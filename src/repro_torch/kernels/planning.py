"""Plan-based quantized matmul and paged-attention planning: problem → plan
→ execute.

Port of ``repro/kernels/planning.py``. Strategies and attention paths are
registered entries with an H100 roofline cost (``core/costmodel.py``) and a
``supports()`` gate; the planner ranks whatever is registered that takes
the problem's quantization format.

Matmul strategies, by format family:
  * W4A16 (``w4a16_*``): ``reference`` (dequantize + ``torch.matmul``, the
    plain path, also for ``w8a16_*``), ``xla`` (JAX's: dequantize, then one
    ``torch.matmul`` accumulated in fp32; also for ``w8a16_*``), ``fused``
    (``csrc/w4a16_gemm.cu``) and ``decoupled`` (the paper's three-phase
    pipeline through device memory);
  * W8A16 (``w8a16_channel*``): ``w8a16_fused`` (``csrc/w8a16_gemm.cu``);
  * W4A8 (``w4a8_*``): ``w4a8_xla`` (the plain path; the JAX package's
    name is kept so ``--strategy`` takes the same words) and
    ``w4a8_fused`` (``csrc/w4a8_gemm.cu``).
Plain strategies support only CPU operands and kernel strategies only CUDA
ones, which takes the place of the JAX package's interpret-mode penalty.
On CUDA the cost model makes ``auto`` pick ``fused`` for every W4A16
shape and dtype; a CUDA problem a kernel cannot take raises when it runs
(or, where no kernel supports the shape, when it is planned), never routes
to a plain path. A forced strategy or path skips the ranking, so the plain
paths still run on the card when asked for by name (the comparisons of
``chip_smoke.py``). ``xla`` is a plain strategy like ``reference``: it
costs the same, so the planner keeps ``reference`` on the CPU (registered
first), and it runs on the card only when forced; JAX plan caches that
name it load. JAX pins its dequantize inside the layer loop with an
optimization barrier, lest XLA hoist every layer's dequantized weight out
of the decode loop; nothing here has a counterpart or needs one: neither
eager PyTorch nor a captured CUDA graph (``runtime/steps.py``) hoists
anything, and a graph replays the dequantize on every call.

Attention paths: ``ring`` (the per-slot ring caches of an engine without
the paged pool: plain attention over the ring, as the JAX package leaves
it to XLA), ``gather`` (materialize the paged window, plain attention; the
CPU path) and ``fused`` (the paged-attention kernel, CUDA only).

A ``KernelPlan`` carries no tile sizes: the Hopper GEMM picks its own
tiles and honours ``split_k`` only. ``refine=True`` (``plan_matmul``,
``plan_for_params``) runs the fused W4A16 strategy's split_k through
``kernels/autotune.autotune_w4a16``, which ranks the launches the kernel
accepts by the H100 roofline and their waves over the SMs; the other
strategies keep the heuristic split (JAX refines every Pallas strategy's
tiles, which the Hopper kernels pick themselves). A plan JSON-round-trips
(``to_json``/``from_json``), and a JAX plan's JSON reads with its tiles
dropped.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import json
import math
import os
import tempfile
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import costmodel
from repro_torch.core.device import dtype_name
from repro_torch.core.quant import (
    DEFAULT_FORMAT, DEFAULT_KV_FORMAT, QuantizedTensor, get_format,
    get_kv_format, w4a16_format_for, w4a16_matmul_ref, w4a8_matmul_ref,
)
from repro_torch.kernels import ref
from repro_torch.kernels.w4a8_fused import w4a8_fused
from repro_torch.kernels.w4a16_decoupled import w4a16_decoupled
from repro_torch.kernels.w4a16_fused import w4a16_fused
from repro_torch.kernels.w8a16_fused import w8a16_fused

__all__ = [
    "MatmulProblem", "KernelPlan", "Strategy",
    "register_strategy", "get_strategy", "available_strategies",
    "strategies_for_format",
    "plan_matmul", "resolve_plan", "execute", "matmul", "plan_for_params",
    "shard_problem", "splits_k", "mesh_axis_size",
    "PlanCache", "PLAN_CACHE", "load_plan_cache", "save_plan_cache",
    "choose_split_k", "num_cores",
    "AttentionProblem", "AttentionPlan", "register_attn_path",
    "available_attn_paths", "plan_attention", "choose_kv_partitions",
    "choose_q_block",
]


# ---------------------------------------------------------------------------
# Problem
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MatmulProblem:
    """One quantized GEMM: C[M, N] = A[M, K] · Dequant(W[K, N]). Hashable —
    the plan cache and the planner key on it. ``backend`` is the operands'
    device type (``cuda`` | ``cpu``); ``batch`` counts the GEMMs of one
    shape that share the plan (an MoE layer's E experts: x (E, M, K)
    against an (E, K/2, N) stack, one launch on the card)."""

    M: int
    N: int
    K: int
    group_size: int = 128
    act_dtype: str = "bfloat16"
    out_dtype: str = "bfloat16"
    has_zeros: bool = False
    backend: str = "cpu"
    batch: int = 1
    format: str = DEFAULT_FORMAT

    @classmethod
    def from_operands(cls, x: torch.Tensor, qt: QuantizedTensor, *,
                      out_dtype=None, batch: int = 1) -> "MatmulProblem":
        """Describe ``x @ Dequant(qt)``; x may have leading dims."""
        K = x.shape[-1]
        M = math.prod(x.shape[:-1]) if x.dim() > 1 else 1
        return cls(
            M=int(M), N=int(qt.N), K=int(K),
            group_size=int(qt.group_size),
            act_dtype=dtype_name(x.dtype),
            out_dtype=dtype_name(out_dtype or x.dtype),
            has_zeros=qt.zeros is not None,
            backend=x.device.type,
            batch=batch,
            format=qt.format.name,
        )

    @property
    def layer_key(self) -> str:
        """Weight-shape key ("KxN") — one entry per model layer."""
        return f"{self.K}x{self.N}"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "MatmulProblem":
        d = dict(d)
        if "format" not in d:
            # a plan cache written before formats: every entry was W4A16
            d["format"] = w4a16_format_for(
                int(d.get("group_size", 128)),
                symmetric=not d.get("has_zeros", False)).name
        return cls(**d)


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """A dispatch decision: strategy + Split-K degree (the Hopper GEMM
    picks its own tiles). ``out_dtype`` None means "the activation dtype
    at execute time"."""

    strategy: str
    split_k: int = 1
    out_dtype: Optional[str] = None

    # the JAX package's plans also carry Pallas tile sizes
    _JAX_TILES = ("block_m", "block_n", "block_k")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "KernelPlan":
        """A plan dict of either package (JAX's tile sizes are dropped:
        the Hopper kernels pick their own tiles)."""
        return cls(**{k: v for k, v in d.items()
                      if k not in cls._JAX_TILES})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "KernelPlan":
        """A plan's JSON, of either package (see :meth:`from_dict`)."""
        return cls.from_dict(json.loads(s))


# ---------------------------------------------------------------------------
# Strategy registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Strategy:
    """execute(x2, qt, plan) -> (M, N); cost(problem, plan) -> seconds;
    supports(problem) -> eligibility; formats -> fnmatch patterns over
    QuantFormat names; splittable -> honours plan.split_k; batched ->
    execute also takes an expert stack whole (x (E, M, K), one launch),
    else :func:`execute` runs it expert by expert."""

    name: str
    execute: Callable[..., torch.Tensor]
    cost: Callable[[MatmulProblem, KernelPlan], float]
    supports: Callable[[MatmulProblem], bool]
    formats: Tuple[str, ...] = ("w4a16_*",)
    splittable: bool = False
    batched: bool = False

    def supports_format(self, format_name: str) -> bool:
        return any(fnmatch.fnmatchcase(format_name, pat)
                   for pat in self.formats)


_REGISTRY: Dict[str, Strategy] = {}


def register_strategy(name: str, *, cost=None, supports=None,
                      formats: Tuple[str, ...] = ("w4a16_*",),
                      splittable: bool = False, batched: bool = False):
    """Register an execute fn under ``name``; the planner picks it up with
    no dispatcher edits."""

    def deco(fn):
        _REGISTRY[name] = Strategy(
            name=name, execute=fn,
            cost=cost or (lambda problem, plan: float("inf")),
            supports=supports or (lambda problem: True),
            formats=tuple(formats), splittable=splittable,
            batched=batched)
        return fn

    return deco


def get_strategy(name: str) -> Strategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown strategy {name!r}; registered: {available_strategies()}"
        ) from None


def available_strategies() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


def strategies_for_format(format_name: str) -> Tuple[str, ...]:
    return tuple(s.name for s in _REGISTRY.values()
                 if s.supports_format(format_name))


# ---------------------------------------------------------------------------
# Split-K heuristic (paper Fig. 2) and core counting
# ---------------------------------------------------------------------------

# device types whose problems run the card's kernels: "meta" is the dry
# run's trace of the card's path (launch/dryrun.py), planned as on the card
CARD_BACKENDS = ("cuda", "meta")


def num_cores(backend: str = "cuda") -> int:
    """Parallel units for the occupancy heuristics: the card's SM count
    (132 on an H100) for CUDA problems, and for meta problems (the H100's
    where no card is present); elsewhere the paper-model default of 8 — a
    CPU host models the target chip, not itself."""
    if backend in CARD_BACKENDS and torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).multi_processor_count
    return costmodel.H100.num_sms if backend == "meta" else 8


def choose_split_k(M: int, N: int, K: int, *, group_size: int = 128,
                   block_m: int = 128, block_n: int = 256,
                   cores: Optional[int] = None, batch: int = 1) -> int:
    """Split when output tiles underfill the chip and K is deep (K ≫ N —
    decode GEMMs), keeping K slices group-aligned. The ``batch`` GEMMs of
    one launch (an expert stack) count their tiles together."""
    if group_size <= 0 or K % group_size:
        return 1
    cores = num_cores() if cores is None else cores
    m_tiles = max(1, -(-M // block_m))
    n_tiles = max(1, -(-N // block_n))
    tiles = m_tiles * n_tiles * batch
    if tiles >= cores or K < 2 * group_size:
        return 1
    want = min(cores // tiles, K // group_size)
    s = 1
    while s * 2 <= want and K % (s * 2) == 0 \
            and (K // (s * 2)) % group_size == 0:
        s *= 2
    return s


# ---------------------------------------------------------------------------
# Cost models (seconds, H100 roofline; lower wins)
# ---------------------------------------------------------------------------

def _act_bytes(problem: MatmulProblem) -> int:
    return torch.finfo(getattr(torch, problem.act_dtype)).bits // 8


def _cost_fused(problem: MatmulProblem, plan: KernelPlan) -> float:
    return costmodel.w4a16_time_fused(
        problem.M, problem.N, problem.K, group=problem.group_size,
        act_bytes=_act_bytes(problem), has_zeros=problem.has_zeros) \
        * problem.batch


def _cost_reference(problem: MatmulProblem, plan: KernelPlan) -> float:
    return costmodel.w4a16_time_dequant_matmul(
        problem.M, problem.N, problem.K,
        act_bytes=_act_bytes(problem)) * problem.batch


def _cost_decoupled(problem: MatmulProblem, plan: KernelPlan) -> float:
    return costmodel.w4a16_time_decoupled(
        problem.M, problem.N, problem.K, split_k=max(plan.split_k, 1),
        group=problem.group_size, act_bytes=_act_bytes(problem),
        has_zeros=problem.has_zeros) * problem.batch


def _cost_w8a16_fused(problem: MatmulProblem, plan: KernelPlan) -> float:
    return costmodel.w8a16_time_fused(
        problem.M, problem.N, problem.K, act_bytes=_act_bytes(problem),
        has_zeros=problem.has_zeros) * problem.batch


def _cost_w4a8_fused(problem: MatmulProblem, plan: KernelPlan) -> float:
    return costmodel.w4a8_time_fused(
        problem.M, problem.N, problem.K, group=problem.group_size,
        has_zeros=problem.has_zeros) * problem.batch


def _cost_w4a8_plain(problem: MatmulProblem, plan: KernelPlan) -> float:
    return costmodel.w4a8_time_plain(
        problem.M, problem.N, problem.K,
        group=problem.group_size) * problem.batch


def _exec_out_dtype(plan: KernelPlan, x: torch.Tensor):
    return getattr(torch, plan.out_dtype) if plan.out_dtype else x.dtype


def _on_cuda(problem: MatmulProblem) -> bool:
    return problem.backend in CARD_BACKENDS


def _off_cuda(problem: MatmulProblem) -> bool:
    return problem.backend not in CARD_BACKENDS


def _packable(problem: MatmulProblem) -> bool:
    """Packed int4 pairs with group-aligned K."""
    return (problem.group_size > 0 and problem.K % 2 == 0
            and problem.K % problem.group_size == 0)


_FLOAT_ACT_FORMATS = ("w4a16_*", "w8a16_*")   # anything dequantize handles


@register_strategy("reference", cost=_cost_reference, supports=_off_cuda,
                   formats=_FLOAT_ACT_FORMATS, batched=True)
def _run_reference(x2, qt, plan):
    return ref.w4a16_ref(x2, qt, out_dtype=_exec_out_dtype(plan, x2))


@register_strategy("xla", cost=_cost_reference, supports=_off_cuda,
                   formats=_FLOAT_ACT_FORMATS, batched=True)
def _run_xla(x2, qt, plan):
    return w4a16_matmul_ref(x2, qt, out_dtype=_exec_out_dtype(plan, x2),
                            acc_dtype=torch.float32)


@register_strategy("w4a8_xla", cost=_cost_w4a8_plain,
                   supports=lambda problem: _off_cuda(problem)
                   and _packable(problem), formats=("w4a8_*",))
def _run_w4a8_plain(x2, qt, plan):
    return w4a8_matmul_ref(x2, qt).to(_exec_out_dtype(plan, x2))


@register_strategy("fused", cost=_cost_fused, supports=_on_cuda,
                   splittable=True, batched=True)
def _run_fused(x2, qt, plan):
    return w4a16_fused(x2, qt, split_k=max(plan.split_k, 1),
                       out_dtype=_exec_out_dtype(plan, x2))


@register_strategy("decoupled", cost=_cost_decoupled, supports=_on_cuda,
                   splittable=True)
def _run_decoupled(x2, qt, plan):
    return w4a16_decoupled(x2, qt, split_k=max(plan.split_k, 1),
                           out_dtype=_exec_out_dtype(plan, x2))


@register_strategy("w8a16_fused", cost=_cost_w8a16_fused,
                   supports=lambda problem: _on_cuda(problem)
                   and problem.group_size >= problem.K > 0,
                   formats=("w8a16_channel*",), splittable=True,
                   batched=True)
def _run_w8a16_fused(x2, qt, plan):
    return w8a16_fused(x2, qt, split_k=max(plan.split_k, 1),
                       out_dtype=_exec_out_dtype(plan, x2))


@register_strategy("w4a8_fused", cost=_cost_w4a8_fused,
                   supports=lambda problem: _on_cuda(problem)
                   and _packable(problem), formats=("w4a8_*",),
                   splittable=True)
def _run_w4a8_fused(x2, qt, plan):
    return w4a8_fused(x2, qt, split_k=max(plan.split_k, 1),
                      out_dtype=_exec_out_dtype(plan, x2))


# ---------------------------------------------------------------------------
# Plan cache (process-wide, in memory)
# ---------------------------------------------------------------------------

class PlanCache:
    """Problem → plan memo with hit/miss stats and JSON persistence in the
    JAX package's format (version 1), so either package warm-starts from
    the other's file. Only planner-chosen plans are cached."""

    _VERSION = 1

    def __init__(self) -> None:
        self._plans: Dict[MatmulProblem, KernelPlan] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._plans)

    def get(self, problem: MatmulProblem) -> Optional[KernelPlan]:
        plan = self._plans.get(problem)
        if plan is None:
            self.misses += 1
        else:
            self.hits += 1
        return plan

    def put(self, problem: MatmulProblem, plan: KernelPlan) -> None:
        self._plans[problem] = plan

    def clear(self) -> None:
        self._plans.clear()
        self.hits = self.misses = 0

    def save(self, path: str) -> int:
        """Persist every cached decision; returns the entry count. The
        write is atomic (a temp file, then ``os.replace``), so a crash
        never truncates a file other runs warm-start from."""
        entries = [{"problem": prob.to_dict(), "plan": plan.to_dict()}
                   for prob, plan in self._plans.items()]
        blob = json.dumps({"version": self._VERSION, "plans": entries},
                          indent=1, sort_keys=True)
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(
            dir=d, prefix=os.path.basename(path) + ".", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return len(entries)

    def load(self, path: str) -> int:
        """Load persisted decisions, merged over the current contents;
        returns the number loaded. Malformed content raises
        ValueError. Plans whose strategy this package does not register
        are dropped."""
        with open(path) as f:
            blob = json.load(f)      # JSONDecodeError is a ValueError
        try:
            if blob.get("version") != self._VERSION:
                raise ValueError(
                    f"unsupported plan-cache version in {path}: "
                    f"{blob.get('version')!r}")
            loaded = {MatmulProblem.from_dict(e["problem"]):
                      KernelPlan.from_dict(e["plan"]) for e in blob["plans"]}
        except (TypeError, AttributeError, KeyError) as e:
            raise ValueError(f"malformed plan cache {path}: {e}") from e
        loaded = {prob: plan for prob, plan in loaded.items()
                  if plan.strategy in _REGISTRY}
        self._plans.update(loaded)
        return len(loaded)


PLAN_CACHE = PlanCache()


def load_plan_cache(path: str, *, tolerant: bool = False) -> int:
    """Load ``path`` into the process cache. With ``tolerant=True`` a
    missing or unreadable file is a no-op returning -1 (launchers
    warm-starting from an optional cache never die on a stale file)."""
    try:
        return PLAN_CACHE.load(path)
    except (OSError, ValueError):
        if tolerant:
            return -1
        raise


def save_plan_cache(path: str) -> int:
    return PLAN_CACHE.save(path)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def _default_plan(problem: MatmulProblem, strategy: str,
                  refine: bool = False) -> KernelPlan:
    """The heuristic (or, with ``refine``, the searched) plan of one
    strategy: the refine pass ranks the fused W4A16 kernel's launches
    (``autotune.autotune_w4a16``) for one GEMM of the problem's shape."""
    split_k = 1
    if get_strategy(strategy).splittable:
        split_k = choose_split_k(problem.M, problem.N, problem.K,
                                 group_size=problem.group_size,
                                 cores=num_cores(problem.backend),
                                 batch=problem.batch)
        if refine and strategy == "fused" and problem.batch == 1:
            from repro_torch.kernels.autotune import autotune_w4a16

            split_k = autotune_w4a16(
                problem.M, problem.N, problem.K, group=problem.group_size,
                dtype=getattr(torch, problem.act_dtype),
                has_zeros=problem.has_zeros)[3]
    return KernelPlan(strategy=strategy, split_k=split_k,
                      out_dtype=problem.out_dtype)


def plan_matmul(problem: MatmulProblem, *, strategy: Optional[str] = None,
                refine: bool = False, use_cache: bool = True,
                cache: Optional[PlanCache] = None) -> KernelPlan:
    """Choose a :class:`KernelPlan`: the cheapest registered strategy that
    supports the problem's format and shape (memoized), or the named
    ``strategy`` (a strategy/format mismatch raises). ``refine=True`` runs
    the refine pass (:func:`_default_plan`); it reaches the search even
    when a plan is cached, and the refined plan replaces the cached one,
    as in the JAX package."""
    if strategy is not None:
        strat = get_strategy(strategy)
        if not strat.supports_format(problem.format):
            raise ValueError(
                f"strategy {strat.name!r} does not support quantization "
                f"format {problem.format!r} (it supports formats matching "
                f"{list(strat.formats)}); strategies that do: "
                f"{list(strategies_for_format(problem.format))}")
        return _default_plan(problem, strat.name, refine)

    cache = cache if cache is not None else PLAN_CACHE
    if use_cache and not refine:
        hit = cache.get(problem)
        if hit is not None:
            return hit
    best: Optional[Tuple[float, int, KernelPlan]] = None
    for order, strat in enumerate(_REGISTRY.values()):
        if not strat.supports_format(problem.format) \
                or not strat.supports(problem):
            continue
        plan = _default_plan(problem, strat.name, refine)
        score = strat.cost(problem, plan)
        if best is None or (score, order) < (best[0], best[1]):
            best = (score, order, plan)
    if best is None:
        candidates = strategies_for_format(problem.format)
        if candidates:
            raise ValueError(
                f"no strategy supporting format {problem.format!r} can "
                f"execute this problem shape (M={problem.M}, N={problem.N}, "
                f"K={problem.K}, group_size={problem.group_size}, "
                f"backend={problem.backend}); {list(candidates)} rejected "
                f"it — for packed-int4 formats K must be even and "
                f"divisible by the group size")
        raise ValueError(
            f"no registered strategy supports quantization format "
            f"{problem.format!r} (strategies: "
            f"{list(available_strategies())})")
    plan = best[2]
    if use_cache:
        cache.put(problem, plan)
    return plan


def resolve_plan(problem: MatmulProblem, cfg=None) -> KernelPlan:
    """Plan for a model-layer matmul, honouring ``cfg.w4a16_plan`` and then
    ``cfg.w4a16_strategy`` ("auto" defers to the planner). The override is
    a :class:`KernelPlan` (every quantized layer), a mapping from the
    layer's ``"KxN"`` to a plan or a plan dict (as :func:`plan_for_params`
    returns; a layer it does not name is planned), or a plan's JSON."""
    override = getattr(cfg, "w4a16_plan", None) if cfg is not None \
        else None
    if isinstance(override, KernelPlan):
        return override
    if isinstance(override, str):
        return KernelPlan.from_json(override)
    if isinstance(override, Mapping):
        hit = override.get(problem.layer_key)
        if hit is not None:
            return hit if isinstance(hit, KernelPlan) \
                else KernelPlan.from_dict(hit)
    strategy = getattr(cfg, "w4a16_strategy", "auto") if cfg is not None \
        else "auto"
    if strategy and strategy != "auto":
        return plan_matmul(problem, strategy=strategy)
    return plan_matmul(problem)


def execute(plan: KernelPlan, x: torch.Tensor,
            qt: QuantizedTensor) -> torch.Tensor:
    """Run a planned quantized matmul: x (..., K) → (..., N). An expert
    stack (packed (E, K/pack, N)) takes x (E, M, K) → (E, M, N): whole for
    a batched strategy (the W4A16 and W8A16 kernels, one launch; the plain
    ``reference``, one dequant and one batched matmul), else one expert at
    a time through the strategy's 2-D path (the decoupled pipeline and
    W4A8)."""
    strat = get_strategy(plan.strategy)
    if not strat.supports_format(qt.format.name):
        raise ValueError(
            f"plan strategy {plan.strategy!r} cannot execute a "
            f"{qt.format.name!r} tensor (it supports formats matching "
            f"{list(strat.formats)})")
    if qt.packed.dim() == 3:
        E = qt.packed.shape[0]
        if x.dim() != 3 or x.shape[0] != E or x.shape[-1] != qt.K:
            raise ValueError(f"an expert stack of {E} takes x (E, M, "
                             f"{qt.K}), got {tuple(x.shape)}")
        if strat.batched:
            return strat.execute(x, qt, plan)
        return torch.stack([strat.execute(x[e], qt.layer(e), plan)
                            for e in range(E)])
    if qt.packed.dim() != 2:
        raise ValueError(f"execute takes one layer's weight or expert "
                         f"stack, got packed {tuple(qt.packed.shape)}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = strat.execute(x2, qt, plan)
    return out.reshape(*lead, qt.N)


def matmul(x: torch.Tensor, qt: QuantizedTensor, *, cfg=None) -> torch.Tensor:
    """One-call convenience over the primary path (plan cache included)."""
    problem = MatmulProblem.from_operands(x, qt)
    return execute(resolve_plan(problem, cfg), x, qt)


def _quantized_paths(tree, names=()):
    if isinstance(tree, QuantizedTensor):
        yield names, tree
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _quantized_paths(v, names + (k,))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _quantized_paths(v, names)


def quantized_leaves(tree):
    return (leaf for _, leaf in _quantized_paths(tree))


def mesh_axis_size(mesh, name: str) -> int:
    """Axis size by name, 0 when absent: a ``DeviceMesh``, or a spec-level
    stand-in with a ``shape`` dict (the JAX package's tests' FakeMesh)."""
    if mesh is None:
        return 0
    dims = getattr(mesh, "mesh_dim_names", None)
    if dims is not None:
        return mesh.size(dims.index(name)) if name in dims else 0
    try:
        return int(mesh.shape[name])
    except (KeyError, TypeError):
        return 0


def splits_k(problem: MatmulProblem, tp: int) -> bool:
    """Can a row-parallel GEMM split its K over ``tp`` ranks that each run
    their shard alone? Only into whole packed rows and quant groups, and
    never for a format that quantizes its activations (a row scale would
    then cover one rank's K slice)."""
    fmt = get_format(problem.format)
    K = problem.K
    units = [K, K // fmt.pack_factor]
    if fmt.scale_granularity == "group":
        units.append(K // problem.group_size)
    return not fmt.quantized_activations and all(u % tp == 0 for u in units)


def shard_problem(problem: MatmulProblem, mesh, kind: str, *,
                  parts: Optional[int] = None) -> MatmulProblem:
    """The per-rank LOCAL GEMM of ``problem`` under tensor parallelism (the
    JAX package's ``shard_problem``): ``kind="col"`` divides N by the
    "model" axis (or by ``parts``: the groups a KV projection's heads
    split into when ranks outnumber them), ``"row"`` divides K, ``"rep"``
    leaves the weight whole; the data axes divide M greedily, as
    ``batch_spec`` does. A dim that does not divide stays whole.

    It departs from JAX where a rank that runs its shard alone cannot take
    JAX's layout: a row-parallel K splits only as :func:`splits_k` allows
    (JAX divides any K the axis divides and replicates the scales).

    Row-parallel sharding moves each rank's GEMM deeper into the K ≫ N
    decode regime the paper's Split-K targets (llama3-405b at TP=4: wk/wv
    become K = 16384 against N = 256 per KV head), so plans are costed on
    these shapes."""
    if mesh is None:
        return problem
    model = mesh_axis_size(mesh, "model")
    M, N, K = problem.M, problem.N, problem.K
    dp = 1
    for a in ("pod", "data"):
        sz = mesh_axis_size(mesh, a)
        if sz > 1 and M % (dp * sz) == 0:
            dp *= sz
    M //= dp
    if model > 1:
        if kind == "col" and N % (parts or model) == 0:
            N //= parts or model
        elif kind == "row" and splits_k(problem, model):
            K //= model
    return dataclasses.replace(problem, M=max(M, 1), N=N, K=K)


def plan_for_params(params, M: int, *, strategy: Optional[str] = None,
                    refine: bool = False, mesh=None,
                    cfg=None) -> Dict[str, KernelPlan]:
    """Pre-plan every quantized layer GEMM in a param tree for ``M`` rows
    (``strategy`` forces one, and a strategy/format mismatch raises here;
    ``refine`` runs each through the refine pass of :func:`plan_matmul`).
    An MoE expert stack (a leaf under ``moe``, experts on the axis before
    K) is planned as one batched problem of E GEMMs. Returns ``{"KxN":
    plan}``; every planned decision lands in the plan cache.

    With ``mesh`` (and the model's ``cfg``) ``params`` is the whole tree
    and each leaf is planned at the GEMM a rank executes: its cut by the
    rank's ``runtime.sharding.Layout`` through :func:`shard_problem`, M
    divided over the data axes. The keys are those shard-local "KxN",
    which is what a rank's layer-time lookups see. A rank's own tree
    (``sharding.shard_params``) plans the same keys without ``mesh``, at
    the rank's M."""
    layout = None
    if mesh is not None:
        # runtime.sharding owns the cut; imported here so that the kernels
        # layer does not import runtime/ when it loads
        from repro_torch.runtime.sharding import Layout
        layout = Layout(cfg, mesh)
    plans: Dict[str, KernelPlan] = {}
    for names, leaf in _quantized_paths(params):
        batch = leaf.packed.shape[-3] if "moe" in names else 1
        problem = MatmulProblem(
            M=int(M), N=int(leaf.N), K=int(leaf.K),
            group_size=leaf.group_size,
            act_dtype=dtype_name(leaf.out_dtype),
            out_dtype=dtype_name(leaf.out_dtype),
            has_zeros=leaf.zeros is not None,
            backend=leaf.packed.device.type, batch=int(batch),
            format=leaf.format.name)
        if layout is not None:
            cut = layout.leaf_cut(names[:-1], {"kernel": leaf})
            kind = "rep" if cut is None or cut[0] == "gather" else \
                ("row" if cut[1] == -2 else "col")
            parts = cut[2] if kind == "col" else None
            problem = shard_problem(problem, mesh, kind, parts=parts)
        plans[problem.layer_key] = plan_matmul(problem, strategy=strategy,
                                               refine=refine)
    return plans


# ---------------------------------------------------------------------------
# Attention planning: ring vs gather vs fused
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttentionProblem:
    """One paged-attention step: B rows of ``q_len`` queries each against a
    ctx-token cached window; Hq query heads over Hkv KV heads of dim D.
    ``backend`` is the device type the step runs on."""
    B: int
    Hq: int
    Hkv: int
    D: int
    cache_len: int
    page_size: int = 16
    window: int = 0
    kv_format: str = DEFAULT_KV_FORMAT
    paged: bool = True
    backend: str = "cpu"
    act_bytes: int = 2
    q_len: int = 1

    @property
    def ctx(self) -> int:
        return self.window or self.cache_len

    @property
    def pages(self) -> int:
        return max(1, -(-self.cache_len // max(self.page_size, 1)))


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    path: str                     # "ring" | "gather" | "fused"
    kv_partitions: int = 1        # Split-K degree over the page axis


@dataclasses.dataclass(frozen=True)
class AttnPath:
    name: str
    cost: Callable[["AttentionProblem", "AttentionPlan"], float]
    supports: Callable[["AttentionProblem"], bool]


_ATTN_REGISTRY: Dict[str, AttnPath] = {}


def register_attn_path(name: str, *, cost, supports=None):
    _ATTN_REGISTRY[name] = AttnPath(
        name=name, cost=cost, supports=supports or (lambda p: True))


def available_attn_paths() -> Tuple[str, ...]:
    return tuple(_ATTN_REGISTRY)


def choose_kv_partitions(B: int, Hkv: int, pages: int, *, q_tiles: int = 1,
                         cores: Optional[int] = None) -> int:
    """Split-K over the page axis until B·Hkv·q_tiles blocks fill the
    card, on a power-of-2 divisor of the table length."""
    cores = num_cores() if cores is None else cores
    tiles = max(1, B * Hkv * max(1, q_tiles))
    if tiles >= cores or pages < 2:
        return 1
    want = min(cores // tiles, pages)
    s = 1
    while s * 2 <= want and pages % (s * 2) == 0:
        s *= 2
    return s


def choose_q_block(q_len: int, group: int, *, target: int = 128) -> int:
    """Queries per Q tile: the largest divisor Tq of ``q_len`` with
    Tq·group rows ≤ ``target``."""
    cap = max(1, target // max(1, group))
    t = max(1, min(q_len, cap))
    while q_len % t:
        t -= 1
    return t


def _attn_quantized(problem: AttentionProblem) -> bool:
    return get_kv_format(problem.kv_format).quantized


def _cost_attn_ring(problem: AttentionProblem, plan: AttentionPlan) -> float:
    return costmodel.attn_time(
        "ring", problem.B, problem.Hq, problem.Hkv, problem.D, problem.ctx,
        quantized=False, act_bytes=problem.act_bytes, q_len=problem.q_len)


def _cost_attn_gather(problem: AttentionProblem,
                      plan: AttentionPlan) -> float:
    return costmodel.attn_time(
        "gather", problem.B, problem.Hq, problem.Hkv, problem.D,
        problem.ctx, quantized=_attn_quantized(problem),
        act_bytes=problem.act_bytes, q_len=problem.q_len)


def _cost_attn_fused(problem: AttentionProblem,
                     plan: AttentionPlan) -> float:
    return costmodel.attn_time(
        "fused", problem.B, problem.Hq, problem.Hkv, problem.D,
        problem.ctx, quantized=_attn_quantized(problem),
        act_bytes=problem.act_bytes, q_len=problem.q_len,
        kv_partitions=plan.kv_partitions)


register_attn_path("ring", cost=_cost_attn_ring,
                   supports=lambda p: not p.paged)
register_attn_path("gather", cost=_cost_attn_gather,
                   supports=lambda p: p.paged)
register_attn_path("fused", cost=_cost_attn_fused,
                   supports=lambda p: p.paged
                   and p.backend in CARD_BACKENDS)


def _attn_plan_for(problem: AttentionProblem, name: str) -> AttentionPlan:
    parts = 1
    if name == "fused":
        group = max(1, problem.Hq // max(1, problem.Hkv))
        q_tiles = problem.q_len // choose_q_block(problem.q_len, group)
        parts = choose_kv_partitions(problem.B, problem.Hkv, problem.pages,
                                     q_tiles=q_tiles,
                                     cores=num_cores(problem.backend))
        # each partition flushes O(q_len·Hq·D) partials: cap S where those
        # bytes would rival the window it splits
        while parts > 1 and parts * problem.q_len * 2 > problem.ctx:
            parts //= 2
    return AttentionPlan(path=name, kv_partitions=parts)


def plan_attention(problem: AttentionProblem, *,
                   path: Optional[str] = None) -> AttentionPlan:
    """Choose the attention path: the cheapest supported one (``ring`` for
    an engine without the paged pool), or the named ``path`` (validated
    against ``supports()``: ``fused`` or ``gather`` without the pool, or
    ``ring`` with it, is refused in the JAX package's words)."""
    if path is not None and path != "auto":
        entry = _ATTN_REGISTRY.get(path)
        if entry is None:
            raise ValueError(
                f"unknown attention path {path!r} (registered: "
                f"{list(available_attn_paths())})")
        if not entry.supports(problem):
            eligible = [e.name for e in _ATTN_REGISTRY.values()
                        if e.supports(problem)]
            raise ValueError(
                f"attention path {path!r} does not support this problem "
                f"(paged={problem.paged}, backend={problem.backend}); "
                f"paths that do: {eligible}")
        return _attn_plan_for(problem, path)

    best: Optional[Tuple[float, int, AttentionPlan]] = None
    for order, entry in enumerate(_ATTN_REGISTRY.values()):
        if not entry.supports(problem):
            continue
        plan = _attn_plan_for(problem, entry.name)
        score = entry.cost(problem, plan)
        if best is None or (score, order) < (best[0], best[1]):
            best = (score, order, plan)
    if best is None:
        raise ValueError(
            f"no registered attention path supports this problem "
            f"(paged={problem.paged}, backend={problem.backend}; "
            f"registered: {list(available_attn_paths())})")
    return best[2]
