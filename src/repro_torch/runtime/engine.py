"""Serving engine: continuous batched decode over request slots on the
paged KV cache (port of ``repro/runtime/engine.py``).

Scope of the port: paged KV, chunked admission (at most ``prefill_chunk``
prompt tokens per slot per engine step, interleaved with decode), greedy
decoding, FIFO admission, one device. Left out and refused: speculation,
the HTTP front door, meshes, prefix sharing and the warm prefix LRU, and
the legacy ring cache.

Slot lifecycle: admit (a free slot takes the queue head once the pool can
hold its worst case) → prefill chunks → decode (one ``serve_step`` over all
``max_batch`` slots; inactive rows write into the null block) → evict
(blocks dereferenced, tags wiped).

Per step the engine runs on planned paths: a decode attention plan
(``B = max_batch``, ``q_len = 1``), a chunk attention plan (``B = 1``,
``q_len = prefill_chunk``), and W4A16 GEMM plans made at ``M = max_batch``
and keyed ``"KxN"``, so the chunk GEMMs (M = prefill_chunk) reuse the
decode plan as in the JAX package.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.shapes import serve_cache_len, serve_num_pages
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.core.quant import (
    DEFAULT_KV_FORMAT, QuantizedTensor, get_kv_format,
)
from repro_torch.kernels import planning
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import kvcache as kvc
from repro_torch.runtime import metrics as rmetrics
from repro_torch.runtime import steps as rsteps

__all__ = ["Request", "ServeReport", "ServingEngine", "StepEvents"]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: a 1-D int prompt, a budget that counts
    every generated token including the one prefill produces, and the
    decode step before which it is not admitted."""

    rid: int
    prompt: Any
    max_new_tokens: int
    arrival_step: int = 0


@dataclasses.dataclass
class ServeReport:
    """What a :meth:`ServingEngine.run` produced."""

    results: Dict[int, List[int]]          # rid → generated token ids
    latencies: Dict[int, float]            # rid → admit→finish seconds
    steps: int = 0
    decode_tokens: int = 0
    decode_s: float = 0.0
    prefill_s: float = 0.0
    step_records: List[dict] = dataclasses.field(default_factory=list)
    peak_pages: int = 0
    ttft: Dict[int, float] = dataclasses.field(default_factory=dict)
    admitted: int = 0
    prefill_logits: Dict[int, torch.Tensor] = dataclasses.field(
        default_factory=dict)              # rid → first-token logits (V,)

    @property
    def tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    def latency_stats(self) -> Dict[str, float]:
        return rmetrics.summarize(list(self.latencies.values()))

    def ttft_stats(self) -> Dict[str, float]:
        return rmetrics.summarize(list(self.ttft.values()))


@dataclasses.dataclass
class StepEvents:
    """What one :meth:`ServingEngine.step` did: tokens emitted per request,
    requests finished and admitted; ``worked`` is False when nothing was
    resident."""

    step: int
    emitted: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    finished: List[int] = dataclasses.field(default_factory=list)
    admitted: List[int] = dataclasses.field(default_factory=list)
    worked: bool = True


class _Slot:
    """Mutable per-slot scheduler record."""

    __slots__ = ("req", "tokens", "remaining", "pos_next", "t_admit",
                 "phase", "pf_stream", "pf_next", "pf_total")

    def __init__(self, req: Request, pos0: int, t_admit: float):
        self.req = req
        self.tokens: List[int] = []
        self.remaining = req.max_new_tokens
        self.pos_next = pos0
        self.t_admit = t_admit
        self.phase = "prefill"          # "prefill" → "active"
        self.pf_stream = None           # (S_total, d) embedding stream
        self.pf_next = 0
        self.pf_total = 0

    def emit_first(self, first_token: int) -> None:
        self.tokens.append(first_token)
        self.remaining -= 1
        self.phase = "active"


class ServingEngine:
    """Continuous-batching paged decode over ``max_batch`` request slots.

    ``device=None`` runs on ``cuda`` and raises when CUDA is missing;
    ``device="cpu"`` runs the plain PyTorch paths (the CPU tests). Params
    must already live on ``device``. ``attn_path`` is ``auto`` (planned per
    regime: ``fused`` on CUDA, ``gather`` on the CPU) or a forced path.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_prompt_len: int = 128, max_new_tokens: int = 64,
                 cache_len: Optional[int] = None, paged: bool = True,
                 page_size: int = 16, prefill_chunk: Optional[int] = None,
                 kv_format: Optional[str] = None,
                 num_pages: Optional[int] = None,
                 attn_path: str = "auto", device: DeviceLike = None,
                 speculate=None, mesh=None, share_prefix: bool = False,
                 warm_cache_mb: float = 0.0):
        if not paged:
            raise NotImplementedError(
                "the port serves from the paged KV cache only; the ring "
                "cache (paged=False) is not ported")
        if speculate not in (None, "off"):
            raise NotImplementedError("speculative decoding is not ported "
                                      "to PyTorch yet")
        if mesh is not None:
            raise NotImplementedError("multi-device serving (mesh) is not "
                                      "ported to PyTorch yet")
        if share_prefix or warm_cache_mb:
            raise NotImplementedError("prefix sharing and the warm prefix "
                                      "cache are not ported to PyTorch yet")
        T.check_family(cfg)
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.max_prompt_len = int(max_prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        self.page_size = int(page_size)
        self.kv_format = kv_format or DEFAULT_KV_FORMAT
        get_kv_format(self.kv_format)
        if cache_len is None:
            self.cache_len = serve_cache_len(cfg, max_prompt_len,
                                             max_new_tokens, self.page_size)
        else:
            self.cache_len = -(-int(cache_len) // self.page_size) \
                * self.page_size
        self.pages_slot = self.cache_len // self.page_size
        self.num_pages = int(
            num_pages if num_pages is not None
            else serve_num_pages(cfg, max_prompt_len, max_new_tokens,
                                 page_size=self.page_size,
                                 max_batch=self.max_batch))
        if self.num_pages < self.pages_slot + 1:
            raise ValueError(
                f"num_pages={self.num_pages} cannot hold even one slot's "
                f"window ({self.pages_slot} pages + the null block); size "
                f"the pool with configs.shapes.serve_num_pages")
        self.alloc = kvc.BlockAllocator(self.num_pages, self.page_size)
        self.prefill_chunk = max(
            1, min(int(prefill_chunk) if prefill_chunk is not None else 32,
                   self.cache_len))

        act_bytes = torch.finfo(cfg.dtype).bits // 8
        attn_problem = planning.AttentionProblem(
            B=self.max_batch, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
            D=cfg.head_dim, cache_len=self.cache_len,
            page_size=self.page_size, window=cfg.sliding_window,
            kv_format=self.kv_format, paged=True,
            backend=self.device.type, act_bytes=act_bytes)
        forced = None if attn_path == "auto" else attn_path
        plan = planning.plan_attention(attn_problem, path=forced)
        self.attn_path, self.kv_partitions = plan.path, plan.kv_partitions
        pf_plan = planning.plan_attention(
            dataclasses.replace(attn_problem, B=1, q_len=self.prefill_chunk),
            path=forced)
        self.prefill_attn_path = pf_plan.path
        self.prefill_kv_partitions = pf_plan.kv_partitions

        self.plans: Dict[str, planning.KernelPlan] = {}
        if cfg.w4a16_plan is None and any(
                isinstance(leaf, QuantizedTensor)
                for leaf in planning.quantized_leaves(params)):
            # decode-regime plans keyed "KxN": the M=prefill_chunk chunk
            # GEMMs look up the same keys and reuse them. A forced strategy
            # is planned here too, so one that cannot run the weights'
            # format is refused before serving starts.
            strategy = None if cfg.w4a16_strategy == "auto" \
                else cfg.w4a16_strategy
            self.plans = planning.plan_for_params(params, M=self.max_batch,
                                                  strategy=strategy)
            cfg = dataclasses.replace(cfg, w4a16_plan=self.plans)
        self.cfg = cfg
        self.params = T.unstack_layers(params)
        self._serve_fns: Dict[Optional[int], Any] = {}
        self._chunk_fns: Dict[Optional[int], Any] = {}
        self._tables: Optional[np.ndarray] = None
        self._reserve: Dict[int, int] = {}

        self.report: Optional[ServeReport] = None
        self._started = False
        self._waiting: collections.deque = collections.deque()
        self._slots: List[Optional[_Slot]] = []
        self._state = None
        self._tok = self._pos = None
        self._step_no = 0
        self._events: Optional[StepEvents] = None

    # -- steps -------------------------------------------------------------

    def _live_bucket(self, hw: int) -> Optional[int]:
        """Live-page bucket for a gather step with high-water mark ``hw``
        pages: the table width halved while it still covers ``hw``
        (None = the full table)."""
        w = self.pages_slot
        hw = max(1, min(int(hw), w))
        while w % 2 == 0 and w // 2 >= hw:
            w //= 2
        return None if w >= self.pages_slot else w

    def _serve_step(self, live_pages: Optional[int] = None):
        fn = self._serve_fns.get(live_pages)
        if fn is None:
            fn = self._serve_fns[live_pages] = rsteps.make_serve_step(
                self.cfg, cache_len=self.cache_len, kv_format=self.kv_format,
                attn_path=self.attn_path, kv_partitions=self.kv_partitions,
                live_pages=live_pages)
        return fn

    def _chunk_step(self, live_pages: Optional[int] = None):
        fn = self._chunk_fns.get(live_pages)
        if fn is None:
            fn = self._chunk_fns[live_pages] = \
                rsteps.make_prefill_chunk_step(
                    self.cfg, self.cache_len, kv_format=self.kv_format,
                    attn_path=self.prefill_attn_path,
                    kv_partitions=self.prefill_kv_partitions,
                    live_pages=live_pages)
        return fn

    def _init_state(self):
        return T.init_paged_state(
            self.cfg, self.max_batch, self.cache_len,
            page_size=self.page_size, num_blocks=self.num_pages,
            kv_format=self.kv_format, device=self.device)

    # -- paged block bookkeeping ------------------------------------------

    def _ensure_pages(self, i: int, offsets) -> None:
        """Map the pages covering logical ``offsets`` for slot ``i``,
        consuming its admit-time reservation."""
        tbl = self._tables[i]
        for p in sorted({o // self.page_size for o in offsets}):
            if tbl[p] < 0:
                tbl[p] = self.alloc.alloc()
                self._reserve[i] = max(0, self._reserve.get(i, 0) - 1)

    def _evict(self, i: int) -> None:
        self._reserve.pop(i, None)
        freed = [bid for bid in map(int, self._tables[i])
                 if bid >= 0 and self.alloc.decref(bid)]
        self._tables[i] = -1
        if freed:
            kvc.reset_blocks(self._state["cache"]["kv"], freed)

    # -- admit / prefill ---------------------------------------------------

    def pos0(self, req: Request) -> int:
        return int(len(req.prompt))

    def _admit(self, req: Request, i: int, t0: float) -> _Slot:
        # without prefix sharing every admit may touch its whole window
        self._reserve[i] = self.pages_slot
        slot = _Slot(req, self.pos0(req), t0)
        slot.pf_total = len(req.prompt)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)
        slot.pf_stream = layers.embed(self.params["embed"], prompt)
        return slot

    def _advance_prefill(self, i: int, slot: _Slot, pending) -> None:
        """Run one prefill chunk for slot ``i``."""
        C = self.prefill_chunk
        start, total = slot.pf_next, slot.pf_total
        end = min(start + C, total)
        self._ensure_pages(i, {p % self.cache_len for p in range(start, end)})
        seg = slot.pf_stream[start:end]
        n = end - start
        if n < C:
            seg = torch.cat([seg, seg.new_zeros((C - n, seg.shape[-1]))])
        positions = np.full((C,), -1, np.int32)
        positions[:n] = np.arange(start, end, dtype=np.int32)
        inputs = {
            "h": seg[None],
            "positions": torch.as_tensor(positions,
                                         device=self.device)[None],
            "table": torch.as_tensor(self._tables[i:i + 1],
                                     device=self.device),
        }
        lp = None
        if self.prefill_attn_path == "gather" and start < self.cache_len:
            lp = self._live_bucket(max(1, -(-start // self.page_size)))
        res = self._chunk_step(lp)(self.params, self._state, inputs)
        self._state = res["state"]
        slot.pf_next = end
        if end == total:
            pending.append((slot, res["logits"][0]))

    def _flush_first_tokens(self, pending) -> None:
        """Emit the first token of every slot whose prefill completed: one
        device argmax over the stacked rows, one host transfer."""
        if not pending:
            return
        rows = torch.stack([row for _, row in pending])
        firsts = torch.argmax(rows, dim=-1).cpu().tolist()
        for (slot, row), t in zip(pending, firsts):
            slot.emit_first(int(t))
            rid = slot.req.rid
            self.report.ttft[rid] = time.perf_counter() - slot.t_admit
            self.report.prefill_logits[rid] = row
            if self._events is not None:
                self._events.emitted.setdefault(rid, []).append(int(t))

    # -- stepper API -------------------------------------------------------

    def _validate(self, r: Request) -> None:
        if len(r.prompt) > self.max_prompt_len:
            raise ValueError(
                f"request {r.rid}: prompt length {len(r.prompt)} exceeds "
                f"engine max_prompt_len {self.max_prompt_len}")
        if r.max_new_tokens > self.max_new_tokens:
            raise ValueError(
                f"request {r.rid}: max_new_tokens {r.max_new_tokens} "
                f"exceeds engine budget {self.max_new_tokens}")
        if r.max_new_tokens < 1:
            raise ValueError(f"request {r.rid}: max_new_tokens must be "
                             f"at least 1 (prefill emits the first token)")
        if len(r.prompt) < 1:
            raise ValueError(f"request {r.rid}: empty prompt")

    def start(self) -> None:
        """Arm the stepper: fresh scheduler state, empty report, a zeroed
        pool."""
        self._waiting = collections.deque()
        self._slots = [None] * self.max_batch
        self.report = ServeReport(results={}, latencies={})
        self._tables = np.full((self.max_batch, self.pages_slot), -1,
                               np.int32)
        self._reserve.clear()
        self.alloc = kvc.BlockAllocator(self.num_pages, self.page_size)
        self._state = self._init_state()
        self._tok = np.zeros(self.max_batch, np.int32)
        self._pos = np.zeros(self.max_batch, np.int32)
        self._step_no = 0
        self._events = None
        self._started = True

    def submit(self, req: Request) -> None:
        if not self._started:
            raise RuntimeError("ServingEngine.submit() before start()")
        self._validate(req)
        self._waiting.append(req)

    def has_work(self) -> bool:
        return self._started and (bool(self._waiting)
                                  or any(s is not None for s in self._slots))

    def drain(self, *, verbose: bool = False) -> ServeReport:
        while self.has_work():
            self.step(verbose=verbose)
        return self.report

    def _finish(self, i: int, slot: _Slot) -> None:
        rid = slot.req.rid
        self.report.results[rid] = slot.tokens
        self.report.latencies[rid] = time.perf_counter() - slot.t_admit
        self._evict(i)
        self._slots[i] = None
        if self._events is not None:
            self._events.finished.append(rid)

    def step(self, *, verbose: bool = False) -> StepEvents:
        """Admit arrived requests into free slots, advance one prefill
        chunk per prefilling slot, run one batched decode step over the
        active slots, evict finished slots."""
        if not self._started:
            raise RuntimeError("ServingEngine.step() before start()")
        ev = StepEvents(step=self._step_no)
        if not self.has_work():
            ev.worked = False
            return ev
        self._events = ev
        try:
            with torch.no_grad():
                self._step_body(ev, verbose)
        finally:
            self._events = None
        self.report.steps = self._step_no
        return ev

    def _step_body(self, ev: StepEvents, verbose: bool) -> None:
        report, slots = self.report, self._slots
        tok, pos = self._tok, self._pos
        step = self._step_no
        pending: List[Any] = []
        admitted = 0
        for i in range(self.max_batch):
            w = self._waiting
            if not w or w[0].arrival_step > self._step_no:
                break
            if slots[i] is not None:
                continue
            if self.pages_slot + sum(self._reserve.values()) \
                    > self.alloc.pages_free:
                break               # pool too full — wait for evictions
            req = w.popleft()
            t0 = time.perf_counter()
            slots[i] = self._admit(req, i, t0)
            report.prefill_s += time.perf_counter() - t0
            report.admitted += 1
            ev.admitted.append(req.rid)
            admitted += 1

        for i, s in enumerate(slots):
            if s is not None and s.phase == "prefill":
                t0 = time.perf_counter()
                self._advance_prefill(i, s, pending)
                report.prefill_s += time.perf_counter() - t0
        self._flush_first_tokens(pending)

        for i, s in enumerate(slots):
            if s is not None and s.phase == "active" \
                    and len(s.tokens) == 1:
                if s.remaining == 0:
                    self._finish(i, s)
                else:
                    tok[i], pos[i] = s.tokens[0], s.pos_next

        active = [i for i, s in enumerate(slots)
                  if s is not None and s.phase == "active"]
        if not active:
            if self.has_work():
                self._step_no = step + 1
            return

        for i in active:
            self._ensure_pages(i, [int(pos[i]) % self.cache_len])
        report.peak_pages = max(report.peak_pages, self.alloc.pages_in_use)
        step_tables = self._tables.copy()
        for i, s in enumerate(slots):
            if s is None or s.phase != "active":
                step_tables[i] = -1     # writes redirect to the null block
        t0 = time.perf_counter()
        inputs = {
            "state": self._state,
            "tokens": torch.as_tensor(tok, device=self.device),
            "pos": torch.as_tensor(pos, device=self.device),
            "tables": torch.as_tensor(step_tables, device=self.device),
        }
        lp = None
        if self.attn_path == "gather":
            mx = max(int(pos[i]) for i in active)
            if mx < self.cache_len:
                lp = self._live_bucket(-(-(mx + 1) // self.page_size))
        res = self._serve_step(lp)(self.params, inputs)
        self._state = res["state"]
        nxt = res["next"].cpu().numpy()       # syncs the device
        dt = time.perf_counter() - t0
        report.decode_s += dt
        report.decode_tokens += len(active)
        report.step_records.append({
            "step": step, "active": len(active), "admitted": admitted,
            "decode_ms": dt * 1e3})
        if verbose:
            print(f"[engine] step {step}: active={len(active)} "
                  f"admitted={admitted} {dt * 1e3:.2f} ms")
        for i in active:
            s = slots[i]
            s.tokens.append(int(nxt[i]))
            ev.emitted.setdefault(s.req.rid, []).append(int(nxt[i]))
            s.remaining -= 1
            s.pos_next += 1
            tok[i], pos[i] = nxt[i], s.pos_next
            if s.remaining == 0:
                self._finish(i, s)
        self._step_no = step + 1

    def run(self, requests, *, verbose: bool = False) -> ServeReport:
        """Serve ``requests`` to completion (start → submit in (arrival,
        rid) order → drain)."""
        for r in requests:
            self._validate(r)
        self.start()
        for r in sorted(requests, key=lambda r: (r.arrival_step, r.rid)):
            self.submit(r)
        return self.drain(verbose=verbose)
