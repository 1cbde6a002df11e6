"""Serving engine: continuous batched decode over request slots on the
paged, prefix-shared KV cache (port of ``repro/runtime/engine.py``).

The rwkv family holds no KV cache: its engine runs the same chunked
prefill and batched decode on the carry-only state, with no allocator,
block tables, prefix sharing or warm LRU. The rwkv and hybrid families'
recurrent carries are per-slot rows of the state: zeroed when a slot
admits a request, advanced only for the rows that decode (``active``),
and, after each verify step, set to the checkpoint at the row's accepted
frontier. The encdec family (whisper) runs its encoder once a request at
admit (:meth:`ServingEngine._insert_enc_kv`) and writes the slot's rows
of the state's cross K/V, which every step then reads; its audio seeds the
prefix-page keys, so identical prompts over different audio share no
page. A vision-prefix arch (internvl2) prefills the request's patch
embeddings ahead of its prompt in one chunked stream; the patches are
``E`` units of the page keys, and decode starts after prompt + prefix.

Slot lifecycle:

  admit   — a free slot takes the next admissible request (FIFO, or by
            priority and deadline under ``admission="priority"``) once the
            pool can hold its worst case. Its page-aligned prompt prefix
            maps onto published blocks (prefix sharing; a chain retained
            warm under ``warm_cache_mb`` is adopted back), and the rest of
            the prompt prefills in chunks of at most ``prefill_chunk``
            tokens interleaved with decode. A warm or live prefix that
            covers the whole prompt, with its first token cached,
            activates the slot with zero prefill steps.
  decode  — one ``serve_step`` over all ``max_batch`` slots (inactive rows
            write into the null block), or, with a proposer wired, one
            batched verify step over (slot, spec_k + 1) positions: propose
            → verify → exact greedy acceptance → allocator rollback of the
            pages the rejected drafts took.
  evict   — a finished or cancelled slot's blocks are dereferenced;
            blocks reaching refcount 0 have their tags wiped (or park
            warm), and the first divergent write to a shared block copies
            it (copy-on-write).

Per step the engine runs on planned paths: a decode attention plan
(``B = max_batch``, ``q_len = 1``), a chunk plan (``B = 1``, ``q_len =
prefill_chunk``), a verify plan when speculating (``B = max_batch``,
``q_len = spec_k + 1``), and W4A16 GEMM plans keyed ``"KxN"``, made at
``M = max_batch`` or, when speculating, at the verify step's ``M =
max_batch·(spec_k + 1)``; the other steps' GEMMs reuse them.

On a (data, model) mesh (``mesh=``, ``launch/mesh.py``) every rank runs
this same host loop — scheduler, allocator, proposer — in lockstep on its
shard of the weights (``runtime/sharding.py``) and of the KV pool (its own
KV heads, every page: the pool is replicated over "data"). The decode and
verify steps split their slots over "data" when ``max_batch`` divides it
and all-gather the tokens after the argmax; the one-slot prefill chunk
runs on every rank. Plans are shard-local: GEMMs keyed on the "KxN" a rank
executes at its own rows (``max_batch / dp``, or ``max_batch·(spec_k +
1) / dp`` when speculating), attention at its own heads. Every family
serves on a mesh. The per-slot state (rwkv's and hybrid's carries,
encdec's ``enc_kv``) holds the rank's heads or SSM channels and, where the
slots split over "data", only the rank's slots: the decode step and the
verify step's carry commit (checkpoint 1 + accepted) act on those rows.
A slot's prefill chunks run on every rank; a rank whose data shard does
not hold the slot runs them on side rows of its own (zeroed at admit, with
encdec's cross K/V from the encoder, which every rank runs at admit at its
own heads) and drops them when the prefill ends, so no carry row crosses
ranks.

The ring engine (``paged=False``, the JAX package's legacy engine and the
reference its paged one is held against) keeps per-slot ring caches
(``T.init_decode_state``): a request's whole prompt prefills at admit
through ``steps.make_prefill_step`` (its attention on the config's
``attn_impl``; the launcher sets the flash kernel on the card), the slot's
row of every state leaf is overwritten from it (:func:`insert_slot`), each
decode step runs over the rings without block tables, and an evicted slot's
ring tags are wiped (:func:`reset_slot`). There is no allocator, no prefix
sharing, no warm LRU and no speculation; a quantized KV format is refused,
as in the JAX package. rwkv follows JAX's rule: ``paged=False`` prefills
whole too. On a mesh a slot's prefill runs on every rank and the rank that
holds the slot's row keeps it; the ring holds the rank's rows and its slice
of the window (``models/transformer.py``).

A moe layer routes every row of a step (inactive decode slots, a chunk's
padding, every verify position) as the JAX engine does, since which pairs
overflow an expert's capacity depends on it.
"""
from __future__ import annotations

import collections
import dataclasses
import math
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
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import kvcache as kvc
from repro_torch.runtime import metrics as rmetrics
from repro_torch.runtime import sharding
from repro_torch.runtime import speculative as spec
from repro_torch.runtime import steps as rsteps

__all__ = ["Request", "ServeReport", "ServingEngine", "StepEvents",
           "insert_slot", "reset_slot"]

_PATH_CODE = {"ring": 0, "gather": 1, "fused": 2}


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """``t`` on the host as a numpy array of the same bytes (bf16 read bit
    for bit as int16: numpy has no bf16)."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.cpu().numpy()


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: a 1-D int prompt, a budget that counts
    every generated token including the one prefill produces, and the
    decode step before which it is not admitted. ``prefix_embeds``
    (vision_prefix, d) and ``audio_embeds`` (encoder_seq, d) are the
    request's frontends (arrays, lists or tensors); where the arch needs
    one and the request carries none, the engine uses zeros.
    ``deadline_s`` (seconds from submission) and ``priority`` (higher
    admits first) only shape the admission order under
    ``admission="priority"``; FIFO ignores both. Deadlines are enforced
    (408) by the front door's queue."""

    rid: int
    prompt: Any
    max_new_tokens: int
    arrival_step: int = 0
    prefix_embeds: Any = None
    audio_embeds: Any = None
    deadline_s: Optional[float] = None
    priority: int = 0


@dataclasses.dataclass
class ServeReport:
    """What a :meth:`ServingEngine.run` (or a front-door session)
    produced."""

    results: Dict[int, List[int]]          # rid → generated token ids
    latencies: Dict[int, float]            # rid → admit→finish seconds
    steps: int = 0
    decode_tokens: int = 0                 # tokens emitted (accepted)
    decode_s: float = 0.0
    prefill_s: float = 0.0
    warm_hits: int = 0                     # admits that adopted warm pages
    warm_misses: int = 0                   # admits that found none warm
    prefill_steps_saved: int = 0           # chunk steps avoided by shared
                                           # or warm prefix pages
    step_records: List[dict] = dataclasses.field(default_factory=list)
    peak_pages: int = 0                    # max live blocks seen
    proposed_tokens: int = 0               # speculative: drafts scored
    accepted_tokens: int = 0               # speculative: drafts accepted
    ttft: Dict[int, float] = dataclasses.field(default_factory=dict)
    cancelled: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    # rid → tokens emitted before cancellation ([] while still queued)
    admitted: int = 0
    # front-door admission outcomes (a 429/408 never reaches the engine)
    rejected_429: int = 0
    rejected_408: int = 0
    peak_queue_depth: int = 0
    queue_wait: Dict[int, float] = dataclasses.field(default_factory=dict)
    prefill_logits: Dict[int, torch.Tensor] = dataclasses.field(
        default_factory=dict)              # rid → first-token logits (V,)

    @property
    def tokens_per_s(self) -> float:
        """Accepted tokens per decode second."""
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    @property
    def acceptance_rate(self) -> float:
        return (self.accepted_tokens / self.proposed_tokens
                if self.proposed_tokens else 0.0)

    def latency_stats(self) -> Dict[str, float]:
        return rmetrics.summarize(list(self.latencies.values()))

    def ttft_stats(self) -> Dict[str, float]:
        return rmetrics.summarize(list(self.ttft.values()))


@dataclasses.dataclass
class StepEvents:
    """What one :meth:`ServingEngine.step` did: tokens emitted per request,
    requests finished and admitted; ``worked`` is False when nothing was
    resident (the step counter did not advance)."""

    step: int
    emitted: Dict[int, List[int]] = dataclasses.field(default_factory=dict)
    finished: List[int] = dataclasses.field(default_factory=list)
    admitted: List[int] = dataclasses.field(default_factory=list)
    worked: bool = True


class _Slot:
    """Mutable per-slot scheduler record."""

    __slots__ = ("req", "tokens", "remaining", "pos_next", "t_admit",
                 "phase", "pf_stream", "pf_next", "pf_total", "pf_keys",
                 "prompt_ids")

    def __init__(self, req: Request, pos0: int, t_admit: float):
        self.req = req
        self.prompt_ids: Optional[List[int]] = None   # set when speculating
        self.tokens: List[int] = []
        self.remaining = req.max_new_tokens
        self.pos_next = pos0
        self.t_admit = t_admit
        self.phase = "prefill"          # "prefill" → "active"
        self.pf_stream = None           # (S_total, d) embedding stream
        self.pf_next = 0                # next prefill position
        self.pf_total = 0
        self.pf_keys = ([], None)       # prefix-share keys to publish

    def emit_first(self, first_token: int) -> None:
        self.tokens.append(first_token)
        self.remaining -= 1
        self.phase = "active"


def insert_slot(state, rstate, slot: int):
    """Write a B = 1 prefilled decode state ``rstate`` into row ``slot`` of
    ``state``, in place (returns ``state``). Every per-slot leaf is (L, B,
    ...) — ring K, V and tags, the recurrent carries, encdec's ``enc_kv``
    — so one rule covers every family; the whole row is overwritten, tags
    included, so a reused slot never sees its previous occupant."""
    def put(dst, src):
        dst[:, slot] = src[:, 0].to(dst.dtype)

    for name, leaf in state["cache"].items():
        src = rstate["cache"][name]
        if isinstance(leaf, attention.KVCache):
            for d, r in zip(leaf, src):
                put(d, r)
        else:
            put(leaf, src)
    for d, r in zip(state.get("enc_kv", ()), rstate.get("enc_kv", ())):
        put(d, r)
    return state


def reset_slot(state, slot: int):
    """Evict ``slot`` of a ring state, in place: wipe its ring tags so the
    row reads as empty (the paged engine wipes blocks instead)."""
    ring = state["cache"].get("kv")
    if isinstance(ring, attention.KVCache):
        attention.cache_reset_slots(ring, slot)
    return state


class ServingEngine:
    """Continuous-batching decode over ``max_batch`` request slots.

    ``device=None`` runs on ``cuda`` and raises when CUDA is missing;
    ``device="cpu"`` runs the plain PyTorch paths (the CPU tests). Params
    must already live on ``device``. ``attn_path`` is ``auto`` (planned per
    regime: ``fused`` on CUDA, ``gather`` on the CPU) or a forced path.
    ``speculate`` is off, a proposer name (``ngram`` | ``draft[:layers=N]``)
    or a :class:`~repro_torch.runtime.speculative.Proposer`; ``spec_k``
    drafts are scored per verify step. ``share_prefix`` (on by default, as
    in the JAX package) maps identical page-aligned prompt prefixes onto
    the same blocks; ``warm_cache_mb`` keeps released prefix chains warm
    up to that many MiB. ``admission`` is ``fifo`` or ``priority``.
    rwkv arrives with ``paged=True`` and serves from its carry-only state
    (``self.paged`` is False, ``self.chunked`` True); the carry families
    share no prefix. ``paged=False`` is the ring engine (module
    docstring): ``self.chunked`` False, the attention path ``ring``.
    ``refine_plans`` runs the W4A16 plans through the planner's refine
    pass (``kernels/autotune.py``); off by default, as in JAX.
    ``mesh`` (a (data, model) DeviceMesh) serves this rank's shard:
    ``params`` whole (cut here) or already the rank's
    (``sharding.shard_params``); ``self.cfg`` is then the rank's config
    (its heads, ``cfg.shard``). ``fsdp_serve`` (a mesh only; off by
    default, as in JAX) keeps only the rank's shares over "data" of its
    slice (``sharding.serve_shares``, cut after the plans are made on the
    slice) and every step gathers a layer at a time.
    """

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 max_prompt_len: int = 128, max_new_tokens: int = 64,
                 refine_plans: bool = False,
                 cache_len: Optional[int] = None, paged: bool = True,
                 page_size: int = 16, prefill_chunk: Optional[int] = None,
                 kv_format: Optional[str] = None,
                 num_pages: Optional[int] = None,
                 warm_cache_mb: float = 0.0, share_prefix: bool = True,
                 speculate=None, spec_k: int = 4,
                 admission: str = "fifo",
                 attn_path: str = "auto", device: DeviceLike = None,
                 mesh=None, fsdp_serve: bool = False):
        if admission not in ("fifo", "priority"):
            raise ValueError(f"admission must be 'fifo' or 'priority', "
                             f"got {admission!r}")
        T.check_family(cfg)
        self.layout = None if mesh is None else sharding.Layout(cfg, mesh)
        # the slots whose per-slot state this rank holds (None: all)
        self._slot_rows = None if self.layout is None \
            else self.layout.rows(int(max_batch))
        global_cfg = cfg
        if self.layout is not None:
            params = sharding.shard_params(params, mesh, cfg)
            cfg = self.layout.local_cfg()
        self.admission = admission
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.max_prompt_len = int(max_prompt_len)
        self.max_new_tokens = int(max_new_tokens)
        # rwkv holds no KV cache: nothing to page
        self.paged = bool(paged) and cfg.family != "rwkv"
        # chunked prefill whenever the paged engine was asked for (rwkv's
        # too); the ring engine prefills each prompt whole
        self.chunked = bool(paged)
        self.page_size = int(page_size)
        self.kv_format = kv_format or DEFAULT_KV_FORMAT
        if get_kv_format(self.kv_format).quantized:
            if cfg.attn_free:
                raise ValueError(
                    f"kv_format {self.kv_format!r} does not apply to "
                    f"{cfg.family!r} archs — they hold no KV cache to "
                    f"quantize; use kv_fp16")
            if not self.paged:
                raise ValueError(
                    f"kv_format {self.kv_format!r} quantizes KV blocks, "
                    f"which needs the paged cache (paged=True)")
        ps = self.page_size if self.paged else None
        if cache_len is None:
            self.cache_len = serve_cache_len(cfg, max_prompt_len,
                                             max_new_tokens, ps)
        else:
            self.cache_len = int(cache_len) if ps is None \
                else -(-int(cache_len) // ps) * ps
        # a recurrent carry must consume every prompt token: no prefix is
        # ever skipped
        self.share_prefix = bool(share_prefix) and self.paged \
            and cfg.family not in T.CARRY_FAMILIES
        self.warm_bytes = int(float(warm_cache_mb) * (1 << 20)) \
            if self.share_prefix else 0
        if self.paged:
            self.pages_slot = self.cache_len // self.page_size
            self.num_pages = int(
                num_pages if num_pages is not None
                else serve_num_pages(cfg, max_prompt_len, max_new_tokens,
                                     page_size=self.page_size,
                                     max_batch=self.max_batch))
            if self.num_pages < self.pages_slot + 1:
                raise ValueError(
                    f"num_pages={self.num_pages} cannot hold even one "
                    f"slot's window ({self.pages_slot} pages + the null "
                    f"block); size the pool with "
                    f"configs.shapes.serve_num_pages")
            # bytes one block occupies across every layer's pool leaves
            # (scales and pos tags included; all KV heads, on a mesh too):
            # the warm budget's unit
            one = kvc.init_pool(1, self.page_size, global_cfg.num_kv_heads,
                                cfg.head_dim, cfg.dtype, self.kv_format,
                                device="meta")
            self.block_bytes = cfg.num_layers * sum(
                t.numel() * t.element_size() for t in one if t is not None)
        else:
            self.pages_slot = self.num_pages = self.block_bytes = 0
        self.alloc = self._new_allocator()
        self.prefill_chunk = max(
            1, min(int(prefill_chunk) if prefill_chunk is not None else 32,
                   self.cache_len))
        # decode steps must not advance the carries of rows that are free
        # or still mid chunked prefill
        self._needs_active = self.chunked \
            and cfg.family in T.CARRY_FAMILIES

        # attention plans per regime (none for attention-free rwkv, whose
        # paths stay None; the ring engine's one path is "ring", and a
        # forced paged path is refused there in the planner's words)
        forced = None if attn_path == "auto" else attn_path
        # a rank's rows of a max_batch step: the attention and GEMM plans'
        # batch
        rows = None if self.layout is None \
            else self.layout.rows(self.max_batch)
        B_rank = self.max_batch if rows is None else rows.stop - rows.start
        attn_problem = None
        self.attn_path = self.prefill_attn_path = None
        self.kv_partitions = self.prefill_kv_partitions = None
        if not cfg.attn_free:
            attn_problem = planning.AttentionProblem(
                B=B_rank, Hq=cfg.num_heads, Hkv=cfg.num_kv_heads,
                D=cfg.head_dim, cache_len=self.cache_len,
                page_size=self.page_size, window=cfg.sliding_window,
                kv_format=self.kv_format, paged=self.paged,
                backend=self.device.type,
                act_bytes=torch.finfo(cfg.dtype).bits // 8)
            plan = planning.plan_attention(attn_problem, path=forced)
            self.attn_path, self.kv_partitions = plan.path, \
                plan.kv_partitions
            if self.paged:
                plan = planning.plan_attention(
                    dataclasses.replace(attn_problem, B=1,
                                        q_len=self.prefill_chunk),
                    path=forced)
            self.prefill_attn_path = plan.path
            self.prefill_kv_partitions = plan.kv_partitions

        self.spec_k = int(spec_k)
        self.proposer: Optional[spec.Proposer] = None
        if speculate is not None and speculate != "off":
            # a draft model runs whole on every rank: its config is built
            # from the target's whole one
            if isinstance(speculate, spec.Proposer):
                spec.validate_speculate(speculate.name, self.spec_k,
                                        cfg=global_cfg, paged=self.chunked)
                self.proposer = speculate
            else:
                spec.validate_speculate(str(speculate), self.spec_k,
                                        cfg=global_cfg, paged=self.chunked)
                self.proposer = spec.make_proposer(str(speculate),
                                                   target_cfg=global_cfg)
        # verify: q_len = k+1 queries per slot over the full batch
        if self.proposer is not None and attn_problem is not None:
            vf_plan = planning.plan_attention(
                dataclasses.replace(attn_problem, q_len=self.spec_k + 1),
                path=forced)
            self.verify_attn_path = vf_plan.path
            self.verify_kv_partitions = vf_plan.kv_partitions
        else:
            self.verify_attn_path = self.attn_path
            self.verify_kv_partitions = self.kv_partitions

        self.plans: Dict[str, planning.KernelPlan] = {}
        if cfg.w4a16_plan is None and any(
                isinstance(leaf, QuantizedTensor)
                for leaf in planning.quantized_leaves(params)):
            # plans keyed "KxN" at the widest step's M: the verify step's
            # B·(k+1) rows when speculating, else the decode step's B (a
            # rank's rows on a mesh, its own weight shards' KxN); the
            # other steps' GEMMs look up the same keys. A forced strategy
            # is planned here too, so one that cannot run the weights'
            # format is refused before serving starts.
            strategy = None if cfg.w4a16_strategy == "auto" \
                else cfg.w4a16_strategy
            M = B_rank * (self.spec_k + 1) \
                if self.proposer is not None else B_rank
            self.plans = planning.plan_for_params(params, M=M,
                                                  strategy=strategy,
                                                  refine=refine_plans)
            cfg = dataclasses.replace(cfg, w4a16_plan=self.plans)
        # the rank keeps its shares of the slice; every step gathers them
        self.fsdp_serve = bool(fsdp_serve and self.layout is not None)
        if self.fsdp_serve:
            params = sharding.serve_shares(params, self.layout)
        self.cfg = cfg
        self.params = T.unstack_layers(params)
        # the ring engine's whole-prompt prefill (eager: one step serves
        # every prompt length); the paged engine's prompt embedding and
        # encoder at admit
        self._prefill = rsteps.make_prefill_step(
            cfg, self.cache_len, fsdp_serve=self.fsdp_serve)
        self._embed = rsteps.make_embed_step(cfg, fsdp_serve=self.fsdp_serve)
        self._encode = rsteps.make_encode_step(cfg,
                                               fsdp_serve=self.fsdp_serve)
        self._serve_fns: Dict[Optional[int], Any] = {}
        self._chunk_fns: Dict[Optional[int], Any] = {}
        self._verify_fns: Dict[Optional[int], Any] = {}
        self._tables: Optional[np.ndarray] = None
        self._keys_cache: Dict[int, Any] = {}   # id(req) → prefix keys
        # slot → the side rows of a slot this rank does not hold, while it
        # prefills (a mesh whose data axis splits the slots)
        self._side: Dict[int, Any] = {}
        self._reserve: Dict[int, int] = {}      # slot → outstanding worst-
                                                # case future allocations
        self.last_state = None

        self.metrics: Optional[rmetrics.MetricsRegistry] = None
        self.report: Optional[ServeReport] = None
        self._started = False
        self._waiting: collections.deque = collections.deque()
        self._slots: List[Optional[_Slot]] = []
        self._state = None
        self._tok = self._pos = None
        self._step_no = 0
        self._events: Optional[StepEvents] = None

    def _new_allocator(self) -> Optional[kvc.BlockAllocator]:
        if not self.paged:
            return None
        return kvc.BlockAllocator(self.num_pages, self.page_size,
                                  warm_bytes=self.warm_bytes,
                                  block_bytes=self.block_bytes)

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
                live_pages=live_pages, fsdp_serve=self.fsdp_serve)
        return fn

    def _chunk_step(self, live_pages: Optional[int] = None):
        fn = self._chunk_fns.get(live_pages)
        if fn is None:
            fn = self._chunk_fns[live_pages] = \
                rsteps.make_prefill_chunk_step(
                    self.cfg, self.cache_len, kv_format=self.kv_format,
                    attn_path=self.prefill_attn_path,
                    kv_partitions=self.prefill_kv_partitions,
                    live_pages=live_pages, fsdp_serve=self.fsdp_serve)
        return fn

    def _verify_step(self, live_pages: Optional[int] = None):
        """The speculative verify step: (B, spec_k+1) positions per call,
        in place of plain decode whenever a proposer is wired (a slot
        without drafts pads its row to one live position)."""
        fn = self._verify_fns.get(live_pages)
        if fn is None:
            fn = self._verify_fns[live_pages] = rsteps.make_verify_step(
                self.cfg, self.cache_len, kv_format=self.kv_format,
                attn_path=self.verify_attn_path,
                kv_partitions=self.verify_kv_partitions,
                live_pages=live_pages, fsdp_serve=self.fsdp_serve)
        return fn

    def _prefill_inputs(self, req: Request):
        """The ring engine's whole-prompt prefill inputs for ``req`` (B =
        1): its tokens, and its patches or audio frames where the arch
        takes them."""
        inputs = {"tokens": torch.as_tensor(
            np.asarray(req.prompt, np.int64), device=self.device)[None]}
        if self.cfg.vision_prefix:
            inputs["prefix_embeds"] = self.vision_embeds(req)[None]
        if self.cfg.family == "encdec":
            inputs["audio_embeds"] = self._audio_embeds(req)[None]
        return inputs

    def _init_state(self):
        rows = self._slot_rows
        n = self.max_batch if rows is None else rows.stop - rows.start
        if not self.paged:
            return T.init_decode_state(self.cfg, n, self.cache_len,
                                       device=self.device)
        return T.init_paged_state(
            self.cfg, n, self.cache_len, page_size=self.page_size,
            num_blocks=self.num_pages, kv_format=self.kv_format,
            device=self.device)

    def _local_row(self, i: int) -> Optional[int]:
        """Slot ``i``'s row in this rank's per-slot state, None where
        another data rank holds it."""
        rows = self._slot_rows
        if rows is None:
            return i
        return i - rows.start if rows.start <= i < rows.stop else None

    def _slot_state(self, i: int):
        """(the state slot ``i``'s prefill chunk runs on, its row there):
        the rank's state at the slot's own row, or the slot's side rows
        (:attr:`_side`) beside the rank's KV pool."""
        side = self._side.get(i)
        if side is None:
            return self._state, self._local_row(i)
        state = dict(self._state, **side)
        state["cache"] = dict(self._state["cache"], **side["cache"])
        return state, 0

    def _reset_carry(self, i: int) -> None:
        """Zero slot ``i``'s recurrent carry rows before its chunked
        prefill streams the prompt through them (on a rank that does not
        hold the slot: side rows at zero)."""
        j = self._local_row(i)
        if j is None:
            self._side[i] = T.init_slot_state(self.cfg, 1, self.device)
            return
        for name, leaf in self._state["cache"].items():
            if name in T.CARRY_LEAVES:
                leaf[:, j] = 0

    def _insert_enc_kv(self, i: int, req: Request) -> None:
        """Run the encoder and every decoder layer's cross K/V projection
        over ``req``'s audio and write them into slot ``i``'s rows of the
        state's ``enc_kv`` (on a rank that does not hold the slot: side
        rows, read by its prefill chunks): the only whole-sequence work
        outside the chunk step (it reads the audio, not the prompt, so
        chunking does not apply)."""
        ek, ev = self._encode(self.params, self._audio_embeds(req)[None])
        j = self._local_row(i)
        if j is None:
            self._side[i] = {"cache": {}, "enc_kv": (ek, ev)}
            return
        sk, sv = self._state["enc_kv"]
        sk[:, j] = ek[:, 0]
        sv[:, j] = ev[:, 0]

    def _apply_carry_selection(self, carries, sel) -> None:
        """Commit the verify step's carry checkpoints: row b takes
        checkpoint ``sel[b]`` (0 restores the pre-verify carry of an
        inactive row, n the carry after n consumed positions, 1 +
        accepted drafts for an active one), for the rows this rank holds.
        The verify step leaves the state's carries untouched, so this is
        their only writer."""
        if self._slot_rows is not None:
            sel = sel[self._slot_rows]
        idx = torch.as_tensor(sel, device=self.device).long()
        rows = torch.arange(len(sel), device=self.device)
        cache = self._state["cache"]
        for name, stack in carries.items():
            cache[name].copy_(stack[:, rows, idx])

    # -- paged block bookkeeping ------------------------------------------

    def _pool(self) -> kvc.PagedKVCache:
        return self._state["cache"]["kv"]

    def _consume_reserve(self, i: int) -> None:
        self._reserve[i] = max(0, self._reserve.get(i, 0) - 1)

    def _drain_reclaimed(self) -> None:
        """Wipe the tags of blocks the allocator evicted from the warm set
        since the last drain (their stale tags would read as valid context
        for the next owner)."""
        bids = self.alloc.take_reclaimed()
        if bids:
            kvc.reset_blocks(self._pool(), bids)

    def _ensure_pages(self, i: int, offsets, txn=None) -> None:
        """Make the pages covering logical ``offsets`` writable for slot
        ``i``: allocate unmapped pages, copy-on-write shared ones (the
        first divergent write of prefix sharing). With ``txn`` (a list)
        every reversible mapping change is recorded — ("alloc", page, bid)
        / ("cow", page, old, new) — for :meth:`_rollback_pages`."""
        if not self.paged:
            return
        tbl = self._tables[i]
        for p in sorted({o // self.page_size for o in offsets}):
            bid = int(tbl[p])
            if bid < 0:
                tbl[p] = self.alloc.alloc()
                self._consume_reserve(i)
                if txn is not None:
                    txn.append(("alloc", p, int(tbl[p])))
            elif self.alloc.refcount(bid) > 1:
                new = self.alloc.cow(bid)
                self._consume_reserve(i)
                kvc.copy_blocks(self._pool(), bid, new)
                tbl[p] = new
                if txn is not None:
                    txn.append(("cow", p, bid, new))
            else:
                # exclusive owner writing in place: the block's published
                # key no longer describes its bytes (a wrapped decode
                # recycles its prompt pages)
                self.alloc.unpublish(bid)
        # allocation pressure may have evicted warm blocks
        self._drain_reclaimed()

    def _rollback_pages(self, i: int, txn, last_page: int) -> None:
        """Undo a speculative step's page mappings beyond ``last_page``
        (the page holding the last accepted position): fresh allocations
        are unmapped and freed; copied pages re-adopt the shared block
        (the copy is dropped before any divergent content was committed),
        so a shared prefix never points at rejected-draft bytes. In-place
        unpublishes stay unpublished. Entries at or below ``last_page``
        stay: tag masking keeps a kept page's stale tail invisible."""
        if not self.paged:
            return
        tbl = self._tables[i]
        freed = []
        for op in reversed(txn):
            if op[1] <= last_page:
                continue
            if op[0] == "alloc":
                _, p, bid = op
                tbl[p] = -1
                if self.alloc.decref(bid):
                    freed.append(bid)
            else:                               # ("cow", p, old, new)
                _, p, old, new = op
                self.alloc.incref(old)          # retake the shared ref
                tbl[p] = old
                if self.alloc.decref(new):
                    freed.append(new)
            self._reserve[i] = self._reserve.get(i, 0) + 1
        if freed:
            kvc.reset_blocks(self._pool(), freed)

    def _embeds(self, value, rows: int) -> torch.Tensor:
        """A request's frontend embeddings (rows, d) on the device in the
        model's dtype; zeros when the request carries none."""
        cfg = self.cfg
        if value is None:
            return torch.zeros((rows, cfg.d_model), dtype=cfg.dtype,
                               device=self.device)
        return torch.as_tensor(value, dtype=cfg.dtype, device=self.device)

    def vision_embeds(self, req: Request) -> torch.Tensor:
        """``req``'s patch embeddings (vision_prefix, d) on the device in
        the model's dtype (zeros when it carries none)."""
        return self._embeds(req.prefix_embeds, self.cfg.vision_prefix)

    def _audio_embeds(self, req: Request) -> torch.Tensor:
        return self._embeds(req.audio_embeds, self.cfg.encoder_seq)

    def _prefix_keys(self, req: Request):
        """(stream length, (full page keys, partial)) for ``req``, hashed
        once per request: the vision patches are ``E`` units ahead of the
        prompt's tokens, and encdec's audio seeds the chain (decoder K/V
        at every position depend on it through cross-attention). Both
        hash the bytes of the model's dtype, as the JAX package does.
        Streams longer than the window share nothing (their offsets are
        no longer page-aligned prefix content)."""
        cached = self._keys_cache.get(id(req))
        if cached is None:
            cfg = self.cfg
            S_total = len(req.prompt) + cfg.vision_prefix
            keys = ([], None)
            if self.share_prefix and S_total <= self.cache_len:
                pe = _host_bytes(self.vision_embeds(req)) \
                    if cfg.vision_prefix else None
                seed = _host_bytes(self._audio_embeds(req)).tobytes() \
                    if cfg.family == "encdec" else b""
                keys = kvc.page_keys(kvc.position_units(req.prompt, pe),
                                     self.page_size, seed=seed)
            cached = self._keys_cache[id(req)] = (S_total, keys)
        return cached

    def _try_share(self, i: int, keys) -> int:
        """Map slot ``i``'s page-aligned prompt prefix onto published
        blocks; returns how many leading positions are covered."""
        full_keys, partial = keys
        tbl = self._tables[i]
        shared = 0
        for pi, key in enumerate(full_keys):
            bid = self.alloc.lookup(key)
            if bid is None:
                return shared
            tbl[pi] = bid
            shared = (pi + 1) * self.page_size
        if partial is not None:
            key, fill = partial
            bid = self.alloc.lookup(key)
            if bid is not None:
                tbl[len(full_keys)] = bid
                shared = len(full_keys) * self.page_size + fill
        return shared

    def _publish_keys(self, i: int, slot: _Slot,
                      upto: Optional[int] = None) -> None:
        """Index slot ``i``'s prefix pages for sharing; ``upto`` (a prefill
        frontier) limits it to fully written pages, so a concurrently
        admitted identical prompt adopts pages as its peer writes them."""
        full_keys, partial = slot.pf_keys
        tbl = self._tables[i]
        done = slot.pf_total if upto is None else upto
        for pi, key in enumerate(full_keys):
            if (pi + 1) * self.page_size <= done and tbl[pi] >= 0:
                self.alloc.publish(key, int(tbl[pi]))
        if partial is not None and done >= slot.pf_total \
                and tbl[len(full_keys)] >= 0:
            self.alloc.publish(partial[0], int(tbl[len(full_keys)]))

    def _share_ahead(self, i: int, slot: _Slot) -> None:
        """Adopt prefix pages published since this slot's admit (a peer
        prefilling the same prompt a few chunks ahead): each unwritten page
        at the prefill frontier whose key is now indexed maps to the shared
        block and its positions are skipped. The final position is always
        computed locally (it produces the first token's logits)."""
        full_keys, partial = slot.pf_keys
        if not full_keys and partial is None:
            return
        tbl = self._tables[i]
        ps = self.page_size
        while slot.pf_next < slot.pf_total - 1 and slot.pf_next % ps == 0:
            p = slot.pf_next // ps
            if tbl[p] >= 0:
                break
            if p < len(full_keys):
                bid = self.alloc.lookup(full_keys[p])
                if bid is None:
                    break
                tbl[p] = bid
                slot.pf_next = min((p + 1) * ps, slot.pf_total - 1)
            else:
                if partial is not None:
                    bid = self.alloc.lookup(partial[0])
                    if bid is not None:
                        tbl[p] = bid
                        slot.pf_next = min(p * ps + partial[1],
                                           slot.pf_total - 1)
                break

    def _required_pages(self, req: Request) -> int:
        """Worst-case new blocks this request may need (the admit gate).
        Live shared prefix pages are discounted, minus one for a possible
        divergent-write copy — only when decode cannot wrap the window (a
        wrapping decode may copy every shared page)."""
        if not self.paged:
            return 0
        S_total, (full_keys, partial) = self._prefix_keys(req)
        if S_total + req.max_new_tokens > self.cache_len:
            return self.pages_slot
        # warm pages already count on the supply side of the gate
        shared = 0
        for key in full_keys:
            bid = self.alloc.peek(key)
            if bid is None or self.alloc.is_warm(bid):
                break
            shared += 1
        else:
            if partial is not None:
                bid = self.alloc.peek(partial[0])
                if bid is not None and not self.alloc.is_warm(bid):
                    shared += 1
        return self.pages_slot - max(0, shared - 1)

    def _evict(self, i: int) -> None:
        self._reserve.pop(i, None)
        self._side.pop(i, None)
        if not self.chunked:
            j = self._local_row(i)
            if j is not None:
                reset_slot(self._state, j)
            return
        if not self.paged:
            return
        # decref may retain published prefix blocks warm instead of freeing
        # them; blocks the retention displaced land on the reclaimed list
        freed = [bid for bid in map(int, self._tables[i])
                 if bid >= 0 and self.alloc.decref(bid)]
        freed += self.alloc.take_reclaimed()
        self._tables[i] = -1
        if freed:
            kvc.reset_blocks(self._pool(), freed)

    # -- admit / prefill ---------------------------------------------------

    def pos0(self, req: Request) -> int:
        """First decode position: prompt + vision prefix (prefill wrote
        that many positions)."""
        return int(len(req.prompt)) + self.cfg.vision_prefix

    def _count(self, name: str, help: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.counter(name, help).inc(n)

    def _admit(self, req: Request, i: int, t0: float) -> _Slot:
        """Set up slot ``i`` for ``req``: share what the prefix index
        holds, then either prefill the rest in chunks or — when the warm
        or live prefix covers the whole prompt and its first token is
        cached — activate with zero prefill steps."""
        self._reserve[i] = self._required_pages(req)
        S_total, keys = self._prefix_keys(req)
        self._keys_cache.pop(id(req), None)
        slot = _Slot(req, self.pos0(req), t0)
        slot.pf_total = S_total
        shared = 0
        first_tok: Optional[int] = None
        if self.share_prefix:
            slot.pf_keys = keys
            warm_before = self.alloc.warm_pages
            shared = self._try_share(i, keys)
            warm_used = warm_before - self.alloc.warm_pages
            if self.alloc.warm_bytes > 0:
                if warm_used > 0:
                    self.report.warm_hits += 1
                else:
                    self.report.warm_misses += 1
                self._count("engine_warm_hits_total",
                            "admits that adopted warm prefix pages",
                            1 if warm_used > 0 else 0)
                self._count("engine_warm_misses_total",
                            "admits that found no warm prefix pages",
                            0 if warm_used > 0 else 1)
            if shared >= S_total:
                fk = self._final_key(keys)
                meta = self.alloc.meta(fk) if fk is not None else None
                if meta is not None:
                    first_tok = int(meta)
        C = self.prefill_chunk
        cold_steps = -(-S_total // C)
        if first_tok is not None:
            # the pool holds every prompt position and greedy decode from
            # it is deterministic: nothing to compute
            slot.pf_next = S_total
            saved = cold_steps
            slot.emit_first(first_tok)
            self._note_first(slot)
        else:
            shared = min(shared, S_total - 1)
            saved = cold_steps - (-(-(S_total - shared) // C))
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)
            emb = self._embed(self.params, prompt)
            if self.cfg.vision_prefix:
                emb = torch.cat([self.vision_embeds(req), emb])
            slot.pf_stream = emb
            slot.pf_next = shared
        if self.cfg.family in T.CARRY_FAMILIES:
            self._reset_carry(i)
        if self.cfg.family == "encdec":
            self._insert_enc_kv(i, req)
        if slot.phase != "prefill":
            self._side.pop(i, None)
        if self.share_prefix:
            self.report.prefill_steps_saved += saved
            if self.metrics is not None:
                self.metrics.histogram(
                    "engine_prefill_steps_saved",
                    "chunk steps avoided per admit by shared or warm "
                    "prefix pages").observe(saved)
        return slot

    def _admit_ring(self, req: Request, i: int, t0: float,
                    pending) -> _Slot:
        """The ring engine's admit: prefill ``req``'s whole prompt into a
        one-slot ring state and write it into slot ``i``'s row (on a mesh,
        on the rank that holds the row; the others drop it). The first
        token's logits join ``pending``."""
        inputs = self._prefill_inputs(req)
        logits, rstate = self._prefill(self.params, inputs)
        j = self._local_row(i)
        if j is not None:
            insert_slot(self._state, rstate, j)
        del rstate
        slot = _Slot(req, self.pos0(req), t0)
        pending.append((slot, logits[0]))
        return slot

    def _advance_prefill(self, i: int, slot: _Slot, pending) -> None:
        """Run one prefill chunk for slot ``i``."""
        C = self.prefill_chunk
        self._share_ahead(i, slot)
        start, total = slot.pf_next, slot.pf_total
        end = min(start + C, total)
        self._ensure_pages(i, {p % self.cache_len for p in range(start, end)})
        seg = slot.pf_stream[start:end]
        n = end - start
        if n < C:
            seg = torch.cat([seg, seg.new_zeros((C - n, seg.shape[-1]))])
        positions = np.full((C,), -1, np.int32)
        positions[:n] = np.arange(start, end, dtype=np.int32)
        state, row = self._slot_state(i)
        inputs = {
            "h": seg[None],
            "positions": torch.as_tensor(positions,
                                         device=self.device)[None],
            "slot": row,
        }
        if self.paged:
            inputs["table"] = torch.as_tensor(self._tables[i:i + 1],
                                              device=self.device)
        lp = None
        if self.prefill_attn_path == "gather" and start < self.cache_len:
            # gather reads pool entries < start only
            lp = self._live_bucket(max(1, -(-start // self.page_size)))
        res = self._chunk_step(lp)(self.params, state, inputs)
        slot.pf_next = end
        if end == total:
            self._side.pop(i, None)
            self._publish_keys(i, slot)
            pending.append((slot, res["logits"][0]))
        else:
            self._publish_keys(i, slot, upto=end)

    def _flush_first_tokens(self, pending) -> None:
        """Emit the first token of every slot whose prefill completed: one
        device argmax over the stacked rows, one host transfer."""
        if not pending:
            return
        rows = torch.stack([row for _, row in pending])
        firsts = torch.argmax(rows, dim=-1).cpu().tolist()
        for (slot, row), t in zip(pending, firsts):
            slot.emit_first(int(t))
            self.report.prefill_logits[slot.req.rid] = row
            self._note_first(slot)
            self._cache_first_token(slot)

    def _cache_first_token(self, slot: _Slot) -> None:
        """Attach the first token to the prompt's final chain key: a later
        admit whose prefix covers the whole prompt then skips prefill
        (greedy decode makes it a function of the hashed prompt)."""
        if not self.share_prefix:
            return
        fk = self._final_key(slot.pf_keys)
        if fk is not None and slot.tokens:
            self.alloc.set_meta(fk, int(slot.tokens[0]))

    def _note_first(self, slot: _Slot) -> None:
        """Record TTFT and queue the first token on the step's events."""
        rid = slot.req.rid
        ttft = time.perf_counter() - slot.t_admit
        self.report.ttft[rid] = ttft
        if self._events is not None:
            self._events.emitted.setdefault(rid, []).append(slot.tokens[-1])
        if self.metrics is not None:
            self.metrics.histogram(
                "engine_ttft_seconds",
                "admit to first token, per request").observe(ttft)

    def _final_key(self, keys) -> Optional[str]:
        """The chain key covering a prompt's last position."""
        full_keys, partial = keys
        if partial is not None:
            return partial[0]
        return full_keys[-1] if full_keys else None

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
        cfg = self.cfg
        for name, value, rows in (
                ("prefix_embeds", r.prefix_embeds, cfg.vision_prefix),
                ("audio_embeds", r.audio_embeds,
                 cfg.encoder_seq if cfg.family == "encdec" else 0)):
            if value is None:
                continue
            if not rows:
                raise ValueError(f"request {r.rid}: {cfg.name} takes no "
                                 f"{name}")
            if tuple(np.shape(value)) != (rows, cfg.d_model):
                raise ValueError(
                    f"request {r.rid}: {name} must be {rows} x "
                    f"{cfg.d_model}, got {tuple(np.shape(value))}")

    def start(self) -> None:
        """Arm the stepper: fresh scheduler state, empty report, a zeroed
        pool and a fresh allocator (warm blocks' bytes are gone with the
        old pool, so run boundaries start cold). Plans and step functions
        live as long as the engine."""
        self._waiting = collections.deque()
        self._slots = [None] * self.max_batch
        self.report = ServeReport(results={}, latencies={})
        self._tables = np.full((self.max_batch, self.pages_slot), -1,
                               np.int32)
        self._reserve.clear()
        self._keys_cache.clear()
        self.alloc = self._new_allocator()
        self._state = self._init_state()
        if self.proposer is not None:
            self.proposer.reset(self)
        self._tok = np.zeros(self.max_batch, np.int32)
        self._pos = np.zeros(self.max_batch, np.int32)
        self._step_no = 0
        self._events = None
        self._started = True

    def submit(self, req: Request) -> None:
        """Queue ``req`` for admission (validated now)."""
        if not self._started:
            raise RuntimeError("ServingEngine.submit() before start()")
        self._validate(req)
        self._waiting.append(req)

    def cancel(self, rid: int) -> bool:
        """Cancel request ``rid`` wherever it is: drop it from the waiting
        queue, or evict its slot mid-decode / mid-prefill and decref its
        pages (shared blocks stay with their peers). Tokens emitted so far
        land in ``report.cancelled[rid]``. Returns False if ``rid`` is not
        resident. Call between steps."""
        if not self._started:
            return False
        for idx, r in enumerate(self._waiting):
            if r.rid == rid:
                del self._waiting[idx]
                self._keys_cache.pop(id(r), None)
                self.report.cancelled[rid] = []
                self._count("engine_cancelled_total",
                            "requests cancelled while queued or resident")
                return True
        for i, s in enumerate(self._slots):
            if s is not None and s.req.rid == rid:
                self.report.cancelled[rid] = list(s.tokens)
                self._evict(i)
                if self.proposer is not None:
                    self.proposer.evict(self, i)
                self._slots[i] = None
                self._count("engine_cancelled_total",
                            "requests cancelled while queued or resident")
                return True
        return False

    def has_work(self) -> bool:
        return self._started and (bool(self._waiting)
                                  or any(s is not None for s in self._slots))

    def drain(self, *, verbose: bool = False) -> ServeReport:
        while self.has_work():
            self.step(verbose=verbose)
        return self.report

    def _next_admissible(self) -> Optional[int]:
        """Waiting-queue index of the next request to admit, or None: the
        arrived queue head (FIFO), or the best arrived request by
        (priority desc, deadline asc, arrival, rid)."""
        w = self._waiting
        if not w:
            return None
        if self.admission == "fifo":
            return 0 if w[0].arrival_step <= self._step_no else None
        best = None
        for idx, r in enumerate(w):
            if r.arrival_step > self._step_no:
                continue
            key = (-(r.priority or 0),
                   r.deadline_s if r.deadline_s is not None else math.inf,
                   r.arrival_step, r.rid)
            if best is None or key < best[0]:
                best = (key, idx)
        return None if best is None else best[1]

    def _finish(self, i: int, slot: _Slot) -> None:
        rid = slot.req.rid
        self.report.results[rid] = slot.tokens
        self.report.latencies[rid] = time.perf_counter() - slot.t_admit
        self._evict(i)
        if self.proposer is not None:
            self.proposer.evict(self, i)
        self._slots[i] = None
        if self._events is not None:
            self._events.finished.append(rid)
        if self.metrics is not None:
            self.metrics.histogram(
                "engine_e2e_seconds", "admit to finish, per request").observe(
                self.report.latencies[rid])

    def _sample_metrics(self, ev: StepEvents, decode_dt: float) -> None:
        """Per-step metrics sample (queue depth, residency, pages, rates)."""
        m = self.metrics
        if m is None:
            return
        m.counter("engine_steps_total", "scheduler steps executed").inc()
        n_tok = sum(len(v) for v in ev.emitted.values())
        if n_tok:
            m.counter("engine_tokens_total", "tokens emitted").inc(n_tok)
        if decode_dt > 0.0:
            m.histogram("engine_step_seconds",
                        "decode/verify wall time per step").observe(decode_dt)
            if n_tok:
                m.histogram("engine_token_seconds",
                            "decode wall time per emitted token").observe(
                    decode_dt / n_tok)
        m.gauge("engine_queue_depth",
                "requests waiting for a slot").set(len(self._waiting))
        m.gauge("engine_active_slots", "slots decoding or prefilling").set(
            sum(1 for s in self._slots if s is not None))
        if self.paged:
            m.gauge("engine_pages_in_use",
                    "live KV blocks").set(self.alloc.pages_in_use)
            m.gauge("engine_warm_pages",
                    "refcount-0 prefix blocks retained warm").set(
                self.alloc.warm_pages)
        if self.attn_path is not None:
            m.gauge("engine_attn_path",
                    "decode attention path (0=ring 1=gather 2=fused)").set(
                _PATH_CODE.get(self.attn_path, -1))
            m.counter(f"engine_attn_path_steps_{self.attn_path}",
                      "scheduler steps served by this attention path").inc()
            if self.chunked:
                m.gauge("engine_prefill_attn_path",
                        "chunked-prefill attention path "
                        "(0=ring 1=gather 2=fused)").set(
                    _PATH_CODE.get(self.prefill_attn_path, -1))
            if self.proposer is not None:
                m.gauge("engine_verify_attn_path",
                        "speculative-verify attention path "
                        "(0=ring 1=gather 2=fused)").set(
                    _PATH_CODE.get(self.verify_attn_path, -1))
        if self.proposer is not None:
            m.gauge("engine_acceptance_rate",
                    "accepted/proposed draft tokens").set(
                self.report.acceptance_rate)

    def step(self, *, verbose: bool = False) -> StepEvents:
        """Admit arrived requests into free slots, advance one prefill
        chunk per prefilling slot, run one batched decode (or speculative
        verify) step over the active slots, evict finished slots. Returns
        the step's :class:`StepEvents`."""
        if not self._started:
            raise RuntimeError("ServingEngine.step() before start()")
        ev = StepEvents(step=self._step_no)
        if not self.has_work():
            ev.worked = False
            return ev
        self._events = ev
        try:
            with torch.no_grad():
                decode_dt = self._step_body(ev, verbose)
        finally:
            self._events = None
        self.report.steps = self._step_no
        self.last_state = self._state
        self._sample_metrics(ev, decode_dt)
        return ev

    def _note_peak_pages(self) -> None:
        if self.paged:
            self.report.peak_pages = max(self.report.peak_pages,
                                         self.alloc.pages_in_use)

    def _step_tables(self) -> torch.Tensor:
        """Block tables with every non-active row masked to -1 (its stale
        writes redirect to the null block)."""
        tables = self._tables.copy()
        for i, s in enumerate(self._slots):
            if s is None or s.phase != "active":
                tables[i] = -1
        return torch.as_tensor(tables, device=self.device)

    def _step_body(self, ev: StepEvents, verbose: bool) -> float:
        report, slots = self.report, self._slots
        tok, pos = self._tok, self._pos
        step = self._step_no
        pending: List[Any] = []
        admitted = 0
        for i in range(self.max_batch):
            idx = self._next_admissible()
            if idx is None:
                break
            if slots[i] is not None:
                continue
            cand = self._waiting[idx]
            if self.paged and self._required_pages(cand) \
                    + sum(self._reserve.values()) \
                    > self.alloc.pages_free + self.alloc.warm_pages:
                break               # pool too full — wait for evictions
            del self._waiting[idx]
            t0 = time.perf_counter()
            if self.chunked:
                slot = self._admit(cand, i, t0)
            else:
                slot = self._admit_ring(cand, i, t0, pending)
            if self.proposer is not None:
                slot.prompt_ids = [int(t) for t in
                                   np.asarray(cand.prompt).reshape(-1)]
                self.proposer.admit(self, i, slot)
            report.prefill_s += time.perf_counter() - t0
            report.admitted += 1
            slots[i] = slot
            ev.admitted.append(cand.rid)
            admitted += 1
        if admitted:
            self._count("engine_admitted_total",
                        "requests admitted into a slot", admitted)

        # (pf_stream is None for warm full hits: nothing left to compute)
        for i, s in enumerate(slots):
            if s is not None and s.phase == "prefill" \
                    and s.pf_stream is not None:
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
            return 0.0
        if self.proposer is not None:
            dt = self._speculate(ev, active, admitted, verbose)
        else:
            dt = self._decode(ev, active, admitted, verbose)
        self._step_no = step + 1
        return dt

    def _decode(self, ev: StepEvents, active, admitted: int,
                verbose: bool) -> float:
        """One batched decode step over every slot."""
        report, slots = self.report, self._slots
        tok, pos = self._tok, self._pos
        for i in active:
            self._ensure_pages(i, [int(pos[i]) % self.cache_len])
        self._note_peak_pages()
        t0 = time.perf_counter()
        inputs = {
            "state": self._state,
            "tokens": torch.as_tensor(tok, device=self.device),
            "pos": torch.as_tensor(pos, device=self.device),
        }
        if self.paged:
            inputs["tables"] = self._step_tables()
        if self._needs_active:
            act = np.zeros(self.max_batch, bool)
            act[active] = True
            inputs["active"] = torch.as_tensor(act, device=self.device)
        lp = None
        if self.attn_path == "gather":
            mx = max(int(pos[i]) for i in active)
            if mx < self.cache_len:
                # insert before attend: entries <= mx are read
                lp = self._live_bucket(-(-(mx + 1) // self.page_size))
        res = self._serve_step(lp)(self.params, inputs)
        self._state = res["state"]
        nxt = res["next"].cpu().numpy()       # syncs the device
        dt = time.perf_counter() - t0
        report.decode_s += dt
        report.decode_tokens += len(active)
        report.step_records.append({
            "step": self._step_no, "active": len(active),
            "admitted": admitted, "decode_ms": dt * 1e3})
        if verbose:
            print(f"[engine] step {self._step_no}: active={len(active)} "
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
        return dt

    def _speculate(self, ev: StepEvents, active, admitted: int,
                   verbose: bool) -> float:
        """Propose → verify → accept → roll back, over every active slot."""
        report, slots = self.report, self._slots
        tok, pos = self._tok, self._pos
        k = self.spec_k
        views = [spec.ProposalView(i, slots[i].prompt_ids + slots[i].tokens,
                                   int(pos[i])) for i in active]
        t0 = time.perf_counter()
        proposals = self.proposer.propose(views, k)
        C = k + 1
        ptok = np.zeros((self.max_batch, C), np.int32)
        ppos = np.full((self.max_batch, C), -1, np.int32)
        n_drafts: Dict[int, int] = {}
        txns: Dict[int, list] = {}
        for i in active:
            s = slots[i]
            props = list(proposals.get(i, []))[:k]
            # clamp: never emit past the request's budget, and never let
            # the draft overhang wrap the window (a wrapped speculative
            # write would destroy a still-in-window entry)
            n = min(len(props), s.remaining - 1)
            if int(pos[i]) + n >= self.cache_len:
                n = max(0, self.cache_len - 1 - int(pos[i]))
            n_drafts[i] = n
            report.proposed_tokens += n
            ptok[i, 0], ppos[i, 0] = tok[i], pos[i]
            for j in range(n):
                ptok[i, j + 1] = int(props[j])
                ppos[i, j + 1] = int(pos[i]) + j + 1
            txns[i] = []
            self._ensure_pages(
                i, [p % self.cache_len
                    for p in range(int(pos[i]), int(pos[i]) + n + 1)],
                txn=txns[i])
        self._note_peak_pages()
        inputs = {
            "tokens": torch.as_tensor(ptok, device=self.device),
            "positions": torch.as_tensor(ppos, device=self.device),
        }
        if self.paged:
            inputs["tables"] = self._step_tables()
        lp = None
        if self.verify_attn_path == "gather":
            mx = max(int(pos[i]) for i in active)
            if mx + k < self.cache_len:
                # gather reads pool entries < positions[:, 0] only
                lp = self._live_bucket(max(1, -(-mx // self.page_size)))
        res = self._verify_step(lp)(self.params, self._state, inputs)
        self._state = res["state"]
        nxt = res["next"].cpu().numpy()              # (B, C)
        dt = time.perf_counter() - t0
        report.decode_s += dt
        emitted_total = 0
        # exact greedy acceptance: draft j survives iff it equals the
        # target's argmax at position j-1; the first mismatch adds the
        # target's own choice
        accepted: Dict[int, int] = {}
        for i in active:
            a = 0
            while a < n_drafts[i] and int(ptok[i, a + 1]) == int(nxt[i, a]):
                a += 1
            accepted[i] = a
        carries = res.get("carries")
        del res
        if carries is not None:
            # the carry after the last emitted token's input: checkpoint
            # 1 + accepted (0 keeps an inactive row's carry)
            sel = np.zeros(self.max_batch, np.int64)
            for i in active:
                sel[i] = accepted[i] + 1
            self._apply_carry_selection(carries, sel)
            del carries
        for i in active:
            s = slots[i]
            a = accepted[i]
            emitted = [int(nxt[i, j]) for j in range(a + 1)]
            report.accepted_tokens += a
            self._rollback_pages(
                i, txns[i],
                ((int(pos[i]) + a) % self.cache_len) // self.page_size)
            emitted_total += len(emitted)
            s.tokens.extend(emitted)
            ev.emitted.setdefault(s.req.rid, []).extend(emitted)
            s.remaining -= len(emitted)
            s.pos_next += len(emitted)
            tok[i], pos[i] = emitted[-1], s.pos_next
            if s.remaining == 0:
                self._finish(i, s)
        report.decode_tokens += emitted_total
        report.step_records.append({
            "step": self._step_no, "active": len(active),
            "admitted": admitted, "decode_ms": dt * 1e3,
            "emitted": emitted_total})
        if verbose:
            print(f"[engine] step {self._step_no}: active={len(active)} "
                  f"emitted={emitted_total} {dt * 1e3:.2f} ms")
        return dt

    def run(self, requests, *, verbose: bool = False) -> ServeReport:
        """Serve ``requests`` to completion (start → submit in (arrival,
        rid) order → drain)."""
        for r in requests:
            self._validate(r)
        self.start()
        for r in sorted(requests, key=lambda r: (r.arrival_step, r.rid)):
            self.submit(r)
        return self.drain(verbose=verbose)
