"""Speculative decoding proposers for the paged serving engine (port of
``repro/runtime/speculative.py``).

Decode GEMMs at small M are weight-traffic bound (K >> N: each generated
token fetches the whole weight matrix); scoring k draft tokens in one
forward pass multiplies tokens per weight fetch. This module supplies the
proposal side; the engine owns the batched verify step
(``steps.make_verify_step``), exact greedy acceptance, and
allocator-level rollback.

  :class:`NgramProposer`      — prompt lookup: the longest recent n-gram
      match of the slot's context suffix proposes the tokens that
      followed it. No second model, no extra state.
  :class:`DraftModelProposer` — a small draft model decoding ahead on a
      per-slot ring state. It is fed the *accepted* tokens between rounds
      (catch-up), so its cache agrees with the target's committed stream.

Proposers only ever *suggest* tokens: the engine accepts the longest
prefix of drafts equal to the target's own greedy choices, so the emitted
text is the non-speculative decode's whatever a proposer proposes.

On a mesh every rank runs the same proposer on the same host-side stream
(the tokens are gathered over "data" each step), so every rank proposes
the same drafts; a draft model runs whole on every rank. The carry
families speculate with ngram (their draft model cannot rewind): each
rank commits checkpoint 1 + accepted of its own slots' carries.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.shapes import serve_cache_len
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import steps as rsteps

__all__ = [
    "Proposer", "ProposalView", "NgramProposer", "DraftModelProposer",
    "PROPOSERS", "available_proposers", "validate_speculate",
    "make_proposer",
]


class ProposalView(NamedTuple):
    """What a proposer sees of one active slot at propose time."""

    slot: int             # batch slot index
    context: List[int]    # prompt + emitted token ids (committed stream)
    pos_next: int         # target's next decode position


class Proposer:
    """Draft-token source for speculative decoding.

    Lifecycle (driven by the serving engine): ``reset`` once per run,
    ``admit``/``evict`` as slots turn over, ``propose`` once per verify
    step for every active slot. Proposals are suggestions of length 0..k
    per slot, clamped and verified by the engine.
    """

    name = "base"

    def reset(self, engine) -> None:
        pass

    def admit(self, engine, i: int, slot) -> None:
        pass

    def evict(self, engine, i: int) -> None:
        pass

    def propose(self, views: Sequence[ProposalView], k: int
                ) -> Dict[int, List[int]]:
        raise NotImplementedError


class NgramProposer(Proposer):
    """Prompt-lookup self-speculation: match the longest context suffix of
    length ``max_n..1`` against earlier context and propose the (up to) k
    tokens that followed its most recent match; nothing when no n-gram
    recurs (that slot then verifies one position, as plain decode)."""

    name = "ngram"

    def __init__(self, max_n: int = 3):
        if max_n < 1:
            raise ValueError(f"ngram max_n must be >= 1, got {max_n}")
        self.max_n = int(max_n)

    def propose(self, views, k):
        out: Dict[int, List[int]] = {}
        for view in views:
            ctx = view.context
            L = len(ctx)
            props: List[int] = []
            for n in range(min(self.max_n, L - 1), 0, -1):
                pat = ctx[L - n:]
                for j in range(L - n - 1, -1, -1):
                    if ctx[j:j + n] == pat:
                        props = ctx[j + n:j + n + k]
                        break
                if props:
                    break
            if props:
                out[view.slot] = props
        return out


class DraftModelProposer(Proposer):
    """Draft-model speculation: a small model decodes k tokens ahead.

    The draft holds a ring decode state with one row per engine slot (it
    never pages). Between rounds it is caught up on the accepted tokens
    from its frontier to the target's, then chained on its own argmax for
    the k proposals. Slots whose chain finished early re-feed their last
    (token, position) — a same-slot ring overwrite with identical content
    — which keeps the per-step batch dense.

    ``params`` are the draft's weights (the JAX package's, converted, in
    the parity tests); without them the draft draws random weights from a
    ``torch.Generator`` (``gen``, else one seeded with ``seed``) on the
    engine's device at :meth:`reset`. Recurrent carry families are
    refused: re-feed and rewind rely on cache writes keyed by position. So
    is an encdec draft: its ring prefill would need the request's audio,
    which the draft is not given (nor is the JAX package's). A draft of a
    vision-prefix target must share its frontend (the same prefix length
    and width): the request's patches feed both models.
    """

    name = "draft"

    def __init__(self, cfg: ModelConfig, params=None, *, seed: int = 1,
                 gen: Optional[torch.Generator] = None):
        if cfg.family in T.CARRY_FAMILIES:
            raise ValueError(
                f"draft speculation cannot use a {cfg.family!r} draft — "
                f"recurrent carry families {T.CARRY_FAMILIES} cannot "
                f"rewind rejected drafts (cache writes must be keyed by "
                f"position); use an attention-state draft or ngram")
        if cfg.family == "encdec":
            raise ValueError(
                f"draft speculation cannot use an 'encdec' draft — the "
                f"draft's ring prefill is not given the request's audio; "
                f"use ngram")
        T.check_family(cfg)
        self.cfg = cfg
        self.params = None if params is None else T.unstack_layers(params)
        self.seed, self.gen = int(seed), gen
        self.state = None
        self._step_fn = rsteps.make_serve_step(cfg)
        self._prefill_fns: Dict[int, object] = {}

    # -- lifecycle ---------------------------------------------------------

    def reset(self, engine) -> None:
        cfg = self.cfg
        if cfg.vision_prefix != engine.cfg.vision_prefix or (
                cfg.vision_prefix and cfg.d_model != engine.cfg.d_model):
            raise ValueError(
                f"draft cfg must match the target's vision frontend "
                f"(vision_prefix {cfg.vision_prefix} vs "
                f"{engine.cfg.vision_prefix}, d_model {cfg.d_model} vs "
                f"{engine.cfg.d_model}) — prefix embeds feed both models")
        self.voff = cfg.vision_prefix
        self.device = engine.device
        if self.params is None:
            gen = self.gen
            if gen is None:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self.seed)
            self.params = T.unstack_layers(
                T.init_params(gen, cfg, device=self.device))
        self.B = engine.max_batch
        # ring window: the full committed stream plus one chained draft
        # overhang; sliding-window clamping wraps as target decode does
        self.cache_len = serve_cache_len(
            cfg, engine.max_prompt_len,
            engine.max_new_tokens + engine.spec_k + 1)
        self.state = T.init_decode_state(cfg, self.B, self.cache_len,
                                         device=self.device)
        self.dpos = np.zeros(self.B, np.int64)     # next unfed position
        self.last_tok = np.zeros(self.B, np.int64)
        self.last_pos = np.zeros(self.B, np.int64)

    def _prefill(self):
        fn = self._prefill_fns.get(self.cache_len)
        if fn is None:
            fn = self._prefill_fns[self.cache_len] = \
                rsteps.make_prefill_step(self.cfg, self.cache_len)
        return fn

    def admit(self, engine, i: int, slot) -> None:
        prompt = np.asarray(slot.req.prompt, np.int64).reshape(-1)
        inputs = {"tokens": torch.as_tensor(prompt, device=self.device)[None]}
        if self.voff:
            inputs["prefix_embeds"] = engine.vision_embeds(slot.req).to(
                self.cfg.dtype)[None]
        with torch.no_grad():
            _, rstate = self._prefill()(self.params, inputs)
        # the B=1 prefill state overwrites row i whole, pos tags included
        for dst, src in zip(self.state["cache"]["kv"], rstate["cache"]["kv"]):
            dst[:, i] = src[:, 0].to(dst.dtype)
        pos0 = len(prompt) + self.voff
        self.dpos[i] = pos0
        self.last_tok[i] = int(prompt[-1])
        self.last_pos[i] = pos0 - 1

    def evict(self, engine, i: int) -> None:
        attention.cache_reset_slots(self.state["cache"]["kv"], i)
        self.dpos[i] = 0
        self.last_tok[i] = 0
        self.last_pos[i] = 0

    # -- proposal ----------------------------------------------------------

    def propose(self, views, k):
        if not views:
            return {}
        # per-slot feed schedules: the committed tokens from the draft's
        # frontier (rewound to the target's: stale speculative ring
        # entries are overwritten position by position before anything
        # queries them), then k-1 chained self-feeds
        feeds: Dict[int, List[tuple]] = {}
        chain_left: Dict[int, int] = {}
        for view in views:
            i, ctx, pos_next = view.slot, view.context, view.pos_next
            start = min(int(self.dpos[i]), pos_next)
            feeds[i] = [(ctx[q - self.voff], q)
                        for q in range(start, pos_next + 1)]
            chain_left[i] = k - 1
        out: Dict[int, List[int]] = {v.slot: [] for v in views}
        n_steps = max(len(feeds[i]) + chain_left[i] for i in feeds)
        collecting: Dict[int, bool] = {}
        for t in range(n_steps):
            tok = self.last_tok.copy()
            pos = self.last_pos.copy()
            for i, sched in feeds.items():
                if t < len(sched):
                    tok[i], pos[i] = sched[t]
                    collecting[i] = (t == len(sched) - 1)
                elif t < len(sched) + chain_left[i]:
                    tok[i] = out[i][-1]           # chain on own argmax
                    pos[i] = pos[i] + 1           # ... one position ahead
                    collecting[i] = True
                else:
                    collecting[i] = False
            with torch.no_grad():
                res = self._step_fn(self.params, {
                    "state": self.state,
                    "tokens": torch.as_tensor(tok, device=self.device),
                    "pos": torch.as_tensor(pos.astype(np.int32),
                                           device=self.device),
                })
            self.state = res["state"]
            nxt = res["next"].cpu().numpy()
            self.last_tok, self.last_pos = tok, pos
            for i in feeds:
                if collecting.get(i):
                    out[i].append(int(nxt[i]))
        for view in views:
            self.dpos[view.slot] = view.pos_next + k
        return out


# ---------------------------------------------------------------------------
# registry + validation (the launcher's up-front refusal path)
# ---------------------------------------------------------------------------

PROPOSERS = {"ngram": NgramProposer, "draft": DraftModelProposer}


def available_proposers() -> List[str]:
    return sorted(PROPOSERS)


def validate_speculate(speculate: Optional[str], spec_k: int, *,
                       cfg: ModelConfig, paged: bool = True
                       ) -> Optional[str]:
    """Resolve and validate ``--speculate`` × ``--spec-k`` up front, with
    the registry's vocabulary. Returns the proposer name (the part before
    ``:``), or None when speculation is off."""
    if speculate in (None, "", "off"):
        return None
    name = str(speculate).split(":", 1)[0]
    if name not in PROPOSERS:
        raise ValueError(
            f"--speculate {speculate!r}: unknown proposer {name!r}. "
            f"Registered proposers: {available_proposers()} "
            f"(use 'draft:<spec>' to derive a draft model)")
    if spec_k < 1:
        raise ValueError(
            f"--spec-k must be >= 1 (got {spec_k}); speculation scores "
            f"the last emitted token plus spec_k drafts per step")
    if not paged:
        raise ValueError(
            f"--speculate {name!r} requires the paged/chunked engine "
            f"(rollback is allocator-level and verify checkpoints carries "
            f"through the chunked path); drop --ring")
    if cfg.sliding_window and spec_k >= cfg.sliding_window:
        raise ValueError(
            f"--spec-k {spec_k} must be smaller than the sliding window "
            f"({cfg.sliding_window}): a draft overhang spanning the whole "
            f"window would evict entries its own verify still attends")
    return name


def make_proposer(speculate: str, *, target_cfg: ModelConfig,
                  draft_cfg: Optional[ModelConfig] = None,
                  draft_params=None, seed: int = 1) -> Proposer:
    """Build a proposer from a ``--speculate`` spec: ``ngram`` /
    ``ngram:<max_n>`` (prompt lookup), or ``draft`` / ``draft:layers=<N>``
    (a draft derived from the target config with ``N`` layers, default 1,
    random weights from ``seed``; or exactly ``draft_cfg`` /
    ``draft_params``)."""
    name, _, arg = str(speculate).partition(":")
    if name == "ngram":
        return NgramProposer(int(arg)) if arg else NgramProposer()
    if name == "draft":
        cfg = draft_cfg
        if cfg is None:
            n_layers = 1
            if arg:
                key, _, val = arg.partition("=")
                if key != "layers" or not val.isdigit():
                    raise ValueError(
                        f"--speculate draft:{arg!r}: expected "
                        f"'draft:layers=<N>' (or pass a draft config "
                        f"programmatically)")
                n_layers = int(val)
            cfg = dataclasses.replace(target_cfg, num_layers=n_layers,
                                      w4a16_plan=None)
        return DraftModelProposer(cfg, draft_params, seed=seed)
    raise ValueError(f"unknown proposer {name!r}; registered: "
                     f"{available_proposers()}")
