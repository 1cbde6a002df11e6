"""The port's speculative decoding against the JAX package on the CPU:
the batched verify step and its scatter, then engine-level greedy parity
on REDUCED h2o-danube-1.8b (W4A16 weights, fp32, SWA-16 window) for the
ngram proposer, a 1-layer random draft and an oracle draft (the target's
own weights), with whole-prompt and chunked prefill, staggered arrivals,
slot reuse and a shared prompt; allocator-level rollback; up-front
validation. Weights are the JAX package's, converted leaf for leaf; the
draft's random weights are JAX's too (its PRNG is not reproduced).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.quant import get_kv_format as jget_kv_format
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.runtime import kvcache as jkvc
from repro.runtime import speculative as jspec
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core.quant import get_kv_format
from repro_torch.launch import serve as tserve
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.runtime import kvcache as kvc
from repro_torch.runtime import speculative as spec
from repro_torch.runtime.engine import Request, ServingEngine

from torch_parity_helpers import jax_to_numpy

ARCH = "h2o-danube-1.8b"
P, G, B, N_REQ, K = 8, 6, 2, 3, 3
_RUNS = {}


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH),
                               w4a16_strategy="xla")
    jparams = JT.quantize_params(JT.init_params(jax.random.PRNGKey(0), jcfg),
                                 jcfg, min_size=0)
    cfg = configs.get_reduced(ARCH)
    tparams = from_jax_params(jax_to_numpy(jparams), dtype=cfg.dtype,
                              device="cpu")
    return jcfg, jparams, cfg, tparams


def _prompts(cfg, n=N_REQ, plen=P, seed=0):
    """The first two requests share a prompt that repeats a short segment
    (ngram has something to match, and prefix sharing runs under
    speculation); the rest are random."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, cfg.vocab_size, size=max(2, plen // 3))
    rep = np.tile(base, -(-plen // len(base)))[:plen]
    toks = rng.integers(0, cfg.vocab_size, size=(n, plen))
    return [(rep if i < 2 else toks[i]).astype(np.int32) for i in range(n)]


def _requests(make, prompts, gen=G):
    return [make(rid=i, prompt=p, max_new_tokens=gen, arrival_step=i)
            for i, p in enumerate(prompts)]


def _proposers(kind, jcfg, jparams, cfg, tparams):
    """(JAX proposer, port proposer) of one kind; the port's draft gets the
    JAX draft's weights."""
    if kind == "ngram":
        return "ngram", "ngram"
    if kind == "oracle":
        return (jspec.DraftModelProposer(jcfg, jparams),
                spec.DraftModelProposer(cfg, tparams))
    jprop = jspec.make_proposer("draft:layers=1", target_cfg=jcfg)
    dcfg = dataclasses.replace(cfg, num_layers=1)
    dparams = from_jax_params(jax_to_numpy(jprop.params), dtype=cfg.dtype,
                              device="cpu")
    return jprop, spec.DraftModelProposer(dcfg, dparams)


def _run_pair(weights, kind, chunk, gen=G):
    """JAX's and the port's engines over the same requests (cached)."""
    key = (kind, chunk, gen)
    if key not in _RUNS:
        jcfg, jparams, cfg, tparams = weights
        kw = dict(max_batch=B, max_prompt_len=P, max_new_tokens=gen,
                  page_size=8, prefill_chunk=chunk)
        prompts = _prompts(cfg)
        if kind is None:
            jprop = tprop = None
        else:
            jprop, tprop = _proposers(kind, jcfg, jparams, cfg, tparams)
        jeng = JServingEngine(jcfg, jparams, speculate=jprop, spec_k=K, **kw)
        jrep = jeng.run(_requests(JRequest, prompts, gen))
        eng = ServingEngine(cfg, tparams, speculate=tprop, spec_k=K,
                            device="cpu", **kw)
        rep = eng.run(_requests(Request, prompts, gen))
        _RUNS[key] = (jrep, rep, eng)
    return _RUNS[key]


# ---------------------------------------------------------------------------
# verify step and its scatter
# ---------------------------------------------------------------------------

def test_scatter_chunks_matches_jax():
    """The batched verify write lands JAX's bytes and tags, padded rows
    and an unmapped page included."""
    nb, ps, H, D, Bt, C = 6, 4, 2, 4, 2, 3
    rng = np.random.default_rng(4)
    tables = np.array([[1, 2], [3, -1]], np.int32)
    k = rng.standard_normal((Bt, C, H, D)).astype(np.float32)
    v = rng.standard_normal((Bt, C, H, D)).astype(np.float32)
    positions = np.array([[2, 3, 4], [6, 7, -1]], np.int32)
    for fmt in ("kv_fp16", "kv8_channel"):
        want = jkvc.scatter_chunks(
            jkvc.init_pool(nb, ps, H, D, jnp.float32, fmt),
            jnp.asarray(tables), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(positions), cache_len=8, fmt=jget_kv_format(fmt))
        got = kvc.scatter_chunks(
            kvc.init_pool(nb, ps, H, D, torch.float32, fmt),
            torch.from_numpy(tables), torch.from_numpy(k),
            torch.from_numpy(v), torch.from_numpy(positions), cache_len=8,
            fmt=get_kv_format(fmt))
        for g, w in zip(got, want):
            if w is None:
                continue
            # block 0 (the null block) takes the padded rows' garbage
            np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])


@pytest.mark.parametrize("fmt", ["kv_fp16", "kv8_channel"])
def test_verify_step_matches_jax(weights, fmt):
    """A prefill chunk per slot, then one verify window per slot (slot 1
    with a short proposal, padded with -1): the logits at every live
    position agree with JAX's at 1e-5 on both attention paths, and the
    pool's tags after the write are JAX's."""
    jcfg, jparams, cfg, tparams = weights
    ps, nb, cache_len, C = 4, 9, 16, K + 1
    prompts = _prompts(cfg, n=2, plen=6, seed=3)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    tok = np.array([[7, 9, 11, 13], [5, 8, 0, 0]], np.int32)
    pos = np.array([[6, 7, 8, 9], [6, 7, -1, -1]], np.int32)

    def jax_side():
        pool = jax.tree.map(
            lambda x: jnp.broadcast_to(x, (jcfg.num_layers,) + x.shape),
            jkvc.init_pool(nb, ps, jcfg.num_kv_heads, jcfg.head_dim,
                           jcfg.dtype, fmt))
        st = {"cache": {"kv": pool}}
        for b in range(2):
            h = jlayers.embed(jparams["embed"], jnp.asarray(prompts[b]))[None]
            _, st = JT.prefill_chunk_step(
                jparams, jcfg, st, h, jnp.arange(6, dtype=jnp.int32)[None],
                jnp.asarray(table[b:b + 1]), b, cache_len=cache_len,
                kv_format=fmt)
        logits, st, carries = JT.verify_step(
            jparams, jcfg, st, jnp.asarray(tok), jnp.asarray(pos),
            jnp.asarray(table), cache_len=cache_len, kv_format=fmt)
        assert carries is None
        return np.asarray(logits), np.asarray(st["cache"]["kv"].page_pos)

    want, want_pos = jax_side()
    for path in ("gather", "fused"):
        st = T.init_paged_state(cfg, 2, cache_len, page_size=ps,
                                num_blocks=nb, kv_format=fmt, device="cpu")
        for b in range(2):
            h = layers.embed(tparams["embed"],
                             torch.from_numpy(prompts[b]))[None]
            _, st = T.prefill_chunk_step(
                tparams, cfg, st, h,
                torch.arange(6, dtype=torch.int32)[None],
                torch.from_numpy(table[b:b + 1]), cache_len=cache_len,
                kv_format=fmt, attn_path=path)
        got, st, carries = T.verify_step(
            tparams, cfg, st, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(table), cache_len=cache_len, kv_format=fmt,
            attn_path=path)
        assert carries is None
        assert got.shape == (2, C, cfg.padded_vocab)
        live = pos >= 0
        np.testing.assert_allclose(got.numpy()[live], want[live],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(
            st["cache"]["kv"].page_pos.numpy()[:, 1:], want_pos[:, 1:])


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ngram", "draft", "oracle"])
@pytest.mark.parametrize("chunk", [None, 4])
def test_speculative_engine_matches_jax(weights, kind, chunk):
    """The speculative engine's greedy tokens equal JAX's speculative
    engine's and the port's own plain decode's; proposed and accepted
    counts and the step count equal JAX's; every page goes back."""
    jrep, rep, eng = _run_pair(weights, kind, chunk)
    _, plain, _ = _run_pair(weights, None, chunk)
    assert rep.results == jrep.results == plain.results
    assert (rep.proposed_tokens, rep.accepted_tokens, rep.steps) == \
        (jrep.proposed_tokens, jrep.accepted_tokens, jrep.steps)
    assert rep.proposed_tokens > 0
    assert rep.decode_tokens == sum(len(v) for v in rep.results.values()) \
        - len(rep.results)
    assert rep.peak_pages == jrep.peak_pages
    assert eng.alloc.pages_in_use == 0
    assert eng.alloc.pages_free == eng.num_pages - 1
    if kind == "oracle":
        # the target's own weights propose its greedy continuation
        assert rep.accepted_tokens == rep.proposed_tokens
        assert rep.acceptance_rate == 1.0
        assert rep.steps < plain.steps


def test_verify_plans_are_made_at_the_verify_width(weights):
    """With a proposer wired the GEMMs are planned at M = B·(k+1)."""
    _, _, cfg, tparams = weights
    from repro_torch.kernels import planning
    kw = dict(max_batch=B, max_prompt_len=P, max_new_tokens=G, page_size=8,
              device="cpu")
    seen = []
    orig = planning.plan_for_params

    def spy(params, M, **kwargs):
        seen.append(M)
        return orig(params, M, **kwargs)

    planning.plan_for_params = spy
    try:
        ServingEngine(cfg, tparams, **kw)
        ServingEngine(cfg, tparams, speculate="ngram", spec_k=K, **kw)
    finally:
        planning.plan_for_params = orig
    assert seen == [B, B * (K + 1)]


# ---------------------------------------------------------------------------
# allocator-level rollback
# ---------------------------------------------------------------------------

def _snapshot(alloc):
    return (alloc.pages_in_use, alloc.pages_free, dict(alloc._ref),
            dict(alloc._index), dict(alloc._key_of))


def _bare_engine(weights):
    _, _, cfg, tparams = weights
    eng = ServingEngine(cfg, tparams, max_batch=2, max_prompt_len=8,
                        max_new_tokens=8, page_size=4, device="cpu")
    eng._tables = np.full((2, eng.pages_slot), -1, np.int32)
    eng._state = eng._init_state()
    shared = eng.alloc.alloc()
    eng.alloc.publish("prefix-key", shared)
    eng._tables[0][0] = shared
    assert eng.alloc.lookup("prefix-key") == shared
    eng._tables[1][0] = shared
    return eng, shared


def test_rollback_restores_allocator_exactly(weights):
    """A rejected draft tail crossing a page boundary out of a shared
    prefix page (copy-on-write and a fresh alloc in one transaction) rolls
    back to the exact allocator state: refcounts, prefix index, free pool,
    block table; the shared block is re-adopted, never re-published; the
    dropped copy's tags are wiped."""
    eng, shared = _bare_engine(weights)
    ps = eng.page_size
    before = _snapshot(eng.alloc)
    tbl_before = eng._tables[1].copy()
    txn = []
    eng._ensure_pages(1, [ps - 1, ps, ps + 1], txn=txn)
    assert [op[0] for op in txn] == ["cow", "alloc"]
    copy_bid = int(eng._tables[1][0])
    assert copy_bid != shared and eng.alloc.refcount(shared) == 1
    eng._state["cache"]["kv"].page_pos[:, copy_bid] = 3    # the copy's tags
    eng._rollback_pages(1, txn, -1)
    assert _snapshot(eng.alloc) == before
    assert (eng._tables[1] == tbl_before).all()
    assert int(eng._tables[1][0]) == shared
    assert int(eng._state["cache"]["kv"].page_pos[:, copy_bid].max()) == -1


def test_rollback_partial_keep(weights):
    """Accepted positions reaching into the copied page keep the copy;
    only the overhang page beyond the accepted frontier unwinds."""
    eng, shared = _bare_engine(weights)
    txn = []
    eng._ensure_pages(1, [3, 4], txn=txn)
    copy_bid = int(eng._tables[1][0])
    overhang = int(eng._tables[1][1])
    eng._rollback_pages(1, txn, 0)
    assert int(eng._tables[1][0]) == copy_bid
    assert int(eng._tables[1][1]) == -1
    assert eng.alloc.refcount(overhang) == 0
    assert eng.alloc.refcount(copy_bid) == 1
    assert eng.alloc.peek("prefix-key") == shared


class _AlwaysWrong(spec.Proposer):
    """Drafts the maximum-vocab token: every verify rejects them all."""

    name = "ngram"

    def __init__(self, vocab):
        self.vocab = vocab

    def propose(self, views, k):
        return {v.slot: [self.vocab - 1] * k for v in views}


def test_rejected_drafts_leave_no_residue(weights):
    """Drafts that always miss: tokens stay the plain decode's (and JAX's
    under the same proposer), and the allocator and pool end exactly
    empty, the shared-prompt slots included."""
    jcfg, jparams, cfg, tparams = weights
    G2 = 8
    kw = dict(max_batch=B, max_prompt_len=P, max_new_tokens=G2,
              page_size=4, prefill_chunk=4, spec_k=K)

    class _JWrong(jspec.Proposer):
        name = "ngram"

        def propose(self, views, k):
            return {v.slot: [jcfg.vocab_size - 1] * k for v in views}

    prompts = _prompts(cfg)
    want = JServingEngine(jcfg, jparams, speculate=_JWrong(), **kw).run(
        _requests(JRequest, prompts, G2))
    eng = ServingEngine(cfg, tparams, speculate=_AlwaysWrong(cfg.vocab_size),
                        device="cpu", **kw)
    rep = eng.run(_requests(Request, prompts, G2))
    plain = ServingEngine(cfg, tparams, device="cpu",
                          **{k: v for k, v in kw.items() if k != "spec_k"})
    assert rep.results == want.results == plain.run(
        _requests(Request, prompts, G2)).results
    assert rep.proposed_tokens == want.proposed_tokens > 0
    assert rep.accepted_tokens == 0
    assert eng.alloc.pages_in_use == 0
    assert eng.alloc.pages_free == eng.num_pages - 1
    assert eng.alloc._index == {} and eng.alloc._ref == {}
    assert int(eng.last_state["cache"]["kv"].page_pos.max()) == -1


# ---------------------------------------------------------------------------
# validation and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,kw", [
    (("bogus", 4), {}),
    (("ngram", 0), {}),
    (("ngram", 4), {"paged": False}),
    (("ngram", 16), {}),                        # window 16
])
def test_validate_speculate_refusals_match_jax(args, kw):
    with pytest.raises(ValueError) as want:
        jspec.validate_speculate(*args, cfg=jconfigs.get_reduced(ARCH), **kw)
    with pytest.raises(ValueError) as got:
        spec.validate_speculate(*args, cfg=configs.get_reduced(ARCH), **kw)
    assert str(got.value) == str(want.value)


def test_validate_speculate_accepts():
    cfg = configs.get_reduced(ARCH)
    assert spec.validate_speculate("draft:layers=2", 4, cfg=cfg) == "draft"
    assert spec.validate_speculate("ngram:2", 4, cfg=cfg) == "ngram"
    assert spec.validate_speculate(None, 4, cfg=cfg) is None
    assert spec.validate_speculate("off", 4, cfg=cfg) is None
    with pytest.raises(ValueError, match="draft:layers=<N>"):
        spec.make_proposer("draft:depth=2", target_cfg=cfg)


def test_ngram_proposals_match_jax():
    views = [(0, [1, 2, 3, 1, 2], 5), (1, [4, 5, 6], 3),
             (2, [7, 7, 7, 7], 4)]
    want = jspec.NgramProposer().propose(
        [jspec.ProposalView(*v) for v in views], 3)
    got = spec.NgramProposer().propose(
        [spec.ProposalView(*v) for v in views], 3)
    assert got == want == {0: [3, 1, 2], 2: [7]}


def test_serve_launcher_speculates_on_cpu():
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "8", "--gen", "6", "--page-size", "4", "--device", "cpu"]
    rep = tserve.main(argv + ["--speculate", "ngram", "--spec-k", "3"])
    plain = tserve.main(argv)
    assert rep.results == plain.results
    assert all(len(v) == 6 for v in rep.results.values())
    for bad, match in ((["--speculate", "nope"], "Registered proposers"),
                       (["--speculate", "ngram", "--spec-k", "0"], "spec-k"),
                       (["--speculate", "ngram", "--spec-k", "16"],
                        "sliding window"),
                       (["--speculate", "ngram", "--ring"], "paged")):
        with pytest.raises(ValueError, match=match):
            tserve.main(argv + bad)
    # the ring engine serves the plain run's tokens
    assert tserve.main(argv + ["--ring"]).results == plain.results
