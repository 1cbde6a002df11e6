"""The port's prefix sharing and warm prefix LRU against the JAX package
on the CPU, on REDUCED h2o-danube-1.8b (W4A16 weights, fp32, SWA-16
window): identical prompts share pages (whole-prompt, lockstep chunked and
staggered chunked admits), copy-on-write on the first divergent write, a
warm readmit with zero prefill steps, the warm budget, a wrapped decode
unpublishing its recycled prompt pages, and a tight pool deferring an
admit. Tokens, peak pages, prefill steps saved and warm hits are held to
JAX's engine on the same requests and converted weights.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.runtime.engine import Request, ServingEngine

from torch_parity_helpers import jax_to_numpy

ARCH = "h2o-danube-1.8b"


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


def _prompts(cfg, n, P, *, same_prompt=False, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(n, P)).astype(np.int32)
    return [toks[0] if same_prompt else toks[i] for i in range(n)]


def _both(weights, prompts, G, *, arrival_every=0, arrivals=None, **kw):
    """Run the same requests through JAX's engine and the port's; returns
    (JAX report, port report, port engine)."""
    jcfg, jparams, cfg, tparams = weights
    arrivals = arrivals or [i * arrival_every for i in range(len(prompts))]

    def reqs(make):
        return [make(rid=i, prompt=p, max_new_tokens=G, arrival_step=a)
                for i, (p, a) in enumerate(zip(prompts, arrivals))]

    P = max(len(p) for p in prompts)
    common = dict(max_batch=kw.pop("max_batch", 2), max_prompt_len=P,
                  max_new_tokens=G, **kw)
    jrep = JServingEngine(jcfg, jparams, **common).run(reqs(JRequest))
    eng = ServingEngine(cfg, tparams, device="cpu", **common)
    return jrep, eng.run(reqs(Request)), eng


def _count_chunks(eng):
    """Wrap the engine's chunk steps: returns the list of slots each
    prefill chunk ran for."""
    ran = []
    orig = eng._advance_prefill

    def advance(i, slot, pending):
        ran.append(slot.req.rid)
        return orig(i, slot, pending)

    eng._advance_prefill = advance
    return ran


@pytest.mark.parametrize("chunk,arrival,min_saved", [
    (None, 0, 1),   # chunk = the prompt: the peer publishes as it writes
    (4, 0, 1),      # lockstep chunked: adopt pages the peer just produced
    (3, 2, 1),      # staggered chunked: catch up through share-ahead
])
def test_prefix_sharing_matches_jax(weights, chunk, arrival, min_saved):
    """Identical prompts across slots: tokens, peak pages and prefill
    steps saved equal JAX's, and the shared run holds fewer pages than
    distinct prompts do (the pages saved equal JAX's too)."""
    _, _, cfg, _ = weights
    P, G, n = 8, 4, 2
    kw = dict(page_size=4, prefill_chunk=chunk, arrival_every=arrival)
    jshared, shared, eng = _both(
        weights, _prompts(cfg, n, P, same_prompt=True), G, **kw)
    jdistinct, distinct, _ = _both(weights, _prompts(cfg, n, P), G, **kw)
    assert shared.results == jshared.results
    assert shared.results[0] == shared.results[1]
    assert distinct.results == jdistinct.results
    assert (shared.peak_pages, shared.prefill_steps_saved) == \
        (jshared.peak_pages, jshared.prefill_steps_saved)
    assert distinct.peak_pages - shared.peak_pages == \
        jdistinct.peak_pages - jshared.peak_pages >= min_saved
    assert eng.alloc.pages_in_use == 0


def test_cow_on_divergent_write(weights):
    """Two slots share a partial prompt page; the first decode write into
    it copies it: identical generations, JAX's tokens and peak pages."""
    _, _, cfg, _ = weights
    P, G = 6, 4                                 # 6 % 4: a partial page
    jrep, rep, eng = _both(weights, _prompts(cfg, 2, P, same_prompt=True),
                           G, page_size=4)
    assert rep.results == jrep.results
    assert rep.results[0] == rep.results[1]
    assert rep.peak_pages == jrep.peak_pages > 1
    assert eng.alloc.pages_in_use == 0


def test_warm_readmit_runs_zero_prefill_steps(weights):
    """A page-aligned prompt re-sent after its release, under a warm
    budget: the readmit adopts the whole chain and the cached first token
    and runs no prefill chunk; one warm hit, one miss; tokens equal the
    cold engine's and JAX's; run boundaries stay cold."""
    jcfg, jparams, cfg, tparams = weights
    P, G = 8, 3
    prompts = _prompts(cfg, 2, P, same_prompt=True)
    kw = dict(page_size=4, prefill_chunk=4, arrival_every=12)
    jwarm, warm, eng = _both(weights, prompts, G, warm_cache_mb=1.0, **kw)
    jcold, cold, _ = _both(weights, prompts, G, **kw)
    assert warm.results == jwarm.results == cold.results == jcold.results
    assert (warm.warm_hits, warm.warm_misses) == \
        (jwarm.warm_hits, jwarm.warm_misses) == (1, 1)
    assert (cold.warm_hits, cold.warm_misses) == (0, 0)
    assert warm.prefill_steps_saved == jwarm.prefill_steps_saved == 2
    assert warm.steps == jwarm.steps < cold.steps
    ran = _count_chunks(eng)
    again = eng.run([Request(rid=i, prompt=p, max_new_tokens=G,
                             arrival_step=12 * i)
                     for i, p in enumerate(prompts)])
    assert again.results == warm.results
    assert ran.count(0) == 2 and ran.count(1) == 0   # readmit: no chunk


def test_warm_budget_is_respected(weights):
    """Distinct prompts churning through a one-chain budget: retention
    never exceeds it, every admit misses (as in JAX), and the warm pages
    stay accounted."""
    jcfg, jparams, cfg, tparams = weights
    P, G, n = 8, 3, 3
    probe = ServingEngine(cfg, tparams, max_batch=1, max_prompt_len=P,
                          max_new_tokens=G, page_size=4, device="cpu")
    jprobe = JServingEngine(jcfg, jparams, max_batch=1, max_prompt_len=P,
                            max_new_tokens=G, page_size=4)
    assert probe.block_bytes == jprobe.alloc.block_bytes
    one_chain_mb = probe.block_bytes * (P // 4) / (1 << 20)
    jrep, rep, eng = _both(weights, _prompts(cfg, n, P), G, max_batch=1,
                           page_size=4, prefill_chunk=4, arrival_every=1,
                           warm_cache_mb=one_chain_mb)
    assert rep.results == jrep.results
    assert (rep.warm_hits, rep.warm_misses) == (0, n)
    assert eng.alloc.warm_bytes_used <= eng.alloc.warm_bytes
    assert 0 < eng.alloc.warm_pages <= P // 4
    assert eng.alloc.pages_in_use == 0
    assert eng.alloc.pages_free + eng.alloc.warm_pages == eng.num_pages - 1


@pytest.mark.parametrize("kv_format", ["kv_fp16", "kv8_channel"])
def test_block_bytes_match_jax(weights, kv_format):
    jcfg, jparams, cfg, tparams = weights
    kw = dict(max_batch=2, max_prompt_len=8, max_new_tokens=4, page_size=4,
              kv_format=kv_format)
    assert ServingEngine(cfg, tparams, device="cpu", **kw).block_bytes == \
        JServingEngine(jcfg, jparams, **kw).alloc.block_bytes


@pytest.mark.parametrize("P,G,num_pages", [
    (14, 10, None),    # pos0 + G > cache_len: decode wraps and recycles
    (14, 8, 6),        # a pool too small for two unshared lifetimes
])
def test_wrapping_and_tight_pool_match_jax(weights, P, G, num_pages):
    """A wrapped decode overwrites its own published prompt pages (their
    keys must go, or a later identical prompt adopts destroyed content);
    a tight pool defers the second admit instead of running dry."""
    _, _, cfg, _ = weights
    jrep, rep, eng = _both(weights, _prompts(cfg, 2, P, same_prompt=True),
                           G, arrivals=[0, 6 if num_pages is None else 1],
                           page_size=4, num_pages=num_pages)
    assert sorted(rep.results) == [0, 1]
    assert rep.results == jrep.results
    assert eng.alloc.pages_in_use == 0


def test_unshared_engine_computes_every_page(weights):
    """``share_prefix=False`` (the port's switch for a no-sharing
    baseline) gives the same tokens with no page or step saved."""
    _, _, cfg, tparams = weights
    P, G = 8, 4
    prompts = _prompts(cfg, 2, P, same_prompt=True)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=G)
            for i, p in enumerate(prompts)]
    kw = dict(max_batch=2, max_prompt_len=P, max_new_tokens=G, page_size=4,
              prefill_chunk=4, device="cpu")
    shared = ServingEngine(cfg, tparams, **kw).run(reqs)
    alone = ServingEngine(cfg, tparams, share_prefix=False, **kw).run(reqs)
    assert alone.results == shared.results
    assert alone.prefill_steps_saved == 0
    assert alone.peak_pages > shared.peak_pages
