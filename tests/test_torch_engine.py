"""The port's serving slice against the JAX package on the CPU: model
layers, decode / chunked-prefill steps, and engine-level greedy token
parity on REDUCED h2o-danube-1.8b with W4A16 weights (the SWA-16 window
wraps: prompt 12 + gen 6 on 4-token pages, prefill chunks of 5), for both
KV formats. Weights are the JAX package's, converted leaf for leaf; inputs
come from numpy with a fixed seed.

The REDUCED config runs in fp32, so op-level tolerances are fp32
summation-order tolerances (the two frameworks reduce in different
orders): rtol 1e-5 / atol 1e-5 on layer outputs, 1e-4 on logits after two
layers and a vocab-wide head.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.runtime import kvcache as jkvc
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as tserve
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Request, ServingEngine

from torch_parity_helpers import jax_to_numpy

ARCH = "h2o-danube-1.8b"
P, G, N_REQ = 12, 6, 2


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfigs.get_reduced(ARCH)
    jparams = JT.quantize_params(JT.init_params(jax.random.PRNGKey(0), jcfg),
                                 jcfg, min_size=0)
    cfg = configs.get_reduced(ARCH)
    tparams = from_jax_params(jax_to_numpy(jparams), dtype=cfg.dtype,
                              device="cpu")
    return jcfg, jparams, cfg, tparams


def _prompts(cfg, n=N_REQ, plen=P, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(n, plen)).astype(np.int32)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 4, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    pos = rng.integers(0, 5000, size=(3, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.rmsnorm({"scale": torch.from_numpy(scale)},
                       torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                                   jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    # angles reach ~5000 rad, where fp32 sin/cos libraries differ by a few
    # ulp of the angle: atol 1e-3 on unit-scale outputs
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          10_000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      10_000.0)), rtol=1e-4, atol=1e-3)


def test_quantize_tree_matches_jax_bytes(weights):
    """The port's quantize_params reproduces the JAX package's stored
    layout byte for byte from the same dense weights."""
    jcfg, _, cfg, _ = weights
    dense = JT.init_params(jax.random.PRNGKey(3), jcfg)
    jq = jax_to_numpy(JT.quantize_params(dense, jcfg, min_size=0))
    tq = T.quantize_params(
        from_jax_params(jax_to_numpy(dense), dtype=cfg.dtype), cfg,
        min_size=0)
    for name in ("wq", "wk", "wv", "wo"):
        got = tq["layers"]["attn"][name]["kernel"]
        want = jq["layers"]["attn"][name]["kernel"]
        np.testing.assert_array_equal(got.packed.numpy(), want["packed"])
        np.testing.assert_array_equal(got.scales.numpy(), want["scales"])
    assert isinstance(tq["lm_head"]["kernel"], torch.Tensor)   # head dense


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def _pools(jcfg, cfg, fmt, nb, ps):
    jpool = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (jcfg.num_layers,) + x.shape),
        jkvc.init_pool(nb, ps, jcfg.num_kv_heads, jcfg.head_dim,
                       jcfg.dtype, fmt))
    tstate = T.init_paged_state(cfg, 2, 16, page_size=ps, num_blocks=nb,
                                kv_format=fmt, device="cpu")
    return {"cache": {"kv": jpool}}, tstate


@pytest.mark.parametrize("fmt", ["kv_fp16", "kv8_channel"])
def test_prefill_and_decode_steps_match_jax(weights, fmt):
    """One prefill chunk then three decode steps, same tables and tokens:
    logits agree at every step, on the gather path and (through the
    paged-attention kernel's plain version) the fused path."""
    jcfg, jparams, cfg, tparams = weights
    ps, nb, cache_len = 4, 9, 16
    prompt = _prompts(cfg)[0][:5]
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    jstate, _ = _pools(jcfg, cfg, fmt, nb, ps)
    h = JT.layers.embed(jparams["embed"], jnp.asarray(prompt))[None]
    positions = np.arange(5, dtype=np.int32)[None]
    jlog, jstate = JT.prefill_chunk_step(
        jparams, jcfg, jstate, h, jnp.asarray(positions),
        jnp.asarray(table[:1]), 0, cache_len=cache_len, kv_format=fmt)
    for path in ("gather", "fused"):
        _, tstate = _pools(jcfg, cfg, fmt, nb, ps)
        th = layers.embed(tparams["embed"], torch.from_numpy(prompt))[None]
        tlog, tstate = T.prefill_chunk_step(
            tparams, cfg, tstate, th, torch.from_numpy(positions),
            torch.from_numpy(table[:1]), cache_len=cache_len, kv_format=fmt,
            attn_path=path)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=1e-4, atol=1e-4)
        js = jstate
        tok = np.array([7, 9], np.int32)
        tables = table.copy()
        tables[1] = -1                  # slot 1 inactive: null-block writes
        for step in range(3):
            pos = np.array([5 + step, 0], np.int32)
            jl, js = JT.decode_step(
                jparams, jcfg, js, jnp.asarray(tok), jnp.asarray(pos),
                tables=jnp.asarray(tables), cache_len=cache_len,
                kv_format=fmt)
            tl, tstate = T.decode_step(
                tparams, cfg, tstate, torch.from_numpy(tok),
                torch.from_numpy(pos), tables=torch.from_numpy(tables),
                cache_len=cache_len, kv_format=fmt, attn_path=path)
            np.testing.assert_allclose(tl.numpy()[0], np.asarray(jl)[0],
                                       rtol=1e-4, atol=1e-4)
            tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jpp = np.asarray(js["cache"]["kv"].page_pos)
        np.testing.assert_array_equal(
            tstate["cache"]["kv"].page_pos.numpy(), jpp)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_format", ["kv_fp16", "kv8_channel"])
def test_engine_token_parity_with_jax(weights, kv_format):
    """The acceptance: the port's ServingEngine.run gives the JAX engine's
    greedy tokens on REDUCED danube, W4A16 weights, window wrapping."""
    jcfg, jparams, cfg, tparams = weights
    toks = _prompts(cfg)
    kw = dict(max_batch=N_REQ, max_prompt_len=P, max_new_tokens=G,
              page_size=4, prefill_chunk=5, kv_format=kv_format)
    jeng = JServingEngine(jcfg, jparams, **kw)
    want = jeng.run([JRequest(rid=i, prompt=toks[i], max_new_tokens=G)
                     for i in range(N_REQ)]).results
    eng = ServingEngine(cfg, tparams, device="cpu", **kw)
    assert eng.cache_len == jeng.cache_len == 16        # P + G wraps it
    assert (eng.attn_path, eng.prefill_attn_path) == ("gather", "gather")
    rep = eng.run([Request(rid=i, prompt=toks[i], max_new_tokens=G)
                   for i in range(N_REQ)])
    assert rep.results == want and sorted(rep.results) == [0, 1]
    assert all(len(v) == G for v in rep.results.values())
    assert rep.decode_tokens == N_REQ * (G - 1)
    # every block went back to the pool
    assert eng.alloc.pages_in_use == 0


def test_engine_queues_past_the_pool_and_matches_jax(weights):
    """More requests than slots, staggered arrivals: FIFO admission and
    slot reuse give the JAX engine's tokens."""
    jcfg, jparams, cfg, tparams = weights
    toks = _prompts(cfg, n=3, plen=8, seed=5)
    kw = dict(max_batch=2, max_prompt_len=8, max_new_tokens=4, page_size=4,
              prefill_chunk=3)
    reqs = [(i, toks[i], 4 if i != 1 else 2, i) for i in range(3)]
    want = JServingEngine(jcfg, jparams, **kw).run(
        [JRequest(rid=i, prompt=p, max_new_tokens=g, arrival_step=a)
         for i, p, g, a in reqs]).results
    got = ServingEngine(cfg, tparams, device="cpu", **kw).run(
        [Request(rid=i, prompt=p, max_new_tokens=g, arrival_step=a)
         for i, p, g, a in reqs]).results
    assert got == want


def test_engine_requires_cuda_unless_cpu_is_asked(weights, monkeypatch):
    _, _, cfg, tparams = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(cfg, tparams, max_batch=2, max_prompt_len=8,
                      max_new_tokens=2, page_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", ARCH, "--reduced"])


def test_engine_refuses_what_the_slice_left_out(weights):
    from repro_torch.runtime import speculative as spec
    _, _, cfg, tparams = weights
    kw = dict(max_batch=2, max_prompt_len=8, max_new_tokens=2, page_size=4,
              device="cpu")
    for bad, match in ((dict(mesh=object()), "mesh"),
                       (dict(attn_path="fused"), "does not support"),
                       # a draft overhang as long as the window (16)
                       (dict(speculate="ngram", spec_k=16),
                        "sliding window")):
        with pytest.raises((NotImplementedError, ValueError), match=match):
            ServingEngine(cfg, tparams, **kw, **bad)
    # the ring engine serves (held against JAX's in test_torch_ring.py)
    ring = ServingEngine(cfg, tparams, **dict(kw, paged=False))
    rep = ring.run([Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=2)])
    assert ring.attn_path == "ring" and len(rep.results[0]) == 2
    # a recurrent draft cannot rewind rejected drafts
    with pytest.raises(ValueError, match="rewind"):
        spec.DraftModelProposer(dataclasses.replace(cfg, family="rwkv"))
    # speculation rolls back at the allocator: the paged engine only
    with pytest.raises(ValueError, match="paged"):
        spec.validate_speculate("ngram", 4, cfg=cfg, paged=False)
    with pytest.raises(NotImplementedError,
                       match="dense, moe, rwkv, hybrid and encdec families"):
        ServingEngine(dataclasses.replace(cfg, family="nope"), tparams,
                      **kw)


def test_serve_launcher_on_cpu():
    rep = tserve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                       "--prompt-len", "6", "--gen", "3", "--page-size", "4",
                       "--device", "cpu", "--strategy", "reference"])
    assert sorted(rep.results) == [0, 1]
    assert all(len(v) == 3 for v in rep.results.values())
    assert set(rep.prefill_logits) == {0, 1}
