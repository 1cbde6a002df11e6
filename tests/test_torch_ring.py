"""The port's ring engine (``ServingEngine(paged=False)``) against the JAX
package's on the CPU: per-slot ring caches, the whole-prompt prefill at
admit, ``insert_slot`` / ``reset_slot``, ``kvcache.scatter_ring`` and the
attention planner's ``ring`` path.

- Every one of the ten archs (REDUCED, W4A16, weights converted from JAX's
  leaf for leaf): the ring engine's greedy tokens equal JAX's ring
  engine's, with three requests over two slots (a slot reused), and equal
  the port's paged engine's on the same weights. The MoE archs drop
  (token, expert) pairs past an expert's capacity per routing batch,
  which a whole prompt and a 4-token chunk fill differently (JAX's two
  engines differ there too), so their ring-against-paged comparison runs
  at a capacity factor where no pair drops.
- JAX's own ring cases: the vision-prefix ring regression
  (``tests/test_engine.py``), ``scatter_ring`` leaf for leaf, the
  planner's ``paged=False`` problems, ``insert_slot`` and ``reset_slot``.
- The ring engine's stepper: cancel mid-decode and priority admission
  give JAX's tokens; the refusals (a quantized KV format, speculation, a
  forced paged path) in JAX's words; ``--ring`` through the launcher.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import planning as jplanning
from repro.models import attention as jattention
from repro.models import transformer as JT
from repro.runtime import engine as jengine
from repro.runtime import kvcache as jkvc
from repro.core import quant as jquant

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core import quant
from repro_torch.kernels import planning
from repro_torch.launch import serve as tserve
from repro_torch.models import attention
from repro_torch.models import transformer as T
from repro_torch.runtime import engine as tengine
from repro_torch.runtime import kvcache as kvc
from repro_torch.runtime.engine import Request, ServingEngine

from torch_parity_helpers import jax_to_numpy

P, G, N = 8, 5, 3
KW = dict(max_batch=2, max_prompt_len=P, max_new_tokens=G)


@functools.lru_cache(maxsize=None)
def weights(arch):
    """JAX's W4A16 weights of the REDUCED config and their conversion (one
    draw an arch for the module; no engine writes its weights)."""
    jcfg = jconfigs.get_reduced(arch)
    jparams = JT.quantize_params(JT.init_params(jax.random.PRNGKey(0), jcfg),
                                 jcfg, min_size=0)
    cfg = configs.get_reduced(arch)
    return jcfg, jparams, cfg, from_jax_params(jax_to_numpy(jparams),
                                               dtype=cfg.dtype, device="cpu")


def request_dicts(cfg, n=N, seed=0):
    """n numpy requests arriving one a step, with the arch's patches or
    audio frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(n, P)).astype(np.int32)
    out = []
    for i in range(n):
        r = dict(rid=i, prompt=toks[i], max_new_tokens=G, arrival_step=i)
        if cfg.vision_prefix:
            r["prefix_embeds"] = rng.standard_normal(
                (cfg.vision_prefix, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            r["audio_embeds"] = rng.standard_normal(
                (cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(r)
    return out


def jax_requests(reqs):
    return [jengine.Request(**{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                               and k != "prompt" else v
                               for k, v in r.items()}) for r in reqs]


def tokens(rep):
    return {int(k): [int(t) for t in v]
            for k, v in sorted(rep.results.items())}


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_ring_engine_matches_jax_and_the_paged_engine(arch):
    jcfg, jparams, cfg, tparams = weights(arch)
    reqs = request_dicts(cfg)
    want = tokens(jengine.ServingEngine(jcfg, jparams, paged=False, **KW)
                  .run(jax_requests(reqs)))
    ring = ServingEngine(cfg, tparams, paged=False, device="cpu", **KW)
    assert not ring.chunked and ring.alloc is None
    assert ring.attn_path == (None if cfg.attn_free else "ring")
    got = ring.run([Request(**r) for r in reqs])
    assert tokens(got) == want
    assert all(len(v) == G for v in want.values())
    if cfg.family == "moe":
        cfg = dataclasses.replace(
            cfg, moe_capacity_factor=float(cfg.num_experts))
        got = ServingEngine(cfg, tparams, paged=False, device="cpu",
                            **KW).run([Request(**r) for r in reqs])
    paged = ServingEngine(cfg, tparams, page_size=4, device="cpu",
                          **KW).run([Request(**r) for r in reqs])
    assert tokens(got) == tokens(paged)


def test_vision_prefix_ring_regression():
    """JAX's regression (``tests/test_engine.py``) on the port's engine:
    prefill writes P + vision_prefix entries and decode advances from pos0
    = P + prefix; the ring keeps position 0 through the last decode
    step."""
    _, _, cfg, tparams = weights("internvl2-1b")
    prefix = cfg.vision_prefix
    eng = ServingEngine(cfg, tparams, max_batch=1, max_prompt_len=P,
                        max_new_tokens=G, paged=False, device="cpu")
    assert eng.cache_len == P + prefix + G
    req = Request(**request_dicts(cfg, 1)[0])
    inputs = eng._prefill_inputs(req)
    with torch.no_grad():
        logits, rstate = eng._prefill(eng.params, inputs)
        state = tengine.insert_slot(
            T.init_decode_state(eng.cfg, 1, eng.cache_len), rstate, 0)
        valid = state["cache"]["kv"].pos[0, 0].numpy()
        assert sorted(valid[valid >= 0]) == list(range(P + prefix))
        serve = eng._serve_step()
        tok = torch.argmax(logits[0])[None].to(torch.int64)
        for i in range(G - 1):
            pos = torch.full((1,), P + prefix + i, dtype=torch.int64)
            res = serve(eng.params, {"state": state, "tokens": tok,
                                     "pos": pos})
            tok, state = res["next"].to(torch.int64), res["state"]
    valid = state["cache"]["kv"].pos[0, 0].numpy()
    assert sorted(valid[valid >= 0]) == list(range(P + prefix + G - 1))


def test_insert_and_reset_slot_match_jax():
    """A B = 1 prefill written into row 1 of a 2-slot ring state, then
    evicted (hymba: ring and SSM carries; whisper: ring and ``enc_kv``):
    every leaf equals JAX's ``insert_slot`` / ``reset_slot`` on the same
    numbers."""
    for arch in ("hymba-1.5b", "whisper-small"):
        jcfg, jparams, cfg, tparams = weights(arch)
        r = request_dicts(cfg, 1)[0]
        jeng = jengine.ServingEngine(jcfg, jparams, paged=False, **KW)
        jin = jeng._prefill_inputs(jax_requests([r])[0])
        _, jr = jeng._prefill_fn(jin)(jeng.params, jin)
        jstate = JT.init_decode_state(jcfg, 2, jeng.cache_len)
        jstate = jengine.insert_slot(jstate, jr, 1)
        eng = ServingEngine(cfg, tparams, paged=False, device="cpu", **KW)
        with torch.no_grad():
            inputs = eng._prefill_inputs(Request(**r))
            _, tr = eng._prefill(eng.params, inputs)
            tstate = tengine.insert_slot(
                T.init_decode_state(eng.cfg, 2, eng.cache_len), tr, 1)
        for stage in ("insert", "reset"):
            jl = jax.tree_util.tree_leaves(jstate)
            tl = jax.tree_util.tree_leaves(
                jax.tree_util.tree_map(lambda t: t.numpy(), tstate))
            assert len(jl) == len(tl), arch
            for a, b in zip(jl, tl):
                np.testing.assert_allclose(np.asarray(a), b, rtol=1e-4,
                                           atol=1e-4, err_msg=arch)
            jstate = jengine.reset_slot(jstate, 1)
            tstate = tengine.reset_slot(tstate, 1)
        assert (tstate["cache"]["kv"].pos[:, 1] == -1).all()
        assert (tstate["cache"]["kv"].pos[:, 0] == -1).all()


@pytest.mark.parametrize("kv_format", ["kv_fp16", "kv8_channel"])
@pytest.mark.parametrize("stacked", [False, True])
def test_scatter_ring_matches_jax(kv_format, stacked):
    """A prefilled ring (tags partly -1) into a slot's pages, one layer
    or stacked over L, with an unmapped page: every pool leaf equals
    JAX's."""
    rng = np.random.default_rng(3)
    L, W, H, D, ps, nb = 2, 12, 2, 8, 4, 6
    k = rng.standard_normal((L, 1, W, H, D)).astype(np.float32)
    v = rng.standard_normal((L, 1, W, H, D)).astype(np.float32)
    pos = np.full((L, 1, W), -1, np.int32)
    pos[:, :, :9] = np.arange(9)
    table = np.array([3, -1, 5], np.int32)
    jfmt, tfmt = jquant.get_kv_format(kv_format), quant.get_kv_format(
        kv_format)
    if stacked:
        jpool = jkvc.init_pool(nb, ps, H, D, jnp.float32,
                               kv_format=kv_format)
        jpool = jax.tree_util.tree_map(
            lambda t: jnp.stack([t] * L), jpool)
        jring = jattention.KVCache(jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos))
        tpool = kvc.init_pool(nb, ps, H, D, torch.float32, kv_format,
                              num_layers=L)
        tring = attention.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                                  torch.from_numpy(pos))
    else:
        jpool = jkvc.init_pool(nb, ps, H, D, jnp.float32,
                               kv_format=kv_format)
        jring = jattention.KVCache(jnp.asarray(k[0]), jnp.asarray(v[0]),
                                   jnp.asarray(pos[0]))
        tpool = kvc.init_pool(nb, ps, H, D, torch.float32, kv_format)
        tring = attention.KVCache(torch.from_numpy(k[0]),
                                  torch.from_numpy(v[0]),
                                  torch.from_numpy(pos[0]))
    want = jkvc.scatter_ring(jpool, table, jring, fmt=jfmt)
    got = kvc.scatter_ring(tpool, table, tring, fmt=tfmt)
    # the null block (0) takes the unmapped page's writes in no set order
    for name in ("k_pool", "v_pool", "page_pos", "k_scale", "v_scale"):
        a, b = getattr(want, name), getattr(got, name)
        if a is None:
            assert b is None
            continue
        np.testing.assert_allclose(_real(np.asarray(a), stacked),
                                   _real(b.numpy(), stacked),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert (got.page_pos[..., 0, :] == -1).all()


def _real(a, stacked):
    """A pool leaf without the null block (the block dim follows L)."""
    return a[:, 1:] if stacked else a[1:]


def test_plan_attention_ring_matches_jax():
    """``paged=False`` plans the ring path on either backend; ``fused`` and
    ``gather`` are refused there, ``ring`` on a paged problem, in JAX's
    words."""
    for backend in ("cpu", "cuda"):
        kw = dict(B=4, Hq=32, Hkv=8, D=128, cache_len=4096, page_size=16,
                  paged=False, kv_format="kv_fp16")
        tp = planning.AttentionProblem(backend=backend, **kw)
        jp = jplanning.AttentionProblem(
            backend="tpu" if backend == "cuda" else "cpu", **kw)
        assert planning.plan_attention(tp).path == \
            jplanning.plan_attention(jp).path == "ring"
        assert planning.plan_attention(tp, path="ring") == \
            planning.AttentionPlan("ring", 1)
        for path in ("fused", "gather"):
            with pytest.raises(ValueError) as te:
                planning.plan_attention(tp, path=path)
            with pytest.raises(ValueError) as je:
                jplanning.plan_attention(jp, path=path)
            want = str(je.value).split(";")[0]
            assert want.startswith(f"attention path {path!r} does not "
                                   f"support this problem (paged=False")
            assert str(te.value).startswith(want[:-1])
            assert "paths that do: ['ring']" in str(te.value)
        with pytest.raises(ValueError, match="does not support"):
            planning.plan_attention(dataclasses.replace(tp, paged=True),
                                    path="ring")
    assert planning.available_attn_paths() == \
        jplanning.available_attn_paths()


def test_ring_cancel_and_priority_match_jax():
    """The stepper on the ring engine: a cancel mid-decode frees the slot
    (its ring tags wiped) for the next request, and priority admission
    picks by (priority, deadline): tokens and cancelled prefixes equal
    JAX's ring engine driven the same way."""
    jcfg, jparams, cfg, tparams = weights("h2o-danube-1.8b")
    reqs = request_dicts(cfg, 4)
    for i, r in enumerate(reqs):
        r.update(arrival_step=0, priority=i % 2)

    def drive(eng, make):
        eng.start()
        for r in reqs:
            eng.submit(make(r))
        eng.step()
        eng.step()
        assert eng.cancel(1)
        return eng.drain()

    kw = dict(KW, admission="priority")
    jeng = jengine.ServingEngine(jcfg, jparams, paged=False, **kw)
    jrep = drive(jeng, lambda r: jax_requests([r])[0])
    eng = ServingEngine(cfg, tparams, paged=False, device="cpu", **kw)
    trep = drive(eng, lambda r: Request(**r))
    assert tokens(trep) == tokens(jrep)
    assert {k: [int(t) for t in v] for k, v in trep.cancelled.items()} == \
        {k: [int(t) for t in v] for k, v in jrep.cancelled.items()}
    assert trep.admitted == jrep.admitted == 4
    # the rings' tags at the end (evicted slots wiped, free slots' steps
    # written) equal JAX's
    np.testing.assert_array_equal(eng.last_state["cache"]["kv"].pos.numpy(),
                                  np.asarray(jeng.last_state["cache"]["kv"]
                                             .pos))


def test_ring_engine_refusals():
    _, _, cfg, tparams = weights("h2o-danube-1.8b")
    kw = dict(KW, paged=False, device="cpu")
    with pytest.raises(ValueError, match="needs the paged cache"):
        ServingEngine(cfg, tparams, kv_format="kv8_channel", **kw)
    with pytest.raises(ValueError, match="requires the paged/chunked"):
        ServingEngine(cfg, tparams, speculate="ngram", spec_k=2, **kw)
    with pytest.raises(ValueError, match=r"does not support this problem "
                       r"\(paged=False"):
        ServingEngine(cfg, tparams, attn_path="fused", **kw)
    eng = ServingEngine(cfg, tparams, **kw)
    assert not eng.share_prefix and eng.alloc is None
    # rwkv keeps its carry-only state and prefills whole, as JAX's does
    _, _, rcfg, rparams = weights("rwkv6-7b")
    with pytest.raises(ValueError, match="no KV cache to quantize"):
        ServingEngine(rcfg, rparams, kv_format="kv8_channel", **kw)
    reng = ServingEngine(rcfg, rparams, **kw)
    assert not reng.chunked and reng.attn_path is None


def test_serve_launcher_ring():
    argv = ["--arch", "h2o-danube-1.8b", "--reduced", "--batch", "2",
            "--prompt-len", "6", "--gen", "3", "--page-size", "4",
            "--device", "cpu"]
    ring = tserve.main(argv + ["--ring"])
    assert ring.results == tserve.main(argv).results
    assert ring.peak_pages == 0 and set(ring.prefill_logits) == {0, 1}
    with pytest.raises(ValueError, match="requires the paged cache; drop "
                       "--ring"):
        tserve.main(argv + ["--ring", "--kv-format", "kv8_channel"])
    with pytest.raises(ValueError, match="does not support this problem"):
        tserve.main(argv + ["--ring", "--attn-path", "fused"])
    assert tserve.main(argv + ["--refine-plans"]).results == ring.results
