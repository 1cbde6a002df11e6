"""The port's recurrent-carry families against the JAX package on the CPU:
rwkv (rwkv6-7b) and hybrid (hymba-1.5b). The layer ops (``time_mix_seq``
with ``valid`` and ``collect_states``, ``time_mix_step``, ``channel_mix``,
``ssm_seq``, ``ssm_step``), the forward, a right-padded prefill chunk, the
decode step with an ``active`` mask, the verify step's carry checkpoints,
and engine-level greedy token parity on the REDUCED configs (dense and
W4A16, chunk sizes None/3/4, more requests than slots, ngram speculation,
drafts partly or always accepted, a proposer that is always wrong),
``cancel`` and slot reuse, the front door, plus the configs, the converter,
``quantize_tree``'s group 64 at K = 1600, the attention plans at hymba's
group of 5, the train step (three steps against JAX's, the backward
through the stepped wkv and SSM scans and hymba's ``0.5 * (attn + ssm)``),
remat, the refusals and the launchers.

Weights are the JAX package's, converted leaf for leaf; inputs come from
numpy with a fixed seed. REDUCED configs run in fp32: layer ops and carries
are held to 1e-5, logits after two layers and a vocab-wide head to 1e-4
(the two frameworks sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.runtime import speculative as jspec
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import FP32_LEAVES, from_jax_params
from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import planning
from repro_torch.kernels.paged_attention import paged_geometry
from repro_torch.launch import serve as tserve
from repro_torch.models import layers, rwkv, ssm
from repro_torch.models import transformer as T
from repro_torch.runtime import speculative as spec
from repro_torch.runtime.engine import Request, ServingEngine

from torch_parity_helpers import (assert_train_matches, check_remat,
                                  jax_to_numpy, jax_trained, port_train,
                                  train_launcher_round_trip)

ARCHS = ("rwkv6-7b", "hymba-1.5b")
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# layer ops
# ---------------------------------------------------------------------------

def _block(kind, quantized):
    """One rwkv block's or SSM head's params at the REDUCED size, JAX's and
    the port's (the same bytes)."""
    arch = "rwkv6-7b" if kind == "rwkv" else "hymba-1.5b"
    jcfg = jconfigs.get_reduced(arch)
    key = jax.random.PRNGKey(0)
    if kind == "rwkv":
        jp = jrwkv.init_rwkv_block(key, jcfg.d_model, jcfg.d_ff,
                                   jcfg.num_heads, jnp.float32)
    else:
        jp = jssm.init_ssm(key, jcfg.d_model, jcfg.d_inner, jcfg.ssm_state,
                           jnp.float32)
    if quantized:
        jp = jlayers.quantize_tree({"p": jp}, min_size=0)["p"]
    tp = from_jax_params(jax_to_numpy(jp), dtype=torch.float32, device="cpu")
    return jcfg, jp, configs.get_reduced(arch), tp


def _valid(kind, B, S):
    """None, or rows of S, S // 2 and 0 valid leading positions."""
    if kind is None:
        return None
    return np.arange(S)[None] < np.array([S, S // 2, 0][:B])[:, None]


def _as(v, mod):
    return None if v is None else (jnp.asarray(v) if mod == "jax"
                                   else torch.from_numpy(v))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("valid", [None, "padded"])
@pytest.mark.parametrize("collect", [False, True])
def test_time_mix_seq_matches_jax(quantized, valid, collect):
    jcfg, jp, cfg, tp = _block("rwkv", quantized)
    B, S, d, H = 3, 6, cfg.d_model, cfg.num_heads
    x = _x((B, S, d), 1)
    wkv = _x((B, H, d // H, d // H), 2) * 0.3
    shift = _x((B, d), 3)
    vm = _valid(valid, B, S)
    jres = jrwkv.time_mix_seq(
        jp, jnp.asarray(x), {"wkv": jnp.asarray(wkv),
                             "shift": jnp.asarray(shift)},
        num_heads=H, cfg=jcfg, valid=_as(vm, "jax"), collect_states=collect)
    tres = rwkv.time_mix_seq(
        tp, torch.from_numpy(x), {"wkv": torch.from_numpy(wkv),
                                  "shift": torch.from_numpy(shift)},
        num_heads=H, cfg=cfg, valid=_as(vm, "torch"), collect_states=collect)
    assert len(tres) == len(jres) == (3 if collect else 2)
    _close(tres[0], jres[0])
    _close(tres[1]["wkv"], jres[1]["wkv"])
    _close(tres[1]["shift"], jres[1]["shift"])
    if collect:
        assert tuple(tres[2].shape) == (B, S, H, d // H, d // H)
        _close(tres[2], jres[2])
    if vm is not None:
        # a row with no valid token keeps its carry exactly
        np.testing.assert_array_equal(tres[1]["wkv"][2].numpy(), wkv[2])
        np.testing.assert_array_equal(tres[1]["shift"][2].numpy(), shift[2])


@pytest.mark.parametrize("quantized", [False, True])
def test_time_mix_step_and_channel_mix_match_jax(quantized):
    jcfg, jp, cfg, tp = _block("rwkv", quantized)
    B, d, H = 3, cfg.d_model, cfg.num_heads
    x, prev = _x((B, d), 4), _x((B, d), 5)
    st = {"wkv": _x((B, H, d // H, d // H), 6) * 0.3, "shift": _x((B, d), 7)}
    jo, jst = jrwkv.time_mix_step(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st.items()},
        num_heads=H, cfg=jcfg)
    to, tst = rwkv.time_mix_step(
        tp, torch.from_numpy(x), {k: torch.from_numpy(v)
                                  for k, v in st.items()},
        num_heads=H, cfg=cfg)
    _close(to, jo)
    _close(tst["wkv"], jst["wkv"])
    _close(tst["shift"], jst["shift"])
    # channel-mix over a (B, S, d) sequence and a single row
    xs, ps = _x((B, 4, d), 8), _x((B, 4, d), 9)
    for a, b in ((xs, ps), (x, prev)):
        _close(rwkv.channel_mix(tp, torch.from_numpy(a), torch.from_numpy(b),
                                cfg),
               jrwkv.channel_mix(jp, jnp.asarray(a), jnp.asarray(b), jcfg))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("valid", [None, "padded"])
@pytest.mark.parametrize("collect", [False, True])
def test_ssm_seq_matches_jax(quantized, valid, collect):
    jcfg, jp, cfg, tp = _block("ssm", quantized)
    B, S = 3, 6
    x = _x((B, S, cfg.d_model), 1)
    h0 = _x((B, cfg.d_inner, cfg.ssm_state), 2)
    vm = _valid(valid, B, S)
    jres = jssm.ssm_seq(jp, jnp.asarray(x), jnp.asarray(h0), jcfg,
                        valid=_as(vm, "jax"), collect_states=collect)
    tres = ssm.ssm_seq(tp, torch.from_numpy(x), torch.from_numpy(h0), cfg,
                       valid=_as(vm, "torch"), collect_states=collect)
    assert len(tres) == len(jres)
    for got, want in zip(tres, jres):
        _close(got, want)
    if vm is not None:
        np.testing.assert_array_equal(tres[1][2].numpy(), h0[2])


@pytest.mark.parametrize("quantized", [False, True])
def test_ssm_step_matches_jax(quantized):
    jcfg, jp, cfg, tp = _block("ssm", quantized)
    x = _x((3, cfg.d_model), 3)
    h0 = _x((3, cfg.d_inner, cfg.ssm_state), 4)
    jo, jh = jssm.ssm_step(jp, jnp.asarray(x), jnp.asarray(h0), jcfg)
    to, th = ssm.ssm_step(tp, torch.from_numpy(x), torch.from_numpy(h0), cfg)
    _close(to, jo)
    _close(th, jh)


def test_softplus_matches_jax_past_the_torch_threshold():
    """``F.softplus`` returns x itself above 20; JAX's is logaddexp(x, 0)
    everywhere, and so is the port's."""
    x = np.array([-80.0, -20.0, -1.0, 0.0, 1e-3, 3.0, 19.9, 20.5, 40.0],
                 np.float32)
    _close(layers.softplus(torch.from_numpy(x)),
           jax.nn.softplus(jnp.asarray(x)), dict(rtol=1e-6, atol=0))


# ---------------------------------------------------------------------------
# configs, quantization and conversion
# ---------------------------------------------------------------------------

def test_configs_and_param_counts_match_jax():
    for arch in ARCHS:
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_reduced, jconfigs.get_reduced)):
            c, j = get(arch), jget(arch)
            for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "d_ff", "vocab_size", "head_dim", "ssm_state",
                      "ssm_expand", "sliding_window", "rope_theta",
                      "family"):
                assert getattr(c, f) == getattr(j, f), (arch, f)
            assert c.param_count() == j.param_count()
            assert c.d_inner == j.d_inner
            assert c.attn_free == j.attn_free
            assert c.supports_long_context() == j.supports_long_context()
    # the full configs' sizes the chip smoke test serves at
    assert configs.get_config("rwkv6-7b").param_count() == 7_516_192_768
    assert configs.get_config("hymba-1.5b").param_count() == 1_638_400_000


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's init builds JAX's tree: the same leaves, shapes and
    dtypes (fp32 ``w_bias``, ``A_log`` and ``D``), the deterministic
    leaves equal (``A_log`` to an fp32 ulp: the two ``log``s round
    differently)."""
    jcfg, cfg = jconfigs.get_reduced(arch), configs.get_reduced(arch)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    jp = jax_to_numpy(JT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def walk(t, j, path=()):
        if isinstance(t, dict):
            assert set(t) == set(j), path
            for k in t:
                walk(t[k], j[k], path + (k,))
            return
        assert tuple(t.shape) == j.shape, path
        assert str(t.dtype).split(".")[-1] == j.dtype.name, path
        if path[-1] in ("w_bias", "A_log", "D"):
            np.testing.assert_allclose(t.numpy(), j, rtol=2 ** -23, atol=0)

    walk(tp, jp)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_keeps_the_fp32_leaves(arch):
    """At a bf16 model dtype, JAX's fp32 leaves (rwkv's ``w_bias``, the
    SSM's ``A_log`` and ``D``) cross as fp32, bit for bit; the rest as
    bf16."""
    jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                               dtype=jnp.bfloat16)
    jp = jax_to_numpy(JT.quantize_params(
        JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg, min_size=0))
    tp = from_jax_params(jp, dtype=torch.bfloat16, device="cpu")
    seen = set()

    def walk(t, j, name=""):
        if isinstance(t, QuantizedTensor):
            np.testing.assert_array_equal(t.packed.numpy(), j["packed"])
            return
        if isinstance(t, dict):
            for k in t:
                walk(t[k], j[k], k)
            return
        if name in FP32_LEAVES:
            seen.add(name)
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), j)
        else:
            assert t.dtype == torch.bfloat16, name

    walk(tp, jp)
    assert seen == ({"w_bias"} if arch == "rwkv6-7b" else {"A_log", "D"})


def test_quantize_tree_picks_group_64_at_k_1600():
    """hymba's K = 1600 leaves are not 128-aligned: both packages quantize
    them at group 64 (and K = 3200 at 128), byte for byte; ``bc_proj``
    stays dense."""
    rng = np.random.default_rng(0)
    tree = {"layers": {
        "attn": {"wk": {"kernel": rng.standard_normal((1600, 320))}},
        "ssm": {"out_proj": {"kernel": rng.standard_normal((3200, 1600))},
                "bc_proj": {"kernel": rng.standard_normal((1600, 32))}}}}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    jq = jax_to_numpy(jlayers.quantize_tree(jax.tree.map(jnp.asarray, tree)))
    tq = layers.quantize_tree(jax.tree.map(torch.from_numpy, tree))
    for path, group in ((("attn", "wk"), 64), (("ssm", "out_proj"), 128)):
        got = tq["layers"][path[0]][path[1]]["kernel"]
        want = jq["layers"][path[0]][path[1]]["kernel"]
        assert isinstance(got, QuantizedTensor)
        assert got.group_size == want["group_size"] == group
        assert got.format.name == want["format"]["name"]
        np.testing.assert_array_equal(got.packed.numpy(), want["packed"])
        np.testing.assert_array_equal(got.scales.numpy(), want["scales"])
    assert isinstance(tq["layers"]["ssm"]["bc_proj"]["kernel"],
                      torch.Tensor)


def test_attention_plans_at_hymba_group():
    """hymba's 25 query heads over 5 KV heads: 5 rows a decode block, a
    32-token chunk in two Q tiles of 16 (80 rows), a k = 4 verify window
    in one tile of 25 rows; each a shape the paged kernel takes at D = 64
    (5 of its 8 warps carry the chunk's row groups)."""
    cfg = configs.get_config("hymba-1.5b")
    G = cfg.num_heads // cfg.num_kv_heads
    assert (G, cfg.head_dim) == (5, 64)
    for q_len, tq, rows in ((1, 1, 5), (32, 16, 80), (5, 5, 25)):
        assert planning.choose_q_block(q_len, G) == tq
        geo = paged_geometry(tq * G, 64, torch.bfloat16, False, 18)
        assert geo.row_groups == -(-rows // 16)
        assert geo.row_groups * geo.key_groups <= 8
    problem = planning.AttentionProblem(
        B=8, Hq=25, Hkv=5, D=64, cache_len=1024, page_size=16, window=1024,
        kv_format="kv_fp16", paged=True, backend="cuda", act_bytes=2)
    for q_len in (1, 32, 5):
        plan = planning.plan_attention(
            dataclasses.replace(problem, q_len=q_len,
                                B=1 if q_len == 32 else 8))
        assert plan.path == "fused" and 64 % plan.kv_partitions == 0


# ---------------------------------------------------------------------------
# the model's steps
# ---------------------------------------------------------------------------

_WEIGHTS = {}


def _weights(arch, quantized):
    key = (arch, quantized)
    if key not in _WEIGHTS:
        jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                                   w4a16_strategy="xla")
        jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
        if quantized:
            jparams = JT.quantize_params(jparams, jcfg, min_size=0)
        cfg = configs.get_reduced(arch)
        tparams = from_jax_params(jax_to_numpy(jparams), dtype=cfg.dtype,
                                  device="cpu")
        _WEIGHTS[key] = (jcfg, jparams, cfg, tparams)
    return _WEIGHTS[key]


PS, NB, CACHE_LEN = 4, 13, 16


def _states(jcfg, cfg, B, seed):
    """JAX's and the port's paged states (rwkv: carry-only) with the same
    random carries."""
    js = JT.init_paged_state(jcfg, B, CACHE_LEN, page_size=PS,
                             num_blocks=NB, kv_format="kv_fp16")
    ts = T.init_paged_state(cfg, B, CACHE_LEN, page_size=PS, num_blocks=NB,
                            kv_format="kv_fp16", device="cpu")
    rng = np.random.default_rng(seed)
    cache = dict(js["cache"])
    for k in T.CARRY_LEAVES:
        if k in ts["cache"]:
            v = (rng.standard_normal(tuple(ts["cache"][k].shape)) * 0.3
                 ).astype(np.float32)
            cache[k] = jnp.asarray(v)
            ts["cache"][k].copy_(torch.from_numpy(v))
    return dict(js, cache=cache), ts


def _carries(state, mod):
    cache = state["cache"]
    return {k: (cache[k].numpy().copy() if mod == "torch"
                else np.asarray(cache[k]))
            for k in T.CARRY_LEAVES if k in cache}


def _tables(cfg, rows):
    if cfg.family == "rwkv":
        return None, None
    t = np.asarray(rows, np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch):
    jcfg, jparams, cfg, tparams = _weights(arch, False)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    _close(T.forward(tparams, cfg, torch.from_numpy(toks)),
           JT.forward(jparams, jcfg, jnp.asarray(toks)), LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_prefill_matches_jax(arch):
    """The whole-prompt prefill into a ring state: last-position logits and
    the carries after the prompt."""
    jcfg, jparams, cfg, tparams = _weights(arch, False)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    jl, jextra = JT.prefill(jparams, jcfg, jnp.asarray(toks), cache_len=8)
    tl, ts = T.prefill(tparams, cfg, torch.from_numpy(toks), cache_len=8)
    _close(tl, jl, LOGIT_TOL)
    for k, v in _carries(ts, "torch").items():
        _close(v, jextra["cache"][k])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_chunk_step_matches_jax(arch, quantized):
    """Slot 1 of two prefills 6 tokens in chunks of 4 (the second
    right-padded): logits at every chunk, slot 1's carries at the last real
    token, slot 0's untouched."""
    jcfg, jparams, cfg, tparams = _weights(arch, quantized)
    js, ts = _states(jcfg, cfg, 2, seed=1)
    before = _carries(ts, "torch")
    jt, tt = _tables(cfg, [[5, 6, 7, 8]])
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=6).astype(np.int32)
    C = 4
    for start in (0, 4):
        n = min(C, 6 - start)
        positions = np.full((1, C), -1, np.int32)
        positions[0, :n] = np.arange(start, start + n)
        seg = np.zeros(C, np.int32)
        seg[:n] = prompt[start:start + n]
        jh = jlayers.embed(jparams["embed"], jnp.asarray(seg))[None]
        jh = jnp.where(jnp.asarray(positions >= 0)[..., None], jh, 0.0)
        jl, js = JT.prefill_chunk_step(
            jparams, jcfg, js, jh, jnp.asarray(positions), jt, 1,
            cache_len=CACHE_LEN, kv_format="kv_fp16")
        tl, ts = T.prefill_chunk_step(
            tparams, cfg, ts, torch.from_numpy(np.array(jh)),
            torch.from_numpy(positions), tt, 1, cache_len=CACHE_LEN,
            kv_format="kv_fp16")
        _close(tl, jl, LOGIT_TOL)
    got, want = _carries(ts, "torch"), _carries(js, "jax")
    for k in got:
        _close(got[k], want[k])
        np.testing.assert_array_equal(got[k][:, 0], before[k][:, 0])
        assert not np.array_equal(got[k][:, 1], before[k][:, 1])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_step_active_mask_matches_jax(arch, quantized):
    """Three decode steps over three slots, slot 1 not decoding (its table
    row -1, ``active`` False): logits, the carries of the active rows, and
    slot 1's carries unchanged, as JAX's."""
    jcfg, jparams, cfg, tparams = _weights(arch, quantized)
    js, ts = _states(jcfg, cfg, 3, seed=3)
    before = _carries(ts, "torch")
    jt, tt = _tables(cfg, [[1, 2, 3, 4], [-1] * 4, [9, 10, 11, 12]])
    active = np.array([True, False, True])
    tok = np.array([7, 9, 11], np.int32)
    for step in range(3):
        pos = np.array([step, 0, 2 + step], np.int32)
        jl, js = JT.decode_step(
            jparams, jcfg, js, jnp.asarray(tok), jnp.asarray(pos), tables=jt,
            active=jnp.asarray(active), cache_len=CACHE_LEN,
            kv_format="kv_fp16")
        tl, ts = T.decode_step(
            tparams, cfg, ts, torch.from_numpy(tok), torch.from_numpy(pos),
            tables=tt, active=torch.from_numpy(active), cache_len=CACHE_LEN,
            kv_format="kv_fp16")
        _close(tl[active], np.asarray(jl)[active], LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    got, want = _carries(ts, "torch"), _carries(js, "jax")
    for k in got:
        _close(got[k], want[k])
        np.testing.assert_array_equal(got[k][:, 1], before[k][:, 1])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quantized", [False, True])
def test_verify_step_carries_match_jax(arch, quantized):
    """A prefill chunk per slot, then one verify window per slot (slot 1
    with a short proposal, padded with -1): logits at every live position,
    every carry checkpoint (index 0 the incoming carry), and the state's
    own carries returned unchanged."""
    jcfg, jparams, cfg, tparams = _weights(arch, quantized)
    js, ts = _states(jcfg, cfg, 2, seed=5)
    jt, tt = _tables(cfg, [[1, 2, 3, 4], [5, 6, 7, 8]])
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    positions = np.arange(6, dtype=np.int32)[None]
    for b in range(2):
        jh = jlayers.embed(jparams["embed"], jnp.asarray(prompts[b]))[None]
        _, js = JT.prefill_chunk_step(
            jparams, jcfg, js, jh, jnp.asarray(positions),
            None if jt is None else jt[b:b + 1], b, cache_len=CACHE_LEN,
            kv_format="kv_fp16")
        _, ts = T.prefill_chunk_step(
            tparams, cfg, ts, torch.from_numpy(np.array(jh)),
            torch.from_numpy(positions),
            None if tt is None else tt[b:b + 1], b, cache_len=CACHE_LEN,
            kv_format="kv_fp16")
    before = _carries(ts, "torch")
    tok = np.array([[7, 9, 11, 13], [5, 8, 0, 0]], np.int32)
    pos = np.array([[6, 7, 8, 9], [6, 7, -1, -1]], np.int32)
    jl, js, jc = JT.verify_step(
        jparams, jcfg, js, jnp.asarray(tok), jnp.asarray(pos), jt,
        cache_len=CACHE_LEN, kv_format="kv_fp16")
    tl, ts, tc = T.verify_step(
        tparams, cfg, ts, torch.from_numpy(tok), torch.from_numpy(pos), tt,
        cache_len=CACHE_LEN, kv_format="kv_fp16")
    live = pos >= 0
    _close(tl.numpy()[live], np.asarray(jl)[live], LOGIT_TOL)
    assert set(tc) == set(jc) == set(before)
    for k in tc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert tc[k].shape[2] == tok.shape[1] + 1
        _close(tc[k], jc[k])
        np.testing.assert_array_equal(tc[k][:, :, 0].numpy(), before[k])
        np.testing.assert_array_equal(ts["cache"][k].numpy(), before[k])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(cfg, n, plen, seed=0):
    """``n`` prompts; the first two repeat a short segment (the ngram
    proposer has something to match)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(n, plen)).astype(np.int32)
    base = toks[0, :max(2, plen // 3)]
    rep = np.tile(base, -(-plen // len(base)))[:plen]
    return [rep if i < 2 else toks[i] for i in range(n)]


def _requests(make, prompts, G):
    return [make(rid=i, prompt=p, max_new_tokens=G, arrival_step=i)
            for i, p in enumerate(prompts)]


def _engine_pair(arch, quantized, prompts, G, *, jspeculate=None,
                 speculate=None, **kw):
    jcfg, jparams, cfg, tparams = _weights(arch, quantized)
    common = dict(max_batch=2, max_prompt_len=max(len(p) for p in prompts),
                  max_new_tokens=G, page_size=4, **kw)
    jrep = JServingEngine(jcfg, jparams, speculate=jspeculate or speculate,
                          **common).run(_requests(JRequest, prompts, G))
    eng = ServingEngine(cfg, tparams, speculate=speculate, device="cpu",
                        **common)
    return jrep, eng.run(_requests(Request, prompts, G)), eng


_PLAIN = {}


def _plain_run(arch, prompts, G, **kw):
    """The port's plain decode (quantized weights, no proposer) of
    ``prompts``: the tokens a speculating run must reproduce. Cached per
    arch, prompts and settings (the accepting-drafts cases share one)."""
    key = (arch, tuple(tuple(p.tolist()) for p in prompts), G,
           tuple(sorted(kw.items())))
    if key not in _PLAIN:
        _, _, cfg, tparams = _weights(arch, True)
        eng = ServingEngine(
            cfg, tparams, device="cpu", max_batch=2,
            max_prompt_len=max(len(p) for p in prompts), max_new_tokens=G,
            page_size=4, **kw)
        _PLAIN[key] = eng.run(_requests(Request, prompts, G))
    return _PLAIN[key]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("chunk", [None, 3, 4])
def test_engine_token_parity_with_jax(arch, quantized, chunk):
    """The acceptance: 3 requests through 2 slots (the third reuses a slot
    whose carry must be reset at admit), chunked prefill interleaved with
    decode (the active mask keeps a prefilling slot's carry): JAX's
    greedy tokens, exactly."""
    cfg = configs.get_reduced(arch)
    jrep, rep, eng = _engine_pair(arch, quantized, _prompts(cfg, 3, 9), 6,
                                  prefill_chunk=chunk)
    assert rep.results == jrep.results and sorted(rep.results) == [0, 1, 2]
    assert all(len(v) == 6 for v in rep.results.values())
    assert rep.steps == jrep.steps
    if arch == "rwkv6-7b":
        # the carry-only state: no pages, no attention path
        assert not eng.paged and eng.alloc is None
        assert eng.attn_path is None and rep.peak_pages == 0
        assert set(eng.last_state["cache"]) == {"wkv", "shift", "cm_shift"}
    else:
        assert eng.paged and eng.alloc.pages_in_use == 0
        assert not eng.share_prefix
    if quantized:
        assert {p.strategy for p in eng.plans.values()} == {"reference"}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_ngram_speculation_parity_with_jax(arch):
    """ngram speculation: every verify step's carries committed at the
    accepted frontier; tokens, drafts proposed and accepted and steps equal
    JAX's."""
    cfg = configs.get_reduced(arch)
    # seed 1: prompts on which prompt lookup proposes for both archs
    jrep, rep, eng = _engine_pair(arch, True, _prompts(cfg, 3, 9, seed=1),
                                  8, prefill_chunk=4, speculate="ngram",
                                  spec_k=3)
    assert rep.results == jrep.results
    assert (rep.proposed_tokens, rep.accepted_tokens, rep.steps) == \
        (jrep.proposed_tokens, jrep.accepted_tokens, jrep.steps)
    assert rep.proposed_tokens > 0


def _oracle(base, prompts, plain, right, vocab):
    """A proposer (``base`` is either package's Proposer) that drafts the
    plain run's next tokens, the first ``right`` of them right and the
    rest the maximum-vocab token: each verify step accepts ``right``
    drafts (fewer near a request's end), so carries commit at checkpoints
    past 1."""
    class Oracle(base):
        name = "ngram"

        def propose(self, views, k):
            out = {}
            for v in views:
                ctx = list(v.context)
                rid = next(i for i, p in enumerate(prompts)
                           if list(p) == ctx[:len(p)])
                done = len(ctx) - len(prompts[rid])
                want = plain[rid][done:done + k]
                out[v.slot] = [t if j < right else vocab - 1
                               for j, t in enumerate(want)]
            return out
    return Oracle()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("right", [3, 2])
def test_engine_accepting_drafts_parity_with_jax(arch, right):
    """Drafts the verify step accepts, all k or the first 2 of 3: every
    committed carry is checkpoint 1 + accepted > 1; the tokens equal the
    plain decode's and JAX's under the same proposer."""
    cfg = configs.get_reduced(arch)
    prompts = _prompts(cfg, 3, 9, seed=6)
    plain = _plain_run(arch, prompts, 8, prefill_chunk=4)
    mk = lambda base: _oracle(base, prompts, plain.results, right,  # noqa
                              cfg.vocab_size)
    jrep, rep, _ = _engine_pair(arch, True, prompts, 8, prefill_chunk=4,
                                speculate=mk(spec.Proposer),
                                jspeculate=mk(jspec.Proposer), spec_k=3)
    assert rep.results == jrep.results == plain.results
    assert (rep.proposed_tokens, rep.accepted_tokens, rep.steps) == \
        (jrep.proposed_tokens, jrep.accepted_tokens, jrep.steps)
    assert rep.accepted_tokens > rep.steps - plain.steps
    assert rep.steps < plain.steps


class _AlwaysWrong(spec.Proposer):
    """Drafts the maximum-vocab token: every verify rejects them all."""

    name = "ngram"

    def __init__(self, vocab):
        self.vocab = vocab

    def propose(self, views, k):
        return {v.slot: [self.vocab - 1] * k for v in views}


class _JAlwaysWrong(jspec.Proposer):
    name = "ngram"

    def __init__(self, vocab):
        self.vocab = vocab

    def propose(self, views, k):
        return {v.slot: [self.vocab - 1] * k for v in views}


@pytest.mark.parametrize("arch", ARCHS)
def test_always_wrong_proposer_rewinds_every_step(arch):
    """Every verify step rejects every draft, so each one commits the carry
    after the last emitted token alone: the tokens equal JAX's under the
    same proposer and the port's plain decode."""
    cfg = configs.get_reduced(arch)
    prompts = _prompts(cfg, 3, 9, seed=5)
    jrep, rep, _ = _engine_pair(
        arch, True, prompts, 8, prefill_chunk=4,
        speculate=_AlwaysWrong(cfg.vocab_size),
        jspeculate=_JAlwaysWrong(cfg.vocab_size), spec_k=3)
    plain = _plain_run(arch, prompts, 8, prefill_chunk=4)
    assert rep.results == jrep.results == plain.results
    assert rep.proposed_tokens == jrep.proposed_tokens > 0
    assert rep.accepted_tokens == 0


def test_apply_carry_selection_takes_each_rows_checkpoint():
    """Row b of every carry leaf becomes checkpoint ``sel[b]`` of the
    stack, in every layer."""
    cfg = configs.get_reduced("rwkv6-7b")
    _, _, _, tparams = _weights("rwkv6-7b", False)
    eng = ServingEngine(cfg, tparams, max_batch=3, max_prompt_len=4,
                        max_new_tokens=2, device="cpu")
    eng.start()
    stacks = {k: torch.randn((cfg.num_layers, 3, 5, *v.shape[2:]))
              for k, v in eng._state["cache"].items()}
    eng._apply_carry_selection(stacks, np.array([0, 4, 2]))
    for k, v in eng._state["cache"].items():
        for b, c in enumerate((0, 4, 2)):
            torch.testing.assert_close(v[:, b], stacks[k][:, b, c], rtol=0,
                                       atol=0)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("where", ["decode", "prefill"])
def test_cancel_then_reuse_the_slot(arch, where):
    """Cancel request 0 mid-decode or mid-prefill while request 1 decodes
    beside it, then admit request 2 into the freed slot: request 1's and
    request 2's tokens equal their solo runs' (request 2's carry was reset
    at admit, whatever the cancelled one left), and JAX's."""
    jcfg, jparams, cfg, tparams = _weights(arch, True)
    prompts = _prompts(cfg, 3, 9, seed=7)
    kw = dict(max_batch=2, max_prompt_len=9, max_new_tokens=6, page_size=4,
              prefill_chunk=3)
    eng = ServingEngine(cfg, tparams, device="cpu", **kw)
    solo = {i: eng.run([Request(rid=i, prompt=prompts[i],
                                max_new_tokens=6)]).results[i]
            for i in (1, 2)}
    jeng = JServingEngine(jcfg, jparams, **kw)
    for i in (1, 2):
        assert solo[i] == jeng.run([JRequest(
            rid=i, prompt=prompts[i], max_new_tokens=6)]).results[i]
    eng.start()
    for i in (0, 1):
        eng.submit(Request(rid=i, prompt=prompts[i], max_new_tokens=6))
    streamed = {}
    if where == "prefill":
        assert not eng.step().emitted          # one 3-token chunk each
        assert eng._slots[0].phase == "prefill"
    while where == "decode" and not streamed.get(0):
        for rid, toks in eng.step().emitted.items():
            streamed.setdefault(rid, []).extend(toks)
    assert eng.cancel(0) is True
    assert eng.report.cancelled[0] == streamed.get(0, [])
    eng.submit(Request(rid=2, prompt=prompts[2], max_new_tokens=6))
    rep = eng.drain()
    assert sorted(rep.results) == [1, 2]
    assert rep.results[1] == solo[1] and rep.results[2] == solo[2]
    if eng.paged:
        assert eng.alloc.pages_in_use == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_front_door_serves_the_carry_families(arch):
    """``--http 0``: the launcher's requests through the front door on
    127.0.0.1 (SSE clients, variable prompt lengths) give the in-process
    run's tokens."""
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--requests", "3",
            "--prompt-len", "4:8", "--gen", "4", "--page-size", "4",
            "--device", "cpu"]
    ref = tserve.main(argv)
    rep = tserve.main(argv + ["--http", "0", "--arrival-every", "1"])
    assert rep.results == ref.results and sorted(rep.results) == [0, 1, 2]
    assert {len(r) for r in rep.results.values()} == {4}


# ---------------------------------------------------------------------------
# refusals and the launchers
# ---------------------------------------------------------------------------

def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_quantized_kv_format_refused_on_rwkv_as_jax():
    jcfg, jparams, cfg, tparams = _weights("rwkv6-7b", False)
    kw = dict(max_batch=2, max_prompt_len=4, max_new_tokens=2,
              kv_format="kv8_channel")
    want = _message(lambda: JServingEngine(jcfg, jparams, **kw))
    assert _message(lambda: ServingEngine(cfg, tparams, device="cpu",
                                          **kw)) == want
    assert "no KV cache" in want
    want = _message(lambda: jserve.validate_kv_format(
        "kv8_channel", "w4a16_g128", paged=True, attn_free=True))
    assert _message(lambda: tserve.validate_kv_format(
        "kv8_channel", "w4a16_g128", attn_free=True)) == want
    with pytest.raises(ValueError, match="no KV cache to quantize"):
        tserve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                     "--kv-format", "kv8_channel"])
    # hymba's attention half pages its KV: kv8_channel is taken
    assert tserve.validate_kv_format("kv8_channel", "w4a16_g128") == \
        "kv8_channel"


@pytest.mark.parametrize("arch", ARCHS)
def test_carry_family_draft_and_training_refused(arch, tmp_path):
    """A carry-family draft is refused (it cannot rewind), as in JAX; the
    train launcher, which refused these archs once, trains them with two
    microbatches and checkpoints that restore."""
    cfg = configs.get_reduced(arch)
    with pytest.raises(ValueError, match="rewind") as info:
        spec.DraftModelProposer(cfg)
    with pytest.raises(ValueError) as jinfo:
        jspec.DraftModelProposer(jconfigs.get_reduced(arch))
    assert str(info.value) == str(jinfo.value)
    with pytest.raises(ValueError, match="rewind"):
        spec.make_proposer("draft:layers=1", target_cfg=cfg)
    # ngram validates for the carry families
    assert spec.validate_speculate("ngram", 4, cfg=cfg) == "ngram"
    train_launcher_round_trip(arch, tmp_path, "--microbatches", "2")


def test_whisper_still_refused():
    """whisper-small is ported now (``tests/test_torch_encdec.py``): the
    family check passes it, and refuses only a family it does not know;
    the registry refuses only an arch the JAX package lacks."""
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(name="whisper-small", family="encdec", num_layers=1,
                      d_model=64, num_heads=2, num_kv_heads=2, d_ff=128,
                      vocab_size=256)
    T.check_family(cfg)
    assert configs.get_config("whisper-small").family == "encdec"
    with pytest.raises(NotImplementedError, match="unknown family 'nope'"):
        T.check_family(dataclasses.replace(cfg, family="nope"))
    with pytest.raises(ValueError, match="not ported"):
        configs.get_config("whisper-large")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_cpu(arch, capsys):
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "6",
            "--gen", "3", "--device", "cpu"]
    if arch == "hymba-1.5b":
        argv += ["--speculate", "ngram"]
    rep = tserve.main(argv)
    out = capsys.readouterr().out
    assert sorted(rep.results) == [0, 1]
    assert all(len(v) == 3 for v in rep.results.values())
    if arch == "rwkv6-7b":
        # no KV cache: no pages and no attention-path lines, as JAX's
        assert "paged KV" not in out and "[serve] pages:" not in out
        assert "attn path" not in out and "recurrent carries only" in out
    else:
        assert "paged KV" in out and "verify gather" in out
        assert "[serve] speculative:" in out


# ---------------------------------------------------------------------------
# training: the train step against JAX's, remat, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_trained, arch, micro, attn_impl):
    """Three ``make_train_step`` steps from JAX's parameters against
    JAX's (``torch_parity_helpers.assert_train_matches``)."""
    want = jax_trained(arch, micro)
    got = port_train(arch, micro, want["params0"], attn_impl=attn_impl)
    assert_train_matches(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_grads(arch, monkeypatch):
    check_remat(arch, monkeypatch)
