"""The recurrent-carry and encoder-decoder families trained on gloo ranks
(``make_train_step(..., mesh=)`` through ``tests/torch_mesh_rank.py``)
against the JAX package's single-device ``make_train_step`` with the same
``TrainSettings`` on the same weights and batches: three steps, fp32
gradients, loss and grad norm at 1e-5 relative and the parameters, m and v
gathered from the ranks at rtol = atol = 1e-5.

Cases, REDUCED: rwkv6-7b at (2,2) under FSDP + ZeRO-2 with 2 microbatches
(one time-mix head a rank, ``w_bias`` cut with ``tm_w``) and at (1,2);
hymba-1.5b at (2,2) under ZeRO-3 with 2 microbatches (the SSM's channels
cut, ``bc_proj`` whole: its B and C through ``copy_to_model``), and with 5
query over 5 KV heads at (1,2) (the attention whole beside the cut SSM);
whisper-small at (1,4) (the encoder, self- and cross-attention at one head
a rank, the encoder's output into the cross K/V through ``copy_to_model``)
and at (2,1) (each data rank its rows' audio frames); rwkv, and whisper
with remat, at (2,2) under ZeRO-3 with 2 microbatches (each layer, the
encoder's too, gathered just before it runs, whisper's again in its
recompute, its gradient reduce-scattered onto the shares). Each world
size is spawned once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.runtime import steps as jsteps

from repro_torch.core.tree import tree_flatten_with_keys

import torch_mesh_rank
from torch_parity_helpers import jax_to_numpy

B, S, STEPS = 8, 16, 3
F32 = "float32"
WEIGHTS = {"rwkv": ("rwkv6-7b", {}),
           "hymba": ("hymba-1.5b", {}),
           "hymba_h5": ("hymba-1.5b", {"num_heads": 5, "num_kv_heads": 5}),
           "whisper": ("whisper-small", {}),
           "whisper_remat": ("whisper-small", {"remat": True})}
# (name, weights, mesh, TrainSettings fields)
CASES = {
    4: [("rwkv-2x2-zero2", "rwkv", (2, 2),
         dict(microbatches=2, fsdp=True, zero2=True, grad_dtype=F32)),
        ("hymba-2x2-zero3", "hymba", (2, 2),
         dict(microbatches=2, fsdp=True, grad_dtype=F32)),
        ("whisper-1x4", "whisper", (1, 4), dict(grad_dtype=F32)),
        ("rwkv-2x2-zero3", "rwkv", (2, 2),
         dict(microbatches=2, fsdp=True, grad_dtype=F32)),
        ("whisper-2x2-zero3", "whisper_remat", (2, 2),
         dict(microbatches=2, fsdp=True, grad_dtype=F32))],
    2: [("rwkv-1x2", "rwkv", (1, 2), dict(grad_dtype=F32)),
        ("hymba-heads5-1x2", "hymba_h5", (1, 2),
         dict(microbatches=2, grad_dtype=F32)),
        ("whisper-2x1-zero2", "whisper", (2, 1),
         dict(microbatches=2, fsdp=True, zero2=True, grad_dtype=F32))],
}
ALL = [(w, c) for w, cases in CASES.items() for c in cases]


def batches(arch, seed=0):
    """``STEPS`` numpy batches of B x S tokens (labels the next token),
    with an encdec arch's audio frames."""
    cfg = jconfigs.get_reduced(arch)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
        b = {"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}
        if cfg.family == "encdec":
            b["audio_embeds"] = rng.standard_normal(
                (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


_WEIGHTS = {}


def jax_weights(key):
    if key not in _WEIGHTS:
        arch, fields = WEIGHTS[key]
        cfg = dataclasses.replace(jconfigs.get_reduced(arch), **fields)
        params = JT.init_params(jax.random.PRNGKey(0), cfg)
        _WEIGHTS[key] = (cfg, params, jax_to_numpy(params))
    return _WEIGHTS[key]


# remat recomputes the same values: a remat run's weights are held
# against JAX's step on the same draw without it
JAX_KEY = {"whisper_remat": "whisper"}
_REF = {}


def jax_reference(key, settings):
    """JAX's single-device ``make_train_step`` with the same settings,
    three steps: {"metrics", "params", "m", "v"} as numpy. Without
    sharding pytrees that step reads neither ``fsdp`` nor ``zero2``, so
    one reference serves every such case."""
    key = JAX_KEY.get(key, key)
    fields = {k: v for k, v in settings.items() if k not in ("fsdp", "zero2")}
    ref_key = (key, tuple(sorted(fields.items())))
    if ref_key in _REF:
        return _REF[ref_key]
    cfg, params, _ = jax_weights(key)
    fields = dict(fields, grad_dtype=jnp.float32)
    opt_cfg = JAdamWConfig(lr=1e-3)
    state = jadamw_init(params, opt_cfg)
    step = jax.jit(jsteps.make_train_step(
        cfg, opt_cfg, jsteps.TrainSettings(**fields)))
    metrics = []
    for i, b in enumerate(batches(cfg.name)):
        params, state, m = step(
            params, state, {"batch": {k: jnp.asarray(v)
                                      for k, v in b.items()},
                            "step": jnp.asarray(i, jnp.int32)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    _REF[ref_key] = {"metrics": metrics, "params": jax_to_numpy(params),
                     "m": jax_to_numpy(state["m"]),
                     "v": jax_to_numpy(state["v"])}
    return _REF[ref_key]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's per-rank results, one spawn per world size."""
    out = {}
    for world, cases in CASES.items():
        job = {"weights": {}, "cases": []}
        for name, key, mesh, fields in cases:
            job["weights"][key] = jax_weights(key)[2]
            arch, cfg_fields = WEIGHTS[key]
            job["cases"].append(dict(
                name=name, arch=arch, cfg=cfg_fields, weights=key,
                mesh=mesh, train=dict(fields, batches=batches(arch))))
        results = torch_mesh_rank.spawn(
            world, job, tmp_path_factory.mktemp(f"trainfam{world}"),
            timeout=240)
        for name, *_ in cases:
            out[name] = [r[name] for r in results]
    return out


@pytest.mark.parametrize("world,case", ALL, ids=[c[0] for _, c in ALL])
def test_family_train_step_on_a_mesh_matches_jax(ranks, world, case):
    """Three steps on every rank against JAX's single-device step: loss
    and grad norm equal on every rank and within 1e-5 of JAX's, the whole
    parameters, m and v gathered to rank 0 within 1e-5; cutting the
    weights and gathering them back gives them bit for bit."""
    name, key, mesh, fields = case
    got = ranks[name]
    assert len(got) == world == mesh[0] * mesh[1]
    assert len({r["coords"] for r in got}) == world
    for r in got:
        assert r["identity"] and r["count"] == STEPS
        assert r["metrics"] == got[0]["metrics"], name
    want = jax_reference(key, fields)
    for step, (g, w) in enumerate(zip(got[0]["metrics"], want["metrics"])):
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"step {step}")
    for part in ("params", "m", "v"):
        g = dict(tree_flatten_with_keys(got[0][part]))
        w = dict(tree_flatten_with_keys(want[part]))
        assert g.keys() == w.keys()
        for k, a in w.items():
            np.testing.assert_allclose(g[k], np.asarray(a, np.float32),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{part} {'/'.join(k)}")


def test_family_rank_heads(ranks):
    """What a training rank runs: rwkv at (2,2) one of two time-mix heads,
    whisper at (1,4) one of four query and KV heads, hymba with 5/5 heads
    at (1,2) the whole attention."""
    assert {r["heads"][0] for r in ranks["rwkv-2x2-zero2"]} == {1}
    assert {r["heads"] for r in ranks["whisper-1x4"]} == {(1, 1)}
    assert {r["heads"] for r in ranks["hymba-heads5-1x2"]} == {(5, 5)}
