"""The port's training path against the JAX package on the CPU: the
sequence-mode forward and loss, the train step (3 steps, 1 and 2
microbatches), AdamW and its schedule, and the synthetic token stream, on
REDUCED h2o-danube-1.8b (fp32, SWA window 16). Parameters and optimizer
state are the JAX package's, converted leaf for leaf; tokens come from the
shared numpy stream.

Tolerances: the forward is held at 1e-4, the JAX flash test's own
(``tests/test_flash_attention.py``: two fp32 attention orders and two
layers of fp32 GEMMs); the train step at 1e-5 relative for loss and grad
norm and rtol = atol = 1e-5 for parameters and moments (fp32 math; the
bf16 gradient cast can round a last-bit difference either way, which moves
a moment by 2^-8 of one clipped gradient, below 1e-5 at this size).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import SyntheticTokenStream as JStream
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.runtime import steps as jsteps

from repro_torch import configs
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.core.tree import tree_flatten_with_keys
from repro_torch.data import SyntheticTokenStream, make_batch_iterator
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_update, cosine_schedule
from repro_torch.runtime import steps as tsteps

from torch_parity_helpers import jax_to_numpy

ARCH = "h2o-danube-1.8b"


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_reduced(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = configs.get_reduced(ARCH)
    return jcfg, jparams, cfg


def _tparams(jparams, cfg):
    return from_jax_params(jax_to_numpy(jparams), dtype=cfg.dtype)


def _tokens(cfg, B=2, S=24, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _assert_trees_close(got, want, rtol, atol):
    want = dict(tree_flatten_with_keys(jax_to_numpy(want)))
    got = dict(tree_flatten_with_keys(got))
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol, err_msg="/".join(key))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_forward_matches_jax(model, attn_impl, remat):
    jcfg, jparams, cfg = model
    jcfg = dataclasses.replace(jcfg, attn_impl=attn_impl, remat=remat)
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl, remat=remat)
    toks = _tokens(cfg)
    want = JT.forward(jparams, jcfg, jnp.asarray(toks))
    got = T.forward(_tparams(jparams, cfg), cfg, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_loss_fn_matches_jax(model, attn_impl):
    """Masked labels (< 0) drop out of the mean, as in JAX."""
    jcfg, jparams, cfg = model
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    toks = _tokens(cfg, seed=1)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -3:] = -1
    want = JT.loss_fn(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                      "labels": jnp.asarray(labels)})
    got = T.loss_fn(_tparams(jparams, cfg), cfg,
                    {"tokens": torch.from_numpy(toks),
                     "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax(model, micro, attn_impl):
    """Three steps from the JAX package's parameters and optimizer state
    against JAX ``make_train_step`` with chunked attention (JAX cannot
    differentiate its flash kernel). The schedule's scale is 0 at step 0,
    so steps 1 and 2 are the first to move the parameters."""
    jcfg, jparams, cfg = model
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    jopt_cfg, opt_cfg = JAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    jstate = jadamw_init(jparams, jopt_cfg)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt_cfg, jsteps.TrainSettings(microbatches=micro)))
    tstep = tsteps.make_train_step(cfg, opt_cfg,
                                   tsteps.TrainSettings(microbatches=micro))
    params = _tparams(jparams, cfg)
    state = from_jax_opt_state(jax_to_numpy(jstate))
    assert state["m"]["layers"]["attn"]["wq"]["kernel"].dtype == torch.float32
    assert state["count"].dtype == torch.int32
    jstream = JStream(vocab_size=cfg.vocab_size, seq_len=16, batch_size=4)
    tstream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=16,
                                   batch_size=4)
    for step in range(3):
        jparams, jstate, jm = jstep(
            jparams, jstate, {"batch": jstream.batch_at(step),
                              "step": jnp.asarray(step, jnp.int32)})
        params, state, m = tstep(params, state,
                                 {"batch": tstream.batch_at(step),
                                  "step": step})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {step}")
    _assert_trees_close(params, jparams, 1e-5, 1e-5)
    _assert_trees_close(state["m"], jstate["m"], 1e-5, 1e-5)
    _assert_trees_close(state["v"], jstate["v"], 1e-5, 1e-5)
    assert int(state["count"]) == int(jstate["count"]) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(dtype):
    """Random trees (a stacked matrix, a vector, a 0-d leaf), bf16 grads
    with a norm above the clip, three updates at warmup-scale and full
    learning rates."""
    rng = np.random.default_rng(0)

    def tree(scale):
        return {"a": {"kernel": (rng.standard_normal((3, 16, 8)) * scale)
                      .astype(np.float32)},
                "b": {"scale": (rng.standard_normal(8) * scale)
                      .astype(np.float32)},
                "c": np.float32(rng.standard_normal() * scale)}

    def to_j(t, dt):
        return jax.tree.map(lambda a: jnp.asarray(a, dt), t)

    def to_t(t, dt):
        return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a))
                            .to(dt), t)

    p = tree(1.0)
    jparams, tparams = to_j(p, getattr(jnp, dtype)), \
        to_t(p, getattr(torch, dtype))
    jcfg, tcfg = JAdamWConfig(), AdamWConfig()
    jstate = jadamw_init(jparams, jcfg)
    tstate = from_jax_opt_state(jax_to_numpy(jstate))
    for lr_scale in (0.01, 1.0, 0.37):
        g = tree(3.0)
        jparams, jstate, jm = jadamw_update(
            to_j(g, jnp.bfloat16), jstate, jparams, jcfg,
            jnp.float32(lr_scale))
        tparams, tstate, tm = adamw_update(
            to_t(g, torch.bfloat16), tstate, tparams, tcfg,
            torch.tensor(lr_scale, dtype=torch.float32))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    tol = 1e-6 if dtype == "float32" else 1e-2
    _assert_trees_close(tparams, jparams, tol, tol)
    _assert_trees_close(tstate["m"], jstate["m"], 1e-6, 1e-7)
    _assert_trees_close(tstate["v"], jstate["v"], 1e-6, 1e-7)
    assert tparams["a"]["kernel"].dtype == getattr(torch, dtype)
    assert tstate["m"]["a"]["kernel"].dtype == torch.float32


def test_cosine_schedule_matches_jax():
    for step in (0, 1, 2, 50, 99, 100, 101, 4321, 9999, 10_000, 20_000):
        got = cosine_schedule(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(jcosine(
            jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=1e-9)
    assert float(cosine_schedule(0)) == 0.0


@pytest.mark.parametrize("host", [0, 3])
def test_synthetic_stream_matches_jax(host):
    kw = dict(vocab_size=512, seq_len=33, batch_size=3, seed=7,
              host_id=host, num_hosts=4)
    js, ts = JStream(**kw), SyntheticTokenStream(**kw)
    for step in (0, 1, 17):
        jb, tb = js.batch_at(step), ts.batch_at(step)
        for key in ("tokens", "labels"):
            assert tb[key].dtype == torch.int32
            np.testing.assert_array_equal(tb[key].numpy(),
                                          np.asarray(jb[key]))
    it = make_batch_iterator(ts, start_step=17, extras={"x": 1})
    first = next(it)
    assert first["x"] == 1 and torch.equal(first["tokens"],
                                           ts.batch_at(17)["tokens"])
    assert torch.equal(next(it)["labels"], ts.batch_at(18)["labels"])


def test_train_launcher_on_cpu(tmp_path):
    """The launcher trains REDUCED danube on the CPU through the flash
    Function (its plain forward): the loss falls over 20 steps, the
    history holds only checkpoints, and the plan cache is written."""
    plans = tmp_path / "plans.json"
    report = ttrain.main([
        "--arch", ARCH, "--reduced", "--steps", "20", "--batch", "4",
        "--seq", "32", "--device", "cpu", "--ckpt-dir",
        str(tmp_path / "ck"), "--ckpt-every", "10", "--plan-cache",
        str(plans)])
    assert len(report.losses) == len(report.step_s) == 20
    assert all(np.isfinite(report.losses))
    assert np.mean(report.losses[-3:]) < report.losses[0] - 0.1
    assert [h[0] for h in report.history] == ["checkpoint"] * 3
    assert sorted(report.after_step_s) == list(range(20))
    assert report.flash_launches == 0 and plans.exists()


def test_train_launcher_requires_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--arch", ARCH, "--reduced", "--steps", "1"])


@pytest.mark.parametrize("fields", [dict(microbatches=2, fsdp=True),
                                    dict(fsdp=True, zero2=True)],
                         ids=["fsdp-micro2", "fsdp-zero2"])
def test_sharded_settings_on_one_device_match_jax(model, fields):
    """``make_train_step`` without a mesh accepts FSDP and ZeRO-2 and
    computes the plain step, as JAX's does with no sharding pytrees (its
    own reference for the sharded step, ``tests/test_distributed.py``):
    three steps against JAX's with the same settings, flash attention on
    the port's side (its plain version on the CPU, no kernel launched)."""
    jcfg, jparams, cfg = model
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    jopt_cfg, opt_cfg = JAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    jstate = jadamw_init(jparams, jopt_cfg)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jopt_cfg, jsteps.TrainSettings(**fields)))
    tstep = tsteps.make_train_step(cfg, opt_cfg,
                                   tsteps.TrainSettings(**fields))
    params = _tparams(jparams, cfg)
    state = from_jax_opt_state(jax_to_numpy(jstate))
    stream = JStream(vocab_size=cfg.vocab_size, seq_len=16, batch_size=4)
    tstream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=16,
                                   batch_size=4)
    launches = tfa.FLASH_ATTENTION.launches
    for step in range(3):
        jparams, jstate, jm = jstep(
            jparams, jstate, {"batch": stream.batch_at(step),
                              "step": jnp.asarray(step, jnp.int32)})
        params, state, m = tstep(params, state,
                                 {"batch": tstream.batch_at(step),
                                  "step": step})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=f"step {step}")
    _assert_trees_close(params, jparams, 1e-5, 1e-5)
    _assert_trees_close(state["m"], jstate["m"], 1e-5, 1e-5)
    _assert_trees_close(state["v"], jstate["v"], 1e-5, 1e-5)
    assert tfa.FLASH_ATTENTION.launches == launches
