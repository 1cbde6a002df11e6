"""Elastic re-meshing of sharded training on gloo ranks
(``tests/torch_mesh_rank.py``) against the JAX package's ``run_training``
on one device.

danube (REDUCED, fp32 gradients) trains at (2,2) under FSDP + ZeRO-2 with 2
microbatches, a checkpoint after every step, 2 rows a data rank. Every try
of step 2 fails (an injected hard failure): ``run_training(remesh_fn=)``
drops the last data row (``launch.mesh.degraded_mesh``: ranks 2 and 3
leave, ranks 0 and 1 join a fresh group of two on a new store), restores
the step-1 checkpoint onto the new step's shares and trains steps 2 and 3
at (1,2). The per-rank batch stays 2 rows, so the global batch goes from 4
to 2, as JAX's elastic test goes from 256 to 240. JAX's single-device
``run_training`` runs the same batch sequence under the same failure
script (its ``remesh_fn`` returns the same step and switches the batches to
the survivors' rows): the survivors' history equals JAX's, and their
parameters, m and v after the last step are within 1e-5 of JAX's.

A straggler: one rank's clock finds step 1 past ``step_timeout_s`` and no
other rank's does; every rank records the failure and retries the step
(the ranks agree on the flag), and the run ends as one without it.
One spawn of 4 ranks.
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
from repro.runtime.resilient import RunnerConfig as JRunnerConfig
from repro.runtime.resilient import run_training as jrun_training

from repro_torch.core.tree import tree_flatten_with_keys

import torch_mesh_rank
from torch_parity_helpers import jax_to_numpy

ARCH = "h2o-danube-1.8b"
S, ROWS, STEPS, FAIL_AT = 16, 2, 4, 2
SETTINGS = dict(microbatches=2, fsdp=True, zero2=True, grad_dtype="float32")


def pool(seed=0):
    """``STEPS`` batches of 2 x ROWS rows (the (2,2) mesh's global batch;
    the survivors take the first ROWS)."""
    cfg = jconfigs.get_reduced(ARCH)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, cfg.vocab_size,
                         size=(2 * ROWS, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()})
    return out


_JAX = {}


def jax_weights():
    if "w" not in _JAX:
        cfg = jconfigs.get_reduced(ARCH)
        params = JT.init_params(jax.random.PRNGKey(0), cfg)
        _JAX["w"] = (cfg, params, jax_to_numpy(params))
    return _JAX["w"]


def jax_elastic(tmp):
    """JAX's single-device ``run_training`` under the same failure script
    and batch sequence: (history, metrics, params, m, v)."""
    cfg, params, _ = jax_weights()
    opt_cfg = JAdamWConfig(lr=1e-3, state_dtype=jnp.float32)
    step = jax.jit(jsteps.make_train_step(cfg, opt_cfg, jsteps.TrainSettings(
        **dict(SETTINGS, grad_dtype=jnp.float32))))
    data, now = pool(), {"dp": 2}

    def batches(i):
        return {"batch": {k: jnp.asarray(v[:ROWS * now["dp"]])
                          for k, v in data[i].items()},
                "step": jnp.asarray(i, jnp.int32)}

    def remesh_fn():
        now["dp"] = 1
        return step

    metrics = []
    params, state, hist = jrun_training(
        cfg=JRunnerConfig(ckpt_dir=str(tmp), ckpt_every=1),
        train_step=step, params=params, opt_state=jadamw_init(params, opt_cfg),
        batches=batches, num_steps=STEPS,
        inject_failure=lambda s, r: s == FAIL_AT and now["dp"] == 2,
        remesh_fn=remesh_fn,
        on_metrics=lambda i, m: metrics.append(
            (i, float(m["loss"]), float(m["grad_norm"]))))
    return hist, metrics, jax_to_numpy(params), jax_to_numpy(state["m"]), \
        jax_to_numpy(state["v"])


def case(name, ckpt, **elastic):
    return dict(name=name, arch=ARCH, weights="danube", mesh=(2, 2),
                elastic=dict(SETTINGS, batches=pool(), rows=ROWS,
                             ckpt_dir=str(ckpt), **elastic))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    job = {"weights": {"danube": jax_weights()[2]},
           "cases": [case("straggler", tmp / "ck_slow", slow={1: 1},
                          step_timeout_s=600.0),
                     case("elastic", tmp / "ck", fail_at=FAIL_AT)]}
    results = torch_mesh_rank.spawn(4, job, tmp)
    return {c["name"]: [r[c["name"]] for r in results] for c in job["cases"]}


def test_straggler_timeout_is_a_failure_on_every_rank(ranks):
    """Rank 1 alone reads step 1 past the timeout: every rank records the
    same failure, retries, and ends with the same history and metrics."""
    got = ranks["straggler"]
    want = [("checkpoint", 0), ("failure", 1, "straggler timeout at step 1"),
            ("checkpoint", 1), ("checkpoint", 2), ("checkpoint", 3)]
    for r in got:
        assert r["history"] == want, r["rank"]
        assert r["metrics"] == got[0]["metrics"]
    assert [m[0] for m in got[0]["metrics"]] == [0, 1, 2, 3]


def test_elastic_remesh_matches_jax_run_training(ranks, tmp_path):
    """The survivors of (2,2) → (1,2): JAX's history, metrics within 1e-5,
    the whole parameters, m and v gathered on rank 0 within 1e-5 of JAX's
    single-device run; ranks 2 and 3 left after step 1."""
    got = ranks["elastic"]
    assert [r["left"] for r in got] == [False, False, True, True]
    for r in got[2:]:
        assert [m[0] for m in r["metrics"]] == [0, 1]
    hist, metrics, params, m, v = jax_elastic(tmp_path)
    assert hist == [("checkpoint", 0), ("checkpoint", 1)] + [
        ("failure", FAIL_AT, f"injected failure at step {FAIL_AT}")] * 4 + [
        ("remesh", FAIL_AT), ("restart", FAIL_AT),
        ("checkpoint", 2), ("checkpoint", 3)]
    for r in got[:2]:
        assert r["history"] == hist, r["rank"]
        assert r["mesh"] == (1, 2)
        assert [x[0] for x in r["metrics"]] == [x[0] for x in metrics]
        np.testing.assert_allclose([x[1:] for x in r["metrics"]],
                                   [x[1:] for x in metrics], rtol=1e-5)
    assert got[1]["params"] is None
    for key, want in (("params", params), ("m", m), ("v", v)):
        g = dict(tree_flatten_with_keys(got[0][key]))
        w = dict(tree_flatten_with_keys(want))
        assert g.keys() == w.keys()
        for k, a in w.items():
            np.testing.assert_allclose(g[k], np.asarray(a, np.float32),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{key} {'/'.join(k)}")
