"""The port's sharded train step (``make_train_step(..., mesh=)``) on gloo
ranks (``tests/torch_mesh_rank.py``) against the JAX package's
single-device ``make_train_step`` with the same ``TrainSettings`` on the
same converted weights and batches, three steps, as JAX's own
``tests/test_distributed.py`` holds its sharded step (its forced
multi-device run fails on this tree, so the reference is the
single-device step it is held against).

Cases, REDUCED: danube at (2,2) under FSDP + ZeRO-2 with 2 microbatches
(fp32 gradients, and bf16 gradients and moments), at (4,1) under ZeRO-3,
at (2,1) plain data-parallel, at (1,4) (4 query heads over 2 KV heads:
each KV head held by two ranks), at (1,4) with 2 query heads (the
attention whole on every rank, its gradients not summed), at (1,4) with
the tied head (the vocab-cut table's gradient from embedding and head),
at (2,1) with labels masked differently on the two data
ranks, at (2,1) with one row a microbatch (every data rank runs every
row); internvl2 (the vision prefix) at (2,2); olmoe at (1,2); the runner
with sharded checkpoints at (2,1); ZeRO-3 (each layer gathered just before
it runs, its gradient reduce-scattered in the backward) at (2,2): danube
and internvl2 with 2 microbatches and mixtral under its preset (8 microbatches of one
row: every data rank runs every row; at a capacity no token overflows, so
that its routing is JAX's single-device routing). Each world size is
spawned once.

MoE under a data axis routes each data shard at its own capacity (JAX's
data-parallel dispatch), so olmoe at (2,1) is held against one process of
the port routing the same shards (``cfg.shard`` a spec-level (2, 1)
layout), not against JAX's single-device step.

Tolerances: fp32 gradients, loss and grad norm at 1e-5 relative and the
gathered parameters, m and v at rtol = atol = 1e-5 (the train parity of
``torch_parity_helpers.assert_train_matches``); bf16 gradients (summed
over the ranks in bf16), JAX's bounds for its sharded step: loss 1e-3,
parameters 1e-2 (``test_distributed.py``).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.runtime import steps as jsteps

from repro_torch import configs
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.convert import from_jax_params
from repro_torch.core.tree import tree_flatten_with_keys
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps as tsteps

import torch_mesh_rank
from torch_parity_helpers import assert_trees_close, jax_to_numpy

B, S, STEPS = 8, 16, 3
# weights: (arch, config fields)
WEIGHTS = {"danube": ("h2o-danube-1.8b", {}),
           # 2 query heads: at (1,4) the attention stays whole on every rank
           "danube_h2": ("h2o-danube-1.8b",
                         {"num_heads": 2, "num_kv_heads": 2, "head_dim": 64}),
           # the tied head: the vocab-cut table read by embed and head
           "danube_tied": ("h2o-danube-1.8b", {"tie_embeddings": True}),
           "internvl2": ("internvl2-1b", {}),
           "olmoe": ("olmoe-1b-7b", {}),
           "mixtral": ("mixtral-8x7b", {"moe_capacity_factor": float(
               jconfigs.get_reduced("mixtral-8x7b").num_experts)})}


def batches(arch, masked=False, seed=0):
    """``STEPS`` numpy batches of B x S tokens (labels the next token),
    with the vision patches of a vision-prefix arch. ``masked``: labels <
    0 on rows 0-1 and 4-5 (data rank 0's rows of both microbatches at
    (2,1) under 2 microbatches) over most of their length, and on row 7
    over a few positions, so the two ranks' unmasked counts differ."""
    cfg = jconfigs.get_reduced(arch)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, cfg.vocab_size, size=(B, S + 1)).astype(np.int32)
        b = {"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}
        if masked:
            b["labels"][[0, 1, 4, 5], 3:] = -1
            b["labels"][7, :2] = -1
        if cfg.vision_prefix:
            b["vision_embeds"] = rng.standard_normal(
                (B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


# (name, arch, mesh, TrainSettings fields, masked labels, ranks run the
# runner); grad_dtype by name
F32 = "float32"
CASES = {
    4: [("danube-2x2-zero2", "danube", (2, 2),
         dict(microbatches=2, fsdp=True, zero2=True, grad_dtype=F32),
         False, False),
        ("danube-2x2-zero2-bf16", "danube", (2, 2),
         dict(microbatches=2, fsdp=True, zero2=True,
              grad_dtype="bfloat16", opt_dtype="bfloat16"), False, False),
        ("danube-4x1-zero3", "danube", (4, 1),
         dict(microbatches=2, fsdp=True, grad_dtype=F32), False, False),
        ("danube-1x4-shared-kv", "danube", (1, 4),
         dict(grad_dtype=F32), False, False),
        ("danube-1x4-whole-attention", "danube_h2", (1, 4),
         dict(microbatches=2, grad_dtype=F32), False, False),
        ("danube-1x4-tied-head", "danube_tied", (1, 4),
         dict(grad_dtype=F32), False, False),
        ("internvl2-2x2", "internvl2", (2, 2),
         dict(microbatches=2, fsdp=True, zero2=True, grad_dtype=F32),
         False, False),
        ("danube-2x2-zero3", "danube", (2, 2),
         dict(microbatches=2, fsdp=True, grad_dtype=F32), False, False),
        ("internvl2-2x2-zero3", "internvl2", (2, 2),
         dict(microbatches=2, fsdp=True, grad_dtype=F32), False, False),
        # mixtral's preset (launch.presets): ZeRO-3, 8 microbatches
        ("mixtral-2x2-zero3", "mixtral", (2, 2),
         dict(microbatches=8, fsdp=True, grad_dtype=F32), False, False)],
    2: [("danube-2x1-dp", "danube", (2, 1), dict(grad_dtype=F32), False,
         False),
        ("danube-2x1-masked", "danube", (2, 1),
         dict(microbatches=2, fsdp=True, grad_dtype=F32), True, False),
        ("danube-2x1-replicated-rows", "danube", (2, 1),
         dict(microbatches=8, fsdp=True, zero2=True, grad_dtype=F32),
         False, False),
        ("olmoe-1x2", "olmoe", (1, 2), dict(grad_dtype=F32), False, False),
        ("olmoe-2x1-routed-per-shard", "olmoe", (2, 1),
         dict(grad_dtype=F32), False, False),
        ("danube-2x1-runner", "danube", (2, 1),
         dict(fsdp=True, grad_dtype=F32), False, True)],
}
JAX_HELD = [(w, c) for w, cases in CASES.items() for c in cases
            if c[0] != "olmoe-2x1-routed-per-shard"]
# the autograd-aware collectives' case: (1, 2), x (3, 8), w1 (8, 6), w2
# (6, 8), wv (8, 10)
OPS_SHAPES = {"x": (3, 8), "w1": (8, 6), "w2": (6, 8), "wv": (8, 10),
              "cy": (3, 8), "cz": (3, 10)}

_WEIGHTS = {}


def jax_weights(key):
    """JAX's ``init_params(key 0)`` of the REDUCED arch and its numpy
    tree."""
    if key not in _WEIGHTS:
        arch, fields = WEIGHTS[key]
        cfg = dataclasses.replace(jconfigs.get_reduced(arch), **fields)
        params = JT.init_params(jax.random.PRNGKey(0), cfg)
        _WEIGHTS[key] = (cfg, params, jax_to_numpy(params))
    return _WEIGHTS[key]


_REF = {}


def jax_reference(key, settings, masked):
    """JAX's single-device ``make_train_step`` with the same settings (no
    sharding pytrees: the plain step), three steps: {"metrics", "params",
    "m", "v"} as numpy. Without sharding pytrees that step reads neither
    ``fsdp`` nor ``zero2``, so one reference serves every such case."""
    fields = {k: v for k, v in settings.items() if k not in ("fsdp", "zero2")}
    ref_key = (key, tuple(sorted(fields.items())), masked)
    if ref_key not in _REF:
        cfg, params, _ = jax_weights(key)
        for name, default in (("grad_dtype", "bfloat16"),
                              ("opt_dtype", "float32")):
            fields[name] = getattr(jnp, fields.get(name, default))
        opt_cfg = JAdamWConfig(lr=1e-3, state_dtype=fields["opt_dtype"])
        state = jadamw_init(params, opt_cfg)
        step = jax.jit(jsteps.make_train_step(
            cfg, opt_cfg, jsteps.TrainSettings(**fields)))
        metrics = []
        for i, b in enumerate(batches(WEIGHTS[key][0], masked)):
            params, state, m = step(
                params, state, {"batch": {k: jnp.asarray(v)
                                          for k, v in b.items()},
                                "step": jnp.asarray(i, jnp.int32)})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        _REF[ref_key] = {"metrics": metrics,
                         "params": jax_to_numpy(params),
                         "m": jax_to_numpy(state["m"]),
                         "v": jax_to_numpy(state["v"])}
    return _REF[ref_key]


def spec_mesh(dm):
    """A spec-level (data, model) stand-in mesh at rank (0, 0)."""
    class FakeMesh:
        shape = {"data": dm[0], "model": dm[1]}
        axis_names = ("data", "model")
        coords = {"data": 0, "model": 0}
    return FakeMesh()


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return tree.float().numpy()


def ops_inputs():
    rng = np.random.default_rng(3)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k, shape in OPS_SHAPES.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's per-rank results, one spawn per world size (each with
    a timeout, so that a hung rank fails its tests, not the suite)."""
    out = {}
    for world, cases in CASES.items():
        tmp = tmp_path_factory.mktemp(f"train{world}")
        job = {"weights": {}, "cases": []}
        for name, key, mesh, fields, masked, runner in cases:
            job["weights"][key] = jax_weights(key)[2]
            arch, cfg_fields = WEIGHTS[key]
            train = dict(fields, batches=batches(arch, masked))
            if runner:
                train["ckpt_dir"] = str(tmp / "ck")
            job["cases"].append(dict(name=name, arch=arch, cfg=cfg_fields,
                                     weights=key, mesh=mesh, train=train))
        if world == 2:
            job["cases"].append(dict(name="ops", mesh=(1, 2),
                                     ops=ops_inputs()))
        results = torch_mesh_rank.spawn(world, job, tmp, timeout=240)
        for case in job["cases"]:
            out[case["name"]] = [r[case["name"]] for r in results]
        out["ckpt_dir"] = str(tmp / "ck") if world == 2 else \
            out.get("ckpt_dir")
    return out


def assert_held(got, want, grad_dtype):
    """fp32 gradients at 1e-5 (every family's train parity); bf16 at JAX's
    bounds for its sharded step (loss 1e-3, parameters 1e-2)."""
    if grad_dtype == F32:
        for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       err_msg=f"step {step}")
        for key in ("params", "m", "v"):
            g = dict(tree_flatten_with_keys(got[key]))
            w = dict(tree_flatten_with_keys(want[key]))
            assert g.keys() == w.keys()
            for k, a in w.items():
                np.testing.assert_allclose(g[k], np.asarray(a, np.float32),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{key} {'/'.join(k)}")
        return
    for (gl, _), (wl, _) in zip(got["metrics"], want["metrics"]):
        assert abs(gl - wl) < 1e-3
    g = dict(tree_flatten_with_keys(got["params"]))
    for key, w in tree_flatten_with_keys(want["params"]):
        assert np.max(np.abs(g[key] - np.asarray(w, np.float32))) < 1e-2, \
            key


@pytest.mark.parametrize("world,case", JAX_HELD,
                         ids=[c[0] for _, c in JAX_HELD])
def test_sharded_train_step_matches_jax_single_device(ranks, world, case):
    """Three steps on every rank against JAX's single-device step with
    the same settings: loss and grad norm per step equal on every rank,
    the whole parameters, m and v gathered from the ranks to rank 0
    within the tolerances; cutting the weights and gathering them back
    gives them bit for bit."""
    name, key, mesh, fields, masked, _ = case
    got = ranks[name]
    assert len(got) == world == mesh[0] * mesh[1]
    assert len({r["coords"] for r in got}) == world
    assert got[0]["coords"] == (0, 0)
    assert all(r["params"] is None for r in got[1:])
    for r in got:
        assert r["identity"] and r["count"] == STEPS
        assert r["metrics"] == got[0]["metrics"], name
    want = jax_reference(key, fields, masked)
    assert_held(got[0], want, fields.get("grad_dtype"))


def test_moe_under_a_data_axis_matches_the_port_routing_per_shard(ranks):
    """olmoe at (2,1): each data rank routes its rows at its own capacity.
    One process of the port routing the same two shards of every
    microbatch (``cfg.shard`` a spec-level (2, 1) layout: its MoE layers
    cut the tokens as the data ranks do) gives the same three steps."""
    cfg = configs.get_reduced("olmoe-1b-7b")
    lay = shd.Layout(cfg, spec_mesh((2, 1)))
    assert lay.route_shards(B * S, False) == 2
    ref_cfg = dataclasses.replace(cfg, shard=lay)
    params = from_jax_params(jax_weights("olmoe")[2], dtype=cfg.dtype)
    opt_cfg = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt_cfg)
    step = tsteps.make_train_step(ref_cfg, opt_cfg, tsteps.TrainSettings(
        grad_dtype=torch.float32))
    metrics = []
    for i, b in enumerate(batches("olmoe-1b-7b")):
        params, state, m = step(params, state, {
            "batch": {k: torch.from_numpy(v) for k, v in b.items()},
            "step": i})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    got = ranks["olmoe-2x1-routed-per-shard"][0]
    want = {"metrics": metrics,
            **{k: to_numpy(t) for k, t in
               (("params", params), ("m", state["m"]), ("v", state["v"]))}}
    assert_held(got, want, F32)
    # routing per shard is not JAX's single-device routing
    jref = jax_reference("olmoe", dict(grad_dtype=F32), False)
    assert got["metrics"][0] != pytest.approx(jref["metrics"][0], rel=1e-6)


def test_rank_shares_and_heads(ranks):
    """What a rank holds: at (1,4) one query and one KV head a rank, each
    KV head held by two ranks (with 2 query heads, both heads whole); at
    (4,1) under FSDP each rank a quarter of
    every matrix and the embedding (norms whole); at (2,2) 2/1 heads and a
    quarter of each cut matrix."""
    cfg = configs.get_reduced("h2o-danube-1.8b")
    total = cfg.param_count()
    for r in ranks["danube-1x4-shared-kv"]:
        assert r["heads"] == (1, 1)
    for r in ranks["danube-2x2-zero2"]:
        assert r["heads"] == (2, 1)
    for r in ranks["danube-1x4-whole-attention"]:
        assert r["heads"] == (2, 2)
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    for r in ranks["danube-4x1-zero3"]:
        assert r["share_elems"] == total // 4 + norms
    for r in ranks["danube-2x1-dp"]:
        assert r["share_elems"] == total + norms


def test_autograd_collectives_match_the_unsharded_computation(ranks):
    """``copy_to_model`` / ``reduce_over_model`` around a column- then
    row-cut MLP and ``gather_over_model`` after a vocab-cut head, on two
    ranks: outputs and every gradient equal the unsharded computation's
    (x's gradient summed once over "model", not tp times)."""
    o = {k: torch.from_numpy(v) for k, v in ops_inputs().items()}
    x, w1, w2, wv = (o[k].clone().requires_grad_(True)
                     for k in ("x", "w1", "w2", "wv"))
    y = torch.relu(x @ w1) @ w2
    z = x @ wv
    ((y * o["cy"]).sum() + (z * o["cz"]).sum()).backward()
    got = sorted(ranks["ops"], key=lambda r: r["rank"])
    for r in got:
        np.testing.assert_allclose(r["y"], y.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r["z"], z.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(r["dx"], x.grad.numpy(), rtol=1e-6,
                                   atol=1e-6)
    for name, w, dim in (("dw1", w1, 1), ("dw2", w2, 0), ("dwv", wv, 1)):
        whole = np.concatenate([r[name] for r in got], axis=dim)
        np.testing.assert_allclose(whole, w.grad.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_sharded_checkpoint_is_the_whole_tree_and_resumes(ranks):
    """``run_training`` on two ranks under FSDP: a checkpoint after each
    step, written by rank 0 as the whole tree; a second runner from the
    initial weights resumes from step 1 and runs step 2. The last
    checkpoint, restored by one process into the whole tree, is the
    ranks' gathered state, and the three steps are JAX's."""
    got = ranks["danube-2x1-runner"]
    for r in got:
        assert [h[0] for h in r["histories"][0]] == ["checkpoint"] * 2
        assert r["histories"][1] == [("resume", 2), ("checkpoint", 2)]
    ckpt = ranks["ckpt_dir"]
    assert latest_step(ckpt) == 2
    assert sorted(os.listdir(ckpt)) == ["step_0", "step_1", "step_2"]
    cfg = configs.get_reduced("h2o-danube-1.8b")
    params = from_jax_params(jax_weights("danube")[2], dtype=cfg.dtype)
    like = {"params": params, "opt": adamw_init(params, AdamWConfig())}
    tree, step, _ = restore_checkpoint(ckpt, like)
    assert step == 2 and int(tree["opt"]["count"]) == 3
    for key, sub in (("params", tree["params"]), ("m", tree["opt"]["m"]),
                     ("v", tree["opt"]["v"])):
        assert_trees_close(sub, got[0][key], 0, 0)
    want = jax_reference("danube", dict(fsdp=True, grad_dtype=F32), False)
    assert_held(got[0], want, F32)
