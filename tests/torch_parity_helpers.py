"""Shared by the port's parity tests: the JAX side's parameter trees as the
numpy trees ``repro_torch.convert.from_jax_params`` takes, and the
train-step parity of every family (three steps of each package's
``make_train_step`` on one numpy draw, remat, the train launcher).

Importing it gives the test process one torch thread. The suite runs
under pytest-xdist, several workers on a few cores, and each worker's
torch would otherwise start an intra-op pool as wide as the machine: the
pools' threads starve one another (the four heaviest port files took
2.1x as long on 4 workers so). Each mesh rank runs on one thread too.

``StandIn`` is the CUDA-graph capture of the port's compiled steps
(``repro_torch.runtime.steps.GRAPHS``) on the CPU, for the compiled
serving and train steps' tests."""
import numpy as np
import pytest
import torch

from repro.core import quant as jquant

torch.set_num_threads(1)


class StandIn:
    """``steps.GRAPHS`` on the CPU: its capture runs the step once on the
    static inputs to make the static outputs and puts the static inputs
    back (a capture launches nothing); its replay re-runs the step on the
    static inputs, in the capture's grad mode, and copies what it returns
    into those static outputs, so a replay overwrites the last one's
    outputs and the donated state is the caller's own tensors, as under a
    CUDA graph. It cannot see a host value that a real capture would bake
    in (the replay re-runs the Python step). ``fail`` makes every capture
    raise as a capture that meets a host sync does. ``nodes``: the
    function names of the graph's kernel nodes a capture reports (None:
    the kernel nodes its counted launches would make)."""

    device_type = "cpu"

    def __init__(self, fail=False, nodes=None):
        self.fail, self.captures, self.replays = fail, 0, 0
        self.nodes = nodes

    def new_pool(self):
        return None

    def warm_up(self, run):
        return run()

    def capture(self, run, statics, pool):
        from repro_torch.kernels import build
        from repro_torch.runtime import steps as rsteps
        if self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        saved = [s.clone() if isinstance(s, torch.Tensor) else None
                 for s in statics]
        before = build.launch_counts()
        grad = torch.is_grad_enabled()
        out = run()
        nodes = self.nodes
        if nodes is None:
            nodes = [f"void {' '.join(k.device)}<8>(Args)"
                     for k, n in build.launch_counts().items()
                     if isinstance(k, build.CudaKernel) and k.device
                     for _ in range(n - before.get(k, 0))]
        for s, c in zip(statics, saved):
            if c is not None:
                s.copy_(c)
        self.captures += 1

        def replay():
            # a graph's replay enters no wrapper: the counts it launched
            # come from the capture (CompiledStep adds them)
            before = build.launch_counts()
            with torch.set_grad_enabled(grad):
                new = run()
            for a, b in zip(rsteps.flat_leaves(out), rsteps.flat_leaves(new)):
                if isinstance(a, torch.Tensor) and a is not b:
                    a.copy_(b)
            build.add_launches({k: before[k] - n for k, n in
                                build.launch_counts().items() if k in before})
            self.replays += 1
        return out, replay, 0, nodes


def jax_to_numpy(tree):
    """Arrays → numpy; QuantizedTensor leaves → {packed, scales, zeros,
    group_size, format}, the format as its descriptor dict."""
    if isinstance(tree, jquant.QuantizedTensor):
        return {"packed": np.asarray(tree.packed),
                "scales": np.asarray(tree.scales),
                "zeros": None if tree.zeros is None
                else np.asarray(tree.zeros),
                "group_size": tree.group_size,
                "format": tree.format.to_dict()}
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


# ---------------------------------------------------------------------------
# train-step parity: the port's make_train_step against JAX's
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 16, 3


def train_batches(cfg, seed=0, steps=TRAIN_STEPS):
    """``steps`` numpy batches of ``TRAIN_B`` x ``TRAIN_S`` tokens
    (labels the next token), with the arch's vision patches or audio
    frames, one draw for both packages."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        t = rng.integers(0, cfg.vocab_size, size=(TRAIN_B, TRAIN_S + 1)) \
            .astype(np.int32)
        b = {"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}
        if cfg.vision_prefix:
            b["vision_embeds"] = rng.standard_normal(
                (TRAIN_B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            b["audio_embeds"] = rng.standard_normal(
                (TRAIN_B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def jax_train(arch, micro, steps=TRAIN_STEPS):
    """JAX's ``make_train_step`` (jitted, REDUCED defaults: chunked
    attention, no remat; fp32 gradients, see ``assert_train_matches``)
    over ``steps`` of ``train_batches`` from ``init_params(key 0)``:
    {"params0", "metrics": [(loss, grad norm)], "params", "m", "v"},
    trees as numpy."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import transformer as JT
    from repro.optim import AdamWConfig, adamw_init
    from repro.runtime import steps as jsteps
    cfg = jconfigs.get_reduced(arch)
    params = JT.init_params(jax.random.PRNGKey(0), cfg)
    opt_cfg = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt_cfg)
    settings = jsteps.TrainSettings(microbatches=micro,
                                    grad_dtype=jnp.float32)
    step_fn = jax.jit(jsteps.make_train_step(cfg, opt_cfg, settings))
    out = {"params0": jax_to_numpy(params), "metrics": []}
    for step, b in enumerate(train_batches(cfg, steps=steps)):
        params, state, m = step_fn(
            params, state, {"batch": {k: jnp.asarray(v) for k, v in b.items()},
                            "step": jnp.asarray(step, jnp.int32)})
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    assert int(state["count"]) == steps
    out.update(params=jax_to_numpy(params), m=jax_to_numpy(state["m"]),
               v=jax_to_numpy(state["v"]))
    return out


@pytest.fixture(scope="module")
def jax_trained():
    """``jax_train`` per (arch, microbatches), run once for the module
    that uses it (each (arch, micro) compiles once)."""
    runs = {}

    def get(arch, micro):
        if (arch, micro) not in runs:
            runs[arch, micro] = jax_train(arch, micro)
        return runs[arch, micro]
    return get


def port_train(arch, micro, params0, **replace):
    """The port's ``make_train_step`` (fp32 gradients) over the same
    batches from the converted ``params0`` (REDUCED, with ``replace``
    applied to the config), in ``jax_train``'s form."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.convert import from_jax_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import steps as tsteps
    cfg = dataclasses.replace(configs.get_reduced(arch), **replace)
    params = from_jax_params(params0, dtype=cfg.dtype)
    opt_cfg = AdamWConfig(lr=1e-3)
    state = adamw_init(params, opt_cfg)
    step_fn = tsteps.make_train_step(cfg, opt_cfg, tsteps.TrainSettings(
        microbatches=micro, grad_dtype=torch.float32))
    out = {"metrics": []}
    for step, b in enumerate(train_batches(cfg)):
        params, state, m = step_fn(
            params, state, {"batch": {k: torch.from_numpy(v)
                                      for k, v in b.items()}, "step": step})
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
    assert int(state["count"]) == TRAIN_STEPS
    out.update(params=params, m=state["m"], v=state["v"])
    return out


def assert_trees_close(got, want, rtol, atol):
    """Port tree ``got`` against numpy tree ``want``, key for key."""
    from repro_torch.core.tree import tree_flatten_with_keys
    want = dict(tree_flatten_with_keys(want))
    got = dict(tree_flatten_with_keys(got))
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].float().numpy(),
                                   np.asarray(w, np.float32), rtol=rtol,
                                   atol=atol, err_msg="/".join(key))


def assert_train_matches(got, want):
    """Loss and grad norm at 1e-5 relative every step; parameters, m and v
    at rtol = atol = 1e-5. Both packages keep the gradients in fp32
    (``TrainSettings.grad_dtype``): their fp32 gradients differ by ~1e-6
    relative (summation order), and the default bf16 cast rounds a few
    dozen elements a leaf to different bf16 neighbours, which moves such
    an element's m by 0.1 x 2^-8 of its gradient, above 1e-5 from a
    gradient of ~4e-3 up (granite's m: 1.49x the bound)."""
    for step, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"step {step}")
    for key in ("params", "m", "v"):
        assert_trees_close(got[key], want[key], 1e-5, 1e-5)


def check_remat(arch, monkeypatch):
    """The port's loss and gradients with ``remat=True`` (every layer, and
    every encoder layer, under ``torch.utils.checkpoint``) against
    ``remat=False`` on REDUCED ``arch``, attention through the flash
    Function: bit for bit on the CPU, with the recomputation seen to run
    (each layer's body called twice)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.core.tree import tree_flatten_with_keys
    from repro_torch.models import transformer as T
    from repro_torch.runtime import steps as tsteps
    cfg = dataclasses.replace(configs.get_reduced(arch), attn_impl="flash")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    batch = {k: torch.from_numpy(v) for k, v in train_batches(cfg)[0].items()}
    calls = []
    for name in ("_layer_seq", "_enc_layer"):
        body = getattr(T, name)
        monkeypatch.setattr(T, name, lambda *a, _b=body, _n=name, **k: (
            calls.append(_n), _b(*a, **k))[1])
    runs = []
    for remat in (False, True):
        calls.clear()
        loss, grads = tsteps.value_and_grad(
            params, dataclasses.replace(cfg, remat=remat), batch)
        runs.append((loss, dict(tree_flatten_with_keys(grads)), len(calls)))
    (l0, g0, n0), (l1, g1, n1) = runs
    assert n0 == cfg.num_layers + cfg.encoder_layers and n1 == 2 * n0
    assert torch.equal(l0, l1) and g0.keys() == g1.keys()
    for key in g0:
        assert torch.equal(g0[key], g1[key]), "/".join(key)


def train_launcher_round_trip(arch, ckpt_dir, *extra):
    """The port's train launcher on the CPU at ``--reduced --steps 3``
    (batch 4 x 16) with checkpoints at steps 0 and 2, then again at
    ``--steps 4`` from the same directory: the second run resumes from
    the step-2 checkpoint and trains step 3 alone. Returns the first
    run's report."""
    from repro_torch.launch import train as ttrain
    argv = ["--arch", arch, "--reduced", "--batch", "4", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(ckpt_dir), "--ckpt-every",
            "2", *extra]
    rep = ttrain.main(argv + ["--steps", "3"])
    assert len(rep.losses) == len(rep.grad_norms) == 3
    assert np.isfinite(rep.losses).all() and np.isfinite(rep.grad_norms).all()
    assert rep.history == [("checkpoint", 0), ("checkpoint", 2)]
    assert rep.flash_launches == 0
    resumed = ttrain.main(argv + ["--steps", "4"])
    assert resumed.history == [("resume", 3), ("checkpoint", 3)]
    assert len(resumed.losses) == 1 and np.isfinite(resumed.losses).all()
    return rep
