"""The compiled train step (``runtime/steps.py``: ``jit_train_step``, the
counterpart of JAX's ``jax.jit(make_train_step)`` and ``jit_train_step``
with ``donate_argnums=(0, 1)``) on the CPU, the training runner under
donation (``runtime/resilient.py``) and the train launcher's compiled
default.

A CUDA graph captures work on the card only, so here the capture is
``torch_parity_helpers.StandIn`` patched in for ``steps.GRAPHS``. Its
replay re-runs the Python step, so it cannot see a host value that a
capture would bake into a graph; :class:`HostReads` can: it traces the
train step on the meta device and fails on any read of a device value on
the host, any copy to the CPU and any op on a CPU tensor.

Weights are the JAX package's, converted leaf for leaf. The compiled step
must equal the port's eager step bit for bit (the same ops on the same
values) and JAX's jitted step within the 1e-5 of ``tests/test_torch_train*``
(both in fp32 gradients, ``torch_parity_helpers.assert_train_matches``).
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core.tree import tree_flatten_with_keys, tree_leaves
from repro_torch.data import SyntheticTokenStream
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import resilient
from repro_torch.runtime import steps as rsteps
from repro_torch.runtime.resilient import RunnerConfig, run_training

from torch_parity_helpers import (StandIn, assert_train_matches, jax_train,
                                  train_batches)

OPT = AdamWConfig(lr=1e-3)
FP32_GRADS = rsteps.TrainSettings(grad_dtype=torch.float32)
STEPS = 4


@pytest.fixture
def graphs(monkeypatch):
    g = StandIn()
    monkeypatch.setattr(rsteps, "GRAPHS", g)
    return g


def _cfg(arch, **replace):
    """REDUCED ``arch`` as the launcher trains it: the flash Function (its
    plain version on the CPU) under remat."""
    return dataclasses.replace(configs.get_reduced(arch), attn_impl="flash",
                               remat=True, **replace)


def _step(i, device="cpu"):
    return torch.full((), i, dtype=torch.int32, device=device)


def _ptrs(*trees):
    return [t.data_ptr() for tree in trees for t in tree_leaves(tree)]


def _train(step_fn, params, state, batches, step0=0):
    """``step_fn`` over ``batches`` from step ``step0``; each step's loss
    and grad norm read before the next step (a replay overwrites them)."""
    metrics = []
    for i, b in enumerate(batches):
        params, state, m = step_fn(params, state,
                                   {"batch": b, "step": _step(step0 + i)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return params, state, metrics


def assert_bit_equal(got, want):
    got, want = dict(tree_flatten_with_keys(got)), \
        dict(tree_flatten_with_keys(want))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].dtype == w.dtype and torch.equal(got[key], w), \
            "/".join(key)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b",
                                  "rwkv6-7b", "whisper-small"])
def test_compiled_train_step_is_eager_and_jax(graphs, arch):
    """4 compiled steps from step 0 (one capture, three replays): the
    eager port's losses, grad norms, parameters and AdamW state bit for
    bit, and JAX's jitted step's within 1e-5; the donated leaves keep
    their ``data_ptr`` and the call returns the caller's trees."""
    want = jax_train(arch, 1, steps=STEPS)
    cfg = _cfg(arch)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in train_batches(cfg, steps=STEPS)]
    fresh = lambda: from_jax_params(want["params0"], dtype=cfg.dtype)
    eager = _train(rsteps.make_train_step(cfg, OPT, FP32_GRADS), fresh(),
                   adamw_init(fresh(), OPT), batches)
    params = fresh()
    state = adamw_init(params, OPT)
    ptrs = _ptrs(params, state)
    step_fn = rsteps.jit_train_step(cfg, OPT, FP32_GRADS)
    got_p, got_s, metrics = _train(step_fn, params, state, batches)
    assert got_p is params and got_s is state and _ptrs(params, state) == ptrs
    assert (graphs.captures, graphs.replays, len(step_fn.graphs)) == \
        (1, STEPS - 1, 1)
    assert metrics == eager[2]
    assert_bit_equal(params, eager[0])
    assert_bit_equal(state, eager[1])
    assert int(state["count"]) == STEPS
    assert_train_matches({"metrics": metrics, "params": params,
                          "m": state["m"], "v": state["v"]}, want)


@pytest.mark.parametrize("micro", [1, 2])
def test_one_graph_serves_every_step(graphs, micro):
    """Five steps, the step fed as a 0-d int32 tensor: one graph (two
    microbatches inside it too), four replays, the eager steps' numbers
    bit for bit; an int step would be part of the signature (a graph a
    step), as a Python int is to ``jax.jit``."""
    cfg = _cfg("h2o-danube-1.8b")
    settings = rsteps.TrainSettings(microbatches=micro)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=8,
                                  batch_size=4)
    batches = [stream.batch_at(i) for i in range(5)]

    def fresh():
        gen = torch.Generator()
        gen.manual_seed(0)
        params = T.init_params(gen, cfg)
        return params, adamw_init(params, OPT)
    eager = _train(rsteps.make_train_step(cfg, OPT, settings), *fresh(),
                   batches)
    step_fn = rsteps.jit_train_step(cfg, OPT, settings)
    params, state = fresh()
    ptrs = _ptrs(params, state)
    got = _train(step_fn, params, state, batches)
    assert len(step_fn.graphs) == step_fn.pool.graphs == 1
    assert (graphs.captures, graphs.replays) == (1, 4)
    assert _ptrs(params, state) == ptrs and got[2] == eager[2]
    assert_bit_equal(params, eager[0])
    assert_bit_equal(state, eager[1])
    # an int step: a new signature every step
    step_fn = rsteps.jit_train_step(cfg, OPT, settings)
    params, state = fresh()
    for i in range(2):
        params, state, _ = step_fn(params, state,
                                   {"batch": batches[i], "step": i})
    assert len(step_fn.graphs) == 2


def test_jit_train_step_refuses_a_mesh():
    """On a mesh the train step stays eager, a named departure."""
    cfg = _cfg("h2o-danube-1.8b")
    with pytest.raises(ValueError, match="jit_train_step: on a mesh the "
                       "train step stays eager: a rank's collectives go "
                       "through gloo"):
        rsteps.jit_train_step(cfg, OPT, mesh=object())
    # without a stand-in a compiled step given CPU tensors refuses them
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="train_step: CUDA graphs capture "
                       "work on the card only"):
        rsteps.jit_train_step(cfg, OPT)(params, adamw_init(params, OPT), {
            "batch": SyntheticTokenStream(vocab_size=cfg.vocab_size,
                                          seq_len=8, batch_size=2)
            .batch_at(0), "step": _step(0)})


def test_a_failing_capture_raises_and_nothing_falls_back(monkeypatch,
                                                         tmp_path):
    """A capture that fails raises ``CaptureFailed``, naming the step and
    its signature: from the step, from the runner (which retries any
    other failure) and from the launcher; no step falls back to eager."""
    monkeypatch.setattr(rsteps, "GRAPHS", StandIn(fail=True))
    cfg = _cfg("h2o-danube-1.8b")
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    step_fn = rsteps.jit_train_step(cfg, OPT)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=8,
                                  batch_size=2)
    inputs = {"batch": stream.batch_at(0), "step": _step(0)}
    with pytest.raises(rsteps.CaptureFailed, match=r"capturing train_step "
                       r"failed at signature .*\(2, 8\) int32.*: operation "
                       "not permitted"):
        step_fn(params, adamw_init(params, OPT), inputs)
    assert not step_fn.graphs
    calls = []
    with pytest.raises(rsteps.CaptureFailed):
        run_training(cfg=RunnerConfig(ckpt_dir=str(tmp_path / "ck")),
                     train_step=step_fn, params=params,
                     opt_state=adamw_init(params, OPT),
                     batches=lambda s: inputs, num_steps=3,
                     on_metrics=lambda s, m: calls.append(s))
    assert not calls
    with pytest.raises(rsteps.CaptureFailed, match="capturing train_step"):
        ttrain.main(["--arch", "h2o-danube-1.8b", "--reduced", "--steps",
                     "2", "--batch", "2", "--seq", "8", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path / "ck2")])


# ---------------------------------------------------------------------------
# the host-free step: nothing a capture would bake in
# ---------------------------------------------------------------------------

class HostRead(AssertionError):
    pass


class HostReads(TorchDispatchMode):
    """Fails on a read of a device value on the host
    (``aten._local_scalar_dense``: ``.item()``, ``float()``, a tensor in
    an ``if``), on any op that takes a CPU tensor (a host value read as a
    scalar) and on any op that makes one (a copy to the host). Run on the
    meta device, where the step's tensors live."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten._local_scalar_dense.default:
            raise HostRead(f"{func} reads a device value on the host")
        if any(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in pytree.tree_leaves((args, kwargs))):
            raise HostRead(f"{func} takes a CPU tensor")
        if torch.device(kwargs.get("device") or "meta").type == "cpu":
            raise HostRead(f"{func} makes a CPU tensor (a copy to the host)")
        out = func(*args, **kwargs)
        if any(isinstance(o, torch.Tensor) and o.device.type == "cpu"
               for o in pytree.tree_leaves(out)):
            raise HostRead(f"{func} makes a CPU tensor (a copy to the host)")
        return out


def _meta_step(arch, B=2, S=16):
    """``make_train_step`` of REDUCED ``arch`` (remat, flash) and its
    arguments on the meta device, the step a meta 0-d int32 tensor."""
    cfg = _cfg(arch)
    params = T.abstract_params(cfg)
    i32 = dict(dtype=torch.int32, device="meta")
    batch = {"tokens": torch.zeros((B, S), **i32),
             "labels": torch.zeros((B, S), **i32)}
    inputs = {"batch": batch, "step": torch.zeros((), **i32)}
    return rsteps.make_train_step(cfg, OPT), \
        (params, adamw_init(params, OPT), inputs)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "olmoe-1b-7b"])
def test_train_step_reads_nothing_from_the_host(arch):
    """The train step (forward, remat recompute, backward, AdamW and its
    schedule) with a device step reads no host value and makes no host
    copy: what a replay computes is what the step computes."""
    step_fn, args = _meta_step(arch)
    with HostReads():
        params, state, metrics = step_fn(*args)
    assert metrics["loss"].device.type == "meta"
    assert state["count"].device.type == "meta"


def test_a_step_that_copies_its_step_to_the_host_trips_the_mode(
        monkeypatch):
    """The schedule as it read the step before the compiled step (moved
    to the CPU, so AdamW's learning rate was a host value that a capture
    bakes in: step 0's, 0, at every replay) trips ``HostReads``."""
    plain = rsteps.cosine_schedule
    monkeypatch.setattr(rsteps, "cosine_schedule", lambda step: plain(
        torch.as_tensor(step, dtype=torch.float32).cpu()))
    step_fn, args = _meta_step("h2o-danube-1.8b")
    with pytest.raises(HostRead, match="copy to the host"):
        with HostReads():
            step_fn(*args)


def test_the_schedule_stays_on_the_step_s_device():
    """A tensor step's scale is computed on its device (meta here); an
    int's on the CPU, as before."""
    for step in (0, 7, 150):
        got = rsteps.cosine_schedule(torch.tensor(step, dtype=torch.int32))
        assert torch.equal(got, rsteps.cosine_schedule(step))
        assert rsteps.cosine_schedule(_step(step, "meta")).device.type \
            == "meta"
    assert rsteps.cosine_schedule(3).device.type == "cpu"


# ---------------------------------------------------------------------------
# the runner under donation
# ---------------------------------------------------------------------------

RUN_STEPS = 5


class Clock:
    """``resilient.time`` under the test's control."""

    def __init__(self):
        self.now = 0.0

    def time(self):
        return self.now


def _runner_setup():
    cfg = _cfg("h2o-danube-1.8b")
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=8,
                                  batch_size=2)

    def fresh():
        gen = torch.Generator()
        gen.manual_seed(0)
        params = T.init_params(gen, cfg)
        return params, adamw_init(params, OPT)
    return cfg, fresh, lambda s: {"batch": stream.batch_at(s),
                                  "step": _step(s)}


def _run(tmp_path, name, compiled, wrap=None, num_steps=RUN_STEPS,
         **kw):
    """The runner from seed 0 with a checkpoint after every step, the
    step compiled or eager (through ``wrap``); returns the final trees,
    history, the trees passed in, and the steps whose metrics arrived."""
    cfg, fresh, batches = _runner_setup()
    step_fn = rsteps.jit_train_step(cfg, OPT) if compiled else \
        rsteps.make_train_step(cfg, OPT)
    if wrap is not None:
        step_fn = wrap(step_fn)
    params, state = fresh()
    seen = []
    out = run_training(
        cfg=RunnerConfig(ckpt_dir=str(tmp_path / name), ckpt_every=1,
                         max_retries=2, step_timeout_s=1.0),
        train_step=step_fn, params=params, opt_state=state,
        batches=batches, num_steps=num_steps,
        on_metrics=lambda s, m: seen.append((s, m["loss"])), **kw)
    return out, (params, state), seen


def _slow_at(clock, step):
    """The step, once slower than the timeout at ``step`` (after it ran:
    the straggler check reads the clock after the step's sync)."""
    def wrap(step_fn):
        tries = []

        def slow(params, opt_state, inputs):
            out = step_fn(params, opt_state, inputs)
            if int(inputs["step"]) == step and not tries:
                tries.append(step)
                clock.now += 10.0
            return out
        slow.donates = getattr(step_fn, "donates", False)
        return slow
    return wrap


@pytest.mark.parametrize("at", [0, 2])
def test_a_straggling_donated_step_keeps_what_it_wrote(graphs, tmp_path,
                                                       monkeypatch, at):
    """A straggler (at step 0, before any checkpoint, or at step 2): the
    eager runner retries it from the state in memory; the compiled
    runner's state is the step's own output by then, which is what that
    retry computes, so it records the failure and keeps that state rather
    than run the step again on it. History, metrics, final parameters and
    AdamW state: equal bit for bit, in the caller's tensors."""
    clock = Clock()
    monkeypatch.setattr(resilient, "time", clock)
    (ep, es, eh), _, eseen = _run(tmp_path, "eager", False,
                                  _slow_at(clock, at))
    (cp, cs, ch), (p0, s0), cseen = _run(tmp_path, "compiled", True,
                                         _slow_at(clock, at))
    fail = ("failure", at, f"straggler timeout at step {at}")
    assert eh == [*[("checkpoint", s) for s in range(at)], fail,
                  *[("checkpoint", s) for s in range(at, RUN_STEPS)]]
    assert ch == eh
    assert cp is p0 and cs is s0
    assert_bit_equal(cp, ep)
    assert_bit_equal(cs, es)
    assert cseen == eseen and [s for s, _ in cseen] == list(range(RUN_STEPS))
    assert graphs.captures == 1


def _raises_after_writing(step):
    """The step, raising once at ``step`` after it ran (its donated state
    written, as a replay that fails part-way may leave it)."""
    def wrap(step_fn):
        tries = []

        def failing(params, opt_state, inputs):
            out = step_fn(params, opt_state, inputs)
            if int(inputs["step"]) == step and not tries:
                tries.append(step)
                raise RuntimeError(f"step {step} failed part-way")
            return out
        failing.donates = getattr(step_fn, "donates", False)
        return failing
    return wrap


def test_a_donated_step_that_raised_is_restored_not_rerun(graphs,
                                                          tmp_path):
    """A step 2 that raises after writing its state: the eager runner
    retries it from the state in memory, which it never handed over; the
    compiled runner restores the step-1 checkpoint into its buffers and
    runs step 2 from there (``("restore", 2)``). Final parameters and
    AdamW state: equal bit for bit, in the caller's tensors."""
    (ep, es, eh), _, eseen = _run(tmp_path, "eager", False,
                                  _raises_after_writing(2))
    (cp, cs, ch), (p0, s0), cseen = _run(tmp_path, "compiled", True,
                                         _raises_after_writing(2))
    fail = ("failure", 2, "step 2 failed part-way")
    assert eh == [("checkpoint", 0), ("checkpoint", 1), fail,
                  *[("checkpoint", s) for s in range(2, RUN_STEPS)]]
    assert ch == [("checkpoint", 0), ("checkpoint", 1), fail,
                  ("restore", 2),
                  *[("checkpoint", s) for s in range(2, RUN_STEPS)]]
    assert cp is p0 and cs is s0
    assert_bit_equal(cp, ep)
    assert_bit_equal(cs, es)
    assert cseen == eseen and [s for s, _ in cseen] == list(range(RUN_STEPS))
    assert graphs.captures == 1


def test_a_donated_step_with_no_checkpoint_to_restore_raises(graphs,
                                                             tmp_path):
    """A step 0 that raises after writing its state, before the first
    checkpoint: the donated state may be part-way and cannot be restored,
    so the runner raises rather than run step 0 again on it."""
    with pytest.raises(resilient.StepFailure, match="step 0 failed after "
                       "writing its donated state, and there is no "
                       "checkpoint to restore"):
        _run(tmp_path, "compiled", True, _raises_after_writing(0))


def test_a_hard_failure_restores_into_the_donated_buffers(graphs,
                                                          tmp_path):
    """Every try of step 2 fails (past ``max_retries``): both runners
    restart from the step-1 checkpoint, the compiled one into its
    buffers; final states bit for bit equal."""
    def failing():
        left = [3]

        def fail(step, retries):
            if step == 2 and left[0]:
                left[0] -= 1
                return True
            return False
        return fail
    (ep, es, eh), _, _ = _run(tmp_path, "eager", False,
                              inject_failure=failing())
    (cp, cs, ch), (p0, s0), _ = _run(tmp_path, "compiled", True,
                                     inject_failure=failing())
    assert ch == eh and ("restart", 2) in ch
    assert [h[0] for h in ch].count("failure") == 3
    assert cp is p0 and cs is s0
    assert_bit_equal(cp, ep)
    assert_bit_equal(cs, es)


def test_a_resume_restores_into_the_donated_buffers(graphs, tmp_path):
    """Three steps, then a second run to five from the step-2
    checkpoint: the compiled runner resumes into the tensors it was given
    and ends where an eager resume does, bit for bit."""
    ends = {}
    for name, compiled in (("eager", False), ("compiled", True)):
        _run(tmp_path, name, compiled, num_steps=3)
        (p, s, h), (p0, s0), seen = _run(tmp_path, name, compiled)
        assert h[0] == ("resume", 3) and [x for x, _ in seen] == [3, 4]
        if compiled:
            assert p is p0 and s is s0
        ends[name] = (p, s)
    assert_bit_equal(ends["compiled"][0], ends["eager"][0])
    assert_bit_equal(ends["compiled"][1], ends["eager"][1])


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--arch", "h2o-danube-1.8b", "--reduced", "--batch", "2",
          "--seq", "8", "--device", "cpu", "--ckpt-every", "2"]


def test_train_launcher_says_how_it_ran(tmp_path, capsys):
    """On the CPU the step runs eagerly, and the launcher says why, with
    ``--eager`` or without."""
    for extra, why in (([], "CUDA graphs capture work on the card only; "
                        "cpu steps run eagerly"), (["--eager"], "--eager")):
        rep = ttrain.main(LAUNCH + ["--steps", "2", "--ckpt-dir",
                                    str(tmp_path / str(len(extra)))] + extra)
        out = capsys.readouterr().out
        assert f"[train] steps: eager ({why}); first step " in out
        assert rep.steps == f"eager ({why})" and rep.graphs is None
        assert rep.first_step_s == rep.step_s[0] and len(rep.step_s) == 2


def test_train_launcher_compiled_under_the_stand_in(graphs, tmp_path,
                                                    capsys):
    """With a capture to use the launcher compiles by default: one graph
    for every step, the eager run's losses and grad norms bit for bit;
    the resumed run restores into the donated buffers and replays."""
    runs = {}
    for extra in ([], ["--eager"]):
        d = str(tmp_path / ("eager" if extra else "compiled"))
        first = ttrain.main(LAUNCH + ["--steps", "3", "--ckpt-dir", d]
                            + extra)
        again = ttrain.main(LAUNCH + ["--steps", "4", "--ckpt-dir", d]
                            + extra)
        runs[bool(extra)] = (first, again, capsys.readouterr().out)
    (first, again, out), (efirst, eagain, _) = runs[False], runs[True]
    assert first.steps.startswith("compiled (CUDA graphs: 1 captured, 0.0 "
                                  "MiB in their pool; capture ")
    assert "[train] steps: compiled (CUDA graphs: 1 captured" in out
    assert first.graphs.graphs == again.graphs.graphs == 1
    assert (first.losses, first.grad_norms) == \
        (efirst.losses, efirst.grad_norms)
    assert again.history == eagain.history == [("resume", 3),
                                               ("checkpoint", 3)]
    assert (again.losses, again.grad_norms) == \
        (eagain.losses, eagain.grad_norms)
    assert graphs.captures == 2 and graphs.replays == 2
    assert np.isfinite(first.losses).all()
