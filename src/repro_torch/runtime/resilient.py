"""Fault-tolerant training runner: checkpoint cadence, retry, restart
(port of ``repro/runtime/resilient.py``).

  * a transient step failure is retried up to ``max_retries`` times from
    the in-memory state;
  * past that (a hard failure), if the caller gives ``remesh_fn``, the
    runner first rebuilds the step (``remesh_fn() -> train_step``: elastic
    re-meshing, ``launch.mesh.degraded_mesh``), then restores the latest
    checkpoint onto that step's own shares (its ``.shards``), and goes on;
  * a step slower than ``step_timeout_s`` counts as a failure.
Every exception a step raises is caught and retried, as in the JAX
package, so a failure that repeats (a kernel that does not build, a sticky
CUDA error) loops for ever: callers that must fail fast run one step
directly first. A compiled step's failed capture (``steps.CaptureFailed``)
is the exception: it is raised, since the same capture would fail again
and nothing falls back to the eager step. ``inject_failure`` lets tests
script failures. Each step ends in a device sync
(``jax.block_until_ready`` in the JAX package).

A step that donates its state (``steps.jit_train_step``: ``donates``)
writes the new parameters and AdamW state into the tensors it was given,
so the runner never runs it again on the state it wrote. A straggler has
finished by the time its clock is read, and the step is deterministic:
the state it wrote is what the eager runner's retry computes, so the
failure is recorded and that state kept. A donated step that raises once
called may have written part of its state: the latest checkpoint is
restored into those same tensors (the compiled step keeps its buffers),
recording ``("restore", step)``; with no checkpoint to restore the runner
raises. Resumes and hard failures restore into them too. An eager step's
retry stays in memory.

On a mesh every rank runs the runner with the same arguments, the step
being ``make_train_step(..., mesh=)`` and ``shards`` its
``TrainShards``: each rank feeds the whole batch and the step takes the
rank's rows; the checkpoints are the whole tree, written by rank 0
(``checkpoint.save_checkpoint(shards=)``), and only rank 0 removes old
ones. A rank's own clock must not decide alone: a step that one rank
finds too slow is a failure on every rank (one all-reduce of the flag a
step), so that the ranks take the same branch and issue the same
collectives. On a re-mesh the per-rank batch stays what ``batches`` gives
(the caller's function may read the new mesh: the global batch then
shrinks with the data axis).
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import time
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.runtime.steps import CaptureFailed


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_retries: int = 3
    step_timeout_s: float = 3600.0
    keep_last: int = 3


class StepFailure(RuntimeError):
    pass


def _gc_checkpoints(ckpt_dir: str, keep: int):
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(m.group(1)) for n in os.listdir(ckpt_dir)
                   if (m := re.match(r"^step_(\d+)$", n)))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def _block_until_ready(tree) -> None:
    for dev in {t.device for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor) and t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _restore(ckpt_dir: str, params, opt_state, shards, donated: bool):
    """The latest checkpoint as ``(params, opt_state, step)``, or None
    where there is none. For a ``donated`` step it is read on the host and
    copied into the tensors of ``params`` and ``opt_state``, which are
    returned: the compiled step keeps its buffers, and the device never
    holds two copies of the state."""
    like = {"params": params, "opt": opt_state}
    if not donated:
        restored, step0, _ = restore_checkpoint(ckpt_dir, like,
                                                shards=shards)
        return None if restored is None else \
            (restored["params"], restored["opt"], step0)
    restored, step0, _ = restore_checkpoint(
        ckpt_dir, tree_map(lambda t: t.to("meta"), like))
    if restored is None:
        return None
    for dst, src in zip(tree_leaves(like), tree_leaves(restored)):
        dst.copy_(src)
    return params, opt_state, step0


def _anyone(flag: bool, shards, tree) -> bool:
    """``flag`` on this rank or, on a mesh, on any rank of the world."""
    if shards is None:
        return flag
    dev = next((t.device for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)), torch.device("cpu"))
    t = torch.full((), float(flag), dtype=torch.float32, device=dev)
    return bool(shards.layout.reduce_world(t) > 0)


def run_training(
    *,
    cfg: RunnerConfig,
    train_step: Callable,                    # (params, opt, inputs) -> ...
    params: Any,
    opt_state: Any,
    batches: Callable[[int], dict],          # step -> inputs dict
    num_steps: int,
    inject_failure: Optional[Callable[[int, int], bool]] = None,
    remesh_fn: Optional[Callable[[], Callable]] = None,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    shards=None,
):
    """Run ``num_steps`` with checkpoint/restart semantics. Returns
    ``(params, opt_state, history)``; history records every recovery
    event and checkpoint. ``shards``: a mesh step's ``TrainShards`` (the
    params and optimizer state are this rank's shares); after a re-mesh
    the new step's."""
    history = []
    start = latest_step(cfg.ckpt_dir)
    step = 0
    writer = shards is None or dist.get_rank() == 0
    donated = getattr(train_step, "donates", False)
    if start is not None:
        params, opt_state, step0 = _restore(cfg.ckpt_dir, params, opt_state,
                                            shards, donated)
        step = step0 + 1
        history.append(("resume", step))

    retries = 0
    while step < num_steps:
        inputs = batches(step)
        t0 = time.time()
        called = slow = False
        try:
            if inject_failure is not None and inject_failure(step, retries):
                raise StepFailure(f"injected failure at step {step}")
            called = True
            params2, opt2, metrics = train_step(params, opt_state, inputs)
            _block_until_ready(metrics)
            slow = _anyone(time.time() - t0 > cfg.step_timeout_s, shards,
                           metrics)
            if slow and not donated:
                raise StepFailure(f"straggler timeout at step {step}")
        except CaptureFailed:
            raise
        except Exception as e:  # noqa: BLE001 — any failure is retried
            retries += 1
            history.append(("failure", step, str(e)[:120]))
            # a donated step that raised may have written part of its state
            written = donated and called
            hard = retries > cfg.max_retries
            if hard and remesh_fn is not None:
                train_step = remesh_fn()
                shards = getattr(train_step, "shards", shards)
                writer = shards is None or dist.get_rank() == 0
                donated = getattr(train_step, "donates", False)
            if hard or written:
                got = _restore(cfg.ckpt_dir, params, opt_state, shards,
                               donated)
                if got is not None:
                    params, opt_state, step0 = got
                    step = step0 + 1
                elif written:
                    raise StepFailure(
                        f"step {step} failed after writing its donated "
                        f"state, and there is no checkpoint to restore "
                        f"(the step is never run again on the state it "
                        f"wrote): {e}") from e
            if hard:
                if remesh_fn is not None:
                    history.append(("remesh", step))
                retries = 0
                history.append(("restart", step))
            elif written:
                history.append(("restore", step))
            continue

        if slow:  # donated: what it wrote is what a retry would compute
            history.append(("failure", step,
                            f"straggler timeout at step {step}"))
        params, opt_state = params2, opt2
        retries = 0
        if on_metrics is not None:
            on_metrics(step, {k: float(v) for k, v in metrics.items()})
        if step % cfg.ckpt_every == 0 or step == num_steps - 1:
            save_checkpoint(cfg.ckpt_dir, step,
                            {"params": params, "opt": opt_state},
                            shards=shards)
            if writer:
                _gc_checkpoints(cfg.ckpt_dir, cfg.keep_last)
            history.append(("checkpoint", step))
        step += 1
    return params, opt_state, history
