"""Fault-tolerant training runner: checkpoint cadence, retry, restart
(port of ``repro/runtime/resilient.py``).

  * a transient step failure is retried up to ``max_retries`` times from
    the in-memory state;
  * past that, the runner restores the latest checkpoint and, if the
    caller gives ``remesh_fn``, rebuilds the step before going on;
  * a step slower than ``step_timeout_s`` counts as a failure.
Every exception a step raises is caught and retried, as in the JAX
package, so a failure that repeats (a kernel that does not build, a sticky
CUDA error) loops for ever: callers that must fail fast run one step
directly first. ``inject_failure`` lets tests script failures. Each step
ends in a device sync (``jax.block_until_ready`` in the JAX package).

On a mesh every rank runs the runner with the same arguments, the step
being ``make_train_step(..., mesh=)`` and ``shards`` its
``TrainShards``: each rank feeds the whole batch and the step takes the
rank's rows; the checkpoints are the whole tree, written by rank 0
(``checkpoint.save_checkpoint(shards=)``), and only rank 0 removes old
ones.
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
from repro_torch.core.tree import tree_leaves


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
    params and optimizer state are this rank's shares)."""
    history = []
    start = latest_step(cfg.ckpt_dir)
    step = 0
    writer = shards is None or dist.get_rank() == 0
    if start is not None:
        restored, step0, _ = restore_checkpoint(
            cfg.ckpt_dir, {"params": params, "opt": opt_state},
            shards=shards)
        params, opt_state = restored["params"], restored["opt"]
        step = step0 + 1
        history.append(("resume", step))

    retries = 0
    while step < num_steps:
        inputs = batches(step)
        t0 = time.time()
        try:
            if inject_failure is not None and inject_failure(step, retries):
                raise StepFailure(f"injected failure at step {step}")
            params2, opt2, metrics = train_step(params, opt_state, inputs)
            _block_until_ready(metrics)
            if time.time() - t0 > cfg.step_timeout_s:
                raise StepFailure(f"straggler timeout at step {step}")
        except Exception as e:  # noqa: BLE001 — any failure is retried
            retries += 1
            history.append(("failure", step, str(e)[:120]))
            if retries > cfg.max_retries:
                restored, step0, _ = restore_checkpoint(
                    cfg.ckpt_dir, {"params": params, "opt": opt_state},
                    shards=shards)
                if restored is not None:
                    params, opt_state = restored["params"], restored["opt"]
                    step = step0 + 1
                if remesh_fn is not None:
                    train_step = remesh_fn()
                    history.append(("remesh", step))
                retries = 0
                history.append(("restart", step))
            continue

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
