"""Deterministic synthetic token pipeline, sharded per host (port of
``repro/data/pipeline.py``).

The stream is numpy in both packages, so the same seed, step and host give
the same bytes; the port hands them over as int32 tensors on ``device``.
Zipfian token statistics plus a short-range copy structure make the LM
loss fall in short runs. On a mesh every rank draws the same batch at a
step (one host's stream: the same seed, step and ``host_id``), and the
sharded train step keeps the rank's rows of each microbatch
(``runtime.steps.make_train_step(..., mesh=)``), as JAX's
``train_input_shardings`` hand each device its rows of the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticTokenStream:
    vocab_size: int
    seq_len: int
    batch_size: int            # per-host batch
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    device: Any = None         # where the batch tensors go (None: CPU)

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a global step (resume-safe)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        B, S, V = self.batch_size, self.seq_len, self.vocab_size
        ranks = np.arange(1, V + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(V, size=(B, S + 1), p=probs).astype(np.int32)
        rep = rng.random((B, S + 1)) < 0.3
        rep[:, 0] = False
        idx = np.where(rep, np.roll(toks, 1, axis=1), toks)
        return {"tokens": torch.from_numpy(idx[:, :-1].copy())
                .to(self.device),
                "labels": torch.from_numpy(idx[:, 1:].copy())
                .to(self.device)}


def make_batch_iterator(stream: SyntheticTokenStream, *,
                        start_step: int = 0,
                        extras: Optional[dict] = None) -> Iterator[dict]:
    """Infinite iterator from a step offset (checkpoint-resume entry point)."""
    step = start_step
    while True:
        b = stream.batch_at(step)
        if extras:
            b = {**b, **extras}
        yield b
        step += 1
