"""AdamW with a configurable state dtype (port of ``repro/optim/adamw.py``).

The JAX update term for term, not ``torch.optim.AdamW`` (whose weight
decay, clipping and cast order differ): a global-norm clip of the
gradients, fp32 update math, moments stored in ``state_dtype``, decay on
every leaf (norm scales and the embedding table included), new parameters
cast back to each parameter's dtype. Functional like the JAX version: it
returns new trees and leaves its inputs as they were, so a failed step can
be retried from the old state.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.tree import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments in ``cfg.state_dtype`` beside each leaf; int32 count."""
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _global_norm(tree) -> torch.Tensor:
    total = None
    for g in tree_leaves(tree):
        sq = torch.sum(torch.square(g.to(F32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0, *,
                 gnorm=None):
    """Returns ``(new_params, new_state, {"grad_norm"})``. ``gnorm`` is
    the clip's global norm when the caller computes it (a mesh rank's
    shares: ``runtime.sharding.TrainShards.global_norm``); by default the
    norm of ``grads``."""
    count = state["count"] + 1
    if gnorm is None:
        gnorm = _global_norm(grads)
    clip = torch.clamp_max(
        torch.div(torch.full_like(gnorm, cfg.grad_clip), gnorm + 1e-9), 1.0)
    cf = count.to(F32)
    bc1 = 1 - torch.pow(cfg.b1, cf)
    bc2 = 1 - torch.pow(cfg.b2, cf)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=F32)   # fp32, as in JAX

    def upd(g, m, v, p):
        g = g.to(F32) * clip
        m32 = cfg.b1 * m.to(F32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(F32) + (1 - cfg.b2) * g * g
        del g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.to(F32)
        newp = p.to(F32) - lr * step
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, grads, state["m"], state["v"], params)
    pick = lambda i: tree_map(lambda t: t[i], out)
    return pick(0), {"m": pick(1), "v": pick(2), "count": count}, \
        {"grad_norm": gnorm}
