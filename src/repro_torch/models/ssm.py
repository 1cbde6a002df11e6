"""Mamba-style selective SSM head, the SSM half of Hymba's hybrid layers
(port of ``repro/models/ssm.py``).

Diagonal selective state space: per channel c and state n,
    h_t = exp(dt_t * A[c,n]) * h_{t-1} + dt_t * B_t[n] * x_t[c]
    y_t = sum_n C_t[n] * h_t[c,n] + D[c] * x_t[c]
with input-dependent dt, B and C. The state is (B, d_inner, ssm_state),
constant in sequence length. The projections are quantizable linears
(``bc_proj`` stays dense, as in the JAX package); the recurrence runs in
fp32 as plain PyTorch, one step of the loop per token.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import layers


def init_ssm(gen: torch.Generator, d_model: int, d_inner: int,
             ssm_state: int, dtype, *, device=None,
             stacked: Optional[int] = None, cut=None):
    """One SSM head's parameters (stacked over ``stacked`` layers when
    given); ``A_log`` and ``D`` are fp32 and deterministic, as in JAX.
    ``cut(path, p)`` (``runtime.sharding.Layout.cut``) takes each leaf to
    a mesh rank's slice as soon as it is drawn."""
    keep = cut or (lambda path, p: p)

    def lin(name, d_in, d_out):
        return keep(("layers", "ssm", name), layers.init_linear(
            gen, d_in, d_out, dtype, device=device, layers=stacked))

    lead = () if stacked is None else (stacked,)
    a = torch.arange(1, ssm_state + 1, dtype=torch.float32, device=device)
    p = {
        "in_proj": lin("in_proj", d_model, d_inner),
        "bc_proj": lin("bc_proj", d_model, 2 * ssm_state),
        "dt_proj": lin("dt_proj", d_model, d_inner),
        "out_proj": lin("out_proj", d_inner, d_model),
    }
    for name, t in (
            ("A_log", torch.log(a).expand(*lead, d_inner, ssm_state)),
            ("D", torch.ones((*lead, d_inner), dtype=torch.float32,
                             device=device))):
        p[name] = keep(("layers", "ssm", name), t.contiguous())
    return p


def ssm_state_init(batch: int, d_inner: int, ssm_state: int, *,
                   device=None) -> torch.Tensor:
    return torch.zeros((batch, d_inner, ssm_state), dtype=torch.float32,
                       device=device)


def _gates(p, x, cfg):
    """u, B, C, dt and A of input x. On a mesh rank that holds a slice of
    the channels (``in_proj``/``dt_proj`` column-cut, ``A_log`` and ``D``
    sliced to match) ``bc_proj`` stays whole, and when the slice trains,
    B and C pass through ``copy_to_model``: every rank's channels read
    them, so each rank's gradient of them is partial."""
    xc = layers.col_input(x, cfg, p["in_proj"], p["dt_proj"])
    u = layers.linear(p["in_proj"], xc, cfg).to(torch.float32)  # (.., d_in)
    bc = layers.linear(p["bc_proj"], x, cfg).to(torch.float32)
    if xc is not x:
        bc = cfg.shard.copy_to_model(bc)
    Bm, Cm = torch.chunk(bc, 2, dim=-1)                        # (..., n)
    dt = layers.softplus(
        layers.linear(p["dt_proj"], xc, cfg).to(torch.float32) - 4.0)
    A = -torch.exp(p["A_log"])                                 # (d_in, n)
    return u, Bm, Cm, dt, A


def ssm_scan(h: torch.Tensor, da: torch.Tensor, dbu: torch.Tensor,
             valid: Optional[torch.Tensor] = None,
             collect_states: bool = False):
    """The recurrence over S steps: ``h_t = da_t * h_{t-1} + dbu_t`` from
    ``h`` (B, d_inner, n), da and dbu (B, S, d_inner, n); a step whose
    ``valid`` (B, S) entry is False leaves the carry as it was. Returns
    (the final carry, every step's pre-mask state (B, S, d_inner, n), and
    the post-mask carries when ``collect_states``, else None). The steps
    read da and dbu through ``unbind``, whose backward stacks the per-step
    gradients once; indexing each step would make each step's backward
    write a zero-filled gradient the size of the whole sequence. On the
    meta device (the dry run, whose ops run in Python) the S steps are one
    step of the same shapes."""
    if dbu.is_meta:
        prev = torch.cat([h[:, None], dbu[:, :-1]], 1)
        h_all = prev * da + dbu
        return h_all[:, -1].clone(), h_all, \
            h_all.clone() if collect_states else None
    h_new_all, kept = [], []
    for t, (da_t, dbu_t) in enumerate(zip(da.unbind(1), dbu.unbind(1))):
        h_new = h * da_t + dbu_t
        h = h_new if valid is None else torch.where(
            valid[:, t, None, None], h_new, h)
        h_new_all.append(h_new)
        if collect_states:
            kept.append(h)
    return h, torch.stack(h_new_all, 1), \
        torch.stack(kept, 1) if collect_states else None


def ssm_seq(p, x: torch.Tensor, state: torch.Tensor, cfg=None, *,
            valid: Optional[torch.Tensor] = None,
            collect_states: bool = False):
    """x: (B, S, d_model) → (B, S, d_model), the recurrence stepped over
    time from ``state`` (B, d_inner, n). ``valid`` (B, S) bool masks
    right-padded positions out of the carry (a masked step leaves ``h``
    untouched; its output row is garbage). With ``collect_states`` the
    per-step (post-mask) carries come back as a third value, (B, S,
    d_inner, n). Returns (out, h_fin[, states])."""
    u, Bm, Cm, dt, A = _gates(p, x, cfg)
    da = torch.exp(dt[..., None] * A)                  # (B, S, d_in, n)
    dbu = (dt * u)[..., None] * Bm[:, :, None, :]
    h, steps, kept = ssm_scan(state, da, dbu, valid, collect_states)
    # y_t = h_t · C_t over every step at once
    y = torch.matmul(steps, Cm[..., None])[..., 0]
    y = y + u * p["D"]
    out = layers.linear(p["out_proj"], y.to(x.dtype), cfg)
    if collect_states:
        return out, h, kept
    return out, h


def ssm_step(p, x: torch.Tensor, state: torch.Tensor, cfg=None):
    """x: (B, d_model), one token → (out (B, d_model), h)."""
    u, Bm, Cm, dt, A = _gates(p, x, cfg)
    h = state * torch.exp(dt[..., None] * A) + (dt * u)[..., None] \
        * Bm[:, None, :]
    y = torch.matmul(h, Cm[..., None])[..., 0] + u * p["D"]
    out = layers.linear(p["out_proj"], y.to(x.dtype), cfg)
    return out, h
