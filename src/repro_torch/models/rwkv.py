"""RWKV-6 "Finch" block: time-mix with data-dependent decay and channel-mix
(port of ``repro/models/rwkv.py``).

Attention-free linear recurrence with a per-head matrix state
``S_t = diag(w_t) S_{t-1} + k_t^T v_t`` and readout ``o_t = r_t S_t``: a
constant-size state. The r/k/v/g/w/output projections and the channel-mix
linears are ordinary ``layers.linear`` calls (W4A16 when quantized); the
recurrence is element-wise work in fp32 and runs as plain PyTorch, one
step of the loop per token, as JAX's ``lax.scan`` body does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers

TM_KEYS = ("tm_r", "tm_k", "tm_v", "tm_g", "tm_w", "tm_o")


def init_rwkv_block(gen: torch.Generator, d_model: int, d_ff: int,
                    num_heads: int, dtype, *, device=None,
                    stacked: Optional[int] = None, cut=None):
    """One block's parameters (stacked over ``stacked`` layers when
    given); ``w_bias`` is fp32, as in the JAX package. ``cut(path, p)``
    (``runtime.sharding.Layout.cut``) takes each leaf to a mesh rank's
    slice as soon as it is drawn."""
    keep = cut or (lambda path, p: p)

    def lin(name, d_in, d_out):
        return keep(("layers", name), layers.init_linear(
            gen, d_in, d_out, dtype, device=device, layers=stacked))

    p = {k: lin(k, d_model, d_model) for k in TM_KEYS}
    shape = (d_model,) if stacked is None else (stacked, d_model)
    p["w_bias"] = keep(("layers", "w_bias"), torch.full(
        shape, -6.0, dtype=torch.float32, device=device))
    p["cm_k"] = lin("cm_k", d_model, d_ff)
    p["cm_v"] = lin("cm_v", d_ff, d_model)
    return p


def rwkv_state_init(batch: int, d_model: int, num_heads: int,
                    head_dim: int, *, device=None):
    """The carry at zero: ``wkv`` (B, H, hd, hd) for ``num_heads`` heads
    (a mesh rank's own), the token shifts (B, d) full width."""
    hd = head_dim
    z = dict(dtype=torch.float32, device=device)
    return {"wkv": torch.zeros((batch, num_heads, hd, hd), **z),
            "shift": torch.zeros((batch, d_model), **z),
            "cm_shift": torch.zeros((batch, d_model), **z)}


def _heads(x: torch.Tensor, H: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], H, x.shape[-1] // H)


def _rkvgw(p, xm, H: int, cfg):
    """The five projections of the mixed input: r, k, v per head (fp32),
    g (fp32) and the decay w = exp(-softplus(xm·W_w + w_bias)) per head.
    On a training mesh rank xm enters the column-cut leaves through
    ``layers.col_input``."""
    xm = layers.col_input(xm, cfg, *(p[k] for k in TM_KEYS[:5]))
    r = _heads(layers.linear(p["tm_r"], xm, cfg), H).to(torch.float32)
    k = _heads(layers.linear(p["tm_k"], xm, cfg), H).to(torch.float32)
    v = _heads(layers.linear(p["tm_v"], xm, cfg), H).to(torch.float32)
    g = layers.linear(p["tm_g"], xm, cfg).to(torch.float32)
    w = layers.softplus(layers.linear(p["tm_w"], xm, cfg).to(torch.float32)
                        + p["w_bias"])
    return r, k, v, g, _heads(torch.exp(-w), H)


def wkv_scan(s: torch.Tensor, w: torch.Tensor, kv: torch.Tensor,
             valid: Optional[torch.Tensor] = None,
             collect_states: bool = False):
    """The recurrence over S steps: ``S_t = w_t * S_{t-1} + kv_t`` from
    ``s`` (B, H, hd, hd), w (B, S, H, hd), kv (B, S, H, hd, hd); a step
    whose ``valid`` (B, S) entry is False leaves the carry as it was.
    Returns (the final carry, every step's pre-mask state (B, S, H, hd,
    hd), and the post-mask carries when ``collect_states``, else None).
    The steps read w and kv through ``unbind`` (a backward that stacks the
    per-step gradients once, as ``ssm.ssm_scan``)."""
    s_new_all, kept = [], []
    for t, (w_t, kv_t) in enumerate(zip(w.unbind(1), kv.unbind(1))):
        s_new = s * w_t[..., None] + kv_t
        s = s_new if valid is None else torch.where(
            valid[:, t, None, None, None], s_new, s)
        s_new_all.append(s_new)
        if collect_states:
            kept.append(s)
    return s, torch.stack(s_new_all, 1), \
        torch.stack(kept, 1) if collect_states else None


def time_mix_seq(p, x: torch.Tensor, state, *, num_heads: int, cfg=None,
                 valid: Optional[torch.Tensor] = None,
                 collect_states: bool = False):
    """Sequence mode: x (B, S, d) → (B, S, d), the recurrence stepped over
    time. ``valid`` (B, S) bool masks right-padded positions out of the
    carry: a masked step leaves ``wkv`` untouched, and the returned
    ``shift`` is the last valid token (a row with no valid token keeps its
    incoming shift). With ``collect_states`` the per-step (post-mask) wkv
    states come back as a third value, (B, S, H, hd, hd). Returns (out,
    {"wkv", "shift"}[, states])."""
    B, S, _ = x.shape
    H = num_heads
    prev = torch.cat([state["shift"].to(x.dtype)[:, None], x[:, :-1]], 1)
    xm = 0.5 * (x + prev)                       # token-shift mixing
    r, k, v, g, w = _rkvgw(p, xm, H, cfg)
    kv = k[..., None] * v[..., None, :]         # (B, S, H, hd, hd)
    s, steps, kept = wkv_scan(state["wkv"], w, kv, valid, collect_states)
    # o_t = r_t · S_t over every step at once
    o = torch.matmul(r[..., None, :], steps)[..., 0, :]
    o = o.reshape(B, S, -1) * F.silu(g)
    out = layers.linear(p["tm_o"], o.to(x.dtype), cfg)
    if valid is None:
        shift = x[:, -1].to(torch.float32)
    else:
        last = (valid.to(torch.int32).sum(1) - 1).clamp_min(0)
        taken = x[torch.arange(B, device=x.device), last]
        shift = torch.where(valid.any(1)[:, None], taken.to(torch.float32),
                            state["shift"])
    new_state = {"wkv": s, "shift": shift}
    if collect_states:
        return out, new_state, kept
    return out, new_state


def time_mix_step(p, x: torch.Tensor, state, *, num_heads: int, cfg=None):
    """Decode mode: x (B, d), one token → (out (B, d), {"wkv", "shift"})."""
    B = x.shape[0]
    xm = 0.5 * (x + state["shift"].to(x.dtype))
    r, k, v, g, w = _rkvgw(p, xm, num_heads, cfg)
    s = state["wkv"] * w[..., None] + k[..., None] * v[..., None, :]
    o = torch.matmul(r[..., None, :], s)[..., 0, :].reshape(B, -1)
    o = o * F.silu(g)
    out = layers.linear(p["tm_o"], o.to(x.dtype), cfg)
    return out, {"wkv": s, "shift": x.to(torch.float32)}


def channel_mix(p, x: torch.Tensor, prev: torch.Tensor, cfg=None):
    """RWKV channel-mix FFN with token shift. x, prev: (..., d)."""
    xm = layers.col_input(0.5 * (x + prev.to(x.dtype)), cfg, p["cm_k"])
    k = layers.linear(p["cm_k"], xm, cfg)
    k = torch.square(F.relu(k.to(torch.float32))).to(x.dtype)
    return layers.linear(p["cm_v"], k, cfg)
