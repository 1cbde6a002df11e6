"""Top-k token-choice MoE with capacity-based dispatch (port of
``repro/models/moe.py``).

Dispatch is the sort-free cumsum-rank formulation: every (token, k) pair
gets a rank within its chosen expert; pairs beyond the expert capacity are
dropped (standard capacity-factor semantics). The expert FFNs run as
batched (E, cap, d) × (E, d, ff) products: with quantized experts one
planned GEMM per stack (on the card one launch of the W4A16 kernel for all
E experts), with dense experts ``torch.bmm``.

Which pairs drop depends on the routing batch T (the capacity is a
function of T), so callers route exactly the rows the JAX package routes:
every decode row (inactive slots included), every padded chunk row, every
verify row.

On a mesh (``cfg.shard``) the expert stacks are tensor-parallel on d_ff
(``w_gate``/``w_up`` column-, ``w_down`` row-parallel; the router
replicated) and the expert-batched kernel runs at the rank's N or K; the
row-parallel partial sums are all-reduced over "model" once, after the
combine (a training rank's through the autograd-aware all-reduce; its
combine weights pass ``copy_to_model``, since each rank's gradient of them
is partial). Dispatch is data-parallel as the JAX package's (its ``_dp_axes``
and the vmapped shards of ``moe_ffn``): each data shard of the routing
batch routes its own tokens at a per-shard capacity. A step whose rows are
a rank's data shard routes them as one; a replicated step (the one-slot
prefill chunk) routes its tokens in ``shards`` contiguous groups
(:func:`moe_ffn`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.device import dtype_name
from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import planning
from repro_torch.models import layers


def init_moe(gen: torch.Generator, d_model: int, d_ff: int,
             num_experts: int, dtype, *, device=None,
             stacked: Optional[int] = None, cut=None):
    """Router and (E, d, ff) / (E, ff, d) expert kernels, N(0, 1/fan_in),
    drawn from ``gen`` on ``device`` (stacked over ``stacked`` layers when
    given); ``cut(path, p)`` replaces each dict as it is drawn (a mesh
    rank's slice, ``transformer.init_params``)."""
    lead = () if stacked is None else (stacked,)
    E = num_experts
    keep = cut or (lambda path, p: p)

    def experts(name, d_in, d_out):
        w = torch.randn(lead + (E, d_in, d_out), generator=gen,
                        device=device) * d_in ** -0.5
        return keep(("layers", "moe", name), {"kernel": w.to(dtype)})

    return {
        "router": keep(("layers", "moe", "router"), layers.init_linear(
            gen, d_model, E, dtype, device=device, layers=stacked)),
        "w_gate": experts("w_gate", d_model, d_ff),
        "w_up": experts("w_up", d_model, d_ff),
        "w_down": experts("w_down", d_ff, d_model),
    }


def capacity(T: int, top_k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Expert capacity for a routing batch of T tokens: the JAX package's
    expression, Python's ``round`` (half to even: round(2.5) = 2)
    included."""
    cap = int(max(top_k, round(T * top_k / num_experts * capacity_factor)))
    return min(cap, T * top_k)


def stable_top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest gates per row, ties to the lower
    index first as ``jax.lax.top_k`` (a stable descending sort)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_matmul(w, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (E, cap, K) · w: (E, K, N) — a quantized expert stack (one plan
    for the stack, M = cap, batch = E) or dense experts (``torch.bmm``,
    fp32 accumulation, the activation dtype out). A whole stack behind a
    d_ff-sharded input (mark ``"gather"``) all-gathers x over "model"
    first; a row-parallel stack's output is a partial sum."""
    kern = w["kernel"]
    if w.get("tp") == "gather":
        x = cfg.shard.gather_over_model(x) if layers.trains(kern) \
            else cfg.shard.gather_model(x)
    if isinstance(kern, QuantizedTensor):
        problem = planning.MatmulProblem(
            M=int(x.shape[1]), N=int(kern.N), K=int(x.shape[-1]),
            group_size=kern.group_size, act_dtype=dtype_name(x.dtype),
            out_dtype=dtype_name(x.dtype), has_zeros=kern.zeros is not None,
            backend=x.device.type, batch=int(x.shape[0]),
            format=kern.format.name)
        plan = planning.resolve_plan(problem, cfg)
        return planning.execute(plan, x, kern)
    return torch.bmm(x, kern.to(x.dtype))


def _dispatch_ffn(p, xt: torch.Tensor, *, num_experts: int, top_k: int,
                  capacity_factor: float, cfg):
    """Route, dispatch and combine one token batch. xt: (T, d)."""
    T, d = xt.shape
    E = num_experts
    dev = xt.device

    logits = layers.linear(p["router"], xt.to(torch.float32), cfg)  # (T, E)
    gates = torch.softmax(logits, dim=-1)
    weights, sel = stable_top_k(gates, top_k)                       # (T, k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    if _partial_out(p):
        # each model rank combines its partial expert outputs: the
        # weights' gradient is partial too, summed over "model"
        weights = cfg.shard.copy_to_model(weights)

    # aux loss (Switch): E * sum_e f_e * p_e
    me = gates.mean(dim=0)
    ce = F.one_hot(sel, E).to(torch.float32).sum(dim=1).mean(dim=0)
    aux = E * torch.sum(me * ce)

    cap = capacity(T, top_k, E, capacity_factor)

    flat_e = sel.reshape(-1)                                        # (T*k,)
    onehot = F.one_hot(flat_e, E)                                   # (T*k, E)
    rank = (torch.cumsum(onehot, dim=0) - onehot)[
        torch.arange(T * top_k, device=dev), flat_e]                # in expert
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank,
                       torch.full_like(flat_e, E * cap))            # overflow

    token_id = torch.arange(T, device=dev).repeat_interleave(top_k)
    src = torch.zeros(E * cap + 1, dtype=torch.long, device=dev)
    src[slot] = token_id + 1                                        # 0 = empty
    src = src[:E * cap]
    gathered = torch.where(
        (src > 0)[:, None], xt[(src - 1).clamp_min(0)],
        torch.zeros((), dtype=xt.dtype, device=dev)).reshape(E, cap, d)

    gathered = layers.col_input(gathered, cfg, p["w_gate"], p["w_up"])
    h_gate = _expert_matmul(p["w_gate"], gathered, cfg)
    h_up = _expert_matmul(p["w_up"], gathered, cfg)
    h = F.silu(h_gate.to(torch.float32)).to(xt.dtype) * h_up
    out_e = _expert_matmul(p["w_down"], h, cfg).reshape(E * cap, d)

    # combine: gather expert outputs back to (token, k), weighted sum
    pair_out = torch.where(
        keep[:, None], out_e[slot.clamp_max(E * cap - 1)],
        torch.zeros((), dtype=out_e.dtype, device=dev)).reshape(T, top_k, d)
    yt = torch.sum(pair_out * weights[..., None].to(xt.dtype), dim=1)
    return yt, aux


def moe_ffn(p, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, cfg=None, shards: int = 1):
    """x: (..., d) → ((..., d), the aux load-balancing loss). Every row of
    x joins the routing batch; with ``shards`` > 1 the flattened tokens
    route in that many contiguous groups, each at its own capacity (the
    JAX package's data-parallel dispatch), and the aux loss is their
    mean."""
    lead = x.shape[:-1]
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    outs = [_dispatch_ffn(p, xs, num_experts=num_experts, top_k=top_k,
                          capacity_factor=capacity_factor, cfg=cfg)
            for xs in xt.chunk(shards)]
    yt = torch.cat([y for y, _ in outs])
    aux = torch.stack([a for _, a in outs]).mean()
    if p["w_down"].get("tp") == "row":
        yt = cfg.shard.reduce_over_model(yt) if _partial_out(p) \
            else cfg.shard.reduce_model(yt)
    return yt.reshape(*lead, d), aux


def _partial_out(p) -> bool:
    """A training rank's row-cut ``w_down``: its combined output is a
    partial sum, and the autograd-aware collectives carry the step."""
    return p["w_down"].get("tp") == "row" \
        and layers.trains(p["w_down"]["kernel"])
