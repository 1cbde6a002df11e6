"""Base layers: (quantizable) Linear, RMSNorm, LayerNorm, GELU, softplus,
the embedding and its tied unembedding, RoPE (port of
``repro/models/layers.py``).

Every matmul goes through :func:`linear`, which dispatches on the weight
leaf type: a plain tensor runs the dense path, a ``QuantizedTensor`` runs
the planned W4A16 path (``planning.matmul``). ``quantize_tree`` is the
serve-time transform into W4A16 form.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.quant import QuantizedTensor, quantize
from repro_torch.kernels import planning


def init_linear(gen: torch.Generator, d_in: int, d_out: int, dtype, *,
                device=None, layers: Optional[int] = None,
                bias: bool = False):
    """{"kernel": (d_in, d_out)} with N(0, 1/d_in) entries (stacked over
    ``layers`` when given), drawn from ``gen``; with ``bias`` also a zero
    {"bias": (d_out,)}."""
    lead = () if layers is None else (layers,)
    w = torch.randn(lead + (d_in, d_out), generator=gen,
                    device=device) * d_in ** -0.5
    p = {"kernel": w.to(dtype)}
    if bias:
        p["bias"] = torch.zeros(lead + (d_out,), dtype=dtype, device=device)
    return p


def trains(w) -> bool:
    """A weight leaf being trained: a tensor that requires grad (never a
    QuantizedTensor)."""
    return isinstance(w, torch.Tensor) and w.requires_grad


def col_input(x: torch.Tensor, cfg, *leaves) -> torch.Tensor:
    """The input of column-cut ``leaves`` that share it (q, k and v; the
    gate and up projections): on a training mesh rank, x through
    ``copy_to_model`` once for all of them (each rank's gradient of x
    covers only its own columns, so it is summed over "model"), else x."""
    if any(p.get("tp") == "col" and trains(p["kernel"]) for p in leaves):
        return cfg.shard.copy_to_model(x)
    return x


def linear(p, x: torch.Tensor, cfg=None) -> torch.Tensor:
    """y = x @ W (+ b); W may be dense or a QuantizedTensor (W4A16). The
    dense path accumulates in fp32 and returns the activation dtype; the
    bias is added in that dtype, as in the JAX package.

    On a mesh (``cfg.shard``, a ``runtime.sharding.Layout``) the leaf's
    ``"tp"`` mark says what the rank holds: ``"col"`` output features (no
    collective), ``"row"`` input features (the partial products are
    all-reduced over "model" in the activation dtype, before the bias),
    ``"gather"`` the whole weight behind an input that is sharded (x is
    all-gathered over "model" first). A weight that requires grad (a mesh
    rank training) goes through the Layout's autograd-aware forms of those
    collectives; a training ``"col"`` leaf's caller passes x through
    :func:`col_input` first."""
    w = p["kernel"]
    mode = p.get("tp")
    grad = trains(w)
    if mode == "gather":
        x = cfg.shard.gather_over_model(x) if grad \
            else cfg.shard.gather_model(x)
    if isinstance(w, QuantizedTensor):
        y = planning.matmul(x, w, cfg=cfg)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if mode == "row":
        y = cfg.shard.reduce_over_model(y) if grad \
            else cfg.shard.reduce_model(y)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


def pick_format(base, K: int):
    """The format a (K, N) weight quantizes to under ``base``: its group
    size, else the largest of 64 and 32 that divides K (hymba's d_model
    1600); None when K cannot be packed or grouped (the leaf stays
    dense)."""
    if base.pack_factor > 1 and K % 2:
        return None
    if base.scale_granularity != "group":
        return base
    for g in (base.group_size, 64, 32):
        if K % g == 0:
            return base.with_group_size(g)
    return None


def quantize_tree(params, *, format=None, group_size: Optional[int] = None,
                  symmetric: Optional[bool] = None, min_size: int = 1 << 16,
                  skip_names=("embed", "lm_head", "router", "bc_proj")):
    """Convert every eligible ``kernel`` leaf of two or more axes to a
    QuantizedTensor. Leading axes (stacked layers, MoE experts: an (L, E,
    K, N) stack) are quantized slice by slice, so scales are per (layer,
    expert, K group, N) and the stack stays one QuantizedTensor of packed
    shape (..., K/2, N). ``embed``, ``lm_head``, the MoE ``router`` and
    ``bc_proj`` stay dense, as in the JAX package; ``min_size`` is per
    matrix, not per stack."""
    base = quant.resolve_format(format)
    if group_size is not None:
        base = base.with_group_size(group_size)
    if symmetric is not None:
        base = base.with_symmetric(symmetric)

    def quantize_leaf(leaf: torch.Tensor):
        if leaf.dim() < 2 or leaf.dtype == torch.int8 \
                or leaf.shape[-2] * leaf.shape[-1] < min_size:
            return leaf
        fmt = pick_format(base, leaf.shape[-2])
        if fmt is None:
            return leaf
        if leaf.dim() == 2:
            return quantize(leaf, fmt, out_dtype=leaf.dtype)
        lead = leaf.shape[:-2]
        if leaf.is_meta:
            # shapes only (the dry run): one slice's layout, stacked
            q = quantize(leaf.reshape(-1, *leaf.shape[-2:])[0], fmt,
                         out_dtype=leaf.dtype)
            return QuantizedTensor(*(
                None if t is None else t.new_empty(lead + t.shape)
                for t in (q.packed, q.scales, q.zeros)),
                q.group_size, leaf.dtype, fmt)
        parts = [quantize(w, fmt, out_dtype=leaf.dtype)
                 for w in leaf.reshape(-1, *leaf.shape[-2:])]

        def stack(ts):
            t = torch.stack(ts)
            return t.reshape(*lead, *t.shape[1:])

        return QuantizedTensor(
            stack([q.packed for q in parts]), stack([q.scales for q in parts]),
            None if parts[0].zeros is None
            else stack([q.zeros for q in parts]),
            parts[0].group_size, leaf.dtype, fmt)

    def visit(tree, names):
        if isinstance(tree, Mapping):
            return {k: visit(v, names + (k,)) for k, v in tree.items()}
        if any(s in names for s in skip_names) or "kernel" not in names:
            return tree
        if not isinstance(tree, torch.Tensor):
            return tree
        return quantize_leaf(tree)

    return visit(params, ())


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it, ``logaddexp(x,
    0)``: ``F.softplus`` returns x itself above its threshold of 20."""
    return torch.logaddexp(x, x.new_zeros(()))


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.to(torch.float32)
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * p["scale"].to(torch.float32)).to(x.dtype)


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32: the centred input over its biased variance, then
    scale and bias."""
    h = x.to(torch.float32)
    mu = torch.mean(h, dim=-1, keepdim=True)
    var = torch.mean((h - mu) ** 2, dim=-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * p["scale"].to(torch.float32)
            + p["bias"].to(torch.float32)).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, in fp32; returns
    x's dtype."""
    return F.gelu(x.to(torch.float32), approximate="tanh").to(x.dtype)


def embed(p, tokens: torch.Tensor, cfg=None) -> torch.Tensor:
    """The rows of the table at ``tokens``. A vocab-sharded table (mark
    ``"vocab"``: the rank holds rows ``[r·V/tp, (r+1)·V/tp)``) looks up the
    ids it holds, zeros elsewhere, and all-reduces over "model" (one
    nonzero term per entry: exact; ``reduce_over_model`` when the table
    trains)."""
    if p.get("tp") != "vocab":
        return F.embedding(tokens.long(), p["table"])
    table = p["table"]
    ids = tokens.long() - cfg.shard.tp_rank * table.shape[0]
    held = (ids >= 0) & (ids < table.shape[0])
    rows = F.embedding(ids.clamp(0, table.shape[0] - 1), table)
    rows = torch.where(held[..., None], rows, torch.zeros_like(rows))
    return cfg.shard.reduce_over_model(rows) if trains(table) \
        else cfg.shard.reduce_model(rows)


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    """The tied head: fp32 logits ``x @ table.T``, the table in x's dtype
    (products of that dtype are exact in fp32)."""
    return torch.matmul(x.to(torch.float32),
                        p["table"].to(x.dtype).to(torch.float32).T)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S). Split-halves RoPE in fp32."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
