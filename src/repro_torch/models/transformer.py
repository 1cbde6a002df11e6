"""Every family of the JAX package — dense, moe, rwkv, hybrid and encdec —
with its layer variants: init, quantize, the training forward and loss,
the paged decode step, the chunked-prefill step, the batched speculative
verify step with its carry checkpoints, and the ring-cache prefill and
decode that a draft model runs on (port of ``repro/models/
transformer.py``). A moe layer holds ``"moe"`` (router and expert stacks,
``models/moe.py``) in place of ``"mlp"``; one FFN switch (:func:`_ffn`)
serves every step. An rwkv layer holds the time-mix and channel-mix
leaves of ``models/rwkv.py`` and no attention; a hybrid layer runs
attention and the selective SSM of ``models/ssm.py`` side by side on the
same input, then the MLP. An encdec (whisper) decoder layer adds
cross-attention (``"cross"``, after ``"norm3"``) to the encoder's output:
:func:`encode_cross_kv` runs the encoder over a request's audio frames
once and projects each decoder layer's cross K/V, which the steps read
from the state's per-slot ``enc_kv`` rows. Cross-attention is plain
PyTorch (``attention.chunked_attention``), as the JAX package leaves it to
XLA; cross q and K/V take no RoPE. A vision-prefix model (internvl2)
prepends a request's patch embeddings to its token embeddings: the engine
builds that stream, and the forward takes ``prefix_embeds``.

``cfg.mlp_type`` picks the SwiGLU MLP or the GELU one (tanh form, with
biases); ``cfg.norm_type`` RMSNorm or LayerNorm (eps 1e-5, with a bias);
``cfg.tie_embeddings`` the tied head (``layers.unembed``) in place of
``lm_head``.

Parameters keep the JAX package's tree: ``{"embed": {"table"},
"final_norm": {"scale"[, "bias"]}, "layers": {...stacked over L...},
"lm_head": {"kernel"}, "encoder": {"layers", "final_norm"}}`` (no
``lm_head`` when tied; ``encoder`` for encdec only). ``params["layers"]``
and the encoder's may also be lists of per-layer dicts
(:func:`unstack_layers`), which is what the serving engine holds so the
layer loop does no slicing per step. The step functions update the paged
KV pool and the recurrent carries (rwkv ``wkv``/``shift``/``cm_shift``,
hybrid ``ssm``, stacked over L with one row per slot) in place and return
the same state; the verify step alone leaves the carries as they are and
returns their checkpoints.

On a mesh (``cfg.shard``, ``runtime/sharding.py``) the params are a rank's
slice and ``cfg`` carries the rank's head counts (attention, rwkv's time
mix) and SSM channels (``ssm_inner``): the layers' collectives live in
``layers.linear``, ``layers.embed`` and :func:`_logits_head`, and the
decode and verify steps run this rank's data shard of the batch when
``Layout.rows`` gives one, gathering every shard's new K/V rows before the
paged write; the state's carries and ``enc_kv`` then hold that shard's
rows. hymba's ``h + 0.5 * (a + s_out)`` adds two outputs that are each
whole on every rank (each reduced over "model" by its row-cut leaf, or
computed whole).

The ring cache on a mesh (the ring engine's state, JAX's
``decode_state_shardings`` rule) holds a rank's rows of the batch and, where
the model axis divides the window W, its slice of the window for every KV
head (``Layout.ring_slice``): model rank r holds ring entries [r·W/tp,
(r+1)·W/tp). A rank's rows are its own, so no K/V row crosses "data". A
decode step all-gathers the new token's K/V of the rank's KV heads over
"model" (the rank that holds entry ``pos % W`` writes it), all-gathers q,
computes each head's online-softmax partials over its slice
(``attention.ring_partials``), all-gathers them over "model" and merges
them (``attention.combine_partials``), keeping its own heads' output for
the row-parallel ``wo``. With W whole, each rank writes every head and
attends its own heads over the whole window. The whole-prompt prefill
gathers each layer's K/V heads the same way and each rank keeps its
slice. This is sequence-parallel decode attention written by hand: the
one place where the port departs from JAX's program rather than its
specs, since GSPMD inserts these collectives for JAX.

A rank may hold its leaves as shares over "data" (``Layout.held`` set:
JAX's ``fsdp_serve`` in serving, ZeRO-3 in training; ``runtime/
sharding.py``). Every layer loop then gathers a layer's leaves right
before the layer runs (:func:`gathered`; under ``cfg.remat`` inside the
checkpointed function, so the recompute gathers again and no gathered
layer is kept for the backward, as ``jax.checkpoint`` around JAX's scan
body), and each step gathers the leaves outside the layer stacks once: a
training forward all of them at its start, a serving step the embedding
just before it embeds and the final norm and head just before the logits
(so neither is held through the layers).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import quant
from repro_torch.core.quant import (
    DEFAULT_KV_FORMAT, QuantizedTensor, get_kv_format, kv_dequantize,
    kv_quantize,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention, layers, moe, rwkv, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime import kvcache as kvc


# Families whose decode state carries per-slot recurrent leaves, which
# chunked prefill threads through and the verify step checkpoints per
# position (a draft model of such a family cannot rewind rejected drafts).
CARRY_FAMILIES = ("rwkv", "hybrid")
CARRY_LEAVES = ("wkv", "shift", "cm_shift", "ssm")
FAMILIES = ("dense", "moe", "rwkv", "hybrid", "encdec")


def check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: unknown family {cfg.family!r}; the port runs the "
            f"dense, moe, rwkv, hybrid and encdec families")


# ---------------------------------------------------------------------------
# init / quantize
# ---------------------------------------------------------------------------

def _drawers(gen: torch.Generator, cfg: ModelConfig, device, keep):
    """The leaf drawers :func:`init_params` and
    :func:`init_serving_params` share: ``lin(d_in, d_out, n, path,
    bias)`` (a linear dict stacked over ``n`` layers, or one layer's with
    ``n`` None, through ``keep(path, p)`` as soon as it is drawn),
    ``norm(*lead)``, ``attn(n, pre)`` and ``mlp(n, pre)``."""
    d, ff = cfg.d_model, cfg.d_ff

    def lin(d_in, d_out, n, path, bias=False):
        return keep(path, layers.init_linear(
            gen, d_in, d_out, cfg.dtype, device=device, layers=n, bias=bias))

    def norm(*lead):
        p = {"scale": torch.ones(lead + (d,), dtype=cfg.dtype,
                                 device=device)}
        if cfg.norm_type == "layernorm":
            p["bias"] = torch.zeros(lead + (d,), dtype=cfg.dtype,
                                    device=device)
        return p

    def attn(n, pre):
        return {"wq": lin(d, cfg.q_dim, n, pre + ("wq",)),
                "wk": lin(d, cfg.kv_dim, n, pre + ("wk",)),
                "wv": lin(d, cfg.kv_dim, n, pre + ("wv",)),
                "wo": lin(cfg.q_dim, d, n, pre + ("wo",))}

    def mlp(n, pre):
        if cfg.mlp_type == "swiglu":
            return {"w_gate": lin(d, ff, n, pre + ("w_gate",)),
                    "w_up": lin(d, ff, n, pre + ("w_up",)),
                    "w_down": lin(ff, d, n, pre + ("w_down",))}
        return {"w_up": lin(d, ff, n, pre + ("w_up",), bias=True),
                "w_down": lin(ff, d, n, pre + ("w_down",), bias=True)}

    return lin, norm, attn, mlp


def _decoder_layers(gen: torch.Generator, cfg: ModelConfig, n, *, device,
                    keep, cut):
    """The decoder layers' leaves in :func:`init_params`'s order of draws:
    stacked over ``n`` layers, or one layer's (``n`` None)."""
    d, ff = cfg.d_model, cfg.d_ff
    lead = () if n is None else (n,)
    _, norm, attn, mlp = _drawers(gen, cfg, device, keep)
    stack = {"norm1": norm(*lead), "norm2": norm(*lead)}
    if cfg.family == "rwkv":
        stack.update(rwkv.init_rwkv_block(gen, d, ff, cfg.num_heads,
                                          cfg.dtype, device=device,
                                          stacked=n, cut=cut))
    else:
        stack["attn"] = attn(n, ("layers", "attn"))
    if cfg.family == "moe":
        stack["moe"] = moe.init_moe(gen, d, ff, cfg.num_experts, cfg.dtype,
                                    device=device, stacked=n, cut=keep)
    elif cfg.family in ("dense", "hybrid", "encdec"):
        stack["mlp"] = mlp(n, ("layers", "mlp"))
    if cfg.family == "hybrid":
        stack["ssm"] = ssm.init_ssm(gen, d, cfg.d_inner, cfg.ssm_state,
                                    cfg.dtype, device=device, stacked=n,
                                    cut=cut)
    if cfg.family == "encdec":
        stack["cross"] = attn(n, ("layers", "cross"))
        stack["norm3"] = norm(*lead)
    return stack


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device=None,
                cut=None):
    """Random parameters drawn from ``gen`` (stacked over L), created in
    ``cfg.dtype`` on ``device`` (rwkv's ``w_bias`` and the SSM's ``A_log``
    and ``D`` in fp32): each layer holds attention (not rwkv), then the
    ``mlp`` (dense, hybrid, encdec) or the router and expert stacks of
    ``moe``, rwkv's time-mix and channel-mix leaves, hybrid's ``ssm``, or
    encdec's ``cross`` attention and ``norm3``; encdec adds the encoder's
    layers (attention and the MLP) and its final norm. LayerNorms and the
    GELU MLP's biases start at zero, as in the JAX package.

    ``cut(path, p)`` (a ``runtime.sharding.Layout.cut``) replaces each
    linear or embedding dict, and each bare tensor that follows a cut
    leaf's columns (rwkv's ``w_bias``, the SSM's ``A_log`` and ``D``),
    right after it is drawn, before the next is: a rank of a mesh then
    never holds more than one whole leaf, and ``gen`` is consumed as
    without it."""
    check_family(cfg)
    L, d, V = cfg.num_layers, cfg.d_model, cfg.padded_vocab
    keep = cut or (lambda path, p: p)
    lin, norm, attn, mlp = _drawers(gen, cfg, device, keep)

    table = torch.randn(V, d, generator=gen, device=device) * 0.02
    embed = keep(("embed",), {"table": table.to(cfg.dtype)})
    del table
    stack = _decoder_layers(gen, cfg, L, device=device, keep=keep, cut=cut)
    params = {"embed": embed, "final_norm": norm(), "layers": stack}
    if cfg.family == "encdec":
        E = cfg.encoder_layers
        params["encoder"] = {
            "layers": {"norm1": norm(E), "norm2": norm(E),
                       "attn": attn(E, ("encoder", "attn")),
                       "mlp": mlp(E, ("encoder", "mlp"))},
            "final_norm": norm()}
    if not cfg.tie_embeddings:
        params["lm_head"] = lin(d, V, None, ("lm_head",))
    return params


# the families the streamed build covers (the others fit one card whole)
STREAMED_FAMILIES = ("dense", "moe")


def check_streamed(cfg: ModelConfig) -> None:
    """Refuse a family :func:`init_serving_params` does not cover."""
    check_family(cfg)
    if cfg.family not in STREAMED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the streamed build covers the "
            f"{' and '.join(STREAMED_FAMILIES)} families, not "
            f"{cfg.family!r}; build it whole (init_params, quantize_params)")


def init_serving_params(gen: torch.Generator, cfg: ModelConfig, *,
                        device=None, quantize: bool = True):
    """The serving tree built layer by layer, for a model whose stacked
    dense tree would not fit the device beside its quantization. The
    embedding and ``lm_head`` are drawn first, then each layer's leaves in
    :func:`init_params`'s order inside a layer; each linear leaf is
    quantized as the serve launcher's :func:`quantize_params` would
    quantize it (``cfg.quant_format``, ``min_size=0``; the embedding, the
    head and the MoE router stay dense) the moment it is drawn, so the device holds the packed tree so far
    and one leaf's fp32 draw or its quantization's temporaries
    (:func:`serving_build_bytes`). ``quantize=False`` returns the dense
    tree of the same draws.

    ``layers`` is a list of per-layer dicts (:func:`unstack_layers`'s
    form). The random stream is its own: per-layer draws do not reproduce
    :func:`init_params`'s whole-stack ones. Dense and MoE families only
    (:data:`STREAMED_FAMILIES`)."""
    check_streamed(cfg)
    fmt = serve_format(cfg).name

    def keep(path, p):
        if not quantize:
            return p
        return layers.quantize_tree(p, format=fmt, min_size=0, prefix=path)

    d, V = cfg.d_model, cfg.padded_vocab
    lin, norm, _, _ = _drawers(gen, cfg, device, keep)
    table = torch.randn(V, d, generator=gen, device=device) * 0.02
    params = {"embed": {"table": table.to(cfg.dtype)}, "final_norm": norm()}
    del table
    if not cfg.tie_embeddings:
        params["lm_head"] = lin(d, V, None, ("lm_head",))
    params["layers"] = [
        _decoder_layers(gen, cfg, None, device=device, keep=keep, cut=None)
        for _ in range(cfg.num_layers)]
    return params


@dataclasses.dataclass(frozen=True)
class BuildBytes:
    """Device bytes of building a serving tree (:func:`serving_build_bytes`):
    ``dense`` the dense tree in ``cfg.dtype``, ``packed`` the serving tree
    (quantized leaves packed, the rest dense), ``whole`` the peak of
    :func:`init_params` then :func:`quantize_params`, ``streamed`` the
    peak of :func:`init_serving_params` (None outside
    :data:`STREAMED_FAMILIES`)."""
    dense: int
    packed: int
    whole: int
    streamed: Optional[int]


def _walk(tree, names=()):
    """(key path, leaf) in insertion order: the order :func:`init_params`
    draws the leaves and :func:`quantize_params` visits them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, names + (k,))
    else:
        yield names, tree


def _nbytes(leaf) -> int:
    if isinstance(leaf, QuantizedTensor):
        return leaf.nbytes_packed()
    return leaf.numel() * leaf.element_size()


def serving_build_bytes(cfg: ModelConfig, *,
                        quantize: bool = True) -> BuildBytes:
    """The two builds' peaks reckoned from the shapes alone (the tree on
    the meta device; nothing is drawn), with the transients of each step
    of a leaf's build:

    - a draw: ``randn`` in fp32 and its scaled copy, 8 bytes an element
      (the fp32 copy and its cast then hold 6);
    - a quantization (``core.quant.quantize``) of one (K, N) matrix: its
      fp32 copy (for a narrower leaf), the scaled and rounded fp32 copies
      and the clamp's copy beside the int8 values, 13 bytes an element
      (9 for an fp32 leaf), and two fp32 arrays of group scales; a
      stack's slices are packed one by one, then stacked: the stack's
      packed bytes twice.

    ``whole``: every dense leaf drawn (a leaf's draw on top of the leaves
    before it), then each leaf quantized while the dense tree is alive.
    ``streamed``: the embedding and the head, then each layer's leaves,
    each drawn and quantized on top of the packed leaves before it (the
    peak is the last layer's largest leaf)."""
    dense_tree = abstract_params(cfg)
    served = quantize_params(dense_tree, cfg, min_size=0) if quantize \
        else dense_tree
    leaves = [(names, w, q) for (names, w), (_, q)
              in zip(_walk(dense_tree), _walk(served))]

    def quant_temp(w, q, per):
        """A quantized unit's transient beyond its dense bytes: one
        (K, N) slice's temporaries on top of the slices packed before it,
        then the stack of a unit of several slices (its packed bytes
        twice)."""
        qb = _nbytes(q) // per
        k = w.shape[-2] * w.shape[-1]
        slices = w.numel() // per // k
        one = k * (9 + (4 if w.element_size() < 4 else 0)) \
            + 8 * k // q.group_size
        return max(qb - qb // slices + one, 2 * qb if slices > 1 else 0)

    live = peak = 0
    for names, w, _ in leaves:
        n = w.numel()
        drawn = names[-1] in ("kernel", "table")
        peak = max(peak, live + (8 * n if drawn else n * w.element_size()))
        live += n * w.element_size()
    dense = live
    for names, w, q in leaves:
        if isinstance(q, QuantizedTensor):
            peak = max(peak, live + quant_temp(w, q, 1))
            live += _nbytes(q)
    whole = peak
    packed = sum(_nbytes(q) for _, _, q in leaves)

    streamed = None
    if cfg.family in STREAMED_FAMILIES:
        L = cfg.num_layers
        top = [leaf for leaf in leaves if leaf[0][0] != "layers"]
        layer = [leaf for leaf in leaves if leaf[0][0] == "layers"]
        live = peak = 0
        for names, w, q, per in [(*leaf, 1) for leaf in top] \
                + [(*leaf, L) for leaf in layer] * L:
            n, b = w.numel() // per, w.element_size()
            drawn = names[-1] in ("kernel", "table")
            if isinstance(q, QuantizedTensor):
                temp = max(8 * n, n * b + quant_temp(w, q, per))
                kept = _nbytes(q) // per
            else:
                temp, kept = (8 * n if drawn else n * b), n * b
            peak = max(peak, live + temp)
            live += kept
        streamed = peak
    return BuildBytes(dense=dense, packed=packed, whole=whole,
                      streamed=streamed)


def abstract_params(cfg: ModelConfig):
    """The parameter tree of :func:`init_params` on the ``meta`` device:
    every leaf's shape and dtype, no storage and no random draw (the dry
    run's counterpart of JAX's ``jax.eval_shape(init_params)``).
    :func:`quantize_params` takes such a tree to the QuantizedTensor tree
    of meta tensors with the real one's packed and scale shapes."""
    return init_params(torch.Generator(), cfg, device="meta")


def serve_format(cfg: ModelConfig, format=None):
    """The format serving quantizes to: ``format`` (a registered name) or
    ``cfg.quant_format``, regrouped to ``cfg.group_size`` for the default
    format only."""
    fmt = quant.get_format(format or cfg.quant_format)
    if fmt.name == quant.DEFAULT_FORMAT:
        return fmt.with_group_size(cfg.group_size)
    return fmt


def quantize_params(params, cfg: ModelConfig, *, format=None,
                    min_size: int = 1 << 16):
    """Serve-time quantization (``cfg.quant_format``, the paper's W4A16 by
    default; ``cfg.group_size`` re-groups the default format only)."""
    return layers.quantize_tree(params, format=serve_format(cfg, format).name,
                                min_size=min_size)


def _layer_slice(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return tree.layer(i)
    if isinstance(tree, str):           # a mesh rank's "tp" mark
        return tree
    return tree[i]


def _unstack(stacked):
    if isinstance(stacked, list):
        return stacked
    L = stacked["norm1"]["scale"].shape[0]
    return [_layer_slice(stacked, i) for i in range(L)]


def unstack_layers(params) -> Dict[str, Any]:
    """``params`` with ``"layers"`` (and the encoder's) as lists of
    per-layer dicts (views of the stacked tensors)."""
    out = dict(params, layers=_unstack(params["layers"]))
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = dict(enc, layers=_unstack(enc["layers"]))
    return out


def _unbind_layers(stacked, L: int) -> List[Dict[str, Any]]:
    """Per-layer views of the stacked leaves for the training forward: one
    ``torch.unbind`` per leaf, so backward assembles each stacked leaf's
    gradient once from its L slices (indexing would build a full-size
    zero gradient for every layer)."""
    if isinstance(stacked, dict):
        parts = {k: _unbind_layers(v, L) for k, v in stacked.items()}
        return [{k: parts[k][i] for k in parts} for i in range(L)]
    if isinstance(stacked, QuantizedTensor):
        return [stacked.layer(i) for i in range(L)]
    if isinstance(stacked, str):        # a mesh rank's "tp" mark
        return [stacked] * L
    return list(torch.unbind(stacked))


def _layers(params) -> List[Dict[str, Any]]:
    return _unstack(params["layers"])


def gathered(cfg: ModelConfig, tree, prefix=()):
    """``tree`` (one layer's leaves at key path ``prefix`` of the stacked
    tree, or leaves outside the layer stacks) as this rank runs it: its
    data shares gathered into its TP slices where it holds shares
    (``cfg.shard.held``), else ``tree`` itself."""
    lay = cfg.shard
    if lay is None or lay.held is None:
        return tree
    return lay.held(tree, tuple(prefix))


def _gathered_top(params, cfg: ModelConfig):
    """``params`` with the leaves outside the layer stacks gathered
    (:func:`gathered`): the embedding, the final norms, ``lm_head``; the
    layer stacks as they are (the training forward's, once a
    microbatch)."""
    if cfg.shard is None or cfg.shard.held is None:
        return params
    out = dict(params, **gathered(cfg, {
        k: v for k, v in params.items() if k not in ("layers", "encoder")}))
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = dict(enc, **gathered(cfg, {
            k: v for k, v in enc.items() if k != "layers"}, ("encoder",)))
    return out


def _embed_table(params, cfg: ModelConfig):
    """``params["embed"]`` gathered (:func:`gathered`): a serving step's,
    just before it embeds."""
    return gathered(cfg, {"embed": params["embed"]})["embed"]


def _head_leaves(params, cfg: ModelConfig):
    """The final norm and the head's leaves (``lm_head``, or the tied
    embedding) gathered (:func:`gathered`): a serving step's, just before
    its logits."""
    keys = ("final_norm", "embed" if cfg.tie_embeddings else "lm_head")
    return gathered(cfg, {k: params[k] for k in keys})


def _layer_views(stacked) -> List[Dict[str, Any]]:
    """Per-layer views for the forward and the encoder:
    :func:`_unbind_layers` of a stacked tree (gradients assemble once per
    leaf), a list (the engine's unstacked params) as it is."""
    if isinstance(stacked, list):
        return stacked
    return _unbind_layers(stacked, stacked["norm1"]["scale"].shape[0])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, p, x):
    if cfg.norm_type == "layernorm":
        return layers.layernorm(p, x)
    return layers.rmsnorm(p, x)


def _mlp(p, cfg: ModelConfig, x):
    """The SwiGLU MLP, or the GELU one (``w_up``, GELU in fp32, ``w_down``;
    both with biases)."""
    if cfg.mlp_type == "swiglu":
        x = layers.col_input(x, cfg, p["w_gate"], p["w_up"])
        g = layers.linear(p["w_gate"], x, cfg)
        u = layers.linear(p["w_up"], x, cfg)
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
        return layers.linear(p["w_down"], h, cfg)
    x = layers.col_input(x, cfg, p["w_up"])
    h = layers.gelu(layers.linear(p["w_up"], x, cfg))
    return layers.linear(p["w_down"], h, cfg)


def _ffn(lp, cfg: ModelConfig, h, split: bool = False):
    """The post-attention FFN tail of every layer body (JAX's
    ``_ffn_seq``): h + FFN(norm2(h)), the FFN being the MLP or the MoE
    (every row of h routed; its aux loss dropped). On a mesh ``split``
    says h's rows are this rank's data shard of the step (the MoE routes
    them as one shard; a replicated step's tokens route in the data
    axis's shards)."""
    x = _norm(cfg, lp["norm2"], h)
    if cfg.family == "moe":
        shards = 1 if cfg.shard is None else cfg.shard.route_shards(
            x.numel() // x.shape[-1], split)
        y, _aux = moe.moe_ffn(
            lp["moe"], x, num_experts=cfg.num_experts,
            top_k=cfg.experts_per_token,
            capacity_factor=cfg.moe_capacity_factor, cfg=cfg,
            shards=shards)
        return h + y
    return h + _mlp(lp["mlp"], cfg, x)


def _attn_seq(p, cfg: ModelConfig, x, positions, *, causal=True,
              window=None, return_kv=False):
    """Self-attention over a whole sequence, causal (with the config's
    sliding window, or ``window``) or not (the encoder's): the
    flash-attention Function when ``cfg.attn_impl == "flash"``, else the
    plain chunked attention. ``return_kv`` also returns the roped (k, v)
    (ring-cache prefill)."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = layers.col_input(x, cfg, p["wq"], p["wk"], p["wv"])
    q = layers.linear(p["wq"], x, cfg).reshape(B, S, H, D)
    k = layers.linear(p["wk"], x, cfg).reshape(B, S, Hkv, D)
    v = layers.linear(p["wv"], x, cfg).reshape(B, S, Hkv, D)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    w = cfg.sliding_window if window is None else window
    if cfg.attn_impl == "flash":
        o = flash_attention(q, k, v, causal=causal, window=w)
    elif cfg.attn_impl == "chunked":
        o = attention.chunked_attention(q, k, v, causal=causal, window=w)
    else:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} "
                         f"(expected chunked | flash)")
    out = layers.linear(p["wo"], o.reshape(B, S, H * D), cfg)
    return (out, (k, v)) if return_kv else out


def _cross_attn_seq(p, cfg: ModelConfig, x, enc_kv):
    """Cross-attention of x (B, S, d) to the encoder's (k, v), each (B, T,
    Hkv, D): no RoPE, no mask, plain PyTorch."""
    B, S, _ = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    x = layers.col_input(x, cfg, p["wq"])
    q = layers.linear(p["wq"], x, cfg).reshape(B, S, H, D)
    k, v = enc_kv
    o = attention.chunked_attention(q, k, v, causal=False, window=0)
    return layers.linear(p["wo"], o.reshape(B, S, H * D), cfg)


def _cross(lp, cfg: ModelConfig, h, enc_kv):
    """h + the encdec layer's cross-attention block (norm3, then
    cross-attention); h as it is for the other families."""
    if cfg.family != "encdec":
        return h
    return h + _cross_attn_seq(lp["cross"], cfg, _norm(cfg, lp["norm3"], h),
                               enc_kv)


def _rwkv_layer(lp, cfg: ModelConfig, h, carry, *, valid=None,
                collect_states: bool = False):
    """One rwkv layer over (B, S) tokens from ``carry`` ({"wkv", "shift",
    "cm_shift"}, one row per h row; not written). ``valid`` (B, S) masks
    right-padded positions out of the carry. Returns (h, new carry) and,
    with ``collect_states``, the carry after each position: the post-mask
    wkv states and the x1/x2 rows that the decode step latches as
    ``shift`` and ``cm_shift`` (each (B, S, ...))."""
    x1 = _norm(cfg, lp["norm1"], h)
    res = rwkv.time_mix_seq(lp, x1, carry, num_heads=cfg.num_heads,
                            cfg=cfg, valid=valid,
                            collect_states=collect_states)
    h = h + res[0]
    x2 = _norm(cfg, lp["norm2"], h)
    prev = torch.cat([carry["cm_shift"].to(x2.dtype)[:, None], x2[:, :-1]],
                     1)
    h = h + rwkv.channel_mix(lp, x2, prev, cfg)
    if valid is None:
        cm = x2[:, -1].to(torch.float32)
    else:
        cm = torch.where(valid.any(1)[:, None],
                         _last_valid_row(x2, valid).to(torch.float32),
                         carry["cm_shift"])
    new = dict(res[1], cm_shift=cm)
    if collect_states:
        return h, new, {"wkv": res[2], "shift": x1.to(torch.float32),
                        "cm_shift": x2.to(torch.float32)}
    return h, new


def _layer_seq(p, cfg: ModelConfig, h, positions, enc_kv=None,
               split=False):
    """One decoder layer in sequence mode, every carry starting at zero,
    its leaves gathered first (:func:`gathered`); ``enc_kv`` this layer's
    cross K/V (encdec), or the encoder's output, projected here, where
    the rank holds shares; ``split`` as :func:`_ffn`'s."""
    p = gathered(cfg, p, ("layers",))
    if isinstance(enc_kv, torch.Tensor):
        enc_kv = _cross_kv(p, cfg, enc_kv)
    B = h.shape[0]
    if cfg.family == "rwkv":
        carry = rwkv.rwkv_state_init(B, cfg.d_model, cfg.num_heads,
                                     cfg.head_dim, device=h.device)
        return _rwkv_layer(p, cfg, h, carry)[0]
    x1 = _norm(cfg, p["norm1"], h)
    a = _attn_seq(p["attn"], cfg, x1, positions)
    if cfg.family == "hybrid":
        s0 = ssm.ssm_state_init(B, cfg.d_inner, cfg.ssm_state,
                                device=h.device)
        s_out, _ = ssm.ssm_seq(p["ssm"], x1, s0, cfg)
        return _ffn(p, cfg, h + 0.5 * (a + s_out))
    return _ffn(p, cfg, _cross(p, cfg, h + a, enc_kv), split)


def _enc_layer(lp, cfg: ModelConfig, h, positions):
    lp = gathered(cfg, lp, ("encoder", "layers"))
    x1 = _norm(cfg, lp["norm1"], h)
    h = h + _attn_seq(lp["attn"], cfg, x1, positions, causal=False, window=0)
    return h + _mlp(lp["mlp"], cfg, _norm(cfg, lp["norm2"], h))


def _encoder_forward(params, cfg: ModelConfig, audio_embeds):
    """The whisper-style encoder over frame embeddings (B, T, d): RoPE at
    frame positions 0..T-1, non-causal self-attention with no window (the
    flash kernel when ``cfg.attn_impl == "flash"``), the MLP, then the
    encoder's final norm. Each layer runs under ``torch.utils.checkpoint``
    with ``cfg.remat``."""
    enc = params["encoder"]
    h = audio_embeds.to(cfg.dtype)
    B, T, _ = h.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=h.device).expand(B, T)
    for lp in _layer_views(enc["layers"]):
        if cfg.remat:
            h = checkpoint(_enc_layer, lp, cfg, h, positions,
                           use_reentrant=False)
        else:
            h = _enc_layer(lp, cfg, h, positions)
    return _norm(cfg, enc["final_norm"], h)


def _cross_kv(lp, cfg: ModelConfig, enc_out):
    """One decoder layer's cross K/V, each (B, T, Hkv, D), from the
    encoder's output."""
    B, T, _ = enc_out.shape
    shape = (B, T, cfg.num_kv_heads, cfg.head_dim)
    p = lp["cross"]
    enc_out = layers.col_input(enc_out, cfg, p["wk"], p["wv"])
    return (layers.linear(p["wk"], enc_out, cfg).reshape(shape),
            layers.linear(p["wv"], enc_out, cfg).reshape(shape))


def encode_cross_kv(params, cfg: ModelConfig, audio_embeds):
    """The encoder forward, then every decoder layer's cross K/V: audio
    (B, T, d) → two (L, B, T, Hkv, D) stacks. The serving engine runs it
    once a request at admit and writes the slot's rows of the state's
    ``enc_kv``; the forward consumes it inline."""
    enc_out = _encoder_forward(params, cfg, audio_embeds)
    kv = [_cross_kv(gathered(cfg, {"cross": lp["cross"]}, ("layers",)), cfg,
                    enc_out) for lp in _layers(params)]
    return (torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv]))


def _embed_stream(table, cfg: ModelConfig, tokens, prefix_embeds):
    """Token embeddings (``table`` the embedding's dict), after the
    vision-prefix embeds when given."""
    h = layers.embed(table, tokens, cfg)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    return h


def _check_audio(cfg: ModelConfig, audio_embeds) -> None:
    if cfg.family == "encdec" and audio_embeds is None:
        raise ValueError(f"{cfg.name}: an encdec forward needs the audio "
                         f"frames (audio_embeds)")


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            prefix_embeds=None, audio_embeds=None,
            split: bool = False) -> torch.Tensor:
    """tokens (B, S_text) → logits (B, S_total, padded_vocab) fp32.
    ``prefix_embeds`` (B, P, d): vision patches prepended to the token
    embeddings (S_total = P + S_text); ``audio_embeds`` (B, T, d): the
    encdec family's audio frames. RoPE positions are ``arange(S_total)``
    for every row. With ``cfg.remat`` each layer runs under
    ``torch.utils.checkpoint`` (recomputed in backward), the counterpart of
    ``jax.checkpoint`` around the JAX layer scan. Gradients reach the
    stacked ``layers`` leaves through the per-layer views. On a mesh
    ``split`` says the rows are this rank's data shard of the batch (a
    training rank's microbatch rows; MoE routes them as one shard)."""
    check_family(cfg)
    _check_audio(cfg, audio_embeds)
    params = _gathered_top(params, cfg)
    h = _embed_stream(params["embed"], cfg, tokens, prefix_embeds)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    lps = _layer_views(params["layers"])
    enc_out = None if cfg.family != "encdec" \
        else _encoder_forward(params, cfg, audio_embeds)
    # a rank holding shares projects a layer's cross K/V inside the layer
    # (its leaves are gathered there)
    held = cfg.shard is not None and cfg.shard.held is not None
    for lp in lps:
        ekv = enc_out if enc_out is None or held \
            else _cross_kv(lp, cfg, enc_out)
        if cfg.remat:
            h = checkpoint(_layer_seq, lp, cfg, h, positions, ekv, split,
                           use_reentrant=False)
        else:
            h = _layer_seq(lp, cfg, h, positions, ekv, split)
    h = _norm(cfg, params["final_norm"], h)
    return _logits_head(params, cfg, h)


def loss_fn(params, cfg: ModelConfig, batch, *, count=None,
            split: bool = False) -> torch.Tensor:
    """Next-token cross entropy over the padded vocabulary (log-softmax in
    fp32); labels < 0 are masked. batch: {tokens, labels, [vision_embeds],
    [audio_embeds]}; the vision prefix's positions carry no label and are
    dropped. The masked sum is divided by the unmasked labels' ``count``
    when given (a mesh rank's rows: the count over every data rank's rows
    of the microbatch, so the ranks' losses sum to the microbatch's mean),
    else by this batch's own count. ``split`` as :func:`forward`'s."""
    logits = forward(params, cfg, batch["tokens"],
                     prefix_embeds=batch.get("vision_embeds"),
                     audio_embeds=batch.get("audio_embeds"), split=split)
    labels = batch["labels"].long()
    P = logits.shape[1] - labels.shape[1]
    if P > 0:
        logits = logits[:, P:]
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    if count is None:
        count = mask.sum()
    return -(ll * mask).sum() / torch.clamp_min(count, 1.0)


def _logits_head(params, cfg: ModelConfig, h):
    """The tied head (``layers.unembed``, fp32) or the dense (unquantized)
    ``lm_head``, whose activation-dtype product is returned as fp32
    logits. A vocab-sharded head's logits are all-gathered over "model"
    (before any argmax); when the head trains, through the autograd-aware
    gather, and the tied head's input through ``copy_to_model``."""
    if cfg.tie_embeddings:
        p = params["embed"]
        sharded = p.get("tp") == "vocab"
        grad = sharded and layers.trains(p["table"])
        logits = layers.unembed(p, cfg.shard.copy_to_model(h) if grad
                                else h)
    else:
        p = params["lm_head"]
        sharded = p.get("tp") == "col"
        grad = sharded and layers.trains(p["kernel"])
        logits = layers.linear(p, layers.col_input(h, cfg, p),
                               cfg).to(torch.float32)
    if not sharded:
        return logits
    return cfg.shard.gather_over_model(logits) if grad \
        else cfg.shard.gather_model(logits)


def _last_valid_row(h, valid):
    """h: (B, C, ...); valid (B, C) bool, True on a right-padded row's
    leading positions → (B, ...) at the last valid position (position 0
    for fully padded rows)."""
    last = (valid.to(torch.int32).sum(dim=1) - 1).clamp_min(0)
    return h[torch.arange(h.shape[0], device=h.device), last]


def _commit(dst: torch.Tensor, new: torch.Tensor, active) -> None:
    """Write a carry leaf's new rows into ``dst`` in place, keeping the
    rows whose ``active`` (B,) entry is False (None: every row)."""
    if active is not None:
        new = torch.where(active.reshape(-1, *(1,) * (new.dim() - 1)), new,
                          dst)
    dst.copy_(new)


def _carry_rows(cache, i: int, rows=slice(None)):
    """Layer ``i``'s recurrent carry leaves (views), the batch rows
    ``rows`` of each."""
    return {k: cache[k][i, rows] for k in CARRY_LEAVES if k in cache}


def _mine(t, rows):
    """``t``'s rows that this rank runs (all of them when ``rows`` is
    None)."""
    return t if rows is None else t[rows]


def _attn_step(ap, cfg: ModelConfig, x, kv_all, i: int, pos, tables, *,
               cache_len: int, fmt, attn_path: str, kv_partitions,
               live_pages, rows=None):
    """Decode self-attention of one layer for one token a row: insert the
    token's K/V (into the paged pool, or the ring when ``tables`` is
    None), then attend (insert before attend). ``pos`` and ``tables``
    cover the step's whole batch; on a mesh whose data axis splits it, x
    holds this rank's ``rows``, and the new K/V rows of every data rank
    are gathered before the insert so that each replica's pool stays
    whole."""
    B = x.shape[0]
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mpos = _mine(pos, rows)
    q = layers.linear(ap["wq"], x, cfg).reshape(B, H, D)
    k = layers.linear(ap["wk"], x, cfg).reshape(B, Hkv, D)
    v = layers.linear(ap["wv"], x, cfg).reshape(B, Hkv, D)
    q = layers.apply_rope(q[:, None], mpos[:, None], cfg.rope_theta)[:, 0]
    k = layers.apply_rope(k[:, None], mpos[:, None], cfg.rope_theta)[:, 0]
    if tables is None and cfg.shard is not None:
        o = _mesh_ring_attn(cfg, q, k, v, _ring_layer(kv_all, i), mpos,
                            cache_len)
    elif tables is None:
        ring = _ring_layer(kv_all, i)
        attention.cache_insert(ring, k, v, mpos)
        o = attention.decode_attention(q, ring, mpos,
                                       window=cfg.sliding_window)
    else:
        pool = kv_all.layer(i)
        if rows is not None:
            k, v = cfg.shard.gather_rows(k, rows), \
                cfg.shard.gather_rows(v, rows)
        kvc.paged_insert(pool, tables, k, v, pos, cache_len=cache_len,
                         fmt=fmt)
        o = kvc.paged_decode_attention(
            q, pool, _mine(tables, rows), mpos, window=cfg.sliding_window,
            fmt=fmt, out_dtype=cfg.dtype, attn_path=attn_path,
            kv_partitions=kv_partitions, live_pages=live_pages)
    return layers.linear(ap["wo"], o.reshape(B, H * D), cfg)


def _mesh_ring_attn(cfg: ModelConfig, q, k, v, ring: attention.KVCache,
                    pos, W: int):
    """One layer's ring decode attention on a mesh rank (see the module's
    docstring): q (B, H, D) and k, v (B, Hkv, D) at this rank's heads and
    rows; ``ring`` its rows of the layer's ring (every KV head, its slice
    of the ``W``-entry window). Returns the rank's heads' output (B, H,
    D)."""
    lay = cfg.shard
    if W <= 0:
        raise ValueError("a ring decode step on a mesh needs the ring's "
                         "window (cache_len)")
    k = lay.gather_heads(k, 1, kv=True)
    v = lay.gather_heads(v, 1, kv=True)
    if not lay.ring_cut(W):
        attention.cache_insert(ring, k, v, pos)
        heads = lay.kv_heads()
        mine = attention.KVCache(ring.k[:, :, heads], ring.v[:, :, heads],
                                 ring.pos)
        return attention.decode_attention(q, mine, pos,
                                          window=cfg.sliding_window)
    part = lay.ring_slice(W)
    attention.cache_insert(ring, k, v, pos, ring_len=W, start=part.start)
    acc, m, l = attention.ring_partials(
        lay.gather_heads(q, 1), ring, pos, window=cfg.sliding_window)
    H = acc.shape[1]
    parts = lay.gather_model(torch.cat([acc, m[..., None], l[..., None]],
                                       -1)[None], 0)
    o = attention.combine_partials(parts[..., :-2], parts[..., -2],
                                   parts[..., -1])
    if lay.attn_sharded:
        n = H // lay.tp
        o = o[:, lay.tp_rank * n:(lay.tp_rank + 1) * n]
    return o.to(q.dtype)


def decode_step(params, cfg: ModelConfig, state, tokens: torch.Tensor,
                pos: torch.Tensor, *, tables=None, cache_len: int = 0,
                kv_format: str = DEFAULT_KV_FORMAT,
                attn_path: str = "gather", kv_partitions=None,
                live_pages=None, active=None):
    """One decode step. tokens/pos: (B,). With ``tables`` (B,
    pages_per_slot) the state is the paged pool (-1 rows are inactive:
    their writes go to the null block); with ``tables=None`` it is the
    per-slot ring cache of :func:`init_decode_state` (the ring engine's,
    the draft model's, and rwkv's carry-only state; on a mesh
    ``cache_len`` is the ring's whole window). ``active`` (B,) bool keeps
    the recurrent carries of rows that are not decoding (a slot mid
    chunked prefill shares the batch; its carry would be advanced by the
    dummy token). An encdec layer's cross-attention reads the state's
    ``enc_kv`` rows.
    On a mesh whose data axis divides B this rank runs its rows of the
    batch (``Layout.rows``) and returns their logits; the state's carries
    and ``enc_kv`` then hold those rows only.
    Returns (logits (B, V) fp32, state)."""
    check_family(cfg)
    fmt = get_kv_format(kv_format)
    rows = None if cfg.shard is None else cfg.shard.rows(tokens.shape[0])
    h = layers.embed(_embed_table(params, cfg), _mine(tokens, rows),
                     cfg)                                          # (B, d)
    active = None if active is None else _mine(active, rows)
    cache = state["cache"]
    for i, lp in enumerate(_layers(params)):
        lp = gathered(cfg, lp, ("layers",))
        if cfg.family == "rwkv":
            x1 = _norm(cfg, lp["norm1"], h)
            tm, st = rwkv.time_mix_step(
                lp, x1, _carry_rows(cache, i), num_heads=cfg.num_heads,
                cfg=cfg)
            h = h + tm
            x2 = _norm(cfg, lp["norm2"], h)
            h = h + rwkv.channel_mix(lp, x2, cache["cm_shift"][i], cfg)
            st["cm_shift"] = x2.to(torch.float32)
            for k, new in st.items():
                _commit(cache[k][i], new, active)
            continue
        x = _norm(cfg, lp["norm1"], h)
        a = _attn_step(lp["attn"], cfg, x, cache["kv"], i, pos, tables,
                       cache_len=cache_len, fmt=fmt, attn_path=attn_path,
                       kv_partitions=kv_partitions, live_pages=live_pages,
                       rows=rows)
        if cfg.family == "hybrid":
            s_out, s_new = ssm.ssm_step(lp["ssm"], x, cache["ssm"][i], cfg)
            _commit(cache["ssm"][i], s_new, active)
            h = h + 0.5 * (a + s_out)
        else:
            h = _cross(lp, cfg, (h + a)[:, None], _enc_rows(state, i))[:, 0]
        h = _ffn(lp, cfg, h, split=rows is not None)
    top = _head_leaves(params, cfg)
    h = _norm(cfg, top["final_norm"], h)
    return _logits_head(top, cfg, h), state


def _enc_rows(state, i: int, rows=slice(None)):
    """Layer ``i``'s cross K/V (views of the state's ``enc_kv``), the
    batch rows ``rows`` of each; None without ``enc_kv``."""
    enc = state.get("enc_kv")
    if enc is None:
        return None
    return enc[0][i, rows], enc[1][i, rows]


def _paged_chunk_attn(ap, cfg: ModelConfig, x1, pool, tables, positions,
                      safe_pos, *, fmt, cache_len: int,
                      attn_path: str = "gather", kv_partitions=None,
                      live_pages=None, rows=None):
    """Self-attention for (B, C) chunks over the paged pool: one slot's
    prefill chunk (B = 1), or every slot's verify window, written with
    :func:`kvcache.scatter_chunks`. Each row attends the
    pool entries below its own first position. The window is read BEFORE
    the chunk is scattered (when the stream wraps, the chunk overwrites
    in-window entries its earliest queries still attend); the chunk's own
    K/V join as a segment after the same quantize round-trip their stored
    copy takes. On a mesh whose data axis splits the verify batch, x1
    holds this rank's ``rows`` (``tables`` and ``positions`` cover every
    row) and every data rank's K/V rows are gathered before the
    scatter."""
    B, C, _ = x1.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    all_tables, all_positions = tables, positions
    tables, positions = _mine(tables, rows), _mine(positions, rows)
    safe_pos = _mine(safe_pos, rows)
    q = layers.linear(ap["wq"], x1, cfg).reshape(B, C, H, D)
    k = layers.linear(ap["wk"], x1, cfg).reshape(B, C, Hkv, D)
    v = layers.linear(ap["wv"], x1, cfg).reshape(B, C, Hkv, D)
    q = layers.apply_rope(q, safe_pos, cfg.rope_theta)
    k = layers.apply_rope(k, safe_pos, cfg.rope_theta)
    kr = kv_dequantize(*kv_quantize(k, fmt), fmt=fmt, dtype=cfg.dtype)
    vr = kv_dequantize(*kv_quantize(v, fmt), fmt=fmt, dtype=cfg.dtype)
    if attn_path == "fused":
        from repro_torch.kernels.paged_attention import fused_chunk_attention

        o = fused_chunk_attention(
            q, kr, vr, pool, tables, positions, window=cfg.sliding_window,
            fmt=fmt, out_dtype=cfg.dtype, kv_partitions=kv_partitions)
    elif attn_path == "gather":
        win = kvc.gather_window(pool, tables, fmt=fmt, out_dtype=cfg.dtype,
                                live_pages=live_pages)
        start = positions[:, :1]
        wpos = torch.where(win.pos < start, win.pos,
                           torch.full_like(win.pos, -1))
        seq = attention.KVCache(
            k=torch.cat([win.k, kr.to(win.k.dtype)], dim=1),
            v=torch.cat([win.v, vr.to(win.v.dtype)], dim=1),
            pos=torch.cat([wpos, positions.to(wpos.dtype)], dim=1))
        o = attention.prefix_chunk_attention(q, seq, positions,
                                             window=cfg.sliding_window)
    else:
        raise ValueError(f"unknown attn_path {attn_path!r} "
                         f"(expected gather | fused)")
    if rows is not None:
        k, v = cfg.shard.gather_rows(k, rows), cfg.shard.gather_rows(v, rows)
    kvc.scatter_chunks(pool, all_tables, k, v, all_positions,
                       cache_len=cache_len, fmt=fmt)
    return layers.linear(ap["wo"], o.reshape(B, C, H * D), cfg)


def prefill_chunk_step(params, cfg: ModelConfig, state, h: torch.Tensor,
                       positions: torch.Tensor, table=None, slot=None, *,
                       cache_len: int, kv_format: str = DEFAULT_KV_FORMAT,
                       attn_path: str = "gather", kv_partitions=None,
                       live_pages=None):
    """One chunked-prefill step for one slot. h: (1, C, d) embedding chunk;
    positions: (1, C) absolute, -1 = padding in the final chunk; table:
    (1, T) the slot's block table (None for attention-free rwkv); slot:
    the slot's row of the recurrent carries (rwkv, hybrid), which step
    their masked recurrences so that a right-padded final chunk leaves
    the carry at the last real token, and of encdec's cross K/V. Returns
    (last-valid-position logits (1, V) fp32, state)."""
    check_family(cfg)
    if (cfg.family in CARRY_FAMILIES or cfg.family == "encdec") \
            and slot is None:
        raise ValueError(f"a {cfg.family!r} prefill chunk needs the slot "
                         f"whose per-slot state it reads")
    fmt = get_kv_format(kv_format)
    valid = positions >= 0
    safe_pos = positions.clamp_min(0)
    cache = state["cache"]
    rows = slice(slot, None if slot is None else slot + 1)
    for i, lp in enumerate(_layers(params)):
        lp = gathered(cfg, lp, ("layers",))
        carry = _carry_rows(cache, i, rows)
        if cfg.family == "rwkv":
            h, new = _rwkv_layer(lp, cfg, h, carry, valid=valid)
            for k, t in new.items():
                carry[k].copy_(t)
            continue
        x1 = _norm(cfg, lp["norm1"], h)
        a = _paged_chunk_attn(
            lp["attn"], cfg, x1, cache["kv"].layer(i), table, positions,
            safe_pos, fmt=fmt, cache_len=cache_len, attn_path=attn_path,
            kv_partitions=kv_partitions, live_pages=live_pages)
        if cfg.family == "hybrid":
            s_out, s_fin = ssm.ssm_seq(lp["ssm"], x1, carry["ssm"], cfg,
                                       valid=valid)
            carry["ssm"].copy_(s_fin)
            h = _ffn(lp, cfg, h + 0.5 * (a + s_out))
        else:
            h = _ffn(lp, cfg, _cross(lp, cfg, h + a,
                                     _enc_rows(state, i, rows)))
    top = _head_leaves(params, cfg)
    h = _norm(cfg, top["final_norm"], h)
    return _logits_head(top, cfg, _last_valid_row(h, valid)), state


def verify_step(params, cfg: ModelConfig, state, tokens: torch.Tensor,
                positions: torch.Tensor, tables=None, *,
                cache_len: int, kv_format: str = DEFAULT_KV_FORMAT,
                attn_path: str = "gather", kv_partitions=None,
                live_pages=None):
    """Batched speculative-verify step (a moe layer routes all B·C rows
    together).

    tokens: (B, C) — per slot, the last emitted token followed by up to
    C-1 drafts; positions: (B, C) absolute, -1 = padding (short proposals,
    inactive rows, whose tables are -1 too); tables: (B, T) (None for
    attention-free rwkv). One forward pass scores every position of every
    slot with the chunked-prefill math, each row attending the pool below
    its ``positions[:, 0]``, then scatters the window's K/V. Rejected
    drafts leave stale pool entries above a slot's accepted frontier;
    their tags exceed every later query position until the next window
    overwrites them, so the masks keep them invisible (the engine rolls
    pages back at the allocator).

    A recurrence cannot be rolled back by masking, so the carries of the
    rwkv and hybrid families are checkpointed: per leaf, C+1 snapshots
    along a new axis 2 (index 0 the incoming carry, index n the carry after
    n consumed positions; rwkv's shift/cm_shift checkpoints are the x1/x2
    rows the decode step would have latched). The state's own carries are
    returned unchanged: the engine writes back checkpoint ``1 + accepted``
    per row (0 for inactive rows). Returns (logits (B, C, V) fp32, state,
    the checkpoints or None)."""
    check_family(cfg)
    fmt = get_kv_format(kv_format)
    rows = None if cfg.shard is None else cfg.shard.rows(tokens.shape[0])
    h = layers.embed(_embed_table(params, cfg),
                     _mine(tokens, rows).clamp_min(0), cfg)  # (B, C, d)
    B, C, _ = h.shape
    valid = _mine(positions, rows) >= 0
    safe_pos = positions.clamp_min(0)
    cache = state["cache"]
    carries = {k: torch.empty((v.shape[0], B, C + 1, *v.shape[2:]),
                              dtype=v.dtype, device=v.device)
               for k, v in cache.items() if k in CARRY_LEAVES} or None
    for i, lp in enumerate(_layers(params)):
        lp = gathered(cfg, lp, ("layers",))
        carry = _carry_rows(cache, i)
        if cfg.family == "rwkv":
            h, _, steps = _rwkv_layer(lp, cfg, h, carry, valid=valid,
                                      collect_states=True)
        else:
            x1 = _norm(cfg, lp["norm1"], h)
            a = _paged_chunk_attn(
                lp["attn"], cfg, x1, cache["kv"].layer(i), tables,
                positions, safe_pos, fmt=fmt, cache_len=cache_len,
                attn_path=attn_path, kv_partitions=kv_partitions,
                live_pages=live_pages, rows=rows)
            if cfg.family == "hybrid":
                s_out, _, s_steps = ssm.ssm_seq(
                    lp["ssm"], x1, carry["ssm"], cfg, valid=valid,
                    collect_states=True)
                steps = {"ssm": s_steps}
                h = _ffn(lp, cfg, h + 0.5 * (a + s_out))
            else:
                h = _ffn(lp, cfg, _cross(lp, cfg, h + a, _enc_rows(state, i)),
                         split=rows is not None)
        for k in carry:
            carries[k][i, :, 0] = carry[k]
            carries[k][i, :, 1:] = steps[k]
    top = _head_leaves(params, cfg)
    h = _norm(cfg, top["final_norm"], h)
    return _logits_head(top, cfg, h), state, carries


# ---------------------------------------------------------------------------
# ring cache: whole-prompt prefill and the state the draft model decodes on
# ---------------------------------------------------------------------------

def _ring_layer(cache: attention.KVCache, i: int) -> attention.KVCache:
    """Layer ``i`` of a layer-stacked ring cache (views)."""
    return attention.KVCache(cache.k[i], cache.v[i], cache.pos[i])


def _init_carries(cfg: ModelConfig, batch: int, device=None):
    """The family's recurrent carries at zero, stacked over L: rwkv's
    ``wkv``, ``shift`` and ``cm_shift``, hybrid's ``ssm``; none else."""
    if cfg.family == "rwkv":
        one = rwkv.rwkv_state_init(batch, cfg.d_model, cfg.num_heads,
                                   cfg.head_dim, device="meta")
    elif cfg.family == "hybrid":
        one = {"ssm": ssm.ssm_state_init(batch, cfg.d_inner, cfg.ssm_state,
                                         device="meta")}
    else:
        return {}
    return {k: torch.zeros((cfg.num_layers, *v.shape), dtype=v.dtype,
                           device=device) for k, v in one.items()}


def init_slot_state(cfg: ModelConfig, batch: int, device=None):
    """Per-slot state alone, at zero: the family's carries (in
    ``"cache"``) and encdec's ``enc_kv``, no KV cache (the rows a mesh
    rank runs a prefill chunk on for a slot that another data rank
    holds)."""
    state = {"cache": _init_carries(cfg, batch, device)}
    if cfg.family == "encdec":
        state["enc_kv"] = _init_enc_kv(cfg, batch, device)
    return state


def _init_enc_kv(cfg: ModelConfig, batch: int, device=None):
    """encdec's per-slot cross K/V at zero: two (L, B, T, Hkv, D) stacks;
    the engine writes a slot's rows at admit."""
    shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
             cfg.head_dim)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def init_decode_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                      device=None):
    """Empty per-slot ring decode state: one KV ring of ``cache_len``
    entries per slot (none for rwkv) and the family's carries, stacked
    over L; encdec adds ``enc_kv``. On a mesh (``cfg.shard``) the ring
    holds every KV head and this rank's slice of the window
    (``Layout.ring_slice``), the carries and ``enc_kv`` the rank's heads
    or channels."""
    check_family(cfg)
    cache = _init_carries(cfg, batch, device)
    if cfg.family != "rwkv":
        Hkv, W = cfg.num_kv_heads, cache_len
        if cfg.shard is not None:
            part = cfg.shard.ring_slice(cache_len)
            Hkv, W = cfg.shard.cfg.num_kv_heads, part.stop - part.start
        shape = (cfg.num_layers, batch, W, Hkv, cfg.head_dim)
        cache["kv"] = attention.KVCache(
            k=torch.zeros(shape, dtype=cfg.dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.dtype, device=device),
            pos=torch.full(shape[:3], -1, dtype=torch.int32, device=device))
    state = {"cache": cache}
    if cfg.family == "encdec":
        state["enc_kv"] = _init_enc_kv(cfg, batch, device)
    return state


def _ring_prefill(cfg: ModelConfig, ring: attention.KVCache, k, v,
                  cache_len: int) -> None:
    """A layer's prefilled K/V (B, S, Hkv, D) into its ring; on a mesh every
    KV head, gathered over "model", into the rank's slice of the
    window."""
    if cfg.shard is None:
        attention.cache_prefill(ring, k, v)
        return
    lay = cfg.shard
    part = lay.ring_slice(cache_len)
    attention.cache_prefill(ring, lay.gather_heads(k, 2, kv=True),
                            lay.gather_heads(v, 2, kv=True),
                            ring_len=cache_len, start=part.start)


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache_len: int, prefix_embeds=None, audio_embeds=None):
    """Run a whole prompt (tokens (B, S_text), after ``prefix_embeds`` (B,
    P, d) when given, at positions 0..S_total-1; encdec's audio frames
    ``audio_embeds`` (B, T, d)); returns (last-position logits (B, V) fp32,
    a ring decode state holding each layer's last ``cache_len`` K/V, the
    carries after the prompt and encdec's ``enc_kv``)."""
    check_family(cfg)
    _check_audio(cfg, audio_embeds)
    h = _embed_stream(_embed_table(params, cfg), cfg, tokens, prefix_embeds)
    B, S, _ = h.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=h.device).expand(B, S)
    state = init_decode_state(cfg, B, cache_len, device=h.device)
    if cfg.family == "encdec":
        for dst, src in zip(state["enc_kv"],
                            encode_cross_kv(params, cfg, audio_embeds)):
            dst.copy_(src)
    cache = state["cache"]
    for i, lp in enumerate(_layers(params)):
        lp = gathered(cfg, lp, ("layers",))
        carry = _carry_rows(cache, i)
        if cfg.family == "rwkv":
            h, new = _rwkv_layer(lp, cfg, h, carry)
            for k, t in new.items():
                carry[k].copy_(t)
            continue
        x1 = _norm(cfg, lp["norm1"], h)
        a, (k, v) = _attn_seq(lp["attn"], cfg, x1, positions,
                              return_kv=True)
        _ring_prefill(cfg, _ring_layer(cache["kv"], i), k, v, cache_len)
        if cfg.family == "hybrid":
            s_out, s_fin = ssm.ssm_seq(lp["ssm"], x1, carry["ssm"], cfg)
            carry["ssm"].copy_(s_fin)
            h = _ffn(lp, cfg, h + 0.5 * (a + s_out))
        else:
            h = _ffn(lp, cfg, _cross(lp, cfg, h + a, _enc_rows(state, i)))
    top = _head_leaves(params, cfg)
    h = _norm(cfg, top["final_norm"], h[:, -1])
    return _logits_head(top, cfg, h), state


def init_paged_state(cfg: ModelConfig, batch: int, cache_len: int, *,
                     page_size: int, num_blocks: int,
                     kv_format: str = DEFAULT_KV_FORMAT, device=None):
    """Paged decode state: one block pool stacked over L, and the family's
    per-slot carries (encdec: ``enc_kv``). Block tables live outside the
    state (the engine passes them per step). rwkv holds no KV cache: its
    state is the carry-only state of :func:`init_decode_state`."""
    check_family(cfg)
    if cfg.family == "rwkv":
        return init_decode_state(cfg, batch, cache_len, device=device)
    kvc.pages_per_slot(cache_len, page_size)
    cache = _init_carries(cfg, batch, device)
    cache["kv"] = kvc.init_pool(num_blocks, page_size, cfg.num_kv_heads,
                                cfg.head_dim, cfg.dtype, kv_format,
                                num_layers=cfg.num_layers, device=device)
    state = {"cache": cache}
    if cfg.family == "encdec":
        state["enc_kv"] = _init_enc_kv(cfg, batch, device)
    return state
