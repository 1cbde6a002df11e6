"""Quantization core: the weight formats (W4A16, W8A16, W4A8) and the
KV-cache formats.

Port of ``repro/core/quant.py``. A :class:`QuantFormat` is a frozen,
JSON-serializable descriptor registered by name; every
:class:`QuantizedTensor` carries the format it was produced with.

Storage convention (byte-identical to the JAX package)
------------------------------------------------------
Weights are ``(K, N)`` (contraction dim first, like ``x @ w``). For 4-bit
formats two INT4 values are packed per ``int8`` byte **along K**:

    byte[k, n] = (q[2k+1, n] << 4) | (q[2k, n] & 0xF)

so the packed tensor is ``(K//2, N)`` int8: even K rows in the low nibble,
odd rows in the high nibble. Packing goes through ``uint8`` and a bitwise
``.view(torch.int8)`` — never a value cast — so the stored bytes are the
JAX package's bytes. Scales (and optional zero-points) are ``(K/group, N)``
fp32. ``torch.round`` rounds half to even, exactly like ``jnp.round``.

    x_q = round(x / s) + z          (z = 0 for symmetric)
    Dequant(x_q) = s * (x_q - z)    (paper Eq. 2)
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

DEFAULT_GROUP_SIZE = 128
DEFAULT_FORMAT = "w4a16_g128"

_PACKINGS = ("int4_pairs_k", "int8_rows")
_GRANULARITIES = ("group", "channel", "tensor")


# ---------------------------------------------------------------------------
# QuantFormat: the descriptor + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuantFormat:
    """A quantization format: what the bits mean and how they are laid out."""

    name: str
    weight_bits: int = 4
    packing: str = "int4_pairs_k"
    scale_granularity: str = "group"
    group_size: int = DEFAULT_GROUP_SIZE
    symmetric: bool = True
    act_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.packing not in _PACKINGS:
            raise ValueError(f"unknown packing {self.packing!r}; "
                             f"one of {_PACKINGS}")
        if self.scale_granularity not in _GRANULARITIES:
            raise ValueError(f"unknown scale granularity "
                             f"{self.scale_granularity!r}; "
                             f"one of {_GRANULARITIES}")
        want_bits = 4 if self.packing == "int4_pairs_k" else 8
        if self.weight_bits != want_bits:
            raise ValueError(f"packing {self.packing!r} stores "
                             f"{want_bits}-bit weights, got "
                             f"weight_bits={self.weight_bits}")
        if self.scale_granularity == "group" and self.group_size <= 0:
            raise ValueError("group granularity needs group_size > 0")

    @property
    def qmin(self) -> int:
        return -(1 << (self.weight_bits - 1))

    @property
    def qmax(self) -> int:
        return (1 << (self.weight_bits - 1)) - 1

    @property
    def pack_factor(self) -> int:
        """K rows represented per packed row (2 for nibble pairs)."""
        return 2 if self.packing == "int4_pairs_k" else 1

    @property
    def quantized_activations(self) -> bool:
        return self.act_dtype == "int8"

    def scale_rows(self, K: int) -> int:
        return K // self.group_size if self.scale_granularity == "group" \
            else 1

    def with_group_size(self, group_size: int) -> "QuantFormat":
        """This format with another group size (registered on demand)."""
        if self.scale_granularity != "group" \
                or group_size == self.group_size:
            return self
        name, n = re.subn(r"_g\d+", f"_g{group_size}", self.name, count=1)
        if not n:
            name = f"{self.name}_g{group_size}"
        return register_format(
            dataclasses.replace(self, name=name, group_size=group_size))

    def with_symmetric(self, symmetric: bool) -> "QuantFormat":
        """Symmetric/asymmetric variant (``_asym`` name suffix toggles)."""
        if symmetric == self.symmetric:
            return self
        name = self.name[:-len("_asym")] if self.name.endswith("_asym") \
            else self.name + "_asym"
        return register_format(
            dataclasses.replace(self, name=name, symmetric=symmetric))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "QuantFormat":
        return cls(**dict(d))


_FORMAT_REGISTRY: Dict[str, QuantFormat] = {}


def register_format(fmt: QuantFormat, *, overwrite: bool = False
                    ) -> QuantFormat:
    """Register ``fmt`` under its name; an identical re-registration is a
    no-op, a different format under a taken name raises."""
    existing = _FORMAT_REGISTRY.get(fmt.name)
    if existing is not None and existing != fmt and not overwrite:
        raise ValueError(
            f"format {fmt.name!r} is already registered with different "
            f"fields; pass overwrite=True to replace it")
    _FORMAT_REGISTRY[fmt.name] = fmt
    return fmt


def get_format(name: str) -> QuantFormat:
    try:
        return _FORMAT_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown quantization format {name!r}; registered: "
            f"{available_formats()}") from None


def available_formats() -> Tuple[str, ...]:
    return tuple(_FORMAT_REGISTRY)


FormatLike = Union[None, str, QuantFormat, Mapping[str, Any]]


def resolve_format(spec: FormatLike) -> QuantFormat:
    """Name / QuantFormat / descriptor dict / None (the default format) →
    a registered QuantFormat."""
    if spec is None:
        return _FORMAT_REGISTRY[DEFAULT_FORMAT]
    if isinstance(spec, str):
        return get_format(spec)
    if isinstance(spec, QuantFormat):
        return register_format(spec)
    if isinstance(spec, Mapping):
        return register_format(QuantFormat.from_dict(spec))
    raise TypeError(f"cannot resolve a quantization format from "
                    f"{type(spec).__name__}")


def w4a16_format_for(group_size: int, *, symmetric: bool = True
                     ) -> QuantFormat:
    """The W4A16-family format for a group size (and symmetry)."""
    fmt = _FORMAT_REGISTRY[DEFAULT_FORMAT].with_group_size(group_size)
    return fmt.with_symmetric(symmetric)


# The paper's format (the default) and the two other members of the family:
# per-channel INT8 weights, and INT4 weights with dynamic per-token INT8
# activations.
W4A16_G128 = register_format(QuantFormat(
    name="w4a16_g128", weight_bits=4, packing="int4_pairs_k",
    scale_granularity="group", group_size=128, symmetric=True,
    act_dtype="bfloat16"))
W8A16_CHANNEL = register_format(QuantFormat(
    name="w8a16_channel", weight_bits=8, packing="int8_rows",
    scale_granularity="channel", group_size=0, symmetric=True,
    act_dtype="bfloat16"))
W4A8_G128 = register_format(QuantFormat(
    name="w4a8_g128", weight_bits=4, packing="int4_pairs_k",
    scale_granularity="group", group_size=128, symmetric=True,
    act_dtype="int8"))


# ---------------------------------------------------------------------------
# QuantizedTensor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuantizedTensor:
    """A quantized weight: packed payload + scales (+ zeros) + its format.

    ``packed``/``scales``/``zeros`` may carry leading stack axes (layers):
    ``packed`` is ``(..., K//pack_factor, N)``. ``format=None`` infers the
    W4A16-family format from ``group_size`` and the presence of ``zeros``.
    """

    packed: torch.Tensor
    scales: torch.Tensor
    zeros: Optional[torch.Tensor]
    group_size: int
    out_dtype: torch.dtype
    format: Optional[QuantFormat] = None

    def __post_init__(self):
        if self.format is None:
            self.format = w4a16_format_for(
                self.group_size, symmetric=self.zeros is None)

    @property
    def shape(self):
        return (self.K, self.N)

    @property
    def K(self) -> int:
        return self.packed.shape[-2] * self.format.pack_factor

    @property
    def N(self) -> int:
        return self.packed.shape[-1]

    def nbytes_packed(self) -> int:
        n = self.packed.numel()
        n += self.scales.numel() * self.scales.element_size()
        if self.zeros is not None:
            n += self.zeros.numel() * self.zeros.element_size()
        return n

    def layer(self, i: int) -> "QuantizedTensor":
        """Slice ``i`` of a stacked tensor (a view, no copy)."""
        return QuantizedTensor(
            self.packed[i], self.scales[i],
            None if self.zeros is None else self.zeros[i],
            self.group_size, self.out_dtype, self.format)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def true_div(a: torch.Tensor, d: float) -> torch.Tensor:
    """``a / d`` as an IEEE division on every device. PyTorch's CUDA kernels
    divide by a Python scalar by multiplying with its reciprocal, which can
    differ in the last bit from the CPU's (and the JAX package's) division;
    a 0-dim tensor on ``a``'s device keeps it a true division."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int4 values (int8 in [-8, 7]) pairwise along axis 0:
    (K, N) → (K//2, N) int8, even rows in the low nibble."""
    if q.shape[0] % 2:
        raise ValueError(f"K must be even to pack, got {tuple(q.shape)}")
    u = q.to(torch.int8).view(torch.uint8)
    lo = u[0::2] & 0xF
    hi = u[1::2] & 0xF
    return ((hi << 4) | lo).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` → (..., K, N) int8 in [-8, 7], by
    shift-based sign extension: ``(b << 4) >> 4`` low, ``b >> 4`` high
    (leading stack axes are kept)."""
    b = packed.view(torch.int8)
    lo = (b.view(torch.uint8) << 4).view(torch.int8) >> 4
    hi = b >> 4
    *lead, k2, n = packed.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * k2, n)


def unpack_int8_rows(packed: torch.Tensor) -> torch.Tensor:
    """The ``int8_rows`` unpack: weight rows are stored as int8."""
    return packed.view(torch.int8)


def pack_weights(q: torch.Tensor, fmt: FormatLike = None) -> torch.Tensor:
    fmt = resolve_format(fmt)
    if fmt.packing == "int4_pairs_k":
        return pack_int4(q)
    return q.to(torch.int8)


def unpack_weights(packed: torch.Tensor, fmt: FormatLike = None
                   ) -> torch.Tensor:
    fmt = resolve_format(fmt)
    if fmt.packing == "int4_pairs_k":
        return unpack_int4(packed)
    return unpack_int8_rows(packed)


def per_channel_scales(qt: QuantizedTensor):
    """``(scales, zeros)`` broadcast to the (1, N) per-channel layout
    (tensor scales broadcast across N); group scales are refused."""
    if qt.format.scale_granularity == "group":
        raise ValueError(
            f"format {qt.format.name!r} has group-granular scales; "
            f"per-channel kernels need channel or tensor granularity")
    N = qt.N
    scales = torch.broadcast_to(qt.scales, (1, N))
    zeros = None if qt.zeros is None \
        else torch.broadcast_to(qt.zeros, (1, N))
    return scales, zeros


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------

def quantize(w: torch.Tensor, format: FormatLike = None, *,
             group_size: Optional[int] = None,
             symmetric: Optional[bool] = None,
             scale_dtype: torch.dtype = torch.float32,
             out_dtype: Optional[torch.dtype] = None) -> QuantizedTensor:
    """Quantize a (K, N) weight matrix per ``format`` (default
    ``w4a16_g128``); same arithmetic, in the same order, as the JAX
    package's ``quantize``, so the stored bytes agree."""
    fmt = resolve_format(format)
    if group_size is not None:
        fmt = fmt.with_group_size(group_size)
    if symmetric is not None:
        fmt = fmt.with_symmetric(symmetric)
    if w.dim() != 2:
        raise ValueError(f"quantize expects 2-D (K, N) weight, got "
                         f"{tuple(w.shape)}")
    K, N = w.shape
    if fmt.packing == "int4_pairs_k" and K % 2:
        raise ValueError(f"K={K} must be even for {fmt.packing} packing")
    if fmt.scale_granularity == "group":
        g = fmt.group_size
        if K % g:
            raise ValueError(f"K={K} not divisible by group_size={g} "
                             f"(format {fmt.name!r})")
        if fmt.packing == "int4_pairs_k" and g % 2:
            raise ValueError("group_size must be even")
    else:
        g = K
    out_dtype = out_dtype or w.dtype

    gw = w.to(torch.float32).reshape(K // g, g, N)
    dims = (1, 2) if fmt.scale_granularity == "tensor" else (1,)
    if fmt.symmetric:
        amax = gw.abs().amax(dim=dims, keepdim=True)
        s = torch.clamp_min(true_div(amax, fmt.qmax), 1e-8)
        z = None
        q = torch.round(gw / s)
    else:
        gmax = gw.amax(dim=dims, keepdim=True)
        gmin = gw.amin(dim=dims, keepdim=True)
        s = torch.clamp_min(true_div(gmax - gmin, fmt.qmax - fmt.qmin), 1e-8)
        z = torch.round(-gmin / s) + fmt.qmin
        q = torch.round(gw / s) + z
    q = torch.clamp(q, fmt.qmin, fmt.qmax).to(torch.int8).reshape(K, N)

    def flat(a):                         # drop the reduced group axis
        return a[:, 0]
    return QuantizedTensor(
        packed=pack_weights(q, fmt),
        scales=flat(s).to(scale_dtype),
        zeros=None if z is None else flat(z).to(scale_dtype),
        group_size=g,
        out_dtype=out_dtype,
        format=fmt,
    )


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """Materialize the full (K, N) weight in ``qt.out_dtype`` (Eq. 2); a
    stack (an MoE layer's experts) gives (..., K, N) at once."""
    q = unpack_weights(qt.packed, qt.format).to(torch.float32)
    g = qt.group_size

    def expand(a):                       # scale rows → per-element (K, .)
        return torch.repeat_interleave(a.to(torch.float32), g, dim=-2)
    if qt.zeros is not None:
        q = q - expand(qt.zeros)
    return (q * expand(qt.scales)).to(qt.out_dtype)


def w4a16_matmul_ref(x: torch.Tensor, qt: QuantizedTensor, *,
                     out_dtype=None, acc_dtype=torch.float32) -> torch.Tensor:
    """``x @ Dequant(W)`` computed the naive way: the weight materialized in
    ``qt.out_dtype``, x rounded to it, the product accumulated in
    ``acc_dtype`` (fp32, as the JAX package's oracle; ``None`` keeps the
    weight's dtype: one library GEMM) and cast to ``out_dtype`` (default
    x's dtype)."""
    w = dequantize(qt)
    acc = acc_dtype or w.dtype
    return torch.matmul(x.to(w.dtype).to(acc), w.to(acc)) \
        .to(out_dtype or x.dtype)


def quantize_activations_int8(x: torch.Tensor):
    """Dynamic per-token symmetric INT8 activations: ``(x_q int8, x_scale
    fp32 (..., 1))``, one scale per row, ``s = max(amax / 127, 1e-8)``
    divided in fp32 and rounded half to even, as the JAX package does."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(true_div(amax, 127.0), 1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def w4a8_group_sums(xq: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """The W4A8 per-group terms ``(M, G, N)`` fp32: ``ws[G, n] · (Σ_g
    xq[m, G, g]·wq[G, g, n] − z[G, n]·Σ_g xq[m, G, g])``. The integer dots
    run as fp32 matmuls of integer values, which are exact: every partial
    sum is an integer below 2^24 (|xq·wq| ≤ 127·8, at most a few thousand
    terms), so the order of summation cannot change them — this is the
    JAX package's int32 dot, on a device with no integer matmul."""
    M, K = xq.shape
    wq = unpack_weights(qt.packed, qt.format)
    N, g = wq.shape[-1], qt.group_size
    G = K // g
    xg = xq.reshape(M, G, g).to(torch.float32)
    acc = torch.einsum("mgk,gkn->mgn", xg,
                       wq.reshape(G, g, N).to(torch.float32))
    if qt.zeros is not None:
        tok = xg.sum(dim=2)                                  # (M, G) exact
        acc = acc - qt.zeros.to(torch.float32)[None] * tok[:, :, None]
    return acc * qt.scales.to(torch.float32)[None]


def w4a8_matmul_ref(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """W4A8 GEMM: dynamic INT8 activations × INT4 weights, exact integer
    sums per K-group, scales applied at the group boundary:

        y[m, n] = xs[m] · Σ_G ws[G, n] · Σ_g xq[m, G, g] · wq[G, g, n]

    cast to x's dtype (the JAX package's ``w4a8_matmul_ref``)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, xs = quantize_activations_int8(x2)
    y = w4a8_group_sums(xq, qt).sum(dim=1)
    return (y * xs).to(x.dtype).reshape(*lead, qt.N)


def quantization_error_bound(qt: QuantizedTensor) -> torch.Tensor:
    """Per-group max rounding error: |w - deq(q(w))| <= s/2."""
    return qt.scales.to(torch.float32) / 2.0


# ---------------------------------------------------------------------------
# KV-cache quantization formats
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVFormat:
    """How cached K/V vectors are stored in the paged block pool:
    ``bits=16`` passthrough (the cache dtype, no scales) or ``bits=8``
    int8 payloads with one fp32 scale per (token, kv-head)."""

    name: str
    bits: int = 16
    scale_granularity: str = "none"

    def __post_init__(self):
        if self.bits not in (8, 16):
            raise ValueError(f"KVFormat bits must be 8 or 16, got {self.bits}")
        if self.bits == 16 and self.scale_granularity != "none":
            raise ValueError("16-bit KV passthrough stores no scales")
        if self.bits == 8 and self.scale_granularity != "channel":
            raise ValueError("8-bit KV needs per-head 'channel' scales")

    @property
    def quantized(self) -> bool:
        return self.bits == 8

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_KV_FORMAT_REGISTRY: Dict[str, KVFormat] = {}
DEFAULT_KV_FORMAT = "kv_fp16"


def register_kv_format(fmt: KVFormat, *, overwrite: bool = False) -> KVFormat:
    existing = _KV_FORMAT_REGISTRY.get(fmt.name)
    if existing is not None and existing != fmt and not overwrite:
        raise ValueError(
            f"KV format {fmt.name!r} is already registered with different "
            f"fields; pass overwrite=True to replace it")
    _KV_FORMAT_REGISTRY[fmt.name] = fmt
    return fmt


def get_kv_format(name: str) -> KVFormat:
    try:
        return _KV_FORMAT_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown KV-cache format {name!r}; registered: "
            f"{available_kv_formats()}") from None


def available_kv_formats() -> Tuple[str, ...]:
    return tuple(_KV_FORMAT_REGISTRY)


KV_FP16 = register_kv_format(KVFormat("kv_fp16", bits=16,
                                      scale_granularity="none"))
KV8_CHANNEL = register_kv_format(KVFormat("kv8_channel", bits=8,
                                          scale_granularity="channel"))


def kv_quantize(x: torch.Tensor, fmt: KVFormat):
    """Quantize K/V token vectors ``(..., Hkv, D)`` per ``fmt``: int8
    payload + fp32 per-(token, head) scales for ``kv8_channel``;
    ``(x, None)`` passthrough for ``kv_fp16``."""
    if not fmt.quantized:
        return x, None
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp_min(true_div(amax, 127.0), 1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s[..., 0]


def kv_dequantize(payload: torch.Tensor, scales, fmt: KVFormat, dtype):
    """Inverse of :func:`kv_quantize`, materializing ``dtype``."""
    if not fmt.quantized:
        return payload.to(dtype)
    return (payload.to(torch.float32)
            * scales.to(torch.float32)[..., None]).to(dtype)
