"""JAX parameter and optimizer-state trees → the port's trees.

The caller hands over the JAX package's params as a nested dict of numpy
arrays (the port never sees JAX): every array leaf becomes a tensor, and a
``QuantizedTensor`` leaf arrives as ``{"packed", "scales", "zeros",
"group_size", "format"}`` (stacked over L like the rest of ``layers``;
``format`` is the format's descriptor dict, ``QuantFormat.to_dict()``, or
its registered name) and becomes the port's
:class:`~repro_torch.core.quant.QuantizedTensor` with the same bytes and
the same format. A quantized leaf without ``format`` is refused: the
payload alone cannot tell a W4A16 leaf from a W4A8 one.
numpy ``bfloat16`` arrays (``ml_dtypes``) are reinterpreted bit for bit.
The leaves the JAX package keeps in fp32 whatever the model's dtype
(rwkv's ``w_bias``, the SSM's ``A_log`` and ``D``) stay fp32.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.quant import QuantizedTensor, resolve_format

_QT_KEYS = {"packed", "scales", "zeros", "group_size", "format"}
# float leaves that stay fp32 at any model dtype (the JAX package's init
# creates them in fp32)
FP32_LEAVES = ("w_bias", "A_log", "D")


def to_tensor(a, device=None) -> torch.Tensor:
    """numpy array → tensor (copied), bfloat16 kept bit-exact."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def from_jax_params(tree: Mapping[str, Any], *, dtype: torch.dtype,
                    device=None):
    """Convert a numpy param tree to the port's tree. Float leaves are cast
    to ``dtype`` (the model's dtype), those named in ``FP32_LEAVES`` to
    fp32; quantized leaves keep int8 payloads and fp32 scales and
    dequantize to ``dtype``."""
    return _convert(tree, "", dtype, device)


def _convert(tree, name: str, dtype: torch.dtype, device):
    if isinstance(tree, Mapping) and "packed" in tree:
        if set(tree) != _QT_KEYS:
            raise ValueError(
                f"a quantized leaf needs exactly the keys {sorted(_QT_KEYS)}"
                f", got {sorted(tree)}: its format must be given, not "
                f"guessed")
        zeros = tree["zeros"]
        return QuantizedTensor(
            packed=to_tensor(tree["packed"], device).view(torch.int8),
            scales=to_tensor(tree["scales"], device),
            zeros=None if zeros is None else to_tensor(zeros, device),
            group_size=int(tree["group_size"]), out_dtype=dtype,
            format=resolve_format(tree["format"]))
    if isinstance(tree, Mapping):
        return {k: _convert(v, k, dtype, device) for k, v in tree.items()}
    t = to_tensor(tree, device)
    if not t.is_floating_point():
        return t
    return t.to(torch.float32 if name in FP32_LEAVES else dtype)


def from_jax_opt_state(tree: Mapping[str, Any], *, device=None):
    """Convert a numpy optimizer-state tree (AdamW's ``{"m", "v",
    "count"}``) leaf for leaf, each in its own dtype: fp32 (or the state
    dtype's) moments stay as they are and ``count`` stays int32 — never
    cast to the model's dtype, as parameters are."""
    if isinstance(tree, Mapping):
        return {k: from_jax_opt_state(v, device=device)
                for k, v in tree.items()}
    return to_tensor(tree, device)
