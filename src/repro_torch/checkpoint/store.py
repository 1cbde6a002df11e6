"""Checkpoint save/restore (port of ``repro/checkpoint/store.py``), in the
JAX package's on-disk format, so either package restores what the other
saved:
  * ``<dir>/step_<n>/arrays.npz`` holds every leaf under its key path
    (dict keys joined by ``/``: ``params/layers/attn/wq/kernel``,
    ``opt/m/...``, ``opt/count``), ``meta.json`` the step, the dtypes npz
    cannot hold (bf16 is stored as its raw uint16 bits) and ``extra``;
  * a save goes to ``<dir>/tmp.<n>`` and is renamed to ``step_<n>``, so a
    crash mid-save never corrupts the latest complete step;
  * a ``QuantizedTensor`` leaf is stored as ``<key>/__packed``,
    ``__scales`` (and ``__zeros``) with its format descriptor, group size
    and dtype in ``meta["quantized"]``; restoring into a template that
    expects another format, or a dense leaf where a quantized one was
    saved (and the reverse), fails loudly with the JAX package's messages.
Restore is structure-checked against a template tree (shapes, and the
template's dtypes and devices for the restored tensors).

A mesh's training state (``shards``, a ``runtime.sharding.TrainShards``)
is saved as the same whole-tree file one process writes: the whole tree is
gathered to rank 0 (every rank joins the gathers), rank 0 alone writes,
and the ranks meet at a barrier before the atomic rename (and after it). Restoring reads the
whole tree on every rank and cuts this rank's shares again. The JAX
store's docstring promises per-host sharded saving, but its code writes
the whole arrays from one host; the port follows the code.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.device import dtype_name
from repro_torch.core.quant import (QuantFormat, QuantizedTensor,
                                    w4a16_format_for)
from repro_torch.core.tree import tree_flatten_with_keys, tree_map

_STEP_RE = re.compile(r"^step_(\d+)$")


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).cpu().numpy().view(np.uint16)
    return x.cpu().numpy()


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra: Optional[dict] = None, *, shards=None) -> str:
    """Atomically persist a tree (params, optimizer state, ...) for
    ``step``; returns the step's directory. With ``shards`` the tree is a
    runner state ``{"params", "opt"}`` of this rank's shares (see the
    module's docstring)."""
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if shards is not None:
        tree = shards.whole_state(tree)
        if tree is None:                # every rank but 0
            dist.barrier()              # rank 0 has written tmp.<step>
            dist.barrier()              # ... and renamed it
            return final
    os.makedirs(ckpt_dir, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    meta = {"step": step, "quantized": {}, "dtypes": {}, "extra": extra or {}}

    def put(key, x):
        if x.dtype == torch.bfloat16:
            meta["dtypes"][key] = "bfloat16"
        arrays[key] = _to_numpy(x)

    for path, leaf in tree_flatten_with_keys(tree):
        key = "/".join(path)
        if isinstance(leaf, QuantizedTensor):
            put(key + "/__packed", leaf.packed)
            put(key + "/__scales", leaf.scales)
            if leaf.zeros is not None:
                put(key + "/__zeros", leaf.zeros)
            meta["quantized"][key] = {
                "group_size": leaf.group_size,
                "out_dtype": dtype_name(leaf.out_dtype),
                "format": leaf.format.to_dict(),
            }
        else:
            put(key, leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if shards is not None:
        dist.barrier()
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    if shards is not None:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(n))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, like: Any, step: Optional[int] = None,
                       *, shards=None):
    """Restore into the structure of ``like`` (shape-checked; each tensor
    in the template leaf's dtype, on its device; a ``meta`` template leaf
    on the CPU). Returns ``(tree, step, extra)``, or ``(None, None,
    None)`` when there is no checkpoint. With ``shards`` ``like`` is this
    rank's shares (a runner state or a param tree): the whole tree is read
    and cut again."""
    if shards is not None:
        whole, step, extra = restore_checkpoint(
            ckpt_dir, shards.whole_shapes(like), step)
        if whole is None:
            return None, None, None
        cut = shards.cut_state(whole) if "params" in whole \
            else shards.cut(whole)
        return tree_map(lambda t, ref: t.to(device=ref.device,
                                            dtype=ref.dtype),
                        cut, like), step, extra
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        return None, None, None
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as data:
        def get(key) -> torch.Tensor:
            arr = data[key]
            if meta.get("dtypes", {}).get(key) == "bfloat16":
                return torch.from_numpy(arr.view(np.int16)) \
                    .view(torch.bfloat16)
            return torch.from_numpy(arr)

        def leaf_of(key: str, leaf):
            if isinstance(leaf, QuantizedTensor):
                return _restore_quantized(key, leaf, data, meta, get)
            if key not in data and key + "/__packed" in data:
                fmt = meta["quantized"].get(key, {}).get(
                    "format", {}).get("name", "a quantized format")
                raise ValueError(
                    f"checkpoint mismatch at {key}: the checkpoint stores "
                    f"a quantized ({fmt}) leaf but the model expects a "
                    f"dense array — restore into a quantized template "
                    f"(quantize_tree the `like` tree first)")
            arr = get(key)
            want = tuple(leaf.shape)
            if tuple(arr.shape) != want:
                raise ValueError(f"checkpoint mismatch at {key}: "
                                 f"{tuple(arr.shape)} != {want}")
            dev = "cpu" if leaf.device.type == "meta" else leaf.device
            return arr.to(device=dev, dtype=leaf.dtype)

        def build(tree, path):
            if isinstance(tree, dict):
                return {k: build(tree[k], path + (str(k),))
                        for k in sorted(tree)}
            return leaf_of("/".join(path), tree)

        out = build(like, ())
    return out, step, meta["extra"]


def _restore_quantized(key, leaf, data, meta, get) -> QuantizedTensor:
    q = meta["quantized"].get(key)
    if q is None:
        raise ValueError(
            f"checkpoint mismatch at {key}: the model expects a quantized "
            f"({leaf.format.name}) leaf but the checkpoint stores a dense "
            f"array — quantize the restored tree (layers.quantize_tree) "
            f"instead of restoring into a quantized template")
    # a checkpoint without a format descriptor resolves through the
    # W4A16-family shim; the descriptor is compared by value
    fmt = QuantFormat.from_dict(q["format"]) if "format" in q else \
        w4a16_format_for(q["group_size"],
                         symmetric=key + "/__zeros" not in data)
    if fmt != leaf.format:
        detail = "" if fmt.name != leaf.format.name else (
            f" (same name, different fields: {fmt.to_dict()} vs "
            f"{leaf.format.to_dict()})")
        raise ValueError(
            f"checkpoint format mismatch at {key}: checkpoint was saved as "
            f"{fmt.name!r} but the model expects {leaf.format.name!r}"
            f"{detail}; re-quantize the source checkpoint or restore with a "
            f"config whose quant_format is {fmt.name!r}")
    want = tuple(leaf.packed.shape)
    got = tuple(data[key + "/__packed"].shape)
    if want and got != want:
        raise ValueError(f"checkpoint mismatch at {key}: packed payload "
                         f"{got} != {want}")
    dev = leaf.packed.device
    zeros_key = key + "/__zeros"
    return QuantizedTensor(
        packed=get(key + "/__packed").to(dev),
        scales=get(key + "/__scales").to(dev),
        zeros=get(zeros_key).to(dev) if zeros_key in data else None,
        group_size=q["group_size"],
        out_dtype=getattr(torch, q["out_dtype"]), format=fmt)
