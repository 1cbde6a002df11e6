"""The dry run on the meta device: trace every (arch × shape × mesh) cell
at a production mesh and record what one rank needs (port of
``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun              # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-20b \\
        --shape train_4k --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes \\
        --json out.json

JAX lowers and compiles each cell over 512 placeholder devices and reads
the compiled program's memory, cost and collectives. The port runs SPMD by
hand, so a cell is rank 0's own step at the production mesh
(``launch.mesh.make_production_mesh``: a fake process group of 256 or 512
ranks in this one process) on meta tensors — shapes and dtypes, no storage,
no random draw — with the rank's shares of the abstract parameters
(``T.abstract_params``, quantized for serving):

- train: ``make_train_step(..., mesh=)`` under ``settings_for(arch)``, the
  microbatches clamped as JAX's so that each microbatch splits over the
  data axis, the flash-attention kernel as the launcher runs it (ZeRO-3,
  llama3-405b's and mixtral's: each layer gathered over "data" just
  before it runs, again in its recompute, its gradient reduce-scattered);
- prefill: ``steps.make_prefill_step`` (the whole prompt into the ring
  state, flash attention) on the rank's W4A16 shard and its rows of the
  batch;
- every serving cell under the arch's ``fsdp_serve`` (llama3-405b's), as
  JAX's dry run passes it: the rank holds its shares over "data" of its
  W4A16 slice (``sharding.serve_shares``) and gathers a layer at a time;
- decode (JAX's cell): ``steps.make_serve_step`` on ``input_specs``' ring
  state at the rank's share (:func:`decode_cell`: the ring's batch over
  "data", its window over "model" where the model axis divides it, every
  KV head; the carries and ``enc_kv`` the rank's rows and heads), the
  ring engine's step;
- decode, the paged departure (:func:`decode_paged_cell`): the same step
  on the paged state the paged engine holds (the pool whole on every data
  replica, the rank's KV heads), the attention planned as on the card.
  JAX's dry run never traces it; the CLI prints it beside JAX's cell for
  every arch that holds a KV cache.

Each kernel wrapper runs its CUDA path on meta tensors up to the launch:
it allocates what that path allocates and launches nothing
(``kernels.build``), and the planners plan meta problems as the card's.

A record (JAX's names): ``bytes_per_device`` — ``argument`` (the step's
inputs: parameters, optimizer state, batch or decode state),
``output`` (new storage the step returns), ``peak_total`` (the most bytes
of meta storage alive at once during the step, arguments included;
:class:`MetaMemory`) and ``temp`` (peak_total − argument − output);
``cost.flops`` — ``torch.utils.flop_counter.FlopCounterMode``'s count of
the aten ops plus each traced kernel launch's operations
(``cost.kernel_flops``); ``collectives`` — bytes and counts by kind,
counted at ``runtime.sharding.Layout``'s collectives; ``status`` OK, SKIP
(JAX's ``skip_reason``) or FAIL; ``seconds``; ``fits_h100``:
``peak_total`` at most the card's memory (``total_memory`` on the card,
80 GiB elsewhere, as ``launch.train.check_fits``). Exit code 1 on any
failed cell.

Two pods fold into one data axis of 32 (``launch.mesh``: ``pod_as_data``).
Meta ops run in Python (about a quarter of a millisecond each), so the
stepped recurrences of rwkv and the SSM trace their steps in one
vectorized step of the same shapes (``models.rwkv.wkv_scan``,
``models.ssm.ssm_scan``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs import SHAPES, cache_len_for, input_specs, skip_reason
from repro_torch.core.quant import QuantizedTensor
from repro_torch.kernels import (flash_attention, gemm, paged_attention,
                                 planning, w4a8_fused, w4a16_decoupled,
                                 w4a16_fused, w8a16_fused)
from repro_torch.launch.mesh import degraded_mesh, make_production_mesh
from repro_torch.launch.presets import serve_settings_for, settings_for
from repro_torch.launch.train import CARD_BYTES
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import sharding
from repro_torch.runtime import steps as rsteps

KERNELS = (w4a16_fused.W4A16_GEMM, gemm.DENSE_GEMM,
           w4a16_decoupled.DEQUANT_W4, w4a16_decoupled.REDUCE_PARTIALS,
           w8a16_fused.W8A16_GEMM, w4a8_fused.W4A8_QUANTIZE,
           w4a8_fused.W4A8_GEMM, paged_attention.PAGED_ATTENTION,
           flash_attention.FLASH_ATTENTION)


def card_bytes() -> int:
    """One card's memory: the card's own, else an H100's 80 GiB."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return CARD_BYTES


def _tensors(tree):
    """Every tensor of a nested structure (QuantizedTensor payloads
    included)."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, QuantizedTensor):
            out += [t for t in (leaf.packed, leaf.scales, leaf.zeros)
                    if t is not None]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


class MetaMemory(TorchDispatchMode):
    """Live bytes of meta storage while the mode is on: every storage an op
    returns is counted once until it is freed (a weak reference to the
    storage, which PyTorch keeps one Python object for); ``track`` counts
    storages made before (the step's arguments). ``peak`` is the most
    bytes alive at once."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._sizes = {}

    def _free(self, key):
        self.live -= self._sizes.pop(key)

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors; returns their bytes
        (each storage once)."""
        added = 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in self._sizes:
                continue
            n = st.nbytes()
            self._sizes[key] = n
            self.live += n
            added += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return added

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track(out)
        return out


def _storage_bytes(tree, exclude=()) -> int:
    seen, n = {id(t.untyped_storage()) for t in _tensors(exclude)}, 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            n += st.nbytes()
    return n


def _cut_depth(cfg, layers: Optional[int]):
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, num_layers=min(layers, cfg.num_layers),
                               encoder_layers=min(layers,
                                                  cfg.encoder_layers))


def _rows_of(t: torch.Tensor, rows) -> torch.Tensor:
    return t if rows is None else t[rows]


def train_cell(cfg, batch, settings, *, mesh=None, opt_cfg=None,
               attn_impl: str = "flash"):
    """One training step of ``cfg`` (on the flash kernel, as the launcher
    runs it, unless ``attn_impl`` says otherwise) on the whole ``batch``
    (meta tensors; a mesh rank takes its rows): ``(step, arguments,
    meta)``, the arguments this rank's shares of the abstract parameters
    and their fresh AdamW state (one device: the whole tree, the plain
    step)."""
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    opt_cfg = opt_cfg or AdamWConfig(state_dtype=settings.opt_dtype)
    step = rsteps.make_train_step(cfg, opt_cfg, settings, mesh=mesh)
    params = T.abstract_params(cfg)
    if mesh is not None:
        params = step.shards.cut(params)
    opt = adamw_init(params, opt_cfg)
    return step, (params, opt, {"batch": batch, "step": 0}), \
        {"kind": "train", "microbatches": settings.microbatches}


def zero3_collectives(shards, microbatches: int) -> tuple:
    """ZeRO-3's collectives over "data" a step, reckoned from a rank's
    ``TrainShards``: each cut leaf of a layer stack all-gathered for each
    layer once a microbatch in the forward and again in its remat
    recompute (once without remat), each cut leaf outside the stacks once
    a microbatch; each cut leaf's gradient reduce-scattered as often as
    it is gathered in the forward. Returns (all-gathers,
    reduce-scatters)."""
    cfg = shards.layout.cfg
    passes = 2 if cfg.remat else 1
    gathers = scatters = 0
    for path, s in shards.leaves.items():
        if s.fsdp is None:
            continue
        n = cfg.num_layers if path[0] == "layers" else \
            cfg.encoder_layers if path[:2] == ("encoder", "layers") else 0
        gathers += passes * n if n else 1
        scatters += n or 1
    return microbatches * gathers, microbatches * scatters


def _serve_params(cfg, mesh, fsdp_serve: bool = False):
    """The serving tree of ``cfg`` on this rank (quantized when the config
    serves quantized; layers unstacked, as the engine holds them; under
    ``fsdp_serve`` its shares over "data", ``sharding.serve_shares``) and
    the config the rank runs."""
    params = T.abstract_params(cfg)
    if cfg.quantize_serve:
        params = T.quantize_params(params, cfg)
    if mesh is None:
        return T.unstack_layers(params), cfg, None
    lay = sharding.Layout(cfg, mesh)
    params = sharding.shard_params(params, mesh, cfg)
    if fsdp_serve:
        params = sharding.serve_shares(params, lay)
    return T.unstack_layers(params), lay.local_cfg(), lay


def prefill_cell(cfg, inputs, cache_len: int, *, mesh=None,
                 fsdp_serve: bool = False):
    """The whole-prompt prefill (``steps.make_prefill_step``: the ring
    state, flash attention) of ``inputs`` (meta tensors) on this rank's
    W4A16 shard and its rows of the batch (JAX's ``batch_spec`` over
    "data")."""
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    params, local, lay = _serve_params(cfg, mesh, fsdp_serve)
    if lay is not None:
        rows = lay.rows(inputs["tokens"].shape[0])
        inputs = {k: _rows_of(v, rows) for k, v in inputs.items()}
    step = rsteps.make_prefill_step(local, cache_len, fsdp_serve=fsdp_serve)
    return step, (params, inputs), {"kind": "prefill",
                                    "fsdp_serve": fsdp_serve}


def decode_cell(cfg, B: int, cache_len: int, *, mesh=None,
                fsdp_serve: bool = False):
    """JAX's decode cell: one serve step over the ring state of
    ``input_specs`` (B slots, a ``cache_len`` window) on this rank's share
    of it — its rows of the batch (``batch_spec`` over "data"), its slice
    of the window where the model axis divides it, every KV head; the
    carries and ``enc_kv`` its rows and heads (``T.init_decode_state`` on
    the rank's config) — with the rank's W4A16 slice, as the ring engine
    runs it."""
    params, local, lay = _serve_params(cfg, mesh, fsdp_serve)
    rows = None if lay is None else lay.rows(B)
    n_rows = B if rows is None else rows.stop - rows.start
    i32 = dict(dtype=torch.int32, device="meta")
    inputs = {"state": T.init_decode_state(local, n_rows, cache_len,
                                           device="meta"),
              "tokens": torch.empty((B,), **i32),
              "pos": torch.empty((B,), **i32)}
    step = rsteps.make_serve_step(local, cache_len=cache_len,
                                  attn_path="ring", fsdp_serve=fsdp_serve)
    return step, (params, inputs), {"kind": "decode", "cell": "ring",
                                    "fsdp_serve": fsdp_serve}


def decode_paged_cell(cfg, B: int, cache_len: int, *, page_size: int,
                      num_blocks: Optional[int] = None, mesh=None,
                      kv_format: str = "kv_fp16",
                      attn_path: Optional[str] = None,
                      kv_partitions: Optional[int] = None,
                      fsdp_serve: bool = False):
    """A named departure from JAX's dry run: one paged decode step over B
    slots as the paged engine runs it: the pool (``num_blocks`` pages, by
    default every slot's ``cache_len`` window and the null block) whole on
    every data replica with this rank's KV heads, the slots' carries and
    ``enc_kv`` its rows, the attention planned for the card unless
    ``attn_path`` is given."""
    params, local, lay = _serve_params(cfg, mesh, fsdp_serve)
    pages = cache_len // page_size
    rows = None if lay is None else lay.rows(B)
    n_rows = B if rows is None else rows.stop - rows.start
    state = T.init_paged_state(
        local, n_rows, cache_len, page_size=page_size,
        num_blocks=num_blocks or 1 + B * pages, kv_format=kv_format,
        device="meta")
    i32 = dict(dtype=torch.int32, device="meta")
    inputs = {"state": state, "tokens": torch.empty((B,), **i32),
              "pos": torch.empty((B,), **i32)}
    meta = {"kind": "decode", "cell": "paged (departure)",
            "fsdp_serve": fsdp_serve}
    kw = {"fsdp_serve": fsdp_serve}
    if local.family in T.CARRY_FAMILIES:
        inputs["active"] = torch.empty((B,), dtype=torch.bool,
                                       device="meta")
    if local.family != "rwkv":
        if attn_path is None:
            plan = planning.plan_attention(planning.AttentionProblem(
                B=n_rows, Hq=local.num_heads, Hkv=local.num_kv_heads,
                D=local.head_dim, cache_len=cache_len, page_size=page_size,
                window=local.sliding_window, kv_format=kv_format,
                paged=True, backend="meta",
                act_bytes=torch.finfo(local.dtype).bits // 8))
            attn_path, kv_partitions = plan.path, plan.kv_partitions
        kw.update(attn_path=attn_path, kv_partitions=kv_partitions)
        inputs["tables"] = torch.empty((B, pages), **i32)
        meta["attn_path"] = attn_path
    step = rsteps.make_serve_step(local, cache_len=cache_len,
                                  kv_format=kv_format, **kw)
    return step, (params, inputs), meta


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               drop_data: int = 0, global_batch: Optional[int] = None,
               layers: Optional[int] = None, paged: bool = False):
    """One cell's step on rank 0 of the production mesh (less
    ``drop_data`` data rows; at ``global_batch`` rows when given; the
    first ``layers`` layers when given; a decode shape's paged departure
    with ``paged``). Returns ``(step, arguments, meta)``:
    ``step(*arguments)`` runs the rank's step; or ``(None, None,
    {"skipped": reason})``."""
    cfg = _cut_depth(configs.get_config(arch), layers)
    shape = SHAPES[shape_name]
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    skip = skip_reason(cfg, shape)
    if skip:
        return None, None, {"skipped": skip}
    mesh = make_production_mesh(multi_pod=multi_pod)
    if drop_data:
        mesh = degraded_mesh(mesh, drop_data=drop_data)
    specs = input_specs(cfg, shape)
    settings = settings_for(arch)
    if shape.kind == "train":
        # each microbatch must split over the data axis: clamp as JAX does
        dpw = mesh.size(mesh.mesh_dim_names.index("data"))
        micro = settings.microbatches
        while micro > 1 and (shape.global_batch // micro) % dpw:
            micro //= 2
        out = train_cell(cfg, specs["batch"], dataclasses.replace(
            settings, microbatches=micro), mesh=mesh)
    elif shape.kind == "prefill":
        out = prefill_cell(cfg, specs, cache_len_for(cfg, shape), mesh=mesh,
                           fsdp_serve=settings.fsdp_serve)
    elif paged:
        ps = serve_settings_for(arch).page_size
        out = decode_paged_cell(cfg, shape.global_batch,
                                -(-cache_len_for(cfg, shape) // ps) * ps,
                                page_size=ps, mesh=mesh,
                                fsdp_serve=settings.fsdp_serve)
    else:
        out = decode_cell(cfg, shape.global_batch, cache_len_for(cfg, shape),
                          mesh=mesh, fsdp_serve=settings.fsdp_serve)
    out[2]["mesh"] = "x".join(str(n) for n in mesh.shape)
    return out


def trace(step, arguments) -> dict:
    """Run ``step(*arguments)`` on meta tensors under the memory tracker,
    the FLOP counter and the collective counters; the record's
    ``bytes_per_device``, ``cost`` and ``collectives``."""
    sharding.reset_collectives()
    before = {k.name: k.traced_flops for k in KERNELS}
    mem = MetaMemory()
    flops = FlopCounterMode(display=False)
    with mem:
        argument = mem.track(arguments)
        with flops:
            out = step(*arguments)
        output = _storage_bytes(out, exclude=arguments)
        peak = mem.peak
    kernel_flops = sum(k.traced_flops - before[k.name] for k in KERNELS)
    aten = float(flops.get_total_flops())
    colls = {k: dict(v) for k, v in sharding.COLLECTIVES.items()}
    colls["total"] = sum(v["bytes"] for v in sharding.COLLECTIVES.values())
    return {
        "bytes_per_device": {"argument": argument, "output": output,
                             "temp": max(peak - argument - output, 0),
                             "peak_total": peak},
        "cost": {"flops": aten + kernel_flops, "aten_flops": aten,
                 "kernel_flops": kernel_flops},
        "collectives": colls,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             drop_data: int = 0, global_batch: Optional[int] = None,
             layers: Optional[int] = None, paged: bool = False,
             verbose: bool = True) -> dict:
    """One cell's record (see the module's docstring); ``paged``: a decode
    shape's paged departure."""
    t0 = time.time()
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    try:
        step, arguments, meta = lower_cell(
            arch, shape_name, multi_pod=multi_pod, drop_data=drop_data,
            global_batch=global_batch, layers=layers, paged=paged)
        if step is None:
            rec.update(status="SKIP", skip_reason=meta["skipped"])
            return rec
        rec.update(meta)
        if multi_pod:
            rec["mesh"] = "2x16x16 (pod_as_data: " + meta["mesh"] + ")"
        if global_batch is not None:
            rec["global_batch"] = global_batch
        rec.update(trace(step, arguments))
    except Exception as e:  # a failure here is a fault of the port
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"[:500]
        return rec
    rec["status"] = "OK"
    rec["fits_h100"] = rec["bytes_per_device"]["peak_total"] <= card_bytes()
    rec["seconds"] = round(time.time() - t0, 1)
    if verbose:
        print(json.dumps(rec, default=str), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--json", default=None, help="write records to this file")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(configs.ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    records, fail = [], 0
    for mp in meshes:
        for a in archs:
            for s in shapes:
                # a decode shape of an arch with a KV cache: JAX's cell,
                # then the paged departure beside it
                departure = SHAPES[s].kind == "decode" \
                    and not configs.get_config(a).attn_free
                for paged in (False, True) if departure else (False,):
                    rec = run_cell(a, s, multi_pod=mp, paged=paged)
                    records.append(rec)
                    if rec["status"] not in ("OK", "SKIP"):
                        fail += 1
                        print(json.dumps(rec, default=str), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1, default=str)
    ok = sum(r["status"] == "OK" for r in records)
    sk = sum(r["status"] == "SKIP" for r in records)
    print(f"\n== dry-run: {ok} OK, {sk} skipped, {fail} FAILED "
          f"of {len(records)} cells ==")
    return 1 if fail else 0


if __name__ == "__main__":
    sys.exit(main())
