"""Serving launcher: quantized continuous-batching paged decode on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b

Weights are drawn at random from ``--seed`` (a ``torch.Generator`` on the
device), quantized at load time to ``--format`` (default the config's, the
paper's ``w4a16_g128``; also ``w8a16_channel`` and ``w4a8_g128``), and
served by ``runtime/engine.py``: every quantized Linear runs the planned
GEMM (``--strategy`` forces one, e.g. ``decoupled``) and paged attention
runs on the planned path (on CUDA: the hand-written kernels).
``--no-quant`` serves the dense weights, every Linear a ``torch.matmul``:
the FP16×FP16 yardstick, not a kernel path. The attention-free rwkv archs
hold no KV cache (no pages, no attention path). Each request of a
vision-prefix arch (internvl2-1b) carries random patch embeddings, and of
an encdec arch (whisper-small) random audio frames, drawn from ``--seed``
and the request's index; on CUDA the encoder's self-attention runs the
flash kernel (``attn_impl = "flash"``). ``--device cpu`` runs the
plain PyTorch paths; by default the launcher needs a CUDA card and fails
without one.

The weights are built one of two ways, chosen by :func:`plan_build` from
the shapes before any weight is drawn: whole (``T.init_params``: the
stacked dense tree, then ``T.quantize_params``), or, for a dense or MoE
arch whose whole build would pass one 80 GiB card, streamed
(``T.init_serving_params``: drawn and quantized layer by layer, so the
device holds the packed tree so far and one leaf's transients). That is
how mixtral-8x7b (87 GiB of bf16 weights, about 24 GiB packed) and
granite-20b serve at full depth on one card. The two builds draw different
random streams, so the choice rests on the arch alone: ``--arch`` and
``--seed`` fix the weights whatever the traffic or the device. A config
whose build, or its packed weights beside the KV pool, would not fit the
device is refused before anything is drawn (on the CPU the bound is one
card's 80 GiB, as the training launcher's ``check_fits``).

``--ring`` serves from per-slot ring KV caches instead of the paged pool
(``ServingEngine(paged=False)``, the JAX package's ring engine: each prompt
prefills whole at admit, on the card through the flash kernel; no sharing,
no speculation, no quantized KV format). ``--refine-plans`` runs the W4A16
plans through the planner's refine pass (``kernels/autotune.py``).

``--speculate ngram|draft[:layers=N]`` with ``--spec-k`` turns on
speculative decoding (a batched verify step of ``batch x (k+1)``
positions), ``--warm-cache-mb`` keeps released prompt prefixes warm, and
``--arrival-every`` spaces the requests' arrivals. ``--http PORT`` serves
the same requests through the asyncio front door
(``runtime/frontdoor.py``): one real-socket client per request on
127.0.0.1 streaming SSE tokens, through a bounded queue (``--queue-depth``
→ 429, ``--deadline-s`` → 408), with ``GET /metrics`` live.

``--mesh DATAxMODEL`` serves on a (data, model) mesh of ranks, one
process each, every rank drawing the same weights and keeping only its
slice of each leaf as it is drawn (``runtime/sharding.py``):

    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch h2o-danube-1.8b --mesh 2x2

The world size must equal DATA*MODEL. Ranks on one card share it over
``gloo`` (``launch/mesh.py``); only rank 0 prints. Every arch serves on
a mesh (an encdec arch's audio frames are drawn from ``--seed`` on every
rank); ``--http`` does not (one front door would have to feed every
rank's host loop).
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import quant
from repro_torch.core.device import resolve_device
from repro_torch.kernels import planning
from repro_torch.configs.shapes import serve_num_pages
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.presets import serve_settings_for
from repro_torch.launch.train import CARD_BYTES
from repro_torch.models import transformer as T
from repro_torch.runtime import kvcache as kvc
from repro_torch.runtime import sharding, speculative
from repro_torch.runtime.engine import Request, ServingEngine


def device_bytes(device) -> int:
    """The memory of ``device``: a card's own, one card's ``CARD_BYTES``
    for the CPU (a CPU run refuses what the card would)."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return CARD_BYTES


def kv_pool_bytes(cfg, *, batch: int, prompt_len: int, gen: int,
                  page_size: int, kv_format: str) -> int:
    """Bytes of the paged KV pool the engine allocates for ``batch`` slots
    of ``prompt_len`` + ``gen`` tokens (``serve_num_pages`` blocks of
    every layer's pool leaves, as ``ServingEngine`` sizes it; the ring
    engine's windows are the same less the null block); 0 for an
    attention-free arch."""
    if cfg.attn_free:
        return 0
    one = kvc.init_pool(1, page_size, cfg.num_kv_heads, cfg.head_dim,
                        cfg.dtype, kv_format, device="meta")
    block = cfg.num_layers * sum(t.numel() * t.element_size()
                                 for t in one if t is not None)
    return block * serve_num_pages(cfg, prompt_len, gen, page_size=page_size,
                                   max_batch=batch)


@dataclasses.dataclass(frozen=True)
class BuildPlan:
    """The build :func:`plan_build` chose: ``mode`` "whole" or
    "streamed", the reckoned ``bytes`` (``T.BuildBytes``), the KV pool's
    ``kv`` bytes and the device's ``have``."""
    mode: str
    bytes: T.BuildBytes
    kv: int
    have: int

    @property
    def peak(self) -> int:
        return self.bytes.streamed if self.mode == "streamed" \
            else self.bytes.whole

    @property
    def need(self) -> int:
        """The most the device holds at once: the build's peak (the
        packed tree and the build's transient), or the packed tree beside
        the KV pool, which the engine allocates once the build's
        transients are freed."""
        return max(self.peak, self.bytes.packed + self.kv)


def plan_build(cfg, *, quantize: bool = True, kv_bytes: int = 0,
               have: int = CARD_BYTES, mesh: bool = False) -> BuildPlan:
    """Choose the weights' build from the shapes alone
    (``T.serving_build_bytes``), before anything is drawn: "streamed" for
    a dense or MoE arch on one device whose whole build's peak passes one
    card's ``CARD_BYTES``, else "whole". Neither the KV pool nor the
    device moves the choice, so the arch and the seed alone fix the
    weights. A plan whose need passes ``have`` bytes is refused. On a mesh
    each rank keeps its slice of a leaf as it is drawn, which only the
    whole build does (no fit is reckoned there)."""
    est = T.serving_build_bytes(cfg, quantize=quantize)
    if mesh:
        return BuildPlan("whole", est, kv_bytes, have)
    mode = "streamed" if est.streamed is not None \
        and est.whole > CARD_BYTES else "whole"
    plan = BuildPlan(mode, est, kv_bytes, have)
    if plan.need > have:
        gib = 2 ** 30
        raise ValueError(
            f"{cfg.name} cannot serve on one device: its {mode} build "
            f"needs {plan.need / gib:.1f} GiB (the build's peak "
            f"{plan.peak / gib:.1f} GiB; the weights "
            f"{est.packed / gib:.1f} GiB "
            f"{'packed' if quantize else 'dense'} beside the KV pool "
            f"{kv_bytes / gib:.1f} GiB) over the device's "
            f"{have / gib:.1f} GiB")
    return plan


def build_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's small test config")
    ap.add_argument("--batch", type=int, default=4,
                    help="engine slot count (max concurrent requests)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="alias for --batch")
    ap.add_argument("--prompt-len", default="32",
                    help="prompt tokens per request: N, or MIN:MAX for "
                         "uniformly drawn lengths")
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens generated per request")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (default: the slot count)")
    ap.add_argument("--arrival-every", type=int, default=0,
                    help="one request arrives every K engine steps (0 = "
                         "all at step 0; with --http, every K x 10 ms)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV tokens per block (default: the arch preset)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per slot per engine step "
                         "(default: the arch preset)")
    ap.add_argument("--ring", action="store_true",
                    help="per-slot ring KV caches instead of the paged "
                         "pool (whole-prompt prefill at admit; no sharing, "
                         "speculation or quantized KV format)")
    ap.add_argument("--warm-cache-mb", type=float, default=0.0,
                    help="warm prefix retention budget in MiB: released "
                         "page-aligned prefixes stay adoptable and a "
                         "returning prompt skips its prefill; 0 = off")
    ap.add_argument("--speculate", default=None,
                    help="speculative decoding proposer: off (default) | "
                         "ngram[:max_n] | draft[:layers=N]")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens scored per verify step")
    ap.add_argument("--kv-format", default=None,
                    help="KV block format: kv_fp16 | kv8_channel "
                         "(default: the arch preset)")
    ap.add_argument("--attn-path", default=None,
                    choices=["auto", "gather", "fused"],
                    help="paged attention path (default: the arch preset, "
                         "auto = planned: fused on CUDA, gather on CPU)")
    ap.add_argument("--strategy", default="auto",
                    choices=["auto"] + list(planning.available_strategies()),
                    help="quantized GEMM strategy (auto = planned: the "
                         "format's kernel on CUDA, its plain path on CPU)")
    ap.add_argument("--format", default=None,
                    help="weight quantization format (registered: "
                         f"{' | '.join(quant.available_formats())}); "
                         "default: the config's quant_format")
    ap.add_argument("--no-quant", action="store_true",
                    help="serve the dense weights (torch.matmul Linears)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--plan-cache", default=None,
                    help="plan-cache JSON (either package's): loaded before "
                         "serving when it exists, written after")
    ap.add_argument("--refine-plans", action="store_true",
                    help="run the planner's refine pass (the fused W4A16 "
                         "kernel's split_k ranked by kernels/autotune.py)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve through the HTTP front door on 127.0.0.1:"
                         "PORT (0 = any free port), one SSE client per "
                         "request")
    ap.add_argument("--queue-depth", type=int, default=64,
                    help="front-door admission queue bound before 429 "
                         "(--http only)")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="default per-request deadline in seconds, 408 "
                         "once expired (--http only; default and 0: none)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="serve on a (data, model) mesh of ranks, e.g. "
                         "2x4 (launch DATA*MODEL ranks with python -m "
                         "torch.distributed.run)")
    ap.add_argument("--verbose", action="store_true")
    return ap.parse_args(argv)


def parse_prompt_len(spec) -> "tuple[int, int]":
    """``N`` (fixed) or ``MIN:MAX`` (uniform variable length) → bounds."""
    s = str(spec)
    try:
        lo, hi = (int(x) for x in s.split(":", 1)) if ":" in s \
            else (int(s),) * 2
    except ValueError:
        raise ValueError(
            f"--prompt-len must be N or MIN:MAX, got {spec!r}") from None
    if not 0 < lo <= hi:
        raise ValueError(
            f"--prompt-len needs 0 < MIN <= MAX, got {spec!r}")
    return lo, hi


def validate_kv_format(kv_format: str, weight_format: str, *,
                       attn_free: bool = False, paged: bool = True) -> str:
    """Resolve the ``--kv-format`` × ``--format`` pair up front, so a bad
    name fails with the registries' vocabulary before any weight is
    drawn. Every registered pair is executable; KV quantization needs the
    paged cache (the ring stores raw rows in the activation dtype), and
    attention-free archs (rwkv) hold no KV cache for a quantized format to
    apply to."""
    quant.get_format(weight_format)
    kf = quant.get_kv_format(kv_format)
    if kf.quantized and attn_free:
        raise ValueError(
            f"--kv-format {kf.name!r} does not apply to attention-free "
            f"archs — there is no KV cache to quantize; use kv_fp16")
    if kf.quantized and not paged:
        raise ValueError(
            f"--kv-format {kf.name!r} quantizes KV blocks, which requires "
            f"the paged cache; drop --ring (or use --kv-format kv_fp16). "
            f"Registered KV formats: {quant.available_kv_formats()}")
    return kf.name


def request_embeds(cfg, seed: int, i: int) -> dict:
    """Request ``i``'s frontend embeddings, drawn from (``seed``, ``i``) as
    fp32 numpy: (vision_prefix, d) patches and (encoder_seq, d) audio
    frames where the arch takes them."""
    rng = np.random.default_rng([seed, i])
    out = {}
    if cfg.vision_prefix:
        out["prefix_embeds"] = rng.standard_normal(
            (cfg.vision_prefix, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        out["audio_embeds"] = rng.standard_normal(
            (cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return out


def make_requests(cfg, n: int, prompt_len, gen: int, seed: int, *,
                  arrival_every: int = 0):
    """``n`` random prompts (numpy, from ``seed``) of ``prompt_len``
    tokens — an int, or (MIN, MAX) for uniformly drawn lengths — one
    arriving every ``arrival_every`` engine steps, each with its
    :func:`request_embeds`."""
    lo, hi = (prompt_len, prompt_len) if isinstance(prompt_len, int) \
        else prompt_len
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(n, hi))
    lens = [hi] * n if lo == hi else \
        [int(x) for x in rng.integers(lo, hi + 1, size=n)]
    return [Request(rid=i, prompt=toks[i, :lens[i]].astype(np.int32),
                    max_new_tokens=gen, arrival_step=i * arrival_every,
                    **request_embeds(cfg, seed, i))
            for i in range(n)]


def build(args: argparse.Namespace):
    """The engine and the requests that ``args`` describe (weights drawn
    and quantized on the device; with ``--mesh`` this rank's slice of
    them); returns ``(engine, requests)``."""
    device = resolve_device(args.device) if args.mesh is None \
        else tmesh.rank_device(args.device)
    cfg = (configs.get_reduced if args.reduced else configs.get_config)(
        args.arch)
    mesh = layout = None
    if args.mesh is not None:
        if args.http is not None:
            raise ValueError("--http serves one host loop; it does not "
                             "take --mesh")
        mesh = tmesh.parse_mesh(args.mesh, device)
    sset = serve_settings_for(args.arch)
    fmt = quant.get_format(args.format or cfg.quant_format)
    kv_format = validate_kv_format(args.kv_format or sset.kv_format,
                                   fmt.name, attn_free=cfg.attn_free,
                                   paged=not args.ring)
    pmin, pmax = parse_prompt_len(args.prompt_len)
    speculate = None if args.speculate == "off" else args.speculate
    # a bad proposer / spec-k pair fails here, before any weight is drawn
    speculative.validate_speculate(speculate, args.spec_k, cfg=cfg,
                                   paged=not args.ring)
    cfg = dataclasses.replace(cfg, w4a16_strategy=args.strategy,
                              quant_format=fmt.name)
    if device.type == "cuda" and (cfg.family == "encdec" or args.ring):
        # the encoder, and the ring engine's whole-prompt prefill, on the
        # flash kernel
        cfg = dataclasses.replace(cfg, attn_impl="flash")

    if mesh is not None:
        layout = sharding.Layout(cfg, mesh)
        rank_cfg = layout.local_cfg()
        cuts = [f"{what} / {layout.tp}" for what, cut in (
            ("the vocab", layout.vocab_sharded), ("d_ff", layout.ffn_sharded),
            ("d_inner", layout.ssm_sharded)) if cut]
        heads = f"{rank_cfg.num_heads} of {cfg.num_heads} time-mix heads" \
            if cfg.attn_free else \
            f"{rank_cfg.num_heads} of {cfg.num_heads} query heads and " \
            f"{rank_cfg.num_kv_heads} of {cfg.num_kv_heads} KV heads"
        print(f"[serve] mesh {args.mesh} ({torch.distributed.get_backend()})"
              f": each rank holds {heads}" + "".join(", " + c for c in cuts))

    B = args.max_batch or args.batch
    R = args.requests or B
    page_size = args.page_size or sset.page_size
    # the build is chosen (or the config refused) before anything is drawn
    plan = plan_build(
        cfg, quantize=not args.no_quant,
        kv_bytes=kv_pool_bytes(cfg, batch=B, prompt_len=pmax, gen=args.gen,
                               page_size=page_size, kv_format=kv_format),
        have=device_bytes(device), mesh=mesh is not None)

    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    if plan.mode == "streamed":
        params = T.init_serving_params(gen, cfg, device=device,
                                       quantize=not args.no_quant)
    else:
        params = T.init_params(gen, cfg, device=device,
                               cut=None if layout is None else layout.cut)
        if not args.no_quant:
            params = T.quantize_params(params, cfg, min_size=0)
    measured = ""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
        measured = f", {peak / 1e6:.1f} MB measured"
    how = (f"{plan.mode} build" + (
        "; each rank keeps its slices" if mesh is not None else
        f": peak {plan.peak / 1e6:.1f} MB reckoned{measured}, "
        f"{plan.bytes.packed / 1e6:.1f} MB "
        f"{'dense' if args.no_quant else 'packed'}"))
    if args.no_quant:
        print(f"[serve] {cfg.name} dense {str(cfg.dtype).split('.')[-1]} "
              f"weights (--no-quant) on {device}; built in "
              f"{time.perf_counter() - t0:.1f} s ({how})")
    else:
        qbytes = sum(leaf.nbytes_packed()
                     for leaf in planning.quantized_leaves(params))
        print(f"[serve] {cfg.name} {fmt.name} ({args.strategy}) on "
              f"{device}; quantized weights {qbytes / 1e6:.1f} MB; built "
              f"in {time.perf_counter() - t0:.1f} s ({how})")

    engine = ServingEngine(
        cfg, params, max_batch=B, max_prompt_len=pmax,
        max_new_tokens=args.gen,
        page_size=page_size,
        prefill_chunk=args.prefill_chunk or sset.prefill_chunk,
        kv_format=kv_format, paged=not args.ring,
        refine_plans=args.refine_plans, warm_cache_mb=args.warm_cache_mb,
        speculate=speculate, spec_k=args.spec_k,
        admission="priority" if args.http is not None else "fifo",
        attn_path=args.attn_path or sset.attn_path, device=device,
        mesh=mesh)
    print(f"[serve] streams: prompt {pmax} + prefix {cfg.vision_prefix} + "
          f"gen {args.gen}"
          + (f"; {cfg.encoder_layers}-layer encoder over "
             f"{cfg.encoder_seq} frames a request at admit (attention "
             f"{cfg.attn_impl})" if cfg.family == "encdec" else ""))
    if engine.paged:
        print(f"[serve] engine: {B} slots, cache_len {engine.cache_len}, "
              f"paged KV {engine.num_pages} blocks x {engine.page_size} "
              f"tokens ({engine.pages_slot}/slot), kv_format "
              f"{engine.kv_format}, prefill_chunk {engine.prefill_chunk}"
              + (f", warm cache {args.warm_cache_mb:g} MiB"
                 if engine.alloc.warm_bytes else ""))
        print(f"[serve] attn path: decode {engine.attn_path} "
              f"(kv_partitions={engine.kv_partitions}), prefill "
              f"{engine.prefill_attn_path} "
              f"(kv_partitions={engine.prefill_kv_partitions})"
              + (f", verify {engine.verify_attn_path} "
                 f"(kv_partitions={engine.verify_kv_partitions})"
                 if engine.proposer is not None else ""))
    elif engine.attn_path is not None:
        print(f"[serve] engine: {B} slots, ring KV cache_len "
              f"{engine.cache_len} a slot, whole-prompt prefill (attention "
              f"{engine.cfg.attn_impl}); attn path: decode "
              f"{engine.attn_path}")
    else:
        print(f"[serve] engine: {B} slots, cache_len {engine.cache_len}, "
              f"recurrent carries only (no KV cache), "
              + (f"prefill_chunk {engine.prefill_chunk}" if engine.chunked
                 else "whole-prompt prefill"))
    if engine.proposer is not None:
        k = args.spec_k
        print(f"[serve] speculative: proposer {engine.proposer.name!r}, "
              f"k={k} (verify scores {B}x{k + 1} positions a step; GEMMs "
              f"planned at M={B * (k + 1)})")
    for lk, plan in sorted(engine.plans.items()):
        print(f"[serve]   plan {lk}: {plan.strategy} split_k={plan.split_k}")

    reqs = make_requests(cfg, R, (pmin, pmax), args.gen, args.seed,
                         arrival_every=args.arrival_every)
    if pmin != pmax:
        print(f"[serve] prompts: variable length {pmin}:{pmax} (mean "
              f"{sum(len(r.prompt) for r in reqs) / R:.1f})")
    return engine, reqs


def serve_http(engine, reqs, *, port: int, queue_depth: int,
               deadline_s, arrival_every: int):
    """Serve ``reqs`` through the front door on 127.0.0.1: one socket
    client per request, arrivals ``arrival_every`` x 10 ms apart, tokens
    streamed back as SSE. Returns (generations, report); a request the
    door rejected (429/408) comes back as None."""
    from repro_torch.runtime.frontdoor import (FrontDoor, QueueSettings,
                                               sse_decode_tokens)

    async def client(port, req, delay):
        await asyncio.sleep(delay)
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        spec = {"prompt": [int(t) for t in req.prompt],
                "max_new_tokens": req.max_new_tokens,
                "priority": req.priority}
        for name in ("prefix_embeds", "audio_embeds"):
            value = getattr(req, name)
            if value is not None:
                spec[name] = np.asarray(value, np.float32).tolist()
        body = json.dumps(spec).encode()
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: serve\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        payload = await reader.read()
        writer.close()
        if b" 200 " not in payload.split(b"\r\n", 1)[0]:
            return None
        return sse_decode_tokens(payload)

    async def run():
        fd = FrontDoor(engine, settings=QueueSettings(
            queue_depth=queue_depth, default_deadline_s=deadline_s))
        await fd.serve(port=port)
        print(f"[serve] front door: http://{fd.host}:{fd.port} "
              f"(queue_depth {queue_depth}, deadline "
              f"{'none' if deadline_s is None else f'{deadline_s:g} s'})")
        got = await asyncio.gather(*(
            client(fd.port, r, i * arrival_every * 0.01)
            for i, r in enumerate(reqs)))
        return got, await fd.shutdown()

    return asyncio.run(run())


def main(argv=None):
    """Build, serve, print the report; returns the ``ServeReport``. On a
    mesh only rank 0 prints (and writes the plan cache)."""
    args = build_args(argv)
    if args.mesh is None:
        return _main(args)
    quiet = int(os.environ.get("RANK", 0)) != 0
    try:
        with contextlib.redirect_stdout(open(os.devnull, "w")) if quiet \
                else contextlib.nullcontext():
            return _main(args, save=not quiet)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _main(args, save: bool = True):
    if args.plan_cache and os.path.exists(args.plan_cache):
        n = planning.load_plan_cache(args.plan_cache, tolerant=True)
        if n >= 0:
            print(f"[serve] plan cache: loaded {n} plans "
                  f"from {args.plan_cache}")
        else:
            print(f"[serve] plan cache {args.plan_cache} unreadable; "
                  f"replanning from scratch")
    engine, reqs = build(args)
    R = len(reqs)
    t0 = time.perf_counter()
    if args.http is not None:
        got, report = serve_http(
            engine, reqs, port=args.http, queue_depth=args.queue_depth,
            deadline_s=args.deadline_s or None,
            arrival_every=args.arrival_every)
    else:
        report = engine.run(reqs, verbose=args.verbose)
        got = [report.results[r.rid] for r in reqs]
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    ls, ts = report.latency_stats(), report.ttft_stats()
    steps = max(len(report.step_records), 1)
    print(f"[serve] {R} requests in {report.steps} steps / {wall:.2f} s "
          f"wall; prefill {report.prefill_s * 1e3:.1f} ms total")
    print(f"[serve] decode: {report.decode_tokens} tokens in "
          f"{report.decode_s:.3f} s = {report.tokens_per_s:.1f} tok/s "
          f"({report.decode_s / steps * 1e3:.2f} ms/step); latency p50 "
          f"{ls['p50'] * 1e3:.1f} / p99 {ls['p99'] * 1e3:.1f} ms; time to "
          f"first token p50 {ts['p50'] * 1e3:.1f} / p99 "
          f"{ts['p99'] * 1e3:.1f} ms")
    if args.http is not None:
        print(f"[serve] front door: {sum(g is not None for g in got)}/{R} "
              f"served, {report.rejected_429} x 429, {report.rejected_408} "
              f"x 408; peak queue {report.peak_queue_depth}")
    if engine.paged:
        print(f"[serve] pages: peak {report.peak_pages} in use (worst case "
              f"{engine.pages_slot * min(engine.max_batch, R)} without "
              f"sharing); prefill steps saved by shared or warm prefixes "
              f"{report.prefill_steps_saved}"
              + (f"; warm hits {report.warm_hits} / misses "
                 f"{report.warm_misses}" if engine.alloc.warm_bytes else ""))
    if engine.proposer is not None:
        print(f"[serve] speculative: {report.accepted_tokens}/"
              f"{report.proposed_tokens} drafts accepted "
              f"({report.acceptance_rate:.0%}); tok/s above counts "
              f"accepted tokens only")
    print(f"[serve] sample generation (request 0): {got[0]}")
    if args.plan_cache and save:
        n = planning.save_plan_cache(args.plan_cache)
        c = planning.PLAN_CACHE
        print(f"[serve] plan cache: {n} plans -> {args.plan_cache} "
              f"({c.hits} hits / {c.misses} misses this run)")
    return report


if __name__ == "__main__":
    main()
