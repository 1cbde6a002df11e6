"""Serving launcher: quantized continuous-batching paged decode on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b

Weights are drawn at random from ``--seed`` (a ``torch.Generator`` on the
device), quantized at load time to ``--format`` (default the config's, the
paper's ``w4a16_g128``; also ``w8a16_channel`` and ``w4a8_g128``), and
served by ``runtime/engine.py``: every quantized Linear runs the planned
GEMM (``--strategy`` forces one, e.g. ``decoupled``) and paged attention
runs on the planned path (on CUDA: the hand-written kernels).
``--no-quant`` serves the dense weights, every Linear a ``torch.matmul``:
the FP16×FP16 yardstick, not a kernel path. ``--device cpu`` runs the
plain PyTorch paths; by default the launcher needs a CUDA card and fails
without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import quant
from repro_torch.core.device import resolve_device
from repro_torch.kernels import planning
from repro_torch.launch.presets import serve_settings_for
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Request, ServingEngine


def build_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's small test config")
    ap.add_argument("--batch", type=int, default=4,
                    help="engine slot count (max concurrent requests)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="alias for --batch")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16,
                    help="tokens generated per request")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (default: the slot count)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV tokens per block (default: the arch preset)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prompt tokens per slot per engine step "
                         "(default: the arch preset)")
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
    ap.add_argument("--verbose", action="store_true")
    return ap.parse_args(argv)


def validate_kv_format(kv_format: str, weight_format: str) -> str:
    """Resolve the ``--kv-format`` × ``--format`` pair up front, so a bad
    name fails with the registries' vocabulary before any weight is
    drawn. Every registered pair is executable (the port serves from the
    paged cache only)."""
    quant.get_format(weight_format)
    return quant.get_kv_format(kv_format).name


def make_requests(cfg, n: int, prompt_len: int, gen: int, seed: int):
    """``n`` random prompts of ``prompt_len`` tokens (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(n, prompt_len))
    return [Request(rid=i, prompt=toks[i].astype(np.int32),
                    max_new_tokens=gen) for i in range(n)]


def build(args: argparse.Namespace):
    """The engine and the requests that ``args`` describe (weights drawn
    and quantized on the device); returns ``(engine, requests)``."""
    device = resolve_device(args.device)
    cfg = (configs.get_reduced if args.reduced else configs.get_config)(
        args.arch)
    sset = serve_settings_for(args.arch)
    fmt = quant.get_format(args.format or cfg.quant_format)
    kv_format = validate_kv_format(args.kv_format or sset.kv_format,
                                   fmt.name)
    cfg = dataclasses.replace(cfg, w4a16_strategy=args.strategy,
                              quant_format=fmt.name)

    t0 = time.perf_counter()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = T.init_params(gen, cfg, device=device)
    if args.no_quant:
        print(f"[serve] {cfg.name} dense {str(cfg.dtype).split('.')[-1]} "
              f"weights (--no-quant) on {device}; built in "
              f"{time.perf_counter() - t0:.1f} s")
    else:
        params = T.quantize_params(params, cfg, min_size=0)
        qbytes = sum(leaf.nbytes_packed()
                     for leaf in planning.quantized_leaves(params))
        print(f"[serve] {cfg.name} {fmt.name} ({args.strategy}) on "
              f"{device}; quantized weights {qbytes / 1e6:.1f} MB; built "
              f"in {time.perf_counter() - t0:.1f} s")

    B = args.max_batch or args.batch
    R = args.requests or B
    engine = ServingEngine(
        cfg, params, max_batch=B, max_prompt_len=args.prompt_len,
        max_new_tokens=args.gen,
        page_size=args.page_size or sset.page_size,
        prefill_chunk=args.prefill_chunk or sset.prefill_chunk,
        kv_format=kv_format, attn_path=args.attn_path or sset.attn_path,
        device=device)
    print(f"[serve] engine: {B} slots, cache_len {engine.cache_len}, paged "
          f"KV {engine.num_pages} blocks x {engine.page_size} tokens "
          f"({engine.pages_slot}/slot), kv_format {engine.kv_format}, "
          f"prefill_chunk {engine.prefill_chunk}")
    print(f"[serve] attn path: decode {engine.attn_path} "
          f"(kv_partitions={engine.kv_partitions}), prefill "
          f"{engine.prefill_attn_path} "
          f"(kv_partitions={engine.prefill_kv_partitions})")
    for lk, plan in sorted(engine.plans.items()):
        print(f"[serve]   plan {lk}: {plan.strategy} split_k={plan.split_k}")

    return engine, make_requests(cfg, R, args.prompt_len, args.gen,
                                 args.seed)


def main(argv=None):
    """Build, serve, print the report; returns the ``ServeReport``."""
    args = build_args(argv)
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
    report = engine.run(reqs, verbose=args.verbose)
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
    print(f"[serve] pages: peak {report.peak_pages} in use")
    print(f"[serve] sample generation (request 0): {report.results[0]}")
    if args.plan_cache:
        n = planning.save_plan_cache(args.plan_cache)
        c = planning.PLAN_CACHE
        print(f"[serve] plan cache: {n} plans -> {args.plan_cache} "
              f"({c.hits} hits / {c.misses} misses this run)")
    return report


if __name__ == "__main__":
    main()
