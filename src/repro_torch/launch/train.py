"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --steps 20 --batch 2 --seq 8192

Random weights from seed 0 (a ``torch.Generator`` on the device), AdamW
(lr 1e-3), the synthetic token stream, and the fault-tolerant runner with
its checkpoints. Attention runs the flash-attention kernel (``attn_impl =
"flash"``, the deployment value); every other op is plain PyTorch. One
device: ``--device cpu`` runs the plain PyTorch path on the CPU (the
kernel's plain version included); by default the launcher needs a CUDA
card and fails without one. ``--plan-cache`` pre-plans the quantized
serving GEMMs of the trained model and saves them for the serve launcher.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

from repro_torch import configs
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import tree_leaves
from repro_torch.data import SyntheticTokenStream
from repro_torch.kernels import planning
from repro_torch.kernels.flash_attention import FLASH_ATTENTION
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import steps as rsteps
from repro_torch.runtime.resilient import RunnerConfig, run_training


@dataclasses.dataclass
class TrainReport:
    """What a run measured: per step (in order of success) the loss, the
    grad norm and the seconds of the train step to a device sync; per step
    the seconds from its end to the next step's start, or to the run's end
    (the checkpoint save where one is due, the old checkpoints' removal,
    the next batch); the runner's history; the flash kernel's launches."""

    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]
    after_step_s: Dict[int, float]
    history: List[Tuple]
    flash_launches: int


def build_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True, choices=list(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--plan-cache", default=None,
                    help="plan-cache JSON: pre-plan this model's quantized "
                         "serving GEMMs after training and persist them, so "
                         "the serve launcher starts with warm plans")
    ap.add_argument("--format", default=None,
                    help="quantization format of the post-training "
                         "serving-GEMM planning pass (default: the config's "
                         "quant_format)")
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> TrainReport:
    args = build_args(argv)
    device = resolve_device(args.device)
    if args.plan_cache and os.path.exists(args.plan_cache):
        if planning.load_plan_cache(args.plan_cache, tolerant=True) < 0:
            print(f"[train] plan cache {args.plan_cache} unreadable; "
                  f"replanning from scratch")

    cfg = (configs.get_reduced if args.reduced else configs.get_config)(
        args.arch)
    if cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: training the moe family is not ported yet (it "
            f"comes with the multi-GPU slice that brings its FSDP/ZeRO-2 "
            f"presets and the load-balancing loss); the port serves it: "
            f"python -m repro_torch.launch.serve --arch {cfg.name}")
    if cfg.family in ("rwkv", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family} family is not ported "
            f"yet (its FSDP/ZeRO-2 presets come with the multi-GPU slice); "
            f"the port serves it: python -m repro_torch.launch.serve "
            f"--arch {cfg.name}")
    if cfg.family == "encdec" or cfg.vision_prefix:
        kind = "encdec" if cfg.family == "encdec" else "vision-prefix"
        raise NotImplementedError(
            f"{cfg.name}: training {kind} archs is not ported yet (their "
            f"audio or patch inputs and FSDP/ZeRO-2 presets come with a "
            f"later slice); the port serves it: python -m "
            f"repro_torch.launch.serve --arch {cfg.name}")
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    settings = rsteps.TrainSettings(microbatches=args.microbatches)
    opt_cfg = AdamWConfig(lr=1e-3)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, device=device)
    opt_state = adamw_init(params, opt_cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[train] {cfg.name} ({cfg.family}) params={n_params / 1e6:.2f}M "
          f"device={device}")

    step_fn = rsteps.make_train_step(cfg, opt_cfg, settings)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, batch_size=args.batch,
                                  device=device)

    def batches(step):
        return {"batch": stream.batch_at(step), "step": step}

    losses, gnorms, step_s = [], [], []
    last = {"metrics_t": None, "step": None}
    after_step_s: Dict[int, float] = {}

    def timed_step(params, opt_state, inputs):
        t0 = time.perf_counter()
        if last["metrics_t"] is not None:
            after_step_s[last["step"]] = t0 - last["metrics_t"]
            last["metrics_t"] = None
        out = step_fn(params, opt_state, inputs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - t0)
        return out

    def on_metrics(step, m):
        losses.append(m["loss"])
        gnorms.append(m["grad_norm"])
        last["metrics_t"], last["step"] = time.perf_counter(), step
        if step % 5 == 0:
            print(f"  step {step:4d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f}")

    launches0 = FLASH_ATTENTION.launches
    t0 = time.time()
    params, opt_state, history = run_training(
        cfg=RunnerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        train_step=timed_step, params=params, opt_state=opt_state,
        batches=batches, num_steps=args.steps, on_metrics=on_metrics)
    if last["metrics_t"] is not None:
        after_step_s[last["step"]] = time.perf_counter() - last["metrics_t"]
    dt = time.time() - t0
    launches = FLASH_ATTENTION.launches - launches0
    print(f"[train] done {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"events: {[h[0] for h in history]}")
    print(f"[train] attn: {cfg.attn_impl} (kernel launches {launches})")
    if args.plan_cache:
        # quantize a throwaway copy of the trained tree to enumerate the
        # serving GEMMs, plan them at decode batch M, and persist them
        qparams = T.quantize_params(params, cfg, format=args.format,
                                    min_size=0)
        plans = planning.plan_for_params(qparams, M=args.batch)
        n = planning.save_plan_cache(args.plan_cache)
        print(f"[train] plan cache: {len(plans)} layer GEMMs planned, "
              f"{n} plans -> {args.plan_cache}")
    return TrainReport(losses=losses, grad_norms=gnorms, step_s=step_s,
                       after_step_s=after_step_s, history=history,
                       flash_launches=launches)


if __name__ == "__main__":
    main()
