"""Training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --steps 20 --batch 2 --seq 8192

Every family trains on one device, as with the JAX launcher: random weights
from seed 0 (a ``torch.Generator`` on the device), AdamW (lr 1e-3), the
synthetic token stream with the arch's vision patches or audio frames
(:func:`extra_inputs`, drawn once), and the fault-tolerant runner with its
checkpoints. A config whose training state cannot fit on the device is
refused before anything is allocated (:func:`check_fits`; on an 80 GB
card that is, outside ``--reduced``, every arch but danube, hymba,
whisper and internvl2). Attention runs the flash-attention kernel
(``attn_impl = "flash"``, the deployment value); every other op is plain
PyTorch. One device: ``--device cpu`` runs the plain PyTorch path on the
CPU (the kernel's plain version included); by default the launcher needs
a CUDA card and fails without one. ``--plan-cache`` pre-plans the quantized
serving GEMMs of the trained model and saves them for the serve launcher.

On the card the train step is compiled, as JAX's launcher jits it:
``steps.jit_train_step``, one CUDA graph for every step (the step is fed
as a 0-d int32 tensor on the card), the parameters and AdamW state
donated. ``--eager`` runs the eager step; on the CPU the step runs
eagerly. The run ends with ``[train] steps: compiled (CUDA graphs: <n>
captured, ...)`` or ``[train] steps: eager (<why>)``. A capture that
fails raises; nothing falls back to the eager step.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

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


# bytes a parameter at the update's peak: bf16 weights, gradients and new
# weights (2 B each), old and new fp32 AdamW m and v (the update is
# functional: the new trees are made beside the old ones). Peak device
# memory of full-width training steps on an H100 came within 5 % of
# ``train_bytes`` (chip_smoke.py phase 12)
TRAIN_BYTES_PER_PARAM = 2 + 2 + 2 + 8 + 8
# the update's fp32 temporaries of a leaf (the clipped gradient, the step,
# the weights in fp32), counted for the largest leaf
LEAF_TEMP_BYTES = 12
# one H100's memory: the bound of ``check_fits`` on the CPU
CARD_BYTES = 80 * 2 ** 30


@dataclasses.dataclass
class TrainReport:
    """What a run measured: per step (in order of success) the loss, the
    grad norm and the seconds of the train step to a device sync; per step
    the seconds from its end to the next step's start, or to the run's end
    (the checkpoint save where one is due, the old checkpoints' removal,
    the next batch); the runner's history; the flash kernel's launches.
    ``first_step_s`` is the first call's seconds (compiled: the eager
    warm-up and the capture), which ``step_s`` holds too, ahead of the
    replays'; ``steps`` says how the steps ran (the closing line's text)
    and ``graphs`` is the compiled step's pool (None: eager)."""

    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]
    after_step_s: Dict[int, float]
    history: List[Tuple]
    flash_launches: int
    first_step_s: float
    steps: str
    graphs: Optional[rsteps.GraphPool]


def extra_inputs(cfg, batch_size: int, gen: torch.Generator,
                 device) -> Dict[str, torch.Tensor]:
    """The non-token inputs of a training batch, drawn once from ``gen``
    in ``cfg.dtype`` (the counterpart of JAX's ``extra_inputs``): vision
    patches ``vision_embeds`` (B, vision_prefix, d) for a vision-prefix
    arch, audio frames ``audio_embeds`` (B, encoder_seq, d) for encdec."""
    shapes = {}
    if cfg.vision_prefix:
        shapes["vision_embeds"] = (batch_size, cfg.vision_prefix,
                                   cfg.d_model)
    if cfg.family == "encdec":
        shapes["audio_embeds"] = (batch_size, cfg.encoder_seq, cfg.d_model)
    return {k: torch.randn(shape, generator=gen, device=device)
            .to(cfg.dtype) for k, shape in shapes.items()}


def largest_leaf(cfg) -> int:
    """Elements of the largest stacked leaf: the embedding or head, an
    expert or MLP stack, or a stack of d x q_dim projections."""
    d, L = cfg.d_model, cfg.num_layers
    return max(cfg.padded_vocab * d, L * max(1, cfg.num_experts) * d
               * cfg.d_ff, L * d * cfg.q_dim)


def train_bytes(cfg, per_param: int = TRAIN_BYTES_PER_PARAM) -> int:
    """Device bytes of ``cfg``'s training state at the update's peak:
    ``per_param`` bytes a parameter plus ``LEAF_TEMP_BYTES`` an element
    of the largest leaf. Activations are not counted."""
    return per_param * cfg.param_count() + LEAF_TEMP_BYTES * largest_leaf(cfg)


def check_fits(cfg, device) -> None:
    """Refuse, before anything is allocated, a config whose training state
    (``train_bytes``: weights, gradients, AdamW moments and the update's
    copies, not the activations) passes the device's memory. The
    launcher trains the config at its full depth, so this is the config
    checked; the message says whether even one layer (and one encoder
    layer) beside the embedding and head would fit. On the CPU the bound
    is one card's ``CARD_BYTES``, so a CPU run refuses what the card
    would."""
    need = train_bytes(cfg)
    have = torch.cuda.get_device_properties(device).total_memory \
        if device.type == "cuda" else CARD_BYTES
    if need <= have:
        return
    one = dataclasses.replace(cfg, num_layers=1,
                              encoder_layers=min(cfg.encoder_layers, 1))
    one_need = train_bytes(one)
    depth = (f"even one of its layers with the embedding and head is "
             f"{one.param_count() / 1e9:.1f} B parameters, "
             f"{one_need / 2**30:.0f} GiB") if one_need > have else \
        (f"a cut to a few layers would fit (one layer with the embedding and "
         f"head: {one_need / 2**30:.0f} GiB), but the launcher trains the "
         f"full depth")
    raise ValueError(
        f"{cfg.name} cannot train on one device: its {cfg.num_layers} "
        f"layers are {cfg.param_count() / 1e9:.1f} B parameters, "
        f"{need / 2**30:.0f} GiB of training state at "
        f"{TRAIN_BYTES_PER_PARAM} B a parameter (bf16 weights, gradients "
        f"and update, old and new fp32 AdamW m and v), over the device's "
        f"{have / 2**30:.0f} GiB; {depth}; train it with --reduced")


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
    ap.add_argument("--eager", action="store_true",
                    help="run the eager train step on the card (default: "
                         "compiled under CUDA graphs)")
    return ap.parse_args(argv)


def steps_line(step_fn, why: Optional[str]) -> str:
    """How the train step ran: compiled, with the graphs it captured, the
    bytes their pool reserved, the capture's seconds and the kernel nodes
    held; or eager and why."""
    if why is not None:
        return f"eager ({why})"
    pool = step_fn.pool
    return (f"compiled (CUDA graphs: {pool.graphs} captured, "
            f"{pool.bytes / 2**20:.1f} MiB in their pool; capture "
            f"{pool.capture_s:.2f} s with the eager first step; "
            f"{pool.kernels} kernel nodes, {pool.nodes} of them held to the "
            f"launch counters)")


def main(argv=None) -> TrainReport:
    args = build_args(argv)
    device = resolve_device(args.device)
    cfg = (configs.get_reduced if args.reduced else configs.get_config)(
        args.arch)
    check_fits(cfg, device)
    if args.plan_cache and os.path.exists(args.plan_cache):
        if planning.load_plan_cache(args.plan_cache, tolerant=True) < 0:
            print(f"[train] plan cache {args.plan_cache} unreadable; "
                  f"replanning from scratch")

    cfg = dataclasses.replace(cfg, attn_impl="flash")
    settings = rsteps.TrainSettings(microbatches=args.microbatches)
    opt_cfg = AdamWConfig(lr=1e-3)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = T.init_params(gen, cfg, device=device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    # the runner holds the only references to the initial state, so that a
    # step holds the state it reads and the one it makes, and no third copy
    initial = [params, adamw_init(params, opt_cfg)]
    del params
    print(f"[train] {cfg.name} ({cfg.family}) params={n_params / 1e6:.2f}M "
          f"device={device}")

    why = "--eager" if args.eager else rsteps.eager_reason(device)
    step_fn = (rsteps.make_train_step if why else rsteps.jit_train_step)(
        cfg, opt_cfg, settings)
    stream = SyntheticTokenStream(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, batch_size=args.batch,
                                  device=device)

    ex = extra_inputs(cfg, args.batch, gen, device)

    def batches(step):
        # a 0-d device tensor, as JAX feeds jnp.int32: one graph serves
        # every step
        return {"batch": {**stream.batch_at(step), **ex},
                "step": torch.full((), step, dtype=torch.int32,
                                   device=device)}

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
    timed_step.donates = getattr(step_fn, "donates", False)

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
        train_step=timed_step, params=initial.pop(0),
        opt_state=initial.pop(0), batches=batches, num_steps=args.steps,
        on_metrics=on_metrics)
    if last["metrics_t"] is not None:
        after_step_s[last["step"]] = time.perf_counter() - last["metrics_t"]
    dt = time.time() - t0
    launches = FLASH_ATTENTION.launches - launches0
    print(f"[train] done {args.steps} steps in {dt:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"events: {[h[0] for h in history]}")
    print(f"[train] attn: {cfg.attn_impl} (kernel launches {launches})")
    steps = steps_line(step_fn, why)
    later = sorted(step_s[1:])
    print(f"[train] steps: {steps}; first step {step_s[0]:.3f} s" + (
        f", the later steps' median {later[len(later) // 2]:.4f} s"
        if later else ""))
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
                       flash_launches=launches, first_step_s=step_s[0],
                       steps=steps, graphs=None if why else step_fn.pool)


if __name__ == "__main__":
    main()
