#!/usr/bin/env python3
"""How far hymba-1.5b's bf16 training moments move with the attention's
summation order alone, against how far the flash kernel moves them.

    python3 scripts/hymba_bf16_spread.py [SEED ...]      (default 0 1 2 3)

Needs one CUDA card. For each seed (the weights' and the token stream's),
hymba-1.5b at full width and depth, bf16, remat, 2 x 1280 tokens (phase
12's cell of ``chip_smoke.py``) takes two ``make_train_step`` steps three
times from the same weights and batches: through the flash kernel, through
the chunked attention at its default 1024-row chunks, and through the
chunked attention at 512-row chunks (a second plain order). It prints, per
seed, ``chip_smoke.py``'s phase-12 readings (loss and grad norm |d|/|ref|
per step, and m and v after step 2 as max|d| / max|ref| per leaf) for flash
against chunked and for 512 against 1024 chunks, and last a JSON line of
them all. This is the evidence behind holding hymba's two paths in fp32
(``chip_smoke.FP32_HELD``)."""
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

ARCH, B, S = "hymba-1.5b", 2, 1280


def readings(torch, a, ta, b, tb):
    """Per step loss and grad norm |a - b| / |b|; m and v per-leaf max."""
    out = {f"step {i} {name}": abs(a[i][j] - b[i][j]) / abs(b[i][j])
           for i in range(cs.FAMILY_STEPS)
           for j, name in enumerate(("loss", "grad_norm"))}
    for name in ("m", "v"):
        out[name], out[name + " worst"] = cs.max_rel_diff(torch, ta[name],
                                                          tb[name])
    return out


def main(seeds) -> int:
    import torch
    if not torch.cuda.is_available():
        print("hymba_bf16_spread: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.data import SyntheticTokenStream
    from repro_torch.kernels import build
    from repro_torch.models import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = cs.card_line()
    cs.log("spread", card)
    table = cs.kernel_table()
    build.build_all([table["flash_attention"][0]])
    cfg = cs.family_config(ARCH, None)
    base = attention.chunked_attention
    results = {}
    for seed in seeds:
        stream = SyntheticTokenStream(vocab_size=cfg.vocab_size, seq_len=S,
                                      batch_size=B, seed=seed, device=dev)
        batches = [stream.batch_at(i) for i in range(cs.FAMILY_STEPS)]
        runs = {}
        for name, impl, chunk in (("flash", "flash", None),
                                  ("chunked 1024", "chunked", None),
                                  ("chunked 512", "chunked", 512)):
            if chunk is not None:
                attention.chunked_attention = functools.partial(
                    base, q_chunk=chunk, kv_chunk=chunk)
            try:
                mk, tk, _ = cs.family_run(torch, dev, cfg, impl, batches,
                                          table, seed=seed)
            finally:
                attention.chunked_attention = base
            runs[name] = (mk, cs.tree_to(torch, tk, "cpu"))
            del tk
            torch.cuda.empty_cache()
        ref = runs["chunked 1024"]
        results[seed] = {
            "flash vs chunked 1024": readings(torch, *runs["flash"], *ref),
            "chunked 512 vs chunked 1024": readings(
                torch, *runs["chunked 512"], *ref)}
        for pair, r in results[seed].items():
            cs.log("spread", f"seed {seed} {pair}: " + ", ".join(
                f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                for k, v in r.items()) + f" (bound m {cs.TRAIN_TOL['m']}, "
                f"v {cs.TRAIN_TOL['v']}) [{card}]")
        del runs, ref
    print(json.dumps({"card": card, "arch": ARCH, "tokens": [B, S],
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [0, 1, 2, 3]))
