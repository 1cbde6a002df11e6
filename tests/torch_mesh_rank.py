"""Multi-rank runs of the port's sharded serving engine for the CPU tests.

:func:`spawn` starts ``world`` processes of this file, each a gloo rank
joined through a ``file://`` store (no TCP port), hands them one pickled
job and collects each rank's pickled results. A job is a list of cases;
each case serves a set of requests through ``ServingEngine(mesh=...)`` at
a (data, model) mesh over the same world, on numpy weights converted with
``repro_torch.convert.from_jax_params`` (``force_fused`` lets the
planner pick the fused paged-attention path on the CPU, whose wrapper then
runs the kernel's plain version). This file imports torch and
``repro_torch`` only (never jax), and runs every rank with one thread.
A rank that fails or hangs past the timeout fails the whole spawn.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


def spawn(world: int, job: dict, tmp_path, *, timeout: float = 240.0):
    """Run ``job`` on ``world`` gloo ranks; returns ``[rank 0's results,
    ...]``, each ``{case name: result}``. Raises with the ranks' output
    when one fails or the timeout passes (every rank is then killed)."""
    tmp = str(tmp_path)
    payload = os.path.join(tmp, "job.pkl")
    with open(payload, "wb") as f:
        pickle.dump(job, f)
    store = os.path.join(tmp, "store")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world),
         store, payload, tmp], env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(
                    p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for f in logs:
        f.seek(0)
        out.append(f.read())
        f.close()
    codes = [p.returncode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(
            f"ranks exited {codes} (timeout {timeout} s):\n" + "\n".join(
                f"--- rank {r} ---\n{text[-3000:]}"
                for r, text in enumerate(out)))
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def run_case(case: dict, weights: dict) -> dict:
    """Serve ``case`` on this rank: the engine's tokens, report counters,
    plan keys, the rank's attention heads and mesh coordinates, and a
    digest of its final KV pool."""
    import dataclasses
    import hashlib

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.convert import from_jax_params
    from repro_torch.kernels import planning
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime.engine import Request, ServingEngine

    cfg = configs.get_reduced(case["arch"])
    cfg = dataclasses.replace(cfg, **case.get("cfg", {}))
    params = from_jax_params(weights[case["weights"]], dtype=cfg.dtype,
                             device="cpu")
    fused = planning._ATTN_REGISTRY["fused"]
    if case.get("force_fused"):
        # the fused paged-attention path on the CPU: its wrapper runs the
        # kernel's plain version on CPU tensors (this case only)
        planning.register_attn_path("fused", cost=fused.cost,
                                    supports=lambda p: p.paged)
    mesh = make_local_mesh(*case["mesh"])
    planning.PLAN_CACHE.clear()
    try:
        eng = ServingEngine(cfg, params, mesh=mesh, device="cpu",
                            **case["engine"])
    finally:
        planning._ATTN_REGISTRY["fused"] = fused
    reqs = [Request(rid=r["rid"], prompt=np.asarray(r["prompt"]),
                    max_new_tokens=r["max_new_tokens"],
                    arrival_step=r.get("arrival_step", 0),
                    prefix_embeds=r.get("prefix_embeds"))
            for r in case["requests"]]
    rep = eng.run(reqs)
    pool = hashlib.sha256()
    for t in eng.last_state["cache"]["kv"]:
        if t is not None:
            pool.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return {
        "tokens": {int(k): [int(t) for t in v]
                   for k, v in sorted(rep.results.items())},
        "warm_hits": rep.warm_hits, "steps": rep.steps,
        "prefill_steps_saved": rep.prefill_steps_saved,
        "peak_pages": rep.peak_pages,
        "plans": sorted(eng.plans),
        "cached": sorted((p.M, p.K, p.N) for p in planning.PLAN_CACHE._plans),
        "heads": (eng.cfg.num_heads, eng.cfg.num_kv_heads),
        "attn_path": (eng.attn_path, eng.prefill_attn_path,
                      eng.verify_attn_path),
        "pool": pool.hexdigest(),
        "coords": (eng.layout.dp_rank, eng.layout.tp_rank),
    }


def main(rank: int, world: int, store: str, payload: str, out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    torch.set_num_threads(1)
    tmesh.init_process_group("cpu", init_method=f"file://{store}",
                             rank=rank, world_size=world)
    with open(payload, "rb") as f:
        job = pickle.load(f)
    results = {case["name"]: run_case(case, job["weights"])
               for case in job["cases"]}
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
