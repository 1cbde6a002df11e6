"""Multi-rank runs of the port's sharded serving engine and sharded train
step for the CPU tests.

:func:`spawn` starts ``world`` processes of this file, each a gloo rank
joined through a ``file://`` store (no TCP port), hands them one pickled
job and collects each rank's pickled results. A job is a list of cases on
numpy weights converted with ``repro_torch.convert.from_jax_params``. A
serving case (:func:`run_case`) serves a set of requests through
``ServingEngine(mesh=...)`` at a (data, model) mesh over the same world
(``force_fused`` lets the planner pick the fused paged-attention path on
the CPU, whose wrapper then runs the kernel's plain version). A training
case with ``paged=False`` serves on the ring engine and also returns its
ring leaves' shapes and, with ``"step"``, the logits of one whole-prompt
prefill and one decode step run by hand on the rank (:func:`ring_step`).
A training
case (``"train"`` in the case, :func:`run_train_case`) runs a few steps of
``make_train_step(..., mesh=...)`` and returns every step's metrics and
the whole parameters, m and v gathered from the ranks. An elastic case
(``"elastic"`` in the case, :func:`run_elastic_case`) runs ``run_training``
with a scripted hard failure and ``remesh_fn`` dropping a data row
(``launch.mesh.degraded_mesh``): the dropped ranks leave, the survivors
join a fresh group on a new store and go on. This file imports
torch and ``repro_torch`` only (never jax), and runs every rank with one
thread. A rank that fails or hangs past the timeout fails the whole spawn.

Each rank dumps every thread's Python stack if it is killed by a signal
(``faulthandler``: an abort in a C++ thread then names where the rank
was), bounds every collective by ``COLLECTIVE_TIMEOUT`` (a peer that is
gone or stuck raises on the waiting rank with a traceback, within the
spawn's timeout), prints its own traceback on any error, and ends with a
barrier, the process group destroyed and ``os._exit``: interpreter
finalization, which would tear down the objects holding process groups
(device meshes, a layout's part groups) in no set order while gloo's
threads still run, is skipped.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# a collective that waits longer raises on the rank (below the spawn's own
# timeout, so that the rank's traceback reaches its log first)
COLLECTIVE_TIMEOUT = 180.0
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
    kw = dict(case["engine"])
    if case.get("oracle"):
        kw["speculate"] = oracle_proposer(**case["oracle"])
    try:
        eng = ServingEngine(cfg, params, mesh=mesh, device="cpu", **kw)
    finally:
        planning._ATTN_REGISTRY["fused"] = fused
    reqs = [Request(rid=r["rid"], prompt=np.asarray(r["prompt"]),
                    max_new_tokens=r["max_new_tokens"],
                    arrival_step=r.get("arrival_step", 0),
                    prefix_embeds=r.get("prefix_embeds"),
                    audio_embeds=r.get("audio_embeds"))
            for r in case["requests"]]
    rep = eng.run(reqs)
    pool = hashlib.sha256()
    state = eng.last_state
    for t in state["cache"].get("kv", ()):
        if t is not None:
            pool.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    # the per-slot state's and the bare leaves' shapes on this rank
    shapes = {k: tuple(v.shape) for k, v in state["cache"].items()
              if k != "kv"}
    if "enc_kv" in state:
        shapes["enc_kv"] = tuple(state["enc_kv"][0].shape)
    lp = eng.params["layers"][0]
    for name, leaf in (("w_bias", lp.get("w_bias")),
                       ("A_log", lp.get("ssm", {}).get("A_log")),
                       ("D", lp.get("ssm", {}).get("D"))):
        if leaf is not None:
            shapes[name] = tuple(leaf.shape)
    out = {}
    ring = state["cache"].get("kv")
    if not eng.chunked and ring is not None:
        out["ring"] = {name: tuple(t.shape)
                       for name, t in zip(("k", "v", "pos"), ring)}
        if case.get("step"):
            out["step"] = ring_step(eng, reqs[0])
    return {
        **out,
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
        "shapes": shapes,
        "speculated": (rep.proposed_tokens, rep.accepted_tokens),
        "side_rows": len(eng._side),
        "steps_note": eng.steps_note,
        "logits": {int(k): v.float().numpy()
                   for k, v in sorted(rep.prefill_logits.items())},
    }


def ring_step(eng, req) -> dict:
    """On a fresh ring state: ``req``'s whole-prompt prefill into slot 0,
    then one decode step of every slot with slot 0 at its first decode
    position and its first token (the other slots at position 0, token
    0). Returns the prefill's logits (V,) and the step's logits of the
    rows this rank runs, with those rows' indices."""
    import numpy as np
    import torch

    from repro_torch.runtime.engine import insert_slot

    with torch.no_grad():
        state = eng._init_state()
        inputs = eng._prefill_inputs(req)
        logits, rstate = eng._prefill(eng.params, inputs)
        j = eng._local_row(0)
        if j is not None:
            insert_slot(state, rstate, j)
        tok = np.zeros(eng.max_batch, np.int64)
        pos = np.zeros(eng.max_batch, np.int64)
        tok[0], pos[0] = int(torch.argmax(logits[0])), eng.pos0(req)
        res = eng._serve_step()(eng.params, {
            "state": state, "tokens": torch.as_tensor(tok),
            "pos": torch.as_tensor(pos)})
    rows = eng._slot_rows or slice(0, eng.max_batch)
    return {"prefill": logits[0].numpy(), "decode": res["logits"].numpy(),
            "rows": list(range(rows.start, rows.stop)), "tok": tok,
            "pos": pos}


def oracle_proposer(plain, right, bad, base=None):
    """A proposer (on ``base``, either package's Proposer; the port's by
    default) that drafts the plain run's next tokens (``plain``: rid →
    the tokens a run without speculation emits), the first ``right`` of
    them right and the rest ``bad``: each verify step accepts up to
    ``right`` drafts, so carries commit at checkpoints past 1."""
    if base is None:
        from repro_torch.runtime.speculative import Proposer as base

    class Oracle(base):
        name = "ngram"

        def reset(self, engine):
            self.prompts = {}

        def admit(self, engine, i, slot):
            self.prompts[i] = (slot.req.rid, len(slot.prompt_ids))

        def propose(self, views, k):
            out = {}
            for v in views:
                rid, n = self.prompts[v.slot]
                done = len(v.context) - n
                want = plain[rid][done:done + k]
                out[v.slot] = [t if j < right else bad
                               for j, t in enumerate(want)]
            return out

    return Oracle()


def run_train_case(case: dict, weights: dict) -> dict:
    """Train ``case`` on this rank: ``case["train"]`` holds the
    ``TrainSettings`` fields (dtypes by name; AdamW's moments in
    ``opt_dtype``) and the numpy
    ``batches``; the weights and AdamW's fresh state are cut to the rank's
    shares. With ``ckpt_dir`` the steps run through ``run_training``
    twice: all but the last step with a checkpoint after each, then a
    second runner from the initial shares, which resumes from the last
    checkpoint and runs the last step. Returns per step (loss, grad norm)
    and, gathered whole from the ranks to rank 0, the parameters, m and v
    as numpy (None on the other ranks); whether cutting the initial
    weights and gathering them back gave them bit for bit (rank 0); the
    runners' histories."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.convert import from_jax_params
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import steps
    from repro_torch.runtime.resilient import RunnerConfig, run_training

    cfg = dataclasses.replace(configs.get_reduced(case["arch"]),
                              **case.get("cfg", {}))
    tr = dict(case["train"])
    batches = tr.pop("batches")
    ckpt_dir = tr.pop("ckpt_dir", None)
    for name, default in (("grad_dtype", "bfloat16"),
                          ("opt_dtype", "float32")):
        tr[name] = getattr(torch, tr.get(name, default))
    settings = steps.TrainSettings(**tr)
    mesh = make_local_mesh(*case["mesh"])
    opt_cfg = AdamWConfig(lr=1e-3, state_dtype=settings.opt_dtype)
    step_fn = steps.make_train_step(cfg, opt_cfg, settings, mesh=mesh)
    shards = step_fn.shards
    whole0 = from_jax_params(weights[case["weights"]], dtype=cfg.dtype,
                             device="cpu")
    params = shards.cut(whole0)
    back = shards.whole(params)
    identity = back is None or all(
        torch.equal(a, b) for a, b in zip(_leaves(back), _leaves(whole0)))
    state = adamw_init(params, opt_cfg)
    metrics, histories = [], []

    def inputs(i):
        return {"batch": {k: torch.from_numpy(v)
                          for k, v in batches[i].items()}, "step": i}

    if ckpt_dir is None:
        for i in range(len(batches)):
            params, state, m = step_fn(params, state, inputs(i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    else:
        def on_metrics(i, m):
            metrics.append((m["loss"], m["grad_norm"]))
        run = RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=1)
        for n in (len(batches) - 1, len(batches)):
            params, state, hist = run_training(
                cfg=run, train_step=step_fn, params=shards.cut(whole0),
                opt_state=adamw_init(shards.cut(whole0), opt_cfg),
                batches=inputs, num_steps=n, on_metrics=on_metrics,
                shards=shards)
            histories.append(hist)

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.float().numpy()

    whole = shards.whole_state({"params": params, "opt": state})
    lay = shards.layout
    out = {"metrics": metrics, "count": int(state["count"]),
           "coords": (lay.dp_rank, lay.tp_rank),
           "heads": (lay.local_cfg().num_heads,
                     lay.local_cfg().num_kv_heads),
           "share_elems": sum(t.numel() for t in _leaves(params)),
           "identity": identity, "histories": histories,
           "params": None, "m": None, "v": None}
    if whole is not None:
        out.update(params=host(whole["params"]), m=host(whole["opt"]["m"]),
                   v=host(whole["opt"]["v"]))
    return out


def run_elastic_case(case: dict, weights: dict, store: str) -> dict:
    """``run_training`` of ``case["elastic"]`` on this rank of a (data,
    model) mesh: each data rank takes ``rows`` rows of every batch (the
    global batch is ``rows`` x the data axis, so it shrinks with it), a
    checkpoint after every step. ``fail_at``: a hard failure at that step
    (every retry fails), after which ``remesh_fn`` drops the last data row
    and rebuilds the step on the survivors' mesh (new store
    ``{store}.degraded``). ``slow``: {rank: step} — that rank's clock finds
    the step past ``step_timeout_s`` (the runner's straggler check), no
    other rank's does. Returns the history, the metrics and, gathered to
    rank 0 of the final mesh, the whole parameters, m and v; ``left`` on a
    rank that left."""
    import dataclasses
    import datetime

    import torch

    from repro_torch import configs
    from repro_torch.convert import from_jax_params
    from repro_torch.launch import mesh as tmesh
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import resilient, steps
    from repro_torch.runtime.resilient import RunnerConfig, run_training

    cfg = dataclasses.replace(configs.get_reduced(case["arch"]),
                              **case.get("cfg", {}))
    el = dict(case["elastic"])
    pool, rows = el.pop("batches"), el.pop("rows")
    fail_at, slow = el.pop("fail_at", None), el.pop("slow", {})
    ckpt_dir, timeout = el.pop("ckpt_dir"), el.pop("step_timeout_s", 3600.0)
    for name, default in (("grad_dtype", "bfloat16"),
                          ("opt_dtype", "float32")):
        el[name] = getattr(torch, el.get(name, default))
    settings = steps.TrainSettings(**el)
    opt_cfg = AdamWConfig(lr=1e-3, state_dtype=settings.opt_dtype)
    now = {"mesh": tmesh.make_local_mesh(*case["mesh"])}
    now["step"] = steps.make_train_step(cfg, opt_cfg, settings,
                                        mesh=now["mesh"])
    first = now["mesh"]
    me = torch.distributed.get_rank()
    real_time = resilient.time
    if me in slow:
        # the runner reads the clock twice a step (start, check): this
        # rank's check of step slow[me] reads past the timeout
        calls = iter(range(1 << 30))
        late = 2 * slow[me] + 1

        class Clock:
            @staticmethod
            def time():
                extra = 2 * timeout if next(calls) == late else 0.0
                return real_time.time() + extra
        resilient.time = Clock

    def batches(i):
        dp = now["mesh"].size(0)
        return {"batch": {k: torch.from_numpy(v[:rows * dp])
                          for k, v in pool[i].items()}, "step": i}

    def remesh_fn():
        now["mesh"] = tmesh.degraded_mesh(
            now["mesh"], drop_data=1, init_method=f"file://{store}.degraded",
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
        now["step"] = steps.make_train_step(cfg, opt_cfg, settings,
                                            mesh=now["mesh"])
        return now["step"]

    metrics = []
    whole0 = from_jax_params(weights[case["weights"]], dtype=cfg.dtype,
                             device="cpu")
    params = now["step"].shards.cut(whole0)
    try:
        params, state, hist = run_training(
            cfg=RunnerConfig(ckpt_dir=ckpt_dir, ckpt_every=1,
                             step_timeout_s=timeout),
            train_step=now["step"], params=params,
            opt_state=adamw_init(params, opt_cfg), batches=batches,
            num_steps=len(pool),
            inject_failure=None if fail_at is None else (
                lambda s, r: s == fail_at and now["mesh"] is first),
            remesh_fn=remesh_fn, shards=now["step"].shards,
            on_metrics=lambda i, m: metrics.append(
                (i, m["loss"], m["grad_norm"])))
    except tmesh.LeftMesh:
        return {"left": True, "rank": me, "metrics": metrics}
    finally:
        resilient.time = real_time

    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        return tree.float().numpy()

    whole = now["step"].shards.whole_state({"params": params, "opt": state})
    out = {"left": False, "rank": me, "history": hist, "metrics": metrics,
           "mesh": tuple(now["mesh"].shape), "params": None, "m": None,
           "v": None}
    if whole is not None:
        out.update(params=host(whole["params"]), m=host(whole["opt"]["m"]),
                   v=host(whole["opt"]["v"]))
    return out


def run_ops_case(case: dict, weights: dict) -> dict:
    """The autograd-aware collectives on this rank of a (1, tp) mesh, on
    ``case["ops"]``'s numpy inputs: a Megatron MLP (``copy_to_model``,
    the rank's columns of ``w1`` and rows of ``w2``,
    ``reduce_over_model``) and a vocab-cut head (``copy_to_model``, the
    rank's columns of ``wv``, ``gather_over_model``), each under a fixed
    cotangent. Returns the outputs and the gradients of x and of the
    rank's slices."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime.sharding import Layout

    ops = {k: torch.from_numpy(v) for k, v in case["ops"].items()}
    mesh = make_local_mesh(*case["mesh"])
    lay = Layout(configs.get_reduced("h2o-danube-1.8b"), mesh)
    tp, r = lay.tp, lay.tp_rank

    def part(t, dim):
        n = t.shape[dim] // tp
        return t.narrow(dim, r * n, n).clone().requires_grad_(True)

    x = ops["x"].clone().requires_grad_(True)
    w1, w2, wv = part(ops["w1"], 1), part(ops["w2"], 0), part(ops["wv"], 1)
    y = lay.reduce_over_model(torch.relu(lay.copy_to_model(x) @ w1) @ w2)
    z = lay.gather_over_model(lay.copy_to_model(x) @ wv)
    ((y * ops["cy"]).sum() + (z * ops["cz"]).sum()).backward()
    return {"y": y.detach().numpy(), "z": z.detach().numpy(),
            "dx": x.grad.numpy(), "dw1": w1.grad.numpy(),
            "dw2": w2.grad.numpy(), "dwv": wv.grad.numpy(), "rank": r}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def main(rank: int, world: int, store: str, payload: str, out: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.launch import mesh as tmesh

    torch.set_num_threads(1)
    tmesh.init_process_group(
        "cpu", init_method=f"file://{store}", rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT))
    with open(payload, "rb") as f:
        job = pickle.load(f)
    def run(case):
        if "elastic" in case:
            return run_elastic_case(case, job["weights"], store)
        fn = run_train_case if "train" in case else \
            run_ops_case if "ops" in case else run_case
        return fn(case, job["weights"])

    results = {case["name"]: run(case) for case in job["cases"]}
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    if dist.is_initialized():       # a rank that left a mesh has no group
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    import faulthandler
    import traceback

    faulthandler.enable(all_threads=True)
    code = 0
    try:
        main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
