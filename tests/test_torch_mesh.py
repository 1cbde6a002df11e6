"""The port's sharded serving on gloo ranks (``tests/torch_mesh_rank.py``)
against the JAX package's single-device engine on the CPU: the same
converted weights and requests, greedy tokens equal exactly on every rank.

The JAX package's own sharded engine tests need forced host devices and
fail on this tree, so the reference is JAX's single-device engine, and
sharding must not change a greedy token (JAX's tests demand the same).
Cases: REDUCED danube at (2,2), (1,4) (groups of 32, so that wo splits
K/4 in whole groups) and (2,4); the fused paged-attention path at (2,4)
with 5-token chunks and ngram; ngram speculation at (2,2); a warm
re-admit at (2,4); a shared prompt prefix whose two slots sit on
different data ranks; internvl2 at (2,2); olmoe at (1,2); llama3-405b
REDUCED at (1,4); danube with the tied head at (1,4). The ring engine
(``paged=False``): danube at (1,2) and (2,2) with a 12-entry window cut
over "model" (it wraps in decode), llama3-405b REDUCED at (1,4) with its
13-entry window whole (4 does not divide it) and with a 16-entry window
cut 4 ways (2 KV heads over 4 ranks). Weight-gathered layers
(``fsdp_serve``: each rank holds its shares over "data" of its slice and
gathers a layer at a time): danube at (2,2) plain and with ngram
(chunked prefill, decode and verify steps), mixtral REDUCED at (2,2) with
ngram (at a capacity no token overflows, so that routing per data shard
is JAX's single-device routing) with and without the flag, internvl2
(the vision prefix) at (2,2); each gives
JAX's tokens, and its first-token logits and KV pools are bit-equal to the
same mesh without the flag. Each world size is spawned once for all its
cases. MoE
under a data axis routes per data shard (a different reference:
``test_torch_sharding.py`` holds that dispatch op by op), so olmoe is held
at TP only.
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch.launch import serve as tserve

import torch_mesh_rank
from torch_parity_helpers import jax_to_numpy

P, G = 8, 5
BASE = dict(max_batch=2, max_prompt_len=P, max_new_tokens=G)
SPEC = dict(BASE, prefill_chunk=5, speculate="ngram", spec_k=2)
SHARED = dict(BASE, page_size=4, prefill_chunk=4)
WARM = dict(BASE, max_new_tokens=4, page_size=4, prefill_chunk=4,
            warm_cache_mb=1.0)
FSDP = dict(BASE, fsdp_serve=True)
SPEC_FSDP = dict(SPEC, fsdp_serve=True)

# weights: (arch, config fields)
WEIGHTS = {
    "danube": ("h2o-danube-1.8b", {}),
    "danube_g32": ("h2o-danube-1.8b", {"group_size": 32}),
    "danube_tied": ("h2o-danube-1.8b", {"tie_embeddings": True}),
    "internvl2": ("internvl2-1b", {}),
    "olmoe": ("olmoe-1b-7b", {}),
    "llama3": ("llama3-405b", {}),
    # no token overflows an expert at this capacity, on one device or
    # routed per data shard
    "mixtral": ("mixtral-8x7b", {"moe_capacity_factor": float(
        jconfigs.get_reduced("mixtral-8x7b").num_experts)}),
}


def requests(arch, kind="base", seed=0):
    """Request dicts (numpy): three prompts arriving one a step
    ("base"), one prompt sent twice a step apart ("shared"), or twice
    long after the first finished ("warm")."""
    cfg = jconfigs.get_reduced(arch)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(3, P)).astype(np.int32)
    if kind == "shared":
        return [dict(rid=i, prompt=toks[0], max_new_tokens=G,
                     arrival_step=i) for i in range(2)]
    if kind == "warm":
        return [dict(rid=0, prompt=toks[0], max_new_tokens=4),
                dict(rid=1, prompt=toks[0], max_new_tokens=4,
                     arrival_step=14)]
    out = []
    for i in range(3):
        r = dict(rid=i, prompt=toks[i], max_new_tokens=G, arrival_step=i)
        if cfg.vision_prefix:
            r["prefix_embeds"] = rng.standard_normal(
                (cfg.vision_prefix, cfg.d_model)).astype(np.float32)
        out.append(r)
    return out


# (case, weights, mesh, engine kwargs, requests, forced fused path)
CASES = {
    4: [("danube-2x2", "danube", (2, 2), BASE, "base", False),
        ("danube-1x4-g32", "danube_g32", (1, 4), BASE, "base", False),
        ("ngram-2x2", "danube", (2, 2), SPEC, "base", False),
        ("shared-prefix-2x2", "danube", (2, 2), SHARED, "shared", False),
        ("internvl2-2x2", "internvl2", (2, 2), BASE, "base", False),
        # the tied head: the vocab-sharded table's logits gathered
        ("tied-head-1x4", "danube_tied", (1, 4), BASE, "base", False),
        ("llama3-1x4", "llama3", (1, 4), BASE, "base", False),
        ("danube-2x2-fsdp", "danube", (2, 2), FSDP, "base", False),
        ("ngram-2x2-fsdp", "danube", (2, 2), SPEC_FSDP, "base", False),
        ("mixtral-ngram-2x2", "mixtral", (2, 2), SPEC, "base", False),
        ("mixtral-ngram-2x2-fsdp", "mixtral", (2, 2), SPEC_FSDP, "base",
         False),
        ("internvl2-2x2-fsdp", "internvl2", (2, 2), FSDP, "base", False)],
    8: [("danube-2x4", "danube", (2, 4), BASE, "base", False),
        ("fused-ngram-2x4", "danube", (2, 4), SPEC, "base", True),
        ("warm-2x4", "danube", (2, 4), WARM, "warm", False)],
    2: [("olmoe-1x2", "olmoe", (1, 2), BASE, "base", False)],
}
ALL = [(world, c) for world, cases in CASES.items() for c in cases]
# (the fsdp_serve case, the same mesh without the flag)
FSDP_PAIRS = [("danube-2x2-fsdp", "danube-2x2"),
              ("ngram-2x2-fsdp", "ngram-2x2"),
              ("mixtral-ngram-2x2-fsdp", "mixtral-ngram-2x2"),
              ("internvl2-2x2-fsdp", "internvl2-2x2")]

RING = dict(BASE, paged=False)
# the ring engine's cases: (case, weights, mesh, engine kwargs)
RING_CASES = {
    2: [("ring-danube-1x2", "danube", (1, 2), dict(RING, cache_len=12))],
    4: [("ring-danube-2x2", "danube", (2, 2), dict(RING, cache_len=12)),
        ("ring-llama3-1x4", "llama3", (1, 4), RING),
        ("ring-llama3-1x4-cut", "llama3", (1, 4),
         dict(RING, cache_len=16))],
}
RING_ALL = [(world, c) for world, cases in RING_CASES.items()
            for c in cases]

_JAX = {}


def jax_weights(key):
    if key not in _JAX:
        arch, fields = WEIGHTS[key]
        jcfg = dataclasses.replace(jconfigs.get_reduced(arch), **fields)
        jparams = JT.quantize_params(
            JT.init_params(jax.random.PRNGKey(0), jcfg), jcfg, min_size=0)
        _JAX[key] = (jcfg, jparams, jax_to_numpy(jparams))
    return _JAX[key]


_REF = {}


def jax_reference(wkey, kw, kind):
    """JAX's single-device engine on the same weights and requests (the
    port's ``fsdp_serve`` is a mesh's layout, not an engine setting of
    JAX's single device)."""
    kw = {k: v for k, v in kw.items() if k != "fsdp_serve"}
    key = (wkey, tuple(sorted(kw.items())), kind)
    if key not in _REF:
        jcfg, jparams, _ = jax_weights(wkey)
        eng = JServingEngine(jcfg, jparams, **kw)
        rep = eng.run([JRequest(**r) for r in requests(jcfg.name, kind)])
        _REF[key] = ({int(k): [int(t) for t in v]
                      for k, v in sorted(rep.results.items())}, rep)
    return _REF[key]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's per-rank results, one spawn per world size."""
    out = {}
    for world, cases in CASES.items():
        job = {"weights": {}, "cases": []}
        ring = [(name, wkey, mesh, kw, "base", False, True)
                for name, wkey, mesh, kw in RING_CASES.get(world, [])]
        for name, wkey, mesh, kw, kind, fused, *step in \
                [c + (False,) for c in cases] + ring:
            job["weights"][wkey] = jax_weights(wkey)[2]
            arch, fields = WEIGHTS[wkey]
            job["cases"].append(dict(
                name=name, arch=arch, cfg=fields,
                weights=wkey, mesh=mesh, engine=kw,
                requests=requests(arch, kind), force_fused=fused,
                step=step[0]))
        results = torch_mesh_rank.spawn(
            world, job, tmp_path_factory.mktemp(f"world{world}"))
        for case in job["cases"]:
            out[case["name"]] = [r[case["name"]] for r in results]
    return out


@pytest.mark.parametrize("world,case", ALL, ids=[c[0] for _, c in ALL])
def test_sharded_engine_matches_jax_single_device(ranks, world, case):
    """Every rank's greedy tokens equal the JAX single-device engine's;
    every rank's mesh coordinates are distinct; data replicas of one
    model column hold bit-identical KV pools (the step's new K/V rows are
    gathered over "data" before each write)."""
    name, wkey, mesh, kw, kind, fused = case
    want, _ = jax_reference(wkey, {k: v for k, v in kw.items()}, kind)
    got = ranks[name]
    assert len(got) == world == mesh[0] * mesh[1]
    for r, res in enumerate(got):
        assert res["tokens"] == want, (name, r)
    assert len({res["coords"] for res in got}) == world
    for col in range(mesh[1]):
        pools = {res["pool"] for res in got if res["coords"][1] == col}
        assert len(pools) == 1, (name, col)
    paths = {res["attn_path"] for res in got}
    assert paths == {("fused",) * 3 if fused else ("gather",) * 3}


@pytest.mark.parametrize("world,case", RING_ALL,
                         ids=[c[0] for _, c in RING_ALL])
def test_ring_engine_on_a_mesh_matches_jax_single_device(ranks, world,
                                                         case):
    """The ring engine on gloo ranks: every rank's greedy tokens equal
    JAX's single-device ring engine's; every rank's ring holds its rows of
    the slots and, where the model axis divides the window, its slice of
    it, for every KV head; one whole-prompt prefill and one decode step
    run by hand give JAX's logits (prefill, and the step's rows this rank
    runs) within 1e-4 (fp32)."""
    import jax.numpy as jnp
    from repro.runtime.engine import insert_slot as jinsert

    name, wkey, mesh, kw = case
    want, _ = jax_reference(wkey, kw, "base")
    jcfg, jparams, _ = jax_weights(wkey)
    jeng = JServingEngine(jcfg, jparams, **kw)
    W = jeng.cache_len
    dp, tp = mesh
    rows = kw["max_batch"] // dp
    win = W // tp if W % tp == 0 else W
    shape = (jcfg.num_layers, rows, win, jcfg.num_kv_heads, jcfg.head_dim)
    req = JRequest(**requests(jcfg.name, "base")[0])
    inputs = jeng._prefill_inputs(req)
    logits, rstate = jeng._prefill_fn(inputs)(jeng.params, inputs)
    state = jinsert(JT.init_decode_state(jcfg, kw["max_batch"], W),
                    rstate, 0)
    got = ranks[name]
    assert len(got) == world
    for r, res in enumerate(got):
        assert res["tokens"] == want, (name, r)
        assert res["ring"] == {"k": shape, "v": shape, "pos": shape[:3]}
        assert res["attn_path"] == ("ring", "ring", "ring")
        step = res["step"]
        np.testing.assert_allclose(step["prefill"], np.asarray(logits[0]),
                                   rtol=1e-4, atol=1e-4)
        out = jeng._serve_step()(jeng.params, {
            "state": state, "tokens": jnp.asarray(step["tok"], jnp.int32),
            "pos": jnp.asarray(step["pos"], jnp.int32)})
        np.testing.assert_allclose(
            step["decode"], np.asarray(out["logits"])[step["rows"]],
            rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("held,plain", FSDP_PAIRS,
                         ids=[p[0] for p in FSDP_PAIRS])
def test_fsdp_serve_is_bit_equal_to_the_slice(ranks, held, plain):
    """A rank holding its shares over "data" (``fsdp_serve``) and gathering
    a layer at a time serves what the same rank holding its whole slice
    serves: the same tokens, first-token logits and final KV pool bit for
    bit on every rank (the gathered layer is the slice's bytes); the plans
    are the slice's."""
    for a, b in zip(ranks[held], ranks[plain]):
        assert a["coords"] == b["coords"]
        assert a["tokens"] == b["tokens"]
        assert a["logits"].keys() == b["logits"].keys()
        for rid, row in a["logits"].items():
            assert np.array_equal(row, b["logits"][rid]), (held, rid)
        assert a["pool"] == b["pool"]
        assert a["plans"] == b["plans"]
        assert a["speculated"] == b["speculated"]


def test_shard_local_plans_and_heads(ranks):
    """Plans are keyed on what a rank executes. REDUCED danube at (1,4),
    groups of 32: wq at N/4 (128x32), wo at K/4 (32x128), w_up N/4, w_down
    K/4, one query and one KV head a rank, GEMMs cached at the rank's M =
    2 slots. At (2,4) with groups of 128 wo (one group) and w_down (two)
    stay whole behind a gathered input; M = 2 slots / 2 data ranks. Under
    ngram speculation the verify step's M is 2·3 / 2 rows."""
    g32 = ranks["danube-1x4-g32"][0]
    assert g32["plans"] == ["128x32", "128x64", "32x128", "64x128"]
    assert g32["heads"] == (1, 1)
    assert {m for m, _, _ in g32["cached"]} >= {2}
    d24 = ranks["danube-2x4"][0]
    assert d24["plans"] == ["128x128", "128x32", "128x64", "256x128"]
    assert (1, 128, 32) in d24["cached"]
    spec = ranks["ngram-2x2"][0]
    assert (3, 128, 64) in spec["cached"]
    # llama3 REDUCED: 8/2 heads over 4 ranks (2 query heads and 1 of the 2
    # KV heads each); olmoe: 4/4 heads over 2
    assert ranks["llama3-1x4"][0]["heads"] == (2, 1)
    assert ranks["olmoe-1x2"][0]["heads"] == (2, 2)


def test_prefix_sharing_and_warm_readmit_on_a_mesh(ranks):
    """A prompt prefix published by slot 0 (data rank 0) is adopted by
    slot 1 (data rank 1) — the same prefill steps saved and peak pages as
    the JAX engine; a warm re-admit hits once on every rank as on one
    device."""
    _, jshared = jax_reference("danube", SHARED, "shared")
    for res in ranks["shared-prefix-2x2"]:
        assert res["prefill_steps_saved"] == jshared.prefill_steps_saved > 0
        assert res["peak_pages"] == jshared.peak_pages
    _, jwarm = jax_reference("danube", WARM, "warm")
    assert jwarm.warm_hits == 1
    for res in ranks["warm-2x4"]:
        assert res["warm_hits"] == 1 and res["steps"] == jwarm.steps


LAUNCH = ["--arch", "h2o-danube-1.8b", "--reduced", "--batch", "2",
          "--prompt-len", "6", "--gen", "3", "--page-size", "4", "--device",
          "cpu"]


def test_serve_launcher_on_a_mesh():
    """``python -m torch.distributed.run ... -m repro_torch.launch.serve
    --mesh 1x2`` on two gloo ranks prints the single process's sample
    generation (rank 0 only); a mesh the world does not hold is refused
    before any weight is drawn."""
    single = tserve.main(LAUNCH).results[0]
    env = dict(os.environ, PYTHONPATH=torch_mesh_rank.SRC,
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *LAUNCH,
         "--mesh", "1x2"], env=env, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("[serve] sample generation") == 1
    got = re.search(r"sample generation \(request 0\): (\[.*\])",
                    out.stdout).group(1)
    assert got == str(list(single))
    assert "1 of 2 KV heads" in out.stdout
    with pytest.raises(ValueError, match="needs 4 ranks but 1 is running"):
        tserve.main(LAUNCH + ["--mesh", "2x2"])
