"""The recurrent-carry and encoder-decoder families served on gloo ranks
(``tests/torch_mesh_rank.py``) against the JAX package's single-device
engine on the CPU: the same converted W4A16 weights and requests, greedy
tokens equal exactly on every rank (fp32, REDUCED).

Cases: rwkv6-7b at (1,2) (one time-mix head a rank, ``tm_o`` gathered
behind its K of one group) and (2,2) (the slots' carries split over
"data"); hymba-1.5b at (1,2), at (1,4) (``out_proj`` and ``w_down`` whole
behind a gathered input, each KV head held by two ranks) and, with 5
query over 5 KV heads, at (1,2), where "model" divides neither head count
(the attention whole beside the cut SSM); whisper-small at (2,2) and
(1,4); ngram speculation on hymba at (2,2) and an oracle's drafts (the
plain run's next token right, the one after wrong) on rwkv at (2,2),
every verify step's carry commit at checkpoint 1 + accepted on the rank's
own slots; a whisper
prompt and audio sent twice, the two slots on different data ranks sharing
the prefix's pages. Prefill runs in chunks of 3 (the carry of a slot that
another data rank holds is carried over several chunks on side rows) and
three requests pass through two slots (a slot's rows reset at readmit).
Weight-gathered layers (``fsdp_serve``: each rank holds its shares over
"data" of its slice and gathers a layer at a time): rwkv, whisper (the
encoder's layers and each decoder layer's cross K/V projected inside the
layer) and hymba with ngram at (2,2) give JAX's tokens, and their
first-token logits and pools are bit-equal to the same mesh without the
flag. Each world size is spawned once.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine
from repro.runtime.speculative import Proposer as JProposer

import torch_mesh_rank
from torch_parity_helpers import jax_to_numpy

P, G = 8, 5
BASE = dict(max_batch=2, max_prompt_len=P, max_new_tokens=G, page_size=4,
            prefill_chunk=3)
SHARED = dict(BASE, prefill_chunk=4)
# speculation: 9-token prompts, 8 tokens each (seed 4: hymba's ngram
# proposes drafts), 2 drafts a verify step
SPEC_P, SPEC_G, SPEC_SEED = 9, 8, 4
SPEC = dict(BASE, max_prompt_len=SPEC_P, max_new_tokens=SPEC_G,
            speculate="ngram", spec_k=2)
FSDP = dict(BASE, fsdp_serve=True)
SPEC_FSDP = dict(SPEC, fsdp_serve=True)
# the oracle's drafts: the plain run's next 2 tokens, the first right
ORACLE = dict(right=1, bad=0)

# weights: (arch, config fields)
WEIGHTS = {
    "rwkv": ("rwkv6-7b", {}),
    "hymba": ("hymba-1.5b", {}),
    # 5 query over 5 KV heads: at (1,2) the attention stays whole
    "hymba_h5": ("hymba-1.5b", {"num_heads": 5, "num_kv_heads": 5}),
    "whisper": ("whisper-small", {}),
}


def requests(arch, kind="base", seed=0):
    """Request dicts (numpy): three prompts arriving one a step, the
    first two repeating a short segment (ngram has drafts to propose), or
    ("shared") one prompt sent twice a step apart; an encdec arch's
    requests carry audio frames (the shared pair the same frames)."""
    cfg = jconfigs.get_reduced(arch)
    plen, gen = (SPEC_P, SPEC_G) if kind == "spec" else (P, G)
    rng = np.random.default_rng(SPEC_SEED if kind == "spec" else seed)
    toks = rng.integers(0, cfg.vocab_size, size=(3, plen)).astype(np.int32)
    rep = np.tile(toks[0, :3], -(-plen // 3))[:plen]
    prompts = [rep, rep, toks[2]]
    audio = [rng.standard_normal((cfg.encoder_seq, cfg.d_model)).astype(
        np.float32) for _ in range(3)]
    n = 3
    if kind == "shared":
        prompts, audio, n = [toks[0]] * 2, [audio[0]] * 2, 2
    out = []
    for i in range(n):
        r = dict(rid=i, prompt=prompts[i], max_new_tokens=gen,
                 arrival_step=i)
        if cfg.family == "encdec":
            r["audio_embeds"] = audio[i]
        out.append(r)
    return out


# (case, weights, mesh, engine kwargs, requests)
CASES = {
    2: [("rwkv-1x2", "rwkv", (1, 2), BASE, "base"),
        ("hymba-1x2", "hymba", (1, 2), BASE, "base"),
        ("hymba-heads5-1x2", "hymba_h5", (1, 2), BASE, "base")],
    4: [("rwkv-2x2", "rwkv", (2, 2), BASE, "base"),
        ("hymba-1x4", "hymba", (1, 4), BASE, "base"),
        ("whisper-2x2", "whisper", (2, 2), BASE, "base"),
        ("whisper-1x4", "whisper", (1, 4), BASE, "base"),
        ("hymba-ngram-2x2", "hymba", (2, 2), SPEC, "spec"),
        ("rwkv-oracle-2x2", "rwkv", (2, 2), SPEC, "oracle"),
        ("whisper-shared-2x2", "whisper", (2, 2), SHARED, "shared"),
        ("rwkv-2x2-fsdp", "rwkv", (2, 2), FSDP, "base"),
        ("whisper-2x2-fsdp", "whisper", (2, 2), FSDP, "base"),
        ("hymba-ngram-2x2-fsdp", "hymba", (2, 2), SPEC_FSDP, "spec")],
}
ALL = [(world, c) for world, cases in CASES.items() for c in cases]
# (the fsdp_serve case, the same mesh without the flag)
FSDP_PAIRS = [("rwkv-2x2-fsdp", "rwkv-2x2"),
              ("whisper-2x2-fsdp", "whisper-2x2"),
              ("hymba-ngram-2x2-fsdp", "hymba-ngram-2x2")]

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


def oracle(wkey):
    """The oracle proposer's arguments: the plain run's tokens (JAX's
    single-device engine, no speculation)."""
    plain, _ = jax_reference(wkey, {k: v for k, v in SPEC.items()
                                    if k not in ("speculate", "spec_k")},
                             "spec")
    return dict(ORACLE, plain=plain)


def jax_reference(wkey, kw, kind):
    """JAX's single-device engine on the same weights and requests (kind
    "oracle": the "spec" requests, speculated by the oracle; the port's
    ``fsdp_serve`` is a mesh's layout, not an engine setting of JAX's
    single device)."""
    kw = {k: v for k, v in kw.items() if k != "fsdp_serve"}
    key = (wkey, tuple(sorted(kw.items())), kind)
    if key not in _REF:
        jcfg, jparams, _ = jax_weights(wkey)
        if kind == "oracle":
            kw = dict(kw, speculate=torch_mesh_rank.oracle_proposer(
                **oracle(wkey), base=JProposer))
        eng = JServingEngine(jcfg, jparams, **kw)
        rep = eng.run([JRequest(**r) for r in requests(
            jcfg.name, "spec" if kind == "oracle" else kind)])
        _REF[key] = ({int(k): [int(t) for t in v]
                      for k, v in sorted(rep.results.items())}, rep)
    return _REF[key]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's per-rank results, one spawn per world size."""
    out = {}
    for world, cases in CASES.items():
        job = {"weights": {}, "cases": []}
        for name, wkey, mesh, kw, kind in cases:
            job["weights"][wkey] = jax_weights(wkey)[2]
            arch, fields = WEIGHTS[wkey]
            job["cases"].append(dict(
                name=name, arch=arch, cfg=fields, weights=wkey, mesh=mesh,
                engine=kw, requests=requests(
                    arch, "spec" if kind == "oracle" else kind),
                oracle=oracle(wkey) if kind == "oracle" else None))
        results = torch_mesh_rank.spawn(
            world, job, tmp_path_factory.mktemp(f"families{world}"))
        for name, *_ in cases:
            out[name] = [r[name] for r in results]
    return out


@pytest.mark.parametrize("world,case", ALL, ids=[c[0] for _, c in ALL])
def test_family_on_a_mesh_matches_jax_single_device(ranks, world, case):
    """Every rank's greedy tokens equal the JAX single-device engine's;
    the mesh coordinates are distinct; data replicas of one model column
    hold bit-identical KV pools; no side rows outlive a prefill."""
    name, wkey, mesh, kw, kind = case
    want, jrep = jax_reference(wkey, kw, kind)
    got = ranks[name]
    assert len(got) == world == mesh[0] * mesh[1]
    for r, res in enumerate(got):
        assert res["tokens"] == want, (name, r)
        assert res["side_rows"] == 0
    assert len({res["coords"] for res in got}) == world
    for col in range(mesh[1]):
        pools = {res["pool"] for res in got if res["coords"][1] == col}
        assert len(pools) == 1, (name, col)
    if "speculate" in kw:
        for res in got:
            assert res["speculated"] == (jrep.proposed_tokens,
                                         jrep.accepted_tokens)
        assert jrep.proposed_tokens > 0
        # the oracle's right drafts are accepted: carries commit past 1
        assert (jrep.accepted_tokens > 0) == (kind == "oracle")


@pytest.mark.parametrize("held,plain", FSDP_PAIRS,
                         ids=[p[0] for p in FSDP_PAIRS])
def test_fsdp_serve_is_bit_equal_to_the_slice(ranks, held, plain):
    """A rank holding its shares over "data" (``fsdp_serve``) and gathering
    a layer at a time serves what the same rank holding its whole slice
    serves: the same tokens, first-token logits and final pool bit for bit
    on every rank (the gathered layer is the slice's bytes)."""
    for a, b in zip(ranks[held], ranks[plain]):
        assert a["coords"] == b["coords"]
        assert a["tokens"] == b["tokens"]
        assert a["logits"].keys() == b["logits"].keys()
        for rid, row in a["logits"].items():
            assert np.array_equal(row, b["logits"][rid]), (held, rid)
        assert a["pool"] == b["pool"]
        assert a["speculated"] == b["speculated"]


# (case, leaf, the shape a rank holds): L = 2 layers, REDUCED widths
SHAPES = [
    # 2 heads of 64 over 2 model ranks, 1 slot a data rank
    ("rwkv-2x2", "wkv", (2, 1, 1, 64, 64)),
    ("rwkv-2x2", "shift", (2, 1, 128)),
    ("rwkv-2x2", "cm_shift", (2, 1, 128)),
    ("rwkv-2x2", "w_bias", (64,)),
    ("rwkv-1x2", "wkv", (2, 2, 1, 64, 64)),
    # d_inner 256 over 4 model ranks, both slots on the one data rank
    ("hymba-1x4", "ssm", (2, 2, 64, 8)),
    ("hymba-1x4", "A_log", (64, 8)),
    ("hymba-1x4", "D", (64,)),
    ("hymba-ngram-2x2", "ssm", (2, 1, 128, 8)),
    ("hymba-heads5-1x2", "ssm", (2, 2, 128, 8)),
    # 4 KV heads of 32 over 2 model ranks, 32 frames, 1 slot a data rank
    ("whisper-2x2", "enc_kv", (2, 1, 32, 2, 32)),
    ("whisper-1x4", "enc_kv", (2, 2, 32, 1, 32)),
]


@pytest.mark.parametrize("name,leaf,shape", SHAPES,
                         ids=[f"{c}-{leaf}" for c, leaf, _ in SHAPES])
def test_rank_holds_its_slice_of_the_per_slot_state(ranks, name, leaf,
                                                    shape):
    """A rank holds its heads of ``wkv`` and ``enc_kv``, its channels of
    ``ssm``, ``A_log`` and ``D``, its slice of ``w_bias``, and, where the
    two slots split over "data", its one slot of each carry."""
    for res in ranks[name]:
        assert res["shapes"][leaf] == shape


def test_rank_heads_and_plans(ranks):
    """hymba at (1,4): one query head a rank over one KV head held by two
    ranks; ``out_proj`` and ``w_down`` (K = 256, two groups of 128) whole
    behind a gathered input (planned at K = 256), ``in_proj`` at N/4. With
    5 query over 5 KV heads at (1,2) the attention stays whole (5/5 a
    rank) beside the SSM's half. rwkv at (1,2): one time-mix head a rank,
    ``tm_o``'s K = 128 (one group) whole behind a gathered input,
    ``cm_v`` at K/2. whisper at (2,2): 2/2 heads a rank."""
    h14 = ranks["hymba-1x4"][0]
    assert h14["heads"] == (1, 1)
    assert {"256x128", "128x64"} <= set(h14["plans"])
    assert ranks["hymba-heads5-1x2"][0]["heads"] == (5, 5)
    assert "256x128" not in ranks["hymba-1x2"][0]["plans"]
    rw = ranks["rwkv-1x2"][0]
    assert rw["heads"][0] == 1
    # tm_r/k/v/g/w at N/2; tm_o gathered; cm_k at N/2, cm_v at K/2
    assert rw["plans"] == ["128x128", "128x64"]
    assert ranks["whisper-2x2"][0]["heads"] == (2, 2)
    assert ranks["whisper-1x4"][0]["heads"] == (1, 1)


def test_whisper_prefix_shared_across_data_ranks(ranks):
    """The same prompt and audio twice: slot 0 (data rank 0) publishes the
    prefix's pages, slot 1 (data rank 1) adopts them; the prefill steps
    saved and peak pages equal the JAX engine's on every rank."""
    _, jrep = jax_reference("whisper", SHARED, "shared")
    assert jrep.prefill_steps_saved > 0
    for res in ranks["whisper-shared-2x2"]:
        assert res["prefill_steps_saved"] == jrep.prefill_steps_saved
        assert res["peak_pages"] == jrep.peak_pages


@pytest.mark.parametrize("arch,mesh,holds", [
    ("whisper-small", "1x2", "2 of 4 query heads"),
    ("rwkv6-7b", "1x2", "1 of 2 time-mix heads")])
def test_serve_launcher_on_a_mesh(arch, mesh, holds):
    """``python -m torch.distributed.run ... -m repro_torch.launch.serve
    --mesh 1x2`` on two gloo ranks: every rank draws the same weights and
    (whisper) the same audio frames, and rank 0 prints the single
    process's sample generation."""
    import os
    import re
    import subprocess
    import sys

    from repro_torch.launch import serve as tserve

    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "6", "--gen", "3", "--page-size", "4", "--device", "cpu"]
    single = tserve.main(argv).results[0]
    env = dict(os.environ, PYTHONPATH=torch_mesh_rank.SRC,
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve", *argv,
         "--mesh", mesh], env=env, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    got = re.search(r"sample generation \(request 0\): (\[.*\])",
                    out.stdout).group(1)
    assert got == str(list(single))
    assert holds in out.stdout
