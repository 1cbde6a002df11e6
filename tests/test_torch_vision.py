"""The port's vision-prefix decoder (internvl2-1b) against the JAX package
on the CPU: the forward with patch embeddings prepended and the loss's
offset past them, a prefill chunk stream that crosses the patch/token
boundary, engine-level greedy token parity on the REDUCED config (dense
and W4A16, chunk sizes None/3/4, ngram speculation, a draft model fed the
patches), prefix sharing (identical patches and prompt share pages; a
request that differs in a single patch row shares nothing from that
row's page on), page counts equal to JAX's, the draft's frontend check,
the front door with ``prefix_embeds`` and its 400s, the train step
(three steps against JAX's, the loss's label slice past the prefix),
remat, and the launchers.

Weights are the JAX package's, converted leaf for leaf; inputs come from
numpy with a fixed seed. REDUCED runs in fp32: logits after two layers
and a vocab-wide head are held to 1e-4.
"""
import asyncio
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.runtime import speculative as jspec
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as T
from repro_torch.runtime import speculative as spec
from repro_torch.runtime.engine import Request, ServingEngine
from repro_torch.runtime.frontdoor import FrontDoor, sse_decode_tokens

from torch_parity_helpers import (assert_train_matches, check_remat,
                                  jax_to_numpy, jax_trained, port_train)

ARCH = "internvl2-1b"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **tol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


_WEIGHTS = {}


def _weights(quantized):
    if quantized not in _WEIGHTS:
        jcfg = dataclasses.replace(jconfigs.get_reduced(ARCH),
                                   w4a16_strategy="xla")
        jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
        if quantized:
            jparams = JT.quantize_params(jparams, jcfg, min_size=0)
        cfg = configs.get_reduced(ARCH)
        tparams = from_jax_params(jax_to_numpy(jparams), dtype=cfg.dtype,
                                  device="cpu")
        _WEIGHTS[quantized] = (jcfg, jparams, cfg, tparams)
    return _WEIGHTS[quantized]


def _patches(cfg, seed, B=None):
    shape = (cfg.vision_prefix, cfg.d_model)
    return _x(shape if B is None else (B,) + shape, seed)


def test_forward_and_loss_offset_match_jax():
    """Logits over prefix + tokens, and the loss over the token positions
    only (the P prefix logits dropped)."""
    jcfg, jparams, cfg, tparams = _weights(False)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    pe = _patches(cfg, 2, B=2)
    got = T.forward(tparams, cfg, torch.from_numpy(toks),
                    prefix_embeds=torch.from_numpy(pe))
    assert tuple(got.shape) == (2, cfg.vision_prefix + 10, cfg.padded_vocab)
    _close(got, JT.forward(jparams, jcfg, jnp.asarray(toks),
                           prefix_embeds=jnp.asarray(pe)))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "vision_embeds": jnp.asarray(pe)}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    _close(T.loss_fn(tparams, cfg, tbatch),
           JT.loss_fn(jparams, jcfg, jbatch), dict(rtol=1e-5, atol=1e-5))


@pytest.mark.parametrize("quantized", [False, True])
def test_chunk_stream_across_the_patch_boundary_matches_jax(quantized):
    """The engine's stream (8 patches, then 6 tokens) prefilled in chunks
    of 5: the second chunk holds the last 3 patches and the first 2 tokens,
    the third the rest, right-padded. Logits at every chunk, then a decode
    step from pos0 = prompt + prefix."""
    jcfg, jparams, cfg, tparams = _weights(quantized)
    CL, PS_, NB = 32, 4, 9
    js = JT.init_paged_state(jcfg, 1, CL, page_size=PS_, num_blocks=NB)
    ts = T.init_paged_state(cfg, 1, CL, page_size=PS_, num_blocks=NB,
                            device="cpu")
    table = np.arange(1, 9, dtype=np.int32)[None]
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, 6).astype(np.int32)
    emb = jlayers.embed(jparams["embed"], jnp.asarray(prompt))
    stream = np.concatenate([_patches(cfg, 4), np.asarray(emb)])
    S, C = len(stream), 5
    for start in range(0, S, C):
        n = min(C, S - start)
        seg = np.zeros((1, C, cfg.d_model), np.float32)
        seg[0, :n] = stream[start:start + n]
        positions = np.full((1, C), -1, np.int32)
        positions[0, :n] = np.arange(start, start + n)
        jl, js = JT.prefill_chunk_step(
            jparams, jcfg, js, jnp.asarray(seg), jnp.asarray(positions),
            jnp.asarray(table), 0, cache_len=CL)
        tl, ts = T.prefill_chunk_step(
            tparams, cfg, ts, torch.from_numpy(seg),
            torch.from_numpy(positions), torch.from_numpy(table), 0,
            cache_len=CL)
        _close(tl, jl)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = np.array([S], np.int32)
    jl, _ = JT.decode_step(jparams, jcfg, js, jnp.asarray(tok),
                           jnp.asarray(pos), tables=jnp.asarray(table),
                           cache_len=CL)
    tl, _ = T.decode_step(tparams, cfg, ts, torch.from_numpy(tok),
                          torch.from_numpy(pos),
                          tables=torch.from_numpy(table), cache_len=CL)
    _close(tl, jl)


def test_ring_prefill_with_prefix_matches_jax():
    """The draft's whole-prompt ring prefill with the patches ahead."""
    jcfg, jparams, cfg, tparams = _weights(False)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    pe = _patches(cfg, 6, B=2)
    jl, _ = JT.prefill(jparams, jcfg, jnp.asarray(toks), cache_len=16,
                       prefix_embeds=jnp.asarray(pe))
    tl, ts = T.prefill(tparams, cfg, torch.from_numpy(toks), cache_len=16,
                       prefix_embeds=torch.from_numpy(pe))
    _close(tl, jl)
    pos = ts["cache"]["kv"].pos[0, 0].numpy()
    assert sorted(pos[pos >= 0]) == list(range(cfg.vision_prefix + 7))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _requests(make, prompts, patches, G):
    return [make(rid=i, prompt=p, max_new_tokens=G, prefix_embeds=pe)
            for i, (p, pe) in enumerate(zip(prompts, patches))]


def _engine_pair(quantized, prompts, patches, G, *, jspeculate=None,
                 speculate=None, **kw):
    jcfg, jparams, cfg, tparams = _weights(quantized)
    common = dict(max_batch=2, max_prompt_len=max(len(p) for p in prompts),
                  max_new_tokens=G, page_size=4, **kw)
    jrep = JServingEngine(jcfg, jparams, speculate=jspeculate or speculate,
                          **common).run(_requests(JRequest, prompts, patches,
                                                  G))
    eng = ServingEngine(cfg, tparams, speculate=speculate, device="cpu",
                        **common)
    return jrep, eng.run(_requests(Request, prompts, patches, G)), eng


def _prompts(cfg, n, plen, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
            for _ in range(n)]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("chunk", [None, 3, 4])
def test_engine_token_parity_with_jax(quantized, chunk):
    """3 requests with their own patches through 2 slots, chunked prefill
    over patches + prompt interleaved with decode: JAX's greedy tokens,
    steps and pages, exactly; the window holds prompt + prefix + gen."""
    cfg = configs.get_reduced(ARCH)
    patches = [_patches(cfg, 10 + i) for i in range(3)]
    jrep, rep, eng = _engine_pair(quantized, _prompts(cfg, 3, 9), patches,
                                  6, prefill_chunk=chunk)
    assert rep.results == jrep.results and sorted(rep.results) == [0, 1, 2]
    assert rep.steps == jrep.steps and rep.peak_pages == jrep.peak_pages
    assert eng.cache_len == 24 and eng.alloc.pages_in_use == 0
    assert eng.pos0(Request(rid=0, prompt=[1] * 9, max_new_tokens=1)) == 17


@pytest.mark.parametrize("kind", ["ngram", "draft"])
def test_engine_speculation_parity_with_jax(kind):
    """ngram, and a 1-layer draft model with the JAX draft's weights whose
    ring prefill takes the patches ahead of the prompt (its positions
    offset by the prefix): JAX's tokens and acceptance counts."""
    jcfg, jparams, cfg, tparams = _weights(True)
    seg = _prompts(cfg, 2, 4, seed=3)
    prompts = [np.tile(s, 3) for s in seg]
    patches = [_patches(cfg, 20 + i) for i in range(2)]
    jprop, prop = "ngram", "ngram"
    if kind == "draft":
        jprop = jspec.make_proposer("draft:layers=1", target_cfg=jcfg)
        prop = spec.DraftModelProposer(
            dataclasses.replace(cfg, num_layers=1),
            from_jax_params(jax_to_numpy(jprop.params), dtype=cfg.dtype))
    jrep, rep, _ = _engine_pair(True, prompts, patches, 8, jspeculate=jprop,
                                speculate=prop, spec_k=3)
    assert rep.results == jrep.results
    assert rep.proposed_tokens == jrep.proposed_tokens > 0
    assert rep.accepted_tokens == jrep.accepted_tokens


@pytest.mark.parametrize("case", ["same", "row"])
def test_sharing_follows_the_patches(case):
    """Two requests with one prompt: identical patches share every page of
    the stream (tokens identical); patches that differ in row 5 (the
    second 4-token page) share page 0 only. Tokens, peak pages and
    prefill steps saved equal JAX's."""
    cfg = configs.get_reduced(ARCH)
    prompt = _prompts(cfg, 1, 8, seed=7)[0]
    p0 = _patches(cfg, 30)
    p1 = p0.copy()
    if case == "row":
        p1[5] += 1.0
    jrep, rep, eng = _engine_pair(True, [prompt, prompt], [p0, p1], 4,
                                  prefill_chunk=4)
    assert rep.results == jrep.results
    assert rep.peak_pages == jrep.peak_pages
    assert rep.prefill_steps_saved == jrep.prefill_steps_saved
    unshared = ServingEngine(cfg, _weights(True)[3], max_batch=2,
                             max_prompt_len=8, max_new_tokens=4,
                             page_size=4, prefill_chunk=4, device="cpu",
                             share_prefix=False).run(
        _requests(Request, [prompt, prompt], [p0, p1], 4))
    assert unshared.results == rep.results
    # 8 patches + 8 tokens + 4 generated = 5 pages a slot unshared
    assert unshared.peak_pages == 10
    saved = unshared.peak_pages - rep.peak_pages
    if case == "same":
        assert rep.results[0] == rep.results[1] and saved >= 3
    else:
        assert saved == 1


def test_page_keys_hash_the_patches_bytes_as_jax():
    """Page keys from patches in the model's dtype, bf16 included (read bit
    for bit), and from encdec's audio seed equal the JAX engine's, so a
    bf16 card and the CPU replica make the same sharing decisions."""
    from repro.runtime import kvcache as jkvc
    from repro_torch.runtime import engine as tengine
    from repro_torch.runtime import kvcache as kvc
    prompt = np.arange(5, dtype=np.int32)
    pe = _x((8, 16), 50)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        host = tengine._host_bytes(torch.from_numpy(pe).to(tdt))
        seed = host.tobytes()
        assert seed == np.asarray(jnp.asarray(pe, jdt)).tobytes()
        got = kvc.page_keys(kvc.position_units(prompt, host), 4, seed=seed)
        want = jkvc.page_keys(jkvc.position_units(
            prompt, jnp.asarray(pe, jdt)), 4, seed=seed)
        assert got == want and len(got[0]) == 3


def test_draft_frontend_must_match_the_target():
    """A draft whose vision prefix differs from the target's is refused at
    the engine's start, with JAX's message."""
    cfg = configs.get_reduced(ARCH)
    tparams = _weights(True)[3]
    draft = spec.DraftModelProposer(dataclasses.replace(
        cfg, num_layers=1, vision_prefix=4))
    eng = ServingEngine(cfg, tparams, max_batch=2, max_prompt_len=8,
                        max_new_tokens=4, page_size=4, speculate=draft,
                        device="cpu")
    with pytest.raises(ValueError, match="vision frontend"):
        eng.start()
    jcfg, jparams = _weights(True)[:2]
    jeng = JServingEngine(jcfg, jparams, max_batch=2, max_prompt_len=8,
                          max_new_tokens=4, page_size=4,
                          speculate=jspec.DraftModelProposer(
                              dataclasses.replace(jcfg, num_layers=1,
                                                  vision_prefix=4)))
    with pytest.raises(ValueError) as jerr:
        jeng.start()
    with pytest.raises(ValueError) as terr:
        eng.start()
    assert str(terr.value) == str(jerr.value)


async def _post(port, spec_):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps(spec_).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    payload = await reader.read()
    writer.close()
    return int(payload.split(b" ", 2)[1]), payload


def test_front_door_with_prefix_embeds_and_its_400s():
    """Requests with ``prefix_embeds`` over HTTP stream ``engine.run``'s
    tokens; embeds of the wrong row count or width, or ``audio_embeds``
    on this arch, are a 400 with JAX's messages."""
    cfg = configs.get_reduced(ARCH)
    tparams = _weights(True)[3]
    prompts = _prompts(cfg, 2, 6, seed=8)
    patches = [_patches(cfg, 40 + i) for i in range(2)]
    eng = ServingEngine(cfg, tparams, max_batch=2, max_prompt_len=6,
                        max_new_tokens=4, page_size=4, device="cpu")
    ref = eng.run(_requests(Request, prompts, patches, 4))
    d = cfg.d_model

    async def main():
        fd = FrontDoor(eng)
        await fd.serve()
        outs = await asyncio.gather(*(_post(fd.port, {
            "prompt": [int(t) for t in prompts[i]], "max_new_tokens": 4,
            "prefix_embeds": patches[i].tolist()}) for i in range(2)))
        bad = {}
        for name, body in (
                ("rows", {"prefix_embeds": [[0.0] * d] * 3}),
                ("width", {"prefix_embeds": [[0.0] * 3] * 8}),
                ("audio", {"audio_embeds": [[0.0] * d] * 8})):
            bad[name] = await _post(fd.port, dict(prompt=[1, 2], **body))
        await fd.shutdown()
        return outs, bad

    outs, bad = asyncio.run(asyncio.wait_for(main(), 300))
    assert [s for s, _ in outs] == [200, 200]
    assert [sse_decode_tokens(p) for _, p in outs] == \
        [ref.results[i] for i in range(2)]
    assert {k: s for k, (s, _) in bad.items()} == \
        {"rows": 400, "width": 400, "audio": 400}
    assert b"prefix_embeds must be 8 x 128" in bad["rows"][1]
    assert b"internvl2-1b takes no audio_embeds" in bad["audio"][1]


def test_training_refused_and_serve_launcher_on_cpu(capsys, tmp_path,
                                                   monkeypatch):
    """The train launcher, which refused internvl2 once, trains it as the
    JAX CLI test does (4 steps, batch 2 x 16, checkpoints every 2 steps)
    on patches from its own ``extra_inputs``; the checkpoint restores (a
    5-step run resumes at step 4). Then the serve launcher with the front
    door."""
    drawn = []
    extra = ttrain.extra_inputs
    monkeypatch.setattr(ttrain, "extra_inputs", lambda *a: drawn.append(
        extra(*a)) or drawn[-1])
    argv = ["--arch", ARCH, "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device",
            "cpu"]
    rep = ttrain.main(argv + ["--steps", "4"])
    assert len(rep.losses) == 4 and np.isfinite(rep.losses).all()
    assert [h[1] for h in rep.history] == [0, 2, 3]
    resumed = ttrain.main(argv + ["--steps", "5"])
    assert resumed.history == [("resume", 4), ("checkpoint", 4)]
    assert np.isfinite(resumed.losses).all()
    assert drawn[0]["vision_embeds"].shape == (2, 8, 128)
    assert [sorted(ex) for ex in drawn] == [["vision_embeds"]] * 2
    rep = tserve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                       "--prompt-len", "6", "--gen", "3", "--device", "cpu",
                       "--http", "0"])
    out = capsys.readouterr().out
    assert sorted(rep.results) == [0, 1]
    assert "prompt 6 + prefix 8 + gen 3" in out
    assert "front door: 2/2 served" in out
    reqs = tserve.make_requests(configs.get_reduced(ARCH), 2, 6, 3, 0)
    assert reqs[0].prefix_embeds.shape == (8, 128)
    assert reqs[0].audio_embeds is None


# ---------------------------------------------------------------------------
# training: the train step against JAX's, remat, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", [ARCH])
def test_train_step_matches_jax(jax_trained, arch, micro, attn_impl):
    """Three ``make_train_step`` steps from JAX's parameters against
    JAX's (``torch_parity_helpers.assert_train_matches``)."""
    want = jax_trained(arch, micro)
    got = port_train(arch, micro, want["params0"], attn_impl=attn_impl)
    assert_train_matches(got, want)


@pytest.mark.parametrize("arch", [ARCH])
def test_remat_gives_the_same_grads(arch, monkeypatch):
    check_remat(arch, monkeypatch)
