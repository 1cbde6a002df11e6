"""The port's encoder-decoder family (whisper-small) against the JAX
package on the CPU: LayerNorm, the tanh GELU, the encoder and the
decoder layers' cross K/V, the forward and loss with audio, the paged
chunk, decode and verify steps reading a slot's cross K/V rows, and
engine-level greedy token parity on the REDUCED config (dense and W4A16,
chunk sizes None/3/4, more requests than slots, ngram speculation), with
prefix sharing under the same audio (pages shared) and different audio
(none), page counts equal to JAX's; the param tree, the converter and
``quantize_tree`` on the encoder's stacks, the front door with
``audio_embeds``, the train step (three steps against JAX's, the backward
through the encoder and the cross-attention), remat, the refusals and the
launchers.

Weights are the JAX package's, converted leaf for leaf; inputs come from
numpy with a fixed seed. REDUCED runs in fp32: layer ops are held to
1e-5, logits after two layers and a vocab-wide head to 1e-4 (the two
frameworks sum in different orders).
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
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.runtime import speculative as spec
from repro_torch.runtime.engine import Request, ServingEngine
from repro_torch.runtime.frontdoor import FrontDoor, sse_decode_tokens

from torch_parity_helpers import (assert_train_matches, check_remat,
                                  jax_to_numpy, jax_trained, port_train,
                                  train_launcher_round_trip)

ARCH = "whisper-small"
TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, tol=TOL):
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


def _audio(cfg, B, seed):
    return _x((B, cfg.encoder_seq, cfg.d_model), seed)


# ---------------------------------------------------------------------------
# layer ops
# ---------------------------------------------------------------------------

def test_layernorm_and_gelu_match_jax():
    """LayerNorm (eps 1e-5, biased variance of the centred input, fp32)
    with a random scale and bias, on an input with a large mean; GELU in
    ``jax.nn.gelu``'s default tanh form, which the erf form misses by
    more than the tolerance."""
    x = _x((3, 5, 64), 1) * 4.0 + 3.0
    p = {"scale": _x((64,), 2), "bias": _x((64,), 3)}
    want = jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = layers.layernorm({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x))
    _close(got, want)
    xs = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = jax.nn.gelu(jnp.asarray(xs))
    _close(layers.gelu(torch.from_numpy(xs)), want)
    erf = torch.nn.functional.gelu(torch.from_numpy(xs)).numpy()
    assert float(np.abs(erf - np.asarray(want)).max()) > 1e-4


def test_linear_bias_matches_jax():
    """The GELU MLP's linears carry a bias, added after the product in the
    activation dtype, dense and W4A16."""
    w, b, x = _x((64, 96), 4), _x((96,), 5), _x((3, 64), 6)
    jp = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
    for quantized in (False, True):
        if quantized:
            jp = jlayers.quantize_tree({"l": jp}, min_size=0)["l"]
        tp = from_jax_params(jax_to_numpy(jp), dtype=torch.float32)
        assert isinstance(tp["kernel"], QuantizedTensor) == quantized
        _close(layers.linear(tp, torch.from_numpy(x)),
               jlayers.linear(jp, jnp.asarray(x)))


@pytest.mark.parametrize("quantized", [False, True])
def test_encoder_and_cross_kv_match_jax(quantized):
    """The encoder (non-causal RoPE attention over the frames, the GELU
    MLP, LayerNorms, its final norm) and every decoder layer's cross K/V
    stack (L, B, T, Hkv, D)."""
    jcfg, jparams, cfg, tparams = _weights(quantized)
    a = _audio(cfg, 2, 7)
    _close(T._encoder_forward(tparams, cfg, torch.from_numpy(a)),
           JT._encoder_forward(jparams, jcfg, jnp.asarray(a)), LOGIT_TOL)
    jk, jv = JT.encode_cross_kv(jparams, jcfg, jnp.asarray(a))
    tk, tv = T.encode_cross_kv(T.unstack_layers(tparams), cfg,
                               torch.from_numpy(a))
    assert tuple(tk.shape) == jk.shape == (
        cfg.num_layers, 2, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
    _close(tk, jk, LOGIT_TOL)
    _close(tv, jv, LOGIT_TOL)


def test_forward_and_loss_match_jax():
    """The training forward and loss with audio frames (dense weights);
    the forward refuses to run without them."""
    jcfg, jparams, cfg, tparams = _weights(False)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    labels = rng.integers(-1, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    a = _audio(cfg, 2, 9)
    _close(T.forward(tparams, cfg, torch.from_numpy(toks),
                     audio_embeds=torch.from_numpy(a)),
           JT.forward(jparams, jcfg, jnp.asarray(toks),
                      audio_embeds=jnp.asarray(a)), LOGIT_TOL)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "audio_embeds": jnp.asarray(a)}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    _close(T.loss_fn(tparams, cfg, tbatch),
           JT.loss_fn(jparams, jcfg, jbatch))
    with pytest.raises(ValueError, match="audio_embeds"):
        T.forward(tparams, cfg, torch.from_numpy(toks))


def test_param_tree_convert_and_quantize_match_jax():
    """The port's init draws the JAX tree (the encoder, ``cross``,
    ``norm3``, LayerNorm and MLP biases); converted leaf for leaf,
    ``quantize_tree`` turns the same leaves into W4A16 (the encoder's and
    ``cross``'s stacked linears) and keeps the biases, norms and ``embed``
    dense, as JAX's."""
    jcfg, jparams, cfg, tparams = _weights(False)
    gen = torch.Generator().manual_seed(0)
    mine = T.init_params(gen, cfg)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, QuantizedTensor):
            return ("q", tuple(tree.packed.shape), tree.group_size)
        return tuple(tree.shape)

    assert shapes(mine) == shapes(tparams)
    assert set(mine["encoder"]) == {"layers", "final_norm"}
    assert set(mine["layers"]) == {"norm1", "norm2", "norm3", "attn",
                                   "cross", "mlp"}
    assert set(mine["layers"]["mlp"]["w_up"]) == {"kernel", "bias"}
    assert set(mine["final_norm"]) == {"scale", "bias"}
    jq = JT.quantize_params(jparams, jcfg, min_size=0)
    tq = T.quantize_params(tparams, cfg, min_size=0)
    assert shapes(tq) == shapes(from_jax_params(jax_to_numpy(jq),
                                                dtype=cfg.dtype))
    assert isinstance(tq["encoder"]["layers"]["mlp"]["w_up"]["kernel"],
                      QuantizedTensor)
    assert isinstance(tq["layers"]["cross"]["wk"]["kernel"], QuantizedTensor)
    assert not isinstance(tq["embed"]["table"], QuantizedTensor)
    np.testing.assert_array_equal(
        tq["layers"]["cross"]["wk"]["kernel"].packed.numpy(),
        np.asarray(jq["layers"]["cross"]["wk"]["kernel"].packed))


# ---------------------------------------------------------------------------
# the model's steps
# ---------------------------------------------------------------------------

PS, NB, CACHE_LEN = 4, 13, 16


def _states(jcfg, cfg, B, seed):
    """JAX's and the port's paged states with the same random cross K/V."""
    js = JT.init_paged_state(jcfg, B, CACHE_LEN, page_size=PS,
                             num_blocks=NB, kv_format="kv_fp16")
    ts = T.init_paged_state(cfg, B, CACHE_LEN, page_size=PS, num_blocks=NB,
                            kv_format="kv_fp16", device="cpu")
    assert len(ts["enc_kv"]) == 2
    enc = []
    for i, leaf in enumerate(ts["enc_kv"]):
        v = _x(tuple(leaf.shape), seed + i)
        leaf.copy_(torch.from_numpy(v))
        enc.append(jnp.asarray(v))
    return dict(js, enc_kv=tuple(enc)), ts


@pytest.mark.parametrize("quantized", [False, True])
def test_chunk_decode_and_verify_steps_match_jax(quantized):
    """Both slots prefill 6 tokens in chunks of 4 (the second right-padded)
    over their own cross K/V rows, then three decode steps with slot 1 not
    decoding (its table row -1), then one verify window per slot (slot 1's
    short proposal padded with -1): logits at every chunk, every active
    decode row and every live verify position."""
    jcfg, jparams, cfg, tparams = _weights(quantized)
    js, ts = _states(jcfg, cfg, 2, seed=10)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    prompts = np.random.default_rng(11).integers(
        0, cfg.vocab_size, size=(2, 6)).astype(np.int32)
    C = 4
    for b in range(2):
        for start in (0, 4):
            n = min(C, 6 - start)
            positions = np.full((1, C), -1, np.int32)
            positions[0, :n] = np.arange(start, start + n)
            seg = np.zeros(C, np.int32)
            seg[:n] = prompts[b, start:start + n]
            jh = jlayers.embed(jparams["embed"], jnp.asarray(seg))[None]
            jl, js = JT.prefill_chunk_step(
                jparams, jcfg, js, jh, jnp.asarray(positions),
                jnp.asarray(tables[b:b + 1]), b, cache_len=CACHE_LEN,
                kv_format="kv_fp16")
            tl, ts = T.prefill_chunk_step(
                tparams, cfg, ts, torch.from_numpy(np.array(jh)),
                torch.from_numpy(positions), torch.from_numpy(
                    tables[b:b + 1]), b, cache_len=CACHE_LEN,
                kv_format="kv_fp16")
            _close(tl, jl, LOGIT_TOL)
    dec_tables = np.array([[1, 2, 3, 4], [-1] * 4], np.int32)
    tok = np.array([7, 9], np.int32)
    for step in range(3):
        pos = np.array([6 + step, 0], np.int32)
        jl, js = JT.decode_step(
            jparams, jcfg, js, jnp.asarray(tok), jnp.asarray(pos),
            tables=jnp.asarray(dec_tables), cache_len=CACHE_LEN,
            kv_format="kv_fp16")
        tl, ts = T.decode_step(
            tparams, cfg, ts, torch.from_numpy(tok), torch.from_numpy(pos),
            tables=torch.from_numpy(dec_tables), cache_len=CACHE_LEN,
            kv_format="kv_fp16")
        _close(tl[0], np.asarray(jl)[0], LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    vtok = np.array([[7, 9, 11, 13], [5, 8, 0, 0]], np.int32)
    vpos = np.array([[9, 10, 11, 12], [6, 7, -1, -1]], np.int32)
    jl, js, jc = JT.verify_step(
        jparams, jcfg, js, jnp.asarray(vtok), jnp.asarray(vpos),
        jnp.asarray(tables), cache_len=CACHE_LEN, kv_format="kv_fp16")
    tl, ts, tc = T.verify_step(
        tparams, cfg, ts, torch.from_numpy(vtok), torch.from_numpy(vpos),
        torch.from_numpy(tables), cache_len=CACHE_LEN, kv_format="kv_fp16")
    assert tc is None and jc is None
    live = vpos >= 0
    _close(tl.numpy()[live], np.asarray(jl)[live], LOGIT_TOL)
    with pytest.raises(ValueError, match="slot"):
        T.prefill_chunk_step(tparams, cfg, ts, torch.zeros(1, C, cfg.d_model),
                             torch.from_numpy(positions),
                             torch.from_numpy(tables[:1]), None,
                             cache_len=CACHE_LEN)


def test_ring_prefill_matches_jax():
    """The whole-prompt ring prefill with audio: last-position logits and
    the state's cross K/V."""
    jcfg, jparams, cfg, tparams = _weights(False)
    toks = np.random.default_rng(12).integers(
        0, cfg.vocab_size, size=(2, 7)).astype(np.int32)
    a = _audio(cfg, 2, 13)
    jl, jextra = JT.prefill(jparams, jcfg, jnp.asarray(toks), cache_len=8,
                            audio_embeds=jnp.asarray(a))
    tl, ts = T.prefill(tparams, cfg, torch.from_numpy(toks), cache_len=8,
                       audio_embeds=torch.from_numpy(a))
    _close(tl, jl, LOGIT_TOL)
    for got, want in zip(ts["enc_kv"], jextra["enc_kv"]):
        _close(got, want, LOGIT_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _prompts(cfg, n, plen, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
            for _ in range(n)]


def _requests(make, prompts, audios, G):
    return [make(rid=i, prompt=p, max_new_tokens=G, audio_embeds=a)
            for i, (p, a) in enumerate(zip(prompts, audios))]


def _engine_pair(quantized, prompts, audios, G, **kw):
    jcfg, jparams, cfg, tparams = _weights(quantized)
    common = dict(max_batch=2, max_prompt_len=max(len(p) for p in prompts),
                  max_new_tokens=G, page_size=4, **kw)
    jrep = JServingEngine(jcfg, jparams, **common).run(
        _requests(JRequest, prompts, audios, G))
    eng = ServingEngine(cfg, tparams, device="cpu", **common)
    return jrep, eng.run(_requests(Request, prompts, audios, G)), eng


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("chunk", [None, 3, 4])
def test_engine_token_parity_with_jax(quantized, chunk):
    """The acceptance: 3 requests, each with its own audio, through 2 slots
    (the third reuses a slot whose cross K/V rows its admit overwrites),
    chunked prefill interleaved with decode: JAX's greedy tokens, exactly,
    in as many steps and with as many pages."""
    cfg = configs.get_reduced(ARCH)
    audios = [_audio(cfg, 1, 20 + i)[0] for i in range(3)]
    jrep, rep, eng = _engine_pair(quantized, _prompts(cfg, 3, 9), audios, 6,
                                  prefill_chunk=chunk)
    assert rep.results == jrep.results and sorted(rep.results) == [0, 1, 2]
    assert all(len(v) == 6 for v in rep.results.values())
    assert rep.steps == jrep.steps and rep.peak_pages == jrep.peak_pages
    assert eng.paged and eng.share_prefix and eng.alloc.pages_in_use == 0
    assert eng.cache_len == 16          # 9 + 6 at 4-token pages: no frames
    if quantized:
        assert {p.strategy for p in eng.plans.values()} == {"reference"}


def test_engine_ngram_speculation_parity_with_jax():
    """ngram speculation at k = 4 over repeating prompts: every verify
    step's cross-attention reads its slot's rows; JAX's tokens and
    acceptance counts."""
    cfg = configs.get_reduced(ARCH)
    seg = _prompts(cfg, 2, 4, seed=3)
    prompts = [np.tile(s, 3) for s in seg]
    audios = [_audio(cfg, 1, 30 + i)[0] for i in range(2)]
    jrep, rep, eng = _engine_pair(True, prompts, audios, 8,
                                  speculate="ngram", spec_k=4)
    assert rep.results == jrep.results
    assert rep.proposed_tokens == jrep.proposed_tokens > 0
    assert rep.accepted_tokens == jrep.accepted_tokens


@pytest.mark.parametrize("same_audio", [True, False])
def test_sharing_follows_the_audio(same_audio):
    """Two requests with one 8-token prompt: over the same audio they share
    the prompt's pages; over different audio (the audio seeds the page
    keys, since cross-attention makes their decoder K/V differ) they share
    none. Tokens, peak pages and prefill steps saved equal JAX's, and
    different audio gives the unshared engine's page count."""
    cfg = configs.get_reduced(ARCH)
    prompt = _prompts(cfg, 1, 8, seed=5)[0]
    a0, a1 = _audio(cfg, 2, 40)
    audios = [a0, a0 if same_audio else a1]
    jrep, rep, _ = _engine_pair(True, [prompt, prompt], audios, 4)
    assert rep.results == jrep.results
    assert rep.peak_pages == jrep.peak_pages
    assert rep.prefill_steps_saved == jrep.prefill_steps_saved
    cfg_, tparams = _weights(True)[2:]
    unshared = ServingEngine(cfg_, tparams, max_batch=2, max_prompt_len=8,
                             max_new_tokens=4, page_size=4, device="cpu",
                             share_prefix=False).run(
        _requests(Request, [prompt, prompt], audios, 4))
    assert unshared.results == rep.results
    if same_audio:
        assert rep.results[0] == rep.results[1]
        assert rep.peak_pages < unshared.peak_pages
    else:
        assert rep.peak_pages == unshared.peak_pages
        assert rep.prefill_steps_saved == 0


def test_missing_audio_is_zeros_and_bad_audio_refused():
    """A request without audio runs on zero frames (JAX's behaviour); a
    wrongly shaped one, or one sent to an arch without an encoder, is
    refused at submit."""
    cfg = configs.get_reduced(ARCH)
    prompts = _prompts(cfg, 2, 5, seed=6)
    zeros = [np.zeros((cfg.encoder_seq, cfg.d_model), np.float32)] * 2
    _, tparams = _weights(True)[2:]
    kw = dict(max_batch=2, max_prompt_len=5, max_new_tokens=3, page_size=4,
              device="cpu")
    got = ServingEngine(cfg, tparams, **kw).run(
        [Request(rid=i, prompt=p, max_new_tokens=3)
         for i, p in enumerate(prompts)])
    want = ServingEngine(cfg, tparams, **kw).run(
        _requests(Request, prompts, zeros, 3))
    assert got.results == want.results
    eng = ServingEngine(cfg, tparams, **kw)
    eng.start()
    with pytest.raises(ValueError, match="audio_embeds must be"):
        eng.submit(Request(rid=0, prompt=prompts[0], max_new_tokens=3,
                           audio_embeds=zeros[0][:4]))
    with pytest.raises(ValueError, match="takes no prefix_embeds"):
        eng.submit(Request(rid=1, prompt=prompts[0], max_new_tokens=3,
                           prefix_embeds=zeros[0]))


def _post(port, spec_):
    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        body = json.dumps(spec_).encode()
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        payload = await reader.read()
        writer.close()
        return int(payload.split(b" ", 2)[1]), payload
    return go()


def test_front_door_with_audio_embeds():
    """Requests with ``audio_embeds`` over HTTP stream ``engine.run``'s
    tokens; ragged or misplaced embeds are a 400."""
    cfg = configs.get_reduced(ARCH)
    _, tparams = _weights(True)[2:]
    prompts = _prompts(cfg, 2, 6, seed=7)
    audios = [_audio(cfg, 1, 50 + i)[0] for i in range(2)]
    eng = ServingEngine(cfg, tparams, max_batch=2, max_prompt_len=6,
                        max_new_tokens=4, page_size=4, device="cpu")
    ref = eng.run(_requests(Request, prompts, audios, 4))

    async def main():
        fd = FrontDoor(eng)
        await fd.serve()
        outs = await asyncio.gather(*(_post(fd.port, {
            "prompt": [int(t) for t in prompts[i]], "max_new_tokens": 4,
            "audio_embeds": audios[i].tolist()}) for i in range(2)))
        bad = [(await _post(fd.port, {"prompt": [1, 2], "audio_embeds":
                                      [[0.0] * cfg.d_model] * 3}))[0],
               (await _post(fd.port, {"prompt": [1, 2], "prefix_embeds":
                                      [[0.0] * cfg.d_model]}))[0]]
        await fd.shutdown()
        return outs, bad

    outs, bad = asyncio.run(asyncio.wait_for(main(), 300))
    assert [s for s, _ in outs] == [200, 200]
    assert [sse_decode_tokens(p) for _, p in outs] == \
        [ref.results[i] for i in range(2)]
    assert bad == [400, 400]


# ---------------------------------------------------------------------------
# refusals and launchers
# ---------------------------------------------------------------------------

def test_encdec_draft_and_training_refused(tmp_path, monkeypatch):
    """An encdec draft is refused; the train launcher, which refused
    whisper once, trains it with two microbatches on audio frames from its
    own ``extra_inputs`` (drawn once, every step's batch), with
    checkpoints that restore."""
    cfg = configs.get_reduced(ARCH)
    with pytest.raises(ValueError, match="'encdec' draft"):
        spec.DraftModelProposer(cfg)
    drawn = []
    extra = ttrain.extra_inputs
    monkeypatch.setattr(ttrain, "extra_inputs", lambda *a: drawn.append(
        extra(*a)) or drawn[-1])
    train_launcher_round_trip(ARCH, tmp_path, "--microbatches", "2")
    assert [sorted(ex) for ex in drawn] == [["audio_embeds"]] * 2
    audio = drawn[0]["audio_embeds"]
    assert audio.shape == (4, 32, 128) and audio.dtype == torch.float32
    assert torch.equal(audio, drawn[1]["audio_embeds"])


@pytest.mark.parametrize("extra", [[], ["--speculate", "ngram"]])
def test_serve_launcher_on_cpu(extra, capsys):
    """The launcher draws each request's audio from the seed and serves it
    on the CPU (the encoder's attention stays ``chunked`` there)."""
    rep = tserve.main(["--arch", ARCH, "--reduced", "--batch", "2",
                       "--prompt-len", "6", "--gen", "3", "--device",
                       "cpu"] + extra)
    out = capsys.readouterr().out
    assert sorted(rep.results) == [0, 1]
    assert "prompt 6 + prefix 0 + gen 3; 2-layer encoder over 32 frames " \
        "a request at admit (attention chunked)" in out
    reqs = tserve.make_requests(configs.get_reduced(ARCH), 2, 6, 3, 0)
    assert reqs[0].audio_embeds.shape == (32, 128)
    assert not np.array_equal(reqs[0].audio_embeds, reqs[1].audio_embeds)


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
