"""The remaining dense configs against the JAX package on the CPU:
starcoder2-7b (GELU MLP with biases), granite-20b (one KV head for 4
query heads at REDUCED, 48 at full width) and llama3-405b (REDUCED
only). Per arch: the config and its parameter count, the forward, the
loss and its gradients, engine-level greedy token parity (W4A16, chunked
prefill, ngram speculation), the tied head through
``dataclasses.replace(cfg, tie_embeddings=True)`` (the forward and the
engine), the train step (three steps against JAX's), remat, and the
launchers (llama3-405b refused outside REDUCED: it cannot fit one card;
``check_fits`` weighs every full config);
plus ``param_count`` of all ten full configs against JAX's.

Weights are the JAX package's, converted leaf for leaf; inputs come from
numpy with a fixed seed. REDUCED runs in fp32: logits after two layers
and a vocab-wide head are held to 1e-4, the loss to 1e-5, gradients to
1e-4 relative (summation order over the batch and two layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro.runtime.engine import Request as JRequest
from repro.runtime.engine import ServingEngine as JServingEngine

from repro_torch import configs
from repro_torch.convert import from_jax_params
from repro_torch.core.tree import tree_flatten_with_keys
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as T
from repro_torch.runtime import steps as tsteps
from repro_torch.runtime.engine import Request, ServingEngine

from torch_parity_helpers import (assert_train_matches, check_remat,
                                  jax_to_numpy, jax_trained, port_train)

ARCHS = ("starcoder2-7b", "granite-20b", "llama3-405b")
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)

_WEIGHTS = {}


def _weights(arch, quantized, tied=False):
    key = (arch, quantized, tied)
    if key not in _WEIGHTS:
        jcfg = dataclasses.replace(jconfigs.get_reduced(arch),
                                   w4a16_strategy="xla",
                                   tie_embeddings=tied)
        jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
        if quantized:
            jparams = JT.quantize_params(jparams, jcfg, min_size=0)
        cfg = dataclasses.replace(configs.get_reduced(arch),
                                  tie_embeddings=tied)
        tparams = from_jax_params(jax_to_numpy(jparams), dtype=cfg.dtype,
                                  device="cpu")
        _WEIGHTS[key] = (jcfg, jparams, cfg, tparams)
    return _WEIGHTS[key]


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **tol)


def test_param_counts_of_all_ten_archs_match_jax():
    """Every full and REDUCED config's fields and analytic parameter count
    equal JAX's (whisper-small's encdec count: decoder self- and
    cross-attention, the encoder's layers); the five new full configs at
    the sizes the chip smoke test serves."""
    assert configs.ARCHS == tuple(a for a in configs.ARCHS
                                  if a in jconfigs.ARCHS)
    assert set(configs.ARCHS) == set(jconfigs.ARCHS)
    for arch in configs.ARCHS:
        for get, jget in ((configs.get_config, jconfigs.get_config),
                          (configs.get_reduced, jconfigs.get_reduced)):
            c, j = get(arch), jget(arch)
            for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                      "d_ff", "vocab_size", "head_dim", "encoder_layers",
                      "encoder_seq", "vision_prefix", "mlp_type",
                      "norm_type", "tie_embeddings", "rope_theta", "family",
                      "padded_vocab"):
                # not ``bf16_partials``: it sums partials across devices
                # in bf16, so only the multi-card slice will carry it
                assert getattr(c, f) == getattr(j, f), (arch, f)
            assert c.param_count() == j.param_count(), arch
            assert c.active_param_count() == j.active_param_count(), arch
    want = {"whisper-small": 278_003_712, "internvl2-1b": 629_866_496,
            "starcoder2-7b": 7_398_752_256, "granite-20b": 28_166_848_512,
            "llama3-405b": 405_849_243_648}
    assert {a: configs.get_config(a).param_count() for a in want} == want
    tied = dataclasses.replace(configs.get_config("whisper-small"),
                               tie_embeddings=True)
    assert want["whisper-small"] - tied.param_count() == 51_968 * 768


# (K, N): runs at admit, for every quantized leaf of the four archs the
# card serves at full width (tests/test_torch_gpu.py holds the kernel at
# each): whisper-small's encoder layers and cross K/V also run at M = 1500
SERVED_GEMMS = {
    "whisper-small": {(768, 768): True, (768, 3072): True,
                      (3072, 768): True},
    "internvl2-1b": {(896, 896): False, (896, 128): False,
                     (896, 4864): False, (4864, 896): False},
    "starcoder2-7b": {(4608, 4608): False, (4608, 512): False,
                      (4608, 18432): False, (18432, 4608): False},
    "granite-20b": {(6144, 6144): False, (6144, 128): False,
                    (6144, 24576): False, (24576, 6144): False},
}


@pytest.mark.parametrize("arch", sorted(SERVED_GEMMS))
def test_served_w4a16_shapes_at_full_width(arch):
    """The W4A16 leaves of ``arch``'s full config, quantized as the serve
    launcher quantizes them (the tree built on the meta device: shapes
    only), are ``SERVED_GEMMS[arch]`` at group 128; ``embed`` and
    ``lm_head`` stay dense."""
    from repro_torch.kernels.planning import _quantized_paths
    full = configs.get_config(arch)
    cfg = dataclasses.replace(full, num_layers=1,
                              encoder_layers=min(full.encoder_layers, 1))
    params = T.quantize_params(T.init_params(torch.Generator(), cfg,
                                             device="meta"), cfg, min_size=0)
    got = {}
    for names, leaf in _quantized_paths(params):
        assert leaf.group_size == 128 and "lm_head" not in names \
            and "embed" not in names
        admit = names[0] == "encoder" or names[-3:-1] in (
            ("cross", "wk"), ("cross", "wv"))
        key = (int(leaf.K), int(leaf.N))
        got[key] = got.get(key, False) or admit
    assert got == SERVED_GEMMS[arch]


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, tied):
    jcfg, jparams, cfg, tparams = _weights(arch, False, tied)
    assert ("lm_head" in tparams) == (not tied)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    _close(T.forward(tparams, cfg, torch.from_numpy(toks)),
           JT.forward(jparams, jcfg, jnp.asarray(toks)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    """The loss and every leaf's gradient (starcoder2's MLP biases among
    them) against ``jax.value_and_grad`` of JAX's loss."""
    jcfg, jparams, cfg, tparams = _weights(arch, False)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 10)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -2:] = -1
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(jparams, jcfg, jbatch)
    loss, grads = tsteps.value_and_grad(
        tparams, cfg, {k: torch.from_numpy(np.array(v))
                       for k, v in jbatch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = dict(tree_flatten_with_keys(from_jax_params(
        jax_to_numpy(jgrads), dtype=torch.float32)))
    got = dict(tree_flatten_with_keys(grads))
    assert set(got) == set(want)
    if arch == "starcoder2-7b":
        assert any(k[-1] == "bias" for k in got)
    for k, g in got.items():
        w = want[k]
        scale = float(w.abs().max()) + 1e-6
        assert float((g - w).abs().max()) <= 1e-4 * scale, k


def _prompts(cfg, n, plen, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
            for _ in range(n)]


def _engine_pair(arch, prompts, G, *, quantized=True, tied=False, **kw):
    jcfg, jparams, cfg, tparams = _weights(arch, quantized, tied)
    common = dict(max_batch=2, max_prompt_len=max(len(p) for p in prompts),
                  max_new_tokens=G, page_size=4, **kw)
    reqs = lambda make: [make(rid=i, prompt=p, max_new_tokens=G)  # noqa
                         for i, p in enumerate(prompts)]
    jrep = JServingEngine(jcfg, jparams, **common).run(reqs(JRequest))
    eng = ServingEngine(cfg, tparams, device="cpu", **common)
    return jrep, eng.run(reqs(Request)), eng


@pytest.mark.parametrize("mode", ["chunk4", "ngram", "tied"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_token_parity_with_jax(arch, mode):
    """3 requests through 2 slots with W4A16 weights: 4-token prefill
    chunks, ngram speculation at k = 3 over repeating prompts, or the tied
    head (the unembedding of the dense ``embed`` table, which
    ``quantize_tree`` leaves dense): JAX's greedy tokens, steps and
    pages."""
    cfg = configs.get_reduced(arch)
    if mode == "ngram":
        prompts = [np.tile(s, 3) for s in _prompts(cfg, 3, 4, seed=4)]
        kw = dict(speculate="ngram", spec_k=3)
    else:
        prompts = _prompts(cfg, 3, 9, seed=5)
        kw = dict(prefill_chunk=4)
    jrep, rep, eng = _engine_pair(arch, prompts, 6, tied=mode == "tied",
                                  **kw)
    assert rep.results == jrep.results and sorted(rep.results) == [0, 1, 2]
    assert rep.steps == jrep.steps and rep.peak_pages == jrep.peak_pages
    if mode == "ngram":
        assert rep.proposed_tokens == jrep.proposed_tokens
        assert rep.accepted_tokens == jrep.accepted_tokens
    if mode == "tied":
        assert "lm_head" not in eng.params
        assert not any("embed" in k for k in eng.plans)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_cpu(arch, tmp_path, capsys):
    """The serve launcher on the CPU, and two training steps (the dense
    family trains, the GELU MLP's biases included)."""
    rep = tserve.main(["--arch", arch, "--reduced", "--batch", "2",
                       "--prompt-len", "6", "--gen", "3", "--device",
                       "cpu"])
    assert sorted(rep.results) == [0, 1]
    out = ttrain.main(["--arch", arch, "--reduced", "--steps", "2",
                       "--batch", "2", "--seq", "8", "--ckpt-dir",
                       str(tmp_path), "--ckpt-every", "10", "--device",
                       "cpu"])
    assert len(out.losses) == 2 and np.isfinite(out.losses).all()


# ---------------------------------------------------------------------------
# training: the train step against JAX's, remat, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_trained, arch, micro, attn_impl):
    """Three ``make_train_step`` steps from JAX's parameters against
    JAX's (``torch_parity_helpers.assert_train_matches``)."""
    want = jax_trained(arch, micro)
    got = port_train(arch, micro, want["params0"], attn_impl=attn_impl)
    assert_train_matches(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_the_same_grads(arch, monkeypatch):
    check_remat(arch, monkeypatch)


def test_train_launcher_refuses_llama3_405b_at_full_width(monkeypatch):
    """Even one layer of llama3-405b with its embedding and head is 7.4 B
    parameters, 175 GiB of training state at 22 B a parameter: the
    launcher refuses it for that reason before it draws any weight."""
    def no_init(*a, **k):
        raise AssertionError("weights drawn before the refusal")
    monkeypatch.setattr(T, "init_params", no_init)
    with pytest.raises(ValueError) as info:
        ttrain.main(["--arch", "llama3-405b", "--steps", "1", "--device",
                     "cpu"])
    msg = str(info.value)
    assert "cannot train on one device" in msg and "7.4 B parameters" in msg
    assert "175 GiB" in msg and "80 GiB" in msg and "--reduced" in msg
    assert "even one of its layers" in msg


# full configs: (arch, whether its training state fits one 80 GB card)
FITS = [("h2o-danube-1.8b", True), ("hymba-1.5b", True),
        ("whisper-small", True), ("internvl2-1b", True),
        ("olmoe-1b-7b", False), ("mixtral-8x7b", False),
        ("rwkv6-7b", False), ("starcoder2-7b", False),
        ("granite-20b", False), ("llama3-405b", False)]


@pytest.mark.parametrize("arch,fits", FITS)
def test_check_fits_holds_the_config_the_launcher_trains(arch, fits):
    """``check_fits`` weighs the full-depth config the launcher would
    train (``train_bytes`` at 22 B a parameter) against one card's 80
    GiB, and ``--reduced`` fits every arch."""
    cpu = torch.device("cpu")
    cfg = configs.get_config(arch)
    assert (ttrain.train_bytes(cfg) <= ttrain.CARD_BYTES) == fits
    if fits:
        ttrain.check_fits(cfg, cpu)
    else:
        with pytest.raises(ValueError, match="cannot train on one device"):
            ttrain.check_fits(cfg, cpu)
    ttrain.check_fits(configs.get_reduced(arch), cpu)
