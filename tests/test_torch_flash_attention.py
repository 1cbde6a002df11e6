"""Flash attention and chunked attention: the JAX package against the port
on the CPU.

The JAX Pallas kernel runs in interpret mode, as its own tests run it,
over its 5-case sweep (``tests/test_flash_attention.py``) and a case at
danube's head ratio (Hq 8 over Hkv 2, D 80, S 96, window 32). The port's
wrapper runs its plain version on CPU tensors. The JAX package cannot
differentiate its Pallas kernel (``jax.grad`` raises in
``_pallas_call_jvp_rule``), so the port's gradient is held against
``jax.grad`` of ``chunked_attention``, the JAX trainer's attention.

Tolerances: the JAX tests' own, rtol = atol = 1e-5 in fp32 (summation
order) and 2e-2 in bf16 (p and the output rounded to bf16 against running
maxima that differ with the tile sizes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.attention import chunked_attention as jax_chunked

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref
from repro_torch.models.attention import chunked_attention

# one torch thread a test process (see its docstring)
import torch_parity_helpers  # noqa: F401

SWEEP = [
    # B, Sq, Skv, Hq, Hkv, D, causal, window, dtype
    (2, 128, 128, 4, 2, 64, True, 0, "float32"),
    (1, 256, 256, 4, 1, 64, True, 64, "float32"),    # SWA + kv=1 GQA
    (2, 96, 96, 2, 2, 32, True, 0, "bfloat16"),      # unaligned S
    (1, 64, 192, 4, 4, 64, False, 0, "float32"),     # cross-attention
    (1, 128, 128, 8, 2, 128, True, 32, "bfloat16"),
    (1, 96, 96, 8, 2, 80, True, 32, "float32"),      # danube's head ratio
    (1, 96, 96, 8, 2, 80, True, 32, "bfloat16"),
]
F32_CASES = [c for c in SWEEP if c[-1] == "float32"]


def _inputs(B, Sq, Skv, Hq, Hkv, D, dtype, seed=0):
    """numpy q, k, v (fp32, rounded to ``dtype``) → (jax, torch) triples."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _close(got, want, dtype):
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,w,dt", SWEEP)
def test_plain_matches_jax_kernel_interpret(B, Sq, Skv, Hq, Hkv, D, causal,
                                            w, dt):
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Skv, Hq, Hkv, D, dt)
    want = jax_flash(jq, jk, jv, causal=causal, window=w, block_q=64,
                     block_kv=64, interpret=True)
    o, lse = tfa.flash_attention_plain(q, k, v, causal=causal, window=w)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    _close(o.float(), want, dt)
    # the CPU wrapper is the plain version, and so is the Function forward
    o2, lse2 = tfa.flash_attention_forward(q, k, v, causal=causal, window=w)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert torch.equal(tfa.flash_attention(q, k, v, causal=causal,
                                           window=w), o)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,w,dt", SWEEP)
def test_chunked_attention_matches_jax(B, Sq, Skv, Hq, Hkv, D, causal, w,
                                       dt):
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Skv, Hq, Hkv, D, dt, seed=1)
    want = jax_chunked(jq, jk, jv, causal=causal, window=w, q_chunk=16,
                       kv_chunk=32)
    got = chunked_attention(q, k, v, causal=causal, window=w, q_chunk=16,
                            kv_chunk=32)
    assert got.dtype == q.dtype
    _close(got.float(), want, dt)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,w,dt", F32_CASES)
def test_attention_ref_matches_jax(B, Sq, Skv, Hq, Hkv, D, causal, w, dt):
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Skv, Hq, Hkv, D, dt, seed=2)
    want = jref.attention_ref(jq, jk, jv, causal=causal, window=w)
    _close(tref.attention_ref(q, k, v, causal=causal, window=w), want, dt)


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,D,causal,w,dt", F32_CASES)
def test_function_grads_match_jax_grad_of_chunked(B, Sq, Skv, Hq, Hkv, D,
                                                  causal, w, dt):
    (jq, jk, jv), (q, k, v) = _inputs(B, Sq, Skv, Hq, Hkv, D, dt, seed=3)
    do = np.random.default_rng(4).standard_normal(
        (B, Sq, Hq, D)).astype(np.float32)
    jgrads = jax.grad(
        lambda a, b, c: jnp.sum(jax_chunked(a, b, c, causal=causal,
                                            window=w) * do),
        argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = tfa.flash_attention(*leaves, causal=causal, window=w)
    tgrads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_backward_over_many_tiles_matches_one_tile(monkeypatch):
    """Query tiles of 4 rows, each over only the keys it can see, give the
    gradient of one whole-sequence tile (fp64: the same sums, exactly
    rounded)."""
    _, (q, k, v) = _inputs(2, 40, 40, 4, 2, 16, "float32", seed=5)
    q, k, v = (t.double() for t in (q, k, v))
    do = torch.randn(q.shape, dtype=torch.float64,
                     generator=torch.Generator().manual_seed(0))
    o, lse = tfa.flash_attention_plain(q, k, v, causal=True, window=7)
    whole = tfa.flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                         window=7)
    monkeypatch.setattr(tfa, "TILE_ELEMS", 2 * 4 * 4 * 10)
    assert tfa._row_tile(2 * 4, 40, 40, causal=True, window=7,
                         full_kv=False) == 4
    tiled = tfa.flash_attention_backward(q, k, v, o, lse, do, causal=True,
                                         window=7)
    for a, b in zip(tiled, whole):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_backward_tile_at_danube_width():
    """2 x 8192 tokens, 32 query heads, window 4096: 128-row tiles over
    4223 keys, two score-sized fp32 tensors of 138 MB live per tile."""
    n = tfa._row_tile(2 * 32, 8192, 8192, causal=True, window=4096,
                      full_kv=False)
    assert n == 128
    assert 2 * 32 * n * (n + 4095) * 4 == 138_379_264


def test_gradcheck_float64_swa():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, dtype=torch.float64, generator=g,
                           requires_grad=True)
               for s in ((1, 12, 4, 8), (1, 12, 2, 8), (1, 12, 2, 8)))
    assert torch.autograd.gradcheck(
        lambda a, b, c: tfa.flash_attention(a, b, c, causal=True, window=4),
        (q, k, v))


def test_kernel_refuses_shapes_it_cannot_take():
    """Checked before any launch: head_dim not a multiple of 16 or above
    128, an fp16 or mixed dtype, Hq not a multiple of Hkv (the last one for
    the CPU path too)."""
    def qkv(D=80, Hq=8, Hkv=2, dtype=torch.bfloat16):
        return (torch.zeros(1, 64, Hq, D, dtype=dtype),
                torch.zeros(1, 64, Hkv, D, dtype=dtype),
                torch.zeros(1, 64, Hkv, D, dtype=dtype))
    for D in (24, 144):
        with pytest.raises(ValueError, match="multiple of 16"):
            tfa._launch(*qkv(D=D), causal=True, window=0)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tfa._launch(*qkv(dtype=torch.float16), causal=True, window=0)
    q, k, v = qkv()
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tfa._launch(q, k.float(), v, causal=True, window=0)
    with pytest.raises(ValueError, match="not a multiple"):
        tfa.flash_attention_forward(*qkv(Hq=6, Hkv=4), causal=True)


@pytest.mark.parametrize("D,dtype,stages", [
    (80, torch.bfloat16, 3), (80, torch.float32, 2),
    (128, torch.bfloat16, 2), (128, torch.float32, 2),
    (32, torch.bfloat16, 3), (64, torch.float32, 2)])
def test_kernel_geometry_fits_the_card(D, dtype, stages):
    """The kernel's shared memory: a 128-row Q tile and ``stages`` (K, V)
    64-key tiles, rows padded by 16 bytes; under the card's 227 KB at
    danube's D = 80 and at D = 128, and two blocks to an SM in bf16 at
    D <= 96. One block per (b, query head, 128-row tile)."""
    geo = tfa.flash_geometry(2, 8192, 32, D, dtype)
    elem = torch.finfo(dtype).bits // 8
    ld = D + (4 if elem == 4 else 8)
    assert geo.stages == stages
    assert geo.smem == 128 * ld * elem + stages * 2 * 64 * ld * elem
    assert geo.smem <= 227 * 1024
    if elem == 2 and D <= 96:
        assert 2 * geo.smem <= 228 * 1024
    assert geo.blocks == 64 * 2 * 32
    assert tfa.flash_geometry(3, 200, 8, D, dtype).blocks == 2 * 3 * 8


def test_kernel_geometry_refuses_before_any_launch():
    """Head dims the kernel is not built for (48 and 112 are multiples of
    16 without an instantiation) and fp16 raise ValueError from the
    geometry, and the wrapper raises before a launch is counted."""
    for D in (48, 112, 144, 24):
        with pytest.raises(ValueError, match="multiple of 16"):
            tfa.flash_geometry(1, 64, 8, D, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tfa.flash_geometry(1, 64, 8, 80, torch.float16)
    before = tfa.FLASH_ATTENTION.launches
    q, k, v = (torch.zeros(1, 64, h, 48, dtype=torch.bfloat16)
               for h in (8, 2, 2))
    with pytest.raises(ValueError, match="multiple of 16"):
        tfa._launch(q, k, v, causal=True, window=0)
    assert tfa.FLASH_ATTENTION.launches == before
