"""The port's quantization core against the JAX package: the stored W4A16
layout byte for byte (even K rows in the low nibble, odd rows in the high
nibble, shift-based sign extension), round-half-to-even in both
quantizers, the format registry, KV-cache formats and the JAX→torch
converter. Inputs come from numpy with a fixed seed; the arithmetic is the
same fp32 IEEE sequence on both sides, so these comparisons are exact
unless stated otherwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq

from repro_torch.convert import from_jax_params
from repro_torch.core import quant as tq
from repro_torch.kernels import common, ref

# one torch thread a test process (see its docstring)
import torch_parity_helpers  # noqa: F401


def _q4(shape, seed=0):
    return np.random.default_rng(seed).integers(-8, 8, size=shape) \
        .astype(np.int8)


def test_pack_int4_bytes_match_jax():
    q = _q4((64, 24))
    got = tq.pack_int4(torch.from_numpy(q)).numpy()
    want = np.asarray(jq.pack_int4(jnp.asarray(q)))
    assert got.dtype == np.int8 and got.shape == (32, 24)
    np.testing.assert_array_equal(got, want)
    # even rows in the low nibble, odd rows in the high nibble
    u = got.view(np.uint8)
    np.testing.assert_array_equal(u & 0xF, q[0::2].view(np.uint8) & 0xF)
    np.testing.assert_array_equal(u >> 4, q[1::2].view(np.uint8) & 0xF)


def test_unpack_int4_sign_extends_like_jax():
    packed = np.arange(-128, 128, dtype=np.int32).astype(np.int8) \
        .reshape(16, 16)                           # every byte value
    got = tq.unpack_int4(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got,
                                  np.asarray(jq.unpack_int4(
                                      jnp.asarray(packed))))
    assert got.min() == -8 and got.max() == 7
    q = _q4((32, 8), seed=1)
    np.testing.assert_array_equal(
        tq.unpack_int4(tq.pack_int4(torch.from_numpy(q))).numpy(), q)
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(torch.zeros(3, 2, dtype=torch.int8))


def test_round_half_to_even_pinned():
    """Exact .5 quotients round to the even integer in both quantizers
    (torch.round and jnp.round are both half-to-even)."""
    col = np.array([7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)
    w = np.tile(np.concatenate([col] * 16)[:, None], (1, 16))   # amax 7 → s 1
    want_q = np.array([7, 0, 2, 2, 0, -2, -2, 4], np.int8)
    t = tq.quantize(torch.from_numpy(w))
    j = jq.quantize(jnp.asarray(w))
    np.testing.assert_array_equal(tq.unpack_int4(t.packed).numpy()[:8, 0],
                                  want_q)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    x = np.array([[127.0, 0.5, 1.5, -2.5]], np.float32)          # s = 1
    kq, _ = tq.kv_quantize(torch.from_numpy(x), tq.KV8_CHANNEL)
    np.testing.assert_array_equal(kq.numpy(), [[127, 0, 2, -2]])
    np.testing.assert_array_equal(
        kq.numpy(), np.asarray(jq.kv_quantize(jnp.asarray(x),
                                              jq.KV8_CHANNEL)[0]))


@pytest.mark.parametrize("group,symmetric", [(128, True), (64, True),
                                             (32, False)])
def test_quantize_dequantize_match_jax(group, symmetric):
    w = np.random.default_rng(2).standard_normal((256, 48)) \
        .astype(np.float32) * 0.1
    t = tq.quantize(torch.from_numpy(w), group_size=group,
                    symmetric=symmetric)
    j = jq.quantize(jnp.asarray(w), group_size=group, symmetric=symmetric)
    assert t.format.name == j.format.name and t.group_size == j.group_size
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    if symmetric:
        assert t.zeros is None and j.zeros is None
    else:
        np.testing.assert_array_equal(t.zeros.numpy(), np.asarray(j.zeros))
    np.testing.assert_array_equal(tq.dequantize(t).numpy(),
                                  np.asarray(jq.dequantize(j)))
    np.testing.assert_array_equal(
        ref.dequant_ref(t.packed, t.scales, t.zeros, group,
                        out_dtype=torch.float32).numpy(),
        np.asarray(jq.dequantize(j)))
    x = np.random.default_rng(3).standard_normal((5, 256)).astype(np.float32)
    # one fp32 dot per output: summation order only (rtol 1e-5)
    np.testing.assert_allclose(
        tq.w4a16_matmul_ref(torch.from_numpy(x), t).numpy(),
        np.asarray(jq.w4a16_matmul_ref(jnp.asarray(x), j)),
        rtol=1e-5, atol=1e-5)


def test_format_registry():
    assert tq.resolve_format(None).name == "w4a16_g128"
    assert tq.W4A16_G128.with_group_size(64).name == "w4a16_g64"
    assert tq.w4a16_format_for(128, symmetric=False).name == \
        "w4a16_g128_asym"
    with pytest.raises(ValueError, match="unknown quantization format"):
        tq.get_format("w3a3")
    with pytest.raises(ValueError, match="stores 4-bit"):
        tq.QuantFormat("bad", weight_bits=8)
    with pytest.raises(ValueError, match="divisible"):
        tq.quantize(torch.zeros(96, 8))
    fmt = tq.QuantFormat.from_dict(tq.W4A16_G128.to_dict())
    assert fmt == tq.W4A16_G128


def test_kv_formats_match_jax():
    x = np.random.default_rng(4).standard_normal((6, 2, 8)) \
        .astype(np.float32) * 3
    q, s = tq.kv_quantize(torch.from_numpy(x), tq.KV8_CHANNEL)
    jqv, js = jq.kv_quantize(jnp.asarray(x), jq.KV8_CHANNEL)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tq.kv_dequantize(q, s, tq.KV8_CHANNEL, torch.float32).numpy(),
        np.asarray(jq.kv_dequantize(jqv, js, jq.KV8_CHANNEL, jnp.float32)))
    passthrough, none = tq.kv_quantize(torch.from_numpy(x), tq.KV_FP16)
    assert none is None and torch.equal(passthrough, torch.from_numpy(x))
    with pytest.raises(ValueError, match="unknown KV-cache format"):
        tq.get_kv_format("kv4")
    with pytest.raises(ValueError, match="per-head"):
        tq.KVFormat("bad", bits=8)


def test_convert_keeps_quantized_bytes():
    w = np.random.default_rng(5).standard_normal((2, 128, 32)) \
        .astype(np.float32)
    js = [jq.quantize(jnp.asarray(w[i])) for i in range(2)]
    tree = {"layers": {"wq": {"kernel": {
        "packed": np.stack([np.asarray(j.packed) for j in js]),
        "scales": np.stack([np.asarray(j.scales) for j in js]),
        "zeros": None, "group_size": 128,
        "format": js[0].format.to_dict()}}},
        "norm": {"scale": np.ones(4, np.float32)},
        "ids": np.arange(3, dtype=np.int32)}
    out = from_jax_params(tree, dtype=torch.bfloat16)
    qt = out["layers"]["wq"]["kernel"]
    assert isinstance(qt, tq.QuantizedTensor) and qt.K == 128 and qt.N == 32
    assert qt.format.name == "w4a16_g128" and qt.out_dtype == torch.bfloat16
    np.testing.assert_array_equal(qt.layer(1).packed.numpy(),
                                  np.asarray(js[1].packed))
    assert out["norm"]["scale"].dtype == torch.bfloat16
    assert out["ids"].dtype == torch.int32


def test_block_helpers_match_jax():
    from repro.kernels import common as jc
    for dim, target in ((2560, 512), (6912, 256), (96, 64), (7, 4)):
        assert common.largest_divisor(dim, target) == \
            jc.largest_divisor(dim, target)
        assert common.pick_block(dim, target) == jc.pick_block(dim, target)
    x = torch.ones(5, 3)
    assert common.pad_dim(x, 0, 8).shape == (8, 3)
    assert common.pad_dim(x, 1, 4).shape == (5, 4)
    assert common.pad_dim(x, 0, 5) is x
