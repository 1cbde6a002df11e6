"""Paged attention: the JAX package's Pallas kernels (``fused_paged_attention``
and ``fused_chunk_attention``, run in interpret mode as their own tests run
them) against the port's versions, which on CPU tensors run the kernel
function's plain PyTorch version — the matrix of
``tests/test_paged_attention.py``: both KV formats, window 0/8, Split-K
partitions 1/2, SWA ring wrap (out-of-order tags), null (-1) table
entries, padded query rows, and the pool-poisoning single-count case. Both
sides get pools filled through their own ``paged_insert`` from the same
numpy data. On the card only: the CUDA kernel against the plain version.

Tolerance: fp32 compute on both sides; scores, softmax and readout differ
only in fp32 summation and exp order — rtol 2e-5, atol 2e-6 (the JAX
package's own fused-vs-gather tolerance).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import paged_attention as jpa
from repro.runtime import kvcache as jkvc

from repro_torch.core import quant as tq
from repro_torch.kernels import paged_attention as tpa
from repro_torch.runtime import kvcache as tkvc

# one torch thread a test process (see its docstring)
import torch_parity_helpers  # noqa: F401

B, HKV, G, D, PS, T_PAGES = 2, 2, 2, 32, 4, 4
CACHE_LEN = PS * T_PAGES
TOL = dict(rtol=2e-5, atol=2e-6)


def _pools(fmt_name, kv):
    """JAX and port pools holding the same tokens: ``kv`` maps position →
    (k, v) arrays of shape (B, HKV, D)."""
    nb = 1 + B * T_PAGES
    tables = (1 + np.arange(B * T_PAGES, dtype=np.int32)).reshape(B, T_PAGES)
    jfmt, tfmt = jq.get_kv_format(fmt_name), tq.get_kv_format(fmt_name)
    jpool = jkvc.init_pool(nb, PS, HKV, D, jnp.float32, fmt_name)
    tpool = tkvc.init_pool(nb, PS, HKV, D, torch.float32, fmt_name)
    for p, (k, v) in kv.items():
        pos = np.full((B,), p, np.int32)
        jpool = jkvc.paged_insert(jpool, jnp.asarray(tables), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos),
                                  cache_len=CACHE_LEN, fmt=jfmt)
        tkvc.paged_insert(tpool, torch.from_numpy(tables),
                          torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(pos), cache_len=CACHE_LEN,
                          fmt=tfmt)
    np.testing.assert_array_equal(tpool.page_pos.numpy(),
                                  np.asarray(jpool.page_pos))
    return jpool, tpool, tables, jfmt, tfmt


def _tokens(positions, seed):
    rng = np.random.default_rng(seed)
    return {p: (rng.standard_normal((B, HKV, D)).astype(np.float32),
                rng.standard_normal((B, HKV, D)).astype(np.float32))
            for p in positions}


def _roundtrip(x, fmt):
    return tq.kv_dequantize(*tq.kv_quantize(torch.from_numpy(x), fmt),
                            fmt=fmt, dtype=torch.float32).numpy()


# ---------------------------------------------------------------------------
# decode (q_len = 1)
# ---------------------------------------------------------------------------

def _decode(fmt_name, *, window, parts, first=0, fill=14, null_tail=False):
    kv = _tokens(range(first, first + fill), seed=first + fill)
    jpool, tpool, tables, jfmt, tfmt = _pools(fmt_name, kv)
    if null_tail:
        tables[1, 2:] = -1
    rng = np.random.default_rng(99)
    q = rng.standard_normal((B, HKV * G, D)).astype(np.float32)
    pos = np.full((B,), first + fill - 1, np.int32)
    want = jpa.fused_paged_attention(
        jnp.asarray(q), jpool, jnp.asarray(tables), jnp.asarray(pos),
        window=window, fmt=jfmt, out_dtype=jnp.float32,
        kv_partitions=parts, interpret=True)
    got = tpa.fused_paged_attention(
        torch.from_numpy(q), tpool, torch.from_numpy(tables),
        torch.from_numpy(pos), window=window, fmt=tfmt,
        out_dtype=torch.float32, kv_partitions=parts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return got, tpool, tables, tfmt, q, pos


@pytest.mark.parametrize("fmt_name", ["kv_fp16", "kv8_channel"])
@pytest.mark.parametrize("window,parts", [(0, 1), (8, 2)])
def test_decode_matches_jax_kernel(fmt_name, window, parts):
    _decode(fmt_name, window=window, parts=parts)


def test_decode_wrapped_ring_and_gather_path():
    """SWA wrap: positions past cache_len alias earlier offsets, so pages
    hold out-of-order tags; the port's gather path agrees too."""
    got, tpool, tables, tfmt, q, pos = _decode("kv_fp16", window=8, parts=2,
                                               first=9)
    gather = tkvc.paged_decode_attention(
        torch.from_numpy(q), tpool, torch.from_numpy(tables),
        torch.from_numpy(pos), window=8, fmt=tfmt, out_dtype=torch.float32)
    torch.testing.assert_close(got, gather, **TOL)


def test_decode_null_table_entries():
    _decode("kv8_channel", window=0, parts=2, fill=6, null_tail=True)


def test_partition_count_must_divide_table():
    got, tpool, tables, tfmt, q, pos = _decode("kv_fp16", window=0, parts=4)
    with pytest.raises(ValueError, match="must divide"):
        tpa.fused_paged_attention(
            torch.from_numpy(q), tpool, torch.from_numpy(tables),
            torch.from_numpy(pos), fmt=tfmt, out_dtype=torch.float32,
            kv_partitions=3)
    qpool = tkvc.init_pool(3, PS, HKV, D, torch.float32, "kv_fp16")
    with pytest.raises(ValueError, match="scales"):
        tpa.fused_paged_attention(
            torch.from_numpy(q), qpool, torch.from_numpy(tables),
            torch.from_numpy(pos), fmt=tq.KV8_CHANNEL,
            out_dtype=torch.float32)


# ---------------------------------------------------------------------------
# chunked prefill (q_len = C)
# ---------------------------------------------------------------------------

def _chunk(fmt_name, *, C, start, window, parts=None, null_tail=False,
           pad_slot1=False, poison=False):
    kv = _tokens(range(start), seed=start)
    if poison:       # junk copies at the chunk's own positions
        junk = np.full((B, HKV, D), 37.0, np.float32)
        kv.update({start + j: (junk, junk) for j in range(C)})
    jpool, tpool, tables, jfmt, tfmt = _pools(fmt_name, kv)
    if null_tail:
        tables[1, 2:] = -1
    rng = np.random.default_rng(777)
    q = rng.standard_normal((B, C, HKV * G, D)).astype(np.float32)
    kseg = _roundtrip(rng.standard_normal((B, C, HKV, D)).astype(np.float32),
                      tfmt)
    vseg = _roundtrip(rng.standard_normal((B, C, HKV, D)).astype(np.float32),
                      tfmt)
    positions = np.broadcast_to(start + np.arange(C, dtype=np.int32),
                                (B, C)).copy()
    if pad_slot1:
        positions[1, 1:] = -1
    want = jpa.fused_chunk_attention(
        jnp.asarray(q), jnp.asarray(kseg), jnp.asarray(vseg), jpool,
        jnp.asarray(tables), jnp.asarray(positions), window=window,
        fmt=jfmt, out_dtype=jnp.float32, kv_partitions=parts,
        interpret=True)
    got = tpa.fused_chunk_attention(
        torch.from_numpy(q), torch.from_numpy(kseg), torch.from_numpy(vseg),
        tpool, torch.from_numpy(tables), torch.from_numpy(positions),
        window=window, fmt=tfmt, out_dtype=torch.float32,
        kv_partitions=parts)
    live = positions >= 0
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               **TOL)


@pytest.mark.parametrize("fmt_name", ["kv_fp16", "kv8_channel"])
@pytest.mark.parametrize("C,start,window", [(1, 6, 8), (3, 6, 0),
                                            (6, 5, 8)])
def test_chunk_matches_jax_kernel(fmt_name, C, start, window):
    """q_len 1, 3 and a page-straddling 6, both formats, full and SWA
    masks."""
    _chunk(fmt_name, C=C, start=start, window=window)


@pytest.mark.parametrize("parts", [1, 2])
def test_chunk_split_k(parts):
    _chunk("kv8_channel", C=3, start=9, window=0, parts=parts)


def test_chunk_swa_wrap():
    """Chunk positions past cache_len: the ring has wrapped (page 0 holds
    tags {16, 17, 2, 3}) and the window mask applies."""
    _chunk("kv_fp16", C=3, start=18, window=8)


def test_chunk_null_blocks_and_padded_rows():
    _chunk("kv8_channel", C=3, start=5, window=0, null_tail=True,
           pad_slot1=True)


def test_chunk_masks_pool_entries_at_chunk_positions():
    """Single counting: pool copies of the chunk's own positions (a peer's
    duplicate, stale rejected drafts) stay masked; only the in-flight
    segment supplies those positions."""
    _chunk("kv_fp16", C=3, start=6, window=0, poison=True)


# ---------------------------------------------------------------------------
# the CUDA kernel's launch geometry (pure Python; the kernel runs on the card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("QG,D,P", [(4, 80, 34), (128, 80, 17),
                                    (4, 128, 68), (128, 128, 68),
                                    (20, 32, 4)])
def test_kernel_geometry_fits_the_card(dtype, quantized, QG, D, P):
    """Danube's decode (G = 4 rows) and chunk (Tq·G = 128) blocks at D = 80
    and 128, and a ragged 20-row tile at D = 32: the warps split into
    16-row groups and key groups (at most 8 warps), a stage holds whole
    16-key sub-tiles for every key group, and the footprint is the
    layout's and fits the card's 227 KB."""
    geo = tpa.paged_geometry(QG, D, dtype, quantized, P)
    assert geo.row_groups == -(-QG // 16)
    assert geo.row_groups * geo.key_groups <= 8
    assert geo.kb % (16 * geo.key_groups) == 0 and geo.kb >= 64
    assert geo.stages == (2 if dtype == torch.float32 else 3)
    elem = torch.finfo(dtype).bits // 8
    assert geo.smem == tpa.paged_smem_bytes(QG, D, elem, quantized, geo.kb,
                                            geo.stages, P, geo.key_groups)
    assert geo.smem <= 227 * 1024


def test_kernel_geometry_at_danube_shapes():
    """The planner's shapes at danube width: decode puts all 8 warps on
    one 16-row tile as key groups over 128-key stages; the 32-token chunk
    puts one 16-row group on each warp over 64-key stages. The bf16
    decode layout: 34 table entries, a 16 x 88 Q tile, three stages of
    (K, V) 128 x 88 tiles and 128 position tags."""
    dec = tpa.paged_geometry(4, 80, torch.bfloat16, False, 34)
    assert (dec.row_groups, dec.key_groups, dec.kb, dec.stages) == \
        (1, 8, 128, 3)
    assert dec.smem == 256 + 16 * 88 * 2 + 3 * (2 * 128 * 88 * 2 + 512)
    chunk = tpa.paged_geometry(128, 80, torch.bfloat16, False, 17)
    assert (chunk.row_groups, chunk.key_groups, chunk.kb, chunk.stages) == \
        (8, 1, 64, 3)
    assert chunk.smem == 128 + 128 * 88 * 2 + 3 * (2 * 64 * 88 * 2 + 256)


def test_kernel_refuses_shapes_before_any_launch():
    """A head dim the kernel is not built for, more than 128 query rows a
    block, a dtype it has no variant for, or a table too long for shared
    memory raise ValueError in the wrapper, before anything reaches the
    card (the operands here lie on the CPU, so any launch would fail
    otherwise)."""
    for QG, D, dtype, P, match in ((4, 72, torch.bfloat16, 17, "head_dim"),
                                   (4, 256, torch.bfloat16, 17, "head_dim"),
                                   (132, 80, torch.bfloat16, 17, "rows"),
                                   (4, 80, torch.float64, 17, "dtype"),
                                   (4, 80, torch.bfloat16, 30000,
                                    "shared memory")):
        with pytest.raises(ValueError, match=match):
            tpa.paged_geometry(QG, D, dtype, False, P)
    pool = tkvc.init_pool(3, PS, HKV, 72, torch.bfloat16, "kv_fp16")
    qk = torch.zeros(1, HKV, 1, G, 72, dtype=torch.bfloat16)
    before = tpa.PAGED_ATTENTION.launches
    with pytest.raises(ValueError, match="head_dim"):
        tpa._launch_partials(qk, torch.zeros(1, 1, dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32), pool,
                             torch.ones(1, 2, dtype=torch.int32), Tq=1, G=G,
                             S=1, window=0, fmt=tq.get_kv_format("kv_fp16"))
    assert tpa.PAGED_ATTENTION.launches == before
