"""The port's paged KV cache: the allocator property tests mirrored from
``tests/test_kvcache.py`` (ref-counting, CoW, warm-prefix LRU, purge),
prefix keys, the in-place pool writes, and parity with the JAX package's
pool ops (insert, chunk scatter, gather with the live-page clamp) and
cache sizing on the same numpy inputs. Pool contents are compared exactly:
both sides store the same values (kv8 quantization is the same fp32
sequence)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.core import quant as jq
from repro.runtime import kvcache as jkvc

from repro_torch import configs
from repro_torch.configs import shapes
from repro_torch.core import quant as tq
from repro_torch.runtime import kvcache as kvc

# one torch thread a test process (see its docstring)
import torch_parity_helpers  # noqa: F401


# ---------------------------------------------------------------------------
# block allocator (mirrors tests/test_kvcache.py)
# ---------------------------------------------------------------------------

def test_allocator_alloc_free_refcount():
    a = kvc.BlockAllocator(5, 4)
    b1, b2 = a.alloc(), a.alloc()
    assert b1 != b2 and kvc.NULL_BLOCK not in (b1, b2)
    assert a.pages_in_use == 2 and a.pages_free == 2
    a.incref(b1)
    assert a.refcount(b1) == 2
    assert not a.decref(b1)
    assert a.decref(b1)
    assert a.pages_in_use == 1 and a.pages_free == 3
    assert b1 in {a.alloc() for _ in range(3)}
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc()
    with pytest.raises(ValueError, match="null block"):
        kvc.BlockAllocator(1, 4)


def test_allocator_share_publish_cow():
    a = kvc.BlockAllocator(6, 4)
    bid = a.alloc()
    a.publish("k0", bid)
    assert a.peek("k0") == bid and a.refcount(bid) == 1
    assert a.lookup("k0") == bid and a.refcount(bid) == 2
    new = a.cow(bid)
    assert new != bid and a.refcount(bid) == 1 and a.refcount(new) == 1
    assert a.peek("k0") == bid
    with pytest.raises(ValueError, match="not shared"):
        a.cow(bid)
    assert a.decref(bid)
    assert a.peek("k0") is None
    b2 = a.alloc()
    a.publish("k1", b2)
    a.unpublish(b2)
    assert a.peek("k1") is None


def test_allocator_warm_retention_adopt_and_repark():
    a = kvc.BlockAllocator(6, 4, warm_bytes=4 * 8, block_bytes=8)
    bid = a.alloc()
    a.publish("k0", bid)
    a.set_meta("k0", 42)
    assert not a.decref(bid)
    assert a.is_warm(bid) and a.warm_pages == 1 and a.pages_in_use == 0
    got = a.lookup("k0")
    assert got == bid and not a.is_warm(bid) and a.refcount(bid) == 1
    assert a.meta("k0") == 42
    assert not a.decref(bid)
    assert a.is_warm(bid)
    z = kvc.BlockAllocator(6, 4)
    b2 = z.alloc()
    z.publish("k0", b2)
    assert z.decref(b2) and z.peek("k0") is None


def test_allocator_warm_budget_never_exceeded():
    a = kvc.BlockAllocator(10, 4, warm_bytes=2 * 8, block_bytes=8)
    parked = []
    for i in range(6):
        bid = a.alloc()
        a.publish(f"k{i}", bid)
        a.decref(bid)
        parked.append(bid)
        assert a.warm_bytes_used <= a.warm_bytes
    assert a.warm_pages == 2
    assert all(a.is_warm(b) for b in parked[-2:])
    assert not any(a.is_warm(b) for b in parked[:-2])
    assert a.take_reclaimed() == parked[:-2]
    assert a.take_reclaimed() == []


def test_allocator_alloc_reclaims_coldest_warm_block():
    a = kvc.BlockAllocator(4, 4, warm_bytes=8 * 8, block_bytes=8)
    b1, b2, b3 = a.alloc(), a.alloc(), a.alloc()
    a.publish("k1", b1)
    a.publish("k2", b2)
    a.decref(b1)
    a.decref(b2)
    assert a.pages_free == 0 and a.warm_pages == 2
    fresh = a.alloc()
    assert fresh == b1 and not a.is_warm(b1)
    assert a.peek("k1") is None and a.peek("k2") == b2
    assert a.take_reclaimed() == [b1]
    a.decref(b3)


def test_allocator_purge_warm_empties_pool():
    a = kvc.BlockAllocator(8, 4, warm_bytes=16 * 8, block_bytes=8)
    for i in range(5):
        bid = a.alloc()
        a.publish(f"k{i}", bid)
        a.decref(bid)
    purged = a.purge_warm()
    assert len(purged) == 5 and a.warm_pages == 0 and a.pages_in_use == 0
    assert a.pages_free == a.num_blocks - 1
    assert sorted(a.take_reclaimed()) == sorted(purged)
    assert all(a.peek(f"k{i}") is None for i in range(5))


def test_page_keys_match_jax():
    units = [bytes([i]) for i in range(10)]
    full, partial = kvc.page_keys(units, 4)
    assert (full, partial) == jkvc.page_keys(units, 4)
    assert len(full) == 2 and partial[1] == 2
    mutated = list(units)
    mutated[5] = b"\xff"
    fm, _ = kvc.page_keys(mutated, 4)
    assert fm[0] == full[0] and fm[1] != full[1]
    toks = np.arange(7, dtype=np.int32)
    assert kvc.position_units(toks) == jkvc.position_units(jnp.asarray(toks))
    assert kvc.page_keys(units, 4, seed=b"a") == \
        jkvc.page_keys(units, 4, seed=b"a")


# ---------------------------------------------------------------------------
# pool ops
# ---------------------------------------------------------------------------

def test_insert_is_in_place_and_inactive_rows_hit_the_null_block():
    fmt = tq.KV_FP16
    pool = kvc.init_pool(4, 2, 1, 4, torch.float32)
    tables = torch.tensor([[1, 2], [-1, -1]], dtype=torch.int32)
    k = torch.full((2, 1, 4), 7.0)
    out = kvc.paged_insert(pool, tables, k, k, torch.tensor([1, 3]),
                           cache_len=4, fmt=fmt)
    assert out is pool
    assert pool.page_pos[1, 1] == 1 and float(pool.k_pool[1, 1, 0, 0]) == 7
    assert torch.all(pool.page_pos[0] == -1)       # null block stays empty
    kvc.copy_blocks(pool, 1, 3)
    assert torch.equal(pool.k_pool[3], pool.k_pool[1])
    kvc.reset_blocks(pool, [1])
    assert torch.all(pool.page_pos[1] == -1) and pool.page_pos[3, 1] == 1


def test_stacked_pool_layer_views_write_through():
    pool = kvc.init_pool(3, 2, 1, 4, torch.float32, "kv8_channel",
                         num_layers=2)
    layer = pool.layer(1)
    kvc.paged_insert(layer, torch.tensor([[1, 2]], dtype=torch.int32),
                     torch.ones(1, 1, 4), torch.ones(1, 1, 4),
                     torch.tensor([0]), cache_len=4, fmt=tq.KV8_CHANNEL)
    assert pool.page_pos[1, 1, 0] == 0 and pool.page_pos[0, 1, 0] == -1
    assert pool.k_scale[1, 1, 0, 0] > 0
    kvc.reset_blocks(pool, [1])
    assert torch.all(pool.page_pos[:, 1] == -1)


@pytest.mark.parametrize("fmt_name", ["kv_fp16", "kv8_channel"])
def test_pool_ops_match_jax(fmt_name):
    """Decode inserts (with an inactive row), a padded chunk scatter past
    the wrap, and the gather (full and live-page clamped) leave both
    packages' pools and windows identical."""
    rng = np.random.default_rng(0)
    nb, ps, H, D, cache_len = 9, 4, 2, 8, 16
    jfmt, tfmt = jq.get_kv_format(fmt_name), tq.get_kv_format(fmt_name)
    tables = np.array([[1, 2, 3, 4], [5, 6, -1, -1]], np.int32)
    jpool = jkvc.init_pool(nb, ps, H, D, jnp.float32, fmt_name)
    tpool = kvc.init_pool(nb, ps, H, D, torch.float32, fmt_name)
    for p in range(6):
        k = rng.standard_normal((2, H, D)).astype(np.float32)
        v = rng.standard_normal((2, H, D)).astype(np.float32)
        pos = np.array([p, p + 3], np.int32)
        jpool = jkvc.paged_insert(jpool, jnp.asarray(tables), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(pos),
                                  cache_len=cache_len, fmt=jfmt)
        kvc.paged_insert(tpool, torch.from_numpy(tables),
                         torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(pos), cache_len=cache_len,
                         fmt=tfmt)
    kc = rng.standard_normal((5, H, D)).astype(np.float32)
    positions = np.array([14, 15, 16, 17, -1], np.int32)     # wraps, padded
    jpool = jkvc.scatter_chunk(jpool, jnp.asarray(tables[0]),
                               jnp.asarray(kc), jnp.asarray(kc),
                               jnp.asarray(positions), cache_len=cache_len,
                               fmt=jfmt)
    kvc.scatter_chunk(tpool, torch.from_numpy(tables[0]),
                      torch.from_numpy(kc), torch.from_numpy(kc),
                      torch.from_numpy(positions), cache_len=cache_len,
                      fmt=tfmt)
    for name in ("page_pos", "k_pool", "v_pool", "k_scale", "v_scale"):
        j, t = getattr(jpool, name), getattr(tpool, name)
        if j is None:
            assert t is None
            continue
        # the null block holds redirected writes whose bytes differ by
        # which duplicate index wins; its tags are -1 on both sides
        np.testing.assert_array_equal(t.numpy()[1:], np.asarray(j)[1:])
    np.testing.assert_array_equal(tpool.page_pos.numpy()[0], -1)
    for live in (None, 2, 3):
        jw = jkvc.gather_window(jpool, jnp.asarray(tables), fmt=jfmt,
                                out_dtype=jnp.float32, live_pages=live)
        tw = kvc.gather_window(tpool, torch.from_numpy(tables), fmt=tfmt,
                               out_dtype=torch.float32, live_pages=live)
        np.testing.assert_array_equal(tw.pos.numpy(), np.asarray(jw.pos))
        mapped = np.asarray(jw.pos) >= 0
        np.testing.assert_array_equal(tw.k.numpy()[mapped],
                                      np.asarray(jw.k)[mapped])
        np.testing.assert_array_equal(tw.v.numpy()[mapped],
                                      np.asarray(jw.v)[mapped])


def test_cache_sizing_matches_jax():
    cfg, jcfg = configs.get_reduced("h2o-danube-1.8b"), \
        jconfigs.get_reduced("h2o-danube-1.8b")
    full, jfull = configs.get_config("h2o-danube-1.8b"), \
        jconfigs.get_config("h2o-danube-1.8b")
    for c, j in ((cfg, jcfg), (full, jfull)):
        for P, G, ps in ((12, 6, 4), (30, 10, 5), (512, 32, 8),
                         (8000, 100, 16)):
            assert shapes.serve_cache_len(c, P, G, ps) == \
                jshapes.serve_cache_len(j, P, G, ps)
            assert shapes.serve_num_pages(c, P, G, page_size=ps,
                                          max_batch=8) == \
                jshapes.serve_num_pages(j, P, G, page_size=ps, max_batch=8)
    # the full-width serving pool of the chip smoke test: 545 blocks
    assert shapes.serve_num_pages(full, 512, 32, page_size=8,
                                  max_batch=8) == 545
    assert full.param_count() == jfull.param_count()
    with pytest.raises(ValueError, match="page multiple"):
        kvc.pages_per_slot(10, 4)
    with pytest.raises(ValueError, match="not ported"):
        configs.get_config("whisper-large")
