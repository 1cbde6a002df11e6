"""Paged KV cache: block pool + ref-counted allocator (port of
``repro/runtime/kvcache.py``).

Device side — :class:`PagedKVCache`: ``k_pool``/``v_pool`` of
``num_blocks × page_size × Hkv × D`` (the model stacks an L axis in front),
per-token ``page_pos`` tags and optional ``kv8_channel`` scales, addressed
through per-slot block tables. Unlike the JAX package, the writes
(:func:`paged_insert`, :func:`scatter_chunk`, :func:`copy_blocks`,
:func:`reset_blocks`) update the pool **in place** (``index_copy_`` /
``index_fill_`` on views) and return the same pool; the pool is the largest
serving tensor and is never copied. Reads that must see the pool before a
write (chunked prefill reads the window, then scatters the chunk) are
issued before the write on the same stream.

Layout invariant: a token at absolute position ``p`` lives at logical
offset ``p % cache_len`` of its slot's window, page ``offset // page_size``,
slot ``offset % page_size``. Physical block 0 is the permanently-empty null
block: a ``-1`` table entry reads it (all tags ``-1``, fully masked) and
writes from unmapped rows are redirected into it with ``-1`` tags.

Host side — :class:`BlockAllocator`: ref-counted alloc/free with a prefix
index and warm-prefix LRU retention, ported whole.
"""
from __future__ import annotations

import collections
import hashlib
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.quant import (
    DEFAULT_KV_FORMAT, KVFormat, get_kv_format, kv_dequantize, kv_quantize,
)
from repro_torch.models import attention

__all__ = [
    "PagedKVCache", "BlockAllocator", "NULL_BLOCK", "init_pool",
    "pages_per_slot", "paged_insert", "paged_decode_attention",
    "gather_window", "scatter_chunk", "scatter_chunks", "scatter_ring",
    "copy_blocks",
    "reset_blocks",
    "position_units", "page_keys",
]

NULL_BLOCK = 0


class PagedKVCache(NamedTuple):
    """Block-pool KV cache. ``k_pool``/``v_pool``: (..., num_blocks,
    page_size, Hkv, D) in the cache dtype (``kv_fp16``) or int8
    (``kv8_channel``, with fp32 ``k_scale``/``v_scale`` of shape
    (..., num_blocks, page_size, Hkv)); ``page_pos``: (..., num_blocks,
    page_size) int32, -1 empty."""

    k_pool: torch.Tensor
    v_pool: torch.Tensor
    page_pos: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return self.page_pos.shape[-2]

    @property
    def page_size(self) -> int:
        return self.page_pos.shape[-1]

    def layer(self, i: int) -> "PagedKVCache":
        """Layer ``i`` of a stacked pool (views: writes land in the stack)."""
        return PagedKVCache(*(None if t is None else t[i] for t in self))


def init_pool(num_blocks: int, page_size: int, num_kv_heads: int,
              head_dim: int, dtype, kv_format: str = DEFAULT_KV_FORMAT, *,
              num_layers: Optional[int] = None,
              device=None) -> PagedKVCache:
    """Fresh pool (stacked over ``num_layers`` when given); block 0 is the
    null block (never allocated)."""
    fmt = get_kv_format(kv_format)
    lead = () if num_layers is None else (num_layers,)
    shape = lead + (num_blocks, page_size, num_kv_heads, head_dim)
    payload = torch.int8 if fmt.quantized else dtype

    def scale():
        return torch.zeros(shape[:-1], dtype=torch.float32, device=device) \
            if fmt.quantized else None

    return PagedKVCache(
        k_pool=torch.zeros(shape, dtype=payload, device=device),
        v_pool=torch.zeros(shape, dtype=payload, device=device),
        page_pos=torch.full(lead + (num_blocks, page_size), -1,
                            dtype=torch.int32, device=device),
        k_scale=scale(), v_scale=scale())


def pages_per_slot(cache_len: int, page_size: int) -> int:
    if cache_len % page_size:
        raise ValueError(
            f"cache_len {cache_len} must be a page multiple (page_size "
            f"{page_size}); round it with configs.shapes.serve_cache_len")
    return cache_len // page_size


# ---------------------------------------------------------------------------
# device ops: gather / scatter through block tables (one layer's pool)
# ---------------------------------------------------------------------------

def _flat(leaf: torch.Tensor) -> torch.Tensor:
    """(nb, ps, ...) → (nb*ps, ...) flat token-slot view."""
    return leaf.view(leaf.shape[0] * leaf.shape[1], *leaf.shape[2:])


def gather_window(pool: PagedKVCache, tables: torch.Tensor, *,
                  fmt: KVFormat, out_dtype,
                  live_pages: Optional[int] = None) -> attention.KVCache:
    """Reassemble each slot's logical window (B, T·page_size, Hkv, D) from
    its block table (-1 → the null block), dequantized to ``out_dtype``.
    ``live_pages`` clamps the gather to the leading that-many table entries
    (callers must not clamp below the batch's live-page high-water mark)."""
    bt = tables.clamp_min(NULL_BLOCK).long()
    if live_pages is not None:
        bt = bt[:, :max(1, min(int(live_pages), bt.shape[1]))]
    B, T = bt.shape
    ps = pool.page_size

    def take(leaf):
        g = leaf.index_select(0, bt.reshape(-1))          # (B*T, ps, ...)
        return g.reshape(B, T * ps, *leaf.shape[2:])

    pos = take(pool.page_pos)
    if not fmt.quantized:
        return attention.KVCache(k=take(pool.k_pool).to(out_dtype),
                                 v=take(pool.v_pool).to(out_dtype), pos=pos)
    k = kv_dequantize(take(pool.k_pool), take(pool.k_scale), fmt, out_dtype)
    v = kv_dequantize(take(pool.v_pool), take(pool.v_scale), fmt, out_dtype)
    return attention.KVCache(k=k, v=v, pos=pos)


def _scatter(pool: PagedKVCache, flat_idx: torch.Tensor, k_new, v_new,
             pos_tag: torch.Tensor, fmt: KVFormat) -> PagedKVCache:
    """Write token vectors at flat pool slots, in place.
    flat_idx/pos_tag: (n,); k_new/v_new: (n, Hkv, D)."""
    idx = flat_idx.long()
    kq, ks = kv_quantize(k_new, fmt)
    vq, vs = kv_quantize(v_new, fmt)
    _flat(pool.k_pool).index_copy_(0, idx, kq.to(pool.k_pool.dtype))
    _flat(pool.v_pool).index_copy_(0, idx, vq.to(pool.v_pool.dtype))
    _flat(pool.page_pos).index_copy_(0, idx, pos_tag.to(torch.int32))
    if ks is not None:
        _flat(pool.k_scale).index_copy_(0, idx, ks)
        _flat(pool.v_scale).index_copy_(0, idx, vs)
    return pool


def paged_insert(pool: PagedKVCache, tables: torch.Tensor, k_new, v_new,
                 pos: torch.Tensor, *, cache_len: int,
                 fmt: KVFormat) -> PagedKVCache:
    """Decode-step insert, in place: one token per slot at logical
    ``pos % cache_len`` (k_new/v_new: (B, Hkv, D); pos: (B,)). Rows whose
    target page is unmapped write a -1 tag into the null block."""
    B = k_new.shape[0]
    ps = pool.page_size
    offset = (pos % cache_len).long()
    bid = torch.gather(tables.long(), 1, (offset // ps)[:, None])[:, 0]
    ok = bid >= 0
    fallback = torch.arange(B, device=pos.device) % ps
    flat = torch.where(ok, bid * ps + offset % ps, fallback)
    tag = torch.where(ok, pos.to(torch.int32),
                      torch.full_like(pos, -1, dtype=torch.int32))
    return _scatter(pool, flat, k_new, v_new, tag, fmt)


def scatter_chunk(pool: PagedKVCache, table: torch.Tensor, k_chunk, v_chunk,
                  positions: torch.Tensor, *, cache_len: int,
                  fmt: KVFormat) -> PagedKVCache:
    """Chunked-prefill scatter, in place: C tokens of one slot (k_chunk:
    (C, Hkv, D); positions (C,), -1 = padding; table (T,)). Requires
    C <= cache_len so offsets within one chunk are distinct."""
    return scatter_chunks(pool, table[None], k_chunk[None], v_chunk[None],
                          positions[None], cache_len=cache_len, fmt=fmt)


def scatter_chunks(pool: PagedKVCache, tables: torch.Tensor, k_chunk,
                   v_chunk, positions: torch.Tensor, *, cache_len: int,
                   fmt: KVFormat) -> PagedKVCache:
    """Batched :func:`scatter_chunk`, in place: C tokens for each of B
    slots at once (the speculative-verify write). k_chunk/v_chunk: (B, C,
    Hkv, D); positions: (B, C), -1 = padding (short proposals, inactive
    rows); tables: (B, T). Rows with ``-1`` positions or unmapped pages
    write ``-1`` tags into the null block; a slot's writable pages are
    exclusively its own after the engine's copy-on-write pass, so two
    slots never write one real page."""
    B, C = positions.shape
    ps = pool.page_size
    safe = positions.clamp_min(0).long()
    offset = safe % cache_len
    bid = torch.gather(tables.long(), 1, offset // ps)          # (B, C)
    ok = (positions >= 0) & (bid >= 0)
    spread = torch.arange(B * C, device=positions.device).reshape(B, C) % ps
    flat = torch.where(ok, bid * ps + offset % ps, spread)
    tag = torch.where(ok, positions.to(torch.int32),
                      torch.full_like(positions, -1, dtype=torch.int32))
    Hkv, D = k_chunk.shape[-2:]
    return _scatter(pool, flat.reshape(-1), k_chunk.reshape(B * C, Hkv, D),
                    v_chunk.reshape(B * C, Hkv, D), tag.reshape(-1), fmt)


def scatter_ring(pool: PagedKVCache, table, ring: attention.KVCache, *,
                 fmt: KVFormat) -> PagedKVCache:
    """Write a prefilled ring cache of one slot (B = 1) into the pages of
    its block ``table`` (T,), in place. The ring's index is the logical
    offset (the ring holds the slot's whole window), so ring entry ``j``
    lands at page ``j // page_size``, offset ``j % page_size``. ``ring``
    is one layer's ((1, W) tags) or stacked over L ((L, 1, W) tags, the
    pool stacked alike). Empty ring entries keep their -1 tag; entries
    whose page is unmapped write -1 tags into the null block."""
    ps = pool.page_size
    W = ring.pos.shape[-1]
    dev = ring.pos.device
    tbl = torch.as_tensor(np.asarray(table, np.int64), device=dev)
    j = torch.arange(W, device=dev)
    bid = tbl[j // ps]
    ok = bid >= 0
    flat = torch.where(ok, bid * ps + j % ps, j % ps)

    def one(pool_l, k, v, pos):
        tag = torch.where(ok, pos.to(torch.int32),
                          torch.full_like(pos, -1, dtype=torch.int32))
        return _scatter(pool_l, flat, k, v, tag, fmt)

    if ring.pos.dim() == 3:
        for i in range(ring.pos.shape[0]):
            one(pool.layer(i), ring.k[i, 0], ring.v[i, 0], ring.pos[i, 0])
        return pool
    return one(pool, ring.k[0], ring.v[0], ring.pos[0])


def paged_decode_attention(q: torch.Tensor, pool: PagedKVCache,
                           tables: torch.Tensor, pos: torch.Tensor, *,
                           window: int = 0, fmt: KVFormat, out_dtype,
                           attn_path: str = "gather", kv_partitions=None,
                           live_pages=None) -> torch.Tensor:
    """Decode attention over the paged pool on the planned path:
    ``gather`` reassembles the windows and runs ``decode_attention``;
    ``fused`` walks the block tables in the paged-attention kernel."""
    if attn_path == "fused":
        from repro_torch.kernels.paged_attention import fused_paged_attention

        return fused_paged_attention(
            q, pool, tables, pos, window=window, fmt=fmt,
            out_dtype=out_dtype, kv_partitions=kv_partitions)
    if attn_path != "gather":
        raise ValueError(f"unknown attn_path {attn_path!r} for paged decode "
                         f"(expected gather | fused)")
    cache = gather_window(pool, tables, fmt=fmt, out_dtype=out_dtype,
                          live_pages=live_pages)
    return attention.decode_attention(q, cache, pos, window=window)


def copy_blocks(pool: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy-on-write: duplicate physical block ``src`` into ``dst`` in
    place (per-layer or layer-stacked pool)."""
    axis = pool.page_pos.dim() - 2
    for leaf in pool:
        if leaf is not None:
            leaf.select(axis, dst).copy_(leaf.select(axis, src))
    return pool


def reset_blocks(pool: PagedKVCache, blocks: Sequence[int]) -> PagedKVCache:
    """Wipe the pos tags of freed blocks in place: stale K/V bytes stay but
    become unreachable."""
    idx = torch.as_tensor(np.asarray(blocks, np.int64),
                          device=pool.page_pos.device)
    pool.page_pos.index_fill_(pool.page_pos.dim() - 2, idx, -1)
    return pool


# ---------------------------------------------------------------------------
# host side: ref-counted block allocator + prefix-sharing index
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Ref-counted physical-block allocator with a prefix-sharing index and
    warm-prefix retention.

    Published blocks whose refcount drops to 0 park in a byte-budgeted warm
    LRU (``warm_bytes``) instead of freeing; ``lookup`` adopts them back,
    ``alloc`` reclaims the coldest when the free list runs dry, and
    reclaimed ids surface through :meth:`take_reclaimed` so their stale
    tags can be wiped before reuse.
    """

    def __init__(self, num_blocks: int, page_size: int, *,
                 warm_bytes: int = 0, block_bytes: int = 1):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is the null "
                             "block)")
        self.num_blocks = int(num_blocks)
        self.page_size = int(page_size)
        self.warm_bytes = int(warm_bytes)
        self.block_bytes = max(1, int(block_bytes))
        self._free = collections.deque(range(1, num_blocks))
        self._ref: dict = {}
        self._index: dict = {}
        self._key_of: dict = {}
        self._meta: dict = {}
        self._warm = collections.OrderedDict()
        self._reclaimed: List[int] = []

    @property
    def pages_in_use(self) -> int:
        return len(self._ref)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def warm_pages(self) -> int:
        return len(self._warm)

    @property
    def warm_bytes_used(self) -> int:
        return len(self._warm) * self.block_bytes

    def refcount(self, bid: int) -> int:
        return self._ref.get(bid, 0)

    def is_warm(self, bid: int) -> bool:
        return bid in self._warm

    def _drop_key(self, bid: int) -> None:
        key = self._key_of.pop(bid, None)
        if key is not None:
            self._index.pop(key, None)
            self._meta.pop(key, None)

    def _reclaim_warm(self) -> Optional[int]:
        if not self._warm:
            return None
        bid, _key = self._warm.popitem(last=False)
        self._drop_key(bid)
        self._free.append(bid)
        self._reclaimed.append(bid)
        return bid

    def take_reclaimed(self) -> List[int]:
        """Warm blocks freed since the last call (wipe their tags)."""
        out, self._reclaimed = self._reclaimed, []
        return out

    def purge_warm(self) -> List[int]:
        """Drop every warm block back to the free list."""
        purged = []
        while self._warm:
            purged.append(self._reclaim_warm())
        return purged

    def alloc(self) -> int:
        if not self._free:
            self._reclaim_warm()
        if not self._free:
            raise RuntimeError(
                f"KV block pool exhausted ({self.num_blocks - 1} usable "
                f"blocks of {self.page_size} tokens, all referenced); size "
                f"the pool with configs.shapes.serve_num_pages or admit "
                f"fewer concurrent requests")
        bid = self._free.popleft()
        self._ref[bid] = 1
        return bid

    def incref(self, bid: int) -> None:
        self._ref[bid] += 1

    def decref(self, bid: int) -> bool:
        """Drop one reference; True when the block was freed (the caller
        wipes its tags). A published block under a warm budget is retained
        instead (False)."""
        self._ref[bid] -= 1
        if self._ref[bid]:
            return False
        del self._ref[bid]
        key = self._key_of.get(bid)
        if key is not None and self.warm_bytes >= self.block_bytes:
            while self.warm_bytes_used + self.block_bytes > self.warm_bytes:
                self._reclaim_warm()
            self._warm[bid] = key
            self._warm.move_to_end(bid)
            return False
        self._drop_key(bid)
        self._free.append(bid)
        return True

    def cow(self, bid: int) -> int:
        """Copy-on-write bookkeeping: a private replacement for a shared
        block (the caller copies the payload with :func:`copy_blocks`)."""
        if self.refcount(bid) < 2:
            raise ValueError(f"block {bid} is not shared (ref "
                             f"{self.refcount(bid)}); nothing to CoW")
        new = self.alloc()
        self.decref(bid)
        return new

    def peek(self, key: str) -> Optional[int]:
        return self._index.get(key)

    def lookup(self, key: str) -> Optional[int]:
        """Find a published block for ``key`` and take a reference on it
        (a warm block is adopted back to live)."""
        bid = self._index.get(key)
        if bid is None:
            return None
        if bid in self._warm:
            del self._warm[bid]
            self._ref[bid] = 1
        else:
            self.incref(bid)
        return bid

    def set_meta(self, key: str, value) -> None:
        if key in self._index:
            self._meta[key] = value

    def meta(self, key: str):
        return self._meta.get(key)

    def publish(self, key: str, bid: int) -> None:
        """Register ``bid``'s content under ``key`` (first writer wins)."""
        if key in self._index or bid in self._key_of:
            return
        self._index[key] = bid
        self._key_of[bid] = key

    def unpublish(self, bid: int) -> None:
        key = self._key_of.pop(bid, None)
        if key is not None:
            self._index.pop(key, None)
            self._meta.pop(key, None)


# ---------------------------------------------------------------------------
# prefix keys: chain hash over page-aligned prompt content
# ---------------------------------------------------------------------------

def position_units(tokens, prefix_embeds=None) -> List[bytes]:
    """One canonical byte string per prefill position."""
    units: List[bytes] = []
    if prefix_embeds is not None:
        arr = np.asarray(prefix_embeds)
        for row in arr.reshape(arr.shape[0], -1):
            units.append(b"E" + row.tobytes())
    for t in np.asarray(tokens, np.int64).reshape(-1):
        units.append(b"T" + int(t).to_bytes(8, "little", signed=True))
    return units


def page_keys(units: Sequence[bytes], page_size: int, *, seed: bytes = b""
              ) -> Tuple[List[str], Optional[Tuple[str, int]]]:
    """Chain-hash keys for the page-aligned prefix of a prefill stream:
    one key per full page, plus ``(key, fill)`` for a trailing partial."""
    h = hashlib.sha256()
    if seed:
        h.update(seed)
    full: List[str] = []
    partial = None
    n = len(units)
    for i, u in enumerate(units):
        h.update(len(u).to_bytes(4, "little"))
        h.update(u)
        if (i + 1) % page_size == 0:
            full.append(h.hexdigest())
    fill = n % page_size
    if fill:
        partial = (h.hexdigest() + f"+{fill}", fill)
    return full, partial
