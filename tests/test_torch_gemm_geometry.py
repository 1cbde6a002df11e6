"""The launch geometry of the port's float-contraction GEMM tile loop
(``csrc/gemm_tile.cuh``) and of the W4A8 kernel (``csrc/w4a8_gemm.cu``),
computed in pure Python by ``kernels/gemm.py:gemm_geometry`` and mirrored
field for field by the C launchers, which refuse a launch whose sizes
differ. The kernels run on the card only (``tests/test_torch_gpu.py``,
``chip_smoke.py``); here the geometry is held to what the kernel needs:
shared memory within the card's 227 KB, clusters of at most 8 blocks, and a
grid that covers M, N and K exactly, at every danube shape and every
reduced shape the CPU tests use.
"""
import pytest
import torch

from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels.common import MAX_SMEM
from repro_torch.kernels.planning import choose_split_k

# (K, N): danube's four GEMM shapes, the REDUCED danube's (d_model 128,
# 4/2 heads of 32, d_ff 256) and the CPU and card tests' edge shapes
SHAPES = [(2560, 2560), (2560, 640), (2560, 6912), (6912, 2560),
          (128, 128), (128, 64), (128, 256), (256, 128),
          (256, 384), (512, 256), (1024, 640), (1024, 144), (96, 16),
          (1056, 48)]
M_VALUES = (1, 8, 9, 32, 33, 256)
DTYPES = [torch.bfloat16, torch.float16, torch.float32]
FLOAT_KINDS = ("int4", "int8", "dense")


def _splits(M, N, K):
    """The planner's split_k on the H100 (132 SMs) and 1."""
    return sorted({choose_split_k(M, N, K, cores=132), 1})


def _check_covers(geo, kind, M, N, K, split_k, dtype, direct):
    gx, gy, gz = geo.grid
    assert gx * tgemm.GEMM_BN >= N > (gx - 1) * tgemm.GEMM_BN
    assert gy * geo.bm >= M > (gy - 1) * geo.bm
    assert gz == geo.ks == split_k * geo.sub
    assert K % geo.ks == 0 and (K // geo.ks) % 32 == 0
    assert 1 <= geo.cluster <= tgemm.MAX_CLUSTER and gz % geo.cluster == 0
    assert geo.smem <= MAX_SMEM
    if dtype == torch.float32:
        assert (geo.cluster, geo.sub, geo.stages, geo.smem) == (1, 1, 1, 0)
        assert geo.bm == (16 if M <= 16 else 32)
        return
    assert geo.bm == (8 if M <= 8 else 16 if M <= 16 else 32)
    assert geo.bk == (64 if kind == "dense" else 128)
    assert geo.stages == tgemm.GEMM_STAGES
    # direct: one cluster holds every K block of a tile; partials: one
    # cluster per plan slice
    assert geo.cluster == (geo.ks if direct else geo.sub)
    # the ring's stages and the warps' sums both fit the footprint
    assert geo.smem >= geo.stages * geo.stage_bytes
    assert geo.smem >= tgemm.GEMM_WARPS * geo.bm * (tgemm.GEMM_BN + 4) * 4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,N", SHAPES)
def test_geometry_fits_and_covers(K, N, dtype):
    """Every weight stage, M from 1 to 256, the planner's split_k and 1,
    direct and partials mode, with and without zero-points."""
    group = 32 if K % 128 else 128
    for kind in FLOAT_KINDS:
        for M in M_VALUES:
            for split_k in _splits(M, N, K):
                for direct in ({False, split_k == 1} if dtype ==
                               torch.float32 else (False, True)):
                    for zeros in (False, True):
                        geo = tgemm.gemm_geometry(
                            kind, M, N, K, split_k, dtype, direct=direct,
                            group=group, has_zeros=zeros)
                        _check_covers(geo, kind, M, N, K, split_k, dtype,
                                      direct)


# (K, N, group): the carry families' served W4A16 shapes; hymba's K = 1600
# leaves quantize at group 64 (quantize_tree's pick: 1600 % 128 != 0)
CARRY_SHAPES = [(4096, 4096, 128), (4096, 14336, 128), (14336, 4096, 128),
                (1600, 1600, 64), (1600, 320, 64), (1600, 3200, 64),
                (1600, 5504, 64), (3200, 1600, 128), (5504, 1600, 128)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,N,group", CARRY_SHAPES)
def test_geometry_at_carry_shapes(K, N, group, dtype):
    """rwkv6-7b's and hymba-1.5b's W4A16 shapes at decode (M = 1, 8), the
    k = 4 verify step (40) and a 32-token chunk, the planner's split_k at
    the leaf's group and 1, direct and partials: the layout fits and
    covers. At group 64 a 128-row stage holds parts of three groups, so
    it carries three scale rows; K = 1600 is 12.5 stages."""
    for M in (1, 8, 32, 40):
        splits = sorted({choose_split_k(M, N, K, group_size=group,
                                        cores=132), 1})
        for split_k in splits:
            for direct in ({False, split_k == 1} if dtype == torch.float32
                           else (False, True)):
                geo = tgemm.gemm_geometry("int4", M, N, K, split_k, dtype,
                                          direct=direct, group=group)
                _check_covers(geo, "int4", M, N, K, split_k, dtype, direct)
                if dtype != torch.float32:
                    assert geo.scale_rows == (3 if group == 64 else 2)
    # K = 1600 at group 64: the planner keeps it whole (a 2-way split
    # leaves 800 rows, not a multiple of 64), the tile loop cuts it in two
    # 800-row slices (25 x 32), no further (400 is not a multiple of 32)
    if K == 1600:
        assert choose_split_k(8, N, K, group_size=64, cores=132) == 1
        if dtype != torch.float32:
            geo = tgemm.gemm_geometry("int4", 8, N, K, 1, dtype,
                                      direct=True, group=64)
            assert (geo.ks, geo.cluster) == (2, 2)


def test_geometry_at_danube_decode():
    """Decode (M = 8) at danube width: one n8 token tile, 64-column blocks,
    K cut until the card holds about two blocks per SM. wq (K 2560, N 2560,
    split_k 4) runs 40 x 8 blocks in clusters of 8; the W4A16 stage is
    64 packed rows + 2 group-scale rows + an 8 x 136 x tile, four deep.
    w_gate (N 6912) already has 432 blocks at split_k 4, so it is not cut
    further; the dense GEMM of wk (split_k 1) cuts K eight ways."""
    bf16 = torch.bfloat16
    wq = tgemm.gemm_geometry("int4", 8, 2560, 2560, 4, bf16, direct=True,
                             group=128)
    assert (wq.bm, wq.bk, wq.stages, wq.ks, wq.sub, wq.cluster) == \
        (8, 128, 4, 8, 2, 8)
    assert wq.grid == (40, 1, 8) and wq.scale_rows == 2
    assert wq.smem == 4 * (64 * 64 + 2 * 64 * 4 + 8 * 136 * 2)
    gate = tgemm.gemm_geometry("int4", 8, 6912, 2560, 4, bf16, direct=True,
                               group=128)
    assert gate.grid == (108, 1, 4) and gate.cluster == 4
    wk = tgemm.gemm_geometry("dense", 8, 640, 2560, 1, bf16, direct=True)
    assert wk.grid == (10, 1, 8) and (wk.bk, wk.cluster) == (64, 8)
    assert wk.smem == 4 * (64 * 72 * 2 + 8 * 72 * 2)
    # decoupled phase 2 (partials): clusters of the blocks of one slice
    p2 = tgemm.gemm_geometry("dense", 8, 640, 2560, 4, bf16, direct=False)
    assert (p2.ks, p2.sub, p2.cluster) == (16, 4, 4)
    # a 32-token prefill chunk: four n8 tiles, the warps' sums set no floor
    w8 = tgemm.gemm_geometry("int8", 32, 2560, 2560, 1, bf16, direct=True)
    assert (w8.bm, w8.ks) == (32, 8)
    assert w8.smem == 4 * (128 * 80 + 32 * 136 * 2)


def test_geometry_follows_the_card():
    """``sub`` stops once the card has two blocks per SM: a card with half
    the SMs gets half the K cut."""
    bf16 = torch.bfloat16
    big = tgemm.gemm_geometry("int4", 8, 2560, 2560, 1, bf16, direct=True,
                              group=128, sms=132)
    small = tgemm.gemm_geometry("int4", 8, 2560, 2560, 1, bf16, direct=True,
                                group=128, sms=66)
    assert (big.ks, small.ks) == (8, 4)


def test_sums_in_kernel_is_a_shape_rule():
    """One launch when the output is in x's dtype and a cluster holds the
    split_k slices; the fp32 variant sums only split_k == 1 itself."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert tgemm.sums_in_kernel(1, bf16, bf16)
    assert tgemm.sums_in_kernel(8, bf16, bf16)
    assert not tgemm.sums_in_kernel(16, bf16, bf16)
    assert not tgemm.sums_in_kernel(2, bf16, f32)
    assert tgemm.sums_in_kernel(1, f32, f32)
    assert not tgemm.sums_in_kernel(2, f32, f32)


def test_geometry_refuses_what_the_kernels_do_not_take():
    bf16 = torch.bfloat16
    for args, kw, match in (
            (("int4", 8, 40, 256, 1, bf16), {}, "N % 16"),
            (("int4", 0, 64, 256, 1, bf16), {}, "M >= 1"),
            (("int4", 8, 64, 256, 16, bf16), {}, "multiples of 32"),
            (("int4", 8, 64, 512, 16, bf16), {"direct": True},
             "at most 8"),
            (("int4", 8, 64, 256, 1, bf16), {"group": 3}, "even"),
            (("int4", 8, 64, 256, 2, torch.float32), {"direct": True},
             "split_k == 1"),
            (("int2", 8, 64, 256, 1, bf16), {}, "weight stage"),
            (("dense", 8, 64, 256, 1, torch.float64), {}, "bf16/fp16/fp32")):
        kw = {"direct": False, "group": 128, **kw}
        with pytest.raises(ValueError, match=match):
            tgemm.gemm_geometry(*args, **kw)
    # beyond a cluster the partials route still takes the split
    geo = tgemm.gemm_geometry("int4", 8, 64, 512, 16, bf16, direct=False,
                              group=32)
    assert geo.ks == 16 and geo.cluster == 1


# ---------------------------------------------------------------------------
# the W4A8 kernel: every dtype on the int8 tensor cores, whole scale groups
# in every block's K rows and every warp's 128-row unit
# ---------------------------------------------------------------------------

def _w4a8_cases(K):
    for group in tgemm.W4A8_GROUPS:
        if K % group == 0:
            yield group


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,N", SHAPES)
def test_w4a8_geometry_fits_and_covers(K, N, dtype):
    """M from 1 to 256, every group that divides K, the planner's split_k,
    1 and 16 where they keep groups whole, direct (up to a cluster) and
    partials, with and without zero-points."""
    for kind in ("w4a8",):
        for group in _w4a8_cases(K):
            for M in M_VALUES:
                for split_k in sorted(set(_splits(M, N, K)) | {16}):
                    if K % split_k or (K // split_k) % group:
                        continue
                    for direct in {False, split_k <= tgemm.MAX_CLUSTER}:
                        for zeros in (False, True):
                            geo = tgemm.gemm_geometry(
                                kind, M, N, K, split_k, dtype,
                                direct=direct, group=group, has_zeros=zeros)
                            gx, gy, gz = geo.grid
                            assert gx * 64 >= N > (gx - 1) * 64
                            assert gy * geo.bm >= M > (gy - 1) * geo.bm
                            assert geo.bm == (8 if M <= 8 else 16 if M <= 16
                                              else 32)
                            assert gz == geo.ks == split_k * geo.sub
                            assert (K // geo.ks) % group == 0
                            assert geo.cluster == (geo.ks if direct
                                                   else geo.sub)
                            assert 1 <= geo.cluster <= tgemm.MAX_CLUSTER
                            assert (geo.bk, geo.stages) == (128, 2)
                            assert geo.scale_rows == 128 // group
                            assert geo.smem <= MAX_SMEM
                            assert geo.smem >= 4 * geo.stages \
                                * geo.stage_bytes + 2 * geo.bm * 4
                            assert geo.smem >= 4 * geo.bm * 68 * 4


def test_w4a8_geometry_at_danube_decode():
    """Decode (M = 8) at danube width, group 128. wq (K 2560 = 20 groups,
    split_k 4) cannot be cut further with whole groups: 40 x 4 blocks in
    clusters of 4. w_down (K 6912 = 54 groups, split_k 2) neither: 27
    groups, 27 units a block. A unit holds 4 KB of packed weights, one
    scale row, an 8 x 144 int8 x tile and 8 group sums; eight units a
    block, then the row scales."""
    bf16 = torch.bfloat16
    wq = tgemm.gemm_geometry("w4a8", 8, 2560, 2560, 4, bf16, direct=True,
                             group=128)
    assert (wq.bm, wq.bk, wq.stages, wq.ks, wq.sub, wq.cluster) == \
        (8, 128, 2, 4, 1, 4)
    assert wq.grid == (40, 1, 4) and wq.scale_rows == 1
    stage = 4096 + 256 + 1152 + 128
    assert wq.stage_bytes == stage and wq.smem == 8 * stage + 128
    down = tgemm.gemm_geometry("w4a8", 8, 2560, 6912, 2, bf16, direct=True,
                               group=128)
    assert down.grid == (40, 1, 2) and down.cluster == 2
    # group 32: K blocks cut while whole groups and the card allow it
    g32 = tgemm.gemm_geometry("w4a8", 8, 640, 2560, 1, bf16, direct=True,
                              group=32)
    assert (g32.ks, g32.cluster, g32.scale_rows) == (8, 8, 4)
    # fp32 activations run the same tensor-core kernel: a 32-token chunk,
    # the same layout as bf16
    f32 = tgemm.gemm_geometry("w4a8", 32, 2560, 2560, 4, torch.float32,
                              direct=True, group=128, has_zeros=True)
    assert (f32.bm, f32.cluster) == (32, 4)
    assert f32.stage_bytes == 4096 + 2 * 256 + 32 * 144 + 128


@pytest.mark.parametrize("args,kw,match", [
    (("w4a8", 8, 64, 256, 1, torch.bfloat16), {"group": 48}, "group 32"),
    (("w4a8", 8, 64, 384, 1, torch.bfloat16), {"group": 96}, "group 32"),
    (("w4a8", 8, 64, 256, 4, torch.bfloat16), {"group": 128}, "dividing"),
    (("w4a8", 8, 40, 256, 1, torch.bfloat16), {}, "N % 16"),
    (("w4a8", 0, 64, 256, 1, torch.bfloat16), {}, "M >= 1"),
    (("w4a8", 8, 64, 512, 16, torch.bfloat16), {"group": 32,
                                                "direct": True},
     "at most 8"),
    (("w4a8", 8, 64, 512, 16, torch.float32), {"group": 32,
                                                "direct": True},
     "at most 8"),
])
def test_w4a8_geometry_refuses_what_the_kernel_does_not_take(args, kw,
                                                             match):
    kw = {"direct": False, "group": 128, **kw}
    with pytest.raises(ValueError, match=match):
        tgemm.gemm_geometry(*args, **kw)


def test_w4a8_partials_beyond_a_cluster():
    """Beyond MAX_CLUSTER slices the partials route takes the split: one
    cluster per plan slice (sub blocks), here none."""
    geo = tgemm.gemm_geometry("w4a8", 8, 64, 512, 16, torch.bfloat16,
                              direct=False, group=32)
    assert geo.ks == 16 and geo.cluster == 1


# an MoE layer's expert stacks, (E, M, K, N): olmoe's at its decode (and
# chunk) capacity 8, mixtral's at decode capacity 2 and chunk capacity 10,
# and the REDUCED configs'
EXPERT_STACKS = [(64, 8, 2048, 1024), (64, 8, 1024, 2048),
                 (8, 2, 4096, 14336), (8, 10, 14336, 4096),
                 (8, 2, 128, 64), (4, 5, 256, 128)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("E,M,K,N", EXPERT_STACKS)
def test_expert_batch_stacks_along_grid_y(E, M, K, N, dtype):
    """A batch of E GEMMs is the single GEMM's layout with E times the
    grid's y extent; its K split counts the tiles of all E, so a stack
    that fills the card is not cut along K."""
    for kind in ("int4", "int8"):
        split = choose_split_k(M, N, K, cores=132, batch=E)
        for direct in (True, False):
            if direct and dtype == torch.float32 and split != 1:
                continue
            one = tgemm.gemm_geometry(kind, M, N, K, split, dtype,
                                      direct=direct, group=128)
            geo = tgemm.gemm_geometry(kind, M, N, K, split, dtype,
                                      direct=direct, group=128, batch=E)
            gx, gy, gz = geo.grid
            assert (gx, gy, gz) == (one.grid[0], one.grid[1] * E, geo.ks)
            assert (geo.bm, geo.bk, geo.smem) == (one.bm, one.bk, one.smem)
            assert geo.sub <= one.sub
            if dtype != torch.float32:
                tiles = gx * gy
                assert geo.sub == 1 or tiles * split * geo.sub // 2 \
                    < 2 * 132
    # olmoe's stacks hold 1024 and 2048 output tiles: no split, no sub
    geo = tgemm.gemm_geometry("int4", 8, 1024, 2048, 1, torch.bfloat16,
                              direct=True, group=128, batch=64)
    assert (geo.grid, geo.ks, geo.cluster) == ((16, 64, 1), 1, 1)


def test_expert_batch_refusals():
    with pytest.raises(ValueError, match="65535"):
        tgemm.gemm_geometry("int4", 32, 1024, 2048, 1, torch.bfloat16,
                            direct=True, group=128, batch=65536)
    with pytest.raises(ValueError, match="W4A8 kernel one"):
        tgemm.gemm_geometry("w4a8", 8, 1024, 2048, 1, torch.bfloat16,
                            direct=True, group=128, batch=8)
    with pytest.raises(ValueError, match="batch=0"):
        tgemm.gemm_geometry("int4", 8, 1024, 2048, 1, torch.bfloat16,
                            direct=True, group=128, batch=0)
