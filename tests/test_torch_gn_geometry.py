"""The cut of a GroupNorm call for the cluster kernels of
unet_tpu_torch/csrc/groupnorm.cu (`ops/kernels/groupnorm.py::geometry`),
checked on the CPU at every GroupNorm input of the default U-Net: the
kernels themselves run only on a GPU (chip_smoke.py), but what the wrapper
hands them is decided here."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from unet_tpu_torch.config import UnetConfig
from unet_tpu_torch.models.unet import build_plan
from unet_tpu_torch.ops.kernels import groupnorm as port_gn

SOURCE = (Path(port_gn.__file__).resolve().parents[2] / "csrc"
          / "groupnorm.cu").read_text()
BATCHES = (1, 4, 8, 16, 32)
SMEM_LIMIT = 227 * 1024  # what one block may use on an H100


def gn_shapes(cfg):
    """The distinct (H, W, C) of the GroupNorm inputs of one forward: both
    norms of every res block, the norm of every attention block, and the
    final norm, at the resolution the plan has reached."""
    plan, res, shapes = build_plan(cfg), cfg.image_size, []
    for group in plan.input_blocks + (plan.middle,) + plan.output_blocks:
        for layer in group:
            if layer[0] == "res":
                shapes += [(res, res, layer[1]), (res, res, layer[2])]
            elif layer[0] == "attn":
                shapes.append((res, res, layer[1]))
            elif layer[0] == "down":
                res //= 2
            elif layer[0] == "up":
                res *= 2
    shapes.append((cfg.image_size, cfg.image_size, plan.out_channels_pre_head))
    return sorted(set(shapes)), len(shapes)


SHAPES, CALLS = gn_shapes(UnetConfig())


def test_the_default_model_has_17_groupnorm_shapes_in_56_calls():
    assert (len(SHAPES), CALLS) == (17, 56)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gn_geometry_covers_every_row_within_the_card(shape):
    """For every batch the model runs at, both types and both directions:
    the cluster's blocks cover the H*W rows exactly once with none empty,
    the cluster is a power of two of at most 16, a block asks for at most
    227 KB of shared memory, a staged ring holds all of the block's rows,
    and every bfloat16 shape is staged."""
    H, W, C = shape
    rows = H * W
    for B in BATCHES:
        for dtype in (torch.float32, torch.bfloat16):
            for backward in (False, True):
                geo = port_gn.geometry(B, H, W, C, 32, dtype, backward)
                what = (B, shape, dtype, backward, geo)
                assert geo.cluster in (1, 2, 4, 8, 16), what
                assert (geo.cluster - 1) * geo.rows_per_block < rows, what
                assert geo.cluster * geo.rows_per_block >= rows, what
                assert 0 < geo.smem_bytes <= SMEM_LIMIT, what
                assert 1 <= geo.tile_rows <= geo.rows_per_block, what
                assert not (geo.staged and geo.streamed), what
                if geo.staged:
                    assert 4 * geo.tile_rows >= geo.rows_per_block, what
                if dtype == torch.bfloat16:
                    assert geo.staged, what
                assert geo.threads % (C // port_gn.vec_width(
                    C, dtype.itemsize)) == 0, what


@pytest.mark.parametrize("B,shape,G,dtype,backward,want", [
    (2, (128, 128, 256), 32, torch.bfloat16, False, "streamed"),
    (32, (64, 64, 192), 32, torch.float32, True, "streamed"),
    (32, (64, 64, 128), 32, torch.float32, True, "streamed"),
    (1, (4, 4, 34), 2, torch.float32, False, "direct"),
    (3, (5, 7, 36), 4, torch.bfloat16, True, "direct"),
])
def test_gn_geometry_streams_what_does_not_fit(B, shape, G, dtype, backward,
                                                want):
    """Slabs too large for 16 blocks' shared memory stream through the
    ring; a C that fills no 16-byte vector is read from device memory."""
    geo = port_gn.geometry(B, *shape, G, dtype, backward)
    got = ("staged" if geo.staged else "streamed" if geo.streamed
           else "direct")
    assert got == want
    assert geo.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("B,shape,G,dtype,backward", [
    (32, (8, 8, 3072), 32, torch.bfloat16, True),  # --num_channels 384
    (2, (8, 8, 2080), 32, torch.float32, True),
    (2, (8, 8, 4160), 32, torch.bfloat16, True),   # a last step not whole
    (2, (64, 64, 2976), 32, torch.float32, True),  # streamed, 1-row tiles
    (1, (2, 2, 2056), 8, torch.bfloat16, True),
    (1, (2, 2, 4104), 8, torch.bfloat16, False),
    (2, (8, 8, 4160), 32, torch.float32, False),
    (1, (3, 3, 6111), 3, torch.float32, False),    # one channel a vector
])
def test_gn_geometry_takes_rows_wider_than_a_block(B, shape, G, dtype,
                                                   backward):
    """A row with more vectors than a block may have threads (512, 256 in
    the backward at 8 values a thread) is shared out: each thread takes J
    vectors of it, and the block's threads cover the row's vectors in J
    steps, none wasted but the last step's few."""
    geo = port_gn.geometry(B, *shape, G, dtype, backward)
    C = shape[-1]
    vec = port_gn.vec_width(C, dtype.itemsize)
    per_row, cap = C // vec, port_gn.max_threads(backward, vec)
    assert per_row > cap >= geo.threads
    J = -(-per_row // geo.threads)
    assert geo.threads * (J - 1) < per_row <= geo.threads * J
    assert J == -(-per_row // cap)
    assert 0 < geo.smem_bytes <= SMEM_LIMIT
    rows = shape[0] * shape[1]
    assert (geo.cluster - 1) * geo.rows_per_block < rows
    assert geo.cluster * geo.rows_per_block >= rows


@pytest.mark.parametrize("C", [1536, 2048])
def test_gn_geometry_gives_the_wide_float32_backward_a_thread_a_vector(C):
    """The trainer's widest float32 GroupNorm inputs at --num_channels 192
    and 256 (decoder concatenations at 8x8): one thread a 16-byte vector of
    a row, up to 512 threads."""
    geo = port_gn.geometry(32, 8, 8, C, 32, torch.float32, True)
    assert geo.threads == C // 4 <= port_gn.max_threads(True, 4)
    assert geo.staged and 0 < geo.smem_bytes <= SMEM_LIMIT


def _widest_c_of_the_two_kernel_design(G, itemsize, backward):
    """The widest C (a multiple of G) that the earlier two-launch kernels
    took: in the forward G <= 1024 and (2G + 2C) floats within 48 KB; in
    the backward C / V <= 1024 threads a row and both kernels' arrays
    ((2G + 2C + 2 RS C) and (4G + 4C) floats) within 48 KB."""
    best = None
    for C in range(G, 8192, G):
        if not backward:
            ok = G <= 1024 and (2 * G + 2 * C) * 4 <= 48 * 1024
        else:
            per_row = C // port_gn.vec_width(C, itemsize)
            slots = 256 // per_row if per_row < 256 else 1
            ok = (per_row <= 1024
                  and (2 * G + 2 * C + 2 * slots * C) * 4 <= 48 * 1024
                  and (4 * G + 4 * C) * 4 <= 48 * 1024)
        best = C if ok else best
    return best


@pytest.mark.parametrize("G", [8, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("backward", [False, True])
def test_gn_geometry_takes_the_widest_rows_the_earlier_kernels_took(
        G, dtype, backward):
    """No shape the earlier design took is refused: its widest C, at a
    small and at a large batch, gets a geometry within the card."""
    C = _widest_c_of_the_two_kernel_design(G, dtype.itemsize, backward)
    for B, H, W in ((1, 1, 1), (32, 8, 8)):
        geo = port_gn.geometry(B, H, W, C, G, dtype, backward)
        assert 0 < geo.smem_bytes <= SMEM_LIMIT
        assert geo.threads <= port_gn.max_threads(
            backward, port_gn.vec_width(C, dtype.itemsize))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_geometry_takes_the_smallest_cluster_that_holds_the_rows(
        dtype):
    """gn_stats stages a block's rows for its two passes in the smallest
    cluster that keeps them within 100 KB (K4's first choice, not doubled
    to fill the card); gn_bwd_sums reads its rows once, so its blocks take
    at most 64 KB of x and dy in one tile, in the smallest such cluster that
    keeps two blocks an SM, and stream what is larger in 16 KB tiles.  At a
    rank's (32, 32, 64, 64) of two ranks: gn_stats in clusters of 4
    (bfloat16) or 8 (float32), gn_bwd_sums in clusters of 8."""
    item = dtype.itemsize
    for shape in ((32, 32, 64, 64), (32, 16, 32, 128), (32, 8, 16, 192),
                  (32, 4, 8, 256)):
        B, H, W, C = shape
        rows = H * W
        stats = port_gn.split_geometry("stats", *shape, 32, dtype)
        assert stats.staged, (shape, stats)
        assert stats.rows_per_block * C * item <= 100 * 1024, (shape, stats)
        assert (stats.cluster == 1
                or -(-rows // (stats.cluster // 2)) * C * item > 100 * 1024)
        sums = port_gn.split_geometry("sums", *shape, 32, dtype)
        block = sums.rows_per_block * 2 * C * item
        assert B * sums.cluster <= 2 * 132, (shape, sums)
        assert (sums.cluster == 1
                or -(-rows // (sums.cluster // 2)) * 2 * C * item > 64 * 1024)
        if sums.staged:
            assert block <= 64 * 1024 and sums.tile_rows == sums.rows_per_block
        else:
            assert sums.streamed and sums.tile_rows * 2 * C * item <= 16 * 1024
    assert port_gn.split_geometry("stats", 32, 32, 64, 64, 32, dtype).cluster \
        == (4 if dtype == torch.bfloat16 else 8)
    sums = port_gn.split_geometry("sums", 32, 32, 64, 64, 32, dtype)
    assert (sums.cluster, sums.rows_per_block) == (8, 256)
    assert sums.staged == (dtype == torch.bfloat16)


def test_gn_geometry_constants_match_the_source():
    """The wrapper counts shared memory and threads as the launcher does
    (the launcher launches with its own count, the wrapper chooses the
    geometry by its)."""
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", SOURCE)[1])
    assert port_gn._SLOTS == const("kSlots")
    assert port_gn._MAX_CLUSTER == const("kMaxCluster")
    assert port_gn._TARGET_THREADS == const("kTargetThreads")
    assert port_gn._MAX_THREADS == const("kMaxThreads")
    assert port_gn._MAX_THREADS_BWD8 == const("kMaxThreadsBwd8")
    assert re.search(r"return backward && V >= 8 \? kMaxThreadsBwd8 : "
                     r"kMaxThreads;", SOURCE)
    assert re.search(r"kMaxSmem = 227 \* 1024", SOURCE)
    assert port_gn._SMEM_LIMIT == SMEM_LIMIT


def test_gn_smem_bytes_counts_the_ring_and_the_arrays():
    """(8,64,64,64) bfloat16 forward in clusters of 8: 512 rows of 64
    channels in the ring, 32 x 64 fold floats, 64 channel floats, 2 x 32
    for the block's and the element's statistics each, 8 x 2 x 32 for the
    cluster's, and four 8-byte barriers.  With 8-byte vectors there is no
    ring, and 16 row slots of 16 threads."""
    ring = 512 * 64 * 2
    floats = 32 * 64 + 64 + 4 * 32 + 8 * 2 * 32
    assert port_gn.smem_bytes(False, 8, 512, 128, 64, 32, 8, 2) == (
        ring + 4 * floats + 8 * 4)
    floats = 16 * 64 + 64 + 4 * 32 + 8 * 2 * 32
    assert port_gn.smem_bytes(False, 8, 512, 512, 64, 32, 4, 2) == (
        4 * floats + 8 * 4)


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+)", SOURCE)[1])


def _source_apply_layout(C, vec):
    """(cols, lanes, slots) as the launcher's `apply_layout` computes them,
    its statements evaluated in Python."""
    body = re.search(r"inline ApplyLayout apply_layout\(int C, int vec\) "
                     r"\{(.*?)\n\}", SOURCE, re.S)[1]
    env = dict(C=C, vec=vec, kApplyThreads=_const("kApplyThreads"))
    for name, expr in re.findall(r"const int (\w+) = ([^;]+);", body):
        env[name] = eval(expr.replace("/", "//"), {}, env)
    return env["cols"], env["lanes"], env["slots"]


def _apply_cover(geo, rows, L):
    """How often gn_apply's grid, as the kernel walks it, reaches each
    (row, vector) of a sample, and the most vectors one thread takes."""
    count = np.zeros((rows, L), dtype=np.int64)
    most = 0
    for chunk in range(geo.chunks):
        first = chunk * geo.rows_per_block
        end = min(rows, first + geo.rows_per_block)
        for col in range(geo.cols):
            for tid in range(geo.threads):
                vector = col * geo.lanes + tid % geo.lanes
                if vector >= L:
                    continue
                mine = range(first + tid // geo.lanes, end, geo.slots)
                count[mine.start:end:geo.slots, vector] += 1
                most = max(most, len(mine))
    return count, most


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_geometry_covers_every_vector_once_as_the_launcher_lays_it_out(
        dtype):
    """gn_apply (K4b) at chip_smoke.py's `SPLIT_SHAPES` and at every
    GroupNorm of the default model on a rank's half of the rows, B=32:
    the launcher's `apply_layout` (read from the source) puts the threads
    where `apply_geometry` says, the grid (chunks, cols, B) reaches every
    (row, vector) of a sample exactly once, no thread takes more than
    `vectors_per_thread` vectors, and each takes at least one full batch
    of loads where half the sample's rows allow, and no more passes than
    keep the grid within `_APPLY_BLOCKS` blocks."""
    from unet_tpu_torch.utils.ab_trees import shape_lists
    root = Path(port_gn.__file__).resolve().parents[3]
    split = [tuple(s) for s in shape_lists(str(root / "chip_smoke.py"))[
        "SPLIT_SHAPES"]]
    assert (32, 32, 64, 64) in split
    cases = set(split) | {(32, H // 2, W, C) for H, W, C in SHAPES}
    assert port_gn._APPLY_THREADS == _const("kApplyThreads")
    assert port_gn._APPLY_UNROLL == _const("kApplyUnroll")
    for B, H, W, C in sorted(cases):
        geo = port_gn.apply_geometry(B, H, W, C, dtype)
        vec = port_gn.vec_width(C, dtype.itemsize)
        what = (B, H, W, C, dtype, geo)
        assert (geo.cols, geo.lanes, geo.slots) == _source_apply_layout(
            C, vec), what
        assert geo.threads == geo.lanes * geo.slots <= 256, what
        rows, L = H * W, C // vec
        assert geo.chunks == -(-rows // geo.rows_per_block), what
        count, most = _apply_cover(geo, rows, L)
        assert (count == 1).all(), what
        assert most == geo.vectors_per_thread, what
        passes, per = -(-rows // geo.slots), geo.vectors_per_thread
        half = -(-passes // 2)  # two runs a sample at least
        assert geo.rows_per_block == per * geo.slots, what
        assert min(half, port_gn._APPLY_UNROLL) <= per <= half, what
        assert B * geo.cols * geo.chunks <= port_gn._APPLY_BLOCKS \
            or per == min(half, port_gn._APPLY_UNROLL) \
            or 2 * B * geo.cols > port_gn._APPLY_BLOCKS, what
        if per > port_gn._APPLY_UNROLL:
            assert B * geo.cols * -(-passes // (per - 1)) \
                > port_gn._APPLY_BLOCKS, what
    bf16 = port_gn.apply_geometry(32, 32, 64, 64, torch.bfloat16)
    f32 = port_gn.apply_geometry(32, 32, 64, 64, torch.float32)
    assert (bf16.vectors_per_thread, f32.vectors_per_thread) == (8, 16)
