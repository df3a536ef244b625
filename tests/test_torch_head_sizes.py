"""Head sizes other than the default model's 32: the attention kernels'
plain versions against the Pallas kernels from head size 7 to 514 (the
CUDA kernels take every head: tiles 16, 32 or 64 wide up to 64, chunks of
64 columns up to 256, clusters of blocks beyond), the port's head rule
against the JAX package's (refused exactly where the JAX package's
attention raises, on the CPU and on a CUDA device alike), the CLIs'
refusals before a model is built and their acceptance of heads wider than
256, and the whole model at head sizes that leave one head of 96, four of
24 or one of 288.

The Pallas kernels run in interpret mode (automatic off a TPU), as
tests/test_pallas.py runs them; the port's wrappers get CPU tensors and so
take their plain versions.  Tolerances are those of the existing attention
cases: tests/test_torch_kernels_plain.py for the forward (float32 2e-5;
bfloat16 1e-3 absolute plus one bfloat16 step relative) and
tests/test_torch_kernels_bwd.py for the backward (float32 3e-5 absolute and
1e-4 relative, bfloat16 3e-2 absolute); the whole model tests/test_model.py's
2e-3 (forward) and 1e-3 (gradients).
"""

import contextlib
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.cli import train as jax_train_cli
from unet_tpu.io import checkpoint as jax_ckpt
from unet_tpu.models import unet as jax_unet
from unet_tpu.ops import functional as jax_functional
from unet_tpu.ops.pallas import attention as jax_attn
from unet_tpu_torch.cli import generate
from unet_tpu_torch.cli import train as train_cli
from unet_tpu_torch.config import UnetConfig
from unet_tpu_torch.data.dataset import write_bin
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.models import unet as port_unet
from unet_tpu_torch.ops.kernels import attention as port_attn

from tests.torch_port_util import TINY, both_models, configs, j2n, t2n

FWD_TOL = {"float32": dict(atol=2e-5),
           "bfloat16": dict(atol=1e-3, rtol=2.0 ** -7)}
BWD_TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
           "bfloat16": dict(atol=3e-2, rtol=0.0)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTENTION_CU = (Path(__file__).resolve().parents[1] / "unet_tpu_torch"
                / "csrc" / "attention.cu")

# (B, T, C, NH): head sizes 16 and 64, the tiles' widths; then T = 72,
# which leaves a ragged 64-row tile, at 12 (an odd number of 8-byte pieces
# in bfloat16), 40 (a 64-wide tile), and 72, 128, 192, 256 (chunked: 2, 2,
# 3 and 4 chunks of 64 columns), then 288, 512 and 514 (clusters of 5, 8
# and 5 blocks; 514 in two groups of clusters, bfloat16 in 4-byte pieces).
SHAPES = [pytest.param(2, 64, 64, 4, id="HS16"),
          pytest.param(2, 64, 128, 2, id="HS64"),
          pytest.param(1, 72, 128, 8, id="HS16-T72"),
          pytest.param(1, 72, 192, 3, id="HS64-T72"),
          pytest.param(1, 72, 36, 3, id="HS12-T72"),
          pytest.param(1, 72, 80, 2, id="HS40-T72"),
          pytest.param(1, 72, 144, 2, id="HS72-T72"),
          pytest.param(1, 72, 128, 1, id="HS128-T72"),
          pytest.param(1, 72, 192, 1, id="HS192-T72"),
          pytest.param(1, 72, 256, 1, id="HS256-T72"),
          pytest.param(1, 72, 288, 1, id="HS288-T72"),
          pytest.param(1, 72, 512, 1, id="HS512-T72"),
          pytest.param(1, 72, 1542, 3, id="HS514-T72")]


@pytest.mark.parametrize("B,T,C,NH", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_fwd_vs_pallas_at_other_head_sizes(B, T, C, NH, dtype):
    qkv = np.random.default_rng(C + NH).standard_normal((B, T, 3 * C),
                                                        dtype=np.float32)
    got = port_attn.qkv_attention_fwd(torch.from_numpy(qkv).to(TDT[dtype]),
                                      NH)
    want = jax_attn.qkv_attention_fused(jnp.asarray(qkv).astype(JDT[dtype]),
                                        NH)
    assert got.dtype == TDT[dtype] and got.shape == (B, T, C)
    np.testing.assert_allclose(t2n(got), j2n(want), **FWD_TOL[dtype])


@pytest.mark.parametrize("B,T,C,NH", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_vs_pallas_at_other_head_sizes(B, T, C, NH, dtype):
    rng = np.random.default_rng(T + C)
    qkv = rng.standard_normal((B, T, 3 * C), dtype=np.float32)
    dout = rng.standard_normal((B, T, C), dtype=np.float32)
    want = jax_attn._bwd_call(jnp.asarray(qkv).astype(JDT[dtype]),
                              jnp.asarray(dout).astype(JDT[dtype]), NH)
    got = port_attn.qkv_attention_bwd(torch.from_numpy(qkv).to(TDT[dtype]),
                                      torch.from_numpy(dout).to(TDT[dtype]),
                                      NH)
    assert got.dtype == TDT[dtype] and got.shape == qkv.shape
    np.testing.assert_allclose(t2n(got), j2n(want), **BWD_TOL[dtype])


def test_head_sizes_are_the_sources_instantiations():
    """The wrapper's HEAD_SIZES are the tile widths of the launchers'
    dispatch in csrc/attention.cu, each instantiating the kernels at its
    own width, its CHUNK and MAX_CHUNKS the chunked kernels' and its
    MAX_CLUSTER the cluster kernels' (csrc/attention.cuh), and the
    launchers send a head wider than CHUNK * MAX_CHUNKS to the cluster
    kernels (csrc/attention_wide.cu), whose `wide_layout` is the rule
    `kernel_layout` mirrors, at its BLOCK_CHUNKS and MIN_BLOCKS."""
    src = ATTENTION_CU.read_text()
    shared = ATTENTION_CU.with_suffix(".cuh").read_text()
    cases = re.findall(r"if \(hs <= (\d+)\) return f\(std::integral_constant"
                       r"<int, (\d+)>\(\)\);", src)
    assert cases and all(a == b for a, b in cases)
    assert tuple(int(a) for a, _ in cases) == port_attn.HEAD_SIZES
    assert all(hs % 16 == 0 for hs in port_attn.HEAD_SIZES)  # mma k-steps
    chunk = int(re.search(r"constexpr int CH = (\d+);", shared).group(1))
    chunks = int(re.search(r"constexpr int MAX_CHUNKS = (\d+);",
                           shared).group(1))
    narrow = int(re.search(r"constexpr int NARROW_MAX = (\d+);",
                           shared).group(1))
    cluster = int(re.search(r"constexpr int MAX_CLUSTER = (\d+);",
                            shared).group(1))
    assert chunk == port_attn.CHUNK and narrow == max(port_attn.HEAD_SIZES)
    assert chunks == port_attn.MAX_CHUNKS and cluster == port_attn.MAX_CLUSTER
    assert cluster <= 8  # the portable cluster size: no attribute asked
    assert src.count("if (hs > CH * MAX_CHUNKS)") == 2
    assert "return attention_fwd_wide(" in src
    assert "return attention_bwd_wide(" in src
    wide = ATTENTION_CU.with_name("attention_wide.cu").read_text()
    layout = wide[wide.index("inline WideLayout wide_layout("):]
    layout = layout[:layout.index("\n}\n")]
    for line in ("for (int c = most; c > 1; c /= 2) {",
                 "const int n = (nd + c - 1) / c;",
                 "if (n <= MAX_CLUSTER && row_tiles * n >= min_blocks) "
                 "return {n, 1, (nd + n - 1) / n};",
                 "const int n = nd < MAX_CLUSTER ? nd : MAX_CLUSTER;",
                 "return {n, (nd + n - 1) / n, 1};"):
        assert line in layout, line
    most = re.search(r"constexpr int MOST_CHUNKS = sizeof\(E\) == 2 \? (\d+) : "
                     r"(\d+);", wide).groups()
    assert tuple(map(int, most)) == (port_attn.BLOCK_CHUNKS[torch.bfloat16],
                                     port_attn.BLOCK_CHUNKS[torch.float32])
    assert int(re.search(r"constexpr int MIN_BLOCKS = (\d+);",
                         wide).group(1)) == port_attn.MIN_BLOCKS


@pytest.mark.parametrize("head_size, dtype, layout, fwd, bwd", [
    (8, "bfloat16", ("tile", 16), 2.0, 2.0),
    (32, "bfloat16", ("tile", 32), 1.0, 1.0),
    (40, "bfloat16", ("tile", 64), 1.6, 1.6),
    (64, "float32", ("tile", 64), 1.0, 1.0),
    (12, "float32", ("tile", 16), 16 / 12, 16 / 12),
    (12, "bfloat16", ("chunked", 1), 16 / 12, 16 / 12),
    (7, "float32", ("chunked", 1), 8 / 7, 8 / 7),
    (72, "bfloat16", ("chunked", 2), 80 / 72, 80 / 72),
    (72, "float32", ("chunked", 2), 1.0, 1.0),
    (96, "bfloat16", ("chunked", 2), 1.0, 1.0),
    (192, "bfloat16", ("chunked", 3), 1.0, 1.0),
    (256, "float32", ("chunked", 4), 1.0, 1.0),
    (257, "bfloat16", ("cluster", 2, 1, 3), 272 / 257, 272 / 257),
    (288, "float32", ("cluster", 3, 1, 2), 1.0, 1.0),
    (288, "bfloat16", ("cluster", 2, 1, 3), 1.0, 1.0),
    (512, "float32", ("cluster", 4, 1, 2), 1.0, 1.0),
    (512, "bfloat16", ("cluster", 2, 1, 4), 1.0, 1.0),
    (2048, "float32", ("cluster", 8, 4, 1), 2.5, 3.0),
    (2048, "bfloat16", ("cluster", 8, 1, 4), 1.0, 1.0),
    (4160, "float32", ("cluster", 8, 9, 1), 5.0, 57 / 9),
    (4160, "bfloat16", ("cluster", 8, 9, 1), 5.0, 57 / 9)])
def test_kernel_layout_and_work_ratio(head_size, dtype, layout, fwd, bwd):
    """A tile pads the head to its width and takes rows of a multiple of
    16 bytes; the chunked kernels take the rest up to 256, the groups of a
    block sharing a tile's scores, so each product is done once over the
    head rounded up to the k-step chunk by chunk (HS 72 in bfloat16: 64 +
    16 columns deep and wide for 72; HS 12: one k-step of 16); a wider head
    takes clusters of blocks of up to 4 chunks (bfloat16) or 2 (float32),
    spread as evenly as the blocks allow (HS 288 in bfloat16: 3 + 2), that
    share its scores, once for up to 8 blocks' worth (2048 columns in
    bfloat16: nothing wasted), beyond that at one chunk a block in `per`
    groups of clusters that each recompute them (HS 4160, 65 chunks: 9
    groups of 8 blocks, the scores 9 times: 10 / 2 forward, 57 / 9
    backward; float32 at 2048: 4 groups; HS 257 in bfloat16: 256 + one
    k-step of 16 deep).  These are the layouts of a launch of at least
    MIN_BLOCKS blocks at any chunks a block (`row_tiles` None)."""
    assert port_attn.kernel_layout(head_size, TDT[dtype]) == layout
    assert port_attn.work_ratio(head_size, TDT[dtype],
                                False) == pytest.approx(fwd)
    assert port_attn.work_ratio(head_size, TDT[dtype],
                                True) == pytest.approx(bwd)


@pytest.mark.parametrize("B, T, dtype, layout", [
    (1, 64, "bfloat16", (8, 1, 1)), (2, 100, "bfloat16", (8, 1, 1)),
    (8, 64, "bfloat16", (8, 1, 1)), (8, 256, "bfloat16", (2, 1, 4)),
    (64, 64, "bfloat16", (2, 1, 4)), (64, 256, "bfloat16", (2, 1, 4)),
    (1, 64, "float32", (8, 1, 1)), (2, 100, "float32", (8, 1, 1)),
    (8, 64, "float32", (4, 1, 2)), (8, 256, "float32", (4, 1, 2)),
    (64, 64, "float32", (4, 1, 2)), (64, 256, "float32", (4, 1, 2))])
def test_cluster_layout_at_every_launch(B, T, dtype, layout):
    """The grid-size rule at DDPM 256 x 256's one head of 512 (8 chunks):
    a block takes the most of 4 (bfloat16) or 2 (float32) chunks, then 2,
    that leaves the launch MIN_BLOCKS blocks (B * ceil(T / rows) tiles of
    rows, 64 rows a tile in bfloat16 and 32 in float32, times n), else one;
    whatever it takes, one group of clusters holds the head, so each score
    is computed once: work_ratio 1.0 in both directions.  At 2048 columns
    (32 chunks) a block of 4 chunks (bfloat16, a large launch) does the
    same; fewer chunks a block take groups of clusters that recompute."""
    dt = TDT[dtype]
    tiles = port_attn.row_tiles(B, T, 1, dt)
    assert port_attn.kernel_layout(512, dt, tiles) == ("cluster", *layout)
    n, _, chunks = layout
    assert chunks == 1 or tiles * n >= port_attn.MIN_BLOCKS
    for backward in (False, True):
        assert port_attn.work_ratio(512, dt, backward,
                                    tiles) == pytest.approx(1.0)
    wide = port_attn.kernel_layout(2048, dt, tiles)
    ratio = port_attn.work_ratio(2048, dt, False, tiles)
    assert (ratio == pytest.approx(1.0)) == (wide == ("cluster", 8, 1, 4))


CHUNKED_CU = ATTENTION_CU.with_name("attention_chunked.cu")
SMEM_LIMIT = 232_448  # dynamic shared memory a block may have on an H100


def chunked_constants():
    """The chunked and cluster kernels' block geometry as csrc/attention.cuh
    declares it: {type: (ROWS, KEYS, DKV_THREADS)} and {name: value} of CH,
    STAGES, ALIGN and SMEM_LIMIT."""
    shared = ATTENTION_CU.with_suffix(".cuh").read_text()
    geo = {t: tuple(int(v) for v in m) for t, *m in re.findall(
        r"template <> struct Geo<(\w+)> \{\s*static constexpr int "
        r"ROWS = (\d+), KEYS = (\d+), DKV_THREADS = (\d+);", shared)}
    consts = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                  shared).group(1))
              for name in ("CH", "STAGES", "ALIGN", "SMEM_LIMIT")}
    return geo, consts


def chunked_smem(item, rows, keys, nd, groups, sides, stats, stages, align,
                 chunk):
    """`chunked_smem_bytes`: sides x (nd own tiles + a partial a group) +
    2 rings x stages x nd stage tiles + the alignment slack, and the dk/dv
    kernel's stages x 3 x keys floats of statistics (the forward's 2 x rows
    floats of row corrections and 1 / l)."""
    own, stage, part = rows * chunk * item, keys * chunk * item, rows * keys * 4
    rows_floats = stages * 3 * keys if stats else 2 * rows if sides == 1 else 0
    return (align + sides * (nd * own + groups * part)
            + 2 * stages * nd * stage + rows_floats * 4)


@pytest.mark.parametrize("kernel", ["fwd", "bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_kernels_fit_in_shared_memory(dtype, kernel):
    """Each chunked kernel's dynamic shared memory at 1 to 4 chunks, from
    the source's own constants by the source's formula: nd groups of warps
    (the dk/dv kernel fewer, of several chunks each, where nd groups would
    pass DKV_THREADS: `dkv_chunks`) and a ring of at least two stages;
    tiles start on the swizzle's period; the wrapper's rows a block are the
    source's."""
    geo, c = chunked_constants()
    assert set(geo) == {"bf16", "float"} and c["SMEM_LIMIT"] == SMEM_LIMIT
    rows, keys, dkv_threads = geo["bf16" if dtype == "bfloat16" else "float"]
    assert port_attn.CHUNKED_ROWS[TDT[dtype]] == rows
    assert rows % 16 == 0 and keys % 16 == 0  # warps of 16 rows; k-steps
    item = 2 if dtype == "bfloat16" else 4
    assert (rows * c["CH"] * item) % c["ALIGN"] == 0
    assert (keys * c["CH"] * item) % c["ALIGN"] == 0
    sides, stats = (1, False) if kernel == "fwd" else (2, kernel == "bwd_dkv")
    group_threads = rows // 16 * 32
    for nd in range(1, port_attn.MAX_CHUNKS + 1):
        groups = nd
        if kernel == "bwd_dkv":
            per = -(-nd * group_threads // dkv_threads)
            groups = -(-nd // per)
            assert groups * group_threads <= dkv_threads

        nbytes = chunked_smem(item, rows, keys, nd, groups, sides, stats,
                              c["STAGES"], c["ALIGN"], c["CH"])
        assert nbytes <= SMEM_LIMIT, (dtype, kernel, nd, nbytes)
    assert c["STAGES"] >= 2
    assert f"{nbytes:,}" in CHUNKED_CU.read_text()  # the note, nd = 4


WIDE_CU = ATTENTION_CU.with_name("attention_wide.cu")


def wide_smem(item, rows, keys, nd, sides, streamed, stats, ring, align,
              chunk):
    """`wide_smem_bytes`: the staged own tiles (sides x nd, ROWS x 64) +
    ring slots of 2 x nd stage tiles (KEYS x 64) and, streamed, the own
    tiles + sides x 3 partials of ROWS x KEYS floats (mine[2] and sum) + the
    dk/dv kernel's ring x 3 x keys floats of m, 1 / l and D + the
    alignment slack."""
    own, stage, part = rows * chunk * item, keys * chunk * item, rows * keys * 4
    return (align + (0 if streamed else sides * nd * own)
            + ring * (2 * nd * stage + (sides * nd * own if streamed else 0))
            + 3 * sides * part + (ring * 3 * keys * 4 if stats else 0))


@pytest.mark.parametrize("kernel", ["fwd", "bwd_dq", "bwd_dkv"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cluster_kernels_fit_in_shared_memory(dtype, kernel):
    """Each cluster kernel's dynamic shared memory at every chunk count a
    block may hold (1 to MOST_CHUNKS; at one chunk also with the own rows
    streamed through the ring, as heads past one cluster take them), from
    the sources' constants by the source's formula: a ring of at least
    three items (one in the score products, one waiting for its output
    products, one in flight), every tile and partial on the swizzle's
    period; the opening note's figures are the largest."""
    geo, c = chunked_constants()
    wide = WIDE_CU.read_text()
    ring = int(re.search(r"constexpr int RING = (\d+);", wide).group(1))
    most = dict(zip(("bfloat16", "float32"), map(int, re.search(
        r"constexpr int MOST_CHUNKS = sizeof\(E\) == 2 \? (\d+) : (\d+);",
        wide).groups())))[dtype]
    assert most == port_attn.BLOCK_CHUNKS[TDT[dtype]] and ring >= 3
    rows, keys, _ = geo["bf16" if dtype == "bfloat16" else "float"]
    item = 2 if dtype == "bfloat16" else 4
    for tile in (rows * c["CH"] * item, keys * c["CH"] * item, rows * keys * 4):
        assert tile % c["ALIGN"] == 0
    sides, stats = (1, False) if kernel == "fwd" else (2, kernel == "bwd_dkv")
    for nd in range(1, most + 1):
        for streamed in (False, True) if nd == 1 else (False,):
            nbytes = wide_smem(item, rows, keys, nd, sides, streamed, stats,
                               ring, c["ALIGN"], c["CH"])
            assert nbytes <= SMEM_LIMIT, (dtype, kernel, nd, streamed, nbytes)
    nbytes = wide_smem(item, rows, keys, most, sides, False, stats, ring,
                       c["ALIGN"], c["CH"])
    assert f"{nbytes:,}" in wide  # the note, at the most chunks a block


# DDPM's 256 x 256 models (Ho et al. 2020: CelebA-HQ, LSUN; ch 128, ch_mult
# (1, 1, 2, 2, 4, 4), two res blocks a level, attention at 16 x 16) in the
# CLIs' flags: one head of 512 in each of its six attention layers.
DDPM256_FLAGS = ["--image_size", "256", "--num_channels", "128",
                 "--channel_mult", "1,1,2,2,4,4", "--num_res_blocks", "2",
                 "--attention_resolutions", "16", "--num_head_channels",
                 "512"]


def test_ddpm256_flags_give_one_model_in_both_clis(no_model_built):
    """Both packages' training CLIs read DDPM 256 x 256's flags into the same
    config fields, the same parameter order and the same attention widths
    (six layers of one head of 512: the cluster kernels), with no model
    built; at the paper's batch of 64 a block of the cluster takes four
    chunks in bfloat16 (two blocks a cluster) and the scores are computed
    once."""
    jcfg = jax_train_cli.model_config_from_args(
        jax_train_cli.create_argparser().parse_args(DDPM256_FLAGS))
    cfg = train_cli.model_config_from_args(
        train_cli.create_argparser().parse_args(DDPM256_FLAGS))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert jax_unet.param_order(jcfg) == port_unet.param_order(cfg)
    plan = jax_unet.build_plan(jcfg)
    jax_widths = [layer[1] for group in plan.input_blocks + (plan.middle,)
                  + plan.output_blocks for layer in group
                  if layer[0] == "attn"]
    assert port_unet.attention_widths(cfg) == jax_widths == [512] * 6
    assert port_attn.head_size_fault(jax_widths, 512) is None
    tiles = port_attn.row_tiles(64, 256, 1, torch.bfloat16)
    assert port_attn.kernel_layout(512, torch.bfloat16, tiles) == (
        "cluster", 2, 1, 4)
    assert port_attn.work_ratio(512, torch.bfloat16, True, tiles) == 1.0
    assert port_ckpt.num_params(cfg) == 103_790_723


@pytest.mark.parametrize("widths, head_size, fault", [
    ([192, 192, 256], 32, None), ([192, 256], 64, None),
    ([64], 16, None), ([96], 64, None),      # one head of 96
    ([192, 256], 128, None),  # one head of 192, two of 128
    ([288], 64, None),        # four heads of 72
    ([192, 256], 48, "do not split"),  # 256 // 48 = 5 heads
    ([256], 48, "do not split"),
    ([32], 64, "no head"), ([64], 128, "no head"),
    ([288, 384], 288, None),  # heads of 288 and 384
    ([512] * 6, 512, None),   # DDPM's 256 x 256 models: one head of 512
    ([64], 0, "not positive")])
def test_head_size_fault(widths, head_size, fault):
    """The same rule for the CPU and a CUDA device: the kernels take every
    head the JAX package runs."""
    got = port_attn.head_size_fault(widths, head_size)
    assert (got is None) if fault is None else (fault in got)


@pytest.mark.parametrize("width", [32, 64, 96, 192, 256, 288])
def test_head_rule_is_the_jax_packages(width):
    """On the CPU the port refuses exactly the head sizes at which the JAX
    package's attention raises (its einsum route: no head divides by zero,
    heads that do not split the width fail the reshape), with the JAX
    model's own head count, width // head_size."""
    for head_size in (1, 7, 24, 40, 48, 64, 72, 128, 192, 288, 400):
        qkv = jnp.zeros((1, 2, 3 * width), jnp.float32)
        try:
            jax_functional.qkv_attention(qkv, width // head_size)
            raised = False
        except (ZeroDivisionError, TypeError, ValueError):
            raised = True
        fault = port_attn.head_size_fault([width], head_size)
        assert raised == (fault is not None), (width, head_size, fault)


def test_attention_widths_of_the_default_model():
    widths = port_unet.attention_widths(UnetConfig())
    assert len(widths) == 11 and set(widths) == {192, 256}


class FakeCuda:
    """A CUDA tensor's attributes, for `_check_cuda` on a CPU-only
    machine (the device check comes first)."""

    device = torch.device("cuda")
    dtype = torch.bfloat16

    def __init__(self, shape):
        self.shape = shape

    def is_contiguous(self):
        return True


def test_cuda_wrapper_refuses_an_uncompiled_head_size():
    """Every head reaches the kernels, a head of 288 (width 288, one head)
    among them; what is refused before any CUDA call is a launch past the
    grid's limits: 14,000 heads of 2112 columns (33 chunks: more than a
    cluster of 8 blocks of 4 chunks holds, so 5 groups of clusters of one
    chunk a block) want 70,000 > 65,535 blocks on grid.y."""
    for C, NH in ((288, 4), (96, 2), (21, 3), (256, 1), (7, 7), (2048, 8),
                  (288, 1), (4160, 1)):
        port_attn._check_cuda(FakeCuda((2, 8, 3 * C)), NH)
    with pytest.raises(ValueError, match="does not take"):
        port_attn._check_cuda(FakeCuda((2, 8, 3 * 2112 * 14000)), 14000)


def _train_flags(tmp_path, head_size, device, channels=96, mult="1,2"):
    """Attention at 8x8 of 16x16 images, on the second level: width 192 at
    96 channels and mult 1,2 (four heads of 48)."""
    return ["--data_file", str(tmp_path / "data.bin"), "--device", device,
            "--num_channels", str(channels),
            "--num_head_channels", str(head_size),
            "--image_size", "16", "--channel_mult", mult,
            "--num_res_blocks", "1", "--attention_resolutions", "8",
            "--batch_size", "2", "--iterations", "1", "--log_interval", "1",
            "--save_interval", "1", "--output_dir", str(tmp_path / "m"),
            "--log_file", str(tmp_path / "log.txt")]


@contextlib.contextmanager
def no_weights_read():
    """Within the block, building a model or loading a checkpoint's weights
    fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a model was built")
    saved = port_unet.init, port_ckpt.load
    port_unet.init = port_ckpt.load = refuse
    try:
        yield
    finally:
        port_unet.init, port_ckpt.load = saved


@pytest.fixture
def no_model_built():
    """Fails the test if a model is built or a checkpoint's weights load."""
    with no_weights_read():
        yield


@pytest.mark.parametrize("head_size, channels, mult, fault", [
    (48, 128, "1,2", "do not split"), (288, 96, "1,3", None)])
def test_train_refuses_a_head_size_on_cuda_before_any_work(
        tmp_path, head_size, channels, mult, fault, no_model_built):
    """48 at the attention width 256 of --num_channels 128 gives five heads,
    which do not split it (the JAX package cannot run it either): refused,
    no data file needed.  288 at width 288 is one head of 288, which the
    kernels take: the run goes on to build its model."""
    flags = _train_flags(tmp_path, head_size, "cuda", channels, mult)
    if fault is not None:
        with pytest.raises(SystemExit, match=fault):
            train_cli.main(flags)
        return
    write_bin(str(tmp_path / "data.bin"), np.zeros((2, 3, 16, 16),
                                                   np.float32))
    with pytest.raises(AssertionError, match="a model was built"):
        train_cli.main(flags)


def test_train_refuses_on_the_cpu_what_the_jax_package_cannot_run(
        tmp_path, no_model_built):
    with pytest.raises(SystemExit, match="do not split"):
        train_cli.main(_train_flags(tmp_path, 48, "cpu", 128))


def test_train_takes_head_size_48_on_the_cpu(tmp_path):
    write_bin(str(tmp_path / "data.bin"), np.random.default_rng(0).uniform(
        -1, 1, (2, 3, 16, 16)).astype(np.float32))
    state = train_cli.main(_train_flags(tmp_path, 48, "cpu"))
    assert state.step == 1
    assert port_ckpt.read_config(
        str(tmp_path / "m" / "model_1.bin")).num_head_channels == 48


@pytest.fixture
def hs48_file(tmp_path):
    cfg = UnetConfig(**{**TINY, "model_channels": 96,
                        "num_head_channels": 48})
    model = port_unet.init(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    path = str(tmp_path / "hs48.bin")
    port_ckpt.save(path, port_ckpt.Checkpoint(params=model, cfg=cfg,
                                              batch_size=2))
    return path


@pytest.mark.parametrize("channels, mult, head_size, fault", [
    (128, (1, 2), 48, "do not split"), (96, (1, 3), 288, None)])
def test_generate_refuses_head_size_48_on_cuda_before_loading(
        tmp_path, channels, mult, head_size, fault, capsys):
    """Width 256 at 48 (five heads, which do not split it), read from the
    checkpoint's header, is refused before any weights load; width 288 at
    288 (one head, which the kernels take) goes on to load them."""
    cfg = UnetConfig(**{**TINY, "model_channels": channels,
                        "channel_mult": mult, "num_head_channels": head_size})
    path = str(tmp_path / "m.bin")
    port_ckpt.save(path, port_ckpt.Checkpoint(
        params=port_unet.init(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu"), cfg=cfg, batch_size=2))
    args = generate.parse_args(["--model_filename", path, "--device",
                                "cuda", "--sampler", "ddim"])
    if fault is None:
        with no_weights_read():
            with pytest.raises(AssertionError, match="a model was built"):
                generate.run(args)
        return
    with no_weights_read():
        with pytest.raises(SystemExit) as e:
            generate.run(args)
    assert e.value.code == 2 and fault in capsys.readouterr().err


def test_generate_takes_head_size_48_on_the_cpu(hs48_file):
    images = generate.run(generate.parse_args(
        ["--model_filename", hs48_file, "--device", "cpu", "--sampler",
         "ddim", "--ddim_steps", "2", "--batch_size", "2"]))
    assert images.dtype == np.uint8 and images.shape == (2, 16, 16, 3)


def test_read_config_is_the_header_load_reads(hs48_file):
    cfg = port_ckpt.read_config(hs48_file)
    assert cfg == port_ckpt.load(hs48_file, device="cpu").cfg
    assert cfg.num_head_channels == 48 and cfg.model_channels == 96


@pytest.mark.parametrize("mult, head_size, widths", [
    pytest.param((1, 3), 64, {96}, id="64"),
    pytest.param((1, 3), 24, {96}, id="24"),
    pytest.param((1, 8), 256, {256}, id="256")])
def test_whole_model_at_other_head_sizes(mult, head_size, widths):
    """TINY at channel_mult (1, 3): attention at width 96 (every GroupNorm
    width a multiple of 32), one head of 96 at 64 channels a head, four of
    24 at 24; at (1, 8) one head across each attention layer's width 256,
    as DDPM's CIFAR-10 model has (the chunked kernels' four chunks on a
    CUDA device).  The port's forward and the gradients of a squared error
    on the CPU against the JAX package's, at tests/test_model.py's bars."""
    jcfg, cfg = configs(channel_mult=mult, num_head_channels=head_size)
    assert set(port_unet.attention_widths(cfg)) == widths
    params, model, _ = both_models(jcfg, cfg, seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    t = np.array([11.0, 700.0], np.float32)
    target = rng.standard_normal(x.shape, dtype=np.float32)

    def jloss(p):
        out = jax_unet.apply(p, jcfg, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean(jnp.square(out - jnp.asarray(target))), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    out = port_unet.apply(model, torch.from_numpy(x), torch.from_numpy(t))
    loss = (out - torch.from_numpy(target)).square().mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(t2n(out.detach()), j2n(jout), atol=2e-3)
    np.testing.assert_allclose(port_ckpt.flatten_tensors(grads),
                               jax_ckpt.flatten_params(jgrads, jcfg),
                               atol=1e-3)


# DDPM's CIFAR-10 model (Ho et al. 2020, diffusion_tf `unet.py`: ch 128,
# ch_mult (1, 2, 2, 2), two res blocks a level, attention at 16 x 16) in
# the CLIs' flags: one head of 256 in each of its six attention layers.
DDPM_CIFAR10_FLAGS = ["--image_size", "32", "--num_channels", "128",
                      "--channel_mult", "1,2,2,2", "--attention_resolutions",
                      "16", "--num_head_channels", "256"]


def test_ddpm_cifar10_flags_give_one_model_in_both_clis(no_model_built):
    """Both packages' training CLIs read DDPM CIFAR-10's flags into the same
    config fields, the same parameter order and the same attention widths
    (six layers of one head of 256: the chunked kernels in four chunks),
    with no model built."""
    jcfg = jax_train_cli.model_config_from_args(
        jax_train_cli.create_argparser().parse_args(DDPM_CIFAR10_FLAGS))
    cfg = train_cli.model_config_from_args(
        train_cli.create_argparser().parse_args(DDPM_CIFAR10_FLAGS))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert jax_unet.param_order(jcfg) == port_unet.param_order(cfg)
    plan = jax_unet.build_plan(jcfg)
    jax_widths = [layer[1] for group in plan.input_blocks + (plan.middle,)
                  + plan.output_blocks for layer in group
                  if layer[0] == "attn"]
    assert port_unet.attention_widths(cfg) == jax_widths == [256] * 6
    assert port_attn.head_size_fault(jax_widths, 256) is None
    for dtype in (torch.float32, torch.bfloat16):
        assert port_attn.kernel_layout(256, dtype) == ("chunked", 4)
    assert port_ckpt.num_params(cfg) == 32_648_323


def test_whole_model_at_a_head_wider_than_256():
    """TINY at channel_mult (1, 9): attention at width 288 (9 channels a
    group) in an input, the middle and two output blocks, one head of 288
    at 288 channels a head (the cluster kernels on a CUDA device).  The
    port's forward and the gradients of a squared error on the CPU against
    the JAX package's, at tests/test_model.py's bars."""
    jcfg, cfg = configs(channel_mult=(1, 9), num_head_channels=288)
    assert port_unet.attention_widths(cfg) == [288] * 4
    assert port_attn.kernel_layout(288, torch.float32) == ("cluster", 3, 1, 2)
    params, model, _ = both_models(jcfg, cfg, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    t = np.array([5.0, 900.0], np.float32)
    target = rng.standard_normal(x.shape, dtype=np.float32)

    def jloss(p):
        out = jax_unet.apply(p, jcfg, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean(jnp.square(out - jnp.asarray(target))), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    out = port_unet.apply(model, torch.from_numpy(x), torch.from_numpy(t))
    loss = (out - torch.from_numpy(target)).square().mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(t2n(out.detach()), j2n(jout), atol=2e-3)
    np.testing.assert_allclose(port_ckpt.flatten_tensors(grads),
                               jax_ckpt.flatten_params(jgrads, jcfg),
                               atol=1e-3)
