"""GroupNorm(+SiLU), forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd Function that joins the two.

Counterpart of unet_tpu/ops/pallas/groupnorm.py.  `gn_act_fwd` replaces the
Pallas forward kernel there (`_fwd_kernel`, launched by `_fwd_call`, reached
through `group_norm_act`) and `gn_act_bwd` the backward kernel
(`_bwd_kernel`, launched by `_bwd_call`, reached through `_gn_bwd`), both
with csrc/groupnorm.cu; `GroupNormAct` is the counterpart of the
`custom_vjp` `group_norm_act`.

What bounds it on an H100 is memory traffic: the forward must read x and
write y once, `2 * B*H*W*C * itemsize` bytes, against a few operations per
element; the backward reads x and dy and writes dx once.  The design keeps
the TPU kernel's idea, one batch element's slab in fast memory: one
thread-block cluster (up to 16 blocks, each able to read the others' shared
memory) per batch element, each block copying its contiguous run of rows
into shared memory where it fits, so every pass after the first reads
shared memory (and streaming it through a ring of tiles there where it
does not), and the blocks combining their statistics through the
cluster's shared memory in rank order, all in one launch.  `geometry`
chooses the cluster, the rows a block and how they are staged.  See the
source for details.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from unet_tpu_torch.ops.kernels import _build

# What csrc/groupnorm.cu takes: at most 16 blocks a cluster, at most 512
# threads a block, 256 in the backward at 8 values a thread (aiming at 256;
# where a row has more vectors than that, a thread takes several), a ring
# of 4 tiles of rows in shared memory.  An H100 has 132 SMs in 8
# GPCs and lets a block use 227 KB of shared memory; of that, at most
# 200 KB hold staged rows, and at most 100 KB leave room for a second block
# on the SM (which the float32 backward, measured in utils/ab_trees.py's
# runs, does better without).  A cluster runs within one GPC, and not every
# GPC has 16 SMs enabled: at most 7 clusters of 16 one-block-an-SM blocks
# run at once.  A block is not cut below 8 rows to fill the card, and a
# staged tile is at least 8 KB (the ring's set-up costs more than a small
# tile saves).
_MAX_CLUSTER = 16
_MAX_THREADS = 512
_MAX_THREADS_BWD8 = 256
_TARGET_THREADS = 256
_SLOTS = 4
_TILE_BYTES = 48 * 1024  # a streamed tile (x and dy together)
_SMS = 132
_SMEM_LIMIT = 227 * 1024
_STAGE_LIMIT = 200 * 1024
_SHARE_LIMIT = 100 * 1024
_CLUSTERS_OF_16 = 7
_MIN_TILE_BYTES = 8 * 1024
_MIN_ROWS = 8
# `split_geometry`: gn_stats' least staged tile; the rows of x and dy a
# block of gn_bwd_sums takes in one copy, and the tiles it streams larger
# ones in.
_STATS_TILE_BYTES = 32 * 1024
_SUMS_BLOCK_BYTES = 64 * 1024
_SUMS_TILE_BYTES = 16 * 1024


def gn_act_fwd_plain(x, gamma, beta, num_groups=32, eps=1e-5, act="silu"):
    """Plain PyTorch GroupNorm + optional SiLU on an NHWC tensor, with the
    kernel's arithmetic: statistics and the affine map in float32 (float64
    for float64 input), two-pass variance, one rounding to x's type at the
    end.  Returns (y, mean, rstd) with mean, rstd of shape (B, G)."""
    B, H, W, C = x.shape
    G = num_groups
    stat_dt = torch.promote_types(x.dtype, torch.float32)
    xg = x.reshape(B, H * W, G, C // G).to(stat_dt)
    mean = xg.mean(dim=(1, 3))
    xc = xg - mean[:, None, :, None]
    var = xc.square().mean(dim=(1, 3))
    rstd = torch.rsqrt(var + eps)
    return _normalize(x, xc, gamma, beta, rstd, act), mean, rstd


def _normalize(x, xc, gamma, beta, rstd, act):
    """y in x's type from x - mean by group (B, H*W, G, C/G) and rstd."""
    stat_dt = xc.dtype
    z = (xc * rstd[:, None, :, None]).reshape(x.shape)
    z = z * gamma.to(stat_dt) + beta.to(stat_dt)
    if act == "silu":
        z = z * torch.sigmoid(z)
    return z.to(x.dtype)


class Geometry(NamedTuple):
    """How a call is cut for the kernel: one cluster of `cluster` blocks per
    batch element, `rows_per_block` of its H*W rows a block (the last block
    may have fewer, none has none), `threads` a block.  `staged`: each
    block copies its rows (of x, and of dy in the backward) into shared
    memory once, and they stay there; `streamed`: they do not fit, so every
    pass streams them through a ring of 4 tiles of `tile_rows` rows in
    shared memory; neither: every pass reads device memory.  `smem_bytes`:
    the dynamic shared memory of a block."""
    cluster: int
    rows_per_block: int
    tile_rows: int
    staged: bool
    streamed: bool
    smem_bytes: int
    threads: int


def vec_width(C: int, itemsize: int) -> int:
    """Channels a thread moves at once: the widest power of two that divides
    C in at most 16 bytes."""
    vec = 1
    while 2 * vec * itemsize <= 16 and C % (2 * vec) == 0:
        vec *= 2
    return vec


def max_threads(backward: bool, vec: int) -> int:
    """The most threads a block may have."""
    return _MAX_THREADS_BWD8 if backward and vec >= 8 else _MAX_THREADS


def block_threads(backward: bool, C: int, vec: int) -> int:
    """C / vec threads cover a row; a block holds as many whole rows as fit
    in `_TARGET_THREADS` (at least one).  Where a row has more vectors than
    the block's cap, each thread takes J of them, in ceil(C / vec / J)
    threads."""
    per_row = C // vec
    if per_row < _TARGET_THREADS:
        return _TARGET_THREADS // per_row * per_row
    J = -(-per_row // max_threads(backward, vec))
    return -(-per_row // J)


def smem_bytes(backward: bool, cluster: int, rows_per_block: int,
               tile_rows: int, C: int, G: int, vec: int,
               itemsize: int) -> int:
    """Dynamic shared memory of one block, as csrc/groupnorm.cu lays it out
    (its launcher counts the same): the ring of rows where C fills whole
    16-byte vectors (all of the block's rows, or 4 tiles), the float32 fold
    and statistics arrays (in the forward, every block's statistics), then
    one 8-byte barrier a ring slot."""
    threads = block_threads(backward, C, vec)
    slots = threads // min(C // vec, threads)
    data = ((2 if backward else 1) * min(rows_per_block, _SLOTS * tile_rows)
            * C * itemsize if vec * itemsize == 16 else 0)
    floats = (2 * slots * C + 4 * C + 2 * G if backward
              else slots * C + C + (4 + 2 * cluster) * G)
    return -(-(data + 4 * floats) // 8) * 8 + 8 * _SLOTS


def _splits(rows: int, cluster: int) -> bool:
    """Whether `cluster` blocks of ceil(rows / cluster) rows leave none
    empty."""
    return (cluster - 1) * -(-rows // cluster) < rows


@functools.lru_cache(maxsize=None)
def geometry(B: int, H: int, W: int, C: int, G: int, dtype: torch.dtype,
             backward: bool, fill: bool = True,
             min_tile_bytes: int = _MIN_TILE_BYTES) -> Geometry:
    """The cut of a call on a (B, H, W, C) tensor: the smallest cluster in
    which a block's rows take at most `_SHARE_LIMIT` bytes of its shared
    memory (`_STAGE_LIMIT` for the float32 backward, and where that fails),
    then doubled while B x cluster stays within the card's SMs, the blocks
    keep `_MIN_ROWS` rows, and clusters of 16 stay within what runs at
    once.  Where C fills whole 16-byte vectors and the rows fit in 16
    blocks they are staged; where they do not fit they are streamed, in
    tiles that leave room for the arrays; otherwise read from device
    memory.  A staged tile holds at least `min_tile_bytes`.  Without
    `fill` the cluster is not doubled (gn_stats: see `split_geometry`).
    Raises ValueError for what the kernel does not take."""
    rows, item = H * W, dtype.itemsize
    vec = vec_width(C, item)
    if B <= 0 or rows <= 0 or C <= 0 or G <= 0 or C % G:
        raise ValueError(f"no GroupNorm of ({B}, {H}, {W}, {C}), G={G}")
    if B > 65535:
        raise ValueError(f"the kernel does not take B={B}")
    row_bytes = (2 if backward else 1) * C * item

    def tile(cluster, staged, streamed):
        per = -(-rows // cluster)
        if staged:
            return min(per, max(-(-per // _SLOTS),
                                -(-min_tile_bytes // row_bytes)))
        if not streamed:
            return per
        room = _SMEM_LIMIT - smem_bytes(backward, cluster, per, 0, C, G,
                                        vec, item)  # the arrays alone
        return min(per, max(1, min(_TILE_BYTES, room // _SLOTS) // row_bytes))

    def smem(cluster, staged, streamed):
        return smem_bytes(backward, cluster, -(-rows // cluster),
                          tile(cluster, staged, streamed), C, G, vec, item)

    def fits(cluster, limit):
        return (-(-rows // cluster) * row_bytes <= limit
                and smem(cluster, True, False) <= _SMEM_LIMIT)

    def smallest(limit):
        cluster = 1
        while (not fits(cluster, limit) and cluster < _MAX_CLUSTER
               and _splits(rows, 2 * cluster)):
            cluster *= 2
        return cluster if fits(cluster, limit) else None

    ring = vec * item == 16
    share = _STAGE_LIMIT if backward and item == 4 else _SHARE_LIMIT
    cluster = ring and (smallest(share) or smallest(_STAGE_LIMIT))
    staged = bool(cluster)
    streamed, cluster = ring and not staged, cluster or 1
    while (fill and cluster < _MAX_CLUSTER and 2 * cluster * B <= _SMS
           and rows >= 2 * cluster * _MIN_ROWS and _splits(rows, 2 * cluster)
           and smem(2 * cluster, staged, streamed) <= _SMEM_LIMIT
           and (2 * cluster < _MAX_CLUSTER or B <= _CLUSTERS_OF_16)):
        cluster *= 2
    if smem(cluster, staged, streamed) > _SMEM_LIMIT:
        raise ValueError(f"the kernel does not take C={C}, G={G}")
    return Geometry(cluster, -(-rows // cluster),
                    tile(cluster, staged, streamed), staged, streamed,
                    smem(cluster, staged, streamed),
                    block_threads(backward, C, vec))


def _check(x, gamma, beta, num_groups, act):
    if act not in ("silu", "none"):
        raise ValueError(f"act must be 'silu' or 'none', got {act!r}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C), got {tuple(x.shape)}")
    C = x.shape[-1]
    if num_groups <= 0 or C % num_groups != 0:
        raise ValueError(f"C={C} does not divide into {num_groups} groups")
    if gamma.shape != (C,) or beta.shape != (C,):
        raise ValueError(f"gamma and beta must be ({C},), got "
                         f"{tuple(gamma.shape)}, {tuple(beta.shape)}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("x, gamma and beta must lie on one device")


def _check_cuda(x, gamma=None, beta=None):
    """What the kernels take beyond `_check`: float32 or bfloat16 on a
    CUDA device, gamma and beta (where given) of x's type, all
    contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    affine = [] if gamma is None else [gamma, beta]
    if any(t.dtype != x.dtype for t in affine):
        raise TypeError(f"gamma and beta must have x's type {x.dtype}, got "
                        f"{gamma.dtype}, {beta.dtype}")
    if not all(t.is_contiguous() for t in [x] + affine):
        raise ValueError("x, gamma and beta must be contiguous")
    if x.shape[0] == 0 or x.shape[1] * x.shape[2] == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")


def gn_act_fwd(x, gamma, beta, num_groups=32, eps=1e-5, act="silu"):
    """GroupNorm + optional SiLU on x (B, H, W, C).  Returns (y, mean, rstd):
    y in x's type, mean and rstd (B, G) float32.

    A CUDA tensor goes to the hand-written kernel (float32 or bfloat16,
    contiguous, gamma and beta of x's type) or raises; only a CPU tensor
    takes the plain version."""
    _check(x, gamma, beta, num_groups, act)
    if x.device.type == "cpu":
        return gn_act_fwd_plain(x, gamma, beta, num_groups, eps, act)
    _check_cuda(x, gamma, beta)
    B, H, W, C = x.shape
    G = num_groups
    geo = geometry(B, H, W, C, G, x.dtype, False)
    y = torch.empty_like(x)
    mean = torch.empty((B, G), dtype=torch.float32, device=x.device)
    rstd = torch.empty((B, G), dtype=torch.float32, device=x.device)
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    fn = _launcher("unet_gn_act_fwd")
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), B, H * W,
                  C, G, eps, int(act == "silu"),
                  int(x.dtype == torch.bfloat16), geo.cluster,
                  geo.rows_per_block, geo.tile_rows,
                  torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "gn_act_fwd")
    gn_act_fwd.launches += 1
    return y, mean, rstd


# Launches of the kernel since the count was last set to 0.
gn_act_fwd.launches = 0


def gn_act_bwd_plain(x, gamma, beta, mean, rstd, dy, num_groups=32,
                     act="silu"):
    """Plain PyTorch GroupNorm(+SiLU) backward with the arithmetic of the
    kernel (and of the TPU kernel's `_bwd_kernel`): x-hat recomputed from the
    forward's mean and rstd (B, G), dz through the SiLU, per-batch sums
    dbeta_b = sum_hw dz and dgamma_b = sum_hw dz * x-hat, then
    dx = rstd * (dz * gamma - t1 - x-hat * t2) with t1, t2 the group means of
    dbeta_b * gamma and dgamma_b * gamma; all in float32 (float64 for float64
    input).  Returns (dx in x's type, dgamma_b, dbeta_b) with the partials
    (B, C) in float32."""
    xhat, dz = _bwd_terms(x, gamma, beta, mean, rstd, dy, num_groups, act)
    dbeta_b = dz.sum(dim=1)
    dgamma_b = (dz * xhat).sum(dim=1)
    B, H, W, C = x.shape
    dx = _bwd_dx(x, gamma, rstd, xhat, dz, dgamma_b, dbeta_b, num_groups,
                 H * W * (C // num_groups))
    return dx, dgamma_b, dbeta_b


def _bwd_terms(x, gamma, beta, mean, rstd, dy, num_groups, act):
    """x-hat and dz (B, H*W, C) in float32 (float64 for float64 input)."""
    B, H, W, C = x.shape
    G = num_groups
    stat_dt = torch.promote_types(x.dtype, torch.float32)
    xg = x.reshape(B, H * W, G, C // G).to(stat_dt)
    mean_c = mean.to(stat_dt)[:, None, :, None]
    rstd_c = rstd.to(stat_dt)[:, None, :, None]
    xhat = ((xg - mean_c) * rstd_c).reshape(B, H * W, C)
    dz = dy.reshape(B, H * W, C).to(stat_dt)
    if act == "silu":
        z = xhat * gamma.to(stat_dt) + beta.to(stat_dt)
        sig = torch.sigmoid(z)
        dz = dz * (sig * (1.0 + z * (1.0 - sig)))
    return xhat, dz


def _bwd_dx(x, gamma, rstd, xhat, dz, dgamma_b, dbeta_b, num_groups, n):
    """dx in x's type from the sums over the `n` values of each (b, g)."""
    B, H, W, C = x.shape
    G = num_groups
    g = gamma.to(xhat.dtype)
    rstd_c = rstd.to(xhat.dtype)[:, None, :, None]
    t1 = ((dbeta_b * g).reshape(B, G, C // G).sum(-1) / n)[:, None, :, None]
    t2 = ((dgamma_b * g).reshape(B, G, C // G).sum(-1) / n)[:, None, :, None]
    dx = rstd_c * ((dz * g).reshape(B, H * W, G, C // G) - t1
                   - xhat.reshape(B, H * W, G, C // G) * t2)
    return dx.reshape(B, H, W, C).to(x.dtype)


def gn_act_bwd(x, gamma, beta, mean, rstd, dy, num_groups=32, act="silu"):
    """Backward of `gn_act_fwd` from its inputs, its (mean, rstd) and dy.
    Returns (dx in x's type, dgamma_b, dbeta_b): the per-batch partials
    (B, C) float32, which the caller sums over B.

    A CUDA tensor goes to the hand-written kernel (the forward's types and
    layout; dy of any strides is made a contiguous NHWC tensor first) or
    raises; only a CPU tensor takes the plain version."""
    _check(x, gamma, beta, num_groups, act)
    B, H, W, C = x.shape
    G = num_groups
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not x's {tuple(x.shape)}")
    if mean.shape != (B, G) or rstd.shape != (B, G):
        raise ValueError(f"mean and rstd must be ({B}, {G})")
    dy = dy.contiguous()
    if x.device.type == "cpu":
        return gn_act_bwd_plain(x, gamma, beta, mean, rstd, dy, G, act)
    _check_cuda(x, gamma, beta)
    if dy.dtype != x.dtype or dy.device != x.device:
        raise TypeError(f"dy must be {x.dtype} on {x.device}")
    if mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise TypeError("mean and rstd must be float32")
    mean, rstd = mean.contiguous(), rstd.contiguous()
    geo = geometry(B, H, W, C, G, x.dtype, True)
    dx = torch.empty_like(x)
    dgamma_b = torch.empty((B, C), dtype=torch.float32, device=x.device)
    dbeta_b = torch.empty((B, C), dtype=torch.float32, device=x.device)
    if x.data_ptr() % 16 or dy.data_ptr() % 16 or dx.data_ptr() % 16:
        raise ValueError("x and dy must be 16-byte aligned")
    fn = _launcher("unet_gn_act_bwd")
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), dgamma_b.data_ptr(), dbeta_b.data_ptr(),
                  B, H * W, C, G, int(act == "silu"),
                  int(x.dtype == torch.bfloat16), geo.cluster,
                  geo.rows_per_block, geo.tile_rows,
                  torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "gn_act_bwd")
    gn_act_bwd.launches += 1
    return dx, dgamma_b, dbeta_b


# Launches of the kernel since the count was last set to 0.
gn_act_bwd.launches = 0


class GroupNormAct(torch.autograd.Function):
    """y = GroupNorm(+SiLU)(x) with `gn_act_fwd` forward and `gn_act_bwd`
    backward; the residuals are (x, gamma, beta, mean, rstd), as in the JAX
    package's `_gn_fwd`.  The backward sums the per-batch partials over B
    and casts them to the parameters' type, as `_gn_bwd` does.  `fwd` and
    `bwd` are the two functions it calls (chip_smoke.py sets them to the
    plain versions for its comparisons)."""

    fwd = staticmethod(gn_act_fwd)
    bwd = staticmethod(gn_act_bwd)

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, act):
        y, mean, rstd = GroupNormAct.fwd(x, gamma, beta, num_groups, eps,
                                         act)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.num_groups, ctx.act = num_groups, act
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        dx, dgamma_b, dbeta_b = GroupNormAct.bwd(
            x, gamma, beta, mean, rstd, dy, ctx.num_groups, ctx.act)
        return (dx, dgamma_b.sum(0).to(gamma.dtype),
                dbeta_b.sum(0).to(beta.dtype), None, None, None)


# --- the split GroupNorm -----------------------------------------------------
#
# A GroupNorm whose rows are split over N model ranks (spatial sharding,
# parallel/spatial.py) needs each (b, g)'s statistics and each (b, c)'s
# backward sums over the whole sample, which K4 and K5 compute inside their
# one launch.  Here they are split around a collective that the caller
# makes (`gather`: every rank's tensor stacked in rank order):
#
#   forward:  gn_stats (K4a) -> gather -> gn_apply (K4b)
#   backward: gn_bwd_sums (K5a) -> gather -> gn_bwd_dx (K5b)
#
# The ranks' statistics are merged in rank order by Chan et al.'s pairwise
# formula (one collective, each rank's (mean, M2) two-pass over its own
# rows), so every rank holds the same bits; two all-reduced passes (the
# sum, then the squared differences from the merged mean) would be exact
# two-pass arithmetic too, at one more collective and one more launch.
# Every rank's slice has the same number of rows (the CLI's rule), so each
# partial counts H*W*C/G values and the sample N times that.
#
# gn_stats and gn_bwd_sums are K4's and K5's cluster kernels stopped after
# their statistics and sums (`split_geometry`); gn_apply streams the rows,
# each thread on one fixed vector of channels (`apply_geometry`: blocks of
# `_APPLY_THREADS`, at least `_APPLY_UNROLL` vectors a thread, the grid
# within about `_APPLY_BLOCKS` blocks, two an SM); gn_bwd_dx is
# elementwise, its shared memory at most `_SPLIT_SMEM`.
_SPLIT_SMEM = 48 * 1024
_APPLY_THREADS = 256
_APPLY_UNROLL = 4
_APPLY_BLOCKS = 2 * _SMS


def gn_stats_plain(x, num_groups=32):
    """Per (b, g) of x (B, H, W, C): the mean and M2 (the sum of squared
    differences from that mean) of its H*W*C/G values, two-pass, float32
    (float64 for float64 input).  Returns (B, G, 2)."""
    B, H, W, C = x.shape
    G = num_groups
    stat_dt = torch.promote_types(x.dtype, torch.float32)
    xg = x.reshape(B, H * W, G, C // G).to(stat_dt)
    mean = xg.mean(dim=(1, 3))
    m2 = (xg - mean[:, None, :, None]).square().sum(dim=(1, 3))
    return torch.stack([mean, m2], dim=-1)


def gn_merge_plain(stats, count, eps=1e-5):
    """(mean, rstd) (B, G) of N ranks' (mean, M2) (`stats` (N, B, G, 2)),
    each over `count` values, merged in rank order by the pairwise formula
    mean += d n_b / n, M2 += M2_b + d^2 n_a n_b / n (d the difference of
    the means), as `gn_apply` merges them."""
    n = torch.full((), float(count), dtype=stats.dtype, device=stats.device)
    mean, m2 = stats[0, ..., 0], stats[0, ..., 1]
    for i in range(1, stats.shape[0]):
        na = n * i
        tot = na + n
        d = stats[i, ..., 0] - mean
        mean = mean + d * (n / tot)
        m2 = m2 + stats[i, ..., 1] + d * d * (na * n / tot)
    return mean, torch.rsqrt(m2 / (n * stats.shape[0]) + eps)


def gn_apply_plain(x, gamma, beta, stats, num_groups=32, eps=1e-5,
                   act="silu"):
    """GroupNorm(+SiLU) of this rank's rows x (B, H, W, C) with the whole
    sample's statistics, merged from every rank's `gn_stats` (`stats`
    (N, B, G, 2), in rank order): (y in x's type, mean, rstd (B, G))."""
    B, H, W, C = x.shape
    G = num_groups
    mean, rstd = gn_merge_plain(stats, H * W * (C // G), eps)
    xg = x.reshape(B, H * W, G, C // G).to(stats.dtype)
    xc = xg - mean[:, None, :, None]
    return _normalize(x, xc, gamma, beta, rstd, act), mean, rstd


def gn_bwd_sums_plain(x, gamma, beta, mean, rstd, dy, num_groups=32,
                      act="silu"):
    """This rank's per-(b, c) sums of the backward: dgamma_b = sum dz x-hat
    and dbeta_b = sum dz over its rows, x-hat from the merged mean and rstd
    (B, G), dz through the SiLU.  Returns (2, B, C) float32: [dgamma_b;
    dbeta_b]."""
    xhat, dz = _bwd_terms(x, gamma, beta, mean, rstd, dy, num_groups, act)
    return torch.stack([(dz * xhat).sum(dim=1), dz.sum(dim=1)])


def gn_bwd_dx_plain(x, gamma, beta, mean, rstd, dy, sums, num_groups=32,
                    act="silu"):
    """dx of this rank's rows from every rank's `gn_bwd_sums` (`sums`
    (N, 2, B, C), added in rank order): t1 and t2 per group over the whole
    sample's count, N * H*W*C/G."""
    B, H, W, C = x.shape
    xhat, dz = _bwd_terms(x, gamma, beta, mean, rstd, dy, num_groups, act)
    total = sums[0]
    for i in range(1, sums.shape[0]):
        total = total + sums[i]
    return _bwd_dx(x, gamma, rstd, xhat, dz, total[0], total[1], num_groups,
                   sums.shape[0] * H * W * (C // num_groups))


def split_geometry(kernel: str, B: int, H: int, W: int, C: int, G: int,
                   dtype: torch.dtype) -> Geometry:
    """The cut of a gn_stats ("stats") or gn_bwd_sums ("sums") call on a
    rank's rows (B, H, W, C), one cluster per batch element; the launcher
    checks it and counts shared memory as `smem_bytes` does.

    gn_stats is K4 up to its statistics, two passes over rows kept in
    shared memory: K4's geometry, the smallest cluster whose blocks stage
    their rows within `_SHARE_LIMIT`, but not doubled to fill the card (the
    cluster's exchange costs more than the SMs it adds save:
    utils/gn_sweep.py at B=32), in tiles of at least `_STATS_TILE_BYTES`.
    gn_bwd_sums is K5's first pass alone, each row read once: the smallest
    cluster whose blocks hold at most `_SUMS_BLOCK_BYTES` of x and dy, all
    copied at once in one tile, while B x cluster stays within two blocks
    an SM; where the rows are still larger they stream through the ring in
    tiles of `_SUMS_TILE_BYTES`."""
    if kernel == "stats":
        return geometry(B, H, W, C, G, dtype, False, fill=False,
                        min_tile_bytes=_STATS_TILE_BYTES)
    if kernel != "sums":
        raise ValueError(f"no split kernel {kernel!r} takes a geometry")
    rows, item = H * W, dtype.itemsize
    vec = vec_width(C, item)
    if B <= 0 or rows <= 0 or C <= 0 or G <= 0 or C % G:
        raise ValueError(f"no GroupNorm of ({B}, {H}, {W}, {C}), G={G}")
    if B > 65535:
        raise ValueError(f"the kernel does not take B={B}")
    row_bytes = 2 * C * item
    cluster = 1
    while (-(-rows // cluster) * row_bytes > _SUMS_BLOCK_BYTES
           and cluster < _MAX_CLUSTER and 2 * cluster * B <= 2 * _SMS
           and _splits(rows, 2 * cluster)
           and (2 * cluster < _MAX_CLUSTER or B <= _CLUSTERS_OF_16)):
        cluster *= 2
    per = -(-rows // cluster)
    ring = vec * item == 16
    staged = ring and per * row_bytes <= _SUMS_BLOCK_BYTES
    streamed = ring and not staged
    tile = (min(per, max(1, _SUMS_TILE_BYTES // row_bytes)) if streamed
            else per)
    smem = smem_bytes(True, cluster, per, tile, C, G, vec, item)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"the kernel does not take C={C}, G={G}")
    return Geometry(cluster, per, tile, staged, streamed, smem,
                    block_threads(True, C, vec))


class ApplyGeometry(NamedTuple):
    """How gn_apply cuts a call: a row's C / vec vectors in `cols` column
    blocks of `lanes` vectors (the last may have fewer), `slots` rows of
    them at a time in `threads` = lanes * slots of a block's
    `_APPLY_THREADS` threads, and a sample's rows in `chunks` runs of
    `rows_per_block` (the last may have fewer).  Grid (chunks, cols, B);
    each thread takes at most `vectors_per_thread` vectors, one every
    `slots` rows of its run."""
    cols: int
    lanes: int
    slots: int
    threads: int
    chunks: int
    rows_per_block: int
    vectors_per_thread: int


def apply_geometry(B: int, H: int, W: int, C: int,
                   dtype: torch.dtype) -> ApplyGeometry:
    """The cut of a gn_apply call on a rank's rows (B, H, W, C); the
    launcher lays out its blocks as `cols`, `lanes` and `slots` say (its
    `apply_layout` is the same rule) and takes `rows_per_block`.  Each
    block's run of rows is a whole number of `slots`-row passes: at least
    `_APPLY_UNROLL` (a thread's first batch of loads is then full), and
    as many more as keep the grid within `_APPLY_BLOCKS` blocks, but at
    most half a sample's passes (two blocks a sample at least).  Fewer,
    larger runs won where the per-thread start (merging the statistics)
    was dear: utils/gn_sweep.py at B=32.  At (32, 32, 64, 64): 8 passes a
    block in bfloat16, 16 in float32."""
    rows, vec = H * W, vec_width(C, dtype.itemsize)
    if B <= 0 or rows <= 0 or C <= 0 or vec < 2:
        raise ValueError(f"gn_apply: the kernel does not take ({B}, {H}, "
                         f"{W}, {C}) (C even, at least two channels a "
                         f"thread)")
    if B > 65535:
        raise ValueError(f"gn_apply: the kernel does not take B={B}")
    L = C // vec
    cols = -(-L // _APPLY_THREADS)
    lanes = -(-L // cols)
    slots = _APPLY_THREADS // lanes
    passes = -(-rows // slots)
    runs = max(1, _APPLY_BLOCKS // (B * cols))  # a sample's, at most
    per = min(-(-passes // 2), max(_APPLY_UNROLL, -(-passes // runs)))
    rows_per_block = per * slots
    return ApplyGeometry(cols, lanes, slots, lanes * slots,
                         -(-rows // rows_per_block), rows_per_block, per)


def _dx_smem(C: int, G: int) -> int:
    """Bytes of dynamic shared memory of a block of gn_bwd_dx, as
    csrc/groupnorm.cu counts them."""
    return 4 * (2 * C + 4 * G)


def _check_split(kernel, x, num_groups, gamma=None, beta=None):
    """What a split kernel takes on a CUDA device beyond `_check`: what
    `_check_cuda` asks, 16-byte alignment, an even C (two channels a
    thread at least) and, for gn_bwd_dx, its shared memory
    (`split_geometry` and `apply_geometry` raise for what the others do
    not take)."""
    _check_cuda(x, gamma, beta)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    C = x.shape[-1]
    if C % 2:
        raise ValueError(f"gn_{kernel}: the kernel takes an even C, not {C}")
    if kernel == "dx" and _dx_smem(C, num_groups) > _SPLIT_SMEM:
        raise ValueError(f"gn_{kernel}: the kernel does not take C={C}, "
                         f"G={num_groups}")


def gn_stats(x, num_groups=32):
    """K4a: `gn_stats_plain` of x (B, H, W, C), (B, G, 2) float32.  A CUDA
    tensor goes to the hand-written kernel (float32 or bfloat16, contiguous)
    or raises; only a CPU tensor takes the plain version."""
    if x.dim() != 4 or num_groups <= 0 or x.shape[-1] % num_groups:
        raise ValueError(f"no GroupNorm of {tuple(x.shape)} in "
                         f"{num_groups} groups")
    if x.device.type == "cpu":
        return gn_stats_plain(x, num_groups)
    _check_split("stats", x, num_groups)
    B, H, W, C = x.shape
    geo = split_geometry("stats", B, H, W, C, num_groups, x.dtype)
    stats = torch.empty((B, num_groups, 2), dtype=torch.float32,
                        device=x.device)
    with torch.cuda.device(x.device):
        code = _launcher("unet_gn_stats")(
            x.data_ptr(), stats.data_ptr(), B, H * W, C, num_groups,
            int(x.dtype == torch.bfloat16), geo.cluster, geo.rows_per_block,
            geo.tile_rows, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "gn_stats")
    gn_stats.launches += 1
    return stats


gn_stats.launches = 0


def gn_apply(x, gamma, beta, stats, num_groups=32, eps=1e-5, act="silu"):
    """K4b: `gn_apply_plain`.  Returns (y in x's type, mean, rstd (B, G)
    float32); stats (N, B, G, 2) float32.  A CUDA tensor goes to the
    hand-written kernel or raises; only a CPU tensor takes the plain
    version."""
    _check(x, gamma, beta, num_groups, act)
    B, H, W, C = x.shape
    G = num_groups
    if stats.dim() != 4 or stats.shape[1:] != (B, G, 2):
        raise ValueError(f"stats must be (N, {B}, {G}, 2), got "
                         f"{tuple(stats.shape)}")
    if x.device.type == "cpu":
        return gn_apply_plain(x, gamma, beta, stats, G, eps, act)
    _check_split("apply", x, G, gamma, beta)
    geo = apply_geometry(B, H, W, C, x.dtype)
    stats = _float_stats(stats, x)
    y = torch.empty_like(x)
    mean = torch.empty((B, G), dtype=torch.float32, device=x.device)
    rstd = torch.empty((B, G), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        code = _launcher("unet_gn_apply")(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            stats.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            stats.shape[0], B, H * W, C, G, eps, int(act == "silu"),
            int(x.dtype == torch.bfloat16), geo.rows_per_block,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "gn_apply")
    gn_apply.launches += 1
    return y, mean, rstd


gn_apply.launches = 0


def _float_stats(t, x):
    """A float32 tensor on x's device, made contiguous."""
    if t.dtype != torch.float32 or t.device != x.device:
        raise TypeError(f"statistics must be float32 on {x.device}, got "
                        f"{t.dtype} on {t.device}")
    return t.contiguous()


def _check_bwd(x, mean, rstd, dy, num_groups):
    B, H, W, C = x.shape
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} is not x's {tuple(x.shape)}")
    if mean.shape != (B, num_groups) or rstd.shape != (B, num_groups):
        raise ValueError(f"mean and rstd must be ({B}, {num_groups})")
    if x.device.type != "cpu" and (dy.dtype != x.dtype
                                   or dy.device != x.device):
        raise TypeError(f"dy must be {x.dtype} on {x.device}")


def gn_bwd_sums(x, gamma, beta, mean, rstd, dy, num_groups=32, act="silu"):
    """K5a: `gn_bwd_sums_plain`, (2, B, C) float32.  A CUDA tensor goes to
    the hand-written kernel (dy made contiguous first) or raises; only a CPU
    tensor takes the plain version."""
    _check(x, gamma, beta, num_groups, act)
    _check_bwd(x, mean, rstd, dy, num_groups)
    dy = dy.contiguous()
    if x.device.type == "cpu":
        return gn_bwd_sums_plain(x, gamma, beta, mean, rstd, dy, num_groups,
                                 act)
    _check_split("sums", x, num_groups, gamma, beta)
    B, H, W, C = x.shape
    geo = split_geometry("sums", B, H, W, C, num_groups, x.dtype)
    mean, rstd = _float_stats(mean, x), _float_stats(rstd, x)
    sums = torch.empty((2, B, C), dtype=torch.float32, device=x.device)
    if dy.data_ptr() % 16:
        raise ValueError("dy must be 16-byte aligned")
    with torch.cuda.device(x.device):
        code = _launcher("unet_gn_bwd_sums")(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dy.data_ptr(), sums.data_ptr(), B, H * W, C,
            num_groups, int(act == "silu"), int(x.dtype == torch.bfloat16),
            geo.cluster, geo.rows_per_block, geo.tile_rows,
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "gn_bwd_sums")
    gn_bwd_sums.launches += 1
    return sums


gn_bwd_sums.launches = 0


def gn_bwd_dx(x, gamma, beta, mean, rstd, dy, sums, num_groups=32,
              act="silu"):
    """K5b: `gn_bwd_dx_plain`, dx in x's type; sums (N, 2, B, C) float32.
    A CUDA tensor goes to the hand-written kernel or raises; only a CPU
    tensor takes the plain version."""
    _check(x, gamma, beta, num_groups, act)
    _check_bwd(x, mean, rstd, dy, num_groups)
    B, H, W, C = x.shape
    if sums.dim() != 4 or sums.shape[1:] != (2, B, C):
        raise ValueError(f"sums must be (N, 2, {B}, {C}), got "
                         f"{tuple(sums.shape)}")
    dy = dy.contiguous()
    if x.device.type == "cpu":
        return gn_bwd_dx_plain(x, gamma, beta, mean, rstd, dy, sums,
                               num_groups, act)
    _check_split("dx", x, num_groups, gamma, beta)
    mean, rstd = _float_stats(mean, x), _float_stats(rstd, x)
    sums = _float_stats(sums, x)
    dx = torch.empty_like(x)
    if dy.data_ptr() % 16 or dx.data_ptr() % 16:
        raise ValueError("dy must be 16-byte aligned")
    with torch.cuda.device(x.device):
        code = _launcher("unet_gn_bwd_dx")(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dy.data_ptr(), sums.data_ptr(), dx.data_ptr(),
            sums.shape[0], B, H * W, C, num_groups, int(act == "silu"),
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "gn_bwd_dx")
    gn_bwd_dx.launches += 1
    return dx


gn_bwd_dx.launches = 0


class SplitGroupNormAct(torch.autograd.Function):
    """y = GroupNorm(+SiLU)(x) of this rank's rows x, the statistics and
    the backward's sums taken over every rank's rows: `gn_stats`, `gather`,
    `gn_apply` forward; `gn_bwd_sums`, `gather`, `gn_bwd_dx` backward.
    `gather(t)` stacks every rank's t in rank order ((N,) + t.shape; a
    collective, which every rank makes in the same order).  The gradient of
    gamma and beta is this rank's own part, summed over B: the step sums
    the parameters' gradients over the ranks afterwards, so a sum over them
    here would count it N times.  `normalize` and `dx` are the
    `gn_apply` and `gn_bwd_dx` it calls (chip_smoke.py swaps them)."""

    normalize = staticmethod(gn_apply)
    dx = staticmethod(gn_bwd_dx)

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, act, gather):
        cls = SplitGroupNormAct
        stats = gather(gn_stats(x, num_groups))
        y, mean, rstd = cls.normalize(x, gamma, beta, stats, num_groups,
                                      eps, act)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.num_groups, ctx.act, ctx.gather = num_groups, act, gather
        return y

    @staticmethod
    def backward(ctx, dy):
        cls = SplitGroupNormAct
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        G, act = ctx.num_groups, ctx.act
        mine = gn_bwd_sums(x, gamma, beta, mean, rstd, dy, G, act)
        dx = cls.dx(x, gamma, beta, mean, rstd, dy, ctx.gather(mine), G, act)
        return (dx, mine[0].sum(0).to(gamma.dtype),
                mine[1].sum(0).to(beta.dtype), None, None, None, None)


_ARGTYPES = {
    "unet_gn_act_fwd": "pppppp" "iiii" "f" "iiiii" "p",
    "unet_gn_act_bwd": "ppppppppp" "iiii" "iiiii" "p",
    "unet_gn_stats": "pp" "iiii" "i" "iii" "p",
    "unet_gn_apply": "ppppppp" "iiiii" "f" "iii" "p",
    "unet_gn_bwd_sums": "ppppppp" "iiii" "ii" "iii" "p",
    "unet_gn_bwd_dx": "pppppppp" "iiiii" "ii" "p",
}


def _launcher(name):
    fn = getattr(_build.load(), name)
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "f": ctypes.c_float}
        fn.argtypes = [kinds[k] for k in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
    return fn
