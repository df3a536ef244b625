"""Spatial sharding over the model axis (port of the JAX package's
`make_parallel_train_step(spatial=True)` in unet_tpu/parallel/mesh.py,
whose collectives GSPMD places; here the layers say them).

Model rank m of a data index holds rows [m H/N, (m+1) H/N) (`rows_of`) of
every activation of its samples, at every level; the parameters are whole
on every rank.  Three kinds of layer need rows of the other ranks, and
exchange them over the model group (`tensor.Shard.group`) by autograd
Functions whose backward is the exact adjoint of their forward:

* a 3x3 convolution (`halo_rows`): one row from each neighbour, the
  image's SAME zero padding only at its top and bottom edge; backward, the
  gradient of the two received rows goes back to the rank that sent them,
  which adds it to its own edge row;
* a GroupNorm (`group_norm_act`): each (b, g)'s statistics and each (b,
  c)'s backward sums over the whole sample, gathered between the split
  kernels of `ops/kernels/groupnorm.py` (`SplitGroupNormAct`);
* attention (`qkv_attention`): every row of the sample.  The ranks'
  (B, T/N, 3C) rows are gathered in rank order, which is T's row-major
  order, K1 runs on the whole and each rank keeps its T/N output rows;
  backward, the output gradients are gathered the same way, K2 runs on
  the whole and each rank keeps its rows of d(qkv).  Every rank's
  attention gradient is then the one-device K2's, with no sum, at N times
  the attention work of one rank's rows.

1x1 convolutions, pooling, upsampling, the skip concatenation and the time
MLP stay local.  With level 0 in patch space (ops/s2d.py) a rank holds its
rows' 2x2 patches: a 3x3 convolution's halo is one patch row (two pixel
rows), and a GroupNorm runs on the free view of the rank's patch rows.
Each rank's parameter gradient is the part of its own rows (the step sums
it over the ranks).  Over one model rank nothing is exchanged: the model
is the one-device model.

Collectives: `distributed.all_gather` and `dist.all_reduce` only.  Every
rank makes the same collectives in the same order, forward and backward
(and again in the backward's recompute under remat).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from unet_tpu_torch.ops.kernels.attention import QKVAttention
from unet_tpu_torch.ops.kernels.groupnorm import SplitGroupNormAct
from unet_tpu_torch.parallel import distributed
from unet_tpu_torch.parallel.tensor import Shard


def rows_of(H: int, shard: Shard) -> slice:
    """The rows of a height H that rank `shard.index` of `shard.size` holds
    (H divides by the size)."""
    if H % shard.size:
        raise ValueError(f"height {H} does not split over {shard.size} "
                         "model ranks")
    h = H // shard.size
    return slice(shard.index * h, (shard.index + 1) * h)


def halo_sources(size: int, index: int) -> Tuple[Optional[int], Optional[int]]:
    """The ranks whose rows rank `index` of `size` takes as its top and
    bottom halo: its neighbours' bottom and top rows, None (zeros) at the
    image's top and bottom edge."""
    return (index - 1 if index > 0 else None,
            index + 1 if index < size - 1 else None)


def gather(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Every model rank's `t` stacked in rank order: (N,) + t.shape (a
    collective over the shard's group)."""
    t = t.contiguous()
    out = torch.empty(shard.size * t.numel(), dtype=t.dtype, device=t.device)
    distributed.all_gather(out, t.view(-1), shard.group)
    return out.view((shard.size,) + tuple(t.shape))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """Rank order (N, B, n, K) -> (B, N n, K)."""
    return t.transpose(0, 1).reshape(t.shape[1], -1, t.shape[-1])


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        every = gather(torch.cat([x[:, :1], x[:, -1:]], dim=1), shard)
        top, bottom = halo_sources(shard.size, shard.index)
        zero = torch.zeros_like(x[:, :1])
        return torch.cat([zero if top is None else every[top][:, 1:],
                          x, zero if bottom is None else every[bottom][:, :1]],
                         dim=1)

    @staticmethod
    def backward(ctx, grad):
        shard = ctx.shard
        every = gather(torch.cat([grad[:, :1], grad[:, -1:]], dim=1), shard)
        top, bottom = halo_sources(shard.size, shard.index)
        dx = grad[:, 1:-1].clone()
        if top is not None:  # our top row was its bottom halo
            dx[:, :1] += every[top][:, 1:]
        if bottom is not None:  # our bottom row was its top halo
            dx[:, -1:] += every[bottom][:, :1]
        return dx, None


def halo_rows(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """(B, h, W, C) -> (B, h + 2, W, C): this rank's rows with the row
    above from the rank before and the row below from the rank after
    (zeros at the image's edge).  A collective, forward and backward."""
    return _Halo.apply(x, shard)


def group_norm_act(x, gamma, beta, num_groups, eps, act, shard: Shard):
    """GroupNorm(+SiLU) of this rank's rows over the whole sample (the
    split kernels around two all-gathers)."""
    return SplitGroupNormAct.apply(x, gamma, beta, num_groups, eps, act,
                                   lambda t: gather(t, shard))


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, shard):
        whole = _rows(gather(qkv, shard))
        ctx.save_for_backward(whole)
        ctx.num_heads, ctx.shard = num_heads, shard
        out = QKVAttention.fwd(whole, num_heads)
        return out.unflatten(1, (shard.size, -1))[:, shard.index].contiguous()

    @staticmethod
    def backward(ctx, dout):
        (whole,) = ctx.saved_tensors
        shard = ctx.shard
        dqkv = QKVAttention.bwd(whole, _rows(gather(dout, shard)),
                                ctx.num_heads)
        return (dqkv.unflatten(1, (shard.size, -1))[:, shard.index]
                .contiguous(), None, None)


def qkv_attention(qkv: torch.Tensor, num_heads: int, shard: Shard
                  ) -> torch.Tensor:
    """Attention of this rank's rows of qkv (B, T/N, 3C) over every row of
    the sample: (B, T/N, C) (K1 and K2 on the gathered rows)."""
    return _Attention.apply(qkv, num_heads, shard)
