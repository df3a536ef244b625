"""Megatron tensor parallelism over the model axis (port of `tp_sharding`
in unet_tpu/parallel/mesh.py, whose collectives GSPMD places; here the
blocks say them).  The model axis has a second use, spatial sharding
(`parallel/spatial.py`), which splits the activations' height instead and
shares `Shard`, a rank's place on the axis, with it; the two never run at
once.

A block that splits (`res_splits`, `attn_splits`) holds only its rank's
piece of the layers the JAX package shards, and runs them between two
collectives over the model group (`Shard.group`):

* column-parallel layers (a ResBlock's `conv1` and `emb`, attention's
  `qkv`) hold the rank's output rows and read the block's replicated input
  through `copy_to_model`: the identity forward, an all-reduce of the
  gradient backward (each rank's rows give a part of it);
* row-parallel layers (`conv2`, `proj`) hold the matching input columns;
  their partial products are summed by `reduce_from_model`: an all-reduce
  forward, the identity backward.  Their bias is added once, by model rank
  0, inside its partial product (the fused bias of `F.conv2d` /
  `F.linear`), so that at a model axis of one the layer is the one-device
  op, bits and all;
* what lies between stays local: a ResBlock's `gn2` normalises its
  C_out/N channels in G/N whole groups, and attention runs the rank's NH/N
  heads, with `qkv` cut by head so that the rank's piece is packed
  [q | k | v] as the kernels take it.

A split ResBlock at level 0 in patch space (ops/s2d.py) splits the same
way: its rank's pieces of conv1 and conv2 are expanded for patch space
inside the forward, and its channels lie in the (phase, c) layout.

Every other leaf (conv_in, the time MLP, gn1, attention's gn, the skip
convs, the blocks that do not split, the head) is whole on every model
rank.  The ranks compute its gradient each on its own, and the card's
convolution backward does not repeat its bits from call to call, so the
step averages that gradient over the model group (`parallel/mesh.py`):
the copies stay equal by construction.  Over one model rank nothing
splits (`res_splits`, `attn_splits`) and nothing is summed.

The partial products are summed in the compute type (bfloat16 in a
bfloat16 step: half the bytes of a float32 sum, at one more rounding of
the sum, as an all-reduce over N ranks rounds N - 1 times).

`Split` says how a leaf of a split block lies over the model group; `take`
cuts the rank's piece of a whole leaf and `join` puts the pieces back, so
that a checkpoint written under TP is the one-device `.bin`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Shard:
    """This rank's place on the model axis: rank `index` of `size`, whose
    collectives run over `group` (None: the default group)."""
    size: int
    index: int
    group: Optional[object] = None


def res_splits(cout: int, num_groups: int, n: int) -> bool:
    """Whether a ResBlock of `cout` channels in `num_groups` GroupNorm
    groups splits over `n` model ranks: its conv1 rows and gn2's groups must
    divide (otherwise the whole block is replicated, as the JAX package
    replicates the leaves whose dimension does not divide).  Over one rank
    nothing splits: the block is the one-device block, with no
    collectives."""
    return n > 1 and cout % n == 0 and num_groups % n == 0


def attn_splits(channels: int, head_size: int, n: int) -> bool:
    """Whether an attention block splits over `n` model ranks: whole heads
    a rank (nothing splits over one rank)."""
    return n > 1 and (channels // head_size) % n == 0


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    """x, replicated over the model group, as the input of a
    column-parallel layer: its gradient is summed over the group (x itself
    without a shard)."""
    return x if shard is None else _CopyToModel.apply(x, shard.group)


def reduce_from_model(x: torch.Tensor, shard: Optional[Shard]
                      ) -> torch.Tensor:
    """The sum over the model group of a row-parallel layer's partial
    products `x`, summed in place (`x` is the layer's fresh output; x
    itself without a shard)."""
    if shard is None:
        return x
    return _ReduceFromModel.apply(x.contiguous(), shard.group)


@dataclasses.dataclass(frozen=True)
class Split:
    """How a leaf of a split block lies over the model group: dimension
    `dim` is `parts` packed parts ([q | k | v] of qkv: 3; [scale | shift]
    of emb under scale-shift norm: 2), each cut evenly, rank m holding
    piece m of every part, packed in the same order.  `dim` None: the whole
    leaf on model rank 0 and none on the others (a row-parallel bias)."""
    dim: Optional[int]
    parts: int = 1


ROWS, COLUMNS, FIRST = Split(0), Split(1), Split(None)


def take(whole: torch.Tensor, split: Split, shard: Shard
         ) -> Optional[torch.Tensor]:
    """The rank's piece of a whole leaf (None for a leaf it does not
    hold)."""
    if split.dim is None:
        return whole if shard.index == 0 else None
    t = whole.movedim(split.dim, 0)
    t = t.reshape((split.parts, shard.size, -1) + tuple(t.shape[1:]))
    return t[:, shard.index].flatten(0, 1).movedim(0, split.dim)


def join(pieces: List[Optional[torch.Tensor]], split: Split) -> torch.Tensor:
    """The whole leaf of every rank's piece (in rank order): the inverse of
    `take`."""
    if split.dim is None:
        return pieces[0]
    parts = [p.movedim(split.dim, 0) for p in pieces]
    parts = [p.reshape((split.parts, -1) + tuple(p.shape[1:])) for p in parts]
    return torch.stack(parts, 1).flatten(0, 2).movedim(0, split.dim)
