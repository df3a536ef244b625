"""Composite blocks: ResBlock and AttentionBlock (port of
unet_tpu/models/blocks.py).

A block is an `nn.Module` whose parameters carry the JAX package's names
(`w`, `b`, `scale`, `bias`) in torch shapes, registered in the order of
the `.bin` file (`models.unet.param_order`).
Initialisation follows the torch defaults the JAX package reproduces:
U(+-1/sqrt(fan_in)) for conv and linear weights and biases, ones and zeros
for GroupNorm.  A block computes in its parameters' type; `models.unet.apply`
casts them to the compute type, once, for a call.

Given a `parallel.tensor.Shard`, a block holds its rank's piece of the
model axis's Megatron split (see parallel/tensor.py) and says in `splits`
how each of those leaves lies over the model group; without one it is the
whole block, and the collectives are the identity.  Given a `spatial`
shard instead (the model axis's other use, parallel/spatial.py), a layer
holds its whole parameters and works on this rank's rows of the
activations: the 3x3 convolutions, the GroupNorms and attention exchange
rows or statistics over the model group.  The two are never set at once.
"""

from __future__ import annotations

import torch
from torch import nn

from unet_tpu_torch.ops import functional as F
from unet_tpu_torch.ops import s2d as S
from unet_tpu_torch.parallel import tensor


def _uniform(shape, bound, generator):
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class Conv2d(nn.Module):
    """Parameters of a SAME convolution: w (O, I, kh, kw), b (O,).

    w is stored in the channels_last memory format (same shape and values,
    other strides): the activations reach cuDNN as channels_last tensors,
    and a kernel in the default format would be laid out again on every
    call.  Without `bias`, b is None.  `spatial`: see the module's
    docstring."""

    def __init__(self, cin, cout, ksize, generator=None, bias=True,
                 spatial=None):
        super().__init__()
        self.spatial = spatial
        bound = 1.0 / (cin * ksize * ksize) ** 0.5
        self.w = nn.Parameter(
            _uniform((cout, cin, ksize, ksize), bound, generator)
            .contiguous(memory_format=torch.channels_last))
        self.b = (nn.Parameter(_uniform((cout,), bound, generator)) if bias
                  else None)

    def forward(self, x):
        return F.conv2d(x, self.w, self.b, shard=self.spatial)


class Linear(nn.Module):
    """Parameters of a linear layer: w (O, I), b (O,) (None without
    `bias`)."""

    def __init__(self, cin, cout, generator=None, bias=True):
        super().__init__()
        bound = 1.0 / cin ** 0.5
        self.w = nn.Parameter(_uniform((cout, cin), bound, generator))
        self.b = (nn.Parameter(_uniform((cout,), bound, generator)) if bias
                  else None)

    def forward(self, x):
        return F.linear(x, self.w, self.b)


class GroupNorm(nn.Module):
    """Parameters of a GroupNorm: scale (C,), bias (C,).  `spatial`: see
    the module's docstring."""

    def __init__(self, channels, num_groups=32, eps=1e-5, spatial=None):
        super().__init__()
        self.spatial = spatial
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, act="silu"):
        return F.group_norm_silu(x, self.scale, self.bias,
                                 num_groups=self.num_groups, eps=self.eps,
                                 act=act, shard=self.spatial)


class ResBlock(nn.Module):
    """GN1 -> SiLU -> [resample] -> Conv3x3 -> +emb-proj -> GN2 -> SiLU ->
    Conv3x3 -> + skip.  x: (B, H, W, Cin) NHWC; emb: (B, emb_dim).

    The embedding projection is added before GN2; with `scale_shift_norm` it
    becomes (scale, shift) applied after a GN2 without activation, and the
    SiLU follows.  The 1x1 `skip` exists only when the channels change.

    With `shard` (N ranks) the block holds rank m's piece: conv1 and emb
    column-parallel (C_out/N output rows; emb's [scale | shift] cut part by
    part), gn2 on those C_out/N channels in G/N groups, conv2 row-parallel
    (their input columns; its bias on rank 0 alone); gn1 and skip
    whole.  With `spatial` the block is whole and its GroupNorms and 3x3
    convolutions work on this rank's rows (the 1x1 skip, the resampling and
    the embedding stay local)."""

    def __init__(self, cin, cout, emb_dim, *, scale_shift_norm=False,
                 up=False, down=False, num_groups=32, eps=1e-5,
                 generator=None, shard=None, spatial=None):
        super().__init__()
        if up and down:
            raise ValueError("a ResBlock resamples up or down, not both")
        self.scale_shift_norm = scale_shift_norm
        self.up, self.down = up, down
        self.shard = shard
        n = 1 if shard is None else shard.size
        parts = 2 if scale_shift_norm else 1
        self.gn1 = GroupNorm(cin, num_groups, eps, spatial)
        self.conv1 = Conv2d(cin, cout // n, 3, generator, spatial=spatial)
        self.emb = Linear(emb_dim, parts * cout // n, generator)
        self.gn2 = GroupNorm(cout // n, num_groups // n, eps, spatial)
        self.conv2 = Conv2d(cout // n, cout, 3, generator,
                            bias=shard is None or shard.index == 0,
                            spatial=spatial)
        if cin != cout:
            self.skip = Conv2d(cin, cout, 1, generator)
        self.splits = {} if shard is None else {
            "conv1.w": tensor.ROWS, "conv1.b": tensor.ROWS,
            "emb.w": tensor.Split(0, parts), "emb.b": tensor.Split(0, parts),
            "gn2.scale": tensor.ROWS, "gn2.bias": tensor.ROWS,
            "conv2.w": tensor.COLUMNS, "conv2.b": tensor.FIRST}

    def forward(self, x, emb, s2d=False):
        """With `s2d`, x is a space-to-depth tensor (B, H/2, W/2, 4Cin) and
        every op runs in patch space with pixel-space semantics
        (ops/s2d.py): the GroupNorms through `group_norm_silu_s2d`, the 3x3
        convolutions through `conv2d_s2d`, the skip through `conv1x1_s2d`,
        the embedding tiled over the four phases.  The model axis splits
        it as in pixel space (`shard`: conv1's rows, gn2's channels and
        conv2's columns are the rank's, in the (phase, c) layout of its
        channels; `spatial`: the 3x3 convolutions and GroupNorms on the
        rank's patch rows).  A block that resamples does not run so."""
        if s2d and (self.up or self.down):
            raise ValueError("a ResBlock runs in patch space only without "
                             "resampling")
        gn, conv, skip, tile = _S2D_OPS if s2d else _PIXEL_OPS
        h = gn(self.gn1, x)
        if self.up:
            h, x = F.upsample_nearest_2x(h), F.upsample_nearest_2x(x)
        elif self.down:
            h, x = F.avg_pool_2x(h), F.avg_pool_2x(x)
        h = conv(self.conv1, tensor.copy_to_model(h, self.shard))

        e = self.emb(tensor.copy_to_model(F.silu(emb), self.shard))
        if self.scale_shift_norm:
            scale, shift = e.chunk(2, dim=-1)
            h = gn(self.gn2, h, "none")
            h = (h * (1.0 + tile(scale)[:, None, None, :])
                 + tile(shift)[:, None, None, :])
            h = F.silu(h)
        else:
            h = h + tile(e)[:, None, None, :]
            h = gn(self.gn2, h)
        h = tensor.reduce_from_model(conv(self.conv2, h), self.shard)

        if hasattr(self, "skip"):
            x = skip(self.skip, x)
        return x + h


# A ResBlock's (GroupNorm, 3x3 conv, 1x1 skip, per-channel vector) in pixel
# space and in patch space (`ResBlock.forward`'s `s2d`).
_PIXEL_OPS = (lambda norm, h, act="silu": norm(h, act=act),
              lambda conv, h: conv(h), lambda conv, h: conv(h),
              lambda v: v)
_S2D_OPS = (lambda norm, h, act="silu": S.group_norm_silu_s2d(
                h, norm.scale, norm.bias, num_groups=norm.num_groups,
                eps=norm.eps, act=act, shard=norm.spatial),
            lambda conv, h: S.conv2d_s2d(h, conv.w, conv.b,
                                         shard=conv.spatial),
            lambda conv, h: S.conv1x1_s2d(h, conv.w, conv.b),
            S.tile_phases)


class AttentionBlock(nn.Module):
    """GN (no activation) -> QKV linear -> multi-head attention -> proj ->
    residual.  x: (B, H, W, C) NHWC, so the (B, T, C) view is a reshape.

    With `shard` (N ranks) the block holds rank m's NH/N heads: the q, k and
    v rows of qkv for those heads, packed [q | k | v] as the kernels take
    them, and proj row-parallel over their channels (its bias on rank 0
    alone); gn whole.  With `spatial` the block is whole, x is this rank's
    rows, and its rows attend over every rank's."""

    def __init__(self, channels, *, head_size=32, num_groups=32, eps=1e-5,
                 generator=None, shard=None, spatial=None):
        super().__init__()
        self.shard, self.spatial = shard, spatial
        n = 1 if shard is None else shard.size
        self.num_heads = channels // head_size // n
        self.gn = GroupNorm(channels, num_groups, eps, spatial)
        self.qkv = Linear(channels, 3 * channels // n, generator)
        self.proj = Linear(channels // n, channels, generator,
                           bias=shard is None or shard.index == 0)
        self.splits = {} if shard is None else {
            "qkv.w": tensor.Split(0, 3), "qkv.b": tensor.Split(0, 3),
            "proj.w": tensor.COLUMNS, "proj.b": tensor.FIRST}

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.gn(x, act="none").reshape(B, H * W, C)
        a = F.qkv_attention(self.qkv(tensor.copy_to_model(h, self.shard)),
                            self.num_heads, self.spatial)
        h = tensor.reduce_from_model(self.proj(a), self.shard)
        return x + h.reshape(B, H, W, C)
