"""Composite blocks: ResBlock and AttentionBlock (port of
unet_tpu/models/blocks.py).

A block is an `nn.Module` whose parameters carry the JAX package's names
(`w`, `b`, `scale`, `bias`) in torch shapes, registered in the order of
the `.bin` file (`models.unet.param_order`).
Initialisation follows the torch defaults the JAX package reproduces:
U(+-1/sqrt(fan_in)) for conv and linear weights and biases, ones and zeros
for GroupNorm.  A block computes in its parameters' type; `models.unet.apply`
casts them to the compute type, once, for a call.
"""

from __future__ import annotations

import torch
from torch import nn

from unet_tpu_torch.ops import functional as F


def _uniform(shape, bound, generator):
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class Conv2d(nn.Module):
    """Parameters of a SAME convolution: w (O, I, kh, kw), b (O,).

    w is stored in the channels_last memory format (same shape and values,
    other strides): the activations reach cuDNN as channels_last tensors,
    and a kernel in the default format would be laid out again on every
    call."""

    def __init__(self, cin, cout, ksize, generator=None):
        super().__init__()
        bound = 1.0 / (cin * ksize * ksize) ** 0.5
        self.w = nn.Parameter(
            _uniform((cout, cin, ksize, ksize), bound, generator)
            .contiguous(memory_format=torch.channels_last))
        self.b = nn.Parameter(_uniform((cout,), bound, generator))

    def forward(self, x):
        return F.conv2d(x, self.w, self.b)


class Linear(nn.Module):
    """Parameters of a linear layer: w (O, I), b (O,)."""

    def __init__(self, cin, cout, generator=None):
        super().__init__()
        bound = 1.0 / cin ** 0.5
        self.w = nn.Parameter(_uniform((cout, cin), bound, generator))
        self.b = nn.Parameter(_uniform((cout,), bound, generator))

    def forward(self, x):
        return F.linear(x, self.w, self.b)


class GroupNorm(nn.Module):
    """Parameters of a GroupNorm: scale (C,), bias (C,)."""

    def __init__(self, channels, num_groups=32, eps=1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x, act="silu"):
        return F.group_norm_silu(x, self.scale, self.bias,
                                 num_groups=self.num_groups, eps=self.eps,
                                 act=act)


class ResBlock(nn.Module):
    """GN1 -> SiLU -> [resample] -> Conv3x3 -> +emb-proj -> GN2 -> SiLU ->
    Conv3x3 -> + skip.  x: (B, H, W, Cin) NHWC; emb: (B, emb_dim).

    The embedding projection is added before GN2; with `scale_shift_norm` it
    becomes (scale, shift) applied after a GN2 without activation, and the
    SiLU follows.  The 1x1 `skip` exists only when the channels change."""

    def __init__(self, cin, cout, emb_dim, *, scale_shift_norm=False,
                 up=False, down=False, num_groups=32, eps=1e-5,
                 generator=None):
        super().__init__()
        if up and down:
            raise ValueError("a ResBlock resamples up or down, not both")
        self.scale_shift_norm = scale_shift_norm
        self.up, self.down = up, down
        self.gn1 = GroupNorm(cin, num_groups, eps)
        self.conv1 = Conv2d(cin, cout, 3, generator)
        self.emb = Linear(emb_dim, 2 * cout if scale_shift_norm else cout,
                          generator)
        self.gn2 = GroupNorm(cout, num_groups, eps)
        self.conv2 = Conv2d(cout, cout, 3, generator)
        if cin != cout:
            self.skip = Conv2d(cin, cout, 1, generator)

    def forward(self, x, emb):
        h = self.gn1(x)
        if self.up:
            h, x = F.upsample_nearest_2x(h), F.upsample_nearest_2x(x)
        elif self.down:
            h, x = F.avg_pool_2x(h), F.avg_pool_2x(x)
        h = self.conv1(h)

        e = self.emb(F.silu(emb))
        if self.scale_shift_norm:
            scale, shift = e.chunk(2, dim=-1)
            h = self.gn2(h, act="none")
            h = h * (1.0 + scale[:, None, None, :]) + shift[:, None, None, :]
            h = F.silu(h)
        else:
            h = h + e[:, None, None, :]
            h = self.gn2(h)
        h = self.conv2(h)

        if hasattr(self, "skip"):
            x = self.skip(x)
        return x + h


class AttentionBlock(nn.Module):
    """GN (no activation) -> QKV linear -> multi-head attention -> proj ->
    residual.  x: (B, H, W, C) NHWC, so the (B, T, C) view is a reshape."""

    def __init__(self, channels, *, head_size=32, num_groups=32, eps=1e-5,
                 generator=None):
        super().__init__()
        self.num_heads = channels // head_size
        self.gn = GroupNorm(channels, num_groups, eps)
        self.qkv = Linear(channels, 3 * channels, generator)
        self.proj = Linear(channels, channels, generator)

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.gn(x, act="none").reshape(B, H * W, C)
        a = F.qkv_attention(self.qkv(h), self.num_heads)
        return x + self.proj(a).reshape(B, H, W, C)
