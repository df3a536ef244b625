"""Space-to-depth execution of the highest-resolution U-Net level (port of
unet_tpu/ops/s2d.py).

Level 0 can run on a 2x-coarser grid with 2x2 pixel patches packed into
channels: every (B, H, W, C) activation becomes (B, H/2, W/2, 4C) with the
channel layout (phase, c), phase = py*2 + px.  Activations are NHWC and
kernels OIHW, as everywhere in the port (ops/functional.py).

The patch-space identity: a stride-1 3x3 SAME convolution on the pixel grid
is exactly a 2x2 convolution on the patch grid with 4Cin input and 4Cout
output channels, except that each output phase reads a window shifted by
its own (py, px).  `conv2d_s2d` therefore pads by 1, convolves once with
the expanded (4Cout, 4Cin, 2, 2) kernel (9 of every 16 (tap, phase) slots
hold an original weight, the rest are structural zeros), which gives
(H/2 + 1, W/2 + 1) outputs, and takes the four phase-shifted (H/2, W/2)
views.  The multiply-adds grow by 16/9; the channels grow by 4x.  A 1x1
convolution multiplies each phase block by the same matrix; a GroupNorm
pools its statistics over the four phases; the 2x2 average pool is the
mean of the phase blocks and the nearest 2x upsample a copy of a pixel
into all four, so the down and up boundaries of level 0 convert between
the two spaces for free.

The expansion is a gather whose backward sums each weight's four slots
back onto its original tap, in one order on every run, so the parameters,
the optimizer and the checkpoints are those of pixel space and a step
repeats its bits.  Summation orders differ from pixel space's, so the two
agree to rounding, not bit for bit.

`group_norm_silu_s2d` is the pixel-space GroupNorm (`functional.
group_norm_silu`: K4 forward and K5 backward on a CUDA tensor) on a free
view: with the channels laid out as (phase, c), an s2d tensor (B, H/2,
W/2, 4C) reshapes to (B, H, W, C) with every channel in place and only the
order of the pixels changed, which a GroupNorm does not see.

On the model axis the ops are the pixel ops' counterparts.  Under spatial
sharding (parallel/spatial.py) a rank's patch rows are its pixel rows in
patch form (its height H/N is even), so the layout ops, pooling,
upsampling and the 1x1 convolution stay local, and `conv2d_s2d` and
`group_norm_silu_s2d` take the pixel ops' `shard=`.  Under Megatron TP
(parallel/tensor.py) a split ResBlock hands them its rank's piece of the
weights: the expansion of conv1's output rows (O/N, I, 3, 3) is the
(phase, o) layout of the rank's channels, which `tile_phases` of its bias
and its embedding rows matches, and that of conv2's input columns reads
them; conv2's bias is model rank 0's alone (None on the others).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from unet_tpu_torch.ops import functional
from unet_tpu_torch.parallel import spatial


def space_to_depth(x):
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel layout (py, px, c)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // 2, W // 2, 4 * C)


def depth_to_space(x):
    """Inverse of `space_to_depth`."""
    B, Hp, Wp, C4 = x.shape
    x = x.reshape(B, Hp, Wp, 2, 2, C4 // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, 2 * Hp, 2 * Wp, C4 // 4)


def concat_channels(a, b):
    """Concatenation along the ORIGINAL channel dim (phase-wise interleave):
    space_to_depth(cat(x, y)) == concat_channels(space_to_depth(x),
    space_to_depth(y))."""
    return torch.cat([a.unflatten(-1, (4, -1)), b.unflatten(-1, (4, -1))],
                     dim=-1).flatten(-2)


def tile_phases(v):
    """Per-original-channel vector (..., C) -> (..., 4C) in the (phase, c)
    channel layout."""
    return v.repeat((1,) * (v.dim() - 1) + (4,))


def _tap_slot(q, d):
    """For output phase q in {0, 1} and pixel tap offset d in {-1, 0, 1}:
    the (window position P, input phase p) covering that pixel, given the
    2x2 window at convolution output index Y spans patches {Y-1, Y} (P = 0,
    1) and phase q's true outputs are read at index Y_true + q."""
    if q == 0:
        return {-1: (0, 1), 0: (1, 0), 1: (1, 1)}[d]
    return {-1: (0, 0), 0: (0, 1), 1: (1, 0)}[d]


def _tap_index() -> np.ndarray:
    """Constant index T[q, P, Q, p] into a kernel's 3x3 taps, flattened
    (ky * 3 + kx), and a tenth slot for zero: the tap that output phase q
    reads at window position (P, Q) from input phase p (the JAX package's
    0/1 tap map as a gather)."""
    index = np.full((4, 2, 2, 4), 9, np.int64)
    for qy in (0, 1):
        for qx in (0, 1):
            for dy in (-1, 0, 1):
                P, py = _tap_slot(qy, dy)
                for dx in (-1, 0, 1):
                    Q, px = _tap_slot(qx, dx)
                    index[qy * 2 + qx, P, Q, py * 2 + px] = \
                        (dy + 1) * 3 + dx + 1
    return index


_TAP_INDEX = _tap_index().ravel()
# Each tap's four slots (one an output phase), in slot order: the gather of
# the expansion's backward.
_TAP_SLOTS = np.argsort(_TAP_INDEX, kind="stable")[:36]
# Both on each device they were asked for (the first, uncaptured call of a
# captured step puts them there, so a capture copies nothing from the host).
_INDICES_ON: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _indices_on(device) -> Tuple[torch.Tensor, torch.Tensor]:
    if device not in _INDICES_ON:
        _INDICES_ON[device] = tuple(torch.from_numpy(a.copy()).to(device)
                                    for a in (_TAP_INDEX, _TAP_SLOTS))
    return _INDICES_ON[device]


class _Taps(torch.autograd.Function):
    """(O, I, 9) taps -> (O, I, 64) slots by the tap index, zero where it
    points past the taps.  The backward sums each tap's four slots in one
    fixed order (a gather and a sum): `index_select`'s own backward adds
    them with atomics on the card, so that two runs of one step would
    differ in the last bits."""

    @staticmethod
    def forward(ctx, taps, index, slots):
        ctx.slots = slots
        O, I, _ = taps.shape
        return torch.cat([taps, taps.new_zeros(O, I, 1)],
                         dim=2).index_select(2, index)

    @staticmethod
    def backward(ctx, grad):
        O, I, _ = grad.shape
        return (grad.index_select(2, ctx.slots).view(O, I, 9, 4).sum(-1),
                None, None)


def expand_weights(w):
    """(O, I, 3, 3) pixel-space kernel -> (4O, 4I, 2, 2) patch-space kernel,
    element [q*O + o, p*I + i, P, Q] the tap of w[o, i] that output phase q
    reads at window position (P, Q) from input phase p, or zero: a gather,
    so every value is an original weight's bits.  Returned channels_last,
    the layout cuDNN takes with the NHWC activations.  The backward puts
    each weight's gradient back on its tap (the sum of its four slots, in
    one order on every run)."""
    O, I, kh, kw = w.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"expand_weights takes a 3x3 kernel, got {kh}x{kw}")
    wp = _Taps.apply(w.flatten(2), *_indices_on(w.device))
    wp = wp.view(O, I, 4, 2, 2, 4).permute(2, 0, 3, 4, 5, 1)
    return wp.reshape(4 * O, 2, 2, 4 * I).permute(0, 3, 1, 2)


def conv2d_s2d(x, w, b, shard=None):
    """3x3 SAME pixel-space convolution evaluated in patch space.

    x: (B, H', W', 4Cin) s2d activations; w: (Cout, Cin, 3, 3) ORIGINAL
    weights; b: (Cout,) or None.  Returns (B, H', W', 4Cout) s2d
    activations: one 2x2 convolution padded by 1, (H'+1, W'+1) outputs, of
    which output phase q = (qy, qx) is the (qy:qy+H', qx:qx+W') view of its
    channel block.  With a spatial `shard` (as `functional.conv2d`) x is
    this rank's patch rows: it takes one patch row (two pixel rows, all the
    2x2 window over {Y-1, Y} reads) from each neighbour
    (`spatial.halo_rows`) and pads only the width, which gives the same
    H'+1 output rows."""
    B, Hp, Wp, _ = x.shape
    O = w.shape[0]
    pad = 1
    if functional._split(shard):
        x, pad = spatial.halo_rows(x, shard), (0, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), expand_weights(w),
                 None if b is None else tile_phases(b),
                 padding=pad).permute(0, 2, 3, 1)
    return torch.cat([y[:, qy:qy + Hp, qx:qx + Wp, q * O:(q + 1) * O]
                      for q, (qy, qx) in enumerate(
                          ((0, 0), (0, 1), (1, 0), (1, 1)))], dim=-1)


def conv1x1_s2d(x, w, b):
    """1x1 pixel-space convolution (a per-pixel matmul) on s2d activations:
    each phase block multiplies the same (Cout, Cin) matrix.
    w: (Cout, Cin, 1, 1)."""
    O, I = w.shape[:2]
    return F.linear(x.unflatten(-1, (4, I)), w.reshape(O, I), b).flatten(-2)


def group_norm_silu_s2d(x, gamma, beta, *, num_groups=32, eps=1e-5,
                        act="silu", shard=None):
    """GroupNorm(+SiLU) over s2d activations with PIXEL-SPACE semantics:
    `functional.group_norm_silu` on the (B, 2H', 2W', C) view of x, whose
    pixels are level 0's in another order (see the module's docstring), so
    its statistics pool over the 4 phases and the affine is per original
    channel.  With a spatial `shard` the view holds this rank's pixel rows
    in another order; the split GroupNorm (`spatial.group_norm_act`) sums
    each (b, g) over the rows it is given and gathers the ranks' sums, so
    its statistics do not depend on that order either."""
    B, Hp, Wp, C4 = x.shape
    y = functional.group_norm_silu(
        x.reshape(B, 2 * Hp, 2 * Wp, C4 // 4), gamma, beta,
        num_groups=num_groups, eps=eps, act=act, shard=shard)
    return y.reshape(x.shape)


def avg_pool_2x_from_s2d(x):
    """2x2 stride-2 average pool of s2d input, producing a NORMAL (B, H',
    W', C) tensor: the pool window IS the patch, so this is the mean over
    the 4 phase blocks."""
    return x.unflatten(-1, (4, -1)).mean(dim=-2)


def upsample_2x_to_s2d(x):
    """Nearest-neighbour 2x upsample producing s2d output directly: every
    phase of a patch is a copy of the source pixel, a channel tile."""
    return tile_phases(x)
