"""Core ops on NHWC tensors (port of unet_tpu/ops/functional.py).

Layout is the JAX package's: activations (B, H, W, C), attention input
packed (B, T, 3C).  Parameters are in torch shapes: conv kernels
(O, I, kh, kw), linear weights (O, I).  A conv reaches `F.conv2d` through the
`permute(0, 3, 1, 2)` view of the NHWC tensor, which is a channels_last NCHW
tensor, so nothing is copied.

`group_norm_silu` and `qkv_attention` are the two ops the JAX package has
Pallas kernels for.  Here they ARE the hand-written CUDA kernels
(ops/kernels/), forward and backward, whenever the tensor lies on a GPU,
through the autograd Functions `GroupNormAct` and `QKVAttention`; there is
no mode switch.  Convolutions and linears go to cuDNN and cuBLAS, as the JAX
package leaves them to XLA, and their gradients to autograd.

Given a spatial `shard` (`parallel.tensor.Shard`: this rank holds its
slice of the height, `parallel/spatial.py`), a 3x3 convolution reads its
neighbours' edge rows, a GroupNorm takes its statistics over the whole
sample (the split kernels) and attention attends over every row; over one
rank, or without a shard, each is the one-device op.

float32 precision: `set_f32_precision("highest")` turns TF32 off for both
matmuls and cuDNN convolutions (PyTorch leaves it on for convolutions by
default); "high" turns both on.  As in the JAX package, "highest" is the
default: it is set when this module is imported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from unet_tpu_torch.ops.kernels.attention import QKVAttention
from unet_tpu_torch.ops.kernels.groupnorm import GroupNormAct
from unet_tpu_torch.parallel import spatial


def set_f32_precision(name: str) -> None:
    """Arithmetic of float32 matmuls and convolutions on the GPU: "highest"
    (full float32, the parity default) or "high" (TF32 on the tensor cores,
    about three decimal digits).  Sets both the matmul and the cuDNN flag."""
    if name not in ("highest", "high"):
        raise ValueError(f"unknown float32 precision {name!r}")
    tf32 = name == "high"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


set_f32_precision("highest")


def silu(x):
    """x * sigmoid(x)."""
    return x * torch.sigmoid(x)


def linear(x, w, b):
    """x @ w.T + b with w (O, I)."""
    return F.linear(x, w, b)


def _split(shard) -> bool:
    return shard is not None and shard.size > 1


def conv2d(x, w, b, shard=None):
    """SAME convolution of an NHWC tensor with an (O, I, kh, kw) kernel
    (3x3 and 1x1 in this model), stride 1.  Returns NHWC, contiguous.
    With a spatial `shard` a 3x3 convolution reads the neighbours' edge
    rows (`spatial.halo_rows`) and pads only the width; a 1x1 never
    exchanges."""
    pad = (w.shape[2] // 2, w.shape[3] // 2)
    if _split(shard) and pad[0]:
        x, pad = spatial.halo_rows(x, shard), (0, pad[1])
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def group_norm_silu(x, gamma, beta, *, num_groups=32, eps=1e-5,
                    act: str = "silu", shard=None):
    """GroupNorm over (H, W, C//G) per group, then SiLU (act="silu") or
    nothing (act="none").  float32 statistics, two-pass variance for every
    input type, as the JAX package's kernel.  With a spatial `shard` the
    statistics are the whole sample's (`spatial.group_norm_act`)."""
    if _split(shard):
        return spatial.group_norm_act(x, gamma, beta, num_groups, eps, act,
                                      shard)
    return GroupNormAct.apply(x, gamma, beta, num_groups, eps, act)


def group_norm(x, gamma, beta, *, num_groups=32, eps=1e-5):
    """GroupNorm without activation."""
    return group_norm_silu(x, gamma, beta, num_groups=num_groups, eps=eps,
                           act="none")


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample, NHWC."""
    B, H, W, C = x.shape
    x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
    return x.reshape(B, 2 * H, 2 * W, C)


def avg_pool_2x(x):
    """2x2 stride-2 average pool, NHWC."""
    B, H, W, C = x.shape
    return x.reshape(B, H // 2, 2, W // 2, 2, C).mean(dim=(2, 4))


def timestep_embedding(t, dim, *, max_period=1000):
    """Sinusoidal embedding [cos(t f) | sin(t f)], f_j = exp(-ln(P) j / half).

    t: (B,) float or int timesteps.  Returns (B, dim), float32 unless t is
    float64; an odd `dim` pads a zero column.  PyTorch's sin and cos reduce
    large arguments properly on the CPU and the GPU, so they are called
    directly (the JAX package has to reduce the range itself)."""
    half = dim // 2
    dt = (torch.promote_types(t.dtype, torch.float32)
          if t.is_floating_point() else torch.float32)
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=dt, device=t.device) / half)
    args = t.to(dt)[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def qkv_attention(qkv, num_heads, shard=None):
    """Non-causal multi-head attention with the guided-diffusion "new
    attention order" head split.

    qkv: (B, T, 3C), channels laid out [q(C) | k(C) | v(C)], each C split
    contiguously into (NH, HS).  Returns (B, T, C).  The scale 1/sqrt(HS) is
    applied to q before the dot; the softmax runs in float32.  With a
    spatial `shard`, qkv is this rank's T/N rows and they attend over every
    rank's (`spatial.qkv_attention`)."""
    if _split(shard):
        return spatial.qkv_attention(qkv, num_heads, shard)
    return QKVAttention.apply(qkv, num_heads)


def mse_loss(pred, target):
    """mean((pred - target)^2) over all elements, in float32 (float64 for
    float64 input) whatever the inputs' type."""
    acc = torch.promote_types(pred.dtype, torch.float32)
    return (pred.to(acc) - target.to(acc)).square().mean()
