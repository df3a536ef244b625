"""GroupNorm(+SiLU) forward: the CUDA kernel's wrapper and its plain version.

Counterpart of unet_tpu/ops/pallas/groupnorm.py.  `gn_act_fwd` replaces the
Pallas forward kernel there (`_fwd_kernel`, launched by `_fwd_call`, reached
through `group_norm_act`) with csrc/groupnorm.cu.

What bounds it on an H100 is memory traffic: x is read and y written once,
`2 * B*H*W*C * itemsize` bytes, against a few operations per element.  The
design therefore reads whole NHWC rows with neighbouring threads (a thread
owns one group within one row), cuts a batch element's rows into chunks so
that enough blocks are in flight, and reduces in two stages (per-chunk mean
and sum of squared differences, combined by the parallel-variance formula),
because blocks run in no order.  See the source for details.

The backward kernel of the JAX file (`_bwd_kernel`) is not ported yet, so
the wrapper refuses inputs that require grad.
"""

from __future__ import annotations

import ctypes

import torch

from unet_tpu_torch.ops.kernels import _build

# Blocks wanted in flight (about two per SM of an H100) and the fewest rows
# worth a block of their own.
_TARGET_BLOCKS = 264
_MIN_ROWS_PER_CHUNK = 8
_SMEM_LIMIT = 48 * 1024


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
    z = (xc * rstd[:, None, :, None]).reshape(B, H, W, C)
    z = z * gamma.to(stat_dt) + beta.to(stat_dt)
    if act == "silu":
        z = z * torch.sigmoid(z)
    return z.to(x.dtype), mean, rstd


def chunking(batch: int, rows: int):
    """(nchunks, rows_per_chunk): how the H*W rows of one batch element are
    cut into blocks so that about `_TARGET_BLOCKS` run at once and none is
    empty."""
    want = max(1, -(-_TARGET_BLOCKS // batch))
    most = max(1, rows // _MIN_ROWS_PER_CHUNK)
    rows_per_chunk = -(-rows // min(want, most))
    return -(-rows // rows_per_chunk), rows_per_chunk


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
    if torch.is_grad_enabled() and (
            x.requires_grad or gamma.requires_grad or beta.requires_grad):
        raise RuntimeError(
            "gn_act_fwd has no backward yet: call it under torch.no_grad() "
            "or with inputs that do not require grad")


def gn_act_fwd(x, gamma, beta, num_groups=32, eps=1e-5, act="silu"):
    """GroupNorm + optional SiLU on x (B, H, W, C).  Returns (y, mean, rstd):
    y in x's type, mean and rstd (B, G) float32.

    A CUDA tensor goes to the hand-written kernel (float32 or bfloat16,
    contiguous, gamma and beta of x's type) or raises; only a CPU tensor
    takes the plain version."""
    _check(x, gamma, beta, num_groups, act)
    if x.device.type == "cpu":
        return gn_act_fwd_plain(x, gamma, beta, num_groups, eps, act)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    if gamma.dtype != x.dtype or beta.dtype != x.dtype:
        raise TypeError(f"gamma and beta must have x's type {x.dtype}, got "
                        f"{gamma.dtype}, {beta.dtype}")
    if not (x.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous()):
        raise ValueError("x, gamma and beta must be contiguous")
    B, H, W, C = x.shape
    G = num_groups
    if B == 0 or H * W == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if G > 1024 or B > 65535 or (2 * G + 2 * C) * 4 > _SMEM_LIMIT:
        raise ValueError(f"the kernel does not take B={B}, C={C}, G={G}")
    nchunks, rows_per_chunk = chunking(B, H * W)
    y = torch.empty_like(x)
    mean = torch.empty((B, G), dtype=torch.float32, device=x.device)
    rstd = torch.empty((B, G), dtype=torch.float32, device=x.device)
    # Scratch between the two stages.  It is dropped on return while the
    # kernels may still run: the allocator hands a freed block only to later
    # work of the same stream, which is ordered after them.
    partials = torch.empty((B, nchunks, G, 2), dtype=torch.float32,
                           device=x.device)
    if x.data_ptr() % 16 or y.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    fn = _launcher()
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                  partials.data_ptr(), B, H * W, C, G, eps,
                  int(act == "silu"), int(x.dtype == torch.bfloat16),
                  nchunks, rows_per_chunk,
                  torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "gn_act_fwd")
    gn_act_fwd.launches += 1
    return y, mean, rstd


# Launches of the kernel since the count was last set to 0.
gn_act_fwd.launches = 0


def _launcher():
    fn = _build.load().unet_gn_act_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float,
                       i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn
