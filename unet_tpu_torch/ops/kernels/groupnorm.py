"""GroupNorm(+SiLU), forward and backward: the CUDA kernels' wrappers, their
plain versions, and the autograd Function that joins the two.

Counterpart of unet_tpu/ops/pallas/groupnorm.py.  `gn_act_fwd` replaces the
Pallas forward kernel there (`_fwd_kernel`, launched by `_fwd_call`, reached
through `group_norm_act`) and `gn_act_bwd` the backward kernel
(`_bwd_kernel`, launched by `_bwd_call`, reached through `_gn_bwd`), both
with csrc/groupnorm.cu; `GroupNormAct` is the counterpart of the
`custom_vjp` `group_norm_act`.

What bounds it on an H100 is memory traffic: x is read and y written once,
`2 * B*H*W*C * itemsize` bytes, against a few operations per element.  The
design therefore reads whole NHWC rows with neighbouring threads (a thread
owns one group within one row), cuts a batch element's rows into chunks so
that enough blocks are in flight, and reduces in two stages (per-chunk mean
and sum of squared differences, combined by the parallel-variance formula),
because blocks run in no order.  The backward reads x and dy and writes dx
once more, with the same chunks and the same two stages (per-chunk sums per
channel, then dx).  See the source for details.
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


def _check_cuda(x, gamma, beta):
    """What the kernels take beyond `_check`: float32 or bfloat16 on a
    CUDA device, gamma and beta of x's type, all contiguous."""
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
    fn = _launcher("unet_gn_act_fwd")
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
    B, H, W, C = x.shape
    G = num_groups
    stat_dt = torch.promote_types(x.dtype, torch.float32)
    xg = x.reshape(B, H * W, G, C // G).to(stat_dt)
    mean_c = mean.to(stat_dt)[:, None, :, None]
    rstd_c = rstd.to(stat_dt)[:, None, :, None]
    xhat = ((xg - mean_c) * rstd_c).reshape(B, H * W, C)
    g, b = gamma.to(stat_dt), beta.to(stat_dt)
    dz = dy.reshape(B, H * W, C).to(stat_dt)
    if act == "silu":
        z = xhat * g + b
        sig = torch.sigmoid(z)
        dz = dz * (sig * (1.0 + z * (1.0 - sig)))
    dbeta_b = dz.sum(dim=1)
    dgamma_b = (dz * xhat).sum(dim=1)
    n = H * W * (C // G)
    t1 = ((dbeta_b * g).reshape(B, G, C // G).sum(-1) / n)[:, None, :, None]
    t2 = ((dgamma_b * g).reshape(B, G, C // G).sum(-1) / n)[:, None, :, None]
    dx = rstd_c * ((dz * g).reshape(B, H * W, G, C // G) - t1
                   - xhat.reshape(B, H * W, G, C // G) * t2)
    return dx.reshape(B, H, W, C).to(x.dtype), dgamma_b, dbeta_b


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
    if B > 65535:
        raise ValueError(f"the kernel does not take B={B}")
    mean, rstd = mean.contiguous(), rstd.contiguous()
    nchunks, rows_per_chunk = chunking(B, H * W)
    dx = torch.empty_like(x)
    dgamma_b = torch.empty((B, C), dtype=torch.float32, device=x.device)
    dbeta_b = torch.empty((B, C), dtype=torch.float32, device=x.device)
    # Scratch between the two stages (see `gn_act_fwd` on its lifetime).
    partials = torch.empty((B, nchunks, 2, C), dtype=torch.float32,
                           device=x.device)
    if x.data_ptr() % 16 or dy.data_ptr() % 16 or dx.data_ptr() % 16:
        raise ValueError("x and dy must be 16-byte aligned")
    fn = _launcher("unet_gn_act_bwd")
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), dgamma_b.data_ptr(), dbeta_b.data_ptr(),
                  partials.data_ptr(), B, H * W, C, G, int(act == "silu"),
                  int(x.dtype == torch.bfloat16), nchunks, rows_per_chunk,
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


_ARGTYPES = {
    "unet_gn_act_fwd": "ppppppp" "iiii" "f" "iiii" "p",
    "unet_gn_act_bwd": "pppppppppp" "iiii" "iiii" "p",
}


def _launcher(name):
    fn = getattr(_build.load(), name)
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "f": ctypes.c_float}
        fn.argtypes = [kinds[k] for k in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
    return fn
