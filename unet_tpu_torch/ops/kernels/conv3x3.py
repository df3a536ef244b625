"""3x3 SAME convolution on the (H, W, B, C) view: the CUDA kernel's wrapper
and its plain version.

Counterpart of scripts/conv_proto.py, the JAX package's experiment with an
implicit-GEMM convolution.  `conv3x3_hwbc` replaces the Pallas kernel there
(`_conv_kernel`, launched by `conv3x3_hwbc`) with csrc/conv3x3.cu: x (H, W,
B, C) convolved with w (3, 3, C, O) HWIO (the experiment's contract, not the
model's OIHW) plus b (O,), zero padding, stride 1, returned as (H, W, B, O)
in x's type.  The TPU kernel's row-chunk argument `TH` is a detail of its
grid and has no counterpart; any H is taken.

Like the JAX function, this one is not part of the model: `ops.functional`
convolves through cuDNN, and only the kernel-benchmark scripts
(`unet_tpu_torch.scripts`) call it.  The TPU kernel has no VJP, so neither
has this one: inputs that require grad are refused.

What bounds it on an H100: `2 * H*W*B * O * 9C` operations against about
`(|x| + |w| + |out|) * itemsize` bytes, so the operations at every shape of
the U-Net.  Three kernels share the launcher; `route` says which a call
takes (the launcher's `route` is the same rule).  bfloat16 with C and O
multiples of 8 runs on the tensor cores: `wgmma` (two warpgroups a block)
on bf16 tiles of 128 rows x 64 channels of the shifted input and 64 x 64
(or 128) of the weights, staged by 16-byte `cp.async` in the swizzled
layout `wgmma` reads through a ring of three stages, with the padding's rows
zero-filled by the copy.  float32 with C and O multiples of 8 runs on the
TF32 tensor cores in 3xTF32 (`mma.sync` on each operand's TF32 pair hi +
lo, a b = a_hi b_lo + a_lo b_hi + a_hi b_hi), on stages of one tap and 32
channels staged the same way, each stage's products summed apart and then
added to the accumulator.  A C or O that is not a multiple of 8 takes the
implicit GEMM with float32 FMAs, in either type.  The card's times of all
three are in PERF.md.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unet_tpu_torch.ops.kernels import _build


def conv3x3_hwbc_plain(x, w, b):
    """Plain PyTorch version with the kernel's rounding points: w rounded to
    x's type, the bias widened and summed with the products, the result
    rounded to x's type once.  The sum runs in float64, so that a comparison
    measures the kernel's own float32 sum: cuDNN's float32 convolution is
    2.3e-5 off a float64 sum at C = 192 (NVIDIA H100 80GB HBM3, 700 W),
    more than the 2e-5 bar the kernel is held to."""
    y = F.conv2d(x.permute(2, 3, 0, 1).double(),            # (B, C, H, W)
                 w.to(x.dtype).permute(3, 2, 0, 1).double(),  # (O, C, 3, 3)
                 b.double(), padding=1)
    return y.permute(2, 3, 0, 1).to(x.dtype).contiguous()   # (H, W, B, O)


def _check(x, w, b):
    if x.dim() != 4:
        raise ValueError(f"x must be (H, W, B, C), got {tuple(x.shape)}")
    C = x.shape[-1]
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be (3, 3, {C}, O), got {tuple(w.shape)}")
    if tuple(b.shape) != (w.shape[3],):
        raise ValueError(f"b must be ({w.shape[3]},), got {tuple(b.shape)}")
    if w.device != x.device or b.device != x.device:
        raise ValueError("x, w and b must lie on one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        raise RuntimeError(
            "conv3x3_hwbc has no backward: call it under torch.no_grad() or "
            "with inputs that do not require grad")


def _check_cuda(x):
    """What the kernel takes beyond `_check`."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if max(x.shape) >= 2 ** 31:
        raise ValueError(f"the kernel does not take {tuple(x.shape)}")


def route(dtype, C, O):
    """Which kernel a call of this type and widths takes: "wgmma" (bfloat16
    on the tensor cores), "tf32" (float32 on the TF32 tensor cores, in
    3xTF32), or "fma" (a C or O that is not a multiple of 8, in either type,
    on the float32 FMA kernel).  The launcher's rule (csrc/conv3x3.cu
    `route`): the tensor-core kernels need 16-byte rows of x and w."""
    if C % 8 or O % 8:
        return "fma"
    return "wgmma" if dtype == torch.bfloat16 else "tf32"


def conv3x3_hwbc(x, w, b):
    """3x3 SAME convolution of x (H, W, B, C) with w (3, 3, C, O) plus b
    (O,); returns (H, W, B, O) in x's type.  w is rounded to x's type and
    the bias widened to float32 before the products, as in the TPU kernel.

    A CUDA tensor goes to the hand-written kernels (x float32 or bfloat16,
    contiguous; on the tensor-core routes of `route` 16-byte aligned) or
    raises; only a CPU tensor takes the plain version."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return conv3x3_hwbc_plain(x, w, b)
    _check_cuda(x)
    H, W, B, C = x.shape
    O = w.shape[3]
    wk = w.to(x.dtype).contiguous()
    bk = b.float().contiguous()
    out = torch.empty((H, W, B, O), dtype=x.dtype, device=x.device)
    if route(x.dtype, C, O) != "fma" and (x.data_ptr() % 16
                                        or wk.data_ptr() % 16):
        raise ValueError("x and w must be 16-byte aligned")
    fn = _launcher()
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
                  H, W, B, C, O, int(x.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "conv3x3_hwbc")
    conv3x3_hwbc.launches += 1
    return out


# Launches of the kernel since the count was last set to 0.
conv3x3_hwbc.launches = 0


def _launcher():
    fn = _build.load().unet_conv3x3_hwbc
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn
