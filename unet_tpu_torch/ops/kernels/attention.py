"""Attention forward: the CUDA kernel's wrapper and its plain version.

Counterpart of unet_tpu/ops/pallas/attention.py.  `qkv_attention_fwd`
replaces the Pallas forward kernel there (`_fwd_kernel`, launched by
`_fwd_call`, reached through `qkv_attention_fused`) with csrc/attention.cu:
non-causal multi-head attention straight from the packed (B, T, 3C) QKV
tensor, [q | k | v] with each C split contiguously into (NH, HS).

What bounds it on an H100: `4 * B*T*C * itemsize` bytes of traffic and
`4 * B*NH*T*T*HS` operations; at HS = 32 the operations win above a few
hundred tokens.  The kernel keeps one query per thread in registers, passes
the head's keys and values through shared memory in tiles and runs an
online softmax over them, so the (B, NH, T, T) scores never reach device
memory and any T is taken (the ragged tile is masked).  Its products are
float32 FMAs for now; tensor-core products are a later change.

The backward kernel of the JAX file (`_bwd_kernel`) is not ported yet, so
the wrapper refuses an input that requires grad.
"""

from __future__ import annotations

import ctypes
import math

import torch

from unet_tpu_torch.ops.kernels import _build

HEAD_SIZE = 32  # the head size csrc/attention.cu is compiled for


def qkv_attention_plain(qkv, num_heads):
    """Plain PyTorch version with the kernel's rounding points: q * scale
    rounded to the input type before the score product, scores and softmax
    in float32 (float64 for float64 input), the weights rounded to the
    input type before the value product, which accumulates in float32."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    HS = C // num_heads
    acc = torch.promote_types(qkv.dtype, torch.float32)
    q, k, v = (a.reshape(B, T, num_heads, HS) for a in qkv.split(C, dim=-1))
    qs = q * (1.0 / math.sqrt(HS))
    scores = torch.einsum("bthd,bshd->bhts", qs.to(acc), k.to(acc))
    weights = torch.softmax(scores, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhts,bshd->bthd", weights.to(acc), v.to(acc))
    return out.to(qkv.dtype).reshape(B, T, C)


def _check(qkv, num_heads):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, T, 3C), got {tuple(qkv.shape)}")
    C = qkv.shape[-1] // 3
    if num_heads <= 0 or C % num_heads:
        raise ValueError(f"C={C} does not split into {num_heads} heads")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError(
            "qkv_attention_fwd has no backward yet: call it under "
            "torch.no_grad() or with an input that does not require grad")


def qkv_attention_fwd(qkv, num_heads):
    """Multi-head attention over qkv (B, T, 3C) -> (B, T, C).

    A CUDA tensor goes to the hand-written kernel (float32 or bfloat16,
    contiguous, head size 32) or raises; only a CPU tensor takes the plain
    version."""
    _check(qkv, num_heads)
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"the kernel takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    B, T, C3 = qkv.shape
    C = C3 // 3
    if C // num_heads != HEAD_SIZE:
        raise ValueError(f"the kernel takes head size {HEAD_SIZE}, got "
                         f"{C // num_heads} (C={C}, {num_heads} heads)")
    if B == 0 or T == 0:
        raise ValueError(f"empty input {tuple(qkv.shape)}")
    if B > 65535 or num_heads > 65535:
        raise ValueError(f"the kernel does not take B={B}, NH={num_heads}")
    out = torch.empty((B, T, C), dtype=qkv.dtype, device=qkv.device)
    if qkv.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    fn = _launcher()
    with torch.cuda.device(qkv.device):
        code = fn(qkv.data_ptr(), out.data_ptr(), B, T, C, num_heads,
                  1.0 / math.sqrt(HEAD_SIZE),
                  int(qkv.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "qkv_attention_fwd")
    qkv_attention_fwd.launches += 1
    return out


# Launches of the kernel since the count was last set to 0.
qkv_attention_fwd.launches = 0


def _launcher():
    fn = _build.load().unet_qkv_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return fn
