"""The arithmetic of the float32 attention kernels and of the float32
convolution, emulated on the CPU.

csrc/attention.cu computes every float32 product of K1 and K2 on the TF32
tensor cores as three products (3xTF32), and csrc/conv3x3.cu those of K7's
"tf32" route: each operand x is split into
hi = tf32(x) and lo = tf32(x - hi), rounded to nearest with ties away from
zero as `cvt.rna.tf32.f32` rounds, and a b is taken as a_hi b_lo + a_lo b_hi
+ a_hi b_hi (common.cuh: `cvt_tf32`, `split_tf32`, `mma_3xtf32`).  Here
that arithmetic is written out in PyTorch (the rounding by bit arithmetic,
the products exact in float32 and summed in float32) and the attention
forward and backward are built from it at the kernels' rounding points.
So is the convolution, stage by stage as the kernel sums it.  They are
held against the plain versions, the kernels' float32 reference,
at the repo's float32 bar (2e-5 absolute, chip_smoke.py `F32_TOL`): three
products keep it, one TF32 product does not, so the bar decides between
the two.  Nothing on the port's path uses this emulation; the kernels
themselves are held against the plain versions on the card by
chip_smoke.py.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch

import torch.nn.functional as F

from unet_tpu_torch.ops.kernels.attention import (qkv_attention_bwd_plain,
                                                   qkv_attention_plain)
from unet_tpu_torch.ops.kernels.conv3x3 import conv3x3_hwbc_plain

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32_ATOL = 2e-5
CONV_STAGE = 32  # channels of one stage of the "tf32" convolution (TF_BK)


def tf32(x):
    """x (float32) rounded to TF32: half a TF32 step added to the magnitude
    of the bits, then the low 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    """a @ b (batched) as the kernels take it: three products of TF32
    operands, each exact in float32 and summed in float32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return ah @ bl + al @ bh + ah @ bh


def mm_tf32(a, b):
    """a @ b from one product of the operands rounded to TF32."""
    return tf32(a) @ tf32(b)


def heads(qkv, num_heads):
    B, T, C3 = qkv.shape
    C = C3 // 3
    return [a.reshape(B, T, num_heads, C // num_heads).transpose(1, 2)
            for a in qkv.split(C, dim=-1)]


def attention_fwd(qkv, num_heads, mm):
    """The forward at the kernel's rounding points: qs = q * scale in
    float32, s = qs k^T, a float32 softmax, out = p v."""
    q, k, v = heads(qkv, num_heads)
    qs = q * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.softmax(mm(qs, k.transpose(-1, -2)), dim=-1)
    out = mm(p, v)
    return out.transpose(1, 2).reshape(qkv.shape[0], qkv.shape[1], -1)


def attention_bwd(qkv, dout, num_heads, mm):
    """The backward at the kernels' rounding points: p recomputed, dp =
    dout v^T, ds = p (dp - rowsum(dp p)) in float32, dq = (ds k) * scale,
    dk = ds^T qs, dv = p^T dout."""
    B, T, _ = qkv.shape
    q, k, v = heads(qkv, num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qs = q * scale
    do = dout.reshape(B, T, num_heads, -1).transpose(1, 2)
    p = torch.softmax(mm(qs, k.transpose(-1, -2)), dim=-1)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    grads = (mm(ds, k) * scale, mm(ds.transpose(-1, -2), qs),
             mm(p.transpose(-1, -2), do))
    return torch.cat([g.transpose(1, 2).reshape(B, T, -1) for g in grads],
                     dim=-1)


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    step = 2.0 ** -10  # a TF32 step at 1
    x = torch.tensor([1 + step / 2, -(1 + step / 2), 1 + step / 2 - 2.0 ** -23,
                      1 + 3 * step / 2, 1 + step, -3.0, 0.0, 2.0 ** -130],
                     dtype=torch.float32)
    want = [1 + step, -(1 + step), 1.0, 1 + 2 * step, 1 + step, -3.0, 0.0,
            2.0 ** -130]
    assert tf32(x).tolist() == want
    hi, lo = split(torch.tensor([math.pi, -math.e], dtype=torch.float32))
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    exact = torch.tensor([math.pi, -math.e], dtype=torch.float64)
    assert ((hi.double() + lo.double() - exact).abs()
            <= 2.0 ** -22 * exact.abs()).all()


def test_the_kernels_round_as_the_emulation():
    source = (ROOT / "unet_tpu_torch/csrc/common.cuh").read_text()
    body = re.search(r"uint32_t cvt_tf32\(float x\) \{(.*?)\n\}", source,
                     re.S).group(1)
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in body
    assert "lo = cvt_tf32(x - __uint_as_float(hi));" in source


@pytest.mark.parametrize("num_heads", [6, 3], ids=["HS32", "HS64"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_three_tf32_products_keep_the_float32_bar_and_one_does_not(
        direction, num_heads):
    rng = np.random.default_rng(7)
    B, T, C = 2, 256, 192
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * C), np.float32))
    if direction == "fwd":
        want = qkv_attention_plain(qkv, num_heads)
        three = attention_fwd(qkv, num_heads, mm_3xtf32)
        one = attention_fwd(qkv, num_heads, mm_tf32)
    else:
        dout = torch.from_numpy(rng.standard_normal((B, T, C), np.float32))
        want = qkv_attention_bwd_plain(qkv, dout, num_heads)
        three = attention_bwd(qkv, dout, num_heads, mm_3xtf32)
        one = attention_bwd(qkv, dout, num_heads, mm_tf32)
    assert three.shape == one.shape == want.shape
    torch.testing.assert_close(three, want, atol=F32_ATOL, rtol=0)
    assert (one - want).abs().max().item() > F32_ATOL


def _launches(text):
    return set(re.findall(r"(\w+_kernel)<HS><<<", text))


def test_float32_launches_only_the_tf32_kernels():
    """Every attention kernel is a tensor-core kernel (`*_mma_kernel` for
    bfloat16, `*_tf32_kernel` for float32), and the float32 branch of each
    launcher reaches only the float32 ones, as `route` says."""
    from unet_tpu_torch.ops.kernels import attention as port_attn
    source = (ROOT / "unet_tpu_torch/csrc/attention.cu").read_text()
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s+(\w+)\(",
                         source)
    assert len(kernels) == 6
    assert all(k.endswith(("_mma_kernel", "_tf32_kernel")) for k in kernels)
    for name in ("unet_qkv_attention_fwd", "unet_qkv_attention_bwd"):
        body = source[source.index(f'extern "C" int {name}('):]
        body = body[:body.index("\n}\n")]
        bf16, f32 = body.split("} else {")
        assert _launches(bf16) and all(k.endswith("_mma_kernel")
                                       for k in _launches(bf16))
        assert _launches(f32) and all(k.endswith("_tf32_kernel")
                                      for k in _launches(f32))
    assert port_attn.route(torch.float32) == "3xtf32"
    assert port_attn.route(torch.bfloat16) == "bf16"


def conv3x3_stages(x, w, b, mm):
    """The convolution of x (H, W, B, C) with w (3, 3, C, O) plus b at the
    "tf32" kernel's rounding points: the accumulator starts at the bias;
    for each tap, then each stage of CONV_STAGE channels, the stage's
    products are summed apart (`mm` of the shifted rows and the weights'
    rows) and that partial is added to the accumulator in float32."""
    H, W, B, C = x.shape
    xp = F.pad(x, (0, 0, 0, 0, 1, 1, 1, 1))  # one zero pixel around H, W
    acc = b.float().expand(H * W * B, w.shape[3]).clone()
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        rows = xp[dy:dy + H, dx:dx + W].reshape(-1, C)
        for c0 in range(0, C, CONV_STAGE):
            acc = acc + mm(rows[:, c0:c0 + CONV_STAGE],
                           w[dy, dx, c0:c0 + CONV_STAGE])
    return acc.reshape(H, W, B, -1)


@pytest.mark.parametrize("C", [192, 320])
def test_three_tf32_products_keep_the_float32_bar_in_the_convolution(C):
    """At the widest inputs of the U-Net's convolutions (C = 192 at 64x64,
    320 at 32x32; K = 9C products an output) the stage partials in 3xTF32
    stay within the bar of the float64 plain version, one TF32 product a
    term does not."""
    rng = np.random.default_rng(11)
    H, W, B, O = 4, 4, 2, 8
    x = torch.from_numpy(rng.standard_normal((H, W, B, C), np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, C, O), np.float32)
                         * np.float32(0.05))
    b = torch.from_numpy(rng.standard_normal(O, np.float32))
    want = conv3x3_hwbc_plain(x, w, b)
    three = conv3x3_stages(x, w, b, mm_3xtf32)
    one = conv3x3_stages(x, w, b, mm_tf32)
    assert three.shape == one.shape == want.shape
    torch.testing.assert_close(three, want, atol=F32_ATOL, rtol=0)
    assert (one - want).abs().max().item() > F32_ATOL


def test_the_float32_convolution_uses_the_shared_3xtf32_blocks():
    """conv3x3.cu's float32 tensor-core kernel splits and multiplies with
    common.cuh's `split_tf32` and `mma_3xtf32` (no copy of them), in stages
    of CONV_STAGE channels, and its launcher sends float32 there."""
    source = (ROOT / "unet_tpu_torch/csrc/conv3x3.cu").read_text()
    assert '#include "common.cuh"' in source
    assert not re.search(r"\b(?:void|uint32_t)\s+(?:split_tf32|mma_3xtf32|"
                         r"mma_tf32|cvt_tf32)\s*\(", source)
    start = source.index("conv3x3_hwbc_tf32_kernel(")
    body = source[start:source.index("\n}\n", start)]
    assert "split_tf32(" in body and "mma_3xtf32(" in body
    assert re.search(r"constexpr int TF_BK = (\d+);", source)[1] == str(
        CONV_STAGE)
    assert "return is_bf16 ? Route::wgmma : Route::tf32;" in source
