"""Per-op and per-block micro-benchmarks of the port (port of
scripts/bench_ops.py).

    python -m unet_tpu_torch.scripts.bench_ops [--dtype bfloat16] \
        [--reps 50] [--batch 32] [--device cuda]

The analog of the reference's dev/<op>.cu benchmark mains, at its shapes
(its headline convolution is 3x3, C_in = 192 -> C_out = 64 at 64x64),
through the port's own `ops.functional` and `models.blocks`: the cuDNN
convolution forward and forward + backward, GroupNorm + SiLU (the
`gn_act_fwd` kernel), the attention block, the attention core at T = 1024
(the `qkv_attention_fwd` / `qkv_attention_bwd` kernels beside their plain
versions and `scaled_dot_product_attention`), and a ResBlock.  Each line is
`utils.benchmark.benchmark` (host clock to a synchronize, four input copies
in rotation), so on the card a line is the larger of the host's and the
device's time per call.  The first line printed names the card and its
power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as TF

from unet_tpu_torch.models import blocks
from unet_tpu_torch.ops import functional as F
from unet_tpu_torch.ops.kernels.attention import qkv_attention_plain
from unet_tpu_torch.utils.benchmark import benchmark, device_line

N_ROT = 4  # input copies in rotation: every timed rep reads another batch
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def run(argv=None) -> dict:
    """Prints one line per op and returns {"device", "dtype", "batch",
    "ops": {name: benchmark result}}."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--reps", type=int, default=50)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    dt = DTYPES[args.dtype]
    rng = np.random.default_rng(0)
    B, reps = args.batch, args.reps
    gen = torch.Generator().manual_seed(0)

    def t(*shape, grad=False):
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return a.to(device=device, dtype=dt).requires_grad_(grad)

    result = {"device": device_line(device), "dtype": args.dtype, "batch": B,
              "ops": {}}
    print(f"{result['device']} dtype={args.dtype} B={B}")

    def line(name, fn, rotate, n=reps):
        r = benchmark(fn, reps=n, rotate=rotate)
        result["ops"][name] = r
        print(f"{name}: {r['mean_ms']:.3f} ms (± {r['std_ms']:.3f})")

    # conv3x3 192->64 @64x64, the reference's headline kernel shape
    xs = [t(B, 64, 64, 192, grad=True) for _ in range(N_ROT)]
    w = (t(64, 192, 3, 3) * 0.05).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    b = t(64, grad=True)
    with torch.no_grad():
        line("conv3x3 192->64 @64x64 fwd", F.conv2d,
             [(x, w, b) for x in xs])

    def conv_grad(x, w, b):
        loss = F.conv2d(x, w, b).float().square().sum()
        return torch.autograd.grad(loss, (x, w, b))

    line("conv3x3 192->64 @64x64 fwd+bwd", conv_grad,
         [(x, w, b) for x in xs])
    del xs

    with torch.no_grad():
        # GroupNorm + SiLU at the largest slab
        xs = [t(B, 64, 64, 64) for _ in range(N_ROT)]
        g, be = torch.ones(64, dtype=dt, device=device), torch.zeros(
            64, dtype=dt, device=device)
        line("groupnorm+silu @64x64x64 fwd", F.group_norm_silu,
             [(x, g, be) for x in xs])

        # the attention block at the first attention resolution
        attn = blocks.AttentionBlock(192, head_size=32, generator=gen).to(
            device=device, dtype=dt)
        xs = [t(B, 16, 16, 192) for _ in range(N_ROT)]
        line("attention block @16x16x192 fwd", attn, [(x,) for x in xs])

    # The attention core at T = 1024 (32x32 spatial, C = 192, HS = 32):
    # the kernels (through the autograd Function), their plain versions, and
    # the library's fused attention, forward and forward + backward.
    T, C, NH = 1024, 192, 6
    qs = [t(B, T, 3 * C, grad=True) for _ in range(N_ROT)]
    dout = t(B, T, C)

    def sdpa(qkv, nh):
        q, k, v = (a.transpose(1, 2) for a in
                   qkv.view(B, T, 3, nh, C // nh).unbind(2))
        out = TF.scaled_dot_product_attention(q, k, v)
        return out.transpose(1, 2).reshape(B, T, C)

    for name, fn in (("kernel", F.qkv_attention),
                     ("plain", qkv_attention_plain), ("sdpa", sdpa)):
        with torch.no_grad():
            line(f"attention core T={T} C={C} {name} fwd", fn,
                 [(q, NH) for q in qs], min(reps, 20))

        def grad(q, nh, fn=fn):
            return torch.autograd.grad(fn(q, nh), q, dout)

        line(f"attention core T={T} C={C} {name} fwd+bwd", grad,
             [(q, NH) for q in qs], min(reps, 20))
    del qs

    with torch.no_grad():
        # ResBlock 64->64 @64x64
        res = blocks.ResBlock(64, 64, 256, generator=gen).to(device=device,
                                                             dtype=dt)
        xs = [t(B, 64, 64, 64) for _ in range(N_ROT)]
        emb = t(B, 256)
        line("resblock 64->64 @64x64 fwd", res, [(x, emb) for x in xs])
    return result


if __name__ == "__main__":
    run()
