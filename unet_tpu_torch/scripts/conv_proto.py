"""The implicit-GEMM 3x3 convolution on the (H, W, B, C) view: a check, and
with `--bench` its time at six U-Net shapes beside cuDNN's (port of
scripts/conv_proto.py).

    python -m unet_tpu_torch.scripts.conv_proto [--bench] [--device cuda]

The JAX script asked whether a Pallas kernel could beat XLA's convolutions
at the model's shapes, and recorded that it could not.  Here the kernel is
`ops.kernels.conv3x3.conv3x3_hwbc` (csrc/conv3x3.cu: an implicit GEMM, in
bfloat16 on the tensor cores with `wgmma` on tiles that `cp.async` stages,
in float32 on the TF32 tensor cores in 3xTF32, on FMAs where C or O is no
multiple of 8), and the yardstick is cuDNN through `F.conv2d`,
which the model itself uses.

The check: the kernel against its plain version on one (8, 8, 4, 64 -> 64)
float32 case, max abs error under 1e-4.  The bench: for each (C, O) pair,
H = W = 64 (32 above C = 192), B = 32, bfloat16, the kernel's error against
its plain version and the times (`utils.benchmark.benchmark`: host clock to
a synchronize, warm cache) of the kernel, of cuDNN alone (`F.conv2d` on the
channels_last (B, C, H, W) view of a (B, H, W, C) copy; on the CPU,
PyTorch's CPU convolution), of cuDNN with the two transposes between the
(H, W, B, C) view and its own layout (the JAX script's `xla(+2
transposes)`), and the least time the card could take.

What it measured on an NVIDIA H100 80GB HBM3 (power limit 700.00 W),
bfloat16: the kernel ran at 171-326 TF/s (0.057 ms at 64->64, 0.128 ms at
192->64), 0.78-1.20x the time of cuDNN alone (0.057-0.125 ms; less at
64->64, 64->128 and 128->128) and less than cuDNN with the two transposes
(0.104-0.215 ms) at all six shapes; the bound is 0.010-0.039 ms.  Every
shape is in PERF.md.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from unet_tpu_torch.ops.kernels.conv3x3 import conv3x3_hwbc, conv3x3_hwbc_plain
from unet_tpu_torch.utils.benchmark import benchmark, bound, device_line

# (C, O) pairs of the U-Net's 3x3 convolutions; C >= 128 occurs after
# downsampling.
SHAPES = [(64, 64), (192, 64), (128, 64), (64, 128), (128, 128), (320, 128)]
BATCH = 32
WARMUP = 2
REPS = 30


def bench_size(C: int) -> int:
    """H = W of the bench at input width C."""
    return 64 if C <= 192 else 32


def run(argv=None) -> dict:
    """Runs the check (and with `--bench` the bench), prints one line each,
    and returns {"device", "correctness", "bench"}.  Raises on a failed
    check."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bench", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    rng = np.random.default_rng(0)

    def tensor(shape, scale=1.0, dtype=torch.float32):
        a = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
        return torch.from_numpy(a).to(device).to(dtype)

    result = {"device": device_line(device)}
    print(result["device"])
    with torch.no_grad():
        H, W, B, C, O = 8, 8, 4, 64, 64
        x, w, b = tensor((H, W, B, C)), tensor((3, 3, C, O), 0.05), tensor(O)
        err = (conv3x3_hwbc(x, w, b) - conv3x3_hwbc_plain(x, w, b)
               ).abs().max().item()
        print(f"correctness (f32 {H}x{W}x{B}x{C}->{O}): max err {err:.2e}")
        if not err < 1e-4:
            raise AssertionError(f"conv3x3_hwbc: max err {err} against the "
                                 "plain version")
        result["correctness"] = {"shape": [H, W, B, C, O], "dtype": "float32",
                                 "max_abs_err": err}
        result["bench"] = [bench_shape(C, O, tensor)
                           for C, O in SHAPES] if args.bench else []
    return result


def bench_shape(C, O, tensor) -> dict:
    H = W = bench_size(C)
    B = BATCH
    bf16 = torch.bfloat16
    x = tensor((H, W, B, C), dtype=bf16)
    w = tensor((3, 3, C, O), 0.05, bf16)
    b = torch.zeros(O, dtype=bf16, device=x.device)
    err = (conv3x3_hwbc(x, w, b).float()
           - conv3x3_hwbc_plain(x, w, b).float()).abs().max().item()
    kernel = benchmark(conv3x3_hwbc, x, w, b, reps=REPS, warmup=WARMUP)

    w_oihw = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x_nchw = x.permute(2, 0, 1, 3).contiguous().permute(0, 3, 1, 2)
    library = benchmark(lambda: F.conv2d(x_nchw, w_oihw, b, padding=1),
                        reps=REPS, warmup=WARMUP)

    def with_transposes():
        xt = x.permute(2, 0, 1, 3).contiguous().permute(0, 3, 1, 2)
        y = F.conv2d(xt, w_oihw, b, padding=1)      # (B, O, H, W)
        return y.permute(2, 3, 0, 1).contiguous()   # (H, W, B, O)

    transposes = benchmark(with_transposes, reps=REPS, warmup=WARMUP)
    gflop = 2 * H * W * B * C * O * 9 / 1e9
    nbytes = (x.numel() + w.numel() + H * W * B * O) * 2 + O * 2
    bound_ms, bound_by = bound(nbytes, gflop * 1e9, bf16)
    row = dict(C=C, O=O, H=H, W=W, B=B, dtype="bfloat16", max_abs_err=err,
               kernel_ms=kernel["mean_ms"], kernel_std_ms=kernel["std_ms"],
               kernel_tflops=gflop / kernel["mean_ms"],
               library_ms=library["mean_ms"],
               library_with_transposes_ms=transposes["mean_ms"],
               bound_ms=bound_ms, bound_by=bound_by,
               kernel_calls=1 + WARMUP + kernel["reps"])
    print(f"C{C}->O{O} @ {H}x{W} B{B}: kernel {row['kernel_ms']:.3f} ms "
          f"({row['kernel_tflops']:.1f} TF/s) | F.conv2d {row['library_ms']:.3f}"
          f" ms | F.conv2d(+2 transposes) "
          f"{row['library_with_transposes_ms']:.3f}"
          f" ms | bound {bound_ms:.4f} ms ({bound_by}) | err {err:.2e}")
    return row


if __name__ == "__main__":
    run()
