"""Per-block-type timing: resblocks against attention (port of
scripts/block_timing.py).

    python -m unet_tpu_torch.scripts.block_timing [--image_size 64] \
        [--dtype bfloat16] [--batch 32] [--reps 40] [--backward] \
        [--device cuda]

The reference threads res/attn timers through its dev forward/backward walk
and prints a two-bucket split (dev/unet_test.cu:2090-2103).  As in the JAX
script the split is measured differentially: the model `UnetConfig(
image_size=S)` against the same plan without attention (`attention_ds=()`),
whose convolution and ResBlock topology is identical; the difference is the
attention bucket.

The forward runs the model cast to the compute type once (as the samplers
do); the forward + backward is the gradient of the MSE loss through
`models.unet.apply` (as the trainer computes it).  Each is timed on the
host's clock (`utils.benchmark.benchmark`).  On the card an eager forward
of this model is host-bound (the card idles most of the time), so the
wall-clock split is mostly a split of the host's launch work; beside it
stands a split of the device's own time: for the forward the replay of a
CUDA graph of calls, for the forward + backward the sum of the device
kernels' times in a `torch.profiler` trace (`utils.profile_forward`).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys

import numpy as np
import torch

from unet_tpu_torch.config import UnetConfig
from unet_tpu_torch.models import unet
from unet_tpu_torch.ops import functional
from unet_tpu_torch.utils.benchmark import benchmark, device_line, graph_ms
from unet_tpu_torch.utils.profile_forward import kernel_families

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _call(model, dtype, backward):
    """fn(x, t): one forward, or the parameters' gradients of one loss."""
    if backward:
        params = list(model.parameters())

        def grads(x, t):
            out = unet.apply(model, x, t, compute_dtype=dtype)
            return torch.autograd.grad(functional.mse_loss(out, x), params)

        return grads
    net = model.to_compute(dtype)

    def forward(x, t):
        with torch.no_grad():
            return net(x, t)

    return forward


def measure_split(cfg: UnetConfig, *, batch=32, dtype=torch.bfloat16,
                  backward=False, reps=40, device="cuda", seed=0) -> dict:
    """The split of one forward (or forward + backward) of `cfg` into its
    attention-free plan and attention, in ms.  Weights from `seed`, four
    input batches in rotation, t = 0.  Returns {"full_ms",
    "attention_free_ms", "attention_ms", "attention_share"} on the host's
    clock, and on a CUDA device the same under "device_alone"."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    S = cfg.image_size
    batches = [torch.from_numpy(
        rng.standard_normal((batch, S, S, cfg.in_channels)).astype(np.float32)
        * np.float32(0.5)).to(device) for _ in range(4)]
    t = torch.zeros(batch, device=device)
    wall, alone = {}, {}
    for label, c in (("full", cfg),
                     ("attention_free", dataclasses.replace(cfg,
                                                            attention_ds=()))):
        model = unet.init(c, generator=torch.Generator().manual_seed(seed),
                          device=device)
        fn = _call(model, dtype, backward)
        r = benchmark(fn, reps=reps, rotate=[(x, t) for x in batches])
        wall[label] = r["mean_ms"]
        print(f"  {label}: {r['mean_ms']:.2f} ms (± {r['std_ms']:.2f})",
              file=sys.stderr)
        if device.type == "cuda":
            xs = itertools.cycle(batches)
            if backward:
                alone[label] = kernel_families(lambda: fn(next(xs), t),
                                               reps)["total_ms"]
            else:
                alone[label] = graph_ms(lambda: fn(next(xs), t), reps)
        del model, fn

    def split(ms):
        full, free = ms["full"], ms["attention_free"]
        return {"full_ms": full, "attention_free_ms": free,
                "attention_ms": full - free,
                "attention_share": (full - free) / full}

    result = {"image_size": S, "batch": batch, "dtype": str(dtype),
              "pass": "fwd+bwd" if backward else "forward", **split(wall)}
    if alone:
        result["device_alone"] = dict(
            split(alone), how=("profiler device total" if backward
                               else "CUDA graph replay"))
    return result


def run(argv=None) -> list:
    """Prints the split of each pass and returns the `measure_split`
    results."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--reps", type=int, default=40)
    p.add_argument("--backward", action="store_true",
                   help="also split the forward + backward")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(device_line(args.device))
    cfg = UnetConfig(image_size=args.image_size)
    results = []
    for backward in (False, True) if args.backward else (False,):
        r = measure_split(cfg, batch=args.batch, dtype=DTYPES[args.dtype],
                          backward=backward, reps=args.reps,
                          device=args.device)
        head = (f"{r['pass']} @ {r['image_size']}x{r['image_size']} "
                f"B={r['batch']} {args.dtype}")
        print(f"{head}: unet {r['full_ms']:.2f} ms = resblocks(+head) "
              f"{r['attention_free_ms']:.2f} + attention "
              f"{r['attention_ms']:.2f} ms "
              f"({100 * r['attention_share']:.1f}%)")
        if "device_alone" in r:
            d = r["device_alone"]
            print(f"{head}, device alone ({d['how']}): unet "
                  f"{d['full_ms']:.2f} ms = resblocks(+head) "
                  f"{d['attention_free_ms']:.2f} + attention "
                  f"{d['attention_ms']:.2f} ms "
                  f"({100 * d['attention_share']:.1f}%)")
        results.append(r)
    return results


if __name__ == "__main__":
    run()
