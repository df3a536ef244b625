"""Device time of one U-Net forward and of one train step by kernel family,
from `torch.profiler`.

    python -m unet_tpu_torch.utils.profile_forward [--batch_size 8] \
        [--train_batch_size 32] [--reps 5]

Runs the default ImageNet-64 model (random weights from a seed) on the CUDA
device in bfloat16 and in float32 ("highest": TF32 off), traces `reps`
forwards, then `reps` train steps (`trainer.make_train_step`'s `step_with`
on one fixed batch: forward, backward, AdamW), after warm-up, and prints one
JSON object for each: per type, the device milliseconds and the kernel
launches of one forward or step, summed by family.  It answers which kernels
the card spends its time in; the time the card waits for the host is not in
it.  No counterpart in the JAX package, whose profiles come from
`jax.profiler`.
"""

from __future__ import annotations

import argparse
import json

import torch

from unet_tpu_torch.config import TrainConfig, UnetConfig
from unet_tpu_torch.models import unet
from unet_tpu_torch.ops import functional
from unet_tpu_torch.training import trainer

# The first family whose marker occurs in a device kernel's name takes it.
FAMILIES = (
    ("gn_act_bwd", ("gn_act_bwd_kernel",)),
    ("gn_act_fwd", ("gn_act_fwd_kernel",)),
    ("qkv_attention_bwd", ("qkv_attention_bwd_dq_tf32_kernel",
                           "qkv_attention_bwd_dkv_tf32_kernel",
                           "qkv_attention_bwd_dq_mma_kernel",
                           "qkv_attention_bwd_dkv_mma_kernel")),
    ("qkv_attention_fwd", ("qkv_attention_fwd_tf32_kernel",
                           "qkv_attention_fwd_mma_kernel")),
    ("cudnn_layout_change", ("nhwcToNchw", "nchwToNhwc")),
    ("convolution_backward", ("dgrad", "wgrad", "convolveNd_wgrad",
                              "bprop")),
    ("convolution", ("fprop", "convolve", "cudnn", "conv")),
    ("matmul", ("gemm", "nvjet", "cublas", "gemv")),
    ("optimizer_and_ema", ("multi_tensor_apply", "foreach")),
    ("copy_and_concatenate", ("direct_copy", "CatArray")),
    ("elementwise_and_reduce", ("elementwise", "reduce_kernel")),
)


def kernel_families(fn, reps):
    """Device milliseconds and launches of one call of `fn` by kernel
    family, from a trace of `reps` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    families = {}
    for event in prof.key_averages():
        if event.device_type != DeviceType.CUDA:
            continue
        family = next((f for f, marks in FAMILIES
                       if any(m in event.key for m in marks)), "other")
        entry = families.setdefault(family, {"ms": 0.0, "launches": 0.0})
        entry["ms"] += event.device_time_total / reps / 1e3
        entry["launches"] += event.count / reps
    if not families:
        raise RuntimeError("the profiler recorded no device kernel")
    return dict(families, total_ms=sum(f["ms"] for f in families.values()),
                total_launches=sum(f["launches"] for f in families.values()))


def profile_forward(model, batch=8, reps=5, seed=0):
    """Device milliseconds and launches of one forward by kernel family,
    bfloat16 and float32, from a trace of `reps` forwards."""
    cfg = model.cfg
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, cfg.image_size, cfg.image_size, cfg.in_channels),
                    generator=gen, device=device)
    t = torch.full((batch,), 500.0, device=device)
    result = {"batch": batch, "forwards_traced": reps}
    for name, dtype in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        net = model.to_compute(dtype)
        with torch.no_grad():
            for _ in range(3):
                net(x, t)
            result[name] = kernel_families(lambda: net(x, t), reps)
    return result


def profile_train_step(model, batch=32, reps=5, seed=0):
    """Device milliseconds and launches of one train step (forward,
    backward, AdamW) by kernel family, bfloat16 and float32, from a trace
    of `reps` steps on one fixed batch.  Trains `model` in place."""
    cfg = model.cfg
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.in_channels)
    x = torch.rand(shape, generator=gen, device=device) * 2 - 1
    t = torch.randint(0, cfg.max_period, (batch,), generator=gen,
                      device=device)
    noise = torch.randn(shape, generator=gen, device=device)
    state = trainer.init_state(model)
    result = {"batch": batch, "steps_traced": reps}
    for name in ("bfloat16", "float32"):
        tc = TrainConfig(batch_size=batch, compute_dtype=name)
        _, step_with = trainer.make_train_step(cfg, tc, device=device)
        for _ in range(3):
            step_with(state, x, t, noise)
        result[name] = kernel_families(
            lambda: step_with(state, x, t, noise), reps)
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--train_batch_size", type=int, default=32)
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")
    functional.set_f32_precision("highest")
    model = unet.init(UnetConfig(),
                      generator=torch.Generator().manual_seed(0),
                      device=torch.device("cuda", 0))
    device = torch.cuda.get_device_name(0)
    print(json.dumps({"phase": "profile_forward", "device": device,
                      **profile_forward(model, args.batch_size, args.reps)}),
          flush=True)
    print(json.dumps({"phase": "profile_train_step", "device": device,
                      **profile_train_step(model, args.train_batch_size,
                                           args.reps)}), flush=True)


if __name__ == "__main__":
    main()
