"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

It needs a GPU, `nvcc`, and the `unet_tpu_torch` package beside it; without
any of them it exits non-zero and prints no result.  What it does, one JSON
object per line:

  1. `device`: the card, its power limit, the torch/CUDA/nvcc versions, and
     the seconds the kernels took to build from unet_tpu_torch/csrc/.
  2. `kernel_checks`: each hand-written kernel against its plain PyTorch
     version on the card, float32 and bfloat16, at the shapes the U-Net
     gives it, with the kernel's, the plain version's and a library call's
     time and the least time the card could take.  Each is timed twice
     after warm-up: as it is called (CUDA events around a loop of calls)
     and on the device alone (the same calls replayed from a CUDA graph).
     Every repetition reads the same input, so the cache is warm.
  3. `forward`: one U-Net forward at each batch the requests below give the
     model (4, 8 and the doubled 16 of classifier-free guidance), the module
     on the kernels against the same module on the plain versions, and the
     time of the B=8 forward either way.
  4. `path`: a checkpoint of the default ImageNet-64 model (full width and
     depth, random weights from a seed) written with the port's own saver,
     then sampled through `cli.generate.run` (DDIM in bfloat16 and float32,
     class-conditional DDIM with classifier-free guidance) and through
     `make_sampler` (the DDPM chain), with the kernels' launch counts held
     against model calls x launches per forward.  A short untimed request of
     each kind goes first, and each kernel is held against its plain version
     at every distinct shape those requests hand it.
  5. `{"kernels": [...]}`: one summary entry per kernel; then the seconds
     the whole run took, the card's name and power limit, and the result
     line.

float32 runs in "highest" precision (TF32 off for matmuls and cuDNN).
A failed build, launch or comparison raises, so the exit code is non-zero.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is false")

import torch.nn.functional as TF  # noqa: E402  (yardstick timings only)

from unet_tpu_torch.cli import generate  # noqa: E402
from unet_tpu_torch.config import UnetConfig  # noqa: E402
from unet_tpu_torch.diffusion.gaussian import (  # noqa: E402
    GaussianDiffusion, named_beta_schedule)
from unet_tpu_torch.diffusion.sampler import make_sampler, to_uint8  # noqa: E402
from unet_tpu_torch.io import checkpoint as ckpt_io  # noqa: E402
from unet_tpu_torch.models import unet  # noqa: E402
from unet_tpu_torch.ops import functional  # noqa: E402
from unet_tpu_torch.ops.kernels import _build  # noqa: E402
from unet_tpu_torch.ops.kernels.attention import (  # noqa: E402
    qkv_attention_fwd, qkv_attention_plain)
from unet_tpu_torch.ops.kernels.groupnorm import (  # noqa: E402
    gn_act_fwd, gn_act_fwd_plain)

DEV = torch.device("cuda", 0)
# Published peaks of one H100 SXM (dense): device memory and arithmetic.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Tolerances, kernel against plain version on the same inputs.  float32: the
# two differ in summation order only.  bfloat16: both round a float32 result
# once, so where the float32 values fall on either side of a rounding point
# they differ by one bfloat16 step, which is at most 2^-7 of the value; the
# absolute part allows for the float32 values' own difference.  GroupNorm's
# is of float32 size.  Attention rounds each softmax weight to bfloat16
# (steps of 2^-8 relative) before the value product, the kernel within its
# running softmax and the plain version after the whole one, which leaves
# noise of about 2^-8 of the output's root mean square in each: six times
# that covers the tail over a million outputs and is about 2% of a typical
# output.
F32_TOL = dict(atol=2e-5, rtol=0.0)
GN_TOL = {torch.float32: F32_TOL,
          torch.bfloat16: dict(atol=1e-4, rtol=2.0 ** -7)}


def attention_tol(want):
    if want.dtype == torch.float32:
        return F32_TOL
    rms = want.float().square().mean().sqrt().item()
    return dict(atol=6 * 2.0 ** -8 * rms, rtol=2.0 ** -7)


STAT_TOL = dict(atol=1e-5, rtol=1e-5)  # mean, rstd: float32 in both
FORWARD_ATOL = 2e-3  # whole U-Net, float32: the repo's bar for the model

# B=4 and B=16 cut the rows into other chunks than B=8 (at 64x64: 66 chunks of
# 63 rows with a last chunk of one row, and 17 of 241, against 33 of 125).
GN_SHAPES = [(8, 64, 64, 64), (8, 32, 32, 320), (8, 16, 16, 448),
             (8, 8, 8, 512), (4, 64, 64, 64), (16, 64, 64, 64),
             (4, 8, 8, 512), (16, 32, 32, 320)]
# Batches the requests give the model: DDPM at 4, DDIM at 8, guidance at 2 x 8.
PATH_BATCHES = (4, 8, 16)
ATTN_SHAPES = [(8, 256, 192, 6), (8, 64, 256, 8), (4, 1024, 192, 6),
               (2, 576, 64, 2), (2, 100, 64, 2)]  # (B, T, C, NH)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str) -> dict:
    """The most registers any kernel uses and the bytes any kernel spills,
    from what `nvcc -Xptxas -v` printed during the build."""
    registers = [int(n) for n in re.findall(r"Used (\d+) registers", log)]
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
    return {"kernels": len(registers), "max_registers": max(registers, default=0),
            "max_spill_bytes": max(spills, default=0)}


def time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps=20) -> float:
    """Time of `fn` on the device alone: `reps` calls are recorded into one
    CUDA graph and the graph's replay is timed, so the host's share of a
    call (argument checks, allocations, the launch itself) is left out."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(kernel, plain, library) -> dict:
    """Each of the three as it is called (`*_ms`: CUDA events around a loop
    of calls, the larger of the host's and the device's time per call) and
    on the device alone (`*_graph_ms`)."""
    out = {}
    for name, fn in (("kernel", kernel), ("plain", plain),
                     ("library", library)):
        out[f"{name}_ms"] = time_ms(fn)
        out[f"{name}_graph_ms"] = graph_ms(fn)
    return out


def compare(got, want, tol, what) -> float:
    """Max abs error; raises when outside atol + rtol * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all()):
        raise AssertionError(
            f"{what}: max abs error {err.max().item():.3e} outside "
            f"atol {tol['atol']} rtol {tol['rtol']}")
    return err.max().item()


def bound(nbytes, flops, dtype):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_groupnorm(gen):
    cases = []
    for shape in GN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for act in ("silu", "none"):
                B, H, W, C = shape
                x = (torch.randn(shape, generator=gen, device=DEV) * 2 + 0.5
                     ).to(dtype)
                gamma = (torch.randn(C, generator=gen, device=DEV) * 0.3 + 1
                         ).to(dtype)
                beta = (torch.randn(C, generator=gen, device=DEV) * 0.2
                        ).to(dtype)
                y, mean, rstd = gn_act_fwd(x, gamma, beta, 32, 1e-5, act)
                torch.cuda.synchronize()
                yp, meanp, rstdp = gn_act_fwd_plain(x, gamma, beta, 32, 1e-5,
                                                    act)
                what = f"gn_act_fwd {shape} {dtype} act={act}"
                err = compare(y, yp, GN_TOL[dtype], what)
                err_mean = compare(mean, meanp, STAT_TOL, what + " mean")
                err_rstd = compare(rstd, rstdp, STAT_TOL, what + " rstd")

                def library():
                    z = TF.group_norm(x.permute(0, 3, 1, 2), 32, gamma, beta,
                                      1e-5)
                    return TF.silu(z) if act == "silu" else z

                item = x.element_size()
                nbytes = 2 * x.numel() * item + 2 * C * item + 2 * B * 32 * 4
                # subtract, scale, affine, and the SiLU's exp, add, divide
                flops = x.numel() * (8 if act == "silu" else 4)
                bound_ms, bound_by = bound(nbytes, flops, torch.float32)
                cases.append(dict(
                    shape=list(shape), dtype=str(dtype), act=act,
                    max_abs_err=err, mean_max_abs_err=err_mean,
                    rstd_max_abs_err=err_rstd, tol=GN_TOL[dtype],
                    **timings(
                        lambda: gn_act_fwd(x, gamma, beta, 32, 1e-5, act),
                        lambda: gn_act_fwd_plain(x, gamma, beta, 32, 1e-5,
                                                 act),
                        library),
                    bound_ms=bound_ms, bound_by=bound_by))
    return cases


def check_attention(gen):
    cases = []
    for B, T, C, NH in ATTN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((B, T, 3 * C), generator=gen, device=DEV
                              ).to(dtype)
            out = qkv_attention_fwd(qkv, NH)
            torch.cuda.synchronize()
            what = f"qkv_attention_fwd {(B, T, C, NH)} {dtype}"
            want = qkv_attention_plain(qkv, NH)
            tol = attention_tol(want)
            err = compare(out, want, tol, what)
            # what the tolerance's absolute part has to cover
            beyond = ((out.float() - want.float()).abs()
                      - 2.0 ** -7 * want.float().abs()).max().item()
            rms = want.float().square().mean().sqrt().item()
            HS = C // NH
            q, k, v = (a.transpose(1, 2) for a in
                       qkv.view(B, T, 3, NH, HS).unbind(2))
            item = qkv.element_size()
            bound_ms, bound_by = bound(4 * B * T * C * item,
                                       4 * B * NH * T * T * HS, dtype)
            cases.append(dict(
                shape=[B, T, C, NH], dtype=str(dtype), max_abs_err=err,
                tol=tol, err_beyond_one_bf16_step=beyond, out_rms=rms,
                **timings(
                    lambda: qkv_attention_fwd(qkv, NH),
                    lambda: qkv_attention_plain(qkv, NH),
                    lambda: TF.scaled_dot_product_attention(q, k, v)),
                bound_ms=bound_ms, bound_by=bound_by))
    return cases


class swapped:
    """Within the block, the functional ops call `gn` and `attn` in place of
    the kernels' wrappers (for the comparisons only)."""

    def __init__(self, gn, attn):
        self.mine = (gn, attn)

    def __enter__(self):
        self.saved = (functional.gn_act_fwd, functional.qkv_attention_fwd)
        functional.gn_act_fwd, functional.qkv_attention_fwd = self.mine

    def __exit__(self, *exc):
        functional.gn_act_fwd, functional.qkv_attention_fwd = self.saved


def plain_versions():
    """The plain versions on the card instead of the kernels."""
    return swapped(gn_act_fwd_plain, qkv_attention_plain)


def recording(gn_seen, attn_seen):
    """Within the block, the kernels' wrappers note the shape of every input
    they are given."""

    def gn(x, gamma, beta, num_groups, eps, act):
        gn_seen.add((tuple(x.shape), num_groups, eps, act))
        return gn_act_fwd(x, gamma, beta, num_groups, eps, act)

    def attn(qkv, num_heads):
        attn_seen.add((tuple(qkv.shape), num_heads))
        return qkv_attention_fwd(qkv, num_heads)

    return swapped(gn, attn)


def check_seen_shapes(gn_seen, attn_seen, gen):
    """Kernel against plain version on random tensors of every shape noted,
    float32 and bfloat16.  Returns the count of shapes and the worst error
    per type."""
    worst = {"torch.float32": 0.0, "torch.bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, groups, eps, act in sorted(gn_seen):
            a = (torch.randn(shape, generator=gen, device=DEV) * 2 + 0.5
                 ).to(dtype)
            g = (torch.randn(shape[-1], generator=gen, device=DEV) * 0.3 + 1
                 ).to(dtype)
            b = (torch.randn(shape[-1], generator=gen, device=DEV) * 0.2
                 ).to(dtype)
            got = gn_act_fwd(a, g, b, groups, eps, act)
            want = gn_act_fwd_plain(a, g, b, groups, eps, act)
            what = f"gn_act_fwd {shape} {dtype} act={act}"
            worst[str(dtype)] = max(worst[str(dtype)], compare(
                got[0], want[0], GN_TOL[dtype], what))
            compare(got[1], want[1], STAT_TOL, what + " mean")
            compare(got[2], want[2], STAT_TOL, what + " rstd")
        for shape, heads in sorted(attn_seen):
            qkv = torch.randn(shape, generator=gen, device=DEV).to(dtype)
            want = qkv_attention_plain(qkv, heads)
            worst[str(dtype)] = max(worst[str(dtype)], compare(
                qkv_attention_fwd(qkv, heads), want, attention_tol(want),
                f"qkv_attention_fwd {shape} {dtype}"))
    return dict(gn_shapes=len(gn_seen), attention_shapes=len(attn_seen),
                batches=sorted({shape[0] for shape, *_ in gn_seen}),
                worst_max_abs_err=worst)


def reset_counts() -> None:
    gn_act_fwd.launches = 0
    qkv_attention_fwd.launches = 0


def launches_per_forward(cfg):
    plan = unet.build_plan(cfg)
    layers = [layer for group in plan.input_blocks + (plan.middle,)
              + plan.output_blocks for layer in group]
    n_res = sum(layer[0] == "res" for layer in layers)
    n_attn = sum(layer[0] == "attn" for layer in layers)
    return 2 * n_res + n_attn + 1, n_attn


def check_forward(model, gen):
    """One float32 forward at each batch of the main path, kernels against
    plain versions; and the time of one B=8 forward either way, float32 and
    bfloat16, as it is called and on the device alone (replayed from a CUDA
    graph): the difference is time the card waits for the host."""
    cfg = model.cfg
    result = {"atol": FORWARD_ATOL, "max_abs_err": {}}
    with torch.no_grad():
        for batch in PATH_BATCHES:
            x = torch.randn(
                (batch, cfg.image_size, cfg.image_size, cfg.in_channels),
                generator=gen, device=DEV)
            t = torch.linspace(1, cfg.max_period - 1, batch, device=DEV
                               ).round()
            out = model(x, t)
            with plain_versions():
                ref = model(x, t)
            torch.cuda.synchronize()
            if out.shape != x.shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(
                    f"forward B={batch}: bad shape or non-finite output")
            result["max_abs_err"][f"batch_{batch}"] = compare(
                out, ref, dict(atol=FORWARD_ATOL, rtol=0.0),
                f"U-Net forward f32 B={batch}")
        x = torch.randn((8, cfg.image_size, cfg.image_size, cfg.in_channels),
                        generator=gen, device=DEV)
        t = torch.linspace(1, cfg.max_period - 1, 8, device=DEV).round()
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            net = model.to_compute(dtype)

            def plain():
                with plain_versions():
                    net(x, t)

            # plain, kernels, kernels, plain: both orders within one run
            times = [time_ms(plain, reps=5), time_ms(lambda: net(x, t), reps=5),
                     time_ms(lambda: net(x, t), reps=5), time_ms(plain, reps=5)]
            result[f"forward_ms_{name}"] = dict(
                kernels=min(times[1:3]), plain_versions=min(times[0], times[3]),
                kernels_graph=graph_ms(lambda: net(x, t), reps=3),
                plain_versions_graph=graph_ms(plain, reps=3))
    result["timed_batch"] = 8
    return result


def drive_path(tmp, totals, gen):
    """The port's main path at the default model; returns the request
    records and the check of the kernels at the shapes the requests give
    them, and adds the kernels' launches to `totals`."""
    cfg = UnetConfig()
    gn_per_fwd, attn_per_fwd = launches_per_forward(cfg)
    if (gn_per_fwd, attn_per_fwd) != (56, 11):
        raise AssertionError(f"unexpected plan: {gn_per_fwd}, {attn_per_fwd}")
    files = {}
    for name, num_classes, seed in (("uncond", None, 0), ("cond", 10, 1)):
        model = unet.init(cfg, num_classes,
                          generator=torch.Generator().manual_seed(seed),
                          device=DEV)
        files[name] = os.path.join(tmp, f"{name}.bin")
        ckpt_io.save(files[name], ckpt_io.Checkpoint(
            params=model, cfg=cfg, batch_size=8))
        del model

    def ddpm_chain(batch, dtype, num_steps=None):
        ckpt = ckpt_io.load(files["uncond"], device=DEV)
        diffusion = GaussianDiffusion.create(
            named_beta_schedule(ckpt.noise_schedule, cfg.max_period),
            device=DEV)
        sampler = make_sampler(cfg, diffusion, batch_size=batch,
                               compute_dtype=dtype, num_steps=num_steps)
        images = sampler(ckpt.params,
                         torch.Generator(device=DEV).manual_seed(0))
        if not bool(torch.isfinite(images).all()):
            raise AssertionError("ddpm chain: non-finite images")
        return to_uint8(images)

    def cli(file, *flags):
        return lambda: generate.run(generate.parse_args(
            ["--model_filename", file, "--device", "cuda", *flags]))

    requests = [
        ("ddim50_b8_bf16", 8, 50, cli(
            files["uncond"], "--sampler", "ddim", "--ddim_steps", "50",
            "--batch_size", "8", "--compute_dtype", "bfloat16")),
        ("ddim50_b8_f32", 8, 50, cli(
            files["uncond"], "--sampler", "ddim", "--ddim_steps", "50",
            "--batch_size", "8", "--compute_dtype", "float32")),
        ("cfg_ddim20_b8_bf16", 8, 20, cli(
            files["cond"], "--sampler", "ddim", "--ddim_steps", "20",
            "--batch_size", "8", "--compute_dtype", "bfloat16",
            "--class_label", "3", "--guidance_scale", "3.0")),
        ("ddpm998_b4_bf16", 4, cfg.max_period - 2,
         lambda: ddpm_chain(4, torch.bfloat16)),
    ]
    # One short untimed request of each kind first: the first call at a
    # batch size and type pays cuDNN's and cuBLAS's set-up.  They also show
    # which shapes the requests hand the kernels.
    gn_seen, attn_seen = set(), set()
    with recording(gn_seen, attn_seen):
        for dtype in ("bfloat16", "float32"):
            cli(files["uncond"], "--sampler", "ddim", "--ddim_steps", "2",
                "--batch_size", "8", "--compute_dtype", dtype)()
        cli(files["cond"], "--sampler", "ddim", "--ddim_steps", "2",
            "--batch_size", "8", "--compute_dtype", "bfloat16",
            "--class_label", "3", "--guidance_scale", "3.0")()
        ddpm_chain(4, torch.bfloat16, num_steps=2)
    seen = check_seen_shapes(gn_seen, attn_seen, gen)
    if seen["batches"] != sorted(PATH_BATCHES):
        raise AssertionError(f"the requests ran at batches {seen['batches']}")

    records = []
    for name, batch, model_calls, request in requests:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        images = request()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        gn_n, attn_n = gn_act_fwd.launches, qkv_attention_fwd.launches
        shape = (batch, cfg.image_size, cfg.image_size, cfg.out_channels)
        if images.shape != shape or str(images.dtype) != "uint8":
            raise AssertionError(
                f"{name}: got {images.shape} {images.dtype}, want {shape} "
                "uint8")
        if (gn_n, attn_n) != (model_calls * gn_per_fwd,
                              model_calls * attn_per_fwd):
            raise AssertionError(
                f"{name}: {gn_n} GroupNorm and {attn_n} attention launches "
                f"for {model_calls} model calls")
        totals["gn_act_fwd"] += gn_n
        totals["qkv_attention_fwd"] += attn_n
        records.append(dict(
            request=name, shape=list(images.shape), dtype=str(images.dtype),
            finite=True, model_calls=model_calls, seconds=seconds,
            images_per_s=batch / seconds, gn_act_fwd_launches=gn_n,
            qkv_attention_fwd_launches=attn_n,
            pixel_mean=float(images.mean())))
    return records, seen


def summary(name, source, replaces, cases, headline, launches):
    """The contract's entry for one kernel: the numbers of the headline case
    (a shape of the main path, bfloat16) and every case beside it."""
    case = next(c for c in cases if all(c[k] == v for k, v in headline.items()))
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=case["max_abs_err"],
        ms=case["kernel_ms"], plain_ms=case["plain_ms"],
        bound_ms=case["bound_ms"], bound_by=case["bound_by"],
        library_ms=case["library_ms"], graph_ms=case["kernel_graph_ms"],
        plain_graph_ms=case["plain_graph_ms"],
        library_graph_ms=case["library_graph_ms"], headline_case=headline,
        worst_max_abs_err={dt: max(c["max_abs_err"] for c in cases
                                   if c["dtype"] == dt)
                           for dt in ("torch.float32", "torch.bfloat16")})


def main() -> None:
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    functional.set_f32_precision("highest")
    _build.load()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "nvidia_smi_name_power_limit": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-2].strip(),
          "build_seconds": _build.build_seconds,
          "ptxas": ptxas_summary(_build.build_log),
          "f32_precision": "highest (TF32 off)"})

    gen = torch.Generator(device=DEV).manual_seed(0)
    gn_cases = check_groupnorm(gen)
    attn_cases = check_attention(gen)
    emit({"phase": "kernel_checks", "gn_act_fwd": gn_cases,
          "qkv_attention_fwd": attn_cases})

    model = unet.init(UnetConfig(),
                      generator=torch.Generator().manual_seed(0), device=DEV)
    emit({"phase": "forward", **check_forward(model, gen)})
    del model

    totals = {"gn_act_fwd": 0, "qkv_attention_fwd": 0}
    with tempfile.TemporaryDirectory() as tmp:
        records, seen = drive_path(tmp, totals, gen)
    emit({"phase": "path", "model": "UnetConfig() ImageNet-64, full depth",
          "kernel_inputs_of_the_requests": seen, "requests": records})
    if min(totals.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {totals}")

    emit({"kernels": [
        summary("gn_act_fwd", "unet_tpu_torch/csrc/groupnorm.cu",
                "unet_tpu/ops/pallas/groupnorm.py:165", gn_cases,
                dict(shape=[8, 64, 64, 64], dtype="torch.bfloat16",
                     act="silu"), totals["gn_act_fwd"]),
        summary("qkv_attention_fwd", "unet_tpu_torch/csrc/attention.cu",
                "unet_tpu/ops/pallas/attention.py:160", attn_cases,
                dict(shape=[8, 256, 192, 6], dtype="torch.bfloat16"),
                totals["qkv_attention_fwd"]),
    ]})
    emit({"phase": "done", "seconds_total": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
