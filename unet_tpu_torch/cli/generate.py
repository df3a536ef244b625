"""Sampling CLI (port of unet_tpu/cli/generate.py; the same flags, plus
`--device`).

python -m unet_tpu_torch.cli.generate --model_filename models/model.bin \
    [--output_filename sample.jpg] [--batch_size 1] [--seed 0] \
    [--device cuda]

Loads a .bin checkpoint (written by this package or the JAX package) and
runs the DDPM or DDIM sampler on `--device`: on a CUDA device the chain is
the replays of one captured sampler step (`diffusion/sampler.py`), on the
CPU the same step runs eagerly.  `main` is parse -> `run` -> save; `run`
returns the images, so a caller without an image library can drive the
whole path.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule)
from unet_tpu_torch.diffusion.sampler import (make_ddim_sampler, make_sampler,
                                              to_uint8)
from unet_tpu_torch.io import checkpoint as ckpt_io
from unet_tpu_torch.models import unet
from unet_tpu_torch.ops.kernels import attention
from unet_tpu_torch.utils.args import add_dict_to_argparser

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, dict(
        model_filename="", output_filename="sample.jpg",
        batch_size=1, seed=0, compute_dtype="float32",
        use_ema=False,   # sample the EMA weights
        sampler="ddpm",  # "ddpm" (998-step ancestral) or "ddim" (fast)
        ddim_steps=50,
        ddim_eta=0.0,
        class_label=-1,      # >= 0: class-conditional sampling with this
        #                      label (checkpoint must carry label_emb)
        guidance_scale=1.0,  # classifier-free guidance weight w:
        #                      eps_u + w*(eps_c - eps_u); needs --class_label
        noise_schedule="",   # "" = the schedule recorded in the checkpoint
        #                      ("linear" when it has no record)
        device="cuda"))      # where the model runs
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    parser = _parser()
    args = parser.parse_args(argv)
    if not args.model_filename:
        parser.error("--model_filename is required")
    if args.sampler not in ("ddpm", "ddim"):
        parser.error(f"unknown sampler {args.sampler!r}")
    if args.guidance_scale != 1.0 and args.class_label < 0:
        parser.error("--guidance_scale needs --class_label")
    if args.noise_schedule not in ("", "linear", "cosine"):
        parser.error(f"unknown schedule {args.noise_schedule!r}")
    if args.compute_dtype not in _DTYPES:
        parser.error(f"unknown compute_dtype {args.compute_dtype!r}")
    return args


def run(args: argparse.Namespace) -> np.ndarray:
    """Load the checkpoint, sample, and return the images as uint8
    (B, H, W, C).  Faults of the arguments against the checkpoint end the
    program as `parser.error` does."""
    error = _parser().error
    device = torch.device(args.device)
    # the JAX package's head rule (the kernels take every head it runs),
    # before any weights are read
    cfg = ckpt_io.read_config(args.model_filename)
    fault = attention.head_size_fault(unet.attention_widths(cfg),
                                      cfg.num_head_channels)
    if fault is not None:
        error(f"{args.model_filename}: {fault} (--device {args.device})")
    ckpt = ckpt_io.load(args.model_filename, device=device)
    schedule = args.noise_schedule or ckpt.noise_schedule or "linear"
    diffusion = GaussianDiffusion.create(
        named_beta_schedule(schedule, ckpt.cfg.max_period), device=device)
    if args.sampler == "ddim":
        T = diffusion.num_timesteps
        if not 1 <= args.ddim_steps <= T - 1:
            error(f"--ddim_steps must be in [1, {T - 1}] for this "
                  f"model's {T}-step schedule")
    y = args.class_label if args.class_label >= 0 else None
    num_classes = ckpt.params.num_classes
    if y is not None and num_classes is None:
        error(f"{args.model_filename} is unconditional (no label_emb); "
              "train with --class_cond for --class_label")
    if y is not None and y >= num_classes:
        error(f"--class_label {y} out of range (num_classes={num_classes})")
    model = ckpt.params
    if args.use_ema:
        if ckpt.ema is None:
            error(f"{args.model_filename} carries no EMA weights "
                  "(train with --ema_rate > 0)")
        model = ckpt.ema
    common = dict(batch_size=args.batch_size,
                  compute_dtype=_DTYPES[args.compute_dtype],
                  y=y, guidance_scale=args.guidance_scale)
    if args.sampler == "ddim":
        sampler = make_ddim_sampler(ckpt.cfg, diffusion,
                                    num_steps=args.ddim_steps,
                                    eta=args.ddim_eta, **common)
    else:
        sampler = make_sampler(ckpt.cfg, diffusion, **common)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    images = sampler(model, generator)
    if not bool(torch.isfinite(images).all()):
        raise FloatingPointError(
            f"sampling from {args.model_filename} produced non-finite "
            "values")
    return to_uint8(images)


def save_images(arr: np.ndarray, filename: str) -> None:
    """One image as it is, several as a grid with rows of up to 8."""
    from PIL import Image
    b, h, w, c = arr.shape
    if b == 1:
        Image.fromarray(arr[0]).save(filename)
        return
    cols = min(b, 8)
    rows = (b + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i in range(b):
        r, cl = divmod(i, cols)
        grid[r * h:(r + 1) * h, cl * w:(cl + 1) * w] = arr[i]
    Image.fromarray(grid).save(filename)


def main(argv=None) -> None:
    args = parse_args(argv)
    save_images(run(args), args.output_filename)
    print(f"Saved sample to {args.output_filename}")


if __name__ == "__main__":
    main()
