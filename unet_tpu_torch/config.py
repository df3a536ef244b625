"""Typed model configuration (port of unet_tpu/config.py).

`UnetConfig` and `TrainConfig` are field for field the JAX package's, so a
config read from a checkpoint header means the same model in both packages,
and one set of training flags the same run.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UnetConfig:
    """Architecture hyperparameters of the ADM U-Net.

    Defaults are the ImageNet-64 unconditional DDPM model.
    """

    in_channels: int = 3
    model_channels: int = 64
    out_channels: int = 3
    num_res_blocks: int = 2
    # Downsample factors at which attention runs (ds = image_size // res).
    attention_ds: Tuple[int, ...] = (4, 8)
    channel_mult: Tuple[int, ...] = (1, 2, 3, 4)
    num_head_channels: int = 32  # HS; NH = channels // HS per block
    # FiLM-style conditioning: emb projects to (scale, shift) applied
    # around GN2 instead of a plain add.
    use_scale_shift_norm: bool = False
    gn_num_groups: int = 32
    gn_eps: float = 1e-5
    image_size: int = 64
    max_period: int = 1000  # sinusoidal-embedding max period AND diffusion T

    @property
    def time_embed_dim(self) -> int:
        return 4 * self.model_channels

    @property
    def num_levels(self) -> int:
        return len(self.channel_mult)

    @property
    def num_skips(self) -> int:
        # One skip per input block: conv_in + num_res_blocks per level +
        # one downsample per non-final level.
        return 1 + self.num_res_blocks * self.num_levels + (self.num_levels - 1)

    def level_channels(self) -> Sequence[int]:
        return [m * self.model_channels for m in self.channel_mult]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyperparameters."""

    batch_size: int = 32
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    iterations: int = 100_000
    log_interval: int = 100
    save_interval: int = 10_000
    # 0 < ema_rate < 1 keeps a float32 exponential moving average of the
    # parameters, updated after each optimizer step and checkpointed.
    ema_rate: float = 0.0
    # Gradient accumulation: each batch runs as microbatches of this size
    # and their gradients are averaged, the full batch's math at
    # microbatch / batch_size of the activation memory.  0 = off.
    microbatch: int = 0
    # Linear learning-rate anneal: lr * (1 - completed_steps /
    # lr_anneal_steps), clamped at 0.  0 = constant lr.
    lr_anneal_steps: int = 0
    # Classifier-free guidance training: per-example probability of
    # replacing the class label with the null label -1.
    label_dropout: float = 0.0
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    remat: bool = False
    shuffle: bool = False

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float64": torch.float64}[self.compute_dtype]


DIFFUSION_T = 1000
