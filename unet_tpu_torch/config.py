"""Typed model configuration (port of unet_tpu/config.py).

`UnetConfig` is field for field the JAX package's, so a config read from a
checkpoint header means the same model in both packages.  `TrainConfig`
arrives with the training slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


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


DIFFUSION_T = 1000
