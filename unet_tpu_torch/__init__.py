"""unet_tpu_torch — the PyTorch/CUDA port of the unet_tpu package.

The JAX package `unet_tpu` is the reference; this package does the same
work on an NVIDIA Hopper GPU.  Module names follow the JAX package
(`config`, `ops/functional`, `models/blocks`, `models/unet`,
`diffusion/gaussian`, `diffusion/sampler`, `io/checkpoint`,
`cli/generate`), so each file's counterpart is found by its path.  Plain
tensor code is PyTorch; the kernels the JAX package wrote in Pallas are
CUDA C++ under `csrc/`, built at first use (`ops/kernels/_build.py`).

Ported so far: the sampling path (checkpoint -> DDPM/DDIM sampler -> U-Net
forward).  The package imports torch and numpy only.
"""

from unet_tpu_torch.config import UnetConfig

__version__ = "0.1.0"
__all__ = ["UnetConfig"]
