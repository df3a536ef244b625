"""Gaussian diffusion forward process (port of
unet_tpu/diffusion/gaussian.py).

The schedules and the float32 cumprod are numpy, as in the JAX package, so
the tables of the two packages are bit-equal.  The tables are kept twice:
as numpy arrays, from which the samplers take their per-step scalars
without asking the device, and as tensors on `device` for `q_sample`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def linear_beta_schedule(num_timesteps: int) -> np.ndarray:
    scale = 1000.0 / num_timesteps
    return np.linspace(scale * 0.0001, scale * 0.02, num_timesteps,
                       dtype=np.float64)


def cosine_beta_schedule(num_timesteps: int, max_beta: float = 0.999
                         ) -> np.ndarray:
    def alpha_bar(t):
        return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

    betas = []
    for i in range(num_timesteps):
        t1 = i / num_timesteps
        t2 = (i + 1) / num_timesteps
        betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), max_beta))
    return np.array(betas)


def named_beta_schedule(name: str, num_timesteps: int) -> np.ndarray:
    if name == "linear":
        return linear_beta_schedule(num_timesteps)
    if name == "cosine":
        return cosine_beta_schedule(num_timesteps)
    raise ValueError(f"unknown beta schedule: {name}")


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    """Precomputed schedule tables, float32: numpy on the host (`betas`,
    `alphas_cumprod`) and tensors on the device (`sqrt_alphas_cumprod`,
    `sqrt_one_minus_alphas_cumprod`)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor

    @staticmethod
    def create(betas: np.ndarray, device="cuda") -> "GaussianDiffusion":
        betas32 = np.asarray(betas, dtype=np.float32)
        if betas32.size == 0 or np.any(betas32 <= 0) or np.any(betas32 >= 1):
            # The scaled linear schedule's beta_end is 20/T, so T <= 20
            # exceeds beta=1 and sqrt(1 - alphas_cumprod) goes NaN.
            rng = ("empty" if betas32.size == 0 else
                   f"range [{betas32.min():.4g}, {betas32.max():.4g}]")
            raise ValueError(
                "beta schedule must lie strictly in (0, 1); got "
                f"{rng} over {betas32.size} steps (linear schedule "
                "needs num_timesteps >= 21)")
        alphas_cumprod = np.cumprod(1.0 - betas32, axis=0)
        return GaussianDiffusion(
            betas=betas32,
            alphas_cumprod=alphas_cumprod,
            sqrt_alphas_cumprod=torch.as_tensor(
                np.sqrt(alphas_cumprod), device=device),
            sqrt_one_minus_alphas_cumprod=torch.as_tensor(
                np.sqrt(1.0 - alphas_cumprod), device=device),
        )

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def q_sample(self, x_start, t, noise):
        """x_t = sqrt(abar_t) x_0 + sqrt(1-abar_t) eps on an NHWC batch.
        t may be int or float (a float indexes by truncation)."""
        ti = t.long()
        a = self.sqrt_alphas_cumprod[ti][:, None, None, None]
        b = self.sqrt_one_minus_alphas_cumprod[ti][:, None, None, None]
        return a * x_start.float() + b * noise.float()


def sample_timesteps(generator: torch.Generator, batch_size: int,
                     num_timesteps: int, device="cuda") -> torch.Tensor:
    """Uniform integer timesteps in [0, num_timesteps), int64 (B,), drawn
    from `generator` (which lives on `device`)."""
    return torch.randint(0, num_timesteps, (batch_size,), generator=generator,
                         device=device)
