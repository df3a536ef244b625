from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               cosine_beta_schedule,
                                               linear_beta_schedule,
                                               named_beta_schedule)
from unet_tpu_torch.diffusion.sampler import (ddim_sample, ddpm_sample,
                                              make_ddim_sampler,
                                              make_sampler, to_uint8)

__all__ = ["GaussianDiffusion", "linear_beta_schedule",
           "cosine_beta_schedule", "named_beta_schedule", "ddpm_sample",
           "ddim_sample", "make_sampler", "make_ddim_sampler", "to_uint8"]
