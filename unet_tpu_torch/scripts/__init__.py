"""Kernel-benchmark scripts of the port (counterparts of scripts/ in the
repo root); run each with `python -m unet_tpu_torch.scripts.<name>`."""
