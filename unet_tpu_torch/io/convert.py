"""Weights carried across from the JAX package (no JAX counterpart).

The JAX package keeps its parameters as a pytree in its native layouts
(HWIO conv kernels, (I, O) linear weights); the port keeps torch shapes.
`params_from_jax` takes that pytree as numpy arrays and does the transposes
the JAX package's checkpoint writer does.  Nothing here imports JAX: the
caller hands over numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from unet_tpu_torch.config import UnetConfig
from unet_tpu_torch.io import checkpoint
from unet_tpu_torch.models import unet


def _to_torch(a: np.ndarray, kind: str) -> np.ndarray:
    if kind == "conv":       # (kh, kw, I, O) -> (O, I, kh, kw)
        return a.transpose(3, 2, 0, 1)
    if kind in ("linear", "conv1d"):     # (I, O) -> (O, I)
        return a.T
    return a                 # "gn": as it is


def params_from_jax(tree, cfg: UnetConfig, num_classes: Optional[int] = None,
                    device="cuda") -> unet.UNet:
    """The JAX package's parameter pytree (nested dicts and lists of numpy
    arrays, the structure of its `unet.init`) -> `UNet` on `device`."""
    chunks = []
    for path, kind in unet.param_order(cfg, num_classes):
        node = tree
        for k in path:
            node = node[k]
        chunks.append(_to_torch(np.asarray(node, np.float32), kind).ravel())
    return checkpoint.unflatten_params(np.concatenate(chunks), cfg,
                                       num_classes, device)


def params_from_flat(flat, cfg: UnetConfig, num_classes: Optional[int] = None,
                     device="cuda") -> unet.UNet:
    """The torch-order flat float32 vector (numpy array or tensor), the
    payload of a `.bin` file -> `UNet` on `device`."""
    if torch.is_tensor(flat):
        flat = flat.detach().cpu().numpy()
    return checkpoint.unflatten_params(np.asarray(flat, np.float32), cfg,
                                       num_classes, device)
