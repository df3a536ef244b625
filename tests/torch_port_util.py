"""Shared helpers of the tests/test_torch_*.py files: the one place where
the JAX package (`unet_tpu`) and its PyTorch/CUDA port (`unet_tpu_torch`)
meet.  Inputs and weights are made from a seed with numpy and handed to
both sides as numpy arrays; everything runs on the CPU, where the port's
kernel wrappers take their plain versions.
"""

import contextlib
import os
import subprocess
import time

import numpy as np
import torch

from unet_tpu.config import UnetConfig as JaxConfig
from unet_tpu.io import checkpoint as jax_ckpt
from unet_tpu.models import unet as jax_unet
from unet_tpu_torch.config import UnetConfig
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.io import convert
from unet_tpu_torch.models import unet as port_unet
from unet_tpu_torch.parallel import distributed

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Each multi-process run of the tests, start to end, in seconds.
RANKS_LIMIT_S = 120

# Smaller than conftest.SMALL_CFG so the JAX side traces in about a second:
# two levels, one res block each, attention at ds 2 (C=64, two heads).
TINY = dict(model_channels=32, image_size=16, channel_mult=(1, 2),
            num_res_blocks=1, attention_ds=(2,))


def configs(**overrides):
    """(JAX package's config, port's config) with the same fields."""
    fields = {**TINY, **overrides}
    return JaxConfig(**fields), UnetConfig(**fields)


def flat_weights(cfg: UnetConfig, num_classes=None, seed=0) -> np.ndarray:
    """A torch-order flat float32 parameter vector with trained-looking
    statistics: GroupNorm scales near 1, weights N(0, 1/fan_in), the rest
    N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = port_ckpt._shape_model(cfg, num_classes)
    chunks = []
    for path, kind in port_unet.param_order(cfg, num_classes):
        shape = tuple(port_unet.get_param(shapes, path).shape)
        a = rng.standard_normal(shape, dtype=np.float32)
        if path[-1] == "scale":
            a = 1.0 + 0.1 * a
        elif kind in ("conv", "linear", "conv1d"):
            a = a / np.sqrt(np.prod(shape[1:]), dtype=np.float32)
        else:
            a = 0.1 * a
        chunks.append(a.ravel())
    return np.concatenate(chunks).astype(np.float32)


@contextlib.contextmanager
def s2d_on():
    """Both packages in mode "on" within the block, their modes restored
    after (JAX reads its mode when it traces)."""
    saved = jax_unet._S2D_MODE, port_unet._S2D_MODE
    jax_unet.set_s2d_mode("on")
    port_unet.set_s2d_mode("on")
    try:
        yield
    finally:
        jax_unet.set_s2d_mode(saved[0])
        port_unet.set_s2d_mode(saved[1])


def both_models(jcfg, cfg, num_classes=None, seed=0):
    """(JAX pytree, port module on the CPU, flat vector) of one weight set."""
    flat = flat_weights(cfg, num_classes, seed)
    params = jax_ckpt.unflatten_params(flat, jcfg, num_classes)
    model = convert.params_from_flat(flat, cfg, num_classes, device="cpu")
    return params, model, flat


def t2n(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def j2n(a) -> np.ndarray:
    """A JAX array as float32/float64 numpy (bfloat16 widened)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def jax_native_library(build_dir):
    """The JAX package's host library (unet_tpu/utils/native.py), built into
    `build_dir` when this process has not loaded it yet: its own place,
    inside the JAX package, may be half written by another test process
    building it at the same time."""
    from unet_tpu.utils import native as jax_native
    if jax_native._lib is None:
        saved = jax_native._SO_PATH
        jax_native._SO_PATH = str(build_dir / "_native.so")
        try:
            jax_native.load_library()
        finally:
            jax_native._SO_PATH = saved
    return jax_native._lib


def run_ranks(argvs, logs, limit_s=RANKS_LIMIT_S, tries=3, env=None):
    """Start one process per argv (`argvs(port)` gives them, for a free
    localhost port), each writing its output to its log file (never a
    pipe), from the repository's root, and wait for all of them within
    `limit_s` seconds; a rendezvous that found its port taken is tried
    again on another.  No process outlives the call.  Returns (exit codes,
    the logs' text)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", **(env or {}))
    for _ in range(tries):
        procs = []
        try:
            for argv, log in zip(argvs(distributed.free_port()), logs):
                with open(log, "wb") as f:
                    procs.append(subprocess.Popen(
                        argv, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                        stdin=subprocess.DEVNULL, env=env))
            deadline = time.monotonic() + limit_s
            codes = [p.wait(timeout=max(deadline - time.monotonic(), 0.1))
                     for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        text = "".join(open(log, errors="replace").read() for log in logs)
        if "EADDRINUSE" not in text:
            break
    return codes, text
