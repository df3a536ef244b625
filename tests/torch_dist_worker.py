"""One rank of the port's data-parallel checks on the CPU (gloo), started
by tests/test_torch_parallel.py as

    python -m tests.torch_dist_worker SPEC.json RANK

SPEC.json names the rendezvous, the world size, the model's config, an
inputs file (.npz: the file-order weights, a global batch, timesteps,
noise and labels, made with numpy) and an output directory.  The rank
runs, on its rows of the global batch:

* `grad`: the DP step's global-mean loss and reduced gradient
  (`value_and_grad`);
* `dp`, `fsdp`, `micro`: two steps of `make_parallel_train_step` (DP, FSDP,
  DP with microbatches of one row), seeded draws, with the EMA;
* `cond`: two class-conditional DP steps with label dropout;
* `sampler`: a 5-step DDPM chain of `make_parallel_sampler`, gathered.

Rank 0 writes the whole vectors (`host_state`) and the losses to
`out/results.npz`; every rank writes the sizes of the vectors it keeps to
`out/sizes<rank>.json`.  This module imports torch and the port only.
"""

import json
import os
import sys

import numpy as np
import torch

from unet_tpu_torch.config import TrainConfig, UnetConfig
from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule)
from unet_tpu_torch.diffusion.sampler import make_parallel_sampler
from unet_tpu_torch.io import convert
from unet_tpu_torch.parallel import distributed
from unet_tpu_torch.parallel import mesh as pmesh
from unet_tpu_torch.training import trainer

# the steps of `dp`, `fsdp`, `micro` and `cond`
STEPS = dict(batch_size=None, lr=1e-4, weight_decay=0.01, ema_rate=0.9)
SEED = 5


def main(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    distributed.initialize(spec["address"], world, rank, device="cpu",
                           timeout_s=60)
    try:
        run(spec, rank, world)
    finally:
        distributed.shutdown()


def run(spec, rank, world):
    cfg = UnetConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in spec["cfg"].items()})
    inputs = np.load(spec["inputs"])
    mesh = pmesh.make_mesh()
    diffusion = GaussianDiffusion.create(
        named_beta_schedule("linear", cfg.max_period), device="cpu")
    local = inputs["batch"].shape[0] // world
    batch = pmesh.shard_batch(torch.from_numpy(inputs["batch"]), mesh)
    chunk = pmesh.shard_batch(torch.from_numpy(inputs["chunk"]).transpose(
        0, 1), mesh).transpose(0, 1)
    labels = pmesh.shard_batch(torch.from_numpy(inputs["labels"]).T,
                               mesh).T
    out, sizes = {}, {}

    def model(num_classes=None):
        return convert.params_from_flat(
            inputs["weights" if num_classes is None else "weights_cond"],
            cfg, num_classes, device="cpu")

    # the reduced loss and gradient on the given global batch, t and noise
    params = model()
    unravel = trainer.Unravel(params)
    step = pmesh.make_parallel_train_step(
        cfg, TrainConfig(batch_size=local), mesh, diffusion,
        example_params=params)
    state = pmesh.init_state(unravel, params, mesh)
    loss, grad = step.value_and_grad(state, batch, inputs["t"],
                                     inputs["noise"])
    out["grad_loss"], out["grad"] = loss.numpy(), grad.numpy()

    def train(name, fsdp=False, microbatch=0, num_classes=None):
        params = model(num_classes)
        tc = TrainConfig(**{**STEPS, "batch_size": local,
                            "microbatch": microbatch,
                            "label_dropout": 0.5 if num_classes else 0.0})
        step = pmesh.make_parallel_train_step(
            cfg, tc, mesh, diffusion, fsdp=fsdp,
            class_cond=num_classes is not None, example_params=params)
        state = pmesh.init_state(trainer.Unravel(params), params, mesh,
                                 fsdp=fsdp, ema_rate=tc.ema_rate, seed=SEED)
        state, losses = step(state, chunk,
                             labels if num_classes is not None else None)
        flat, m, v, ema = pmesh.host_state(state)
        out.update({f"{name}_losses": losses.numpy(),
                    f"{name}_flat": flat.numpy(), f"{name}_m": m.numpy(),
                    f"{name}_v": v.numpy(), f"{name}_ema": ema.numpy()})
        sizes[name] = dict(
            master=state.master.numel(), m=state.m.numel(),
            v=state.v.numel(), ema=state.ema.numel(),
            flat=state.flat.numel(), size=state.placement.size,
            step=state.step)

    train("dp")
    train("fsdp", fsdp=True)
    train("micro", microbatch=1)
    train("cond", num_classes=10)

    sample = make_parallel_sampler(cfg, diffusion, mesh,
                                   batch_size=inputs["batch"].shape[0],
                                   num_steps=5, gather=True)
    out["sampler"] = sample(model(), torch.Generator().manual_seed(0)
                            ).numpy()

    with open(os.path.join(spec["out"], f"sizes{rank}.json"), "w") as f:
        json.dump(sizes, f)
    if rank == 0:
        np.savez(os.path.join(spec["out"], "results.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
