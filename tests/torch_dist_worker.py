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
* `sampler`: a 5-step DDPM chain of `make_parallel_sampler`, gathered;
* `mesh_model_2`: the place of the rank on `make_mesh(model=2)`.

Rank 0 writes the whole vectors (`host_state`) and the losses to
`out/results.npz`; every rank writes the sizes of the vectors it keeps to
`out/sizes<rank>.json`.

A spec with "meshes" (tests/test_torch_tensor_parallel.py) runs the
tensor-parallel jobs instead (`run_tp`), on each mesh it names in turn
(name, model axis, extra jobs), the data axis taking the other ranks:

* `grad`: the global-mean loss and reduced gradient of the TP step, or
  with a data axis over 1 of the tp x fsdp step, gathered over both axes
  into the whole vector;
* `kept_grad`: the same step's gradient of the leaves the rank keeps
  whole, after each model rank moved its copies of them by its own amount;
* `tp`, `tpfsdp` (with a data axis over 1), and where named `remat` (TP
  with remat and microbatches of one row) and `cond` (class-conditional
  TP with label dropout): two steps each, seeded draws, with the EMA.

Into out/<mesh name>/, rank 0 writes the whole vectors and the losses
(`results.npz`); every rank writes its own vector after `tp` (to hold
the leaves it keeps whole against the other model ranks',
`local<rank>.npy`), its `kept_grad<rank>.npy` and its place on the mesh
(`mesh<rank>.json`).

This module imports torch and the port only.
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
        (run_tp if "meshes" in spec else run)(spec, rank, world)
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

    mesh2 = pmesh.make_mesh(model=2)  # the model axis, laid out
    sizes["mesh_model_2"] = dict(data=mesh2.data, model=mesh2.model,
                                 data_rank=mesh2.data_rank,
                                 model_rank=mesh2.model_rank)

    sample = make_parallel_sampler(cfg, diffusion, mesh,
                                   batch_size=inputs["batch"].shape[0],
                                   num_steps=5, gather=True)
    out["sampler"] = sample(model(), torch.Generator().manual_seed(0)
                            ).numpy()

    with open(os.path.join(spec["out"], f"sizes{rank}.json"), "w") as f:
        json.dump(sizes, f)
    if rank == 0:
        np.savez(os.path.join(spec["out"], "results.npz"), **out)


def run_tp(spec, rank, world):
    cfg = UnetConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in spec["cfg"].items()})
    inputs = np.load(spec["inputs"])
    diffusion = GaussianDiffusion.create(
        named_beta_schedule("linear", cfg.max_period), device="cpu")
    for name, model, jobs in spec["meshes"]:
        out_dir = os.path.join(spec["out"], name)
        os.makedirs(out_dir, exist_ok=True)
        tp_jobs(cfg, inputs, diffusion, pmesh.make_mesh(model=model), jobs,
                rank, out_dir)


def tp_jobs(cfg, inputs, diffusion, mesh, jobs, rank, out_dir):
    """The TP jobs on one mesh (see the module's docstring)."""
    local = inputs["batch"].shape[0] // mesh.data
    batch = pmesh.shard_batch(torch.from_numpy(inputs["batch"]), mesh)
    chunk = pmesh.shard_batch(torch.from_numpy(inputs["chunk"]).transpose(
        0, 1), mesh).transpose(0, 1)
    labels = pmesh.shard_batch(torch.from_numpy(inputs["labels"]).T,
                               mesh).T
    out, fraction = {}, {}

    def model(num_classes=None):
        return convert.params_from_flat(
            inputs["weights" if num_classes is None else "weights_cond"],
            cfg, num_classes, device="cpu")

    # the gradient of tp x fsdp where there is a data axis, else of TP
    params, fsdp = model(), mesh.data > 1
    step = pmesh.make_parallel_train_step(
        cfg, TrainConfig(batch_size=local), mesh, diffusion, tp=True,
        fsdp=fsdp, example_params=params)
    state = pmesh.init_state(trainer.Unravel(params), params, mesh, tp=True,
                             fsdp=fsdp)
    loss, grad = step.value_and_grad(state, batch, inputs["t"],
                                     inputs["noise"])
    placement = state.placement
    grad, = distributed.replicate([grad], placement.size, placement.sharded,
                                  placement.group)
    out["grad_loss"] = loss.numpy()
    out["grad"] = state.layout.gather(grad).numpy()
    # each model rank moves its copies of the leaves kept whole by its own
    # amount: their reduced gradients must still agree over the model ranks
    kept = state.layout.kept()
    state.flat.detach().index_add_(
        0, kept, torch.full((kept.numel(),), 1e-3 * (mesh.model_rank + 1)))
    _, moved = step.value_and_grad(state, batch, inputs["t"], inputs["noise"])
    moved, = distributed.replicate([moved], placement.size,
                                   placement.sharded, placement.group)
    np.save(os.path.join(out_dir, f"kept_grad{rank}.npy"),
            moved[kept].numpy())

    def train(name, fsdp=False, remat=False, microbatch=0, num_classes=None):
        params = model(num_classes)
        tc = TrainConfig(**{**STEPS, "batch_size": local,
                            "microbatch": microbatch, "remat": remat,
                            "label_dropout": 0.5 if num_classes else 0.0})
        step = pmesh.make_parallel_train_step(
            cfg, tc, mesh, diffusion, tp=True, fsdp=fsdp,
            class_cond=num_classes is not None, example_params=params)
        state = pmesh.init_state(trainer.Unravel(params), params, mesh,
                                 tp=True, fsdp=fsdp, ema_rate=tc.ema_rate,
                                 seed=SEED)
        state, losses = step(state, chunk,
                             labels if num_classes is not None else None)
        flat, m, v, ema = pmesh.host_state(state)
        out.update({f"{name}_losses": losses.numpy(),
                    f"{name}_flat": flat.numpy(), f"{name}_m": m.numpy(),
                    f"{name}_v": v.numpy(), f"{name}_ema": ema.numpy()})
        fraction[name] = pmesh.shard_fraction(state.placement, state.layout)
        return state

    state = train("tp")
    np.save(os.path.join(out_dir, f"local{rank}.npy"),
            state.flat.detach().numpy())
    if mesh.data > 1:
        train("tpfsdp", fsdp=True)
    for job in jobs:
        if job == "remat":
            train("remat", remat=True, microbatch=1)
        elif job == "cond":
            train("cond", num_classes=10)

    with open(os.path.join(out_dir, f"mesh{rank}.json"), "w") as f:
        json.dump(dict(data=mesh.data, model=mesh.model,
                       data_rank=mesh.data_rank, model_rank=mesh.model_rank,
                       rows=[mesh.rows.start, mesh.rows.step],
                       fraction=fraction), f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "results.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
