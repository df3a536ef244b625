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
* `mesh_model_2`: the place of the rank on `make_mesh(model=2)`;
* `s2d`: whether the model ran level 0 in patch space
  (`models.unet._use_s2d`, on when the rank's environment sets
  UNET_TPU_TORCH_S2D=on).

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
  TP with label dropout): two steps each, seeded draws, with the EMA;
* `s2d` (where named): level 0 in patch space (`models.unet.set_s2d_mode`
  "on" around these runs alone, restored after): the `grad` job's loss
  and whole gradient, and with `remat` also named its two steps.

Into out/<mesh name>/, rank 0 writes the whole vectors and the losses
(`results.npz`); every rank writes its own vector after `tp` (to hold
the leaves it keeps whole against the other model ranks',
`local<rank>.npy`), its `kept_grad<rank>.npy` and its place on the mesh
(`mesh<rank>.json`).

A spec with "spatial" (tests/test_torch_spatial_parallel.py) runs the
spatial-sharding jobs instead (`run_spatial`), on each mesh it names in
turn (name, model axis, extra jobs):

* `modules` (where named): a 3x3 convolution, GroupNorm(+SiLU) and
  GroupNorm alone, and attention on the rank's rows of the spec's module
  inputs, and the patch-space convolution and GroupNorm(+SiLU)
  (`ops/s2d.py`) on the rank's patch rows, forward and backward; the
  outputs and input gradients gathered over the model ranks, the
  parameters' gradients summed over them;
* `grad`: the global-mean loss and reduced gradient of the spatial step,
  and with a data axis over 1 of the spatial x fsdp step, whole;
* `spatial`, `spatialfsdp` (with a data axis over 1), and where named
  `remat` (with remat and microbatches of one row): two steps each,
  seeded draws, with the EMA;
* `s2d` (where named): level 0 in patch space (mode "on" around these
  runs alone, restored after): the `grad` job again, and with `remat`
  also named its two steps.

Into out/<mesh name>/, rank 0 writes the results (`results.npz`); every
rank writes its vectors after each run of steps (`<run><rank>.npz`), to
hold them against the other model ranks'.  The `s2d` job's results carry
the prefix `s2d_`.

This module imports torch and the port only.
"""

import contextlib
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
from unet_tpu_torch.models import unet
from unet_tpu_torch.ops import functional as F
from unet_tpu_torch.ops import s2d as S
from unet_tpu_torch.parallel import distributed
from unet_tpu_torch.parallel import mesh as pmesh
from unet_tpu_torch.parallel import spatial as sp
from unet_tpu_torch.training import trainer

# the steps of `dp`, `fsdp`, `micro` and `cond`
STEPS = dict(batch_size=None, lr=1e-4, weight_decay=0.01, ema_rate=0.9)
SEED = 5


@contextlib.contextmanager
def s2d_on():
    """Level 0 in patch space within the block, the mode restored after."""
    saved = unet._S2D_MODE
    unet.set_s2d_mode("on")
    try:
        yield
    finally:
        unet.set_s2d_mode(saved)


def main(spec_path: str, rank: int) -> None:
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    world = spec["world"]
    distributed.initialize(spec["address"], world, rank, device="cpu",
                           timeout_s=60)
    try:
        if "spatial" in spec:
            run_spatial(spec, rank, world)
        else:
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
    sizes["s2d"] = unet._use_s2d(cfg)
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
    fsdp = mesh.data > 1

    def whole_grad(prefix=""):
        params = model()
        step = pmesh.make_parallel_train_step(
            cfg, TrainConfig(batch_size=local), mesh, diffusion, tp=True,
            fsdp=fsdp, example_params=params)
        state = pmesh.init_state(trainer.Unravel(params), params, mesh,
                                 tp=True, fsdp=fsdp)
        loss, grad = step.value_and_grad(state, batch, inputs["t"],
                                         inputs["noise"])
        placement = state.placement
        grad, = distributed.replicate([grad], placement.size,
                                      placement.sharded, placement.group)
        out[f"{prefix}grad_loss"] = loss.numpy()
        out[f"{prefix}grad"] = state.layout.gather(grad).numpy()
        return step, state

    step, state = whole_grad()
    placement = state.placement
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
    if "s2d" in jobs:
        with s2d_on():
            whole_grad("s2d_")
            if "remat" in jobs:
                train("s2d_remat", remat=True, microbatch=1)

    with open(os.path.join(out_dir, f"mesh{rank}.json"), "w") as f:
        json.dump(dict(data=mesh.data, model=mesh.model,
                       data_rank=mesh.data_rank, model_rank=mesh.model_rank,
                       rows=[mesh.rows.start, mesh.rows.step],
                       fraction=fraction), f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "results.npz"), **out)


def run_spatial(spec, rank, world):
    cfg = UnetConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in spec["cfg"].items()})
    inputs = np.load(spec["inputs"])
    diffusion = GaussianDiffusion.create(
        named_beta_schedule("linear", cfg.max_period), device="cpu")
    for name, model, jobs in spec["spatial"]:
        out_dir = os.path.join(spec["out"], name)
        os.makedirs(out_dir, exist_ok=True)
        spatial_jobs(cfg, inputs, diffusion, pmesh.make_mesh(model=model),
                     jobs, rank, out_dir)


def module_jobs(inputs, shard):
    """Each op of a spatial shard on the rank's rows (see the module's
    docstring): {name: array} of the gathered outputs and gradients."""
    out = {}

    def check(name, fn, x, dy, params):
        rows = sp.rows_of(x.shape[1], shard)
        mine = x[:, rows].clone().requires_grad_()
        params = [torch.from_numpy(p).requires_grad_() for p in params]
        y = fn(mine, *params)
        y.backward(torch.from_numpy(dy)[:, rows])

        def whole(t):  # every rank's rows, back in order
            return torch.cat(list(sp.gather(t.detach(), shard)), dim=1)

        out[f"{name}_y"] = whole(y).numpy()
        out[f"{name}_dx"] = whole(mine.grad).numpy()
        for i, p in enumerate(params):
            grad = p.grad.contiguous()
            torch.distributed.all_reduce(grad, group=shard.group)
            out[f"{name}_dp{i}"] = grad.numpy()

    x = torch.from_numpy(inputs["mod_x"])
    check("conv", lambda a, w, b: F.conv2d(
        a, w.contiguous(memory_format=torch.channels_last), b, shard=shard),
        x, inputs["mod_conv_dy"], [inputs["mod_conv_w"], inputs["mod_conv_b"]])
    for act in ("silu", "none"):
        check(f"gn_{act}", lambda a, g, b: F.group_norm_silu(
            a, g, b, num_groups=8, act=act, shard=shard),
            x, inputs["mod_gn_dy"], [inputs["mod_gamma"], inputs["mod_beta"]])
    check("attn", lambda a: F.qkv_attention(a, 2, shard),
          torch.from_numpy(inputs["mod_qkv"]), inputs["mod_attn_dy"], [])
    xs = S.space_to_depth(x)  # a rank's patch rows are its rows' patches
    check("conv_s2d", lambda a, w, b: S.conv2d_s2d(a, w, b, shard=shard),
          xs, inputs["mod_conv_s2d_dy"],
          [inputs["mod_conv_w"], inputs["mod_conv_b"]])
    check("gn_s2d", lambda a, g, b: S.group_norm_silu_s2d(
        a, g, b, num_groups=8, shard=shard),
        xs, inputs["mod_gn_s2d_dy"], [inputs["mod_gamma"], inputs["mod_beta"]])
    return out


def spatial_jobs(cfg, inputs, diffusion, mesh, jobs, rank, out_dir):
    """The spatial jobs on one mesh (see the module's docstring)."""
    local = inputs["batch"].shape[0] // mesh.data
    batch = pmesh.shard_batch(torch.from_numpy(inputs["batch"]), mesh)
    chunk = pmesh.shard_batch(torch.from_numpy(inputs["chunk"]).transpose(
        0, 1), mesh).transpose(0, 1)
    out = module_jobs(inputs, mesh.shard) if "modules" in jobs else {}

    def model():
        return convert.params_from_flat(inputs["weights"], cfg,
                                        device="cpu")

    def make(fsdp, **tc):
        params = model()
        tc = TrainConfig(**{**STEPS, "batch_size": local, **tc})
        step = pmesh.make_parallel_train_step(
            cfg, tc, mesh, diffusion, spatial=True, fsdp=fsdp,
            example_params=params)
        state = pmesh.init_state(trainer.Unravel(params), params, mesh,
                                 fsdp=fsdp, ema_rate=tc.ema_rate, seed=SEED)
        return step, state

    fsdps = [("spatial", False)] + ([("spatialfsdp", True)]
                                    if mesh.data > 1 else [])

    def grads(prefix=""):
        for name, fsdp in fsdps:
            step, state = make(fsdp)
            loss, grad = step.value_and_grad(state, batch, inputs["t"],
                                             inputs["noise"])
            placement = state.placement
            grad, = distributed.replicate([grad], placement.size,
                                          placement.sharded, placement.group)
            out[f"{prefix}{name}_grad_loss"] = loss.numpy()
            out[f"{prefix}{name}_grad"] = grad.numpy()

    def steps(runs, prefix=""):
        for name, fsdp in runs:
            extra = dict(remat=True, microbatch=1) if name == "remat" else {}
            step, state = make(fsdp, **extra)
            state, losses = step(state, chunk)
            flat, m, v, ema = pmesh.host_state(state)
            name = prefix + name
            out.update({f"{name}_losses": losses.numpy(),
                        f"{name}_flat": flat.numpy(), f"{name}_m": m.numpy(),
                        f"{name}_v": v.numpy(), f"{name}_ema": ema.numpy()})
            np.savez(os.path.join(out_dir, f"{name}{rank}.npz"),
                     flat=state.flat.detach().numpy(), m=state.m.numpy(),
                     v=state.v.numpy(), ema=state.ema.numpy())

    grads()
    remat = [("remat", False)] * ("remat" in jobs)
    steps(fsdps + remat)
    if "s2d" in jobs:
        with s2d_on():
            grads("s2d_")
            steps(remat, "s2d_")
    with open(os.path.join(out_dir, f"mesh{rank}.json"), "w") as f:
        json.dump(dict(data=mesh.data, model=mesh.model,
                       data_rank=mesh.data_rank, model_rank=mesh.model_rank),
                  f)
    if rank == 0:
        np.savez(os.path.join(out_dir, "results.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
