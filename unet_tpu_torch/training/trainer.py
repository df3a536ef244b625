"""Training step and loop pieces (port of unet_tpu/training/trainer.py).

One step is: timesteps and noise from the step's generator -> q_sample ->
U-Net forward (the hand-written GroupNorm and attention kernels) -> MSE ->
backward (their backward kernels) -> AdamW -> EMA.  The JAX package compiles
it into one program with donated state; here it runs eagerly, and the
parameters (an `nn.Module` of float32 master parameters), the AdamW moments
and the EMA are updated in place, so `step_with` returns the state object it
was given, changed.  Nothing in a step waits for the device; the caller
reads the loss when it needs it.

The random stream is a pure function of (seed, step): each step draws its
timesteps, then its noise, then the label dropout from a `torch.Generator`
on the training device seeded by `step_seed(seed, step)`.  A run resumed at
step N therefore continues the same trajectory with nothing but the seed
and the step count stored (the JAX package's `step_keys` contract).  The
numbers differ from the JAX package's; parity goes through `step_with`,
which takes t and the noise as inputs.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from unet_tpu_torch.config import TrainConfig, UnetConfig
from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule,
                                               sample_timesteps)
from unet_tpu_torch.io import checkpoint as ckpt_io
from unet_tpu_torch.models import unet
from unet_tpu_torch.ops import functional as F
from unet_tpu_torch.training import optim


@dataclasses.dataclass
class TrainState:
    params: unet.UNet          # float32 master parameters
    m: List[torch.Tensor]      # AdamW moments, float32, params' order
    v: List[torch.Tensor]
    step: int                  # number of completed optimizer steps
    seed: int                  # base seed of the random stream (constant)
    # float32 exponential moving average of the parameters, or None
    ema: Optional[unet.UNet] = None


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s generator: a pure function of both."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def step_generator(state: TrainState, device) -> torch.Generator:
    """The generator of the step the state is about to take."""
    return torch.Generator(device=device).manual_seed(
        step_seed(state.seed, state.step))


def init_state(params: unet.UNet, *, seed: int = 0, step: int = 0,
               ema_rate: float = 0.0, ema: Optional[unet.UNet] = None
               ) -> TrainState:
    """Fresh AdamW moments.  ema_rate > 0 seeds the EMA from `params` (or
    takes `ema`, when resuming a checkpoint that carries one); the EMA is a
    copy, never an alias of the parameters."""
    m, v = optim.init_moments(list(params.parameters()))
    if ema is None and ema_rate > 0.0:
        ema = copy.deepcopy(params).float()
    if ema is not None:
        ema.requires_grad_(False)
    return TrainState(params=params, m=m, v=v, step=step, seed=seed,
                      ema=ema)



def to_checkpoint(state: TrainState, cfg: UnetConfig, *, batch_size: int,
                  loader_pos: int = 0, ema_rate: float = 0.0,
                  noise_schedule: Optional[str] = "linear"
                  ) -> ckpt_io.Checkpoint:
    """The `Checkpoint` of a training state: parameters, AdamW moments,
    step, seed and EMA, with the loader's cursor and the run's settings."""
    return ckpt_io.Checkpoint(
        params=state.params, cfg=cfg, batch_size=batch_size, step=state.step,
        adam_m=ckpt_io.flatten_tensors(state.m),
        adam_v=ckpt_io.flatten_tensors(state.v), rng_seed=state.seed,
        loader_pos=loader_pos, ema=state.ema, ema_rate=ema_rate,
        noise_schedule=noise_schedule)


def from_checkpoint(ckpt: ckpt_io.Checkpoint, *, seed: int = 0,
                    ema_rate: float = 0.0) -> TrainState:
    """The training state a checkpoint resumes: its parameters, step,
    moments (zeros when it has none), seed (`seed` when it records none)
    and EMA (a fresh copy of the parameters when ema_rate > 0 and it has
    none)."""
    state = init_state(
        ckpt.params, seed=seed if ckpt.rng_seed is None else ckpt.rng_seed,
        step=ckpt.step, ema_rate=ema_rate, ema=ckpt.ema)
    if ckpt.adam_m is not None:
        state.m = ckpt_io.unflatten_like(ckpt.adam_m, ckpt.params)
        state.v = ckpt_io.unflatten_like(ckpt.adam_v, ckpt.params)
    return state

@torch.no_grad()
def _ema_step(ema: Optional[unet.UNet], params: unet.UNet,
              rate: float) -> None:
    """ema <- rate * ema + (1 - rate) * params, float32, in place, after
    the optimizer step."""
    if ema is None or rate <= 0.0:
        return
    e = list(ema.parameters())
    torch._foreach_mul_(e, rate)
    torch._foreach_add_(e, [p.float() for p in params.parameters()],
                        alpha=1.0 - rate)


def make_loss_fn(cfg: UnetConfig, diffusion: GaussianDiffusion,
                 compute_dtype=torch.float32, remat: bool = False):
    """`loss_fn(model, x_start, t, noise, y=None)`: the MSE between the
    model's prediction at x_t = q_sample(x_start, t, noise) and the noise."""
    def loss_fn(model, x_start, t, noise, y=None):
        x_t = diffusion.q_sample(x_start, t, noise)
        pred = unet.apply(model, x_t.to(compute_dtype), t, y,
                          compute_dtype=compute_dtype, remat=remat)
        return F.mse_loss(pred, noise)
    return loss_fn


def _make_grad_fn(loss_fn, tc: TrainConfig):
    """`grad_fn(model, batch, t, noise, y=None) -> (loss, grads)`: the loss
    (a float32 0-dim tensor, detached) and one float32 gradient per
    parameter, in `model.parameters()` order.

    With 0 < tc.microbatch < batch the batch runs as consecutive
    microbatches of that size, gradients summed in float32 and the loss and
    the sum scaled by 1/n: the mean of the microbatch means, which is the
    full batch's mean, at microbatch/B of the activation memory."""
    def value_and_grad(model, batch, t, noise, y):
        params = list(model.parameters())
        loss = loss_fn(model, batch, t, noise, y)
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), [g.float() for g in grads]

    def grad_fn(model, batch, t, noise, y=None):
        mb = tc.microbatch
        n = batch.shape[0] // mb if mb else 1
        if mb and n * mb != batch.shape[0]:
            raise ValueError(f"microbatch {mb} does not divide batch "
                             f"{batch.shape[0]}")
        if n == 1:
            return value_and_grad(model, batch, t, noise, y)
        l_acc, g_acc = None, None
        for i in range(n):
            part = slice(i * mb, (i + 1) * mb)
            loss, grads = value_and_grad(
                model, batch[part], t[part], noise[part],
                None if y is None else y[part])
            if g_acc is None:
                l_acc, g_acc = loss.float(), grads
            else:
                l_acc = l_acc + loss
                torch._foreach_add_(g_acc, grads)
        inv = 1.0 / n
        torch._foreach_mul_(g_acc, inv)
        return l_acc * inv, g_acc

    return grad_fn


def _drop_labels(y, generator: torch.Generator, rate: float):
    """Per-example classifier-free-guidance label dropout: each label
    becomes the null label -1 with probability `rate`.  Drawn after the
    step's timesteps and noise, so enabling it perturbs nothing else."""
    if y is None or rate <= 0.0:
        return y
    drop = torch.rand(y.shape, generator=generator, device=y.device) < rate
    return torch.where(drop, torch.full_like(y, -1), y)


def _setup(cfg: UnetConfig, tc: TrainConfig, diffusion, device):
    """(device, diffusion, grad_fn) of a step function: the linear schedule
    when no diffusion is given."""
    device = torch.device(device)
    if diffusion is None:
        diffusion = GaussianDiffusion.create(
            named_beta_schedule("linear", cfg.max_period), device=device)
    grad_fn = _make_grad_fn(
        make_loss_fn(cfg, diffusion, tc.compute_torch_dtype, tc.remat), tc)
    return device, diffusion, grad_fn


def _to_device(a, device, dtype=None):
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    return a.to(device=device, dtype=dtype)


def _draws(state: TrainState, batch, num_timesteps: int, device):
    """The step's generator, then its timesteps and noise drawn from it."""
    gen = step_generator(state, device)
    t = sample_timesteps(gen, batch.shape[0], num_timesteps, device)
    return gen, t, torch.randn(batch.shape, generator=gen, device=device)


def _update(state: TrainState, grads, tc: TrainConfig) -> None:
    """AdamW on the parameters with the 1-based step count, then the EMA."""
    hp = optim.AdamWParams(lr=tc.lr, beta1=tc.beta1, beta2=tc.beta2,
                           eps=tc.eps, weight_decay=tc.weight_decay,
                           anneal_steps=tc.lr_anneal_steps)
    state.step += 1
    optim.adamw_update(list(state.params.parameters()), grads, state.m,
                       state.v, state.step, hp)
    _ema_step(state.ema, state.params, tc.ema_rate)


def make_train_step(cfg: UnetConfig, tc: TrainConfig,
                    diffusion: Optional[GaussianDiffusion] = None,
                    device="cuda"):
    """Returns `(train_step, step_with)`:

    * `train_step(state, batch, y=None) -> (state, loss)` draws the step's
      timesteps, noise and label dropout from the step's generator;
    * `step_with(state, batch, t, noise, y=None) -> (state, loss)` takes
      them as inputs (the cross-framework parity hook).

    batch: (B, H, W, C) float32 NHWC in [-1, 1], a tensor or a numpy array;
    the state is updated in place and returned."""
    device, diffusion, grad_fn = _setup(cfg, tc, diffusion, device)

    def step_with(state: TrainState, batch, t, noise, y=None):
        batch = _to_device(batch, device, torch.float32)
        t, noise = _to_device(t, device), _to_device(noise, device,
                                                     torch.float32)
        y = None if y is None else _to_device(y, device, torch.long)
        loss, grads = grad_fn(state.params, batch, t, noise, y)
        _update(state, grads, tc)
        return state, loss

    def train_step(state: TrainState, batch, y=None):
        batch = _to_device(batch, device, torch.float32)
        gen, t, noise = _draws(state, batch, diffusion.num_timesteps, device)
        y = None if y is None else _to_device(y, device, torch.long)
        return step_with(state, batch, t, noise,
                         _drop_labels(y, gen, tc.label_dropout))

    return train_step, step_with


def make_multi_step(cfg: UnetConfig, tc: TrainConfig,
                    diffusion: Optional[GaussianDiffusion] = None,
                    device="cuda"):
    """Returns `multi_step(state, batches) -> (state, losses)`: K train
    steps over batches (K, B, H, W, C), the K losses as one (K,) tensor.
    The JAX package scans them in one program; here it is a loop."""
    train_step, _ = make_train_step(cfg, tc, diffusion, device)

    def multi_step(state: TrainState, batches):
        losses = []
        for batch in batches:
            state, loss = train_step(state, batch)
            losses.append(loss)
        return state, torch.stack(losses)

    return multi_step


def tree_sq_norm(tensors) -> torch.Tensor:
    """Sum of squared L2 norms over all tensors, float32: the reference's
    norm metric, which is the sum of squares and not its square root."""
    return sum(t.float().square().sum() for t in tensors)


def make_train_step_aux(cfg: UnetConfig, tc: TrainConfig,
                        diffusion: Optional[GaussianDiffusion] = None,
                        device="cuda"):
    """Like `train_step`, but returns `(state, {"loss", "grad_norm",
    "param_norm"})`, the norms those of the gradients and of the
    parameters before the update."""
    device, diffusion, grad_fn = _setup(cfg, tc, diffusion, device)

    def train_step(state: TrainState, batch):
        batch = _to_device(batch, device, torch.float32)
        _, t, noise = _draws(state, batch, diffusion.num_timesteps, device)
        loss, grads = grad_fn(state.params, batch, t, noise)
        aux = {"loss": loss, "grad_norm": tree_sq_norm(grads),
               "param_norm": tree_sq_norm(
                   p.detach() for p in state.params.parameters())}
        _update(state, grads, tc)
        return state, aux

    return train_step


def device_peak_memory_mib(device="cuda") -> Optional[float]:
    """Peak device memory allocated by PyTorch in MiB
    (`torch.cuda.max_memory_allocated`); None for a CPU device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / (1024 * 1024)


class LossCounter:
    """Running mean of the losses since the last flush."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def add(self, loss) -> None:
        self.total += float(loss)
        self.count += 1

    def mean_and_reset(self) -> float:
        mean = self.total / max(self.count, 1)
        self.total, self.count = 0.0, 0
        return mean
