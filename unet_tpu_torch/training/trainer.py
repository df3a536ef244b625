"""Training step and loop pieces (port of unet_tpu/training/trainer.py).

One step is: timesteps and noise from the step's generator -> q_sample ->
U-Net forward (the hand-written GroupNorm and attention kernels) -> MSE ->
backward (their backward kernels) -> AdamW -> EMA.  The parameters (an
`nn.Module` of float32 master parameters), the AdamW moments and the EMA are
updated in place, so a step returns the state object it was given, changed.
Nothing in a step waits for the device; the caller reads the loss when it
needs it.

`make_train_step` runs a step eagerly, op by op.  `make_multi_step` and
`make_flat_multi_step` are the JAX package's one-program chunk of K steps:
on a CUDA device one step is captured into a CUDA graph and replayed K
times (`utils/graphs.py`), on the CPU the same code runs eagerly.  The flat
variant keeps the master parameters and both moments as three flat float32
vectors (`FlatState`) and calls the model through views of them.

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
import math
from typing import Dict, List, Optional

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
from unet_tpu_torch.utils import graphs


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
                  noise_schedule: Optional[str] = "linear",
                  host_rng_state: Optional[np.ndarray] = None
                  ) -> ckpt_io.Checkpoint:
    """The `Checkpoint` of a training state: parameters, AdamW moments,
    step, seed and EMA, with the loader's cursor, the run's settings and,
    for a `--host_rng` run, the host generator's 625-word state."""
    return ckpt_io.Checkpoint(
        params=state.params, cfg=cfg, batch_size=batch_size, step=state.step,
        adam_m=ckpt_io.flatten_tensors(state.m),
        adam_v=ckpt_io.flatten_tensors(state.v), rng_seed=state.seed,
        loader_pos=loader_pos, host_rng_state=host_rng_state, ema=state.ema,
        ema_rate=ema_rate, noise_schedule=noise_schedule)


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
                 compute_dtype=torch.float32, remat: bool = False,
                 apply=unet.apply):
    """`loss_fn(model, x_start, t, noise, y=None)`: the MSE between the
    model's prediction at x_t = q_sample(x_start, t, noise) and the noise.
    `apply` calls the model (`unet.apply`; `Unravel.apply` for a flat
    vector of its parameters)."""
    def loss_fn(model, x_start, t, noise, y=None):
        x_t = diffusion.q_sample(x_start, t, noise)
        pred = apply(model, x_t.to(compute_dtype), t, y,
                     compute_dtype=compute_dtype, remat=remat)
        return F.mse_loss(pred, noise)
    return loss_fn


def _parameters(model) -> List[torch.Tensor]:
    return list(model.parameters())


def _make_grad_fn(loss_fn, tc: TrainConfig, leaves=_parameters):
    """`grad_fn(model, batch, t, noise, y=None) -> (loss, grads)`: the loss
    (a float32 0-dim tensor, detached) and one float32 gradient per tensor
    of `leaves(model)` (the parameters, in `model.parameters()` order; for
    a flat vector, the vector).

    With 0 < tc.microbatch < batch the batch runs as consecutive
    microbatches of that size, gradients summed in float32 and the loss and
    the sum scaled by 1/n: the mean of the microbatch means, which is the
    full batch's mean, at microbatch/B of the activation memory."""
    def value_and_grad(model, batch, t, noise, y):
        params = leaves(model)
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


def _drop_labels(y, generator: torch.Generator, rate: float, world: int = 1,
                 rows: Optional[slice] = None):
    """Per-example classifier-free-guidance label dropout: each label
    becomes the null label -1 with probability `rate`.  Drawn after the
    step's timesteps and noise, so enabling it perturbs nothing else.  With
    `world` > 1 the draw is that of the global batch of `world` times y's
    rows, cut to `rows` (see `_draws`)."""
    if y is None or rate <= 0.0:
        return y
    drop = torch.rand((y.shape[0] * world,) + tuple(y.shape[1:]),
                      generator=generator, device=y.device) < rate
    if rows is not None:
        drop = drop[rows]
    return torch.where(drop, torch.full_like(y, -1), y)


def _setup(cfg: UnetConfig, tc: TrainConfig, diffusion, device,
           apply=unet.apply, leaves=_parameters):
    """(device, diffusion, grad_fn) of a step function: the linear schedule
    when no diffusion is given."""
    device = torch.device(device)
    if diffusion is None:
        diffusion = GaussianDiffusion.create(
            named_beta_schedule("linear", cfg.max_period), device=device)
    grad_fn = _make_grad_fn(
        make_loss_fn(cfg, diffusion, tc.compute_torch_dtype, tc.remat,
                     apply), tc, leaves)
    return device, diffusion, grad_fn


def _adamw_params(tc: TrainConfig) -> optim.AdamWParams:
    return optim.AdamWParams(lr=tc.lr, beta1=tc.beta1, beta2=tc.beta2,
                             eps=tc.eps, weight_decay=tc.weight_decay,
                             anneal_steps=tc.lr_anneal_steps)


def _to_device(a, device, dtype=None):
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    return a.to(device=device, dtype=dtype)


def _draws(state: TrainState, batch, num_timesteps: int, device,
           world: int = 1, rows: Optional[slice] = None):
    """The step's generator, then its timesteps and noise drawn from it.
    With `world` > 1 the batch is one rank's rows of a global batch of
    `world` times as many: the draws are the global batch's, cut to `rows`
    (`parallel.distributed.global_batch`), so that the ranks together draw
    what one device draws for the whole batch."""
    gen = step_generator(state, device)
    shape = (batch.shape[0] * world,) + tuple(batch.shape[1:])
    t = sample_timesteps(gen, shape[0], num_timesteps, device)
    noise = torch.randn(shape, generator=gen, device=device)
    if rows is not None:
        t, noise = t[rows], noise[rows]
    return gen, t, noise


def _update(state: TrainState, grads, step, tc: TrainConfig) -> None:
    """AdamW on the parameters with the 1-based step count `step` (an int
    or a 0-dim tensor on the device), then the EMA."""
    optim.adamw_update(list(state.params.parameters()), grads, state.m,
                       state.v, step, _adamw_params(tc))
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
        state.step += 1
        _update(state, grads, state.step, tc)
        return state, loss

    def train_step(state: TrainState, batch, y=None):
        batch = _to_device(batch, device, torch.float32)
        gen, t, noise = _draws(state, batch, diffusion.num_timesteps, device)
        y = None if y is None else _to_device(y, device, torch.long)
        return step_with(state, batch, t, noise,
                         _drop_labels(y, gen, tc.label_dropout))

    return train_step, step_with


def from_uint8(pixels: torch.Tensor) -> torch.Tensor:
    """float32 u / 127.5 - 1 of uint8 pixels u: the values a `.bin`
    written from them stores (within 1 ulp on a CUDA device, which
    multiplies by the reciprocal; exactly on the CPU)."""
    return pixels.to(torch.float32) / 127.5 - 1.0


class MultiStep:
    """K train steps as K replays of one captured step (`utils/graphs.py`):
    on a CUDA device the first step ever runs eagerly (the warm-up), the
    second is captured, and every step after that is a replay; on the CPU
    every step runs eagerly.  Returned by `make_multi_step`,
    `make_flat_multi_step` and `parallel.mesh.make_parallel_train_step`.

    * `multi(state, batches, labels=None) -> (state, losses)`: K steps over
      batches (K, B, H, W, C) (uint8 pixels where `make_multi_step` was
      given `input_u8`) and, for a class-conditional model, labels (K, B),
      the K losses in one (K,) float32 tensor on the device;
    * `multi.step_with(state, batch, t, noise, y=None) -> (state, loss)`:
      one step with its timesteps and noise given (the parity hook).

    Each step's timesteps, noise and label dropout are drawn outside the
    graph, from the step's generator (`step_generator`), as
    `make_train_step`'s `train_step` draws them, and copied into the
    graph's input tensors: the random stream stays a pure function of
    (seed, step) on both paths.  A step of one rank of `world` draws them
    for the global batch and keeps its `rows` of them (`_draws`); its
    `step_with` takes them for the global batch too.  A rank that holds a
    slice of the height (`height`, spatial sharding) is given its rows at
    the full height, cuts its slice of them on the device (after the copy
    of a uint8 batch) and of the noise.  The graph reads the
    parameters, moments and EMA of the state it was captured with, in
    place; a call with another state, or another batch shape or type, or
    with labels where there were none, captures again.  `graph` is the
    current `graphs.Graph` (its `held` counts the kernels one step
    launches)."""

    def __init__(self, device, diffusion, grad_fn, update, tensors,
                 input_u8: bool, *, label_dropout: float = 0.0,
                 world: int = 1, rows: Optional[slice] = None,
                 height: Optional[slice] = None):
        self.device, self.diffusion = device, diffusion
        self._grad_fn, self._update, self._tensors = grad_fn, update, tensors
        self.input_u8 = input_u8
        self.label_dropout, self.world, self.rows = label_dropout, world, rows
        self.height = height
        self.graph = None
        self._bound = None

    def _bind(self, state, shape, dtype, labeled: bool) -> None:
        """The graph and its input tensors for this state and batch."""
        key = (id(state), tuple(t.data_ptr() for t in self._tensors(state)),
               shape, dtype, labeled)
        if key == self._bound:
            return
        self.graph = None  # frees the old graph's memory pool
        dev = self.device
        self._batch = torch.zeros(shape, dtype=dtype, device=dev)
        self._t = torch.zeros(shape[:1], dtype=torch.long, device=dev)
        self._noise = torch.zeros(self._cut(self._batch).shape,
                                  dtype=torch.float32, device=dev)
        self._y = (torch.zeros(shape[:1], dtype=torch.long, device=dev)
                   if labeled else None)
        self._step = torch.zeros((), dtype=torch.float32, device=dev)
        self._loss = torch.zeros((), dtype=torch.float32, device=dev)

        def step():
            batch = self._cut(self._batch)
            if self.input_u8:
                batch = from_uint8(batch)
            loss, grads = self._grad_fn(state, batch, self._t, self._noise,
                                        self._y)
            self._step.add_(1.0)
            self._update(state, grads, self._step)
            self._loss.copy_(loss)

        self.graph = graphs.Graph(step, dev)
        self._bound = key

    def _cut(self, batch):
        """This rank's slice of the height of a batch at the full height."""
        return batch if self.height is None else batch[:, self.height]

    def _run(self, state, batch, t, noise, y) -> None:
        self._batch.copy_(batch)
        self._t.copy_(t)
        self._noise.copy_(self._cut(noise))
        if y is not None:
            self._y.copy_(y)
        self.graph()
        state.step += 1

    def __call__(self, state, batches, labels=None):
        batches = _to_device(batches, self.device)
        if labels is not None:
            labels = _to_device(labels, self.device, torch.long)
        self._bind(state, tuple(batches.shape[1:]), batches.dtype,
                   labels is not None)
        self._step.fill_(state.step)
        losses = torch.empty(batches.shape[0], dtype=torch.float32,
                             device=self.device)
        for i, batch in enumerate(batches):
            gen, t, noise = _draws(state, batch, self.diffusion.num_timesteps,
                                   self.device, self.world, self.rows)
            y = None if labels is None else _drop_labels(
                labels[i], gen, self.label_dropout, self.world, self.rows)
            self._run(state, batch, t, noise, y)
            losses[i] = self._loss
        return state, losses

    def step_with(self, state, batch, t, noise, y=None):
        batch = _to_device(batch, self.device)
        t = _to_device(t, self.device)
        noise = _to_device(noise, self.device, torch.float32)
        if self.rows is not None:
            t, noise = t[self.rows], noise[self.rows]
        if y is not None:
            y = _to_device(y, self.device, torch.long)
        self._bind(state, tuple(batch.shape), batch.dtype, y is not None)
        self._step.fill_(state.step)
        self._run(state, batch, t, noise, y)
        return state, self._loss.clone()


def _tree_tensors(state: TrainState) -> List[torch.Tensor]:
    ema = [] if state.ema is None else list(state.ema.parameters())
    return list(state.params.parameters()) + state.m + state.v + ema


def make_multi_step(cfg: UnetConfig, tc: TrainConfig,
                    diffusion: Optional[GaussianDiffusion] = None,
                    device="cuda", input_u8: bool = False) -> MultiStep:
    """K train steps of a `TrainState` in one call (see `MultiStep`): the
    JAX package's one-program scan, with the same AdamW, EMA, microbatches
    and remat as `make_train_step`, whose steps it equals.

    input_u8=True takes the batches as uint8 pixels u and computes
    u / 127.5 - 1 on the device, at a quarter of the bytes to copy there.
    For a `.bin` that stores exactly that expression of uint8 pixels (every
    one `data.dataset.write_bin` writes from them) the result is the
    stored float32 within 1 ulp (on a CUDA device the division is a
    multiplication by the reciprocal; on the CPU it is exact).  The
    training CLI probes its first chunk for exactly that before it asks
    for it."""
    device, diffusion, grad_fn = _setup(cfg, tc, diffusion, device)
    return MultiStep(
        device, diffusion,
        lambda state, batch, t, noise, y=None: grad_fn(state.params, batch,
                                                       t, noise, y),
        lambda state, grads, step: _update(state, grads, step, tc),
        _tree_tensors, input_u8, label_dropout=tc.label_dropout)


# ---------------------------------------------------------------------------
# Flat master parameters: the parameters and the AdamW moments each one
# contiguous float32 vector (the reference's arena layout).  The model is
# called through views of it; in bfloat16 the whole vector is cast once.


@dataclasses.dataclass
class FlatState:
    flat: torch.Tensor         # float32 (n,) master parameters, `Unravel`
    #                            order; requires grad (the step's leaf)
    m: torch.Tensor            # float32 (n,) AdamW moments
    v: torch.Tensor
    step: int                  # number of completed optimizer steps
    seed: int                  # base seed of the random stream


def _channels_last(p: torch.Tensor) -> bool:
    return (p.dim() == 4 and not p.is_contiguous()
            and p.is_contiguous(memory_format=torch.channels_last))


class Unravel:
    """The parameters of `model` as views of one flat vector, in
    `unet.param_order` (the `.bin` file's order; a rank's piece of the model
    under TP lacks the biases it does not hold), each parameter's elements
    in its memory order: a convolution kernel kept channels_last (see
    `models.blocks.Conv2d`) as (O, kh, kw, I), so that its view has the
    module's strides.

    * `unravel(flat) -> {name: view}`, the names of `named_parameters()`;
    * `unravel.flatten(model)`: the vector of a model's parameters;
      `unravel.pack(tensors)`: that of tensors shaped like them;
    * `unravel.apply(flat, x, t, y=None, *, compute_dtype, remat)`:
      `unet.apply` with the parameters of `flat`, cast to `compute_dtype`
      with one cast of the whole vector, inside the autograd graph, so the
      gradient comes back as one vector in `flat`'s type."""

    def __init__(self, model: unet.UNet):
        self.model = model
        self.names, self.shapes, self.layouts = [], [], []
        for path, _ in unet.param_order(model.cfg, model.num_classes):
            p = unet.get_param(model, path)
            if p is None:
                continue
            self.names.append(".".join(str(k) for k in path))
            self.shapes.append(tuple(p.shape))
            self.layouts.append(_channels_last(p))
        self.sizes = [math.prod(s) for s in self.shapes]

    def flatten(self, model: unet.UNet) -> torch.Tensor:
        params = dict(model.named_parameters())
        return self.pack([params[n] for n in self.names])

    def pack(self, tensors) -> torch.Tensor:
        """One float32 vector of tensors shaped like the parameters, in
        `names` order (the AdamW moments of a `TrainState`, say), laid out
        as `flatten` lays out the parameters."""
        return torch.cat([
            (t.detach().permute(0, 2, 3, 1) if cl
             else t.detach()).reshape(-1).float()
            for t, cl in zip(tensors, self.layouts)])

    def __call__(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for name, shape, cl, piece in zip(self.names, self.shapes,
                                          self.layouts,
                                          torch.split(flat, self.sizes)):
            if cl:
                o, i, kh, kw = shape
                out[name] = piece.view(o, kh, kw, i).permute(0, 3, 1, 2)
            else:
                out[name] = piece.view(shape)
        return out

    def apply(self, flat, x, t, y=None, *, compute_dtype=None,
              remat: bool = False):
        if compute_dtype is not None and compute_dtype != flat.dtype:
            flat = flat.to(compute_dtype)
        return torch.func.functional_call(self.model, self(flat), (x, t, y),
                                          {"remat": remat})


def flatten_state(params: unet.UNet, *, seed: int = 0, step: int = 0):
    """(FlatState, Unravel) of a model: its parameters copied into one
    float32 vector, zero moments."""
    unravel = Unravel(params)
    flat = unravel.flatten(params).requires_grad_()
    return FlatState(flat=flat, m=torch.zeros_like(flat.detach()),
                     v=torch.zeros_like(flat.detach()), step=step,
                     seed=seed), unravel


def make_flat_multi_step(cfg: UnetConfig, tc: TrainConfig, unravel: Unravel,
                         diffusion: Optional[GaussianDiffusion] = None,
                         device="cuda") -> MultiStep:
    """K train steps of a `FlatState` in one call (see `MultiStep`): the
    gradient as one flat vector, AdamW over the whole vector at once
    (`optim.adamw_update_flat`), microbatches honoured; no EMA, as the JAX
    package's `make_flat_multi_step`."""
    device, diffusion, grad_fn = _setup(cfg, tc, diffusion, device,
                                        apply=unravel.apply,
                                        leaves=lambda flat: [flat])
    hp = _adamw_params(tc)
    return MultiStep(
        device, diffusion,
        lambda state, batch, t, noise, y=None: grad_fn(state.flat, batch, t,
                                                       noise, y),
        lambda state, grads, step: optim.adamw_update_flat(
            state.flat, grads[0], state.m, state.v, step, hp),
        lambda state: [state.flat, state.m, state.v], False,
        label_dropout=tc.label_dropout)


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
        state.step += 1
        _update(state, grads, state.step, tc)
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
