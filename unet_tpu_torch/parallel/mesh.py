"""Data-parallel training over ranks (port of the data axis of
unet_tpu/parallel/mesh.py).

The JAX package shards a jitted step with GSPMD: the batch over a 'data'
mesh axis, the parameters replicated (DP) or split leaf by leaf (FSDP), and
XLA places the collectives.  Here each rank is one process on one device
(`parallel/distributed.py`) and the step says its collectives itself.  The
contract is the JAX package's: N ranks compute the math of one device with
the global batch.

The step trains the flat state of `training/trainer.py` (`Unravel`: every
parameter a view of one float32 vector, the model called through them):

* DP: every rank holds the whole vector, both AdamW moments and the EMA.
  The gradient comes back from autograd as one vector; one all-reduce sums
  it over the ranks (and one more the loss), and AdamW and the EMA run on
  the whole vector, the same on every rank.
* FSDP (ZeRO-3): the vector is padded to a multiple of N and split evenly;
  each rank owns one piece of the master parameters (`ParallelState.master`,
  a view of its piece of the working vector), of both moments and of the
  EMA.  The gradient is reduce-scattered, AdamW and the EMA update the
  rank's piece, and an all-gather into the working vector gives the next
  forward every piece.  This splits everything evenly where the JAX
  package splits each leaf along its largest divisible dimension and
  replicates the rest (`shard_fraction` 1.0 here): AdamW and the EMA work
  element by element, so the math is the same.

The batch size and the microbatch of a `TrainConfig` are per rank, as in
the JAX package; a rank runs its microbatches over its own rows, and the
mean of the ranks' means is the global mean.  A step's timesteps, noise
and label dropout are drawn for the global batch from the step's
generator (`trainer.step_generator`) and cut to the rank's rows
(`distributed.global_batch`): N ranks fed the shards of a loader follow
the trajectory of one process at the global batch.  The loss a step
returns is the global mean.  On a CUDA device the step is captured with its
collectives and replayed (`trainer.MultiStep`, `utils/graphs.py`); on the
CPU it runs eagerly.

The model axis (Megatron TP, the 2-D tp x fsdp split, spatial sharding)
is not ported: `make_mesh(model > 1)`, `tp_sharding` and
`tp_fsdp_sharding` raise, naming ROADMAP.md's Queue 1 item 8b.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from unet_tpu_torch.config import TrainConfig, UnetConfig
from unet_tpu_torch.diffusion.gaussian import GaussianDiffusion
from unet_tpu_torch.models import unet
from unet_tpu_torch.parallel import distributed
from unet_tpu_torch.training import optim, trainer

_MODEL_AXIS = ("the model axis (tensor and spatial parallelism) is not "
               "ported to unet_tpu_torch yet (ROADMAP.md, Queue 1 item 8b)")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: `data` ranks of the default process group, this
    process being rank `rank` on `device`."""
    data: int
    rank: int
    device: torch.device

    @property
    def rows(self) -> slice:
        """This rank's rows of a global batch."""
        return distributed.global_batch(self.rank, self.data)


def make_mesh(data: int = 0, model: int = 1) -> Mesh:
    """The mesh over the ranks of the process group `distributed.initialize`
    joined.  data=0 means all of them; a data axis over some of them only,
    or a model axis, raises."""
    if model != 1:
        raise NotImplementedError(f"make_mesh(model={model}): {_MODEL_AXIS}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize first")
    rank, world = distributed.world()
    if data == 0:
        data = world
    if data != world:
        raise ValueError(f"data axis {data} != {world} ranks: the data "
                         "axis spans every rank")
    return Mesh(data=data, rank=rank, device=distributed.device())


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a flat vector of `size` elements lies over the data axis: whole
    on every rank, or (`sharded`) padded to `shards` * `shard` elements and
    split into `shards` pieces of `shard`, rank `index` holding piece
    `index` (one piece, the whole vector, on a data axis of one rank; the
    collectives run all the same)."""
    size: int
    shards: int
    index: int
    sharded: bool

    @property
    def shard(self) -> int:
        return -(-self.size // self.shards)

    @property
    def padded(self) -> int:
        return self.shard * self.shards

    @property
    def piece(self) -> slice:
        return slice(self.index * self.shard, (self.index + 1) * self.shard)


def replicated(mesh: Mesh, size: int) -> Placement:
    """A vector of `size` elements whole on every rank."""
    return Placement(size=size, shards=1, index=0, sharded=False)


def fsdp_sharding(mesh: Mesh, size: int) -> Placement:
    """A vector of `size` elements split evenly over the data axis (ZeRO-3:
    every element sharded, the tail padded)."""
    return Placement(size=size, shards=mesh.data, index=mesh.rank,
                     sharded=True)


def tp_sharding(mesh: Mesh, params):
    raise NotImplementedError(f"tp_sharding: {_MODEL_AXIS}")


def tp_fsdp_sharding(mesh: Mesh, params):
    raise NotImplementedError(f"tp_fsdp_sharding: {_MODEL_AXIS}")


def param_sharding(mesh: Mesh, size: int, *, fsdp: bool = False,
                   tp: bool = False) -> Placement:
    """The placement `make_parallel_train_step` gives the flat parameters,
    the moments and the EMA."""
    if tp:
        return tp_sharding(mesh, size)
    return fsdp_sharding(mesh, size) if fsdp else replicated(mesh, size)


def shard_fraction(placement: Placement) -> float:
    """The fraction of the parameters' elements that are sharded: 1.0 under
    FSDP (the even split leaves nothing whole), 0.0 under DP."""
    return 1.0 if placement.sharded else 0.0


@dataclasses.dataclass
class ParallelState:
    """A rank's training state.  `flat` is the whole float32 parameter
    vector the forward reads (`Unravel` order; padded to
    `placement.padded` under FSDP), requiring grad.  Under DP `m`, `v` and
    `ema` are whole too; under FSDP they are the rank's pieces, and the
    rank's master parameters are `master`, its piece of `flat`."""
    flat: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    step: int
    seed: int
    placement: Placement
    ema: Optional[torch.Tensor] = None

    @property
    def master(self) -> torch.Tensor:
        if not self.placement.sharded:
            return self.flat
        return self.flat.detach()[self.placement.piece]


def shard_state(flat: torch.Tensor, mesh: Mesh, *, fsdp: bool = False,
                m: Optional[torch.Tensor] = None,
                v: Optional[torch.Tensor] = None,
                ema: Optional[torch.Tensor] = None, step: int = 0,
                seed: int = 0) -> ParallelState:
    """The rank's `ParallelState` of whole vectors that every rank holds
    alike (from one seed or one checkpoint): the parameters `flat`, the
    moments (zeros when None) and the EMA (none when None), as
    `param_sharding` places them, on the mesh's device."""
    size = flat.numel()
    placement = param_sharding(mesh, size, fsdp=fsdp)

    def place(vec, whole):
        vec = vec.detach().to(device=mesh.device, dtype=torch.float32)
        if placement.padded != size:
            vec = torch.cat([vec, vec.new_zeros(placement.padded - size)])
        return vec.clone() if whole else vec[placement.piece].clone()

    zeros = torch.zeros(size)
    return ParallelState(
        flat=place(flat, True).requires_grad_(),
        m=place(zeros if m is None else m, not placement.sharded),
        v=place(zeros if v is None else v, not placement.sharded),
        ema=None if ema is None else place(ema, not placement.sharded),
        step=step, seed=seed, placement=placement)


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global batch."""
    return batch[mesh.rows]


def init_state(unravel: trainer.Unravel, params: unet.UNet, mesh: Mesh, *,
               fsdp: bool = False, ema_rate: float = 0.0, seed: int = 0,
               step: int = 0, m=None, v=None,
               ema: Optional[unet.UNet] = None) -> ParallelState:
    """The rank's state of a model's parameters (laid out by `unravel`):
    fresh moments, or `m` and `v` (tensors shaped like the parameters, in
    their order, as a `trainer.TrainState` holds them); the EMA `ema`, or a
    copy of the parameters when ema_rate > 0 and none is given."""
    flat = unravel.flatten(params)
    if ema is not None:
        ema = unravel.flatten(ema)
    elif ema_rate > 0.0:
        ema = flat
    return shard_state(flat, mesh, fsdp=fsdp,
                       m=None if m is None else unravel.pack(m),
                       v=None if v is None else unravel.pack(v),
                       ema=ema, step=step, seed=seed)


def host_state(state: ParallelState):
    """(flat, m, v, ema): whole float32 host copies of a state's vectors
    (ema None without one).  A collective under FSDP: every rank calls
    it."""
    size = state.placement.size
    flat = state.flat.detach()[:size].cpu()
    m, v, ema = distributed.replicate([state.m, state.v, state.ema], size,
                                      state.placement.sharded)
    return flat, m, v, ema


def tree_state(unravel: trainer.Unravel, flat, m, v, ema, *, step: int,
               seed: int) -> trainer.TrainState:
    """The `trainer.TrainState` of whole host vectors (`host_state`), on
    the CPU: a model with the parameters of `flat`, the moments as tensors
    shaped like them, the EMA as a model; what a checkpoint is written
    from."""
    def model(vec):
        out = copy.deepcopy(unravel.model).to("cpu")
        mine = dict(out.named_parameters())
        with torch.no_grad():
            for name, view in unravel(vec).items():
                mine[name].copy_(view)
        return out

    def tensors(vec):
        return [view.clone() for view in unravel(vec).values()]

    return trainer.TrainState(
        params=model(flat), m=tensors(m), v=tensors(v), step=step, seed=seed,
        ema=None if ema is None else model(ema).requires_grad_(False))


class ParallelStep(trainer.MultiStep):
    """The step of one rank (see the module's docstring): a
    `trainer.MultiStep` over a `ParallelState`, called with this rank's
    rows, (K, B, H, W, C), and returning the K global-mean losses.  Also
    `value_and_grad(state, batch, t, noise, y=None) -> (loss, grad)`: the
    global-mean loss and the gradient after the reduction (whole under DP,
    the rank's piece under FSDP), with t and noise given for the global
    batch, updating nothing (the parity hook)."""

    def value_and_grad(self, state: ParallelState, batch, t, noise, y=None):
        dev = self.device
        batch = trainer._to_device(batch, dev, torch.float32)
        t = trainer._to_device(t, dev)[self.rows]
        noise = trainer._to_device(noise, dev, torch.float32)[self.rows]
        if y is not None:
            y = trainer._to_device(y, dev, torch.long)
        loss, (grad,) = self._grad_fn(state, batch, t, noise, y)
        return loss, grad


def make_parallel_train_step(cfg: UnetConfig, tc: TrainConfig, mesh: Mesh,
                             diffusion: Optional[GaussianDiffusion] = None,
                             *, fsdp: bool = False, class_cond: bool = False,
                             example_params: Optional[unet.UNet] = None,
                             input_u8: bool = False) -> ParallelStep:
    """The step of this rank (`ParallelStep`): DP, or FSDP with `fsdp`.
    `example_params` is the model whose parameters the flat vector holds
    (its layout, and the module the forward calls); `class_cond` takes
    labels (with tc.label_dropout); `input_u8` takes uint8 pixels, as
    `trainer.make_multi_step`.  Build the state with `init_state` or
    `shard_state`."""
    if example_params is None:
        raise ValueError("make_parallel_train_step needs example_params "
                         "(the model whose flat parameters it trains)")
    unravel = trainer.Unravel(example_params)
    size = sum(unravel.sizes)
    placement = param_sharding(mesh, size, fsdp=fsdp)
    if placement.padded == size:
        apply = unravel.apply
    else:
        def apply(flat, *args, **kwargs):
            return unravel.apply(flat[:size], *args, **kwargs)
    device, diffusion, grad_fn = trainer._setup(
        cfg, tc, diffusion, mesh.device, apply=apply,
        leaves=lambda flat: [flat])
    hp = trainer._adamw_params(tc)
    inv = 1.0 / mesh.data

    def reduced_grad(state, batch, t, noise, y=None):
        loss, (grad,) = grad_fn(state.flat, batch, t, noise, y)
        dist.all_reduce(loss)
        loss.mul_(inv)
        if placement.sharded:
            piece = torch.empty(placement.shard, dtype=grad.dtype,
                                device=grad.device)
            distributed.reduce_scatter(piece, grad)
            grad = piece
        else:
            dist.all_reduce(grad)
        return loss, [grad.mul_(inv)]

    @torch.no_grad()
    def update(state, grads, step):
        master = state.master
        optim.adamw_update_flat(master, grads[0], state.m, state.v, step, hp)
        if state.ema is not None and tc.ema_rate > 0.0:
            state.ema.mul_(tc.ema_rate).add_(master, alpha=1.0 - tc.ema_rate)
        if placement.sharded:
            distributed.all_gather(state.flat.detach(), master)

    return ParallelStep(
        device, diffusion, reduced_grad, update,
        tensors=lambda s: [s.flat, s.m, s.v] + ([] if s.ema is None
                                                else [s.ema]),
        input_u8=input_u8,
        label_dropout=tc.label_dropout if class_cond else 0.0,
        world=mesh.data, rows=mesh.rows)
