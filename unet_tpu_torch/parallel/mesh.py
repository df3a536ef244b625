"""Parallel training over ranks (port of unet_tpu/parallel/mesh.py).

The JAX package shards a jitted step with GSPMD: the batch over a 'data'
mesh axis, the parameters replicated (DP) or split leaf by leaf (FSDP), or
Megatron-style over a 'model' axis (TP, and both: tp x fsdp), and XLA
places the collectives.  Here each rank is one process on one device
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

The model axis: `make_mesh(data, model)` lays the ranks out as the JAX
package's `devices.reshape(data, model)`, rank d * model + m, with a
process group for each axis.  The model ranks of one data index take the
same rows, draws and labels; the batch's reductions (the loss, the
gradient's all-reduce or reduce-scatter, FSDP's all-gather) run over the
data group.  The model axis has two uses, never both at once:

* TP (`tp=True`): Megatron over the model group (`parallel/tensor.py`).
  A rank trains its piece of the model (`Layout`, from `tp_sharding`): the
  pieces of the blocks that split and every other leaf whole, flattened
  into the rank's vector by `trainer.Unravel` of the piece.  Every model
  rank computes the gradient of the leaves it holds whole, and the card's
  convolution backward does not repeat its bits from call to call, so one
  all-reduce over the model group averages that gradient (`Layout.kept`)
  before the data axis's reduction: the copies stay equal by
  construction, whatever the backward's algorithms.  The JAX package
  shards conv1, emb and qkv by output and conv2 and proj by input and
  replicates the rest; the port does the same by blocks (a block whose
  widths do not divide stays whole, as a leaf does there), and differs in
  two places: gn2's affine is cut with the channels it scales (no
  collective, where JAX's replicated copy needs its gradient summed), and
  the bias of conv2 and proj is held by model rank 0 alone, which adds it
  once inside its partial product.
* tp x fsdp (`tp=True, fsdp=True`): the rank's vector is split evenly over
  its data group, as FSDP splits the whole one; the JAX package splits the
  largest remaining dimension of each leaf instead, which is the same math
  for AdamW and the EMA.

* spatial (`spatial=True`, the JAX package's activations sharded
  `P("data", "model", None, None)`): model rank m holds rows [m H/N,
  (m+1) H/N) of every activation of its data index's samples
  (`parallel/spatial.py`) and the whole model, its vector the one-device
  vector (a `Layout` of one model rank).  The step is given the rank's
  rows at the full height and cuts its slice on the device (the noise
  too).  The rank's loss is the mean over its slice, and every parameter
  is used by every model rank on its own rows, so the loss and the whole
  gradient are summed over every rank (one all-reduce) and scaled by
  1/(data N) (the slices are equal: the CLI's rule).  spatial x fsdp sums
  the gradient over the model group, then reduce-scatters it over the data
  axis as FSDP does, and splits the vector as FSDP does.  One summed
  gradient keeps the model ranks' copies equal by construction.

DP and FSDP are TP over one model rank: every step goes through a
`Layout`, which over one rank splits nothing (the whole model, its vector
in the one-device order) and runs no model-axis collective; spatial
sharding over one model rank is DP itself.

A checkpoint is written from whole host vectors (`host_state`): under TP
the pieces are gathered over the model group and put back in `.bin`
order, so that it is the file one device writes (under spatial sharding
the rank's vector is already that); `init_state` cuts a rank's pieces from
whole vectors, so a run resumes under another layout.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from unet_tpu_torch.config import TrainConfig, UnetConfig
from unet_tpu_torch.diffusion.gaussian import GaussianDiffusion
from unet_tpu_torch.models import unet
from unet_tpu_torch.parallel import distributed, spatial as sp, tensor
from unet_tpu_torch.training import optim, trainer


@dataclasses.dataclass(frozen=True)
class Mesh:
    """`data` x `model` ranks of the default process group, rank d * model
    + m at data index d and model index m; this process is rank `rank`, on
    `device`.  `data_group` holds the data ranks of this model index (those
    that split the batch), `model_group` the model ranks of this data index
    (those that split the model); a group of every rank is None (the
    default group), and so is the model group of a model axis of one rank,
    which runs no collective."""
    data: int
    rank: int
    device: torch.device
    model: int = 1
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def rows(self) -> slice:
        """This rank's rows of a global batch (those of its data index)."""
        return distributed.global_batch(self.data_rank, self.data)

    @property
    def shard(self) -> tensor.Shard:
        """This rank's place on the model axis."""
        return tensor.Shard(self.model, self.model_rank, self.model_group)


def make_mesh(data: int = 0, model: int = 1) -> Mesh:
    """The mesh over the ranks of the process group `distributed.initialize`
    joined: `model` ranks on the model axis and `data` (0: the rest) on the
    data axis, which together span every rank.  Every rank calls it: it
    creates the groups of both axes."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.distributed.initialize first")
    rank, world = distributed.world()
    if model < 1 or world % model:
        raise ValueError(f"model axis {model} does not divide {world} ranks")
    if data == 0:
        data = world // model
    if data * model != world:
        raise ValueError(f"{data} x {model} != {world} ranks: the data and "
                         "model axes span every rank")
    model_group = None if model == 1 else distributed.subgroup(
        [[d * model + m for m in range(model)] for d in range(data)])
    data_group = distributed.subgroup(
        [[d * model + m for d in range(data)] for m in range(model)])
    return Mesh(data=data, rank=rank, device=distributed.device(),
                model=model, data_group=data_group, model_group=model_group)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a flat vector of `size` elements lies over the data axis: whole
    on every rank, or (`sharded`) padded to `shards` * `shard` elements and
    split into `shards` pieces of `shard`, data rank `index` holding piece
    `index` (one piece, the whole vector, on a data axis of one rank; the
    collectives run all the same), over the data group `group`."""
    size: int
    shards: int
    index: int
    sharded: bool
    group: Optional[object] = None

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
    return Placement(size=size, shards=1, index=0, sharded=False,
                     group=mesh.data_group)


def fsdp_sharding(mesh: Mesh, size: int) -> Placement:
    """A vector of `size` elements split evenly over the data axis (ZeRO-3:
    every element sharded, the tail padded)."""
    return Placement(size=size, shards=mesh.data, index=mesh.data_rank,
                     sharded=True, group=mesh.data_group)


class Layout:
    """One rank's pieces of a whole model's parameters under Megatron TP
    (see the module's docstring): `model`, the piece itself (a `unet.UNet`
    on the meta device, whose blocks run the collectives over the shard's
    group; `local.apply` calls it with the parameters of a vector),
    `local`, the `trainer.Unravel` of its vector (`size` elements),
    `whole`, that of the whole model, and `splits`, how each split leaf
    lies over the model group (`tensor.Split`, by `whole` name; every
    other leaf is whole on every rank).  Over one rank nothing splits:
    `model` is the whole model and its vector the one-device vector.

    * `kept()`: the positions in the rank's vector of the leaves it holds
      whole (a tensor of indices);
    * `take(vec)`: the rank's vector of a whole vector;
    * `join(vecs)`: the whole vector of every model rank's vectors, in
      rank order;
    * `gather(vec)`: `join` of every model rank's `vec`, which each passes
      (a collective over the model group)."""

    def __init__(self, params: unet.UNet, shard: tensor.Shard):
        self.shard = shard
        self.whole = trainer.Unravel(params)

        def piece(index, group):
            with torch.device("meta"):
                return unet.UNet(params.cfg, params.num_classes,
                                 shard=tensor.Shard(shard.size, index, group))

        self.model = piece(shard.index, shard.group)
        self.local = trainer.Unravel(self.model)
        self.size = sum(self.local.sizes)
        self.ranks = [self.local if m == shard.index
                      else trainer.Unravel(piece(m, None))
                      for m in range(shard.size)]
        self.splits = {
            f"{prefix}.{name}": split
            for prefix, module in self.model.named_modules()
            for name, split in getattr(module, "splits", {}).items()}

    def kept(self) -> torch.Tensor:
        offsets = itertools.accumulate(self.local.sizes, initial=0)
        return torch.cat([
            torch.arange(start, start + size)
            for name, start, size in zip(self.local.names, offsets,
                                         self.local.sizes)
            if name not in self.splits])

    def take(self, vec: torch.Tensor) -> torch.Tensor:
        views = self.whole(vec)
        return self.local.pack([
            tensor.take(views[n], self.splits[n], self.shard)
            if n in self.splits else views[n] for n in self.local.names])

    def join(self, vecs: List[torch.Tensor]) -> torch.Tensor:
        views = [unravel(vec) for unravel, vec in zip(self.ranks, vecs)]
        return self.whole.pack([
            tensor.join([v.get(n) for v in views], self.splits[n])
            if n in self.splits else views[0][n] for n in self.whole.names])

    def gather(self, vec: torch.Tensor) -> torch.Tensor:
        if self.shard.size == 1:
            return self.join([vec])
        longest = max(sum(unravel.sizes) for unravel in self.ranks)
        mine = torch.zeros(longest, dtype=vec.dtype, device=vec.device)
        mine[:vec.numel()] = vec
        every = torch.empty(self.shard.size * longest, dtype=vec.dtype,
                            device=vec.device)
        distributed.all_gather(every, mine, self.shard.group)
        return self.join([row[:sum(unravel.sizes)] for unravel, row in
                          zip(self.ranks, every.view(self.shard.size, -1))])

    @property
    def fraction(self) -> float:
        """The fraction of the whole model's elements in split leaves."""
        split = sum(size for name, size in zip(self.whole.names,
                                               self.whole.sizes)
                    if name in self.splits)
        return split / sum(self.whole.sizes)


def tp_sharding(mesh: Mesh, params: unet.UNet) -> Layout:
    """This rank's Megatron pieces of `params` (a whole model) on the
    mesh's model axis."""
    return Layout(params, mesh.shard)


def tp_fsdp_sharding(mesh: Mesh, params: unet.UNet
                     ) -> Tuple[Layout, Placement]:
    """The 2-D split: this rank's Megatron pieces of `params`, and their
    vector split evenly over the data axis."""
    layout = tp_sharding(mesh, params)
    return layout, fsdp_sharding(mesh, layout.size)


def param_sharding(mesh: Mesh, params: unet.UNet, *, fsdp: bool = False,
                   tp: bool = False) -> Tuple[Layout, Placement]:
    """What `make_parallel_train_step` and `init_state` give the
    parameters, the moments and the EMA: the rank's TP pieces (without
    `tp`, the whole model: the `Layout` of one model rank) and how the
    vector of them lies over the data axis."""
    layout = tp_sharding(mesh, params) if tp else Layout(
        params, tensor.Shard(1, 0))
    return layout, (fsdp_sharding if fsdp else replicated)(mesh, layout.size)


def shard_fraction(placement: Placement,
                   layout: Optional[Layout] = None) -> float:
    """The fraction of the parameters' elements that are sharded: 1.0 when
    the vector is split over the data axis (the even split leaves nothing
    whole), under TP alone the share in split leaves, 0.0 under DP (or
    without a layout)."""
    if placement.sharded:
        return 1.0
    return 0.0 if layout is None else layout.fraction


@dataclasses.dataclass
class ParallelState:
    """A rank's training state.  `flat` is the float32 parameter vector the
    forward reads (the `Unravel` order of the rank's pieces, `layout`: the
    whole model's without TP; padded to `placement.padded` under FSDP),
    requiring grad.  Without FSDP `m`, `v` and `ema` are like it; under
    FSDP they are the rank's pieces, and the rank's master parameters are
    `master`, its piece of `flat`."""
    flat: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    step: int
    seed: int
    placement: Placement
    layout: Layout
    ema: Optional[torch.Tensor] = None

    @property
    def master(self) -> torch.Tensor:
        if not self.placement.sharded:
            return self.flat
        return self.flat.detach()[self.placement.piece]


def shard_state(flat: torch.Tensor, mesh: Mesh, layout: Layout, *,
                fsdp: bool = False, m: Optional[torch.Tensor] = None,
                v: Optional[torch.Tensor] = None,
                ema: Optional[torch.Tensor] = None, step: int = 0,
                seed: int = 0) -> ParallelState:
    """The rank's `ParallelState` of whole vectors that every rank holds
    alike (from one seed or one checkpoint): the parameters `flat`, the
    moments (zeros when None) and the EMA (none when None), cut to the
    rank's pieces by `layout` and placed over the data axis (split evenly
    with `fsdp`), on the mesh's device."""
    size = layout.size
    placement = (fsdp_sharding if fsdp else replicated)(mesh, size)

    def place(vec, whole):
        vec = layout.take(vec.detach().to(device=mesh.device,
                                          dtype=torch.float32))
        if placement.padded != size:
            vec = torch.cat([vec, vec.new_zeros(placement.padded - size)])
        return vec.clone() if whole else vec[placement.piece].clone()

    zeros = torch.zeros(flat.numel())
    return ParallelState(
        flat=place(flat, True).requires_grad_(),
        m=place(zeros if m is None else m, not placement.sharded),
        v=place(zeros if v is None else v, not placement.sharded),
        ema=None if ema is None else place(ema, not placement.sharded),
        step=step, seed=seed, placement=placement, layout=layout)


def shard_batch(batch: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a global batch."""
    return batch[mesh.rows]


def init_state(unravel: trainer.Unravel, params: unet.UNet, mesh: Mesh, *,
               fsdp: bool = False, tp: bool = False, ema_rate: float = 0.0,
               seed: int = 0, step: int = 0, m=None, v=None,
               ema: Optional[unet.UNet] = None) -> ParallelState:
    """The rank's state of a whole model's parameters (laid out by
    `unravel`): fresh moments, or `m` and `v` (tensors shaped like the
    parameters, in their order, as a `trainer.TrainState` holds them); the
    EMA `ema`, or a copy of the parameters when ema_rate > 0 and none is
    given.  `tp` cuts the rank's Megatron pieces (`tp_sharding`)."""
    flat = unravel.flatten(params)
    if ema is not None:
        ema = unravel.flatten(ema)
    elif ema_rate > 0.0:
        ema = flat
    order = [name for name, _ in params.named_parameters()]

    def pack(tensors):  # from the parameters' order to `unravel`'s
        by_name = dict(zip(order, tensors))
        return unravel.pack([by_name[name] for name in unravel.names])

    layout, _ = param_sharding(mesh, params, tp=tp)
    return shard_state(flat, mesh, layout, fsdp=fsdp,
                       m=None if m is None else pack(m),
                       v=None if v is None else pack(v),
                       ema=ema, step=step, seed=seed)


def host_state(state: ParallelState):
    """(flat, m, v, ema): whole float32 host copies of a state's vectors
    in the whole model's `Unravel` order (ema None without one).  A
    collective under FSDP or TP: every rank calls it."""
    size = state.placement.size
    vecs = [state.flat.detach()[:size]] + distributed.replicate(
        [state.m, state.v, state.ema], size, state.placement.sharded,
        state.placement.group)
    vecs = [None if vec is None else
            state.layout.gather(vec.to(state.flat.device)) for vec in vecs]
    return tuple(None if vec is None else vec.cpu() for vec in vecs)


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

    def tensors(vec):  # in the parameters' order, as a TrainState's
        views = unravel(vec)
        return [views[name].clone()
                for name, _ in unravel.model.named_parameters()]

    return trainer.TrainState(
        params=model(flat), m=tensors(m), v=tensors(v), step=step, seed=seed,
        ema=None if ema is None else model(ema).requires_grad_(False))


class ParallelStep(trainer.MultiStep):
    """The step of one rank (see the module's docstring): a
    `trainer.MultiStep` over a `ParallelState`, called with this rank's
    rows, (K, B, H, W, C), and returning the K global-mean losses.  Also
    `value_and_grad(state, batch, t, noise, y=None) -> (loss, grad)`: the
    global-mean loss and the gradient after the reduction (the rank's
    vector, or under FSDP its piece of it), with the rank's rows at the
    full height as the step takes them and t and noise given for the global
    batch (both cut to the rank's rows, and to its slice of the height
    under spatial sharding), updating nothing (the parity hook)."""

    def value_and_grad(self, state: ParallelState, batch, t, noise, y=None):
        dev = self.device
        batch = self._cut(trainer._to_device(batch, dev, torch.float32))
        t = trainer._to_device(t, dev)[self.rows]
        noise = self._cut(
            trainer._to_device(noise, dev, torch.float32)[self.rows])
        if y is not None:
            y = trainer._to_device(y, dev, torch.long)
        loss, (grad,) = self._grad_fn(state, batch, t, noise, y)
        return loss, grad


def make_parallel_train_step(cfg: UnetConfig, tc: TrainConfig, mesh: Mesh,
                             diffusion: Optional[GaussianDiffusion] = None,
                             *, fsdp: bool = False, tp: bool = False,
                             spatial: bool = False, class_cond: bool = False,
                             example_params: Optional[unet.UNet] = None,
                             input_u8: bool = False) -> ParallelStep:
    """The step of this rank (`ParallelStep`): DP, or FSDP with `fsdp`,
    each over the data axis; over the model axis `tp` adds Megatron TP (tp
    x fsdp with both) or `spatial` shards the activations' height (spatial
    x fsdp with both).  `example_params` is the whole model whose
    parameters the flat vector holds (its layout, and the module the
    forward calls, or under TP the rank's piece of it); `class_cond` takes
    labels (with tc.label_dropout); `input_u8` takes uint8 pixels, as
    `trainer.make_multi_step`.  Build the state with `init_state` or
    `shard_state` (without `tp`: the whole vector)."""
    if tp and spatial:
        raise ValueError("tp and spatial both use the model axis")
    if example_params is None:
        raise ValueError("make_parallel_train_step needs example_params "
                         "(the model whose flat parameters it trains)")
    layout, placement = param_sharding(mesh, example_params, fsdp=fsdp,
                                       tp=tp)
    unravel = layout.local
    shard = mesh.shard
    split = spatial and shard.size > 1  # over one rank spatial is DP
    height = None
    if split:
        with torch.device("meta"):
            unravel = trainer.Unravel(unet.UNet(
                example_params.cfg, example_params.num_classes,
                spatial=shard))
        # in patch space a rank's rows make whole patch rows (`space_to_depth`
        # refuses an odd count): the CLI's rule makes them a multiple of 2
        height = sp.rows_of(cfg.image_size, shard)
    size = placement.size
    if placement.padded == size:
        apply = unravel.apply
    else:
        def apply(flat, *args, **kwargs):
            return unravel.apply(flat[:size], *args, **kwargs)
    device, diffusion, grad_fn = trainer._setup(
        cfg, tc, diffusion, mesh.device, apply=apply,
        leaves=lambda flat: [flat])
    hp = trainer._adamw_params(tc)
    inv = 1.0 / (mesh.data * (shard.size if split else 1))
    kept = None if layout.shard.size == 1 else layout.kept().to(device)

    def reduced_grad(state, batch, t, noise, y=None):
        loss, (grad,) = grad_fn(state.flat, batch, t, noise, y)
        if kept is not None:  # one gradient for the leaves kept whole
            whole = grad.index_select(0, kept)
            dist.all_reduce(whole, group=shard.group)
            grad.index_copy_(0, kept, whole.mul_(1.0 / shard.size))
        # spatial: every rank holds a part of every parameter's gradient,
        # summed over all ranks (None: the group of every rank)
        over = None if split else mesh.data_group
        dist.all_reduce(loss, group=over)
        loss.mul_(inv)
        if placement.sharded:
            if split:
                dist.all_reduce(grad, group=shard.group)
            piece = torch.empty(placement.shard, dtype=grad.dtype,
                                device=grad.device)
            distributed.reduce_scatter(piece, grad, mesh.data_group)
            grad = piece
        else:
            dist.all_reduce(grad, group=over)
        return loss, [grad.mul_(inv)]

    @torch.no_grad()
    def update(state, grads, step):
        master = state.master
        optim.adamw_update_flat(master, grads[0], state.m, state.v, step, hp)
        if state.ema is not None and tc.ema_rate > 0.0:
            state.ema.mul_(tc.ema_rate).add_(master, alpha=1.0 - tc.ema_rate)
        if placement.sharded:
            distributed.all_gather(state.flat.detach(), master,
                                   mesh.data_group)

    return ParallelStep(
        device, diffusion, reduced_grad, update,
        tensors=lambda s: [s.flat, s.m, s.v] + ([] if s.ema is None
                                                else [s.ema]),
        input_u8=input_u8,
        label_dropout=tc.label_dropout if class_cond else 0.0,
        world=mesh.data, rows=mesh.rows, height=height)
