"""The ADM U-Net: static architecture plan and the `UNet` module (port of
unet_tpu/models/unet.py).

`build_plan`, `fwd_flops` and `param_order` are the JAX package's, value for
value.  `UNet` holds its parameters under the JAX package's pytree paths
(`time_mlp.l1.w`, `input[3].res.gn1.scale`, ...), so one `param_order` path
addresses the same parameter in both packages.  `init` and `apply` mirror the
JAX functions of those names: `apply` casts the parameters to the compute
type once, inside the autograd graph, and with `remat` recomputes each layer
group in the backward (`torch.utils.checkpoint`, as the JAX package wraps
each group in `jax.checkpoint`).  Level 0 runs in pixel space or, under
`set_s2d_mode("on")`, in patch space (ops/s2d.py), as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from unet_tpu_torch.config import UnetConfig
from unet_tpu_torch.models import blocks
from unet_tpu_torch.ops import functional as F
from unet_tpu_torch.ops import s2d as S
from unet_tpu_torch.parallel import tensor

# Layer kinds appearing in a plan:
#   ("conv_in", cin, cout)  ("res", cin, cout)  ("attn", c)
#   ("down", c)  ("up", c)
Layer = Tuple


@dataclasses.dataclass(frozen=True)
class UnetPlan:
    input_blocks: Tuple[Tuple[Layer, ...], ...]
    middle: Tuple[Layer, ...]
    output_blocks: Tuple[Tuple[Layer, ...], ...]
    out_channels_pre_head: int


def build_plan(cfg: UnetConfig) -> UnetPlan:
    """Walk the architecture as the guided-diffusion constructor does: the
    input column pushes one skip per block; the output column pops them in
    reverse."""
    ch = cfg.channel_mult[0] * cfg.model_channels
    input_blocks: List[Tuple[Layer, ...]] = [(("conv_in", cfg.in_channels, ch),)]
    skip_chans = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers: List[Layer] = [("res", ch, mult * cfg.model_channels)]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_ds:
                layers.append(("attn", ch))
            input_blocks.append(tuple(layers))
            skip_chans.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_blocks.append((("down", ch),))
            skip_chans.append(ch)
            ds *= 2

    middle: Tuple[Layer, ...] = (("res", ch, ch), ("attn", ch), ("res", ch, ch))

    output_blocks: List[Tuple[Layer, ...]] = []
    for level, mult in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            ich = skip_chans.pop()
            layers = [("res", ch + ich, mult * cfg.model_channels)]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_ds:
                layers.append(("attn", ch))
            if level and i == cfg.num_res_blocks:
                layers.append(("up", ch))
                ds //= 2
            output_blocks.append(tuple(layers))

    return UnetPlan(tuple(input_blocks), middle, tuple(output_blocks), ch)


def attention_widths(cfg: UnetConfig) -> List[int]:
    """The channel width of every attention layer of the plan, in order."""
    plan = build_plan(cfg)
    return [layer[1] for group in plan.input_blocks + (plan.middle,)
            + plan.output_blocks for layer in group if layer[0] == "attn"]


def fwd_flops(cfg: UnetConfig, batch_size: int = 1) -> int:
    """Analytic forward matmul/conv FLOPs (2 * MACs) for one batch: convs,
    linears and attention dots along the plan `UNet.forward` executes."""
    plan = build_plan(cfg)

    def conv(h, w, cin, cout, k=3):
        return 2 * h * w * cin * cout * k * k

    def res(h, w, cin, cout):
        f = conv(h, w, cin, cout) + conv(h, w, cout, cout)
        emb_out = 2 * cout if cfg.use_scale_shift_norm else cout
        f += 2 * cfg.time_embed_dim * emb_out
        if cin != cout:
            f += conv(h, w, cin, cout, k=1)
        return f

    def attn(h, w, c):
        t = h * w
        # qkv 1x1 + QK^T + PV + proj 1x1
        return 2 * t * c * 3 * c + 2 * 2 * t * t * c + 2 * t * c * c

    def group(h, w, layers):
        f = 0
        for layer in layers:
            kind = layer[0]
            if kind == "conv_in":
                f += conv(h, w, layer[1], layer[2])
            elif kind == "res":
                f += res(h, w, layer[1], layer[2])
            elif kind == "attn":
                f += attn(h, w, layer[1])
            elif kind == "down":
                h, w = h // 2, w // 2
            elif kind == "up":
                h, w = h * 2, w * 2
        return f, h, w

    s = cfg.image_size
    ted = cfg.time_embed_dim
    total = 2 * (cfg.model_channels * ted + ted * ted)  # time MLP
    h = w = s
    for layers in plan.input_blocks + (plan.middle,) + plan.output_blocks:
        f, h, w = group(h, w, layers)
        total += f
    total += conv(s, s, plan.out_channels_pre_head, cfg.out_channels)
    return total * batch_size


# ---------------------------------------------------------------------------
# Space-to-depth execution of level 0 (ops/s2d.py): an alternate, off by
# default.  The JAX package keeps it for the TPU's 128-lane matrix unit,
# which level 0's 64 channels half fill; the card has no such lanes, and
# what it costs here is measured by chip_smoke.py (PERF.md).

_S2D_MODES = ("off", "on", "auto")
_S2D_MODE = "off"


def set_s2d_mode(name: str) -> None:
    """Select level 0's execution: "off" (pixel space, the default), "on"
    (patch space wherever `s2d_supported`, on any device) or "auto", which
    in the JAX package means patch space for bfloat16 on a TPU; the port
    never runs on a TPU, so "auto" is pixel space on every device.  The
    mode is read when a forward runs, so set it before the first step, or
    the capture of a step or a sampler chain, that should follow it.  Also
    read from UNET_TPU_TORCH_S2D when this module is imported, where an
    unknown value acts as "auto" (the JAX package's UNET_TPU_S2D does)."""
    global _S2D_MODE
    if name not in _S2D_MODES:
        raise ValueError(f"unknown space-to-depth mode {name!r}: one of "
                         f"{_S2D_MODES}")
    _S2D_MODE = name


_ENV_MODE = os.environ.get("UNET_TPU_TORCH_S2D", "off")
set_s2d_mode(_ENV_MODE if _ENV_MODE in _S2D_MODES else "auto")


def s2d_supported(cfg: UnetConfig) -> bool:
    """Patch-space level 0 needs an even image with a >= 2x2 patch grid, a
    level below it (the down and up boundaries convert between the spaces)
    and no attention at ds=1 (attention stays in pixel space)."""
    return (cfg.image_size % 2 == 0 and cfg.image_size // 2 >= 2
            and cfg.num_levels >= 2 and 1 not in cfg.attention_ds)


def _use_s2d(cfg: UnetConfig) -> bool:
    """Whether level 0 runs in patch space now: mode "on" and supported."""
    return _S2D_MODE == "on" and s2d_supported(cfg)


def group_modes(cfg: UnetConfig, s2d: bool):
    """(input column's, output column's) mode of each group of the plan
    (`LayerGroup.forward`): with `s2d`, "s2d" for level 0's groups (conv_in,
    its ResBlocks, its "down"; the output column's last num_res_blocks + 1),
    "to_s2d" for the level-1 group whose "up" feeds level 0, "normal" for
    the rest; without it "normal" for every group."""
    plan = build_plan(cfg)
    n_in, n_out = len(plan.input_blocks), len(plan.output_blocks)
    if not s2d:
        return ("normal",) * n_in, ("normal",) * n_out
    level0 = cfg.num_res_blocks + 1
    ins = tuple("s2d" if i <= level0 else "normal" for i in range(n_in))
    outs = tuple("s2d" if i >= n_out - level0 else
                 "to_s2d" if i == n_out - level0 - 1 else "normal"
                 for i in range(n_out))
    return ins, outs


# ---------------------------------------------------------------------------
# Modules


class LayerGroup(nn.Module):
    """One entry of the plan's input or output column: its layers applied in
    order.  "down" and "up" have no parameters."""

    def __init__(self, layers, cfg: UnetConfig, generator=None, shard=None,
                 spatial=None):
        super().__init__()
        self.layers = layers
        for layer in layers:
            kind = layer[0]
            if kind == "conv_in":
                self.conv = blocks.Conv2d(layer[1], layer[2], 3, generator,
                                          spatial=spatial)
            elif kind == "res":
                self.res = _res(layer, cfg, generator, shard, spatial)
            elif kind == "attn":
                self.attn = _attn(layer, cfg, generator, shard, spatial)

    def forward(self, h, emb, mode="normal"):
        """mode: "normal" (pixel space), "s2d" (the whole group in patch
        space: its "down" takes s2d input and gives pixel space) or
        "to_s2d" (pixel space, but a trailing "up" gives s2d output); see
        `group_modes`."""
        in_s2d = mode == "s2d"
        for layer in self.layers:
            kind = layer[0]
            if kind == "conv_in":
                h = (S.conv2d_s2d(h, self.conv.w, self.conv.b,
                                  shard=self.conv.spatial) if in_s2d
                     else self.conv(h))
            elif kind == "res":
                h = self.res(h, emb, s2d=in_s2d)
            elif kind == "attn":
                if in_s2d:
                    raise ValueError("attention runs in pixel space only")
                h = self.attn(h)
            elif kind == "down":
                h = S.avg_pool_2x_from_s2d(h) if in_s2d else F.avg_pool_2x(h)
            elif kind == "up":
                h = (S.upsample_2x_to_s2d(h) if mode == "to_s2d"
                     else F.upsample_nearest_2x(h))
        return h


def _res(layer, cfg, generator, shard=None, spatial=None):
    if shard is not None and not tensor.res_splits(
            layer[2], cfg.gn_num_groups, shard.size):
        shard = None
    return blocks.ResBlock(layer[1], layer[2], cfg.time_embed_dim,
                           scale_shift_norm=cfg.use_scale_shift_norm,
                           num_groups=cfg.gn_num_groups, eps=cfg.gn_eps,
                           generator=generator, shard=shard, spatial=spatial)


def _attn(layer, cfg, generator, shard=None, spatial=None):
    if shard is not None and not tensor.attn_splits(
            layer[1], cfg.num_head_channels, shard.size):
        shard = None
    return blocks.AttentionBlock(layer[1], head_size=cfg.num_head_channels,
                                 num_groups=cfg.gn_num_groups, eps=cfg.gn_eps,
                                 generator=generator, shard=shard,
                                 spatial=spatial)


class UNet(nn.Module):
    """The U-Net over NHWC tensors.  Parameters are initialised on the CPU
    from `generator` (torch-default statistics); move the module with
    `.to(device)` or build it through `init`.

    With `shard` (`parallel.tensor.Shard`) it is one rank's piece of the
    model under Megatron TP: every ResBlock and attention block that splits
    over the shard's ranks (`tensor.res_splits`, `tensor.attn_splits`)
    holds the rank's piece (`blocks`), every other layer is whole; the
    pieces come from a whole model through `parallel.mesh.tp_sharding`.

    With `spatial` (a `Shard` too; never with `shard`) it is the whole
    model, its parameters in the one-device order and shapes, run on this
    rank's rows [m H/N, (m+1) H/N) of every activation
    (`parallel/spatial.py`): every 3x3 convolution, `conv_in` and
    `out.conv` among them, every GroupNorm, `out.gn` among them, and every
    attention layer exchange over the model group.  The image's lowest
    resolution must divide by N, so that every level's slice is whole and
    every pooled slice even.

    Level 0 runs in patch space when `_use_s2d` says so at the call
    (`set_s2d_mode`), whole or split over model ranks: under `spatial` a
    rank's patch rows are its pixel rows in patch form (its level-0
    height H/N is even, since the lowest resolution divides by N and
    patch space needs a level below level 0), and its 3x3 convolutions
    and GroupNorms exchange over the model group as in pixel space; under
    `shard` level 0's split ResBlocks run their rank's piece in patch
    space (ops/s2d.py)."""

    def __init__(self, cfg: UnetConfig, num_classes: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, shard=None,
                 spatial=None):
        super().__init__()
        if shard is not None and spatial is not None:
            raise ValueError("tp and spatial both use the model axis")
        self.cfg = cfg
        self.num_classes = num_classes
        plan = build_plan(cfg)
        ted = cfg.time_embed_dim
        self.time_mlp = nn.Module()
        self.time_mlp.l1 = blocks.Linear(cfg.model_channels, ted, generator)
        self.time_mlp.l2 = blocks.Linear(ted, ted, generator)
        if num_classes is not None:
            label_emb = torch.empty(num_classes, ted)
            if not label_emb.is_meta:  # (on the meta device the draw loads
                #                         torch's compiler stack: seconds)
                label_emb.normal_(generator=generator)
            self.label_emb = nn.Parameter(label_emb)
        self.input = nn.ModuleList(
            LayerGroup(b, cfg, generator, shard, spatial)
            for b in plan.input_blocks)
        self.middle = nn.Module()
        self.middle.res1 = _res(plan.middle[0], cfg, generator, shard,
                                spatial)
        self.middle.attn = _attn(plan.middle[1], cfg, generator, shard,
                                 spatial)
        self.middle.res2 = _res(plan.middle[2], cfg, generator, shard,
                                spatial)
        self.output = nn.ModuleList(
            LayerGroup(b, cfg, generator, shard, spatial)
            for b in plan.output_blocks)
        self.out = nn.Module()
        self.out.gn = blocks.GroupNorm(plan.out_channels_pre_head,
                                       cfg.gn_num_groups, cfg.gn_eps,
                                       spatial)
        self.out.conv = blocks.Conv2d(plan.out_channels_pre_head,
                                      cfg.out_channels, 3, generator,
                                      spatial=spatial)

    @property
    def dtype(self) -> torch.dtype:
        return self.out.conv.w.dtype

    @property
    def device(self) -> torch.device:
        return self.out.conv.w.device

    def to_compute(self, dtype) -> "UNet":
        """This module if its parameters already have `dtype`, else a copy
        cast to it, detached from this one.  The samplers cast once, before
        their loop; training casts inside the graph (`apply`)."""
        if dtype is None or dtype == self.dtype:
            return self
        return copy.deepcopy(self).to(dtype)

    def forward(self, x, t, y=None, *, remat=False):
        """x: (B, H, W, C_in) NHWC; t: (B,) timesteps; y: optional (B,)
        integer labels, where -1 is the null label: no class embedding is
        added, so the call equals the unconditional one (the
        classifier-free-guidance convention).  Computes in the parameters'
        type and returns (B, H, W, C_out) in it.  `remat` recomputes each
        layer group's forward in the backward instead of keeping its
        activations."""
        cfg = self.cfg
        x = x.to(self.dtype)
        emb = F.timestep_embedding(t, cfg.model_channels,
                                   max_period=cfg.max_period).to(self.dtype)
        emb = self.time_mlp.l2(F.silu(self.time_mlp.l1(emb)))
        if y is not None:
            if self.num_classes is None:
                raise ValueError("labels given to an unconditional model")
            lab = self.label_emb[y.clamp(min=0)]
            emb = emb + torch.where((y >= 0)[:, None], lab,
                                    torch.zeros((), dtype=lab.dtype,
                                                device=lab.device))

        def run(module, *args):
            if not remat:
                return module(*args)
            # The recompute runs in the backward, after `apply` has put the
            # float32 parameters back: bind the ones the group holds now
            # (the compute-type casts).  No random op inside a group, so no
            # RNG state to keep.
            return checkpoint(torch.func.functional_call, module,
                              dict(module.named_parameters()), args,
                              use_reentrant=False, preserve_rng_state=False)

        s2d = _use_s2d(cfg)
        in_modes, out_modes = group_modes(cfg, s2d)
        h = S.space_to_depth(x) if s2d else x
        skips = []
        for group, mode in zip(self.input, in_modes):
            h = run(group, h, emb, mode)
            skips.append(h)
        h = run(self.middle.res1, h, emb)
        h = run(self.middle.attn, h)
        h = run(self.middle.res2, h, emb)
        for group, mode in zip(self.output, out_modes):
            skip = skips.pop()
            h = (S.concat_channels(h, skip) if mode == "s2d"
                 else torch.cat([h, skip], dim=-1))
            h = run(group, h, emb, mode)
        if s2d:
            gn, conv = self.out.gn, self.out.conv
            h = S.group_norm_silu_s2d(h, gn.scale, gn.bias,
                                      num_groups=gn.num_groups, eps=gn.eps,
                                      shard=gn.spatial)
            return S.depth_to_space(S.conv2d_s2d(h, conv.w, conv.b,
                                                 shard=conv.spatial))
        return self.out.conv(self.out.gn(h))


def init(cfg: UnetConfig, num_classes: Optional[int] = None, *,
         generator: Optional[torch.Generator] = None,
         device="cuda") -> UNet:
    """A `UNet` with torch-default init statistics drawn from `generator`
    (a CPU generator, so one seed gives one model on any device), placed on
    `device`."""
    return UNet(cfg, num_classes, generator).to(device)


def apply(model: UNet, x, t, y=None, *, compute_dtype=None,
          remat: bool = False):
    """Full U-Net forward with the parameters cast to `compute_dtype` for the
    call (None: the parameters' own type), once and inside the autograd
    graph, so the gradients reach `model`'s own parameters (bfloat16-rounded
    values in float32 for a bfloat16 call), as the JAX package's `apply`.
    `remat` recomputes each layer group in the backward (the JAX package's
    `remat=True`); the final GroupNorm and conv stay outside any group."""
    if compute_dtype is None or compute_dtype == model.dtype:
        return model(x, t, y, remat=remat)
    cast = {n: p.to(compute_dtype) for n, p in model.named_parameters()}
    return torch.func.functional_call(model, cast, (x, t, y),
                                      {"remat": remat})


# ---------------------------------------------------------------------------
# torch named_parameters() flat order (the .bin interchange contract).

# Each entry: (path-in-module, kind) with kind in {"gn", "conv", "linear",
# "conv1d"}: the same paths and kinds as the JAX package, where the kind
# selects the transpose between its native layouts and torch shapes.
ParamRef = Tuple[Tuple, str]


def _res_order(prefix, cin, cout) -> List[ParamRef]:
    refs = [
        (prefix + ("gn1", "scale"), "gn"), (prefix + ("gn1", "bias"), "gn"),
        (prefix + ("conv1", "w"), "conv"), (prefix + ("conv1", "b"), "gn"),
        (prefix + ("emb", "w"), "linear"), (prefix + ("emb", "b"), "gn"),
        (prefix + ("gn2", "scale"), "gn"), (prefix + ("gn2", "bias"), "gn"),
        (prefix + ("conv2", "w"), "conv"), (prefix + ("conv2", "b"), "gn"),
    ]
    if cin != cout:
        refs += [(prefix + ("skip", "w"), "conv"),
                 (prefix + ("skip", "b"), "gn")]
    return refs


def _attn_order(prefix) -> List[ParamRef]:
    return [
        (prefix + ("gn", "scale"), "gn"), (prefix + ("gn", "bias"), "gn"),
        (prefix + ("qkv", "w"), "conv1d"), (prefix + ("qkv", "b"), "gn"),
        (prefix + ("proj", "w"), "conv1d"), (prefix + ("proj", "b"), "gn"),
    ]


def _group_order(prefix, layers) -> List[ParamRef]:
    refs: List[ParamRef] = []
    for layer in layers:
        kind = layer[0]
        if kind == "conv_in":
            refs += [(prefix + ("conv", "w"), "conv"),
                     (prefix + ("conv", "b"), "gn")]
        elif kind == "res":
            refs += _res_order(prefix + ("res",), layer[1], layer[2])
        elif kind == "attn":
            refs += _attn_order(prefix + ("attn",))
    return refs


def param_order(cfg: UnetConfig, num_classes: Optional[int] = None
                ) -> List[ParamRef]:
    """Flat parameter order of the .bin file: torch named_parameters() order
    of the guided-diffusion model."""
    plan = build_plan(cfg)
    refs: List[ParamRef] = [
        (("time_mlp", "l1", "w"), "linear"), (("time_mlp", "l1", "b"), "gn"),
        (("time_mlp", "l2", "w"), "linear"), (("time_mlp", "l2", "b"), "gn"),
    ]
    if num_classes is not None:
        refs.append((("label_emb",), "gn"))
    for i, layers in enumerate(plan.input_blocks):
        refs += _group_order(("input", i), layers)
    refs += _res_order(("middle", "res1"), *plan.middle[0][1:])
    refs += _attn_order(("middle", "attn"))
    refs += _res_order(("middle", "res2"), *plan.middle[2][1:])
    for i, layers in enumerate(plan.output_blocks):
        refs += _group_order(("output", i), layers)
    refs += [
        (("out", "gn", "scale"), "gn"), (("out", "gn", "bias"), "gn"),
        (("out", "conv", "w"), "conv"), (("out", "conv", "b"), "gn"),
    ]
    return refs


def get_param(model: UNet, path) -> nn.Parameter:
    """The parameter a `param_order` path names."""
    node = model
    for k in path:
        node = node[k] if isinstance(k, int) else getattr(node, k)
    return node
