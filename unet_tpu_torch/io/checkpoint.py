"""`.bin` checkpoint interchange (magic 12345678), port of
unet_tpu/io/checkpoint.py: the same file format, byte for byte, so a file
written by either package loads in the other.

  * 256-int32 header [magic, B, C_in, C_model, C_out, H, W, max_period,
    has_adamw, has_rng].
  * flat float32 params in torch `named_parameters()` order.
  * optional AdamW m then v in the same flat order.

Extension fields are trusted only behind header[12] == EXT_MAGIC (a file
from another writer may hold garbage in its spare slots); header[9]
(has_rng) is always written 0:
  * header[10]: optimizer step count.
  * header[11]: 32-bit RNG seed; present iff header[13] == 1.
  * header[14]: dataloader cursor in batches consumed.
  * header[15] == 1: a host MT19937 state blob (625 uint32) is appended
    after params (+ AdamW moments, + EMA).
  * header[16..37]: full architecture (num_res_blocks, channel_mult,
    attention_ds, num_head_channels, use_scale_shift_norm, num_classes), so
    load(cfg=None) reconstructs the exact model.
  * header[38] == 1: a float32 EMA of the parameters (same flat order) is
    appended after the AdamW moments and before any MT19937 blob.
  * header[39]: the EMA decay rate as raw float32 bits (iff header[38] == 1).
  * header[40]: noise schedule the model was trained with (1 = linear,
    2 = cosine; 0 = absent -> linear).

The port keeps its parameters in torch shapes, the file's own order, so no
transpose happens here (the JAX package transposes at this boundary;
io/convert.py does the same for a JAX pytree).  Parameters and the EMA load
as `UNet` modules on `device`; in a `Checkpoint` the AdamW moments are flat
float32 numpy vectors in file order (`flatten_tensors` / `unflatten_like`
convert them to and from one tensor per parameter; the trainer's
`to_checkpoint` / `from_checkpoint` use them).  `load` also takes a torch
`.pt`/`.pth` state_dict (`load_torch_pt`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from unet_tpu_torch.config import UnetConfig
from unet_tpu_torch.models import unet

MAGIC = 12345678
HEADER_INTS = 256
# "written by this framework" marker at header[12] (shared with the JAX
# package); extensions require an exact match, not a boolean.
EXT_MAGIC = 20260816
HOST_RNG_WORDS = 625  # MT19937: 624 state words + cursor
_MAX_LEVELS = 8       # fixed header room for channel_mult / attention_ds


def _arch_to_header(header: np.ndarray, cfg: UnetConfig,
                    num_classes: Optional[int]) -> None:
    """Architecture -> EXT header slots [16..37] (see module docstring)."""
    if len(cfg.channel_mult) > _MAX_LEVELS or len(
            cfg.attention_ds) > _MAX_LEVELS:
        raise ValueError(f"header supports at most {_MAX_LEVELS} levels")
    header[16] = cfg.num_res_blocks
    header[17] = len(cfg.channel_mult)
    header[18:18 + len(cfg.channel_mult)] = cfg.channel_mult
    header[26] = len(cfg.attention_ds)
    header[27:27 + len(cfg.attention_ds)] = cfg.attention_ds
    header[35] = cfg.num_head_channels
    header[36] = 1 if cfg.use_scale_shift_norm else 0
    header[37] = num_classes or 0


def _arch_from_header(header: np.ndarray) -> UnetConfig:
    """EXT header slots -> full UnetConfig (only valid behind EXT_MAGIC)."""
    return UnetConfig(
        in_channels=int(header[2]),
        model_channels=int(header[3]),
        out_channels=int(header[4]),
        image_size=int(header[5]),
        max_period=int(header[7]),
        num_res_blocks=int(header[16]),
        channel_mult=tuple(int(m) for m in header[18:18 + int(header[17])]),
        attention_ds=tuple(int(d) for d in header[27:27 + int(header[26])]),
        num_head_channels=int(header[35]),
        use_scale_shift_norm=bool(header[36]),
    )


def _shape_model(cfg: UnetConfig, num_classes: Optional[int]) -> unet.UNet:
    """A `UNet` on the meta device: every parameter's shape, no storage and
    no init."""
    with torch.device("meta"):
        return unet.UNet(cfg, num_classes)


def flatten_params(model: unet.UNet) -> np.ndarray:
    """Module -> flat float32 vector in torch named_parameters() order."""
    chunks = [unet.get_param(model, path).detach().float().reshape(-1)
              for path, _ in unet.param_order(model.cfg, model.num_classes)]
    return torch.cat(chunks).cpu().numpy()


def unflatten_params(flat: np.ndarray, cfg: UnetConfig,
                     num_classes: Optional[int] = None,
                     device="cuda") -> unet.UNet:
    """Flat torch-order float32 vector -> `UNet` on `device`."""
    model = _shape_model(cfg, num_classes).to_empty(device=device)
    need = sum(p.numel() for p in model.parameters())
    if need != flat.size:
        raise ValueError(
            f"checkpoint has {flat.size} params, model needs {need}")
    # one host-to-device copy, then views of it
    vec = torch.tensor(np.asarray(flat, np.float32), device=device)
    offset = 0
    with torch.no_grad():
        for path, _ in unet.param_order(cfg, num_classes):
            p = unet.get_param(model, path)
            p.copy_(vec[offset:offset + p.numel()].view(p.shape))
            offset += p.numel()
    return model


def flatten_tensors(tensors) -> np.ndarray:
    """Tensors shaped like the parameters, in their order -> one flat
    float32 vector (the file's layout of the AdamW moments)."""
    return torch.cat([t.detach().float().reshape(-1) for t in tensors]
                     ).cpu().numpy()


def unflatten_like(flat: np.ndarray, model: unet.UNet):
    """Flat float32 vector in file order -> one float32 tensor per
    parameter of `model`, shaped and laid out like it, on its device."""
    params = list(model.parameters())
    need = sum(p.numel() for p in params)
    if need != flat.size:
        raise ValueError(f"vector has {flat.size} values, model needs {need}")
    vec = torch.tensor(np.asarray(flat, np.float32), device=model.device)
    out, offset = [], 0
    for p in params:
        t = torch.empty_like(p, dtype=torch.float32)
        t.copy_(vec[offset:offset + p.numel()].view(p.shape))
        out.append(t)
        offset += p.numel()
    return out


def num_params(cfg: UnetConfig, num_classes: Optional[int] = None) -> int:
    return sum(p.numel()
               for p in _shape_model(cfg, num_classes).parameters())


@dataclasses.dataclass
class Checkpoint:
    params: unet.UNet
    cfg: UnetConfig
    batch_size: int
    step: int = 0
    adam_m: Optional[np.ndarray] = None   # flat float32, file order
    adam_v: Optional[np.ndarray] = None
    rng_seed: Optional[int] = None
    loader_pos: int = 0               # dataloader cursor, in batches
    host_rng_state: Optional[np.ndarray] = None  # (625,) uint32 MT19937
    ema: Optional[unet.UNet] = None   # float32 EMA of the parameters
    ema_rate: float = 0.0             # decay rate the EMA was trained at
    # beta schedule trained with; None on load = the file has no record
    noise_schedule: Optional[str] = "linear"


def save(path: str, ckpt: Checkpoint) -> None:
    """Write `ckpt` to `path`; the number of classes is the model's own."""
    cfg = ckpt.cfg
    header = np.zeros(HEADER_INTS, dtype=np.int32)
    header[0] = MAGIC
    header[1] = ckpt.batch_size
    header[2] = cfg.in_channels
    header[3] = cfg.model_channels
    header[4] = cfg.out_channels
    header[5] = cfg.image_size
    header[6] = cfg.image_size
    header[7] = cfg.max_period
    header[8] = 1 if ckpt.adam_m is not None else 0
    header[9] = 0
    header[12] = EXT_MAGIC
    header[10] = ckpt.step
    header[13] = 0 if ckpt.rng_seed is None else 1
    header[11] = 0 if ckpt.rng_seed is None else ckpt.rng_seed
    header[14] = ckpt.loader_pos
    header[15] = 0 if ckpt.host_rng_state is None else 1
    header[38] = 0 if ckpt.ema is None else 1
    if ckpt.ema is not None:
        header[39] = np.float32(ckpt.ema_rate).view(np.int32)
    # None = "no record"; writing 0 keeps load(save(ckpt)) round-trippable.
    header[40] = {None: 0, "linear": 1, "cosine": 2}[ckpt.noise_schedule]
    _arch_to_header(header, cfg, ckpt.params.num_classes)
    n = num_params(cfg, ckpt.params.num_classes)
    blobs = [header, flatten_params(ckpt.params)]
    if ckpt.adam_m is not None:
        for moment in (ckpt.adam_m, ckpt.adam_v):
            moment = np.ascontiguousarray(moment, np.float32)
            if moment.size != n:
                raise ValueError(
                    f"AdamW moment has {moment.size} values, model has {n}")
            blobs.append(moment)
    if ckpt.ema is not None:
        blobs.append(flatten_params(ckpt.ema))
    if ckpt.host_rng_state is not None:
        state = np.ascontiguousarray(ckpt.host_rng_state, np.uint32)
        if state.size != HOST_RNG_WORDS:
            raise ValueError(f"host_rng_state must be {HOST_RNG_WORDS} words")
        blobs.append(state)
    # tmp + fsync + rename: a kill mid-write must never leave a truncated
    # file under the final name, and on power loss the rename must not
    # commit ahead of the data
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            for blob in blobs:
                f.write(blob.tobytes())
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        try:
            os.unlink(tmp)  # no stale .tmp after a mid-write failure
        except OSError:
            pass
        raise
    os.replace(tmp, path)
    # fsync the directory so the rename itself survives power loss
    try:
        dfd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # e.g. directories not fsync-able on this filesystem


def _read_header(f, path: str) -> np.ndarray:
    header = np.frombuffer(f.read(HEADER_INTS * 4), dtype=np.int32)
    if header.size != HEADER_INTS or header[0] != MAGIC:
        raise ValueError(f"bad magic or short header in {path}")
    return header


def _config_from_header(header: np.ndarray) -> UnetConfig:
    if header[12] == EXT_MAGIC:
        return _arch_from_header(header)
    # a file without the marker records only the basic sizes; the rest is
    # the default architecture
    return UnetConfig(in_channels=int(header[2]),
                      model_channels=int(header[3]),
                      out_channels=int(header[4]),
                      image_size=int(header[5]),
                      max_period=int(header[7]))


def _is_torch_pt(path: str) -> bool:
    return path.endswith((".pt", ".pth"))


def read_config(path: str) -> UnetConfig:
    """The architecture `load` builds with cfg=None, read without the
    weights: a `.bin` checkpoint's header, or `UnetConfig()` for a `.pt`."""
    if _is_torch_pt(path):
        return UnetConfig()
    with open(path, "rb") as f:
        return _config_from_header(_read_header(f, path))


def load_torch_pt(path: str, cfg: Optional[UnetConfig] = None,
                  num_classes: Optional[int] = None,
                  device="cuda") -> Checkpoint:
    """Load a torch `.pt`/`.pth` state_dict of the guided-diffusion-style
    model (`UnetConfig()` when cfg is None): its tensors, in the dict's
    order, are the parameters in `param_order`, in that model's shapes (an
    attention projection is a Conv1d's (O, I, 1)); a `torch.compile`
    model's `_orig_mod.` key prefix changes nothing.  The order is checked, not
    trusted: every tensor must have the shape of the parameter at its place,
    and the count must match, or the load raises."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict):
        raise ValueError(f"{path}: expected a state_dict")
    if cfg is None:
        cfg = UnetConfig()
    tensors = [(k, v) for k, v in state.items() if isinstance(v, torch.Tensor)]
    order = unet.param_order(cfg, num_classes)
    if len(tensors) != len(order):
        raise ValueError(
            f"{path}: state_dict has {len(tensors)} tensors, model expects "
            f"{len(order)} parameters")
    shapes = _shape_model(cfg, num_classes)
    chunks = []
    for (key, v), (param_path, kind) in zip(tensors, order):
        expect = tuple(unet.get_param(shapes, param_path).shape)
        if kind == "conv1d":  # the torch model's Conv1d(kernel 1): (O, I, 1)
            expect += (1,)
        if tuple(v.shape) != expect:
            raise ValueError(
                f"{path}: tensor '{key}' has shape {tuple(v.shape)}, "
                f"expected {expect} for parameter "
                f"{'.'.join(map(str, param_path))} — state_dict order does "
                f"not match named_parameters() order")
        chunks.append(v.detach().float().reshape(-1))
    flat = torch.cat(chunks).numpy()
    return Checkpoint(params=unflatten_params(flat, cfg, num_classes, device),
                      cfg=cfg, batch_size=0, noise_schedule=None)


def load(path: str, cfg: Optional[UnetConfig] = None,
         num_classes: Optional[int] = None, device="cuda") -> Checkpoint:
    """Load a `.bin` checkpoint written by this package, the JAX package or
    the guided-diffusion-style CUDA/torch trainers the format comes from
    (with cfg=None the architecture comes from the header), or a torch
    `.pt`/`.pth` state_dict (`load_torch_pt`)."""
    if _is_torch_pt(path):
        return load_torch_pt(path, cfg, num_classes, device)
    with open(path, "rb") as f:
        header = _read_header(f, path)
        is_ext = header[12] == EXT_MAGIC
        if cfg is None:
            cfg = _config_from_header(header)
        if num_classes is None and is_ext and header[37] > 0:
            num_classes = int(header[37])
        n = num_params(cfg, num_classes)

        def read_flat():
            flat = np.frombuffer(f.read(n * 4), dtype=np.float32)
            if flat.size != n:
                raise ValueError(f"{path} is truncated")
            return flat

        params = unflatten_params(read_flat(), cfg, num_classes, device)
        adam_m = adam_v = None
        if header[8]:
            adam_m, adam_v = read_flat(), read_flat()
        step = rng_seed = loader_pos = host_rng_state = ema = None
        ema_rate = 0.0
        noise_schedule = None
        if is_ext:
            noise_schedule = {1: "linear", 2: "cosine"}.get(
                int(header[40]))
            step = int(header[10])
            rng_seed = int(header[11]) if header[13] == 1 else None
            loader_pos = int(header[14])
            if header[38] == 1:
                ema = unflatten_params(read_flat(), cfg, num_classes, device)
                ema_rate = float(header[39:40].view(np.float32)[0])
            if header[15] == 1:
                host_rng_state = np.frombuffer(
                    f.read(HOST_RNG_WORDS * 4), dtype=np.uint32).copy()
        # Any further trailing bytes (another writer's RNG blob) are ignored.
    return Checkpoint(params=params, cfg=cfg, batch_size=int(header[1]),
                      step=step or 0, adam_m=adam_m, adam_v=adam_v,
                      rng_seed=rng_seed, loader_pos=loader_pos or 0,
                      host_rng_state=host_rng_state, ema=ema,
                      ema_rate=ema_rate, noise_schedule=noise_schedule)

