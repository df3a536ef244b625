"""Training CLI (port of unet_tpu/cli/train.py; the same flags, plus
`--device`).

python -m unet_tpu_torch.cli.train --data_file data/train.bin \\
    [--batch_size 32] [--iterations N] [--compute_dtype bfloat16] \\
    [--model_weights models/model_N.bin | --auto_resume true] [--device cuda]
    [--num_devices N [--fsdp true] [--tensor_parallel M |
    --spatial_parallel M]]

A fresh init (from `--seed`) or `--model_weights` (parameters, AdamW
moments, step, seed, EMA, loader cursor and, with `--host_rng`, the host
generator's state: a resumed run continues the original's trajectory;
`--auto_resume` takes the newest `model_<step>.bin` in `--output_dir`),
then the step loop over the `.bin` stream (`--data_file`) or over a
directory of images (`--data_dir`, whose file-name prefixes are the class
labels under `--class_cond`): a text log line every `--log_interval` steps
("step N: loss L (X ms/step)") and the same numbers as a key-value table
(and a CSV file under `--csv_log_dir`), a full checkpoint
`output_dir/model_<step>.bin` every `--save_interval`.  `--init_model_only`
writes the initial checkpoint and exits.  SIGTERM or SIGINT lets the step
or chunk in flight finish, saves `model_<step>.bin`, logs "caught signal
..." and returns (exit status 0); a second signal kills at once.

A `.bin` stream is read by the host library's prefetching loaders
(`utils/native.py`; `--native_loader false`: `data.dataset.data_loader`,
which gives the same bytes).  Where the JAX package's CLI scans a log
interval of steps into one program, this one does too, under the same
condition (`--log_interval` > 1, an interval that divides `--iterations`,
`--save_interval` and the step it starts from, and none of `--log_norms`,
`--host_rng`, `--class_cond`): each interval is a chunk of `log_interval`
batches for `trainer.make_multi_step`, which on a CUDA device replays one
captured step over it.  The first chunk is probed: where every value is
u / 127.5 - 1 of a uint8 u (every `.bin` written from pixels) the chunks go
to the device as uint8 and the step rebuilds the float32 values there, and
the log says which encoding it took.  Each chunk is staged in pinned host
memory (the native loaders write its rows there themselves) and copied on
a side stream while the device runs the chunk before it; the host's
milliseconds for a chunk are logged as `chunk_host_ms`.  Other runs take
one eager step per batch (`trainer.make_train_step`; with `--host_rng`,
its `step_with` on timesteps and noise drawn from torch's MT19937 stream on
the host, the JAX package's draws).

The loop never waits for the device within a log interval: the losses stay
on the device and are read once per interval.

Data parallel (`parallel/`): one process per device.  `--num_devices N`
(0: every card `--device cuda` shows; the CPU is one device) with N > 1
makes this command a launcher of N ranks of itself on this machine
(`distributed.launch`), rank r on card r (or on the CPU, over gloo);
`--coordinator_address host:port --num_processes N --process_id r` makes
this process rank r of N, on any machine, on `--device` (`cuda`: card r
modulo the cards it shows).  `--batch_size` and `--microbatch` are per
rank; the global batch is N times `--batch_size`.  Each rank reads its
shard of the stream (rows r, r + N, ... of every global batch of the
one-process run; `--data_dir` only for one command) and trains the flat
state of `parallel/mesh.py`, DP or with `--fsdp` ZeRO-3, on the chunked
path (captured with its collectives) or one step per call; the run is the
one-process run at the global batch.  Rank 0 writes the log and the
checkpoints, every rank joins their gather; `--auto_resume` resumes where
rank 0 says.  SIGTERM to the one command is passed to every rank, which
agree once per step or chunk whether any caught it, and all stop at one
step; `--coordinator_address` processes do not catch it.

`--tensor_parallel M` splits the N ranks into N / M data ranks by M model
ranks (rank d * M + m), as the JAX CLI's mesh: the model ranks of one data
index read the same shard and split the model Megatron-style (TP), with
`--fsdp` also its vector over the data axis (tp x fsdp); the global batch
is N / M times `--batch_size`.  `--spatial_parallel M` lays the ranks out
the same way, and the model ranks of one data index split the height of
every activation of their samples instead (`parallel/spatial.py`; with
`--fsdp`, the vector over the data axis too): each holds rows [m H/M,
(m+1) H/M) at every level and the whole model.  The lowest resolution,
`--image_size` / 2^(levels - 1), must divide by M, so that every level's
slice is whole and every pooled slice even (the JAX package's GSPMD
reshards where the port refuses).  A checkpoint is the one-device `.bin`,
so a run resumes under any layout.  Each rank needs a device of its own:
two NCCL ranks cannot share a card.

UNET_TPU_TORCH_S2D=on runs the model's level 0 in patch space
(`models.unet.set_s2d_mode`, ops/s2d.py) on one device, under DP and FSDP,
and on the model axis (`--tensor_parallel`, `--spatial_parallel`, with or
without `--fsdp`), as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import signal
import sys
import time

import numpy as np
import torch

from unet_tpu_torch.config import TrainConfig, UnetConfig
from unet_tpu_torch.data import dataset
from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule)
from unet_tpu_torch.io import checkpoint as ckpt_io
from unet_tpu_torch.models import unet
from unet_tpu_torch.ops.kernels import attention
from unet_tpu_torch.parallel import distributed
from unet_tpu_torch.parallel import mesh as pmesh
from unet_tpu_torch.training import trainer
from unet_tpu_torch.utils.args import add_dict_to_argparser
from unet_tpu_torch.utils import native
from unet_tpu_torch.utils.logger import Logger, TextLog


def defaults() -> dict:
    return dict(
        model_weights="",       # .bin checkpoint to load ("" = fresh init)
        data_file="data/elephant_train.bin",
        log_file="log.txt",
        image_size=64,
        num_channels=64,
        num_res_blocks=2,
        attention_resolutions="16,8",  # resolution units; ds factors are
        #                                image_size // res
        channel_mult="",               # "" = (1,2,3,4)
        num_head_channels=32,
        class_cond=False,
        num_classes=10,
        use_scale_shift_norm=False,
        randomize=False,               # shuffle + p=0.5 flip
        data_dir="",                   # directory of images instead of a
        #                                .bin (needs Pillow; required for
        #                                --class_cond labels)
        diffusion_steps=1000,
        noise_schedule="linear",
        lr=1e-4,
        weight_decay=0.0,
        lr_anneal_steps=0,         # >0 anneals lr linearly to 0 over this
        #                            many steps
        microbatch=0,              # >0 runs microbatches of this size with
        #                            averaged grads (full-batch math)
        label_dropout=0.0,         # classifier-free-guidance training:
        #                            per-example probability of the null
        #                            label; needs --class_cond
        ema_rate=0.0,              # >0 keeps a float32 parameter EMA and
        #                            saves it in checkpoints
        batch_size=32,
        log_interval=100,
        save_interval=10_000,
        iterations=100_000,
        init_model_only=False,
        init_model_filename="unet_init.bin",
        seed=0,
        compute_dtype="float32",   # float32 | bfloat16
        remat=False,
        shuffle=False,
        flip=False,                # p=0.5 horizontal flip augmentation
        host_rng=False,            # timesteps and noise from torch's
        #                            MT19937 stream on the host (the JAX
        #                            package's draws), per-step path
        log_norms=False,           # grad/param norms + peak memory
        num_devices=0,             # 0 = all visible devices of --device (a
        #                            CPU is one); N > 1: N ranks, one per
        #                            device, data parallel
        fsdp=False,                # shard the parameters, AdamW moments
        #                            and EMA over the ranks (ZeRO-3;
        #                            parallel/mesh.py)
        tensor_parallel=1,
        spatial_parallel=1,
        num_shards=1,              # dataloader shards; this process reads
        shard_index=0,             # shard shard_index of num_shards
        coordinator_address="",    # host:port of rank 0's rendezvous: this
        #                            process is rank --process_id of
        #                            --num_processes, one device each
        num_processes=0,
        process_id=-1,
        auto_resume=False,         # resume from the newest model_*.bin in
        #                            --output_dir if there is one (pairs
        #                            with the SIGTERM save)
        native_loader=True,        # .bin streams through the host
        #                            library's prefetch thread (false:
        #                            data_loader; the same bytes)
        output_dir="models",
        csv_log_dir="",
        device="cuda",             # where the model trains
    )


def create_argparser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    add_dict_to_argparser(parser, defaults())
    return parser


def model_config_from_args(args) -> UnetConfig:
    """Flags -> UnetConfig, as the JAX package's CLI converts them."""
    if args.channel_mult == "":
        channel_mult = (1, 2, 3, 4)
    else:
        channel_mult = tuple(
            int(m) for m in str(args.channel_mult).split(","))
    attention_ds = tuple(
        args.image_size // int(res)
        for res in str(args.attention_resolutions).split(","))
    return UnetConfig(model_channels=args.num_channels,
                      num_res_blocks=args.num_res_blocks,
                      image_size=args.image_size,
                      max_period=args.diffusion_steps,
                      attention_ds=attention_ds,
                      channel_mult=channel_mult,
                      num_head_channels=args.num_head_channels,
                      use_scale_shift_norm=args.use_scale_shift_norm)


def _visible_devices(args) -> int:
    """What --num_devices 0 means: the cards this machine shows for a CUDA
    --device without an index, else 1 (one card, or the CPU)."""
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        return max(torch.cuda.device_count(), 1)
    return 1


def _num_ranks(args) -> int:
    """The data axis: --num_devices, or with 0 all visible devices; the
    auto default drops to one device for --host_rng and --log_norms, as
    the JAX CLI's does."""
    if args.num_devices:
        return args.num_devices
    if args.host_rng or args.log_norms:
        return 1
    return _visible_devices(args)


def _model_axis(args) -> int:
    """The model axis: --tensor_parallel or --spatial_parallel (1 and
    below: none)."""
    return max(args.tensor_parallel, args.spatial_parallel, 1)


def _reject_bad_combos(args, ranks: int = 1, multiproc: bool = False
                       ) -> None:
    """Error loudly instead of silently ignoring flags.  `ranks` is the
    number of devices (data x model axis); `multiproc`, a run of
    --coordinator_address processes.  An EXPLICIT --num_devices > 1
    conflicts with single-device-only features; the auto default
    (--num_devices 0) quietly drops to one device for them.  The JAX CLI's
    rule that its data axis divide over the processes holds here by
    construction: a process is one device, and the processes of one data
    index read one shard."""
    def bad(cond, msg):
        if cond:
            raise SystemExit(f"train: {msg}")
    bad(not 0.0 <= args.ema_rate < 1.0, "--ema_rate must be in [0, 1)")
    bad(not 0.0 <= args.label_dropout < 1.0,
        "--label_dropout must be in [0, 1)")
    bad(args.label_dropout > 0.0 and not args.class_cond,
        "--label_dropout needs --class_cond")
    bad(args.lr_anneal_steps < 0, "--lr_anneal_steps must be >= 0")
    bad(args.noise_schedule not in ("linear", "cosine"),
        f"unknown --noise_schedule {args.noise_schedule!r}")
    bad(args.compute_dtype not in ("float32", "bfloat16"),
        f"unknown --compute_dtype {args.compute_dtype!r}")
    bad(args.log_interval < 1, "--log_interval must be >= 1")
    bad(args.save_interval < 0,
        "--save_interval must be >= 0 (0 = never save)")
    bad(args.microbatch < 0, "--microbatch must be >= 0")
    bad(args.microbatch > 0 and args.batch_size % args.microbatch != 0,
        f"--microbatch {args.microbatch} does not divide "
        f"--batch_size {args.batch_size}")
    bad(args.microbatch > 0 and args.host_rng,
        "--microbatch and --host_rng cannot be combined")
    bad(args.host_rng and args.log_norms,
        "--host_rng and --log_norms cannot be combined")
    bad(args.host_rng and args.class_cond,
        "--host_rng and --class_cond cannot be combined")
    bad(args.log_norms and args.class_cond,
        "--log_norms and --class_cond cannot be combined")
    bad(args.class_cond and not args.data_dir,
        "--class_cond needs --data_dir (labels come from image file-name "
        "prefixes)")
    bad(args.data_dir and args.shuffle,
        "--shuffle applies to .bin streams; use --randomize with "
        "--data_dir")
    bad(args.num_shards > 1 and args.data_dir,
        "--num_shards applies to .bin streams")
    bad(args.shard_index >= args.num_shards,
        "--shard_index must be < --num_shards")
    # the mesh (the JAX CLI's rules)
    bad(args.tensor_parallel > 1 and args.spatial_parallel > 1,
        "--tensor_parallel and --spatial_parallel both use the model "
        "mesh axis")
    bad(args.num_devices < 0, "--num_devices must be >= 0 (0 = all)")
    for flag in ("host_rng", "log_norms"):
        bad(args.num_devices > 1 and getattr(args, flag),
            f"--{flag} is only wired for single-device runs "
            "(--num_devices 1)")
    model_axis = _model_axis(args)
    if args.fsdp or model_axis > 1:
        bad(ranks % model_axis != 0,
            f"model axis {model_axis} does not divide {ranks} devices")
        bad(args.fsdp and ranks // model_axis < 2,
            "--fsdp needs >= 2 devices on the data axis")
        for flag in ("host_rng", "log_norms"):
            bad(getattr(args, flag),
                f"--{flag} is only wired for single-device runs")
    if args.spatial_parallel > 1:  # the port's own rule
        cfg = model_config_from_args(args)
        step = 2 ** (len(cfg.channel_mult) - 1)
        bad(cfg.image_size % (step * args.spatial_parallel) != 0,
            f"--spatial_parallel {args.spatial_parallel} does not divide "
            f"the lowest resolution {cfg.image_size / step:g} (--image_size "
            "/ 2^(levels - 1)): every level's slice of the height must be "
            "whole")
    device = torch.device(args.device)
    if ranks > 1 and not multiproc:
        bad(device.index is not None,
            f"--num_devices {ranks} takes --device cuda or cpu without an "
            f"index (rank r trains on card r); got --device {args.device}")
        bad(device.type == "cuda" and ranks > torch.cuda.device_count(),
            f"--num_devices {ranks} but this machine shows "
            f"{torch.cuda.device_count()} CUDA devices")
    bad(not args.coordinator_address
        and (args.num_processes not in (0, 1)
             or args.process_id not in (-1, 0)),
        "--num_processes and --process_id need --coordinator_address")
    if multiproc:
        nproc = args.num_processes
        bad(nproc < 1 or not 0 <= args.process_id < nproc,
            "--coordinator_address needs --num_processes N and "
            "--process_id in [0, N) (the port infers neither)")
        for flag in ("host_rng", "log_norms", "class_cond"):
            # class_cond stays single-process: labels come from --data_dir
            # (rejected below for multi-process .bin streams)
            bad(getattr(args, flag),
                f"--{flag} is only wired for single-process runs")
        bad(args.data_dir,
            "--data_dir has no shard support; multi-process runs need a "
            ".bin stream (each process reads its own shard)")
        bad(args.num_devices == 1,
            "--num_devices 1 conflicts with --coordinator_address")
        bad(args.num_devices not in (0, nproc),
            f"--num_devices {args.num_devices} would build a mesh over a "
            "subset of the global device set and exclude some processes' "
            "chips; omit it (0 = all) in multi-process runs")
        bad(args.num_shards != 1
            and (args.num_shards != nproc
                 or args.shard_index != args.process_id),
            "--num_shards is assigned per process automatically in "
            "multi-process runs; leave it at 1 (explicit sharding "
            "requires --shard_index <rank>, distinct per process)")
    # the JAX package's head rule (the kernels take every head it runs)
    fault = attention.head_size_fault(
        unet.attention_widths(model_config_from_args(args)),
        args.num_head_channels)
    bad(fault is not None, f"{fault} (--num_head_channels "
        f"{args.num_head_channels}, --num_channels {args.num_channels}, "
        f"--device {args.device})")


def _chunked(args, tc: TrainConfig, start_step: int) -> bool:
    """Whether the run takes the chunked path: the JAX CLI's condition
    (unet_tpu/cli/train.py, single device)."""
    return (not args.host_rng and not args.log_norms and not args.class_cond
            and tc.log_interval > 1
            and tc.save_interval % tc.log_interval == 0
            and start_step % tc.log_interval == 0
            and tc.iterations % tc.log_interval == 0)


def _as_uint8(chunk: np.ndarray):
    """The uint8 pixels u with u / 127.5 - 1 == chunk exactly, or None."""
    u8 = np.round((chunk + 1.0) * 127.5).astype(np.uint8)
    if np.array_equal(u8.astype(np.float32) / 127.5 - 1.0, chunk):
        return u8
    return None


class _ChunkStager:
    """Chunks to the device while it runs the chunk before.  On a CUDA
    device each chunk is written into one pinned host buffer (`buffer`, by
    the caller or by `put`) and copied from there without blocking, on a
    side stream, into whichever of two device buffers the running chunk
    does not read; `send` returns that buffer once the current stream is
    ordered after the copy.  On the CPU a chunk is used as it is."""

    def __init__(self, device: torch.device):
        self.device = device
        self.host = None
        self.dev = []
        self.turn = 0
        self.copied = None
        self.freed = [None, None]
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def buffer(self, shape, dtype) -> np.ndarray:
        """The host array the next chunk is to be written into.  On a CUDA
        device: the pinned buffer, once the last copy out of it is done
        (the copy runs asynchronously, so no row may be written before)."""
        dtype = np.dtype(dtype)
        if self.stream is None:
            self.host = np.empty(shape, dtype)
            return self.host
        if (self.host is None or tuple(self.host.shape) != tuple(shape)
                or self.host.numpy().dtype != dtype):
            self.host = torch.from_numpy(np.empty(shape, dtype)).pin_memory()
            self.dev = [torch.empty_like(self.host, device=self.device)
                        for _ in range(2)]
            self.copied = None
            self.freed = [None, None]
        elif self.copied is not None:
            self.copied.synchronize()
        return self.host.numpy()

    def send(self) -> torch.Tensor:
        """The chunk written into `buffer()`, on the device."""
        if self.stream is None:
            return torch.from_numpy(self.host)
        j, self.turn = self.turn, 1 - self.turn
        with torch.cuda.stream(self.stream):
            if self.freed[j] is not None:
                self.stream.wait_event(self.freed[j])
            self.dev[j].copy_(self.host, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record(self.stream)
        current = torch.cuda.current_stream(self.device)
        current.wait_event(self.copied)
        return self.dev[j]

    def put(self, chunk: np.ndarray) -> torch.Tensor:
        """`chunk` on the device (copied into the pinned buffer first)."""
        if self.stream is None:
            self.host = chunk
        else:
            self.buffer(chunk.shape, chunk.dtype)[...] = chunk
        return self.send()

    def release(self, buf: torch.Tensor) -> None:
        """The work queued so far on the current stream is the last to read
        `buf` (a buffer `send` returned)."""
        if self.stream is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self.freed[next(j for j, d in enumerate(self.dev)
                            if d is buf)] = event


def _step_of(path: str):
    """The step of a `model_<step>.bin` path, or None."""
    m = re.fullmatch(r"model_(\d+)\.bin", os.path.basename(path))
    return int(m.group(1)) if m else None


def _newest_checkpoint(output_dir: str):
    """The `model_<step>.bin` in `output_dir` with the largest step, or
    None."""
    steps = []
    if os.path.isdir(output_dir):
        steps = [s for s in map(_step_of, os.listdir(output_dir))
                 if s is not None]
    if not steps:
        return None
    return os.path.join(output_dir, f"model_{max(steps)}.bin")


def _loader(args, tc: TrainConfig, seed: int, start_step: int,
            data_rank: int = 0, data: int = 1):
    """(batch iterator, the native loader behind it or None), as the JAX
    CLI chooses them: a directory of images (rows data_rank, data_rank +
    data, ... of each global batch); a plain sequential `.bin` stream through
    `NativeLoader`; shuffle, flip or shards through `NativeAugmentedLoader`;
    `data_loader` with `--native_loader false`.  Every one starts
    `start_step` batches into its stream."""
    flip = args.flip or args.randomize
    if args.data_dir:
        return dataset.image_dir_loader(
            args.data_dir, tc.batch_size, size=args.image_size,
            class_cond=args.class_cond, randomize=args.randomize, seed=seed,
            skip_batches=start_step, num_shards=data,
            shard_index=data_rank), None
    if not args.native_loader:
        return dataset.data_loader(
            args.data_file, tc.batch_size, shuffle=tc.shuffle, flip=flip,
            seed=seed, skip_batches=start_step, num_shards=args.num_shards,
            shard_index=args.shard_index), None
    if not tc.shuffle and not flip and args.num_shards == 1:
        loader = native.NativeLoader(args.data_file, tc.batch_size,
                                     skip_batches=start_step)
    else:
        loader = native.NativeAugmentedLoader(
            args.data_file, tc.batch_size, shuffle=tc.shuffle, flip=flip,
            seed=seed, num_shards=args.num_shards,
            shard_index=args.shard_index, skip_batches=start_step)
    return iter(loader), loader


def main(argv=None):
    """Train as the flags say; returns the final state (None with
    --init_model_only, and in the command that launched --num_devices N
    ranks).  A rank of a data-parallel run returns its
    `parallel.mesh.ParallelState`."""
    args = create_argparser().parse_args(argv)
    launched = distributed.launched()
    multiproc = bool(args.coordinator_address)
    if launched is None and not multiproc:
        ranks = _num_ranks(args)
        _reject_bad_combos(args, ranks)  # before any work happens
        if args.num_devices == 0:
            print(f"--num_devices 0: {ranks} visible device(s) of --device "
                  f"{args.device}")
        if ranks > 1:
            distributed.launch(
                [sys.executable, "-m", "unet_tpu_torch.cli.train",
                 *(sys.argv[1:] if argv is None else argv)], ranks)
            return None
        return _train(args, argv)
    if launched is not None:
        address, world, rank = launched
        _reject_bad_combos(args, world)
    else:
        address, world, rank = (args.coordinator_address,
                                args.num_processes, args.process_id)
        _reject_bad_combos(args, args.num_devices or world, multiproc=True)
    device = distributed.initialize(address, world, rank, args.device)
    try:
        return _train(args, argv, device=device, rank=rank, world=world,
                      multiproc=multiproc)
    finally:
        distributed.shutdown()


def _train(args, argv, device=None, rank: int = 0, world: int = 1,
           multiproc: bool = False):
    """The run of one process: the one-device path without a process group
    (`device` None), else rank `rank` of `world` (`parallel/mesh.py`)."""
    parallel = device is not None
    main_proc = rank == 0
    # the data axis: the model ranks of one data index read the same rows
    model_axis = _model_axis(args)
    data_rank, data = rank // model_axis, world // model_axis
    if parallel:
        if multiproc:
            # each data index streams its own interleaved shard of the data
            args.num_shards, args.shard_index = data, data_rank
        else:
            # shard shard_index of num_shards, split again over the data
            # axis: data rank d reads rows d, d + data, ... of that shard's
            # batches
            args.shard_index += args.num_shards * data_rank
            args.num_shards *= data
    else:
        device = torch.device(args.device)
    if args.auto_resume and not args.model_weights:
        newest = _newest_checkpoint(args.output_dir) if main_proc else None
        if parallel:
            # ranks must agree on the resume point, and only rank 0 writes
            # checkpoints: rank 0 decides, everyone follows (a rank whose
            # filesystem lacks the file then fails at load)
            step = distributed.broadcast_int(
                -1 if newest is None else _step_of(newest))
            newest = (None if step < 0 else
                      os.path.join(args.output_dir, f"model_{step}.bin"))
        if newest is not None:
            args.model_weights = newest
            if main_proc:
                print(f"auto-resume: {newest}")
    if (not args.init_model_only and not args.data_dir
            and not os.path.exists(args.data_file)):
        raise SystemExit(f"train: data file not found: {args.data_file} "
                         "(write one with unet_tpu_torch.cli.prepare_data)")
    cfg = model_config_from_args(args)
    num_classes = args.num_classes if args.class_cond else None
    tc = TrainConfig(batch_size=args.batch_size, lr=args.lr,
                     weight_decay=args.weight_decay,
                     lr_anneal_steps=args.lr_anneal_steps,
                     microbatch=args.microbatch,
                     label_dropout=args.label_dropout,
                     ema_rate=args.ema_rate,
                     iterations=args.iterations,
                     log_interval=args.log_interval,
                     save_interval=args.save_interval,
                     compute_dtype=args.compute_dtype, remat=args.remat,
                     shuffle=args.shuffle or args.randomize)

    # --- model init / load ---
    ckpt = None
    seed = args.seed
    if args.model_weights:
        ckpt = ckpt_io.load(args.model_weights, cfg, num_classes,
                            device=device)
        argv_flags = sys.argv[1:] if argv is None else argv
        if ckpt.ema is not None and args.ema_rate == 0.0:
            if "--ema_rate" in argv_flags:
                # explicit --ema_rate 0: the user is turning the EMA off
                ckpt.ema = None
                print("dropping the checkpoint's EMA (--ema_rate 0)")
            elif ckpt.ema_rate > 0.0:
                # the rate travels in the checkpoint (header[39]): resuming
                # without --ema_rate keeps averaging at it
                args.ema_rate = ckpt.ema_rate
                tc = dataclasses.replace(tc, ema_rate=ckpt.ema_rate)
                print(f"resuming EMA at its checkpointed rate "
                      f"{ckpt.ema_rate:g}")
            else:
                raise SystemExit(
                    "train: checkpoint carries EMA weights but no rate — "
                    "pass --ema_rate to keep averaging, or --ema_rate 0 "
                    "to drop the EMA")
        if ckpt.rng_seed is not None:
            seed = ckpt.rng_seed
        if (ckpt.noise_schedule is not None
                and ckpt.noise_schedule != args.noise_schedule):
            # q_sample must use the schedule the run was trained with
            print(f"resuming with the checkpointed noise schedule "
                  f"{ckpt.noise_schedule!r} (not {args.noise_schedule!r})")
            args.noise_schedule = ckpt.noise_schedule
        params = ckpt.params
        print(f"loaded {args.model_weights} (step {ckpt.step})")
    else:
        params = unet.init(cfg, num_classes,
                           generator=torch.Generator().manual_seed(seed),
                           device=device)
        print(f"fresh init (seed {seed}, "
              f"{ckpt_io.num_params(cfg, num_classes):,} params)")

    if args.init_model_only:
        if main_proc:
            ckpt_io.save(args.init_model_filename, ckpt_io.Checkpoint(
                params=params, cfg=cfg, batch_size=tc.batch_size,
                noise_schedule=args.noise_schedule))
            print(f"wrote init checkpoint to {args.init_model_filename}")
        return None

    if ckpt is not None:
        state = trainer.from_checkpoint(ckpt, seed=seed, ema_rate=tc.ema_rate)
    else:
        state = trainer.init_state(params, seed=seed, ema_rate=tc.ema_rate)
    start_step = state.step
    host_rng = None
    if args.host_rng:
        host_rng = native.TorchRng(seed)
        if ckpt is not None and ckpt.host_rng_state is not None:
            host_rng.set_state(ckpt.host_rng_state)

    # --- data + step function ---
    diffusion = GaussianDiffusion.create(
        named_beta_schedule(args.noise_schedule, cfg.max_period),
        device=device)
    chunked = _chunked(args, tc, start_step)
    mesh = unravel = None
    tp, use_sp = args.tensor_parallel > 1, args.spatial_parallel > 1
    if parallel:
        # the flat state of this rank; the tree state goes
        mesh = pmesh.make_mesh(model=model_axis)
        unravel = trainer.Unravel(params)
        state = pmesh.init_state(
            unravel, state.params, mesh, fsdp=args.fsdp, tp=tp,
            ema_rate=tc.ema_rate, seed=state.seed, step=state.step,
            m=state.m, v=state.v, ema=state.ema)
        if main_proc:
            print(f"data parallel: {data} rank(s) x batch {tc.batch_size} "
                  f"= global batch {data * tc.batch_size}")
            if tp:
                print(f"tensor parallel: {model_axis} model ranks a data "
                      "rank")
            if use_sp:
                print(f"spatial parallel: {model_axis} model ranks a data "
                      "rank")
            if args.fsdp or tp:
                kind = "fsdp+tp" if args.fsdp and tp else (
                    "fsdp" if args.fsdp else "tp")
                print(f"param sharding: "
                      f"{pmesh.shard_fraction(state.placement, state.layout):.1%}"
                      f" of elements sharded ({kind})")

    def make_step(input_u8: bool):
        if parallel:
            return pmesh.make_parallel_train_step(
                cfg, tc, mesh, diffusion, fsdp=args.fsdp, tp=tp,
                spatial=use_sp, class_cond=args.class_cond,
                example_params=params, input_u8=input_u8)
        return trainer.make_multi_step(cfg, tc, diffusion, device,
                                       input_u8=input_u8)

    if parallel and not chunked:
        step_fn = make_step(False)
    elif args.log_norms:
        step_fn = trainer.make_train_step_aux(cfg, tc, diffusion, device)
    elif not chunked:
        step_fn, step_with = trainer.make_train_step(cfg, tc, diffusion,
                                                     device)
    if not args.data_dir:
        hdr = dataset.BinDataset(args.data_file)
        if ((hdr.height, hdr.width, hdr.channels)
                != (cfg.image_size, cfg.image_size, cfg.in_channels)):
            raise SystemExit(
                f"train: {args.data_file} holds "
                f"{hdr.height}x{hdr.width}x{hdr.channels} images but the "
                f"model is configured for {cfg.image_size}x"
                f"{cfg.image_size}x{cfg.in_channels} — pass --image_size "
                f"{hdr.height} (and matching arch flags) or rebuild the "
                "dataset with prepare_data --size")
    loader, native_loader = _loader(args, tc, seed, start_step, data_rank,
                                    data)

    # --- loop ---
    # rank 0 owns the log files and the checkpoint writes; the other ranks
    # print to their own standard output only
    text_log = TextLog(args.log_file if main_proc else None)
    kv_log = Logger((args.csv_log_dir or None) if main_proc else None)
    counter = trainer.LossCounter()
    os.makedirs(args.output_dir, exist_ok=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    multi = None  # the chunked path's step, built on the first chunk
    stager = _ChunkStager(device)
    chunk_shape = (tc.log_interval, tc.batch_size, cfg.image_size,
                   cfg.image_size, cfg.in_channels)

    def next_chunk() -> torch.Tensor:
        """The next `log_interval` batches, on the device, in the encoding
        the first chunk's probe chose.  Past the first chunk a native
        loader writes the rows straight into the staging buffer (uint8 in
        one pass: round((v + 1) * 127.5), so later chunks are not probed
        again, as in the JAX CLI)."""
        nonlocal multi
        t0 = time.perf_counter()
        if native_loader is not None and multi is not None:
            buf = stager.buffer(chunk_shape, np.uint8 if multi.input_u8
                                else np.float32)
            for rows in buf:
                native_loader.next_into(rows)
            batches = stager.send()
        else:
            if native_loader is not None:
                chunk = np.empty(chunk_shape, np.float32)
                for rows in chunk:
                    native_loader.next_into(rows)
            else:
                chunk = np.stack([next(loader)
                                  for _ in range(tc.log_interval)])
            u8 = _as_uint8(chunk)
            if multi is None:
                multi = make_step(u8 is not None)
                text_log.log(
                    "H2D encoding: uint8 (byte-derived dataset; f32 rebuilt "
                    "on the device within 1 ulp)" if multi.input_u8 else
                    "H2D encoding: float32 (the data is not u/127.5 - 1 of "
                    "uint8 pixels u)")
            if multi.input_u8 and u8 is None:
                raise SystemExit("train: a chunk past the first is not "
                                 "uint8-derived, as the first one was")
            batches = stager.put(u8 if multi.input_u8 else chunk)
        kv_log.logkv_mean("chunk_host_ms", (time.perf_counter() - t0) * 1e3)
        return batches

    def save(it: int) -> str:
        """model_<it>.bin, written by rank 0; under FSDP and TP every rank
        joins the gather of the pieces first."""
        path = os.path.join(args.output_dir, f"model_{it}.bin")
        saved = state
        if parallel:
            flat, m, v, ema = pmesh.host_state(state)
            if not main_proc:
                return path
            saved = pmesh.tree_state(unravel, flat, m, v, ema,
                                     step=state.step, seed=state.seed)
        ckpt_io.save(path, trainer.to_checkpoint(
            saved, cfg, batch_size=tc.batch_size, loader_pos=it,
            ema_rate=tc.ema_rate, noise_schedule=args.noise_schedule,
            host_rng_state=(host_rng.get_state() if host_rng is not None
                            else None)))
        text_log.log(f"saved {path}")
        return path

    # SIGTERM / SIGINT: the handler only notes the signal; the loop saves
    # after the step or chunk in flight and returns.  A second signal kills
    # at once (the handler puts the default back).  The ranks of one
    # --num_devices command (whose launcher passes the signal on to each)
    # agree once per step or chunk on whether any caught it, so that all
    # stop at one step; not armed for --coordinator_address processes,
    # whose signals no launcher passes on.
    caught = []

    def graceful(signum, frame):
        caught.append(signum)
        signal.signal(signum, signal.SIG_DFL)

    def stopping() -> bool:
        if multiproc:
            return False
        if parallel:
            return distributed.any_rank(bool(caught))
        return bool(caught)

    previous = {} if multiproc else {
        sig: signal.signal(sig, graceful)
        for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        pending = []  # this interval's losses, still on the device
        t_flush = time.perf_counter()
        it = start_step
        batches = next_chunk() if chunked else None
        while it < tc.iterations:
            if chunked:
                state, losses = multi(state, batches)
                stager.release(batches)
                # stage the next chunk while the device runs this one (not
                # on the way out: a resume rebuilds the cursor from the step)
                batches = (next_chunk()
                           if it + tc.log_interval < tc.iterations
                           and not caught else None)
                pending.append(losses)
                it += tc.log_interval
            elif parallel:
                if args.class_cond:
                    batch, labels = next(loader)
                    state, loss = step_fn(state, batch[None], labels[None])
                else:
                    state, loss = step_fn(state, next(loader)[None])
                pending.append(loss)
                it += 1
            elif host_rng is not None:
                # the JAX CLI's draws: timesteps floor(u * T), then the noise
                # in torch's NCHW element order, laid out NHWC
                batch = next(loader)
                B = batch.shape[0]
                t = host_rng.timesteps(B, cfg.max_period)
                noise = np.ascontiguousarray(host_rng.normal(
                    (B, cfg.in_channels, cfg.image_size, cfg.image_size)
                ).transpose(0, 2, 3, 1))
                state, loss = step_with(state, batch, t, noise)
                pending.append(loss[None])
                it += 1
            elif args.class_cond:
                batch, labels = next(loader)
                state, loss = step_fn(state, batch, labels)
                pending.append(loss[None])
                it += 1
            else:
                batch = torch.from_numpy(next(loader)).to(device)
                if args.log_norms:
                    state, aux = step_fn(state, batch)
                    pending.append(aux["loss"][None])
                    kv_log.logkv_mean("grad_norm_mean",
                                      float(aux["grad_norm"]))
                    kv_log.logkv("grad_norm", float(aux["grad_norm"]))
                    kv_log.logkv_mean("param_norm", float(aux["param_norm"]))
                else:
                    state, loss = step_fn(state, batch)
                    pending.append(loss[None])
                it += 1
            if it % tc.log_interval == 0:
                for loss in torch.cat(pending).tolist():  # waits for the card
                    counter.add(loss)
                pending.clear()
                dt = (time.perf_counter() - t_flush) / tc.log_interval
                mean_loss = counter.mean_and_reset()
                text_log.log(f"step {it}: loss {mean_loss:.6f} "
                             f"({dt * 1e3:.2f} ms/step)")
                kv_log.logkv("step", it)
                kv_log.logkv("loss", mean_loss)
                kv_log.logkv("ms_per_step", dt * 1e3)
                if args.log_norms:
                    peak = trainer.device_peak_memory_mib(device)
                    if peak is not None:
                        kv_log.logkv("peak_mem_MiB", round(peak, 1))
                kv_log.dumpkvs()
                t_flush = time.perf_counter()
            path = None
            if tc.save_interval > 0 and it % tc.save_interval == 0:
                path = save(it)
            if stopping():
                path = path or save(it)
                text_log.log(f"caught signal {caught[0] if caught else '-'} "
                             f"at step {it}; checkpoint saved, exiting "
                             f"(resume with --model_weights {path} or "
                             "--auto_resume true)")
                return state
    finally:
        # main() runs in-process in tests: the caller's handlers come back
        # even when the loop raises
        for sig, handler in previous.items():
            if handler is not None:  # None: installed from C code
                signal.signal(sig, handler)
    return state


if __name__ == "__main__":
    main()
