"""Dissect the training CLI's chunked wall time into its host phases (port
of scripts/profile_input_pipeline.py).

    python -m unet_tpu_torch.scripts.profile_input_pipeline \\
        --data_file data.bin [--chunks 8] [--k 100] [--image_size 64] \\
        [--batch_size 32] [--ema_rate 0.999] [--device cuda]

The chunked path of `cli/train.py`, per chunk of k steps:

  dispatch  multi(state, chunk_N)    queue k steps (on a CUDA device: k
                                     replays of one captured step)
  assemble  chunk_N+1                the native loader's rows, uint8,
                                     straight into the pinned buffer
  stage     send()                   the copy to the device on a side stream
  drain     losses_N.cpu()           waits for the device to finish

with the CLI's own pieces: `utils.native.NativeAugmentedLoader(shuffle,
flip, seed 0)`, `cli.train._ChunkStager` and `trainer.make_multi_step(...,
input_u8=True)`, bfloat16, the default model at `--image_size`, full width
and depth, its weights from seed 0.  Wall ms/step is max(device, assemble +
stage) when the overlap works; the rest is time the host holds the device
back.  Each phase is reported per step, averaged over `--chunks` chunks
after one warm-up chunk (which also captures the step).

On a CUDA device a dispatch is k host-side steps, not one program, so it
is split further, each part on the host's clock in a loop of its own of k
calls over the same captured step, each call on an idle device: `step`,
a call of `multi` on two batches less one on one batch (a step's share of
a call); `call`, the rest of the one-batch call (once a call: the binding
check, the step counter, the losses' tensor); (a) `launch`, a bare replay
of the captured step (the graph launch alone, with the launch counters it
adds); (b) `draws`, `trainer._draws` (the step's generator, its timesteps
and noise); (c) `rest`, step less (a) and (b): the copies into the
graph's inputs and the write of the loss; and `remainder`, a chunk's
dispatch per step less `step` and its share of `call`: what a dispatch
onto a busy device takes beyond the same work on an idle one.  It is
inferred, not timed: it holds any wait for room in the device's queue of
launches and any host work that is slower while the device is busy (a
graph launch, the loader's thread competing for the host).  The calls and
the bare replays
are real steps: they train the state further.  On the CPU there is no
graph and no split.

Prints one JSON object; `profile` returns it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from unet_tpu_torch.cli.train import _ChunkStager
from unet_tpu_torch.config import TrainConfig, UnetConfig
from unet_tpu_torch.models import unet
from unet_tpu_torch.training import trainer
from unet_tpu_torch.utils.benchmark import device_line
from unet_tpu_torch.utils.native import NativeAugmentedLoader


def _ms_per_step(seconds, k) -> float:
    return float(np.mean(seconds)) / k * 1e3


def _dispatch_split(multi, state, chunk, k, dispatch_ms, device) -> dict:
    """The dispatch split of the module's docstring, host ms, each part
    timed k times on an idle device (a synchronize before every call, so
    that no launch waits for room in the device's queue)."""
    def idle_ms(fn):
        seconds = 0.0
        for _ in range(k):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn()
            seconds += time.perf_counter() - t0
        torch.cuda.synchronize(device)
        return seconds / k * 1e3

    one = idle_ms(lambda: multi(state, chunk[:1]))
    step = idle_ms(lambda: multi(state, chunk[:2])) - one
    launch = idle_ms(multi.graph)
    draws = idle_ms(lambda: trainer._draws(
        state, chunk[0], multi.diffusion.num_timesteps, device))
    return {"step": step, "call": one - step, "launch": launch,
            "draws": draws, "rest": step - launch - draws,
            "remainder": dispatch_ms - step - (one - step) / k}


def profile(cfg: UnetConfig, tc: TrainConfig, data_file: str, device,
            chunks: int, k: int) -> dict:
    """The chunked path's host phases at `cfg`, `tc` (see the module's
    docstring): ms per step of each phase, the dispatch split (None on the
    CPU), the steps taken through `multi` and the bare replays (each adds
    one step's launches to the kernels' counters), and the last chunk's
    losses."""
    device = torch.device(device)
    B, S, C = tc.batch_size, cfg.image_size, cfg.in_channels
    loader = NativeAugmentedLoader(data_file, B, shuffle=True, flip=True,
                                   seed=0)
    multi = trainer.make_multi_step(cfg, tc, device=device, input_u8=True)
    params = unet.init(cfg, generator=torch.Generator().manual_seed(0),
                       device=device)
    state = trainer.init_state(params, ema_rate=tc.ema_rate)
    stager = _ChunkStager(device)

    def assemble():
        buf = stager.buffer((k, B, S, S, C), np.uint8)
        for rows in buf:
            loader.next_into(rows)

    # warm-up: the first step runs eagerly, the second is captured
    assemble()
    chunk = stager.send()
    state, losses = multi(state, chunk)
    stager.release(chunk)
    losses.cpu()

    times = {name: [] for name in ("dispatch", "assemble", "stage", "drain",
                                   "total")}
    assemble()
    nxt = stager.send()
    for _ in range(chunks):
        chunk = nxt
        t0 = time.perf_counter()
        state, losses = multi(state, chunk)
        stager.release(chunk)
        t1 = time.perf_counter()
        assemble()
        t2 = time.perf_counter()
        nxt = stager.send()
        t3 = time.perf_counter()
        host_losses = losses.cpu()
        t4 = time.perf_counter()
        for name, seconds in (("dispatch", t1 - t0), ("assemble", t2 - t1),
                              ("stage", t3 - t2), ("drain", t4 - t3),
                              ("total", t4 - t0)):
            times[name].append(seconds)
    ms = {name: _ms_per_step(v, k) for name, v in times.items()}
    split = None
    if device.type == "cuda":
        split = _dispatch_split(multi, state, nxt, k, ms["dispatch"], device)
    return {"device": device_line(device), "image_size": S,
            "batch_size": B, "k": k, "chunks": chunks,
            "compute_dtype": tc.compute_dtype, "ema_rate": tc.ema_rate,
            "ms_per_step": ms, "dispatch_split_ms_per_step": split,
            "steps": (chunks + 1 + 3 * (split is not None)) * k,
            "bare_replays": 0 if split is None else k,
            "losses": host_losses.tolist()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_file", required=True)
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--image_size", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--ema_rate", type=float, default=0.999)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.chunks < 1 or args.k < 1:
        p.error("--chunks and --k must be >= 1")
    cfg = UnetConfig(image_size=args.image_size)
    tc = TrainConfig(batch_size=args.batch_size, compute_dtype="bfloat16",
                     ema_rate=args.ema_rate, shuffle=True)
    result = profile(cfg, tc, args.data_file, args.device, args.chunks,
                     args.k)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
