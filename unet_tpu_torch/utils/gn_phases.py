"""Where the time of one GroupNorm kernel launch goes, phase by phase.

    python -m unet_tpu_torch.utils.gn_phases

Builds csrc/*.cu with -DGN_PHASE_CLOCKS, in which thread 0 of every block
of the GroupNorm kernels keeps its SM's cycle counter at each phase
boundary (and the global timer at its start and end), launches each case
once after warm-up, and prints one JSON object per case: the phases'
cycles, median and largest over the blocks; from the first block's start,
the nanoseconds to the median and the last block's end; and the
device-alone time of a call (a CUDA graph of 20 calls) of this build.  The
cases are chip_smoke.py's headline shapes and a few others, and the split
GroupNorm's two cluster kernels (`gn_stats`, `gn_bwd_sums`) on a rank's
rows.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

from unet_tpu_torch.ops.kernels import _build
from unet_tpu_torch.ops.kernels import groupnorm as gn
from unet_tpu_torch.utils.benchmark import device_line, graph_ms

PHASES = {
    "forward": ("start ring", "sum", "block mean", "squares and block M2",
                "exchange", "combine", "normalise"),
    "backward": ("start ring", "pass 1", "block sums", "cluster barrier",
                 "cluster sums and t1, t2", "pass 2"),
    # the split GroupNorm's two cluster kernels: K4 and K5 stopped early
    "stats": ("start ring", "sum", "block mean", "squares and block M2",
              "exchange", "combine"),
    "sums": ("start ring", "pass 1", "block sums", "cluster barrier",
             "reduce-scatter"),
}
CASES = [((8, 64, 64, 64), "bfloat16", "forward"),
         ((4, 64, 64, 64), "bfloat16", "forward"),
         ((8, 8, 8, 256), "bfloat16", "forward"),
         ((8, 32, 32, 320), "bfloat16", "forward"),
         ((2, 128, 128, 256), "bfloat16", "forward"),
         ((8, 64, 64, 64), "float32", "forward"),
         ((32, 64, 64, 64), "bfloat16", "backward"),
         ((32, 32, 32, 320), "bfloat16", "backward"),
         ((32, 8, 8, 1024), "bfloat16", "backward"),
         ((32, 64, 64, 192), "float32", "backward"),
         ((32, 8, 8, 2048), "float32", "backward")] + [
    (shape, dtype, kind)  # a rank's rows at two model ranks (chip_smoke.py)
    for shape in ((32, 32, 64, 64), (32, 4, 8, 256))
    for dtype in ("bfloat16", "float32") for kind in ("stats", "sums")]
BLOCKS, SLOTS = 4096, 16  # csrc/groupnorm.cu's kClockBlocks, kClockSlots


def phase_clocks(lib, nblocks):
    buf = np.zeros(BLOCKS * SLOTS, dtype=np.int64)
    torch.cuda.synchronize()
    _build.check_launch(lib.unet_gn_phase_clocks(buf.ctypes.data),
                        "unet_gn_phase_clocks")
    return buf.reshape(BLOCKS, SLOTS)[:nblocks]


def run_case(lib, shape, dtype, kind, act="silu", seed=0):
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    x = torch.randn(shape, generator=gen, device=dev).to(dt)
    g = torch.ones(shape[-1], device=dev, dtype=dt)
    b = torch.zeros(shape[-1], device=dev, dtype=dt)
    dy = torch.randn(shape, generator=gen, device=dev).to(dt)
    _, mean, rstd = gn.gn_act_fwd(x, g, b, 32, 1e-5, act)
    call = {
        "forward": lambda: gn.gn_act_fwd(x, g, b, 32, 1e-5, act),
        "backward": lambda: gn.gn_act_bwd(x, g, b, mean, rstd, dy, 32, act),
        "stats": lambda: gn.gn_stats(x, 32),
        "sums": lambda: gn.gn_bwd_sums(x, g, b, mean, rstd, dy, 32, act),
    }[kind]
    for _ in range(3):
        call()
    ms = graph_ms(call)
    geo = (gn.split_geometry(kind, *shape, 32, dt) if kind in ("stats", "sums")
           else gn.geometry(*shape, 32, dt, kind == "backward"))
    call()
    clocks = phase_clocks(lib, shape[0] * geo.cluster)
    names = PHASES[kind]
    cycles = np.diff(clocks[:, :len(names) + 1], axis=1)
    start, end = clocks[:, 14], clocks[:, 15]
    return {"shape": list(shape), "dtype": dtype, "act": act,
            "kernel": kind, "cluster": geo.cluster,
            "staged": geo.staged, "streamed": geo.streamed,
            "graph_ms": ms,
            "cycles_median": dict(zip(names, np.median(cycles, 0).tolist())),
            "cycles_max": dict(zip(names, cycles.max(0).tolist())),
            "ns_to_median_end": float(np.median(end - start.min())),
            "ns_to_last_end": float(end.max() - start.min()),
            "ns_start_spread": float(start.max() - start.min())}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("gn_phases needs a CUDA device")
    _build.extra_flags = ("-DGN_PHASE_CLOCKS",)
    lib = _build.load()
    lib.unet_gn_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.unet_gn_phase_clocks.restype = ctypes.c_int
    print(json.dumps({"device": device_line()}), flush=True)
    for shape, dtype, kind in CASES:
        print(json.dumps(run_case(lib, shape, dtype, kind)), flush=True)


if __name__ == "__main__":
    main()
