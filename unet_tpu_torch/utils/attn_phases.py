"""Where the time of the cluster attention forward (heads wider than 256)
goes, phase by phase.

    python -m unet_tpu_torch.utils.attn_phases [--out FILE]

Builds csrc/*.cu with -DWIDE_PHASE_CLOCKS, in which thread 0 of every block
of the forward cluster kernel adds up its SM's cycles in each phase of the
kernel's loop over the stages of keys (csrc/attention_wide.cu's
`WIDE_PHASE`), and prints, for each of `utils/attn_sweep.py`'s shapes in
both types and at every number of chunks a block may hold, one JSON object:
the layout, the blocks, the phases' cycles a block (the mean over the
blocks, over the whole loop) and the device-alone time of a call of this
build (the fastest of three CUDA graphs of 20 calls).  Thread 0 is in group
0; the groups run in step between the block's barriers.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math

import numpy as np
import torch

from unet_tpu_torch.ops.kernels import _build
from unet_tpu_torch.ops.kernels import attention as attn
from unet_tpu_torch.utils.attn_sweep import SHAPES
from unet_tpu_torch.utils.benchmark import device_line, graph_ms

# csrc/attention_wide.cu's WIDE_PHASE(0) .. WIDE_PHASE(7)
PHASES = ("wait for the stage", "score products", "groups' sum",
          "first barrier's wait", "reduce slice", "second barrier", "gather",
          "softmax and output")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every line to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_phases needs a CUDA device")
    _build.extra_flags = ("-DWIDE_PHASE_CLOCKS",)
    lib = _build.load()
    clocks = lib.unet_wide_phase_clocks
    clocks.argtypes = [ctypes.c_void_p]
    clocks.restype = ctypes.c_int
    buf = np.zeros(len(PHASES) + 1, dtype=np.uint64)
    fwd = attn._launcher("unet_qkv_attention_fwd_cluster")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    lines = [json.dumps({"device": device_line()})]
    print(lines[-1], flush=True)
    for B, T, C, NH in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((B, T, 3 * C), generator=gen,
                              device=dev).to(dtype)
            out = torch.empty((B, T, C), dtype=dtype, device=dev)
            for most in (1, 2, 4) if dtype == torch.bfloat16 else (1, 2):
                def fn():
                    return fwd(qkv.data_ptr(), out.data_ptr(), B, T, C, NH,
                               1.0 / math.sqrt(C // NH),
                               int(dtype == torch.bfloat16), most,
                               torch.cuda.current_stream().cuda_stream)
                _build.check_launch(fn(), "unet_qkv_attention_fwd_cluster")
                ms = min(graph_ms(fn) for _ in range(3))
                torch.cuda.synchronize()
                _build.check_launch(clocks(buf.ctypes.data), "clocks")  # zero
                _build.check_launch(fn(), "unet_qkv_attention_fwd_cluster")
                torch.cuda.synchronize()
                _build.check_launch(clocks(buf.ctypes.data), "clocks")
                blocks = int(buf[-1])
                lines.append(json.dumps(dict(
                    shape=[B, T, C, NH], dtype=str(dtype), most_chunks=most,
                    layout=list(attn.kernel_layout(C // NH, dtype, 10**9,
                                                   most)),
                    blocks=blocks, graph_ms=ms,
                    cycles_a_block={name: float(buf[k]) / blocks
                                    for k, name in enumerate(PHASES)})))
                print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
