"""The cluster attention kernels (heads wider than 256) at every number of
chunks a block may hold, beside the one the grid-size rule picks.

    python -m unet_tpu_torch.utils.attn_sweep [--out FILE]

For each of `SHAPES` (B, T, C, NH: DDPM 256 x 256's one head of 512 at its
two attention resolutions, at B = 8 and at the paper's batch of 64), float32
and bfloat16, forward and backward, runs the cluster kernels at 1, 2 and
(bfloat16) 4 chunks a block at the most (`unet_qkv_attention_*_cluster` in
csrc/attention_wide.cu), checks each against the plain version (the largest
error over the largest value) and times it device alone (the fastest of
three CUDA graphs of 20 calls).  Prints one JSON object per case, with the
layout it launched (`kernel_layout` at that many chunks and any
launch) and `chosen` where
it is what the rule picks (`kernel_layout` for the launch's row tiles), so
that the rule can be read against the alternatives.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from unet_tpu_torch.ops.kernels import attention as attn
from unet_tpu_torch.utils.benchmark import device_line, graph_ms

SHAPES = [(8, 256, 512, 1), (64, 256, 512, 1), (8, 64, 512, 1),
          (64, 64, 512, 1)]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every line to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("attn_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd = attn._launcher("unet_qkv_attention_fwd_cluster")
    bwd = attn._launcher("unet_qkv_attention_bwd_cluster")
    lines = [json.dumps({"device": device_line()})]
    print(lines[-1], flush=True)
    for B, T, C, NH in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            qkv = torch.randn((B, T, 3 * C), generator=gen,
                              device=dev).to(dtype)
            dout = torch.randn((B, T, C), generator=gen, device=dev).to(dtype)
            want = {"fwd": attn.qkv_attention_plain(qkv, NH).float(),
                    "bwd": attn.qkv_attention_bwd_plain(qkv, dout,
                                                        NH).float()}
            out = torch.empty((B, T, C), dtype=dtype, device=dev)
            dqkv = torch.empty_like(qkv)
            stats = torch.empty((3, B, NH, T), device=dev)
            scale = 1.0 / math.sqrt(C // NH)
            bf16 = int(dtype == torch.bfloat16)
            pick = attn.kernel_layout(C // NH, dtype,
                                      attn.row_tiles(B, T, NH, dtype))
            chunks = (1, 2, 4) if dtype == torch.bfloat16 else (1, 2)
            for kind in ("fwd", "bwd"):
                got = out if kind == "fwd" else dqkv
                for most in chunks:
                    def fn():
                        stream = torch.cuda.current_stream().cuda_stream
                        if kind == "fwd":
                            return fwd(qkv.data_ptr(), out.data_ptr(), B, T,
                                       C, NH, scale, bf16, most, stream)
                        return bwd(qkv.data_ptr(), dout.data_ptr(),
                                   dqkv.data_ptr(), stats.data_ptr(), B, T,
                                   C, NH, scale, bf16, most, stream)
                    code = fn()
                    if code != 0:
                        raise RuntimeError(f"{kind} {(B, T, C, NH)} {dtype} "
                                           f"at {most} chunks: error {code}")
                    torch.cuda.synchronize()
                    err = ((got.float() - want[kind]).abs().max()
                           / want[kind].abs().max()).item()
                    layout = attn.kernel_layout(C // NH, dtype, 10**9, most)
                    lines.append(json.dumps(dict(
                        kernel=kind, shape=[B, T, C, NH], dtype=str(dtype),
                        most_chunks=most, layout=list(layout),
                        blocks=attn.row_tiles(B, T, NH, dtype) * layout[1]
                        * layout[2], chosen=layout == pick,
                        ms=min(graph_ms(fn) for _ in range(3)),
                        err_of_largest=err)))
                    print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
