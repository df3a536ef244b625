"""The split GroupNorm's two cluster kernels at every cut of the rows, and
gn_apply at every run of rows a block.

    python -m unet_tpu_torch.utils.gn_sweep [--out FILE]

For each of chip_smoke.py's `SPLIT_SHAPES` (a rank's rows at two model
ranks, B=32), float32 and bfloat16, times `gn_stats` and `gn_bwd_sums` (with
SiLU) at every cluster of 1 to 16 blocks that cuts the rows and, for each,
at a few tile sizes: all of a block's rows in one tile, four tiles,
tiles of 8, 16 and 32 KB, and the tile `split_geometry` picks; and
`gn_apply` (with SiLU, the statistics of two ranks) at runs of 1, 2, 3, 4,
6, 8, 16 and 32 passes of its rows a block, and the run `apply_geometry`
picks.  Each case is checked against its plain version (the largest error
over the largest value) and timed device alone (the fastest of three CUDA
graphs of 20 calls).  Prints one JSON object per case, `chosen` where it is
what `split_geometry` or `apply_geometry` picks, so that the rule can be
read against the alternatives.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from unet_tpu_torch.ops.kernels import groupnorm as gn
from unet_tpu_torch.utils.benchmark import device_line, graph_ms

SHAPES = [(32, 32, 64, 64), (32, 16, 32, 128), (32, 8, 16, 192),
          (32, 4, 8, 256)]
GROUPS = 32


def cases(shape, dtype, kernel, pick):
    """(cluster, rows a block, tile rows) of every cut `kernel` could take,
    the `split_geometry` one `pick` among them."""
    rows = shape[1] * shape[2]
    row_bytes = (2 if kernel == "sums" else 1) * shape[3] * dtype.itemsize
    for cluster in (1, 2, 4, 8, 16):
        per = -(-rows // cluster)
        if (cluster - 1) * per >= rows:
            continue
        tiles = {per, -(-per // 4)} | {max(1, min(per, kb * 1024 // row_bytes))
                                       for kb in (8, 16, 32)}
        if cluster == pick.cluster:
            tiles.add(pick.tile_rows)
        for tile in sorted(tiles):
            yield cluster, per, tile


def apply_cases(shape, dtype):
    """The runs of rows a gn_apply block could take: 1 to 32 passes of its
    threads' rows, and the one `apply_geometry` picks."""
    pick = gn.apply_geometry(*shape, dtype)
    passes = -(-shape[1] * shape[2] // pick.slots)
    runs = {min(k, passes) * pick.slots for k in (1, 2, 3, 4, 6, 8, 16, 32)}
    return pick, sorted(runs | {pick.rows_per_block})


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every line to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gn_sweep needs a CUDA device")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    lines = [json.dumps({"device": device_line()})]
    print(lines[-1], flush=True)
    for shape in SHAPES:
        B, H, W, C = shape
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            dy = torch.randn(shape, generator=gen, device=dev).to(dtype)
            g = torch.ones(C, device=dev, dtype=dtype)
            b = torch.zeros(C, device=dev, dtype=dtype)
            _, mean, rstd = gn.gn_act_fwd(x, g, b, GROUPS, 1e-5, "silu")
            want = {"stats": gn.gn_stats_plain(x, GROUPS),
                    "sums": gn.gn_bwd_sums_plain(x, g, b, mean, rstd, dy,
                                                 GROUPS, "silu")}
            bf16 = int(dtype == torch.bfloat16)
            for kernel in ("stats", "sums"):
                pick = gn.split_geometry(kernel, *shape, GROUPS, dtype)
                out = torch.empty_like(want[kernel])
                if kernel == "stats":
                    launch = gn._launcher("unet_gn_stats")
                    head = [x.data_ptr(), out.data_ptr(), B, H * W, C, GROUPS,
                            bf16]
                else:
                    launch = gn._launcher("unet_gn_bwd_sums")
                    head = [t.data_ptr() for t in (x, g, b, mean, rstd, dy,
                                                    out)]
                    head += [B, H * W, C, GROUPS, 1, bf16]
                for geo in cases(shape, dtype, kernel, pick):
                    def fn():
                        return launch(*head, *geo,
                                      torch.cuda.current_stream().cuda_stream)
                    if fn() != 0:  # more shared memory than a block has
                        continue
                    err = ((out - want[kernel]).abs().max()
                           / want[kernel].abs().max()).item()
                    lines.append(json.dumps(dict(
                        kernel=kernel, shape=list(shape), dtype=str(dtype),
                        cluster=geo[0], rows_per_block=geo[1],
                        tile_rows=geo[2],
                        chosen=geo == (pick.cluster, pick.rows_per_block,
                                       pick.tile_rows),
                        ms=min(graph_ms(fn) for _ in range(3)),
                        err_of_largest=err)))
                    print(lines[-1], flush=True)
            stats = torch.stack([gn.gn_stats_plain(x, GROUPS),
                                 gn.gn_stats_plain(x.flip(1), GROUPS)])
            want = gn.gn_apply_plain(x, g, b, stats, GROUPS, 1e-5, "silu")[0]
            y = torch.empty_like(x)
            m, r = (torch.empty((B, GROUPS), device=dev) for _ in range(2))
            head = [t.data_ptr() for t in (x, g, b, stats, y, m, r)]
            head += [2, B, H * W, C, GROUPS, 1e-5, 1, bf16]
            launch = gn._launcher("unet_gn_apply")
            pick, runs = apply_cases(shape, dtype)
            for run in runs:
                def fn():
                    return launch(*head, run,
                                  torch.cuda.current_stream().cuda_stream)
                if fn() != 0:
                    raise RuntimeError(f"gn_apply {shape} {dtype}: rows a "
                                       f"block {run} refused")
                err = ((y.float() - want.float()).abs().max()
                       / want.float().abs().max()).item()
                lines.append(json.dumps(dict(
                    kernel="apply", shape=list(shape), dtype=str(dtype),
                    rows_per_block=run, blocks=-(-H * W // run) * pick.cols * B,
                    chosen=run == pick.rows_per_block,
                    ms=min(graph_ms(fn) for _ in range(3)),
                    err_of_largest=err)))
                print(lines[-1], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
