"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

It needs a GPU, `nvcc`, and the `unet_tpu_torch` package beside it; without
any of them it exits non-zero and prints no result.  What it does, one JSON
object per line:

  1. `device`: the card, its power limit, the torch/CUDA/nvcc versions, and
     the seconds the kernels took to build from unet_tpu_torch/csrc/, with
     ptxas's registers of each kernel instantiation and the most bytes any
     kernel spills (a spill, a build log that names no kernel, or one that
     lacks an attention kernel at a tile width of `HEAD_SIZES`, a chunked
     attention kernel or a tensor-core convolution, fails the run).
  2. `kernel_checks`: each hand-written kernel (GroupNorm and attention,
     forward and backward) against its plain PyTorch version on the card,
     float32 and bfloat16, at the shapes the U-Net gives it in sampling and
     in training (attention also at head sizes 16 and 64, and both at the
     shapes of a block split over two model ranks), with the kernel's, the plain version's and a library
     call's time and the least time the card could take; then attention
     forward and backward at head sizes from 7 to 4160 (`ATTN_HEAD_SHAPES`,
     untimed but for those of `ATTN_HEAD_TIMED`), each with its
     layout (tile width, chunks, or cluster and groups) and `work_ratio`;
     each timed attention case names the backend the library call
     (`scaled_dot_product_attention`) ran.  Each is timed
     twice after warm-up: as it is called (CUDA events around a loop of
     calls) and on the device alone (the same calls replayed from a CUDA
     graph).  Every repetition reads the same input, so the cache is warm.
     Each GroupNorm and attention kernel runs twice at every case and must
     give the same bits again; a GroupNorm case records its cluster size
     and whether its blocks staged their rows in shared memory, an
     attention case its route (bf16 `mma.sync`, `wgmma` in the chunked
     kernels, or float32 as three TF32 products).
  3. `forward`: one U-Net forward at each batch the requests below give the
     model (4, 8 and the doubled 16 of classifier-free guidance), the module
     on the kernels against the same module on the plain versions, and the
     time of the B=8 forward either way.
  4. `path`: a checkpoint of the default ImageNet-64 model (full width and
     depth, random weights from a seed) written with the port's own saver,
     then sampled through `cli.generate.run` (DDIM in bfloat16 and float32,
     class-conditional DDIM with classifier-free guidance) and through
     `make_sampler` (the DDPM chain), with the kernels' launch counts held
     against model calls x launches per forward.  On the card each chain is
     the replays of one captured sampler step (`utils/graphs.py`); each
     request runs again with every step eager (`eager_steps`), its seconds
     and images/s beside the captured ones (`eager_*`), its counts held
     the same way; `captured_against_eager`: a DDIM-50 float32 chain from
     one start, captured against eager, within the forward's 2e-3 (and
     whether the bits are equal).  A short untimed request of each kind goes
     first, and each kernel is held against its plain version at every
     distinct shape those requests hand it (at warm-up and capture).
  5. `train_step`: one float32 training step of the default model at B=32,
     its loss and every gradient on the kernels against the same step on the
     plain versions; then ten `step_with` steps on one fixed batch, whose
     loss must fall.
  6. `graphs`: the captured train step (`trainer.make_multi_step`) at
     B=32.  `f32_step`: one float32 step captured against the same step run
     eagerly, loss within 1e-5 relative and parameters and moments within
     1e-3, beside how far a second eager run falls from the first;
     `flat_against_tree_f32`: `make_flat_multi_step` against
     `make_multi_step` for three float32 steps, losses within 1e-5 and
     parameters within 1e-3; `captured_steps`: for each configuration of
     the `train` phase, the device time of one replay of its step (the
     device time per step that the `train` phase's idle shares use), the
     launches the graph holds, and for bfloat16 the ten losses of a
     captured chunk against ten eager steps, one replay profiled with
     `torch.profiler` (its GroupNorm and attention kernels must be the
     launches the graph holds); `flat_against_tree_replay_ms`: the device
     time of a flat and a tree step, float32 and bfloat16.
  7. `train`: the training CLI (`cli.train.main`) on a `.bin` of seeded
     images written by the port's `write_bin`, the default model at full
     width and depth, B=32: bfloat16 for 20 steps with a checkpoint at step
     20 and a resume from it to step 40; float32 for 10 steps; bfloat16 with
     remat and microbatches of 16 for 4 steps; all on the chunked path
     (captured, uint8 input: the log must say so); then the same bfloat16,
     float32 and remat runs on the per-step path (`*steps`: the same log
     interval, a `--save_interval` that is no multiple of it).  Finite losses, the log lines, the checkpoints' steps and
     the kernels' launch counts per step are asserted; ms/step, images/s,
     peak memory (allocated and reserved), the device's ms per step and the
     idle share (1 - device ms / ms per step) reported for each;
     `bf16_chunked_against_per_step`: the two bfloat16 runs' logged mean
     losses.
     A two-step untimed chunk of each kind goes first, and each kernel is
     held against its plain version at every distinct shape those steps
     hand it.
  8. `head_size`: the training and sampling CLIs at the default model with
     128 channels a head (one head of 192, two of 128: the chunked
     kernels): both refuse head size 48 (five heads of a width of 256) on
     the card before they build a model, and both take 288 at
     --num_channels 96 (heads of 288 and 384: the cluster kernels; one
     bfloat16 step at B=32, a DDIM-2 request from a small checkpoint); 3
     bfloat16 steps at B=32 with a checkpoint, then a DDIM-10 request at
     B=4 from it, and one float32 step against the plain versions (the
     `train_step` bars), with exact launch counts, finite losses and
     images, and every kernel input of the runs held against its plain
     version.
  8b. `wide_head`: DDPM's 256x256 model (Ho et al. 2020: C=128, mult
     1,1,2,2,4,4, two res blocks, single-head attention at 16x16; here one
     head of 512, the cluster kernels) at full width and depth: 3 bfloat16
     steps of `cli.train.main` at the paper's B=64 on 128 seeded images
     with a checkpoint, a DDIM-10 request at B=2 through
     `cli.generate.run` from it, one float32 step at B=8 against the plain
     versions (the `train_step` bars); 6 K1 launches a forward and 6 K2 a
     step, every count exact, finite losses and images, every kernel input
     held against its plain version; ms/step, peak MiB and the parameter
     count, each also on a line of its own, and the cluster kernels'
     device ms a step (each kernel's device-alone time at (64,256,512,1)
     and (64,64,512,1) times its launches there) beside the step's ms.
  8c. `ddpm_cifar`: DDPM's CIFAR-10 model (Ho et al. 2020: C=128, mult
     1,2,2,2, two res blocks, single-head attention at 16x16: one head of
     256, the chunked kernels in four chunks) at full width and depth, as
     `wide_head`: 3 bfloat16 steps of `cli.train.main` at the paper's
     B=128 on 256 seeded 32x32 images with a checkpoint, a DDIM-10 request
     at B=16 from it, one float32 step at B=32 against the plain versions;
     6 K1 a forward and 6 K2 a step, counts exact, every kernel input held
     against its plain version; ms/step, images/s, peak MiB, DDIM-10
     seconds, and the chunked kernels' device ms a step (each kernel's
     device-alone time at (128,256,256,1) and (128,16,256,1) times its
     launches there) beside the step's ms.
  9. `s2d`: space-to-depth level 0 (`UNET_TPU_TORCH_S2D=on`,
     `models.unet.set_s2d_mode`, `unet_tpu_torch/ops/s2d.py`) at the
     default model, full width and depth, against pixel space on the
     kernels: a B=8 forward in float32 (within 2e-3) and bfloat16 (within
     1.5x the bfloat16 pixel forward's distance from the float32 one),
     each mode's device time alone; a float32 step's loss and gradients
     at B=32 (the `train_step` bars) and one `step_with` either way; the
     captured bfloat16 + EMA step at B=32 in either mode, its device time
     a replay, and the device time of one level-0 GroupNorm and 3x3
     convolution in either space (`level0_ops`); `cli.train.main` 20
     chunked bfloat16 steps (ms/step, images/s, idle share, peak MiB
     beside the `train` phase's); a DDIM-10 float32 request at B=8 through
     `cli.generate.run` in either mode, twice each, from one checkpoint
     and seed (the float images within 2e-3).  Launches are held to the
     plan's counts (56 GroupNorm and 11 attention launches a forward, as
     many backward a step, as in pixel space: level 0's GroupNorms run K4
     and K5 on a free view), and every kernel input of the s2d runs
     against its plain version.
 10. `input_pipeline`: `unet_tpu_torch.scripts.profile_input_pipeline`
     at its defaults (bfloat16 + EMA, B=32, 100 steps a chunk), 4 chunks
     over a `.bin` of 1024 seeded images: the chunked path's host phases
     a step (dispatch, assemble, stage, drain, total) and the dispatch
     split (a step's host time on an idle device, a call's, the graph
     launch, the draws, the rest, and what a busy device's dispatch takes
     beyond the idle one's, an inferred remainder); every step's launches
     held exactly.
 11. `cli`: the rest of the one-card training CLI at the default model,
     full width and depth, B=32.  The data path: bfloat16 with the EMA,
     50 chunked steps at a log interval of 10, with `--native_loader` true
     and false, each sequential and with `--randomize`; for each, over
     the intervals past the capture that stage a chunk (the 2nd to the
     4th): ms/step, the idle share, the host's ms to assemble and stage a
     chunk (`chunk_host_ms` of the CSV log) and its ms in the call that
     queues a chunk's steps; the first staged chunks of the two loaders
     must be byte-equal.  `--host_rng`: 4 float32 per-step
     steps saved at 2, and a resume from 2 to 4: the same 625-word blob
     (also that of four steps' draws from the seed) and losses within
     1e-5.  The SIGTERM save: `python -m unet_tpu_torch.cli.train` in a
     child process, chunked, gets SIGTERM after its first log line and must
     exit 0, log "caught signal 15 at step N" and leave only
     `model_N.bin`; `--auto_resume` must then resume from it to step N+10.
     Class-conditional training: 3 bfloat16 steps of `make_train_step`
     with 10 classes and label dropout 0.1 on seeded labels, then a CFG
     DDIM-10 request from its checkpoint (the image-directory decode needs
     Pillow, which the card's machine lacks: the CPU tests run it).  A
     `.pt` state_dict of the default model served by `cli.generate.run`
     (DDIM-10, B=4) must give the images of the `.bin` of the same weights.
     Launch counts are held exactly for the runs in this process.
 12. `parallel`: the data-parallel tier (`unet_tpu_torch/parallel/`) over a
     process group of one rank (NCCL; the machine has one card), the
     default model at B=32 a rank: the captured DP and FSDP steps against
     the one-device flat step, the same bits after 3 bfloat16 and 2
     float32 steps (cuDNN held to its deterministic algorithms on both
     sides); a DDIM-10 B=8 request through `make_parallel_sampler`, the
     one-device chain's bits; `cli.train --num_devices 0` as the one rank
     of a `--coordinator_address` group, 20 chunked bfloat16 steps with the
     EMA and rank 0's checkpoint, beside the one-device run: ms/step, idle
     share, losses.  Launch counts held exactly.
 13. `tensor_parallel`: Megatron TP and the 2-D tp x fsdp split
     (`unet_tpu_torch/parallel/tensor.py`, `parallel/mesh.py`), the default
     model at the global batch 32: at model axis 1 (one NCCL rank) the
     captured TP and tp x fsdp steps against the one-device flat step, the
     same bits after 3 bfloat16 and 2 float32 steps (cuDNN deterministic),
     with each replay's device time; at model axis 2 two processes of this
     script (`--tensor_parallel_rank`) over gloo on the one card (NCCL
     refuses two ranks on a card), 3 bfloat16 and 2 float32 eager TP steps
     against the same one-device steps (losses and parameters within the
     tolerances stated at `TP_LR`), the leaves each rank keeps whole
     bit-equal on both, and every kernel input of the split model (such as
     GroupNorm at (32,64,64,32) in 16 groups and attention at
     (32,256,288) with 3 heads) held against its plain version.  Then the
     same for one float32 entry (2 steps) with level 0 in patch space
     (`set_s2d_mode("on")` around it alone): at axis 1 TP and tp x fsdp
     bit-equal to the one-device flat s2d step, each replay's device
     time; at axis 2 the gradient and steps against the one-device s2d
     ones, the split gn2 on the free view of its patch rows.  Launch
     counts held exactly per rank, as many in patch space.
 14. `spatial_parallel`: spatial sharding (`unet_tpu_torch/parallel/
     spatial.py`, the model axis's other use), the default model at the
     global batch 32.  The split GroupNorm's four kernels (`gn_stats`,
     `gn_apply`, `gn_bwd_sums`, `gn_bwd_dx`) against their plain versions
     at the half-height inputs of the model's GroupNorms over two ranks,
     f32 and bf16, again for the same bits, and the two virtual ranks'
     pipeline against K4 and K5 on the whole tensor; timed beside a
     library call and their bound; the cut of each (the two reductions'
     clusters, gn_apply's blocks a sample and vectors a thread) recorded.
     At model axis 1 (one NCCL rank, DP
     itself) the captured spatial step against the one-device flat step of
     the `tensor_parallel` phase, the same bits after 3 bf16 and 2 f32
     steps; at model axis 2 two processes of this script
     (`--spatial_parallel_rank`) over gloo on the card, the gradient at the
     initial parameters leaf by leaf and 3 bf16 and 2 f32 eager steps
     against one device's, every vector bit-equal on both ranks, and every
     kernel input (the split GroupNorm at half height, K1 and K2 on the
     gathered rows) held against its plain version.  Then one float32
     entry in patch space, as in `tensor_parallel`: at axis 1 bit-equal to
     the one-device flat s2d step, its replay's device time; at axis 2
     the gradient and steps against the one-device s2d ones (a halo of one
     patch row, the split GroupNorm on the free view of the rank's patch
     rows).  Launch counts held exactly per rank (no whole K4 or K5 in a
     split step, in either space).
 15. `conv_checks` and `conv`: the kernel-benchmark path.  The
     implicit-GEMM 3x3 convolution (the port of the JAX package's experiment
     scripts/conv_proto.py; where C and O are multiples of 8 on the tensor
     cores, bfloat16 with `wgmma` and float32 in 3xTF32, else float32
     FMAs, each case naming its route) is held
     against its plain version at the six shapes of that script's bench and
     at ragged ones, float32 and bfloat16, and a rerun must give the same
     bits (timed at the headline shape only); then `unet_tpu_torch.scripts.conv_proto --bench`,
     `bench_ops` and `block_timing` (forward and backward, `UnetConfig()`
     full width and depth, B=32) run in this process, with the convolution
     kernel's launches counted exactly and every other kernel's at least
     once, and each GroupNorm and attention kernel is held against its
     plain version at every shape those scripts handed it.
 16. `{"kernels": [...]}`: one summary entry per kernel, its launches those
     of the sampling requests and the training runs together (the
     convolution's: those of the `conv` phase; the split GroupNorm's:
     those of the `spatial_parallel` phase's two ranks; GroupNorm's and
     attention's also those of the `s2d` and `input_pipeline` phases and
     the later one-card phases); then the seconds
     the whole run took, the card's name and power limit, and the result
     line.

float32 runs in "highest" precision (TF32 off for matmuls and cuDNN).
A failed build, launch or comparison raises, so the exit code is non-zero.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() "
             "is false")

import torch.nn.functional as TF  # noqa: E402  (yardstick timings only)

from unet_tpu_torch.cli import generate  # noqa: E402
from unet_tpu_torch.cli import train as train_cli  # noqa: E402
from unet_tpu_torch.config import TrainConfig, UnetConfig  # noqa: E402
from unet_tpu_torch.data.dataset import write_bin  # noqa: E402
from unet_tpu_torch.diffusion.gaussian import (  # noqa: E402
    GaussianDiffusion, named_beta_schedule)
from unet_tpu_torch.diffusion.sampler import (  # noqa: E402
    ddim_sample, make_parallel_sampler, make_sampler, to_uint8)
from unet_tpu_torch.io import checkpoint as ckpt_io  # noqa: E402
from unet_tpu_torch.models import unet  # noqa: E402
from unet_tpu_torch.ops import functional  # noqa: E402
from unet_tpu_torch.ops import s2d as s2d_ops  # noqa: E402
from unet_tpu_torch.ops.kernels import _build  # noqa: E402
from unet_tpu_torch.ops.kernels import attention as attn_mod  # noqa: E402
from unet_tpu_torch.ops.kernels import conv3x3 as conv_mod  # noqa: E402
from unet_tpu_torch.ops.kernels import groupnorm as gn_mod  # noqa: E402
from unet_tpu_torch.ops.kernels.attention import (  # noqa: E402
    qkv_attention_bwd, qkv_attention_bwd_plain, qkv_attention_fwd,
    qkv_attention_plain)
from unet_tpu_torch.ops.kernels.conv3x3 import (  # noqa: E402
    conv3x3_hwbc, conv3x3_hwbc_plain)
from unet_tpu_torch.ops.kernels.groupnorm import (  # noqa: E402
    gn_act_bwd, gn_act_bwd_plain, gn_act_fwd, gn_act_fwd_plain, gn_apply,
    gn_apply_plain, gn_bwd_dx, gn_bwd_dx_plain, gn_bwd_sums,
    gn_bwd_sums_plain, gn_stats, gn_stats_plain)
from unet_tpu_torch.parallel import distributed  # noqa: E402
from unet_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from unet_tpu_torch.parallel import tensor  # noqa: E402
from unet_tpu_torch.scripts import bench_ops, block_timing  # noqa: E402
from unet_tpu_torch.scripts import conv_proto  # noqa: E402
from unet_tpu_torch.scripts import profile_input_pipeline  # noqa: E402
from unet_tpu_torch.training import trainer  # noqa: E402
from unet_tpu_torch.utils import graphs  # noqa: E402
from unet_tpu_torch.utils.native import TorchRng  # noqa: E402
from unet_tpu_torch.utils.benchmark import (  # noqa: E402
    bound, device_line, graph_ms)

DEV = torch.device("cuda", 0)
# Tolerances, kernel against plain version on the same inputs.  float32: the
# two differ in summation order only.  bfloat16: both round a float32 result
# once, so where the float32 values fall on either side of a rounding point
# they differ by one bfloat16 step, which is at most 2^-7 of the value; the
# absolute part allows for the float32 values' own difference.  GroupNorm's
# is of float32 size.  Attention rounds each softmax weight to bfloat16
# (steps of 2^-8 relative) before the value product, the kernel within its
# running softmax and the plain version after the whole one, which leaves
# noise of about 2^-8 of the output's root mean square in each: six times
# that covers the tail over a million outputs and is about 2% of a typical
# output.
F32_TOL = dict(atol=2e-5, rtol=0.0)
GN_TOL = {torch.float32: F32_TOL,
          torch.bfloat16: dict(atol=1e-4, rtol=2.0 ** -7)}


def attention_tol(want):
    if want.dtype == torch.float32:
        return F32_TOL
    rms = want.float().square().mean().sqrt().item()
    return dict(atol=6 * 2.0 ** -8 * rms, rtol=2.0 ** -7)


STAT_TOL = dict(atol=1e-5, rtol=1e-5)  # mean, rstd: float32 in both
FORWARD_ATOL = 2e-3  # whole U-Net, float32: the repo's bar for the model


def partial_tol(want):
    """GroupNorm backward's dgamma_b, dbeta_b: float32 sums over the H*W
    rows of a batch element, added in another order by the kernel, so their
    difference grows like sqrt(H*W) float32 roundings of the largest term:
    at H*W = 4096 that is 64 * 2^-24 = 3.8e-6 of the largest value."""
    return dict(atol=4e-6 * want.abs().max().item(), rtol=0.0)


def attention_bwd_tol(want):
    """Attention backward: float32 as the forward.  bfloat16: one bfloat16
    step where both round the same float32 value on either side of a
    rounding point (2^-7 relative), plus the products of ds and p that one
    side rounds to bfloat16 a step away from the other (ds is rounded
    before the dq and dk products, p before the dv product, and the two
    compute them in another order): 8 x 2^-8 of the output's root mean
    square."""
    if want.dtype == torch.float32:
        return F32_TOL
    rms = want.float().square().mean().sqrt().item()
    return dict(atol=8 * 2.0 ** -8 * rms, rtol=2.0 ** -7)


TRAIN_LOSS_RTOL = 1e-5  # one float32 step, kernels against plain versions
TRAIN_GRAD_ATOL = 1e-3  # every gradient: the repo's bar for the model

# B=4 and B=16 cut the rows into other clusters than B=8 (at 64x64: 16
# blocks of 256 rows at B=4 and 8, 8 of 512 at B=16); (8,8,8,256) is the
# smallest input of the model; (2,128,128,256) is too large to stage in
# shared memory, so its blocks stream their rows through it on every pass;
# (2,8,8,4160) has more 16-byte vectors a row than a block has threads, so
# a thread takes two (bfloat16) or three (float32, the last step short).
GN_SHAPES = [(8, 64, 64, 64), (8, 32, 32, 320), (8, 16, 16, 448),
             (8, 8, 8, 512), (4, 64, 64, 64), (16, 64, 64, 64),
             (4, 8, 8, 512), (16, 32, 32, 320), (8, 8, 8, 256),
             (2, 128, 128, 256), (2, 8, 8, 4160)]
# A ResBlock split over two model ranks (tensor parallelism) hands GroupNorm
# its C_out/2 channels in 16 groups: the first ResBlock's of the trainer,
# forward and backward, timed beside the whole model's (32 groups at the
# shapes above).
TP_GN_CASES = [((32, 64, 64, 32), 16)]
# Batches the requests give the model: DDPM at 4, DDIM at 8, guidance at 2 x 8.
PATH_BATCHES = (4, 8, 16)
# (B, T, C, NH): head size 32 (the default model's), then 16 and 64 (64 is
# the published ADM ImageNet-64 setting, `--num_head_channels 64`) at the
# model's attention widths and a ragged T.
ATTN_SHAPES = [(8, 256, 192, 6), (8, 64, 256, 8), (4, 1024, 192, 6),
               (2, 576, 64, 2), (2, 100, 64, 2), (8, 256, 192, 12),
               (8, 256, 192, 3), (8, 64, 256, 4), (2, 100, 64, 4),
               (32, 256, 96, 3)]
# The backward kernels at the trainer's batch (32, and 16 with microbatches):
# the first and the widest concatenated GroupNorm inputs of each level, and
# both attention resolutions; two small ragged shapes besides.  In float32,
# (32,64,64,192) (the widest input at 64x64) does not fit in a cluster's
# shared memory and streams its rows through it on both passes.
# (32,8,8,2048) is the widest input of the trainer at --num_channels 256
# (512 threads a block in float32); (2,8,8,2080) has more 16-byte vectors
# a row than a block has threads, so a thread takes two.
TRAIN_BATCH = 32
GN_BWD_SHAPES = [(32, 64, 64, 64), (32, 64, 64, 128), (32, 32, 32, 320),
                 (32, 16, 16, 448), (32, 8, 8, 1024), (16, 64, 64, 64),
                 (3, 5, 7, 96), (32, 64, 64, 192), (32, 8, 8, 2048),
                 (2, 8, 8, 2080)]
# (32,256,96,3) is the ds-4 attention split over two model ranks (half its
# heads), forward and backward.
ATTN_BWD_SHAPES = [(32, 256, 192, 6), (32, 64, 256, 8), (16, 256, 192, 6),
                   (2, 100, 64, 2), (32, 256, 192, 12), (32, 256, 192, 3),
                   (32, 64, 256, 4), (32, 256, 96, 3)]
# Head sizes beyond the default model's 32 (B, T, C, NH), each untimed
# but for `ATTN_HEAD_TIMED`: the default model at `--num_head_channels 128`
# (one head of 192 at ds 4, two of 128 at ds 8: the `head_size` phase's
# model); Improved DDPM's ImageNet-64 widths at 128 (heads of 128); heads
# of 72 (`--num_channels 96 --num_head_channels 64`, width 288); Stable
# Diffusion 1.x's 40, 80 and 160; DDPM's CIFAR-10 head of 256 (at B=8, and
# at the `ddpm_cifar` phase's B=128 at T = 256 and 16); then 48, 12, 8 and
# 7 at a ragged T (bfloat16 copies in pieces of 16, 8, 16 and 2 bytes).
# Then the cluster kernels (heads wider than 256): DDPM's 256 x 256
# models' one head of 512 at 16 x 16 and in the middle block at 8 x 8, at
# B=8 and at the `wide_head` phase's B=64 (one, two and four chunks a
# block, `kernel_layout`'s grid-size rule); 288 and 384 (`--num_channels 96
# --num_head_channels 288`), and 288 at B=32 (three chunks a block in
# bfloat16); 2048 (a full cluster of 8); 4160 (65 chunks: nine groups of
# clusters, each block's own rows streamed through the ring); 257 and 514
# at a ragged T (bfloat16 copies in pieces of 2 and 4 bytes; 514 in two
# groups).  The backward also at the trainer's batch at the first two.
ATTN_HEAD_SHAPES = [(8, 256, 192, 1), (8, 64, 256, 2), (8, 256, 384, 3),
                    (8, 64, 512, 4), (4, 256, 288, 4), (4, 1024, 320, 8),
                    (4, 256, 640, 8), (2, 64, 1280, 8), (8, 256, 256, 1),
                    (128, 256, 256, 1), (128, 16, 256, 1), (2, 100, 96, 2),
                    (2, 100, 36, 3), (2, 100, 24, 3), (2, 100, 21, 3),
                    (8, 256, 512, 1), (8, 64, 512, 1), (4, 256, 288, 1),
                    (4, 256, 1152, 3), (2, 64, 2048, 1), (1, 64, 4160, 1),
                    (2, 100, 771, 3), (2, 100, 1542, 3), (64, 256, 512, 1),
                    (64, 64, 512, 1), (32, 256, 288, 1)]
ATTN_HEAD_BWD_SHAPES = [(32, 256, 192, 1), (32, 64, 256, 2)]
ATTN_HEAD_TIMED = {"fwd": [(8, 256, 192, 1), (8, 64, 256, 2),
                           (128, 256, 256, 1), (8, 256, 512, 1),
                           (8, 64, 512, 1), (64, 256, 512, 1),
                           (64, 64, 512, 1)],
                   "bwd": [(32, 256, 192, 1), (32, 64, 256, 2),
                           (128, 256, 256, 1), (8, 256, 512, 1),
                           (8, 64, 512, 1), (64, 256, 512, 1),
                           (64, 64, 512, 1)]}
# The convolution at the six (H, W, B, C, O) of conv_proto's bench, then
# ragged ones: odd sizes (and O = 40, short of the tensor-core kernel's 64
# columns), a single pixel, and C = 3, which is no multiple of 8 and so
# takes the FMA kernel in both types.  A literal, so that
# utils/ab_trees.py can read it without importing this file.
CONV_SHAPES = [(64, 64, 32, 64, 64), (64, 64, 32, 192, 64),
               (64, 64, 32, 128, 64), (64, 64, 32, 64, 128),
               (64, 64, 32, 128, 128), (32, 32, 32, 320, 128),
               (7, 5, 3, 24, 40), (1, 1, 1, 8, 8), (64, 64, 32, 3, 64)]
# The convolution against its plain version: one rounding of a float32 sum
# in each, as GroupNorm.
CONV_TOL = GN_TOL
# The case the `kernels` line reports: conv_proto's and bench_ops's headline
# (check_conv also times the float32 case at its shape).
CONV_HEADLINE = dict(shape=[64, 64, 32, 192, 64], dtype="torch.bfloat16")
# The head size of the second training and sampling run (`drive_head_size`:
# one head of 192 and two of 128 at the default model's widths); the
# (--num_head_channels, --num_channels) both CLIs must refuse on the card
# before they build a model, each with the (channels, mult) of a small
# checkpoint of the same attention width for `generate`: 48 at widths 192
# and 256 (256 // 48 = 5 heads do not split 256, which the JAX package
# cannot run either); and the same for a head both take, 288 at widths 288
# and 384 (heads of 288 and 384, the cluster kernels).
OTHER_HEAD_SIZE = 128
REFUSED_HEADS = [(48, 64, 64, (1, 4))]
ACCEPTED_HEAD = (288, 96, 96, (1, 3))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timings(kernel, plain, library, library_stream=None) -> dict:
    """Each of the three as it is called (`*_ms`: CUDA events around a loop
    of calls, the larger of the host's and the device's time per call) and
    on the device alone (`*_graph_ms`); a library of None is reported as
    None.  A library backward runs through
    autograd, which puts each backward kernel on the stream its forward ran
    on: `library_stream` is that stream, and the library is timed and
    captured there."""
    out = {}
    for name, fn in (("kernel", kernel), ("plain", plain),
                     ("library", library)):
        if fn is None:  # no one library call computes it
            out[f"{name}_ms"] = out[f"{name}_graph_ms"] = None
            continue
        stream = library_stream if name == "library" else None
        with torch.cuda.stream(stream):
            out[f"{name}_ms"] = time_ms(fn)
            out[f"{name}_graph_ms"] = graph_ms(fn, stream=stream)
    return out


def sdpa_backend(fn) -> dict:
    """Which of `scaled_dot_product_attention`'s backends the call `fn`
    makes ran, read from the names of the kernels it launched
    (`torch.profiler`): "flash", "cudnn", "efficient" (memory-efficient),
    or "math" (no fused attention kernel: matmuls and a softmax)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    text = " ".join(names).lower()
    backend = ("flash" if "flash" in text else "cudnn" if "cudnn" in text
               else "efficient" if "fmha" in text or "efficient" in text
               else "math")
    return dict(library_backend=backend, library_kernels=names[:6])


def side_stream():
    """A new stream that starts after the work queued so far."""
    stream = torch.cuda.Stream(device=DEV)
    stream.wait_stream(torch.cuda.current_stream())
    return stream


def compare(got, want, tol, what) -> float:
    """Max abs error; raises when outside atol + rtol * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all()):
        raise AssertionError(
            f"{what}: max abs error {err.max().item():.3e} outside "
            f"atol {tol['atol']} rtol {tol['rtol']}")
    return err.max().item()


def same_bits(got, again, what) -> None:
    """Raises unless two results (tuples of tensors) are equal bit for bit."""
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: a rerun gave other bits")


def gn_geometry(shape, dtype, backward, groups=32) -> dict:
    """The cluster size the wrapper chooses for a GroupNorm case, and
    whether the rows stay in shared memory (staged) or stream through it."""
    geo = gn_mod.geometry(*shape, groups, dtype, backward)
    return dict(cluster=geo.cluster, staged=geo.staged,
                streamed=geo.streamed)


def check_groupnorm(gen):
    cases = []
    for shape, G in [(s, 32) for s in GN_SHAPES] + TP_GN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for act in ("silu", "none"):
                B, H, W, C = shape
                x, gamma, beta = gn_inputs(shape, dtype, gen)
                y, mean, rstd = gn_act_fwd(x, gamma, beta, G, 1e-5, act)
                again = gn_act_fwd(x, gamma, beta, G, 1e-5, act)
                torch.cuda.synchronize()
                what = f"gn_act_fwd {shape} G={G} {dtype} act={act}"
                same_bits((y, mean, rstd), again, what)
                yp, meanp, rstdp = gn_act_fwd_plain(x, gamma, beta, G, 1e-5,
                                                    act)
                err = compare(y, yp, GN_TOL[dtype], what)
                err_mean = compare(mean, meanp, STAT_TOL, what + " mean")
                err_rstd = compare(rstd, rstdp, STAT_TOL, what + " rstd")

                def library():
                    z = TF.group_norm(x.permute(0, 3, 1, 2), G, gamma, beta,
                                      1e-5)
                    return TF.silu(z) if act == "silu" else z

                item = x.element_size()
                nbytes = 2 * x.numel() * item + 2 * C * item + 2 * B * G * 4
                # subtract, scale, affine, and the SiLU's exp, add, divide
                flops = x.numel() * (8 if act == "silu" else 4)
                bound_ms, bound_by = bound(nbytes, flops, torch.float32)
                cases.append(dict(
                    shape=list(shape), groups=G, dtype=str(dtype), act=act,
                    **gn_geometry(shape, dtype, False, G),
                    max_abs_err=err, mean_max_abs_err=err_mean,
                    rstd_max_abs_err=err_rstd, tol=GN_TOL[dtype],
                    **timings(
                        lambda: gn_act_fwd(x, gamma, beta, G, 1e-5, act),
                        lambda: gn_act_fwd_plain(x, gamma, beta, G, 1e-5,
                                                 act),
                        library),
                    bound_ms=bound_ms, bound_by=bound_by))
    return cases


def attention_fwd_case(B, T, C, NH, dtype, gen, timed=True):
    """The forward kernel against its plain version at one shape and type,
    twice for equal bits; with `timed` beside the library and the bound."""
    qkv = torch.randn((B, T, 3 * C), generator=gen, device=DEV).to(dtype)
    out = qkv_attention_fwd(qkv, NH)
    again = qkv_attention_fwd(qkv, NH)
    torch.cuda.synchronize()
    what = f"qkv_attention_fwd {(B, T, C, NH)} {dtype}"
    if not torch.equal(out, again):
        raise AssertionError(f"{what}: a rerun gave other bits")
    want = qkv_attention_plain(qkv, NH)
    tol = attention_tol(want)
    err = compare(out, want, tol, what)
    # what the tolerance's absolute part has to cover
    beyond = ((out.float() - want.float()).abs()
              - 2.0 ** -7 * want.float().abs()).max().item()
    rms = want.float().square().mean().sqrt().item()
    HS = C // NH
    tiles = attn_mod.row_tiles(B, T, NH, dtype)
    case = dict(shape=[B, T, C, NH], head_size=HS, dtype=str(dtype),
                route=attn_mod.route(dtype),
                layout=list(attn_mod.kernel_layout(HS, dtype, tiles)),
                work_ratio=attn_mod.work_ratio(HS, dtype, False, tiles),
                max_abs_err=err, tol=tol, err_beyond_one_bf16_step=beyond,
                out_rms=rms)
    if timed:
        q, k, v = (a.transpose(1, 2) for a in
                   qkv.view(B, T, 3, NH, HS).unbind(2))
        item = qkv.element_size()
        bound_ms, bound_by = bound(4 * B * T * C * item,
                                   4 * B * NH * T * T * HS, dtype)
        case.update(**timings(
            lambda: qkv_attention_fwd(qkv, NH),
            lambda: qkv_attention_plain(qkv, NH),
            lambda: TF.scaled_dot_product_attention(q, k, v)),
            bound_ms=bound_ms, bound_by=bound_by,
            **sdpa_backend(lambda: TF.scaled_dot_product_attention(q, k, v)))
    return case


def check_attention(gen):
    """`ATTN_SHAPES` timed, then `ATTN_HEAD_SHAPES`, timed where
    `ATTN_HEAD_TIMED` names them."""
    cases = []
    for shapes, timed in ((ATTN_SHAPES, ATTN_SHAPES),
                          (ATTN_HEAD_SHAPES, ATTN_HEAD_TIMED["fwd"])):
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                cases.append(attention_fwd_case(*shape, dtype, gen,
                                                timed=shape in timed))
    return cases


def gn_inputs(shape, dtype, gen):
    C = shape[-1]
    x = (torch.randn(shape, generator=gen, device=DEV) * 2 + 0.5).to(dtype)
    gamma = (torch.randn(C, generator=gen, device=DEV) * 0.3 + 1).to(dtype)
    beta = (torch.randn(C, generator=gen, device=DEV) * 0.2).to(dtype)
    return x, gamma, beta


def compare_gn_bwd(got, want, dtype, what):
    """Worst error of dx and of the partials against the plain version."""
    err = compare(got[0], want[0], GN_TOL[dtype], what + " dx")
    err_partials = max(compare(g, w, partial_tol(w), what + " partials")
                       for g, w in zip(got[1:], want[1:]))
    return err, err_partials


def check_groupnorm_bwd(gen):
    cases = []
    for shape, G in [(s, 32) for s in GN_BWD_SHAPES] + TP_GN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for act in ("silu", "none"):
                B, H, W, C = shape
                x, gamma, beta = gn_inputs(shape, dtype, gen)
                dy = torch.randn(shape, generator=gen, device=DEV).to(dtype)
                _, mean, rstd = gn_act_fwd(x, gamma, beta, G, 1e-5, act)
                args = (x, gamma, beta, mean, rstd, dy, G, act)
                got = gn_act_bwd(*args)
                again = gn_act_bwd(*args)
                torch.cuda.synchronize()
                what = f"gn_act_bwd {shape} G={G} {dtype} act={act}"
                same_bits(got, again, what)
                want = gn_act_bwd_plain(*args)
                err, err_partials = compare_gn_bwd(got, want, dtype, what)
                partials_of_largest = max(
                    (g - w).abs().max().item() / w.abs().max().item()
                    for g, w in zip(got[1:], want[1:]))

                # The library's GroupNorm(+SiLU) backward on the same values:
                # autograd through F.group_norm and F.silu, graph retained.
                stream = side_stream()
                with torch.cuda.stream(stream):
                    xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
                    gl = gamma.detach().requires_grad_()
                    bl = beta.detach().requires_grad_()
                    yl = TF.group_norm(xl, G, gl, bl, 1e-5)
                    yl = TF.silu(yl) if act == "silu" else yl
                dyl = dy.permute(0, 3, 1, 2)

                def library():
                    return torch.autograd.grad(yl, (xl, gl, bl), dyl,
                                               retain_graph=True)

                item = x.element_size()
                # x and dy read, dx written; gamma, beta, mean, rstd read;
                # the (B, C) partials written
                nbytes = (3 * x.numel() * item + 2 * C * item
                          + 2 * B * G * 4 + 2 * B * C * 4)
                # x-hat, the SiLU's derivative, dz, two sums, dx
                flops = x.numel() * (20 if act == "silu" else 10)
                bound_ms, bound_by = bound(nbytes, flops, torch.float32)
                cases.append(dict(
                    shape=list(shape), groups=G, dtype=str(dtype), act=act,
                    **gn_geometry(shape, dtype, True, G),
                    max_abs_err=err, partials_max_abs_err=err_partials,
                    partials_err_of_largest=partials_of_largest,
                    tol=GN_TOL[dtype],
                    **timings(lambda: gn_act_bwd(*args),
                              lambda: gn_act_bwd_plain(*args), library,
                              stream),
                    bound_ms=bound_ms, bound_by=bound_by))
                del yl
    return cases


def attention_bwd_case(B, T, C, NH, dtype, gen, timed=True):
    """The backward kernels against their plain version at one shape and
    type, twice for equal bits; with `timed` beside autograd through the
    library and the bound."""
    qkv = torch.randn((B, T, 3 * C), generator=gen, device=DEV).to(dtype)
    dout = torch.randn((B, T, C), generator=gen, device=DEV).to(dtype)
    got = qkv_attention_bwd(qkv, dout, NH)
    again = qkv_attention_bwd(qkv, dout, NH)
    torch.cuda.synchronize()
    what = f"qkv_attention_bwd {(B, T, C, NH)} {dtype}"
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: a rerun gave other bits")
    want = qkv_attention_bwd_plain(qkv, dout, NH)
    tol = attention_bwd_tol(want)
    err = compare(got, want, tol, what)
    beyond = ((got.float() - want.float()).abs()
              - 2.0 ** -7 * want.float().abs()).max().item()
    rms = want.float().square().mean().sqrt().item()
    HS = C // NH
    tiles = attn_mod.row_tiles(B, T, NH, dtype)
    case = dict(shape=[B, T, C, NH], head_size=HS, dtype=str(dtype),
                route=attn_mod.route(dtype),
                layout=list(attn_mod.kernel_layout(HS, dtype, tiles)),
                work_ratio=attn_mod.work_ratio(HS, dtype, True, tiles),
                max_abs_err=err, tol=tol, err_beyond_one_bf16_step=beyond,
                out_rms=rms)
    if timed:
        stream = side_stream()
        with torch.cuda.stream(stream):
            ql = qkv.detach().requires_grad_()
            q, k, v = (a.transpose(1, 2) for a in
                       ql.view(B, T, 3, NH, HS).unbind(2))
            out = TF.scaled_dot_product_attention(q, k, v)
        dol = dout.view(B, T, NH, HS).transpose(1, 2)

        def library():
            return torch.autograd.grad(out, ql, dol, retain_graph=True)

        item = qkv.element_size()
        # qkv and dout read, d(qkv) written; five T x T x HS products per
        # head (scores, dp, dq, dk, dv)
        bound_ms, bound_by = bound(7 * B * T * C * item,
                                   10 * B * NH * T * T * HS, dtype)
        case.update(**timings(lambda: qkv_attention_bwd(qkv, dout, NH),
                              lambda: qkv_attention_bwd_plain(qkv, dout, NH),
                              library, stream),
                    bound_ms=bound_ms, bound_by=bound_by)
        with torch.cuda.stream(stream):
            case.update(**sdpa_backend(library))
        del out
    return case


def check_attention_bwd(gen):
    """`ATTN_BWD_SHAPES` timed, then `ATTN_HEAD_SHAPES` and
    `ATTN_HEAD_BWD_SHAPES`, timed where `ATTN_HEAD_TIMED` names them."""
    cases = []
    for shapes, timed in ((ATTN_BWD_SHAPES, ATTN_BWD_SHAPES),
                          (ATTN_HEAD_SHAPES + ATTN_HEAD_BWD_SHAPES,
                           ATTN_HEAD_TIMED["bwd"])):
        for shape in shapes:
            for dtype in (torch.float32, torch.bfloat16):
                cases.append(attention_bwd_case(*shape, dtype, gen,
                                                timed=shape in timed))
    return cases


class swapped:
    """Within the block, the autograd Functions and the functional ops call
    the given functions in place of the kernels' wrappers (for the
    comparisons and the shape records only): `fwd` and `bwd` map
    "gn"/"attn" to a forward and a backward, `sgn_normalize` and `sgn_dx`
    stand for the split GroupNorm's `gn_apply` and `gn_bwd_dx`."""

    NAMES = {("gn", "fwd"): (gn_mod.GroupNormAct, "fwd"),
             ("gn", "bwd"): (gn_mod.GroupNormAct, "bwd"),
             ("attn", "fwd"): (attn_mod.QKVAttention, "fwd"),
             ("attn", "bwd"): (attn_mod.QKVAttention, "bwd"),
             ("sgn", "normalize"): (gn_mod.SplitGroupNormAct, "normalize"),
             ("sgn", "dx"): (gn_mod.SplitGroupNormAct, "dx")}

    def __init__(self, **mine):
        self.mine = mine  # e.g. gn_fwd=..., attn_bwd=...

    def __enter__(self):
        self.saved = {}
        for key, fn in self.mine.items():
            owner, name = self.NAMES[tuple(key.split("_"))]
            self.saved[key] = getattr(owner, name)
            setattr(owner, name, staticmethod(fn))

    def __exit__(self, *exc):
        for key, fn in self.saved.items():
            owner, name = self.NAMES[tuple(key.split("_"))]
            setattr(owner, name, staticmethod(fn))


def plain_versions():
    """The plain versions on the card instead of the kernels."""
    return swapped(gn_fwd=gn_act_fwd_plain, gn_bwd=gn_act_bwd_plain,
                   attn_fwd=qkv_attention_plain,
                   attn_bwd=qkv_attention_bwd_plain)


def recording(seen):
    """Within the block, the kernels' wrappers note the shape of every input
    they are given in `seen`: {"gn_fwd", "gn_bwd", "attn_fwd", "attn_bwd",
    "sgn_fwd", "sgn_bwd"} -> set of signatures (the split GroupNorm's with
    the number of ranks it was split over)."""

    def sgn_fwd(x, gamma, beta, stats, num_groups, eps, act):
        seen["sgn_fwd"].add((tuple(x.shape), num_groups, eps, act,
                             stats.shape[0]))
        return gn_apply(x, gamma, beta, stats, num_groups, eps, act)

    def sgn_bwd(x, gamma, beta, mean, rstd, dy, sums, num_groups, act):
        seen["sgn_bwd"].add((tuple(x.shape), num_groups, 1e-5, act,
                             sums.shape[0]))
        return gn_bwd_dx(x, gamma, beta, mean, rstd, dy, sums, num_groups,
                         act)

    def gn_fwd(x, gamma, beta, num_groups, eps, act):
        seen["gn_fwd"].add((tuple(x.shape), num_groups, eps, act))
        return gn_act_fwd(x, gamma, beta, num_groups, eps, act)

    def gn_bwd(x, gamma, beta, mean, rstd, dy, num_groups, act):
        seen["gn_bwd"].add((tuple(x.shape), num_groups, 1e-5, act))
        return gn_act_bwd(x, gamma, beta, mean, rstd, dy, num_groups, act)

    def attn_fwd(qkv, num_heads):
        seen["attn_fwd"].add((tuple(qkv.shape), num_heads))
        return qkv_attention_fwd(qkv, num_heads)

    def attn_bwd(qkv, dout, num_heads):
        seen["attn_bwd"].add((tuple(qkv.shape), num_heads))
        return qkv_attention_bwd(qkv, dout, num_heads)

    return swapped(gn_fwd=gn_fwd, gn_bwd=gn_bwd, attn_fwd=attn_fwd,
                   attn_bwd=attn_bwd, sgn_normalize=sgn_fwd, sgn_dx=sgn_bwd)


def new_seen():
    return {"gn_fwd": set(), "gn_bwd": set(), "attn_fwd": set(),
            "attn_bwd": set(), "sgn_fwd": set(), "sgn_bwd": set()}


def check_seen_shapes(seen, gen):
    """Kernel against plain version on random tensors of every shape noted,
    float32 and bfloat16; each GroupNorm kernel runs twice and must give the
    same bits (the split GroupNorm's four kernels: `split_gn_case`, over
    the ranks it was split over).  Returns the count of shapes and the
    worst error per type."""
    worst = {"torch.float32": 0.0, "torch.bfloat16": 0.0}

    def note(dtype, err):
        worst[str(dtype)] = max(worst[str(dtype)], err)

    for dtype in (torch.float32, torch.bfloat16):
        for shape, groups, eps, act in sorted(seen["gn_fwd"]):
            a, g, b = gn_inputs(shape, dtype, gen)
            got = gn_act_fwd(a, g, b, groups, eps, act)
            what = f"gn_act_fwd {shape} {dtype} act={act}"
            same_bits(got, gn_act_fwd(a, g, b, groups, eps, act), what)
            want = gn_act_fwd_plain(a, g, b, groups, eps, act)
            note(dtype, compare(got[0], want[0], GN_TOL[dtype], what))
            compare(got[1], want[1], STAT_TOL, what + " mean")
            compare(got[2], want[2], STAT_TOL, what + " rstd")
        for shape, groups, eps, act in sorted(seen["gn_bwd"]):
            a, g, b = gn_inputs(shape, dtype, gen)
            _, mean, rstd = gn_act_fwd(a, g, b, groups, eps, act)
            dy = torch.randn(shape, generator=gen, device=DEV).to(dtype)
            args = (a, g, b, mean, rstd, dy, groups, act)
            got = gn_act_bwd(*args)
            what = f"gn_act_bwd {shape} {dtype} act={act}"
            same_bits(got, gn_act_bwd(*args), what)
            note(dtype, max(compare_gn_bwd(
                got, gn_act_bwd_plain(*args), dtype, what)))
        for shape, groups, eps, act, shards in sorted(
                seen["sgn_fwd"] | seen["sgn_bwd"]):
            note(dtype, split_gn_case(shape, groups, shards, dtype, act,
                                      gen)["max_abs_err"])
        for shape, heads in sorted(seen["attn_fwd"]):
            qkv = torch.randn(shape, generator=gen, device=DEV).to(dtype)
            want = qkv_attention_plain(qkv, heads)
            note(dtype, compare(
                qkv_attention_fwd(qkv, heads), want, attention_tol(want),
                f"qkv_attention_fwd {shape} {dtype}"))
        for shape, heads in sorted(seen["attn_bwd"]):
            qkv = torch.randn(shape, generator=gen, device=DEV).to(dtype)
            dout = torch.randn(shape[:2] + (shape[2] // 3,), generator=gen,
                               device=DEV).to(dtype)
            want = qkv_attention_bwd_plain(qkv, dout, heads)
            note(dtype, compare(
                qkv_attention_bwd(qkv, dout, heads), want,
                attention_bwd_tol(want),
                f"qkv_attention_bwd {shape} {dtype}"))
    return dict(**{f"{k}_shapes": len(v) for k, v in seen.items()},
                batches=sorted({shape[0] for shape, *_ in seen["gn_fwd"]}),
                worst_max_abs_err=worst)


# Instantiations the build log must list (`_build.kernel_instance` names):
# every attention kernel at every tile width, the chunked ones (heads past
# 64) at 1 to 4 chunks and the cluster ones (heads past 256) at every
# number of chunks a block may hold (1 to `BLOCK_CHUNKS`: 4 in bfloat16, 2
# in float32), the four tensor-core convolutions (bf16 `wgmma` and float32
# 3xTF32, 64 and 128 columns).
REQUIRED_INSTANCES = [
    f"qkv_attention_{k}_kernel<{hs}>" for hs in attn_mod.HEAD_SIZES
    for k in ("fwd_tf32", "bwd_dq_tf32", "bwd_dkv_tf32", "fwd_mma",
              "bwd_dq_mma", "bwd_dkv_mma")] + [
    f"qkv_attention_{k}_chunked_kernel<{t},{nd}>"
    for t in ("__nv_bfloat16", "float")
    for nd in range(1, attn_mod.MAX_CHUNKS + 1)
    for k in ("fwd", "bwd_dq", "bwd_dkv")] + [
    f"qkv_attention_{k}_wide_kernel<{t},{nd}>"
    for t, dtype in (("__nv_bfloat16", torch.bfloat16),
                     ("float", torch.float32))
    for nd in range(1, attn_mod.BLOCK_CHUNKS[dtype] + 1)
    for k in ("fwd", "bwd_dq", "bwd_dkv")
] + [f"conv3x3_hwbc_{k}_kernel<{bn}>" for k in ("wgmma", "tf32")
     for bn in (64, 128)]


def reset_counts() -> None:
    for fn in graphs.COUNTED:
        fn.launches = 0


counts = graphs.launch_counts


class EagerGraph:
    """Stands in for `graphs.Graph` inside `eager_steps()`: runs the step
    eagerly on every call, as the port ran every step before it captured
    them (the comparison side of the captured paths only)."""

    def __init__(self, fn, device):
        self.fn = fn
        self.held = {}

    def __call__(self):
        self.fn()


@contextlib.contextmanager
def eager_steps():
    """Within the block the train chunks and sampler chains run every step
    eagerly on the card instead of replaying a captured one."""
    saved = graphs.Graph
    graphs.Graph = EagerGraph
    try:
        yield
    finally:
        graphs.Graph = saved


def free_graphs() -> None:
    """Give the memory of graphs no longer referenced back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def replay_ms(graph, reps=10) -> float:
    """Device time of one replay of a `graphs.Graph`: `reps` replays
    queued back to back between CUDA events (their counts are not
    touched)."""
    graph.graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# A substring of the name of each kernel a wrapper launches, as the profiler
# reports it: the attention backward launches two, dq then dk/dv.
PROFILED = {"gn_act_fwd": ("gn_act_fwd_kernel",),
            "gn_act_bwd": ("gn_act_bwd_kernel",),
            "qkv_attention_fwd": ("qkv_attention_fwd_",),
            "qkv_attention_bwd": ("qkv_attention_bwd_dq_",
                                  "qkv_attention_bwd_dkv_")}


def profile_replay(graph) -> dict:
    """`torch.profiler` over one replay: the kernels it ran on the card,
    their device time, and the hand-written ones by wrapper, which must be
    what the graph says it holds."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        graph.graph.replay()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    seen = {}
    for name, parts in PROFILED.items():
        per_part = [sum(part in e.name for e in kernels) for part in parts]
        if len(set(per_part)) != 1 or per_part[0] != graph.held[name]:
            raise AssertionError(f"profiled replay: {name} ran {per_part} "
                                 f"kernels, the graph holds "
                                 f"{graph.held[name]}")
        seen[name] = per_part[0]
    return dict(kernels=len(kernels), hand_written=seen, held=graph.held,
                device_ms=sum(e.time_range.elapsed_us() for e in kernels)
                / 1e3)


# The split GroupNorm's four kernels (spatial sharding): no launch where
# nothing is split.
SPLIT_GN = ("gn_stats", "gn_apply", "gn_bwd_sums", "gn_bwd_dx")
NO_SPLIT = dict.fromkeys(SPLIT_GN, 0)


def launches_per_forward(cfg):
    plan = unet.build_plan(cfg)
    layers = [layer for group in plan.input_blocks + (plan.middle,)
              + plan.output_blocks for layer in group]
    n_res = sum(layer[0] == "res" for layer in layers)
    n_attn = sum(layer[0] == "attn" for layer in layers)
    return 2 * n_res + n_attn + 1, n_attn


def launches_per_step(cfg, remat, microbatches):
    """Each kernel's launches in one train step: one forward and one
    backward per microbatch; with remat the forward of every layer group
    runs again in the backward, all GroupNorms but the final one (which
    sits outside the groups) and every attention."""
    gn, attn = launches_per_forward(cfg)
    gn_fwd, attn_fwd = (2 * gn - 1, 2 * attn) if remat else (gn, attn)
    return {"gn_act_fwd": microbatches * gn_fwd,
            "gn_act_bwd": microbatches * gn,
            "qkv_attention_fwd": microbatches * attn_fwd,
            "qkv_attention_bwd": microbatches * attn,
            "conv3x3_hwbc": 0,  # the model convolves through cuDNN
            **NO_SPLIT}


def check_forward(model, gen):
    """One float32 forward at each batch of the main path, kernels against
    plain versions; and the time of one B=8 forward either way, float32 and
    bfloat16, as it is called and on the device alone (replayed from a CUDA
    graph): the difference is time the card waits for the host."""
    cfg = model.cfg
    result = {"atol": FORWARD_ATOL, "max_abs_err": {}}
    with torch.no_grad():
        for batch in PATH_BATCHES:
            x = torch.randn(
                (batch, cfg.image_size, cfg.image_size, cfg.in_channels),
                generator=gen, device=DEV)
            t = torch.linspace(1, cfg.max_period - 1, batch, device=DEV
                               ).round()
            out = model(x, t)
            with plain_versions():
                ref = model(x, t)
            torch.cuda.synchronize()
            if out.shape != x.shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(
                    f"forward B={batch}: bad shape or non-finite output")
            result["max_abs_err"][f"batch_{batch}"] = compare(
                out, ref, dict(atol=FORWARD_ATOL, rtol=0.0),
                f"U-Net forward f32 B={batch}")
        x = torch.randn((8, cfg.image_size, cfg.image_size, cfg.in_channels),
                        generator=gen, device=DEV)
        t = torch.linspace(1, cfg.max_period - 1, 8, device=DEV).round()
        for name, dtype in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            net = model.to_compute(dtype)

            def plain():
                with plain_versions():
                    net(x, t)

            # plain, kernels, kernels, plain: both orders within one run
            times = [time_ms(plain, reps=5), time_ms(lambda: net(x, t), reps=5),
                     time_ms(lambda: net(x, t), reps=5), time_ms(plain, reps=5)]
            result[f"forward_ms_{name}"] = dict(
                kernels=min(times[1:3]), plain_versions=min(times[0], times[3]),
                kernels_graph=graph_ms(lambda: net(x, t), reps=3),
                plain_versions_graph=graph_ms(plain, reps=3))
    result["timed_batch"] = 8
    return result


def drive_path(tmp, totals, gen):
    """The port's main path at the default model; returns the request
    records, the check of the kernels at the shapes the requests give them
    and the captured DDIM-50 chain against the eager one, and adds the
    kernels' launches of the captured requests to `totals`."""
    cfg = UnetConfig()
    gn_per_fwd, attn_per_fwd = launches_per_forward(cfg)
    if (gn_per_fwd, attn_per_fwd) != (56, 11):
        raise AssertionError(f"unexpected plan: {gn_per_fwd}, {attn_per_fwd}")
    files = {}
    for name, num_classes, seed in (("uncond", None, 0), ("cond", 10, 1)):
        model = unet.init(cfg, num_classes,
                          generator=torch.Generator().manual_seed(seed),
                          device=DEV)
        files[name] = os.path.join(tmp, f"{name}.bin")
        ckpt_io.save(files[name], ckpt_io.Checkpoint(
            params=model, cfg=cfg, batch_size=8))
        del model

    def ddpm_chain(batch, dtype, num_steps=None):
        ckpt = ckpt_io.load(files["uncond"], device=DEV)
        diffusion = GaussianDiffusion.create(
            named_beta_schedule(ckpt.noise_schedule, cfg.max_period),
            device=DEV)
        sampler = make_sampler(cfg, diffusion, batch_size=batch,
                               compute_dtype=dtype, num_steps=num_steps)
        images = sampler(ckpt.params,
                         torch.Generator(device=DEV).manual_seed(0))
        if not bool(torch.isfinite(images).all()):
            raise AssertionError("ddpm chain: non-finite images")
        return to_uint8(images)

    def cli(file, *flags):
        return lambda: generate.run(generate.parse_args(
            ["--model_filename", file, "--device", "cuda", *flags]))

    requests = [
        ("ddim50_b8_bf16", 8, 50, cli(
            files["uncond"], "--sampler", "ddim", "--ddim_steps", "50",
            "--batch_size", "8", "--compute_dtype", "bfloat16")),
        ("ddim50_b8_f32", 8, 50, cli(
            files["uncond"], "--sampler", "ddim", "--ddim_steps", "50",
            "--batch_size", "8", "--compute_dtype", "float32")),
        ("cfg_ddim20_b8_bf16", 8, 20, cli(
            files["cond"], "--sampler", "ddim", "--ddim_steps", "20",
            "--batch_size", "8", "--compute_dtype", "bfloat16",
            "--class_label", "3", "--guidance_scale", "3.0")),
        ("ddpm998_b4_bf16", 4, cfg.max_period - 2,
         lambda: ddpm_chain(4, torch.bfloat16)),
    ]
    # One short untimed request of each kind first: the first call at a
    # batch size and type pays cuDNN's and cuBLAS's set-up.  They also show
    # which shapes the requests hand the kernels.
    seen = new_seen()
    with recording(seen):
        for dtype in ("bfloat16", "float32"):
            cli(files["uncond"], "--sampler", "ddim", "--ddim_steps", "2",
                "--batch_size", "8", "--compute_dtype", dtype)()
        cli(files["cond"], "--sampler", "ddim", "--ddim_steps", "2",
            "--batch_size", "8", "--compute_dtype", "bfloat16",
            "--class_label", "3", "--guidance_scale", "3.0")()
        ddpm_chain(4, torch.bfloat16, num_steps=2)
    seen = check_seen_shapes(seen, gen)
    if seen["batches"] != sorted(PATH_BATCHES):
        raise AssertionError(f"the requests ran at batches {seen['batches']}")

    def run_request(name, batch, model_calls, request):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        images = request()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        gn_n, attn_n = gn_act_fwd.launches, qkv_attention_fwd.launches
        if (gn_act_bwd.launches or qkv_attention_bwd.launches
                or conv3x3_hwbc.launches):
            raise AssertionError(f"{name}: a backward kernel or the "
                                 f"convolution kernel ran: {counts()}")
        shape = (batch, cfg.image_size, cfg.image_size, cfg.out_channels)
        if images.shape != shape or str(images.dtype) != "uint8":
            raise AssertionError(
                f"{name}: got {images.shape} {images.dtype}, want {shape} "
                "uint8")
        if (gn_n, attn_n) != (model_calls * gn_per_fwd,
                              model_calls * attn_per_fwd):
            raise AssertionError(
                f"{name}: {gn_n} GroupNorm and {attn_n} attention launches "
                f"for {model_calls} model calls")
        return images, seconds, gn_n, attn_n

    records = []
    for name, batch, model_calls, request in requests:
        images, seconds, gn_n, attn_n = run_request(name, batch, model_calls,
                                                    request)
        totals["gn_act_fwd"] += gn_n
        totals["qkv_attention_fwd"] += attn_n
        # the same request with every step of the chain run eagerly
        with eager_steps():
            eager_images, eager_seconds, _, _ = run_request(
                name, batch, model_calls, request)
        free_graphs()
        records.append(dict(
            request=name, shape=list(images.shape), dtype=str(images.dtype),
            finite=True, model_calls=model_calls, seconds=seconds,
            images_per_s=batch / seconds, gn_act_fwd_launches=gn_n,
            qkv_attention_fwd_launches=attn_n,
            pixel_mean=float(images.mean()), eager_seconds=eager_seconds,
            eager_images_per_s=batch / eager_seconds,
            eager_images_equal=bool(np.array_equal(images, eager_images))))
    return records, seen, check_captured_chain(files["uncond"], gen)


def check_captured_chain(path, gen):
    """The captured DDIM-50 chain against the same chain run eagerly, float32,
    B=8, from one start: within the forward's bar."""
    cfg = UnetConfig()
    ckpt = ckpt_io.load(path, device=DEV)
    diffusion = GaussianDiffusion.create(
        named_beta_schedule(ckpt.noise_schedule, cfg.max_period), device=DEV)
    x_init = torch.randn((8, cfg.image_size, cfg.image_size, cfg.in_channels),
                         generator=gen, device=DEV)

    def chain():
        return ddim_sample(ckpt.params, cfg, diffusion, num_steps=50,
                           batch_size=8, x_init=x_init)

    captured = chain()
    with eager_steps():
        eager = chain()
    err = compare(captured, eager, dict(atol=FORWARD_ATOL, rtol=0.0),
                  "captured DDIM-50 f32 against the eager chain")
    free_graphs()
    return dict(chain="ddim50_b8_f32", atol=FORWARD_ATOL, max_abs_err=err,
                bits_equal=bool(torch.equal(captured, eager)))


def step_against_plain(cfg, gen, batch_size=TRAIN_BATCH):
    """One float32 step of `cfg` at the trainer's batch (or `batch_size`):
    loss and every gradient on the kernels against the same on the plain
    versions (the kernels' launches held to one step's); returns the model,
    the step's inputs and the record."""
    model = unet.init(cfg, generator=torch.Generator().manual_seed(2),
                      device=DEV)
    diffusion = GaussianDiffusion.create(
        named_beta_schedule("linear", cfg.max_period), device=DEV)
    tc = TrainConfig(batch_size=batch_size, lr=1e-3)
    grad_fn = trainer._make_grad_fn(
        trainer.make_loss_fn(cfg, diffusion, torch.float32), tc)
    shape = (batch_size, cfg.image_size, cfg.image_size, cfg.in_channels)
    batch = torch.rand(shape, generator=gen, device=DEV) * 2 - 1
    t = torch.randint(0, cfg.max_period, (batch_size,), generator=gen,
                      device=DEV)
    noise = torch.randn(shape, generator=gen, device=DEV)
    reset_counts()
    loss, grads = grad_fn(model, batch, t, noise)
    launches = counts()
    if launches != launches_per_step(cfg, False, 1):
        raise AssertionError(f"train step f32: launches {launches}")
    with plain_versions():
        ploss, pgrads = grad_fn(model, batch, t, noise)
    loss, ploss = loss.item(), ploss.item()
    rel = abs(loss - ploss) / abs(ploss)
    if not (math.isfinite(loss) and rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"train step f32: loss {loss} against {ploss} "
                             "on the plain versions")
    grad_err = max(compare(g, p, dict(atol=TRAIN_GRAD_ATOL, rtol=0.0),
                           f"train step f32 gradient {i}")
                   for i, (g, p) in enumerate(zip(grads, pgrads)))
    grad_max = max(p.abs().max().item() for p in pgrads)
    return model, tc, diffusion, (batch, t, noise), dict(
        batch=batch_size, loss=loss, plain_loss=ploss, loss_rel_err=rel,
        loss_rtol=TRAIN_LOSS_RTOL, grad_max_abs_err=grad_err,
        grad_atol=TRAIN_GRAD_ATOL, grad_max_abs=grad_max, launches=launches)


def check_train_step(gen):
    """One float32 step of the default model at the trainer's batch: loss
    and gradients on the kernels against the same on the plain versions;
    then ten `step_with` steps on one fixed batch, t and noise, whose loss
    must fall."""
    cfg = UnetConfig()
    model, tc, diffusion, (batch, t, noise), record = step_against_plain(
        cfg, gen)
    state = trainer.init_state(model)
    _, step_with = trainer.make_train_step(cfg, tc, diffusion, DEV)
    losses = torch.stack([step_with(state, batch, t, noise)[1]
                          for _ in range(10)]).tolist()
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"ten steps on one batch: losses {losses}")
    return dict(**record, ten_step_losses=losses)


# The training configurations of the `train` phase, as `TrainConfig`s: the
# chunked path's step of each is captured in the `graphs` phase.
TRAIN_CONFIGS = {
    "bf16": dict(compute_dtype="bfloat16", ema_rate=0.999),
    "f32": dict(compute_dtype="float32"),
    "remat": dict(compute_dtype="bfloat16", remat=True,
                  microbatch=TRAIN_BATCH // 2)}
STEP_LOSS_RTOL = 1e-5        # one captured f32 step against the eager one
STEP_STATE_ATOL = 1e-3       # its parameters and moments
FLAT_LOSS_RTOL = 1e-5        # the flat f32 chunk against the tree one
FLAT_PARAM_ATOL = 1e-3
# bfloat16, ten captured steps on uint8 input against ten eager steps on the
# stored float32 batches: the rebuilt input is within 1 ulp of the stored
# one, and the card's convolution backward does not repeat its bits from
# run to run even eagerly, so the trajectories part by bfloat16 roundings.
BF16_LOSS_RTOL = 1e-2


def state_tensors(state):
    return list(state.params.parameters()) + state.m + state.v


def drive_graphs(gen):
    """The captured train steps on the card, `UnetConfig()` at B=32:

    * one float32 step captured against the same step run eagerly, from the
      same state, batch, t and noise (the graph's first call runs eagerly,
      so the second step is the captured one), and a second eager run
      beside them: how far two eager runs fall apart;
    * `make_flat_multi_step` against the tree `make_multi_step`, three
      float32 steps on one chunk from one state, compared name by name, and
      the device time of one replay of each, float32 and bfloat16 (no
      EMA);
    * for each configuration of `TRAIN_CONFIGS`, the chunked path's step
      (`make_multi_step`, uint8 input) over a chunk of ten seeded batches:
      the device time of one replay (CUDA events around back-to-back
      replays); for bf16 the ten losses against ten eager `train_step`s on
      the float32 batches, and one replay profiled, whose hand-written
      kernels must be the launches the graph holds."""
    cfg = UnetConfig()
    diffusion = GaussianDiffusion.create(
        named_beta_schedule("linear", cfg.max_period), device=DEV)
    shape = (TRAIN_BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)
    out = {}

    def model(seed):
        return unet.init(cfg, generator=torch.Generator().manual_seed(seed),
                         device=DEV)

    # one f32 step, captured against eager
    tc = TrainConfig(batch_size=TRAIN_BATCH, lr=1e-3)
    captured = trainer.init_state(model(2))
    eager = [trainer.init_state(copy.deepcopy(captured.params))
             for _ in range(2)]
    multi = trainer.make_multi_step(cfg, tc, diffusion, DEV)
    _, step_with = trainer.make_train_step(cfg, tc, diffusion, DEV)
    losses = []
    for _ in range(2):
        batch = torch.rand(shape, generator=gen, device=DEV) * 2 - 1
        t = torch.randint(0, cfg.max_period, (TRAIN_BATCH,), generator=gen,
                          device=DEV)
        noise = torch.randn(shape, generator=gen, device=DEV)
        losses.append([multi.step_with(captured, batch, t, noise)[1].item()]
                      + [step_with(s, batch, t, noise)[1].item()
                         for s in eager])
    rel = abs(losses[1][0] - losses[1][1]) / abs(losses[1][1])
    err = max(compare(a, b, dict(atol=STEP_STATE_ATOL, rtol=0.0),
                      f"captured f32 step, state tensor {i}")
              for i, (a, b) in enumerate(zip(state_tensors(captured),
                                             state_tensors(eager[0]))))
    floor = max((a - b).abs().max().item() for a, b in
                zip(state_tensors(eager[1]), state_tensors(eager[0])))
    if not rel <= STEP_LOSS_RTOL:
        raise AssertionError(f"captured f32 step: loss {losses[1]}")
    out["f32_step"] = dict(
        losses_captured_eager_eager=losses, loss_rel_err=rel,
        loss_rtol=STEP_LOSS_RTOL, state_max_abs_err=err,
        state_atol=STEP_STATE_ATOL, eager_against_eager_max_abs_err=floor,
        bits_equal=all(torch.equal(a, b) for a, b in zip(
            state_tensors(captured), state_tensors(eager[0]))),
        held=multi.graph.held)
    del multi, captured, eager
    free_graphs()

    # flat against tree, three f32 steps on one chunk
    pixels = torch.randint(0, 256, (10,) + shape, generator=gen, device=DEV,
                           dtype=torch.uint8)
    stored = pixels.float() / 127.5 - 1.0
    tree = trainer.init_state(model(3), seed=5)
    flat, unravel = trainer.flatten_state(copy.deepcopy(tree.params), seed=5)
    tree_multi = trainer.make_multi_step(cfg, tc, diffusion, DEV)
    flat_multi = trainer.make_flat_multi_step(cfg, tc, unravel, diffusion,
                                              DEV)
    tree_losses = tree_multi(tree, stored[:3])[1].tolist()
    flat_losses = flat_multi(flat, stored[:3])[1].tolist()
    rel = max(abs(a - b) / abs(b) for a, b in zip(flat_losses, tree_losses))
    params = dict(tree.params.named_parameters())
    err = max(compare(view, params[name], dict(atol=FLAT_PARAM_ATOL,
                                                rtol=0.0), f"flat {name}")
              for name, view in unravel(flat.flat.detach()).items())
    if not rel <= FLAT_LOSS_RTOL:
        raise AssertionError(f"flat chunk: losses {flat_losses} against "
                             f"{tree_losses}")
    out["flat_against_tree_f32"] = dict(
        steps=3, flat_losses=flat_losses, tree_losses=tree_losses,
        loss_rel_err=rel, loss_rtol=FLAT_LOSS_RTOL, param_max_abs_err=err,
        param_atol=FLAT_PARAM_ATOL)
    # the device time of one step either way, f32 and bf16, no EMA
    replays = {"f32": dict(tree_ms=replay_ms(tree_multi.graph),
                           flat_ms=replay_ms(flat_multi.graph))}
    del tree_multi, flat_multi, tree, flat, unravel
    free_graphs()
    tc16 = TrainConfig(batch_size=TRAIN_BATCH, lr=1e-3,
                       compute_dtype="bfloat16")
    tree = trainer.init_state(model(3), seed=5)
    flat, unravel = trainer.flatten_state(copy.deepcopy(tree.params), seed=5)
    tree_multi = trainer.make_multi_step(cfg, tc16, diffusion, DEV)
    flat_multi = trainer.make_flat_multi_step(cfg, tc16, unravel, diffusion,
                                              DEV)
    tree_multi(tree, stored[:2])
    flat_multi(flat, stored[:2])
    replays["bf16"] = dict(tree_ms=replay_ms(tree_multi.graph),
                           flat_ms=replay_ms(flat_multi.graph))
    out["flat_against_tree_replay_ms"] = replays
    del tree_multi, flat_multi, tree, flat, unravel
    free_graphs()

    # each training configuration's captured step
    steps = {}
    for name, fields in TRAIN_CONFIGS.items():
        tc = TrainConfig(batch_size=TRAIN_BATCH, **fields)
        state = trainer.init_state(model(0), ema_rate=tc.ema_rate)
        start = copy.deepcopy(state) if name == "bf16" else None
        multi = trainer.make_multi_step(cfg, tc, diffusion, DEV,
                                        input_u8=True)
        got = multi(state, pixels)[1].tolist()
        record = dict(replay_ms=replay_ms(multi.graph), held=multi.graph.held)
        if name == "bf16":
            train_step, _ = trainer.make_train_step(cfg, tc, diffusion, DEV)
            want = [train_step(start, b)[1].item() for b in stored]
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            if not (all(map(math.isfinite, got)) and rel <= BF16_LOSS_RTOL):
                raise AssertionError(f"bf16 captured losses {got} against "
                                     f"eager {want}")
            record.update(captured_losses=got, eager_losses=want,
                          loss_max_rel_diff=rel, loss_rtol=BF16_LOSS_RTOL,
                          profiled_replay=profile_replay(multi.graph))
            del start
        steps[name] = record
        del multi, state
        free_graphs()
    out["captured_steps"] = steps
    return out


LOG_LINE = re.compile(r"step (\d+): loss (\S+) \(([0-9.]+) ms/step\)")


def drive_train(tmp, totals, gen, step_ms):
    """The training CLI at the default model, full width and depth, B=32:
    returns the run records and the check of the kernels at the shapes the
    trainer's first steps give them, and adds the launches of the chunked
    runs to `totals`.  Each configuration runs on the chunked path (the
    uint8 encoding must be logged) and again on the per-step path (a
    `--save_interval` that is no multiple of the log interval); `step_ms`
    is the device time of each
    configuration's step (`drive_graphs`), from which each run's idle
    share follows."""
    cfg = UnetConfig()
    rng = np.random.default_rng(0)
    data = os.path.join(tmp, "train.bin")
    pixels = rng.integers(0, 256, (256, cfg.in_channels, cfg.image_size,
                                   cfg.image_size), dtype=np.uint8)
    write_bin(data, pixels.astype(np.float32) / 127.5 - 1.0)

    def run(name, *flags):
        log = os.path.join(tmp, f"{name}.txt")
        argv = ["--data_file", data, "--device", str(DEV),
                "--batch_size", str(TRAIN_BATCH), "--output_dir",
                os.path.join(tmp, name.split("_")[0]), "--log_file", log,
                *flags]
        with contextlib.redirect_stdout(io.StringIO()) as out:
            state = train_cli.main(argv)
        torch.cuda.synchronize()
        with open(log) as f:
            return state, f.read(), out.getvalue()

    # One untimed chunk of two steps of each kind first (an eager step and a
    # captured one): cuDNN's and cuBLAS's set-up, and the shapes the trainer
    # hands the kernels at warm-up and capture.
    seen = new_seen()
    with recording(seen):
        for flags in (["--compute_dtype", "bfloat16"],
                      ["--compute_dtype", "float32"],
                      ["--compute_dtype", "bfloat16", "--remat", "true",
                       "--microbatch", str(TRAIN_BATCH // 2)]):
            run("warm", "--iterations", "2", "--log_interval", "2",
                "--save_interval", "0", *flags)
            free_graphs()
    seen = check_seen_shapes(seen, gen)
    if seen["batches"] != [TRAIN_BATCH // 2, TRAIN_BATCH]:
        raise AssertionError(f"the trainer ran at batches {seen['batches']}")

    bf16 = ["--compute_dtype", "bfloat16", "--ema_rate", "0.999"]
    f32 = ["--compute_dtype", "float32"]
    remat = ["--compute_dtype", "bfloat16", "--remat", "true",
             "--microbatch", str(TRAIN_BATCH // 2)]
    # (name, configuration, first step, last step, flags).  The `*steps`
    # runs log at the same interval, but their --save_interval is no
    # multiple of it (and past their last step), which sends them down the
    # per-step path, as the JAX CLI would send them.
    runs = [
        ("bf16", "bf16", 0, 20, [*bf16, "--iterations", "20",
                                 "--log_interval", "10",
                                 "--save_interval", "20"]),
        ("bf16_resume", "bf16", 20, 40, [
            *bf16, "--iterations", "40", "--log_interval", "10",
            "--save_interval", "20", "--model_weights",
            os.path.join(tmp, "bf16", "model_20.bin")]),
        ("bf16steps", "bf16", 0, 20, [*bf16, "--iterations", "20",
                                      "--log_interval", "10",
                                      "--save_interval", "25"]),
        ("f32", "f32", 0, 10, [*f32, "--iterations", "10", "--log_interval",
                               "5", "--save_interval", "0"]),
        ("f32steps", "f32", 0, 10, [*f32, "--iterations", "10",
                                    "--log_interval", "5",
                                    "--save_interval", "11"]),
        ("remat", "remat", 0, 4, [*remat, "--iterations", "4",
                                  "--log_interval", "2",
                                  "--save_interval", "0"]),
        ("rematsteps", "remat", 0, 4, [*remat, "--iterations", "4",
                                       "--log_interval", "2",
                                       "--save_interval", "5"]),
    ]
    records = []
    for name, config, first, last, flags in runs:
        remat_on, micro = config == "remat", 2 if config == "remat" else 1
        per_step = name.endswith("steps")
        reset_counts()
        t0 = time.perf_counter()
        state, log, out = run(name, *flags)
        seconds = time.perf_counter() - t0
        got = counts()
        want = {k: (last - first) * v
                for k, v in launches_per_step(cfg, remat_on, micro).items()}
        if got != want:
            raise AssertionError(f"train {name}: launches {got}, want {want}")
        if ("H2D encoding: uint8" in log) == per_step:
            raise AssertionError(f"train {name}: the encoding line, or its "
                                 f"absence, is wrong: {log[:200]}")
        lines = LOG_LINE.findall(log)
        steps = [int(s) for s, _, _ in lines]
        losses = [float(loss) for _, loss, _ in lines]
        interval = steps[0] - first if steps else 0
        if (steps != list(range(first + interval, last + 1, interval))
                or not all(map(math.isfinite, losses))):
            raise AssertionError(f"train {name}: log lines {lines}")
        if state.step != last:
            raise AssertionError(f"train {name}: ended at step {state.step}")
        if name.startswith("bf16") and not per_step:
            path = os.path.join(tmp, "bf16", f"model_{last}.bin")
            if f"saved {path}" not in log:
                raise AssertionError(f"train {name}: no checkpoint line")
            if ckpt_io.load(path, device=DEV).step != last:
                raise AssertionError(f"train {name}: checkpoint step")
        if name == "bf16_resume" and "loaded" not in out:
            raise AssertionError("train bf16_resume: did not load")
        if not per_step:
            for k, v in got.items():
                totals[k] += v
        ms = float(lines[-1][2])  # the last interval: warm
        records.append(dict(
            run=name, path="per-step" if per_step else "chunked (captured)",
            steps=f"{first}->{last}", remat=remat_on, microbatches=micro,
            batch=TRAIN_BATCH, logged_losses=losses, ms_per_step=ms,
            images_per_s=TRAIN_BATCH / ms * 1e3,
            device_ms_per_step=step_ms[config],
            idle_share=1.0 - step_ms[config] / ms,
            peak_mib=trainer.device_peak_memory_mib(DEV),
            peak_reserved_mib=torch.cuda.max_memory_reserved(DEV) / 2 ** 20,
            seconds=seconds, launches=got,
            launches_per_step=launches_per_step(cfg, remat_on, micro)))
        del state
        free_graphs()
    by_name = {r["run"]: r for r in records}
    chunked, per_step = (by_name[n]["logged_losses"]
                         for n in ("bf16", "bf16steps"))
    agreement = dict(
        chunked=chunked, per_step=per_step,
        max_rel_diff=max(abs(a - b) / abs(b)
                         for a, b in zip(chunked, per_step)))
    return records, seen, agreement


def drive_head_size(tmp, totals, gen):
    """The training and sampling CLIs at `UnetConfig()` with
    `OTHER_HEAD_SIZE` channels a head (one head of 192 at ds 4, two of 128
    at ds 8: the chunked kernels).  Both CLIs refuse each of
    `REFUSED_HEADS` on the card before they build a model; then
    `cli.train.main` takes 3 bfloat16 steps at B=32 and saves a
    checkpoint, `cli.generate.run` answers one DDIM-10 request at B=4 from
    it; both take `ACCEPTED_HEAD` (one bfloat16 step at B=32, a DDIM-2
    request at B=2 from a small checkpoint of the same width), and one
    float32 step at B=32 holds its loss and every gradient on the kernels
    against the plain versions (the `train_step` bars).  Launch counts per
    step and per model call are held exactly, the losses and images must
    be finite, and each kernel is held against its plain version at every
    shape the runs hand it.  Adds the launches to `totals`."""
    cfg = dataclasses.replace(UnetConfig(), num_head_channels=OTHER_HEAD_SIZE)
    data = os.path.join(tmp, "train.bin")
    pixels = np.random.default_rng(1).uniform(
        -1, 1, (64, cfg.in_channels, cfg.image_size, cfg.image_size))
    write_bin(data, pixels.astype(np.float32))
    log = os.path.join(tmp, "log.txt")

    def train_argv(head_size, *flags):
        return ["--data_file", data, "--device", str(DEV), "--batch_size",
                str(TRAIN_BATCH), "--num_head_channels", str(head_size),
                "--compute_dtype", "bfloat16", "--output_dir",
                os.path.join(tmp, "models"), "--log_file", log, *flags]

    def small_checkpoint(head_size, small_channels, small_mult):
        """generate reads the head size from the checkpoint: a small model
        with the same attention width will do."""
        small = UnetConfig(model_channels=small_channels,
                           channel_mult=small_mult, image_size=16,
                           num_res_blocks=1, attention_ds=(2,),
                           num_head_channels=head_size)
        path = os.path.join(tmp, f"hs{head_size}.bin")
        ckpt_io.save(path, ckpt_io.Checkpoint(
            params=unet.init(small, generator=torch.Generator().manual_seed(3),
                             device="cpu"), cfg=small, batch_size=4))
        return small, path

    # refused before any model exists
    reset_counts()
    refused = []
    for head_size, channels, small_channels, small_mult in REFUSED_HEADS:
        case = dict(num_head_channels=head_size, num_channels=channels)
        try:
            train_cli.main(train_argv(head_size, "--num_channels",
                                      str(channels), "--iterations", "1"))
        except SystemExit as e:
            case["train"] = str(e)
        _, path = small_checkpoint(head_size, small_channels, small_mult)
        with contextlib.redirect_stderr(io.StringIO()) as err:
            try:
                generate.run(generate.parse_args(
                    ["--model_filename", path, "--device", "cuda"]))
            except SystemExit:
                case["generate"] = err.getvalue().strip().splitlines()[-1]
        if not {"train", "generate"} <= set(case) or any(counts().values()):
            raise AssertionError(f"head size {head_size} on the card: "
                                 f"{case}, {counts()}")
        refused.append(case)

    seen = new_seen()
    t0 = time.perf_counter()
    with recording(seen), contextlib.redirect_stdout(io.StringIO()):
        state = train_cli.main(train_argv(
            OTHER_HEAD_SIZE, "--iterations", "3", "--log_interval", "1",
            "--save_interval", "3"))
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    got = counts()
    want = {k: 3 * v for k, v in launches_per_step(cfg, False, 1).items()}
    with open(log) as f:
        lines = LOG_LINE.findall(f.read())
    losses = [float(loss) for _, loss, _ in lines]
    if (got != want or state.step != 3 or [int(s) for s, _, _ in lines]
            != [1, 2, 3] or not all(map(math.isfinite, losses))):
        raise AssertionError(f"train at head size {OTHER_HEAD_SIZE}: "
                             f"launches {got}, want {want}; log {lines}")
    for k, v in got.items():
        totals[k] += v
    del state

    path = os.path.join(tmp, "models", "model_3.bin")
    if ckpt_io.read_config(path).num_head_channels != OTHER_HEAD_SIZE:
        raise AssertionError("the checkpoint lost its head size")
    reset_counts()
    t0 = time.perf_counter()
    with recording(seen):
        images = generate.run(generate.parse_args(
            ["--model_filename", path, "--device", "cuda", "--sampler",
             "ddim", "--ddim_steps", "10", "--batch_size", "4",
             "--compute_dtype", "bfloat16"]))
    torch.cuda.synchronize()
    sample_seconds = time.perf_counter() - t0
    gn_per_fwd, attn_per_fwd = launches_per_forward(cfg)
    got_sample = counts()
    want_sample = dict(gn_act_fwd=10 * gn_per_fwd, gn_act_bwd=0,
                       qkv_attention_fwd=10 * attn_per_fwd,
                       qkv_attention_bwd=0, conv3x3_hwbc=0, **NO_SPLIT)
    shape = (4, cfg.image_size, cfg.image_size, cfg.out_channels)
    if (got_sample != want_sample or images.shape != shape
            or not np.isfinite(images).all()):
        raise AssertionError(f"ddim10 at head size {OTHER_HEAD_SIZE}: "
                             f"launches {got_sample}, images {images.shape}")
    for k, v in got_sample.items():
        totals[k] += v
    heads = sorted({shape[2] // 3 // n for shape, n in seen["attn_fwd"]})
    if heads != sorted({w // (w // OTHER_HEAD_SIZE)
                        for w in unet.attention_widths(cfg)}):
        raise AssertionError(f"the runs' head sizes {heads}")

    # taken: heads of 288 and 384, and of 288 in the small checkpoint
    head_size, channels, small_channels, small_mult = ACCEPTED_HEAD
    wide = dataclasses.replace(cfg, model_channels=channels,
                               num_head_channels=head_size)
    small, path = small_checkpoint(head_size, small_channels, small_mult)
    reset_counts()
    with recording(seen), contextlib.redirect_stdout(io.StringIO()):
        state = train_cli.main(train_argv(
            head_size, "--num_channels", str(channels), "--iterations", "1",
            "--log_interval", "1", "--save_interval", "1", "--output_dir",
            os.path.join(tmp, f"hs{head_size}"), "--log_file",
            os.path.join(tmp, f"hs{head_size}.txt")))
        small_images = generate.run(generate.parse_args(
            ["--model_filename", path, "--device", str(DEV), "--sampler",
             "ddim", "--ddim_steps", "2", "--batch_size", "2",
             "--compute_dtype", "bfloat16"]))
    torch.cuda.synchronize()
    got_wide = counts()
    want_wide = launches_per_step(wide, False, 1)
    want_wide["gn_act_fwd"] += 2 * launches_per_forward(small)[0]
    want_wide["qkv_attention_fwd"] += 2 * launches_per_forward(small)[1]
    with open(os.path.join(tmp, f"hs{head_size}.txt")) as f:
        wide_lines = LOG_LINE.findall(f.read())
    if (got_wide != want_wide or state.step != 1 or len(wide_lines) != 1
            or not math.isfinite(float(wide_lines[0][1]))
            or not np.isfinite(small_images).all()):
        raise AssertionError(f"head size {head_size} on the card: launches "
                             f"{got_wide}, want {want_wide}; log "
                             f"{wide_lines}")
    for k, v in got_wide.items():
        totals[k] += v
    del state
    accepted = dict(num_head_channels=head_size, num_channels=channels,
                    heads=sorted({w // (w // head_size)
                                  for w in unet.attention_widths(wide)}),
                    train_loss=float(wide_lines[0][1]),
                    sample_shape=list(small_images.shape), launches=got_wide)

    with recording(seen):
        model, *_, step = step_against_plain(cfg, gen)
    for k, v in step["launches"].items():
        totals[k] += v
    del model
    return dict(head_size=OTHER_HEAD_SIZE, heads_run=heads, refused=refused,
                accepted=accepted,
                train=dict(batch=TRAIN_BATCH, steps=3, logged_losses=losses,
                           seconds=train_seconds, launches=got),
                sample=dict(request="ddim10_b4_bf16", shape=list(images.shape),
                            seconds=sample_seconds, launches=got_sample,
                            pixel_mean=float(images.mean())),
                f32_step=step, kernel_inputs=check_seen_shapes(seen, gen))


# The `wide_head` phase: DDPM's 256 x 256 models (Ho et al. 2020,
# arXiv:2006.11239; CelebA-HQ, LSUN church and bedroom: ch 128, mult
# 1,1,2,2,4,4, two res blocks a level, single-head attention at 16 x 16)
# in the CLIs' flags, one head of 512 (the cluster kernels) in two input
# blocks and three output blocks at 16 x 16 and the middle block at 8 x 8.
DDPM256_FLAGS = ["--image_size", "256", "--num_channels", "128",
                 "--channel_mult", "1,1,2,2,4,4", "--num_res_blocks", "2",
                 "--attention_resolutions", "16", "--num_head_channels",
                 "512"]
# Training at the paper's batch of 64 (its Appendix B); the float32 check
# at 8 (cut to keep the phase short).
WIDE_BATCH = 64
WIDE_F32_BATCH = 8
WIDE_STEPS = 3


def drive_one_head(tmp, totals, gen, name, flags, head, batch, n_images,
                   sample_batch, f32_batch, steps=3):
    """A model of one head a layer (`flags`: its CLI flags; `head` columns,
    six attention layers) at full width and depth, random weights from a
    seed, on the training and serving paths: `cli.train.main` takes `steps`
    bfloat16 steps at `batch` on a `.bin` of `n_images` seeded images,
    logging every step, and saves a checkpoint; `cli.generate.run` answers
    one DDIM-10 request at `sample_batch` from it; one float32 step at
    `f32_batch` holds its loss and every gradient on the kernels against
    the plain versions (the `train_step` bars).  6 K1 launches a forward
    and 6 K2 a step, every launch count exact, finite losses and images,
    and every kernel input of the runs held against its plain version.
    Adds the launches to `totals`; returns the record and the config."""
    cfg = train_cli.model_config_from_args(
        train_cli.create_argparser().parse_args(flags))
    widths = unet.attention_widths(cfg)
    gn_per_fwd, attn_per_fwd = launches_per_forward(cfg)
    if widths != [head] * 6 or attn_per_fwd != 6:
        raise AssertionError(f"{name}: attention widths {widths}")
    data = os.path.join(tmp, f"{name}.bin")
    pixels = np.random.default_rng(4).uniform(
        -1, 1, (n_images, cfg.in_channels, cfg.image_size, cfg.image_size))
    write_bin(data, pixels.astype(np.float32))
    log = os.path.join(tmp, "log.txt")
    seen = new_seen()

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(seen), contextlib.redirect_stdout(io.StringIO()):
        state = train_cli.main(
            ["--data_file", data, "--device", str(DEV), "--batch_size",
             str(batch), "--compute_dtype", "bfloat16", "--iterations",
             str(steps), "--log_interval", "1", "--save_interval",
             str(steps), "--output_dir", os.path.join(tmp, "models"),
             "--log_file", log, *flags])
    torch.cuda.synchronize()
    train_seconds = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    got = counts()
    want = {k: steps * v for k, v in launches_per_step(cfg, False, 1).items()}
    with open(log) as f:
        lines = LOG_LINE.findall(f.read())
    losses = [float(loss) for _, loss, _ in lines]
    if (got != want or state.step != steps
            or [int(step) for step, _, _ in lines] != list(range(1, steps + 1))
            or not all(map(math.isfinite, losses))):
        raise AssertionError(f"{name} train: launches {got}, want {want}; "
                             f"log {lines}")
    for k, v in got.items():
        totals[k] += v
    del state
    free_graphs()

    path = os.path.join(tmp, "models", f"model_{steps}.bin")
    reset_counts()
    t0 = time.perf_counter()
    with recording(seen):
        images = generate.run(generate.parse_args(
            ["--model_filename", path, "--device", str(DEV), "--sampler",
             "ddim", "--ddim_steps", "10", "--batch_size", str(sample_batch),
             "--compute_dtype", "bfloat16"]))
    torch.cuda.synchronize()
    sample_seconds = time.perf_counter() - t0
    got_sample = counts()
    want_sample = dict(gn_act_fwd=10 * gn_per_fwd, gn_act_bwd=0,
                       qkv_attention_fwd=10 * attn_per_fwd,
                       qkv_attention_bwd=0, conv3x3_hwbc=0, **NO_SPLIT)
    shape = (sample_batch, cfg.image_size, cfg.image_size, cfg.out_channels)
    if (got_sample != want_sample or images.shape != shape
            or not np.isfinite(images).all()):
        raise AssertionError(f"{name} ddim10: launches {got_sample}, "
                             f"images {images.shape}")
    for k, v in got_sample.items():
        totals[k] += v
    free_graphs()

    with recording(seen):
        model, *_, step = step_against_plain(cfg, gen, f32_batch)
    for k, v in step["launches"].items():
        totals[k] += v
    del model
    free_graphs()
    heads = sorted({shape[2] // 3 // n for shape, n in seen["attn_fwd"]})
    if heads != [head]:
        raise AssertionError(f"{name}: the runs' head sizes {heads}")
    ms_per_step = float(lines[-1][2])
    return dict(
        flags=" ".join(flags), attention_widths=widths,
        layout={str(dt): list(attn_mod.kernel_layout(head, dt))
                for dt in (torch.float32, torch.bfloat16)},
        params=ckpt_io.num_params(cfg), launches_per_forward=dict(
            gn_act_fwd=gn_per_fwd, qkv_attention_fwd=attn_per_fwd),
        train=dict(batch=batch, steps=steps, logged_losses=losses,
                   ms_per_step=ms_per_step,
                   images_per_s=batch / ms_per_step * 1e3, peak_mib=peak_mib,
                   seconds=train_seconds, launches=got),
        sample=dict(request=f"ddim10_b{sample_batch}_bf16",
                    shape=list(images.shape), seconds=sample_seconds,
                    launches=got_sample, pixel_mean=float(images.mean())),
        f32_step=step, kernel_inputs=check_seen_shapes(seen, gen)), cfg


def drive_wide_head(tmp, totals, gen):
    """DDPM-256 (`DDPM256_FLAGS`, one head of 512: the cluster kernels)
    through `drive_one_head`: 3 bfloat16 steps at B=64 on 128 seeded 256 x
    256 images, DDIM-10 at B=2, the float32 step at B=8; then the cluster
    kernels' device time a training step (`attention_share`)."""
    record, cfg = drive_one_head(tmp, totals, gen, "ddpm256", DDPM256_FLAGS,
                                 512, WIDE_BATCH, 2 * WIDE_BATCH, 2,
                                 WIDE_F32_BATCH, WIDE_STEPS)
    record["cluster_kernels"] = attention_share(record, cfg, WIDE_BATCH, gen)
    return record


def attention_share(record, cfg, batch, gen):
    """The attention kernels' device time a bfloat16 training step of a
    model of one head a layer (`drive_one_head`'s record and config):
    each kernel's device-alone time (`graph_ms`) at the step's attention
    shapes, the five layers at the attention resolution and the middle
    block's at the lowest, times its launches there, beside the step's
    ms."""
    C = record["attention_widths"][0]
    # attention layers a forward at each T: the middle block's at the
    # lowest resolution, the others' at the attention resolution
    mid = (cfg.image_size // 2 ** (len(cfg.channel_mult) - 1)) ** 2
    (ds,) = cfg.attention_ds
    layers = {(cfg.image_size // ds) ** 2: 5, mid: 1}
    if sum(layers.values()) != 6:
        raise AssertionError(f"attention layers {layers}")
    kernels, total = [], 0.0
    for T, n in sorted(layers.items(), reverse=True):
        qkv = torch.randn((batch, T, 3 * C), generator=gen,
                          device=DEV).to(torch.bfloat16)
        dout = torch.randn((batch, T, C), generator=gen,
                           device=DEV).to(torch.bfloat16)
        qkv_attention_fwd(qkv, 1)  # graph_ms's call before the capture
        qkv_attention_bwd(qkv, dout, 1)
        fwd_ms = graph_ms(lambda: qkv_attention_fwd(qkv, 1))
        bwd_ms = graph_ms(lambda: qkv_attention_bwd(qkv, dout, 1))
        total += n * (fwd_ms + bwd_ms)
        kernels.append(dict(
            shape=[batch, T, C, 1], dtype="torch.bfloat16",
            layout=list(attn_mod.kernel_layout(C, torch.bfloat16,
                                               attn_mod.row_tiles(
                                                   batch, T, 1,
                                                   torch.bfloat16))),
            launches_per_step=n, fwd_graph_ms=fwd_ms, bwd_graph_ms=bwd_ms))
    step_ms = record["train"]["ms_per_step"]
    return dict(cases=kernels, device_ms_per_step=total, step_ms=step_ms,
                share_of_step=total / step_ms)


# The `ddpm_cifar` phase: DDPM's CIFAR-10 model (Ho et al. 2020,
# arXiv:2006.11239; diffusion_tf `unet.py`: ch 128, ch_mult (1, 2, 2, 2),
# two res blocks a level, attention at 16 x 16) in the CLIs' flags: one
# head of 256 (the chunked kernels, four chunks) in two input blocks and
# three output blocks at 16 x 16 (T = 256) and the middle block at 4 x 4
# (T = 16).  Training at the paper's batch of 128; the float32 check at 32
# (cut from 128 to keep the phase short).
DDPM_CIFAR_FLAGS = ["--image_size", "32", "--num_channels", "128",
                    "--channel_mult", "1,2,2,2", "--attention_resolutions",
                    "16", "--num_head_channels", "256"]
CIFAR_BATCH = 128
CIFAR_SAMPLE_BATCH = 16
CIFAR_F32_BATCH = 32


def drive_ddpm_cifar(tmp, totals, gen):
    """DDPM CIFAR-10 through `drive_one_head`: 3 bfloat16 steps at B=128 on
    256 seeded 32 x 32 images, DDIM-10 at B=16, the float32 step at B=32;
    then the chunked kernels' device time a training step: each kernel's
    device-alone time (`graph_ms`, bfloat16) at the step's two attention
    shapes, (128, 256, 256, 1) and (128, 16, 256, 1), times its launches
    there, beside the step's ms."""
    record, cfg = drive_one_head(tmp, totals, gen, "ddpm_cifar",
                                 DDPM_CIFAR_FLAGS, 256, CIFAR_BATCH, 256,
                                 CIFAR_SAMPLE_BATCH, CIFAR_F32_BATCH)
    record["chunked_kernels"] = attention_share(record, cfg, CIFAR_BATCH,
                                                gen)
    return record


# The `s2d` phase: space-to-depth level 0 against pixel space.  bfloat16: the
# s2d forward's distance from the float32 pixel forward, at most this many
# times the bfloat16 pixel forward's (each rounds its own way).
S2D_BF16_FACTOR = 1.5
S2D_SERVING_STEPS = 10


def s2d_op_times(gen):
    """Device ms (alone, `graph_ms`) of forward + backward of one level-0
    GroupNorm(+SiLU) and one 64 -> 64 3x3 convolution at the trainer's
    batch in bfloat16, pixel space (K4 and K5; cuDNN) against patch space
    (`group_norm_silu_s2d`, K4 and K5 on a view; `conv2d_s2d`): where the
    s2d step's time goes."""
    B, H, C = TRAIN_BATCH, 64, 64

    def param(*shape, scale=0.05):
        return (torch.randn(shape, generator=gen, device=DEV) * scale).to(
            torch.bfloat16).requires_grad_()

    x = param(B, H, H, C, scale=1.0)
    dy = torch.randn((B, H, H, C), generator=gen, device=DEV).to(
        torch.bfloat16)
    xs = s2d_ops.space_to_depth(x.detach()).requires_grad_()
    dys = s2d_ops.space_to_depth(dy)
    gamma, beta = param(C, scale=1.0), param(C)
    w = param(C, C, 3, 3).detach().contiguous(
        memory_format=torch.channels_last).requires_grad_()
    b = param(C)
    pairs = {
        "group_norm_silu": (gamma, beta, (
            lambda h: functional.group_norm_silu(h, gamma, beta),
            lambda h: s2d_ops.group_norm_silu_s2d(h, gamma, beta))),
        "conv3x3_64_64": (w, b, (
            lambda h: functional.conv2d(h, w, b),
            lambda h: s2d_ops.conv2d_s2d(h, w, b)))}
    out = {}
    for name, (p1, p2, (pixel, patch)) in pairs.items():
        times = {}
        for space, fn, inp, grad in (("pixel", pixel, x, dy),
                                     ("s2d", patch, xs, dys)):
            def step(fn=fn, inp=inp, grad=grad):
                torch.autograd.grad(fn(inp), (inp, p1, p2), grad)

            step()
            times[f"{space}_ms"] = graph_ms(step, reps=3)
        out[name] = dict(times, shape=[B, H, H, C], dtype="torch.bfloat16")
    return out


@contextlib.contextmanager
def s2d_mode(name):
    """Within the block the model runs level 0 as `name` says
    (`unet.set_s2d_mode`); the mode before is restored after."""
    saved = unet._S2D_MODE
    unet.set_s2d_mode(name)
    try:
        yield
    finally:
        unet.set_s2d_mode(saved)


def drive_s2d(tmp, totals, gen, pixel_replay_ms, pixel_run):
    """Space-to-depth level 0 (`UNET_TPU_TORCH_S2D=on`) at `UnetConfig()`,
    full width and depth, against pixel space, on the kernels:

    * one forward at B=8, float32 (within `FORWARD_ATOL`) and bfloat16
      (within `S2D_BF16_FACTOR` times the bfloat16 pixel forward's
      distance from the float32 one), each mode's device time alone;
    * the float32 loss and gradients of one step at B=32 (the `train_step`
      phase's bars), and one `step_with` either way;
    * the captured bfloat16 + EMA step (`make_multi_step`, uint8 input,
      B=32) over ten batches, in either mode: launches exactly the plan's,
      ten finite losses, the device time of one replay (beside
      `pixel_replay_ms`, the `graphs` phase's), and the device time of a
      level-0 GroupNorm and convolution in either space (`s2d_op_times`);
    * `cli.train.main`, bfloat16 + EMA, chunked, 20 steps at B=32:
      ms/step, images/s, idle share, peak MiB beside `pixel_run` (the
      `train` phase's bf16 run);
    * a DDIM-10 float32 request at B=8 through `cli.generate.run` in both
      modes, twice each, from one checkpoint and one seed: the float
      images within `FORWARD_ATOL`.

    Every kernel input of the s2d runs is held against its plain version.
    Launch counts are held exactly and added to `totals`."""
    cfg = UnetConfig()
    per_fwd = launches_per_forward(cfg)
    per_step = launches_per_step(cfg, False, 1)
    if not unet.s2d_supported(cfg):
        raise AssertionError("the default model does not take s2d")
    out = dict(launches_per_forward=dict(gn_act_fwd=per_fwd[0],
                                         qkv_attention_fwd=per_fwd[1]),
               launches_per_step=per_step)
    seen = new_seen()

    def held(name, want):
        got = counts()
        if got != want:
            raise AssertionError(f"s2d {name}: launches {got}, want {want}")
        for k, v in got.items():
            totals[k] += v
        return got

    def forward_launches(n):
        return dict(gn_act_fwd=n * per_fwd[0], gn_act_bwd=0,
                    qkv_attention_fwd=n * per_fwd[1], qkv_attention_bwd=0,
                    conv3x3_hwbc=0, **NO_SPLIT)

    model = unet.init(cfg, generator=torch.Generator().manual_seed(0),
                      device=DEV)
    x = torch.randn((8, cfg.image_size, cfg.image_size, cfg.in_channels),
                    generator=gen, device=DEV)
    t = torch.linspace(1, cfg.max_period - 1, 8, device=DEV).round()
    outs, device_ms = {}, {}
    with torch.no_grad():
        for mode, space in (("on", "s2d"), ("off", "pixel")):
            for name, dtype in (("f32", torch.float32),
                                ("bf16", torch.bfloat16)):
                net = model.to_compute(dtype)
                with s2d_mode(mode):
                    reset_counts()
                    with recording(seen) if mode == "on" else \
                            contextlib.nullcontext():
                        y = net(x, t)
                    torch.cuda.synchronize()
                    if mode == "on":
                        held(f"forward {name}", forward_launches(1))
                    device_ms[f"{space}_{name}"] = graph_ms(
                        lambda: net(x, t), reps=3)
                if y.shape != x.shape or not bool(torch.isfinite(y).all()):
                    raise AssertionError(f"{space} forward {name}: bad shape "
                                         "or non-finite output")
                outs[space, name] = y.float()
    f32_err = compare(outs["s2d", "f32"], outs["pixel", "f32"],
                      dict(atol=FORWARD_ATOL, rtol=0.0),
                      "s2d forward f32 against pixel space")
    pixel_bf16 = (outs["pixel", "bf16"] - outs["pixel", "f32"]).abs().max()
    s2d_bf16 = (outs["s2d", "bf16"] - outs["pixel", "f32"]).abs().max()
    if not s2d_bf16 <= S2D_BF16_FACTOR * pixel_bf16:
        raise AssertionError(f"s2d forward bf16: {s2d_bf16.item()} from the "
                             f"f32 pixel forward, pixel bf16 "
                             f"{pixel_bf16.item()}")
    out["forward"] = dict(
        batch=8, f32_max_abs_err=f32_err, atol=FORWARD_ATOL,
        bf16_from_f32_pixel=dict(s2d=s2d_bf16.item(),
                                 pixel=pixel_bf16.item(),
                                 factor=S2D_BF16_FACTOR),
        device_ms=device_ms)
    del outs

    # one float32 step's loss and gradients, then one step_with either way
    diffusion = GaussianDiffusion.create(
        named_beta_schedule("linear", cfg.max_period), device=DEV)
    tc = TrainConfig(batch_size=TRAIN_BATCH, lr=1e-3)
    grad_fn = trainer._make_grad_fn(
        trainer.make_loss_fn(cfg, diffusion, torch.float32), tc)
    shape = (TRAIN_BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)
    batch = torch.rand(shape, generator=gen, device=DEV) * 2 - 1
    tt = torch.randint(0, cfg.max_period, (TRAIN_BATCH,), generator=gen,
                       device=DEV)
    noise = torch.randn(shape, generator=gen, device=DEV)
    with s2d_mode("on"):
        reset_counts()
        with recording(seen):
            loss, grads = grad_fn(model, batch, tt, noise)
        torch.cuda.synchronize()
        held("f32 step", per_step)
    ploss, pgrads = grad_fn(model, batch, tt, noise)
    loss, ploss = loss.item(), ploss.item()
    rel = abs(loss - ploss) / abs(ploss)
    if not (math.isfinite(loss) and rel <= TRAIN_LOSS_RTOL):
        raise AssertionError(f"s2d step f32: loss {loss} against {ploss} in "
                             "pixel space")
    grad_err = max(compare(g, p, dict(atol=TRAIN_GRAD_ATOL, rtol=0.0),
                           f"s2d step f32 gradient {i}")
                   for i, (g, p) in enumerate(zip(grads, pgrads)))
    del grads, pgrads
    _, step_with = trainer.make_train_step(cfg, tc, diffusion, DEV)
    step_losses = {}
    for mode in ("on", "off"):
        state = trainer.init_state(copy.deepcopy(model))
        with s2d_mode(mode):
            step_losses[mode] = step_with(state, batch, tt, noise)[1].item()
        del state
    step_rel = abs(step_losses["on"] - step_losses["off"]) / abs(
        step_losses["off"])
    if not step_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"s2d step_with f32: losses {step_losses}")
    out["train_step"] = dict(
        batch=TRAIN_BATCH, loss=loss, pixel_loss=ploss, loss_rel_err=rel,
        loss_rtol=TRAIN_LOSS_RTOL, grad_max_abs_err=grad_err,
        grad_atol=TRAIN_GRAD_ATOL, step_with_losses=step_losses,
        step_with_loss_rel_err=step_rel)
    del model, batch, tt, noise
    free_graphs()

    # the captured bf16 + EMA step over ten batches, either way
    tc16 = TrainConfig(batch_size=TRAIN_BATCH, **TRAIN_CONFIGS["bf16"])
    pixels = torch.randint(0, 256, (10,) + shape, generator=gen, device=DEV,
                           dtype=torch.uint8)
    steps = {}
    for mode, space in (("on", "s2d"), ("off", "pixel")):
        with s2d_mode(mode):
            state = trainer.init_state(
                unet.init(cfg, generator=torch.Generator().manual_seed(0),
                          device=DEV), ema_rate=tc16.ema_rate)
            multi = trainer.make_multi_step(cfg, tc16, diffusion, DEV,
                                            input_u8=True)
            reset_counts()
            with recording(seen) if mode == "on" else \
                    contextlib.nullcontext():
                losses = multi(state, pixels)[1].tolist()
            torch.cuda.synchronize()
        if mode == "on":
            held("captured bf16 step",
                 {k: 10 * v for k, v in per_step.items()})
            if multi.graph.held != per_step:
                raise AssertionError(f"s2d captured step: holds "
                                     f"{multi.graph.held}")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{space} captured step: losses {losses}")
        steps[space] = dict(replay_ms=replay_ms(multi.graph),
                            held=multi.graph.held, losses=losses)
        del multi, state
        free_graphs()
    out["captured_step"] = dict(
        batch=TRAIN_BATCH, config="bf16 + EMA 0.999, uint8 input",
        replay_ms=steps["s2d"]["replay_ms"],
        pixel_replay_ms=steps["pixel"]["replay_ms"],
        pixel_replay_ms_graphs_phase=pixel_replay_ms, **steps,
        level0_ops=s2d_op_times(gen))
    del pixels

    # the training CLI, bf16 + EMA, chunked, 20 steps
    data = os.path.join(tmp, "train.bin")
    images = np.random.default_rng(0).integers(
        0, 256, (256, cfg.in_channels, cfg.image_size, cfg.image_size),
        dtype=np.uint8)
    write_bin(data, images.astype(np.float32) / 127.5 - 1.0)
    log = os.path.join(tmp, "log.txt")
    with s2d_mode("on"):
        reset_counts()
        t0 = time.perf_counter()
        with recording(seen), contextlib.redirect_stdout(io.StringIO()):
            state = train_cli.main(
                ["--data_file", data, "--device", str(DEV), "--batch_size",
                 str(TRAIN_BATCH), "--compute_dtype", "bfloat16",
                 "--ema_rate", "0.999", "--iterations", "20",
                 "--log_interval", "10", "--save_interval", "20",
                 "--output_dir", os.path.join(tmp, "models"), "--log_file",
                 log])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    got = held("cli.train", {k: 20 * v for k, v in per_step.items()})
    with open(log) as f:
        text = f.read()
    lines = LOG_LINE.findall(text)
    logged = [float(loss) for _, loss, _ in lines]
    if ("H2D encoding: uint8" not in text or state.step != 20
            or [int(s) for s, _, _ in lines] != [10, 20]
            or not all(map(math.isfinite, logged))):
        raise AssertionError(f"s2d cli.train: log {text[-400:]}")
    ms = float(lines[-1][2])  # the last interval: warm
    replay = steps["s2d"]["replay_ms"]
    out["train"] = dict(
        run="bf16 + EMA, chunked (captured), 0->20", batch=TRAIN_BATCH,
        logged_losses=logged, ms_per_step=ms,
        images_per_s=TRAIN_BATCH / ms * 1e3, device_ms_per_step=replay,
        idle_share=1.0 - replay / ms,
        peak_mib=trainer.device_peak_memory_mib(DEV), seconds=seconds,
        launches=got,
        pixel={k: pixel_run[k] for k in ("ms_per_step", "images_per_s",
                                         "device_ms_per_step", "idle_share",
                                         "peak_mib")})
    del state
    free_graphs()

    # serving: DDIM-10 f32 B=8 through cli.generate.run, both modes
    path = os.path.join(tmp, "model.bin")
    ckpt_io.save(path, ckpt_io.Checkpoint(
        params=unet.init(cfg, generator=torch.Generator().manual_seed(0),
                         device=DEV), cfg=cfg, batch_size=8))
    floats, requests = {}, {}
    saved_to_uint8 = generate.to_uint8
    try:
        for mode, space in (("on", "s2d"), ("off", "pixel")):
            def keep(images, space=space):
                floats[space] = images.float().clone()
                return saved_to_uint8(images)

            generate.to_uint8 = keep
            seconds = []
            with s2d_mode(mode):
                reset_counts()
                # twice: the first request of a mode pays the set-up of
                # its convolutions at this batch and type
                for _ in range(2):
                    t0 = time.perf_counter()
                    with recording(seen) if mode == "on" else \
                            contextlib.nullcontext():
                        images = generate.run(generate.parse_args(
                            ["--model_filename", path, "--device", "cuda",
                             "--sampler", "ddim", "--ddim_steps",
                             str(S2D_SERVING_STEPS), "--batch_size", "8",
                             "--compute_dtype", "float32"]))
                    torch.cuda.synchronize()
                    seconds.append(time.perf_counter() - t0)
                requests[space] = dict(first_seconds=seconds[0],
                                       seconds=seconds[1],
                                       pixel_mean=float(images.mean()))
                if mode == "on":
                    requests[space]["launches"] = held(
                        "ddim10 f32", forward_launches(2 * S2D_SERVING_STEPS))
            if images.shape != (8, cfg.image_size, cfg.image_size,
                                cfg.out_channels):
                raise AssertionError(f"s2d ddim10: images {images.shape}")
    finally:
        generate.to_uint8 = saved_to_uint8
    out["serving"] = dict(
        request=f"ddim{S2D_SERVING_STEPS}_b8_f32", atol=FORWARD_ATOL,
        max_abs_err=compare(floats["s2d"], floats["pixel"],
                            dict(atol=FORWARD_ATOL, rtol=0.0),
                            "s2d DDIM-10 f32 against pixel space"),
        **requests)
    free_graphs()
    out["kernel_inputs"] = check_seen_shapes(seen, gen)
    return out


# The `input_pipeline` phase: scripts.profile_input_pipeline at its defaults
# (bf16, B=32, k=100, EMA 0.999) over this many chunks, on a .bin of this
# many seeded images.
PIPELINE_CHUNKS, PIPELINE_IMAGES = 4, 1024


def drive_input_pipeline(tmp, totals):
    """`python -m unet_tpu_torch.scripts.profile_input_pipeline` (its
    `main`, in this process) on a `.bin` of `PIPELINE_IMAGES` seeded images
    at `UnetConfig()`'s size: the chunked path's host phases per step and
    the dispatch split into launch, draws and the rest.  Every step it ran
    (through the captured step's calls and the bare replays) must have made
    one captured step's launches; they are added to `totals`."""
    cfg = UnetConfig()
    data = os.path.join(tmp, "pipeline.bin")
    images = np.random.default_rng(2).integers(
        0, 256, (PIPELINE_IMAGES, cfg.in_channels, cfg.image_size,
                 cfg.image_size), dtype=np.uint8)
    write_bin(data, images.astype(np.float32) / 127.5 - 1.0)
    del images
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        result = profile_input_pipeline.main(
            ["--data_file", data, "--chunks", str(PIPELINE_CHUNKS),
             "--device", "cuda"])
    torch.cuda.synchronize()
    steps = result["steps"] + result["bare_replays"]
    got, want = counts(), {k: steps * v for k, v in
                           launches_per_step(cfg, False, 1).items()}
    if (got != want or result["dispatch_split_ms_per_step"] is None
            or not all(map(math.isfinite, result["losses"]))):
        raise AssertionError(f"input pipeline: launches {got}, want {want}; "
                             f"{result}")
    for k, v in got.items():
        totals[k] += v
    free_graphs()
    return dict(result, launches=got)


# The `cli` phase.  Data path: 50 steps at a log interval of 10; the
# intervals between the first (warm-up and capture) and the last (which
# stages no chunk) are read: each stages a chunk while the card runs one.
CLI_DATA_STEPS, CLI_DATA_INTERVAL = 50, 10
# --host_rng, float32 per-step: the resumed run's losses against the
# straight run's, as a captured float32 step against an eager one.
HOST_RNG_LOSS_RTOL = STEP_LOSS_RTOL


@contextlib.contextmanager
def first_chunk_kept(kept):
    """Within the block, the first chunk a `cli.train` run stages is copied
    into `kept` (an empty list), as the pinned host buffer held it when its
    copy to the card was queued."""
    real = train_cli._ChunkStager.send

    def send(self):
        if not kept:
            kept.append(self.host.numpy().copy())
        return real(self)

    train_cli._ChunkStager.send = send
    try:
        yield
    finally:
        train_cli._ChunkStager.send = real


@contextlib.contextmanager
def enqueue_timed(seconds):
    """Within the block, the host's seconds in each call of a train chunk
    (`MultiStep.__call__`: the draws and the replays queued) are appended
    to `seconds`."""
    real = trainer.MultiStep.__call__

    def call(self, state, batches):
        t0 = time.perf_counter()
        out = real(self, state, batches)
        seconds.append(time.perf_counter() - t0)
        return out

    trainer.MultiStep.__call__ = call
    try:
        yield
    finally:
        trainer.MultiStep.__call__ = real


def read_csv(directory):
    """The rows of the one CSV file `Logger` wrote under `directory`."""
    (name,) = os.listdir(directory)
    with open(os.path.join(directory, name)) as f:
        keys, *rows = [line.rstrip("\n").split(",") for line in f]
    return [dict(zip(keys, row)) for row in rows]


def torch_state_dict(model, cfg):
    """`model`'s weights as the guided-diffusion torch model's state_dict
    holds them: in `param_order`, an attention projection as a Conv1d's
    (O, I, 1), on the CPU."""
    out = {}
    for path, kind in unet.param_order(cfg, model.num_classes):
        w = unet.get_param(model, path).detach().cpu()
        out[".".join(map(str, path))] = w[..., None] if kind == "conv1d" \
            else w
    return out


def drive_cli(tmp, totals, step_ms):
    """The rest of the one-card training CLI at `UnetConfig()`, full width
    and depth, B=32: the data path (the native loaders against
    `data_loader`, sequential and `--randomize`, the first staged chunks
    byte-equal), `--host_rng` with a resume, the SIGTERM save and
    `--auto_resume` in a child process, class-conditional training and a
    CFG request from its checkpoint, and a `.pt` state_dict served as the
    `.bin` of the same weights is.  Launch counts are held exactly where
    the run is in this process, and added to `totals`."""
    cfg = UnetConfig()
    per_step = launches_per_step(cfg, False, 1)
    gn_per_fwd, attn_per_fwd = launches_per_forward(cfg)
    per_request = dict(gn_act_fwd=10 * gn_per_fwd, gn_act_bwd=0,
                       qkv_attention_fwd=10 * attn_per_fwd,
                       qkv_attention_bwd=0, conv3x3_hwbc=0, **NO_SPLIT)
    rng = np.random.default_rng(2)
    data = os.path.join(tmp, "train.bin")
    write_bin(data, rng.integers(0, 256, (256, cfg.in_channels,
                                          cfg.image_size, cfg.image_size),
                                 dtype=np.uint8).astype(np.float32)
              / 127.5 - 1.0)

    def counted(name, want):
        got = counts()
        if got != want:
            raise AssertionError(f"cli {name}: launches {got}, want {want}")
        for k, v in got.items():
            totals[k] += v
        return got

    def train(name, *flags):
        log = os.path.join(tmp, f"{name}.txt")
        argv = ["--data_file", data, "--device", str(DEV), "--batch_size",
                str(TRAIN_BATCH), "--output_dir", os.path.join(tmp, name),
                "--log_file", log, *flags]
        with contextlib.redirect_stdout(io.StringIO()) as out:
            state = train_cli.main(argv)
        torch.cuda.synchronize()
        with open(log) as f:
            return state, f.read(), out.getvalue()

    # --- the data path ---
    data_runs, first_chunks = [], {}
    for randomize in ("false", "true"):
        for native_loader in ("true", "false"):
            name = f"data_native_{native_loader}_randomize_{randomize}"
            csv_dir = os.path.join(tmp, name + "_csv")
            kept, enqueue = [], []
            reset_counts()
            t0 = time.perf_counter()
            with first_chunk_kept(kept), enqueue_timed(enqueue):
                state, log, _ = train(
                    name, "--compute_dtype", "bfloat16", "--ema_rate",
                    "0.999", "--iterations", str(CLI_DATA_STEPS),
                    "--log_interval", str(CLI_DATA_INTERVAL),
                    "--save_interval", "0", "--native_loader", native_loader,
                    "--randomize", randomize, "--csv_log_dir", csv_dir)
            seconds = time.perf_counter() - t0
            launches = counted(name, {k: CLI_DATA_STEPS * v
                                      for k, v in per_step.items()})
            lines = LOG_LINE.findall(log)
            if ("H2D encoding: uint8" not in log or state.step
                    != CLI_DATA_STEPS or [int(s) for s, _, _ in lines]
                    != list(range(CLI_DATA_INTERVAL, CLI_DATA_STEPS + 1,
                                  CLI_DATA_INTERVAL))
                    or not all(math.isfinite(float(v)) for _, v, _ in lines)):
                raise AssertionError(f"cli {name}: log {log[:400]}")
            rows = read_csv(csv_dir)
            # the warm intervals that stage a chunk while the card runs one
            ms = float(np.mean([float(m) for _, _, m in lines[1:-1]]))
            host_ms = float(np.mean([float(r["chunk_host_ms"])
                                     for r in rows[1:-1]]))
            first_chunks[(randomize, native_loader)] = kept[0]
            data_runs.append(dict(
                run=name, native_loader=native_loader == "true",
                randomize=randomize == "true", batch=TRAIN_BATCH,
                steps=CLI_DATA_STEPS, log_interval=CLI_DATA_INTERVAL,
                ms_per_step=ms, images_per_s=TRAIN_BATCH / ms * 1e3,
                ms_per_step_by_interval=[float(m) for _, _, m in lines],
                device_ms_per_step=step_ms["bf16"],
                idle_share=1.0 - step_ms["bf16"] / ms,
                host_ms_per_chunk=host_ms,
                host_ms_per_chunk_by_interval=[
                    float(r["chunk_host_ms"]) if r["chunk_host_ms"] else None
                    for r in rows],
                enqueue_host_ms_per_chunk=float(np.mean(enqueue[1:])) * 1e3,
                enqueue_host_ms_by_chunk=[t * 1e3 for t in enqueue],
                logged_losses=[float(v) for _, v, _ in lines],
                seconds=seconds, launches=launches))
            del state
            free_graphs()
    for randomize in ("false", "true"):
        a, b = (first_chunks[(randomize, n)] for n in ("true", "false"))
        if a.dtype != np.uint8 or a.shape != (
                CLI_DATA_INTERVAL, TRAIN_BATCH, cfg.image_size,
                cfg.image_size, cfg.in_channels) or not np.array_equal(a, b):
            raise AssertionError(f"cli: the native loader's first chunk is "
                                 f"not data_loader's (randomize {randomize})")
    if np.array_equal(first_chunks[("false", "true")],
                      first_chunks[("true", "true")]):
        raise AssertionError("cli: --randomize staged the sequential chunk")

    # --- --host_rng: 4 per-step float32 steps saved at 2, and a resume ---
    hr_flags = ("--compute_dtype", "float32", "--host_rng", "true",
                "--iterations", "4", "--log_interval", "1",
                "--save_interval", "2")
    reset_counts()
    _, straight_log, _ = train("host_rng", *hr_flags)
    counted("host_rng", {k: 4 * v for k, v in per_step.items()})
    reset_counts()
    _, resumed_log, out = train(
        "host_rng_resume", *hr_flags, "--model_weights",
        os.path.join(tmp, "host_rng", "model_2.bin"))
    counted("host_rng_resume", {k: 2 * v for k, v in per_step.items()})
    blobs = [ckpt_io.load(os.path.join(tmp, d, "model_4.bin"),
                          device=DEV).host_rng_state
             for d in ("host_rng", "host_rng_resume")]
    drawn = TorchRng(0)  # four steps' draws from the seed
    for _ in range(4):
        drawn.timesteps(TRAIN_BATCH, cfg.max_period)
        drawn.normal((TRAIN_BATCH, cfg.in_channels, cfg.image_size,
                      cfg.image_size))
    straight = [float(v) for _, v, _ in LOG_LINE.findall(straight_log)]
    resumed = [float(v) for _, v, _ in LOG_LINE.findall(resumed_log)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight[2:]))
    if ("loaded" not in out or len(straight) != 4 or len(resumed) != 2
            or not all(map(math.isfinite, straight))
            or not rel <= HOST_RNG_LOSS_RTOL
            or not np.array_equal(blobs[0], blobs[1])
            or not np.array_equal(blobs[0], drawn.get_state())):
        raise AssertionError(f"cli host_rng: losses {straight} / {resumed}, "
                             f"blobs equal {np.array_equal(*blobs)}")
    host_rng = dict(dtype="float32", steps="4 straight; 2 + resume to 4",
                    losses=straight, resumed_losses=resumed,
                    loss_max_rel_diff=rel, loss_rtol=HOST_RNG_LOSS_RTOL,
                    blob_words=int(blobs[0].size), blobs_equal=True,
                    blob_is_four_steps_of_draws=True)

    # --- SIGTERM and --auto_resume, in a child process on the card ---
    root = os.path.dirname(os.path.abspath(__file__))
    models = os.path.join(tmp, "preempt")
    child_log = os.path.join(tmp, "preempt.txt")
    child_argv = [sys.executable, "-m", "unet_tpu_torch.cli.train",
                  "--data_file", data, "--device", str(DEV),
                  "--batch_size", str(TRAIN_BATCH), "--compute_dtype",
                  "bfloat16", "--log_interval", "5", "--output_dir", models,
                  "--log_file", child_log]

    def child(out_name, *flags):
        # the child's output goes to a file (never a pipe nobody reads)
        with open(os.path.join(tmp, out_name), "w") as f:
            return subprocess.Popen(child_argv + list(flags), cwd=root,
                                    stdout=f, stderr=subprocess.STDOUT)

    t0 = time.perf_counter()
    proc = child("preempt.out", "--iterations", "100000",
                 "--save_interval", "0")
    try:
        deadline = time.time() + 300
        while not (os.path.exists(child_log)
                   and "step 5:" in open(child_log).read()):
            if proc.poll() is not None or time.time() > deadline:
                raise AssertionError(
                    "cli preempt: no log line: "
                    + open(os.path.join(tmp, "preempt.out")).read()[-2000:])
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    preempt_log = open(child_log).read()
    caught = re.search(r"caught signal 15 at step (\d+)", preempt_log)
    stopped = int(caught.group(1)) if caught else -1
    if (code != 0 or not caught
            or sorted(os.listdir(models)) != [f"model_{stopped}.bin"]):
        raise AssertionError(f"cli preempt: exit {code}, {preempt_log[-500:]}"
                             f", files {sorted(os.listdir(models))}")
    if ckpt_io.load(os.path.join(models, f"model_{stopped}.bin"),
                    device=DEV).step != stopped:
        raise AssertionError("cli preempt: the checkpoint's step")
    preempt_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = child("resume.out", "--iterations", str(stopped + 10),
                 "--save_interval", "5", "--auto_resume", "true")
    try:
        code = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    resume_out = open(os.path.join(tmp, "resume.out")).read()
    resume_log = open(child_log).read()
    path = os.path.join(models, f"model_{stopped}.bin")
    if (code != 0 or f"auto-resume: {path}" not in resume_out
            or f"(step {stopped})" not in resume_out
            or f"step {stopped + 10}: loss" not in resume_log
            or not os.path.exists(os.path.join(
                models, f"model_{stopped + 10}.bin"))):
        raise AssertionError(f"cli auto_resume: exit {code}, "
                             f"{resume_out[-1500:]}")
    preempt = dict(signal="SIGTERM", stopped_at=stopped, exit_code=0,
                   files_after_signal=[f"model_{stopped}.bin"],
                   resumed_to=stopped + 10, seconds=preempt_seconds,
                   resume_seconds=time.perf_counter() - t0,
                   logged=[line for line in preempt_log.splitlines()
                           if "caught signal" in line])

    # --- class-conditional training, then a CFG request from it ---
    num_classes = 10
    tc = TrainConfig(batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                     label_dropout=0.1)
    state = trainer.init_state(unet.init(
        cfg, num_classes, generator=torch.Generator().manual_seed(5),
        device=DEV), seed=5)
    diffusion = GaussianDiffusion.create(
        named_beta_schedule("linear", cfg.max_period), device=DEV)
    train_step, _ = trainer.make_train_step(cfg, tc, diffusion, DEV)
    rng = np.random.default_rng(5)
    batches = rng.uniform(-1, 1, (3, TRAIN_BATCH, cfg.image_size,
                                  cfg.image_size, cfg.in_channels)
                          ).astype(np.float32)
    labels = rng.integers(0, num_classes, (3, TRAIN_BATCH)).astype(np.int32)
    reset_counts()
    losses = []
    for batch, y in zip(batches, labels):
        state, loss = train_step(state, batch, y)
        losses.append(loss)
    losses = torch.stack(losses).tolist()
    counted("class_cond", {k: 3 * v for k, v in per_step.items()})
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"cli class_cond: losses {losses}")
    cond = os.path.join(tmp, "cond.bin")
    ckpt_io.save(cond, trainer.to_checkpoint(state, cfg,
                                             batch_size=TRAIN_BATCH))
    del state
    reset_counts()
    t0 = time.perf_counter()
    images = generate.run(generate.parse_args(
        ["--model_filename", cond, "--device", "cuda", "--sampler", "ddim",
         "--ddim_steps", "10", "--batch_size", "4", "--compute_dtype",
         "bfloat16", "--class_label", "3", "--guidance_scale", "3.0"]))
    cfg_seconds = time.perf_counter() - t0
    counted("class_cond cfg_ddim10", per_request)
    if images.shape != (4, cfg.image_size, cfg.image_size, cfg.out_channels):
        raise AssertionError(f"cli class_cond: images {images.shape}")
    class_cond = dict(num_classes=num_classes, label_dropout=0.1,
                      batch=TRAIN_BATCH, steps=3, losses=losses,
                      request="cfg_ddim10_b4_bf16 label 3 guidance 3.0",
                      request_seconds=cfg_seconds,
                      pixel_mean=float(images.mean()),
                      data_dir="not run on the card (no Pillow there)")

    # --- a .pt state_dict served as the .bin of the same weights ---
    model = unet.init(cfg, generator=torch.Generator().manual_seed(6),
                      device=DEV)
    files = {"pt": os.path.join(tmp, "weights.pt"),
             "bin": os.path.join(tmp, "weights.bin")}
    torch.save(torch_state_dict(model, cfg), files["pt"])
    ckpt_io.save(files["bin"], ckpt_io.Checkpoint(params=model, cfg=cfg,
                                                  batch_size=4))
    del model
    served, seconds = {}, {}
    for kind, path in files.items():
        reset_counts()
        t0 = time.perf_counter()
        served[kind] = generate.run(generate.parse_args(
            ["--model_filename", path, "--device", "cuda", "--sampler",
             "ddim", "--ddim_steps", "10", "--batch_size", "4",
             "--compute_dtype", "bfloat16", "--seed", "7"]))
        seconds[kind] = time.perf_counter() - t0
        counted(f"serve {kind}", per_request)
    if not np.array_equal(served["pt"], served["bin"]):
        raise AssertionError("cli: the .pt served other images than the .bin")
    pt = dict(request="ddim10_b4_bf16", images_equal_to_bin=True,
              seconds=seconds, pixel_mean=float(served["pt"].mean()))
    free_graphs()
    return dict(data_path=data_runs, first_chunks_byte_equal=True,
                host_rng=host_rng, preempt=preempt, class_cond=class_cond,
                torch_pt=pt)


# The steps of the bit-for-bit comparison of the `parallel` phase: (name,
# compute type, steps).
PARALLEL_BITS = (("bf16", "bfloat16", 3), ("f32", "float32", 2))
PARALLEL_CLI_STEPS = 20


def drive_parallel(tmp, totals, step_ms):
    """The data-parallel tier on the card, `UnetConfig()` at B=32 a rank,
    over a process group of one rank (NCCL; the machine has one card):

    * the DP and the FSDP step of `make_parallel_train_step`, captured with
      their collectives, against the one-device flat step
      (`make_flat_multi_step`) from the same model, seed and uint8 batches:
      the losses, parameters and moments must be the same bits after 3
      bfloat16 steps and after 2 float32 steps (cuDNN held to its
      deterministic algorithms on both sides, since its convolution
      backward does not otherwise repeat its bits); each step's device time
      from its graph's replays;
    * a DDIM-10 B=8 bfloat16 request through `make_parallel_sampler`
      (gathered) against `ddim_sample` from the same generator: the same
      bits;
    * `cli.train` with `--num_devices 0` as the one rank of a
      `--coordinator_address` group, 20 chunked bfloat16 steps with the
      EMA and rank 0's checkpoint at step 20, beside the same run on the
      one-device path: ms/step and the idle share of each (device ms of
      the step's replay over ms/step), their logged losses.
    Launch counts are held exactly against launches per step (or per model
    call) times the steps, and added to `totals`."""
    cfg = UnetConfig()
    per_step = launches_per_step(cfg, False, 1)
    gn_per_fwd, attn_per_fwd = launches_per_forward(cfg)
    diffusion = GaussianDiffusion.create(
        named_beta_schedule("linear", cfg.max_period), device=DEV)
    shape = (TRAIN_BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)
    gen = torch.Generator(device=DEV).manual_seed(7)
    pixels = torch.randint(0, 256, (3,) + shape, generator=gen, device=DEV,
                           dtype=torch.uint8)
    out = {}

    def counted(name, want):
        torch.cuda.synchronize()
        got = counts()
        if got != want:
            raise AssertionError(f"parallel {name}: launches {got}, want "
                                 f"{want}")
        for k, v in got.items():
            totals[k] += v
        return got

    def model():
        return unet.init(cfg, generator=torch.Generator().manual_seed(4),
                         device=DEV)

    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0, DEV,
                           timeout_s=120)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = pmesh.make_mesh()
        steps_record = {}
        for name, dtype, steps in PARALLEL_BITS:
            tc = TrainConfig(batch_size=TRAIN_BATCH, lr=1e-3,
                             compute_dtype=dtype)
            net = model()
            flat, unravel = trainer.flatten_state(net, seed=6)
            one = trainer.make_flat_multi_step(cfg, tc, unravel, diffusion,
                                               DEV)
            batches = pixels[:steps].float() / 127.5 - 1.0
            reset_counts()
            want = one(flat, batches)[1].tolist()
            want_launches = {k: steps * v for k, v in per_step.items()}
            counted(f"one-device {name}", want_launches)
            record = dict(steps=steps, one_device_losses=want)
            for mode in ("dp", "fsdp"):
                step = pmesh.make_parallel_train_step(
                    cfg, tc, mesh, diffusion, fsdp=mode == "fsdp",
                    example_params=net)
                state = pmesh.init_state(unravel, net, mesh,
                                         fsdp=mode == "fsdp", seed=6)
                reset_counts()
                got = step(state, batches)[1].tolist()
                counted(f"{mode} {name}", want_launches)
                pairs = ((state.flat, flat.flat), (state.m, flat.m),
                         (state.v, flat.v))
                diff = max((a.detach() - b.detach()).abs().max().item()
                           for a, b in pairs)
                if got != want or diff != 0.0:
                    raise AssertionError(
                        f"parallel {mode} {name}: losses {got} against the "
                        f"one-device {want}, state max abs diff {diff}")
                record[mode] = dict(losses=got, bits_equal=True,
                                    replay_ms=replay_ms(step.graph),
                                    held=step.graph.held,
                                    resident=dict(
                                        flat=state.flat.numel(),
                                        master=state.master.numel(),
                                        m=state.m.numel()))
                del step, state
                free_graphs()
            # (the replays step the state on: timed after the comparisons)
            record["one_device_replay_ms"] = replay_ms(one.graph)
            steps_record[name] = record
            del one, flat, unravel, net
            free_graphs()
        out["steps_against_one_device"] = steps_record

        # the device time of the CLI's step below (DP, bf16 + EMA)
        tc = TrainConfig(batch_size=TRAIN_BATCH, **TRAIN_CONFIGS["bf16"])
        net = model()
        step = pmesh.make_parallel_train_step(cfg, tc, mesh, diffusion,
                                              example_params=net,
                                              input_u8=True)
        state = pmesh.init_state(trainer.Unravel(net), net, mesh,
                                 ema_rate=tc.ema_rate)
        reset_counts()
        step(state, pixels)
        counted("dp bf16 + EMA", {k: 3 * v for k, v in per_step.items()})
        dp_ema_ms = replay_ms(step.graph)
        del step, state
        free_graphs()

        # a DDIM-10 request, parallel against one device
        chains = {}
        for kind in ("one_device", "parallel"):
            reset_counts()
            t0 = time.perf_counter()
            g = torch.Generator(device=DEV).manual_seed(11)
            if kind == "one_device":
                images = ddim_sample(net, cfg, diffusion, g, num_steps=10,
                                     batch_size=8,
                                     compute_dtype=torch.bfloat16)
            else:
                images = make_parallel_sampler(
                    cfg, diffusion, mesh, batch_size=8,
                    compute_dtype=torch.bfloat16, sampler="ddim",
                    num_steps=10, gather=True)(net, g)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counted(f"ddim10 {kind}", dict(
                gn_act_fwd=10 * gn_per_fwd, gn_act_bwd=0,
                qkv_attention_fwd=10 * attn_per_fwd, qkv_attention_bwd=0,
                conv3x3_hwbc=0, **NO_SPLIT))
            chains[kind] = (images, seconds)
            free_graphs()
        if not torch.equal(chains["parallel"][0], chains["one_device"][0]):
            raise AssertionError("parallel DDIM-10: not the one-device bits")
        out["ddim10_b8_bf16"] = dict(
            bits_equal=True, shape=list(chains["parallel"][0].shape),
            seconds={k: v[1] for k, v in chains.items()})
        del net
    finally:
        torch.backends.cudnn.deterministic = deterministic
        distributed.shutdown()

    # the CLI: one rank of a --coordinator_address group, and one device
    rng = np.random.default_rng(4)
    data = os.path.join(tmp, "train.bin")
    write_bin(data, rng.integers(0, 256, (256, cfg.in_channels,
                                          cfg.image_size, cfg.image_size),
                                 dtype=np.uint8).astype(np.float32)
              / 127.5 - 1.0)
    runs = {}
    for kind in ("parallel", "one_device"):
        flags = ["--data_file", data, "--device", str(DEV), "--batch_size",
                 str(TRAIN_BATCH), "--compute_dtype", "bfloat16",
                 "--ema_rate", "0.999", "--iterations",
                 str(PARALLEL_CLI_STEPS), "--log_interval", "10",
                 "--save_interval", str(PARALLEL_CLI_STEPS), "--output_dir",
                 os.path.join(tmp, kind), "--log_file",
                 os.path.join(tmp, f"{kind}.txt")]
        if kind == "parallel":
            flags += ["--num_devices", "0", "--coordinator_address",
                      f"localhost:{distributed.free_port()}",
                      "--num_processes", "1", "--process_id", "0"]
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            state = train_cli.main(flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = counted(f"cli {kind}", {k: PARALLEL_CLI_STEPS * v
                                      for k, v in per_step.items()})
        with open(os.path.join(tmp, f"{kind}.txt")) as f:
            log = f.read()
        lines = LOG_LINE.findall(log)
        path = os.path.join(tmp, kind, f"model_{PARALLEL_CLI_STEPS}.bin")
        if ([int(s) for s, _, _ in lines] != [10, 20] or state.step != 20
                or ckpt_io.load(path, device=DEV).step != 20
                or os.listdir(os.path.join(tmp, kind))
                != [f"model_{PARALLEL_CLI_STEPS}.bin"]
                or "H2D encoding: uint8" not in log):
            raise AssertionError(f"parallel cli {kind}: {log}")
        if kind == "parallel" and "data parallel: 1 rank(s)" not in (
                printed.getvalue()):
            raise AssertionError("parallel cli: not the parallel path")
        ms = float(lines[-1][2])
        device_ms = dp_ema_ms if kind == "parallel" else step_ms["bf16"]
        runs[kind] = dict(
            logged_losses=[float(v) for _, v, _ in lines], ms_per_step=ms,
            images_per_s=TRAIN_BATCH / ms * 1e3, device_ms_per_step=device_ms,
            idle_share=1.0 - device_ms / ms, seconds=seconds, launches=got,
            peak_mib=trainer.device_peak_memory_mib(DEV))
        del state
        free_graphs()
    rel = max(abs(a - b) / abs(b) for a, b in zip(
        runs["parallel"]["logged_losses"], runs["one_device"]["logged_losses"]))
    if not rel <= BF16_LOSS_RTOL:
        raise AssertionError(f"parallel cli: losses {runs} part by {rel}")
    out["cli_bf16_ema"] = dict(runs=runs, loss_max_rel_diff=rel,
                               loss_rtol=BF16_LOSS_RTOL)
    return out


# The `tensor_parallel` phase: the steps of each comparison (name, compute
# type, steps), as the `parallel` phase's, at lr 1e-4.  The two-rank run on
# the card (gloo, which passes CUDA tensors through the host: NCCL refuses
# two ranks on one card) runs under the CLI's own settings (cuDNN not held
# deterministic) and is held to the one-device step within tolerances, not
# bits:
# * the gradient of the first step's batch at the initial parameters,
#   gathered into the whole vector, leaf by leaf (|g - g1| / |g1|, the
#   worst leaf): float32 within TP_F32_GRAD_RTOL of the one-device float32
#   gradient; bfloat16 against the one-device float32 gradient within
#   TP_BF16_GRAD_FACTOR times the one-device bfloat16 gradient's own error
#   there (the split rounds each rank's partial product of conv2 and proj
#   to bfloat16 and their sum once more).  A wrong leaf is off by about
#   its own size;
# * the losses of the steps: float32 within 1e-5 relative; bfloat16 against
#   the one-device bfloat16 steps within the one-device bfloat16 steps'
#   own distance from the float32 ones (their common steps, the same
#   batches and draws);
# * the parameters after the steps only within 2.02 lr x steps: an AdamW
#   step moves a parameter by about lr whatever its gradient, so where two
#   runs' gradients differ in sign they part by up to 2.02 lr a step; this
#   catches a diverging run, not a wrong gradient (the gradient check does).
# Readings on an H100 (PERF.md): the float32 worst leaf 6.8e-6; the
# bfloat16 one 0.032 against the one-device bfloat16 gradient's 0.032; the
# bfloat16 losses 4.2e-5 against the control's 1.4e-4.
TP_LR = 1e-4
TP_F32_LOSS_RTOL = 1e-5
TP_F32_GRAD_RTOL = 1e-4
TP_BF16_GRAD_FACTOR = 1.5
TP_RANKS = 2
TP_RANK_LIMIT_S = 300
# The model axis phases' entries: PARALLEL_BITS in pixel space, then one
# float32 entry with level 0 in patch space (mode "on" around it alone).
S2D_BITS = ("s2d_f32", "float32", 2)
MODEL_AXIS_BITS = PARALLEL_BITS + (S2D_BITS,)


def model_axis_bits():
    """MODEL_AXIS_BITS, the loop's body for each entry run in its space:
    patch space for the s2d entry (the mode restored when the body ends),
    the caller's (pixel space) for the others."""
    for name, dtype, steps in MODEL_AXIS_BITS:
        with (s2d_mode("on") if name == S2D_BITS[0]
              else contextlib.nullcontext()):
            yield name, dtype, steps


def space_f32_grad(one_grads, name):
    """The one-device float32 gradient of the space (pixel or patch) of the
    entry `name`: the yardstick of its gradient at model axis 2."""
    return one_grads[S2D_BITS[0] if name == S2D_BITS[0] else "f32"][1]


def ranks_seen(ranks, names):
    """The kernel inputs the ranks noted for the entries `names` (each
    rank's JSON `seen`), as one `new_seen()`."""
    seen = new_seen()
    for rank in ranks:
        for name in names:
            for k, v in rank["seen"][name].items():
                seen[k] |= {tuple(tuple(a) if isinstance(a, list) else a
                                  for a in entry) for entry in v}
    return seen


def tp_config(dtype: str) -> TrainConfig:
    return TrainConfig(batch_size=TRAIN_BATCH, lr=TP_LR, compute_dtype=dtype)


def tp_model(cfg):
    return unet.init(cfg, generator=torch.Generator().manual_seed(4),
                     device=DEV)


def tp_batches(cfg, steps):
    """The seeded float32 batches of the phase's steps, on the card."""
    shape = (TRAIN_BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)
    gen = torch.Generator(device=DEV).manual_seed(7)
    pixels = torch.randint(0, 256, (3,) + shape, generator=gen, device=DEV,
                           dtype=torch.uint8)
    return pixels[:steps].float() / 127.5 - 1.0


def tp_grad_inputs(cfg):
    """The batch (the phase's first), t and noise of the gradient check,
    seeded, on the card."""
    gen = torch.Generator(device=DEV).manual_seed(8)
    shape = (TRAIN_BATCH, cfg.image_size, cfg.image_size, cfg.in_channels)
    t = torch.randint(0, cfg.max_period, (TRAIN_BATCH,), generator=gen,
                      device=DEV)
    return tp_batches(cfg, 1)[0], t, torch.randn(shape, generator=gen,
                                                 device=DEV)


def leaf_rel_err(got, want, unravel) -> float:
    """The worst leaf's |got - want| / |want| (L2 norms) of two whole
    vectors laid out by `unravel`."""
    got, want = unravel(got), unravel(want)
    return max(((got[n] - want[n]).norm()
                / want[n].norm().clamp_min(1e-30)).item()
               for n in unravel.names)


def tensor_parallel_rank(spec_path: str, rank: int) -> None:
    """One rank of the phase's two-rank run (a child process of
    `drive_tensor_parallel`): a process group over gloo on card 0, the mesh
    data 1 x model 2, and for each of `MODEL_AXIS_BITS` (the last in patch
    space) the TP step's loss and gradient at the initial parameters
    (`tp_grad_inputs`, gathered into the whole vector) and then the eager
    TP steps from the phase's model, seed and batches, kernel inputs
    recorded by entry; cuDNN as the CLI leaves it.  Writes the losses, the
    launch counts, the shapes and the seconds to `rank<r>.json`, the rank's
    vector to `<name><r>.npy` and (rank 0) the whole gradient to
    `<name>_grad.npy` beside the spec."""
    with open(spec_path) as f:
        spec = json.load(f)
    out_dir = os.path.dirname(spec_path)
    functional.set_f32_precision("highest")
    _build.load()
    distributed.initialize(spec["address"], TP_RANKS, rank, DEV,
                           timeout_s=TP_RANK_LIMIT_S, process_backend="gloo")
    try:
        mesh = pmesh.make_mesh(model=TP_RANKS)
        cfg = UnetConfig()
        diffusion = GaussianDiffusion.create(
            named_beta_schedule("linear", cfg.max_period), device=DEV)
        record, seen = {}, {}
        for name, dtype, steps in model_axis_bits():
            net = tp_model(cfg)
            tc = tp_config(dtype)
            step = pmesh.make_parallel_train_step(cfg, tc, mesh, diffusion,
                                                  tp=True, example_params=net)
            state = pmesh.init_state(trainer.Unravel(net), net, mesh, tp=True,
                                     seed=6)
            batch, t, noise = tp_grad_inputs(cfg)
            grad_loss, grad = step.value_and_grad(state, batch[mesh.rows], t,
                                                  noise)
            grad = state.layout.gather(grad)
            if rank == 0:
                np.save(os.path.join(out_dir, f"{name}_grad.npy"),
                        grad.cpu().numpy())
            # the same gradient before the step's reductions, at the leaves
            # the rank keeps whole (what each rank computes for them alone)
            _, _, raw_fn = trainer._setup(cfg, tc, diffusion, DEV,
                                          apply=state.layout.local.apply,
                                          leaves=lambda vec: [vec])
            _, (raw,) = raw_fn(state.flat, batch[mesh.rows], t, noise)
            np.save(os.path.join(out_dir, f"{name}_kept_raw{rank}.npy"),
                    raw[state.layout.kept().to(DEV)].cpu().numpy())
            del grad, raw, raw_fn, batch, t, noise
            batches = tp_batches(cfg, steps)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seen[name] = new_seen()
            with eager_steps(), recording(seen[name]):
                losses = step(state, batches)[1].tolist()
            torch.cuda.synchronize()
            record[name] = dict(
                losses=losses, grad_loss=grad_loss.item(), launches=counts(),
                seconds_per_step=(time.perf_counter() - t0) / steps,
                local_size=state.layout.size)
            np.save(os.path.join(out_dir, f"{name}{rank}.npy"),
                    state.flat.detach().cpu().numpy())
            del step, state, net
            free_graphs()
        record["seen"] = {name: {k: sorted(v) for k, v in entry.items()}
                          for name, entry in seen.items()}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        distributed.shutdown()


def drive_tensor_parallel(tmp, totals, gen):
    """Megatron TP and the 2-D tp x fsdp split (`parallel/tensor.py`,
    `parallel/mesh.py`) on the card, `UnetConfig()` at B=32:

    * model axis 1 over NCCL (one rank): the captured TP and tp x fsdp
      steps of `make_parallel_train_step` against the one-device flat step
      (`make_flat_multi_step`) from the same model, seed and batches: the
      same bits after 3 bfloat16 and 2 float32 steps (cuDNN deterministic
      on both sides), and each step's device time from its graph's replays;
    * model axis 2 on the one card: two processes over gloo
      (`tensor_parallel_rank`) with cuDNN as the CLI leaves it, the TP
      gradient at the initial parameters and then 3 eager bfloat16 and 2
      float32 TP steps at the global batch 32, against the one-device
      gradient and steps (their pieces joined into the whole vector):
      gradients, losses and parameters within the tolerances above, and
      the leaves each rank keeps whole bit-equal over the two; every kernel
      input the split model gave the kernels held against its plain
      version (`check_seen_shapes`);
    * both again for `S2D_BITS`, 2 float32 steps with level 0 in patch
      space, against the one-device flat s2d step and gradient.
    Launch counts are held exactly (per rank: a split block launches the
    kernels of a whole one, in either space) and added to `totals`.
    Returns the phase's record and the one-device references (losses and
    state after the steps, gradients, the bf16 control) that the
    `spatial_parallel` phase holds its steps against too."""
    cfg = UnetConfig()
    per_step = launches_per_step(cfg, False, 1)
    diffusion = GaussianDiffusion.create(
        named_beta_schedule("linear", cfg.max_period), device=DEV)
    out = {}

    def counted(name, want, got=None):
        torch.cuda.synchronize()
        got = counts() if got is None else got
        if got != want:
            raise AssertionError(f"tensor_parallel {name}: launches {got}, "
                                 f"want {want}")
        for k, v in got.items():
            totals[k] += v
        return got

    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0, DEV,
                           timeout_s=120)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    one_device, one_grads = {}, {}
    try:
        mesh = pmesh.make_mesh(model=1)
        steps_record = {}
        for name, dtype, steps in model_axis_bits():
            tc = tp_config(dtype)
            net = tp_model(cfg)
            flat, unravel = trainer.flatten_state(net, seed=6)
            _, _, grad_fn = trainer._setup(cfg, tc, diffusion, DEV,
                                           apply=unravel.apply,
                                           leaves=lambda vec: [vec])
            grad_loss, (grad,) = grad_fn(flat.flat, *tp_grad_inputs(cfg))
            one_grads[name] = (grad_loss.item(), grad.cpu())
            del grad, grad_fn
            one = trainer.make_flat_multi_step(cfg, tc, unravel, diffusion,
                                               DEV)
            batches = tp_batches(cfg, steps)
            reset_counts()
            want = one(flat, batches)[1].tolist()
            want_launches = {k: steps * v for k, v in per_step.items()}
            counted(f"one-device {name}", want_launches)
            one_device[name] = (want, flat.flat.detach().cpu(),
                                flat.m.cpu(), flat.v.cpu())
            record = dict(steps=steps, one_device_losses=want)
            for mode in ("tp", "tp_fsdp"):
                fsdp = mode == "tp_fsdp"
                step = pmesh.make_parallel_train_step(
                    cfg, tc, mesh, diffusion, tp=True, fsdp=fsdp,
                    example_params=net)
                state = pmesh.init_state(unravel, net, mesh, tp=True,
                                         fsdp=fsdp, seed=6)
                reset_counts()
                got = step(state, batches)[1].tolist()
                counted(f"{mode} {name}", want_launches)
                pairs = ((state.flat, flat.flat), (state.m, flat.m),
                         (state.v, flat.v))
                diff = max((a.detach() - b.detach()).abs().max().item()
                           for a, b in pairs)
                if got != want or diff != 0.0:
                    raise AssertionError(
                        f"tensor_parallel {mode} {name} at model axis 1: "
                        f"losses {got} against the one-device {want}, "
                        f"state max abs diff {diff}")
                record[mode] = dict(
                    losses=got, bits_equal=True,
                    replay_ms=replay_ms(step.graph), held=step.graph.held,
                    split_leaves=len(state.layout.splits),
                    shard_fraction=pmesh.shard_fraction(state.placement,
                                                        state.layout))
                del step, state
                free_graphs()
            record["one_device_replay_ms"] = replay_ms(one.graph)
            steps_record[name] = record
            del one, flat, unravel, net
            free_graphs()
        out["model_axis_1_nccl"] = steps_record
    finally:
        torch.backends.cudnn.deterministic = deterministic
        distributed.shutdown()

    # model axis 2: two gloo ranks on card 0
    spec = os.path.join(tmp, "tp_spec.json")
    with open(spec, "w") as f:
        json.dump(dict(address=f"localhost:{distributed.free_port()}"), f)
    logs = [os.path.join(tmp, f"tp_rank{r}.log") for r in range(TP_RANKS)]
    procs = []
    t0 = time.perf_counter()
    try:
        for r, log in enumerate(logs):
            with open(log, "wb") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--tensor_parallel_rank", spec, str(r)],
                    stdout=f, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL))
        codes = [p.wait(timeout=TP_RANK_LIMIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0] * TP_RANKS:
        text = "".join(open(log, errors="replace").read()[-3000:]
                       for log in logs)
        raise AssertionError(f"tensor_parallel: the ranks exited {codes}:\n"
                             f"{text}")
    ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
             for r in range(TP_RANKS)]
    net = tp_model(cfg).cpu()
    layouts = [pmesh.Layout(net, tensor.Shard(TP_RANKS, m))
               for m in range(TP_RANKS)]
    axis2 = dict(backend="gloo (CUDA tensors through the host)",
                 cudnn_deterministic=False,
                 seconds=time.perf_counter() - t0)
    whole = layouts[0].whole
    f32_grad = one_grads["f32"][1]
    # the one-device bfloat16 run's own distance from the float32 one: the
    # gradient (worst leaf) and the losses of the steps both runs take
    control = dict(
        grad=leaf_rel_err(one_grads["bf16"][1], f32_grad, whole),
        losses=max(abs(a - b) / abs(b) for a, b in zip(
            one_device["bf16"][0], one_device["f32"][0])))
    axis2["bf16_against_f32_one_device"] = control
    for name, dtype, steps in MODEL_AXIS_BITS:
        want, want_flat = one_device[name][:2]
        got = ranks[0][name]["losses"]
        if any(rank[name]["losses"] != got for rank in ranks):
            raise AssertionError(f"tensor_parallel {name}: the ranks' "
                                 f"losses differ: {ranks}")
        f32_grad = space_f32_grad(one_grads, name)
        grad = torch.from_numpy(np.load(os.path.join(tmp, f"{name}_grad.npy")))
        if dtype == "float32":
            rtol, grad_rtol = TP_F32_LOSS_RTOL, TP_F32_GRAD_RTOL
        else:
            rtol = control["losses"]
            grad_rtol = TP_BF16_GRAD_FACTOR * control["grad"]
        grad_err = leaf_rel_err(grad, f32_grad, whole)
        grad_err_same_type = leaf_rel_err(grad, one_grads[name][1], whole)
        grad_loss_rel = abs(ranks[0][name]["grad_loss"] - one_grads[name][0]
                            ) / abs(one_grads[name][0])
        if not (grad_err <= grad_rtol and grad_loss_rel <= rtol):
            raise AssertionError(
                f"tensor_parallel {name} at model axis 2: gradient worst "
                f"leaf {grad_err} from the one-device float32 gradient "
                f"(bar {grad_rtol}), loss {grad_loss_rel} from the "
                f"one-device loss (bar {rtol})")
        del grad
        raw = [np.load(os.path.join(tmp, f"{name}_kept_raw{r}.npy"))
               for r in range(TP_RANKS)]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        vecs = [torch.from_numpy(np.load(os.path.join(tmp, f"{name}{r}.npy")))
                for r in range(TP_RANKS)]
        param_diff = (layouts[0].join(vecs) - want_flat).abs().max().item()
        atol = 2.02 * TP_LR * steps
        if not (rel <= rtol and param_diff <= atol):
            raise AssertionError(
                f"tensor_parallel {name} at model axis 2: losses {got} "
                f"against the one-device {want} (max rel {rel}, rtol "
                f"{rtol}), parameters max abs diff {param_diff} (atol "
                f"{atol})")
        views = [layout.local(vec) for layout, vec in zip(layouts, vecs)]
        kept = [n for n in layouts[0].whole.names
                if n not in layouts[0].splits]
        if not all(torch.equal(views[1][n], views[0][n]) for n in kept):
            raise AssertionError(f"tensor_parallel {name}: a leaf kept whole "
                                 "differs between the model ranks")
        for r, rank in enumerate(ranks):
            counted(f"model axis 2 {name} rank {r}",
                    {k: steps * v for k, v in per_step.items()},
                    rank[name]["launches"])
        axis2[name] = dict(
            steps=steps, losses=got, one_device_losses=want,
            loss_max_rel_diff=rel, loss_rtol=rtol,
            param_max_abs_diff=param_diff, param_atol=atol,
            grad_leaf_rel_err=grad_err, grad_leaf_rtol=grad_rtol,
            grad_leaf_rel_err_against_same_type=grad_err_same_type,
            grad_loss_rel_err=grad_loss_rel,
            kept_raw_grad_bits_equal=bool(np.array_equal(raw[0], raw[1])),
            kept_raw_grad_max_abs_diff=float(np.abs(raw[0] - raw[1]).max()),
            kept_whole_bit_equal=True,
            local_sizes=[rank[name]["local_size"] for rank in ranks],
            whole_size=sum(whole.sizes),
            seconds_per_step=[rank[name]["seconds_per_step"]
                              for rank in ranks])
    # the first ResBlock's gn2 on its half of the channels (in patch space
    # through the free view), and every attention layer on half its heads
    # (UnetConfig(): (32,64,64,32) in 16 groups; (32,256,288) and
    # (32,64,384), 3 and 4 heads), in either space
    width = cfg.model_channels * cfg.channel_mult[0] // TP_RANKS
    gn2 = ((TRAIN_BATCH, cfg.image_size, cfg.image_size, width),
           cfg.gn_num_groups // TP_RANKS)
    heads = {w // cfg.num_head_channels // TP_RANKS
             for w in unet.attention_widths(cfg)}
    for names in (["bf16", "f32"], [S2D_BITS[0]]):
        seen = ranks_seen(ranks, names)
        if (gn2 not in {(e[0], e[1]) for e in seen["gn_fwd"]}
                or heads != {e[1] for e in seen["attn_fwd"]}):
            raise AssertionError(f"tensor_parallel {names}: the split model "
                                 f"handed the kernels {seen}, not {gn2} and "
                                 f"{heads} heads")
    axis2["s2d_kernel_inputs"] = {k: sorted(v) for k, v in seen.items()}
    axis2["kernel_inputs_of_the_steps"] = check_seen_shapes(
        ranks_seen(ranks, [n for n, _, _ in MODEL_AXIS_BITS]), gen)
    out["model_axis_2_one_card"] = axis2
    return out, dict(one_device=one_device, one_grads=one_grads,
                     control=control)


# The `spatial_parallel` phase.  (a) The split GroupNorm's four kernels
# alone at the half-height inputs of the default model's GroupNorms at two
# model ranks (B=32): the first and last level's, and two between; each
# against its plain version, again for the same bits, and the two virtual
# ranks' pipeline (gn_stats on each half, gn_apply with both halves'
# statistics; gn_bwd_sums, gn_bwd_dx) against K4 and K5 on the whole
# tensor within their bars.  Timed with silu.  The library calls beside
# them: `torch.var_mean` over the groups for gn_stats (the same statistics,
# M2 / n); for gn_apply, `F.group_norm` + `F.silu` on the rank's rows, and
# for gn_bwd_dx autograd through them (the local GroupNorm each pair of
# kernels stands in for, as K4's and K5's yardsticks); none for
# gn_bwd_sums.
SPLIT_SHAPES = [(32, 32, 64, 64), (32, 16, 32, 128), (32, 8, 16, 192),
                (32, 4, 8, 256)]
SPLIT_RANKS = 2
SPLIT_HEADLINE = dict(shape=[32, 32, 64, 64], dtype="torch.bfloat16",
                      act="silu")
# (c) Model axis 2 on the card: two processes of this script
# (`--spatial_parallel_rank`) over gloo, eager, cuDNN as the CLI leaves it,
# held to the one-device step (the `tensor_parallel` phase's references)
# with the bars of TP: the gradient at the initial parameters leaf by leaf,
# f32 within TP_F32_GRAD_RTOL of the one-device f32 gradient, bf16 within
# TP_BF16_GRAD_FACTOR times the one-device bf16 gradient's own error; the
# losses f32 within TP_F32_LOSS_RTOL, bf16 within the one-device bf16
# steps' distance from the f32 ones.
SP_RANKS = 2
SP_RANK_LIMIT_S = 300


def split_gn_case(shape, groups, shards, dtype, act, gen, timed=False):
    """The split GroupNorm's four kernels at a rank's input `shape` of a
    tensor split over `shards` ranks (see the phase's note): each against
    its plain version, rerun for the same bits, and the ranks' pipeline
    against K4 and K5 on the whole tensor.  Returns one case per kernel
    (`timed`: with their times and bounds)."""
    B, h, W, C = shape
    G, eps = groups, 1e-5
    whole, gamma, beta = gn_inputs((B, shards * h, W, C), dtype, gen)
    dy_whole = torch.randn(whole.shape, generator=gen, device=DEV).to(dtype)
    xs = [t.contiguous() for t in whole.chunk(shards, dim=1)]
    dys = [t.contiguous() for t in dy_whole.chunk(shards, dim=1)]
    what = f"{shape} over {shards} G={G} {dtype} act={act}"
    errs = {}

    def sums_err(name, pairs):
        """The worst error of float32 sums (the statistics, the backward's
        partials) within `partial_tol`, and the same over their largest
        value."""
        errs[name] = max(compare(got, want, partial_tol(want),
                                 f"{name} {what}") for got, want in pairs)
        largest[name] = max(want.abs().max().item() for _, want in pairs)

    largest = {}
    stats = [gn_stats(x, G) for x in xs]
    same_bits((stats[0],), (gn_stats(xs[0], G),), "gn_stats " + what)
    plain = [gn_stats_plain(x, G) for x in xs]
    for got, want in zip(stats, plain):  # the mean at the statistics' bar
        compare(got[..., 0], want[..., 0], STAT_TOL, "gn_stats mean " + what)
    sums_err("gn_stats", [(got[..., 1], want[..., 1])  # M2, a float32 sum
                          for got, want in zip(stats, plain)])
    gathered = torch.stack(stats)

    fwd = [gn_apply(x, gamma, beta, gathered, G, eps, act) for x in xs]
    same_bits(fwd[0], gn_apply(xs[0], gamma, beta, gathered, G, eps, act),
              "gn_apply " + what)
    for got in fwd[1:]:  # every rank merged the same statistics
        same_bits(got[1:], fwd[0][1:], "gn_apply's statistics " + what)
    err = 0.0
    for x, got in zip(xs, fwd):
        want = gn_apply_plain(x, gamma, beta, gathered, G, eps, act)
        err = max(err, compare(got[0], want[0], GN_TOL[dtype],
                               "gn_apply " + what))
        compare(got[1], want[1], STAT_TOL, "gn_apply mean " + what)
        compare(got[2], want[2], STAT_TOL, "gn_apply rstd " + what)
    errs["gn_apply"] = err
    y4, mean4, rstd4 = gn_act_fwd(whole, gamma, beta, G, eps, act)
    virtual_fwd = compare(torch.cat([y for y, _, _ in fwd], dim=1), y4,
                          GN_TOL[dtype], "split forward against K4 " + what)
    compare(fwd[0][1], mean4, STAT_TOL, "split mean against K4 " + what)
    compare(fwd[0][2], rstd4, STAT_TOL, "split rstd against K4 " + what)

    _, mean, rstd = fwd[0]
    sums = [gn_bwd_sums(x, gamma, beta, mean, rstd, d, G, act)
            for x, d in zip(xs, dys)]
    same_bits((sums[0],), (gn_bwd_sums(xs[0], gamma, beta, mean, rstd, dys[0],
                                       G, act),), "gn_bwd_sums " + what)
    sums_err("gn_bwd_sums", [
        (got, gn_bwd_sums_plain(x, gamma, beta, mean, rstd, d, G, act))
        for got, x, d in zip(sums, xs, dys)])
    every = torch.stack(sums)
    dxs = [gn_bwd_dx(x, gamma, beta, mean, rstd, d, every, G, act)
           for x, d in zip(xs, dys)]
    same_bits((dxs[0],), (gn_bwd_dx(xs[0], gamma, beta, mean, rstd, dys[0],
                                    every, G, act),), "gn_bwd_dx " + what)
    errs["gn_bwd_dx"] = max(
        compare(got, gn_bwd_dx_plain(x, gamma, beta, mean, rstd, d, every, G,
                                     act), GN_TOL[dtype], "gn_bwd_dx " + what)
        for got, x, d in zip(dxs, xs, dys))
    dx5, dgamma5, dbeta5 = gn_act_bwd(whole, gamma, beta, mean, rstd,
                                      dy_whole, G, act)
    virtual_bwd = compare(torch.cat(dxs, dim=1), dx5, GN_TOL[dtype],
                          "split backward against K5 " + what)
    for got, want in ((every[:, 0].sum(0), dgamma5),
                      (every[:, 1].sum(0), dbeta5)):
        compare(got, want, partial_tol(want),
                "split partials against K5 " + what)

    base = dict(shape=list(shape), shards=shards, groups=G, dtype=str(dtype),
                act=act, virtual_against_whole_max_abs_err=dict(
                    forward_k4=virtual_fwd, backward_k5=virtual_bwd))
    out = {name: dict(base, max_abs_err=err, tol=GN_TOL[dtype])
           for name, err in errs.items()}
    for name, kernel in (("gn_stats", "stats"), ("gn_bwd_sums", "sums")):
        geo = gn_mod.split_geometry(kernel, *shape, G, dtype)  # their cut
        out[name].update(cluster=geo.cluster,
                         rows_per_block=geo.rows_per_block,
                         staged=geo.staged, streamed=geo.streamed)
    apply = gn_mod.apply_geometry(*shape, dtype)  # gn_apply's grid
    out["gn_apply"].update(blocks_per_sample=apply.chunks * apply.cols,
                           threads=apply.threads,
                           vectors_per_thread=apply.vectors_per_thread)
    for name, top in largest.items():  # float32 sums: partial_tol's bar
        out[name].update(tol="4e-6 of the largest value",
                         err_of_largest=errs[name] / top)
    # the worst error of the outputs in x's type (y, dx), as K4's and K5's
    out["max_abs_err"] = max(errs["gn_apply"], errs["gn_bwd_dx"])
    if not timed:
        return out
    x, d, item = xs[0], dys[0], xs[0].element_size()
    n, stat = x.numel(), 4 * B * G * 2
    flops = 20 if act == "silu" else 10
    stream = side_stream()
    with torch.cuda.stream(stream):
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        gl = gamma.detach().requires_grad_()
        bl = beta.detach().requires_grad_()
        yl = TF.group_norm(xl, G, gl, bl, eps)
        yl = TF.silu(yl) if act == "silu" else yl
    dyl = d.permute(0, 3, 1, 2)

    def local_gn():
        z = TF.group_norm(x.permute(0, 3, 1, 2), G, gamma, beta, eps)
        return TF.silu(z) if act == "silu" else z

    runs = {  # kernel, plain, library (and its stream), bytes, operations
        "gn_stats": (
            lambda: gn_stats(x, G), lambda: gn_stats_plain(x, G),
            lambda: torch.var_mean(x.view(B, h * W, G, C // G), dim=(1, 3),
                                   correction=0), None,
            n * item + stat, 3 * n),
        "gn_apply": (
            lambda: gn_apply(x, gamma, beta, gathered, G, eps, act),
            lambda: gn_apply_plain(x, gamma, beta, gathered, G, eps, act),
            local_gn, None,
            2 * n * item + 2 * C * item + shards * stat + 4 * 2 * B * G,
            n * (8 if act == "silu" else 4)),
        "gn_bwd_sums": (
            lambda: gn_bwd_sums(x, gamma, beta, mean, rstd, d, G, act),
            lambda: gn_bwd_sums_plain(x, gamma, beta, mean, rstd, d, G, act),
            None, None,
            2 * n * item + 2 * C * item + 4 * 2 * B * G + 4 * 2 * B * C,
            n * flops),
        "gn_bwd_dx": (
            lambda: gn_bwd_dx(x, gamma, beta, mean, rstd, d, every, G, act),
            lambda: gn_bwd_dx_plain(x, gamma, beta, mean, rstd, d, every, G,
                                    act),
            lambda: torch.autograd.grad(yl, (xl, gl, bl), dyl,
                                        retain_graph=True), stream,
            3 * n * item + 2 * C * item + 4 * 2 * B * G
            + shards * 4 * 2 * B * C, n * flops)}
    for name, (kernel, plain, library, lib_stream, nbytes, ops) in \
            runs.items():
        bound_ms, bound_by = bound(nbytes, ops, torch.float32)
        out[name].update(timings(kernel, plain, library, lib_stream),
                         bound_ms=bound_ms, bound_by=bound_by)
    del yl
    return out


def check_split_kernels(gen):
    """(a) of the `spatial_parallel` phase: {kernel: cases}."""
    cases = {name: [] for name in SPLIT_GN}
    for shape in SPLIT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for act in ("silu", "none"):
                got = split_gn_case(shape, 32, SPLIT_RANKS, dtype, act, gen,
                                    timed=act == "silu")
                for name in SPLIT_GN:
                    cases[name].append(got[name])
    return cases


def spatial_parallel_rank(spec_path: str, rank: int) -> None:
    """One rank of the `spatial_parallel` phase's two-rank run (a child
    process of `drive_spatial_parallel`): a process group over gloo on card
    0, the mesh data 1 x model 2, and for each of `MODEL_AXIS_BITS` (the
    last in patch space) the spatial step's loss and gradient at the
    initial parameters (`tp_grad_inputs`) and then the eager spatial steps
    from the phase's model, seed and batches, kernel inputs recorded by
    entry; cuDNN as the CLI leaves it.  Writes the losses, the launch counts, the shapes and the
    seconds to `rank<r>.json`, the rank's vectors to `<name><r>.npz` and
    (rank 0) the gradient to `<name>_grad.npy` beside the spec."""
    with open(spec_path) as f:
        spec = json.load(f)
    out_dir = os.path.dirname(spec_path)
    functional.set_f32_precision("highest")
    _build.load()
    distributed.initialize(spec["address"], SP_RANKS, rank, DEV,
                           timeout_s=SP_RANK_LIMIT_S, process_backend="gloo")
    try:
        mesh = pmesh.make_mesh(model=SP_RANKS)
        cfg = UnetConfig()
        diffusion = GaussianDiffusion.create(
            named_beta_schedule("linear", cfg.max_period), device=DEV)
        record, seen = {}, {}
        for name, dtype, steps in model_axis_bits():
            net = tp_model(cfg)
            step = pmesh.make_parallel_train_step(
                cfg, tp_config(dtype), mesh, diffusion, spatial=True,
                example_params=net)
            state = pmesh.init_state(trainer.Unravel(net), net, mesh, seed=6)
            batch, t, noise = tp_grad_inputs(cfg)
            grad_loss, grad = step.value_and_grad(state, batch[mesh.rows], t,
                                                  noise)
            if rank == 0:
                np.save(os.path.join(out_dir, f"{name}_grad.npy"),
                        grad.cpu().numpy())
            del grad, batch, t, noise
            batches = tp_batches(cfg, steps)
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seen[name] = new_seen()
            with eager_steps(), recording(seen[name]):
                losses = step(state, batches)[1].tolist()
            torch.cuda.synchronize()
            record[name] = dict(
                losses=losses, grad_loss=grad_loss.item(), launches=counts(),
                seconds_per_step=(time.perf_counter() - t0) / steps)
            np.savez(os.path.join(out_dir, f"{name}{rank}.npz"),
                     flat=state.flat.detach().cpu().numpy(),
                     m=state.m.cpu().numpy(), v=state.v.cpu().numpy())
            del step, state, net
            free_graphs()
        record["seen"] = {name: {k: sorted(v) for k, v in entry.items()}
                          for name, entry in seen.items()}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
    finally:
        distributed.shutdown()


def spatial_launches_per_step(cfg):
    """Each kernel's launches in one spatial step of one model rank: every
    GroupNorm through the split kernels, forward and backward, every
    attention through K1 and K2 on the gathered rows; no whole K4 or K5."""
    gn, attn = launches_per_forward(cfg)
    return dict(gn_act_fwd=0, gn_act_bwd=0, qkv_attention_fwd=attn,
                qkv_attention_bwd=attn, conv3x3_hwbc=0, gn_stats=gn,
                gn_apply=gn, gn_bwd_sums=gn, gn_bwd_dx=gn)


def drive_spatial_parallel(tmp, totals, gen, refs):
    """Spatial sharding (`parallel/spatial.py`, `parallel/mesh.py`) on the
    card, `UnetConfig()` at the global batch 32, against the one-device
    references of the `tensor_parallel` phase (the same model, seed,
    batches and steps):

    * (b) model axis 1 over NCCL (one rank, DP itself): the captured
      spatial step against the one-device flat step, the same bits after 3
      bfloat16 and 2 float32 steps (cuDNN deterministic), and its replay's
      device time;
    * (c) model axis 2 on the one card: two processes over gloo
      (`spatial_parallel_rank`) with cuDNN as the CLI leaves it, the
      gradient at the initial parameters and then 3 eager bfloat16 and 2
      float32 steps, held to the one-device gradient and losses within the
      bars at SP_RANKS, every vector bit-equal on both ranks; every kernel
      input the ranks gave the kernels held against its plain version
      (`check_seen_shapes`: the split GroupNorm at half height, K1 and K2
      at the gathered rows);
    * (b) and (c) again for `S2D_BITS` in patch space, against the
      one-device flat s2d step and gradient.
    Launch counts are held exactly per rank and added to `totals`."""
    cfg = UnetConfig()
    per_step = launches_per_step(cfg, False, 1)
    diffusion = GaussianDiffusion.create(
        named_beta_schedule("linear", cfg.max_period), device=DEV)
    one_device, one_grads = refs["one_device"], refs["one_grads"]
    control = refs["control"]
    out = {}

    def counted(name, want, got=None):
        torch.cuda.synchronize()
        got = counts() if got is None else got
        if got != want:
            raise AssertionError(f"spatial_parallel {name}: launches {got}, "
                                 f"want {want}")
        for k, v in got.items():
            totals[k] += v

    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0, DEV,
                           timeout_s=120)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = pmesh.make_mesh(model=1)
        axis1 = {}
        for name, dtype, steps in model_axis_bits():
            net = tp_model(cfg)
            step = pmesh.make_parallel_train_step(
                cfg, tp_config(dtype), mesh, diffusion, spatial=True,
                example_params=net)
            state = pmesh.init_state(trainer.Unravel(net), net, mesh, seed=6)
            reset_counts()
            got = step(state, tp_batches(cfg, steps))[1].tolist()
            counted(f"model axis 1 {name}",
                    {k: steps * v for k, v in per_step.items()})
            want, *want_state = one_device[name]
            diff = max((a.detach().cpu() - b).abs().max().item() for a, b in
                       zip((state.flat, state.m, state.v), want_state))
            if got != want or diff != 0.0:
                raise AssertionError(
                    f"spatial_parallel {name} at model axis 1: losses {got} "
                    f"against the one-device {want}, state max abs diff "
                    f"{diff}")
            axis1[name] = dict(steps=steps, losses=got, bits_equal=True,
                               replay_ms=replay_ms(step.graph),
                               held=step.graph.held)
            del step, state, net
            free_graphs()
        out["model_axis_1_nccl"] = axis1
    finally:
        torch.backends.cudnn.deterministic = deterministic
        distributed.shutdown()

    # model axis 2: two gloo ranks on card 0
    spec = os.path.join(tmp, "sp_spec.json")
    with open(spec, "w") as f:
        json.dump(dict(address=f"localhost:{distributed.free_port()}"), f)
    logs = [os.path.join(tmp, f"sp_rank{r}.log") for r in range(SP_RANKS)]
    procs = []
    t0 = time.perf_counter()
    try:
        for r, log in enumerate(logs):
            with open(log, "wb") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--spatial_parallel_rank", spec, str(r)],
                    stdout=f, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL))
        codes = [p.wait(timeout=SP_RANK_LIMIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if codes != [0] * SP_RANKS:
        text = "".join(open(log, errors="replace").read()[-3000:]
                       for log in logs)
        raise AssertionError(f"spatial_parallel: the ranks exited {codes}:\n"
                             f"{text}")
    ranks = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
             for r in range(SP_RANKS)]
    whole = trainer.Unravel(tp_model(cfg).cpu())
    axis2 = dict(backend="gloo (CUDA tensors through the host)",
                 cudnn_deterministic=False, seconds=time.perf_counter() - t0,
                 bf16_against_f32_one_device=control)
    sp_step = spatial_launches_per_step(cfg)
    for name, dtype, steps in MODEL_AXIS_BITS:
        want = one_device[name][0]
        got = ranks[0][name]["losses"]
        if any(rank[name]["losses"] != got for rank in ranks):
            raise AssertionError(f"spatial_parallel {name}: the ranks' "
                                 f"losses differ: {ranks}")
        f32_grad = space_f32_grad(one_grads, name)
        grad = torch.from_numpy(np.load(os.path.join(tmp, f"{name}_grad.npy")))
        if dtype == "float32":
            rtol, grad_rtol = TP_F32_LOSS_RTOL, TP_F32_GRAD_RTOL
        else:
            rtol = control["losses"]
            grad_rtol = TP_BF16_GRAD_FACTOR * control["grad"]
        grad_err = leaf_rel_err(grad, f32_grad, whole)
        grad_err_same_type = leaf_rel_err(grad, one_grads[name][1], whole)
        grad_loss_rel = abs(ranks[0][name]["grad_loss"] - one_grads[name][0]
                            ) / abs(one_grads[name][0])
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if not (grad_err <= grad_rtol and grad_loss_rel <= rtol
                and rel <= rtol):
            raise AssertionError(
                f"spatial_parallel {name} at model axis 2: gradient worst "
                f"leaf {grad_err} from the one-device float32 gradient (bar "
                f"{grad_rtol}), loss {grad_loss_rel} from the one-device "
                f"loss, losses {got} against the one-device {want} (max rel "
                f"{rel}; bar {rtol})")
        vecs = [np.load(os.path.join(tmp, f"{name}{r}.npz"))
                for r in range(SP_RANKS)]
        for part in ("flat", "m", "v"):
            if not np.array_equal(vecs[1][part], vecs[0][part]):
                raise AssertionError(f"spatial_parallel {name}: the ranks' "
                                     f"{part} differ")
        param_diff = float(np.abs(vecs[0]["flat"]
                                  - one_device[name][1].numpy()).max())
        for r, rank in enumerate(ranks):
            counted(f"model axis 2 {name} rank {r}",
                    {k: steps * v for k, v in sp_step.items()},
                    rank[name]["launches"])
        axis2[name] = dict(
            steps=steps, losses=got, one_device_losses=want,
            loss_max_rel_diff=rel, loss_rtol=rtol,
            grad_leaf_rel_err=grad_err, grad_leaf_rtol=grad_rtol,
            grad_leaf_rel_err_against_same_type=grad_err_same_type,
            grad_loss_rel_err=grad_loss_rel, param_max_abs_diff=param_diff,
            every_vector_bit_equal_on_both_ranks=True,
            seconds_per_step=[rank[name]["seconds_per_step"]
                              for rank in ranks])
    # the split GroupNorm at half height (the first: (32, 32, 64, 64) in 32
    # groups over 2 ranks; in patch space through the free view of the
    # rank's patch rows), no whole GroupNorm, and attention on the gathered
    # rows of every attention layer ((32, 256, 576) and (32, 64, 768)), in
    # either space
    half = (TRAIN_BATCH, cfg.image_size // SP_RANKS, cfg.image_size,
            cfg.model_channels)
    gathered = {(TRAIN_BATCH, (cfg.image_size // ds) ** 2, 3 * w)
                for ds, w in zip(sorted(cfg.attention_ds),
                                 sorted(set(unet.attention_widths(cfg))))}
    for names in (["bf16", "f32"], [S2D_BITS[0]]):
        seen = ranks_seen(ranks, names)
        if (half not in {e[0] for e in seen["sgn_fwd"]}
                or {e[4] for e in seen["sgn_fwd"] | seen["sgn_bwd"]}
                != {SP_RANKS}
                or seen["gn_fwd"] or seen["gn_bwd"]
                or {e[0] for e in seen["attn_fwd"]} != gathered):
            raise AssertionError(f"spatial_parallel {names}: the ranks "
                                 f"handed the kernels {seen}, not {half} "
                                 f"and {gathered}")
    axis2["s2d_kernel_inputs"] = {k: sorted(v) for k, v in seen.items()}
    axis2["kernel_inputs_of_the_steps"] = check_seen_shapes(
        ranks_seen(ranks, [n for n, _, _ in MODEL_AXIS_BITS]), gen)
    out["model_axis_2_one_card"] = axis2
    return out


def check_conv(gen):
    """The convolution kernels against their plain version at
    `CONV_SHAPES`, float32 and bfloat16, twice (the second call must give
    the same bits); each case records its `route` (the tensor-core kernels,
    "wgmma" in bfloat16 and "tf32" in float32, or the FMA kernel, "fma"), and a
    float32 case whose C and O are multiples of 8 must take "tf32".  The
    plain version sums in float64, so
    `library_max_abs_err`, cuDNN's distance from it (`F.conv2d` on the
    channels_last view of a (B, H, W, C) copy of the input, as conv_proto's
    bench), shows the error of cuDNN's own sum beside the kernel's.  Only
    the headline shape, `CONV_HEADLINE`, is timed, in both types (kernel,
    plain version and cuDNN alone, as called and on the device alone);
    conv_proto's bench times the kernel and cuDNN at the others, and
    utils/ab_trees.py times each case in turn."""
    cases = []
    for shape in CONV_SHAPES:
        H, W, B, C, O = shape
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((H, W, B, C), generator=gen, device=DEV).to(dtype)
            w = (torch.randn((3, 3, C, O), generator=gen, device=DEV) * 0.05
                 ).to(dtype)
            b = torch.randn(O, generator=gen, device=DEV).to(dtype)
            got = conv3x3_hwbc(x, w, b)
            again = conv3x3_hwbc(x, w, b)
            torch.cuda.synchronize()
            what = f"conv3x3_hwbc {shape} {dtype}"
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: a rerun gave other bits")
            want = conv3x3_hwbc_plain(x, w, b)
            err = compare(got, want, CONV_TOL[dtype], what)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            x_nchw = x.permute(2, 0, 1, 3).contiguous().permute(0, 3, 1, 2)
            lib = TF.conv2d(x_nchw, w_oihw, b, padding=1).permute(2, 3, 0, 1)
            lib_err = (lib.float() - want.float()).abs().max().item()
            item = x.element_size()
            bound_ms, bound_by = bound(
                (x.numel() + w.numel() + H * W * B * O + O) * item,
                2 * H * W * B * O * 9 * C, dtype)
            route = conv_mod.route(dtype, C, O)
            if dtype == torch.float32 and C % 8 == 0 and O % 8 == 0 \
                    and route != "tf32":
                raise AssertionError(f"{what}: route {route}, not tf32")
            case = dict(shape=list(shape), dtype=str(dtype),
                        route=route, max_abs_err=err,
                        tol=CONV_TOL[dtype], library_max_abs_err=lib_err,
                        bound_ms=bound_ms, bound_by=bound_by)
            if case["shape"] == CONV_HEADLINE["shape"]:
                case.update(timings(
                    lambda: conv3x3_hwbc(x, w, b),
                    lambda: conv3x3_hwbc_plain(x, w, b),
                    lambda: TF.conv2d(x_nchw, w_oihw, b, padding=1)))
            cases.append(case)
    return cases


def drive_conv(gen):
    """The kernel-benchmark path: conv_proto's check and bench, bench_ops
    and block_timing (forward and backward) at `UnetConfig()`, B=32, in
    bfloat16, all on the card.  Returns their results, what they printed,
    the kernels' launches, and the check of the GroupNorm and attention
    kernels at every shape these scripts handed them (the attention core of
    bench_ops at T=1024 among them).  The convolution's launches must be
    exactly those of conv_proto, and every other kernel must have run."""
    seen = new_seen()
    reset_counts()
    with recording(seen), contextlib.redirect_stdout(io.StringIO()) as out:
        proto = conv_proto.run(["--bench", "--device", "cuda"])
        ops = bench_ops.run(["--device", "cuda", "--reps", "20"])
        split = block_timing.run(["--backward", "--reps", "8",
                                  "--device", "cuda"])
    torch.cuda.synchronize()
    got = counts()
    want = 1 + sum(row["kernel_calls"] for row in proto["bench"])
    if got["conv3x3_hwbc"] != want:
        raise AssertionError(f"conv: {got['conv3x3_hwbc']} convolution "
                             f"launches, want {want}")
    if min(v for k, v in got.items() if k not in SPLIT_GN) <= 0:
        raise AssertionError(f"conv: a kernel was never launched: {got}")
    if len(proto["bench"]) != len(conv_proto.SHAPES):
        raise AssertionError("conv_proto: the bench did not run every shape")
    numbers = ([r["kernel_ms"] for r in proto["bench"]]
               + [r["mean_ms"] for r in ops["ops"].values()]
               + [r[k] for r in split for k in ("full_ms", "attention_free_ms")]
               + [r["device_alone"][k] for r in split
                  for k in ("full_ms", "attention_free_ms")])
    if len(split) != 2 or not all(math.isfinite(v) and v > 0
                                  for v in numbers):
        raise AssertionError(f"conv: bad timings {numbers}")
    if ((32, 1024, 576), 6) not in seen["attn_bwd"]:
        raise AssertionError("conv: bench_ops's attention core did not reach "
                             "the backward kernel")
    seen = check_seen_shapes(seen, gen)
    if seen["batches"] != [32]:
        raise AssertionError(f"conv: the scripts ran at batches "
                             f"{seen['batches']}")
    return dict(conv_proto=proto, bench_ops=ops, block_timing=split,
                printed=out.getvalue().splitlines(), launches=got,
                kernel_inputs_of_the_scripts=seen)


def summary(name, source, replaces, cases, headline, launches):
    """The contract's entry for one kernel: the numbers of the headline case
    (a shape of the main path, bfloat16) and every case beside it."""
    case = next(c for c in cases if all(c[k] == v for k, v in headline.items()))
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches, max_abs_err=case["max_abs_err"],
        ms=case["kernel_ms"], plain_ms=case["plain_ms"],
        bound_ms=case["bound_ms"], bound_by=case["bound_by"],
        library_ms=case["library_ms"], graph_ms=case["kernel_graph_ms"],
        plain_graph_ms=case["plain_graph_ms"],
        library_graph_ms=case["library_graph_ms"], headline_case=headline,
        worst_max_abs_err={dt: max(c["max_abs_err"] for c in cases
                                   if c["dtype"] == dt)
                           for dt in ("torch.float32", "torch.bfloat16")})


def main() -> None:
    t_start = time.perf_counter()
    smi = device_line()
    functional.set_f32_precision("highest")
    _build.load()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    ptxas = _build.ptxas_summary(_build.build_log)
    instances = {k["kernel"]: k["registers"]
                 for k in _build.ptxas_instances(_build.build_log)}
    emit({"phase": "device", "kind": torch.cuda.get_device_name(0),
          "nvidia_smi_name_power_limit": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-2].strip(),
          "build_seconds": _build.build_seconds, "ptxas": ptxas,
          "registers_by_instance": instances,
          "f32_precision": "highest (TF32 off)"})
    if not ptxas["kernels"] or ptxas["max_spill_bytes"]:
        raise AssertionError(f"no kernel in the build log, or a kernel "
                             f"spills registers: {ptxas}")
    missing = [k for k in REQUIRED_INSTANCES if k not in instances]
    if missing:
        raise AssertionError(f"not in the build log: {missing}")
    if CONV_SHAPES[:6] != [(conv_proto.bench_size(C), conv_proto.bench_size(C),
                            conv_proto.BATCH, C, O)
                           for C, O in conv_proto.SHAPES]:
        raise AssertionError("CONV_SHAPES does not begin with conv_proto's "
                             "bench shapes")

    gen = torch.Generator(device=DEV).manual_seed(0)
    cases = {"gn_act_fwd": check_groupnorm(gen),
             "qkv_attention_fwd": check_attention(gen),
             "gn_act_bwd": check_groupnorm_bwd(gen),
             "qkv_attention_bwd": check_attention_bwd(gen)}
    emit({"phase": "kernel_checks", **cases})

    model = unet.init(UnetConfig(),
                      generator=torch.Generator().manual_seed(0), device=DEV)
    emit({"phase": "forward", **check_forward(model, gen)})
    del model

    totals = {name: 0 for name in counts()}
    with tempfile.TemporaryDirectory() as tmp:
        records, seen, chain = drive_path(tmp, totals, gen)
    emit({"phase": "path", "model": "UnetConfig() ImageNet-64, full depth",
          "kernel_inputs_of_the_requests": seen, "requests": records,
          "captured_against_eager": chain, "launches": dict(totals)})

    emit({"phase": "train_step", "model": "UnetConfig(), float32 highest",
          **check_train_step(gen)})
    captured = drive_graphs(gen)
    emit({"phase": "graphs", "model": "UnetConfig() ImageNet-64, full depth, "
          f"B={TRAIN_BATCH}", **captured})
    with tempfile.TemporaryDirectory() as tmp:
        runs, seen, agreement = drive_train(
            tmp, totals, gen, {name: step["replay_ms"] for name, step in
                               captured["captured_steps"].items()})
    emit({"phase": "train", "model": "UnetConfig() ImageNet-64, full depth",
          "kernel_inputs_of_the_steps": seen, "runs": runs,
          "bf16_chunked_against_per_step": agreement,
          "launches_with_the_requests": dict(totals)})
    with tempfile.TemporaryDirectory() as tmp:
        other = drive_head_size(tmp, totals, gen)
    emit({"phase": "head_size", "model": f"UnetConfig() ImageNet-64, full "
          f"depth, num_head_channels={OTHER_HEAD_SIZE}", **other,
          "launches_with_the_runs_before": dict(totals)})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        wide = drive_wide_head(tmp, totals, gen)
    emit({"phase": "wide_head", "model": "DDPM 256x256 (CelebA-HQ/LSUN), "
          "full width and depth, one head of 512", **wide,
          "seconds": time.perf_counter() - t0,
          "launches_with_the_runs_before": dict(totals)})
    for key, value in (("ms_per_step", wide["train"]["ms_per_step"]),
                       ("peak_mib", wide["train"]["peak_mib"]),
                       ("params", wide["params"])):
        emit({"wide_head": key, "value": value})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cifar = drive_ddpm_cifar(tmp, totals, gen)
    emit({"phase": "ddpm_cifar", "model": "DDPM CIFAR-10 (Ho et al. 2020), "
          "full width and depth, one head of 256", **cifar,
          "seconds": time.perf_counter() - t0,
          "launches_with_the_runs_before": dict(totals)})

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        s2d = drive_s2d(tmp, totals, gen,
                        captured["captured_steps"]["bf16"]["replay_ms"],
                        next(r for r in runs if r["run"] == "bf16"))
    emit({"phase": "s2d", "model": "UnetConfig() ImageNet-64, full depth, "
          "level 0 in patch space", **s2d,
          "seconds": time.perf_counter() - t0,
          "launches_with_the_runs_before": dict(totals)})

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pipeline = drive_input_pipeline(tmp, totals)
    emit({"phase": "input_pipeline", "model": "UnetConfig() ImageNet-64, "
          f"full depth, B={TRAIN_BATCH} bfloat16 + EMA", **pipeline,
          "seconds": time.perf_counter() - t0,
          "launches_with_the_runs_before": dict(totals)})

    reset_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        rest = drive_cli(tmp, totals, {name: step["replay_ms"] for name, step
                                       in captured["captured_steps"].items()})
    emit({"phase": "cli", "model": "UnetConfig() ImageNet-64, full depth",
          **rest, "seconds": time.perf_counter() - t0,
          "launches_with_the_runs_before": dict(totals)})

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        par = drive_parallel(tmp, totals, {name: step["replay_ms"] for name,
                                           step in captured["captured_steps"]
                                           .items()})
    emit({"phase": "parallel", "model": "UnetConfig() ImageNet-64, full "
          f"depth, B={TRAIN_BATCH} a rank, 1 rank (NCCL)", **par,
          "seconds": time.perf_counter() - t0,
          "launches_with_the_runs_before": dict(totals)})

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tp, refs = drive_tensor_parallel(tmp, totals, gen)
    emit({"phase": "tensor_parallel", "model": "UnetConfig() ImageNet-64, "
          f"full depth, global B={TRAIN_BATCH}", **tp,
          "seconds": time.perf_counter() - t0,
          "launches_with_the_runs_before": dict(totals)})

    t0 = time.perf_counter()
    split_cases = check_split_kernels(gen)
    with tempfile.TemporaryDirectory() as tmp:
        spatial = drive_spatial_parallel(tmp, totals, gen, refs)
    del refs
    emit({"phase": "spatial_parallel", "model": "UnetConfig() ImageNet-64, "
          f"full depth, global B={TRAIN_BATCH}", "split_kernels": split_cases,
          **spatial, "seconds": time.perf_counter() - t0,
          "launches_with_the_runs_before": dict(totals)})
    cases.update(split_cases)

    cases["conv3x3_hwbc"] = check_conv(gen)
    emit({"phase": "conv_checks", "conv3x3_hwbc": cases["conv3x3_hwbc"]})
    conv = drive_conv(gen)
    totals["conv3x3_hwbc"] = conv["launches"]["conv3x3_hwbc"]
    emit({"phase": "conv", "model": "UnetConfig() ImageNet-64, full depth, "
          "B=32 bfloat16", **conv})
    if min(totals.values()) <= 0:
        raise AssertionError(f"a kernel was never launched: {totals}")

    gn_src, attn_src = ("unet_tpu_torch/csrc/groupnorm.cu",
                        "unet_tpu_torch/csrc/attention.cu")
    emit({"kernels": [
        summary("gn_act_fwd", gn_src, "unet_tpu/ops/pallas/groupnorm.py:165",
                cases["gn_act_fwd"],
                dict(shape=[8, 64, 64, 64], dtype="torch.bfloat16",
                     act="silu"), totals["gn_act_fwd"]),
        summary("qkv_attention_fwd", attn_src,
                "unet_tpu/ops/pallas/attention.py:160",
                cases["qkv_attention_fwd"],
                dict(shape=[8, 256, 192, 6], dtype="torch.bfloat16"),
                totals["qkv_attention_fwd"]),
        summary("gn_act_bwd", gn_src, "unet_tpu/ops/pallas/groupnorm.py:200",
                cases["gn_act_bwd"],
                dict(shape=[32, 64, 64, 64], dtype="torch.bfloat16",
                     act="silu"), totals["gn_act_bwd"]),
        summary("qkv_attention_bwd", attn_src,
                "unet_tpu/ops/pallas/attention.py:189",
                cases["qkv_attention_bwd"],
                dict(shape=[32, 256, 192, 6], dtype="torch.bfloat16"),
                totals["qkv_attention_bwd"]),
        summary("conv3x3_hwbc", "unet_tpu_torch/csrc/conv3x3.cu",
                "scripts/conv_proto.py:111", cases["conv3x3_hwbc"],
                CONV_HEADLINE,
                totals["conv3x3_hwbc"]),
    ] + [summary(name, gn_src, replaces, cases[name], SPLIT_HEADLINE,
                 totals[name])
         for name, replaces in (
             ("gn_stats", "unet_tpu/ops/pallas/groupnorm.py:165"),
             ("gn_apply", "unet_tpu/ops/pallas/groupnorm.py:165"),
             ("gn_bwd_sums", "unet_tpu/ops/pallas/groupnorm.py:200"),
             ("gn_bwd_dx", "unet_tpu/ops/pallas/groupnorm.py:200"))]})
    emit({"phase": "done", "seconds_total": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tensor_parallel_rank"]:
        tensor_parallel_rank(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--spatial_parallel_rank"]:
        spatial_parallel_rank(sys.argv[2], int(sys.argv[3]))
    else:
        main()
