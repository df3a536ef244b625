"""Captured work: the port's counterpart of `jax.jit`.

The JAX package runs a train chunk and a sampler chain each as one compiled
program.  Here, on a CUDA device, the work of one step is captured into a
`torch.cuda.CUDAGraph` (with its own memory pool) and replayed: one launch
from the host in place of the step's two thousand.  On the CPU the same
code runs eagerly.  There is no switch between the two: the device decides.

`Graph(fn, device)` wraps `fn()`, a function of no arguments that reads its
inputs from tensors that stay where they are (the caller writes each
step's inputs into them) and writes its results in place.  On a CUDA
device:

* the first call runs `fn` eagerly, on the stream the graph will be
  captured on.  That call is real work (a train step, a sampler step) and
  it is the warm-up capture needs: it builds the hand-written kernels
  (`ops/kernels/_build.py` runs `nvcc` at first use), sets their
  shared-memory and cluster attributes and checks that a cluster fits
  (done once per kernel and configuration, in `csrc/*.cu`), and lets cuDNN
  and cuBLAS pick their algorithms and workspaces.  None of these may
  happen inside a capture;
* the second call captures `fn` and replays it; every later call replays.
  A capture that fails raises;
* a replay launches, on the current stream, every kernel the capture
  recorded.

The kernel wrappers count their launches in Python (`fn.launches`), which
runs only at capture.  So the graph keeps the count of launches the
capture recorded, of each kernel (`held`), takes them back out of the
counters (nothing ran), and adds them on every replay: a count still means
kernels that ran on the card.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from unet_tpu_torch.ops.kernels import attention, conv3x3, groupnorm

# The wrappers that count their launches.
COUNTED = (groupnorm.gn_act_fwd, groupnorm.gn_act_bwd,
           attention.qkv_attention_fwd, attention.qkv_attention_bwd,
           conv3x3.conv3x3_hwbc, groupnorm.gn_stats, groupnorm.gn_apply,
           groupnorm.gn_bwd_sums, groupnorm.gn_bwd_dx)


def launch_counts() -> Dict[str, int]:
    """Each counted kernel's launches since its count was last set to 0."""
    return {fn.__name__: fn.launches for fn in COUNTED}


# One side stream per device for every warm-up and capture: cuBLAS keeps a
# workspace per stream it has run on, for the life of the process.
_STREAMS: Dict[int, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


class Graph:
    """`fn()`, run eagerly on a CPU device, and on a CUDA device once
    eagerly, then captured and replayed (see the module's docstring).
    `held` is the launches of each counted kernel that one replay makes
    (empty until the capture)."""

    def __init__(self, fn: Callable[[], None], device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph = None
        self.held: Dict[str, int] = {}
        self._warm = False

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
        elif not self._warm:
            self._warm_up()
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            for fn in COUNTED:
                fn.launches += self.held[fn.__name__]

    def _warm_up(self) -> None:
        stream = _capture_stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            self.fn()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        self._warm = True

    def _capture(self) -> None:
        before = launch_counts()
        try:
            graph = self._record()
            self.held = {name: n - before[name]
                         for name, n in launch_counts().items()}
        finally:
            for fn in COUNTED:
                fn.launches = before[fn.__name__]
        self.graph = graph

    def _record(self) -> "torch.cuda.CUDAGraph":
        """`fn`'s launches captured into a new graph (nothing runs)."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=_capture_stream(self.device)):
            self.fn()
        return graph
