"""ctypes bindings of the host runtime (`unet_tpu_torch/native/host.cpp`).

The library is built with the host C++ compiler at first use, never at
import, into `unet_tpu_torch/build/` beside the kernels' library, under a
name derived from the source's contents and the flags (so an unchanged tree
builds once).  A failed build raises `HostBuildError` with the compiler's
output; nothing falls back to the numpy loader.

  * `TorchRng`: the stream `torch.manual_seed(seed)` gives, draw for draw
    (uniforms bit for bit; normals as torch's own formula), for
    `--host_rng`; `get_state()` is the 625-word blob checkpoints carry.
  * `NativeLoader`: a `.bin` dataset read and CHW->HWC transposed on a
    worker thread one batch ahead, sequentially, as `data_loader` does.
  * `NativeAugmentedLoader`: `data_loader`'s shuffle, flip and shards, its
    numpy draws made here in `data_loader`'s order and only the gather,
    transpose and mirror done on the worker thread, so a given step gets
    the same bytes from either loader, resumed runs included.

Both loaders' `next_into` write a batch into a preallocated (B, H, W, C)
array: float32, or the uint8 pixels round((v + 1) * 127.5) when the array
is uint8 (the trainer's host-to-device encoding), in one native pass.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
COMPILER = "c++"
# -ffp-contract=off keeps the Box-Muller arithmetic torch's, bit for bit.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
             "-ffp-contract=off")

_lib: Optional[ctypes.CDLL] = None


class HostBuildError(RuntimeError):
    """The host C++ compiler is missing or refused the source."""


def _digest() -> str:
    h = hashlib.sha256(" ".join((COMPILER,) + CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile host.cpp into `BUILD_DIR` unless that build exists; returns
    the library's path."""
    lib_path = BUILD_DIR / f"libunet_host_{_digest()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    try:
        out = subprocess.run([COMPILER, *CXX_FLAGS, "-o", str(tmp),
                              str(SOURCE)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
    except FileNotFoundError as e:
        raise HostBuildError(f"{COMPILER} not found: the host library "
                             f"cannot be built ({e})") from e
    if out.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise HostBuildError(f"{COMPILER} failed on {SOURCE.name} (exit "
                             f"{out.returncode}):\n{out.stdout}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build is harmless
    return lib_path


def load_library() -> ctypes.CDLL:
    """The host library with every function's `argtypes` and `restype`
    declared, built first if need be."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    up = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    bp = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lp = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    signatures = {
        "rng_create": (vp, [ctypes.c_uint32]),
        "rng_destroy": (None, [vp]),
        "rng_seed": (None, [vp, ctypes.c_uint32]),
        "rng_u32": (ctypes.c_uint32, [vp]),
        "rng_f32": (ctypes.c_float, [vp]),
        "rng_f64": (ctypes.c_double, [vp]),
        "rng_uniform": (None, [vp, fp, i64, ctypes.c_float, ctypes.c_float]),
        "rng_normal": (None, [vp, fp, i64, ctypes.c_float, ctypes.c_float]),
        "rng_timesteps": (None, [vp, fp, i64, ctypes.c_int]),
        "rng_shuffle": (None, [vp, ip, i64]),
        "rng_get_state": (None, [vp, up]),
        "rng_set_state": (None, [vp, up]),
        "loader_open": (vp, [ctypes.c_char_p, ctypes.c_int, i64]),
        "loader_close": (None, [vp]),
        "loader_meta": (None, [vp, lp]),
        "loader_next": (None, [vp, fp]),
        "loader_next_u8": (None, [vp, bp]),
        "loader_set_epoch": (ctypes.c_int, [vp, lp, bp, i64, i64]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    return lib


class TorchRng:
    """The MT19937 stream of `torch.manual_seed(seed)` on the host."""

    STATE_WORDS = 625  # 624 MT19937 words + the cursor: the whole state

    def __init__(self, seed: int = 0):
        self._lib = load_library()
        self._h = self._lib.rng_create(seed & 0xFFFFFFFF)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rng_destroy(self._h)
            self._h = None

    def seed(self, seed: int) -> None:
        self._lib.rng_seed(self._h, seed & 0xFFFFFFFF)

    def randint32(self) -> int:
        return int(self._lib.rng_u32(self._h))

    def uniform(self, n: int, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
        out = np.empty(n, np.float32)
        self._lib.rng_uniform(self._h, out, n, lo, hi)
        return out

    def normal(self, shape, mean: float = 0.0, std: float = 1.0) -> np.ndarray:
        """torch's `normal_` on a tensor of `shape`, in its element order."""
        n = int(np.prod(shape))
        out = np.empty(n, np.float32)
        self._lib.rng_normal(self._h, out, n, mean, std)
        return out.reshape(shape)

    def timesteps(self, n: int, max_period: int) -> np.ndarray:
        """floor(u * max_period) of n float uniforms u, as float32."""
        out = np.empty(n, np.float32)
        self._lib.rng_timesteps(self._h, out, n, max_period)
        return out

    def shuffle_indices(self, n: int) -> np.ndarray:
        idx = np.arange(n, dtype=np.int32)
        self._lib.rng_shuffle(self._h, idx, n)
        return idx

    def get_state(self) -> np.ndarray:
        out = np.empty(self.STATE_WORDS, np.uint32)
        self._lib.rng_get_state(self._h, out)
        return out

    def set_state(self, state: np.ndarray) -> None:
        state = np.ascontiguousarray(state, np.uint32)
        if state.size != self.STATE_WORDS:
            raise ValueError(f"rng state must be {self.STATE_WORDS} words")
        self._lib.rng_set_state(self._h, state)


class NativeLoader:
    """NHWC batches of a `.bin` dataset, read on a worker thread one batch
    ahead.  Sequential by default (fixed-stride batches wrapping at the end,
    `skip_batches` resuming with `data_loader`'s cursor arithmetic); after
    `set_epoch`, the images an order names, each mirrored where its flip
    byte says."""

    def __init__(self, path: str, batch_size: int, skip_batches: int = 0):
        self._lib = load_library()
        self._h = self._lib.loader_open(os.fsencode(path), batch_size,
                                        skip_batches)
        if not self._h:
            raise IOError(f"cannot open dataset {path} (missing, or not a "
                          "magic-20240620 .bin)")
        meta = np.zeros(4, np.int64)
        self._lib.loader_meta(self._h, meta)
        self.n_images, self.channels, self.height, self.width = map(int, meta)
        self.batch_size = batch_size
        if self.n_images < batch_size:
            # data_loader's check: the reader would pad a short batch with
            # zeros past the end of the file
            raise ValueError(f"dataset has {self.n_images} images < "
                             f"batch_size {batch_size}; every rank needs at "
                             "least one full batch per epoch")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.loader_close(self._h)
            self._h = None

    def _check(self, out: np.ndarray) -> None:
        want = (self.batch_size, self.height, self.width, self.channels)
        if out.shape != want or not out.flags.c_contiguous:
            raise ValueError(f"next_into needs a C-contiguous {want} array, "
                             f"got {out.shape}")

    def next_batch(self) -> np.ndarray:
        out = np.empty((self.batch_size, self.height, self.width,
                        self.channels), np.float32)
        self._lib.loader_next(self._h, out)
        return out

    def next_into(self, out: np.ndarray) -> None:
        """Write the next batch into `out`: float32 pixels, or uint8
        round((v + 1) * 127.5) when `out` is uint8."""
        self._check(out)
        if out.dtype == np.uint8:
            self._lib.loader_next_u8(self._h, out)
        else:
            self._lib.loader_next(self._h, out)

    def set_epoch(self, order: np.ndarray, flips: np.ndarray,
                  start_batch: int = 0) -> None:
        """Serve `order` (absolute image indices, a whole number of batches)
        with its 0/1 `flips`, from batch `start_batch`; whatever was
        prefetched from the previous order is dropped."""
        order = np.ascontiguousarray(order, np.int64)
        flips = np.ascontiguousarray(flips, np.uint8)
        if flips.size != order.size:
            raise ValueError(f"{order.size} indices but {flips.size} flips")
        ok = self._lib.loader_set_epoch(self._h, order, flips, order.size,
                                        start_batch)
        if not ok:
            raise ValueError(f"bad epoch: {order.size} indices, batch "
                             f"{self.batch_size}, start {start_batch}")

    def __iter__(self):
        while True:
            yield self.next_batch()


class NativeAugmentedLoader:
    """`data_loader(path, batch_size, shuffle=, flip=, seed=, num_shards=,
    shard_index=, skip_batches=)`, batch for batch and byte for byte, with
    the pixels moved on `NativeLoader`'s worker thread.

    The numpy generator stays here and draws what `data_loader` draws, in
    its order: one permutation per epoch when shuffling, B flip draws per
    batch, and for `skip_batches` the draws of the skipped prefix."""

    def __init__(self, path: str, batch_size: int, *, shuffle: bool = False,
                 flip: bool = False, seed: int = 0, num_shards: int = 1,
                 shard_index: int = 0, skip_batches: int = 0):
        self._base = NativeLoader(path, batch_size)
        self.batch_size = batch_size
        self._n = self._base.n_images
        if self._n < batch_size * num_shards:
            # data_loader's check: a clamped epoch would serve ragged batches
            raise ValueError(
                f"dataset has {self._n} images < batch_size*num_shards ="
                f" {batch_size}*{num_shards}; every rank needs at least "
                f"one full batch per epoch")
        self._rng = np.random.default_rng(seed)
        self._shuffle, self._flip = shuffle, flip
        self._num_shards, self._shard_index = num_shards, shard_index
        # the global epoch length, as data_loader's
        self._per_epoch = max(self._n // (batch_size * num_shards), 1)
        if shuffle:
            # replay the skipped epochs: a permutation and its flips each
            for _ in range(skip_batches // self._per_epoch):
                self._rng.permutation(self._n)
                self._skip_flip_draws(self._per_epoch)
            self._seq_idx = None
        else:
            # data_loader draws every skipped batch's flips up front
            self._seq_idx = np.ascontiguousarray(
                np.arange(self._n)[shard_index::num_shards], np.int64)
            self._skip_flip_draws(skip_batches)
        self._start = skip_batches % self._per_epoch
        self._first_epoch = True
        self._left = 0

    def _skip_flip_draws(self, k_batches: int) -> None:
        if self._flip and k_batches:
            self._rng.random((k_batches, self.batch_size))

    def _flip_rows(self, rows: int) -> np.ndarray:
        if not self._flip or rows == 0:
            return np.zeros((rows, self.batch_size), np.uint8)
        return (self._rng.random((rows, self.batch_size)) < 0.5
                ).astype(np.uint8)

    def _install_epoch(self) -> None:
        B, pe = self.batch_size, self._per_epoch
        start = self._start if self._first_epoch else 0
        if self._shuffle:
            order = self._rng.permutation(self._n)[
                self._shard_index::self._num_shards][:pe * B]
            # data_loader draws the whole epoch's flips, skipped rows too
            flips = self._flip_rows(pe)
        else:
            order = self._seq_idx[:pe * B]
            # the skipped rows' draws were made in __init__
            flips = np.zeros((pe, B), np.uint8)
            flips[start:] = self._flip_rows(pe - start)
        self._base.set_epoch(order, flips.ravel(), start_batch=start)
        self._left = pe - start
        self._first_epoch = False

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._left == 0:
            self._install_epoch()
        self._left -= 1
        return self._base.next_batch()

    def next_into(self, out: np.ndarray) -> None:
        if self._left == 0:
            self._install_epoch()
        self._left -= 1
        self._base.next_into(out)
