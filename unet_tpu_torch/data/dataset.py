"""Binary image dataset (.bin, magic 20240620): writer, reader and loaders
(port of unet_tpu/data/dataset.py, which is numpy only; this is the port's
own copy of `write_bin`, `images_to_bin`, `BinDataset`, `data_loader` and
`image_dir_loader`).

File contract: 256-int32 header [magic, n_imgs, C, H, W] followed by n_imgs
float32 images, CHW, values in [-1, 1].

The reader memory-maps the file and serves NHWC batches; the CHW->HWC
transpose happens on the host at batch-assembly time.  The loader's draws
from its numpy generator are the JAX package's, in the same order, so both
packages see bit-identical batch streams, resumed ones included.
`images_to_bin` and `image_dir_loader` decode image files with Pillow,
imported inside them: nothing else here needs it.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

MAGIC = 20240620
HEADER_INTS = 256


def write_bin(path: str, images: np.ndarray) -> None:
    """images: (N, C, H, W) fp32 in [-1, 1]."""
    n, c, h, w = images.shape
    header = np.zeros(HEADER_INTS, dtype=np.int32)
    header[0], header[1], header[2], header[3], header[4] = MAGIC, n, c, h, w
    with open(path, "wb") as f:
        f.write(header.tobytes())
        f.write(np.ascontiguousarray(images, dtype=np.float32).tobytes())


def _load_image(path: str, size: int) -> np.ndarray:
    """One image file as (size, size, 3) float32 in [-1, 1], HWC: RGB, a
    non-square or mis-sized image centre-cropped to a square and resized
    bicubically to `size`."""
    from PIL import Image  # only the image-file paths need Pillow

    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        side = min(img.size)
        left = (img.width - side) // 2
        top = (img.height - side) // 2
        img = img.crop((left, top, left + side, top + side))
        img = img.resize((size, size), Image.BICUBIC)
    return np.asarray(img).astype(np.float32) / 127.5 - 1.0


def images_to_bin(image_dir: str, out_path: str, *, size: int = 64) -> int:
    """A directory of images (searched recursively, in sorted order) ->
    .bin of (n, 3, size, size); returns the number of images written."""
    files = _list_images(image_dir)
    header = np.zeros(HEADER_INTS, dtype=np.int32)
    header[0], header[1] = MAGIC, len(files)
    header[2], header[3], header[4] = 3, size, size
    with open(out_path, "wb") as f:
        f.write(header.tobytes())
        for fname in files:
            f.write(_load_image(fname, size).transpose(2, 0, 1)
                    .astype(np.float32).tobytes())
    return len(files)


def _list_images(data_dir: str):
    """The jpg/jpeg/png/gif files under `data_dir`, directories entered in
    sorted order."""
    exts = {"jpg", "jpeg", "png", "gif"}
    results = []
    for entry in sorted(os.listdir(data_dir)):
        full = os.path.join(data_dir, entry)
        if os.path.isdir(full):
            results.extend(_list_images(full))
        elif "." in entry and entry.rsplit(".", 1)[-1].lower() in exts:
            results.append(full)
    return results


class BinDataset:
    """Memory-mapped view over a .bin dataset; zero-copy until batch read."""

    def __init__(self, path: str):
        header = np.fromfile(path, dtype=np.int32, count=HEADER_INTS)
        if header[0] != MAGIC:
            raise ValueError(f"bad magic {header[0]} in {path}")
        self.n_images = int(header[1])
        self.channels = int(header[2])
        self.height = int(header[3])
        self.width = int(header[4])
        self._mmap = np.memmap(
            path, dtype=np.float32, mode="r", offset=HEADER_INTS * 4,
            shape=(self.n_images, self.channels, self.height, self.width))

    def __len__(self) -> int:
        return self.n_images

    def batch_nhwc(self, indices: np.ndarray) -> np.ndarray:
        """Gather a batch and transpose to NHWC fp32."""
        return np.ascontiguousarray(
            self._mmap[indices].transpose(0, 2, 3, 1), dtype=np.float32)


def data_loader(path: str, batch_size: int, *, shuffle: bool = False,
                flip: bool = False,
                seed: int = 0, num_shards: int = 1, shard_index: int = 0,
                skip_batches: int = 0,
                ) -> Iterator[np.ndarray]:
    """Infinite NHWC batch iterator.

    Default (shuffle=False): sequential fixed-stride batches wrapping at
    the end of an epoch.  flip=True applies a p=0.5 horizontal flip per
    image.  With num_shards > 1, each shard reads a disjoint interleaved
    slice for data-parallel training.

    skip_batches=N fast-forwards the stream past its first N batches
    WITHOUT reading pixel data — cursor arithmetic plus replaying the
    rng draws (flip masks, shuffle permutations) so a resumed run sees
    the exact batch sequence the original run would have from step N on.
    The stream position is checkpointed as header[14]
    (io/checkpoint.py).
    """
    ds = BinDataset(path)
    n = len(ds)
    if n < batch_size * num_shards:
        # loud instead of silently clamping per_epoch to 1: a short shard
        # slice would yield ragged batches
        raise ValueError(
            f"dataset has {n} images < batch_size*num_shards = "
            f"{batch_size}*{num_shards}; every rank needs at least one "
            f"full batch per epoch")
    rng = np.random.default_rng(seed)

    def maybe_flip(batch):
        if not flip:
            return batch
        mask = rng.random(batch.shape[0]) < 0.5
        batch = batch.copy()
        batch[mask] = batch[mask, :, ::-1]  # flip width (NHWC axis 2)
        return batch

    def skip_flip_draws(k_batches):
        if flip and k_batches:
            rng.random((k_batches, batch_size))

    if shuffle:
        # per_epoch comes from the GLOBAL size, not the shard slice: all
        # ranks share one seeded stream, and shard-local lengths differ
        # when num_shards does not divide n — a per-rank per_epoch would
        # desynchronize the permutation cadence after the first epoch
        # and silently overlap the shards.
        # Every rank's slice holds >= per_epoch*batch_size images:
        # floor(n/S) >= B*floor(n/(B*S)).
        per_epoch = max(n // (batch_size * num_shards), 1)
        # replay whole epochs (one permutation + its flip draws each) ...
        for _ in range(skip_batches // per_epoch):
            rng.permutation(n)
            skip_flip_draws(per_epoch)
        start = skip_batches % per_epoch
        while True:
            perm = rng.permutation(n)
            perm = perm[shard_index::num_shards]
            skip_flip_draws(start)  # ... then the partial epoch
            for i in range(start, per_epoch):
                yield maybe_flip(ds.batch_nhwc(
                    perm[i * batch_size:(i + 1) * batch_size]))
            start = 0
    else:
        idx = np.arange(n)[shard_index::num_shards]
        # same GLOBAL epoch length as the shuffle branch, so all ranks
        # wrap in lockstep, as in the JAX package's loaders
        per_epoch = max(n // (batch_size * num_shards), 1)
        m = per_epoch * batch_size
        pos = (skip_batches % per_epoch) * batch_size
        skip_flip_draws(skip_batches)
        while True:
            if pos + batch_size > m:
                pos = 0
            yield maybe_flip(ds.batch_nhwc(idx[pos:pos + batch_size]))
            pos += batch_size


def image_dir_loader(data_dir: str, batch_size: int, *, size: int = 64,
                     class_cond: bool = False, randomize: bool = False,
                     seed: int = 0, skip_batches: int = 0,
                     num_shards: int = 1, shard_index: int = 0) -> Iterator:
    """Infinite NHWC batch iterator straight over a directory of images:
    with `randomize`, a permutation per epoch and a p=0.5 horizontal flip
    per image; with `class_cond`, (batch, labels) tuples, an image's label
    being the index of its file-name prefix before '_' among the sorted
    prefixes.

    skip_batches=N fast-forwards past the first N batches without decoding
    an image: cursor arithmetic and a replay of the draws (one permutation
    per epoch, one flip draw per image), so a resumed run sees the stream
    the original would have from step N on.

    num_shards > 1: the stream of global batches of batch_size *
    num_shards images, of which this shard decodes and yields rows
    shard_index, shard_index + num_shards, ... (the rows
    `parallel.distributed.global_batch` gives a rank); every shard makes
    every draw, so the shards together yield what one shard of them all
    would."""
    files = _list_images(data_dir)
    if not files:
        raise ValueError(f"no images under {data_dir}")
    whole = batch_size * num_shards
    if len(files) < whole:
        # the epoch loop below would yield nothing, for ever
        raise ValueError(f"{data_dir} has {len(files)} images < batch_size "
                         f"{whole}; an epoch needs one full batch")
    labels = None
    if class_cond:
        names = [os.path.basename(p).split("_")[0] for p in files]
        class_of = {x: i for i, x in enumerate(sorted(set(names)))}
        labels = np.asarray([class_of[x] for x in names], np.int32)
    rng = np.random.default_rng(seed)

    def load(idx):
        arr = _load_image(files[idx], size)
        if randomize and rng.random() < 0.5:
            arr = arr[:, ::-1]
        return arr  # HWC

    n = len(files)
    per_epoch = max(len(range(0, n - whole + 1, whole)), 1)
    if randomize:  # replay the draws of the skipped prefix
        for _ in range(skip_batches // per_epoch):
            rng.permutation(n)
            rng.random(per_epoch * whole)
    start = skip_batches % per_epoch
    while True:
        order = rng.permutation(n) if randomize else np.arange(n)
        if randomize and start:
            rng.random(start * whole)
        for i in range(start * whole, n - whole + 1, whole):
            idx = order[i:i + whole]
            rows = []
            for j, k in enumerate(idx):
                if j % num_shards == shard_index:
                    rows.append(load(k))
                elif randomize:
                    rng.random()  # another shard's image's flip draw
            batch = np.stack(rows)
            if class_cond:
                yield batch, labels[idx[shard_index::num_shards]]
            else:
                yield batch
        start = 0
