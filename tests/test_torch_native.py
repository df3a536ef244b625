"""The port's host library (unet_tpu_torch/native/host.cpp through
utils/native.py) against the JAX package's (unet_tpu/utils/native.py) and
against torch's own generator, on the CPU.

TorchRng: every draw and every 625-word state blob bit-equal to the JAX
package's, uniforms and timesteps bit-equal to `torch.Generator`'s, normals
within the JAX test's 2.5e-7 of torch's (its sin lanes may be an ulp off
torch's vectorised sin).  Loaders: batches byte-equal to the port's
`data_loader` and to the JAX package's loaders.  The library is built once
per session.
"""

import os

import numpy as np
import pytest
import torch

from unet_tpu.data import dataset as jax_dataset
from unet_tpu.utils import native as jax_native
from unet_tpu_torch.data import dataset
from unet_tpu_torch.utils import native

from tests.torch_port_util import jax_native_library

SEEDS = (0, 7, 137, 2 ** 32 - 1)


@pytest.fixture(scope="session")
def lib():
    return native.load_library()


@pytest.fixture(scope="session")
def jax_lib(tmp_path_factory):
    return jax_native_library(tmp_path_factory.mktemp("jax_native"))


def _pair(seed):
    return native.TorchRng(seed), jax_native.TorchRng(seed)


def _torch_gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_randint32_equals_jax_and_torch(lib, jax_lib, seed):
    """torch.randint over [0, 2^32 - 1) takes a u64 (two u32 draws) modulo
    the range: the raw stream is torch's."""
    ours, theirs = _pair(seed)
    gen = _torch_gen(seed)
    for _ in range(8):
        hi, lo = ours.randint32(), ours.randint32()
        assert (hi, lo) == (theirs.randint32(), theirs.randint32())
        assert ((hi << 32) | lo) % 0xFFFFFFFF == int(
            torch.randint(0, 0xFFFFFFFF, [1], generator=gen).item())


@pytest.mark.parametrize("n", [1, 33, 1000])
def test_uniform_equals_jax_and_torch(lib, jax_lib, n):
    ours, theirs = _pair(11)
    gen = _torch_gen(11)
    for _ in range(2):
        got = ours.uniform(n)
        np.testing.assert_array_equal(got, theirs.uniform(n))
        np.testing.assert_array_equal(got, torch.rand(n, generator=gen)
                                      .numpy())
    np.testing.assert_array_equal(ours.uniform(5, -2.0, 3.0),
                                  theirs.uniform(5, -2.0, 3.0))


@pytest.mark.parametrize("n", [1, 5, 15, 16, 24, 37, 3 * 16 * 16])
def test_normal_equals_jax_and_torch(lib, jax_lib, n):
    """n < 16: scalar double Box-Muller with a cached second sample;
    n >= 16: blocks of 16 from uniforms, a ragged tail redrawn.  torch
    keeps a scalar call's unused sample for its next call and the library
    does not, so torch is compared on a fresh generator's first call."""
    ours, theirs = _pair(3)
    want = torch.empty(n).normal_(generator=_torch_gen(3)).numpy()
    for call in range(3):
        got = ours.normal((n,))
        np.testing.assert_array_equal(got, theirs.normal((n,)))
        if call == 0:
            np.testing.assert_allclose(got, want, atol=2.5e-7, rtol=0)
    np.testing.assert_array_equal(ours.normal((2, 3, 4, 4), 0.5, 2.0),
                                  theirs.normal((2, 3, 4, 4), 0.5, 2.0))


def test_timesteps_and_shuffle_equal_jax(lib, jax_lib):
    ours, theirs = _pair(5)
    gen = _torch_gen(5)
    t = ours.timesteps(1000, 1000)
    np.testing.assert_array_equal(t, theirs.timesteps(1000, 1000))
    assert t.dtype == np.float32 and 0 <= t.min() and t.max() < 1000
    # floor(u * T) of torch's float uniforms
    u = torch.rand(1000, generator=gen).numpy()
    np.testing.assert_array_equal(t, np.floor(u * np.float32(1000)))
    idx = ours.shuffle_indices(257)
    np.testing.assert_array_equal(idx, theirs.shuffle_indices(257))
    assert sorted(idx.tolist()) == list(range(257))


def test_state_blob_equals_jax_and_resumes_across_packages(lib, jax_lib):
    """After draws of every kind the blobs are the same 625 words; a blob
    from either package, set into the other, continues the same stream."""
    ours, theirs = _pair(42)
    for rng in (ours, theirs):
        rng.timesteps(7, 1000)
        rng.normal((3, 3, 8, 8))
        rng.normal((5,))
        rng.uniform(9)
    blob = ours.get_state()
    assert blob.dtype == np.uint32 and blob.shape == (625,)
    np.testing.assert_array_equal(blob, theirs.get_state())

    port_from_jax = native.TorchRng(0)
    port_from_jax.set_state(theirs.get_state())
    jax_from_port = jax_native.TorchRng(0)
    jax_from_port.set_state(blob)
    want = ours.normal((2, 3, 8, 8))
    np.testing.assert_array_equal(port_from_jax.normal((2, 3, 8, 8)), want)
    np.testing.assert_array_equal(jax_from_port.normal((2, 3, 8, 8)), want)
    with pytest.raises(ValueError, match="625"):
        ours.set_state(blob[:624])


def _bin(tmp_path, n, seed, u8=False):
    rng = np.random.default_rng(seed)
    if u8:
        imgs = rng.integers(0, 256, (n, 3, 8, 8)).astype(np.float32)
        imgs = imgs / 127.5 - 1.0
    else:
        imgs = rng.standard_normal((n, 3, 8, 8)).astype(np.float32)
    path = os.path.join(tmp_path, f"d{n}_{seed}.bin")
    dataset.write_bin(path, imgs)
    return path


def test_native_loader_equals_data_loader_and_jax(lib, jax_lib, tmp_path):
    """Sequential batches wrapping at the epoch's end, from the start and
    resumed."""
    path = _bin(tmp_path, 10, 0)
    for skip in (0, 1, 5):
        ours = native.NativeLoader(path, 4, skip_batches=skip)
        assert (ours.n_images, ours.channels, ours.height, ours.width) == (
            10, 3, 8, 8)
        theirs = jax_native.NativeLoader(path, 4, skip_batches=skip)
        python = dataset.data_loader(path, 4, skip_batches=skip)
        for k in range(6):
            got = ours.next_batch()
            np.testing.assert_array_equal(got, next(python), f"{skip} {k}")
            np.testing.assert_array_equal(got, theirs.next_batch())


AUGMENTED = [
    dict(shuffle=True, flip=True),
    dict(shuffle=True, flip=True, skip_batches=7),
    dict(shuffle=False, flip=True, skip_batches=5),
    dict(shuffle=False, flip=True),
    dict(shuffle=True, flip=False, num_shards=2, shard_index=1,
         skip_batches=3),
    dict(shuffle=False, flip=True, num_shards=2, shard_index=0),
    dict(shuffle=False, flip=False)]


@pytest.mark.parametrize("kw", AUGMENTED, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_augmented_loader_equals_data_loader_and_jax(lib, jax_lib, tmp_path,
                                                     kw):
    """37 images at B=4: several epoch wraps, shards that do not divide."""
    path = _bin(tmp_path, 37, 1)
    ours = native.NativeAugmentedLoader(path, 4, seed=3, **kw)
    theirs = jax_native.NativeAugmentedLoader(path, 4, seed=3, **kw)
    python = dataset.data_loader(path, 4, seed=3, **kw)
    jax_python = jax_dataset.data_loader(path, 4, seed=3, **kw)
    for k in range(25):
        got = next(ours)
        np.testing.assert_array_equal(got, next(python), f"batch {k}")
        np.testing.assert_array_equal(got, next(theirs), f"batch {k}")
        np.testing.assert_array_equal(got, next(jax_python), f"batch {k}")


def test_next_into_writes_uint8_pixels_and_float_rows(lib, tmp_path):
    """Rows of a preallocated chunk: float32 as next_batch, uint8 as
    round((v + 1) * 127.5) of the same batch (round half to even, as
    numpy), for both loaders."""
    path = _bin(tmp_path, 20, 5, u8=True)
    for make in (lambda: native.NativeLoader(path, 4),
                 lambda: native.NativeAugmentedLoader(
                     path, 4, shuffle=True, flip=True, seed=3)):
        a, b = make(), make()
        chunk8 = np.empty((12, 4, 8, 8, 3), np.uint8)
        chunkf = np.empty((12, 4, 8, 8, 3), np.float32)
        for j in range(12):  # several epochs
            a.next_into(chunk8[j])
            b.next_into(chunkf[j])
        np.testing.assert_array_equal(
            chunk8, np.round((chunkf + 1.0) * 127.5).astype(np.uint8))
        np.testing.assert_array_equal(chunk8.astype(np.float32) / 127.5 - 1,
                                      chunkf)
    # values off the uint8 grid round half to even, as np.round
    half = np.full((4, 3, 8, 8), 0.5 / 127.5 - 1.0, np.float32)
    path = os.path.join(tmp_path, "half.bin")
    dataset.write_bin(path, half)
    out = np.empty((4, 8, 8, 3), np.uint8)
    native.NativeLoader(path, 4).next_into(out)
    np.testing.assert_array_equal(
        out, np.round((half.transpose(0, 2, 3, 1) + 1.0) * 127.5)
        .astype(np.uint8))


def test_next_into_refuses_a_wrong_array(lib, tmp_path):
    loader = native.NativeLoader(_bin(tmp_path, 8, 2), 4)
    with pytest.raises(ValueError, match="C-contiguous"):
        loader.next_into(np.empty((4, 8, 8, 4), np.float32))
    with pytest.raises(ValueError, match="C-contiguous"):
        loader.next_into(np.empty((4, 8, 3, 8), np.uint8).transpose(
            0, 1, 3, 2))


def test_undersized_dataset_raises(lib, tmp_path):
    path = _bin(tmp_path, 6, 3)
    with pytest.raises(ValueError, match="full batch"):
        native.NativeLoader(path, 8)
    with pytest.raises(ValueError, match="full batch"):
        native.NativeAugmentedLoader(path, 8, shuffle=True)
    with pytest.raises(ValueError, match="full batch"):
        native.NativeAugmentedLoader(path, 4, num_shards=2, shard_index=0)
    with pytest.raises(IOError, match="cannot open"):
        native.NativeLoader(os.path.join(tmp_path, "missing.bin"), 4)
    with pytest.raises(ValueError, match="bad epoch"):
        native.NativeLoader(_bin(tmp_path, 8, 4), 4).set_epoch(
            np.arange(3), np.zeros(3, np.uint8))


def test_build_is_keyed_by_the_source_and_reports_the_compiler(
        monkeypatch, tmp_path, lib):
    """The library's name carries the digest of source and flags, an
    existing build is reused, and a refused source raises with the
    compiler's output and leaves nothing behind."""
    assert native.build() == native.build()
    assert native._digest() in native.build().name
    bad = tmp_path / "host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.HostBuildError, match="host.cpp") as e:
        native.build()
    assert "error" in str(e.value)
    assert list((tmp_path / "build").iterdir()) == []
    monkeypatch.setattr(native, "COMPILER", str(tmp_path / "no-such-c++"))
    with pytest.raises(native.HostBuildError, match="not found"):
        native.build()
