"""The port's own copies of the JAX package's numpy-only modules, held to
them: the `.bin` dataset writer and loader give bit-identical batch streams
(shuffle, flip, shards and a resumed stream's `skip_batches`), and the
metrics logger writes the same text and CSV for the same key-value pairs."""

import io

import numpy as np
import pytest

from unet_tpu.data import dataset as jax_dataset
from unet_tpu.utils import logger as jax_logger
from unet_tpu_torch.data import dataset as port_dataset
from unet_tpu_torch.utils import logger as port_logger


@pytest.fixture
def bin_file(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (11, 3, 4, 6)).astype(np.float32)
    port_dataset.write_bin(str(tmp_path / "port.bin"), images)
    jax_dataset.write_bin(str(tmp_path / "jax.bin"), images)
    return tmp_path


def test_write_bin_and_reader_equal_the_jax_ones(bin_file):
    port = (bin_file / "port.bin").read_bytes()
    assert port == (bin_file / "jax.bin").read_bytes()
    a = port_dataset.BinDataset(str(bin_file / "port.bin"))
    b = jax_dataset.BinDataset(str(bin_file / "jax.bin"))
    assert (len(a), a.channels, a.height, a.width) == (11, 3, 4, 6)
    idx = np.array([4, 0, 9])
    np.testing.assert_array_equal(a.batch_nhwc(idx), b.batch_nhwc(idx))


@pytest.mark.parametrize("kw", [
    dict(), dict(flip=True), dict(shuffle=True), dict(shuffle=True,
                                                       flip=True, seed=3),
    dict(num_shards=2, shard_index=1), dict(shuffle=True, num_shards=2,
                                            shard_index=0, flip=True),
    dict(skip_batches=5), dict(shuffle=True, flip=True, skip_batches=7),
    dict(shuffle=True, num_shards=2, shard_index=1, skip_batches=3)])
def test_data_loader_streams_equal_the_jax_ones(bin_file, kw):
    """Twelve batches of 2 (several epochs of 11 images, or of a shard)."""
    path = str(bin_file / "port.bin")
    port = port_dataset.data_loader(path, 2, **kw)
    ref = jax_dataset.data_loader(path, 2, **kw)
    for _ in range(12):
        a, b = next(port), next(ref)
        assert a.shape == (2, 4, 6, 3) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_loader_refuses_a_dataset_shorter_than_a_batch(bin_file):
    with pytest.raises(ValueError, match="every rank"):
        next(port_dataset.data_loader(str(bin_file / "port.bin"), 6,
                                      num_shards=2))


def test_logger_output_equals_the_jax_one(tmp_path, monkeypatch):
    outs = []
    for mod, sub in ((port_logger, "port"), (jax_logger, "jax")):
        stream = io.StringIO()
        log = mod.Logger(str(tmp_path / sub), stream=stream)
        for step, loss in ((1, 0.5), (2, 0.25)):
            log.logkv("step", step)
            log.logkv("loss", loss)
            log.logkv_mean("norm", 2.0 * step)
            log.logkv_mean("norm", 4.0 * step)
            if step == 2:
                log.logkv("a_very_long_key_name_beyond_thirty_chars", 1e-9)
            log.dumpkvs()
        log.formats[1].close()
        (csv,) = (tmp_path / sub).glob("log_*.csv")
        text = mod.TextLog(str(tmp_path / f"{sub}.txt"))
        text.log("step 2: loss 0.250000 (1.00 ms/step)")
        outs.append((stream.getvalue(), csv.read_text(),
                     (tmp_path / f"{sub}.txt").read_text()))
    assert outs[0] == outs[1]
    assert "| norm " in outs[0][0] and outs[0][1].count("\n") == 3
