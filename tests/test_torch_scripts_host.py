"""The port's host-side scripts on the CPU: `scripts.profile_input_pipeline`
(the chunked path's host phases, at a tiny size) and
`scripts.make_demo_dataset` (the JAX script's bytes).
"""

import importlib.util
import math
import os
import sys

import numpy as np
import pytest

from unet_tpu.cli import prepare_data as jax_prepare_data
from unet_tpu_torch.config import TrainConfig
from unet_tpu_torch.data.dataset import write_bin
from unet_tpu_torch.scripts import make_demo_dataset, profile_input_pipeline

from tests.torch_port_util import ROOT, TINY, configs


def _jax_script(name):
    """scripts/<name>.py of the JAX package (no package of its own)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_profile_input_pipeline_reports_every_phase(tmp_path):
    """One chunk of two steps after the warm-up chunk: every phase timed,
    no dispatch split on the CPU (there is no graph), finite losses."""
    _, cfg = configs()
    pixels = np.random.default_rng(0).integers(
        0, 256, (8, 3, TINY["image_size"], TINY["image_size"]))
    data = str(tmp_path / "d.bin")
    write_bin(data, (pixels / 127.5 - 1.0).astype(np.float32))
    tc = TrainConfig(batch_size=2, compute_dtype="bfloat16", ema_rate=0.999,
                     shuffle=True)
    out = profile_input_pipeline.profile(cfg, tc, data, "cpu", chunks=1, k=2)
    assert set(out["ms_per_step"]) == {"dispatch", "assemble", "stage",
                                       "drain", "total"}
    assert all(v > 0 for v in out["ms_per_step"].values()), out
    assert out["dispatch_split_ms_per_step"] is None
    assert (out["steps"], out["bare_replays"]) == (4, 0)
    assert out["device"] == "cpu" and out["compute_dtype"] == "bfloat16"
    assert len(out["losses"]) == 2 and all(map(math.isfinite,
                                               out["losses"]))


def test_make_demo_dataset_writes_the_jax_scripts_bytes(tmp_path):
    jax_script = _jax_script("make_demo_dataset")
    flags = ["--n", "6", "--size", "16", "--seed", "0"]
    jax_script.main(["--out", str(tmp_path / "jax.bin"), *flags])
    make_demo_dataset.main(["--out", str(tmp_path / "port.bin"),
                            "--keep_crops", str(tmp_path / "crops"), *flags])
    got = (tmp_path / "port.bin").read_bytes()
    assert got == (tmp_path / "jax.bin").read_bytes()
    assert len(got) == 1024 + 6 * 3 * 16 * 16 * 4
    assert sorted(os.listdir(tmp_path / "crops"))[0].startswith("000000_")
    # the crops pass through the JAX package's prepare_data to the same file
    jax_prepare_data.main(["--data_dir", str(tmp_path / "crops"),
                           "--output_name", str(tmp_path / "again.bin"),
                           "--size", "16"])
    assert (tmp_path / "again.bin").read_bytes() == got


def test_make_demo_dataset_skips_only_a_missing_package(monkeypatch):
    """A source is left out when its package is not installed; an error of
    an installed one is raised; no source at all ends the program."""
    everything = [name for name, _ in make_demo_dataset.source_images()]
    assert everything == ["china", "flower", "hopper"]
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    assert [n for n, _ in make_demo_dataset.source_images()] == ["hopper"]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="no bundled source photos"):
        make_demo_dataset.source_images()
    monkeypatch.undo()

    def broken():
        raise OSError("unreadable sample image")

    import sklearn.datasets
    monkeypatch.setattr(sklearn.datasets, "load_sample_images", broken)
    with pytest.raises(OSError, match="unreadable"):
        make_demo_dataset.source_images()
