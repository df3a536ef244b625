"""`.bin` interchange between the JAX package and the port, and the port's
sampling CLI on such a file (CPU).  The two packages write the same bytes
for the same checkpoint, so the comparisons are exact.
"""

import os

import jax
import numpy as np
import pytest
import torch

from unet_tpu.io import checkpoint as jax_ckpt
from unet_tpu_torch.cli import generate
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.io import convert
from unet_tpu_torch.models import unet as port_unet

from tests.torch_port_util import configs, flat_weights


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _full_jax_checkpoint(jcfg, cfg, num_classes):
    """A JAX-side checkpoint with every optional part: AdamW moments, EMA,
    seed, loader cursor, host RNG state, cosine schedule."""
    flats = [flat_weights(cfg, num_classes, seed=s) for s in range(4)]
    trees = [jax_ckpt.unflatten_params(f, jcfg, num_classes) for f in flats]
    rng_state = np.arange(jax_ckpt.HOST_RNG_WORDS, dtype=np.uint32) * 7
    ckpt = jax_ckpt.Checkpoint(
        params=trees[0], cfg=jcfg, batch_size=16, step=1234,
        adam_m=trees[1], adam_v=trees[2], rng_seed=99, loader_pos=77,
        host_rng_state=rng_state, ema=trees[3], ema_rate=0.999,
        noise_schedule="cosine")
    return ckpt, flats, rng_state


@pytest.mark.parametrize("num_classes", [None, 5])
def test_jax_file_loads_in_the_port_and_resaves_identical(tmp_path,
                                                          num_classes):
    jcfg, cfg = configs(use_scale_shift_norm=num_classes is not None)
    ckpt, flats, rng_state = _full_jax_checkpoint(jcfg, cfg, num_classes)
    a, b = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jax_ckpt.save(a, ckpt, num_classes)

    got = port_ckpt.load(a, device="cpu")       # cfg from the header
    assert got.cfg == cfg
    assert got.params.num_classes == num_classes
    assert (got.batch_size, got.step, got.rng_seed, got.loader_pos) == (
        16, 1234, 99, 77)
    assert got.noise_schedule == "cosine"
    assert got.ema_rate == pytest.approx(0.999, abs=1e-7)
    np.testing.assert_array_equal(port_ckpt.flatten_params(got.params),
                                  flats[0])
    np.testing.assert_array_equal(got.adam_m, flats[1])
    np.testing.assert_array_equal(got.adam_v, flats[2])
    np.testing.assert_array_equal(port_ckpt.flatten_params(got.ema), flats[3])
    np.testing.assert_array_equal(got.host_rng_state, rng_state)

    port_ckpt.save(b, got)
    assert _read(a) == _read(b)
    assert not os.path.exists(b + ".tmp")


@pytest.mark.parametrize("num_classes", [None, 5])
def test_port_file_loads_in_jax_and_resaves_identical(tmp_path, num_classes):
    jcfg, cfg = configs()
    model = convert.params_from_flat(flat_weights(cfg, num_classes, 1), cfg,
                                     num_classes, device="cpu")
    ema = convert.params_from_flat(flat_weights(cfg, num_classes, 2), cfg,
                                   num_classes, device="cpu")
    a, b = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    port_ckpt.save(a, port_ckpt.Checkpoint(
        params=model, cfg=cfg, batch_size=4, step=10, ema=ema, ema_rate=0.99))

    got = jax_ckpt.load(a)
    assert got.cfg == jcfg and got.step == 10 and got.batch_size == 4
    assert got.noise_schedule == "linear" and got.adam_m is None
    assert ("label_emb" in got.params) == (num_classes is not None)
    np.testing.assert_array_equal(
        jax_ckpt.flatten_params(got.params, jcfg, num_classes),
        port_ckpt.flatten_params(model))
    tree = jax.tree.map(np.asarray, got.ema)
    back = convert.params_from_jax(tree, cfg, num_classes, device="cpu")
    np.testing.assert_array_equal(port_ckpt.flatten_params(back),
                                  port_ckpt.flatten_params(ema))
    jax_ckpt.save(b, got, num_classes)
    assert _read(a) == _read(b)


def test_minimal_file_and_explicit_cfg(tmp_path):
    """No optional part; a file without the extension marker loads with the
    basic sizes of its header and the default architecture, or with the cfg
    the caller gives."""
    _, cfg = configs()
    model = convert.params_from_flat(flat_weights(cfg), cfg, device="cpu")
    path = str(tmp_path / "m.bin")
    port_ckpt.save(path, port_ckpt.Checkpoint(params=model, cfg=cfg,
                                              batch_size=1,
                                              noise_schedule=None))
    got = port_ckpt.load(path, device="cpu")
    assert got.noise_schedule is None and got.ema is None
    assert got.adam_m is None and got.rng_seed is None
    assert os.path.getsize(path) == 4 * (port_ckpt.HEADER_INTS
                                         + port_ckpt.num_params(cfg))
    raw = bytearray(_read(path))
    raw[12 * 4:13 * 4] = bytes(4)          # strip the marker
    plain = str(tmp_path / "plain.bin")
    with open(plain, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="truncated"):
        port_ckpt.load(plain, device="cpu")   # default arch: a larger model
    got = port_ckpt.load(plain, cfg=cfg, device="cpu")
    assert got.step == 0 and got.noise_schedule is None
    np.testing.assert_array_equal(port_ckpt.flatten_params(got.params),
                                  port_ckpt.flatten_params(model))


def test_load_refuses_bad_files(tmp_path):
    _, cfg = configs()
    path = str(tmp_path / "bad.bin")
    with open(path, "wb") as f:
        f.write(np.zeros(256, np.int32).tobytes())
    with pytest.raises(ValueError, match="magic"):
        port_ckpt.load(path, device="cpu")
    model = port_unet.init(cfg, device="cpu")
    good = str(tmp_path / "good.bin")
    port_ckpt.save(good, port_ckpt.Checkpoint(params=model, cfg=cfg,
                                              batch_size=1))
    with open(path, "wb") as f:
        f.write(_read(good)[:-8])
    with pytest.raises(ValueError, match="truncated"):
        port_ckpt.load(path, device="cpu")
    # a .pt goes to load_torch_pt, which wants a state_dict
    torch.save([1, 2], str(tmp_path / "model.pt"))
    with pytest.raises(ValueError, match="expected a state_dict"):
        port_ckpt.load(str(tmp_path / "model.pt"), device="cpu")
    with pytest.raises(ValueError, match="AdamW moment"):
        port_ckpt.save(path, port_ckpt.Checkpoint(
            params=model, cfg=cfg, batch_size=1, adam_m=np.zeros(3),
            adam_v=np.zeros(3)))
    assert not os.path.exists(path + ".tmp")


def test_header_constants_equal_the_jax_ones():
    for name in ("MAGIC", "HEADER_INTS", "EXT_MAGIC", "HOST_RNG_WORDS",
                 "_MAX_LEVELS"):
        assert getattr(port_ckpt, name) == getattr(jax_ckpt, name)


# ---------------------------------------------------------------------------
# cli.generate on a file the JAX package wrote


@pytest.fixture(scope="module")
def jax_file(tmp_path_factory):
    jcfg, cfg = configs()
    ckpt, _, _ = _full_jax_checkpoint(jcfg, cfg, 5)
    path = str(tmp_path_factory.mktemp("ckpt") / "cond.bin")
    jax_ckpt.save(path, ckpt, 5)
    return path


@pytest.mark.parametrize("flags", [
    ["--sampler", "ddim", "--ddim_steps", "3"],
    ["--sampler", "ddim", "--ddim_steps", "2", "--ddim_eta", "1.0",
     "--use_ema", "true", "--compute_dtype", "bfloat16"],
    ["--sampler", "ddim", "--ddim_steps", "2", "--class_label", "3",
     "--guidance_scale", "3.0", "--noise_schedule", "linear"],
])
def test_generate_run(jax_file, flags):
    args = generate.parse_args(["--model_filename", jax_file, "--device",
                                "cpu", "--batch_size", "2", "--seed", "4",
                                *flags])
    images = generate.run(args)
    assert images.dtype == np.uint8 and images.shape == (2, 16, 16, 3)
    assert 0 < images.mean() < 255
    np.testing.assert_array_equal(images, generate.run(args))  # seeded


def test_generate_ddpm_is_the_default_sampler(jax_file, monkeypatch):
    """No --sampler: the ancestral chain, all T - 2 steps of it (counted
    here on a stand-in model function, not run)."""
    from unet_tpu_torch.diffusion import sampler
    calls = []

    def fake(cfg, **kw):
        return lambda model, x, t: (calls.append(float(t[0])),
                                    torch.zeros_like(x))[1]

    monkeypatch.setattr(sampler, "make_model_fn", fake)
    args = generate.parse_args(["--model_filename", jax_file, "--device",
                                "cpu"])
    assert args.sampler == "ddpm" and args.batch_size == 1
    images = generate.run(args)
    assert images.shape == (1, 16, 16, 3)
    assert calls == [float(t) for t in range(999, 1, -1)]


@pytest.mark.parametrize("flags", [
    [],                                                  # no file
    ["--model_filename", "x.bin", "--sampler", "euler"],
    ["--model_filename", "x.bin", "--guidance_scale", "2.0"],
    ["--model_filename", "x.bin", "--noise_schedule", "sigmoid"],
    ["--model_filename", "x.bin", "--compute_dtype", "float16"],
])
def test_generate_parse_errors(flags, capsys):
    with pytest.raises(SystemExit) as e:
        generate.parse_args(flags)
    assert e.value.code == 2
    capsys.readouterr()


@pytest.mark.parametrize("flags", [
    ["--sampler", "ddim", "--ddim_steps", "1000"],
    ["--class_label", "5"],                              # out of range
])
def test_generate_run_errors(jax_file, flags, capsys):
    args = generate.parse_args(["--model_filename", jax_file, "--device",
                                "cpu", *flags])
    with pytest.raises(SystemExit) as e:
        generate.run(args)
    assert e.value.code == 2
    capsys.readouterr()


def test_generate_run_errors_of_an_unconditional_file(tmp_path, capsys):
    _, cfg = configs()
    path = str(tmp_path / "u.bin")
    port_ckpt.save(path, port_ckpt.Checkpoint(
        params=port_unet.init(cfg, device="cpu"), cfg=cfg, batch_size=1))
    for flags in (["--class_label", "1"], ["--use_ema", "true"]):
        args = generate.parse_args(["--model_filename", path, "--device",
                                    "cpu", *flags])
        with pytest.raises(SystemExit):
            generate.run(args)
    capsys.readouterr()


def test_generate_main_saves_an_image(jax_file, tmp_path, capsys):
    pytest.importorskip("PIL")
    from PIL import Image
    for batch, size in ((1, (16, 16)), (3, (48, 16))):
        out = str(tmp_path / f"s{batch}.png")
        generate.main(["--model_filename", jax_file, "--device", "cpu",
                       "--sampler", "ddim", "--ddim_steps", "1",
                       "--batch_size", str(batch), "--output_filename", out])
        assert Image.open(out).size == size
    assert "Saved sample" in capsys.readouterr().out
