"""The port's data and checkpoint surface and the training CLI's flags of
it, against the JAX package's, on the CPU at `TINY` sizes: `images_to_bin`
and `prepare_data` (the same bytes), `image_dir_loader` (the same batches
and labels), `load_torch_pt` (the same parameters), and `cli.train`'s
`--host_rng`, `--class_cond`, `--auto_resume`, `--native_loader` and the
SIGTERM save.

Where the JAX CLI is run, its step functions are stand-ins that record what
they are handed (no JAX model is compiled): what is compared is what each
CLI feeds its step.
"""

import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

from unet_tpu.cli import prepare_data as jax_prepare
from unet_tpu.cli import train as jax_cli
from unet_tpu.data import dataset as jax_dataset
from unet_tpu.io import checkpoint as jax_ckpt
from unet_tpu.training import trainer as jax_trainer
from unet_tpu_torch.cli import prepare_data
from unet_tpu_torch.cli import train as port_cli
from unet_tpu_torch.data import dataset
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.models import unet as port_unet
from unet_tpu_torch.training import trainer
from unet_tpu_torch.utils import native

from tests.torch_port_util import (TINY, configs, flat_weights,
                                   jax_native_library)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = TINY["image_size"]


@pytest.fixture(scope="module", autouse=True)
def jax_lib(tmp_path_factory):
    return jax_native_library(tmp_path_factory.mktemp("jax_native"))


def _write_images(root, names, size=8, seed=0):
    """PIL-written RGB images, one per name (its extension picks the
    format); a name may hold a subdirectory."""
    rng = np.random.default_rng(seed)
    for name in names:
        path = os.path.join(root, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        w, h = size if isinstance(size, tuple) else (size, size)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(path)
    return root


@pytest.fixture
def image_dir(tmp_path):
    """Nine images of two classes (file-name prefixes), png and jpg, one in
    a subdirectory, one non-square (centre crop + bicubic resize)."""
    d = tmp_path / "images"
    _write_images(str(d), ["cat_0.png", "cat_1.jpg", "dog_0.png",
                           "dog_1.png", "sub/cat_2.png", "dog_2.jpeg",
                           "cat_3.png", "dog_3.png"], size=SIZE, seed=1)
    _write_images(str(d), ["dog_4.png"], size=(SIZE + 7, SIZE - 3), seed=2)
    (d / "notes.txt").write_text("not an image")
    return str(d)


@pytest.mark.parametrize("size", [SIZE, 8])
def test_images_to_bin_writes_the_jax_bytes(image_dir, tmp_path, size):
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    assert dataset.images_to_bin(image_dir, str(ours), size=size) == 9
    assert jax_dataset.images_to_bin(image_dir, str(theirs), size=size) == 9
    assert ours.read_bytes() == theirs.read_bytes()
    assert ours.stat().st_size == 1024 + 9 * 3 * size * size * 4
    assert dataset._list_images(image_dir) == jax_dataset._list_images(
        image_dir)


def test_prepare_data_cli_writes_the_jax_file(image_dir, tmp_path, capsys):
    ours, theirs = tmp_path / "ours.bin", tmp_path / "theirs.bin"
    prepare_data.main(["--data_dir", image_dir, "--output_name", str(ours),
                       "--size", "12"])
    jax_prepare.main(["--data_dir", image_dir, "--output_name", str(theirs),
                      "--size", "12"])
    assert ours.read_bytes() == theirs.read_bytes()
    assert f"wrote 9 images to {ours}" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        prepare_data.main([])


@pytest.mark.parametrize("kw", [
    dict(), dict(class_cond=True), dict(randomize=True, seed=3),
    dict(class_cond=True, randomize=True, seed=5, skip_batches=3),
    dict(randomize=True, skip_batches=9)], ids=lambda kw: "-".join(
        f"{k}={v}" for k, v in kw.items()) or "plain")
def test_image_dir_loader_equals_jax(image_dir, kw):
    """Two images a batch: four batches an epoch (one image left over),
    several epochs."""
    ours = dataset.image_dir_loader(image_dir, 2, size=SIZE, **kw)
    theirs = jax_dataset.image_dir_loader(image_dir, 2, size=SIZE, **kw)
    for k in range(10):
        a, b = next(ours), next(theirs)
        if kw.get("class_cond"):
            (a, ya), (b, yb) = a, b
            np.testing.assert_array_equal(ya, yb, f"labels {k}")
            assert ya.dtype == np.int32 and set(ya) <= {0, 1}
        assert a.shape == (2, SIZE, SIZE, 3) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b, f"batch {k}")


def test_image_dir_loader_refuses_an_empty_or_short_directory(tmp_path):
    _write_images(str(tmp_path / "two"), ["a_0.png", "a_1.png"], size=SIZE)
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no images"):
        next(dataset.image_dir_loader(str(tmp_path / "empty"), 2))
    with pytest.raises(ValueError, match="full batch"):
        next(dataset.image_dir_loader(str(tmp_path / "two"), 4))


def _state_dict(cfg, num_classes=None, seed=0, prefix=""):
    """A state_dict of seeded weights as the guided-diffusion torch model
    holds them: keys in `param_order`, an attention projection as a
    Conv1d's (O, I, 1)."""
    flat = flat_weights(cfg, num_classes, seed)
    shapes = port_ckpt._shape_model(cfg, num_classes)
    state, offset = {}, 0
    for path, kind in port_unet.param_order(cfg, num_classes):
        shape = tuple(port_unet.get_param(shapes, path).shape)
        shape += (1,) if kind == "conv1d" else ()
        n = int(np.prod(shape))
        state[prefix + ".".join(map(str, path))] = torch.from_numpy(
            flat[offset:offset + n].reshape(shape).copy())
        offset += n
    return state, flat


@pytest.mark.parametrize("num_classes, prefix, suffix", [
    (None, "", ".pt"), (3, "_orig_mod.", ".pth")])
def test_load_torch_pt_equals_jax(tmp_path, num_classes, prefix, suffix):
    jcfg, cfg = configs()
    state, flat = _state_dict(cfg, num_classes, prefix=prefix)
    path = str(tmp_path / f"m{suffix}")
    torch.save(state, path)
    ours = port_ckpt.load(path, cfg, num_classes, device="cpu")
    theirs = jax_ckpt.load(path, jcfg, num_classes)
    np.testing.assert_array_equal(port_ckpt.flatten_params(ours.params), flat)
    np.testing.assert_array_equal(
        jax_ckpt.flatten_params(theirs.params, jcfg, num_classes), flat)
    assert ours.params.num_classes == num_classes
    assert (ours.step, ours.batch_size, ours.adam_m, ours.noise_schedule) \
        == (0, 0, None, None)
    assert port_ckpt.read_config(path) == type(cfg)()


def test_load_torch_pt_refuses_a_wrong_count_or_shape(tmp_path):
    _, cfg = configs()
    state, _ = _state_dict(cfg)
    keys = list(state)
    short = {k: state[k] for k in keys[:-1]}
    torch.save(short, tmp_path / "short.pt")
    with pytest.raises(ValueError, match="tensors, model expects"):
        port_ckpt.load(str(tmp_path / "short.pt"), cfg, device="cpu")
    swapped = dict(state)
    swapped[keys[0]], swapped[keys[2]] = state[keys[2]], state[keys[0]]
    torch.save(swapped, tmp_path / "swapped.pt")
    with pytest.raises(ValueError, match="has shape"):
        port_ckpt.load(str(tmp_path / "swapped.pt"), cfg, device="cpu")
    torch.save([1, 2], tmp_path / "list.pt")
    with pytest.raises(ValueError, match="expected a state_dict"):
        port_ckpt.load(str(tmp_path / "list.pt"), cfg, device="cpu")


def _flags(data, out, *extra):
    """A TINY model on the CPU, two images a batch."""
    return ["--device", "cpu", "--num_channels", str(TINY["model_channels"]),
            "--image_size", str(SIZE), "--channel_mult", "1,2",
            "--num_res_blocks", "1", "--attention_resolutions", "8",
            "--batch_size", "2", "--lr", "1e-3", "--output_dir", str(out),
            "--log_file", str(out) + ".txt", *data, *extra]


@pytest.fixture
def bin_file(tmp_path):
    """Ten images made from uint8 pixels (the chunked path ships uint8)."""
    rng = np.random.default_rng(16)
    pixels = rng.integers(0, 256, (10, 3, SIZE, SIZE)).astype(np.float32)
    path = tmp_path / "data.bin"
    dataset.write_bin(str(path), pixels / 127.5 - 1.0)
    return ["--data_file", str(path)]


def _recording_steps(monkeypatch, module, fed, jax_side):
    """Wrap `module.make_train_step` so that each step records what it is
    handed, as numpy; on the JAX side the steps are stand-ins that return
    the state and a zero loss."""
    real = module.make_train_step

    def make(*args, **kwargs):
        train_step, step_with = (None, None) if jax_side else real(
            *args, **kwargs)

        def rec_train(state, batch, y=None):
            fed.append(("train", np.asarray(batch),
                        None if y is None else np.asarray(y)))
            return (state, 0.0) if jax_side else train_step(state, batch, y)

        def rec_with(state, batch, t, noise, y=None):
            fed.append(("with", np.asarray(batch), np.asarray(t),
                        np.asarray(noise)))
            return (state, 0.0) if jax_side else step_with(
                state, batch, t, noise, y)

        return rec_train, rec_with

    monkeypatch.setattr(module, "make_train_step", make)


def test_host_rng_feeds_the_jax_draws_and_resumes_bit_identically(
        monkeypatch, tmp_path, bin_file, capsys):
    """The timesteps and noise the port's CLI hands `step_with` are the JAX
    CLI's (the same TorchRng calls, NCHW noise laid out NHWC), and 2 steps
    + a resume for 2 more equal 4 straight steps: losses, parameters and
    the 625-word blob."""
    fed, jax_fed = [], []
    _recording_steps(monkeypatch, trainer, fed, False)
    _recording_steps(monkeypatch, jax_trainer, jax_fed, True)
    common = ("--host_rng", "true", "--iterations", "4", "--log_interval",
              "1", "--save_interval", "2", "--seed", "9")
    port_cli.main(_flags(bin_file, tmp_path / "straight", *common,
                         "--native_loader", "false"))
    jax_cli.main(_flags(bin_file, tmp_path / "jax", *common,
                        "--save_interval", "0", "--native_loader", "false",
                        "--num_devices", "1")[2:])
    assert len(fed) == len(jax_fed) == 4
    for (_, batch, t, noise), (_, jbatch, jt, jnoise) in zip(fed, jax_fed):
        assert t.dtype == np.float32 and noise.shape == (2, SIZE, SIZE, 3)
        np.testing.assert_array_equal(batch, jbatch)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(noise, jnoise)

    port_cli.main(_flags(bin_file, tmp_path / "cut", *common, "--iterations",
                         "2"))
    port_cli.main(_flags(bin_file, tmp_path / "cut", *common,
                         "--model_weights",
                         str(tmp_path / "cut" / "model_2.bin")))
    assert "loaded" in capsys.readouterr().out
    for k in range(4):  # the resumed run's draws are the straight run's
        np.testing.assert_array_equal(fed[4 + k][2], fed[k][2])
        np.testing.assert_array_equal(fed[4 + k][3], fed[k][3])
    logs = [(tmp_path / f"{name}.txt").read_text()
            for name in ("straight", "cut")]
    losses = [re.findall(r"step (\d+): loss (\S+)", log) for log in logs]
    # the resumed run's log holds its own steps, 3 and 4
    assert losses[0][2:] == losses[1] and len(losses[0]) == 4
    a = port_ckpt.load(str(tmp_path / "straight" / "model_4.bin"),
                       device="cpu")
    b = port_ckpt.load(str(tmp_path / "cut" / "model_4.bin"), device="cpu")
    assert a.host_rng_state.shape == (625,)
    np.testing.assert_array_equal(a.host_rng_state, b.host_rng_state)
    np.testing.assert_array_equal(port_ckpt.flatten_params(a.params),
                                  port_ckpt.flatten_params(b.params))
    rng = native.TorchRng(9)  # four steps' draws from the seed
    for _ in range(4):
        rng.timesteps(2, 1000)
        rng.normal((2, 3, SIZE, SIZE))
    np.testing.assert_array_equal(a.host_rng_state, rng.get_state())
    j = jax_ckpt.load(str(tmp_path / "straight" / "model_2.bin"))
    np.testing.assert_array_equal(
        j.host_rng_state,
        port_ckpt.load(str(tmp_path / "straight" / "model_2.bin"),
                       device="cpu").host_rng_state)


def test_class_cond_trains_from_an_image_directory_as_jax_feeds_it(
        monkeypatch, tmp_path, image_dir):
    """--data_dir --class_cond --label_dropout: the batches and labels the
    port's CLI hands its step are the JAX CLI's, the step trains, and the
    checkpoint carries the label embedding (loadable by the JAX
    package)."""
    fed, jax_fed = [], []
    _recording_steps(monkeypatch, trainer, fed, False)
    _recording_steps(monkeypatch, jax_trainer, jax_fed, True)
    common = ("--data_dir", image_dir, "--class_cond", "true",
              "--num_classes", "2", "--label_dropout", "0.5",
              "--randomize", "true", "--iterations", "3",
              "--log_interval", "1")
    state = port_cli.main(_flags([], tmp_path / "ours", *common,
                                 "--save_interval", "3"))
    jax_cli.main(_flags([], tmp_path / "jax", *common, "--save_interval",
                        "0", "--num_devices", "1")[2:])
    assert len(fed) == len(jax_fed) == 3 and state.step == 3
    for (kind, batch, y), (_, jbatch, jy) in zip(fed, jax_fed):
        assert kind == "train" and y is not None
        np.testing.assert_array_equal(batch, jbatch)
        np.testing.assert_array_equal(y, jy)
    losses = re.findall(r"step \d+: loss (\S+)",
                        (tmp_path / "ours.txt").read_text())
    assert len(losses) == 3 and all(np.isfinite(float(v)) for v in losses)
    path = str(tmp_path / "ours" / "model_3.bin")
    assert port_ckpt.load(path, device="cpu").params.num_classes == 2
    jcfg, _ = configs()
    assert "label_emb" in jax_ckpt.load(path, jcfg).params


def test_auto_resume_takes_the_newest_checkpoint(tmp_path, bin_file, capsys):
    out = tmp_path / "models"
    assert port_cli._newest_checkpoint(str(out)) is None
    port_cli.main(_flags(bin_file, out, "--iterations", "4",
                         "--log_interval", "2", "--save_interval", "2"))
    (out / "model_10.bin.tmp").write_bytes(b"")  # no checkpoint
    assert port_cli._newest_checkpoint(str(out)) == str(out / "model_4.bin")
    capsys.readouterr()
    state = port_cli.main(_flags(bin_file, out, "--iterations", "6",
                                 "--log_interval", "2", "--save_interval",
                                 "2", "--auto_resume", "true"))
    printed = capsys.readouterr().out
    assert f"auto-resume: {out / 'model_4.bin'}" in printed
    assert "(step 4)" in printed and state.step == 6
    assert (out / "model_6.bin").exists()
    # by step number, not by name: model_10 is newer than model_9
    for step in (9, 10):
        os.link(out / "model_6.bin", out / f"model_{step}.bin")
    assert port_cli._newest_checkpoint(str(out)) == str(out / "model_10.bin")
    # a fresh directory starts fresh
    port_cli.main(_flags(bin_file, tmp_path / "empty", "--iterations", "2",
                         "--log_interval", "2", "--save_interval", "2",
                         "--auto_resume", "true"))
    assert "fresh init" in capsys.readouterr().out


@pytest.mark.parametrize("augment", [[], ["--randomize", "true"]],
                         ids=["sequential", "randomize"])
def test_native_loader_serves_the_cli_and_trains_as_data_loader(
        monkeypatch, tmp_path, bin_file, augment):
    """--native_loader true (the default) reads through the host library's
    loaders, on the chunked path straight into the staging buffer (uint8),
    and trains to the very parameters `data_loader` gives."""
    made = []

    def counted(cls):
        class Counted(cls):
            def __init__(self, *args, **kwargs):
                made.append(cls.__name__)
                super().__init__(*args, **kwargs)
        return Counted

    for name in ("NativeLoader", "NativeAugmentedLoader"):
        monkeypatch.setattr(native, name, counted(getattr(native, name)))
    runs = {}
    for loader in ("true", "false"):
        out = tmp_path / f"native_{loader}"
        runs[loader] = port_cli.main(_flags(
            bin_file, out, *augment, "--native_loader", loader,
            "--iterations", "6", "--log_interval", "2",
            "--save_interval", "6"))
        assert "H2D encoding: uint8" in (tmp_path / f"{out.name}.txt"
                                         ).read_text()
    # the augmented loader reads through a NativeLoader of its own
    assert made == (["NativeAugmentedLoader", "NativeLoader"] if augment
                    else ["NativeLoader"])
    for a, b in zip(runs["true"].params.parameters(),
                    runs["false"].params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_chunk_stager_buffer_is_what_send_returns_on_the_cpu():
    stager = port_cli._ChunkStager(torch.device("cpu"))
    buf = stager.buffer((2, 1, 2, 2, 3), np.uint8)
    buf[...] = 7
    out = stager.send()
    assert out.dtype == torch.uint8 and int(out.sum()) == 7 * 24
    chunk = np.ones((2, 1, 2, 2, 3), np.float32)
    assert torch.equal(stager.put(chunk), torch.from_numpy(chunk))


_CHILD = """
import sys
sys.path.insert(0, {root!r})
from unet_tpu_torch.cli import train
train.main({argv!r})
"""


def test_sigterm_saves_a_resumable_checkpoint_and_exits_0(tmp_path,
                                                         bin_file):
    """A trainer in a child process gets SIGTERM after its first log line:
    it exits 0, logs the signal, and leaves exactly the checkpoint of the
    step it stopped at, from which --auto_resume continues."""
    out = tmp_path / "models"
    argv = _flags(bin_file, out, "--iterations", "100000", "--log_interval",
                  "2", "--save_interval", "0")
    log = tmp_path / "models.txt"
    child_out = tmp_path / "child.out"
    with open(child_out, "w") as f:  # a file, never a pipe nobody reads
        proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD.format(root=ROOT, argv=argv)],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 120
            while not (log.exists() and "step 2:" in log.read_text()):
                assert proc.poll() is None, child_out.read_text()
                assert time.time() < deadline, "no log line in 120 s"
                time.sleep(0.1)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, child_out.read_text()
    caught = re.search(r"caught signal 15 at step (\d+)", log.read_text())
    assert caught, log.read_text()
    step = int(caught.group(1))
    assert sorted(os.listdir(out)) == [f"model_{step}.bin"]
    ckpt = port_ckpt.load(str(out / f"model_{step}.bin"), device="cpu")
    assert ckpt.step == step and ckpt.adam_m is not None

    handlers = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    state = port_cli.main(_flags(bin_file, out, "--iterations", str(step + 2),
                                 "--log_interval", "2", "--save_interval",
                                 "2", "--auto_resume", "true"))
    assert state.step == step + 2
    assert (out / f"model_{step + 2}.bin").exists()
    # the handlers main() installed are gone again
    assert handlers == [signal.getsignal(s)
                        for s in (signal.SIGTERM, signal.SIGINT)]
