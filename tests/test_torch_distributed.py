"""The port's training CLI over several ranks on the CPU (gloo): one
command with `--num_devices 2`, two `--coordinator_address` processes,
FSDP with a save and a resume, class-conditional training, the SIGTERM
stop, the launcher's handling of a rank that fails, and the JAX CLI's
rules of the data axis.

Each run must reproduce the one-process run at twice the batch on the same
data (the loaders' shards and the draws for the global batch make it the
same run): logged losses within 2e-5 relative, parameters within 5e-4
(two rank counts reduce in different orders, and an AdamW step moves a
parameter by about lr whatever its gradient).  Rank 0 alone writes one
checkpoint per save, which the JAX package's loader reads at its step.
Every multi-process run is bounded (`torch_port_util.RANKS_LIMIT_S`) and
leaves no process behind.
"""

import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
from PIL import Image

from unet_tpu.io import checkpoint as jax_ckpt
from unet_tpu_torch.cli import train as port_cli
from unet_tpu_torch.data.dataset import write_bin
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.parallel import distributed

from tests.torch_port_util import (RANKS_LIMIT_S, ROOT, TINY, configs,
                                   run_ranks)

MODEL = ["--num_channels", str(TINY["model_channels"]),
         "--image_size", str(TINY["image_size"]), "--channel_mult", "1,2",
         "--num_res_blocks", "1", "--attention_resolutions", "8",
         "--device", "cpu", "--lr", "1e-4", "--ema_rate", "0.9",
         "--log_interval", "2", "--save_interval", "2"]
TRAIN = [sys.executable, "-m", "unet_tpu_torch.cli.train"]
LOSS = re.compile(r"step (\d+): loss (\S+)")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A .bin of 20 images written from uint8 pixels (the chunked path
    sends them as uint8), and the one-process run at batch 4, 4 steps."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(5)
    pixels = rng.integers(0, 256, (20, 3, TINY["image_size"],
                                   TINY["image_size"]))
    write_bin(str(root / "d.bin"),
              (pixels / 127.5 - 1.0).astype(np.float32))
    port_cli.main(_flags(root, "one", "--batch_size", "4", "--iterations",
                         "4"))
    return root


def _flags(root, name, *extra):
    return ["--data_file", str(root / "d.bin"), *MODEL,
            "--output_dir", str(root / name),
            "--log_file", str(root / f"{name}.txt"), *extra]


def _losses(root, name):
    return [(int(s), float(v)) for s, v in
            LOSS.findall((root / f"{name}.txt").read_text())]


def _assert_reproduces_one_process(root, name, logged=(2, 4),
                                   saved=(2, 4), ref="one"):
    """The run `name` logged the losses of the run `ref` at the steps
    `logged` and left the checkpoints of the steps `saved`, and only
    those, the last at the same parameters."""
    got, want = _losses(root, name), dict(_losses(root, ref))
    assert [s for s, _ in got] == list(logged), got
    np.testing.assert_allclose([v for _, v in got],
                               [want[s] for s in logged], rtol=2e-5)
    assert sorted(os.listdir(root / name)) == sorted(
        f"model_{s}.bin" for s in saved)
    last = f"model_{saved[-1]}.bin"
    a = port_ckpt.load(str(root / name / last), device="cpu")
    b = port_ckpt.load(str(root / ref / last), device="cpu")
    assert a.step == b.step == saved[-1] and a.batch_size == 2
    for x, y in ((port_ckpt.flatten_params(a.params),
                  port_ckpt.flatten_params(b.params)),
                 (a.adam_m, b.adam_m), (a.adam_v, b.adam_v),
                 (port_ckpt.flatten_params(a.ema),
                  port_ckpt.flatten_params(b.ema))):
        np.testing.assert_allclose(x, y, atol=5e-4)
    jcfg, _ = configs()
    j = jax_ckpt.load(str(root / name / last), jcfg)
    assert j.step == saved[-1]
    np.testing.assert_array_equal(
        jax_ckpt.flatten_params(j.params, jcfg, a.params.num_classes),
        port_ckpt.flatten_params(a.params))


def _launch(root, name, *extra):
    """One `cli.train` command of 2 ranks, in a child process."""
    codes, text = run_ranks(lambda port: [[*TRAIN, *_flags(
        root, name, "--batch_size", "2", "--num_devices", "2", *extra)]],
        [root / f"{name}.out"])
    assert codes == [0], text[-4000:]
    return text


def test_num_devices_2_is_one_process_at_twice_the_batch(data):
    out = _launch(data, "two", "--iterations", "4")
    assert "data parallel: 2 rank(s) x batch 2 = global batch 4" in out
    _assert_reproduces_one_process(data, "two")


def test_coordinator_processes_are_one_process_at_twice_the_batch(data):
    def argvs(port):
        return [[*TRAIN, *_flags(
            data, "coord", "--batch_size", "2", "--iterations", "4",
            "--coordinator_address", f"localhost:{port}",
            "--num_processes", "2", "--process_id", str(r))]
            for r in range(2)]

    codes, text = run_ranks(argvs, [data / f"coord{r}.out" for r in range(2)])
    assert codes == [0, 0], text[-4000:]
    _assert_reproduces_one_process(data, "coord")


def test_fsdp_saves_and_resumes_the_one_process_run(data):
    out = _launch(data, "fsdp", "--fsdp", "true", "--iterations", "2")
    assert "param sharding: 100.0% of elements sharded (fsdp)" in out
    _launch(data, "fsdp", "--fsdp", "true", "--iterations", "4",
            "--model_weights", str(data / "fsdp" / "model_2.bin"))
    # the second run truncated the log: it logged step 4 only
    _assert_reproduces_one_process(data, "fsdp", logged=(4,))


def test_class_cond_num_devices_2_is_one_process_at_twice_the_batch(
        tmp_path):
    rng = np.random.default_rng(3)
    images = tmp_path / "images"
    images.mkdir()
    for i in range(12):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
                        ).save(images / f"{'cat' if i % 3 else 'dog'}_{i}.png")
    common = ["--data_dir", str(images), "--class_cond", "true",
              "--num_classes", "2", "--label_dropout", "0.5",
              "--randomize", "true", "--iterations", "4"]
    port_cli.main(["--data_file", "", *MODEL, "--output_dir",
                   str(tmp_path / "one"), "--log_file",
                   str(tmp_path / "one.txt"), "--batch_size", "4", *common])
    codes, text = run_ranks(lambda port: [[
        *TRAIN, "--data_file", "", *MODEL, "--output_dir",
        str(tmp_path / "two"), "--log_file", str(tmp_path / "two.txt"),
        "--batch_size", "2", "--num_devices", "2", *common]],
        [tmp_path / "two.out"])
    assert codes == [0], text[-4000:]
    _assert_reproduces_one_process(tmp_path, "two")


def test_sigterm_stops_every_rank_at_one_step_and_saves(data):
    """SIGTERM to the command that launched 2 FSDP ranks: both stop at one
    step, join the gather, rank 0 saves; the command exits 0, and
    `--auto_resume` continues from that checkpoint."""
    name = "term"
    log = data / f"{name}.txt"
    with open(data / f"{name}.out", "wb") as f:
        proc = subprocess.Popen(
            [*TRAIN, *_flags(data, name, "--batch_size", "2",
                             "--num_devices", "2", "--fsdp", "true",
                             "--iterations", "100000", "--save_interval",
                             "0")],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL, env=dict(os.environ,
                                               OMP_NUM_THREADS="1"))
        try:
            deadline = time.monotonic() + RANKS_LIMIT_S
            while not (log.exists() and "step 2:" in log.read_text()):
                assert proc.poll() is None, (data / f"{name}.out"
                                             ).read_text()[-4000:]
                assert time.monotonic() < deadline, "no log line"
                time.sleep(0.1)
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=max(deadline - time.monotonic(), 1))
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    assert proc.returncode == 0, (data / f"{name}.out").read_text()[-4000:]
    caught = re.search(r"caught signal 15 at step (\d+)", log.read_text())
    assert caught, log.read_text()
    step = int(caught.group(1))
    assert sorted(os.listdir(data / name)) == [f"model_{step}.bin"]
    assert port_ckpt.load(str(data / name / f"model_{step}.bin"),
                          device="cpu").step == step
    # the same command with --auto_resume: rank 0 finds the checkpoint, the
    # other rank follows
    out = _launch(data, name, "--fsdp", "true", "--iterations",
                  str(step + 2), "--auto_resume", "true")
    assert f"auto-resume: {data / name / f'model_{step}.bin'}" in out
    assert _losses(data, name)[-1][0] == step + 2
    assert (data / name / f"model_{step + 2}.bin").exists()


def test_launch_stops_the_other_ranks_when_one_fails(tmp_path, capfd):
    """Rank 1 exits 3 at once; rank 0 would sleep a minute.  The launcher
    kills rank 0, shows rank 1's output and exits non-zero, in seconds."""
    pid_file = tmp_path / "rank0.pid"
    code = (f"import os, sys, time\n"
            f"rank = os.environ[{distributed.LAUNCH_ENV!r}].split(',')[2]\n"
            f"if rank == '1':\n"
            f"    print('rank 1 gives up'); sys.exit(3)\n"
            f"open({str(pid_file)!r}, 'w').write(str(os.getpid()))\n"
            f"time.sleep(60)\n")
    t0 = time.monotonic()
    with pytest.raises(distributed.LaunchError, match="rank 1 of 2 failed"):
        distributed.launch([sys.executable, "-c", code], 2)
    assert time.monotonic() - t0 < 30
    assert "rank 1 gives up" in capfd.readouterr().err
    if pid_file.exists():  # rank 0 got as far as writing it
        with pytest.raises(ProcessLookupError):
            os.kill(int(pid_file.read_text()), 0)


def test_num_devices_0_names_the_devices_it_found(data, capsys):
    port_cli.main(_flags(data, "zero", "--batch_size", "4", "--iterations",
                         "2", "--num_devices", "0"))
    assert "--num_devices 0: 1 visible device(s) of --device cpu" in (
        capsys.readouterr().out)


COORD = ["--coordinator_address", "localhost:1", "--num_processes", "2",
         "--process_id", "0"]


@pytest.mark.parametrize("flags,message", [
    (["--num_devices", "2", "--host_rng", "true"],
     "--host_rng is only wired for single-device runs (--num_devices 1)"),
    (["--num_devices", "2", "--log_norms", "true"],
     "--log_norms is only wired for single-device runs (--num_devices 1)"),
    (["--fsdp", "true"], "--fsdp needs >= 2 devices on the data axis"),
    ([*COORD, "--fsdp", "true", "--host_rng", "true"],
     "--host_rng is only wired for single-device runs"),
    ([*COORD, "--class_cond", "true", "--data_dir", "d"],
     "--class_cond is only wired for single-process runs"),
    ([*COORD, "--data_dir", "d"], "--data_dir has no shard support"),
    ([*COORD, "--num_devices", "1"],
     "--num_devices 1 conflicts with --coordinator_address"),
    ([*COORD, "--num_devices", "3"],
     "--num_devices 3 would build a mesh over a subset"),
    ([*COORD, "--num_shards", "3"],
     "--num_shards is assigned per process automatically"),
    (["--coordinator_address", "localhost:1"],
     "--coordinator_address needs --num_processes N and --process_id"),
    (["--num_processes", "2", "--process_id", "1"],
     "--num_processes and --process_id need --coordinator_address"),
    (["--num_devices", "2", "--device", "cuda:0"],
     "--num_devices 2 takes --device cuda or cpu without an index"),
    (["--num_devices", "-1"], "--num_devices must be >= 0"),
])
def test_data_axis_bad_combos_exit_with_their_message(data, flags, message):
    with pytest.raises(SystemExit) as exit_:
        port_cli.main(_flags(data, "bad", "--batch_size", "2", *flags))
    assert str(exit_.value).startswith(f"train: {message}"), exit_.value
