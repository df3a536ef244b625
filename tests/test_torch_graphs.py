"""The port's captured paths, on the CPU, where they run the same code
eagerly: the launch-count bookkeeping of `utils/graphs.Graph` under a
stand-in capture and replay, the uint8 input of `make_multi_step`, the
training CLI's chunked path against its per-step path (a bit-identical
resume included), and the table-driven sampler steps against the loops
they replaced (kept here as the reference) and the JAX samplers.

Tolerances: the uint8 rebuild within 1 ulp of what `write_bin` stored (the
JAX package's claim for its own), the chunked losses within 1e-6 relative of
the per-step ones (the JAX package's tests/test_train.py for its scan); the
sampler steps bit for bit against the old loops, and the JAX samplers at
tests/test_torch_sampler.py's 1e-3.
"""

import argparse
import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.diffusion import gaussian as jax_gaussian
from unet_tpu.diffusion import sampler as jax_sampler
from unet_tpu_torch.cli import train as port_cli
from unet_tpu_torch.config import TrainConfig
from unet_tpu_torch.data.dataset import BinDataset, write_bin
from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule)
from unet_tpu_torch.diffusion import sampler as port_sampler
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.ops.kernels import attention, groupnorm
from unet_tpu_torch.training import trainer
from unet_tpu_torch.utils import graphs

from tests.torch_port_util import TINY, both_models, configs, j2n, t2n


class _StandIn(graphs.Graph):
    """A `Graph` on a CUDA device whose capture runs the function (so the
    Python wrappers count, as they do at a real capture) and whose replay
    only notes that it happened."""

    def _warm_up(self):
        self.fn()
        self._warm = True

    def _record(self):
        self.fn()
        outer = self

        class Replay:
            def replay(self):
                outer.replays += 1
        return Replay()


@pytest.fixture
def zero_counts():
    saved = graphs.launch_counts()
    for fn in graphs.COUNTED:
        fn.launches = 0
    yield
    for fn in graphs.COUNTED:
        fn.launches = saved[fn.__name__]


def test_a_graph_adds_what_it_holds_on_every_replay(zero_counts):
    ran = []

    def step():  # two GroupNorm launches and one attention launch
        ran.append(1)
        groupnorm.gn_act_fwd.launches += 2
        attention.qkv_attention_fwd.launches += 1

    graph = _StandIn(step, torch.device("cuda"))
    graph.replays = 0
    graph()  # warm-up: runs, and its launches count
    assert graph.graph is None and graphs.launch_counts()["gn_act_fwd"] == 2
    graph()  # capture (counted, then taken back) and one replay
    assert graph.held == {"gn_act_fwd": 2, "gn_act_bwd": 0,
                          "qkv_attention_fwd": 1, "qkv_attention_bwd": 0,
                          "conv3x3_hwbc": 0, "gn_stats": 0, "gn_apply": 0,
                          "gn_bwd_sums": 0, "gn_bwd_dx": 0}
    for _ in range(3):
        graph()
    assert len(ran) == 2 and graph.replays == 4
    counts = graphs.launch_counts()
    assert (counts["gn_act_fwd"], counts["qkv_attention_fwd"]) == (10, 5)


def test_a_failed_capture_raises_and_counts_nothing(zero_counts):
    calls = []

    def step():
        calls.append(1)
        groupnorm.gn_act_bwd.launches += 1
        if len(calls) == 2:
            raise RuntimeError("operation not permitted when capturing")

    graph = _StandIn(step, torch.device("cuda"))
    graph()
    with pytest.raises(RuntimeError, match="capturing"):
        graph()
    assert graph.graph is None and graphs.launch_counts()["gn_act_bwd"] == 1


def test_on_the_cpu_a_graph_runs_its_function_every_call():
    ran = []
    graph = graphs.Graph(lambda: ran.append(1), "cpu")
    for _ in range(3):
        graph()
    assert len(ran) == 3 and graph.graph is None and graph.held == {}


def _pixels(rng, n, size=16):
    return rng.integers(0, 256, (n, 3, size, size), dtype=np.uint8)


def test_uint8_input_rebuilds_the_stored_batch_and_its_losses(tmp_path):
    _, cfg = configs()
    rng = np.random.default_rng(20)
    pixels = _pixels(rng, 4)
    path = str(tmp_path / "u8.bin")
    write_bin(path, pixels.astype(np.float32) / 127.5 - 1.0)
    ds = BinDataset(path)
    stored = np.stack([ds.batch_nhwc(np.arange(2 * k, 2 * k + 2))
                       for k in range(2)])
    u8 = pixels.transpose(0, 2, 3, 1).reshape(stored.shape)
    rebuilt = trainer.from_uint8(torch.from_numpy(u8)).numpy()
    ulps = np.abs(rebuilt.view(np.int32).astype(np.int64)
                  - stored.view(np.int32))
    assert rebuilt.dtype == np.float32 and ulps.max() <= 1

    tc = TrainConfig(batch_size=2, lr=1e-3, weight_decay=0.01)
    states = [trainer.init_state(both_models(*configs(), seed=21)[1], seed=2)
              for _ in range(2)]
    multi = trainer.make_multi_step(cfg, tc, device="cpu", input_u8=True)
    _, losses = multi(states[0], u8)
    train_step, _ = trainer.make_train_step(cfg, tc, device="cpu")
    want = torch.stack([train_step(states[1], b)[1] for b in stored])
    np.testing.assert_allclose(losses.numpy(), want.numpy(), rtol=1e-6)
    if ulps.max() == 0:
        assert torch.equal(losses, want)
        np.testing.assert_array_equal(
            port_ckpt.flatten_params(states[0].params),
            port_ckpt.flatten_params(states[1].params))


def test_multi_step_hook_equals_the_eager_step_with():
    _, cfg = configs()
    tc = TrainConfig(batch_size=2, lr=1e-3, ema_rate=0.5, remat=True,
                     microbatch=1)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    t = rng.integers(0, 1000, 2)
    noise = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    states = [trainer.init_state(both_models(*configs(), seed=22)[1],
                                 ema_rate=0.5) for _ in range(2)]
    multi = trainer.make_multi_step(cfg, tc, device="cpu")
    _, step_with = trainer.make_train_step(cfg, tc, device="cpu")
    for _ in range(2):
        _, got = multi.step_with(states[0], x, t, noise)
        _, want = step_with(states[1], x, t, noise)
        assert torch.equal(got, want)
    assert states[0].step == states[1].step == 2
    for a, b in ((states[0].params, states[1].params),
                 (states[0].ema, states[1].ema)):
        np.testing.assert_array_equal(port_ckpt.flatten_params(a),
                                      port_ckpt.flatten_params(b))


def _args(**kw):
    fields = dict(host_rng=False, log_norms=False, class_cond=False)
    return argparse.Namespace(**{**fields, **kw})


@pytest.mark.parametrize("args,tc,start,chunked", [
    ({}, dict(log_interval=2, save_interval=4, iterations=8), 0, True),
    ({}, dict(log_interval=2, save_interval=0, iterations=8), 4, True),
    ({}, dict(log_interval=1, save_interval=4, iterations=8), 0, False),
    ({}, dict(log_interval=3, save_interval=4, iterations=12), 0, False),
    ({}, dict(log_interval=2, save_interval=4, iterations=9), 0, False),
    ({}, dict(log_interval=2, save_interval=4, iterations=8), 3, False),
    (dict(log_norms=True), dict(log_interval=2, save_interval=4,
                                iterations=8), 0, False),
    (dict(host_rng=True), dict(log_interval=2, save_interval=4,
                               iterations=8), 0, False),
    (dict(class_cond=True), dict(log_interval=2, save_interval=4,
                                 iterations=8), 0, False)])
def test_the_cli_chunks_where_the_jax_cli_does(args, tc, start, chunked):
    assert port_cli._chunked(_args(**args), TrainConfig(**tc),
                             start) is chunked


@pytest.fixture
def u8_data(tmp_path):
    write_bin(str(tmp_path / "data.bin"),
              _pixels(np.random.default_rng(23), 6).astype(np.float32)
              / 127.5 - 1.0)
    return tmp_path


def _flags(tmp, out, *extra):
    return ["--data_file", str(tmp / "data.bin"), "--device", "cpu",
            "--num_channels", str(TINY["model_channels"]),
            "--image_size", str(TINY["image_size"]), "--channel_mult", "1,2",
            "--num_res_blocks", "1", "--attention_resolutions", "8",
            "--batch_size", "2", "--log_interval", "2", "--save_interval",
            "2", "--lr", "1e-3", "--ema_rate", "0.9", "--shuffle", "true",
            "--output_dir", str(tmp / out), "--csv_log_dir",
            str(tmp / f"{out}_csv"), "--log_file", str(tmp / f"{out}.txt"),
            *extra]


def _csv_losses(directory):
    (path,) = directory.glob("*.csv")
    with open(path) as f:
        return [float(row["loss"]) for row in csv.DictReader(f)]


def test_cli_chunked_path_equals_the_per_step_path_and_resumes(u8_data):
    tmp = u8_data
    port_cli.main(_flags(tmp, "chunked", "--iterations", "4"))
    port_cli.main(_flags(tmp, "steps", "--iterations", "4",
                         "--log_interval", "1"))
    log = (tmp / "chunked.txt").read_text()
    assert "H2D encoding: uint8" in log and "step 4: loss" in log
    assert "H2D encoding" not in (tmp / "steps.txt").read_text()
    chunked, steps = _csv_losses(tmp / "chunked_csv"), _csv_losses(
        tmp / "steps_csv")
    assert len(chunked) == 2 and len(steps) == 4
    pairs = [(steps[0] + steps[1]) / 2, (steps[2] + steps[3]) / 2]
    np.testing.assert_allclose(chunked, pairs, rtol=1e-6)

    port_cli.main(_flags(tmp, "cut", "--iterations", "2"))
    state = port_cli.main(_flags(tmp, "cut", "--iterations", "4",
                                 "--model_weights",
                                 str(tmp / "cut" / "model_2.bin")))
    assert state.step == 4
    a = port_ckpt.load(str(tmp / "chunked" / "model_4.bin"), device="cpu")
    b = port_ckpt.load(str(tmp / "cut" / "model_4.bin"), device="cpu")
    assert a.step == b.step == 4 and a.loader_pos == b.loader_pos == 4
    for x, y in ((port_ckpt.flatten_params(a.params),
                  port_ckpt.flatten_params(b.params)),
                 (a.adam_m, b.adam_m), (a.adam_v, b.adam_v),
                 (port_ckpt.flatten_params(a.ema),
                  port_ckpt.flatten_params(b.ema))):
        np.testing.assert_array_equal(x, y)


def test_cli_chunked_path_keeps_float32_for_other_data(tmp_path):
    rng = np.random.default_rng(24)
    write_bin(str(tmp_path / "data.bin"),
              rng.uniform(-1, 1, (4, 3, 16, 16)).astype(np.float32))
    port_cli.main(_flags(tmp_path, "f", "--iterations", "2"))
    assert "H2D encoding: float32" in (tmp_path / "f.txt").read_text()


# The loops the table-driven samplers replaced, as they were: Python floats
# from the numpy tables, a fresh tensor of t and a fresh draw every step.

def _ddpm_loop(model, diffusion, generator, x, n, noise=None):
    T, f32 = diffusion.num_timesteps, np.float32
    betas, abar = diffusion.betas, diffusion.alphas_cumprod
    for i in range(n):
        t = T - 1 - i
        eps = model(x, torch.full((x.shape[0],), float(t)))
        beta_t, alpha_t, alpha_t_1 = betas[t - 1], abar[t - 1], abar[t - 2]
        c_eps = beta_t / np.sqrt(f32(1.0) - alpha_t)
        c_mu = f32(1.0) / np.sqrt(f32(1.0) - beta_t)
        sigma = np.sqrt((f32(1.0) - alpha_t_1) / (f32(1.0) - alpha_t)
                        * beta_t)
        z = (torch.randn(x.shape, generator=generator) if noise is None
             else noise[i])
        x = (x - float(c_eps) * eps) * float(c_mu) + float(sigma) * z
    return x


def _ddim_loop(model, diffusion, generator, x, num_steps, eta, noise=None):
    T, f32 = diffusion.num_timesteps, np.float32
    abar = diffusion.alphas_cumprod
    ts = np.unique(np.linspace(1, T - 1, num_steps)
                   .round().astype(np.int64))[::-1]
    a_cur = abar[ts - 1]
    a_prev = np.concatenate([abar[ts[1:] - 1], [1.0]])
    sigma = (eta * np.sqrt((1.0 - a_prev) / (1.0 - a_cur))
             * np.sqrt(np.maximum(1.0 - a_cur / a_prev, 0.0)))
    a_cur, a_prev, sigma = (a.astype(f32) for a in (a_cur, a_prev, sigma))
    for i in range(len(ts)):
        eps = model(x, torch.full((x.shape[0],), float(ts[i])))
        a_t, a_p, sg = a_cur[i], a_prev[i], sigma[i]
        c_x0 = f32(1.0) / np.sqrt(a_t)
        x0 = (x - float(np.sqrt(f32(1.0) - a_t)) * eps) * float(c_x0)
        c_dir = np.sqrt(np.maximum(f32(1.0) - a_p - sg * sg, f32(0.0)))
        x = float(np.sqrt(a_p)) * x0 + float(c_dir) * eps
        if sg != 0.0:
            z = (torch.randn(x.shape, generator=generator) if noise is None
                 else noise[i])
            x = x + float(sg) * z
    return x


def _diffusions(T=1000):
    jd = jax_gaussian.GaussianDiffusion.create(
        jax_gaussian.named_beta_schedule("linear", T))
    pd = GaussianDiffusion.create(named_beta_schedule("linear", T),
                                  device="cpu")
    return jd, pd


@pytest.mark.parametrize("with_noise", [False, True])
def test_table_driven_ddpm_steps_equal_the_loop_and_jax(with_noise):
    jcfg, cfg = configs()
    params, model, _ = both_models(jcfg, cfg, seed=25)
    jd, pd = _diffusions()
    rng = np.random.default_rng(25)
    x0 = torch.from_numpy(rng.standard_normal((2, 16, 16, 3),
                                              dtype=np.float32))
    noise = (torch.from_numpy(rng.standard_normal((3, 2, 16, 16, 3),
                                                  dtype=np.float32))
             if with_noise else None)
    got = port_sampler.ddpm_sample(
        model, cfg, pd, torch.Generator().manual_seed(4), batch_size=2,
        x_init=x0, num_steps=3, noise=noise)
    with torch.no_grad():
        want = _ddpm_loop(model, pd, torch.Generator().manual_seed(4), x0,
                          3, noise)
    assert torch.equal(got, want)
    assert not torch.equal(x0, got)  # the start is not written over
    if with_noise:
        jwant = jax_sampler.ddpm_sample(
            params, jcfg, jd, jax.random.PRNGKey(0), batch_size=2,
            x_init=jnp.asarray(x0.numpy()), noise=jnp.asarray(noise.numpy()),
            num_steps=3)
        np.testing.assert_allclose(t2n(got), j2n(jwant), atol=1e-3)


@pytest.mark.parametrize("eta,with_noise", [(0.0, False), (1.0, False),
                                            (0.5, True)])
def test_table_driven_ddim_steps_equal_the_loop(eta, with_noise):
    _, cfg = configs()
    _, model, _ = both_models(*configs(), seed=26)
    _, pd = _diffusions(100)
    rng = np.random.default_rng(26)
    x0 = torch.from_numpy(rng.standard_normal((2, 16, 16, 3),
                                              dtype=np.float32))
    noise = (torch.from_numpy(rng.standard_normal((4, 2, 16, 16, 3),
                                                  dtype=np.float32))
             if with_noise else None)
    got = port_sampler.ddim_sample(
        model, cfg, pd, torch.Generator().manual_seed(6), num_steps=4,
        eta=eta, batch_size=2, x_init=x0, noise=noise)
    with torch.no_grad():
        want = _ddim_loop(model, pd, torch.Generator().manual_seed(6), x0, 4,
                          eta, noise)
    assert torch.equal(got, want)


def test_table_driven_guided_ddpm_equals_the_loop():
    """Classifier-free guidance, w = 3: one model call on the doubled
    batch inside the step."""
    _, cfg = configs()
    _, model, _ = both_models(*configs(), num_classes=10, seed=27)
    _, pd = _diffusions()
    x0 = torch.from_numpy(np.random.default_rng(27).standard_normal(
        (2, 16, 16, 3), dtype=np.float32))
    got = port_sampler.ddpm_sample(
        model, cfg, pd, torch.Generator().manual_seed(8), num_steps=2,
        batch_size=2, x_init=x0, y=3, guidance_scale=3.0)
    eps_fn = port_sampler.make_model_fn(cfg, y=3, guidance_scale=3.0)
    with torch.no_grad():
        want = _ddpm_loop(lambda x, t: eps_fn(model, x, t), pd,
                          torch.Generator().manual_seed(8), x0, 2)
    assert torch.equal(got, want)
