"""The port's training slice against the JAX package's, on the CPU: the
loss's gradients, AdamW, a 10-step `step_with` trajectory, microbatching,
remat, the EMA and the training CLI with its checkpoints.

One set of numpy weights and one set of numpy batches, timesteps and noise
go to both sides (the two frameworks' generators draw different numbers, so
trajectories are compared through `step_with`).  Tolerances are the JAX
tests' own: whole-model gradients 1e-3 (tests/test_model.py), trajectory
losses 2e-3 relative and final parameters 5e-3 (tests/test_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.config import TrainConfig as JaxTrainConfig
from unet_tpu.diffusion import gaussian as jax_gaussian
from unet_tpu.io import checkpoint as jax_ckpt
from unet_tpu.training import optim as jax_optim
from unet_tpu.training import trainer as jax_trainer
from unet_tpu_torch.cli import train as port_cli
from unet_tpu_torch.config import TrainConfig
from unet_tpu_torch.data.dataset import write_bin
from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule,
                                               sample_timesteps)
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.ops import functional as F
from unet_tpu_torch.training import optim, trainer

from tests.torch_port_util import TINY, both_models, configs

GRAD_ATOL = 1e-3
T_STEPS = 1000


def _diffusions():
    jd = jax_gaussian.GaussianDiffusion.create(
        jax_gaussian.named_beta_schedule("linear", T_STEPS))
    pd = GaussianDiffusion.create(named_beta_schedule("linear", T_STEPS),
                                  device="cpu")
    return jd, pd


def _draws(cfg, seed, n=None, batch=2):
    """Batches in [-1, 1]-ish, timesteps and noise, NHWC, made with numpy."""
    rng = np.random.default_rng(seed)
    lead = (batch,) if n is None else (n, batch)
    shape = lead + (cfg.image_size, cfg.image_size, cfg.in_channels)
    return (rng.standard_normal(shape, dtype=np.float32) * 0.5,
            rng.integers(0, T_STEPS, size=lead),
            rng.standard_normal(shape, dtype=np.float32))


def test_train_config_equals_the_jax_one():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        JaxTrainConfig())
    assert TrainConfig().compute_torch_dtype == torch.float32
    assert (TrainConfig(compute_dtype="bfloat16").compute_torch_dtype
            == torch.bfloat16)


def test_mse_loss_is_float32_and_sample_timesteps_in_range():
    pred = torch.tensor([[1.0, 2.0]], dtype=torch.bfloat16)
    loss = F.mse_loss(pred, torch.tensor([[0.0, 0.0]]))
    assert loss.dtype == torch.float32 and loss.item() == 2.5
    gen = torch.Generator().manual_seed(0)
    t = sample_timesteps(gen, 4096, 7, device="cpu")
    assert t.dtype == torch.int64 and t.shape == (4096,)
    assert set(t.tolist()) == set(range(7))


@pytest.mark.parametrize("scale_shift", [False, True])
def test_model_gradients_equal_jax_grad_of_the_loss(scale_shift):
    jcfg, cfg = configs(use_scale_shift_norm=scale_shift)
    params, model, _ = both_models(jcfg, cfg, seed=3)
    x, t, noise = _draws(cfg, 4)
    jd, pd = _diffusions()
    jloss = jax_trainer.make_loss_fn(jcfg, jd, jnp.float32)
    want_loss, want = jax.jit(jax.value_and_grad(jloss))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(noise))
    loss = trainer.make_loss_fn(cfg, pd, torch.float32)(
        model, torch.from_numpy(x), torch.from_numpy(t),
        torch.from_numpy(noise))
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(port_ckpt.flatten_tensors(grads),
                               jax_ckpt.flatten_params(want, jcfg),
                               atol=GRAD_ATOL)


@pytest.mark.parametrize("flat", [False, True])
def test_adamw_equals_jax_over_three_steps(flat):
    """Weight decay and the lr anneal on; a bfloat16 gradient is taken in
    float32 as the JAX package does.  Tolerance: the same float32 formula,
    its products and sums associated differently (1e-6 absolute and 1e-5
    relative)."""
    rng = np.random.default_rng(5)
    p0 = [rng.standard_normal(s, dtype=np.float32) for s in ((3, 4), (5,))]
    grads = [[rng.standard_normal(a.shape, dtype=np.float32) for a in p0]
             for _ in range(3)]
    hp = dict(lr=1e-2, weight_decay=0.1, anneal_steps=4)
    jhp, thp = jax_optim.AdamWParams(**hp), optim.AdamWParams(**hp)
    if flat:
        p0 = [np.concatenate([a.ravel() for a in p0])]
        grads = [[np.concatenate([a.ravel() for a in g])] for g in grads]
    jp = [jnp.asarray(a) for a in p0]
    jm, jv = jax_optim.init_moments(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    tm, tv = optim.init_moments(tp)
    for step, g in enumerate(grads, start=1):
        gb = [jnp.asarray(a).astype(jnp.bfloat16) for a in g]
        if flat:
            jp0, jm0, jv0 = jax_optim.adamw_update_flat(
                jp[0], gb[0], jm[0], jv[0], jnp.int32(step), jhp)
            jp, jm, jv = [jp0], [jm0], [jv0]
            optim.adamw_update_flat(
                tp[0], torch.from_numpy(g[0]).to(torch.bfloat16), tm[0],
                tv[0], step, thp)
        else:
            jp, jm, jv = jax_optim.adamw_update(jp, gb, jm, jv,
                                                jnp.int32(step), jhp)
            optim.adamw_update(
                tp, [torch.from_numpy(a).to(torch.bfloat16) for a in g],
                tm, tv, step, thp)
        for pair in ((tp, jp), (tm, jm), (tv, jv)):
            for a, b in zip(*pair):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-6)


def test_ten_step_with_steps_track_jax():
    jcfg, cfg = configs()
    params, model, _ = both_models(jcfg, cfg, seed=7)
    batches, ts, noises = _draws(cfg, 8, n=10)
    jd, pd = _diffusions()
    fields = dict(batch_size=2, lr=1e-3, weight_decay=0.01)
    _, jstep = jax_trainer.make_train_step(jcfg, JaxTrainConfig(**fields),
                                           jd, donate=False)
    _, tstep = trainer.make_train_step(cfg, TrainConfig(**fields), pd,
                                       device="cpu")
    jstate = jax_trainer.init_state(params)
    tstate = trainer.init_state(model)
    jl, tl = [], []
    for i in range(10):
        jstate, loss = jstep(jstate, jnp.asarray(batches[i]),
                             jnp.asarray(ts[i]), jnp.asarray(noises[i]))
        jl.append(float(loss))
        tstate, loss = tstep(tstate, batches[i], ts[i], noises[i])
        tl.append(loss.item())
    assert tstate.step == 10 and tstate.params is model
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(port_ckpt.flatten_params(model),
                               jax_ckpt.flatten_params(jstate.params, jcfg),
                               atol=5e-3)


def _loss_and_grads(tc, model, x, t, noise):
    _, pd = _diffusions()
    grad_fn = trainer._make_grad_fn(
        trainer.make_loss_fn(model.cfg, pd, tc.compute_torch_dtype,
                             tc.remat), tc)
    return grad_fn(model, *(torch.from_numpy(a) for a in (x, t, noise)))


def test_microbatches_equal_the_full_batch_and_remat_equals_no_remat():
    """Microbatches: the same float32 math summed in another order (1e-6).
    Remat recomputes the same operations on the same inputs: bit-equal."""
    jcfg, cfg = configs()
    _, model, _ = both_models(jcfg, cfg, seed=9)
    x, t, noise = _draws(cfg, 10, batch=4)
    loss, grads = _loss_and_grads(TrainConfig(), model, x, t, noise)
    mloss, mgrads = _loss_and_grads(TrainConfig(microbatch=2), model, x, t,
                                    noise)
    np.testing.assert_allclose(mloss.item(), loss.item(), rtol=1e-6)
    np.testing.assert_allclose(port_ckpt.flatten_tensors(mgrads),
                               port_ckpt.flatten_tensors(grads), atol=1e-6)
    rloss, rgrads = _loss_and_grads(TrainConfig(remat=True), model, x, t,
                                    noise)
    assert torch.equal(rloss, loss)
    assert all(torch.equal(a, b) for a, b in zip(rgrads, grads))


def test_bfloat16_grads_reach_the_float32_parameters():
    """compute_dtype bfloat16 casts inside the graph: the gradients are
    float32, one per master parameter, close to the float32 ones."""
    jcfg, cfg = configs()
    _, model, _ = both_models(jcfg, cfg, seed=11)
    x, t, noise = _draws(cfg, 12)
    _, grads = _loss_and_grads(TrainConfig(), model, x, t, noise)
    _, bgrads = _loss_and_grads(TrainConfig(compute_dtype="bfloat16"),
                                model, x, t, noise)
    assert all(g.dtype == torch.float32 for g in bgrads)
    assert [g.shape for g in bgrads] == [p.shape for p in model.parameters()]
    assert model.dtype == torch.float32
    a, b = (port_ckpt.flatten_tensors(g) for g in (bgrads, grads))
    assert np.abs(a - b).max() < 0.05 * np.abs(b).max()


def test_bfloat16_remat_equals_no_remat():
    """Under remat the backward recomputes each group from the bfloat16
    casts the forward made, not from the float32 parameters: bit-equal."""
    jcfg, cfg = configs()
    _, model, _ = both_models(jcfg, cfg, seed=11)
    x, t, noise = _draws(cfg, 12)
    loss, grads = _loss_and_grads(TrainConfig(compute_dtype="bfloat16"),
                                  model, x, t, noise)
    rloss, rgrads = _loss_and_grads(
        TrainConfig(compute_dtype="bfloat16", remat=True), model, x, t,
        noise)
    assert torch.equal(rloss, loss)
    assert all(torch.equal(a, b) for a, b in zip(rgrads, grads))


def test_multi_step_equals_consecutive_train_steps():
    _, cfg = configs()
    tc = TrainConfig(batch_size=2, lr=1e-3, weight_decay=0.01)
    batches = torch.from_numpy(_draws(cfg, 17, n=2)[0])
    states = [trainer.init_state(both_models(*configs(), seed=17)[1], seed=3)
              for _ in range(2)]
    multi_step = trainer.make_multi_step(cfg, tc, device="cpu")
    _, losses = multi_step(states[0], batches)
    train_step, _ = trainer.make_train_step(cfg, tc, device="cpu")
    want = torch.stack([train_step(states[1], b)[1] for b in batches])
    assert losses.shape == (2,) and torch.equal(losses, want)
    assert states[0].step == states[1].step == 2
    np.testing.assert_array_equal(port_ckpt.flatten_params(states[0].params),
                                  port_ckpt.flatten_params(states[1].params))


def test_ema_is_a_copy_and_follows_the_update():
    _, cfg = configs()
    _, model, _ = both_models(*configs(), seed=13)
    state = trainer.init_state(model, ema_rate=0.5)
    before = port_ckpt.flatten_params(model)
    assert all(e.data_ptr() != p.data_ptr() for e, p in
               zip(state.ema.parameters(), model.parameters()))
    _, step_with = trainer.make_train_step(
        cfg, TrainConfig(batch_size=2, lr=1e-2, ema_rate=0.5), device="cpu")
    x, t, noise = _draws(cfg, 14)
    step_with(state, x, t, noise)
    after = port_ckpt.flatten_params(model)
    assert not np.array_equal(after, before)
    np.testing.assert_allclose(port_ckpt.flatten_params(state.ema),
                               0.5 * before + 0.5 * after, atol=1e-7)


def test_train_step_draws_a_pure_function_of_seed_and_step():
    _, cfg = configs()
    tc = TrainConfig(batch_size=2, lr=1e-3)
    batch = _draws(cfg, 15)[0]
    losses = []
    for _ in range(2):
        _, model, _ = both_models(*configs(), seed=15)
        state = trainer.init_state(model, seed=4, step=6)
        train_step, _ = trainer.make_train_step(cfg, tc, device="cpu")
        losses.append(train_step(state, batch)[1].item())
    assert losses[0] == losses[1]
    assert trainer.step_seed(4, 6) != trainer.step_seed(4, 7)
    assert trainer.step_seed(4, 6) != trainer.step_seed(5, 6)


def _cli_flags(tmp_path, out, *extra):
    return ["--data_file", str(tmp_path / "data.bin"), "--device", "cpu",
            "--num_channels", str(TINY["model_channels"]),
            "--image_size", str(TINY["image_size"]), "--channel_mult", "1,2",
            "--num_res_blocks", "1", "--attention_resolutions", "8",
            "--batch_size", "2", "--log_interval", "2", "--save_interval",
            "2", "--lr", "1e-3", "--weight_decay", "0.01",
            "--shuffle", "true", "--flip", "true", "--ema_rate", "0.9",
            "--output_dir", str(tmp_path / out),
            "--log_file", str(tmp_path / f"{out}.txt"), *extra]


@pytest.fixture
def data_file(tmp_path):
    rng = np.random.default_rng(16)
    write_bin(str(tmp_path / "data.bin"),
              rng.uniform(-1, 1, (6, 3, 16, 16)).astype(np.float32))
    return tmp_path


def test_cli_train_resume_is_bit_identical_and_loads_in_jax(data_file,
                                                            capsys):
    tmp = data_file
    port_cli.main(_cli_flags(tmp, "straight", "--iterations", "4"))
    log = (tmp / "straight.txt").read_text()
    assert "step 2: loss" in log and "step 4: loss" in log
    assert "ms/step" in log and (tmp / "straight" / "model_4.bin").exists()

    port_cli.main(_cli_flags(tmp, "cut", "--iterations", "2"))
    state = port_cli.main(_cli_flags(
        tmp, "cut", "--iterations", "4", "--model_weights",
        str(tmp / "cut" / "model_2.bin")))
    assert state.step == 4
    assert "step 4: loss" in (tmp / "cut.txt").read_text()
    assert "loaded" in capsys.readouterr().out

    a = port_ckpt.load(str(tmp / "straight" / "model_4.bin"), device="cpu")
    b = port_ckpt.load(str(tmp / "cut" / "model_4.bin"), device="cpu")
    assert a.step == b.step == 4 and a.loader_pos == b.loader_pos == 4
    for x, y in ((port_ckpt.flatten_params(a.params),
                  port_ckpt.flatten_params(b.params)),
                 (a.adam_m, b.adam_m), (a.adam_v, b.adam_v),
                 (port_ckpt.flatten_params(a.ema),
                  port_ckpt.flatten_params(b.ema))):
        np.testing.assert_array_equal(x, y)

    j = jax_ckpt.load(str(tmp / "straight" / "model_4.bin"))
    assert j.step == 4 and j.rng_seed == a.rng_seed == 0
    assert j.ema_rate == pytest.approx(0.9)
    np.testing.assert_array_equal(jax_ckpt.flatten_params(j.params, j.cfg),
                                  port_ckpt.flatten_params(a.params))
    np.testing.assert_array_equal(jax_ckpt.flatten_params(j.adam_m, j.cfg),
                                  a.adam_m)
    np.testing.assert_array_equal(jax_ckpt.flatten_params(j.adam_v, j.cfg),
                                  a.adam_v)


def test_cli_init_model_only_and_log_norms(data_file, capsys):
    tmp = data_file
    init = tmp / "init.bin"
    assert port_cli.main(_cli_flags(tmp, "i", "--init_model_only", "true",
                                    "--init_model_filename", str(init))
                         ) is None
    ckpt = port_ckpt.load(str(init), device="cpu")
    assert ckpt.step == 0 and ckpt.adam_m is None
    port_cli.main(_cli_flags(tmp, "n", "--iterations", "2", "--log_norms",
                             "true", "--model_weights", str(init),
                             "--microbatch", "1", "--remat", "true"))
    out = capsys.readouterr().out
    assert "grad_norm" in out and "param_norm" in out
    assert "peak_mem_MiB" not in out  # no device memory on the CPU


@pytest.mark.parametrize("flags", [
    ["--microbatch", "3"], ["--ema_rate", "1.5"],
    ["--compute_dtype", "float16"], ["--label_dropout", "0.1"],
    # (the flags above hold --shuffle true: each case below reaches the
    # rule it is named after, "--shuffle false" where another would fire)
    ["--host_rng", "true", "--microbatch", "1"],
    ["--host_rng", "true", "--log_norms", "true"],
    ["--host_rng", "true", "--class_cond", "true", "--data_dir", "d",
     "--shuffle", "false"],
    ["--log_norms", "true", "--class_cond", "true", "--data_dir", "d",
     "--shuffle", "false"],
    ["--class_cond", "true"],
    ["--data_dir", "d"],
    ["--data_dir", "d", "--shuffle", "false", "--num_shards", "2"]])
def test_cli_bad_combos_exit(data_file, flags):
    with pytest.raises(SystemExit):
        port_cli.main(_cli_flags(data_file, "x", *flags))
