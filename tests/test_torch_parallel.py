"""The port's data-parallel step and sampler (`unet_tpu_torch/parallel/`,
`make_parallel_sampler`) on the CPU, over gloo: 2 and 4 ranks, each a
process (tests/torch_dist_worker.py), against the JAX package's
single-device gradients and against the port's one process at the global
batch; and one rank in this process against the one-device flat step.

The contract is the JAX package's (tests/test_parallel.py): N ranks compute
the math of one device with the global batch.  Tolerances: the reduced loss
1e-5 relative and gradients 1e-5 absolute against the JAX package's
`value_and_grad` (as tests/test_parallel.py holds its mesh); parameters,
moments and EMA after two AdamW steps (lr 1e-4) within 5e-4 of one process
(an AdamW step moves a parameter by about lr whatever the gradient's size,
so reduction-order noise on a gradient near 0 can move it by that much),
losses 1e-5 relative; microbatches against the full batch as
tests/test_parallel.py holds them; images 1e-4.  World size 1 gives the
one-device step's bits.  With level 0 in patch space (UNET_TPU_TORCH_S2D=on
in the ranks' environment, `set_s2d_mode("on")` here) 2 ranks hold the one
process in that mode to the same bars.
"""

import contextlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.diffusion import gaussian as jax_gaussian
from unet_tpu.io import checkpoint as jax_ckpt
from unet_tpu.training import trainer as jax_trainer
from unet_tpu_torch.config import TrainConfig
from unet_tpu_torch.data.dataset import data_loader, write_bin
from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule)
from unet_tpu_torch.diffusion.sampler import make_sampler
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.io import convert
from unet_tpu_torch.models import unet
from unet_tpu_torch.parallel import distributed
from unet_tpu_torch.parallel import mesh as pmesh
from unet_tpu_torch.training import trainer

from tests import torch_dist_worker as worker
from tests.torch_port_util import (TINY, both_models, configs, flat_weights,
                                   run_ranks)

T_STEPS = 1000


def _diffusion():
    return GaussianDiffusion.create(named_beta_schedule("linear", T_STEPS),
                                    device="cpu")


def _inputs(world):
    """The numpy inputs of a run of `world` ranks: weights, a global batch
    of 2 rows a rank, its t and noise, two steps' batches and labels."""
    _, cfg = configs()
    rng = np.random.default_rng(world)
    B = 2 * world
    shape = (B, cfg.image_size, cfg.image_size, cfg.in_channels)
    return dict(
        weights=flat_weights(cfg, None, seed=world),
        weights_cond=flat_weights(cfg, 10, seed=world + 10),
        batch=rng.standard_normal(shape, dtype=np.float32) * 0.5,
        t=rng.integers(0, T_STEPS, size=B),
        noise=rng.standard_normal(shape, dtype=np.float32),
        chunk=rng.standard_normal((2,) + shape, dtype=np.float32) * 0.5,
        labels=rng.integers(0, 10, size=(2, B)))


def _run_worker(world, out, env=None):
    """The results of one run of the worker at a world size (each rank's
    environment extended by `env`), its inputs, and the sizes each rank
    kept."""
    inputs = _inputs(world)
    np.savez(out / "inputs.npz", **inputs)
    _, cfg = configs()

    def argvs(port):
        spec = dict(address=f"localhost:{port}", world=world,
                    cfg={k: list(v) if isinstance(v, tuple) else v
                         for k, v in TINY.items()},
                    inputs=str(out / "inputs.npz"), out=str(out))
        with open(out / "spec.json", "w") as f:
            json.dump(spec, f)
        return [[sys.executable, "-m", "tests.torch_dist_worker",
                 str(out / "spec.json"), str(r)] for r in range(world)]

    codes, text = run_ranks(argvs, [out / f"rank{r}.log"
                                    for r in range(world)], env=env)
    assert codes == [0] * world, text[-4000:]
    results = dict(np.load(out / "results.npz"))
    sizes = [json.load(open(out / f"sizes{r}.json")) for r in range(world)]
    return world, inputs, results, sizes


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request, tmp_path_factory):
    world = request.param
    return _run_worker(world, tmp_path_factory.mktemp(f"world{world}"))


@pytest.fixture(scope="module")
def s2d_ranks(tmp_path_factory):
    """The worker's run at 2 ranks with level 0 in patch space."""
    return _run_worker(2, tmp_path_factory.mktemp("world2_s2d"),
                       env={"UNET_TPU_TORCH_S2D": "on"})


@contextlib.contextmanager
def _s2d_on():
    """Level 0 in patch space in this process; the mode before is restored
    after."""
    saved = unet._S2D_MODE
    unet.set_s2d_mode("on")
    try:
        yield
    finally:
        unet.set_s2d_mode(saved)


def _names(cfg, num_classes=None):
    model = convert.params_from_flat(flat_weights(cfg, num_classes), cfg,
                                     num_classes, device="cpu")
    return trainer.Unravel(model)


def _by_name(unravel, vec):
    return {k: v.numpy() for k, v in unravel(torch.from_numpy(vec)).items()}


def test_dp_loss_and_gradients_equal_the_jax_single_device(ranks):
    world, inputs, results, _ = ranks
    jcfg, cfg = configs()
    params = jax_ckpt.unflatten_params(inputs["weights"], jcfg, None)
    jd = jax_gaussian.GaussianDiffusion.create(
        jax_gaussian.named_beta_schedule("linear", T_STEPS))
    want_loss, want = jax.jit(jax.value_and_grad(
        jax_trainer.make_loss_fn(jcfg, jd, jnp.float32)))(
        params, jnp.asarray(inputs["batch"]), jnp.asarray(inputs["t"]),
        jnp.asarray(inputs["noise"]))
    np.testing.assert_allclose(float(results["grad_loss"]), float(want_loss),
                               rtol=1e-5)
    views = trainer.Unravel(convert.params_from_flat(
        inputs["weights"], cfg, device="cpu"))(
            torch.from_numpy(results["grad"]))
    np.testing.assert_allclose(
        port_ckpt.flatten_tensors(list(views.values())),
        jax_ckpt.flatten_params(want, jcfg), atol=1e-5)


def _one_process(inputs, num_classes=None):
    """Two steps of the one-device tree step (`make_multi_step`, or
    `make_train_step` with labels) at the global batch, same seed: the
    run the ranks must reproduce."""
    _, cfg = configs()
    model = convert.params_from_flat(
        inputs["weights" if num_classes is None else "weights_cond"], cfg,
        num_classes, device="cpu")
    B = inputs["batch"].shape[0]
    tc = TrainConfig(**{**worker.STEPS, "batch_size": B,
                        "label_dropout": 0.5 if num_classes else 0.0})
    state = trainer.init_state(model, seed=worker.SEED, ema_rate=tc.ema_rate)
    chunk = torch.from_numpy(inputs["chunk"])
    if num_classes is None:
        state, losses = trainer.make_multi_step(
            cfg, tc, _diffusion(), device="cpu")(state, chunk)
    else:
        step, _ = trainer.make_train_step(cfg, tc, _diffusion(), "cpu")
        losses = torch.stack([
            step(state, b, torch.from_numpy(y))[1]
            for b, y in zip(chunk, inputs["labels"])])
    return state, losses.numpy()


def _assert_state_near(results, name, state, losses, unravel, atol):
    np.testing.assert_allclose(results[f"{name}_losses"], losses, rtol=1e-5)
    params = dict(state.params.named_parameters())
    ema = dict(state.ema.named_parameters())
    moments = dict(zip(params, zip(state.m, state.v)))
    got = {part: _by_name(unravel, results[f"{name}_{part}"])
           for part in ("flat", "m", "v", "ema")}
    for key in unravel.names:
        for part, want in (("flat", params[key]), ("m", moments[key][0]),
                           ("v", moments[key][1]), ("ema", ema[key])):
            np.testing.assert_allclose(got[part][key],
                                       want.detach().numpy(), atol=atol,
                                       err_msg=f"{name} {part} {key}")


def test_dp_and_fsdp_equal_one_process_at_the_global_batch(ranks):
    world, inputs, results, _ = ranks
    _, cfg = configs()
    state, losses = _one_process(inputs)
    unravel = _names(cfg)
    for name in ("dp", "fsdp"):
        _assert_state_near(results, name, state, losses, unravel, 5e-4)


def test_fsdp_equals_dp(ranks):
    _, _, results, _ = ranks
    np.testing.assert_allclose(results["fsdp_losses"], results["dp_losses"],
                               rtol=1e-5)
    for part in ("flat", "m", "v", "ema"):
        np.testing.assert_allclose(results[f"fsdp_{part}"],
                                   results[f"dp_{part}"], atol=5e-4,
                                   err_msg=part)


def test_fsdp_ranks_keep_a_ceil_p_over_n_piece(ranks):
    world, _, _, sizes = ranks
    P = sizes[0]["dp"]["size"]
    piece = -(-P // world)
    for rank_sizes in sizes:
        fsdp, dp = rank_sizes["fsdp"], rank_sizes["dp"]
        assert fsdp["size"] == P and fsdp["step"] == dp["step"] == 2
        assert (fsdp["master"], fsdp["m"], fsdp["v"], fsdp["ema"]) == (
            piece,) * 4
        assert fsdp["flat"] == piece * world      # the working vector
        assert (dp["master"], dp["m"], dp["v"], dp["ema"], dp["flat"]) == (
            P,) * 5


def test_microbatches_per_rank_equal_the_full_batch(ranks):
    _, _, results, _ = ranks
    np.testing.assert_allclose(results["micro_losses"], results["dp_losses"],
                               rtol=1e-6)
    np.testing.assert_allclose(results["micro_flat"], results["dp_flat"],
                               atol=5e-4)


def test_class_cond_dp_equals_one_process(ranks):
    _, inputs, results, _ = ranks
    _, cfg = configs()
    state, losses = _one_process(inputs, num_classes=10)
    _assert_state_near(results, "cond", state, losses, _names(cfg, 10), 5e-4)


def test_parallel_sampler_equals_make_sampler(ranks):
    _, inputs, results, _ = ranks
    _, cfg = configs()
    model = convert.params_from_flat(inputs["weights"], cfg, device="cpu")
    want = make_sampler(cfg, _diffusion(), batch_size=inputs["batch"].shape[0],
                        num_steps=5)(model, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(results["sampler"], want.numpy(), atol=1e-4)


@pytest.mark.parametrize("name", ["dp", "fsdp", "micro", "sampler"])
def test_s2d_ranks_equal_one_process_in_s2d(s2d_ranks, name):
    """DP, FSDP, DP with microbatches and `make_parallel_sampler` with
    level 0 in patch space against the one process in that mode."""
    _, inputs, results, sizes = s2d_ranks
    _, cfg = configs()
    assert [rank_sizes["s2d"] for rank_sizes in sizes] == [True, True]
    with _s2d_on():
        if name == "sampler":
            model = convert.params_from_flat(inputs["weights"], cfg,
                                             device="cpu")
            want = make_sampler(cfg, _diffusion(),
                                batch_size=inputs["batch"].shape[0],
                                num_steps=5)(
                model, torch.Generator().manual_seed(0))
            np.testing.assert_allclose(results["sampler"], want.numpy(),
                                       atol=1e-4)
            return
        state, losses = _one_process(inputs)
    _assert_state_near(results, name, state, losses, _names(cfg), 5e-4)


@pytest.fixture
def one_rank():
    """A process group of this process alone, over gloo."""
    distributed.initialize(f"localhost:{distributed.free_port()}", 1, 0,
                           device="cpu", timeout_s=30)
    try:
        yield pmesh.make_mesh()
    finally:
        distributed.shutdown()


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
def test_world_size_1_gives_the_one_device_flat_steps_bits(one_rank, fsdp):
    _, model, _ = both_models(*configs(), seed=6)
    cfg = model.cfg
    tc = TrainConfig(batch_size=2, lr=1e-3, weight_decay=0.01)
    chunk = torch.from_numpy(_inputs(1)["chunk"])
    chunk = torch.cat([chunk, chunk[:1]])               # three steps
    flat, unravel = trainer.flatten_state(model, seed=3)
    _, want = trainer.make_flat_multi_step(cfg, tc, unravel, _diffusion(),
                                           device="cpu")(flat, chunk)
    step = pmesh.make_parallel_train_step(cfg, tc, one_rank, _diffusion(),
                                          fsdp=fsdp, example_params=model)
    state = pmesh.init_state(unravel, model, one_rank, fsdp=fsdp, seed=3)
    state, got = step(state, chunk)
    assert state.step == flat.step == 3
    assert torch.equal(got, want)
    for a, b in ((state.flat, flat.flat), (state.m, flat.m),
                 (state.v, flat.v)):
        assert torch.equal(a.detach(), b.detach())


def test_make_mesh_needs_a_process_group_and_refuses_the_model_axis(ranks):
    """make_mesh needs a process group; over one it builds a model axis
    (here over the worker's ranks: data world / 2 x model 2, rank d * 2 +
    m, as tests/test_torch_tensor_parallel.py holds at more shapes).
    Spatial sharding builds a step, which over one model rank is DP's
    (tests/test_torch_spatial_parallel.py runs it over more); TP and
    spatial together raise."""
    world, _, _, sizes = ranks
    with pytest.raises(RuntimeError, match="initialize"):
        pmesh.make_mesh()
    for r, rank_sizes in enumerate(sizes):
        assert rank_sizes["mesh_model_2"] == dict(
            data=world // 2, model=2, data_rank=r // 2, model_rank=r % 2)
    mesh = pmesh.Mesh(data=2, rank=0, device=torch.device("cpu"))
    _, cfg = configs()
    step = pmesh.make_parallel_train_step(
        cfg, TrainConfig(), mesh, spatial=True,
        example_params=convert.params_from_flat(flat_weights(cfg), cfg,
                                                device="cpu"))
    assert (step.world, step.rows, step.height) == (2, slice(0, None, 2),
                                                    None)
    with pytest.raises(ValueError, match="tp and spatial"):
        pmesh.make_parallel_train_step(configs()[1], TrainConfig(), mesh,
                                       tp=True, spatial=True)


@pytest.mark.parametrize("size,world", [(10, 4), (12, 4), (7, 1), (5, 8)])
def test_placement_pads_to_a_multiple_and_splits_evenly(size, world):
    pieces = [pmesh.fsdp_sharding(pmesh.Mesh(world, r, torch.device("cpu")),
                                  size) for r in range(world)]
    shard = -(-size // world)
    assert all(p.shard == shard and p.padded == shard * world
               for p in pieces)
    covered = np.concatenate([np.arange(p.padded)[p.piece] for p in pieces])
    np.testing.assert_array_equal(covered, np.arange(shard * world))
    assert pmesh.shard_fraction(pieces[0]) == 1.0
    whole = pmesh.replicated(pmesh.Mesh(world, 0, torch.device("cpu")), size)
    assert whole.padded == size and pmesh.shard_fraction(whole) == 0.0


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_shards_read_the_global_batch_rows_of_their_rank(tmp_path,
                                                                shuffle):
    """Shard r of N at batch B reads rows r, r + N, ... of what one loader
    reads at batch N * B (`distributed.global_batch`), batch after batch,
    across an epoch's end."""
    rng = np.random.default_rng(1)
    write_bin(str(tmp_path / "d.bin"),
              rng.uniform(-1, 1, (26, 3, 4, 4)).astype(np.float32))
    world, B = 3, 2
    whole = data_loader(str(tmp_path / "d.bin"), B * world, shuffle=shuffle,
                        seed=4)
    shards = [data_loader(str(tmp_path / "d.bin"), B, shuffle=shuffle,
                          seed=4, num_shards=world, shard_index=r)
              for r in range(world)]
    for _ in range(7):
        batch = next(whole)
        for r, shard in enumerate(shards):
            np.testing.assert_array_equal(
                next(shard), batch[distributed.global_batch(r, world)])
