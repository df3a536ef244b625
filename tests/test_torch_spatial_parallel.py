"""The port's spatial sharding (`unet_tpu_torch/parallel/spatial.py`, the
split GroupNorm of `ops/kernels/groupnorm.py`, `parallel/mesh.py`,
`cli/train.py --spatial_parallel`) on the CPU over gloo.

In process: the split plain GroupNorm (statistics per slice, merged in
rank order; the backward's sums per slice, added in rank order) against
the whole plain GroupNorm, within 1e-6 (relative to each tensor's largest
value), and against the JAX package's kernel in interpret mode
(tests/test_pallas.py's bars: float32 2e-5, bfloat16 3e-2); the halo's
neighbours; the split kernels' shared memory at every GroupNorm of the
default model at 2 and 4 model ranks.

Three meshes of tests/torch_dist_worker.py's spatial jobs at TINY (the
lowest resolution 8, so 2 and 4 model ranks are both legal): data 1 x
model 2 in two processes (the ops on a rank's rows against the whole
ops, forward and backward; remat with microbatches); data 2 x model 2
(spatial and spatial x fsdp in the same processes) and then data 1 x
model 4 (2 rows a rank at the lowest level), in four.  The contract is
the JAX package's (tests/test_parallel.py runs spatial on a 4 x 2 mesh):
the ranks compute the math of one device at the global batch.
Tolerances: the loss 1e-5 relative and the gradient 1e-5 absolute against
the JAX package's single-device `value_and_grad`; after two AdamW steps
with the EMA, the losses within 1e-5 relative of one process and the
state within 5e-4 (tests/test_torch_parallel.py's bars); every vector
bit-equal over the model ranks of a data index.

Every mesh also runs level 0 in patch space (the worker's `s2d` job,
`set_s2d_mode("on")` around it alone): the loss and gradient against the
JAX package's single-device s2d `value_and_grad` (both packages in mode
"on" while JAX traces), at the same bars; on data 1 x model 2 the
patch-space ops on a rank's patch rows against the whole ops, and two s2d
steps with remat and microbatches against the one-process s2d run.
"""

import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.diffusion import gaussian as jax_gaussian
from unet_tpu.io import checkpoint as jax_ckpt
from unet_tpu.ops.pallas.groupnorm import group_norm_act as jax_gn
from unet_tpu.training import trainer as jax_trainer
from unet_tpu_torch.cli import train as port_cli
from unet_tpu_torch.config import TrainConfig, UnetConfig
from unet_tpu_torch.data.dataset import write_bin
from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule)
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.io import convert
from unet_tpu_torch.models import unet as port_unet
from unet_tpu_torch.ops import functional as F
from unet_tpu_torch.ops import s2d as S
from unet_tpu_torch.ops.kernels import groupnorm as port_gn
from unet_tpu_torch.parallel import spatial as sp
from unet_tpu_torch.parallel import tensor
from unet_tpu_torch.training import trainer

from tests import torch_dist_worker as worker
from tests.torch_port_util import (TINY, configs, flat_weights, run_ranks,
                                   s2d_on)

T_STEPS = 1000
B = 4  # the global batch



def _gn_inputs(rng, shape):
    C = shape[-1]
    return (rng.standard_normal(shape, dtype=np.float32) * 2 + 0.5,
            rng.standard_normal(C, dtype=np.float32) * 0.3 + 1,
            rng.standard_normal(C, dtype=np.float32) * 0.2,
            rng.standard_normal(shape, dtype=np.float32))


def _split_gn(x, gamma, beta, dy, n, G, act):
    """The split plain GroupNorm over n slices of the height: (y, mean,
    rstd, dx, and the per-batch dgamma_b and dbeta_b (B, C) of the slices
    summed)."""
    xs, dys = x.chunk(n, dim=1), dy.chunk(n, dim=1)
    stats = torch.stack([port_gn.gn_stats(p, G) for p in xs])
    fwd = [port_gn.gn_apply(p, gamma, beta, stats, G, 1e-5, act) for p in xs]
    for _, mean, rstd in fwd[1:]:  # every slice merged the same bits
        assert torch.equal(mean, fwd[0][1]) and torch.equal(rstd, fwd[0][2])
    _, mean, rstd = fwd[0]
    sums = torch.stack([port_gn.gn_bwd_sums(p, gamma, beta, mean, rstd, d,
                                            G, act)
                        for p, d in zip(xs, dys)])
    dx = torch.cat([port_gn.gn_bwd_dx(p, gamma, beta, mean, rstd, d, sums, G,
                                      act) for p, d in zip(xs, dys)], dim=1)
    return (torch.cat([y for y, _, _ in fwd], dim=1), mean, rstd, dx,
            sums[:, 0].sum(0), sums[:, 1].sum(0))


def _close(got, want, rel):
    """Within `rel` of the largest value of `want`."""
    want = torch.as_tensor(want)
    atol = rel * float(want.abs().max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("act", ["silu", "none"])
def test_split_plain_group_norm_equals_the_whole_one(n, act):
    rng = np.random.default_rng(n)
    x, gamma, beta, dy = map(torch.from_numpy,
                             _gn_inputs(rng, (2, 8, 6, 64)))
    y, mean, rstd, dx, dgamma, dbeta = _split_gn(x, gamma, beta, dy, n, 32,
                                                 act)
    y0, mean0, rstd0 = port_gn.gn_act_fwd_plain(x, gamma, beta, 32, 1e-5, act)
    for got, want in ((y, y0), (mean, mean0), (rstd, rstd0)):
        _close(got, want, 1e-6)
    dx0, dgamma0, dbeta0 = port_gn.gn_act_bwd_plain(x, gamma, beta, mean0,
                                                    rstd0, dy, 32, act)
    for got, want in ((dx, dx0), (dgamma, dgamma0), (dbeta, dbeta0)):
        _close(got, want, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_group_norm_against_the_jax_kernel(dtype):
    """Two slices through the split plain GroupNorm against the JAX
    package's `group_norm_act` (interpret mode on the CPU) on the whole
    tensor, forward and backward, at tests/test_pallas.py's bars."""
    rng = np.random.default_rng(7)
    x, gamma, beta, dy = _gn_inputs(rng, (2, 8, 8, 64))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jx, jg, jb = (jnp.asarray(a).astype(jdt) for a in (x, gamma, beta))

    def loss(x, g, b):
        return jnp.sum(jax_gn(x, g, b, 32, 1e-5, "silu").astype(jnp.float32)
                       * dy)

    want_y = np.asarray(jax_gn(jx, jg, jb, 32, 1e-5, "silu"), np.float32)
    want_dx = np.asarray(jax.grad(loss)(jx, jg, jb), np.float32)
    tx, tg, tb, tdy = (torch.from_numpy(a).to(tdt)
                       for a in (x, gamma, beta, dy))
    y, _, _, dx, _, _ = _split_gn(tx, tg, tb, tdy, 2, 32, "silu")
    atol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(y.float().numpy(), want_y, atol=atol)
    np.testing.assert_allclose(dx.float().numpy(), want_dx, atol=atol,
                               rtol=1e-4 if dtype == "float32" else 3e-2)


def test_halo_comes_from_the_neighbours_and_zeros_at_the_edges():
    assert sp.halo_sources(1, 0) == (None, None)
    assert sp.halo_sources(2, 0) == (None, 1)
    assert sp.halo_sources(2, 1) == (0, None)
    assert [sp.halo_sources(4, m) for m in range(4)] == [
        (None, 1), (0, 2), (1, 3), (2, None)]
    assert [sp.rows_of(8, tensor.Shard(4, m)) for m in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError, match="does not split"):
        sp.rows_of(6, tensor.Shard(4, 0))


@pytest.mark.parametrize("n", [2, 4])
def test_split_kernels_take_every_group_norm_of_the_default_model(n):
    """Every GroupNorm of `UnetConfig()` on a rank's rows at n model ranks
    and B=32, such as (32, 32, 64, 64) and (32, 4, 8, 256) at n = 2, in
    both types: gn_stats and gn_bwd_sums get a cluster geometry
    (`split_geometry`, which the launchers check) whose blocks cover the
    rank's rows exactly, in a cluster of a power of two up to 16, with
    shared memory within the card, and at least two blocks a sample at
    (32, 32, 64, 64); gn_apply gets its streaming cut (`apply_geometry`)
    and gn_bwd_dx fits its shared memory (the launchers refuse what does
    not)."""
    cfg = UnetConfig()
    plan, res, shapes = port_unet.build_plan(cfg), cfg.image_size, set()
    for group in plan.input_blocks + (plan.middle,) + plan.output_blocks:
        for layer in group:  # a ResBlock's gn1 and gn2, attention's gn
            if layer[0] == "res":
                shapes |= {(res, layer[1]), (res, layer[2])}
            elif layer[0] == "attn":
                shapes.add((res, layer[1]))
            elif layer[0] == "down":
                res //= 2
            elif layer[0] == "up":
                res *= 2
    assert {(64, 64), (8, 256)} <= shapes  # half height: (32, 64), (4, 256)
    B, G = 32, cfg.gn_num_groups
    for H, C in sorted(shapes):
        assert H % n == 0
        h, rows = H // n, H // n * H
        for dtype in (torch.float32, torch.bfloat16):
            for kernel in ("stats", "sums"):
                geo = port_gn.split_geometry(kernel, B, h, H, C, G, dtype)
                what = (h, H, C, dtype, kernel, geo)
                assert geo.cluster in (1, 2, 4, 8, 16), what
                assert 0 < geo.smem_bytes <= port_gn._SMEM_LIMIT, what
                assert (geo.cluster - 1) * geo.rows_per_block < rows, what
                assert rows <= geo.cluster * geo.rows_per_block, what
                if (h, H, C) == (32, 64, 64):
                    assert B * geo.cluster >= 2 * B, what
            apply = port_gn.apply_geometry(B, h, H, C, dtype)
            assert 0 < apply.threads <= port_gn._APPLY_THREADS, (h, C, apply)
        assert 0 < port_gn._dx_smem(C, G) <= port_gn._SPLIT_SMEM, (h, C)


@pytest.fixture(scope="module")
def inputs():
    """The numpy inputs of every mesh: weights, a global batch of 4 rows,
    its t and noise, two steps' batches; the module checks' inputs."""
    _, cfg = configs()
    rng = np.random.default_rng(21)
    shape = (B, cfg.image_size, cfg.image_size, cfg.in_channels)
    x, gamma, beta, gn_dy = _gn_inputs(rng, (2, 8, 6, 32))
    return dict(
        weights=flat_weights(cfg, None, seed=21),
        batch=rng.standard_normal(shape, dtype=np.float32) * 0.5,
        t=rng.integers(0, T_STEPS, size=B),
        noise=rng.standard_normal(shape, dtype=np.float32),
        chunk=rng.standard_normal((2,) + shape, dtype=np.float32) * 0.5,
        mod_x=x, mod_gamma=gamma, mod_beta=beta, mod_gn_dy=gn_dy,
        mod_conv_w=rng.standard_normal((16, 32, 3, 3), dtype=np.float32) / 17,
        mod_conv_b=rng.standard_normal(16, dtype=np.float32) * 0.1,
        mod_conv_dy=rng.standard_normal((2, 8, 6, 16), dtype=np.float32),
        mod_qkv=rng.standard_normal((2, 48, 96), dtype=np.float32),
        mod_attn_dy=rng.standard_normal((2, 48, 32), dtype=np.float32),
        mod_conv_s2d_dy=rng.standard_normal((2, 4, 3, 64), dtype=np.float32),
        mod_gn_s2d_dy=rng.standard_normal((2, 4, 3, 128), dtype=np.float32))


# Two runs of the worker: 2 ranks, and 4 ranks that take two meshes in
# turn (one set of processes, to keep the file's time down).  Every mesh
# runs the `s2d` job too (level 0 in patch space).
SPAWNS = {"world2": [("data1_model2", 2, ["modules", "remat", "s2d"])],
          "world4": [("data2_model2", 2, ["s2d"]),
                     ("data1_model4", 4, ["s2d"])]}
MESHES = {name: (spawn, model) for spawn, meshes in SPAWNS.items()
          for name, model, _ in meshes}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    """`run(spawn)`: the output directory of one run of the worker's
    spatial jobs (made once)."""
    done = {}

    def run(spawn):
        if spawn in done:
            return done[spawn]
        world = int(spawn[len("world"):])
        out = tmp_path_factory.mktemp(spawn)
        np.savez(out / "inputs.npz", **inputs)

        def argvs(port):
            spec = dict(address=f"localhost:{port}", world=world,
                        spatial=SPAWNS[spawn],
                        cfg={k: list(v) if isinstance(v, tuple) else v
                             for k, v in TINY.items()},
                        inputs=str(out / "inputs.npz"), out=str(out))
            with open(out / "spec.json", "w") as f:
                json.dump(spec, f)
            return [[sys.executable, "-m", "tests.torch_dist_worker",
                     str(out / "spec.json"), str(r)] for r in range(world)]

        codes, text = run_ranks(argvs, [out / f"rank{r}.log"
                                        for r in range(world)])
        assert codes == [0] * world, text[-4000:]
        done[spawn] = out
        return out

    return run


@pytest.fixture(params=list(MESHES))
def ranks(request, spawned):
    """The results of the spatial jobs on one mesh: (data, model, jobs,
    rank 0's results, the out directory)."""
    spawn, model = MESHES[request.param]
    world = int(spawn[len("world"):])
    out = spawned(spawn) / request.param
    jobs = next(j for n, _, j in SPAWNS[spawn] if n == request.param)
    return dict(data=world // model, model=model, jobs=jobs, out=out,
                results=dict(np.load(out / "results.npz")),
                mesh=[json.load(open(out / f"mesh{r}.json"))
                      for r in range(world)])


def _diffusion():
    return GaussianDiffusion.create(named_beta_schedule("linear", T_STEPS),
                                    device="cpu")


def _jax_grad(inputs):
    """The JAX package's single-device loss and gradient at the global
    batch (torch-order flat vector), in the JAX package's current s2d
    mode."""
    jcfg, _ = configs()
    params = jax_ckpt.unflatten_params(inputs["weights"], jcfg, None)
    jd = jax_gaussian.GaussianDiffusion.create(
        jax_gaussian.named_beta_schedule("linear", T_STEPS))
    loss, grad = jax.jit(jax.value_and_grad(
        jax_trainer.make_loss_fn(jcfg, jd, jnp.float32)))(
        params, jnp.asarray(inputs["batch"]), jnp.asarray(inputs["t"]),
        jnp.asarray(inputs["noise"]))
    return float(loss), jax_ckpt.flatten_params(grad, jcfg)


@pytest.fixture(scope="module")
def jax_grad(inputs):
    return _jax_grad(inputs)


@pytest.fixture(scope="module")
def jax_s2d_grad(inputs):
    """`jax_grad` with level 0 in patch space (both packages' mode "on"
    while the JAX function traces, restored after)."""
    with s2d_on():
        return _jax_grad(inputs)


def _assert_grads(ranks, want_loss, want, inputs, prefix=""):
    _, cfg = configs()
    views = trainer.Unravel(convert.params_from_flat(
        inputs["weights"], cfg, device="cpu"))
    names = ["spatial"] + (["spatialfsdp"] if ranks["data"] > 1 else [])
    for name in (prefix + n for n in names):
        results = ranks["results"]
        np.testing.assert_allclose(float(results[f"{name}_grad_loss"]),
                                   want_loss, rtol=1e-5, err_msg=name)
        got = views(torch.from_numpy(results[f"{name}_grad"]))
        np.testing.assert_allclose(
            port_ckpt.flatten_tensors(list(got.values())), want, atol=1e-5,
            err_msg=name)


def test_spatial_loss_and_gradient_equal_the_jax_single_device(
        ranks, jax_grad, inputs):
    """The loss and the gradient of the spatial step (and of spatial x fsdp
    where there is a data axis) are one device's at the global batch: a
    gradient of gamma and beta counted once per model rank, or a halo's
    gradient left behind, would be off by about its own size."""
    _assert_grads(ranks, *jax_grad, inputs)


def test_s2d_spatial_loss_and_gradient_equal_the_jax_single_device_s2d(
        ranks, jax_s2d_grad, inputs):
    """The same with level 0 in patch space on both sides: the patch rows'
    halo (one patch row, two pixel rows, from each neighbour) and the
    split GroupNorm on the free view give one device's s2d gradient."""
    _assert_grads(ranks, *jax_s2d_grad, inputs, prefix="s2d_")


def _one_process(inputs):
    """Two steps of the one-device tree step at the global batch, same
    seed: the run the ranks must reproduce."""
    _, cfg = configs()
    model = convert.params_from_flat(inputs["weights"], cfg, device="cpu")
    tc = TrainConfig(**{**worker.STEPS, "batch_size": B})
    state = trainer.init_state(model, seed=worker.SEED, ema_rate=tc.ema_rate)
    state, losses = trainer.make_multi_step(cfg, tc, _diffusion(),
                                            device="cpu")(
        state, torch.from_numpy(inputs["chunk"]))
    unravel = trainer.Unravel(model)
    order = [name for name, _ in model.named_parameters()]

    def pack(tensors):  # a TrainState's moments are in parameters() order
        by_name = dict(zip(order, tensors))
        return unravel.pack([by_name[n] for n in unravel.names]).numpy()

    return dict(losses=losses.numpy(),
                flat=unravel.flatten(state.params).numpy(),
                m=pack(state.m), v=pack(state.v),
                ema=unravel.flatten(state.ema).numpy())


@pytest.fixture(scope="module")
def one_process(inputs):
    return _one_process(inputs)


@pytest.fixture(scope="module")
def one_process_s2d(inputs):
    with s2d_on():
        return _one_process(inputs)


def test_spatial_steps_equal_one_process_at_the_global_batch(
        ranks, one_process):
    """Two AdamW steps with the EMA (spatial; spatial x fsdp where there is
    a data axis; remat with microbatches of one row where named) follow the
    one-process run at the global batch."""
    runs = ["spatial"] + (["spatialfsdp"] if ranks["data"] > 1 else []) \
        + [job for job in ranks["jobs"] if job == "remat"]
    results = ranks["results"]
    for name in runs:
        np.testing.assert_allclose(results[f"{name}_losses"],
                                   one_process["losses"], rtol=1e-5,
                                   err_msg=name)
        for part in ("flat", "m", "v", "ema"):
            np.testing.assert_allclose(results[f"{name}_{part}"],
                                       one_process[part], atol=5e-4,
                                       err_msg=f"{name} {part}")


def test_s2d_remat_steps_equal_one_process_in_s2d(spawned, one_process_s2d):
    """On data 1 x model 2, in patch space: two AdamW steps with remat and
    microbatches of one row (the recompute repeats the halo and GroupNorm
    collectives) follow the one-process s2d run at the global batch, and
    leave the same bits on both model ranks."""
    out = spawned("world2") / "data1_model2"
    results = dict(np.load(out / "results.npz"))
    np.testing.assert_allclose(results["s2d_remat_losses"],
                               one_process_s2d["losses"], rtol=1e-5)
    got = [np.load(out / f"s2d_remat{r}.npz") for r in range(2)]
    for part in ("flat", "m", "v", "ema"):
        np.testing.assert_allclose(results[f"s2d_remat_{part}"],
                                   one_process_s2d[part], atol=5e-4,
                                   err_msg=part)
        np.testing.assert_array_equal(got[1][part], got[0][part],
                                      err_msg=part)


def test_every_vector_is_bit_equal_over_the_model_ranks(ranks):
    """After the steps every model rank of a data index holds the same bits
    of the parameters, both moments and the EMA (of its piece under
    spatial x fsdp): the parameters are replicated over the model axis,
    and one summed gradient keeps them so."""
    n = ranks["model"]
    runs = ["spatial"] + (["spatialfsdp"] if ranks["data"] > 1 else [])
    for name in runs:
        for d in range(ranks["data"]):
            got = [np.load(ranks["out"] / f"{name}{d * n + m}.npz")
                   for m in range(n)]
            for part in ("flat", "m", "v", "ema"):
                assert np.isfinite(got[0][part]).all()
                for m in range(1, n):
                    np.testing.assert_array_equal(got[m][part], got[0][part],
                                                  err_msg=f"{name} {part}")
    for r, place in enumerate(ranks["mesh"]):
        assert (place["data_rank"], place["model_rank"]) == divmod(
            r, ranks["model"])


def test_ops_on_a_ranks_rows_equal_the_whole_ops(inputs, spawned):
    """On data 1 x model 2: a 3x3 convolution with its halo, GroupNorm with
    and without SiLU and attention, each on its rank's rows, gathered,
    equal the whole op forward and backward; each parameter's gradient
    summed over the ranks is the whole op's (within 1e-6 of each tensor's
    largest value: the sums run in another order)."""
    got = dict(np.load(spawned("world2") / "data1_model2" / "results.npz"))

    def whole(name, fn, x, dy, params):
        x = torch.from_numpy(x).requires_grad_()
        params = [torch.from_numpy(p).requires_grad_() for p in params]
        y = fn(x, *params)
        y.backward(torch.from_numpy(dy))
        want = {f"{name}_y": y, f"{name}_dx": x.grad}
        want.update({f"{name}_dp{i}": p.grad for i, p in enumerate(params)})
        for key, value in want.items():
            _close(got[key], value.detach(), 1e-6)

    whole("conv", lambda a, w, b: F.conv2d(
        a, w.contiguous(memory_format=torch.channels_last), b),
        inputs["mod_x"], inputs["mod_conv_dy"],
        [inputs["mod_conv_w"], inputs["mod_conv_b"]])
    for act in ("silu", "none"):
        whole(f"gn_{act}", lambda a, g, b: F.group_norm_silu(
            a, g, b, num_groups=8, act=act), inputs["mod_x"],
            inputs["mod_gn_dy"], [inputs["mod_gamma"], inputs["mod_beta"]])
    whole("attn", lambda a: F.qkv_attention(a, 2), inputs["mod_qkv"],
          inputs["mod_attn_dy"], [])


def test_s2d_ops_on_a_ranks_patch_rows_equal_the_whole_ops(inputs, spawned):
    """On data 1 x model 2: the patch-space 3x3 convolution with its halo
    of one patch row and GroupNorm(+SiLU) on the free view, each on its
    rank's patch rows, gathered, equal the whole ops forward and backward,
    and each parameter's gradient summed over the ranks is the whole op's
    (within 1e-6 of each tensor's largest value)."""
    got = dict(np.load(spawned("world2") / "data1_model2" / "results.npz"))
    xs = S.space_to_depth(torch.from_numpy(inputs["mod_x"])).numpy()
    for name, fn, dy, params in (
            ("conv_s2d", S.conv2d_s2d, inputs["mod_conv_s2d_dy"],
             [inputs["mod_conv_w"], inputs["mod_conv_b"]]),
            ("gn_s2d", lambda a, g, b: S.group_norm_silu_s2d(
                a, g, b, num_groups=8), inputs["mod_gn_s2d_dy"],
             [inputs["mod_gamma"], inputs["mod_beta"]])):
        x = torch.from_numpy(xs).requires_grad_()
        params = [torch.from_numpy(p).requires_grad_() for p in params]
        y = fn(x, *params)
        y.backward(torch.from_numpy(dy))
        want = {f"{name}_y": y, f"{name}_dx": x.grad}
        want.update({f"{name}_dp{i}": p.grad for i, p in enumerate(params)})
        for key, value in want.items():
            _close(got[key], value.detach(), 1e-6)


# --- the CLI ----------------------------------------------------------------

MODEL = ["--num_channels", str(TINY["model_channels"]),
         "--image_size", str(TINY["image_size"]), "--channel_mult", "1,2",
         "--num_res_blocks", "1", "--attention_resolutions", "8",
         "--device", "cpu", "--lr", "1e-4", "--ema_rate", "0.9",
         "--log_interval", "2", "--save_interval", "2", "--batch_size", "4"]
TRAIN = [sys.executable, "-m", "unet_tpu_torch.cli.train"]


def _flags(root, name, *extra):
    return ["--data_file", str(root / "d.bin"), *MODEL,
            "--output_dir", str(root / name),
            "--log_file", str(root / f"{name}.txt"), *extra]


def _losses(root, name):
    return {int(s): float(v) for s, v in re.findall(
        r"step (\d+): loss (\S+)", (root / f"{name}.txt").read_text())}


def test_spatial_parallel_2_writes_the_one_device_bin_and_resumes(
        tmp_path):
    """2 steps under --num_devices 2 --spatial_parallel 2 write the .bin
    one device writes (the JAX package's loader reads it), and one process
    resumes it to step 4: the straight one-process run of 4 steps."""
    rng = np.random.default_rng(5)
    pixels = rng.integers(0, 256, (20, 3, TINY["image_size"],
                                   TINY["image_size"]))
    write_bin(str(tmp_path / "d.bin"),
              (pixels / 127.5 - 1.0).astype(np.float32))
    port_cli.main(_flags(tmp_path, "one", "--iterations", "4"))
    codes, out = run_ranks(lambda port: [[*TRAIN, *_flags(
        tmp_path, "sp", "--iterations", "2", "--num_devices", "2",
        "--spatial_parallel", "2")]], [tmp_path / "sp.out"])
    assert codes == [0], out[-4000:]
    assert "data parallel: 1 rank(s) x batch 4 = global batch 4" in out
    assert "spatial parallel: 2 model ranks a data rank" in out
    port_cli.main(_flags(tmp_path, "back", "--iterations", "4",
                         "--model_weights",
                         str(tmp_path / "sp" / "model_2.bin")))
    want = _losses(tmp_path, "one")
    np.testing.assert_allclose(_losses(tmp_path, "sp")[2], want[2],
                               rtol=2e-5)
    np.testing.assert_allclose(_losses(tmp_path, "back")[4], want[4],
                               rtol=2e-5)
    for name, step in (("sp", 2), ("back", 4)):
        a = port_ckpt.load(str(tmp_path / name / f"model_{step}.bin"),
                           device="cpu")
        b = port_ckpt.load(str(tmp_path / "one" / f"model_{step}.bin"),
                           device="cpu")
        assert a.step == b.step == step and a.batch_size == 4
        for x, y in ((port_ckpt.flatten_params(a.params),
                      port_ckpt.flatten_params(b.params)),
                     (a.adam_m, b.adam_m), (a.adam_v, b.adam_v),
                     (port_ckpt.flatten_params(a.ema),
                      port_ckpt.flatten_params(b.ema))):
            np.testing.assert_allclose(x, y, atol=5e-4)
    jcfg, _ = configs()
    j = jax_ckpt.load(str(tmp_path / "sp" / "model_2.bin"), jcfg)
    np.testing.assert_array_equal(
        jax_ckpt.flatten_params(j.params, jcfg),
        port_ckpt.flatten_params(port_ckpt.load(
            str(tmp_path / "sp" / "model_2.bin"), device="cpu").params))


COORD = ["--coordinator_address", "localhost:1", "--num_processes", "2",
         "--process_id", "0"]


@pytest.mark.parametrize("flags,message", [
    (["--spatial_parallel", "2", "--tensor_parallel", "2"],
     "--tensor_parallel and --spatial_parallel both use the model mesh "
     "axis"),
    (["--spatial_parallel", "2"], "model axis 2 does not divide 1 devices"),
    (["--spatial_parallel", "2", "--num_devices", "3"],
     "model axis 2 does not divide 3 devices"),
    (["--spatial_parallel", "2", "--num_devices", "2", "--fsdp", "true"],
     "--fsdp needs >= 2 devices on the data axis"),
    ([*COORD, "--spatial_parallel", "2", "--host_rng", "true"],
     "--host_rng is only wired for single-device runs"),
    ([*COORD, "--spatial_parallel", "2", "--log_norms", "true"],
     "--log_norms is only wired for single-device runs"),
    (["--spatial_parallel", "3", "--num_devices", "3"],
     "--spatial_parallel 3 does not divide the lowest resolution 8 "
     "(--image_size / 2^(levels - 1)): every level's slice of the height "
     "must be whole"),
    (["--spatial_parallel", "16", "--num_devices", "16"],
     "--spatial_parallel 16 does not divide the lowest resolution 8 "
     "(--image_size / 2^(levels - 1)): every level's slice of the height "
     "must be whole"),
])
def test_spatial_bad_combos_exit_with_the_jax_clis_message(
        tmp_path, flags, message):
    with pytest.raises(SystemExit) as exit_:
        port_cli.main(["--data_file", str(tmp_path / "d.bin"), *MODEL,
                       *flags])
    assert str(exit_.value) == f"train: {message}", exit_.value
