"""The port's Megatron tensor parallelism and its 2-D tp x fsdp split
(`unet_tpu_torch/parallel/tensor.py`, `parallel/mesh.py`,
`cli/train.py --tensor_parallel`) on the CPU over gloo.

Three meshes of tests/torch_dist_worker.py's TP jobs: data 1 x model 2 in
two processes; data 2 x model 2 (TP and tp x fsdp in the same processes)
and then data 1 x model 4, where the attention blocks of TINY (two heads)
do not split and stay whole, in four.  The model is TINY with scale-shift
norm, so that emb's [scale | shift] rows are cut part by part.  The
contract is the JAX package's (tests/test_parallel.py, TP and tp x fsdp on
a 4 x 2 mesh): the ranks compute the math of one device at the global
batch.  Tolerances: the loss 1e-5 relative and the gradient 1e-5 absolute
against the JAX package's single-device `value_and_grad` (of TP, and of
tp x fsdp where there is a data axis); after two AdamW
steps with the EMA, parameters, moments and EMA within 5e-4 of one process
and losses within 1e-5 relative (tests/test_torch_parallel.py's bars); the
leaves a rank keeps whole bit-equal over the model ranks.

Every mesh also runs level 0 in patch space (the worker's `s2d` job,
`set_s2d_mode("on")` around it alone): the TP (tp x fsdp with a data
axis) loss and gradient against the JAX package's single-device s2d
`value_and_grad`, and on data 1 x model 2 two s2d steps with remat and
microbatches against the one-process s2d run, at the same bars.
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
from unet_tpu.models import unet as jax_unet
from unet_tpu.parallel import mesh as jax_mesh
from unet_tpu.training import trainer as jax_trainer
from unet_tpu_torch.cli import train as port_cli
from unet_tpu_torch.config import TrainConfig, UnetConfig
from unet_tpu_torch.data.dataset import write_bin
from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule)
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.io import convert
from unet_tpu_torch.models import unet as port_unet
from unet_tpu_torch.ops.kernels import groupnorm as port_gn
from unet_tpu_torch.parallel import mesh as pmesh
from unet_tpu_torch.parallel import tensor
from unet_tpu_torch.training import trainer

from tests import torch_dist_worker as worker
from tests.torch_port_util import (TINY, configs, flat_weights, run_ranks,
                                   s2d_on)

T_STEPS = 1000
B = 4  # the global batch
SCALE_SHIFT = dict(use_scale_shift_norm=True)


def _cfgs():
    return configs(**SCALE_SHIFT)


@pytest.fixture(scope="module")
def inputs():
    """The numpy inputs of every mesh: weights, a global batch of 4 rows,
    its t and noise, two steps' batches and labels."""
    _, cfg = _cfgs()
    rng = np.random.default_rng(11)
    shape = (B, cfg.image_size, cfg.image_size, cfg.in_channels)
    return dict(
        weights=flat_weights(cfg, None, seed=11),
        weights_cond=flat_weights(cfg, 10, seed=12),
        batch=rng.standard_normal(shape, dtype=np.float32) * 0.5,
        t=rng.integers(0, T_STEPS, size=B),
        noise=rng.standard_normal(shape, dtype=np.float32),
        chunk=rng.standard_normal((2,) + shape, dtype=np.float32) * 0.5,
        labels=rng.integers(0, 10, size=(2, B)))


# Two runs of the worker: 2 ranks, and 4 ranks that take two meshes in
# turn (one set of processes, to keep the file's time down).  Every mesh
# runs the `s2d` job too (level 0 in patch space).
SPAWNS = {"world2": [("data1_model2", 2, ["remat", "cond", "s2d"])],
          "world4": [("data2_model2", 2, ["s2d"]),
                     ("data1_model4", 4, ["s2d"])]}
MESHES = {name: (spawn, model) for spawn, meshes in SPAWNS.items()
          for name, model, _ in meshes}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, inputs):
    """`run(spawn)`: the output directory of one run of the worker's TP
    jobs (made once)."""
    done = {}

    def run(spawn):
        if spawn in done:
            return done[spawn]
        world = int(spawn[len("world"):])
        out = tmp_path_factory.mktemp(spawn)
        np.savez(out / "inputs.npz", **inputs)

        def argvs(port):
            spec = dict(address=f"localhost:{port}", world=world,
                        meshes=SPAWNS[spawn],
                        cfg={k: list(v) if isinstance(v, tuple) else v
                             for k, v in {**TINY, **SCALE_SHIFT}.items()},
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
    """The results of the TP jobs on one mesh: (data, model, jobs, rank 0's
    results, each rank's vector after `tp`, each rank's place)."""
    spawn, model = MESHES[request.param]
    world = int(spawn[len("world"):])
    out = spawned(spawn) / request.param
    jobs = next(j for n, _, j in SPAWNS[spawn] if n == request.param)
    return dict(data=world // model, model=model, jobs=jobs,
                results=dict(np.load(out / "results.npz")),
                local=[np.load(out / f"local{r}.npy") for r in range(world)],
                kept_grad=[np.load(out / f"kept_grad{r}.npy")
                           for r in range(world)],
                mesh=[json.load(open(out / f"mesh{r}.json"))
                      for r in range(world)])


def _diffusion():
    return GaussianDiffusion.create(named_beta_schedule("linear", T_STEPS),
                                    device="cpu")


def _jax_grad(inputs):
    """The JAX package's single-device loss and gradient at the global
    batch (torch-order flat vector), in the JAX package's current s2d
    mode."""
    jcfg, _ = _cfgs()
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


def _assert_grad(ranks, want_loss, want, inputs, prefix=""):
    np.testing.assert_allclose(float(ranks["results"][f"{prefix}grad_loss"]),
                               want_loss, rtol=1e-5)
    _, cfg = _cfgs()
    views = trainer.Unravel(convert.params_from_flat(
        inputs["weights"], cfg, device="cpu"))(
            torch.from_numpy(ranks["results"][f"{prefix}grad"]))
    np.testing.assert_allclose(
        port_ckpt.flatten_tensors(list(views.values())), want, atol=1e-5)


def test_tp_loss_and_gradient_equal_the_jax_single_device(ranks, jax_grad,
                                                         inputs):
    _assert_grad(ranks, *jax_grad, inputs)


def test_s2d_tp_loss_and_gradient_equal_the_jax_single_device_s2d(
        ranks, jax_s2d_grad, inputs):
    """The same with level 0 in patch space on both sides (TP, and tp x
    fsdp where there is a data axis): each rank expands its piece of conv1
    and conv2, normalises its channels through the free view, and the
    partial products' sum is one device's s2d gradient."""
    _assert_grad(ranks, *jax_s2d_grad, inputs, prefix="s2d_")


def _one_process(inputs, num_classes=None):
    """Two steps of the one-device tree step at the global batch, same seed
    (`make_train_step` with labels): the run the ranks must reproduce."""
    _, cfg = _cfgs()
    model = convert.params_from_flat(
        inputs["weights" if num_classes is None else "weights_cond"], cfg,
        num_classes, device="cpu")
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
    return {None: _one_process(inputs), 10: _one_process(inputs, 10)}


def test_s2d_tp_remat_steps_equal_one_process_in_s2d(spawned, inputs):
    """On data 1 x model 2, in patch space: two TP steps with remat and
    microbatches of one row (the recompute repeats the model group's
    all-reduces) follow the one-process s2d run at the global batch."""
    results = dict(np.load(spawned("world2") / "data1_model2"
                           / "results.npz"))
    with s2d_on():
        want = _one_process(inputs)
    np.testing.assert_allclose(results["s2d_remat_losses"], want["losses"],
                               rtol=1e-5)
    for part in ("flat", "m", "v", "ema"):
        np.testing.assert_allclose(results[f"s2d_remat_{part}"], want[part],
                                   atol=5e-4, err_msg=part)


def test_tp_and_tp_fsdp_equal_one_process_at_the_global_batch(
        ranks, one_process):
    results = ranks["results"]
    runs = {"tp": None}  # name: the labels' classes
    if ranks["data"] > 1:
        runs["tpfsdp"] = None
    runs.update({job: (10 if job == "cond" else None)
                 for job in ranks["jobs"] if job in ("remat", "cond")})
    for name, num_classes in runs.items():
        want = one_process[num_classes]
        np.testing.assert_allclose(results[f"{name}_losses"],
                                   want["losses"], rtol=1e-5, err_msg=name)
        for part in ("flat", "m", "v", "ema"):
            np.testing.assert_allclose(results[f"{name}_{part}"], want[part],
                                       atol=5e-4, err_msg=f"{name} {part}")
    if ranks["data"] > 1:  # tp x fsdp is TP
        np.testing.assert_allclose(results["tpfsdp_losses"],
                                   results["tp_losses"], rtol=1e-5)
        for part in ("flat", "m", "v", "ema"):
            np.testing.assert_allclose(results[f"tpfsdp_{part}"],
                                       results[f"tp_{part}"], atol=5e-4,
                                       err_msg=part)


def _layouts(model, n):
    return [pmesh.Layout(model, tensor.Shard(n, m)) for m in range(n)]


def test_leaves_kept_whole_are_bit_equal_over_the_model_ranks(ranks, inputs):
    """After two steps every leaf a rank keeps whole has the same bits on
    every model rank of its data index; a row-parallel bias is on model
    rank 0 alone."""
    _, cfg = _cfgs()
    model = convert.params_from_flat(inputs["weights"], cfg, device="cpu")
    n = ranks["model"]
    layouts = _layouts(model, n)
    for d in range(ranks["data"]):
        views = [layouts[m].local(torch.from_numpy(
            ranks["local"][d * n + m][:layouts[m].size])) for m in range(n)]
        whole = [name for name in layouts[0].whole.names
                 if name not in layouts[0].splits]
        assert whole and all(name in v for v in views for name in whole)
        for name in whole:
            for m in range(1, n):
                assert torch.equal(views[m][name], views[0][name]), name
        first = [name for name, split in layouts[0].splits.items()
                 if split == tensor.FIRST]
        assert first and all(name in views[0] for name in first)
        assert not any(name in v for v in views[1:] for name in first)


def test_leaves_kept_whole_get_one_gradient_over_the_model_ranks(ranks):
    """Where the model ranks' copies of the leaves kept whole differ (each
    rank moved its own by its own amount, as a backward that does not
    repeat its bits would make them differ), the step's gradient of those
    leaves has the same bits on every model rank of a data index: it is
    averaged over the model group, so the copies cannot drift apart."""
    n = ranks["model"]
    for d in range(ranks["data"]):
        grads = ranks["kept_grad"][d * n:(d + 1) * n]
        assert grads[0].size and np.isfinite(grads[0]).all()
        for m in range(1, n):
            np.testing.assert_array_equal(grads[m], grads[0])


def test_make_mesh_lays_the_ranks_out_as_the_jax_mesh(ranks):
    data, model = ranks["data"], ranks["model"]
    for r, place in enumerate(ranks["mesh"]):
        assert (place["data"], place["model"]) == (data, model)
        assert (place["data_rank"], place["model_rank"]) == divmod(r, model)
        assert place["rows"] == [r // model, data]   # rows d, d + data, ...
        assert 0.8 < place["fraction"]["tp"] < 1.0
        if data > 1:  # the even split over the data axis leaves none whole
            assert place["fraction"]["tpfsdp"] == 1.0


def _jax_names(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(getattr(k, "key", getattr(k, "idx", None)))
                     for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("n", [2, 4])
def test_shard_plan_is_the_jax_plan_but_for_its_stated_differences(n):
    """The leaves the port splits are those of the JAX package's
    `tp_sharding` on its 8-device CPU mesh (8 / n data x n model), except:
    gn2's affine is cut with the channels it scales, the bias of conv2 and
    proj is held by model rank 0 alone, and a block whose widths do not
    split (attention of two heads at n = 4) stays whole where the JAX
    package cuts its qkv rows across the heads.  `shard_fraction` follows;
    under tp x fsdp the port's even split leaves nothing whole, the JAX
    package's per-leaf split very little."""
    jcfg, cfg = _cfgs()
    params = jax.eval_shape(lambda k: jax_unet.init(k, jcfg),
                            jax.random.PRNGKey(0))
    mesh = jax_mesh.make_mesh(data=8 // n, model=n)
    tree = jax_mesh.tp_sharding(mesh, params)
    jax_split = {name for name, sh in _jax_names(tree).items()
                 if any(p is not None for p in sh.spec)}

    model = port_unet.init(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    layout = _layouts(model, n)[0]
    want = set(jax_split)
    for prefix, module in model.named_modules():
        if isinstance(module, port_unet.blocks.ResBlock):
            assert tensor.res_splits(module.conv2.w.shape[0],
                                     cfg.gn_num_groups, n)
            want |= {f"{prefix}.{leaf}" for leaf in
                     ("gn2.scale", "gn2.bias", "conv2.b")}
        elif isinstance(module, port_unet.blocks.AttentionBlock):
            if tensor.attn_splits(module.proj.w.shape[0],
                                  cfg.num_head_channels, n):
                want.add(f"{prefix}.proj.b")
            else:
                want -= {f"{prefix}.{leaf}" for leaf in
                         ("qkv.w", "qkv.b", "proj.w")}
    assert set(layout.splits) == want
    assert (n == 4) == any(".attn." in name for name in jax_split - want)

    sizes = dict(zip(layout.whole.names, layout.whole.sizes))
    jax_fraction = jax_mesh.shard_fraction(tree, params)
    assert jax_fraction == pytest.approx(
        sum(sizes[k] for k in jax_split) / sum(sizes.values()))
    assert layout.fraction == pytest.approx(
        sum(sizes[k] for k in want) / sum(sizes.values()))
    placement = pmesh.Placement(layout.size, 8 // n, 0, True)
    assert pmesh.shard_fraction(placement, layout) == 1.0
    assert pmesh.shard_fraction(pmesh.Placement(layout.size, 1, 0, False),
                                layout) == layout.fraction
    assert jax_mesh.shard_fraction(
        jax_mesh.tp_fsdp_sharding(mesh, params), params) > 0.95


@pytest.mark.parametrize("n", [1, 2, 4])
def test_pieces_join_back_into_every_leaf(n):
    """`take` then `join` is the identity for every leaf of a model with
    scale-shift norm and a label embedding; qkv's piece is the rank's heads
    packed [q | k | v], emb's its channels of scale then of shift."""
    _, cfg = _cfgs()
    model = convert.params_from_flat(flat_weights(cfg, 10, seed=3), cfg, 10,
                                     device="cpu")
    layouts = _layouts(model, n)
    whole = layouts[0].whole.flatten(model)
    pieces = [layout.take(whole) for layout in layouts]
    assert [p.numel() for p in pieces] == [layout.size for layout in layouts]
    assert torch.equal(layouts[0].join(pieces), whole)
    attn, res = model.input[3].attn, model.input[3].res
    C = attn.proj.w.shape[0]
    for m, layout in enumerate(layouts):
        got = layout.local(pieces[m])
        qkv = got["input.3.attn.qkv.w"]
        if tensor.attn_splits(C, cfg.num_head_channels, n):
            rows = torch.cat([torch.arange(p * C + m * C // n,
                                           p * C + (m + 1) * C // n)
                              for p in range(3)])
            assert torch.equal(qkv, attn.qkv.w.detach()[rows])
        else:
            assert torch.equal(qkv, attn.qkv.w.detach())
        cout = res.conv2.w.shape[0]
        rows = torch.cat([torch.arange(p * cout + m * cout // n,
                                       p * cout + (m + 1) * cout // n)
                          for p in range(2)])
        assert torch.equal(got["input.3.res.emb.w"], res.emb.w.detach()[rows])
        assert ("input.3.res.conv2.b" in got) == (m == 0)


@pytest.mark.parametrize("n", [2, 4])
def test_gn_geometry_takes_every_sharded_gn2_of_the_default_model(n):
    """A split ResBlock hands K4/K5 its C_out/N channels in G/N groups, such
    as (32, 64, 64, 16) in 8 groups at N = 4: the wrapper's geometry takes
    each at the trainer's batch, both types and directions, as
    tests/test_torch_gn_geometry.py holds the whole model's."""
    cfg = UnetConfig()
    plan, res, shapes = port_unet.build_plan(cfg), cfg.image_size, set()
    for group in plan.input_blocks + (plan.middle,) + plan.output_blocks:
        for layer in group:
            if layer[0] == "res" and tensor.res_splits(
                    layer[2], cfg.gn_num_groups, n):
                shapes.add((res, res, layer[2] // n))
            elif layer[0] == "down":
                res //= 2
            elif layer[0] == "up":
                res *= 2
    assert (64, 64, 64 // n) in shapes
    G = cfg.gn_num_groups // n
    for H, W, C in sorted(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            for backward in (False, True):
                geo = port_gn.geometry(32, H, W, C, G, dtype, backward)
                what = ((H, W, C), G, dtype, backward, geo)
                assert geo.cluster in (1, 2, 4, 8, 16), what
                assert geo.cluster * geo.rows_per_block >= H * W, what
                assert 0 < geo.smem_bytes <= 227 * 1024, what
                if dtype == torch.bfloat16:
                    assert geo.staged, what


def test_state_round_trip_keeps_each_moment_with_its_parameter():
    """`init_state` takes the moments in the parameters' order, as a
    `TrainState` holds them, and `tree_state` gives them back in it: in a
    class-conditional model that order puts `label_emb` before the time
    MLP, where the flat vector's puts it after."""
    _, cfg = _cfgs()
    model = convert.params_from_flat(flat_weights(cfg, 10, seed=4), cfg, 10,
                                     device="cpu")
    params = [p for _, p in model.named_parameters()]
    m = [torch.full_like(p, i) for i, p in enumerate(params)]
    v = [torch.full_like(p, -i) for i, p in enumerate(params)]
    unravel = trainer.Unravel(model)
    mesh = pmesh.Mesh(data=1, rank=0, device=torch.device("cpu"))
    state = pmesh.init_state(unravel, model, mesh, m=m, v=v, step=3)
    back = pmesh.tree_state(unravel, *pmesh.host_state(state), step=3,
                            seed=0)
    assert [n for n, _ in back.params.named_parameters()][0] == "label_emb"
    for a, b in zip(back.m + back.v, m + v):
        assert torch.equal(a, b)


# --- the CLI ----------------------------------------------------------------

MODEL = ["--num_channels", str(TINY["model_channels"]),
         "--image_size", str(TINY["image_size"]), "--channel_mult", "1,2",
         "--num_res_blocks", "1", "--attention_resolutions", "8",
         "--use_scale_shift_norm", "true", "--device", "cpu", "--lr", "1e-4",
         "--ema_rate", "0.9", "--log_interval", "2", "--save_interval", "2",
         "--batch_size", "4"]
TRAIN = [sys.executable, "-m", "unet_tpu_torch.cli.train"]


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """A .bin of 20 images from uint8 pixels, and the one-process run at
    batch 4, 4 steps, saved at 2 and 4."""
    root = tmp_path_factory.mktemp("tp_cli")
    rng = np.random.default_rng(5)
    pixels = rng.integers(0, 256, (20, 3, TINY["image_size"],
                                   TINY["image_size"]))
    write_bin(str(root / "d.bin"),
              (pixels / 127.5 - 1.0).astype(np.float32))
    port_cli.main(_flags(root, "one", "--iterations", "4"))
    return root


def _flags(root, name, *extra):
    return ["--data_file", str(root / "d.bin"), *MODEL,
            "--output_dir", str(root / name),
            "--log_file", str(root / f"{name}.txt"), *extra]


def _tp(root, name, *extra):
    """One `cli.train` command of 2 ranks, data 1 x model 2, in a child
    process."""
    codes, text = run_ranks(lambda port: [[*TRAIN, *_flags(
        root, name, "--num_devices", "2", "--tensor_parallel", "2",
        *extra)]], [root / f"{name}.out"])
    assert codes == [0], text[-4000:]
    return text


def _assert_checkpoint_near(root, name, step, ref="one"):
    """`name`'s model_<step>.bin holds `ref`'s state within 5e-4, and the
    JAX package's loader reads it."""
    a = port_ckpt.load(str(root / name / f"model_{step}.bin"), device="cpu")
    b = port_ckpt.load(str(root / ref / f"model_{step}.bin"), device="cpu")
    assert a.step == b.step == step and a.batch_size == b.batch_size == 4
    for x, y in ((port_ckpt.flatten_params(a.params),
                  port_ckpt.flatten_params(b.params)),
                 (a.adam_m, b.adam_m), (a.adam_v, b.adam_v),
                 (port_ckpt.flatten_params(a.ema),
                  port_ckpt.flatten_params(b.ema))):
        np.testing.assert_allclose(x, y, atol=5e-4)
    jcfg, _ = _cfgs()
    j = jax_ckpt.load(str(root / name / f"model_{step}.bin"), jcfg)
    assert j.step == step
    np.testing.assert_array_equal(jax_ckpt.flatten_params(j.params, jcfg),
                                  port_ckpt.flatten_params(a.params))


def _losses(root, name):
    return {int(s): float(v) for s, v in re.findall(
        r"step (\d+): loss (\S+)", (root / f"{name}.txt").read_text())}


def test_tensor_parallel_2_writes_the_one_device_bin_and_resumes_across(
        cli_data):
    """2 steps under --num_devices 2 --tensor_parallel 2 write the .bin one
    device writes, and one process resumes it to step 4: the straight
    one-process run.  The other way, two --coordinator_address processes
    under --tensor_parallel 2 resume the one-process checkpoint of step 2
    to the same step 4."""
    out = _tp(cli_data, "tp", "--iterations", "2")
    assert "data parallel: 1 rank(s) x batch 4 = global batch 4" in out
    assert "tensor parallel: 2 model ranks a data rank" in out
    assert "of elements sharded (tp)" in out
    _assert_checkpoint_near(cli_data, "tp", 2)
    want = _losses(cli_data, "one")
    np.testing.assert_allclose(_losses(cli_data, "tp")[2], want[2],
                               rtol=2e-5)
    port_cli.main(_flags(cli_data, "back", "--iterations", "4",
                         "--model_weights",
                         str(cli_data / "tp" / "model_2.bin")))
    _assert_checkpoint_near(cli_data, "back", 4)

    def argvs(port):
        return [[*TRAIN, *_flags(
            cli_data, "from_one", "--iterations", "4", "--tensor_parallel",
            "2", "--model_weights", str(cli_data / "one" / "model_2.bin"),
            "--coordinator_address", f"localhost:{port}",
            "--num_processes", "2", "--process_id", str(r))]
            for r in range(2)]

    codes, text = run_ranks(argvs, [cli_data / f"from_one{r}.out"
                                    for r in range(2)])
    assert codes == [0, 0], text[-4000:]
    _assert_checkpoint_near(cli_data, "from_one", 4)
    np.testing.assert_allclose(_losses(cli_data, "from_one")[4], want[4],
                               rtol=2e-5)


COORD = ["--coordinator_address", "localhost:1", "--num_processes", "2",
         "--process_id", "0"]


@pytest.mark.parametrize("flags,message", [
    (["--tensor_parallel", "2", "--spatial_parallel", "2"],
     "--tensor_parallel and --spatial_parallel both use the model mesh "
     "axis"),
    (["--tensor_parallel", "2"], "model axis 2 does not divide 1 devices"),
    (["--tensor_parallel", "2", "--num_devices", "3"],
     "model axis 2 does not divide 3 devices"),
    (["--tensor_parallel", "2", "--num_devices", "2", "--fsdp", "true"],
     "--fsdp needs >= 2 devices on the data axis"),
    ([*COORD, "--tensor_parallel", "2", "--host_rng", "true"],
     "--host_rng is only wired for single-device runs"),
    ([*COORD, "--tensor_parallel", "2", "--log_norms", "true"],
     "--log_norms is only wired for single-device runs"),
])
def test_model_axis_bad_combos_exit_with_the_jax_clis_message(
        tmp_path, flags, message):
    with pytest.raises(SystemExit) as exit_:
        port_cli.main(["--data_file", str(tmp_path / "d.bin"), *MODEL,
                       *flags])
    assert str(exit_.value) == f"train: {message}", exit_.value
