"""The port's space-to-depth level 0 (unet_tpu_torch/ops/s2d.py and the
model's `set_s2d_mode`) against the JAX package's, on the CPU.

Tolerances: the layout ops and `expand_weights` bit for bit (reshapes and
a gather); the other ops float32 2e-5 forward and 3e-5 / 1e-4 (absolute /
relative) for gradients (tests/test_pallas.py's bars); the whole U-Net
float32 2e-3 forward and 1e-3 for the parameter gradients
(tests/test_model.py's), bfloat16 within 1.5x the JAX package's own
bfloat16 distance from float32; the port's patch space against its own
pixel space 1e-4 / 2e-3 (tests/test_s2d.py's); a train step's loss 1e-5
relative and its parameters 1e-3.  Every JAX function that takes the
mode is traced with both packages set to "on" and the modes restored after
(JAX reads it when it traces).  The model axis in patch space runs in
tests/test_torch_spatial_parallel.py and tests/test_torch_tensor_parallel.py;
here, in one process, the pieces a TP rank expands and the bias it may
lack, and the CLI's flag rules.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.config import TrainConfig as JaxTrainConfig
from unet_tpu.config import UnetConfig as JaxConfig
from unet_tpu.diffusion import gaussian as jax_gaussian
from unet_tpu.io import checkpoint as jax_ckpt
from unet_tpu.models import unet as jax_unet
from unet_tpu.ops import s2d as JS
from unet_tpu.training import trainer as jax_trainer
from unet_tpu_torch.cli import train as port_cli
from unet_tpu_torch.config import TrainConfig, UnetConfig
from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule)
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.models import unet as port_unet
from unet_tpu_torch.ops import s2d as PS
from unet_tpu_torch.training import trainer

from tests.torch_port_util import (ROOT, TINY, both_models, configs, j2n,
                                   s2d_on, t2n)


def _hwio_to_oihw(w):
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def _normal(rng, shape, scale=1.0):
    return (rng.standard_normal(shape, dtype=np.float32) * scale).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the ops

def _layout_cases(rng):
    x = _normal(rng, (2, 8, 6, 5))
    xs = np.asarray(JS.space_to_depth(jnp.asarray(x)))
    ys = np.asarray(JS.space_to_depth(jnp.asarray(_normal(rng, (2, 8, 6, 3)))))
    v = _normal(rng, (2, 7))
    return {
        "space_to_depth": ("space_to_depth", (x,)),
        "depth_to_space": ("depth_to_space", (xs,)),
        "concat_channels": ("concat_channels", (xs, ys)),
        "tile_phases": ("tile_phases", (v,)),
        "upsample_2x_to_s2d": ("upsample_2x_to_s2d", (x,)),
    }


@pytest.mark.parametrize("op", ["space_to_depth", "depth_to_space",
                                "concat_channels", "tile_phases",
                                "upsample_2x_to_s2d"])
def test_layout_op_is_bit_equal_to_jax(op):
    name, args = _layout_cases(np.random.default_rng(0))[op]
    want = getattr(JS, name)(*map(jnp.asarray, args))
    got = getattr(PS, name)(*map(torch.from_numpy, args))
    np.testing.assert_array_equal(t2n(got), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expand_weights_is_bit_equal_to_jax(dtype):
    w = _normal(np.random.default_rng(1), (3, 3, 5, 7))
    want = JS.expand_weights(jnp.asarray(w).astype(dtype))
    got = PS.expand_weights(torch.from_numpy(_hwio_to_oihw(w)).to(
        getattr(torch, dtype)))
    assert got.shape == (28, 20, 2, 2) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(t2n(got),
                                  j2n(want).transpose(3, 2, 0, 1))


def test_expand_weights_gradient_lands_on_the_taps():
    """Autograd through the gather adds each slot's cotangent back onto the
    tap it came from: JAX's vjp of its einsum."""
    rng = np.random.default_rng(2)
    w, ct = _normal(rng, (3, 3, 4, 6)), _normal(rng, (2, 2, 16, 24))
    _, vjp = jax.vjp(JS.expand_weights, jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    tw = torch.from_numpy(_hwio_to_oihw(w)).requires_grad_()
    PS.expand_weights(tw).backward(torch.from_numpy(
        _hwio_to_oihw(ct)))
    np.testing.assert_allclose(tw.grad.numpy(), want.transpose(3, 2, 0, 1),
                               atol=1e-6)


# tests/test_s2d.py's three shapes: (Cin, Cout, H, W)
@pytest.mark.parametrize("cin,cout,h,w", [(64, 64, 8, 8), (192, 64, 6, 10),
                                          (3, 32, 4, 4)])
def test_conv2d_s2d_forward_and_grads_match_jax(cin, cout, h, w):
    rng = np.random.default_rng(3)
    x = np.asarray(JS.space_to_depth(jnp.asarray(_normal(rng, (2, h, w,
                                                                cin)))))
    k = _normal(rng, (3, 3, cin, cout), 0.1)
    b = _normal(rng, (cout,), 0.1)
    dout = _normal(rng, (2, h // 2, w // 2, 4 * cout))

    def loss(x, k, b):
        return jnp.sum(JS.conv2d_s2d(x, k, b) * dout)

    jx, jk, jb = map(jnp.asarray, (x, k, b))
    want = JS.conv2d_s2d(jx, jk, jb)
    gx, gk, gb = jax.grad(loss, argnums=(0, 1, 2))(jx, jk, jb)
    tx, tk, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, _hwio_to_oihw(k), b))
    got = PS.conv2d_s2d(tx, tk, tb)
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=2e-5)
    got.backward(torch.from_numpy(dout))
    for g, e in ((tx.grad, gx), (tk.grad, np.asarray(gk).transpose(
            3, 2, 0, 1)), (tb.grad, gb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=3e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("op", ["conv1x1", "avg_pool", "gn_silu", "gn_none"])
def test_op_matches_jax(op):
    rng = np.random.default_rng(4)
    x = np.asarray(JS.space_to_depth(jnp.asarray(
        _normal(rng, (2, 8, 8, 64), 2.0) + 0.5)))
    if op == "conv1x1":
        k, b = _normal(rng, (1, 1, 64, 32), 0.2), _normal(rng, (32,), 0.1)
        want = JS.conv1x1_s2d(*map(jnp.asarray, (x, k, b)))
        got = PS.conv1x1_s2d(*map(torch.from_numpy,
                                  (x, _hwio_to_oihw(k), b)))
    elif op == "avg_pool":
        want = JS.avg_pool_2x_from_s2d(jnp.asarray(x))
        got = PS.avg_pool_2x_from_s2d(torch.from_numpy(x))
    else:
        act = op.split("_")[1]
        gamma = _normal(rng, (64,), 0.3) + 1
        beta = _normal(rng, (64,), 0.2)
        want = JS.group_norm_silu_s2d(*map(jnp.asarray, (x, gamma, beta)),
                                      num_groups=32, act=act)
        got = PS.group_norm_silu_s2d(*map(torch.from_numpy,
                                          (x, gamma, beta)),
                                     num_groups=32, act=act)
    assert got.shape == want.shape
    np.testing.assert_allclose(t2n(got), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------------------
# the gating

@pytest.mark.parametrize("fields,supported", [
    (dict(), True), (dict(image_size=128), True),
    (dict(attention_ds=(1, 2)), False),  # attention at ds=1 stays in pixels
    (dict(channel_mult=(1,)), False),    # no level below level 0
    (dict(image_size=2), False)])
def test_s2d_supported_as_jax(fields, supported):
    assert port_unet.s2d_supported(UnetConfig(**fields)) is supported
    assert jax_unet.s2d_supported(JaxConfig(**fields)) is supported


def test_set_s2d_mode_refuses_an_unknown_name_and_auto_is_pixel_space():
    _, cfg = configs()
    assert port_unet.s2d_supported(cfg)
    saved = port_unet._S2D_MODE
    try:
        with pytest.raises(ValueError, match="unknown space-to-depth"):
            port_unet.set_s2d_mode("yes")
        assert port_unet._S2D_MODE == saved
        port_unet.set_s2d_mode("auto")
        assert not port_unet._use_s2d(cfg)
        port_unet.set_s2d_mode("on")
        assert port_unet._use_s2d(cfg)
        assert not port_unet._use_s2d(UnetConfig(**{**TINY,
                                                    "attention_ds": (1,)}))
    finally:
        port_unet.set_s2d_mode(saved)


# ---------------------------------------------------------------------------
# the whole model

@pytest.fixture(scope="module", params=[False, True],
                ids=["plain_norm", "scale_shift_norm"])
def model_case(request):
    """One weight set on both sides; the JAX forward and parameter gradient
    of sum(apply * dout) in mode "on", each compiled once."""
    jcfg, cfg = configs(use_scale_shift_norm=request.param)
    params, model, _ = both_models(jcfg, cfg, seed=1)
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 16, 16, 3))
    t = np.array([3.0, 500.0], np.float32)
    dout = _normal(rng, (2, 16, 16, 3))
    with s2d_on():
        out = jax.jit(lambda p: jax_unet.apply(p, jcfg, x, t))(params)
        grads = jax.jit(jax.grad(lambda p: jnp.sum(
            jax_unet.apply(p, jcfg, x, t) * dout)))(params)
    return dict(model=model, x=x, t=t, dout=dout, out=np.asarray(out),
                grads=jax_ckpt.flatten_params(grads, jcfg))


def _port_forward_and_grads(model, x, t, dout):
    model.zero_grad()
    out = port_unet.apply(model, torch.from_numpy(x), torch.from_numpy(t))
    (out * torch.from_numpy(dout)).sum().backward()
    grads = port_ckpt.flatten_tensors([p.grad for p in model.parameters()])
    return t2n(out), grads


def test_s2d_forward_and_gradients_match_jax(model_case):
    c = model_case
    with s2d_on():
        out, grads = _port_forward_and_grads(c["model"], c["x"], c["t"],
                                             c["dout"])
    np.testing.assert_allclose(out, c["out"], atol=2e-3)
    np.testing.assert_allclose(grads, c["grads"], atol=1e-3)


def test_s2d_equals_the_ports_pixel_space(model_case):
    c = model_case
    with s2d_on():
        s2d = _port_forward_and_grads(c["model"], c["x"], c["t"], c["dout"])
    pixel = _port_forward_and_grads(c["model"], c["x"], c["t"], c["dout"])
    np.testing.assert_allclose(s2d[0], pixel[0], atol=1e-4)
    np.testing.assert_allclose(s2d[1], pixel[1], atol=2e-3, rtol=1e-4)


def test_s2d_remat_equals_no_remat(model_case):
    """Under remat each group's recompute runs in the mode the forward gave
    it (`run`'s arguments carry it)."""
    c = model_case
    model, x, t = c["model"], *map(torch.from_numpy, (c["x"], c["t"]))
    outs = []
    with s2d_on():
        for remat in (False, True):
            model.zero_grad()
            out = port_unet.apply(model, x, t, remat=remat)
            (out * torch.from_numpy(c["dout"])).sum().backward()
            outs.append((t2n(out), port_ckpt.flatten_tensors(
                [p.grad for p in model.parameters()])))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=1e-6)


def test_s2d_bf16_forward_is_as_close_to_f32_as_jaxs():
    """bfloat16: the port's s2d forward within 1.5x the distance of the JAX
    package's bfloat16 s2d forward from its float32 one (the bar
    chip_smoke.py holds the card's s2d to).  Each package's bfloat16 model
    output lies about 3e-2 from float32 at this size, so two bfloat16
    models, in pixel space too, differ by more than an op's 3e-2."""
    jcfg, cfg = configs()
    params, model, _ = both_models(jcfg, cfg, seed=1)
    rng = np.random.default_rng(5)
    x = _normal(rng, (2, 16, 16, 3))
    t = np.array([3.0, 500.0], np.float32)
    with s2d_on():
        want, ref = (j2n(jax.jit(lambda p, dt=dt: jax_unet.apply(
            p, jcfg, x, t, compute_dtype=dt))(params))
            for dt in (jnp.float32, jnp.bfloat16))
        with torch.no_grad():
            got = port_unet.apply(model, torch.from_numpy(x),
                                  torch.from_numpy(t),
                                  compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    jax_bf16 = np.abs(ref - want).max()
    assert np.abs(t2n(got) - want).max() <= 1.5 * jax_bf16, jax_bf16


def test_s2d_train_step_with_matches_jax():
    """One `step_with` of each package in mode "on", t and noise given:
    loss and the parameters after the AdamW step.  AdamW's first step
    moves a parameter by lr g / (|g| + eps): with the default eps of 1e-8
    a gradient at rounding level moves by up to lr either way, and the two
    packages' gradients differ at that level, so eps is 1e-6 here; a
    gradient of real size still moves by lr, and a wrong sign by 2 lr."""
    jcfg, cfg = configs()
    params, model, _ = both_models(jcfg, cfg, seed=6)
    rng = np.random.default_rng(7)
    x = _normal(rng, (2, 16, 16, 3), 0.5)
    t = rng.integers(0, 1000, size=2)
    noise = _normal(rng, (2, 16, 16, 3))
    fields = dict(batch_size=2, lr=1e-3, weight_decay=0.01, eps=1e-6)
    jd = jax_gaussian.GaussianDiffusion.create(
        jax_gaussian.named_beta_schedule("linear", 1000))
    pd = GaussianDiffusion.create(named_beta_schedule("linear", 1000),
                                  device="cpu")
    with s2d_on():
        _, jstep = jax_trainer.make_train_step(
            jcfg, JaxTrainConfig(**fields), jd, donate=False)
        jstate, jloss = jstep(jax_trainer.init_state(params),
                              *map(jnp.asarray, (x, t, noise)))
        _, tstep = trainer.make_train_step(cfg, TrainConfig(**fields), pd,
                                           device="cpu")
        tstate, tloss = tstep(trainer.init_state(model), x, t, noise)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(port_ckpt.flatten_params(tstate.params),
                               jax_ckpt.flatten_params(jstate.params, jcfg),
                               atol=1e-3)


# ---------------------------------------------------------------------------
# the model axis (the multi-rank runs: tests/test_torch_spatial_parallel.py,
# tests/test_torch_tensor_parallel.py)

@pytest.mark.parametrize("split", ["rows", "columns"])
def test_expand_weights_of_a_ranks_piece_is_its_part_of_the_whole(split):
    """Under TP a split ResBlock expands its rank's piece of a kernel: of
    conv1's output rows, the (phase, o) rows of the whole expansion that
    hold the rank's channels; of conv2's input columns, the (phase, i)
    columns.  Bit for bit (a gather)."""
    w = torch.from_numpy(_hwio_to_oihw(_normal(np.random.default_rng(8),
                                               (3, 3, 6, 8))))
    whole = PS.expand_weights(w)
    n = 2
    for m in range(n):
        if split == "rows":
            O = w.shape[0]
            piece = PS.expand_weights(w[m * O // n:(m + 1) * O // n])
            want = whole[torch.cat([torch.arange(q * O + m * O // n,
                                                 q * O + (m + 1) * O // n)
                                    for q in range(4)])]
        else:
            I = w.shape[1]
            piece = PS.expand_weights(w[:, m * I // n:(m + 1) * I // n])
            want = whole[:, torch.cat([torch.arange(p * I + m * I // n,
                                                    p * I + (m + 1) * I // n)
                                       for p in range(4)])]
        np.testing.assert_array_equal(t2n(piece), t2n(want))


def test_conv2d_s2d_without_bias_equals_a_zero_bias():
    """A row-parallel conv2 on a model rank but the first has no bias."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_normal(rng, (2, 4, 3, 24)))
    w = torch.from_numpy(_hwio_to_oihw(_normal(rng, (3, 3, 6, 5), 0.2)))
    np.testing.assert_array_equal(
        t2n(PS.conv2d_s2d(x, w, None)),
        t2n(PS.conv2d_s2d(x, w, torch.zeros(5))))


@pytest.mark.parametrize("flag", ["--tensor_parallel", "--spatial_parallel"])
def test_cli_takes_the_model_axis_with_s2d(tmp_path, flag):
    """As the JAX CLI: UNET_TPU_TORCH_S2D=on passes the flag rules with a
    model axis of 2, with and without --fsdp."""
    model = ["--data_file", str(tmp_path / "d.bin"), "--device", "cpu",
             "--image_size", "16", "--num_channels", "32",
             "--channel_mult", "1,2", "--num_res_blocks", "1",
             "--attention_resolutions", "8", flag, "2"]
    with s2d_on():
        assert port_unet._use_s2d(port_cli.model_config_from_args(
            port_cli.create_argparser().parse_args(model)))
        for extra, ranks in ((["--num_devices", "2"], 2),
                             (["--num_devices", "4", "--fsdp", "true"], 4)):
            port_cli._reject_bad_combos(
                port_cli.create_argparser().parse_args(model + extra), ranks)


def test_an_unknown_environment_mode_acts_as_auto():
    """An unknown UNET_TPU_TORCH_S2D is "auto" when the module is imported,
    as the JAX package reads an unknown UNET_TPU_S2D: pixel space off a
    TPU.  `set_s2d_mode` still refuses the name."""
    code = ("from unet_tpu_torch.models import unet\n"
            "from unet_tpu_torch.config import UnetConfig\n"
            "print(unet._S2D_MODE, unet._use_s2d(UnetConfig()))\n"
            "try:\n"
            "    unet.set_s2d_mode('bogus')\n"
            "except ValueError:\n"
            "    print('refused')\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120, check=True,
        env=dict(os.environ, UNET_TPU_TORCH_S2D="bogus")).stdout.split()
    assert out == ["auto", "False", "refused"], out
