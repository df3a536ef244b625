"""The port's blocks and U-Net against the JAX package's, on the CPU, with
one set of numpy weights on both sides.

Tolerances: blocks float32 1e-4 absolute (a few convs deep, sums in another
order); the whole U-Net float32 2e-3, the bar tests/test_model.py holds the
JAX model to against its torch reference, and float64 1e-9, which a wiring
fault (head split, eps, skip order, null label) cannot pass.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.io import checkpoint as jax_ckpt
from unet_tpu.models import blocks as jax_blocks
from unet_tpu.models import unet as jax_unet
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.io import convert
from unet_tpu_torch.models import blocks as port_blocks
from unet_tpu_torch.models import unet as port_unet

from tests.torch_port_util import both_models, configs, j2n, t2n


def _fill(module, rng):
    """numpy weights into a port block; returns the JAX package's dict of
    the same weights in its native layouts (HWIO, (I, O))."""
    tree = {}
    with torch.no_grad():
        for name, p in module.named_parameters():
            a = rng.standard_normal(tuple(p.shape), dtype=np.float32)
            if name.endswith("scale"):
                a = 1 + 0.1 * a
            elif p.dim() > 1:
                a = a / np.float32(np.sqrt(np.prod(p.shape[1:])))
            else:
                a = 0.1 * a
            p.copy_(torch.from_numpy(a))
            native = {4: lambda v: v.transpose(2, 3, 1, 0),
                      2: lambda v: v.T, 1: lambda v: v}[p.dim()](a)
            layer, leaf = name.split(".")
            tree.setdefault(layer, {})[leaf] = jnp.asarray(native)
    return tree


@pytest.mark.parametrize("kwargs,cin,cout", [
    (dict(), 32, 32),
    (dict(), 32, 64),                        # with the 1x1 skip
    (dict(up=True), 64, 32),
    (dict(down=True), 32, 64),
    (dict(scale_shift_norm=True), 32, 64),
    (dict(scale_shift_norm=True, down=True), 64, 64),
])
def test_resblock(rng, kwargs, cin, cout):
    block = port_blocks.ResBlock(cin, cout, 128, **kwargs)
    assert hasattr(block, "skip") == (cin != cout)
    tree = _fill(block, rng)
    x = rng.standard_normal((2, 8, 8, cin), dtype=np.float32)
    emb = rng.standard_normal((2, 128), dtype=np.float32)
    want = jax_blocks.resblock_apply(tree, jnp.asarray(x), jnp.asarray(emb),
                                     **kwargs)
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.from_numpy(emb))
    assert got.shape == want.shape
    np.testing.assert_allclose(t2n(got), j2n(want), atol=1e-4)


def test_resblock_refuses_up_and_down():
    with pytest.raises(ValueError):
        port_blocks.ResBlock(32, 32, 64, up=True, down=True)


@pytest.mark.parametrize("channels", [64, 96])
def test_attention_block(rng, channels):
    block = port_blocks.AttentionBlock(channels)
    assert block.num_heads == channels // 32
    tree = _fill(block, rng)
    x = rng.standard_normal((2, 4, 4, channels), dtype=np.float32)
    want = jax_blocks.attention_apply(tree, jnp.asarray(x))
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    np.testing.assert_allclose(t2n(got), j2n(want), atol=1e-4)


def test_init_statistics():
    """torch-default bounds: U(+-1/sqrt(fan_in)) for weights and biases,
    ones and zeros for GroupNorm; one seed gives one model."""
    _, cfg = configs()
    gen = torch.Generator().manual_seed(3)
    model = port_unet.init(cfg, 4, generator=gen, device="cpu")
    conv = model.input[1].res.conv1
    bound = 1 / np.sqrt(conv.w.shape[1] * 9)
    assert conv.w.abs().max() <= bound and conv.w.abs().max() > 0.9 * bound
    assert conv.b.abs().max() <= bound
    lin = model.time_mlp.l2
    assert lin.w.abs().max() <= 1 / np.sqrt(lin.w.shape[1])
    assert torch.equal(model.out.gn.scale, torch.ones_like(model.out.gn.scale))
    assert not model.out.gn.bias.any()
    assert model.label_emb.shape == (4, cfg.time_embed_dim)
    again = port_unet.init(cfg, 4, generator=torch.Generator().manual_seed(3),
                           device="cpu")
    np.testing.assert_array_equal(port_ckpt.flatten_params(model),
                                  port_ckpt.flatten_params(again))


# ---------------------------------------------------------------------------
# the U-Net as a whole


def _inputs(rng, cfg, B=2):
    x = rng.standard_normal((B, cfg.image_size, cfg.image_size,
                             cfg.in_channels), dtype=np.float32)
    t = np.array([7.0, 993.0], np.float32)[:B]
    return x, t


@pytest.mark.parametrize("labels", [None, (3, 0), (2, -1)])
def test_unet_forward_f32(rng, labels):
    jcfg, cfg = configs()
    num_classes = None if labels is None else 5
    params, model, _ = both_models(jcfg, cfg, num_classes)
    x, t = _inputs(rng, cfg)
    jy = None if labels is None else jnp.asarray(labels, jnp.int32)
    ty = None if labels is None else torch.tensor(labels)
    want = jax.jit(lambda p, a, b: jax_unet.apply(p, jcfg, a, b, jy))(
        params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = port_unet.apply(model, torch.from_numpy(x),
                              torch.from_numpy(t), ty)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(t2n(got), j2n(want), atol=2e-3)


def test_unet_null_label_equals_unconditional(rng):
    """y = -1 adds no class embedding: the call equals the one without y."""
    _, cfg = configs()
    _, model, _ = both_models(*configs(), 5)
    x, t = _inputs(rng, cfg)
    with torch.no_grad():
        a = model(torch.from_numpy(x), torch.from_numpy(t),
                  torch.tensor([-1, -1]))
        b = model(torch.from_numpy(x), torch.from_numpy(t))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        uncond = both_models(*configs())[1]
        with torch.no_grad():
            uncond(torch.from_numpy(x), torch.from_numpy(t),
                   torch.tensor([1, 1]))


def test_unet_forward_f64(rng):
    jcfg, cfg = configs(attention_ds=(1, 2), use_scale_shift_norm=True)
    params, model, _ = both_models(jcfg, cfg, 5)
    x, t = _inputs(rng, cfg)
    x, t = x.astype(np.float64), t.astype(np.float64)
    with jax.enable_x64():
        p64 = jax.tree.map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        want = np.asarray(jax_unet.apply(
            p64, jcfg, jnp.asarray(x), jnp.asarray(t),
            jnp.asarray([4, -1], jnp.int32), compute_dtype=jnp.float64))
    with torch.no_grad():
        got = port_unet.apply(model, torch.from_numpy(x), torch.from_numpy(t),
                              torch.tensor([4, -1]),
                              compute_dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-9)


def test_unet_bf16_runs_and_stays_close_to_f32(rng):
    """compute_dtype casts the parameters for the call and leaves the
    module's own float32 parameters alone."""
    _, cfg = configs()
    _, model, _ = both_models(*configs())
    x, t = _inputs(rng, cfg)
    with torch.no_grad():
        ref = model(torch.from_numpy(x), torch.from_numpy(t))
        got = port_unet.apply(model, torch.from_numpy(x), torch.from_numpy(t),
                              compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and model.dtype == torch.float32
    # bfloat16 keeps 8 bits: a few percent of the output's O(1) range
    assert (got.float() - ref).abs().max() < 0.15


CONFIGS = [dict(), dict(model_channels=64, image_size=64,
                        channel_mult=(1, 2, 3, 4), num_res_blocks=2,
                        attention_ds=(4, 8)),
           dict(use_scale_shift_norm=True, attention_ds=(1, 2),
                channel_mult=(1, 2, 2), num_res_blocks=2)]


@pytest.mark.parametrize("fields", CONFIGS)
@pytest.mark.parametrize("num_classes", [None, 10])
def test_plan_order_flops_and_count_equal_the_jax_ones(fields, num_classes):
    jcfg, cfg = configs(**fields)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    for prop in ("time_embed_dim", "num_levels", "num_skips"):
        assert getattr(jcfg, prop) == getattr(cfg, prop)
    assert list(jcfg.level_channels()) == list(cfg.level_channels())
    assert (dataclasses.astuple(jax_unet.build_plan(jcfg))
            == dataclasses.astuple(port_unet.build_plan(cfg)))
    assert (jax_unet.param_order(jcfg, num_classes)
            == port_unet.param_order(cfg, num_classes))
    for batch in (1, 8):
        assert (jax_unet.fwd_flops(jcfg, batch)
                == port_unet.fwd_flops(cfg, batch))
    assert (jax_ckpt.num_params(jcfg, num_classes)
            == port_ckpt.num_params(cfg, num_classes))


def test_default_config_is_the_imagenet64_model():
    jcfg, cfg = configs(**CONFIGS[1])
    from unet_tpu.config import UnetConfig as J
    from unet_tpu_torch.config import DIFFUSION_T, UnetConfig as P
    from unet_tpu.config import DIFFUSION_T as JT
    assert dataclasses.asdict(P()) == dataclasses.asdict(J())
    assert dataclasses.asdict(P()) == dataclasses.asdict(cfg)
    assert DIFFUSION_T == JT == 1000
    plan = port_unet.build_plan(P())
    layers = [layer for g in plan.input_blocks + (plan.middle,)
              + plan.output_blocks for layer in g]
    n_res = sum(layer[0] == "res" for layer in layers)
    n_attn = sum(layer[0] == "attn" for layer in layers)
    # GroupNorm and attention kernel launches of one forward
    assert (2 * n_res + n_attn + 1, n_attn) == (56, 11)


def test_param_order_addresses_every_parameter_once():
    _, cfg = configs()
    model = port_unet.init(cfg, 3, device="cpu")
    seen = [id(port_unet.get_param(model, path))
            for path, _ in port_unet.param_order(cfg, 3)]
    assert len(set(seen)) == len(seen) == len(list(model.parameters()))
    uncond = port_unet.init(cfg, device="cpu")
    names = [n for n, _ in uncond.named_parameters()]
    assert names == [".".join(map(str, path))
                     for path, _ in port_unet.param_order(cfg)]


def test_params_from_jax_equals_params_from_flat():
    jcfg, cfg = configs()
    params, model, flat = both_models(jcfg, cfg, 5)
    tree = jax.tree.map(np.asarray, params)
    other = convert.params_from_jax(tree, cfg, 5, device="cpu")
    np.testing.assert_array_equal(port_ckpt.flatten_params(other), flat)
    np.testing.assert_array_equal(port_ckpt.flatten_params(model), flat)
    np.testing.assert_array_equal(
        jax_ckpt.flatten_params(params, jcfg, 5), flat)
    third = convert.params_from_flat(torch.from_numpy(flat), cfg, 5,
                                     device="cpu")
    np.testing.assert_array_equal(port_ckpt.flatten_params(third), flat)
    with pytest.raises(ValueError):
        convert.params_from_flat(flat[:-1], cfg, 5, device="cpu")
