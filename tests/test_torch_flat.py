"""The port's flat master parameters (`FlatState`, `flatten_state`,
`Unravel`, `make_flat_multi_step`) and its AdamW with scalars on the device,
against the JAX package and against the port's own tree path, on the CPU.

The flat vectors of the two packages lay their parameters out in different
orders (JAX: tree leaves; the port: `param_order`, convolution kernels in
their channels_last memory order), so parameters are compared one by one,
by name, through `io/convert`.  Tolerances: AdamW and the JAX trajectory as
tests/test_torch_train.py holds them (1e-5 relative and 1e-6 absolute; 2e-3
relative losses and 5e-3 parameters), flat against tree as the JAX package's
tests/test_train.py holds its own (1e-5 relative losses, 2e-6 parameters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.config import TrainConfig as JaxTrainConfig
from unet_tpu.diffusion import gaussian as jax_gaussian
from unet_tpu.training import optim as jax_optim
from unet_tpu.training import trainer as jax_trainer
from unet_tpu_torch.config import TrainConfig
from unet_tpu_torch.diffusion.gaussian import (GaussianDiffusion,
                                               named_beta_schedule)
from unet_tpu_torch.io import convert
from unet_tpu_torch.models import unet
from unet_tpu_torch.training import optim, trainer

from tests.torch_port_util import both_models, configs

T_STEPS = 1000


def _draws(cfg, seed, n, batch=2):
    rng = np.random.default_rng(seed)
    shape = (n, batch, cfg.image_size, cfg.image_size, cfg.in_channels)
    return (rng.standard_normal(shape, dtype=np.float32) * 0.5,
            rng.integers(0, T_STEPS, size=(n, batch)),
            rng.standard_normal(shape, dtype=np.float32))


def _diffusion():
    return GaussianDiffusion.create(named_beta_schedule("linear", T_STEPS),
                                    device="cpu")


def test_unravel_views_are_the_parameters_in_param_order():
    _, cfg = configs()
    _, model, _ = both_models(*configs(), num_classes=10, seed=1)
    state, unravel = trainer.flatten_state(model, seed=3, step=4)
    assert (state.step, state.seed) == (4, 3)
    assert state.flat.dtype == torch.float32 and state.flat.requires_grad
    assert not state.m.any() and not state.v.any()
    assert state.flat.numel() == sum(p.numel() for p in model.parameters())
    views = unravel(state.flat.detach())
    params = dict(model.named_parameters())
    assert list(views) == [".".join(str(k) for k in path)
                           for path, _ in unet.param_order(cfg, 10)]
    for name, view in views.items():
        assert torch.equal(view, params[name])
        assert view.stride() == params[name].stride(), name
    # the vector is a copy: the model keeps its own parameters
    state.flat.data.zero_()
    assert all(p.abs().sum() > 0 for p in model.parameters())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unravel_apply_equals_apply_and_its_gradient(dtype):
    """One cast of the whole vector gives the values of one cast per
    parameter: the same forward, bit for bit, and the same gradients,
    which come back as one float32 vector."""
    _, model, _ = both_models(*configs(), seed=2)
    state, unravel = trainer.flatten_state(model)
    x, t, _ = (torch.from_numpy(a[0]) for a in _draws(model.cfg, 3, 1))
    want = unet.apply(model, x.to(dtype), t, compute_dtype=dtype)
    got = unravel.apply(state.flat, x.to(dtype), t, compute_dtype=dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    (g_flat,) = torch.autograd.grad(got.float().square().mean(),
                                    [state.flat])
    grads = torch.autograd.grad(want.float().square().mean(),
                                list(model.parameters()))
    assert g_flat.dtype == torch.float32
    by_name = dict(zip([n for n, _ in model.named_parameters()], grads))
    for name, g in unravel(g_flat).items():
        assert torch.equal(g, by_name[name]), name


@pytest.mark.parametrize("flat", [False, True])
def test_adamw_with_a_device_step_equals_jax_over_three_steps(flat):
    """The step count as a 0-dim float32 tensor that is advanced in place,
    as a captured step advances it; weight decay and the lr anneal on."""
    rng = np.random.default_rng(6)
    p0 = [rng.standard_normal(s, dtype=np.float32) for s in ((3, 4), (5,))]
    if flat:
        p0 = [np.concatenate([a.ravel() for a in p0])]
    grads = [[rng.standard_normal(a.shape, dtype=np.float32) for a in p0]
             for _ in range(3)]
    hp = dict(lr=1e-2, weight_decay=0.1, anneal_steps=2)
    jhp, thp = jax_optim.AdamWParams(**hp), optim.AdamWParams(**hp)
    jp = [jnp.asarray(a) for a in p0]
    jm, jv = jax_optim.init_moments(jp)
    tp = [torch.from_numpy(a.copy()) for a in p0]
    tm, tv = optim.init_moments(tp)
    counter = torch.zeros((), dtype=torch.float32)
    for step, g in enumerate(grads, start=1):
        counter.add_(1.0)
        if flat:
            jp0, jm0, jv0 = jax_optim.adamw_update_flat(
                jp[0], jnp.asarray(g[0]), jm[0], jv[0], jnp.int32(step), jhp)
            jp, jm, jv = [jp0], [jm0], [jv0]
            optim.adamw_update_flat(tp[0], torch.from_numpy(g[0]), tm[0],
                                    tv[0], counter, thp)
        else:
            jp, jm, jv = jax_optim.adamw_update(
                jp, [jnp.asarray(a) for a in g], jm, jv, jnp.int32(step),
                jhp)
            optim.adamw_update(tp, [torch.from_numpy(a) for a in g], tm, tv,
                               counter, thp)
        for pair in ((tp, jp), (tm, jm), (tv, jv)):
            for a, b in zip(*pair):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-5, atol=1e-6)
    # step 3 is past the anneal: lr 0, the parameters stayed
    assert float(optim._lr_at(counter, thp)) == 0.0


def test_adamw_int_and_device_step_are_one_path():
    rng = np.random.default_rng(7)
    p = rng.standard_normal(9, dtype=np.float32)
    g = rng.standard_normal(9, dtype=np.float32)
    hp = optim.AdamWParams(lr=1e-2, weight_decay=0.1, anneal_steps=5)
    out = []
    for step in (3, torch.tensor(3.0)):
        tp, gm, gv = (torch.from_numpy(p.copy()), torch.ones(9),
                      torch.ones(9))
        optim.adamw_update_flat(tp, torch.from_numpy(g), gm, gv, step, hp)
        out.append((tp, gm, gv))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_flat_step_tracks_the_jax_step_with():
    """Three steps of the flat step hook against the JAX package's
    `step_with` on the same batches, t and noise."""
    jcfg, cfg = configs()
    params, model, _ = both_models(jcfg, cfg, seed=7)
    batches, ts, noises = _draws(cfg, 8, 3)
    jd = jax_gaussian.GaussianDiffusion.create(
        jax_gaussian.named_beta_schedule("linear", T_STEPS))
    fields = dict(batch_size=2, lr=1e-3, weight_decay=0.01)
    _, jstep = jax_trainer.make_train_step(jcfg, JaxTrainConfig(**fields),
                                           jd, donate=False)
    state, unravel = trainer.flatten_state(model)
    multi = trainer.make_flat_multi_step(cfg, TrainConfig(**fields), unravel,
                                         _diffusion(), device="cpu")
    jstate = jax_trainer.init_state(params)
    jl, tl = [], []
    for i in range(3):
        jstate, loss = jstep(jstate, jnp.asarray(batches[i]),
                             jnp.asarray(ts[i]), jnp.asarray(noises[i]))
        jl.append(float(loss))
        state, loss = multi.step_with(state, batches[i], ts[i], noises[i])
        tl.append(loss.item())
    assert state.step == 3
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jstate.params),
                                   cfg, device="cpu")
    want = dict(want.named_parameters())
    for name, view in unravel(state.flat.detach()).items():
        np.testing.assert_allclose(view.numpy(), want[name].detach().numpy(),
                                   atol=5e-3, err_msg=name)


@pytest.mark.parametrize("microbatch", [0, 1])
def test_flat_multi_step_equals_the_tree_multi_step(microbatch):
    _, cfg = configs()
    tc = TrainConfig(batch_size=2, lr=1e-3, eps=1e-3, microbatch=microbatch)
    batches = torch.from_numpy(_draws(cfg, 9, 2)[0])
    _, model, _ = both_models(*configs(), seed=9)
    fstate, unravel = trainer.flatten_state(model, seed=5)
    tstate = trainer.init_state(model, seed=5)
    fmulti = trainer.make_flat_multi_step(cfg, tc, unravel, _diffusion(),
                                          device="cpu")
    tmulti = trainer.make_multi_step(cfg, tc, _diffusion(), device="cpu")
    fstate, flosses = fmulti(fstate, batches)
    tstate, tlosses = tmulti(tstate, batches)
    assert flosses.shape == (2,) and fstate.step == tstate.step == 2
    np.testing.assert_allclose(flosses.numpy(), tlosses.numpy(), rtol=1e-5)
    params = dict(tstate.params.named_parameters())
    for name, view in unravel(fstate.flat.detach()).items():
        np.testing.assert_allclose(view.numpy(),
                                   params[name].detach().numpy(), atol=2e-6,
                                   err_msg=name)
