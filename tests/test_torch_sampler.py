"""The port's diffusion tables and samplers against the JAX package's, on
the CPU: one set of numpy weights, one start image and one noise sequence on
both sides (the two frameworks' generators draw different numbers, so the
chains are compared through the `x_init` / `noise` hooks).

Tolerance of the chains: float32 1e-3 absolute.  One model call agrees to
about 1e-5 at this size; a chain feeds each difference back through the
next call, and 1e-3 is the bar tests/test_sampling_parity.py sets for a
few-step chain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.diffusion import gaussian as jax_gaussian
from unet_tpu.diffusion import sampler as jax_sampler
from unet_tpu_torch.diffusion import GaussianDiffusion, named_beta_schedule
from unet_tpu_torch.diffusion import sampler as port_sampler

from tests.torch_port_util import both_models, configs, j2n, t2n

CHAIN_ATOL = 1e-3


def _diffusions(name="linear", T=1000):
    jd = jax_gaussian.GaussianDiffusion.create(
        jax_gaussian.named_beta_schedule(name, T))
    pd = GaussianDiffusion.create(named_beta_schedule(name, T), device="cpu")
    return jd, pd


@pytest.mark.parametrize("name,T", [("linear", 1000), ("cosine", 1000),
                                    ("linear", 100)])
def test_tables_are_bit_equal(name, T):
    jd, pd = _diffusions(name, T)
    assert pd.num_timesteps == jd.num_timesteps == T
    assert pd.betas.dtype == pd.alphas_cumprod.dtype == np.float32
    np.testing.assert_array_equal(pd.betas, np.asarray(jd.betas))
    np.testing.assert_array_equal(pd.alphas_cumprod,
                                  np.asarray(jd.alphas_cumprod))
    np.testing.assert_array_equal(pd.sqrt_alphas_cumprod.numpy(),
                                  np.asarray(jd.sqrt_alphas_cumprod))
    np.testing.assert_array_equal(
        pd.sqrt_one_minus_alphas_cumprod.numpy(),
        np.asarray(jd.sqrt_one_minus_alphas_cumprod))


def test_schedule_guard():
    """The scaled linear schedule leaves (0, 1) for T <= 20."""
    with pytest.raises(ValueError, match="strictly in"):
        GaussianDiffusion.create(named_beta_schedule("linear", 20),
                                 device="cpu")
    with pytest.raises(ValueError, match="strictly in"):
        GaussianDiffusion.create(np.array([]), device="cpu")
    with pytest.raises(ValueError, match="unknown beta schedule"):
        named_beta_schedule("sigmoid", 100)
    GaussianDiffusion.create(named_beta_schedule("linear", 21), device="cpu")


def test_q_sample(rng):
    jd, pd = _diffusions()
    x0 = rng.standard_normal((3, 4, 4, 3), dtype=np.float32)
    eps = rng.standard_normal((3, 4, 4, 3), dtype=np.float32)
    for t in (np.array([0, 500, 999]), np.array([1.0, 17.9, 998.2],
                                                np.float32)):
        want = jd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps))
        got = pd.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                          torch.from_numpy(eps))
        np.testing.assert_allclose(t2n(got), j2n(want), atol=1e-6)


def _start(rng, cfg, B, steps):
    shape = (B, cfg.image_size, cfg.image_size, cfg.in_channels)
    return (rng.standard_normal(shape, dtype=np.float32),
            rng.standard_normal((steps,) + shape, dtype=np.float32))


def test_ddpm_chain(rng):
    """Three steps of the ancestral chain, t = 999, 998, 997."""
    jcfg, cfg = configs()
    params, model, _ = both_models(jcfg, cfg)
    jd, pd = _diffusions()
    x0, noise = _start(rng, cfg, 2, 3)
    want = jax_sampler.ddpm_sample(
        params, jcfg, jd, jax.random.PRNGKey(0), batch_size=2,
        x_init=jnp.asarray(x0), noise=jnp.asarray(noise), num_steps=3)
    got = port_sampler.ddpm_sample(
        model, cfg, pd, batch_size=2, x_init=torch.from_numpy(x0),
        noise=torch.from_numpy(noise), num_steps=3)
    assert got.shape == x0.shape and got.dtype == torch.float32
    assert not got.requires_grad
    np.testing.assert_allclose(t2n(got), j2n(want), atol=CHAIN_ATOL)
    # the chain moved: three steps of noise are far from the start
    assert np.abs(t2n(got) - x0).max() > 0.01
    with pytest.raises(ValueError, match="noise has"):
        port_sampler.ddpm_sample(model, cfg, pd, batch_size=2,
                                 x_init=torch.from_numpy(x0),
                                 noise=torch.from_numpy(noise), num_steps=4)


def _jax_ddim_noise(key, steps, shape):
    """The noise `unet_tpu`'s ddim_sample draws from `key`, step by step."""
    key, _ = jax.random.split(key)
    out = []
    for _ in range(steps):
        key, nkey = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(nkey, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_chain(rng, eta):
    """Four DDIM steps.  The JAX sampler has no noise hook, so for eta = 1
    the port is fed the numbers the JAX sampler draws from its key."""
    jcfg, cfg = configs()
    params, model, _ = both_models(jcfg, cfg)
    jd, pd = _diffusions()
    x0, _ = _start(rng, cfg, 2, 0)
    key = jax.random.PRNGKey(5)
    want = jax_sampler.ddim_sample(
        params, jcfg, jd, key, num_steps=4, eta=eta, batch_size=2,
        x_init=jnp.asarray(x0))
    noise = torch.from_numpy(_jax_ddim_noise(key, 4, x0.shape))
    got = port_sampler.ddim_sample(
        model, cfg, pd, num_steps=4, eta=eta, batch_size=2,
        x_init=torch.from_numpy(x0), noise=noise)
    np.testing.assert_allclose(t2n(got), j2n(want), atol=CHAIN_ATOL)
    if eta:
        other = port_sampler.ddim_sample(
            model, cfg, pd, num_steps=4, eta=eta, batch_size=2,
            x_init=torch.from_numpy(x0), noise=torch.zeros_like(noise))
        assert (other - got).abs().max() > 0.01   # the noise was used


def test_ddim_step_rules():
    _, cfg = configs()
    _, model, _ = both_models(*configs())
    _, pd = _diffusions()
    for bad in (0, 1000):
        with pytest.raises(ValueError, match="num_steps"):
            port_sampler.ddim_sample(model, cfg, pd, num_steps=bad)
    # the rounded linspace may repeat a step; the chain then runs the
    # unique ones, as the JAX sampler does
    calls = []
    fn = lambda m, x, t: (calls.append(float(t[0])), torch.zeros_like(x))[1]
    _, small = _diffusions("linear", 100)
    port_sampler.ddim_sample(model, cfg, small, num_steps=99, model_fn=fn,
                             generator=torch.Generator().manual_seed(0))
    assert calls == sorted(set(calls), reverse=True)
    assert calls[0] == 99.0 and calls[-1] == 1.0


def test_cfg_chain(rng):
    """Classifier-free guidance, w = 3, through two steps of the ancestral
    chain (whose steps, unlike the first DDIM steps from pure noise, keep
    the values O(1), so the absolute tolerance means what it says)."""
    jcfg, cfg = configs()
    params, model, _ = both_models(jcfg, cfg, 5)
    jd, pd = _diffusions()
    x0, noise = _start(rng, cfg, 2, 2)
    want = jax_sampler.ddpm_sample(
        params, jcfg, jd, jax.random.PRNGKey(0), num_steps=2, batch_size=2,
        x_init=jnp.asarray(x0), noise=jnp.asarray(noise), y=3,
        guidance_scale=3.0)
    got = port_sampler.ddpm_sample(
        model, cfg, pd, num_steps=2, batch_size=2,
        x_init=torch.from_numpy(x0), noise=torch.from_numpy(noise), y=3,
        guidance_scale=3.0)
    np.testing.assert_allclose(t2n(got), j2n(want), atol=CHAIN_ATOL)
    plain = port_sampler.ddpm_sample(
        model, cfg, pd, num_steps=2, batch_size=2,
        x_init=torch.from_numpy(x0), noise=torch.from_numpy(noise), y=3)
    assert (plain - got).abs().max() > 1e-3   # the guidance did something


@pytest.mark.parametrize("w,batch_seen", [(3.0, 4), (1.0, 2), (0.0, 2)])
def test_cfg_is_one_model_call(rng, w, batch_seen):
    """w not in {0, 1}: ONE call on the doubled batch [y | null]; w = 1 the
    plain conditional call; w = 0 one null-label call, equal to the
    unconditional model."""
    jcfg, cfg = configs()
    params, model, _ = both_models(jcfg, cfg, 5)
    x = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    t = np.array([400.0, 400.0], np.float32)
    seen = []
    hook = model.register_forward_hook(
        lambda mod, args, out: seen.append((args[0].shape[0], args[2])))
    fn = port_sampler.make_model_fn(cfg, y=torch.tensor([3, 1]),
                                    guidance_scale=w)
    with torch.no_grad():
        got = fn(model, torch.from_numpy(x), torch.from_numpy(t))
    hook.remove()
    assert len(seen) == 1 and seen[0][0] == batch_seen
    assert seen[0][1].tolist() == {3.0: [3, 1, -1, -1], 1.0: [3, 1],
                                   0.0: [-1, -1]}[w]
    jfn = jax_sampler.make_model_fn(jcfg, y=jnp.asarray([3, 1]),
                                    guidance_scale=w)
    want = jfn(params, jnp.asarray(x), jnp.asarray(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(t2n(got), j2n(want), atol=1e-4)
    if w == 0.0:
        with torch.no_grad():
            assert torch.equal(got, model(torch.from_numpy(x),
                                          torch.from_numpy(t)))


def test_sampler_closures_and_generator():
    """make_sampler / make_ddim_sampler: same seed, same images; the
    generator is the only source of randomness."""
    _, cfg = configs()
    _, model, _ = both_models(*configs())
    _, pd = _diffusions()
    ddpm = port_sampler.make_sampler(cfg, pd, batch_size=2, num_steps=2)
    ddim = port_sampler.make_ddim_sampler(cfg, pd, batch_size=2, num_steps=2,
                                          eta=0.5)
    for sample in (ddpm, ddim):
        a = sample(model, torch.Generator().manual_seed(1))
        b = sample(model, torch.Generator().manual_seed(1))
        c = sample(model, torch.Generator().manual_seed(2))
        assert a.shape == (2, 16, 16, 3) and torch.isfinite(a).all()
        assert torch.equal(a, b) and not torch.equal(a, c)


def test_sampler_compute_dtype_carries_x_in_f32():
    _, cfg = configs()
    _, model, _ = both_models(*configs())
    _, pd = _diffusions()
    out = port_sampler.ddim_sample(
        model, cfg, pd, torch.Generator().manual_seed(0), num_steps=2,
        batch_size=1, compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert model.dtype == torch.float32


def test_to_uint8(rng):
    x = rng.standard_normal((2, 4, 4, 3), dtype=np.float32) * 1.5
    x[0, 0, 0] = [-1.0, 1.0, 0.0]
    got = port_sampler.to_uint8(torch.from_numpy(x))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jax_sampler.to_uint8(jnp.asarray(x)))
    assert got[0, 0, 0].tolist() == [0, 255, 127]
