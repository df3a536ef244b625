"""Per-op parity of the port's ops/functional.py against the JAX package's,
float32 on the CPU, same numpy inputs on both sides.

Tolerance 1e-5 absolute: both sides compute in float32 and differ only in
the order of sums (a 3x3 conv over 32 channels adds 288 products of O(1)
values); `timestep_embedding` is held to 1e-6 because both sides reduce the
argument of sin/cos properly and then differ by an ulp or two.  The JAX
side of that test is jitted, as tests/test_ops.py and the model run it: XLA
then folds the frequency table with a correctly rounded exp, while its
op-by-op exp is an ulp off in two entries, which at 800 rad is 8e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.ops import functional as JF
from unet_tpu_torch.ops import functional as PF

from tests.torch_port_util import j2n, t2n

ATOL = 1e-5


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def test_silu(rng):
    jx, tx = _pair(rng.standard_normal((4, 37), dtype=np.float32) * 4)
    np.testing.assert_allclose(t2n(PF.silu(tx)), j2n(JF.silu(jx)), atol=ATOL)


def test_linear(rng):
    x = rng.standard_normal((3, 5, 48), dtype=np.float32)
    w = rng.standard_normal((24, 48), dtype=np.float32) / 7   # torch (O, I)
    b = rng.standard_normal(24, dtype=np.float32)
    want = JF.linear(jnp.asarray(x), jnp.asarray(w.T), jnp.asarray(b))
    got = PF.linear(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(t2n(got), j2n(want), atol=ATOL)


@pytest.mark.parametrize("ksize,cin,cout", [(3, 32, 48), (1, 48, 32),
                                            (3, 3, 32)])
def test_conv2d(rng, ksize, cin, cout):
    x = rng.standard_normal((2, 8, 6, cin), dtype=np.float32)
    w = (rng.standard_normal((cout, cin, ksize, ksize), dtype=np.float32)
         / np.float32(np.sqrt(cin * ksize * ksize)))            # OIHW
    b = rng.standard_normal(cout, dtype=np.float32)
    want = JF.conv2d(jnp.asarray(x), jnp.asarray(w.transpose(2, 3, 1, 0)),
                     jnp.asarray(b))
    got = PF.conv2d(*(torch.from_numpy(a) for a in (x, w, b)))
    assert got.shape == (2, 8, 6, cout) and got.is_contiguous()
    np.testing.assert_allclose(t2n(got), j2n(want), atol=ATOL)


@pytest.mark.parametrize("act", ["silu", "none"])
def test_group_norm_silu(rng, act):
    x = rng.standard_normal((2, 4, 6, 96), dtype=np.float32) * 2 + 0.5
    g = rng.standard_normal(96, dtype=np.float32) * 0.3 + 1
    b = rng.standard_normal(96, dtype=np.float32) * 0.2
    want = JF.group_norm_silu(*map(jnp.asarray, (x, g, b)), act=act)
    got = PF.group_norm_silu(*map(torch.from_numpy, (x, g, b)), act=act)
    np.testing.assert_allclose(t2n(got), j2n(want), atol=ATOL)
    if act == "none":
        plain = PF.group_norm(*map(torch.from_numpy, (x, g, b)))
        assert torch.equal(plain, got)


def test_group_norm_other_group_count(rng):
    x = rng.standard_normal((1, 3, 5, 24), dtype=np.float32)
    g = np.ones(24, np.float32)
    b = np.zeros(24, np.float32)
    want = JF.group_norm(*map(jnp.asarray, (x, g, b)), num_groups=4,
                         eps=1e-3)
    got = PF.group_norm(*map(torch.from_numpy, (x, g, b)), num_groups=4,
                        eps=1e-3)
    np.testing.assert_allclose(t2n(got), j2n(want), atol=ATOL)


def test_resampling(rng):
    x = rng.standard_normal((2, 4, 6, 5), dtype=np.float32)
    jx, tx = _pair(x)
    up = PF.upsample_nearest_2x(tx)
    assert up.shape == (2, 8, 12, 5)
    np.testing.assert_array_equal(t2n(up), j2n(JF.upsample_nearest_2x(jx)))
    np.testing.assert_allclose(t2n(PF.avg_pool_2x(tx)),
                               j2n(JF.avg_pool_2x(jx)), atol=ATOL)


def _jax_embedding(dim, max_period=1000):
    return jax.jit(lambda t: JF.timestep_embedding(t, dim,
                                                   max_period=max_period))


@pytest.mark.parametrize("dim", [64, 33])
def test_timestep_embedding(dim):
    """Arguments reach t * f_0 = 999 rad: [cos | sin] order, a zero column
    for an odd dim, float and integer t."""
    t = np.array([0.0, 1.0, 2.5, 250.0, 777.0, 998.0, 999.0], np.float32)
    want = j2n(_jax_embedding(dim)(jnp.asarray(t)))
    got = PF.timestep_embedding(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and got.shape == (7, dim)
    np.testing.assert_allclose(t2n(got), want, atol=1e-6)
    if dim % 2:
        assert not got[:, -1].any()
    ti = np.array([0, 3, 999], np.int64)
    np.testing.assert_allclose(
        t2n(PF.timestep_embedding(torch.from_numpy(ti), dim)),
        j2n(_jax_embedding(dim)(jnp.asarray(ti))), atol=1e-6)


def test_timestep_embedding_other_period():
    t = np.array([5.0, 99.0], np.float32)
    want = j2n(_jax_embedding(16, 100)(jnp.asarray(t)))
    got = PF.timestep_embedding(torch.from_numpy(t), 16, max_period=100)
    np.testing.assert_allclose(t2n(got), want, atol=1e-6)


@pytest.mark.parametrize("B,T,C,NH", [(2, 16, 64, 2), (1, 50, 96, 3)])
def test_qkv_attention(rng, B, T, C, NH):
    qkv = rng.standard_normal((B, T, 3 * C), dtype=np.float32)
    want = JF.qkv_attention(jnp.asarray(qkv), NH)
    got = PF.qkv_attention(torch.from_numpy(qkv), NH)
    assert got.shape == (B, T, C)
    np.testing.assert_allclose(t2n(got), j2n(want), atol=ATOL)


def test_set_f32_precision_sets_both_flags():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        PF.set_f32_precision("high")
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        PF.set_f32_precision("highest")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        with pytest.raises(ValueError):
            PF.set_f32_precision("default")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
