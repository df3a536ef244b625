"""The two modules of the port that hold a CUDA kernel, held against the
Pallas kernels they replace.

The Pallas kernels run in interpret mode (automatic off a TPU), as
tests/test_pallas.py runs them; the port's wrappers get CPU tensors and so
take their plain PyTorch versions, which repeat the CUDA kernels'
arithmetic.  The CUDA kernels themselves are compared with those plain
versions on the GPU by chip_smoke.py.

Tolerances: float32 2e-5 absolute (the bar of tests/test_pallas.py: same
arithmetic, another order of sums); bfloat16 GroupNorm 3e-2 absolute
(outputs of size up to ~4 where one bfloat16 step is 2^-6 = 1.6e-2, and the
two sides may round a float32 value on either side of a rounding point);
bfloat16 attention 1e-3 absolute plus one bfloat16 step (2^-7) relative
against the Pallas kernel: its outputs are averages of about sqrt(e/T), so a
bar of 3e-2 would be a third of a typical value.  Against the XLA path,
which rounds at other points (differences up to 1.2e-2 seen), 1.5e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.ops import functional as JF
from unet_tpu.ops.pallas import groupnorm as jax_gn
from unet_tpu.ops.pallas.attention import qkv_attention_fused
from unet_tpu_torch.ops.kernels import attention as port_attn
from unet_tpu_torch.ops.kernels import groupnorm as port_gn

from tests.torch_port_util import j2n, t2n

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
ATTN_TOL = {"float32": dict(atol=2e-5),
            "bfloat16": dict(atol=1e-3, rtol=2.0 ** -7)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 4, 4, 192),
                                   (1, 4, 8, 448)])
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_act_fwd_vs_pallas(rng, shape, act, dtype):
    C = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32) * 2 + 0.5
    gamma = rng.standard_normal(C, dtype=np.float32) * 0.3 + 1
    beta = rng.standard_normal(C, dtype=np.float32) * 0.2
    jargs = [jnp.asarray(a).astype(JDT[dtype]) for a in (x, gamma, beta)]
    targs = [torch.from_numpy(a).to(TDT[dtype]) for a in (x, gamma, beta)]

    want, want_mean, want_rstd = jax_gn._fwd_call(
        *jargs, num_groups=32, eps=1e-5, act=act)
    got, mean, rstd = port_gn.gn_act_fwd(*targs, 32, 1e-5, act)

    assert got.dtype == TDT[dtype] and got.shape == shape
    assert mean.dtype == rstd.dtype == torch.float32
    assert mean.shape == rstd.shape == (shape[0], 32)
    np.testing.assert_allclose(t2n(got), j2n(want), atol=ATOL[dtype])
    # statistics are float32 on both sides whatever x's type
    np.testing.assert_allclose(t2n(mean), j2n(want_mean)[:, 0], atol=1e-5)
    np.testing.assert_allclose(t2n(rstd), j2n(want_rstd)[:, 0], atol=1e-5,
                               rtol=1e-5)
    # the public entry of the JAX kernel gives the same y
    pub = jax_gn.group_norm_act(*jargs, 32, 1e-5, act)
    np.testing.assert_allclose(t2n(got), j2n(pub), atol=ATOL[dtype])


def test_gn_plain_is_two_pass(rng):
    """A large common offset must not cost the variance its digits: the
    one-pass E[x^2] - E[x]^2 form loses them all at this offset."""
    x = (rng.standard_normal((1, 8, 8, 64), dtype=np.float32) * 0.01
         + np.float32(300.0))
    tx = torch.from_numpy(x)
    ones, zeros = torch.ones(64), torch.zeros(64)
    _, _, rstd = port_gn.gn_act_fwd_plain(tx, ones, zeros, 32, 1e-5, "none")
    var = x.astype(np.float64).reshape(1, 64, 32, 2).var(axis=(1, 3))
    np.testing.assert_allclose(t2n(rstd), 1 / np.sqrt(var + 1e-5), rtol=1e-3)


@pytest.mark.parametrize("B,T,C,NH", [(2, 64, 64, 2), (2, 256, 192, 6),
                                      (1, 576, 64, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_attention_fwd_vs_pallas(rng, B, T, C, NH, dtype):
    qkv = rng.standard_normal((B, T, 3 * C), dtype=np.float32)
    jq = jnp.asarray(qkv).astype(JDT[dtype])
    tq = torch.from_numpy(qkv).to(TDT[dtype])
    got = port_attn.qkv_attention_fwd(tq, NH)
    assert got.dtype == TDT[dtype] and got.shape == (B, T, C)
    tol = ATTN_TOL[dtype]
    np.testing.assert_allclose(t2n(got), j2n(qkv_attention_fused(jq, NH)),
                               **tol)
    # the XLA path rounds at other points than the kernel in bfloat16
    np.testing.assert_allclose(t2n(got), j2n(JF.qkv_attention(jq, NH)),
                               **(tol if dtype == "float32"
                                  else dict(atol=1.5e-2)))


@pytest.mark.parametrize("B,T,C,NH", [(1, 8, 64, 2), (1, 72, 64, 2),
                                      (1, 136, 64, 2), (2, 64, 256, 8),
                                      (1, 72, 256, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_attention_fwd_vs_pallas_at_ragged_tiles(B, T, C, NH, dtype):
    """T = 8, 72 and 136 leave the CUDA kernels' 64-row tiles short or
    ragged (the Pallas kernel takes any multiple of 8); C = 256 in 8 heads
    is the ds-8 level's head layout.  Inputs from a seed of their own."""
    qkv = np.random.default_rng(T + C).standard_normal((B, T, 3 * C),
                                                       dtype=np.float32)
    got = port_attn.qkv_attention_fwd(torch.from_numpy(qkv).to(TDT[dtype]),
                                      NH)
    want = qkv_attention_fused(jnp.asarray(qkv).astype(JDT[dtype]), NH)
    assert got.dtype == TDT[dtype] and got.shape == (B, T, C)
    np.testing.assert_allclose(t2n(got), j2n(want), **ATTN_TOL[dtype])


def test_attention_plain_rounding_points():
    """bfloat16: q * scale is rounded before the score product and the
    softmax weights before the value product, as the TPU kernel does."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((1, 8, 96), generator=g).to(torch.bfloat16)
    q, k, v = (a.reshape(1, 8, 1, 32) for a in qkv.split(32, dim=-1))
    qs = (q.float() * (32 ** -0.5)).to(torch.bfloat16)
    s = torch.einsum("bthd,bshd->bhts", qs.float(), k.float())
    p = torch.softmax(s, dim=-1).to(torch.bfloat16)
    want = torch.einsum("bhts,bshd->bthd", p.float(), v.float()
                        ).to(torch.bfloat16).reshape(1, 8, 32)
    assert torch.equal(port_attn.qkv_attention_plain(qkv, 1), want)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch(rng):
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 64),
                                             dtype=np.float32))
    g, b = torch.ones(64), torch.zeros(64)
    qkv = torch.from_numpy(rng.standard_normal((1, 16, 192),
                                               dtype=np.float32))
    before = (port_gn.gn_act_fwd.launches,
              port_attn.qkv_attention_fwd.launches)
    y, mean, rstd = port_gn.gn_act_fwd(x, g, b, 32, 1e-5, "silu")
    yp, meanp, rstdp = port_gn.gn_act_fwd_plain(x, g, b, 32, 1e-5, "silu")
    assert torch.equal(y, yp) and torch.equal(mean, meanp)
    assert torch.equal(rstd, rstdp)
    assert torch.equal(port_attn.qkv_attention_fwd(qkv, 2),
                       port_attn.qkv_attention_plain(qkv, 2))
    assert (port_gn.gn_act_fwd.launches,
            port_attn.qkv_attention_fwd.launches) == before


@pytest.mark.parametrize("call", [
    lambda: port_gn.gn_act_fwd(torch.zeros(2, 2, 64), torch.ones(64),
                               torch.zeros(64)),
    lambda: port_gn.gn_act_fwd(torch.zeros(1, 2, 2, 48), torch.ones(48),
                               torch.zeros(48)),
    lambda: port_gn.gn_act_fwd(torch.zeros(1, 2, 2, 64), torch.ones(32),
                               torch.zeros(64)),
    lambda: port_gn.gn_act_fwd(torch.zeros(1, 2, 2, 64), torch.ones(64),
                               torch.zeros(64), act="relu"),
    lambda: port_attn.qkv_attention_fwd(torch.zeros(1, 4, 100), 1),
    lambda: port_attn.qkv_attention_fwd(torch.zeros(1, 4, 96), 5),
    lambda: port_attn.qkv_attention_fwd(torch.zeros(4, 96), 1),
    # what the cluster kernels take: at most 65535 batch elements, and a
    # block's float32 arrays (6 C floats in the backward) within 227 KB
    lambda: port_gn.geometry(65536, 1, 1, 64, 32, torch.float32, False),
    lambda: port_gn.geometry(1, 2, 2, 16384, 32, torch.float32, True),
    lambda: port_gn.geometry(1, 2, 2, 64, 48, torch.float32, False),
    # only gn_stats and gn_bwd_sums are cut into clusters
    lambda: port_gn.split_geometry("apply", 1, 2, 2, 64, 32, torch.float32),
])
def test_wrappers_refuse_bad_shapes(call):
    with pytest.raises(ValueError):
        call()
