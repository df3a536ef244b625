"""The backward kernels' plain versions and the autograd Functions around
the port's two kernels, held against the Pallas backward kernels they
replace and against finite differences.

The Pallas kernels run in interpret mode (automatic off a TPU), as
tests/test_pallas.py runs them; the port's wrappers get CPU tensors and so
take their plain PyTorch versions, which repeat the CUDA kernels'
arithmetic (chip_smoke.py holds the CUDA kernels to them on the GPU).

Tolerances are those of tests/test_pallas.py for kernel gradients: float32
3e-5 absolute and 1e-4 relative, bfloat16 3e-2 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.ops.pallas import attention as jax_attn
from unet_tpu.ops.pallas import groupnorm as jax_gn
from unet_tpu_torch.ops import functional as F
from unet_tpu_torch.ops.kernels import attention as port_attn
from unet_tpu_torch.ops.kernels import groupnorm as port_gn

from tests.torch_port_util import j2n, t2n

TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=0.0)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.parametrize("cg", [2, 4, 8])
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gn_act_bwd_plain_vs_pallas(cg, act, dtype):
    """x, gamma, beta, dy and the forward's mean and rstd go to both sides;
    C / G = 2, 4, 8 at G = 32."""
    rng = np.random.default_rng(cg)
    shape = (2, 4, 4, 32 * cg)
    C = shape[-1]
    x = rng.standard_normal(shape, dtype=np.float32) * 2 + 0.5
    gamma = rng.standard_normal(C, dtype=np.float32) * 0.3 + 1
    beta = rng.standard_normal(C, dtype=np.float32) * 0.2
    dy = rng.standard_normal(shape, dtype=np.float32)
    jargs = [jnp.asarray(a).astype(JDT[dtype]) for a in (x, gamma, beta)]
    _, mean, rstd = jax_gn._fwd_call(*jargs, num_groups=32, eps=1e-5,
                                     act=act)
    want_dx, want_dg, want_db = jax_gn._bwd_call(
        *jargs, mean, rstd, jnp.asarray(dy).astype(JDT[dtype]),
        num_groups=32, eps=1e-5, act=act)

    targs = [torch.from_numpy(a).to(TDT[dtype]) for a in (x, gamma, beta)]
    dx, dg, db = port_gn.gn_act_bwd(
        *targs, torch.tensor(j2n(mean)[:, 0]), torch.tensor(j2n(rstd)[:, 0]),
        torch.from_numpy(dy).to(TDT[dtype]), 32, act)
    assert dx.dtype == TDT[dtype] and dx.shape == shape
    assert dg.dtype == db.dtype == torch.float32
    assert dg.shape == db.shape == (2, C)
    np.testing.assert_allclose(t2n(dx), j2n(want_dx), **TOL[dtype])
    # the partials are float32 sums on both sides whatever x's type
    np.testing.assert_allclose(t2n(dg), j2n(want_dg)[:, 0], **TOL["float32"])
    np.testing.assert_allclose(t2n(db), j2n(want_db)[:, 0], **TOL["float32"])


@pytest.mark.parametrize("T, C, NH", [
    pytest.param(64, 64, 2, id="64"), pytest.param(256, 64, 2, id="256"),
    pytest.param(64, 256, 8, id="64-C256-NH8"), pytest.param(8, 64, 2, id="8"),
    pytest.param(72, 64, 2, id="72"), pytest.param(136, 64, 2, id="136"),
    pytest.param(72, 256, 8, id="72-C256-NH8")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qkv_attention_bwd_plain_vs_pallas(T, C, NH, dtype):
    """T = 256 takes two query blocks in the Pallas kernel, whose dk and dv
    then add up across its sequential grid axis; C = 256 in 8 heads is the
    ds-8 level's head layout; T = 8, 72 and 136 leave the CUDA kernels'
    64-row tiles short or ragged."""
    rng = np.random.default_rng(T)
    qkv = rng.standard_normal((2, T, 3 * C), dtype=np.float32)
    dout = rng.standard_normal((2, T, C), dtype=np.float32)
    want = jax_attn._bwd_call(jnp.asarray(qkv).astype(JDT[dtype]),
                              jnp.asarray(dout).astype(JDT[dtype]), NH)
    got = port_attn.qkv_attention_bwd(torch.from_numpy(qkv).to(TDT[dtype]),
                                      torch.from_numpy(dout).to(TDT[dtype]),
                                      NH)
    assert got.dtype == TDT[dtype] and got.shape == qkv.shape
    np.testing.assert_allclose(t2n(got), j2n(want), **TOL[dtype])


def _gn_inputs(seed=0, shape=(2, 3, 4, 64)):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g, dtype=torch.float64)
    gamma = torch.randn(shape[-1], generator=g, dtype=torch.float64) * .3 + 1
    beta = torch.randn(shape[-1], generator=g, dtype=torch.float64) * .2
    return [a.requires_grad_() for a in (x, gamma, beta)]


@pytest.mark.parametrize("act", ["silu", "none"])
def test_group_norm_function_gradcheck(act):
    """float64 through the Function: its backward (the plain version of
    the kernel's arithmetic) against finite differences; 8 groups of 8.
    Fast mode: the Jacobian along random directions."""
    assert torch.autograd.gradcheck(
        lambda x, g, b: port_gn.GroupNormAct.apply(x, g, b, 8, 1e-5, act),
        _gn_inputs(), fast_mode=True)


def test_attention_function_gradcheck_at_a_ragged_length():
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn((1, 100, 192), generator=g, dtype=torch.float64)
    assert torch.autograd.gradcheck(
        lambda a: port_attn.QKVAttention.apply(a, 2),
        (qkv.requires_grad_(),), fast_mode=True)


def test_functional_ops_differentiate_through_the_functions():
    """`group_norm_silu` and `qkv_attention` record the Functions, and the
    backward of a CPU tensor launches no kernel."""
    x, gamma, beta = _gn_inputs(2)
    y = F.group_norm_silu(x, gamma, beta, num_groups=32)
    assert type(y.grad_fn).__name__ == "GroupNormActBackward"
    qkv = torch.randn((1, 16, 96), dtype=torch.float64, requires_grad=True)
    out = F.qkv_attention(qkv, 1)
    assert type(out.grad_fn).__name__ == "QKVAttentionBackward"
    before = (port_gn.gn_act_bwd.launches, port_attn.qkv_attention_bwd.launches)
    (y.sum() + out.square().sum()).backward()
    assert all(a.grad is not None for a in (x, gamma, beta, qkv))
    assert (port_gn.gn_act_bwd.launches,
            port_attn.qkv_attention_bwd.launches) == before


def test_gn_bwd_takes_a_strided_dy():
    """The gradient autograd hands the backward may be a permuted view (a
    convolution's input gradient is channels_last NCHW): the wrapper reads
    its values, not its storage order."""
    x, gamma, beta = (a.detach().float() for a in _gn_inputs(3))
    _, mean, rstd = port_gn.gn_act_fwd(x, gamma, beta, 32, 1e-5, "silu")
    dy = torch.randn(x.shape)
    strided = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not strided.is_contiguous() and torch.equal(strided, dy)
    want = port_gn.gn_act_bwd(x, gamma, beta, mean, rstd, dy, 32, "silu")
    got = port_gn.gn_act_bwd(x, gamma, beta, mean, rstd, strided, 32, "silu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("call", [
    lambda: port_gn.gn_act_bwd(torch.zeros(1, 2, 2, 64), torch.ones(64),
                               torch.zeros(64), torch.zeros(1, 32),
                               torch.ones(1, 32), torch.zeros(1, 2, 2, 32)),
    lambda: port_gn.gn_act_bwd(torch.zeros(1, 2, 2, 64), torch.ones(64),
                               torch.zeros(64), torch.zeros(1, 16),
                               torch.ones(1, 16), torch.zeros(1, 2, 2, 64)),
    lambda: port_attn.qkv_attention_bwd(torch.zeros(1, 4, 96),
                                        torch.zeros(1, 4, 96), 1),
    lambda: port_attn.qkv_attention_bwd(torch.zeros(1, 4, 96),
                                        torch.zeros(1, 4, 32), 5),
])
def test_bwd_wrappers_refuse_bad_shapes(call):
    with pytest.raises(ValueError):
        call()
