"""The port's implicit-GEMM 3x3 convolution (`ops.kernels.conv3x3`) held
against the Pallas kernel it replaces, scripts/conv_proto.py.

scripts/ is not a package, so the JAX script is loaded from its file; its
Pallas kernel runs in interpret mode (automatic off a TPU).  The port's
wrapper gets CPU tensors and so takes its plain version, which keeps the
CUDA kernel's rounding points; the CUDA kernel itself is compared with that
plain version on the GPU by chip_smoke.py.

Tolerances: float32 2e-5 absolute (the bar of tests/test_pallas.py: same
arithmetic, another order of sums; the plain version sums in float64, the
Pallas kernel in float32); bfloat16 1e-4 absolute plus one bfloat16 step
(2^-7) relative, the GroupNorm bar: both sides round one sum of exact
products once, and may round on either side of a rounding point.
"""

import importlib.util
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu_torch.ops.kernels import conv3x3 as port_conv
from unet_tpu_torch.scripts import conv_proto as port_proto

from tests.torch_port_util import j2n, t2n

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_conv_proto", ROOT / "scripts" / "conv_proto.py")
jax_proto = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_proto)

TOL = {"float32": dict(atol=2e-5, rtol=0.0),
       "bfloat16": dict(atol=1e-4, rtol=2.0 ** -7)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(shape, seed):
    H, W, B, C, O = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((H, W, B, C), dtype=np.float32)
    w = rng.standard_normal((3, 3, C, O), dtype=np.float32) * 0.05
    b = rng.standard_normal(O, dtype=np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,TH,dtype", [
    ((8, 8, 4, 64, 64), 2, "float32"),
    ((6, 5, 3, 24, 40), 3, "float32"),
    ((8, 8, 4, 64, 64), 2, "bfloat16"),
    ((4, 4, 8, 192, 64), 1, "bfloat16"),
])
def test_conv3x3_hwbc_vs_pallas(shape, TH, dtype):
    """x in the working type; w and b float32, so the cast of w to x's type
    and the float32 bias are both exercised."""
    x, w, b = _inputs(shape, seed=sum(shape))
    jx = jnp.asarray(x).astype(JDT[dtype])
    tx = torch.from_numpy(x).to(TDT[dtype])
    want = jax_proto.conv3x3_hwbc(jx, jnp.asarray(w), jnp.asarray(b), TH=TH)
    got = port_conv.conv3x3_hwbc(tx, torch.from_numpy(w), torch.from_numpy(b))
    H, W, B, _, O = shape
    assert got.dtype == TDT[dtype] and got.shape == (H, W, B, O)
    assert got.is_contiguous()
    np.testing.assert_allclose(t2n(got), j2n(want), **TOL[dtype])
    if dtype == "float32":
        ref = jax_proto.conv3x3_ref(jx, jnp.asarray(w), jnp.asarray(b))
        np.testing.assert_allclose(t2n(got), j2n(ref), **TOL[dtype])


def test_plain_rounds_w_to_the_input_type():
    x, w, b = _inputs((3, 4, 2, 16, 8), seed=1)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    assert torch.equal(port_conv.conv3x3_hwbc_plain(tx, tw, tb),
                       port_conv.conv3x3_hwbc_plain(
                           tx, tw.to(torch.bfloat16), tb))


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    x, w, b = (torch.from_numpy(a) for a in _inputs((5, 3, 2, 8, 12), 2))
    before = port_conv.conv3x3_hwbc.launches
    assert torch.equal(port_conv.conv3x3_hwbc(x, w, b),
                       port_conv.conv3x3_hwbc_plain(x, w, b))
    assert port_conv.conv3x3_hwbc.launches == before


def test_inputs_that_require_grad_are_refused():
    x, w, b = (torch.from_numpy(a) for a in _inputs((2, 2, 1, 8, 8), 3))
    for which in range(3):
        args = [x, w, b]
        args[which] = args[which].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            port_conv.conv3x3_hwbc(*args)
        with torch.no_grad():
            port_conv.conv3x3_hwbc(*args)


@pytest.mark.parametrize("x_shape,w_shape,b_shape", [
    ((4, 4, 2), (3, 3, 2, 8), (8,)),          # x not 4-D
    ((4, 4, 2, 8), (3, 3, 4, 8), (8,)),       # C of w is not C of x
    ((4, 4, 2, 8), (1, 1, 8, 8), (8,)),       # not a 3x3 kernel
    ((4, 4, 2, 8), (3, 3, 8, 8), (4,)),       # b does not match O
])
def test_wrapper_refuses_bad_shapes(x_shape, w_shape, b_shape):
    with pytest.raises(ValueError):
        port_conv.conv3x3_hwbc(torch.zeros(x_shape), torch.zeros(w_shape),
                               torch.zeros(b_shape))


def test_conv_proto_check_passes_on_the_cpu(capsys):
    result = port_proto.run(["--device", "cpu"])
    assert result["device"] == "cpu" and result["bench"] == []
    assert result["correctness"]["max_abs_err"] < 1e-4
    assert "correctness (f32 8x8x4x64->64)" in capsys.readouterr().out


def _source_rule():
    """csrc/conv3x3.cu's `route(is_bf16, C, O)` as a Python function: its
    ragged test, then its choice by type."""
    src = (ROOT / "unet_tpu_torch" / "csrc" / "conv3x3.cu").read_text()
    body = re.search(r"Route route\(int is_bf16, int C, int O\) \{(.*?)\n\}",
                     src, re.S).group(1)
    ragged = re.search(r"if \((.*?)\) return Route::(\w+);", body)
    typed = re.search(r"return is_bf16 \? Route::(\w+) : Route::(\w+);", body)
    expr = ragged.group(1).replace("&&", " and ").replace("||", " or ")

    def rule(is_bf16, C, O):
        if eval(expr, {}, dict(C=C, O=O)):
            return ragged.group(2)
        return typed.group(1) if is_bf16 else typed.group(2)
    return rule


def _chip_smoke_conv_shapes():
    from unet_tpu_torch.utils.ab_trees import shape_lists
    return [tuple(s) for s in shape_lists(str(ROOT / "chip_smoke.py"))[
        "CONV_SHAPES"]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_mirrors_the_launchers_rule_at_the_chip_shapes(dtype):
    """The wrapper's `route` is the launcher's `route` at every shape
    chip_smoke.py checks the kernels at: with C and O multiples of 8,
    bfloat16 on `wgmma` and float32 on 3xTF32; C = 3 (the image's
    channels) on the FMA kernel in both types."""
    rule = _source_rule()
    shapes = _chip_smoke_conv_shapes()
    assert len(shapes) == 9
    routes = {}
    for H, W, B, C, O in shapes:
        routes[(C, O)] = port_conv.route(dtype, C, O)
        assert routes[(C, O)] == rule(dtype == torch.bfloat16, C, O)
    assert routes.pop((3, 64)) == "fma"
    assert set(routes.values()) == {
        "wgmma" if dtype == torch.bfloat16 else "tf32"}
