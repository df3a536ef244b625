"""Head sizes other than the default model's 32: the attention kernels'
plain versions against the Pallas kernels at head sizes 16 and 64, the
head sizes the CUDA kernels are compiled for, and the CLIs' refusal of any
other head size on a CUDA device (before a model is built; the CPU takes
any head size, as the JAX package does).

The Pallas kernels run in interpret mode (automatic off a TPU), as
tests/test_pallas.py runs them; the port's wrappers get CPU tensors and so
take their plain versions.  Tolerances are those of the existing attention
cases: tests/test_torch_kernels_plain.py for the forward (float32 2e-5;
bfloat16 1e-3 absolute plus one bfloat16 step relative) and
tests/test_torch_kernels_bwd.py for the backward (float32 3e-5 absolute and
1e-4 relative, bfloat16 3e-2 absolute).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_tpu.ops.pallas import attention as jax_attn
from unet_tpu_torch.cli import generate
from unet_tpu_torch.cli import train as train_cli
from unet_tpu_torch.config import UnetConfig
from unet_tpu_torch.data.dataset import write_bin
from unet_tpu_torch.io import checkpoint as port_ckpt
from unet_tpu_torch.models import unet as port_unet
from unet_tpu_torch.ops.kernels import attention as port_attn

from tests.torch_port_util import TINY, j2n, t2n

FWD_TOL = {"float32": dict(atol=2e-5),
           "bfloat16": dict(atol=1e-3, rtol=2.0 ** -7)}
BWD_TOL = {"float32": dict(atol=3e-5, rtol=1e-4),
           "bfloat16": dict(atol=3e-2, rtol=0.0)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ATTENTION_CU = (Path(__file__).resolve().parents[1] / "unet_tpu_torch"
                / "csrc" / "attention.cu")

# (B, T, C, NH): head sizes 16 and 64; T = 72 leaves a ragged 64-row tile.
SHAPES = [pytest.param(2, 64, 64, 4, id="HS16"),
          pytest.param(2, 64, 128, 2, id="HS64"),
          pytest.param(1, 72, 128, 8, id="HS16-T72"),
          pytest.param(1, 72, 192, 3, id="HS64-T72")]


@pytest.mark.parametrize("B,T,C,NH", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_fwd_vs_pallas_at_other_head_sizes(B, T, C, NH, dtype):
    qkv = np.random.default_rng(C + NH).standard_normal((B, T, 3 * C),
                                                        dtype=np.float32)
    got = port_attn.qkv_attention_fwd(torch.from_numpy(qkv).to(TDT[dtype]),
                                      NH)
    want = jax_attn.qkv_attention_fused(jnp.asarray(qkv).astype(JDT[dtype]),
                                        NH)
    assert got.dtype == TDT[dtype] and got.shape == (B, T, C)
    np.testing.assert_allclose(t2n(got), j2n(want), **FWD_TOL[dtype])


@pytest.mark.parametrize("B,T,C,NH", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_vs_pallas_at_other_head_sizes(B, T, C, NH, dtype):
    rng = np.random.default_rng(T + C)
    qkv = rng.standard_normal((B, T, 3 * C), dtype=np.float32)
    dout = rng.standard_normal((B, T, C), dtype=np.float32)
    want = jax_attn._bwd_call(jnp.asarray(qkv).astype(JDT[dtype]),
                              jnp.asarray(dout).astype(JDT[dtype]), NH)
    got = port_attn.qkv_attention_bwd(torch.from_numpy(qkv).to(TDT[dtype]),
                                      torch.from_numpy(dout).to(TDT[dtype]),
                                      NH)
    assert got.dtype == TDT[dtype] and got.shape == qkv.shape
    np.testing.assert_allclose(t2n(got), j2n(want), **BWD_TOL[dtype])


def test_head_sizes_are_the_sources_instantiations():
    """The wrapper's HEAD_SIZES are the cases of the launchers' dispatch in
    csrc/attention.cu, each instantiating the kernels at its own size."""
    cases = re.findall(r"case (\d+): return f\(std::integral_constant<int, "
                       r"(\d+)>\(\)\);", ATTENTION_CU.read_text())
    assert cases and all(a == b for a, b in cases)
    assert tuple(sorted(int(a) for a, _ in cases)) == port_attn.HEAD_SIZES
    assert all(hs % 16 == 0 for hs in port_attn.HEAD_SIZES)  # mma k-steps


@pytest.mark.parametrize("widths, head_size, fault", [
    ([192, 192, 256], 32, None), ([192, 256], 64, None), ([64], 16, None),
    ([192, 256], 48, "head sizes"), ([96, 192], 64, "does not divide"),
    ([32], 64, "does not divide")])
def test_head_size_fault(widths, head_size, fault):
    got = port_attn.head_size_fault(widths, head_size)
    assert (got is None) if fault is None else (fault in got)


def test_attention_widths_of_the_default_model():
    widths = port_unet.attention_widths(UnetConfig())
    assert len(widths) == 11 and set(widths) == {192, 256}


def test_cuda_wrapper_refuses_an_uncompiled_head_size():
    """On a CPU-only machine the refusal comes before any CUDA call: the
    device check comes first, so a CUDA tensor is faked by its attributes."""
    class FakeCuda:
        device = torch.device("cuda")
        dtype = torch.bfloat16
        shape = (2, 8, 3 * 96)

        def is_contiguous(self):
            return True

    with pytest.raises(ValueError, match="head sizes"):
        port_attn._check_cuda(FakeCuda(), 2)  # HS = 48


def _train_flags(tmp_path, head_size, device, channels=96, mult="1,2"):
    """Attention at 8x8 of 16x16 images, on the second level: width 192 at
    96 channels and mult 1,2 (four heads of 48)."""
    return ["--data_file", str(tmp_path / "data.bin"), "--device", device,
            "--num_channels", str(channels),
            "--num_head_channels", str(head_size),
            "--image_size", "16", "--channel_mult", mult,
            "--num_res_blocks", "1", "--attention_resolutions", "8",
            "--batch_size", "2", "--iterations", "1", "--log_interval", "1",
            "--save_interval", "1", "--output_dir", str(tmp_path / "m"),
            "--log_file", str(tmp_path / "log.txt")]


@pytest.fixture
def no_model_built(monkeypatch):
    """Fails the test if a model is built or a checkpoint's weights load."""
    def refuse(*args, **kwargs):
        raise AssertionError("a model was built")
    monkeypatch.setattr(port_unet, "init", refuse)
    monkeypatch.setattr(port_ckpt, "load", refuse)


@pytest.mark.parametrize("head_size, channels, mult", [
    (48, 96, "1,2"), (64, 32, "1,3")])
def test_train_refuses_a_head_size_on_cuda_before_any_work(
        tmp_path, head_size, channels, mult, no_model_built):
    """48 is compiled for no kernel; 64 does not divide the attention width
    96 of --num_channels 32 --channel_mult 1,3.  No data file is needed to
    be refused."""
    with pytest.raises(SystemExit, match="head size"):
        train_cli.main(_train_flags(tmp_path, head_size, "cuda", channels,
                                    mult))


def test_train_takes_head_size_48_on_the_cpu(tmp_path):
    write_bin(str(tmp_path / "data.bin"), np.random.default_rng(0).uniform(
        -1, 1, (2, 3, 16, 16)).astype(np.float32))
    state = train_cli.main(_train_flags(tmp_path, 48, "cpu"))
    assert state.step == 1
    assert port_ckpt.read_config(
        str(tmp_path / "m" / "model_1.bin")).num_head_channels == 48


@pytest.fixture
def hs48_file(tmp_path):
    cfg = UnetConfig(**{**TINY, "model_channels": 96,
                        "num_head_channels": 48})
    model = port_unet.init(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    path = str(tmp_path / "hs48.bin")
    port_ckpt.save(path, port_ckpt.Checkpoint(params=model, cfg=cfg,
                                              batch_size=2))
    return path


def test_generate_refuses_head_size_48_on_cuda_before_loading(
        hs48_file, no_model_built, capsys):
    args = generate.parse_args(["--model_filename", hs48_file, "--device",
                                "cuda", "--sampler", "ddim"])
    with pytest.raises(SystemExit) as e:
        generate.run(args)
    assert e.value.code == 2 and "head sizes" in capsys.readouterr().err


def test_generate_takes_head_size_48_on_the_cpu(hs48_file):
    images = generate.run(generate.parse_args(
        ["--model_filename", hs48_file, "--device", "cpu", "--sampler",
         "ddim", "--ddim_steps", "2", "--batch_size", "2"]))
    assert images.dtype == np.uint8 and images.shape == (2, 16, 16, 3)


def test_read_config_is_the_header_load_reads(hs48_file):
    cfg = port_ckpt.read_config(hs48_file)
    assert cfg == port_ckpt.load(hs48_file, device="cpu").cfg
    assert cfg.num_head_channels == 48 and cfg.model_channels == 96
