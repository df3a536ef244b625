"""Rules the port keeps: it imports nothing of JAX or of the JAX package,
its import needs no CUDA toolchain, and its build step fails loudly.
"""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "unet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_files_were_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "unet_tpu_torch/ops/functional.py",
            "unet_tpu_torch/ops/kernels/_build.py",
            "unet_tpu_torch/cli/generate.py",
            "unet_tpu_torch/ops/kernels/conv3x3.py",
            "unet_tpu_torch/utils/benchmark.py",
            "unet_tpu_torch/scripts/conv_proto.py",
            "unet_tpu_torch/scripts/bench_ops.py",
            "unet_tpu_torch/scripts/block_timing.py",
            "unet_tpu_torch/utils/native.py",
            "unet_tpu_torch/cli/prepare_data.py",
            "unet_tpu_torch/parallel/__init__.py",
            "unet_tpu_torch/parallel/distributed.py",
            "unet_tpu_torch/parallel/mesh.py",
            "unet_tpu_torch/ops/s2d.py",
            "unet_tpu_torch/scripts/profile_input_pipeline.py",
            "unet_tpu_torch/scripts/make_demo_dataset.py"} <= names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_jax_package_import(path):
    for module in _imported_modules(path):
        top = module.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax"), (path, module)
        assert top != "unet_tpu", (path, module)


def test_import_needs_no_toolchain_and_pulls_in_no_jax():
    """A fresh interpreter imports every module of the port with `nvcc` and
    `triton` unreachable, builds nothing, and ends with no JAX loaded."""
    code = """
import importlib, pathlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('triton', 'jax', 'jaxlib', 'unet_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
for m in ('jax', 'jaxlib'):
    sys.modules.pop(m, None)
root = pathlib.Path('unet_tpu_torch')
for p in sorted(root.rglob('*.py')):
    mod = '.'.join(p.with_suffix('').parts)
    if mod.endswith('__init__'):
        mod = mod[:-9]
    importlib.import_module(mod)
from unet_tpu_torch.ops.kernels import _build
from unet_tpu_torch.utils import native
assert _build._lib is None and native._lib is None
assert 'PIL' not in sys.modules
assert not [m for m in sys.modules if m.split('.')[0] in ('triton', 'unet_tpu')]
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PATH": "/nonexistent", "HOME": "/nonexistent"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_host_library_is_built_from_the_ports_own_source():
    """host.cpp lives in the port and names nothing of the JAX package: no
    `unet_tpu` module or path, no `native/` directory, no JAX."""
    from unet_tpu_torch.utils import native
    assert native.SOURCE == ROOT / "unet_tpu_torch" / "native" / "host.cpp"
    text = native.SOURCE.read_text()
    assert not re.search(r"\bunet_tpu\b(?!_torch)|\bnative/|\bjax", text)
    assert "#include <Python.h>" not in text
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert native.BUILD_DIR == ROOT / "unet_tpu_torch" / "build"


@pytest.mark.parametrize("name", ["utils/native.py", "cli/train.py",
                                  "ops/kernels/_build.py",
                                  "parallel/distributed.py",
                                  "parallel/mesh.py"])
def test_no_handler_swallows_a_build_or_load_failure(name):
    """Every `except` in the modules that build and load the libraries,
    choose the loader, or join and run the ranks, raises again: no
    fallback to the plain loader, a missing library, another backend or
    fewer ranks."""
    tree = ast.parse((ROOT / "unet_tpu_torch" / name).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler):
            assert any(isinstance(n, ast.Raise) for n in ast.walk(node)), (
                name, node.lineno)


@pytest.mark.parametrize("device,kind", [
    ("cuda", "nccl"), ("cuda:1", "nccl"), ("cpu", "gloo")])
def test_a_cuda_device_always_gets_nccl(device, kind):
    """The process group's backend follows the device, with no switch and
    no fallback; a device with no backend raises."""
    from unet_tpu_torch.parallel import distributed
    assert distributed.backend(device) == kind
    with pytest.raises(ValueError, match="no process-group backend"):
        distributed.backend("meta")
    source = (ROOT / "unet_tpu_torch" / "parallel" / "distributed.py"
              ).read_text()
    assert source.count('"gloo"') == 1  # in `backend` alone


def test_build_step_raises_without_nvcc(monkeypatch, tmp_path):
    from unet_tpu_torch.ops.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed at its usual place")
    with pytest.raises(_build.KernelCompileError, match="nvcc not found"):
        _build.build()
    assert _build._lib is None


def test_build_step_reports_the_compilers_output(monkeypatch, tmp_path):
    """A compiler that refuses a source: the error carries its output and
    names the file; nothing is left in the build directory."""
    from unet_tpu_torch.ops.kernels import _build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such instruction' >&2\n"
                    "exit 3\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(_build.KernelCompileError) as e:
        _build.build()
    text = str(e.value)
    assert "no such instruction" in text and "exit 3" in text
    assert ("groupnorm.cu" in text and "attention.cu" in text
            and "conv3x3.cu" in text and "attention_wide.cu" in text)
    assert list((tmp_path / "build").iterdir()) == []


def test_build_keeps_the_compilers_output_beside_the_library(
        monkeypatch, tmp_path):
    """A compiler that succeeds: its output is `build_log` after the build,
    and again when the next call finds the library already on disk."""
    from unet_tpu_torch.ops.kernels import _build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nout=\nwhile [ $# -gt 0 ]; do\n"
                    "  [ \"$1\" = -o ] && out=$2\n  shift\ndone\n"
                    "echo 'ptxas info    : Used 40 registers'\n"
                    ": > \"$out\"\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "build_log", "")
    lib = _build.build()
    fresh = _build.build_log
    assert fresh.count("Used 40 registers") == len(_build.sources())
    monkeypatch.setattr(_build, "build_log", "")
    assert _build.build() == lib
    assert _build.build_seconds == 0.0 and _build.build_log == fresh
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])


@pytest.mark.parametrize("mangled, name", [
    ("_ZN45_GLOBAL__N__d44ee978_12_attention_cu_9f1402cf28qkv_attention_fwd"
     "_mma_kernelEPK13__nv_bfloat16PS0_iif", "qkv_attention_fwd_mma_kernel"),
    ("_ZN45_GLOBAL__N__564b41ec_12_groupnorm_cu_0b627da415gn_stats_kernelI13"
     "__nv_bfloat16Li1EEEvPKT_Pfiiii", "gn_stats_kernel"),
    ("_Z10foo_kernelPf", "foo_kernel"),
    ("unet_kernel", "unet_kernel"),
    ("_ZNbroken", "_ZNbroken")])
def test_kernel_name_from_a_mangled_name(mangled, name):
    """nvcc names an anonymous namespace after the source file, and a
    template's arguments follow the name."""
    from unet_tpu_torch.ops.kernels import _build
    assert _build.kernel_name(mangled) == name


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3abc8a_kernelIfEEvPf' for 'sm_90a'
ptxas info    : Function properties for _ZN3abc8a_kernelIfEEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN3abc8a_kernelIdEEvPd' for 'sm_90a'
ptxas info    : Function properties for _ZN3abc8a_kernelIdEEvPd
    8 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z8b_kernelv' for 'sm_90a'
ptxas info    : Used 16 registers, 384 bytes cmem[0]
"""


def test_ptxas_summary_lists_each_kernel_and_the_spills():
    from unet_tpu_torch.ops.kernels import _build
    assert _build.ptxas_summary(PTXAS_LOG) == {
        "kernels": 3, "max_registers": 255, "max_spill_bytes": 12,
        "registers": {"a_kernel": [40, 255], "b_kernel": [16]}}


def test_ptxas_summary_of_a_log_without_ptxas_names_no_kernel():
    """What `chip_smoke.py` fails on: a library whose build log is lost."""
    from unet_tpu_torch.ops.kernels import _build
    assert _build.ptxas_summary("")["kernels"] == 0
    assert _build.ptxas_summary("nvcc: warning\n")["kernels"] == 0


def _c_signature(name):
    """The parameter kinds of an `extern "C"` launcher in csrc/*.cu: "p"
    for a pointer or stream, "i" for int, "f" for float."""
    from unet_tpu_torch.ops.kernels import _build
    for src in _build.sources():
        m = re.search(r'extern "C" int %s\(([^)]*)\)' % name,
                      src.read_text())
        if m:
            kinds = ""
            for param in m.group(1).split(","):
                ctype = param.strip().rsplit(" ", 1)[0]
                kinds += ("p" if "*" in param or ctype == "cudaStream_t"
                          else {"int": "i", "float": "f"}[ctype])
            return kinds
    raise AssertionError(f"no launcher {name} in csrc")


@pytest.mark.parametrize("module, name", [
    ("attention", "unet_qkv_attention_fwd"),
    ("attention", "unet_qkv_attention_bwd"),
    ("groupnorm", "unet_gn_act_fwd"),
    ("groupnorm", "unet_gn_act_bwd"),
    ("groupnorm", "unet_gn_stats"),
    ("groupnorm", "unet_gn_apply"),
    ("groupnorm", "unet_gn_bwd_sums"),
    ("groupnorm", "unet_gn_bwd_dx")])
def test_launcher_argtypes_match_the_sources(module, name):
    """The ctypes signature a wrapper declares is the one its launcher
    takes: a mismatch passes wrong arguments on the GPU without an error."""
    import importlib
    mod = importlib.import_module(f"unet_tpu_torch.ops.kernels.{module}")
    assert mod._ARGTYPES[name] == _c_signature(name)


def test_sources_and_digest():
    from unet_tpu_torch.ops.kernels import _build
    names = [p.name for p in _build.sources()]
    assert names == sorted(names)
    assert {"attention.cu", "attention_chunked.cu", "attention_wide.cu",
            "conv3x3.cu", "groupnorm.cu"} <= set(names)
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    tag = _build._digest(_build.sources())
    assert tag == _build._digest(_build.sources()) and len(tag) == 16


CSRC_FILES = sorted((ROOT / "unet_tpu_torch" / "csrc").glob("*.cu*"))


@pytest.mark.parametrize("path", CSRC_FILES, ids=lambda p: p.name)
def test_kernel_sources_include_no_framework_header(path):
    """Every CUDA source and header of the port (attention_wide.cu among
    them) has a plain C interface: no PyTorch, Python or JAX header, so a
    build takes seconds."""
    includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', path.read_text())
    assert includes and not [
        h for h in includes if h.split("/")[0] in (
            "torch", "ATen", "c10", "pybind11", "Python.h", "jax", "xla")]


def test_the_attention_sources_are_found():
    assert {"attention.cu", "attention_chunked.cu", "attention_wide.cu",
            "attention.cuh", "common.cuh"} <= {p.name for p in CSRC_FILES}


def test_check_launch_passes_zero():
    from unet_tpu_torch.ops.kernels import _build
    _build.check_launch(0, "anything")   # no library needed for success


def test_chip_smoke_refuses_to_run_without_a_gpu():
    """On a machine with no CUDA device the script exits non-zero and prints
    no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("mangled, instance", [
    ("_ZN45_GLOBAL__N__d44ee978_12_attention_cu_9f1402cf28qkv_attention_fwd"
     "_mma_kernelILi64EEEvPK13__nv_bfloat16PS1_iif",
     "qkv_attention_fwd_mma_kernel<64>"),
    ("_ZN45_GLOBAL__N__d44ee978_12_attention_cu_9f1402cf33qkv_attention_bwd"
     "_dkv_tf32_kernelILi16EEEvPKfS2_PfS2_iiif",
     "qkv_attention_bwd_dkv_tf32_kernel<16>"),
    ("_ZN45_GLOBAL__N__564b41ec_12_groupnorm_cu_0b627da415gn_stats_kernelI13"
     "__nv_bfloat16Li1EEEvPKT_Pfiiii", "gn_stats_kernel<__nv_bfloat16,1>"),
    ("_ZN3abc8a_kernelIfEEvPf", "a_kernel<float>"),
    ("_Z10foo_kernelPf", "foo_kernel"),
    ("unet_kernel", "unet_kernel")])
def test_kernel_instance_names_the_template_arguments(mangled, instance):
    from unet_tpu_torch.ops.kernels import _build
    assert _build.kernel_instance(mangled) == instance


def test_ptxas_instances_lists_each_instantiation():
    from unet_tpu_torch.ops.kernels import _build
    assert _build.ptxas_instances(PTXAS_LOG) == [
        {"kernel": "a_kernel<float>", "registers": 40, "spill_bytes": 0},
        {"kernel": "a_kernel<double>", "registers": 255, "spill_bytes": 12},
        {"kernel": "b_kernel", "registers": 16, "spill_bytes": 0}]
