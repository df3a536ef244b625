"""Build-and-load step for the hand-written CUDA kernels.

The JAX package needs no counterpart (Pallas kernels are compiled by JAX);
here every `csrc/*.cu` is compiled by `nvcc` for sm_90a and linked into one
shared library with a plain C interface, which is loaded with `ctypes`.
The sources include no PyTorch header, so a build takes seconds.

The build happens at first use, never at import: importing this module
needs neither `nvcc` nor a GPU.  Objects are compiled in parallel (one
`nvcc` per source, all started together) into `unet_tpu_torch/build/`,
under a name derived from the sources' contents, so an unchanged tree
builds once; what the compiler printed is kept beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

# `-Xptxas -v` costs nothing and puts each kernel's registers, shared memory
# and spills into `build_log` (`ptxas_summary` reads them).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Flags added to NVCC_FLAGS, set before the first `load`: an instrumented
# build (utils/gn_phases.py sets -DGN_PHASE_CLOCKS) gets a library of its own.
extra_flags: tuple = ()

_lib: Optional[ctypes.CDLL] = None
# Seconds the last build took (0.0 when the library was already on disk) and
# what the compiler printed during the build of the library in use.
build_seconds = 0.0
build_log = ""


class KernelCompileError(RuntimeError):
    """`nvcc` is missing or refused a source; carries its output."""


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidates.append(os.path.join(os.environ[var], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelCompileError(
        "nvcc not found (looked on PATH, in $CUDA_HOME/bin and in "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built")


def sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(paths) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(extra_flags)).encode())
    for p in list(paths) + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into one shared library; returns its path.
    Raises KernelCompileError with nvcc's output when any step fails."""
    global build_seconds, build_log
    srcs = sources()
    if not srcs:
        raise KernelCompileError(f"no CUDA sources under {CSRC_DIR}")
    tag = _digest(srcs)
    lib_path = BUILD_DIR / f"libunet_kernels_{tag}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        build_seconds = 0.0
        build_log = log_path.read_text() if log_path.exists() else ""
        return lib_path
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}_{tag}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *extra_flags, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures, logs = [], []
    for src, obj, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name} "
                            f"(exit {proc.returncode}):\n{out}")
    objs = [str(obj) for _, obj, _ in jobs]
    try:
        if failures:
            raise KernelCompileError("\n".join(failures))
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise KernelCompileError(
                f"nvcc failed to link (exit {link.returncode}):\n"
                f"{link.stdout}")
        tmp_log = log_path.with_name(f"{log_path.name}.{os.getpid()}.tmp")
        tmp_log.write_text("".join(logs))
        os.replace(tmp_log, log_path)
        os.replace(tmp, lib_path)  # atomic: a concurrent build is harmless
    finally:
        for o in objs:
            if os.path.exists(o):
                os.unlink(o)
    build_log = "".join(logs)
    build_seconds = time.perf_counter() - t0
    return lib_path


def kernel_name(mangled: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameter types, from its mangled name (`_Z` <length> <name>, or `_ZN`
    <length> <namespace> <length> <name>); the mangled name otherwise."""
    m = re.match(r"_ZN?(\d+)", mangled)
    if not m:
        return mangled
    start, length = m.end(), int(m.group(1))
    if mangled.startswith("_ZN"):  # the name follows the namespace
        n = re.match(r"\d+", mangled[start + length:])
        if not n:
            return mangled
        start, length = start + length + n.end(), int(n.group())
    return mangled[start:start + length]


def kernel_instance(mangled: str) -> str:
    """A kernel's name with its template arguments, `name<16>` or
    `name<__nv_bfloat16,1>`, from its mangled name; `kernel_name` where it
    is no template."""
    name = kernel_name(mangled)
    at = mangled.find(name)
    rest = mangled[at + len(name):] if at >= 0 else ""
    if not rest.startswith("I"):
        return name
    args, pos = [], 1
    while pos < len(rest) and rest[pos] != "E":
        if rest[pos] == "L":  # a literal: L <type letter> <value> E
            end = rest.find("E", pos)
            if end < 0:
                return name
            args.append(rest[pos + 2:end])
            pos = end + 1
        elif rest[pos].isdigit():  # a type by name: <length> <name>
            digits = re.match(r"\d+", rest[pos:])
            start = pos + digits.end()
            args.append(rest[start:start + int(digits.group())])
            pos = start + int(digits.group())
        else:  # a builtin type
            args.append({"f": "float", "d": "double"}.get(rest[pos], rest[pos]))
            pos += 1
    return f"{name}<{','.join(args)}>"


def ptxas_instances(log: str) -> list:
    """Each compiled kernel's `kernel_instance` name, registers and spilled
    bytes (stores and loads, the larger), in the build's order, from what
    `nvcc -Xptxas -v` printed."""
    out = []
    for entry in log.split("Compiling entry function '")[1:]:
        used = re.search(r"Used (\d+) registers", entry)
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", entry)]
        out.append({"kernel": kernel_instance(entry.split("'", 1)[0]),
                    "registers": int(used.group(1)) if used else None,
                    "spill_bytes": max(spills, default=0)})
    return out


def ptxas_summary(log: str) -> dict:
    """Each kernel's registers (a list: one entry per instantiation, in the
    build's order) and the most bytes any kernel spills, from what `nvcc
    -Xptxas -v` printed (`build_log`)."""
    registers = {}
    for entry in log.split("Compiling entry function '")[1:]:
        used = re.search(r"Used (\d+) registers", entry)
        registers.setdefault(kernel_name(entry.split("'", 1)[0]), []).append(
            int(used.group(1)) if used else None)
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
    counts = [n for regs in registers.values() for n in regs if n is not None]
    return {"kernels": sum(len(r) for r in registers.values()),
            "max_registers": max(counts, default=0),
            "max_spill_bytes": max(spills, default=0),
            "registers": registers}


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if need be.  The wrappers
    declare their functions' `argtypes` on it."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.unet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.unet_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_launch(code: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code (0 is success)."""
    if code != 0:
        text = load().unet_cuda_error_string(code).decode()
        raise RuntimeError(
            f"{name}: kernel launch failed with CUDA error {code} ({text})")
