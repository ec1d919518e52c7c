"""Build and load the hand-written CUDA kernels of csrc/.

Each `csrc/<name>.cu` is compiled by nvcc into its own shared library
with a plain C interface, `build/lib<name>-<hash>.so`, loaded through
ctypes. The hash covers the source text and the compiler flags, so a
library is built at first use and rebuilt when its source changes.
Nothing includes PyTorch's headers: a build takes seconds, not minutes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


def kernel_sources() -> list[str]:
    """Names of the kernel sources, `csrc/<name>.cu`."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from source at first use")
    return path


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start_build(name: str):
    """Start nvcc for csrc/<name>.cu; returns (process, tmp, lib, log) or
    None when the library for this source is already built."""
    lib = library_path(name)
    if os.path.exists(lib):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = lib[:-3] + ".log"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, log


def _finish_build(name: str, job) -> None:
    proc, tmp, lib, log = job
    output, _ = proc.communicate()
    with open(log, "w") as f:
        f.write(output)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{output}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Build the named kernel sources (default: all), one nvcc each, all
    started together. Returns {name: library path}."""
    names = kernel_sources() if names is None else names
    jobs = {n: _start_build(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish_build(n, job)
    return {n: library_path(n) for n in names}


def build_log(name: str) -> str:
    """nvcc's output (with -Xptxas -v: registers, shared memory, spills)
    from the build of csrc/<name>.cu, or "" if it was built elsewhere."""
    log = library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load_library(name: str) -> ctypes.CDLL:
    """ctypes handle of csrc/<name>.cu's library, building it if needed."""
    if name not in _loaded:
        path = build_all([name])[name]
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]
