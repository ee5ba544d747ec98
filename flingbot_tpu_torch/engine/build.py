"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by its own `nvcc` into a shared library
with a plain C interface (no PyTorch headers: a build takes seconds, not
minutes) and loaded with ctypes.  All sources build in parallel, at first
use.  A library is named by a hash of its source and of the nvcc flags,
so an edited source rebuilds and an unchanged one is reused.

The build directory is `flingbot_tpu_torch/build/` (ignored by git), or
$FLINGBOT_TORCH_BUILD_DIR.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no a*b+c contraction, so a kernel rounds every operation as
# its plain PyTorch version does and the two can be compared bit for bit
# (the solver's clamps and contact counts are discontinuous, so an FMA's
# different rounding can flip a branch and move a particle by far more
# than the rounding itself).  chip_smoke's kernel-vs-plain tolerances rely
# on this flag; a build with contraction must be held instead by one frame
# on the card against the CPU path (chip_smoke phase 4, 1e-4)
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-fmad=false", "-shared",
                           "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# ptxas resource reports of the builds this process ran, by kernel name
build_logs: dict = {}


def build_dir() -> str:
    return os.environ.get("FLINGBOT_TORCH_BUILD_DIR",
                          os.path.join(PKG_DIR, "build"))


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (sm_90a)")
    return path


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"{name}_{h.hexdigest()[:16]}.so")


def build(names) -> dict:
    """Compile (where needed, all in parallel) and load the named kernels.
    Returns {name: ctypes.CDLL}; the caller keeps the libraries."""
    procs = {}
    os.makedirs(build_dir(), exist_ok=True)
    for n in names:
        out = _lib_path(n)
        if os.path.exists(out):
            continue
        # a unique temporary name, renamed into place: concurrent builders
        # never load a half-written library
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path()] + NVCC_FLAGS + [
            "-o", tmp, os.path.join(CSRC_DIR, n + ".cu")]
        procs[n] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[n] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {n}.cu:\n{log}")
        os.replace(tmp, out)
    return {n: ctypes.CDLL(_lib_path(n)) for n in names}
