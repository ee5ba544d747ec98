"""ctypes bindings for the native host runtime, fbnative.cpp (counterpart
of flingbot_tpu/native/__init__.py, with the port's own copy of the
source).

g++ builds the library at first use (the first `load_cloth`,
`covered_area` or read of `available`), into the port's build directory
(engine/build.py: flingbot_tpu_torch/build/, ignored by git, or
$FLINGBOT_TORCH_BUILD_DIR), named by a hash of the source and flags.
Without a toolchain `available` is False, and the pure-Python loader
(engine.topology.load_cloth) and the device coverage (env.coverage) keep
working.  This is host code: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fbnative.cpp")
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_tried = False


def lib_path() -> str:
    from flingbot_tpu_torch.engine.build import build_dir

    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(GXX_FLAGS).encode())
    return os.path.join(build_dir(), f"libfbnative_{h.hexdigest()[:16]}.so")


def _build(out: str):
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # a unique temporary name, renamed into place: concurrent builders
    # never load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    subprocess.run(["g++"] + GXX_FLAGS + [_SRC, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, out)


def _load():
    """Build (once per source) and bind the library; None without g++."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        out = lib_path()
        if not os.path.exists(out):
            _build(out)
        lib = ctypes.CDLL(out)
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.fb_load_cloth.restype = ctypes.c_void_p
    lib.fb_load_cloth.argtypes = [ctypes.c_char_p]
    lib.fb_last_error.restype = ctypes.c_char_p
    lib.fb_mesh_counts.restype = ctypes.c_int64
    lib.fb_mesh_counts.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.fb_mesh_fill.restype = ctypes.c_int64
    lib.fb_mesh_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.fb_mesh_free.argtypes = [ctypes.c_void_p]
    lib.fb_covered_area.restype = ctypes.c_double
    lib.fb_covered_area.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double]
    _lib = lib
    return lib


def __getattr__(name):
    # `available`, as the JAX module has it, but read lazily: importing
    # the module builds nothing
    if name == "available":
        return _load() is not None
    raise AttributeError(name)


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError("fbnative did not build (g++ is needed)")
    return lib


def load_cloth(path: str):
    """Native quad-OBJ cloth loader; same contract as
    engine.topology.load_cloth (reference tasks.py:39-102)."""
    lib = _need()
    handle = lib.fb_load_cloth(path.encode())
    if not handle:
        raise ValueError(lib.fb_last_error().decode())
    try:
        counts = (ctypes.c_int64 * 5)()
        lib.fb_mesh_counts(handle, counts)
        v, t, s, b, h = (int(c) for c in counts)
        verts = np.empty((v, 3), np.float64)
        tris = np.empty((t, 3), np.int64)
        stretch = np.empty((s, 2), np.int64)
        bend = np.empty((b, 2), np.int64)
        shear = np.empty((h, 2), np.int64)
        lib.fb_mesh_fill(
            handle,
            verts.ctypes.data_as(ctypes.c_void_p),
            tris.ctypes.data_as(ctypes.c_void_p),
            stretch.ctypes.data_as(ctypes.c_void_p),
            bend.ctypes.data_as(ctypes.c_void_p),
            shear.ctypes.data_as(ctypes.c_void_p),
        )
        return verts, tris, stretch, bend, shear
    finally:
        lib.fb_mesh_free(handle)


def covered_area(positions: np.ndarray, radius: float = 0.00625) -> float:
    """Reference-exact covered area; positions (N, 3) or (N, 4) float32."""
    lib = _need()
    pos = np.ascontiguousarray(positions, np.float32)
    n, stride = pos.shape[0], pos.shape[1]
    return float(lib.fb_covered_area(
        pos.ctypes.data_as(ctypes.c_void_p), n, stride, radius))

