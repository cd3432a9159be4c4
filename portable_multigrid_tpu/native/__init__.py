"""Native (C++) setup runtime, loaded via ctypes and built on first use.

The compute path is JAX/XLA; this package is the *host* native tier: the
counterpart of the reference's C++ setup machinery (DoF enumeration, index
harvesting, transfer weights).  Every process compiles the shared library
from ``pmg_native.cpp`` with g++ on first use, so a library is never loaded
on a machine other than the one that built it; the file is removed once
loaded.  Every entry point has a pure-Python twin in fem/ used as fallback
and as the golden reference in tests.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import uuid

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pmg_native.cpp")
# inside the checkout, listed in .gitignore
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "native")
_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def _build() -> str:
    """Compile the library for this process; returns the file's path."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    out = os.path.join(
        _BUILD_DIR, f"libpmg_native-{os.getpid()}-{uuid.uuid4().hex}.so"
    )
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", out]
    subprocess.run(cmd, check=True, capture_output=True)
    return out


def get_lib():
    """Load (building first) the native library; raises NativeUnavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            path = _build()
            try:
                lib = ctypes.CDLL(path)
            finally:
                os.remove(path)
        except (OSError, subprocess.CalledProcessError) as exc:
            raise NativeUnavailable(str(exc)) from exc
        lib.pmg_enumerate_dofs.restype = ctypes.c_int64
        lib.pmg_enumerate_dofs.argtypes = [
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.pmg_valence_weights.restype = None
        lib.pmg_valence_weights.argtypes = [
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    try:
        get_lib()
        return True
    except NativeUnavailable:
        return False


def enumerate_dofs_native(cells: np.ndarray, dim: int, degree: int):
    """C++ DoF enumeration; same contract as fem.dof_numbering.enumerate_dofs."""
    lib = get_lib()
    cells = np.ascontiguousarray(cells, dtype=np.int64)
    E = cells.shape[0]
    ndof = (degree + 1) ** dim
    l2g = np.zeros((E, ndof), dtype=np.int64)
    mask = np.zeros(E * ndof, dtype=np.float64)
    n = lib.pmg_enumerate_dofs(
        dim,
        degree,
        E,
        cells.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        l2g.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        mask.size,
    )
    if n < 0:
        raise RuntimeError("pmg_enumerate_dofs failed")
    return int(n), l2g, mask[:n].copy()


def valence_weights_native(l2g: np.ndarray, n_dofs: int) -> np.ndarray:
    lib = get_lib()
    l2g = np.ascontiguousarray(l2g, dtype=np.int64)
    out = np.zeros(n_dofs, dtype=np.float64)
    lib.pmg_valence_weights(
        l2g.shape[0],
        l2g.shape[1],
        l2g.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_dofs,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def enumerate_dofs(mesh, degree: int):
    """Native-if-available DoF enumeration (Python fallback otherwise)."""
    try:
        return enumerate_dofs_native(mesh.cells, mesh.dim, degree)
    except NativeUnavailable:
        from ..fem.dof_numbering import enumerate_dofs as py_enum

        return py_enum(mesh, degree)
