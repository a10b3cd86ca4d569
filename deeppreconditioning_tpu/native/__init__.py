"""ctypes bindings to the native C++ host runtime (libdptpu.so).

The library is built from ``native/src`` on first use (``make -C
native``, g++, bound through ctypes — no pybind11); a build that fails
leaves ``available()`` false.  Every entry point has a pure-numpy
fallback — the native path is a drop-in accelerator for the host-side
precompute (conv index plans, incomplete factorizations, levelization),
mirroring how the reference rides spconv's native indice generation and
ilupp's C++ factorizations (reference test.py:81-93, model.py:27-40).

Use ``available()`` to check, ``require()`` to assert.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_LIB = None
_LIB_TRIED = False

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libdptpu.so"


def build() -> bool:
    """``make -C native`` if the library is missing or older than its
    source.  The Makefile writes to a temporary name and renames, so
    concurrent builders (test workers) never load a half-written file."""
    src = _NATIVE_DIR / "src" / "dptpu.cpp"
    if _LIB_PATH.exists() and (
            not src.exists()
            or _LIB_PATH.stat().st_mtime >= src.stat().st_mtime):
        return True
    if not src.exists():
        return False
    proc = subprocess.run(["make", "-s", "-C", str(_NATIVE_DIR)],
                          capture_output=True, text=True)
    return proc.returncode == 0 and _LIB_PATH.exists()


def _load():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if build():
        lib = ctypes.CDLL(str(_LIB_PATH))
        _configure(lib)
        _LIB = lib
    return _LIB


def _configure(lib) -> None:
    i64 = ctypes.c_int64
    i32 = ctypes.c_int32
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.dptpu_conv_plan.restype = i64
    lib.dptpu_conv_plan.argtypes = [
        i64, p_i32, p_i32, i32, i32, i32, i32, i32, i32,
        p_i32, p_i32, p_i32,
    ]
    lib.dptpu_ic0.restype = i64
    lib.dptpu_ic0.argtypes = [i64, p_i64, p_i32, p_f64]
    lib.dptpu_ict.restype = i64
    lib.dptpu_ict.argtypes = [
        i64, p_i64, p_i32, p_f64, i32, ctypes.c_double,
        p_i64, p_i32, p_f64, i64,
    ]
    lib.dptpu_levels.restype = None
    lib.dptpu_levels.argtypes = [i64, p_i64, p_i32, p_i32]
    lib.dptpu_fvm_assemble.restype = i64
    lib.dptpu_fvm_assemble.argtypes = [
        i32, i32, p_f64, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, i32, p_i32, p_i32, p_f64, p_f64,
    ]


def available() -> bool:
    return _load() is not None


def require():
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "libdptpu.so could not be built; run `make -C native`"
        )
    return lib


def conv_plan(rows: np.ndarray, cols: np.ndarray, h_in: int, w_in: int,
              kh: int, kw: int, ph: int, pw: int):
    """Native conv output-site + gather-map builder.

    Returns (out_rows, out_cols, gather[(kh*kw, nnz_out)]) with -1
    sentinels, same contract as ops.sparse_conv._build_layer_plan_np.
    """
    lib = require()
    nnz = rows.shape[0]
    cap = max(nnz * kh * kw, 1)
    out_rows = np.empty(cap, np.int32)
    out_cols = np.empty(cap, np.int32)
    gather = np.empty(kh * kw * cap, np.int32)
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    nnz_out = lib.dptpu_conv_plan(
        nnz, rows, cols, h_in, w_in, kh, kw, ph, pw,
        out_rows, out_cols, gather,
    )
    g = np.empty((kh * kw, nnz_out), np.int32)
    for k in range(kh * kw):
        g[k] = gather[k * nnz_out:(k + 1) * nnz_out]
    return out_rows[:nnz_out].copy(), out_cols[:nnz_out].copy(), g


def ic0(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray) -> int:
    """In-place IC(0) on tril CSR (diag last per row).  Returns 0 on
    success or the 1-based row of the first breakdown."""
    lib = require()
    n = indptr.shape[0] - 1
    return int(lib.dptpu_ic0(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        data,
    ))


def ict(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
        add_fill_in: int, threshold: float):
    """ICT of a full symmetric CSR matrix; returns tril CSR triple."""
    lib = require()
    n = indptr.shape[0] - 1
    nnz_a = indices.shape[0]
    capacity = nnz_a + n * (add_fill_in + 1) + n
    l_indptr = np.empty(n + 1, np.int64)
    l_indices = np.empty(capacity, np.int32)
    l_data = np.empty(capacity, np.float64)
    nnz = lib.dptpu_ict(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(data, np.float64),
        add_fill_in, threshold,
        l_indptr, l_indices, l_data, capacity,
    )
    if nnz < 0:
        raise RuntimeError("ICT capacity overflow")
    return l_indptr, l_indices[:nnz].copy(), l_data[:nnz].copy()


def levels(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Dependency levels of a tril CSR factor."""
    lib = require()
    n = indptr.shape[0] - 1
    out = np.zeros(n, np.int32)
    lib.dptpu_levels(
        n,
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        out,
    )
    return out


def fvm_assemble(ny: int, nx: int, rho: np.ndarray, dx: float,
                 dy: float, dt: float, dirichlet_top: bool):
    """Native FVM pressure-Poisson assembly; returns COO triplets +
    Dirichlet diagonal contribution (contract of
    data.fvm.assemble_pressure_poisson)."""
    lib = require()
    n = ny * nx
    cap = 5 * n
    rows = np.empty(cap, np.int32)
    cols = np.empty(cap, np.int32)
    vals = np.empty(cap, np.float64)
    diag_extra = np.empty(n, np.float64)
    nnz = lib.dptpu_fvm_assemble(
        ny, nx, np.ascontiguousarray(rho, np.float64).ravel(),
        dx, dy, dt, int(dirichlet_top), rows, cols, vals, diag_extra,
    )
    return (rows[:nnz].copy(), cols[:nnz].copy(), vals[:nnz].copy(),
            diag_extra)
