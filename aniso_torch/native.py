"""ctypes binding to the port's host engine (csrc/aniso_host.cpp).

attenuation_batch is the counterpart of aniso_tpu/native/__init__.py:105:
exact attenuation integrals along point pairs, f64, OpenMP.  The library is
built from the port's own copy of the source on first use (_build.py); a
missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import _build

_lock = threading.Lock()
_lib = None

_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path = _build.build([_build.HOST_SOURCE])[_build.HOST_SOURCE]
            lib = ctypes.CDLL(path)
            lib.aniso_attenuation_batch.argtypes = [
                ctypes.c_int, ctypes.c_int, _f64p, _f64p, _f64p, _f64p,
                ctypes.c_int, _f64p, _f64p, ctypes.c_long, _f64p,
            ]
            lib.aniso_attenuation_batch.restype = None
            _lib = lib
        return _lib


def attenuation_batch(grid, coeffs, p0, p1,
                      compat_global_basis: bool = False) -> np.ndarray:
    """E along each p0[k] -> p1[k] (physical coords), exact quadrature;
    float64 (n,)."""
    lib = _load()
    gx = np.ascontiguousarray(grid.rule.points, dtype=np.float64)
    gw = np.ascontiguousarray(grid.rule.weights, dtype=np.float64)
    norms = np.ascontiguousarray(grid.norms, dtype=np.float64)
    c = np.ascontiguousarray(
        np.asarray(coeffs, dtype=np.float64).reshape(grid.sz * grid.sz, grid.nq)
    )
    p0 = np.ascontiguousarray(np.asarray(p0, np.float64).reshape(-1, 2))
    p1 = np.ascontiguousarray(np.asarray(p1, np.float64).reshape(-1, 2))
    if p0.shape != p1.shape:
        raise ValueError(f"p0 {p0.shape} and p1 {p1.shape} differ")
    n = p0.shape[0]
    out = np.empty(n, dtype=np.float64)
    lib.aniso_attenuation_batch(
        grid.sz, grid.deg, gx, gw, norms, c,
        int(compat_global_basis), p0, p1, n, out,
    )
    return out
