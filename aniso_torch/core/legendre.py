"""Legendre polynomials and the normalized 2D tensor basis (numpy, f64).

The numpy functions of aniso_tpu/core/legendre.py, copied (the original
module imports jax.numpy).  Flat 2D index nm = n * deg + k with P_n along x
and P_k along y (reference Geometry.cpp:131-137).
"""

from __future__ import annotations

import numpy as np


def legendre_all_np(deg: int, x: np.ndarray) -> np.ndarray:
    """P_0..P_{deg-1} at x (numpy, float64). Returns shape (deg,) + x.shape."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty((deg,) + x.shape, dtype=np.float64)
    out[0] = 1.0
    if deg > 1:
        out[1] = x
    for n in range(2, deg):
        out[n] = ((2 * n - 1) * x * out[n - 1] - (n - 1) * out[n - 2]) / n
    return out


def basis2d_np(deg: int, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    px = legendre_all_np(deg, np.asarray(x))
    py = legendre_all_np(deg, np.asarray(y))
    b = px[:, None] * py[None, :]
    return b.reshape((deg * deg,) + b.shape[2:])


def basis_norms_np(deg: int, qx: np.ndarray, qy: np.ndarray, w2d: np.ndarray) -> np.ndarray:
    """Quadrature-measured norms of the 2D basis rows.

    Matches reference Geometry.cpp:140-147: norm_nm = sqrt(sum_I B_nm(I)^2 w_I).
    Analytically equal to 2/sqrt((2n+1)(2k+1)) for an exact rule.
    """
    b = basis2d_np(deg, qx, qy)  # (deg^2, nq)
    return np.sqrt(np.sum(b * b * w2d[None, :], axis=1))
