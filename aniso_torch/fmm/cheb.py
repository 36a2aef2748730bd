"""Chebyshev anterpolation operators for the black-box FMM (numpy).

Copy of aniso_tpu/fmm/cheb.py (reference bbfmm.h:597-693): first-kind
Chebyshev nodes, the (np^2, nq) P2M matrix shared by every leaf and the
four (np^2, np^2) M2M transfers shared by every level.
"""

from __future__ import annotations

import numpy as np


def cheb_nodes(n: int) -> np.ndarray:
    """First-kind Chebyshev nodes on [-1, 1] (bbfmm.h:600-604)."""
    return -np.cos((np.arange(n) + 0.5) * np.pi / n)


def cheb_t_all(n: int, x: np.ndarray) -> np.ndarray:
    """T_0..T_{n-1} at x, shape (n,) + x.shape."""
    x = np.asarray(x, dtype=np.float64)
    out = np.empty((n,) + x.shape)
    out[0] = 1.0
    if n > 1:
        out[1] = x
    for m in range(2, n):
        out[m] = 2.0 * x * out[m - 1] - out[m - 2]
    return out


def interp_matrix(n: int, x: np.ndarray) -> np.ndarray:
    """S[i, k]: weight of Chebyshev node k for interpolation at x_i.

    S(x, k) = 1/n + (2/n) sum_{m=1}^{n-1} T_m(x_k) T_m(x)
    (the reference's  (2 T tNode^T - 1)/n,  bbfmm.h:639-641).
    """
    xk = cheb_nodes(n)
    tx = cheb_t_all(n, np.asarray(x))      # (n, npts)
    tk = cheb_t_all(n, xk)                 # (n, n)
    s = (2.0 * np.einsum("mp,mk->pk", tx, tk) - 1.0) / n
    return s


def p2m_matrix(qx: np.ndarray, qy: np.ndarray, n: int) -> np.ndarray:
    """(np^2, nq): leaf anterpolation from local nodes (qx, qy) in [-1,1]^2.

    Flat Chebyshev index c = a * n + b with a along x, b along y.
    """
    sx = interp_matrix(n, qx)              # (nq, n)
    sy = interp_matrix(n, qy)
    out = np.einsum("ka,kb->abk", sx, sy).reshape(n * n, -1)
    return out


def child_transfer(n: int) -> np.ndarray:
    """(2, n, n): Tc[h][i, a] = S(child_node_i_in_parent_frame, a).

    h = 0: child on [-1, 0] (nodes (cheb - 1)/2); h = 1: child on [0, 1].
    M2M: parent[a, b] += Tc[hx][i, a] Tc[hy][j, b] child[i, j];
    L2L is the transpose (bbfmm.h:635-693).
    """
    xk = cheb_nodes(n)
    return np.stack(
        [interp_matrix(n, (xk - 1.0) / 2.0), interp_matrix(n, (xk + 1.0) / 2.0)]
    )


def m2m_tensor(n: int) -> np.ndarray:
    """(2, 2, n^2, n^2): R[hx, hy][parent_c, child_c] tensor-product transfer."""
    tc = child_transfer(n)
    out = np.einsum("xia,yjb->xyabij", tc, tc)
    return out.reshape(2, 2, n * n, n * n)


def cheb_grid_2d(n: int) -> np.ndarray:
    """(n^2, 2) flat Chebyshev tensor grid on [-1,1]^2, c = a*n + b."""
    xk = cheb_nodes(n)
    gx = np.repeat(xk, n)
    gy = np.tile(xk, n)
    return np.stack([gx, gy], axis=-1)
