"""Global-basis compat mode as a per-square coefficient transform (numpy).

The numpy branch of aniso_tpu/ops/compat.py, copied.  The reference
evaluates its local Legendre expansions with the basis at global
coordinates (KernelFactory.cpp:180-205); restricted to one square that is a
polynomial of the local coordinate, so the quirk is an exact per-square
coefficient transform and everything downstream stays translation
invariant.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..core.geometry import Grid
from ..core.legendre import legendre_all_np
from ..core.quadrature import gauss_legendre


@lru_cache(maxsize=None)
def _axis_transforms(sz: int, deg: int) -> np.ndarray:
    """T[i, n, a]: P_n(global x) = sum_a T[i, n, a] P_a(local x) on square i.

    Global coordinate on square i: x = (i + (xl + 1) / 2) / sz.  Projection
    onto P_a with the orthogonality relation, integrated exactly by a
    deg-point Gauss rule (integrand degree <= 2(deg-1)).
    """
    rule = gauss_legendre(deg)
    xl = rule.points                      # (deg,)
    w = rule.weights
    pl = legendre_all_np(deg, xl)         # (deg_a, deg_pts) local basis
    out = np.empty((sz, deg, deg))
    for i in range(sz):
        xg = (i + (xl + 1.0) / 2.0) / sz
        pg = legendre_all_np(deg, xg)     # (deg_n, deg_pts) global basis
        # T[n, a] = (2a+1)/2 * sum_g w_g P_n(xg_g) P_a(xl_g)
        scale = (2.0 * np.arange(deg) + 1.0) / 2.0
        out[i] = np.einsum("ng,ag,g->na", pg, pl, w) * scale[None, :]
    return out


def to_local_equivalent(grid: Grid, coeffs: np.ndarray) -> np.ndarray:
    """Per-square coefficients c~ such that local-basis evaluation of c~
    equals global-basis evaluation of `coeffs` (the reference quirk).

    coeffs: (sz, sz, deg^2) normalized-Legendre coefficients (numpy).
    """
    sz, deg = grid.sz, grid.deg
    T = _axis_transforms(sz, deg)                       # (sz, deg, deg)
    norms = grid.norms.reshape(deg, deg)                # (deg_a, deg_b)
    c = np.asarray(coeffs).reshape(sz, sz, deg, deg)
    # c~[i,j,a,b] = norms[a,b] * sum_nk c[i,j,n,k]/norms[n,k] T[i,n,a] T[j,k,b]
    cn = c / norms[None, None]
    out = np.einsum("ijnk,ina,jkb->ijab", cn, T, T)
    return (out * norms[None, None]).reshape(sz, sz, deg * deg)
