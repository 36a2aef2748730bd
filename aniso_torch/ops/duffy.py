"""Duffy-transform singular quadrature for the self-square 1/r integral.

Copy of aniso_tpu/ops/duffy.py (reference KernelFactory.cpp:863-986).
"""

from __future__ import annotations

import numpy as np

from ..core.quadrature import gauss_legendre, affine_01


def duffy_tables(deg: int, sing_rule: int, qx: np.ndarray, qy: np.ndarray):
    """Build (X, Y, W) of shape (deg^2, 8 * sing_rule^2) in local coords."""
    rule = affine_01(gauss_legendre(sing_rule))
    u = np.repeat(rule.points, sing_rule)       # (ns^2,) row-major like ref
    v = np.tile(rule.points, sing_rule)
    w = np.repeat(rule.weights, sing_rule) * np.tile(rule.weights, sing_rule)

    # Duffy collapse on the unit square: (u, v) -> (u, u v), w -> w u
    du = u
    dv = u * v
    dw = w * u

    nq = deg * deg
    ns2 = sing_rule * sing_rule
    X = np.empty((nq, 8 * ns2))
    Y = np.empty((nq, 8 * ns2))
    W = np.empty((nq, 8 * ns2))

    for k in range(nq):
        x, y = qx[k], qy[k]
        # 8 fan triangles (reference KernelFactory.cpp:948-965)
        tris = [
            (x, y, 1.0, y, 1.0, 1.0),
            (x, y, 1.0, 1.0, x, 1.0),
            (x, y, x, 1.0, -1.0, 1.0),
            (x, y, -1.0, 1.0, -1.0, y),
            (x, y, -1.0, y, -1.0, -1.0),
            (x, y, -1.0, -1.0, x, -1.0),
            (x, y, x, -1.0, 1.0, -1.0),
            (x, y, 1.0, -1.0, 1.0, y),
        ]
        for t, (p0x, p0y, p1x, p1y, p2x, p2y) in enumerate(tris):
            a11 = p1x - p0x
            a12 = p2x - p1x
            a21 = p1y - p0y
            a22 = p2y - p1y
            det = a11 * a22 - a12 * a21
            sl = slice(t * ns2, (t + 1) * ns2)
            X[k, sl] = a11 * du + a12 * dv + p0x
            Y[k, sl] = a21 * du + a22 * dv + p0y
            W[k, sl] = det * dw
    return X, Y, W
