"""Static segment-quadrature weights: attenuation E as a linear map (numpy).

Copy of aniso_tpu/ops/segment_stencil.py.  For the structured pair families
the solver needs (3x3 near node pairs, M2L Chebyshev pairs at fixed box
offsets) the exact piecewise Gauss quadrature of E(p, q) is

    E = sum_{cells c, basis b} W[pair, c, b] * coeff[cell c, b]

with static weights W against a patch of per-cell Legendre coefficients.
"""

from __future__ import annotations

import numpy as np

from ..core.geometry import Grid
from ..core.legendre import basis2d_np


def segment_weights(
    grid: Grid,
    p0: np.ndarray,
    p1: np.ndarray,
    patch_lo: np.ndarray,
    patch_shape: tuple[int, int],
) -> np.ndarray:
    """Static quadrature weights for E along segments p0 -> p1.

    p0, p1: (npair, 2) endpoints in *cell units* relative to the grid of
      cells (cell (a, b) spans [a, a+1] x [b, b+1]).  May be negative or
      exceed the patch; contributions are accumulated into the patch cells
      (caller guarantees segments stay inside the patch).
    patch_lo: (2,) integer lower corner of the patch in cell units.
    patch_shape: (PX, PY) patch extent in cells.

    Returns W: (npair, PX, PY, nq) with
      E_pair = dx * sum_{cx, cy, b} W[pair, cx, cy, b] * coeff[cx, cy, b]
    where coeff are the normalized-Legendre per-cell coefficients and dx is
    the physical cell width (grid.dx).
    """
    deg = grid.deg
    gpts = grid.rule.points
    gwts = grid.rule.weights
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    npair = p0.shape[0]
    PX, PY = patch_shape
    W = np.zeros((npair, PX, PY, deg * deg))

    d = p1 - p0
    # crossing parameters per axis (integer gridlines in cell units)
    ts_list = []
    for ax in range(2):
        lo = np.minimum(p0[:, ax], p1[:, ax])
        hi = np.maximum(p0[:, ax], p1[:, ax])
        i_lo = np.floor(lo)
        i_hi = np.floor(hi)
        kmax = int(np.max(i_hi - i_lo)) if npair else 0
        kmax = max(kmax, 0)
        m = np.arange(kmax)[None, :]
        denom = d[:, ax][:, None]
        ks = np.where(denom >= 0, i_lo[:, None] + 1 + m, i_hi[:, None] - m)
        safe = np.where(denom == 0, 1.0, denom)
        t = (ks - p0[:, ax][:, None]) / safe
        ncross = np.clip(i_hi - i_lo, 0, kmax)[:, None]
        valid = (np.arange(kmax)[None, :] < ncross) & (denom != 0)
        ts_list.append(np.where(valid, np.clip(t, 0.0, 1.0), 1.0))

    ts = np.concatenate(
        [np.zeros((npair, 1)), ts_list[0], ts_list[1], np.ones((npair, 1))],
        axis=1,
    )
    ts = np.sort(ts, axis=1)
    ta, tb = ts[:, :-1], ts[:, 1:]            # (npair, nseg)
    tm = 0.5 * (ta + tb)
    half = 0.5 * (tb - ta)
    seg_len = np.linalg.norm(d, axis=1)[:, None] * (tb - ta)  # cell units

    # cell of each sub-segment midpoint
    xm = p0[:, 0][:, None] + tm * d[:, 0][:, None]
    ym = p0[:, 1][:, None] + tm * d[:, 1][:, None]
    cx = np.floor(xm).astype(int) - int(patch_lo[0])
    cy = np.floor(ym).astype(int) - int(patch_lo[1])
    keep = (seg_len > 0)
    cx = np.clip(cx, 0, PX - 1)
    cy = np.clip(cy, 0, PY - 1)

    # Gauss samples in local cell coordinates
    for g in range(len(gpts)):
        tg = tm + half * gpts[g]
        xg = p0[:, 0][:, None] + tg * d[:, 0][:, None]
        yg = p0[:, 1][:, None] + tg * d[:, 1][:, None]
        ex = 2.0 * (xg - (cx + patch_lo[0])) - 1.0
        ey = 2.0 * (yg - (cy + patch_lo[1])) - 1.0
        basis = basis2d_np(deg, ex, ey) / grid.norms[:, None, None]
        w = gwts[g] * seg_len / 2.0 * keep     # (npair, nseg)
        contrib = basis * w[None, :, :]        # (nq, npair, nseg)
        # accumulate into W[pair, cx, cy, :]
        np.add.at(
            W,
            (np.arange(npair)[:, None], cx, cy),
            np.moveaxis(contrib, 0, -1),
        )
    return W


def near_pair_weights(grid: Grid):
    """Static E-stencil for all 3x3 near-field node pairs.

    Pairs: (di, dj, kt, ks) -- target node kt in the centre square, source
    node ks in the square at offset (di, dj) in {-1,0,1}^2.  Patch: the 3x3
    squares.  Returns W with shape (3, 3, nq, nq, 3, 3, nq_basis):
      E[sq, di, dj, kt, ks] = dx * einsum(W[di,dj,kt,ks], patch_coeffs[sq])
    """
    nq = grid.nq
    # node local coords in cell units within the centre cell: (q + 1) / 2
    tx = (grid.qx + 1.0) / 2.0
    ty = (grid.qy + 1.0) / 2.0
    offs = (-1, 0, 1)
    p0 = np.empty((3, 3, nq, nq, 2))
    p1 = np.empty((3, 3, nq, nq, 2))
    for a, di in enumerate(offs):
        for b, dj in enumerate(offs):
            for kt in range(nq):
                for ks in range(nq):
                    p1[a, b, kt, ks] = (tx[kt], ty[kt])          # target
                    p0[a, b, kt, ks] = (di + tx[ks], dj + ty[ks])  # source
    W = segment_weights(
        grid,
        p0.reshape(-1, 2),
        p1.reshape(-1, 2),
        patch_lo=np.array([-1, -1]),
        patch_shape=(3, 3),
    )
    return W.reshape(3, 3, nq, nq, 3, 3, nq)
