"""Grid geometry and interpolation operators for the unit square (numpy).

Copy of aniso_tpu/core/geometry.py.  Index conventions (reference
Geometry.cpp:50-61):
  - square (i, j): i indexes x, j indexes y
  - node k = r * deg + c inside a square: x follows r, y follows c
  - fields are (sz, sz, deg^2) arrays
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .quadrature import Rule1D, gauss_legendre, tensor_rule
from .legendre import basis2d_np, basis_norms_np

DEFAULT_REFINE_LEVEL = 2  # reference Geometry.h:26


@dataclass(frozen=True)
class Grid:
    """Static discretization of the unit square.

    Attributes mirror the reference Geometry members (Geometry.h:40-62) but
    in tensor layout.
    """

    sz: int
    deg: int
    dx: float
    # 1D rule on [-1, 1]
    rule: Rule1D
    # local tensor rule, flat k = r*deg + c, shape (deg^2,)
    qx: np.ndarray
    qy: np.ndarray
    w2d: np.ndarray
    sqrt_w2d: np.ndarray
    # global node coordinates / weights, shape (sz, sz, deg^2)
    nodes_x: np.ndarray
    nodes_y: np.ndarray
    weights: np.ndarray
    # normalized Legendre projection: coeff = proj @ (w2d * values) per square,
    # shape (deg^2 basis, deg^2 points).  sigma_hat(x) = sum_nm c_nm Pt_nm(x).
    norms: np.ndarray           # (deg^2,)
    proj: np.ndarray            # (deg^2, deg^2): Pt_nm(loc_I) * w2d_I
    interpolate: np.ndarray     # reference `interpolate`: Pt_nm(loc_I)*sqrt(w2d_I)
    # refined near-field quadrature (2 quadrisection levels), shape (16*deg^2,)
    refine_x: np.ndarray
    refine_y: np.ndarray
    refine_w: np.ndarray
    # nearMapping[r, I]: coarse nodal values*sqrt(w) -> refined values*sqrt(w_r)
    near_mapping: np.ndarray    # (16*deg^2, deg^2)

    @property
    def n_squares(self) -> int:
        return self.sz * self.sz

    @property
    def nq(self) -> int:
        return self.deg * self.deg

    @property
    def n_nodes(self) -> int:
        return self.n_squares * self.nq

    @property
    def refine_nq(self) -> int:
        return self.refine_x.shape[0]

    def flat_nodes(self) -> np.ndarray:
        """(n_nodes, 2) array in reference global ordering."""
        return np.stack(
            [self.nodes_x.reshape(-1), self.nodes_y.reshape(-1)], axis=-1
        )


def make_grid(sz: int, deg: int, refine_level: int = DEFAULT_REFINE_LEVEL) -> Grid:
    """Build the Grid (reference Geometry::Geometry, Geometry.cpp:10-114)."""
    if sz < 1 or deg < 1:
        raise ValueError(f"invalid grid: sz={sz} deg={deg}")
    rule = gauss_legendre(deg)
    qx, qy, w2d = tensor_rule(rule)
    dx = 1.0 / sz

    # global nodes: x = (0.5 + i) dx + 0.5 qx dx  (Geometry.cpp:50-61)
    i_idx = np.arange(sz)
    nodes_x = (0.5 + i_idx)[:, None, None] * dx + 0.5 * qx[None, None, :] * dx
    nodes_x = np.broadcast_to(nodes_x, (sz, sz, deg * deg)).copy()
    nodes_y = (0.5 + i_idx)[None, :, None] * dx + 0.5 * qy[None, None, :] * dx
    nodes_y = np.broadcast_to(nodes_y, (sz, sz, deg * deg)).copy()
    weights = np.broadcast_to(
        w2d[None, None, :] * 0.25 * dx * dx, (sz, sz, deg * deg)
    ).copy()

    norms = basis_norms_np(deg, qx, qy, w2d)
    b = basis2d_np(deg, qx, qy)            # (deg^2, deg^2) unnormalized
    bt = b / norms[:, None]                # normalized basis at coarse points
    interpolate = bt * np.sqrt(w2d)[None, :]
    proj = bt * w2d[None, :]

    # refined quadrature: quadrisect `refine_level` times (Geometry.cpp:79-107)
    rx, ry, rw = qx.copy(), qy.copy(), w2d.copy()
    for _ in range(refine_level):
        # children in reference order (+,+), (+,-), (-,+), (-,-)
        sx = np.array([1.0, 1.0, -1.0, -1.0])
        sy = np.array([1.0, -1.0, 1.0, -1.0])
        rx = ((rx[:, None] + sx[None, :]) / 2.0).reshape(-1)
        ry = ((ry[:, None] + sy[None, :]) / 2.0).reshape(-1)
        rw = np.broadcast_to(rw[:, None] / 4.0, (rw.shape[0], 4)).reshape(-1).copy()

    # nearMapping = refinements^T @ interpolate (Geometry.cpp:109-113):
    # refinements[nm, r] = Pt_nm(refined_r) * sqrt(rw_r)
    refinements = (basis2d_np(deg, rx, ry) / norms[:, None]) * np.sqrt(rw)[None, :]
    near_mapping = refinements.T @ interpolate

    return Grid(
        sz=sz,
        deg=deg,
        dx=dx,
        rule=rule,
        qx=qx,
        qy=qy,
        w2d=w2d,
        sqrt_w2d=np.sqrt(w2d),
        nodes_x=nodes_x,
        nodes_y=nodes_y,
        weights=weights,
        norms=norms,
        proj=proj,
        interpolate=interpolate,
        refine_x=rx,
        refine_y=ry,
        refine_w=rw,
        near_mapping=near_mapping,
    )


def project_field(grid: Grid, values: np.ndarray) -> np.ndarray:
    """Per-square normalized-Legendre coefficients of a nodal field.

    values: (sz, sz, deg^2) nodal values -> (sz, sz, deg^2) coefficients.
    Matches reference KernelFactory::interpolation (KernelFactory.cpp:212-227):
    coeff = interpolate @ (sqrt(w) * values) = proj @ values... note
    interpolate includes one sqrt(w) so together it is w * values against the
    normalized basis.
    """
    return np.einsum("bq,ijq->ijb", grid.proj, values)
