"""The implicit-quadtree Chebyshev FMM matvec of one Fourier mode, in torch.

Counterpart of aniso_tpu/fmm/apply.py for a single mode:

  P2M   one (r, nq) matrix shared by every leaf (weights folded in)
  M2M   4 static (r, r) tensor-product transfers, level -> level-1
  M2L   per level: K1 (kernels.m2l), exp(-E) * cos(m theta)/r against the
        V-list multipoles, all 4 parity classes in one launch
  L2L   transpose of M2M
  L2T   transpose of P2M (no weights)

plus the U-list near field, K2 (kernels.near): expm1(-E) * cos(m theta)/r
blocks fused with the refined + Duffy correction stencil (ops.near), the
m = 0 self-node diagonal sigma_hat * w, and in compat mode the per-square
Duffy blocks.  The real kernel's own U list is omitted: the reference
subtracts those coarse 3x3 contributions right back out (nearRemoval,
KernelFactory.cpp:445-478).

P2M, M2M, L2L and L2T are small matmuls left to torch (kernel table K8).
Not ported, deliberately: _loop_variant_zero (aniso_tpu apply.py:258), an
XLA loop-invariant-hoisting workaround that eager torch has no use for; the
dense-translate orientation branches (:341-372), one GPU layout serves all;
_row_chunk and the transient caps (:197-255, :567-574).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.geometry import Grid
from ..kernels.m2l import m2l_translate
from ..kernels.near import near_contract
from .cheb import cheb_grid_2d, m2m_tensor, p2m_matrix
from .smooth import near_pair_geometry
from .structure import TreeConfig, coarsest_m2l_level, vlist_offsets


def build_fmm_static(grid: Grid, np_cheb: int, device, dtype) -> dict:
    """Static sweep operators shared by every mode and every sigma."""
    p2m = p2m_matrix(grid.qx, grid.qy, np_cheb)      # (r, nq)
    wglob = grid.w2d * 0.25 * grid.dx * grid.dx
    return {
        "p2m_w": torch.as_tensor(p2m * wglob[None, :], dtype=dtype, device=device),
        "l2t": torch.as_tensor(p2m.T, dtype=dtype, device=device),
        "m2m": torch.as_tensor(m2m_tensor(np_cheb), dtype=dtype, device=device),
        "shift": torch.as_tensor(
            parity_shift_table_np(), dtype=torch.int32, device=device
        ),
    }


@functools.lru_cache(maxsize=None)
def m2l_pair_geometry_np(np_cheb: int):
    """Static V-list pair geometry in *box units*: (rr, ang), each
    (4, 27, r, r) with class order c = 2*px + py.

    Scale invariance: physical distance = rr * B * dx, angle unchanged, so
    one table serves every level (multiply rr by B * dx at use sites).
    """
    r = np_cheb * np_cheb
    cheb = (cheb_grid_2d(np_cheb) + 1.0) / 2.0       # box units [0, 1]
    rr = np.empty((4, 27, r, r))
    ang = np.empty((4, 27, r, r))
    for px in (0, 1):
        for py in (0, 1):
            for oi, (di, dj) in enumerate(vlist_offsets(px, py)):
                src = cheb[None, :, :] + np.array([di, dj])
                tgt = cheb[:, None, :]
                d = src - tgt                         # (r, r, 2)
                rr[2 * px + py, oi] = np.hypot(d[..., 0], d[..., 1])
                ang[2 * px + py, oi] = np.arctan2(d[..., 1], d[..., 0])
    return rr, ang


def build_mode_static(grid: Grid, tcfg: TreeConfig, np_cheb: int, mode: int,
                      stencil: np.ndarray, duffy, device, dtype) -> dict:
    """Per-mode static tables in the kernels' layouts.

    m2l_cosr: {level: (4, r, 27r)} = cos(m ang) / r_phys in (a, o, b) order;
    near_cosrw: (nq_t, 3, 3, nq_s) = cos(m ang) / r * w_src (0 at r = 0);
    near_static: (nq_t, 3, 3, nq_s) refined + Duffy stencil (ops.near);
    duffy: (sz, sz, nq_t, nq_s) per-square Duffy blocks (compat mode) or
    None.
    """
    rr, ang = m2l_pair_geometry_np(np_cheb)
    r = np_cheb * np_cheb
    cosr = {}
    for level in range(coarsest_m2l_level(), tcfg.leaf_level + 1):
        B = tcfg.box_size_squares(level)
        tab = np.cos(mode * ang) / (rr * B * grid.dx)   # (4, 27, r, r)
        cosr[level] = torch.as_tensor(
            tab.transpose(0, 2, 1, 3).reshape(4, r, 27 * r),
            dtype=dtype, device=device,
        )
    dxv, dyv, rn = near_pair_geometry(grid)
    wsrc = grid.w2d * 0.25 * grid.dx * grid.dx        # (nq_s,)
    safe = np.where(rn == 0.0, 1.0, rn)
    ncos = np.where(
        rn == 0.0, 0.0, np.cos(mode * np.arctan2(dyv, dxv)) / safe
    ) * wsrc

    def near_layout(a):       # (3, 3, nq_t, nq_s) -> (nq_t, 3, 3, nq_s)
        return torch.as_tensor(
            np.ascontiguousarray(np.transpose(a, (2, 0, 1, 3))),
            dtype=dtype, device=device,
        )

    return {
        "m2l_cosr": cosr,
        "near_cosrw": near_layout(ncos),
        "near_static": near_layout(stencil),
        "duffy": None if duffy is None else torch.as_tensor(
            duffy, dtype=dtype, device=device
        ),
    }


@functools.lru_cache(maxsize=None)
def parity_shift_table_np() -> np.ndarray:
    """(4, 27, 4) int: per class c = 2px+py and V offset o, the source
    parity plane and its box-grid shift: (sx, sy, shx+1, shy+1).

    Source box 2x+px+di has absolute axis index a = px+di in [-2, 3], i.e.
    parity sx = a mod 2 on the coarse (m/2, m/2) plane shifted by
    shx = (a - sx)/2 in {-1, 0, 1}: every V-list source is at most ONE box
    away on its parity plane.
    """
    out = np.empty((4, 27, 4), dtype=np.int64)
    for px in (0, 1):
        for py in (0, 1):
            for o, (di, dj) in enumerate(vlist_offsets(px, py)):
                ax, ay = px + di, py + dj
                sx, sy = ax & 1, ay & 1
                out[2 * px + py, o] = (
                    sx, sy, (ax - sx) // 2 + 1, (ay - sy) // 2 + 1
                )
    return out


def _up_pass(static, leaf_level: int, u: torch.Tensor) -> dict:
    """Leaf charges -> multipoles per level: {level: (m, m, r)}."""
    m2m = static["m2m"]
    M = {leaf_level: torch.einsum("ck,ijk->ijc", static["p2m_w"], u)}
    for level in range(leaf_level, coarsest_m2l_level(), -1):
        child = M[level]
        m2 = child.shape[0] // 2
        r = child.shape[-1]
        c4 = child.reshape(m2, 2, m2, 2, r)
        M[level - 1] = torch.einsum("hgac,xhygc->xya", m2m, c4)
    return M


def _down_pass(static, leaf_level: int, M: dict, m2l_E: dict,
               m2l_cosr: dict) -> torch.Tensor:
    """K1 per level, then L2L into the next level (one einsum)."""
    m2m = static["m2m"]
    L = None
    for level in range(coarsest_m2l_level(), leaf_level + 1):
        T = m2l_translate(m2l_E[level], m2l_cosr[level], M[level],
                          static["shift"])
        if L is None:
            L = T
        else:
            m2, r = L.shape[0], L.shape[-1]
            Lc = torch.einsum("hgac,xya->xhygc", m2m, L)
            L = Lc.reshape(2 * m2, 2 * m2, r) + T
    return L


def _near_apply(caches, mode_static, mode: int, u: torch.Tensor):
    """U-list near field by K2, with the m = 0 diagonal sigma_hat * w * u
    (reference KernelFactory.cpp:260) and the compat Duffy term fused."""
    return near_contract(
        caches["near_E"], mode_static["near_cosrw"],
        mode_static["near_static"], u,
        sigma_w=caches["sigma_w"] if mode == 0 else None,
        duffy=mode_static["duffy"],
    )


def fmm_apply_mode(leaf_level, static, caches, mode_static, mode, u):
    """Corrected mode matvec K_m u including the 1/2pi scaling.

    caches: {'near_E', 'm2l_E', 'sigma_w'} (sigma-dependent,
    mode-independent); mode_static: build_mode_static's tables.
    """
    M = _up_pass(static, leaf_level, u)
    L = _down_pass(static, leaf_level, M, caches["m2l_E"],
                   mode_static["m2l_cosr"])
    far = torch.einsum("kc,ijc->ijk", static["l2t"], L)
    near = _near_apply(caches, mode_static, mode, u)
    return (far + near) / (2.0 * math.pi)
