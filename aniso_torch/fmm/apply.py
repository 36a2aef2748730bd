"""The implicit-quadtree Chebyshev FMM matvec, in torch: one Fourier mode
of a charge (fmm_apply_mode) or all D modes of it in one sweep
(fmm_apply_all_modes).

Counterpart of aniso_tpu/fmm/apply.py:

  P2M   one (r, nq) matrix shared by every leaf (weights folded in)
  M2M   4 static (r, r) tensor-product transfers, level -> level-1
  M2L   per level: K1 (kernels.m2l), exp(-E) * cos(m theta)/r against the
        V-list multipoles, all 4 parity classes in one launch; or K3
        (kernels.offsets) at a per-offset fine level, which re-forms E from
        the coefficient field
  L2L   transpose of M2M
  L2T   transpose of P2M (no weights)

plus the U-list near field, K2 (kernels.near): expm1(-E) * cos(m theta)/r
blocks fused with the refined + Duffy correction stencil (ops.near), the
m = 0 self-node diagonal sigma_hat * w, and in compat mode the per-square
Duffy blocks.  The real kernel's own U list is omitted: the reference
subtracts those coarse 3x3 contributions right back out (nearRemoval,
KernelFactory.cpp:445-478).

The E caches and the multipoles do not depend on the mode, only the small
cos(d theta)/r tables do.  In the all-modes sweep the tables carry a leading
mode axis (stack_mode_statics), the up pass runs once, and each kernel
launch serves every mode from one read of E: the locals are one stacked
(D, m, m, r) tensor.  (The JAX package carries them as a list of D arrays
to avoid padded layouts of its device, aniso_tpu apply.py:723-729; nothing
of that applies here.)

P2M, M2M, L2L and L2T are small matmuls left to torch (kernel table K8),
batched over the mode axis.  Not ported, deliberately: _loop_variant_zero (aniso_tpu apply.py:258), an
XLA loop-invariant-hoisting workaround that eager torch has no use for; the
dense-translate orientation branches (:341-372), one GPU layout serves all;
_row_chunk and the transient caps (:197-255, :567-574); the factored patch@W
levels of _level_E (:411-424).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.geometry import Grid
from ..kernels.m2l import m2l_translate
from ..kernels.near import near_contract
from ..kernels.offsets import offsets_translate
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
    """Leaf charges -> multipoles per level: {level: (m, m, r)}; on a
    shard's (lx, ly) block of squares, the block's boxes at each level."""
    m2m = static["m2m"]
    M = {leaf_level: torch.einsum("ck,ijk->ijc", static["p2m_w"], u)}
    for level in range(leaf_level, coarsest_m2l_level(), -1):
        child = M[level]
        r = child.shape[-1]
        c4 = child.reshape(child.shape[0] // 2, 2, child.shape[1] // 2, 2, r)
        M[level - 1] = torch.einsum("hgac,xhygc->xya", m2m, c4)
    return M


def stack_mode_statics(mode_statics: list) -> dict:
    """The D modes' tables (build_mode_static, mode d at index d) stacked
    along a leading mode axis, the layout the all-modes kernels read:
    m2l_cosr {level: (D, 4, r, 27r)}, near_cosrw and near_static
    (D, nq_t, 3, 3, nq_s), duffy (D, sz, sz, nq_t, nq_s) or None."""
    first = mode_statics[0]
    return {
        "m2l_cosr": {
            level: torch.stack([ms["m2l_cosr"][level] for ms in mode_statics])
            for level in first["m2l_cosr"]
        },
        "near_cosrw": torch.stack([ms["near_cosrw"] for ms in mode_statics]),
        "near_static": torch.stack([ms["near_static"] for ms in mode_statics]),
        "duffy": None if first["duffy"] is None else torch.stack(
            [ms["duffy"] for ms in mode_statics]),
    }


def mode_view(mode_stack: dict, d: int) -> dict:
    """Mode d's tables as views of the stack (no copy)."""
    duffy = mode_stack["duffy"]
    return {
        "m2l_cosr": {lv: t[d] for lv, t in mode_stack["m2l_cosr"].items()},
        "near_cosrw": mode_stack["near_cosrw"][d],
        "near_static": mode_stack["near_static"][d],
        "duffy": None if duffy is None else duffy[d],
    }


def _down_pass(static, leaf_level: int, M: dict, m2l_E: dict,
               m2l_cosr: dict, coeffs=None, translate_fn=None) -> torch.Tensor:
    """Per level K1 (a dense E tensor) or K3 (a per-offset level {'Wo'},
    re-formed from `coeffs`; aniso_tpu _level_E :411-424), then L2L into
    the next level (one einsum).  With cosr tables that carry a mode axis
    the locals do too: (D, m, m, r).

    translate_fn: the translate of one shard of a domain decomposition
    (parallel.api, after aniso_tpu apply.py:524-547), called (level, E_l,
    cosr_l, M_l) with the shard's M; it returns the shard's T, or None for
    the level's own K1 / K3."""
    m2m = static["m2m"]
    L = None
    for level in range(coarsest_m2l_level(), leaf_level + 1):
        E_l = m2l_E[level]
        T = None
        if translate_fn is not None:
            T = translate_fn(level, E_l, m2l_cosr[level], M[level])
        if T is None and isinstance(E_l, dict):
            T = offsets_translate(E_l["Wo"], coeffs, m2l_cosr[level],
                                  M[level], static["shift"])
        elif T is None:
            T = m2l_translate(E_l, m2l_cosr[level], M[level], static["shift"])
        if L is None:
            L = T
        else:
            Lc = torch.einsum("hgac,...xya->...xhygc", m2m, L)
            L = Lc.reshape(T.shape) + T
    return L


def _near_apply(caches, mode_static, mode: int, u: torch.Tensor):
    """U-list near field by K2, with the m = 0 diagonal sigma_hat * w * u
    (reference KernelFactory.cpp:260) and the compat Duffy term fused.
    mode_static is one mode's tables (`mode` says which) or, with mode 0, a
    stack whose slot 0 is mode 0."""
    return near_contract(
        caches["near_E"], mode_static["near_cosrw"],
        mode_static["near_static"], u,
        sigma_w=caches["sigma_w"] if mode == 0 else None,
        duffy=mode_static["duffy"],
    )


def fmm_apply_mode(leaf_level, static, caches, mode_static, mode, u,
                   translate_fn=None, near_fn=None, multipoles=None):
    """Corrected mode matvec K_m u including the 1/2pi scaling.

    caches: {'near_E', 'm2l_E', 'sigma_w'[, 'coeffs']} (sigma-dependent,
    mode-independent; 'coeffs' when a level is per-offset); mode_static:
    build_mode_static's tables for Fourier mode `mode`: (sz, sz, nq) comes
    back.  The kernels' wrappers dispatch on the tables' mode axis, so
    tables stacked by stack_mode_statics (with mode = 0: slot 0 is mode 0
    and takes the diagonal) give every mode at once, (D, sz, sz, nq);
    fmm_apply_all_modes names that call.

    One shard of a domain decomposition (parallel.api.sharded_solver, after
    aniso_tpu apply.py:684-711) passes its block u, its slices of the
    caches, its multipoles from _up_pass (`multipoles`: the sweep's up
    passes run on every shard before any down pass, so that the halos of
    a level exist when its first shard needs them), translate_fn (see
    _down_pass) and near_fn, called (caches, mode_static, mode, u), which
    returns the shard's near field or None for K2.
    """
    M = multipoles if multipoles is not None else _up_pass(
        static, leaf_level, u)
    L = _down_pass(static, leaf_level, M, caches["m2l_E"],
                   mode_static["m2l_cosr"], caches.get("coeffs"),
                   translate_fn)
    far = torch.einsum("kc,...ijc->...ijk", static["l2t"], L)
    near = near_fn(caches, mode_static, mode, u) if near_fn else None
    if near is None:
        near = _near_apply(caches, mode_static, mode, u)
    return (far + near) / (2.0 * math.pi)


def fmm_apply_all_modes(leaf_level, static, caches, mode_stack, u):
    """K_d u for every mode d = 0..D-1 at once: (D, sz, sz, nq).

    Counterpart of aniso_tpu fmm_apply_all_modes (:714-768): one up pass,
    per level one K1 or K3 launch for all modes, L2L and L2T batched over
    the mode axis, one K2 launch.  mode_stack: stack_mode_statics' tables,
    mode d at index d.
    """
    return fmm_apply_mode(leaf_level, static, caches, mode_stack, 0, u)
