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

P2M, M2M, L2L and L2T are K8 (kernels.transfer): the up pass in one or
two launches, and, once every level's T is formed, the L2L chain with the
leaf's L2T, near-field add and 1/2pi scale in one or two more.  Not
ported, deliberately: _loop_variant_zero (aniso_tpu apply.py:258), an
XLA loop-invariant-hoisting workaround that eager torch has no use for; the
dense-translate orientation branches (:341-372), one GPU layout serves all;
_row_chunk and the transient caps (:197-255, :567-574); the factored patch@W
levels of _level_E (:411-424).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.geometry import Grid
from ..kernels.m2l import m2l_translate
from ..kernels.near import near_contract
from ..kernels.offsets import offsets_translate
from ..kernels.transfer import down, up_pass
from .cheb import cheb_grid_2d, child_transfer, p2m_matrix
from .smooth import near_pair_geometry
from .structure import TreeConfig, coarsest_m2l_level, vlist_offsets


def build_fmm_static(grid: Grid, np_cheb: int, device, dtype) -> dict:
    """Static sweep operators shared by every mode and every sigma."""
    p2m = p2m_matrix(grid.qx, grid.qy, np_cheb)      # (r, nq)
    wglob = grid.w2d * 0.25 * grid.dx * grid.dx

    def t(a):       # contiguous, as K8 reads them
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return {
        "p2m_w": t(p2m * wglob[None, :]),
        "l2t": t(p2m.T),
        "m2m_1d": t(child_transfer(np_cheb)),
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


def _up_pass(static, leaf_level: int, u: torch.Tensor, stop=None) -> dict:
    """Leaf charges -> multipoles per level, {level: (m, m, r)}, from the
    leaf up to level `stop` (default: the coarsest M2L level) by K8
    (kernels.transfer); on a shard's (lx, ly) block of squares, the
    block's boxes at each level."""
    lo = coarsest_m2l_level() if stop is None else stop
    Ms = up_pass(static["p2m_w"], static["m2m_1d"], u, leaf_level - lo)
    return {leaf_level - s: M for s, M in enumerate(Ms)}


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


def _translates(static, leaf_level: int, M: dict, m2l_E: dict,
                m2l_cosr: dict, coeffs=None, translate_fn=None,
                lo=None) -> list:
    """Every level's T from level `lo` (default: the coarsest) to the leaf:
    per level K1 (a dense E tensor) or K3 (a per-offset level {'Wo'},
    re-formed from `coeffs`; aniso_tpu _level_E :411-424).  With cosr
    tables that carry a mode axis, T does too: (D, m, m, r).

    translate_fn: the translate of one shard of a domain decomposition
    (parallel.api, after aniso_tpu apply.py:524-547), called (level, E_l,
    cosr_l, M_l) with the shard's M; it returns the shard's T, or None for
    the level's own K1 / K3."""
    T = []
    for level in range(lo or coarsest_m2l_level(), leaf_level + 1):
        E_l = m2l_E[level]
        T_l = None
        if translate_fn is not None:
            T_l = translate_fn(level, E_l, m2l_cosr[level], M[level])
        if T_l is None and isinstance(E_l, dict):
            T_l = offsets_translate(E_l["Wo"], coeffs, m2l_cosr[level],
                                    M[level], static["shift"])
        elif T_l is None:
            T_l = m2l_translate(E_l, m2l_cosr[level], M[level],
                                static["shift"])
        T.append(T_l)
    return T


def _down_pass(static, leaf_level: int, M: dict, m2l_E: dict,
               m2l_cosr: dict, coeffs=None, translate_fn=None, near=None,
               start=None):
    """Every level's T (_translates) before any L2L, then K8's chain
    (kernels.transfer.down): L2L level by level with T added and, given
    `near` (K2's output), the leaf epilogue, so that the corrected matvec
    comes back; without `near`, the leaf's locals.  start: (level, L) the
    shard's locals at a level from which its chain continues (the coarser
    levels computed whole, parallel.api); T is then formed for the finer
    levels only."""
    T = _translates(static, leaf_level, M, m2l_E, m2l_cosr, coeffs,
                    translate_fn, None if start is None else start[0] + 1)
    L0, Ts = (T[0], T[1:]) if start is None else (start[1], T)
    return down(static["m2m_1d"], L0, Ts,
                None if near is None else static["l2t"], near)


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
                   translate_fn=None, near_fn=None, multipoles=None,
                   start=None):
    """Corrected mode matvec K_m u including the 1/2pi scaling.

    caches: {'near_E', 'm2l_E', 'sigma_w'[, 'coeffs']} (sigma-dependent,
    mode-independent; 'coeffs' when a level is per-offset); mode_static:
    build_mode_static's tables for Fourier mode `mode`: (sz, sz, nq) comes
    back.  The kernels' wrappers dispatch on the tables' mode axis, so
    tables stacked by stack_mode_statics (with mode = 0: slot 0 is mode 0
    and takes the diagonal) give every mode at once, (D, sz, sz, nq);
    fmm_apply_all_modes names that call.  K8 runs the up pass, then K1 /
    K3 every level's T and K2 the near field, then K8 the L2L chain and
    the leaf's L2T, near add and scale in one pass.

    One shard of a domain decomposition (parallel.api.sharded_solver, after
    aniso_tpu apply.py:684-711) passes its block u, its slices of the
    caches, its multipoles from _up_pass (`multipoles`: the sweep's up
    passes run on every shard before any down pass, so that the halos of
    a level exist when its first shard needs them), translate_fn and
    `start` (see _down_pass) and near_fn, called (caches, mode_static,
    mode, u), which returns the shard's near field or None for K2.
    """
    M = multipoles if multipoles is not None else _up_pass(
        static, leaf_level, u)
    near = near_fn(caches, mode_static, mode, u) if near_fn else None
    if near is None:
        near = _near_apply(caches, mode_static, mode, u)
    return _down_pass(static, leaf_level, M, caches["m2l_E"],
                      mode_static["m2l_cosr"], caches.get("coeffs"),
                      translate_fn, near, start)


def fmm_apply_all_modes(leaf_level, static, caches, mode_stack, u):
    """K_d u for every mode d = 0..D-1 at once: (D, sz, sz, nq).

    Counterpart of aniso_tpu fmm_apply_all_modes (:714-768): one up pass,
    per level one K1 or K3 launch for all modes, one K2 launch, and K8's
    down pass for all modes at once (a block a box and mode).  mode_stack:
    stack_mode_statics' tables, mode d at index d.
    """
    return fmm_apply_mode(leaf_level, static, caches, mode_stack, 0, u)
