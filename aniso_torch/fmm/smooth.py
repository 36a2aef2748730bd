"""Sigma-dependent attenuation caches (E) of the FMM operator.

Counterpart of aniso_tpu/fmm/smooth.py.  The caches hold the attenuation
line integrals E, which do not depend on the Fourier mode; the per-mode
factors cos(m theta)/r are small static tables folded in at apply time
(exp(-E) cos/r in M2L, expm1(-E) cos/r in the near field).

E is a fixed linear map of the sigma_t Legendre coefficient field with
static, sigma-independent segment-quadrature weights (ops.segment_stencil):

  * near pairs and the dense fine M2L levels (box size B in {1, 2}
    squares): numpy weight tables (lru-cached, grid-size independent)
    contracted with coefficient windows by torch on the device;
  * per-offset fine levels ({'Wo'}): only the static weight block of each
    canonical (class, offset) entry is stored; K3 (kernels.offsets)
    re-forms E from coefficient windows inside the matvec.  A fine level
    takes this form when it does not fit the dense budget, and every fine
    level of the f64 refinement twin does;
  * coarse M2L levels (B >= 4): f64, per-offset GEMMs on the device where
    boxes are many (K6, build_m2l_E_coarse_device), exact per-pair
    integrals on the host engine (native.py) where they are few;
  * the host f64 refinement twin (refine_twin="host"): near E and every
    M2L level dense, built in numpy on the host (build_near_E_np,
    build_m2l_E_fine_np, the per-offset host GEMMs of
    _coarse_dgemm_level_np or the host engine's per-pair integrals;
    build_m2l_E_host), as the JAX package builds its host twin.

Layouts are the GPU kernels' own (kernels.m2l, kernels.near,
kernels.offsets): near E (sz, sz, nq_t, 3, 3, nq_s) and every dense M2L
level (4, m2, m2, r, 27r), contiguous.  Not ported, deliberately: the TPU
tile-orientation switches (y-minor / row / flat, aniso_tpu smooth.py:
288-342), the factored patch@W fine levels, the v5e upload caps of the
device coarse build (_COARSE_DEVICE_MAX_W_LEVEL_BYTES) and the ANISO_*
knobs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.geometry import Grid, make_grid
from ..ops.segment_stencil import near_pair_weights, segment_weights
from ..ops.windows import patch_3x3
from .cheb import cheb_grid_2d
from .structure import TreeConfig, coarsest_m2l_level, vlist_offsets


# ---------------------------------------------------------------------------
# Static (sigma-independent) weight tables -- numpy f64, copies of aniso_tpu
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def near_weights_np(deg: int) -> np.ndarray:
    """(3,3,nq,nq,3,3,nq) static E weights for the 3x3 near node pairs.

    Grid-size independent (cell units); any sz works for the grid used here.
    """
    return near_pair_weights(make_grid(4, deg))


@functools.lru_cache(maxsize=None)
def _fine_W_flat_np(deg: int, np_cheb: int, B: int):
    """(4, Q, P) factored-layout weight operator in CELL units, f64: Q in
    the (q, a, b) order of patch_for_level, P in the (a, o, b) pair order."""
    W = fine_m2l_weights_np(deg, np_cheb, B)
    nq = deg * deg
    PX = 7 * B
    return np.ascontiguousarray(
        W.transpose(0, 4, 2, 3, 1).reshape(4, nq * PX * PX, -1)
    )


@functools.lru_cache(maxsize=None)
def fine_m2l_weights_np(deg: int, np_cheb: int, B: int) -> np.ndarray:
    """(4, r*27*r, 7B, 7B, nq) static E weights for fine-level M2L pairs.

    Class order c = 2*px + py; every parity class has exactly 27 V-list
    offsets.  Weights are relative to the target box corner with the common
    patch covering cells [-3B, 4B) per axis; grid-size independent.

    The pair axis is ordered (a, o, b) -- target point major, offset,
    source point minor -- matching the E-cache layout.
    """
    g = make_grid(4, deg)  # only deg-dependent tables are used
    r = np_cheb * np_cheb
    cheb = (cheb_grid_2d(np_cheb) + 1.0) / 2.0 * B
    PX = 7 * B
    out = np.empty((4, 27 * r * r, PX, PX, deg * deg))
    for px in (0, 1):
        for py in (0, 1):
            offs = vlist_offsets(px, py)
            p0 = np.empty((len(offs), r, r, 2))
            p1 = np.empty((len(offs), r, r, 2))
            for oi, (di, dj) in enumerate(offs):
                src = cheb[None, :, :] + np.array([di * B, dj * B])
                p0[oi] = np.broadcast_to(src, (r, r, 2))
                p1[oi] = np.broadcast_to(cheb[:, None, :], (r, r, 2))
            out[2 * px + py] = segment_weights(
                g,
                p0.reshape(-1, 2),
                p1.reshape(-1, 2),
                patch_lo=np.array([-3 * B, -3 * B]),
                patch_shape=(PX, PX),
            )
    # reorder pairs (o, a, b) -> (a, o, b) to match the cache layout
    perm = (
        np.arange(27 * r * r).reshape(27, r, r).transpose(1, 0, 2).reshape(-1)
    )
    return out[:, perm]


def near_pair_geometry(grid: Grid):
    """Static physical (dx_vec, dy_vec, r) for near pairs (3,3,nq_t,nq_s)."""
    dx = grid.dx
    tx = 0.5 * dx + 0.5 * grid.qx * dx
    ty = 0.5 * dx + 0.5 * grid.qy * dx
    offs = np.array([-1.0, 0.0, 1.0])
    sx = (0.5 + offs)[:, None] * dx + 0.5 * grid.qx[None, :] * dx  # (3, nq)
    sy = (0.5 + offs)[:, None] * dx + 0.5 * grid.qy[None, :] * dx
    dxv = sx[:, None, None, :] - tx[None, None, :, None]   # (3,1,nq_t,nq_s)
    dxv = np.broadcast_to(dxv, (3, 3, grid.nq, grid.nq))
    dyv = sy[None, :, None, :] - ty[None, None, :, None]
    dyv = np.broadcast_to(dyv, (3, 3, grid.nq, grid.nq))
    r = np.sqrt(dxv ** 2 + dyv ** 2)
    return dxv, dyv, r


@functools.lru_cache(maxsize=None)
def coarse_mirror_table(np_cheb: int) -> tuple:
    """Per (class, offset): the line-integral symmetry E(a->b) = E(b->a).

    Entry (c, o) with absolute offset d pairs with entry (c', o') where the
    roles of target and source box swap: c' is the parity class of I + d,
    o' indexes -d in c''s V list, and the paired box plane is shifted by
    (sx, sy) = ((p + d - p') / 2) per axis (always in {-1, 0, 1}).  The
    pairing is a fixed-point-free involution, so computing only the
    lexicographically-canonical half of the blocks and transposing the
    (a, b) point axes into the mirror halves the integral count.

    Returns tuple of (c, o, canonical, c2, o2, sx, sy)."""
    out = []
    for px in (0, 1):
        for py in (0, 1):
            c = 2 * px + py
            offs = vlist_offsets(px, py)
            for o, (di, dj) in enumerate(offs):
                qx, qy = (px + di) & 1, (py + dj) & 1
                c2 = 2 * qx + qy
                o2 = vlist_offsets(qx, qy).index((-di, -dj))
                sx = (px + di - qx) // 2
                sy = (py + dj - qy) // 2
                canonical = (di, dj) > (-di, -dj)
                out.append((c, o, canonical, c2, o2, sx, sy))
    return tuple(out)


def mirror_fill_coarse(E6) -> None:
    """Fill non-canonical (class, offset) blocks of E6 (4, m2, m2, 27, r, r)
    in place from their canonical mirrors (transposed point axes, shifted
    box plane).  Entries whose mirror source falls off the plane are
    zeroed: their multipoles are zero in the V-list gather, so their E
    value is never observable.  E6 is a numpy array or a torch tensor."""
    m2 = E6.shape[1]
    r = E6.shape[-1]
    for (c, o, canonical, c2, o2, sx, sy) in coarse_mirror_table(
        int(np.sqrt(r))
    ):
        if not canonical:
            continue
        xd = slice(max(0, sx), m2 + min(0, sx))
        yd = slice(max(0, sy), m2 + min(0, sy))
        xs = slice(max(0, -sx), m2 + min(0, -sx))
        ys = slice(max(0, -sy), m2 + min(0, -sy))
        E6[c2, :, :, o2] = 0
        E6[c2, xd, yd, o2] = E6[c, xs, ys, o].swapaxes(-1, -2)


@functools.lru_cache(maxsize=None)
def _fine_offset_entries(np_cheb: int):
    """Canonical per-offset plan shared by the per-offset fine levels, K3
    and the device coarse build (copy of aniso_tpu smooth.py:358-378):
    (entries, keys, mirrors) with entries = ((c, o, px, py, di, dj, ki),
    ...) over canonical (class, offset) blocks, keys = the distinct
    physical offsets (di, dj) in weight-block order (the weight geometry
    drops the parity class), and mirrors[(c, o)] = (c2, o2, sx, sy) from
    coarse_mirror_table."""
    entries = []
    keys = []
    mirrors = {}
    for (c, o, canonical, c2, o2, sx, sy) in coarse_mirror_table(np_cheb):
        if not canonical:
            continue
        px, py = c >> 1, c & 1
        di, dj = vlist_offsets(px, py)[o]
        if (di, dj) not in keys:
            keys.append((di, dj))
        entries.append((c, o, px, py, di, dj, keys.index((di, dj))))
        mirrors[(c, o)] = (c2, o2, sx, sy)
    return tuple(entries), tuple(keys), mirrors


# per-offset dgemm coarse levels: cap on one (class, offset) weight block
# (r^2 pairs x bounding-box cells x nq, f64); beyond it the per-pair engine
# takes over (few boxes there)
_COARSE_DGEMM_MAX_W_BLOCK_BYTES = 400 * 1024 * 1024


@functools.lru_cache(maxsize=None)
def _coarse_offset_weight_cached(
    deg: int, np_cheb: int, B: int, di: int, dj: int
):
    """Static E weights for ONE V-list offset at box size B.

    Pairs (a, b) = (target cheb, source cheb); the patch is the bounding
    box of the two boxes ((|di|+1)B x (|dj|+1)B cells).  Returns
    (W, ox0, oy0) with W: (r*r, bbx, bby, nq), origin relative to the
    target box corner in cell units.  Sigma-independent and keyed without
    the parity class (the geometry depends only on (di, dj))."""
    g = make_grid(4, deg)
    r = np_cheb * np_cheb
    cheb = (cheb_grid_2d(np_cheb) + 1.0) / 2.0 * B
    ox0, oy0 = min(0, di * B), min(0, dj * B)
    bbx, bby = (abs(di) + 1) * B, (abs(dj) + 1) * B
    p1 = np.broadcast_to(cheb[:, None, :], (r, r, 2)).reshape(-1, 2)
    src = cheb[None, :, :] + np.array([di * B, dj * B])
    p0 = np.broadcast_to(src, (r, r, 2)).reshape(-1, 2)
    W = segment_weights(
        g, p0, p1, patch_lo=np.array([ox0, oy0]), patch_shape=(bbx, bby)
    )
    return W, ox0, oy0


def _coarse_dgemm_eligible(grid: Grid, tcfg: TreeConfig, level: int,
                           np_cheb: int) -> bool:
    """The per-offset-weights restructuring pays off when boxes are many
    and the weight blocks bounded; otherwise the per-pair engine runs."""
    B = tcfg.box_size_squares(level)
    r = np_cheb * np_cheb
    m2 = tcfg.boxes(level) // 2
    w_block_bytes = r * r * (4 * B) * (4 * B) * grid.nq * 8
    return w_block_bytes <= _COARSE_DGEMM_MAX_W_BLOCK_BYTES and m2 >= 8


def coarse_m2l_levels(tcfg: TreeConfig) -> list:
    return [
        lv for lv in range(coarsest_m2l_level(), tcfg.leaf_level + 1)
        if tcfg.box_size_squares(lv) > 2
    ]


# ---------------------------------------------------------------------------
# Coarse levels (B >= 4): f64, on the device (K6) or the host engine
# ---------------------------------------------------------------------------


def pad_coeffs(coeffs: torch.Tensor, B: int) -> torch.Tensor:
    """The coefficient field zero-padded by 3B cells below and 4B above
    (every V-list bounding box of a level with box size B stays inside)."""
    sz, nq = coeffs.shape[0], coeffs.shape[-1]
    pad = coeffs.new_zeros((sz + 7 * B, sz + 7 * B, nq))
    pad[3 * B:3 * B + sz, 3 * B:3 * B + sz] = coeffs
    return pad


def box_windows(pad: torch.Tensor, B: int, m2: int, px: int, py: int,
                di: int, dj: int) -> torch.Tensor:
    """(m2, m2, K) bounding-box windows of one (class, offset) entry, K =
    bbx * bby * nq in (a, b, q) order: box (x, y) of class (px, py) gets
    cells [px B + min(0, di B) + 2Bx, + (|di|+1) B) x [...] of the field
    (pad = pad_coeffs(coeffs, B)), taken as B-granular strided box-plane
    slices (aniso_tpu _coarse_device_level_fn :686-706,
    _offsets_translate_impl :483-496)."""
    nq = pad.shape[-1]
    LX = pad.shape[0] // B
    pb = pad.reshape(LX, B, LX, B, nq)
    ux = px + min(0, di) + 3
    uy = py + min(0, dj) + 3
    rows = torch.cat(
        [pb[ux + s:ux + s + 2 * m2:2] for s in range(abs(di) + 1)], dim=1
    )                                       # (m2, bbx, LX, B, nq)
    win = torch.cat(
        [rows[:, :, uy + s:uy + s + 2 * m2:2] for s in range(abs(dj) + 1)],
        dim=3,
    )                                       # (m2, bbx, m2, bby, nq)
    return win.permute(0, 2, 1, 3, 4).reshape(m2, m2, -1)


# static f64 weight blocks of the device coarse build, resident on their
# device for the process: {(deg, np_cheb, B, di, dj, device): (r*r, K)}
_DEVICE_W_CACHE: dict = {}


def _coarse_offset_weight_device(deg: int, np_cheb: int, B: int, di: int,
                                 dj: int, device) -> torch.Tensor:
    """(r*r, K) f64 weight block of one offset on `device`, made once per
    process and kept there across set_coeff calls (the host table is not
    kept: at 512^2 the B = 32 level alone holds 3.2 GB of them)."""
    key = (deg, np_cheb, B, di, dj, str(device))
    W = _DEVICE_W_CACHE.get(key)
    if W is None:
        Wnp = _coarse_offset_weight_cached.__wrapped__(deg, np_cheb, B, di, dj)[0]
        W = torch.as_tensor(
            Wnp.reshape(Wnp.shape[0], -1), dtype=torch.float64, device=device
        )
        _DEVICE_W_CACHE[key] = W
    return W


def build_m2l_E_coarse_device(grid: Grid, tcfg: TreeConfig, level: int,
                              np_cheb: int, coeffs: torch.Tensor
                              ) -> torch.Tensor:
    """f64 E (4, m2, m2, r, 27r) in K1's layout at a dgemm-eligible coarse
    level, on coeffs' device: K6 (aniso_tpu _coarse_device_level_fn
    :661-733 and build_m2l_E_coarse_device :736-770).

    Per canonical (class, offset) entry one (m2^2, K) @ (K, r^2) f64 GEMM
    of B-granular box windows against the resident static weight block,
    then the mirror fill E(a->b) = E(b->a) and the (a, o, b) assembly.
    These are plain large GEMMs outside any kernel, left to torch.matmul
    as JAX left them to XLA."""
    B = tcfg.box_size_squares(level)
    m2 = tcfg.boxes(level) // 2
    r = np_cheb * np_cheb
    pad = pad_coeffs(coeffs.to(torch.float64), B)
    entries, _, _ = _fine_offset_entries(np_cheb)
    E6 = pad.new_empty((4, m2, m2, 27, r, r))
    for (c, o, px, py, di, dj, _) in entries:
        W = _coarse_offset_weight_device(grid.deg, np_cheb, B, di, dj,
                                         pad.device)
        win = box_windows(pad, B, m2, px, py, di, dj)
        E6[c, :, :, o] = (win.reshape(m2 * m2, -1) @ W.T).reshape(m2, m2, r, r)
    mirror_fill_coarse(E6)
    E6.mul_(grid.dx)
    return E6.permute(0, 1, 2, 4, 3, 5).reshape(4, m2, m2, r, 27 * r)


def _coarse_perpair_level_np(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs_np: np.ndarray, canonical_only: bool = True,
) -> np.ndarray:
    """(4, m2, m2, r*27*r) f64 E at a coarse level from exact per-pair line
    integrals on the host engine (native.attenuation_batch); with
    canonical_only, the mirror pass fills the other half."""
    from .. import native

    B = tcfg.box_size_squares(level)
    r = np_cheb * np_cheb
    dx = grid.dx
    cheb = (cheb_grid_2d(np_cheb) + 1.0) / 2.0 * B    # cell units in box
    m2 = tcfg.boxes(level) // 2
    canon = {
        (c, o): canonical
        for (c, o, canonical, *_rest) in coarse_mirror_table(np_cheb)
    }
    coeffs_np = np.asarray(coeffs_np, np.float64)
    E_out = np.empty((4, m2, m2, 27, r, r), dtype=np.float64)
    for px in (0, 1):
        for py in (0, 1):
            offs = vlist_offsets(px, py)
            I2 = np.arange(m2)
            bx = ((2 * I2 + px) * B)[:, None]
            by = ((2 * I2 + py) * B)[None, :]
            for oi, (di, dj) in enumerate(offs):
                if canonical_only and not canon[(2 * px + py, oi)]:
                    continue
                src_rel = cheb[None, :, :] + np.array([di * B, dj * B])
                tgt_rel = cheb[:, None, :]
                tgt = np.empty((m2, m2, r, r, 2))
                src = np.empty((m2, m2, r, r, 2))
                tgt[..., 0] = (bx[:, :, None, None] + tgt_rel[None, None, :, :, 0]) * dx
                tgt[..., 1] = (by[:, :, None, None] + tgt_rel[None, None, :, :, 1]) * dx
                src[..., 0] = (bx[:, :, None, None] + src_rel[None, None, :, :, 0]) * dx
                src[..., 1] = (by[:, :, None, None] + src_rel[None, None, :, :, 1]) * dx
                Es = native.attenuation_batch(
                    grid, coeffs_np, src.reshape(-1, 2), tgt.reshape(-1, 2)
                )
                E_out[2 * px + py, :, :, oi] = Es.reshape(m2, m2, r, r)
    if canonical_only:
        mirror_fill_coarse(E_out)
    return E_out.transpose(0, 1, 2, 4, 3, 5).reshape(4, m2, m2, -1)


# ---------------------------------------------------------------------------
# Host (numpy / BLAS) builders: the f64 twin of refine_twin="host"
# ---------------------------------------------------------------------------


def build_near_E_np(grid: Grid, coeffs_np: np.ndarray) -> np.ndarray:
    """Host twin of build_near_E, f64, in K2's layout (sz, sz, nq_t, 3, 3,
    nq_s) (aniso_tpu build_near_E_np, :425-435, which stores it (3, 3,
    nq_t, nq_s, sz, sz)): one einsum of the static weights with the 3x3
    coefficient windows."""
    W = near_weights_np(grid.deg)
    pad = np.pad(np.asarray(coeffs_np, np.float64), ((1, 1), (1, 1), (0, 0)))
    win = np.lib.stride_tricks.sliding_window_view(pad, (3, 3), axis=(0, 1))
    # win[i, j, q, c, d] = pad[i + c, j + d, q]
    E = np.einsum("abtscdq,ijqcd->ijtabs", W, win, optimize=True)
    return np.ascontiguousarray(E * grid.dx)


def build_m2l_E_fine_np(grid: Grid, tcfg: TreeConfig, level: int,
                        np_cheb: int, coeffs_np: np.ndarray) -> np.ndarray:
    """Host twin of build_m2l_E_fine, f64, (4, m2, m2, r, 27r) in K1's
    layout (aniso_tpu build_m2l_E_fine_np, :438-464): per class, the
    (7B, 7B) coefficient windows at stride 2B contracted with the fine
    weights of fine_m2l_weights_np."""
    B = tcfg.box_size_squares(level)
    m2 = tcfg.boxes(level) // 2
    r = np_cheb * np_cheb
    PX = 7 * B
    W = fine_m2l_weights_np(grid.deg, np_cheb, B)
    pad = np.pad(
        np.asarray(coeffs_np, np.float64),
        ((3 * B, 4 * B), (3 * B, 4 * B), (0, 0)),
    )
    ext = 2 * m2 * B + 5 * B
    out = np.empty((4, m2, m2, W.shape[1]))
    for px in (0, 1):
        for py in (0, 1):
            sl = pad[px * B:px * B + ext, py * B:py * B + ext]
            win = np.lib.stride_tricks.sliding_window_view(
                sl, (PX, PX), axis=(0, 1)
            )[::2 * B, ::2 * B]
            # win[x, y, q, a, b] = sl[2Bx + a, 2By + b, q]
            out[2 * px + py] = np.einsum(
                "pabq,xyqab->xyp", W[2 * px + py], win, optimize=True
            )
    return (out * grid.dx).reshape(4, m2, m2, r, 27 * r)


def _coarse_dgemm_level_np(grid: Grid, tcfg: TreeConfig, level: int,
                           np_cheb: int, coeffs_np: np.ndarray) -> np.ndarray:
    """(4, m2, m2, 27, r, r) f64 E at a dgemm-eligible coarse level on the
    host (aniso_tpu _coarse_dgemm_level_np, :610-645): the per-offset
    static weights against B-granular coefficient windows, one host GEMM a
    canonical (class, offset) entry, then the mirror fill.  The same
    quadrature as the per-pair engine and as K6."""
    B = tcfg.box_size_squares(level)
    r = np_cheb * np_cheb
    m2 = tcfg.boxes(level) // 2
    pad = np.pad(np.asarray(coeffs_np, np.float64),
                 ((3 * B, 4 * B), (3 * B, 4 * B), (0, 0)))
    E6 = np.empty((4, m2, m2, 27, r, r), dtype=np.float64)
    for (c, o, canonical, _, _, _, _) in coarse_mirror_table(np_cheb):
        if not canonical:
            continue
        px, py = c >> 1, c & 1
        di, dj = vlist_offsets(px, py)[o]
        W, ox0, oy0 = _coarse_offset_weight_cached(grid.deg, np_cheb, B,
                                                   di, dj)
        bbx, bby = W.shape[1], W.shape[2]
        x0 = px * B + ox0 + 3 * B
        y0 = py * B + oy0 + 3 * B
        sl = pad[x0:x0 + 2 * B * (m2 - 1) + bbx,
                 y0:y0 + 2 * B * (m2 - 1) + bby]
        win = np.lib.stride_tricks.sliding_window_view(
            sl, (bbx, bby), axis=(0, 1)
        )[::2 * B, ::2 * B]
        # win[x, y, q, a, b] = sl[2Bx + a, 2By + b, q]
        E6[c, :, :, o] = np.einsum(
            "pabq,xyqab->xyp", W, win, optimize=True
        ).reshape(m2, m2, r, r)
    mirror_fill_coarse(E6)
    return E6 * grid.dx


def build_m2l_E_coarse_oracle_np(grid: Grid, tcfg: TreeConfig, level: int,
                                 np_cheb: int,
                                 coeffs_np: np.ndarray) -> np.ndarray:
    """f64 (4, m2, m2, r*27*r) E at a coarse level from exact per-pair line
    integrals of every (class, offset) entry on the host engine, no mirror
    fill (aniso_tpu build_m2l_E_coarse_oracle_np, :773-790): the oracle of
    the coarse builders."""
    return _coarse_perpair_level_np(grid, tcfg, level, np_cheb, coeffs_np,
                                    canonical_only=False)


def build_m2l_E_coarse_np(grid: Grid, tcfg: TreeConfig, level: int,
                          np_cheb: int, coeffs_np: np.ndarray) -> np.ndarray:
    """f64 (4, m2, m2, r*27*r) E at a coarse level, on the host
    (aniso_tpu build_m2l_E_coarse_np, :864-887): the per-offset host GEMMs
    where boxes are many (_coarse_dgemm_level_np), else the host engine's
    per-pair integrals on the canonical half and the mirror fill."""
    if _coarse_dgemm_eligible(grid, tcfg, level, np_cheb):
        m2 = tcfg.boxes(level) // 2
        E6 = _coarse_dgemm_level_np(grid, tcfg, level, np_cheb, coeffs_np)
        return E6.transpose(0, 1, 2, 4, 3, 5).reshape(4, m2, m2, -1)
    return _coarse_perpair_level_np(grid, tcfg, level, np_cheb, coeffs_np)


def build_m2l_E_coarse_all_np(grid: Grid, tcfg: TreeConfig, np_cheb: int,
                              coeffs_np: np.ndarray) -> dict:
    """f64 E of every coarse level on the host, {level: (4, m2, m2,
    r*27*r)} (aniso_tpu build_m2l_E_coarse_all_np, :978-988): the host
    twin's, which the fast path casts onto its device."""
    return {lv: build_m2l_E_coarse_np(grid, tcfg, lv, np_cheb, coeffs_np)
            for lv in coarse_m2l_levels(tcfg)}


def build_m2l_E_host(grid: Grid, tcfg: TreeConfig, np_cheb: int,
                     coeffs_np: np.ndarray, coarse_np=None) -> dict:
    """The host twin's M2L cache: every level dense, f64, {level: CPU
    tensor (4, m2, m2, r, 27r)} in K1's layout (aniso_tpu
    build_m2l_E_host, :1125-1146): fine levels by build_m2l_E_fine_np,
    coarse levels by build_m2l_E_coarse_np or, shared with the fast path,
    from coarse_np (build_m2l_E_coarse_all_np's)."""
    r = np_cheb * np_cheb
    cache = {}
    for level in range(coarsest_m2l_level(), tcfg.leaf_level + 1):
        m2 = tcfg.boxes(level) // 2
        if tcfg.box_size_squares(level) <= 2:
            E = build_m2l_E_fine_np(grid, tcfg, level, np_cheb, coeffs_np)
        elif coarse_np and level in coarse_np:
            E = coarse_np[level]
        else:
            E = build_m2l_E_coarse_np(grid, tcfg, level, np_cheb, coeffs_np)
        cache[level] = torch.as_tensor(E, dtype=torch.float64).reshape(
            4, m2, m2, r, 27 * r)
    return cache


def build_m2l_E_coarse_all(grid: Grid, tcfg: TreeConfig, np_cheb: int,
                           coeffs_np: np.ndarray, device) -> dict:
    """f64 E for every coarse level on `device`, {level: (4, m2, m2, r,
    27r)}, shared by the f32 cache (a cast) and the f64 twin (as it is)
    (aniso_tpu build_m2l_E_coarse_all :991-1036): dgemm-eligible levels by
    K6 on the device, queued first so that the host's per-pair levels (a
    handful of boxes, native engine) overlap them."""
    coeffs = torch.as_tensor(coeffs_np, dtype=torch.float64, device=device)
    r = np_cheb * np_cheb
    levels = coarse_m2l_levels(tcfg)
    out = {
        lv: build_m2l_E_coarse_device(grid, tcfg, lv, np_cheb, coeffs)
        for lv in levels if _coarse_dgemm_eligible(grid, tcfg, lv, np_cheb)
    }
    for lv in levels:
        if lv not in out:
            m2 = tcfg.boxes(lv) // 2
            out[lv] = torch.as_tensor(
                _coarse_perpair_level_np(grid, tcfg, lv, np_cheb, coeffs_np),
                device=device,
            ).reshape(4, m2, m2, r, 27 * r)
    return out


# ---------------------------------------------------------------------------
# Device caches
# ---------------------------------------------------------------------------


def build_near_E(grid: Grid, coeffs: torch.Tensor) -> torch.Tensor:
    """Near-pair E in K2's layout (sz, sz, nq_t, 3, 3, nq_s), physical
    units, in coeffs' dtype and device (aniso_tpu build_near_E, :166)."""
    W = torch.as_tensor(
        near_weights_np(grid.deg) * grid.dx, dtype=coeffs.dtype,
        device=coeffs.device,
    )
    return near_E_from_weights(W, coeffs)


def near_E_from_weights(W: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Near E from the (3, 3, nq, nq, 3, 3, nq) weights of near_weights_np
    with grid.dx folded in: one GEMM of the 3x3 coefficient windows
    (sz^2, 9 nq) against the weights permuted to (nq_t, 3, 3, nq_s | 3, 3,
    nq)."""
    sz, nq = coeffs.shape[0], coeffs.shape[-1]
    Wp = W.permute(2, 0, 1, 3, 4, 5, 6).reshape(9 * nq * nq, 9 * nq)
    win = patch_3x3(coeffs).reshape(sz * sz, 9 * nq)
    return torch.matmul(win, Wp.T).reshape(sz, sz, nq, 3, 3, nq)


def patch_for_level(coeffs: torch.Tensor, level: int) -> torch.Tensor:
    """(4, m2, m2, Q) per-box coefficient patches at a fine level, Q in the
    (q, a, b) order of _fine_W_flat_np (aniso_tpu patch_for_level, :210).

    The patch of box (x, y) in class (px, py) covers cells
    [px*B + 2Bx - 3B, px*B + 2Bx + 4B) per axis: a (7B, 7B) window at
    stride 2B of the field zero-padded by 3B - px*B below."""
    sz, nq = coeffs.shape[0], coeffs.shape[-1]
    B = sz >> level
    m2 = (1 << level) // 2
    PX = 7 * B
    pad = coeffs.new_zeros((sz + 8 * B, sz + 8 * B, nq))
    pad[3 * B:3 * B + sz, 3 * B:3 * B + sz] = coeffs
    patches = []
    for px in (0, 1):
        for py in (0, 1):
            # box 0's window starts at cell px*B - 3B: pad index px*B
            sub = pad[px * B:, py * B:]
            w = sub.unfold(0, PX, 2 * B).unfold(1, PX, 2 * B)[:m2, :m2]
            patches.append(w.reshape(m2, m2, nq * PX * PX))  # (q, a, b)
    return torch.stack(patches)


def build_m2l_E_fine(grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
                     coeffs: torch.Tensor) -> torch.Tensor:
    """Dense fine-level E (B in {1, 2}) in K1's layout (4, m2, m2, r, 27r):
    one (m2^2, Q) @ (Q, P) GEMM per class (aniso_tpu _fine_E_build_jit,
    :256; a plain large GEMM, left to torch.matmul as JAX left it to XLA)."""
    B = tcfg.box_size_squares(level)
    m2 = tcfg.boxes(level) // 2
    r = np_cheb * np_cheb
    W = torch.as_tensor(
        _fine_W_flat_np(grid.deg, np_cheb, B),
        dtype=coeffs.dtype, device=coeffs.device,
    )
    patch = patch_for_level(coeffs, level)
    E = torch.empty((4, m2 * m2, W.shape[-1]), dtype=coeffs.dtype,
                    device=coeffs.device)
    for c in range(4):
        torch.matmul(patch[c].reshape(m2 * m2, -1), W[c], out=E[c])
    E.mul_(grid.dx)
    return E.reshape(4, m2, m2, r, 27 * r)


def build_m2l_offsets_fine(grid: Grid, tcfg: TreeConfig, level: int,
                           np_cheb: int, dtype, device) -> dict:
    """Per-offset form of a fine level, {'Wo': flat tensor} (aniso_tpu
    build_m2l_offsets_fine, :381-422): the static weight block of each
    distinct canonical offset (_coarse_offset_weight_cached, grid.dx folded
    in), stored in K3's layout, (K, r*r) per offset back to back in
    _fine_offset_entries' key order (kernels.offsets).  A few MB instead of
    GBs of dense E; K3 re-forms E inside the matvec from the coefficient
    field, which the caller stores beside the cache as caches['coeffs']."""
    _, keys, _ = _fine_offset_entries(np_cheb)
    B = tcfg.box_size_squares(level)
    r2 = (np_cheb * np_cheb) ** 2
    blocks = [
        (_coarse_offset_weight_cached(grid.deg, np_cheb, B, di, dj)[0]
         * grid.dx).reshape(r2, -1).T.ravel()
        for (di, dj) in keys
    ]
    return {"Wo": torch.as_tensor(np.concatenate(blocks), dtype=dtype,
                                  device=device)}


# headroom kept free next to the dense E levels for the build transients
# (the fine W operator, the patches) and the apply's temporaries
_DEVICE_HEADROOM_BYTES = 2 * 1024 ** 3


def dense_budget_bytes(device: torch.device):
    """Bytes the dense fine M2L E levels may take (None on the CPU: no
    budget): the device memory not in use (free, plus what torch's
    allocator holds unused) less a fixed headroom.  Whatever is resident
    when it is called (the f64 twin, the near E, the coarse levels and
    their weights) is already out of the free memory it reads."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    idle = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(
        device)
    return free + idle - _DEVICE_HEADROOM_BYTES


def build_m2l_E(grid: Grid, tcfg: TreeConfig, np_cheb: int,
                coeffs: torch.Tensor, coarse: dict,
                budget_bytes=None) -> dict:
    """Per-level M2L E cache in coeffs' dtype and device (aniso_tpu
    build_m2l_E, :1039-1122): dense levels (4, m2, m2, r, 27r) and
    per-offset fine levels {'Wo'} (build_m2l_offsets_fine).  coarse holds
    the f64 coarse levels (build_m2l_E_coarse_all); a dtype or device that
    differs from theirs takes a cast, f64 on their device shares them.

    Coarse levels are always dense (they are resident already, in f64).
    Fine levels are allocated coarsest-first against budget_bytes, the
    bytes their dense E may take in the port's unpadded layout (None: no
    limit); a fine level that does not fit takes the per-offset form.
    Coarsest-first is also the right order: a per-offset level costs the
    same re-form operations at any depth, so the budget goes to the levels
    that are cheapest in bytes."""
    r = np_cheb * np_cheb
    itemsize = coeffs.element_size()
    cache = {}
    spent = 0
    for level in range(coarsest_m2l_level(), tcfg.leaf_level + 1):
        m2 = tcfg.boxes(level) // 2
        nbytes = 4 * m2 * m2 * r * 27 * r * itemsize
        if tcfg.box_size_squares(level) > 2:
            cache[level] = torch.as_tensor(
                coarse[level], dtype=coeffs.dtype, device=coeffs.device
            ).reshape(4, m2, m2, r, 27 * r)
        elif budget_bytes is not None and spent + nbytes > budget_bytes:
            cache[level] = build_m2l_offsets_fine(
                grid, tcfg, level, np_cheb, coeffs.dtype, coeffs.device
            )
        else:
            spent += nbytes
            cache[level] = build_m2l_E_fine(grid, tcfg, level, np_cheb, coeffs)
    return cache


def per_offset_levels(cache: dict) -> list:
    """The levels of an M2L cache held in the per-offset form."""
    return [lv for lv, v in cache.items() if isinstance(v, dict)]


def m2l_cache_bytes(cache: dict) -> int:
    """Bytes of the per-level tensors (contiguous, unpadded): dense E, or
    the weight blocks of a per-offset level."""
    return sum(
        t.numel() * t.element_size()
        for t in (v["Wo"] if isinstance(v, dict) else v
                  for v in cache.values())
    )
