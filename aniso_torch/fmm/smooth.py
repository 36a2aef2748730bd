"""Sigma-dependent attenuation caches (E) of the FMM operator.

Counterpart of aniso_tpu/fmm/smooth.py for the main path.  The caches hold
the attenuation line integrals E, which do not depend on the Fourier mode;
the per-mode factors cos(m theta)/r are small static tables folded in at
apply time (exp(-E) cos/r in M2L, expm1(-E) cos/r in the near field).

E is a fixed linear map of the sigma_t Legendre coefficient field with
static, sigma-independent segment-quadrature weights (ops.segment_stencil):

  * near pairs and the fine M2L levels (box size B in {1, 2} squares):
    numpy weight tables (lru-cached, grid-size independent) contracted with
    coefficient windows by torch on the device;
  * coarse M2L levels (B >= 4): f64 on the host, per-offset dgemm where
    boxes are many, exact per-pair integrals on the host engine (native.py)
    where they are few.

Layouts are the GPU kernels' own (kernels.m2l, kernels.near): near E
(sz, sz, nq_t, 3, 3, nq_s) and every M2L level (4, m2, m2, r, 27r),
contiguous.  Not ported, deliberately: the TPU tile-orientation switches
(y-minor / row / flat, aniso_tpu smooth.py:288-342), the factored and
per-offset fine levels (a fine level that does not fit the dense budget
raises; the per-offset form comes with slice 2), the device f64 coarse
build and the ANISO_* knobs.
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


def mirror_fill_coarse(E6: np.ndarray) -> None:
    """Fill non-canonical (class, offset) blocks of E6 (4, m2, m2, 27, r, r)
    in place from their canonical mirrors (transposed point axes, shifted
    box plane).  Entries whose mirror source falls off the plane are
    zeroed: their multipoles are zero in the V-list gather, so their E
    value is never observable."""
    m2 = E6.shape[1]
    r = E6.shape[-1]
    for (c, o, canonical, c2, o2, sx, sy) in coarse_mirror_table(
        int(np.sqrt(r))
    ):
        if not canonical:
            continue
        blk = E6[c, :, :, o]                      # (m2, m2, r, r)
        dst = np.zeros_like(blk)
        xd = slice(max(0, sx), m2 + min(0, sx))
        yd = slice(max(0, sy), m2 + min(0, sy))
        xs = slice(max(0, -sx), m2 + min(0, -sx))
        ys = slice(max(0, -sy), m2 + min(0, -sy))
        dst[xd, yd] = blk[xs, ys].transpose(0, 1, 3, 2)
        E6[c2, :, :, o2] = dst


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
# Coarse levels: f64 on the host
# ---------------------------------------------------------------------------


def _coarse_dgemm_level_np(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs_np: np.ndarray,
) -> np.ndarray:
    """(4, m2, m2, 27, r, r) f64 E at a coarse level via per-offset static
    weights x sliding coefficient windows (host BLAS dgemm): the same
    piecewise-Gauss quadrature as the per-pair engine, as 54 canonical
    (class, offset) matmuls + the mirror pass."""
    B = tcfg.box_size_squares(level)
    r = np_cheb * np_cheb
    m2 = tcfg.boxes(level) // 2
    cf = np.asarray(coeffs_np, np.float64)
    pad = np.pad(cf, ((3 * B, 4 * B), (3 * B, 4 * B), (0, 0)))
    E6 = np.empty((4, m2, m2, 27, r, r), dtype=np.float64)
    for (c, o, canonical, _, _, _, _) in coarse_mirror_table(np_cheb):
        if not canonical:
            continue
        px, py = c >> 1, c & 1
        di, dj = vlist_offsets(px, py)[o]
        W, ox0, oy0 = _coarse_offset_weight_cached(
            grid.deg, np_cheb, B, di, dj
        )
        bbx, bby = W.shape[1], W.shape[2]
        x0 = px * B + ox0 + 3 * B
        y0 = py * B + oy0 + 3 * B
        sl = pad[x0 : x0 + 2 * B * (m2 - 1) + bbx,
                 y0 : y0 + 2 * B * (m2 - 1) + bby]
        win = np.lib.stride_tricks.sliding_window_view(
            sl, (bbx, bby), axis=(0, 1)
        )[:: 2 * B, :: 2 * B]
        # win[x, y, q, a, b] = sl[2Bx + a, 2By + b, q]
        E6[c, :, :, o] = np.einsum(
            "pabq,xyqab->xyp", W, win, optimize=True
        ).reshape(m2, m2, r, r)
    mirror_fill_coarse(E6)
    return E6 * grid.dx


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


def build_m2l_E_coarse_np(
    grid: Grid, tcfg: TreeConfig, level: int, np_cheb: int,
    coeffs_np: np.ndarray,
) -> np.ndarray:
    """f64 (4, m2, m2, r*27*r) E at a coarse level (B >= 4): per-offset
    dgemm where eligible, else the canonical per-pair engine + mirror."""
    if _coarse_dgemm_eligible(grid, tcfg, level, np_cheb):
        E6 = _coarse_dgemm_level_np(grid, tcfg, level, np_cheb, coeffs_np)
        m2 = tcfg.boxes(level) // 2
        return E6.transpose(0, 1, 2, 4, 3, 5).reshape(4, m2, m2, -1)
    return _coarse_perpair_level_np(
        grid, tcfg, level, np_cheb, coeffs_np, canonical_only=True
    )


def build_m2l_E_coarse_all_np(
    grid: Grid, tcfg: TreeConfig, np_cheb: int, coeffs_np: np.ndarray,
) -> dict:
    """f64 host E for every coarse level: {level: (4, m2, m2, r*27*r)}."""
    return {
        lv: build_m2l_E_coarse_np(grid, tcfg, lv, np_cheb, coeffs_np)
        for lv in coarse_m2l_levels(tcfg)
    }


# ---------------------------------------------------------------------------
# Device caches
# ---------------------------------------------------------------------------


def build_near_E(grid: Grid, coeffs: torch.Tensor) -> torch.Tensor:
    """Near-pair E in K2's layout (sz, sz, nq_t, 3, 3, nq_s), physical
    units, in coeffs' dtype and device (aniso_tpu build_near_E, :166).

    One GEMM: the 3x3 coefficient windows (sz^2, 9 nq) against the static
    weights permuted to (nq_t, 3, 3, nq_s | 3, 3, nq)."""
    sz, nq = coeffs.shape[0], coeffs.shape[-1]
    W = torch.as_tensor(
        near_weights_np(grid.deg), dtype=coeffs.dtype, device=coeffs.device
    )
    Wp = W.permute(2, 0, 1, 3, 4, 5, 6).reshape(9 * nq * nq, 9 * nq)
    win = patch_3x3(coeffs).reshape(sz * sz, 9 * nq)
    E = torch.matmul(win, Wp.T) * grid.dx
    return E.reshape(sz, sz, nq, 3, 3, nq)


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


# headroom kept free next to the dense E levels for the build transients
# (the fine W operator, the patches), the Krylov basis and the apply's
# temporaries
_DEVICE_HEADROOM_BYTES = 2 * 1024 ** 3


def dense_budget_bytes(device: torch.device):
    """Bytes the M2L E cache may take: the device's free memory less a
    fixed headroom (None on the CPU: no budget)."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return free - _DEVICE_HEADROOM_BYTES


def build_m2l_E(grid: Grid, tcfg: TreeConfig, np_cheb: int,
                coeffs: torch.Tensor, coarse_np: dict,
                budget_bytes=None) -> dict:
    """Per-level M2L E cache {level: (4, m2, m2, r, 27r)}, all dense, in
    coeffs' dtype and device (aniso_tpu build_m2l_E, :1039).  coarse_np
    holds the f64 host coarse levels (build_m2l_E_coarse_all_np).

    Levels are allocated coarsest-first against budget_bytes; a fine level
    that does not fit raises: its per-offset recompute form is slice 2's
    (ROADMAP queue A item 10)."""
    r = np_cheb * np_cheb
    itemsize = coeffs.element_size()
    cache = {}
    spent = 0
    for level in range(coarsest_m2l_level(), tcfg.leaf_level + 1):
        m2 = tcfg.boxes(level) // 2
        nbytes = 4 * m2 * m2 * r * 27 * r * itemsize
        if budget_bytes is not None and spent + nbytes > budget_bytes:
            raise NotImplementedError(
                f"m2l E level {level} ({nbytes / 1e9:.2f} GB dense) does not "
                f"fit the dense budget ({budget_bytes / 1e9:.2f} GB, "
                f"{spent / 1e9:.2f} GB spent): the per-offset fine-level "
                "form is ported in slice 2"
            )
        spent += nbytes
        if tcfg.box_size_squares(level) <= 2:
            cache[level] = build_m2l_E_fine(grid, tcfg, level, np_cheb, coeffs)
        else:
            cache[level] = torch.as_tensor(
                coarse_np[level], dtype=coeffs.dtype, device=coeffs.device
            ).reshape(4, m2, m2, r, 27 * r)
    return cache


def m2l_cache_bytes(cache: dict) -> int:
    """Bytes of the per-level E tensors (contiguous, unpadded)."""
    return sum(t.numel() * t.element_size() for t in cache.values())
