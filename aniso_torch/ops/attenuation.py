"""Exact attenuation line integrals E(p, q) = int_seg sigma_t (torch): the
plain version of K7.

Counterpart of aniso_tpu/ops/attenuation.py.  The reference splits each
segment at its grid-line crossings and integrates every piece with the
per-cell Gauss rule on the per-square normalized Legendre expansion of
sigma_t (KernelFactory.cpp:67-190).  The JAX form, transcribed here over a
batch of pairs, is branch-free:

  1. the crossings of each axis as parameters t in [0, 1], ascending,
     padded with t = 1 to a static count `max_cross` (_crossings);
  2. the breakpoints [0, merge(tx, ty), 1] (_merge_breakpoints);
  3. per sub-segment the cell from its midpoint and the deg-point Gauss rule
     (exact: the integrand restricted to a cell is a polynomial of degree
     <= 2(deg-1) in t); zero-length sub-segments contribute exactly 0;
  4. with n_pieces > 1 the segment is cut into equal parameter pieces whose
     integrals add up (E is additive along the segment).

Callers guarantee n_pieces * max_cross >= the crossings per axis: a pair
of the unit square crosses at most sz lines per axis, so (sz, 1) always
holds, and pads the fewest sub-segments (JAX's dense builds take (8,
ceil(sz / 6)) above sz = 8 to bound its compile time).  The pairs are taken
in chunks so that the temporaries stay under ~256 MB.

line_integral_batch is the entry point: CPU tensors compute here, CUDA
tensors go to the K7 kernel (kernels.attenuation), which walks the
crossings exactly and needs no bounds.

compat_global_basis evaluates the basis at global [0, 1] coordinates, the
reference quirk (KernelFactory.cpp:180-205); the default evaluates at local
[-1, 1] cell coordinates.
"""

from __future__ import annotations

import torch

from ..core.geometry import Grid

# elements of the largest temporaries per chunk of pairs (doubles: 256 MB)
_CHUNK_ELEMENTS = 1 << 25


def legendre_all(deg: int, x: torch.Tensor) -> torch.Tensor:
    """P_0..P_{deg-1} at x: shape (deg,) + x.shape (the recurrence of
    aniso_tpu/core/legendre.py:legendre_all)."""
    outs = [torch.ones_like(x)]
    if deg > 1:
        outs.append(x)
    for n in range(2, deg):
        outs.append(((2 * n - 1) * x * outs[n - 1]
                     - (n - 1) * outs[n - 2]) / n)
    return torch.stack(outs)


def _cell(v: torch.Tensor, sz: int) -> torch.Tensor:
    return torch.clamp(torch.floor(v * sz).long(), 0, sz - 1)


def make_sigma_eval(grid: Grid, compat_global_basis: bool = False):
    """Returns sigma_eval(coeffs, x, y) evaluating the per-square expansion.

    coeffs: (sz, sz, deg^2) normalized-Legendre coefficients; x, y: equal
    shapes."""
    sz, deg = grid.sz, grid.deg

    def sigma_eval(coeffs, x, y):
        norms = torch.as_tensor(grid.norms, dtype=x.dtype, device=x.device)
        i = _cell(x, sz)
        j = _cell(y, sz)
        if compat_global_basis:
            ex, ey = x, y
        else:
            ex = 2.0 * (x * sz - i) - 1.0
            ey = 2.0 * (y * sz - j) - 1.0
        px = legendre_all(deg, ex)
        py = legendre_all(deg, ey)
        basis = (px[:, None] * py[None, :]).reshape((deg * deg,) + x.shape)
        basis = basis / norms.reshape((deg * deg,) + (1,) * x.dim())
        c = coeffs.reshape(sz * sz, deg * deg)[i * sz + j]
        return torch.einsum("q...,...q->...", basis, c)

    return sigma_eval


def _crossings(a0: torch.Tensor, a1: torch.Tensor, sz: int,
               kmax: int) -> torch.Tensor:
    """(P,) coordinates of the endpoints -> (P, kmax) parameters t of the
    crossings with the lines a = k/sz, ascending (the lines are walked in
    the direction of travel), padded with 1."""
    lo = torch.minimum(a0, a1)
    hi = torch.maximum(a0, a1)
    i_lo = torch.floor(lo * sz)[:, None]
    i_hi = torch.floor(hi * sz)[:, None]
    ncross = torch.clamp((i_hi - i_lo).long(), 0, kmax)
    m = torch.arange(kmax, dtype=a0.dtype, device=a0.device)
    denom = (a1 - a0)[:, None]
    ks = torch.where(denom >= 0.0, i_lo + 1.0 + m, i_hi - m)
    lines = ks / sz
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    t = (lines - a0[:, None]) / safe
    valid = (torch.arange(kmax, device=a0.device) < ncross) & (denom != 0.0)
    return torch.where(valid, torch.clamp(t, 0.0, 1.0), torch.ones_like(t))


def _merge_breakpoints(tx: torch.Tensor, ty: torch.Tensor) -> torch.Tensor:
    """Two ascending (P, k) arrays -> the (P, 2k + 2) breakpoints
    [0, merge(tx, ty), 1].  JAX merges by ranks and one-hot products (its
    TPU sort was a compile sink); a sort gives the same values."""
    merged = torch.sort(torch.cat([tx, ty], dim=1), dim=1).values
    zero = torch.zeros_like(merged[:, :1])
    return torch.cat([zero, merged, zero + 1.0], dim=1)


def make_line_integral(grid: Grid, max_cross: int,
                       compat_global_basis: bool = False, n_pieces: int = 1):
    """Returns E(coeffs, x0, y0, x1, y1) over 1-D batches of pairs: the
    integral of sigma_t from (x0, y0) to (x1, y1), exact while every piece
    crosses at most max_cross lines per axis."""
    sz, deg = grid.sz, grid.deg
    nseg = 2 * max_cross + 1
    # per pair: the two Legendre factors (deg, nseg, deg), the gathered
    # coefficients (nseg, deg^2) and the Gauss-point coordinates
    per_pair = nseg * (3 * deg * deg + 8 * deg)
    chunk = max(1, _CHUNK_ELEMENTS // per_pair)

    def piece_integral(cn, gpts, gwts, x0, y0, x1, y1):
        tx = _crossings(x0, x1, sz, max_cross)
        ty = _crossings(y0, y1, sz, max_cross)
        ts = _merge_breakpoints(tx, ty)
        ta, tb = ts[:, :-1], ts[:, 1:]                      # (P, nseg)
        tm = 0.5 * (ta + tb)
        half = 0.5 * (tb - ta)
        tg = tm[..., None] + half[..., None] * gpts         # (P, nseg, deg)
        ddx = (x1 - x0)[:, None]
        ddy = (y1 - y0)[:, None]
        xg = x0[:, None, None] + tg * ddx[..., None]
        yg = y0[:, None, None] + tg * ddy[..., None]
        # cell from the sub-segment midpoint (reference integral_helper:176)
        i = _cell(x0[:, None] + tm * ddx, sz)
        j = _cell(y0[:, None] + tm * ddy, sz)
        if compat_global_basis:
            ex, ey = xg, yg
        else:
            ex = 2.0 * (xg * sz - i[..., None]) - 1.0
            ey = 2.0 * (yg * sz - j[..., None]) - 1.0
        px = legendre_all(deg, ex)                          # (deg, P, nseg, deg)
        py = legendre_all(deg, ey)
        # sum_q c_q basis_q / norm_q, the basis P_a(ex) P_b(ey), q = a deg + b
        c = cn[i * sz + j]                                  # (P, nseg, deg^2)
        vals = 0.0
        for a in range(deg):
            row = c[..., a * deg, None] * py[0]
            for b in range(1, deg):
                row = row + c[..., a * deg + b, None] * py[b]
            vals = vals + px[a] * row                       # (P, nseg, deg)
        seg = vals @ gwts
        seg_len = torch.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2)[:, None] \
            * (tb - ta)
        return torch.sum(seg * seg_len, dim=1) / 2.0

    def line_integral(coeffs, x0, y0, x1, y1):
        dt, dev = x0.dtype, x0.device
        gpts = torch.as_tensor(grid.rule.points, dtype=dt, device=dev)
        gwts = torch.as_tensor(grid.rule.weights, dtype=dt, device=dev)
        norms = torch.as_tensor(grid.norms, dtype=dt, device=dev)
        cn = coeffs.reshape(sz * sz, deg * deg).to(dt) / norms
        out = torch.empty_like(x0)
        for a in range(0, x0.shape[0], chunk):
            b = a + chunk
            p = (x0[a:b], y0[a:b], x1[a:b], y1[a:b])
            if n_pieces == 1:
                out[a:b] = piece_integral(cn, gpts, gwts, *p)
                continue
            cx0, cy0, cx1, cy1 = p
            dxp = (cx1 - cx0) / n_pieces
            dyp = (cy1 - cy0) / n_pieces
            acc = torch.zeros_like(cx0)
            for k in range(n_pieces):
                ax = cx0 + float(k) * dxp
                ay = cy0 + float(k) * dyp
                acc = acc + piece_integral(cn, gpts, gwts, ax, ay, ax + dxp,
                                           ay + dyp)
            out[a:b] = acc
        return out

    return line_integral


def line_integral_batch(grid: Grid, coeffs, p0, p1, max_cross: int,
                        compat_global_basis: bool = False,
                        n_pieces: int = 1) -> torch.Tensor:
    """E over pairs: p0, p1 of shape (..., 2) -> (...).  On the CPU the plain
    version with the caller's bounds; on the card K7, which is exact for
    any number of crossings."""
    from ..kernels.attenuation import line_integral_pairs

    flat0 = p0.reshape(-1, 2)
    flat1 = p1.reshape(-1, 2)
    out = line_integral_pairs(grid, coeffs, flat0, flat1,
                              compat_global_basis, max_cross, n_pieces)
    return out.reshape(p0.shape[:-1])
