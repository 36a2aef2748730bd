"""K7: the exact attenuation line integral, for pairs of points and fused
into the whole dense smooth matrices.

Replaces aniso_tpu/ops/attenuation.py:make_line_integral (:112, with
_crossings :67 and _merge_breakpoints :92) and the all-pairs loops of
aniso_tpu/ops/dense.py:build_dense_smooth (:43), build_dense_E (:115) and
build_dense_smooth_all (:166).  The CUDA kernel is csrc/line_integral.cu;
its header states the bound (operations on the FP64 CUDA cores) and the
design (the crossings walked in ascending t, one thread per pair; the dense
matrices from the upper triangle of 16 x 16 tiles, each E once).

Two entries, float64 arithmetic (E feeds expm1 and must be exact):

  line_integral_pairs  E[k] = int sigma_t from p0[k] to p1[k]
  dense_smooth         out[d, t, s] = expm1(-E(t -> s)) cos(m theta) / r
                       * w[s] for m = modes[d] and every target t and source
                       s; at r = 0: diag[t] * w[t] for m = 0, else 0 (theta
                       = atan2 of src - tgt); stored in float64 or float32

Layouts: coeffs (sz, sz, deg^2) normalized-Legendre coefficients of
sigma_t; p0, p1, pts (n, 2); w, diag (n,); all float64.  The kernel is
compiled for deg 1-8 and takes any higher deg in one runtime-deg instance.

Both take their plain versions (ops.attenuation's transcription of the JAX
function; dense_smooth_plain, the rows of JAX's build_dense_smooth_all
epilogue, dense_smooth_rows_plain, chunk by chunk) for CPU tensors and
launch the kernel for CUDA tensors.  `launches` counts kernel launches per
entry: "pairs", and "dense_f64" / "dense_f32" by the stored type.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import attenuation as plain
from . import _cuda

SOURCE = "line_integral.cu"
SYMBOLS = {"pairs": "aniso_line_integral_pairs_f64",
           "dense_f64": "aniso_dense_smooth_f64",
           "dense_f32": "aniso_dense_smooth_f32"}
_FIELD = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
          ctypes.c_void_p, ctypes.c_int)
_ARGTYPES = {
    "pairs": _FIELD + (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p),
    "dense": _FIELD + (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p),
}
# float64 rows of the plain dense version computed at a time (128 MB)
_PLAIN_ELEMENTS = 1 << 24

launches = {"pairs": 0, "dense_f64": 0, "dense_f32": 0}


def _field_args(grid, coeffs: torch.Tensor, compat: bool):
    """The kernel's view of sigma_t: Gauss points and weights, and the
    coefficients divided by the basis norms; kept alive by the caller."""
    dev = coeffs.device
    _cuda.check("coeffs", coeffs, (grid.sz, grid.sz, grid.nq), torch.float64)
    gx = torch.as_tensor(grid.rule.points, dtype=torch.float64, device=dev)
    gw = torch.as_tensor(grid.rule.weights, dtype=torch.float64, device=dev)
    norms = torch.as_tensor(grid.norms, dtype=torch.float64, device=dev)
    cn = (coeffs / norms).contiguous()
    return (gx, gw, cn), (grid.sz, grid.deg, _cuda.ptr(gx), _cuda.ptr(gw),
                          _cuda.ptr(cn), int(compat))


def _instance(t: torch.Tensor):
    if t.dtype != torch.float64:
        raise TypeError(f"K7 takes float64, got {t.dtype}")


def line_integral_pairs(grid, coeffs, p0, p1, compat: bool = False,
                        max_cross: int | None = None,
                        n_pieces: int | None = None) -> torch.Tensor:
    """E along each p0[k] -> p1[k]: (n,).  max_cross / n_pieces bound the
    plain version (default: exact for every pair, see _plain_exact); the
    kernel needs none."""
    if p0.device.type == "cpu":
        if max_cross is None:
            return _plain_exact(grid, coeffs, p0, p1, compat)
        li = plain.make_line_integral(grid, max_cross, compat, n_pieces or 1)
        return li(coeffs, p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1])
    _instance(p0)
    n = p0.shape[0]
    _cuda.check("p0", p0, (n, 2), torch.float64)
    _cuda.check("p1", p1, (n, 2), torch.float64)
    keep, field = _field_args(grid, coeffs, compat)
    fn = _cuda.load(SOURCE, SYMBOLS["pairs"], _ARGTYPES["pairs"])
    out = torch.empty(n, dtype=torch.float64, device=p0.device)
    rc = fn(*field, _cuda.ptr(p0), _cuda.ptr(p1), n, _cuda.ptr(out),
            _cuda.stream(p0.device))
    _cuda.raise_on_error(SYMBOLS["pairs"], rc)
    launches["pairs"] += 1
    del keep
    return out


def _plain_exact(grid, coeffs, p0, p1, compat):
    """The plain version, exact for every pair: the pairs are grouped by the
    power of two at or above the lines they cross on their longer axis,
    and each group runs in one piece with that bound.  (The plain version
    pads every pair to its bound, so one bound of sz for all would cost
    about twice as much.)"""
    sz = grid.sz
    k = torch.maximum(*((torch.floor(p1[:, a] * sz)
                         - torch.floor(p0[:, a] * sz)).abs() for a in (0, 1)))
    bound = torch.clamp(2 ** torch.ceil(torch.log2(k.clamp(min=1))),
                        max=sz).long()
    out = torch.empty(p0.shape[0], dtype=p0.dtype, device=p0.device)
    for b in torch.unique(bound).tolist():
        idx = torch.nonzero(bound == b).squeeze(1)
        a, c = p0[idx], p1[idx]
        out[idx] = plain.make_line_integral(grid, b, compat)(
            coeffs, a[:, 0], a[:, 1], c[:, 0], c[:, 1])
    return out


def dense_smooth_rows_plain(grid, coeffs, pts, w, diag, row0: int,
                            nrows: int, modes, compat: bool = False):
    """The JAX math step by step: E of every (row, source) pair by the plain
    line integral (target -> source, as JAX's pure path), then
    expm1(-E) / r * cos(m atan2(dy, dx)) * w[s] with the r = 0 entries of
    aniso_tpu/ops/dense.py:183-197."""
    n = pts.shape[0]
    rows = pts[row0:row0 + nrows]
    p0 = rows[:, None, :].expand(nrows, n, 2).reshape(-1, 2)
    p1 = pts[None, :, :].expand(nrows, n, 2).reshape(-1, 2)
    E = _plain_exact(grid, coeffs, p0, p1, compat).reshape(nrows, n)
    d = pts[None, :, :] - rows[:, None, :]             # src - tgt
    r = torch.hypot(d[..., 0], d[..., 1])
    ang = torch.atan2(d[..., 1], d[..., 0])
    base = torch.expm1(-E) / torch.where(r == 0.0, torch.ones_like(r), r)
    idx = torch.arange(nrows, device=pts.device)
    out = []
    for m in modes:
        k = base * torch.cos(m * ang)
        if m == 0:
            k[idx, row0 + idx] = diag[row0:row0 + nrows]
        else:
            k[r == 0.0] = 0.0
        out.append(k * w[None, :])
    return torch.stack(out)


def dense_smooth_plain(grid, coeffs, pts, w, diag, modes,
                       compat: bool = False, dtype=torch.float64):
    """dense_smooth's plain version: the plain rows in chunks of at most
    128 MB, each cast to `dtype`."""
    modes = list(modes)
    n = pts.shape[0]
    out = torch.empty((len(modes), n, n), dtype=dtype, device=pts.device)
    step = max(1, _PLAIN_ELEMENTS // (len(modes) * n))
    for r0 in range(0, n, step):
        nr = min(step, n - r0)
        out[:, r0:r0 + nr] = dense_smooth_rows_plain(
            grid, coeffs, pts, w, diag, r0, nr, modes, compat)
    return out


def dense_smooth(grid, coeffs, pts, w, diag, modes, compat: bool = False,
                 dtype=torch.float64) -> torch.Tensor:
    """(D, n, n) smooth matrices of `modes` (consecutive, ascending), every
    target row and source column, in `dtype` (float64 or float32; the
    arithmetic is float64): one launch."""
    modes = list(modes)
    if pts.device.type == "cpu":
        return dense_smooth_plain(grid, coeffs, pts, w, diag, modes, compat,
                                  dtype)
    _instance(pts)
    inst = {torch.float64: "dense_f64", torch.float32: "dense_f32"}.get(dtype)
    if inst is None:
        raise TypeError(f"K7 stores float64 or float32, not {dtype}")
    n = pts.shape[0]
    m0, D = modes[0], len(modes)
    if modes != list(range(m0, m0 + D)) or m0 < 0:
        raise ValueError(f"K7 takes consecutive ascending modes, got {modes}")
    _cuda.check_all(torch.float64, ("pts", pts, (n, 2)), ("w", w, (n,)),
                    ("diag", diag, (n,)))
    keep, field = _field_args(grid, coeffs, compat)
    fn = _cuda.load(SOURCE, SYMBOLS[inst], _ARGTYPES["dense"])
    out = torch.empty((D, n, n), dtype=dtype, device=pts.device)
    rc = fn(*field, _cuda.ptr(pts), _cuda.ptr(w), _cuda.ptr(diag), n, m0, D,
            _cuda.ptr(out), _cuda.stream(pts.device))
    _cuda.raise_on_error(SYMBOLS[inst], rc)
    launches[inst] += 1
    del keep
    return out


def subsegments(grid, rows: np.ndarray, cols: np.ndarray) -> int:
    """The sub-segments K7 integrates over all (row, col) pairs, exactly:
    one per pair plus one per grid line crossed on each axis; a pair of
    equal points has none.  rows, cols: (k, 2) distinct node coordinates
    (numpy)."""
    sz = grid.sz
    k = np.arange(sz + 1)
    total = len(rows) * len(cols)
    for axis in (0, 1):
        a, b = (np.bincount(np.floor(p[:, axis] * sz).astype(np.int64),
                            minlength=sz + 1).astype(np.float64)
                for p in (rows, cols))
        total += int(a @ np.abs(k[:, None] - k[None, :]) @ b)
    same = {tuple(p) for p in rows.tolist()} & {tuple(p) for p in
                                                cols.tolist()}
    return total - len(same)


def flops_per_subsegment(deg: int, compat: bool = False) -> int:
    """Operations K7 does per sub-segment, counted from the kernel's code
    (a fused multiply-add counts 2): the crossing parameter (2), the
    midpoint, half width and cell (10), the length factor (4); per Gauss
    point the parameter and coordinates (6), the local coordinates (8,
    none in compat mode), the two Legendre recurrences (2 x 5 per degree
    above 1), the double sum over deg^2 coefficients (2 deg^2 + 2 deg) and
    the weighted add (2)."""
    per_point = 6 + (0 if compat else 8) + 10 * max(deg - 2, 0) \
        + 2 * deg * deg + 2 * deg + 2
    return 16 + deg * per_point
