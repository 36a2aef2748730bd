"""Dense (all-pairs) operator assembly: the exact reference path (torch).

Counterpart of aniso_tpu/ops/dense.py.  The corrected mode-m matvec is

  K_m u = (1/2pi) [ smooth_m all-pairs (w u) + real_m all-pairs (w u)
                  + NearStencil_m u ]

where NearStencil = -coarse(3x3) + refined(8) + duffy(self) (ops.near, with
the removal term: the coarse 3x3 part of the all-pairs real sum cancels
against it, main.cpp:78-119).

The smooth matrices embed the attenuation E of every pair; K7
(kernels.attenuation.dense_smooth) computes E once per unordered pair and
writes every mode's two entries from it, in one launch straight into the
solver's dtype (float64 arithmetic), so that no (n, n) E is ever stored.
The real matrices are geometry only: torch expressions in float64, row
chunk by row chunk, cast to the solver's dtype.  The two (n, n) GEMVs of dense_apply are plain large products left
to torch.matmul, as JAX leaves them to XLA.

Memory: 2 D n^2 itemsize bytes for D modes (at 64^2, deg 3: 21.7 GB for one
mode in float64); dense_bytes / check_dense_fits.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.geometry import Grid
from ..kernels._cuda import resolve_device
from ..kernels.attenuation import dense_smooth, line_integral_pairs
from .attenuation import make_sigma_eval
from .kernels import real_kernel
from .stencil import apply_near_stencil, apply_per_square

# float64 elements of one row chunk of the real and E builds (128 MB)
_CHUNK_ELEMENTS = 1 << 24


def dense_bytes(grid: Grid, n_modes: int, dtype) -> int:
    """Bytes of the D smooth and D real (n, n) matrices."""
    itemsize = torch.finfo(dtype).bits // 8
    return 2 * n_modes * grid.n_nodes ** 2 * itemsize


def check_dense_fits(grid: Grid, n_modes: int, dtype, device) -> None:
    """Raise before allocating when the dense matrices exceed the card's
    free memory (the CPU is not checked)."""
    device = torch.device(device)
    if device.type != "cuda":
        return
    need = dense_bytes(grid, n_modes, dtype)
    free = torch.cuda.mem_get_info(device)[0]
    if need > free:
        raise MemoryError(
            f"the dense backend needs {need / 1e9:.2f} GB for {n_modes} "
            f"mode(s) at {grid.sz}^2 ({grid.n_nodes} nodes: 2 D n^2 x "
            f"{torch.finfo(dtype).bits // 8} bytes), more than the "
            f"{free / 1e9:.2f} GB free on {device}; use backend='fmm'"
        )


def _row_chunks(n: int, per_row: int):
    rows = max(1, min(65535, _CHUNK_ELEMENTS // per_row))
    for r0 in range(0, n, rows):
        yield r0, min(rows, n - r0)


def _nodes(grid: Grid, device):
    pts = torch.as_tensor(grid.flat_nodes(), dtype=torch.float64,
                          device=device).contiguous()
    w = torch.as_tensor(grid.weights.reshape(-1), dtype=torch.float64,
                        device=device)
    return pts, w


def build_dense_real(grid: Grid, m: int, device, dtype=torch.float64,
                     out=None) -> torch.Tensor:
    """(n, n) matrix K[t, s] = real_m(s, t) * w[s] (geometry only), into
    `out` when given."""
    pts, w = _nodes(grid, device)
    n = pts.shape[0]
    ax, ay = pts[:, 0], pts[:, 1]
    if out is None:
        out = torch.empty((n, n), dtype=dtype, device=device)
    for r0, nr in _row_chunks(n, n):
        rows = slice(r0, r0 + nr)
        k = real_kernel(m, ax[None, :], ay[None, :], ax[rows, None],
                        ay[rows, None])
        out[rows] = k * w[None, :]
    return out


def build_dense_smooth_all(grid: Grid, modes, coeffs, sigma_nodes, device,
                           dtype=torch.float64) -> torch.Tensor:
    """(D, n, n) smooth matrices K_m[t, s] = smooth_m(s, t) * w[s] of the
    consecutive `modes`, from one E per pair (K7), in `dtype`.

    coeffs must be in local-basis form (callers pass the compat-transformed
    coefficients under the global-basis quirk); sigma_nodes (sz, sz, nq)
    gives the m = 0 diagonal (KernelFactory.cpp:260)."""
    pts, w = _nodes(grid, device)
    cf = torch.as_tensor(np.asarray(coeffs), dtype=torch.float64,
                         device=device)
    diag = torch.as_tensor(np.asarray(sigma_nodes).reshape(-1),
                           dtype=torch.float64, device=device)
    return dense_smooth(grid, cf, pts, w, diag, modes, dtype=dtype)


def build_dense_smooth(grid: Grid, m: int, coeffs,
                       compat_global_basis: bool = False, device=None,
                       dtype=torch.float64) -> torch.Tensor:
    """(n, n) matrix K[t, s] = smooth_m(s, t) * w[s] of one mode, with the
    line integral and the m = 0 diagonal sigma_hat(node) evaluated under
    `compat_global_basis`.  device None means the GPU (resolve_device)."""
    device = resolve_device(device)
    pts, w = _nodes(grid, device)
    cf = torch.as_tensor(np.asarray(coeffs), dtype=torch.float64,
                         device=device)
    if m == 0:
        sig = make_sigma_eval(grid, compat_global_basis)
        diag = sig(cf, pts[:, 0], pts[:, 1])
    else:
        diag = torch.zeros_like(w)
    return dense_smooth(grid, cf, pts, w, diag, [m], compat_global_basis,
                        dtype)[0]


def build_dense_E(grid: Grid, coeffs, device) -> torch.Tensor:
    """All-pairs attenuation matrix E[t, s] (float64), from target to
    source."""
    pts, _ = _nodes(grid, device)
    n = pts.shape[0]
    cf = torch.as_tensor(np.asarray(coeffs), dtype=torch.float64,
                         device=device)
    out = torch.empty((n, n), dtype=torch.float64, device=device)
    for r0, nr in _row_chunks(n, n):
        p0 = pts[r0:r0 + nr, None, :].expand(nr, n, 2).reshape(-1, 2)
        p1 = pts[None, :, :].expand(nr, n, 2).reshape(-1, 2)
        out[r0:r0 + nr] = line_integral_pairs(grid, cf, p0, p1).reshape(nr, n)
    return out


def dense_apply(k_smooth, k_real, stencil, duffy, grid: Grid,
                u: torch.Tensor) -> torch.Tensor:
    """Full corrected mode matvec on a (sz, sz, nq) charge -> (sz, sz, nq)
    (main.cpp:78-119 / AnisoWrapper.cpp:92-136).  The matrices include the
    source weight, so they act on the raw charge."""
    sz, nq = grid.sz, grid.nq
    uf = u.reshape(-1)
    out = (k_smooth @ uf + k_real @ uf).reshape(sz, sz, nq)
    out = out + apply_near_stencil(stencil, u)
    if duffy is not None:
        out = out + apply_per_square(duffy, u)
    return out / (2.0 * math.pi)
