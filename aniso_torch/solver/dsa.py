"""Diffusion synthetic acceleration (DSA) preconditioner.

Counterpart of aniso_tpu/solver/dsa.py.  Reference semantics
(aniso.m:66-119): with FEM matrices Diff = S(D) + M(sigma_a) + E/2 and
Diff2 = S(D) + M(sigma_t) + E/2 (so Diff2 - Diff = M(sigma_s)), the
preconditioner applies z = Diff^-1 Diff2 h = h + Diff^-1 M(sigma_s) h: the
classic DSA form "identity plus a diffusion solve of the scattering
residual", with 2D Eddington diffusion coefficient D = 0.5/sigma_t
(aniso.m:77) and Marshak (Robin) boundary z/2 + D dz/dn = 0 from the E/2
edge term (aniso.m:89-90).

As in the JAX package, the diffusion operator lives on the solver's own
sz x sz grid of squares, cell-centered finite-volume with harmonic-mean
face coefficients: a 5-point stencil (K9d, kernels.diffusion), solved by
Jacobi-preconditioned CG on the device.  The restriction is the
quadrature-weighted square average and the prolongation constant per
square.

On the card the whole CG, stencil and stopping test included, is one launch
of the CUDA kernel K9 (kernels.pcg), as JAX runs it as one device
while_loop: nothing is read back inside a call, and the iteration count
stays on the card until it is read.  The stopping rule is JAX's
(dsa.py:126-128), so iteration counts and z agree.

Multi-mode: the diffusion limit approximates the angular mean; the
preconditioner corrects Fourier mode 0 and passes higher modes through.

Thick cells: on cells more than ~1.5 mean free paths thick the discrete
transport operator departs from its continuum diffusion limit and the raw
correction hurts.  The guard is the JAX package's cell-local damping of the
correction by the cell optical depth tau = sigma_t * dx:

    theta(tau) = 0                              for tau >= 1.6
               = 1 / (1 + e^{(tau-1.45)/0.07})  below

so thick cells degrade the preconditioner toward the identity while
resolved cells keep the full DSA win.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels import pcg as k9
from ..kernels.diffusion import diffusion_apply
from ..kernels.pcg import PcgResult


class Stencil(NamedTuple):
    """A z = sigma_a z - div(D grad z) on (sz, sz) cell values: the face
    coefficients, absorption and cell width that K9d and K9 take; calling
    it applies the stencil (K9d)."""
    Dx: torch.Tensor
    Dy: torch.Tensor
    robin: torch.Tensor
    sigma_a: torch.Tensor
    dx: float

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        return diffusion_apply(z, *self)


def cell_average(grid, nodal: torch.Tensor, w=None) -> torch.Tensor:
    """Quadrature-weighted square means: (sz, sz, nq) -> (sz, sz).  w: the
    weights (grid.w2d) already on nodal's device in its dtype."""
    if w is None:
        w = torch.as_tensor(grid.w2d, dtype=nodal.dtype, device=nodal.device)
    return (nodal * w).sum(-1) / w.sum()


def _face_coeffs(D: torch.Tensor, dx: float):
    """Harmonic-mean interior face coefficients + Robin boundary factors.

    Returns (Dx, Dy, robin) where Dx[i, j] couples cells (i, j) and
    (i+1, j), Dy couples (i, j)-(i, j+1), and robin[b] multiplies the cell
    value to give the Marshak outward flux z * 2D/(dx + 4D) per unit length.
    """
    Dx = 2.0 * D[:-1, :] * D[1:, :] / (D[:-1, :] + D[1:, :])
    Dy = 2.0 * D[:, :-1] * D[:, 1:] / (D[:, :-1] + D[:, 1:])
    robin = 2.0 * D / (dx + 4.0 * D)
    return Dx.contiguous(), Dy.contiguous(), robin


def make_diffusion_apply(D: torch.Tensor, sigma_a: torch.Tensor, dx: float):
    """A z = sigma_a z - div(D grad z), Robin z/2 + D dz/dn = 0, as a
    5-point stencil on (sz, sz) cell values; returns (the Stencil, the
    Jacobi diagonal of A)."""
    Dx, Dy, robin = _face_coeffs(D, dx)
    sigma_a = (sigma_a + torch.zeros_like(D)).contiguous()
    inv_dx2 = 1.0 / (dx * dx)
    inv_dx = 1.0 / dx
    apply = Stencil(Dx, Dy, robin, sigma_a, dx)

    diag = sigma_a.clone()
    diag[:-1, :] += Dx * inv_dx2
    diag[1:, :] += Dx * inv_dx2
    diag[:, :-1] += Dy * inv_dx2
    diag[:, 1:] += Dy * inv_dx2
    diag[0, :] += robin[0, :] * inv_dx
    diag[-1, :] += robin[-1, :] * inv_dx
    diag[:, 0] += robin[:, 0] * inv_dx
    diag[:, -1] += robin[:, -1] * inv_dx
    return apply, diag


def pcg(apply: Stencil, diag, b, *, tol: float = 1e-8,
        max_iter: int = 500) -> PcgResult:
    """Jacobi-preconditioned CG from x = 0 on the stencil `apply`; stops
    when k = max_iter or |r|^2 <= tol^2 |b|^2 (K9 on the card, its plain
    version on the CPU)."""
    return k9.pcg(b, diag, *apply, tol=tol, max_iter=max_iter)


class DsaPreconditioner:
    """Callable left preconditioner for TransportSolver.solve.

    h (N, sz, sz, nq) -> h with mode 0 replaced by h0 + prolong(theta z),
    where  (sigma_a - div D grad) z = sigma_s_bar * mean(h0).  It works in
    the solver's dtype on the solver's device, and copies nothing from the
    host in a call, so a CUDA graph can capture it (K9's launch, one
    cluster or one cooperative grid, included).

    `calls` counts the calls since reset() (a solver's captured step adds
    its calls on each replay).  `cg_iterations` lists the CG iterations of
    each of them: on the card each call's K9 count goes into its own slot
    of a device log, indexed by a counter on the device, and the list reads
    the log (after the solve); at most LOG_CALLS calls between resets.
    """

    LOG_CALLS = 1 << 16

    def __init__(self, solver, *, tol: float = 1e-8, max_iter: int = 500,
                 damping: bool = True):
        grid = solver.grid
        if solver.sigma_s is None:
            raise RuntimeError("call set_coeff before building DSA")
        self.grid = grid
        dev = solver.sigma_s.device
        self.w = torch.as_tensor(grid.w2d, dtype=solver.sigma_s.dtype,
                                 device=dev)
        sigma_s_bar = cell_average(grid, solver.sigma_s, self.w)
        sigma_t_bar = cell_average(grid, solver.sigma_t, self.w)
        sigma_a_bar = torch.clamp(sigma_t_bar - sigma_s_bar, min=1e-12)
        D = 0.5 / sigma_t_bar          # 2D Eddington (aniso.m:77)
        self.sigma_s_bar = sigma_s_bar
        self.apply_diff, self.diag = make_diffusion_apply(
            D, sigma_a_bar, grid.dx
        )
        # cell-local thick-cell damping theta(tau) (module docstring);
        # damping=False retains the raw continuum DSA for A/B studies
        if damping:
            tau = grid.dx * sigma_t_bar
            arg = torch.clamp((tau - 1.45) / 0.07, -50.0, 50.0)
            theta = 1.0 / (1.0 + torch.exp(arg))
            self.theta = torch.where(tau >= 1.6, torch.zeros_like(theta),
                                     theta)
        else:
            self.theta = torch.ones_like(sigma_t_bar)
        self.tol = tol
        self.max_iter = max_iter
        self.calls = 0
        self._counts = []                      # the CPU's CG counts
        self._log = self._slot = None
        if dev.type == "cuda":
            self._log = torch.zeros(self.LOG_CALLS, dtype=torch.int32,
                                    device=dev)
            self._slot = torch.zeros(1, dtype=torch.int64, device=dev)

    def reset(self):
        """Start counting calls and CG iterations anew."""
        self.calls = 0
        self._counts.clear()
        if self._slot is not None:
            self._slot.zero_()

    @property
    def cg_iterations(self) -> list:
        if self._log is None:
            return list(self._counts)
        if self.calls > self.LOG_CALLS:
            raise RuntimeError(f"{self.calls} calls since reset(): the log "
                               f"holds {self.LOG_CALLS}")
        return self._log[:self.calls].tolist()

    def __call__(self, h: torch.Tensor) -> torch.Tensor:
        multi = h.dim() == 4
        h0 = h[0] if multi else h
        hbar = cell_average(self.grid, h0, self.w)
        z, k = pcg(
            self.apply_diff, self.diag, self.sigma_s_bar * hbar,
            tol=self.tol, max_iter=self.max_iter,
        )
        if self._log is not None:              # K9's count, on the card
            self._log.index_copy_(0, self._slot % self.LOG_CALLS, k.view(1))
            self._slot += 1
        else:
            self._counts.append(k)
        self.calls += 1
        h0_new = h0 + (self.theta * z)[:, :, None]
        if not multi:
            return h0_new
        out = h.clone()
        out[0] = h0_new
        return out
