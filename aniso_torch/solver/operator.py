"""The corrected transport operator and the solver facade, FMM backend,
one Fourier mode.

Counterpart of aniso_tpu/solver/operator.py for kernel_size = 1
(reference main.cpp:78-141):

  K_0 u = (1/2pi) [ smooth_0(w u) + real_0(w u) + NearStencil_0 u ]
  forward:  A x = x - chi_0 K_0(sigma_s x)        (main.cpp:125-136)
  rhs:      b = K_0 q

set_coeff builds the mode-independent E caches once (fmm.smooth); apply
runs the FMM matvec (fmm.apply) through the CUDA kernels K1 and K2.

Not in this slice (each raises NotImplementedError): the dense backend,
kernel_size > 1 (multi-mode coupling), refine=True (f32/f64 refinement),
a preconditioner (DSA), and float64 on the GPU (the kernels are float32).

Every entry point runs on the GPU unless the caller passes device="cpu";
without CUDA the default raises instead of running on the CPU.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.config import SolverConfig
from ..core.geometry import make_grid, project_field
from ..fmm.apply import build_fmm_static, build_mode_static, fmm_apply_mode
from ..fmm.smooth import (
    build_m2l_E, build_m2l_E_coarse_all_np, build_near_E, dense_budget_bytes,
    m2l_cache_bytes,
)
from ..fmm.structure import tree_config
from ..ops.compat import to_local_equivalent
from ..ops.fields import evaluate_at_nodes_np
from ..ops.near import build_near_stencil
from .gmres import GmresResult, gmres

# Full-f32 products everywhere: with reduced-precision (TF32) multiplies
# GMRES converges by its own estimate while the true residual stalls at
# ~1e-2 (the JAX record, aniso_tpu/fmm/apply.py:38-42).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """None means the GPU; CUDA must then be present.  The CPU runs only
    when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


class TransportSolver:
    """Facade playing the role of the reference `Aniso` + `aniso.m`
    orchestration, FMM backend, one Fourier mode."""

    def __init__(self, cfg: SolverConfig, backend: str = "fmm", device=None):
        cfg.validate()
        if backend == "dense":
            raise NotImplementedError(
                "backend='dense' is a later slice (ROADMAP queue A item 9)"
            )
        if backend != "fmm":
            raise NotImplementedError(backend)
        if cfg.kernel_size > 1:
            raise NotImplementedError(
                "kernel_size > 1 (multi-mode coupling) is a later slice "
                "(ROADMAP queue A item 11)"
            )
        if cfg.refine:
            raise NotImplementedError(
                "refine=True (f32/f64 refinement) is slice 2 "
                "(ROADMAP queue A item 10)"
            )
        self.device = resolve_device(device)
        self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
        if self.device.type == "cuda" and self.dtype != torch.float32:
            raise NotImplementedError(
                "float64 on the GPU needs f64 kernels (slice 2); use "
                "dtype='float32'"
            )
        self.cfg = cfg
        self.grid = make_grid(cfg.domain_size, cfg.quad_rule)
        # chi_0 = (g^0 - g^N) / (1 - g^N) = 1 for N = 1
        # (KernelFactory.cpp:18-20; the g = 0 branch gives 1 as well)
        self.chi = np.array([1.0])
        self._tcfg = tree_config(cfg.domain_size, cfg.max_level)

        # geometry-only near stencil; the FMM path omits the real-kernel U
        # list, so the stencil carries no removal term
        stencil, duffy = build_near_stencil(
            self.grid, 0, cfg.sing_rule, cfg.compat_global_basis,
            include_removal=False,
        )
        self._fmm_static = build_fmm_static(
            self.grid, cfg.np_cheb, self.device, self.dtype
        )
        self._mode_statics = [build_mode_static(
            self.grid, self._tcfg, cfg.np_cheb, 0, stencil, duffy,
            self.device, self.dtype,
        )]
        self.sigma_s = None
        self.sigma_t_coeff = None
        self._caches = None
        self.set_coeff_phases = {}
        self.n_matvecs = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # -- coefficient setting (reference AnisoWrapper 'setCoeff' + 'cache') --

    def set_coeff(self, sigma_s, sigma_t):
        """sigma_s / sigma_t: nodal fields shaped (sz, sz, nq) (or flat).

        The sigma pipeline (projection, compat transform, node evaluation)
        and the coarse M2L levels run on the host in f64; the near E and
        the fine M2L levels are built on the device."""
        g = self.grid
        self._caches = None          # release the previous caches first
        shape = (g.sz, g.sz, g.nq)
        sig_s_np = np.asarray(sigma_s, np.float64).reshape(shape)
        sig_t_np = np.asarray(sigma_t, np.float64).reshape(shape)
        self.sigma_s = self._tensor(sig_s_np)
        coeffs_np = project_field(g, sig_t_np)
        self.sigma_t_coeff = self._tensor(coeffs_np)
        # under the reference's global-basis quirk, evaluate with transformed
        # coefficients in the (translation-invariant) local basis
        if self.cfg.compat_global_basis:
            coeffs_np = to_local_equivalent(g, coeffs_np)
        sigma_nodes = evaluate_at_nodes_np(g, coeffs_np)
        w_glob = g.w2d * 0.25 * g.dx * g.dx

        phases = {}
        t0 = time.perf_counter()
        coarse_np = build_m2l_E_coarse_all_np(
            g, self._tcfg, self.cfg.np_cheb, coeffs_np
        )
        phases["coarse_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        coeffs = self._tensor(coeffs_np)
        caches = {"sigma_w": self._tensor(sigma_nodes * w_glob)}
        caches["near_E"] = build_near_E(g, coeffs)
        self._sync()
        phases["near_E_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        caches["m2l_E"] = build_m2l_E(
            g, self._tcfg, self.cfg.np_cheb, coeffs, coarse_np,
            budget_bytes=dense_budget_bytes(self.device),
        )
        self._sync()
        phases["m2l_s"] = time.perf_counter() - t0
        self.set_coeff_phases = phases
        self._caches = caches

    def cache_report(self) -> dict:
        """Bytes per cache family (role of Aniso::displayKernelCacheSize,
        Aniso.cpp:19-47), in the port's unpadded GPU layouts."""
        def nbytes(t):
            return t.numel() * t.element_size()

        rep = {}
        if self._caches is not None:
            rep["m2l_E"] = m2l_cache_bytes(self._caches["m2l_E"])
            rep["near_E"] = nbytes(self._caches["near_E"])
            rep["sigma_w"] = nbytes(self._caches["sigma_w"])
            ms = self._mode_statics[0]
            rep["mode_statics"] = (
                sum(nbytes(t) for t in ms["m2l_cosr"].values())
                + nbytes(ms["near_cosrw"]) + nbytes(ms["near_static"])
                + (0 if ms["duffy"] is None else nbytes(ms["duffy"]))
            )
        rep["total"] = sum(rep.values())
        return rep

    # -- corrected matvec (reference MEX 'mapping') --

    def apply_mode(self, m: int, u) -> torch.Tensor:
        """K_m u on a (sz, sz, nq) charge (AnisoWrapper.cpp:92-136)."""
        if m != 0:
            raise NotImplementedError(
                "modes m > 0 come with kernel_size > 1 (a later slice)"
            )
        if self._caches is None:
            raise RuntimeError("call set_coeff first")
        g = self.grid
        u = self._tensor(u).reshape(g.sz, g.sz, g.nq).contiguous()
        self.n_matvecs += 1
        return fmm_apply_mode(
            self._tcfg.leaf_level, self._fmm_static, self._caches,
            self._mode_statics[0], 0, u,
        )

    # -- forward operators --

    def rhs(self, charge) -> torch.Tensor:
        """rhs (aniso.m:121-137) for one mode: (1, sz, sz, nq)."""
        return self.apply_mode(0, charge)[None]

    def forward(self, u) -> torch.Tensor:
        """(A u)_0 = u_0 - chi_0 K_0(sigma_s u_0)  (main.cpp:125-136)."""
        g = self.grid
        u = self._tensor(u).reshape(1, g.sz, g.sz, g.nq)
        K = self.apply_mode(0, self.sigma_s * u[0])
        return u - self.chi[0] * K[None]

    def inner_gmres(self, b, tol, x0=None, precond=None) -> GmresResult:
        if precond is not None:
            raise NotImplementedError(
                "preconditioning (DSA) is a later slice (ROADMAP queue A "
                "item 12)"
            )
        g = self.grid
        b = self._tensor(b).reshape(1, g.sz, g.sz, g.nq)
        x0 = None if x0 is None else self._tensor(x0).reshape(b.shape)
        return gmres(
            self.forward, b, x0, restart=self.cfg.restart,
            max_iter=self.cfg.max_iter, tol=tol,
        )

    # -- solve (aniso.m:159-173 / main.cpp:138-141) --

    def solve(self, charge, x0: Optional[torch.Tensor] = None,
              precond=None) -> GmresResult:
        b = self.rhs(charge)
        return self.inner_gmres(b, self.cfg.tol, x0=x0, precond=precond)
