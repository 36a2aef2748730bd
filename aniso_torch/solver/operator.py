"""The corrected transport operator and the solver facade, FMM backend,
one Fourier mode.

Counterpart of aniso_tpu/solver/operator.py for kernel_size = 1
(reference main.cpp:78-141):

  K_0 u = (1/2pi) [ smooth_0(w u) + real_0(w u) + NearStencil_0 u ]
  forward:  A x = x - chi_0 K_0(sigma_s x)        (main.cpp:125-136)
  rhs:      b = K_0 q

set_coeff builds the mode-independent E caches once (fmm.smooth); apply
runs the FMM matvec (fmm.apply) through the CUDA kernels K1, K2 and K3, in
float32 or float64.  With refine=True (dtype float32), set_coeff also
builds the f64 twin of the operator on the device and solve() runs
solver.refine.refined_solve: f32 inner GMRES, f64 outer residuals
(aniso_tpu/solver/operator.py:157-182, 261-272, 462-483).

Not ported (each raises NotImplementedError): the dense backend,
kernel_size > 1 (multi-mode coupling), a preconditioner (DSA), and the
host numpy twin (refine_twin="host").

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
    build_m2l_E, build_m2l_E_coarse_all, build_near_E, dense_budget_bytes,
    m2l_cache_bytes, per_offset_levels,
)
from ..fmm.structure import tree_config
from ..ops.compat import to_local_equivalent
from ..ops.fields import evaluate_at_nodes_np
from ..ops.near import build_near_stencil
from .gmres import GmresResult, gmres
from .refine import refined_solve

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
        if cfg.refine and cfg.refine_twin == "host":
            raise NotImplementedError(
                "refine_twin='host' (the numpy twin on the host) is not "
                "ported; the f64 twin lives on the device"
            )
        self.device = resolve_device(device)
        self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
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

        def statics(dtype):
            return (
                build_fmm_static(self.grid, cfg.np_cheb, self.device, dtype),
                [build_mode_static(self.grid, self._tcfg, cfg.np_cheb, 0,
                                   stencil, duffy, self.device, dtype)],
            )

        self._fmm_static, self._mode_statics = statics(self.dtype)
        if cfg.refine:
            # the f64 twin of the operator for the outer residuals
            self._fmm_static64, self._mode_statics64 = statics(torch.float64)
        self.sigma_s = None
        self.sigma_t_coeff = None
        self._caches = None
        self._caches64 = None
        self._sigma_s64 = None
        self.set_coeff_phases = {}
        self.n_matvecs = 0
        self.n_matvecs64 = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # -- coefficient setting (reference AnisoWrapper 'setCoeff' + 'cache') --

    def set_coeff(self, sigma_s, sigma_t):
        """sigma_s / sigma_t: nodal fields shaped (sz, sz, nq) (or flat).

        The sigma pipeline (projection, compat transform, node evaluation)
        runs on the host in f64.  The coarse M2L levels are built in f64 on
        the device (K6) or, the few-box ones, on the host engine; with
        refine=True the f64 twin comes next; then the near E and the M2L
        levels in the solver's dtype, whose fine levels are dense while
        they fit the device memory left and per-offset beyond."""
        g = self.grid
        self._caches = None          # release the previous caches first
        self._caches64 = None
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
        sigma_w = evaluate_at_nodes_np(g, coeffs_np) * (
            g.w2d * 0.25 * g.dx * g.dx)

        phases = {}
        t0 = time.perf_counter()
        coarse = build_m2l_E_coarse_all(
            g, self._tcfg, self.cfg.np_cheb, coeffs_np, self.device
        )
        self._sync()
        phases["coarse_s"] = time.perf_counter() - t0
        if self.cfg.refine:
            t0 = time.perf_counter()
            self._sigma_s64 = torch.as_tensor(
                sig_s_np, dtype=torch.float64, device=self.device)
            self._caches64 = self._build_caches(
                torch.float64, coeffs_np, sigma_w, coarse, phases, twin=True)
            phases["twin_s"] = time.perf_counter() - t0
        self._caches = self._build_caches(
            self.dtype, coeffs_np, sigma_w, coarse, phases)
        self.set_coeff_phases = phases

    def _build_caches(self, dtype, coeffs_np, sigma_w, coarse: dict,
                      phases: dict, twin: bool = False) -> dict:
        """{'sigma_w', 'near_E', 'm2l_E'[, 'coeffs']} in `dtype`.

        coarse (the f64 levels) is cast in place to `dtype`, so that f64
        copies no one else holds are freed before the fine levels are
        built.  The twin (aniso_tpu operator.py:462-483) keeps every fine
        level per-offset (budget 0) and its near E dense in f64: 1.53 GB
        at 512^2, which the card holds (JAX re-forms it per apply for the
        v5e's memory).  The fast path's dense budget is the device memory
        left once everything else is resident (aniso_tpu operator.py:
        420-455 sums the same items): the twin, the coarse levels and
        their weights, the near E and the mode tables are allocated before
        it is read, and the Krylov basis is reserved."""
        g = self.grid
        tag = "64" if twin else ""
        t0 = time.perf_counter()
        coeffs = torch.as_tensor(coeffs_np, dtype=dtype, device=self.device)
        caches = {
            "sigma_w": torch.as_tensor(sigma_w, dtype=dtype,
                                       device=self.device),
            "near_E": build_near_E(g, coeffs),
        }
        self._sync()
        phases[f"near_E{tag}_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        for lv in list(coarse):
            coarse[lv] = coarse[lv].to(dtype)
        budget = 0 if twin else dense_budget_bytes(self.device)
        if not twin and budget is not None:
            # reserve the Krylov basis, which the solve allocates later
            itemsize = torch.finfo(dtype).bits // 8
            budget -= (self.cfg.restart + 1) * g.sz * g.sz * g.nq * itemsize
        caches["m2l_E"] = build_m2l_E(
            g, self._tcfg, self.cfg.np_cheb, coeffs, coarse,
            budget_bytes=budget,
        )
        if per_offset_levels(caches["m2l_E"]):
            caches["coeffs"] = coeffs
        self._sync()
        phases[f"m2l{tag}_s"] = time.perf_counter() - t0
        return caches

    def cache_report(self) -> dict:
        """Bytes per cache family (role of Aniso::displayKernelCacheSize,
        Aniso.cpp:19-47), in the port's unpadded GPU layouts; 'f64_twin'
        sums the twin's caches, whose coarse levels the fast path shares
        in float64."""
        def nbytes(t):
            return t.numel() * t.element_size()

        def family(c):
            return m2l_cache_bytes(c["m2l_E"]) + sum(
                nbytes(v) for k, v in c.items() if k != "m2l_E")

        rep = {}
        if self._caches is not None:
            rep["m2l_E"] = m2l_cache_bytes(self._caches["m2l_E"])
            rep["near_E"] = nbytes(self._caches["near_E"])
            rep["sigma_w"] = nbytes(self._caches["sigma_w"])
            if "coeffs" in self._caches:
                rep["coeffs"] = nbytes(self._caches["coeffs"])
            if self._caches64 is not None:
                rep["f64_twin"] = family(self._caches64)
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
        self.n_matvecs += 1
        return self._fmm(self._fmm_static, self._caches,
                         self._mode_statics[0], self._tensor(u))

    def _apply64(self, u) -> torch.Tensor:
        """K_0 u through the f64 twin (sz, sz, nq)."""
        self._require_twin()
        self.n_matvecs64 += 1
        return self._fmm(
            self._fmm_static64, self._caches64, self._mode_statics64[0],
            torch.as_tensor(u, dtype=torch.float64, device=self.device),
        )

    def _fmm(self, static, caches, mode_static, u) -> torch.Tensor:
        g = self.grid
        return fmm_apply_mode(
            self._tcfg.leaf_level, static, caches, mode_static, 0,
            u.reshape(g.sz, g.sz, g.nq).contiguous(),
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

    def _require_twin(self):
        if self._caches64 is None:
            raise RuntimeError("the f64 twin needs refine=True and set_coeff")

    def _forward64(self, u) -> torch.Tensor:
        """f64 twin of forward() for the refinement residuals."""
        self._require_twin()
        g = self.grid
        u = torch.as_tensor(u, dtype=torch.float64, device=self.device)
        u = u.reshape(1, g.sz, g.sz, g.nq)
        K = self._apply64(self._sigma_s64 * u[0])
        return u - self.chi[0] * K[None]

    def _rhs64(self, q) -> torch.Tensor:
        """f64 twin of rhs(): (1, sz, sz, nq)."""
        return self._apply64(q)[None]

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
              precond=None):
        """GMRES to cfg.tol (a GmresResult); with refine=True the refined
        solve to a true f64 residual (a RefinedResult)."""
        if self.cfg.refine:
            return refined_solve(self, charge, x0=x0, precond=precond)
        b = self.rhs(charge)
        return self.inner_gmres(b, self.cfg.tol, x0=x0, precond=precond)
