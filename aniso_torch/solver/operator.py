"""The corrected transport operator and the solver facade, N >= 1 coupled
Fourier modes, on the dense or the FMM backend.

Counterpart of aniso_tpu/solver/operator.py (reference main.cpp:78-141 for
one mode, aniso.m:121-156 for N):

  K_m u = (1/2pi) [ smooth_m(w u) + real_m(w u) + NearStencil_m u ]
  forward:  (A u)_i = u_i - sum_j chi_|j| K_|i-j|(sigma_s u_|j|)
  rhs:      b_i = sum_j K_|i-j|(q_|j|)            j = -(N-1) .. N-1

with chi_i = (g^i - g^N) / (1 - g^N).  The sums are a static (N, N, D)
combination tensor C[i, a, d] over the charge index a = |j| and the kernel
mode d = |i - j|, D = 2N - 1 (_mode_coupling).

backend="dense" (the default, as in JAX) stores the all-pairs smooth and
real matrices of every mode (ops.dense; the smooth ones built by the CUDA
kernel K7) and applies them with two GEMVs plus the near stencil, which
carries the coarse removal term; exact, for validation and the reference
CLI's grids (2 D n^2 itemsize bytes).  backend="fmm" builds the
mode-independent E caches once (fmm.smooth) and runs the FMM matvec
(fmm.apply) through the CUDA kernels K1, K2, K3 and K8; for each charge a one
all-modes sweep (fmm.apply.fmm_apply_all_modes) gives K_d(v_a) for every d
from one read of the E caches.  Both run in float32 or float64.  With
refine=True (fmm, dtype float32), set_coeff also builds the f64 twin of
the operator on the device and solve() runs solver.refine.refined_solve:
f32 inner GMRES, f64 outer residuals (aniso_tpu/solver/operator.py:157-182,
261-272, 462-483).  solve takes a left preconditioner
(solver.dsa.DsaPreconditioner) on either backend.

Not ported (raises NotImplementedError): the host numpy twin
(refine_twin="host").  refine=True with the dense backend raises as in JAX.

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
from ..fmm.apply import (
    build_fmm_static, build_mode_static, fmm_apply_all_modes, fmm_apply_mode,
    mode_view, stack_mode_statics,
)
from ..fmm.smooth import (
    build_m2l_E, build_m2l_E_coarse_all, build_near_E, dense_budget_bytes,
    m2l_cache_bytes, per_offset_levels,
)
from ..fmm.structure import tree_config
from ..kernels._cuda import resolve_device
from ..kernels.m2l import check_np
from ..ops import dense as dense_ops
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


def _mode_coupling(N: int, chi: np.ndarray, weighted: bool) -> np.ndarray:
    """C[i, a, d] such that out_i = sum_{a,d} C[i,a,d] K_d(u_a).

    Encodes the reference mode loops (aniso.m:121-156): j runs over
    -(N-1)..N-1 with a = |j|, d = |i - j|; `weighted` multiplies chi_|j|
    (forward/mforward) -- rhs uses chi = 1.
    """
    D = 2 * N - 1
    C = np.zeros((N, N, D))
    for i in range(N):
        for j in range(-(N - 1), N):
            w = chi[abs(j)] if weighted else 1.0
            C[i, abs(j), abs(i - j)] += w
    return C


def mode_chi(N: int, g: float) -> np.ndarray:
    """chi_i = (g^i - g^N) / (1 - g^N)  (KernelFactory.cpp:18-20); at g = 0
    only mode 0 scatters."""
    if g == 0.0:
        return np.array([1.0] + [0.0] * (N - 1))
    return (g ** np.arange(N) - g ** N) / (1.0 - g ** N)


class TransportSolver:
    """Facade playing the role of the reference `Aniso` + `aniso.m`
    orchestration."""

    def __init__(self, cfg: SolverConfig, backend: str = "dense",
                 device=None):
        cfg.validate()
        if backend not in ("dense", "fmm"):
            raise NotImplementedError(backend)
        if cfg.refine and backend != "fmm":
            raise NotImplementedError(
                "refine=True needs the fmm backend (dense runs f64 as-is)"
            )
        if cfg.refine and cfg.refine_twin == "host":
            raise NotImplementedError(
                "refine_twin='host' (the numpy twin on the host) is not "
                "ported; the f64 twin lives on the device"
            )
        self.device = resolve_device(device)
        self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
        if backend == "fmm" and self.device.type == "cuda":
            # the card's M2L kernels take np up to a limit (a row of 27 np^2
            # values in shared memory): refuse before anything is built
            for dt in {self.dtype, torch.float64 if cfg.refine else None}:
                if dt is not None:
                    check_np(cfg.np_cheb, dt)
        self.cfg = cfg
        self.backend_name = backend
        self.grid = make_grid(cfg.domain_size, cfg.quad_rule)
        N = cfg.kernel_size
        self.n_modes = 2 * N - 1
        self.chi = mode_chi(N, cfg.g)
        self._C_fwd, self._C_rhs = self._couplings(self.dtype)

        # geometry-only near stencils per mode; the FMM path omits the
        # real-kernel U list, so its stencils carry no removal term
        near = [
            build_near_stencil(self.grid, m, cfg.sing_rule,
                               cfg.compat_global_basis,
                               include_removal=backend == "dense")
            for m in range(self.n_modes)
        ]
        self.sigma_s = None
        self.sigma_t = None
        self.sigma_t_coeff = None
        self.set_coeff_phases = {}
        self.n_matvecs = 0
        self.n_matvecs64 = 0
        self._caches = None
        self._caches64 = None
        self._sigma_s64 = None
        self._k_smooth = None
        self._k_real = None
        # the captured Arnoldi steps of inner_gmres (solver.gmres) and what
        # forward() read when they were captured: set_coeff drops them, and
        # so does inner_gmres once any of it was replaced
        self._graphs = {}
        self._graph_reads = []
        if backend == "dense":
            self._stencils = [self._tensor(st) for st, _ in near]
            self._duffys = [None if d is None else self._tensor(d)
                            for _, d in near]
            self._dense_pairs = self._pairs()
        else:
            self._init_fmm(near)

    def _couplings(self, dtype):
        """(C_fwd, C_rhs) in `dtype` on the device."""
        return tuple(
            torch.as_tensor(_mode_coupling(self.cfg.kernel_size, self.chi,
                                           weighted),
                            dtype=dtype, device=self.device)
            for weighted in (True, False))

    def _init_fmm(self, near):
        """The tree, the sweep operators and the per-mode tables; with
        refine=True their f64 twin and its coupling tensors."""
        cfg = self.cfg
        self._tcfg = tree_config(cfg.domain_size, cfg.max_level)

        def statics(dtype):
            """(sweep operators, the D modes' tables stacked, the same per
            mode as views of the stack) in `dtype`."""
            stack = stack_mode_statics([
                build_mode_static(self.grid, self._tcfg, cfg.np_cheb, m,
                                  stencil, duffy, self.device, dtype)
                for m, (stencil, duffy) in enumerate(near)
            ])
            return (
                build_fmm_static(self.grid, cfg.np_cheb, self.device, dtype),
                stack,
                [mode_view(stack, m) for m in range(self.n_modes)],
            )

        (self._fmm_static, self._mode_stack,
         self._mode_statics) = statics(self.dtype)
        if cfg.refine:
            # the f64 twin of the operator for the outer residuals
            (self._fmm_static64, self._mode_stack64,
             self._mode_statics64) = statics(torch.float64)
            self._C_fwd64, self._C_rhs64 = self._couplings(torch.float64)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # -- coefficient setting (reference AnisoWrapper 'setCoeff' + 'cache') --

    def set_coeff(self, sigma_s, sigma_t):
        """sigma_s / sigma_t: nodal fields shaped (sz, sz, nq) (or flat).

        The sigma pipeline (projection, compat transform, node evaluation)
        runs on the host in f64.  Dense: the real matrices, then the smooth
        ones through K7 (raises first if they do not fit the card).  FMM:
        the coarse M2L levels are built in f64 on the device (K6) or, the
        few-box ones, on the host engine; with refine=True the f64 twin
        comes next; then the near E and the M2L levels in the solver's
        dtype, whose fine levels are dense while they fit the device memory
        left and per-offset beyond."""
        g = self.grid
        # release the previous caches first, and the graphs that read them
        self._graphs, self._graph_reads = {}, []
        self._caches = self._caches64 = None
        self._k_smooth = self._k_real = None
        shape = (g.sz, g.sz, g.nq)
        sig_s_np = np.asarray(sigma_s, np.float64).reshape(shape)
        sig_t_np = np.asarray(sigma_t, np.float64).reshape(shape)
        self.sigma_s = self._tensor(sig_s_np)
        self.sigma_t = self._tensor(sig_t_np)
        coeffs_np = project_field(g, sig_t_np)
        self.sigma_t_coeff = self._tensor(coeffs_np)
        # under the reference's global-basis quirk, evaluate with transformed
        # coefficients in the (translation-invariant) local basis
        if self.cfg.compat_global_basis:
            coeffs_np = to_local_equivalent(g, coeffs_np)
        sigma_nodes = evaluate_at_nodes_np(g, coeffs_np)
        phases = {}
        self.set_coeff_phases = phases
        if self.backend_name == "dense":
            self._build_dense(coeffs_np, sigma_nodes, phases)
            return
        sigma_w = sigma_nodes * (g.w2d * 0.25 * g.dx * g.dx)

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

    def _build_dense(self, coeffs_np, sigma_nodes, phases: dict):
        """The (D, n, n) real and smooth matrices (aniso_tpu operator.py:
        320-328), in the solver's dtype."""
        g, D = self.grid, self.n_modes
        dense_ops.check_dense_fits(g, D, self.dtype, self.device)
        t0 = time.perf_counter()
        n = g.n_nodes
        self._k_real = torch.empty((D, n, n), dtype=self.dtype,
                                   device=self.device)
        for m in range(D):
            dense_ops.build_dense_real(g, m, self.device, out=self._k_real[m])
        self._sync()
        phases["dense_real_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self._k_smooth = dense_ops.build_dense_smooth_all(
            g, range(D), coeffs_np, sigma_nodes, self.device, self.dtype)
        self._sync()
        phases["dense_smooth_s"] = time.perf_counter() - t0

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
            # reserve the Krylov basis, which the solve allocates later:
            # restart + 1 vectors of N fields
            itemsize = torch.finfo(dtype).bits // 8
            budget -= ((self.cfg.restart + 1) * self.cfg.kernel_size
                       * g.sz * g.sz * g.nq * itemsize)
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
        Aniso.cpp:19-47), in the port's unpadded GPU layouts: the dense
        backend's 'dense_smooth' and 'dense_real' matrices, or the FMM's E
        caches, where 'f64_twin' sums the twin's caches, whose coarse levels
        the fast path shares in float64."""
        def nbytes(t):
            return t.numel() * t.element_size()

        def family(c):
            return m2l_cache_bytes(c["m2l_E"]) + sum(
                nbytes(v) for k, v in c.items() if k != "m2l_E")

        rep = {}
        if self._k_smooth is not None:
            rep["dense_smooth"] = nbytes(self._k_smooth)
            rep["dense_real"] = nbytes(self._k_real)
        if self._caches is not None:
            rep["m2l_E"] = m2l_cache_bytes(self._caches["m2l_E"])
            rep["near_E"] = nbytes(self._caches["near_E"])
            rep["sigma_w"] = nbytes(self._caches["sigma_w"])
            if "coeffs" in self._caches:
                rep["coeffs"] = nbytes(self._caches["coeffs"])
            if self._caches64 is not None:
                rep["f64_twin"] = family(self._caches64)
            ms = self._mode_stack       # every mode's tables
            rep["mode_statics"] = (
                sum(nbytes(t) for t in ms["m2l_cosr"].values())
                + nbytes(ms["near_cosrw"]) + nbytes(ms["near_static"])
                + (0 if ms["duffy"] is None else nbytes(ms["duffy"]))
            )
        rep["total"] = sum(rep.values())
        return rep

    # -- corrected matvec (reference MEX 'mapping') --

    def _require_coeff(self):
        if self._caches is None and self._k_smooth is None:
            raise RuntimeError("call set_coeff first")

    def apply_mode(self, m: int, u) -> torch.Tensor:
        """K_m u on a (sz, sz, nq) charge (AnisoWrapper.cpp:92-136), for any
        m in 0..2N-2.  n_matvecs counts it."""
        if not 0 <= m < self.n_modes:
            raise ValueError(f"mode {m} outside 0..{self.n_modes - 1}")
        self._require_coeff()
        self.n_matvecs += 1
        if self.backend_name == "dense":
            return dense_ops.dense_apply(
                self._k_smooth[m], self._k_real[m], self._stencils[m],
                self._duffys[m], self.grid, self._field(self._tensor(u)))
        return fmm_apply_mode(
            self._tcfg.leaf_level, self._fmm_static, self._caches,
            self._mode_statics[m], m, self._field(self._tensor(u)),
        )

    def _field(self, u: torch.Tensor) -> torch.Tensor:
        g = self.grid
        return u.reshape(g.sz, g.sz, g.nq).contiguous()

    def _modes(self, u, dtype) -> torch.Tensor:
        """u as (N, sz, sz, nq) on the device in `dtype`."""
        g = self.grid
        u = torch.as_tensor(u, dtype=dtype, device=self.device)
        return u.reshape(self.cfg.kernel_size, g.sz, g.sz, g.nq)

    def _coupled(self, C, v, twin: bool = False) -> torch.Tensor:
        """out_i = sum_{a,d} C[i, a, d] K_d(v_a).  FMM: one all-modes sweep
        per charge a, accumulated over a (aniso_tpu operator.py:217-226);
        n_matvecs (n_matvecs64 for the twin) counts the sweeps.  Dense: each
        K_d(v_a) that the reference loops use applied once (aniso_tpu
        operator.py:583-615), every apply counted."""
        if self.backend_name == "dense":
            return self._coupled_dense(C, v)
        if twin:
            static, caches, stack = (self._fmm_static64, self._caches64,
                                     self._mode_stack64)
        else:
            static, caches, stack = (self._fmm_static, self._caches,
                                     self._mode_stack)
        out = None
        for a in range(self.cfg.kernel_size):
            Ka = fmm_apply_all_modes(self._tcfg.leaf_level, static, caches,
                                     stack, self._field(v[a]))
            acc = torch.einsum("id,dxyq->ixyq", C[:, a], Ka)
            out = acc if out is None else out + acc
        if twin:
            self.n_matvecs64 += self.cfg.kernel_size
        else:
            self.n_matvecs += self.cfg.kernel_size
        return out

    def _pairs(self) -> list:
        """[(charge a, the modes d it meets, the same as a device index)]:
        the index lives on the device so that a matvec copies nothing from
        the host (a captured step may not)."""
        N = self.cfg.kernel_size
        pairs = {}
        for i in range(N):
            for j in range(-(N - 1), N):
                pairs.setdefault(abs(j), set()).add(abs(i - j))
        return [(a, sorted(ds), torch.tensor(sorted(ds), device=self.device))
                for a, ds in sorted(pairs.items())]

    def _coupled_dense(self, C, v) -> torch.Tensor:
        out = None
        for a, ds, ds_index in self._dense_pairs:
            Ka = torch.stack([self.apply_mode(d, v[a]) for d in ds])
            acc = torch.einsum("id,dxyq->ixyq", C[:, a, ds_index], Ka)
            out = acc if out is None else out + acc
        return out

    # -- forward operators --

    def rhs(self, charge) -> torch.Tensor:
        """Multi-mode rhs (aniso.m:121-137).  charge: (N, sz, sz, nq)."""
        self._require_coeff()
        return self._coupled(self._C_rhs, self._modes(charge, self.dtype))

    def forward(self, u) -> torch.Tensor:
        """(A u)_i = u_i - sum_j chi_|j| K_|i-j|(sigma_s u_|j|)
        (aniso.m:139-156; main.cpp:125-136 for N = 1)."""
        self._require_coeff()
        u = self._modes(u, self.dtype)
        return u - self._coupled(self._C_fwd, self.sigma_s * u)

    def _require_twin(self):
        if self._caches64 is None:
            raise RuntimeError("the f64 twin needs refine=True and set_coeff")

    def _apply64(self, u) -> torch.Tensor:
        """K_0 u through the f64 twin (sz, sz, nq)."""
        self._require_twin()
        self.n_matvecs64 += 1
        return fmm_apply_mode(
            self._tcfg.leaf_level, self._fmm_static64, self._caches64,
            self._mode_statics64[0], 0,
            self._field(torch.as_tensor(u, dtype=torch.float64,
                                        device=self.device)),
        )

    def _forward64(self, u) -> torch.Tensor:
        """f64 twin of forward() for the refinement residuals."""
        self._require_twin()
        u = self._modes(u, torch.float64)
        return u - self._coupled(self._C_fwd64, self._sigma_s64 * u,
                                 twin=True)

    def _rhs64(self, q) -> torch.Tensor:
        """f64 twin of rhs(): (N, sz, sz, nq)."""
        self._require_twin()
        return self._coupled(self._C_rhs64, self._modes(q, torch.float64),
                             twin=True)

    def _forward_reads(self) -> list:
        """Every object forward() reads from the caches (the leaves of
        sigma_s, _caches, the dense matrices and the sweep operators that
        K8 reads), whose addresses a captured step holds."""
        leaves = []

        def walk(v):
            if isinstance(v, dict):
                for w in v.values():
                    walk(w)
            elif isinstance(v, (list, tuple)):
                for w in v:
                    walk(w)
            elif v is not None:
                leaves.append(v)

        walk([self.sigma_s, self._caches, self._k_smooth, self._k_real,
              getattr(self, "_fmm_static", None)])
        return leaves

    def inner_gmres(self, b, tol, x0=None, precond=None) -> GmresResult:
        """GMRES on forward(), left-preconditioned when `precond` (the
        action of the preconditioner on an (N, sz, sz, nq) field) is
        given.  On the card its Arnoldi step is a CUDA graph, captured at
        the first solve of each dtype, shape and restart, with a
        preconditioner or without, and again for another preconditioner
        object (solver.gmres).  The graphs are dropped by set_coeff, and
        here when anything forward() reads was replaced since they were
        captured (a cache entry swapped by hand).  The counts a step makes
        (n_matvecs, n_matvecs64, the preconditioner's `calls`, the kernels'
        launches) are added on each replay."""
        b = self._modes(b, self.dtype)
        x0 = None if x0 is None else self._modes(x0, self.dtype)
        reads = self._forward_reads()
        if (len(reads) != len(self._graph_reads)
                or any(a is not c for a, c in zip(reads, self._graph_reads))):
            self._graphs, self._graph_reads = {}, reads
        # the host counters a captured step bumps besides the kernels'
        counters = [(self, "n_matvecs"), (self, "n_matvecs64")]
        if hasattr(precond, "calls"):
            counters.append((precond, "calls"))
        return gmres(
            self.forward, b, x0, restart=self.cfg.restart,
            max_iter=self.cfg.max_iter, tol=tol, precond=precond,
            graphs=self._graphs, counters=counters,
        )

    # -- solve (aniso.m:159-173 / main.cpp:138-141) --

    def solve(self, charge, x0: Optional[torch.Tensor] = None,
              precond=None):
        """GMRES to cfg.tol (a GmresResult); with refine=True the refined
        solve to a true f64 residual (a RefinedResult).  With `precond`
        (solver.dsa.DsaPreconditioner) the reported residual is the
        preconditioned one."""
        if self.cfg.refine:
            return refined_solve(self, charge, x0=x0, precond=precond)
        b = self.rhs(charge)
        return self.inner_gmres(b, self.cfg.tol, x0=x0, precond=precond)
