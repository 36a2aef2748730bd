"""Mixed-precision iterative refinement: f32 inner GMRES, f64 residuals.

Counterpart of aniso_tpu/solver/refine.py (:37-147), with the same loop:

    x_0 = 0
    repeat:  r_k = b - A x_k           (f64 twin operator, f64 caches)
             solve A d = r_k / |r_k|   (f32 GMRES to max(tol, 1e-6))
             x_{k+1} = x_k + |r_k| d   (f64 update)

Each round contracts the true residual by the inner solve's achievable
relative residual (~1e-6 in f32), so two rounds reach ~1e-11; the loop
stops on convergence, on a stall (a round that does not cut the residual
by 4x: the f64 operator's or the f32 contraction's floor), or after
MAX_REFINE rounds.  Starting from x_0 = 0, r_0 = b exactly and the first
f64 matvec is skipped.

The f64 state (b, x, r) stays on the solver's device; each round reads
its residual norm back as a Python float.  The solver is a
TransportSolver built with SolverConfig(refine=True, dtype="float32"):
its set_coeff builds the f64 twin (_forward64, _rhs64) next to the f32
fast path (forward, inner_gmres).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional, Tuple

import torch

MAX_REFINE = 10  # cap on inner solves; two reach 1e-11 from f32's ~1e-6


class RefinedResult(NamedTuple):
    x: torch.Tensor            # (1, sz, sz, nq) float64
    residual: float            # true f64 relative residual |b - A x| / |b|
    iterations: int            # total inner (f32) matvec count
    converged: bool
    refinements: int           # number of inner solves performed
    history: Tuple[float, ...]  # true relative residual before each round
    phases: Optional[dict] = None  # wall-clock breakdown (rhs64 / f64
    #   residual matvecs / inner f32 solves / f64 updates), host-timed
    #   with every step forced to completion


def refined_solve(
    solver,
    charge,
    x0=None,
    precond=None,
) -> RefinedResult:
    """Solve (I - K sigma_s) x = K q to cfg.tol by refinement."""
    tol = solver.cfg.tol
    # the f32 Givens-estimate floor is ~5e-7; the achieved true inner
    # residual is then ~1e-6, which is the per-round contraction
    inner_tol = max(tol, 1e-6)
    phases = {"rhs64_s": 0.0, "forward64_s": [], "inner_s": [],
              "inner_iters": [], "update_s": 0.0}
    f64 = torch.float64
    dev = solver.device
    shape = (1,) + solver.grid.nodes_x.shape
    q = torch.as_tensor(charge, dtype=f64, device=dev).reshape(shape)

    t0 = time.perf_counter()
    b = solver._rhs64(q)
    bnorm = float(torch.linalg.vector_norm(b))
    phases["rhs64_s"] = time.perf_counter() - t0
    if bnorm == 0.0:
        return RefinedResult(torch.zeros(shape, dtype=f64, device=dev), 0.0,
                             0, True, 0, (), phases)

    x = (torch.zeros(shape, dtype=f64, device=dev) if x0 is None
         else torch.as_tensor(x0, dtype=f64, device=dev).reshape(shape))
    total_inner = 0
    history = []
    for k in range(MAX_REFINE):
        # starting from zero, r = b exactly: skip one f64 matvec
        t0 = time.perf_counter()
        r = b if (x0 is None and k == 0) else b - solver._forward64(x)
        rnorm = float(torch.linalg.vector_norm(r))
        phases["forward64_s"].append(time.perf_counter() - t0)
        rel = rnorm / bnorm
        history.append(rel)
        if rel <= tol:
            return RefinedResult(x, rel, total_inner, True, k,
                                 tuple(history), phases)
        if k > 0 and rel > 0.25 * history[-2]:
            # stalled at the floor of the f64 operator / f32 contraction;
            # more rounds cannot help
            return RefinedResult(x, rel, total_inner, False, k,
                                 tuple(history), phases)
        t0 = time.perf_counter()
        res = solver.inner_gmres((r / rnorm).to(solver.dtype), inner_tol,
                                 precond=precond)
        solver._sync()
        phases["inner_s"].append(time.perf_counter() - t0)
        phases["inner_iters"].append(int(res.iterations))
        total_inner += int(res.iterations)
        t0 = time.perf_counter()
        x = x + rnorm * res.x.to(f64)
        solver._sync()
        phases["update_s"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    rel = float(torch.linalg.vector_norm(b - solver._forward64(x))) / bnorm
    phases["forward64_s"].append(time.perf_counter() - t0)
    history.append(rel)
    return RefinedResult(
        x, rel, total_inner, rel <= tol, MAX_REFINE, tuple(history), phases
    )
