"""aniso_torch's GMRES against aniso_tpu's, f64 on the CPU: plain and
left-preconditioned, and the configurations later slices took.  The FMM
solves are in test_torch_solver_fmm.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu.solver.gmres import gmres as j_gmres

from aniso_torch.core.config import SolverConfig
from aniso_torch.solver.gmres import gmres as t_gmres
from aniso_torch.solver.operator import TransportSolver

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("restart", [6, 50])
def test_gmres_matches_jax(restart):
    """Same iteration count and x to 1e-12 on a nonsymmetric system (with
    restart 6 the solve goes through several restart cycles)."""
    rng = np.random.default_rng(restart)
    n = 40
    A = rng.standard_normal((n, n)) / np.sqrt(n) * 0.6 + np.eye(n)
    b = rng.standard_normal(n)
    ref = j_gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                  restart=restart, max_iter=200, tol=1e-12)
    At = torch.as_tensor(A)
    got = t_gmres(lambda v: At @ v, torch.as_tensor(b), restart=restart,
                  max_iter=200, tol=1e-12)
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    x_ref = np.asarray(ref.x)
    assert np.abs(got.x.numpy() - x_ref).max() / np.abs(x_ref).max() < 1e-12
    assert abs(got.residual - float(ref.residual)) <= 1e-3 * float(ref.residual)


@pytest.mark.parametrize("change,backend", [
    ({}, "sparse"),
    ({"refine": True, "dtype": "float32", "refine_twin": "host"}, "fmm"),
    ({"refine": True, "dtype": "float32"}, "dense"),
])
def test_later_slices_raise(change, backend):
    """A backend the port lacks and refine on the dense backend (as in
    JAX) raise NotImplementedError.  The host f64 twin raised too until it
    was ported: now it constructs, its twin on the CPU."""
    cfg = SolverConfig(domain_size=8, quad_rule=2, **change)
    if change.get("refine_twin") == "host":
        s = TransportSolver(cfg, backend=backend, device="cpu")
        assert s._twin_device == torch.device("cpu")
        assert s._fmm_static64 is not None and s._C_fwd64.device.type == "cpu"
        return
    with pytest.raises(NotImplementedError):
        TransportSolver(cfg, backend=backend, device="cpu")


@pytest.mark.parametrize("restart", [5, 40])
def test_preconditioned_gmres_matches_jax(restart):
    """Left-preconditioned GMRES: the same iterations, x and (the
    preconditioned) residual as JAX's."""
    rng = np.random.default_rng(restart)
    n = 30
    A = rng.standard_normal((n, n)) / np.sqrt(n) * 0.8 + 2 * np.eye(n)
    P = np.linalg.inv(np.diag(np.diag(A)) + 0.1 * np.tril(A, -1))
    b = rng.standard_normal(n)
    ref = j_gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                  restart=restart, max_iter=200, tol=1e-12,
                  precond=lambda v: jnp.asarray(P) @ v)
    At, Pt = torch.as_tensor(A), torch.as_tensor(P)
    got = t_gmres(lambda v: At @ v, torch.as_tensor(b), restart=restart,
                  max_iter=200, tol=1e-12, precond=lambda v: Pt @ v)
    assert got.converged and got.iterations == int(ref.iterations)
    x_ref = np.asarray(ref.x)
    assert np.abs(got.x.numpy() - x_ref).max() / np.abs(x_ref).max() < 1e-12
    assert abs(got.residual - float(ref.residual)) <= 1e-3 * float(ref.residual)
