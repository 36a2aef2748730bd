"""aniso_torch's GMRES and FMM solve against aniso_tpu's, f64 on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.solver.gmres import gmres as j_gmres
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.core.config import SolverConfig
from aniso_torch.solver.gmres import gmres as t_gmres
from aniso_torch.solver.operator import TransportSolver


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


@pytest.mark.parametrize("compat", [False, True])
def test_fmm_solve_16_matches_jax(compat):
    kw = dict(domain_size=16, quad_rule=3, kernel_size=1, g=0.95,
              sing_rule=8, np_cheb=4, dtype="float64", tol=1e-10,
              restart=80, max_iter=400, compat_global_basis=compat)
    js = JSolver(JConfig(**kw), backend="fmm")
    ts = TransportSolver(SolverConfig(**kw), device="cpu")
    g = ts.grid
    sig = 16 * 0.5 * (1 - np.cos(2 * np.pi * g.nodes_x))
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    js.set_coeff(sig, sig + 0.2)
    ts.set_coeff(sig, sig + 0.2)
    ref = js.solve(q)
    got = ts.solve(q)
    assert got.converged
    assert got.iterations == int(ref.iterations)
    x_ref = np.asarray(ref.x)
    assert got.x.shape == x_ref.shape == (1, 16, 16, 9)
    assert np.abs(got.x.numpy() - x_ref).max() / np.abs(x_ref).max() < 1e-10
    b = ts.rhs(q)
    true_res = torch.linalg.vector_norm(ts.forward(got.x) - b) \
        / torch.linalg.vector_norm(b)
    assert float(true_res) < 1e-10 * 10


@pytest.mark.parametrize("change,backend", [
    ({"kernel_size": 2}, "fmm"),
    ({"refine": True, "dtype": "float32", "refine_twin": "host"}, "fmm"),
    ({}, "dense"),
])
def test_later_slices_raise(change, backend):
    cfg = SolverConfig(domain_size=8, quad_rule=2, **change)
    with pytest.raises(NotImplementedError):
        TransportSolver(cfg, backend=backend, device="cpu")


def test_precond_and_higher_modes_raise():
    ts = TransportSolver(SolverConfig(domain_size=8, quad_rule=2,
                                      np_cheb=3), device="cpu")
    g = ts.grid
    ts.set_coeff(np.ones(g.nodes_x.shape), 2 * np.ones(g.nodes_x.shape))
    q = np.ones(g.nodes_x.shape)
    with pytest.raises(NotImplementedError):
        ts.solve(q, precond=lambda v: v)
    with pytest.raises(NotImplementedError):
        ts.apply_mode(1, q)
