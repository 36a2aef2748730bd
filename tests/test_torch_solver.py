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
    ts = TransportSolver(SolverConfig(**kw), backend="fmm",
                         device="cpu")
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
    ({}, "sparse"),
    ({"refine": True, "dtype": "float32", "refine_twin": "host"}, "fmm"),
    ({"refine": True, "dtype": "float32"}, "dense"),
])
def test_later_slices_raise(change, backend):
    cfg = SolverConfig(domain_size=8, quad_rule=2, **change)
    with pytest.raises(NotImplementedError):
        TransportSolver(cfg, backend=backend, device="cpu")


@pytest.fixture(scope="module")
def pair_n2():
    """(JAX, port) N = 2 solvers at 8^2 with the same medium, built once:
    the tests below solve and apply, and change neither."""
    kw = dict(domain_size=8, quad_rule=2, kernel_size=2, g=0.7, np_cheb=3,
              sing_rule=6, tol=1e-10)
    js = JSolver(JConfig(**kw), backend="fmm")
    ts = TransportSolver(SolverConfig(**kw), backend="fmm",
                         device="cpu")
    g = ts.grid
    sig = 4 * (1 + 0.5 * np.sin(2 * np.pi * g.nodes_x) * np.cos(3 * g.nodes_y))
    js.set_coeff(sig, sig + 0.3)
    ts.set_coeff(sig, sig + 0.3)
    return js, ts


def test_precond_and_higher_modes_raise(pair_n2):
    """What used to raise now runs: the N = 2 solver builds, its modes
    0..2 match JAX's, and a solve with the identity as preconditioner is
    the plain solve.  A mode outside 0..2N-2 still raises."""
    js, ts = pair_n2
    g = ts.grid
    assert ts.n_modes == 3 and len(ts._mode_statics) == 3
    u = np.random.default_rng(5).standard_normal(g.nodes_x.shape)
    for m in range(3):
        want = np.asarray(js.apply_mode(m, jnp.asarray(u)))
        got = ts.apply_mode(m, u).numpy()
        assert np.abs(got - want).max() / np.abs(want).max() < 1e-12
    with pytest.raises(ValueError):
        ts.apply_mode(3, u)
    q = np.stack([np.exp(-25 * ((g.nodes_x - 0.5) ** 2
                                + (g.nodes_y - 0.5) ** 2)),
                  np.zeros(g.nodes_x.shape)])
    plain = ts.solve(q)
    same = ts.solve(q, precond=lambda v: v)
    assert plain.converged and same.iterations == plain.iterations
    assert torch.equal(same.x, plain.x)


def test_n2_solve_matches_jax(pair_n2):
    """The coupled two-mode solve: the same iteration count and x to
    1e-10."""
    js, ts = pair_n2
    g = ts.grid
    q = np.random.default_rng(6).standard_normal((2,) + g.nodes_x.shape)
    ref = js.solve(jnp.asarray(q))
    got = ts.solve(q)
    assert got.converged and got.iterations == int(ref.iterations)
    x_ref = np.asarray(ref.x)
    assert got.x.shape == x_ref.shape == (2, 8, 8, 4)
    assert np.abs(got.x.numpy() - x_ref).max() / np.abs(x_ref).max() < 1e-10


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
