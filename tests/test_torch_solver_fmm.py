"""aniso_torch's FMM solve against aniso_tpu's, f64 on the CPU, split
from test_torch_solver.py so that the test workers start it after the
files with more cases: the one-mode 16^2 solve with compat off and on, and
the N = 2 solver's modes and coupled solve."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.core.config import SolverConfig
from aniso_torch.solver.operator import TransportSolver

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


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


def test_n2_modes_match_jax_and_identity_precond_is_plain(pair_n2):
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
