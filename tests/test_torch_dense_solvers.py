"""aniso_torch's dense backend against aniso_tpu's, f64 on the CPU: the
larger solvers, split from test_torch_dense.py (whose helpers they use) so
that no test file holds a test worker much longer than the others.

The deg 9 dense operator (past K7's compiled degrees) against JAX's; the FMM
against the dense operator in torch; the DSA-preconditioned dense solve
against JAX's; the float32 dense matvec against the float64 one.
Tolerances as stated in each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.core.config import SolverConfig
from aniso_torch.solver.operator import TransportSolver

from test_torch_dense import pure_jax, rel, sigma

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_dense_operator_deg9_matches_jax():
    """deg 9, past K7's compiled degrees (1-8; the card takes it in K7's
    runtime-deg instance): the port's dense smooth matrix (K7's plain
    version) at 2^2 against JAX's, built with its pure line integral, to
    1e-13, and the dense operator on a seeded field to 1e-10.  The operator
    also holds the real (geometry) matrix, which at deg 9 came out 2.7e-11
    from JAX's in 3 of 8 fresh processes of the same code on a loaded
    8-core CPU host, and 1.2e-16 in the others.  (JAX's pure line integral holds a
    chunk of 256 rows' pairs x crossings x Gauss points x deg^2 basis
    values at once: 17 GB at 4^2, 2.4 GB here.)"""
    kw = dict(domain_size=2, quad_rule=9, kernel_size=1, g=0.8,
              sing_rule=10, np_cheb=4, dtype="float64")
    js = JSolver(JConfig(**kw), backend="dense")
    ts = TransportSolver(SolverConfig(**kw), backend="dense", device="cpu")
    with pure_jax():
        js.set_coeff(*sigma(js.grid))
    ts.set_coeff(*sigma(ts.grid))
    assert ts._k_smooth.shape == (1, 324, 324)
    assert rel(ts._k_smooth[0].numpy(), js._k_smooth[0]) < 1e-13
    u = np.random.default_rng(9).standard_normal(ts.grid.nodes_x.shape)
    got = ts.apply_mode(0, u)
    err = rel(got.numpy(), js.apply_mode(0, jnp.asarray(u)))
    assert err < 1e-10, err


@pytest.mark.parametrize("sz", [8, 16])
def test_fmm_matches_dense(sz):
    """The counterpart of tests/test_fmm.py::test_fmm_matches_dense: FMM
    matvec == dense matvec within the np = 4 Chebyshev truncation."""
    cfg = SolverConfig(domain_size=sz, quad_rule=2, kernel_size=2,
                       sing_rule=6, np_cheb=4)
    dense = TransportSolver(cfg, backend="dense", device="cpu")
    fmm = TransportSolver(cfg, backend="fmm", device="cpu")
    g = dense.grid
    sig_s = 4.0 + 2.0 * np.sin(2 * np.pi * g.nodes_x) * g.nodes_y
    dense.set_coeff(sig_s, sig_s + 0.2)
    fmm.set_coeff(sig_s, sig_s + 0.2)
    u = np.random.default_rng(1234).standard_normal((sz, sz, g.nq))
    for m in range(3):
        a = dense.apply_mode(m, u).numpy()
        b = fmm.apply_mode(m, u).numpy()
        assert np.abs(a - b).max() / np.abs(a).max() < 6e-3, m


def test_dense_dsa_solve_matches_jax():
    """The DSA-preconditioned solve on the dense backend (8^2, deg 2,
    sigma_s = 20, the correction undamped so that it acts at tau = 2.5):
    JAX's iteration count, and x to 1e-8 (the preconditioner's CG stops at
    its own tol 1e-8, as in test_torch_dsa.py)."""
    from aniso_tpu.solver.dsa import DsaPreconditioner as JDsa
    from aniso_torch.solver.dsa import DsaPreconditioner

    kw = dict(domain_size=8, quad_rule=2, kernel_size=1, g=0.5, sing_rule=6,
              dtype="float64", tol=1e-10, restart=80, max_iter=200)
    js = JSolver(JConfig(**kw), backend="dense")
    ts = TransportSolver(SolverConfig(**kw), backend="dense", device="cpu")
    sig = np.full_like(ts.grid.nodes_x, 20.0)
    with pure_jax():
        js.set_coeff(sig, sig + 0.2)
    ts.set_coeff(sig, sig + 0.2)
    q = np.exp(-25 * ((ts.grid.nodes_x - 0.5) ** 2
                      + (ts.grid.nodes_y - 0.5) ** 2))[None]
    ref = js.solve(jnp.asarray(q), precond=JDsa(js, damping=False))
    pre = DsaPreconditioner(ts, damping=False)
    got = ts.solve(q, precond=pre)
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    assert pre.cg_iterations and pre.cg_iterations[-1] > 0
    assert rel(got.x.numpy(), ref.x) < 1e-8


def test_dense_float32_matches_float64():
    """In float32 the matrices are K7's float64 ones cast, and the GEMVs
    run in float32: the matvec stays within float32 rounding of the f64
    one (sums of 576 terms: 1e-5 of the maximum)."""
    kw = dict(domain_size=8, quad_rule=3, kernel_size=1, sing_rule=8,
              compat_global_basis=True)
    f64 = TransportSolver(SolverConfig(**kw, dtype="float64"),
                          device="cpu")
    f32 = TransportSolver(SolverConfig(**kw, dtype="float32"),
                          device="cpu")
    for s in (f64, f32):
        s.set_coeff(*sigma(s.grid))
    assert f32._k_smooth.dtype == torch.float32
    assert torch.equal(f32._k_smooth, f64._k_smooth.float())
    u = np.random.default_rng(9).standard_normal((8, 8, 9))
    want = f64.apply_mode(0, u).numpy()
    got = f32.apply_mode(0, u)
    assert got.dtype == torch.float32
    assert rel(got.double().numpy(), want) < 1e-5
