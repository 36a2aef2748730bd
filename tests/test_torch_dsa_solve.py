"""aniso_torch's DSA preconditioner against aniso_tpu's, f64 on the CPU:
the preconditioner and the preconditioned solves, split from
test_torch_dsa.py (whose helper they use) so that the test workers start
them after the files with more cases.

The preconditioner's action to 1e-9 with the thick-cell damping on and off,
and the preconditioned solve of the JAX package's own
test_dsa_accelerates_fmm_backend: the same two iteration counts and x to
1e-8; the coupled N = 2 solve likewise.  Each (JAX, port) pair of solvers
is built once a worker; the tests read them and change neither.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.solver import dsa as j_dsa
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.core.config import SolverConfig
from aniso_torch.solver import dsa as t_dsa
from aniso_torch.solver.operator import TransportSolver

from test_torch_dsa import rel
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@functools.lru_cache(maxsize=None)
def _pair(sz, N, g, sigma_s_val=20.0, **kw):
    cfg = dict(domain_size=sz, quad_rule=2, kernel_size=N, g=g, sing_rule=6,
               np_cheb=4, dtype="float64", tol=1e-10, restart=200,
               max_iter=300)
    cfg.update(kw)
    js = JSolver(JConfig(**cfg), backend="fmm")
    ts = TransportSolver(SolverConfig(**cfg), backend="fmm",
                         device="cpu")
    sig = np.full_like(ts.grid.nodes_x, sigma_s_val)
    js.set_coeff(sig, sig + 0.2)
    ts.set_coeff(sig, sig + 0.2)
    return js, ts


@pytest.mark.parametrize("damping", [True, False])
@pytest.mark.parametrize("sz,N", [(16, 1), (8, 2)])
def test_dsa_call_matches_jax(sz, N, damping):
    """The preconditioner's action on an (N, sz, sz, nq) field (and, for
    N = 1, on a bare (sz, sz, nq) one): mode 0 corrected, the others passed
    through.  At 8^2 (tau = 2.5) the damping switches the correction off;
    at 16^2 (tau = 1.26) it keeps almost all of it."""
    js, ts = _pair(sz, N, 0.5)
    jp = j_dsa.DsaPreconditioner(js, damping=damping)
    tp = t_dsa.DsaPreconditioner(ts, damping=damping)
    assert np.abs(tp.theta.numpy() - np.asarray(jp.theta)).max() < 1e-13
    h = np.random.default_rng(7).standard_normal((N,) + ts.grid.nodes_x.shape)
    # under jit, as JAX's jitted solve runs its preconditioner: called
    # eagerly, each of its primitives compiles on its own
    want = np.asarray(jax.jit(jp)(jnp.asarray(h)))
    got = tp(torch.as_tensor(h))
    assert got.shape == want.shape
    assert rel(got.numpy(), want) < 1e-9
    assert tp.cg_iterations and tp.cg_iterations[-1] > 0
    if N > 1:
        assert torch.equal(got[1:], torch.as_tensor(h)[1:])
    else:
        bare = tp(torch.as_tensor(h[0]))
        assert torch.equal(bare, got[0])
    changed = not torch.equal(got[0], torch.as_tensor(h)[0])
    assert changed == (not (damping and sz == 8))


def test_dsa_needs_coefficients():
    ts = TransportSolver(SolverConfig(domain_size=8, quad_rule=2, np_cheb=3),
                         backend="fmm", device="cpu")
    with pytest.raises(RuntimeError):
        t_dsa.DsaPreconditioner(ts)


def test_dsa_solve_32_matches_jax():
    """The JAX package's test_dsa_accelerates_fmm_backend (32^2, g = 0,
    sigma_s = 20, fmm, f64): the same iteration counts plain and
    preconditioned, x to 1e-8, and the acceleration it gates."""
    js, ts = _pair(32, 1, 0.0)
    g = ts.grid
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    ref_plain = js.solve(jnp.asarray(q)[None])
    ref_dsa = js.solve(jnp.asarray(q)[None],
                       precond=j_dsa.DsaPreconditioner(js))
    pre = t_dsa.DsaPreconditioner(ts)
    plain = ts.solve(q)
    got = ts.solve(q, precond=pre)
    assert plain.converged and got.converged
    assert plain.iterations == int(ref_plain.iterations)
    assert got.iterations == int(ref_dsa.iterations)
    assert got.iterations <= plain.iterations - 8
    assert rel(plain.x.numpy(), np.asarray(ref_plain.x)) < 1e-8
    assert rel(got.x.numpy(), np.asarray(ref_dsa.x)) < 1e-8
    # one CG solve per preconditioner call: b, r0, each iteration, and the
    # true residual of the restart cycle
    assert len(pre.cg_iterations) == got.iterations + 3


def test_dsa_multimode_solve_matches_jax():
    """N = 2, g = 0.9 at 16^2: the preconditioned coupled solve, the same
    iterations as JAX and x to 1e-8."""
    js, ts = _pair(16, 2, 0.9, tol=1e-9)
    g = ts.grid
    q = np.zeros((2,) + g.nodes_x.shape)
    q[0] = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    ref = js.solve(jnp.asarray(q), precond=j_dsa.DsaPreconditioner(js))
    got = ts.solve(q, precond=t_dsa.DsaPreconditioner(ts))
    assert got.converged and got.iterations == int(ref.iterations)
    assert rel(got.x.numpy(), np.asarray(ref.x)) < 1e-8
