"""aniso_torch's DSA preconditioner against aniso_tpu's, f64 on the CPU.

The same inputs, made from a numpy seed, go through the JAX functions and
the port's: the cell average, the diffusion apply (the plain version of the
CUDA kernel K9d) and its Jacobi diagonal to 1e-13 of the maximum, the CG
(the same iteration count, x to 1e-10), the preconditioner's action to 1e-9
with the thick-cell damping on and off, and the preconditioned solve of the
JAX package's own test_dsa_accelerates_fmm_backend: the same two iteration
counts and x to 1e-8.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.solver import dsa as j_dsa
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.core.config import SolverConfig
from aniso_torch.core.geometry import make_grid
from aniso_torch.kernels import diffusion
from aniso_torch.solver import dsa as t_dsa
from aniso_torch.solver.operator import TransportSolver


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def diffusion_inputs(sz, seed):
    rng = np.random.default_rng(seed)
    D = 0.5 / (1.0 + 20 * rng.random((sz, sz)))
    sig_a = 0.1 + rng.random((sz, sz))
    return D, sig_a, 1.0 / sz, rng


def test_cell_average_matches_jax():
    g = make_grid(8, 3)
    v = np.random.default_rng(0).standard_normal(g.nodes_x.shape)
    want = np.asarray(j_dsa.cell_average(g, jnp.asarray(v)))
    got = t_dsa.cell_average(g, torch.as_tensor(v))
    assert got.shape == (8, 8)
    assert rel(got.numpy(), want) < 1e-13


@pytest.mark.parametrize("sz", [1, 2, 8, 16])
def test_diffusion_apply_and_diagonal_match_jax(sz):
    """sz = 1 and 2: every cell touches two or more sides of the domain."""
    D, sig_a, dx, rng = diffusion_inputs(sz, sz)
    j_apply, j_diag = j_dsa.make_diffusion_apply(
        jnp.asarray(D), jnp.asarray(sig_a), dx)
    t_apply, t_diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D), torch.as_tensor(sig_a), dx)
    assert rel(t_diag.numpy(), np.asarray(j_diag)) < 1e-13
    for _ in range(2):
        z = rng.standard_normal((sz, sz))
        assert rel(t_apply(torch.as_tensor(z)).numpy(),
                   np.asarray(j_apply(jnp.asarray(z)))) < 1e-13


def test_face_coeffs_match_jax():
    D, _, dx, _ = diffusion_inputs(8, 3)
    want = j_dsa._face_coeffs(jnp.asarray(D), dx)
    got = t_dsa._face_coeffs(torch.as_tensor(D), dx)
    assert got[0].shape == (7, 8) and got[1].shape == (8, 7)
    for a, b in zip(got, want):
        assert a.is_contiguous()
        assert rel(a.numpy(), np.asarray(b)) < 1e-14


def test_diffusion_plain_is_what_the_cpu_wrapper_runs():
    D, sig_a, dx, rng = diffusion_inputs(8, 4)
    Dx, Dy, robin = t_dsa._face_coeffs(torch.as_tensor(D), dx)
    z = torch.as_tensor(rng.standard_normal((8, 8)))
    n0 = dict(diffusion.launches)
    got = diffusion.diffusion_apply(z, Dx, Dy, robin, torch.as_tensor(sig_a),
                                    dx)
    want = diffusion.diffusion_apply_plain(z, Dx, Dy, robin,
                                           torch.as_tensor(sig_a), dx)
    assert torch.equal(got, want)
    assert diffusion.launches == n0          # no kernel launch on the CPU


def test_diffusion_wrapper_refuses_tensors_off_the_cpu_without_a_kernel():
    """A tensor that is neither on the CPU nor a launchable CUDA tensor is
    refused, never computed by the plain version; so is another dtype."""
    def t(shape, dtype=torch.float64):
        return torch.empty(shape, dtype=dtype, device="meta")

    args = (t((8, 8)), t((7, 8)), t((8, 7)), t((8, 8)), t((8, 8)))
    with pytest.raises(ValueError):
        diffusion.diffusion_apply(*args, 0.125)
    with pytest.raises(TypeError):
        diffusion.diffusion_apply(*(a.half() for a in args), 0.125)


@pytest.mark.parametrize("tol,max_iter", [(1e-8, 500), (1e-12, 2000),
                                          (1e-12, 7)])
def test_pcg_matches_jax(tol, max_iter):
    """The same x to 1e-10 and the same iteration count: JAX's CG returns
    no count, so it is run again capped at the port's count (the same x,
    bitwise) and at one less (another x)."""
    D, sig_a, dx, rng = diffusion_inputs(16, 5)
    b = rng.standard_normal((16, 16))
    j_apply, j_diag = j_dsa.make_diffusion_apply(
        jnp.asarray(D), jnp.asarray(sig_a), dx)
    t_apply, t_diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D), torch.as_tensor(sig_a), dx)
    want = np.asarray(j_dsa.pcg(j_apply, j_diag, jnp.asarray(b), tol=tol,
                                max_iter=max_iter))
    got = t_dsa.pcg(t_apply, t_diag, torch.as_tensor(b), tol=tol,
                    max_iter=max_iter)
    k = got.iterations
    assert 0 < k <= max_iter
    assert rel(got.x.numpy(), want) < 1e-10
    at_k = np.asarray(j_dsa.pcg(j_apply, j_diag, jnp.asarray(b), tol=tol,
                                max_iter=k))
    before = np.asarray(j_dsa.pcg(j_apply, j_diag, jnp.asarray(b), tol=tol,
                                  max_iter=k - 1))
    assert np.array_equal(at_k, want)
    assert not np.array_equal(before, want)
    if max_iter > 7:
        r = b - t_apply(got.x).numpy()
        assert np.linalg.norm(r) <= tol * np.linalg.norm(b) * (1 + 1e-6)


def test_pcg_zero_rhs():
    D, sig_a, dx, _ = diffusion_inputs(4, 6)
    apply, diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D), torch.as_tensor(sig_a), dx)
    res = t_dsa.pcg(apply, diag, torch.zeros(4, 4, dtype=torch.float64))
    assert res.iterations == 0 and float(res.x.abs().max()) == 0.0


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
    want = np.asarray(jp(jnp.asarray(h)))
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
