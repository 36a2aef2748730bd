"""aniso_torch's DSA preconditioner against aniso_tpu's, f64 on the CPU.

The same inputs, made from a numpy seed, go through the JAX functions and
the port's: the cell average, the diffusion apply (the plain version of the
CUDA kernel K9d) and its Jacobi diagonal to 1e-13 of the maximum, the CG
(the same iteration count, x to 1e-10).  The preconditioner and the
preconditioned solves are in test_torch_dsa_solve.py.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu.solver import dsa as j_dsa

from aniso_torch.core.geometry import make_grid
from aniso_torch.kernels import diffusion
from aniso_torch.solver import dsa as t_dsa

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


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


@functools.lru_cache(maxsize=None)
def pcg_problem():
    """b and JAX's and the port's 16^2 diffusion operator and diagonal,
    built once a worker for the CG cases."""
    D, sig_a, dx, rng = diffusion_inputs(16, 5)
    b = rng.standard_normal((16, 16))
    return (b,) + j_dsa.make_diffusion_apply(
        jnp.asarray(D), jnp.asarray(sig_a), dx) + t_dsa.make_diffusion_apply(
        torch.as_tensor(D), torch.as_tensor(sig_a), dx)


@pytest.mark.parametrize("tol,max_iter", [(1e-8, 500), (1e-12, 2000),
                                          (1e-12, 7)])
def test_pcg_matches_jax(tol, max_iter):
    """The same x to 1e-10 and the same iteration count: JAX's CG returns
    no count, so it is run again capped at the port's count (the same x,
    bitwise) and at one less (another x)."""
    b, j_apply, j_diag, t_apply, t_diag = pcg_problem()
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
