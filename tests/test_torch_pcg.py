"""K9, the DSA preconditioner's CG (aniso_torch.kernels.pcg), against the
JAX package's pcg.

On the CPU the wrapper runs its plain version: the same inputs, made from a
numpy seed, go through aniso_tpu.solver.dsa.pcg and the port's pcg at 1^2,
8^2 and 16^2 cells in f64.  x agrees to 1e-12 of its maximum (the same f64
recurrences, the stencil's adds in the same order), and the iteration count
equals the count of JAX's loop recomputed here in numpy with JAX's stencil
(JAX's pcg returns no count).  The tests marked `cuda` hold the kernel
against pcg_plain on the card (x within 1e-4 of |x| in float32 and 1e-10
in float64, the counts within 1 in float64 and 15% in float32: the same
loop, each operation rounded alike, its dot products summed in another
order, which at tol 1e-8 moves where a float32 residual below the type's
resolution crosses it) and skip without one; they import no JAX (run them on the
card with `python -m pytest tests/test_torch_pcg.py -m cuda --noconftest`).
"""

import numpy as np
import pytest
import torch

from aniso_torch.kernels import _cuda
from aniso_torch.kernels import pcg as k9
from aniso_torch.solver import dsa as t_dsa


def diffusion_inputs(sz, seed):
    """A medium with sigma_t in [1, 21) and absorption in [0.1, 1.1), and
    a right-hand side, from a numpy seed."""
    rng = np.random.default_rng(seed)
    D = 0.5 / (1.0 + 20 * rng.random((sz, sz)))
    sig_a = 0.1 + rng.random((sz, sz))
    return D, sig_a, 1.0 / sz, rng.standard_normal((sz, sz))


def jax_dsa():
    """(jax.numpy, aniso_tpu.solver.dsa), imported by the CPU tests only."""
    import jax.numpy as jnp
    from aniso_tpu.solver import dsa

    return jnp, dsa


def jax_count(apply, diag, b, tol, max_iter):
    """Iterations of aniso_tpu/solver/dsa.py:pcg (:114-141) recomputed in
    numpy, the stencil JAX's own."""
    jnp, _ = jax_dsa()
    diag, b = np.asarray(diag), np.asarray(b)
    inv_diag = 1.0 / diag
    bnorm2 = np.sum(b * b)
    bnorm2 = 1.0 if bnorm2 == 0.0 else bnorm2
    x, r = np.zeros_like(b), b
    z = inv_diag * r
    p, rz = z, np.sum(r * z)
    k = 0
    while k < max_iter and np.sum(r * r) > tol * tol * bnorm2:
        ap = np.asarray(apply(jnp.asarray(p)))
        alpha = rz / np.sum(p * ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = np.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return k


CASES = ([(sz, tol, 500) for sz in (1, 8, 16) for tol in (1e-8, 1e-12)]
         + [(16, 1e-12, 7)])


@pytest.mark.parametrize("sz,tol,max_iter", CASES)
def test_pcg_cpu_matches_jax(sz, tol, max_iter):
    """The wrapper on CPU tensors (pcg_plain, no launch) against JAX's pcg;
    (16, 1e-12, 7) stops at max_iter."""
    jnp, j_dsa = jax_dsa()
    D, sig_a, dx, b = diffusion_inputs(sz, sz)
    j_apply, j_diag = j_dsa.make_diffusion_apply(
        jnp.asarray(D), jnp.asarray(sig_a), dx)
    st, diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D), torch.as_tensor(sig_a), dx)
    want = np.asarray(j_dsa.pcg(j_apply, j_diag, jnp.asarray(b), tol=tol,
                                max_iter=max_iter))
    n0 = dict(k9.launches)
    got = k9.pcg(torch.as_tensor(b), diag, *st, tol=tol, max_iter=max_iter)
    assert k9.launches == n0
    assert got.iterations == jax_count(j_apply, j_diag, b, tol, max_iter)
    assert 0 < got.iterations <= max_iter
    assert (got.iterations == max_iter) == (max_iter == 7)
    err = np.abs(got.x.numpy() - want).max() / np.abs(want).max()
    assert err < 1e-12


@pytest.mark.parametrize("sz", [1, 8, 16])
def test_pcg_zero_rhs_matches_jax(sz):
    """b = 0: no iteration, x = 0, as JAX (b.b taken as 1)."""
    jnp, j_dsa = jax_dsa()
    D, sig_a, dx, _ = diffusion_inputs(sz, 20 + sz)
    j_apply, j_diag = j_dsa.make_diffusion_apply(
        jnp.asarray(D), jnp.asarray(sig_a), dx)
    st, diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D), torch.as_tensor(sig_a), dx)
    b = np.zeros((sz, sz))
    got = k9.pcg(torch.as_tensor(b), diag, *st)
    want = np.asarray(j_dsa.pcg(j_apply, j_diag, jnp.asarray(b)))
    assert got.iterations == 0 == jax_count(j_apply, j_diag, b, 1e-8, 500)
    assert float(got.x.abs().max()) == 0.0 == np.abs(want).max()


def test_dsa_pcg_is_the_wrapper():
    """solver.dsa.pcg on the stencil make_diffusion_apply returns is K9's
    wrapper: the same x and count, bitwise, on the CPU."""
    D, sig_a, dx, b = diffusion_inputs(8, 3)
    st, diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D), torch.as_tensor(sig_a), dx)
    b = torch.as_tensor(b)
    got = t_dsa.pcg(st, diag, b, tol=1e-10, max_iter=300)
    want = k9.pcg_plain(b, diag, *st, tol=1e-10, max_iter=300)
    assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x)


def _meta(sz, dtype=torch.float64):
    def t(shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device="meta")

    return [t((sz, sz)), t((sz, sz)), t((sz - 1, sz)), t((sz, sz - 1)),
            t((sz, sz)), t((sz, sz))]


@pytest.mark.parametrize("bad", ["diag", "Dx", "Dy", "robin", "sigma_a"])
def test_pcg_refuses_mismatched_shapes_and_dtypes(bad):
    """Off the CPU the wrapper checks every input before any launch: a
    wrong shape raises ValueError, a dtype other than b's TypeError, a
    float16 b TypeError; correct inputs off a card raise ValueError."""
    names = ["b", "diag", "Dx", "Dy", "robin", "sigma_a"]
    i = names.index(bad)
    args = _meta(8)
    args[i] = torch.empty((3, 5), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="shape"):
        k9.pcg(*args, 0.125)
    args = _meta(8)
    args[i] = args[i].float()
    with pytest.raises(TypeError):
        k9.pcg(*args, 0.125)
    with pytest.raises(TypeError):
        k9.pcg(*[a.half() for a in _meta(8)], 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        k9.pcg(*_meta(8), 0.125)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(sz, dtype, device, seed=0):
    D, sig_a, dx, b = diffusion_inputs(sz, seed)
    st, diag = t_dsa.make_diffusion_apply(
        torch.as_tensor(D, dtype=dtype).to(device),
        torch.as_tensor(sig_a, dtype=dtype).to(device), dx)
    return torch.as_tensor(b, dtype=dtype).to(device), diag, st


# relative to |x|: float32 after hundreds of iterations of the same
# recurrences with dot products summed in another order; float64 to 1e-10
_X_GATE = {torch.float32: 1e-4, torch.float64: 1e-10}
# iteration counts: within 1 in float64, 15% of plain's in float32
_COUNT_GATE = {torch.float32: 0.15, torch.float64: 0.0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sz", [8, 64, 128, 512])
def test_pcg_kernel_matches_plain_on_card(cuda_device, dtype, sz):
    """K9 (one cooperative launch: 1 to 2 cells a thread at these sizes)
    against pcg_plain on the same card tensors at the DSA preconditioner's
    tol 1e-8 and dsa512's max_iter; the count stays on the card until
    read."""
    b, diag, st = _card_inputs(sz, dtype, cuda_device, seed=sz)
    inst = _cuda.INSTANCES[dtype]
    n0 = k9.launches[inst]
    got = k9.pcg(b, diag, *st, tol=1e-8, max_iter=4000)
    assert k9.launches[inst] == n0 + 1
    assert isinstance(got.iterations, torch.Tensor)
    assert got.iterations.device.type == "cuda"
    want = k9.pcg_plain(b, diag, *st, tol=1e-8, max_iter=4000)
    k = int(got.iterations)
    assert 0 < k < 4000
    assert abs(k - want.iterations) <= max(1, _COUNT_GATE[dtype]
                                           * want.iterations)
    err = float(torch.linalg.vector_norm(got.x - want.x)
                / torch.linalg.vector_norm(want.x))
    assert err <= _X_GATE[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_pcg_kernel_stops_where_plain_does_on_card(cuda_device, dtype):
    """b = 0 takes no iteration and returns x = 0; max_iter = 7 stops at
    7."""
    b, diag, st = _card_inputs(64, dtype, cuda_device, seed=5)
    zero = k9.pcg(torch.zeros_like(b), diag, *st)
    assert int(zero.iterations) == 0 and float(zero.x.abs().max()) == 0.0
    capped = k9.pcg(b, diag, *st, tol=1e-12, max_iter=7)
    want = k9.pcg_plain(b, diag, *st, tol=1e-12, max_iter=7)
    assert int(capped.iterations) == 7 == want.iterations
    err = float(torch.linalg.vector_norm(capped.x - want.x)
                / torch.linalg.vector_norm(want.x))
    assert err <= _X_GATE[dtype]


@pytest.mark.cuda
def test_pcg_grid_too_large_raises_on_card(cuda_device):
    """4096^2 cells exceed 16 cells a thread of every block the card holds
    at once: the cooperative launch is refused, with no smaller path."""
    b, diag, st = _card_inputs(4096, torch.float32, cuda_device)
    n0 = k9.launches["f32"]
    with pytest.raises(RuntimeError):
        k9.pcg(b, diag, *st)
    assert k9.launches["f32"] == n0
