"""aniso_torch's dense backend against aniso_tpu's, f64 on the CPU.

The plain version of K7 (the exact line integral) against JAX's
make_line_integral on random and degenerate pairs; the kernels, the sigma
evaluation and the near stencil; the dense matrices (JAX's pure line
integral: the reference's native library is kept out, its build races
between test workers); dense_apply on JAX's matrices carried across by
aniso_torch.convert; the dense solver's apply_mode / forward / rhs / solve
(the deg 9 operator, the FMM against the dense operator, the DSA solve and
float32 are in test_torch_dense_solvers.py).  Tolerances: 1e-13 of the
maximum for line integrals and matrices (the same f64 quadrature summed in
another order), 1e-12 for the operators, 1e-10 for the solve's x.
"""

import contextlib
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import aniso_tpu.native
from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.core.geometry import make_grid as j_make_grid
from aniso_tpu.ops import attenuation as j_att
from aniso_tpu.ops import dense as j_dense
from aniso_tpu.ops import kernels as j_kernels
from aniso_tpu.ops import stencil as j_stencil
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch import native as t_native
from aniso_torch.convert import dense_from_jax_numpy
from aniso_torch.core.config import SolverConfig
from aniso_torch.core.geometry import make_grid, project_field
from aniso_torch.kernels import attenuation as k7
from aniso_torch.ops import attenuation as t_att
from aniso_torch.ops import dense as t_dense
from aniso_torch.ops import kernels as t_kernels
from aniso_torch.ops import stencil as t_stencil
from aniso_torch.ops.compat import to_local_equivalent
from aniso_torch.ops.fields import evaluate_at_nodes_np
from aniso_torch.solver.operator import TransportSolver

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def sigma(grid):
    s = 16 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x)) \
        + np.sin(3 * grid.nodes_y) ** 2
    return s, s + 0.2


def degenerate_pairs(sz):
    """Axis-aligned segments both ways, segments through grid corners,
    endpoints on grid lines, zero length (inside a cell and on a line)."""
    h = 1.0 / sz
    return np.array([
        [(0.3, 0.2), (0.3, 0.9)], [(0.3, 0.9), (0.3, 0.2)],
        [(0.1, 0.55), (0.8, 0.55)], [(0.8, 0.55), (0.1, 0.55)],
        [(0.5 * h, 0.5 * h), (2.5 * h, 2.5 * h)],
        [(2.5 * h, 0.5 * h), (0.5 * h, 2.5 * h)],
        [(0.0, 0.0), (1.0, 1.0)], [(1.0, 0.0), (0.0, 1.0)],
        [(h, 0.3), (3 * h, 0.7)], [(0.25, 0.5), (0.75, 0.25)],
        [(2 * h, 2 * h), (2 * h, 0.9)], [(0.0, 0.4), (1.0, 0.4)],
        [(0.37, 0.61), (0.37, 0.61)], [(2 * h, 3 * h), (2 * h, 3 * h)],
    ])


# (sz, max_cross, n_pieces) of the plain version; JAX takes its dense
# builds' bounds, (sz, 1) up to 8 and (8, ceil(sz / 6)) above
BOUNDS = [(4, 4, 1), (8, 8, 1), (8, 4, 2), (16, 8, 3), (16, 16, 1)]


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("sz,max_cross,n_pieces", BOUNDS)
def test_line_integral_plain_matches_jax(sz, max_cross, n_pieces, compat):
    rng = np.random.default_rng(sz + 10 * max_cross)
    g, jg = make_grid(sz, 3), j_make_grid(sz, 3)
    coeffs = rng.standard_normal((sz, sz, 9)) + 3.0
    deg = degenerate_pairs(sz)
    p0 = np.concatenate([rng.random((300, 2)), deg[:, 0]])
    p1 = np.concatenate([rng.random((300, 2)), deg[:, 1]])
    jb = (sz, 1) if sz <= 8 else (8, -(-sz // 6))
    want = np.asarray(j_att.line_integral_batch(
        jg, jnp.asarray(coeffs), jnp.asarray(p0), jnp.asarray(p1), jb[0],
        compat, jb[1]))
    got = t_att.line_integral_batch(g, t(coeffs), t(p0), t(p1), max_cross,
                                    compat, n_pieces).numpy()
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    # zero-length segments contribute exactly nothing
    assert np.all(got[-2:] == 0.0)


@pytest.mark.parametrize("compat", [False, True])
def test_line_integral_plain_matches_host_engine(compat):
    """The port's plain line integral against its host engine (the
    reference's crossing split with a sort, in C++)."""
    rng = np.random.default_rng(5)
    g = make_grid(8, 2)
    coeffs = rng.standard_normal((8, 8, 4)) + 2.0
    p0, p1 = rng.random((400, 2)), rng.random((400, 2))
    want = t_native.attenuation_batch(g, coeffs, p0, p1, compat)
    got = k7.line_integral_pairs(g, t(coeffs), t(p0), t(p1), compat).numpy()
    assert rel(got, want) < 1e-13


@pytest.mark.parametrize("compat", [False, True])
def test_sigma_eval_matches_jax(compat):
    rng = np.random.default_rng(3)
    g, jg = make_grid(8, 3), j_make_grid(8, 3)
    coeffs = rng.standard_normal((8, 8, 9))
    x, y = rng.random(200), rng.random(200)
    want = j_att.make_sigma_eval(jg, compat)(jnp.asarray(coeffs),
                                             jnp.asarray(x), jnp.asarray(y))
    got = t_att.make_sigma_eval(g, compat)(t(coeffs), t(x), t(y))
    assert rel(got.numpy(), want) < 1e-14


@pytest.mark.parametrize("m", [0, 1, 2, 5])
def test_mode_kernels_match_jax(m):
    rng = np.random.default_rng(m)
    ax, ay, bx, by = rng.random((4, 50))
    bx[:5], by[:5] = ax[:5], ay[:5]                  # r = 0 entries
    E = rng.random(50)
    diag = rng.random(50)
    J = [jnp.asarray(v) for v in (ax, ay, bx, by)]
    T = [t(v) for v in (ax, ay, bx, by)]
    assert rel(t_kernels.cos_m_theta(m, T[0] - T[2], T[1] - T[3]).numpy(),
               j_kernels.cos_m_theta(m, J[0] - J[2], J[1] - J[3])) < 1e-14
    assert rel(t_kernels.real_kernel(m, *T).numpy(),
               j_kernels.real_kernel(m, *J)) < 1e-14
    got = t_kernels.smooth_kernel_from_E(m, *T, t(E), t(diag)).numpy()
    want = j_kernels.smooth_kernel_from_E(m, *J, jnp.asarray(E),
                                          jnp.asarray(diag))
    assert rel(got, want) < 1e-14
    assert rel(t_kernels.anisotropy_weights(0.8, m + 1).numpy(),
               j_kernels.anisotropy_weights(0.8, m + 1)) < 1e-15
    assert rel(t_kernels.anisotropy_weights(0.0, m + 1).numpy(),
               j_kernels.anisotropy_weights(0.0, m + 1)) == 0.0


def test_stencils_match_jax():
    rng = np.random.default_rng(4)
    st = rng.standard_normal((3, 3, 9, 9))
    per = rng.standard_normal((6, 6, 9, 9))
    u = rng.standard_normal((6, 6, 9))
    assert rel(t_stencil.apply_near_stencil(t(st), t(u)).numpy(),
               j_stencil.apply_near_stencil(jnp.asarray(st),
                                            jnp.asarray(u))) < 1e-14
    assert rel(t_stencil.apply_per_square(t(per), t(u)).numpy(),
               j_stencil.apply_per_square(jnp.asarray(per),
                                          jnp.asarray(u))) < 1e-14


@contextlib.contextmanager
def pure_jax():
    """JAX's line integral in place of the reference's native library."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aniso_tpu.native, "available", lambda: False)
        yield


@functools.lru_cache(maxsize=None)
def matrices(compat):
    """(JAX's, the port's) smooth and real matrices of modes 0..2 at 8^2,
    deg 3, for the operator's coefficients (compat-transformed as in
    set_coeff)."""
    g, jg = make_grid(8, 3), j_make_grid(8, 3)
    coeffs = project_field(g, sigma(g)[1])
    if compat:
        coeffs = to_local_equivalent(g, coeffs)
    nodes = evaluate_at_nodes_np(g, coeffs)
    js = j_dense.build_dense_smooth_all(jg, range(3), jnp.asarray(coeffs),
                                        jnp.asarray(nodes), use_native=False)
    jr = [j_dense.build_dense_real(jg, m) for m in range(3)]
    ks = t_dense.build_dense_smooth_all(g, range(3), coeffs, nodes, "cpu")
    kr = [t_dense.build_dense_real(g, m, "cpu") for m in range(3)]
    return [np.asarray(k) for k in js], [np.asarray(k) for k in jr], ks, kr


@pytest.mark.parametrize("compat", [False, True])
def test_dense_matrices_match_jax(compat):
    js, jr, ks, kr = matrices(compat)
    assert ks.shape == (3, 576, 576)
    for m in range(3):
        assert rel(ks[m].numpy(), js[m]) < 1e-13
        assert rel(kr[m].numpy(), jr[m]) < 1e-13


@pytest.mark.parametrize("compat", [False, True])
def test_dense_apply_matches_jax(compat):
    """The port's dense_apply on JAX's matrices (convert) against JAX's,
    and on its own matrices."""
    js, jr, ks, kr = matrices(compat)
    g = make_grid(8, 3)
    from aniso_tpu.ops.near import build_near_stencil as j_near

    cs, cr = dense_from_jax_numpy(js, jr, "cpu", F64)
    u = np.random.default_rng(7).standard_normal((8, 8, 9))
    for m in range(3):
        st, dy = j_near(j_make_grid(8, 3), m, 8, compat, include_removal=True)
        want = j_dense.dense_apply(
            jnp.asarray(js[m]), jnp.asarray(jr[m]), st, dy,
            j_make_grid(8, 3), jnp.asarray(u))
        dyt = None if dy is None else t(dy)
        got = t_dense.dense_apply(cs[m], cr[m], t(st), dyt, g, t(u))
        assert rel(got.numpy(), want) < 1e-13
        own = t_dense.dense_apply(ks[m], kr[m], t(st), dyt, g, t(u))
        assert rel(own.numpy(), want) < 1e-12


@pytest.mark.parametrize("m", [0, 1])
def test_single_mode_builds_match_jax(m):
    """build_dense_smooth (the line integral and the diagonal under the
    global-basis quirk) and build_dense_E at 4^2, deg 3."""
    rng = np.random.default_rng(11)
    g, jg = make_grid(4, 3), j_make_grid(4, 3)
    coeffs = project_field(g, 2.0 + rng.random((4, 4, 9)))
    for compat in (False, True):
        want = j_dense.build_dense_smooth(jg, m, jnp.asarray(coeffs),
                                          compat, use_native=False)
        got = t_dense.build_dense_smooth(g, m, coeffs, compat, "cpu")
        assert rel(got.numpy(), want) < 1e-13
    if m == 0:
        want = j_dense.build_dense_E(jg, jnp.asarray(coeffs),
                                     use_native=False)
        assert rel(t_dense.build_dense_E(g, coeffs, "cpu").numpy(),
                   want) < 1e-13


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("deg", [2, 3])
def test_whole_matrix_entry_matches_jax(deg, compat, dtype):
    """K7's whole-matrix entry (its plain version on the CPU) against JAX's
    build_dense_smooth_all at 4^2, modes 0-2: on the raw coefficients, or
    under the global-basis quirk (the basis at global coordinates on the
    raw coefficients; JAX on their local equivalent).  A float32 store
    rounds each value once (2^-24 relative): 1e-7 of the maximum there."""
    rng = np.random.default_rng(deg)
    g, jg = make_grid(4, deg), j_make_grid(4, deg)
    raw = project_field(g, 2.0 + rng.random((4, 4, deg * deg)))
    local = to_local_equivalent(g, raw) if compat else raw
    nodes = evaluate_at_nodes_np(g, local)
    with pure_jax():
        want = j_dense.build_dense_smooth_all(
            jg, range(3), jnp.asarray(local), jnp.asarray(nodes),
            use_native=False)
    got = k7.dense_smooth(g, t(raw), t(g.flat_nodes()),
                          t(g.weights.reshape(-1)), t(nodes).reshape(-1),
                          range(3), compat, dtype)
    assert got.dtype == dtype and got.shape == (3, 4 * 4 * deg * deg,
                                                4 * 4 * deg * deg)
    tol = 1e-13 if dtype == torch.float64 else 1e-7
    for m in range(3):
        assert rel(got[m].double().numpy(), want[m]) < tol


@functools.lru_cache(maxsize=None)
def solvers(N, compat):
    """(JAX, port) dense solvers at 8^2, deg 3, f64, N modes."""
    kw = dict(domain_size=8, quad_rule=3, kernel_size=N, g=0.8,
              sing_rule=8, np_cheb=4, dtype="float64", tol=1e-12,
              restart=60, max_iter=300, compat_global_basis=compat)
    js = JSolver(JConfig(**kw), backend="dense")
    ts = TransportSolver(SolverConfig(**kw), backend="dense", device="cpu")
    with pure_jax():
        js.set_coeff(*sigma(js.grid))
    ts.set_coeff(*sigma(ts.grid))
    return js, ts


@pytest.mark.parametrize("N,compat", [(1, True), (2, False)])
def test_dense_operator_matches_jax(N, compat):
    js, ts = solvers(N, compat)
    rng = np.random.default_rng(N)
    u = rng.standard_normal((N, 8, 8, 9))
    for m in range(2 * N - 1):
        n0 = ts.n_matvecs
        got = ts.apply_mode(m, u[0])
        assert ts.n_matvecs == n0 + 1
        assert rel(got.numpy(), js.apply_mode(m, jnp.asarray(u[0]))) < 1e-12
    assert rel(ts.forward(u).numpy(), js.forward(jnp.asarray(u))) < 1e-12
    assert rel(ts.rhs(u).numpy(), js.rhs(jnp.asarray(u))) < 1e-12
    rep = ts.cache_report()
    n2 = (2 * N - 1) * 576 ** 2 * 8
    assert rep == {"dense_smooth": n2, "dense_real": n2, "total": 2 * n2}


@pytest.mark.parametrize("N,compat", [(1, True), (2, False)])
def test_dense_solve_matches_jax(N, compat):
    js, ts = solvers(N, compat)
    q = np.zeros((N, 8, 8, 9))
    g = ts.grid
    q[0] = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    ref = js.solve(jnp.asarray(q))
    got = ts.solve(q)
    assert got.converged and bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    assert rel(got.x.numpy(), ref.x) < 1e-10
    b = ts.rhs(q)
    true_res = torch.linalg.vector_norm(ts.forward(got.x) - b) \
        / torch.linalg.vector_norm(b)
    assert float(true_res) < 1e-11


def test_default_backend_matches_jax():
    cfg = dict(domain_size=8, quad_rule=2)
    ts = TransportSolver(SolverConfig(**cfg), device="cpu")
    assert ts.backend_name == JSolver(JConfig(**cfg)).backend_name == "dense"


def test_dense_memory_check_raises(monkeypatch):
    """At 512^2 the matrices of one mode would take 44 TB: a message, no
    allocation."""
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (80 * 10 ** 9, 80 * 10 ** 9))
    g = make_grid(512, 3)
    assert t_dense.dense_bytes(g, 1, F64) == 2 * (512 * 512 * 9) ** 2 * 8
    with pytest.raises(MemoryError, match="use backend='fmm'"):
        t_dense.check_dense_fits(g, 1, F64, "cuda")
    t_dense.check_dense_fits(make_grid(8, 3), 1, F64, "cuda")
    t_dense.check_dense_fits(g, 1, F64, "cpu")


def test_subsegment_count():
    """K7's sub-segment count (its operation bound) against a walk of every
    pair."""
    g = make_grid(4, 2)
    pts = g.flat_nodes()
    sz = g.sz
    want = 0
    for a in pts[:10]:
        for b in pts:
            if (a == b).all():
                continue
            cells = np.floor(np.stack([a, b]) * sz)
            want += 1 + int(np.abs(cells[1] - cells[0]).sum())
    assert k7.subsegments(g, pts[:10], pts) == want

