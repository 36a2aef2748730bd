"""The device-resident GMRES (aniso_torch.solver.gmres) and its step's
kernels K11 (CGS2) and K12 (Givens) against the JAX package's gmres.

On the CPU the wrappers run their plain versions, in float64, on inputs made
from a numpy seed:
  * K11's plain step against JAX's masked _dots / _comb pass (the body of
    aniso_tpu/solver/gmres.py's inner loop, :161-170) at i = 0, 5 and
    m - 1: the new basis vector and the column to 1e-13 relative, every
    other row untouched, and a no-op when the step is inactive;
  * K12's plain step against JAX's bookkeeping (:172-193) fed the same
    column, in each of _givens' three branches: cs, sn, s, H, resid, done,
    i and j to 1e-14 relative;
  * the whole gmres against JAX's: several restart cycles, max_iter reached
    mid-cycle, x0 given, converged at the first test, b = 0, a left
    preconditioner: iterations equal, x to 1e-12 and the residual to 1e-3
    relative (tests/test_torch_solver.py's gates); steps queued after
    convergence change neither x nor the count; host_reads within
    iterations + 2 cycles + 2;
  * the solver's plan cache: one plan with a preconditioner and one
    without, dropped by set_coeff and when a cache entry is replaced.
JAX is imported inside the CPU tests only.  The tests marked `cuda` hold the
kernels against the plain versions on the card, the captured step against
the eager one, and the captures anew against the CPU solver (run them there with `python -m pytest
tests/test_torch_gmres.py -m cuda --noconftest`).
"""

import numpy as np
import pytest
import torch

from aniso_torch.kernels import krylov
from aniso_torch.solver import gmres as t_gmres


def jax_gmres():
    """(jax.numpy, aniso_tpu.solver.gmres), for the CPU tests only."""
    import jax.numpy as jnp
    from aniso_tpu.solver import gmres

    return jnp, gmres


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / (scale if scale else 1.0)


def make_state(m, i, j=1, done=0.0, max_iter=100, normb=2.0, tol=1e-10):
    st = torch.zeros(krylov.state_layout(m).len, dtype=torch.float64)
    st[krylov.I], st[krylov.J], st[krylov.DONE] = i, j, done
    st[krylov.NORMB], st[krylov.TOL] = normb, tol
    st[krylov.MAX_ITER] = max_iter
    return st


# -- K11 --

M = 8
SHAPE = (2, 3, 4)
N = int(np.prod(SHAPE))


def cgs2_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M + 1,) + SHAPE),
            rng.standard_normal(SHAPE))


@pytest.mark.parametrize("i", [0, 5, M - 1])
def test_cgs2_plain_matches_jax(i):
    jnp, jg = jax_gmres()
    V, w = cgs2_inputs(i)
    # JAX's body (:161-170) on the same basis and w
    Vj, wj = jnp.asarray(V), jnp.asarray(w)
    mask = (jnp.arange(M + 1) <= i).astype(wj.dtype)
    h1 = jg._dots(Vj, wj) * mask
    wj = wj - jg._comb(Vj, h1)
    h2 = jg._dots(Vj, wj) * mask
    wj = wj - jg._comb(Vj, h2)
    wnorm = jnp.linalg.norm(wj)
    Vj = Vj.at[i + 1].set(wj / jnp.where(wnorm == 0.0, 1.0, wnorm))
    col = (h1 + h2).at[i + 1].set(wnorm)

    Vt = torch.as_tensor(V).reshape(M + 1, -1).clone()
    wt = torch.as_tensor(w).reshape(-1).clone()
    ut = torch.zeros(N, dtype=torch.float64)
    st = make_state(M, i)
    krylov.cgs2(Vt, wt, ut, st)
    L = krylov.state_layout(M)
    Vref = np.asarray(Vj).reshape(M + 1, -1)
    assert rel(Vt[i + 1], Vref[i + 1]) < 1e-13
    assert torch.equal(ut, Vt[i + 1])
    others = [k for k in range(M + 1) if k != i + 1]
    assert torch.equal(Vt[others],
                       torch.as_tensor(V).reshape(M + 1, -1)[others])
    assert rel(st[L.col:L.col + i + 2], np.asarray(col)[:i + 2]) < 1e-13
    # K11 changes no header entry: K12 moves i and j
    assert st[krylov.I] == i and st[krylov.J] == 1


@pytest.mark.parametrize("why", ["done", "i = m", "j > max_iter"])
def test_cgs2_inactive_step_is_a_no_op(why):
    V, w = cgs2_inputs(3)
    st = {"done": make_state(M, 2, done=1.0),
          "i = m": make_state(M, M),
          "j > max_iter": make_state(M, 2, j=8, max_iter=7)}[why]
    Vt = torch.as_tensor(V).reshape(M + 1, -1).clone()
    wt = torch.as_tensor(w).reshape(-1).clone()
    ut = torch.zeros(N, dtype=torch.float64)
    st0 = st.clone()
    krylov.cgs2(Vt, wt, ut, st)
    krylov.givens_step(st, M)
    assert torch.equal(Vt, torch.as_tensor(V).reshape(M + 1, -1))
    assert torch.equal(wt, torch.as_tensor(w).reshape(-1))
    assert not ut.any()
    assert torch.equal(st, st0)


# bench's field (64^2 squares, deg 3) and refined512's (512^2), restart 80,
# on an H100 (132 SMs, 227 KB of shared memory a block)
FIELDS = {"bench": 64 * 64 * 9, "512": 512 * 512 * 9}


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("field", sorted(FIELDS))
def test_cgs2_plan_reads_v_once_where_it_fits(field, item):
    """K11's plan is a cached pure function of (n, m, item, vec, SMs,
    shared memory): on bench's field one block an SM holds its chunk of V's
    80 rows and of w in shared memory (V read once), in float32 and
    float64; at 512^2 the chunk does not fit and V streams, with the rows
    of a tile it keeps; each fits a block; either branch can be asked
    for, a resident one that does not fit raises."""
    n, m, vec = FIELDS[field], 80, 16 // item
    plan = krylov.cgs2_plan(n, m, item, vec, 132)
    assert plan is krylov.cgs2_plan(n, m, item, vec, 132)
    assert plan.blocks == 132 and plan.chunk % vec == 0
    assert (plan.blocks - 1) * plan.chunk < n <= plan.blocks * plan.chunk
    assert plan.smem <= krylov.SMEM_BLOCK
    assert plan.resident == (field == "bench")
    head = 8 * ((2 + krylov.WARPS) * (m + 1))
    if plan.resident:
        assert plan.smem >= head + (m + 1) * plan.chunk * item
    else:
        assert 0 < plan.stash <= m
        assert plan.stash == m           # (b) reads V once too
        assert plan.smem >= head + plan.stash * krylov.TILE * 16
        with pytest.raises(ValueError, match="do not fit"):
            krylov.cgs2_plan(n, m, item, vec, 132, resident=True)
    streamed = krylov.cgs2_plan(n, m, item, vec, 132, resident=False)
    assert not streamed.resident and streamed.smem <= krylov.SMEM_BLOCK
    # a short row: fewer blocks, each at least MIN_VECTORS vectors
    short = krylov.cgs2_plan(4099, m, item, 1, 132)
    assert short.resident and short.chunk >= krylov.MIN_VECTORS
    assert (short.blocks - 1) * short.chunk < 4099 <= \
        short.blocks * short.chunk


# -- K12 --

def jax_givens_body(col, cs, sn, s, H, i, normb, tol):
    """JAX's bookkeeping after the column (:172-193), on JAX arrays."""
    from jax import lax

    jnp, jg = jax_gmres()

    def rot_body(k, colv):
        t = cs[k] * colv[k] + sn[k] * colv[k + 1]
        upd = -sn[k] * colv[k] + cs[k] * colv[k + 1]
        return colv.at[k].set(t).at[k + 1].set(upd)

    col = lax.fori_loop(0, i, rot_body, col)
    c_new, s_new = jg._givens(col[i], col[i + 1])
    cs = cs.at[i].set(c_new)
    sn = sn.at[i].set(s_new)
    col = col.at[i].set(c_new * col[i] + s_new * col[i + 1])
    col = col.at[i + 1].set(0.0)
    s_i = c_new * s[i] + s_new * s[i + 1]
    s_i1 = -s_new * s[i] + c_new * s[i + 1]
    s = s.at[i].set(s_i).at[i + 1].set(s_i1)
    H = H.at[:, i].set(col)
    resid = jnp.abs(s_i1) / normb
    return cs, sn, s, H, resid, resid < tol


@pytest.mark.parametrize("branch", ["dy == 0", "|dy| > |dx|", "else"])
@pytest.mark.parametrize("i", [0, 3, M - 1])
def test_givens_plain_matches_jax(i, branch):
    jnp, _ = jax_gmres()
    rng = np.random.default_rng(10 * i + len(branch))
    L = krylov.state_layout(M)
    # earlier rotations from real angles, an s from earlier steps, the
    # earlier columns of H
    ang = rng.uniform(0, 2 * np.pi, M)
    cs = np.where(np.arange(M) < i, np.cos(ang), 0.0)
    sn = np.where(np.arange(M) < i, np.sin(ang), 0.0)
    s = np.zeros(M + 1)
    s[:i + 1] = rng.standard_normal(i + 1)
    H = np.zeros((M + 1, M))
    H[:, :i] = np.triu(rng.standard_normal((M + 1, i)), -1)
    col = np.zeros(M + 1)
    col[:i + 1] = rng.standard_normal(i + 1)
    # col[i + 1] is no earlier rotation's: it alone picks the branch
    col[i + 1] = {"dy == 0": 0.0, "|dy| > |dx|": 1e3, "else": 1e-3}[branch]
    normb, tol = 2.5, 0.3

    st = make_state(M, i, j=i + 1, normb=normb, tol=tol)
    for off, val in ((L.cs, cs), (L.sn, sn), (L.s, s), (L.col, col)):
        st[off:off + len(val)] = torch.as_tensor(val)
    krylov.hessenberg(st, M)[:] = torch.as_tensor(H)
    krylov.givens_step(st, M)

    want = jax_givens_body(*(jnp.asarray(a) for a in (col, cs, sn, s, H)),
                           i, normb, tol)
    got = (st[L.cs:L.sn], st[L.sn:L.col], st[L.s:L.cs],
           krylov.hessenberg(st, M))
    for g, w in zip(got, want[:4]):
        assert rel(g, w) < 1e-14
    assert rel(st[krylov.RESID], want[4]) < 1e-14
    assert bool(st[krylov.DONE]) == bool(want[5])
    assert st[krylov.I] == i + 1 and st[krylov.J] == i + 2


def test_backsub_plain_solves_the_leading_block():
    rng = np.random.default_rng(4)
    k = 5
    st = make_state(M, k)
    H = np.triu(rng.standard_normal((M + 1, M))) + 4 * np.eye(M + 1, M)
    s = rng.standard_normal(M + 1)
    L = krylov.state_layout(M)
    krylov.hessenberg(st, M)[:] = torch.as_tensor(H)
    st[L.s:L.cs] = torch.as_tensor(s)
    krylov.givens_backsub(st, M)
    y = st[L.y:L.len].numpy()
    assert rel(y[:k], np.linalg.solve(H[:k, :k], s[:k])) < 1e-14
    assert not y[k:].any()


# -- the whole solve --

def system(seed, n=40):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n) * 0.6 + np.eye(n)
    return A, rng.standard_normal(n), rng


CASES = {
    # name: (restart, max_iter, tol, x0, b scale, precond)
    "cycles": (6, 200, 1e-12, False, 1.0, False),
    "max_iter_mid_cycle": (6, 9, 1e-14, False, 1.0, False),
    "x0": (8, 200, 1e-11, True, 1.0, False),
    "first_test": (8, 200, 1e-8, "exact", 1.0, False),
    "b_zero": (8, 200, 1e-12, False, 0.0, False),
    "precond": (5, 200, 1e-12, False, 1.0, True),
}


def run_both(name):
    jnp, jg = jax_gmres()
    restart, max_iter, tol, x0, scale, pre = CASES[name]
    A, b, rng = system(len(name))
    b = scale * b
    if x0 == "exact":
        x0 = np.linalg.solve(A, b)
    elif x0:
        x0 = rng.standard_normal(len(b))
    else:
        x0 = None
    d = 1.0 / (1.0 + np.abs(np.diag(A)) + rng.random(len(b)))
    kw = dict(restart=restart, max_iter=max_iter, tol=tol)
    ref = jg.gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                   None if x0 is None else jnp.asarray(x0),
                   precond=(lambda v: jnp.asarray(d) * v) if pre else None,
                   **kw)
    At, dt = torch.as_tensor(A), torch.as_tensor(d)
    s0 = dict(t_gmres.stats)
    got = t_gmres.gmres(
        lambda v: At @ v, torch.as_tensor(b),
        None if x0 is None else torch.as_tensor(x0),
        precond=(lambda v: dt * v) if pre else None, **kw)
    used = {k: t_gmres.stats[k] - s0[k] for k in s0}
    return ref, got, used


@pytest.mark.parametrize("name", sorted(CASES))
def test_gmres_matches_jax(name):
    ref, got, used = run_both(name)
    assert got.converged == bool(ref.converged)
    assert got.iterations == int(ref.iterations)
    x_ref = np.asarray(ref.x)
    assert rel(got.x.numpy(), x_ref) < 1e-12
    r_ref = float(ref.residual)
    if name == "first_test":         # both residuals are x0's round-off
        assert got.residual <= CASES[name][2] and r_ref <= CASES[name][2]
    else:
        assert abs(got.residual - r_ref) <= 1e-3 * r_ref
    assert used["host_reads"] <= got.iterations + 2 * used["cycles"] + 2
    assert used["steps_after_done"] == 0        # the CPU reads at once
    if name == "max_iter_mid_cycle":
        assert not got.converged and got.iterations == 9
        assert used["cycles"] == 2
    if name in ("first_test", "b_zero"):
        assert got.iterations == 0 and used["cycles"] == 0
    if name == "cycles":
        assert used["cycles"] >= 3


@pytest.mark.parametrize("lookahead", [1, 3])
@pytest.mark.parametrize("name", ["cycles", "precond"])
def test_steps_after_done_change_nothing(name, lookahead, monkeypatch):
    """Steps queued behind the converged one, as a captured step's are on
    the card (one; more here), run (their matvecs too) and leave x, the
    count and the residual as the solve that reads each state at once."""
    _, base, base_used = run_both(name)
    monkeypatch.setattr(t_gmres, "_lookahead", lambda plan: lookahead)
    _, got, used = run_both(name)
    assert torch.equal(got.x, base.x)
    assert got.iterations == base.iterations
    assert got.residual == base.residual
    # both converge inside a cycle: the steps queued behind it all ran
    assert 1 <= used["steps_after_done"] <= lookahead
    assert used["steps"] - base_used["steps"] == used["steps_after_done"]
    assert used["host_reads"] <= got.iterations + 2 * used["cycles"] + 2


def small_solver():
    from aniso_torch.core.config import SolverConfig
    from aniso_torch.solver.operator import TransportSolver

    ts = TransportSolver(SolverConfig(domain_size=8, quad_rule=2, np_cheb=3,
                                      dtype="float64", tol=1e-10),
                         backend="fmm", device="cpu")
    g = ts.grid
    sig = 4.0 + 0 * g.nodes_x
    ts.set_coeff(sig, sig + 0.2)
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    return ts, q


def test_set_coeff_drops_the_cached_steps():
    ts, q = small_solver()
    first = ts.solve(q)
    assert len(ts._graphs) == 1
    plan = next(iter(ts._graphs.values()))
    again = ts.solve(q)                     # the cached buffers again
    assert next(iter(ts._graphs.values())) is plan
    assert again.iterations == first.iterations
    assert torch.equal(again.x, first.x)
    sig = 4.0 + 0 * ts.grid.nodes_x
    ts.set_coeff(sig, sig + 0.5)
    assert ts._graphs == {}


def test_another_preconditioner_replaces_the_cached_step():
    """One plan per dtype, shape, restart and preconditioned or not: a
    second preconditioner object takes the first one's plan (which holds
    it), so repeated solves each with a new one keep one plan."""
    ts, q = small_solver()
    plain = ts.solve(q)
    first, second = (lambda v: 0.5 * v), (lambda v: 0.5 * v)
    a = ts.solve(q, precond=first)
    assert len(ts._graphs) == 2
    plan = ts._graphs[next(k for k in ts._graphs if k[-1])]
    assert plan.precond is first
    b = ts.solve(q, precond=second)
    assert len(ts._graphs) == 2
    assert ts._graphs[next(k for k in ts._graphs if k[-1])] is plan
    assert plan.precond is second
    assert b.iterations == a.iterations and torch.equal(b.x, a.x)
    assert ts.solve(q).iterations == plain.iterations


def test_a_replaced_cache_drops_the_cached_steps():
    """A cache entry swapped by hand (as the per-offset checks swap a
    level's E) is something a captured step would read at its old
    address: the next solve starts from a new plan."""
    ts, q = small_solver()
    ts.solve(q)
    plan = next(iter(ts._graphs.values()))
    ts.solve(q)
    assert next(iter(ts._graphs.values())) is plan
    ts.sigma_s = 2.0 * ts.sigma_s
    ts.solve(q)
    assert len(ts._graphs) == 1
    assert next(iter(ts._graphs.values())) is not plan
    plan = next(iter(ts._graphs.values()))
    assert ts._graph_reads[0] is ts.sigma_s
    leaf = ts._caches["near_E"]
    ts._caches["near_E"] = leaf.clone()
    ts.solve(q)
    assert next(iter(ts._graphs.values())) is not plan
    assert not any(r is leaf for r in ts._graph_reads)


# -- on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# relative to the largest value: float32 values with float64 sums against
# sums in float32 (the plain pass); float64 in another order
_GATE = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64 * 64 * 9, 4099])   # 16-byte packs; not
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("i", [0, 14, 79])
def test_cgs2_kernel_matches_plain_on_card(cuda_device, dtype, i, n):
    m = 80
    gen = torch.Generator(device=cuda_device).manual_seed(i)
    V = torch.randn((m + 1, n), generator=gen, dtype=dtype,
                    device=cuda_device)
    V /= torch.linalg.vector_norm(V, dim=1, keepdim=True)
    w = torch.randn(n, generator=gen, dtype=dtype, device=cuda_device)
    st = make_state(m, i).to(cuda_device)
    args = [V.clone(), w.clone(), torch.zeros_like(w), st.clone()]
    want = [V.clone(), w.clone(), torch.zeros_like(w), st.clone()]
    n0 = krylov.launches[krylov._cuda.INSTANCES[dtype]]
    krylov.cgs2(*args)
    krylov.cgs2_plain(*want)
    assert krylov.launches[krylov._cuda.INSTANCES[dtype]] == n0 + 1
    L = krylov.state_layout(m)
    assert rel(args[0].cpu(), want[0].cpu()) < _GATE[dtype]
    assert torch.equal(args[2], args[0][i + 1])
    sl = slice(L.col, L.col + i + 2)
    assert rel(args[3][sl].cpu(), want[3][sl].cpu()) < _GATE[dtype]
    # inactive: nothing moves
    done = make_state(m, i, done=1.0).to(cuda_device)
    before = [V.clone(), done.clone()]
    krylov.cgs2(V, w.clone(), torch.zeros_like(w), done)
    krylov.givens_step(done, m)
    assert torch.equal(V, before[0]) and torch.equal(done, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [True, False])
@pytest.mark.parametrize("n", [64 * 64 * 9, 4099])   # 16-byte packs; not
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("i", [14, 79])
def test_cgs2_both_branches_and_replays_on_card(cuda_device, monkeypatch,
                                                dtype, i, n, resident):
    """K11 with V resident in shared memory and streamed (the plan's
    branch forced) against cgs2_plain; an inactive step a no-op; the step
    captured in a CUDA graph, replayed twice from the same inputs, gives
    the eager launch's bits."""
    import functools

    monkeypatch.setattr(krylov, "cgs2_plan", functools.partial(
        krylov.cgs2_plan.__wrapped__, resident=resident))
    m = 80
    gen = torch.Generator(device=cuda_device).manual_seed(100 + i)
    V = torch.randn((m + 1, n), generator=gen, dtype=dtype,
                    device=cuda_device)
    V /= torch.linalg.vector_norm(V, dim=1, keepdim=True)
    w = torch.randn(n, generator=gen, dtype=dtype, device=cuda_device)
    st = make_state(m, i).to(cuda_device)
    inputs = [V, w, torch.zeros_like(w), st]
    args = [x.clone() for x in inputs]
    want = [x.clone() for x in inputs]
    krylov.cgs2(*args)
    krylov.cgs2_plain(*want)
    L = krylov.state_layout(m)
    sl = slice(L.col, L.col + i + 2)
    assert rel(args[0].cpu(), want[0].cpu()) < _GATE[dtype]
    assert rel(args[1].cpu(), want[1].cpu()) < _GATE[dtype]
    assert torch.equal(args[2], args[0][i + 1])
    assert rel(args[3][sl].cpu(), want[3][sl].cpu()) < _GATE[dtype]
    eager = [x.clone() for x in args]
    done = make_state(m, i, done=1.0).to(cuda_device)
    idle = [V.clone(), w.clone(), torch.zeros_like(w), done.clone()]
    krylov.cgs2(*idle)
    assert torch.equal(idle[0], V) and torch.equal(idle[1], w)
    assert not idle[2].any() and torch.equal(idle[3], done)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        krylov.cgs2(*args)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        for a, x in zip(args, inputs):
            a.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, e) for a, e in zip(args, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("i", [0, 14, 79])
def test_givens_kernel_matches_plain_on_card(cuda_device, i):
    m = 80
    rng = np.random.default_rng(i)
    L = krylov.state_layout(m)
    st = make_state(m, i, j=i + 1)
    ang = rng.uniform(0, 2 * np.pi, i)
    st[L.cs:L.cs + i] = torch.as_tensor(np.cos(ang))
    st[L.sn:L.sn + i] = torch.as_tensor(np.sin(ang))
    st[L.s:L.s + i + 1] = torch.as_tensor(rng.standard_normal(i + 1))
    st[L.col:L.col + i + 2] = torch.as_tensor(rng.standard_normal(i + 2))
    # the earlier columns: a Hessenberg block the back-substitution solves
    H = np.triu(rng.standard_normal((m + 1, m)), -1) + 4 * np.eye(m + 1, m)
    krylov.hessenberg(st, m)[:] = torch.as_tensor(H)
    got, want = st.to(cuda_device), st.clone().to(cuda_device)
    krylov.givens_step(got, m)
    krylov.givens_step_plain(want, m)
    assert rel(got.cpu(), want.cpu()) < 1e-14
    krylov.givens_backsub(got, m)
    krylov.givens_backsub_plain(want, m)
    assert rel(got[L.y:].cpu(), want[L.y:].cpu()) < 1e-12


@pytest.mark.cuda
def test_captured_solve_matches_eager_on_card(cuda_device):
    """The same system solved through the captured step and through the
    eager one (graphs kept, then not): iterations equal, x to 1e-12, the
    replays counted in the kernels' launches."""
    A, b, _ = system(7, n=300)
    At = torch.as_tensor(A, device=cuda_device)
    bt = torch.as_tensor(b, device=cuda_device)
    graphs = {}
    s0, k0 = dict(t_gmres.stats), krylov.launches["f64"]
    got = t_gmres.gmres(lambda v: At @ v, bt, restart=10, max_iter=200,
                        tol=1e-12, graphs=graphs)
    steps = t_gmres.stats["steps"] - s0["steps"]
    assert krylov.launches["f64"] - k0 == steps
    assert t_gmres.stats["captures"] - s0["captures"] == 1
    assert t_gmres.stats["steps_after_done"] - s0["steps_after_done"] <= 1
    cpu = t_gmres.gmres(lambda v: torch.as_tensor(A) @ v,
                        torch.as_tensor(b), restart=10, max_iter=200,
                        tol=1e-12)
    assert got.converged and got.iterations == cpu.iterations
    assert rel(got.x.cpu(), cpu.x) < 1e-12
    again = t_gmres.gmres(lambda v: At @ v, bt, restart=10, max_iter=200,
                          tol=1e-12, graphs=graphs)
    assert t_gmres.stats["captures"] - s0["captures"] == 1
    assert again.iterations == got.iterations
    assert torch.equal(again.x, got.x)


@pytest.mark.cuda
def test_replaced_cache_and_preconditioner_recapture_on_card(cuda_device):
    """On the card a second preconditioner object and a cache replaced by
    hand each capture the step anew (one capture, not one plan more), and
    the answers stay the CPU solver's."""
    from aniso_torch.core.config import SolverConfig
    from aniso_torch.solver.operator import TransportSolver

    cfg = SolverConfig(domain_size=8, quad_rule=2, np_cheb=3,
                       dtype="float64", tol=1e-10)
    card = TransportSolver(cfg, backend="fmm", device=cuda_device)
    cpu = TransportSolver(cfg, backend="fmm", device="cpu")
    g = card.grid
    sig = 4.0 + 0 * g.nodes_x
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    for ts in (card, cpu):
        ts.set_coeff(sig, sig + 0.2)

    def captures():
        return t_gmres.stats["captures"]

    def same(a, b):
        assert a.iterations == b.iterations
        assert rel(a.x.cpu(), b.x) < 1e-10

    c0 = captures()
    same(card.solve(q), cpu.solve(q))
    same(card.solve(q), cpu.solve(q))
    assert captures() - c0 == 1
    for _ in range(2):                      # a new preconditioner each time
        same(card.solve(q, precond=lambda v: 0.5 * v),
             cpu.solve(q, precond=lambda v: 0.5 * v))
    assert captures() - c0 == 3 and len(card._graphs) == 2
    for ts in (card, cpu):
        ts.sigma_s = 2.0 * ts.sigma_s
    same(card.solve(q), cpu.solve(q))
    assert captures() - c0 == 4 and len(card._graphs) == 1
