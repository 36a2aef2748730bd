"""The sharded GMRES step (parallel.api.ShardedSpace, K11-S) against the JAX
package's GMRES on a sharded basis.

On the CPU the step runs its plain version, cgs2_shard_plain then
givens_step_masked, in float64, on inputs made from a numpy seed:
  * cgs2_shard_plain on 2 and 8 shards against JAX's masked _dots / _comb
    pass on the whole field (aniso_tpu/solver/gmres.py:45-58, the body
    :161-170) at i = 0, 5 and m - 1, the rows above i holding NaN: the new
    basis vector and the column to 1e-12 relative, every other row as it
    was;
  * givens_step_masked bitwise givens_step_plain (the same operations with
    no host read);
  * an inactive step (done, i = restart, j > max_iter) changes neither V,
    u nor the state;
  * the whole sharded gmres on the 2 x 4 mesh against JAX's sharded solve
    jitted as benchmarks/sharded_solve.py:107-112 jits it (16^2, restart
    30, two cycles): the same iterations, x to 1e-8 relative;
  * a sharded step with Tensor.item, __bool__, __float__, __int__ and
    tolist made to raise: the step reads nothing on the host, as a
    captured CUDA graph needs.
JAX is imported inside the CPU tests only.  The tests marked `cuda` hold
K11-S against its plain version on the card (the fused route, the split
route, and two groups of shards summed between launches; float32 and
float64; steps 0, 14 and 79 and the two where a block's range stops fitting
shared memory; NaN rows above i; the fused step replayed bitwise from a
CUDA graph) and replay a sharded solve's captured step (run them there with `python -m pytest
tests/test_torch_sharded_gmres.py -m cuda --noconftest`).
"""

import numpy as np
import pytest
import torch

from aniso_torch.core.config import SolverConfig
from aniso_torch.kernels import krylov
from aniso_torch.parallel import api, halo
from aniso_torch.solver import gmres as t_gmres
from aniso_torch.solver.operator import TransportSolver

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

M = 8
FIELD = (8, 8, 3)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).max()
    return np.abs(a - b).max() / (scale if scale else 1.0)


def make_state(m, i, j=1, done=0.0, max_iter=100, seed=None):
    """A state at step i; with a seed, the rotations, s and the column of a
    seeded earlier cycle."""
    L = krylov.state_layout(m)
    st = torch.zeros(L.len, dtype=torch.float64)
    st[krylov.I], st[krylov.J], st[krylov.DONE] = i, j, done
    st[krylov.NORMB], st[krylov.TOL] = 2.0, 1e-10
    st[krylov.MAX_ITER] = max_iter
    if seed is not None:
        rng = np.random.default_rng(seed)
        ang = rng.uniform(0.0, 2 * np.pi, i)
        st[L.cs:L.cs + i] = torch.as_tensor(np.cos(ang))
        st[L.sn:L.sn + i] = torch.as_tensor(np.sin(ang))
        st[L.s:L.s + i + 1] = torch.as_tensor(rng.standard_normal(i + 1))
        st[L.col:L.col + i + 2] = torch.as_tensor(
            rng.standard_normal(i + 2))
    return st


def cpu_mesh(n):
    return api.make_mesh(devices=["cpu"] * n)


def shard_step_inputs(mesh, i, seed, nan=True):
    """The whole basis (m + 1, *FIELD), rows above i zero (JAX's), and w;
    each shard's flattened part of them, rows above i NaN (nan=True)."""
    rng = np.random.default_rng(seed)
    V = rng.standard_normal((M + 1,) + FIELD)
    V[i + 1:] = 0.0
    w = rng.standard_normal(FIELD)
    Vt = torch.as_tensor(V).clone()
    if nan:
        Vt[i + 1:] = float("nan")
    Vp = api.shard(mesh, Vt, (1, 2)).local_blocks()
    wp = api.shard(mesh, torch.as_tensor(w), (0, 1)).local_blocks()
    return (V, w, [p.view(M + 1, -1) for p in Vp],
            [p.reshape(-1) for p in wp],
            [torch.zeros(p.numel(), dtype=torch.float64) for p in wp])


def assemble(mesh, parts, shape):
    """The whole (*FIELD) array from each shard's flattened block."""
    bx, by = FIELD[0] // mesh.shape[0], FIELD[1] // mesh.shape[1]
    out = np.zeros(shape)
    for k, p in zip(mesh.local, parts):
        ix, iy = mesh.coords(k)
        out[ix * bx:(ix + 1) * bx, iy * by:(iy + 1) * by] = \
            p.reshape(bx, by, -1).numpy()
    return out


@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("i", [0, 5, M - 1])
def test_cgs2_shard_plain_matches_jax(i, shards):
    import jax.numpy as jnp
    from aniso_tpu.solver import gmres as jg

    mesh = cpu_mesh(shards)
    V, w, Vp, wp, up = shard_step_inputs(mesh, i, seed=10 + i)
    before = [p.clone() for p in Vp]
    # JAX's body (:161-170) on the whole field
    Vj, wj = jnp.asarray(V), jnp.asarray(w)
    mask = (jnp.arange(M + 1) <= i).astype(wj.dtype)
    h1 = jg._dots(Vj, wj) * mask
    wj = wj - jg._comb(Vj, h1)
    h2 = jg._dots(Vj, wj) * mask
    wj = wj - jg._comb(Vj, h2)
    wnorm = jnp.linalg.norm(wj)
    vnew = np.asarray(wj / jnp.where(wnorm == 0.0, 1.0, wnorm))
    col = np.asarray((h1 + h2).at[i + 1].set(wnorm))

    st = make_state(M, i)
    krylov.cgs2_shard_plain(Vp, wp, up, st)
    L = krylov.state_layout(M)
    assert rel(assemble(mesh, [p[i + 1] for p in Vp], FIELD), vnew) < 1e-12
    assert rel(st[L.col:L.col + i + 2], col[:i + 2]) < 1e-12
    assert rel(st[L.h2:L.h2 + i + 1], np.asarray(h2)[:i + 1]) < 1e-12
    for p, b, u in zip(Vp, before, up):
        assert torch.equal(u, p[i + 1])
        assert torch.equal(p[:i + 1], b[:i + 1])
        assert torch.isnan(p[i + 2:]).all()
    # K11-S changes no header entry: its Givens epilogue moves i and j
    assert st[krylov.I] == i and st[krylov.J] == 1


@pytest.mark.parametrize("branch", ["dy = 0", "|dy| > |dx|", "|dx| >= |dy|"])
@pytest.mark.parametrize("i", [0, 5, M - 1])
def test_givens_step_masked_is_givens_step_plain(i, branch):
    st = make_state(M, i, j=i + 1, seed=i)
    L = krylov.state_layout(M)
    col = st[L.col:L.col + M + 1]
    # after the i earlier rotations col[i] is some dx: set dy = col[i + 1]
    col[i + 1] = {"dy = 0": 0.0, "|dy| > |dx|": 1e3,
                  "|dx| >= |dy|": 1e-3}[branch]
    want, got = st.clone(), st.clone()
    krylov.givens_step_plain(want, M)
    krylov.givens_step_masked(got, M)
    assert torch.equal(got, want)


@pytest.mark.parametrize("why", ["done", "i = m", "j > max_iter"])
def test_inactive_sharded_step_is_a_no_op(why):
    mesh = cpu_mesh(8)
    _, _, Vp, wp, up = shard_step_inputs(mesh, M - 1, seed=3, nan=False)
    st = {"done": make_state(M, 2, done=1.0, seed=2),
          "i = m": make_state(M, M),
          "j > max_iter": make_state(M, 2, j=8, max_iter=7, seed=2)}[why]
    for p in up:
        p.normal_(generator=torch.Generator().manual_seed(1))
    before = [[t.clone() for t in ts] for ts in (Vp, wp, up)] + [st.clone()]
    krylov.cgs2_givens_shards([(Vp, wp, up)], st)
    for ts, bs in zip((Vp, wp, up), before):
        assert all(torch.equal(t, b) for t, b in zip(ts, bs))
    assert torch.equal(st, before[3])


def port_solver(sz=16, dtype="float64", device="cpu"):
    cfg = SolverConfig(domain_size=sz, quad_rule=2, kernel_size=1, g=0.9,
                       sing_rule=8, np_cheb=3, dtype=dtype)
    s = TransportSolver(cfg, backend="fmm", device=device)
    x = s.grid.nodes_x
    sig = 20 * 0.5 * (1 - np.cos(2 * np.pi * x))
    s.set_coeff(sig, sig + 0.2)
    return s


def charge(grid):
    return np.exp(-25 * ((grid.nodes_x - 0.5) ** 2
                         + (grid.nodes_y - 0.5) ** 2))


def test_sharded_gmres_matches_jaxs_jitted_sharded_solve():
    """16^2, sigma_s up to 20, g 0.9, tol 1e-12, GMRES(30) on the 2 x 4
    mesh: 35 iterations, two cycles, in both."""
    import jax
    import jax.numpy as jnp
    from aniso_tpu.core.config import SolverConfig as JConfig
    from aniso_tpu.parallel import api as j_api
    from aniso_tpu.solver.gmres import gmres as j_gmres
    from aniso_tpu.solver.operator import TransportSolver as JSolver

    if jax.device_count() != 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    restart, max_iter, tol = 30, 100, 1e-12
    s = port_solver()
    q = charge(s.grid)
    js = JSolver(JConfig(domain_size=16, quad_rule=2, kernel_size=1, g=0.9,
                         sing_rule=8, np_cheb=3, dtype="float64"),
                 backend="fmm")
    js.set_coeff(np.asarray(s.sigma_s), np.asarray(s.sigma_s) + 0.2)
    jm = j_api.make_mesh()
    apply_j, caches_j, ms_j = j_api.sharded_solver(js, jm)

    @jax.jit
    def solve_full(cch, ms0, sig, u0):
        def matvec(v):
            return v - apply_j(cch, ms0, 0, sig * v)
        b = apply_j(cch, ms0, 0, u0)
        return j_gmres(matvec, b, restart=restart, max_iter=max_iter,
                       tol=tol)

    want = solve_full(caches_j, ms_j[0], j_api.shard_field(jm, js.sigma_s),
                      j_api.shard_field(jm, jnp.asarray(q)))

    mesh = cpu_mesh(8)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    sig = api.shard_field(mesh, s.sigma_s)
    b = apply_fn(caches, ms[0], 0, api.shard_field(mesh, torch.as_tensor(q)))
    g0 = dict(t_gmres.stats)
    res = t_gmres.gmres(lambda v: v - apply_fn(caches, ms[0], 0, sig * v), b,
                        restart=restart, max_iter=max_iter, tol=tol)
    assert t_gmres.stats["cycles"] - g0["cycles"] >= 2
    assert res.converged and res.iterations == int(want.iterations)
    assert res.iterations > restart
    assert rel(res.x.full(), np.asarray(want.x)) < 1e-8


HOST_READS = ("item", "__bool__", "__float__", "__int__", "tolist")


def test_a_sharded_step_reads_nothing_on_the_host(monkeypatch):
    """One eager step first (first-use plans), as solver.gmres's capture
    runs one; then three steps with every host read made to raise, but
    inside K1's plain gather, which reads its constant shift table
    (kernels/m2l.py:_gather_planes) and runs on the CPU only (K1 on the
    card takes the table's pointer); they give the bits of three steps run
    without the patch."""
    from aniso_torch.kernels import m2l

    s = port_solver()
    mesh = cpu_mesh(8)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    sig = api.shard_field(mesh, s.sigma_s)
    b = apply_fn(caches, ms[0], 0,
                 api.shard_field(mesh, torch.as_tensor(charge(s.grid))))
    space = b.krylov_space()
    assert not space.capturable and space.fused
    plain = {"in": False}

    def guard(name):
        read = getattr(torch.Tensor, name)

        def checked(self, *args, **kwargs):
            if not plain["in"]:
                raise AssertionError(f"a host read ({name}) inside a "
                                     "sharded step")
            return read(self, *args, **kwargs)
        return checked

    gather = m2l._gather_planes

    def plain_gather(*args):
        plain["in"] = True
        try:
            return gather(*args)
        finally:
            plain["in"] = False

    def run(patch):
        V = space.basis(b, M + 1)
        u = space.zeros(b)
        st = make_state(M, 0)
        st[krylov.NORMB] = space.norm(b)
        st[krylov.state_layout(M).s] = space.norm(b)
        space.start(V, u, b, space.norm(b))

        def step():
            space.cgs2_givens(V, u - apply_fn(caches, ms[0], 0, sig * u), u,
                              st)

        step()
        if patch:
            monkeypatch.setattr(m2l, "_gather_planes", plain_gather)
            for name in HOST_READS:
                monkeypatch.setattr(torch.Tensor, name, guard(name))
            with pytest.raises(AssertionError, match="host read"):
                bool(torch.ones(1))
        for _ in range(3):
            step()
        monkeypatch.undo()
        return V, u, st

    V, u, st = run(True)
    V0, u0, st0 = run(False)
    assert st[krylov.I] == 4 and st[krylov.J] == 5
    assert torch.equal(st, st0)
    for k in mesh.local:
        assert torch.equal(V.parts[k][:5], V0.parts[k][:5])
        assert torch.equal(u.blocks[k], V.parts[k][4])


# -- on the card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# relative to the largest value: float32 values with float64 sums against
# sums in float32 (the plain pass); float64 in another order
_GATE = {torch.float32: 1e-5, torch.float64: 1e-12}


def _sum_in_place(parts):
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p
    for p in parts:
        p.copy_(acc)


def _whole_steps(m, shards, n, dtype):
    """The last step at which a block's whole range of these shards stays
    in shared memory on this card, and the one after (the plan's)."""
    item = torch.finfo(dtype).bits // 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = krylov.k11_plan((n,) * shards, m, item, 16 // item, sms)
    whole = [i for i in range(m)
             if krylov.shard_resident(i, plan, item) == plan.chunk]
    assert whole and whole[-1] < m - 1
    return whole[-1], whole[-1] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "split", "two groups"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("i", [0, 14, 79, "last whole", "first partial"])
def test_k11s_matches_plain_on_card(cuda_device, route, dtype, i):
    """Eight shards of 64 x 32 squares, 9 nodes each, restart 80, the rows
    above i NaN: K11-S's ring instance (one launch; four; four a group of
    four shards with their sums added between the launches) against
    cgs2_shard_plain then givens_step_masked on the same card, at steps 0,
    14, 79 and at the last step whose block ranges stay whole in shared
    memory and the one after; an inactive step a no-op; the fused step
    captured in a CUDA graph and replayed twice from the same inputs gives
    the eager launch's bits."""
    m, shards, n = 80, 8, 64 * 32 * 9
    if isinstance(i, str):
        i = _whole_steps(m, shards, n, dtype)[i == "first partial"]
    _k11s_against_plain(cuda_device, route, dtype, i, m, (n,) * shards)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fused", "split", "two groups"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("i", [0, 14, 79])
@pytest.mark.parametrize("ns", [(32 * 32 * 9,) * 4,
                                (32 * 32 * 9, 32 * 31 * 9, 32 * 33 * 9,
                                 32 * 32 * 9)],
                         ids=["4x32x32", "unequal"])
def test_k11s_lean_matches_plain_on_card(cuda_device, route, dtype, i, ns):
    """The lean instance (no ring: a block's range of every row fits its
    shared memory) on sharded64_compat's four shards of 32 x 32 squares
    and on four unequal ones (blocks whose range crosses from one shard
    into the next), as the test above."""
    item = torch.finfo(dtype).bits // 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for split in (False, True):
        assert krylov.k11_plan(ns, 80, item, 16 // item, sms,
                               split).stages == 0
    _k11s_against_plain(cuda_device, route, dtype, i, 80, ns)


def _k11s_against_plain(cuda_device, route, dtype, i, m, ns):
    gen = torch.Generator(device=cuda_device).manual_seed(i)
    V = [torch.randn((m + 1, n), generator=gen, dtype=dtype,
                     device=cuda_device) for n in ns]
    norm = torch.sqrt(sum((Vk.double() ** 2).sum(dim=1) for Vk in V))
    for Vk in V:
        Vk /= norm[:, None].to(dtype)
        Vk[i + 1:] = float("nan")
    w = [torch.randn((n,), generator=gen, dtype=dtype, device=cuda_device)
         for n in ns]
    st = make_state(m, i, j=i + 1, seed=i).to(cuda_device)
    half = len(ns) // 2

    def parts():
        return [[x.clone() for x in V], [x.clone() for x in w],
                [torch.zeros_like(x) for x in w], st.clone()]

    def cat(p):
        return [torch.cat([x.flatten() for x in t]) if isinstance(t, list)
                else t for t in p]

    got, want = parts(), parts()
    Vs, ws, us = got[:3]
    groups = {"fused": [(Vs, ws, us)], "split": [(Vs, ws, us)],
              "two groups": [(Vs[:half], ws[:half], us[:half]),
                             (Vs[half:], ws[half:], us[half:])]}[route]
    combine = None if route == "fused" else _sum_in_place
    n0 = dict(krylov.shard_launches)
    krylov.cgs2_givens_shards(groups, got[3], combine)
    inst = krylov._cuda.INSTANCES[dtype]
    assert krylov.shard_launches[inst] - n0[inst] == (
        1 if route == "fused" else 4 * len(groups))
    krylov.cgs2_shard_plain(*want[:3], want[3])
    krylov.givens_step_masked(want[3], m)
    torch.cuda.synchronize()
    for g, x, u0 in zip(got[0], want[0], got[2]):
        assert rel(g[i + 1].cpu(), x[i + 1].cpu()) < _GATE[dtype]
        assert torch.equal(u0, g[i + 1])
        assert torch.isnan(g[i + 2:]).all()
    for g, x in zip(got[0], V):
        assert torch.equal(g[:i + 1], x[:i + 1])
    L = krylov.state_layout(m)
    for sl in (slice(L.H, L.y), slice(0, L.H)):
        assert rel(got[3][sl].cpu(), want[3][sl].cpu()) < _GATE[dtype]
    assert got[3][krylov.I] == i + 1 and got[3][krylov.J] == i + 2
    # inactive: nothing moves
    idle = parts()
    idle[3][krylov.DONE] = 1.0
    before = [t.clone() for t in cat(idle)]
    krylov.cgs2_givens_shards([tuple(idle[:3])], idle[3], combine)
    torch.cuda.synchronize()
    for a, b in zip(cat(idle), before):
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    if route != "fused":
        return
    # the captured step, replayed twice from the same inputs
    eager = [x.clone() for x in cat(got)]
    cap = parts()
    Vs, ws, us = cap[:3]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        krylov.cgs2_givens_shards([(Vs, ws, us)], cap[3], None)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    replays = []
    for _ in range(2):
        for a, x in zip(cap, parts()):
            for ak, xk in zip(*((a, x) if isinstance(a, list)
                                else ([a], [x]))):
                ak.copy_(xk)
        graph.replay()
        torch.cuda.synchronize()
        replays.append([x.clone() for x in cat(cap)])
    for r in replays:
        assert all(torch.equal(torch.nan_to_num(a), torch.nan_to_num(e))
                   for a, e in zip(r, eager))


@pytest.mark.cuda
def test_sharded_solve_replays_its_steps_on_card(cuda_device):
    """The sharded solve on 8 shards of one card, its graphs kept: the
    second solve replays every step (no capture), and both give the CPU
    sharded solve's iterations and x to 1e-10."""
    s = port_solver()
    q = charge(s.grid)
    mesh = cpu_mesh(8)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    sig = api.shard_field(mesh, s.sigma_s)
    b = apply_fn(caches, ms[0], 0, api.shard_field(mesh, torch.as_tensor(q)))
    ref = t_gmres.gmres(lambda v: v - apply_fn(caches, ms[0], 0, sig * v),
                        b, restart=30, max_iter=100, tol=1e-12)
    sc = port_solver(device="cuda")
    meshc = api.make_mesh(devices=[cuda_device] * 8)
    apply_c, caches_c, ms_c = api.sharded_solver(sc, meshc)
    sigc = api.shard_field(meshc, sc.sigma_s)
    bc = apply_c(caches_c, ms_c[0], 0, api.shard_field(
        meshc, torch.as_tensor(q, device=cuda_device)))
    assert bc.krylov_space().capturable
    graphs = {}
    for solve in range(2):
        g0 = dict(t_gmres.stats)
        halo.reset_collectives()
        res = t_gmres.gmres(
            lambda v: v - apply_c(caches_c, ms_c[0], 0, sigc * v), bc,
            restart=30, max_iter=100, tol=1e-12, graphs=graphs)
        d = {k: t_gmres.stats[k] - g0[k] for k in g0}
        assert d["captures"] == (1 if solve == 0 else 0)
        assert d["replays"] == d["steps"] - d["captures"] > 0
        assert res.iterations == ref.iterations
        assert rel(res.x.full().cpu(), ref.x.full()) < 1e-10
        # the replays added the capture's collectives
        assert halo.collective_stats().counts["all-reduce"] >= \
            3 * res.iterations
