"""aniso_torch.parallel.api: the mesh, the placements, the sharded matvec
and the sharded GMRES, on CPU shards.

The mesh is as square as possible (8 -> 2 x 4) and takes repeated devices;
shard_field / shard_pytree cut each cache family along its own spatial
dims (the port's layouts) and replicate the rest.  The sharded corrected
matvec against the port's one-device matvec (1e-12 relative: the same f64
arithmetic per shard) and against JAX's sharded_solver(..., halo=
"shardmap") on its virtual 2 x 4 mesh (1e-10: the two packages' caches
are built apart, as tests/test_torch_fmm.py holds them to 1e-13), at 32^2
with compat on and off; a per-offset leaf (a zero dense budget) takes the
replicated route through K3's plain version.  The sharded GMRES against the
one-device solve (iterations +- 1, x to 1e-8).  The collective accounting:
CollectiveStats as JAX's, and the O(halo) bound of
tests/test_halo_wired.py:68-82 on the port's counters.  Any mesh: on (1, 8)
the shards' up pass stops below level 2 and the coarse levels run whole; on
(2, 3) no power-of-two grid divides the mesh and the field is computed
whole; every mesh make_mesh builds for 3-32 devices.
"""

import functools
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.parallel import api as j_api
from aniso_tpu.parallel import inspect as j_inspect
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.core.config import SolverConfig
from aniso_torch.fmm import smooth
from aniso_torch.parallel import api, halo
from aniso_torch.parallel.api import Replicated, Sharded
from aniso_torch.solver.gmres import gmres
from aniso_torch.solver.operator import TransportSolver

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU8 = ["cpu"] * 8

# torch's CPU thread pool starts here, before JAX's OpenMP host engine runs
# in this process: started after it, torch's first multi-threaded calls
# were seen to differ from its later calls on the same inputs by ~1e-9
# relative (ROADMAP queue C item 1); started first, every call agrees.
torch.exp(torch.ones(1 << 20, dtype=torch.float64)).sum()


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def config(sz, compat=False, dtype="float64", N=1):
    return dict(domain_size=sz, quad_rule=2, kernel_size=N, g=0.9,
                sing_rule=8, np_cheb=3, dtype=dtype,
                compat_global_basis=compat)


def sigma(grid):
    s = 8 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    return s, s + 0.2


@functools.lru_cache(maxsize=None)
def port_solver(sz, compat=False, dtype="float64", N=1):
    s = TransportSolver(SolverConfig(**config(sz, compat, dtype, N)),
                        backend="fmm", device="cpu")
    s.set_coeff(*sigma(s.grid))
    return s


def seeded(grid, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (grid.sz, grid.sz, grid.nq)))


@pytest.mark.parametrize("n,shape", [(8, (2, 4)), (4, (2, 2)), (2, (1, 2)),
                                     (1, (1, 1)), (16, (4, 4))])
def test_make_mesh_is_as_square_as_possible(n, shape):
    mesh = api.make_mesh(devices=["cpu"] * n)
    assert mesh.shape == shape and mesh.size == n
    assert mesh.local == list(range(n)) and set(mesh.ranks) == {0}
    assert mesh.neighbour(0, -1, 0) is None
    if shape[1] > 1:
        assert mesh.neighbour(0, 0, 1) == 1


def test_make_mesh_takes_repeated_devices_and_n_devices():
    mesh = api.make_mesh(n_devices=4, devices=CPU8)
    assert mesh.shape == (2, 2)
    assert mesh.local_groups() == {torch.device("cpu"): [0, 1, 2, 3]}


def test_make_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.make_mesh()


def test_shard_field_blocks():
    s = port_solver(16)
    mesh = api.make_mesh(devices=CPU8)
    u = seeded(s.grid)
    sh = api.shard_field(mesh, u)
    for k in range(8):
        ix, iy = mesh.coords(k)
        blk = sh.blocks[k]
        assert blk.shape == (8, 4, s.grid.nq) and blk.is_contiguous()
        assert torch.equal(blk, u[8 * ix:8 * ix + 8, 4 * iy:4 * iy + 4])
    assert torch.equal(sh.full(), u)
    rep = api.replicate(mesh, torch.ones(3))
    assert list(rep.per_device) == [torch.device("cpu")]


def test_shard_pytree_follows_the_ports_layouts():
    s = port_solver(16, compat=True)
    mesh = api.make_mesh(devices=CPU8)
    caches = api.shard_pytree(mesh, s._caches)
    nE = caches["near_E"]
    assert isinstance(nE, Sharded) and nE.dims == (0, 1)
    assert nE.blocks[5].shape == (8, 4) + tuple(s._caches["near_E"].shape[2:])
    assert isinstance(caches["sigma_w"], Sharded)
    # level 2's (2, 2) parity planes do not divide the 2 x 4 mesh
    assert isinstance(caches["m2l_E"][2], Replicated)
    for level in (3, 4):
        E, full = caches["m2l_E"][level], s._caches["m2l_E"][level]
        assert isinstance(E, Sharded) and E.dims == (1, 2)
        m2 = full.shape[1]
        assert torch.equal(E.blocks[6], full[:, m2 // 2:, m2 // 2:m2 // 4 * 3])
        assert E.blocks[6].is_contiguous()
    ms = api.shard_pytree(mesh, s._mode_statics[0])
    assert isinstance(ms["duffy"], Sharded) and ms["duffy"].dims == (0, 1)
    for key in ("near_cosrw", "near_static"):
        assert isinstance(ms[key], Replicated)
    assert all(isinstance(t, Replicated) for t in ms["m2l_cosr"].values())
    stack = api.shard_pytree(mesh, s._mode_stack)
    assert stack["duffy"].dims == (1, 2)


def test_shard_pytree_replicates_per_offset_levels():
    s = port_solver(16)
    mesh = api.make_mesh(devices=CPU8)
    coeffs = s.sigma_t_coeff
    m2l = smooth.build_m2l_E(s.grid, s._tcfg, 3, coeffs,
                             {2: s._caches["m2l_E"][2]}, budget_bytes=0)
    placed = api.shard_pytree(mesh, {"m2l_E": m2l, "coeffs": coeffs})
    assert isinstance(placed["m2l_E"][4]["Wo"], Replicated)
    assert isinstance(placed["coeffs"], Sharded)


@pytest.mark.parametrize("mesh_n", [8, 4])
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("mode", [0, 1])
def test_sharded_matvec_matches_one_device(mode, compat, mesh_n):
    s = port_solver(32, compat, N=2)
    mesh = api.make_mesh(devices=["cpu"] * mesh_n)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    u = seeded(s.grid)
    out = apply_fn(caches, ms[mode], mode, api.shard_field(mesh, u))
    assert isinstance(out, Sharded)
    assert rel(out.full(), s.apply_mode(mode, u)) < 1e-12


@functools.lru_cache(maxsize=None)
def jax_solver(sz, compat):
    s = JSolver(JConfig(**config(sz, compat)), backend="fmm")
    s.set_coeff(*sigma(s.grid))
    return s


@pytest.mark.parametrize("compat", [False, True])
def test_sharded_matvec_matches_jax_sharded_solver(compat):
    if jax.device_count() != 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    js = jax_solver(32, compat)
    u = np.random.default_rng(0).standard_normal(js.grid.nodes_x.shape)
    jm = j_api.make_mesh()
    apply_j, caches_j, ms_j = j_api.sharded_solver(js, jm, halo="shardmap")
    want = np.asarray(apply_j(caches_j, ms_j[0], 0,
                              j_api.shard_field(jm, jnp.asarray(u))))
    s = port_solver(32, compat)
    mesh = api.make_mesh(devices=CPU8)
    apply_fn, caches, ms = api.sharded_solver(s, mesh, halo="shardmap")
    got = apply_fn(caches, ms[0], 0,
                   api.shard_field(mesh, torch.as_tensor(u))).full()
    assert rel(got, want) < 1e-10


def test_sharded_solver_keeps_jaxs_halo_names():
    s = port_solver(16)
    mesh = api.make_mesh(devices=CPU8)
    u = api.shard_field(mesh, seeded(s.grid))
    outs = []
    for name in ("gspmd", "shardmap"):
        apply_fn, caches, ms = api.sharded_solver(s, mesh, halo=name)
        outs.append(apply_fn(caches, ms[0], 0, u).full())
    assert torch.equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="unknown halo mode"):
        api.sharded_solver(s, mesh, halo="ring")


def test_per_offset_levels_take_the_replicated_route():
    """A zero dense budget makes levels 3 and 4 of 16^2 per-offset: K3's
    plain version runs on the whole level from the gathered M and the
    gathered coefficient field."""
    s = TransportSolver(SolverConfig(**config(16)), backend="fmm",
                        device="cpu")
    s.set_coeff(*sigma(s.grid))
    u = seeded(s.grid, 1)
    ref_dense = s.apply_mode(0, u)
    s._caches["m2l_E"] = smooth.build_m2l_E(
        s.grid, s._tcfg, 3, s.sigma_t_coeff, {2: s._caches["m2l_E"][2]},
        budget_bytes=0)
    s._caches["coeffs"] = s.sigma_t_coeff
    assert smooth.per_offset_levels(s._caches["m2l_E"]) == [3, 4]
    ref = s.apply_mode(0, u)
    assert rel(ref, ref_dense) < 1e-12
    mesh = api.make_mesh(devices=CPU8)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    halo.reset_collectives()
    out = apply_fn(caches, ms[0], 0, api.shard_field(mesh, u))
    st = halo.collective_stats()
    assert rel(out.full(), ref) < 1e-12
    # level 2 (replicated), levels 3 and 4 (per offset) gather M, and the
    # coefficient field once
    assert st.counts["all-gather"] == 4


@pytest.mark.parametrize("mesh_n", [8, 2])
def test_sharded_gmres_matches_one_device_solve(mesh_n):
    s = port_solver(16)
    g = s.grid
    q = torch.as_tensor(np.exp(-25 * ((g.nodes_x - 0.5) ** 2
                                      + (g.nodes_y - 0.5) ** 2)))
    b = s.apply_mode(0, q)
    ref = gmres(lambda v: v - s.apply_mode(0, s.sigma_s * v), b,
                restart=30, max_iter=60, tol=1e-10)
    mesh = api.make_mesh(devices=["cpu"] * mesh_n)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    sig = api.shard_field(mesh, s.sigma_s)
    calls = []

    def matvec(v):
        calls.append(1)
        return v - apply_fn(caches, ms[0], 0, sig * v)

    halo.reset_collectives()
    bs = apply_fn(caches, ms[0], 0, api.shard_field(mesh, q))
    res = gmres(matvec, bs, restart=30, max_iter=60, tol=1e-10)
    st = halo.collective_stats()
    assert res.converged and res.residual < 1e-10
    assert abs(res.iterations - ref.iterations) <= 1
    assert rel(res.x.full(), ref.x) < 1e-8
    # the iteration gathers no field: only the replicated route's level 2
    # (on the 2 x 4 mesh) gathers its M, once per matvec
    gathers = 0 if mesh.shape == (1, 2) else 1 + len(calls)
    assert st.counts.get("all-gather", 0) == gathers
    assert st.counts["all-reduce"] >= 3 * res.iterations


def test_collective_stats_is_jaxs():
    hlo = ("%a = f32[8,16]{1,0} all-gather(f32[4,16] %x), dimensions={0}\n"
           "%b = f64[2,3]{1,0} collective-permute(f64[2,3] %y)\n"
           "%c = f32[4]{0} all-reduce(f32[4] %z), to_apply=%sum\n")
    want = j_inspect.collective_stats(hlo)
    got = halo.CollectiveStats(dict(want.counts), dict(want.bytes))
    assert got._fields == want._fields
    assert got == tuple(want) and got.total_bytes() == want.total_bytes()
    assert got.total_bytes() == 8 * 16 * 4 + 2 * 3 * 8 + 4 * 4


def test_sharded_matvec_moves_o_halo_bytes():
    """tests/test_halo_wired.py:68-82 on the port's counters: the pattern
    is the code's (8 directions of halo per exchange: u's and the sharded
    levels' M), no volume all-gather, and less than one field per shard in
    all (f32, 32^2, deg 2, np 3, as there)."""
    s = port_solver(32, dtype="float32")
    mesh = api.make_mesh(devices=CPU8)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    u = api.shard_field(mesh, seeded(s.grid).float())
    halo.reset_collectives()
    apply_fn(caches, ms[0], 0, u)
    st = halo.collective_stats()
    field_bytes = s.grid.n_nodes * 4
    assert st.counts.get("permute", 0) >= 8, st
    assert st.bytes.get("all-gather", 0) <= 16 * 1024, st
    assert st.total_bytes() < mesh.size * field_bytes, st


def cpu_mesh(shape):
    return api.Mesh(shape, [torch.device("cpu")] * (shape[0] * shape[1]))


@pytest.mark.parametrize("block,stop", [((16, 2), 3), ((8, 4), 2),
                                        ((4, 2), 3), ((1, 1), 4),
                                        ((16, 16), 2), ((2, 8), 3)])
def test_stop_level_is_the_coarsest_level_of_whole_boxes(block, stop):
    assert api.stop_level(block, 4) == stop


def test_shard_field_replicates_a_field_that_does_not_divide():
    s = port_solver(16)
    mesh = cpu_mesh((2, 3))
    u = seeded(s.grid)
    sh = api.shard_field(mesh, u)
    assert sh.mesh is mesh.whole and sh.mesh.shape == (1, 1)
    assert sh.mesh.local == [0] and not sh.mesh.multiprocess
    assert torch.equal(sh.blocks[0], u) and torch.equal(sh.full(), u)


@pytest.mark.parametrize("sz", [16, 32])
@pytest.mark.parametrize("shape", [(1, 8), (2, 3)])
def test_sharded_matvec_on_any_mesh_matches_one_device(shape, sz):
    """(1, 8): blocks of sz x sz / 8 squares, whose boxes stop being whole
    above level 3 (16^2) or 4 (32^2): the coarse up pass and locals run
    whole from the gathered M; (2, 3): the field whole on one shard."""
    s = port_solver(sz)
    mesh = cpu_mesh(shape)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    u = seeded(s.grid, 3)
    out = apply_fn(caches, ms[0], 0, api.shard_field(mesh, u))
    assert rel(out.full(), s.apply_mode(0, u)) < 1e-12


@pytest.mark.parametrize("n", [3, 5, 6, 7, 12, 32])
def test_sharded_solver_takes_every_mesh_make_mesh_builds(n):
    s = port_solver(16, N=2)
    mesh = api.make_mesh(devices=["cpu"] * n)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    u = seeded(s.grid, n)
    out = apply_fn(caches, ms[1], 1, api.shard_field(mesh, u))
    assert rel(out.full(), s.apply_mode(1, u)) < 1e-12


@pytest.mark.parametrize("shape", [(1, 8), (2, 3)])
def test_sharded_gmres_on_any_mesh_matches_one_device(shape):
    s = port_solver(16)
    g = s.grid
    q = torch.as_tensor(np.exp(-25 * ((g.nodes_x - 0.5) ** 2
                                      + (g.nodes_y - 0.5) ** 2)))
    b = s.apply_mode(0, q)
    ref = gmres(lambda v: v - s.apply_mode(0, s.sigma_s * v), b,
                restart=30, max_iter=60, tol=1e-10)
    mesh = cpu_mesh(shape)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    sig = api.shard_field(mesh, s.sigma_s)
    bs = apply_fn(caches, ms[0], 0, api.shard_field(mesh, q))
    res = gmres(lambda v: v - apply_fn(caches, ms[0], 0, sig * v), bs,
                restart=30, max_iter=60, tol=1e-10)
    assert res.converged and res.iterations == ref.iterations
    assert rel(res.x.full(), ref.x) < 1e-8


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_release_moves_the_caches_onto_the_mesh(shape):
    """sharded_solver(..., release=True) places the blocks that the default
    copies, so its matvec is bitwise the same, and leaves no whole level
    referenced: after a solve (whose step's reads hold every cache tensor)
    the solver keeps no cache and no captured step, each whole array that
    was sharded is freed, and one that is replicated is the placed tree's
    own copy on its device."""
    s = TransportSolver(SolverConfig(**config(16)), backend="fmm",
                        device="cpu")
    s.set_coeff(*sigma(s.grid))
    g = s.grid
    s.solve(np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2)))
    assert s._graph_reads
    mesh = cpu_mesh(shape)
    u = api.shard_field(mesh, seeded(g, 2))
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    want = apply_fn(caches, ms[0], 0, u).full()
    del apply_fn, caches, ms
    whole = {("m2l_E", lv): weakref.ref(E)
             for lv, E in s._caches["m2l_E"].items()}
    whole.update({(k, None): weakref.ref(s._caches[k])
                  for k in ("near_E", "sigma_w")})
    apply_fn, caches, ms = api.sharded_solver(s, mesh, release=True)
    gc.collect()
    assert s._caches is None and s._graphs == {} and s._graph_reads == []
    replicated = set()
    for (key, lv), ref in whole.items():
        placed = caches[key] if lv is None else caches[key][lv]
        if isinstance(placed, Replicated):
            replicated.add(lv)
            assert ref() is placed.on(torch.device("cpu"))
        else:
            assert isinstance(placed, Sharded) and ref() is None, (key, lv)
    # level 2's (2, 2) parity planes divide a 2 x 2 mesh, not a 2 x 4 one
    assert replicated == (set() if shape == (2, 2) else {2})
    assert torch.equal(apply_fn(caches, ms[0], 0, u).full(), want)
    with pytest.raises(RuntimeError, match="set_coeff"):
        s.apply_mode(0, seeded(g))


def test_shard_pytree_release_empties_the_tree_largest_first(monkeypatch):
    """release places the largest array first and sets each entry of the
    tree to None once it is placed; the placed tree equals the copy."""
    s = port_solver(16)
    mesh = cpu_mesh((2, 2))
    tree = {"near_E": s._caches["near_E"], "sigma_w": s._caches["sigma_w"],
            "m2l_E": dict(s._caches["m2l_E"]), "none": None}
    order = []
    shard = api.shard

    def spy(mesh, x, dims=(0, 1)):
        order.append(x.numel())
        return shard(mesh, x, dims)

    monkeypatch.setattr(api, "shard", spy)
    placed = api.shard_pytree(mesh, tree, release=True)
    assert order == sorted(order, reverse=True) and len(order) == 5
    assert tree["m2l_E"] == {2: None, 3: None, 4: None}
    assert tree["near_E"] is None and tree["sigma_w"] is None
    assert placed["none"] is None
    for lv in (2, 3, 4):
        full = s._caches["m2l_E"][lv]
        m2 = full.shape[1]
        assert torch.equal(placed["m2l_E"][lv].blocks[3],
                           full[:, m2 // 2:, m2 // 2:])

