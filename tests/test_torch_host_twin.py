"""The host f64 refinement twin (refine_twin="host") against the JAX
package's, on the CPU.

The port's host builders (aniso_torch/fmm/smooth.py: build_near_E_np,
build_m2l_E_fine_np, _coarse_dgemm_level_np, build_m2l_E_coarse_oracle_np,
build_m2l_E_coarse_np, build_m2l_E_coarse_all_np, build_m2l_E_host) against
aniso_tpu's on 16^2 and 32^2 in f64 at deg 3, np 4: the same numpy
contractions, summed in another order, so 1e-13 of the largest value (the
port stores near E and the M2L levels in its kernels' layouts; the JAX
arrays are permuted to them).  The per-pair oracle against the port's fast
coarse levels (the host GEMMs, the canonical per-pair half with the mirror
fill, and K6's plain version) on every observable entry, as
tests/test_coarse_e.py holds JAX's.  Then a refined solve with the host
twin against JAX's at 16^2: the same rounds, x within 1e-10; the host and
device twins' operators within 1e-12.  Last, every data.cfg key of
_KEYMAP at values JAX's validate accepts: the port's TransportSolver
constructs on the CPU wherever JAX's does, on both backends, and refuses
(with the same exception) wherever JAX's does.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from aniso_tpu.core import config as j_config
from aniso_tpu.core.geometry import make_grid as j_make_grid
from aniso_tpu.fmm import smooth as j_smooth
from aniso_tpu.fmm.structure import tree_config as j_tree_config
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.core import config as t_config
from aniso_torch.core.geometry import make_grid, project_field
from aniso_torch.fmm import smooth as t_smooth
from aniso_torch.fmm.structure import tree_config, vlist_offsets
from aniso_torch.solver.operator import TransportSolver
from aniso_torch.solver.refine import RefinedResult

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NP = 4
R = NP * NP
TOL_BUILD = 1e-13


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


@functools.lru_cache(maxsize=None)
def medium(sz):
    """(port grid, JAX grid, port tree, JAX tree, sigma_t's Legendre
    coefficients (sz, sz, nq)) of a seeded medium at deg 3."""
    g = make_grid(sz, 3)
    sig = 2.0 + np.random.default_rng(sz).uniform(0.0, 3.0, g.nodes_x.shape)
    return (g, j_make_grid(sz, 3), tree_config(sz), j_tree_config(sz),
            project_field(g, sig))


def levels(sz, fine):
    _, _, tcfg, _, _ = medium(sz)
    return [(sz, lv) for lv in range(2, tcfg.leaf_level + 1)
            if (tcfg.box_size_squares(lv) <= 2) == fine]


@pytest.mark.parametrize("sz", [16, 32])
def test_near_E_np_matches_jax(sz):
    """JAX's (3, 3, nq_t, nq_s, sz, sz) against the port's K2 layout
    (sz, sz, nq_t, 3, 3, nq_s); both in physical units."""
    g, jg, _, _, cf = medium(sz)
    got = t_smooth.build_near_E_np(g, cf)
    want = j_smooth.build_near_E_np(jg, cf).transpose(4, 5, 2, 0, 1, 3)
    assert got.dtype == np.float64 and got.flags.c_contiguous
    assert rel(got, want) < TOL_BUILD


@pytest.mark.parametrize("sz,level", levels(16, True) + levels(32, True))
def test_m2l_E_fine_np_matches_jax(sz, level):
    """Every fine level (B 1 and 2): (4, m2, m2, r, 27r), the (a, o, b)
    pair axis of JAX's flat P split."""
    g, jg, tcfg, jt, cf = medium(sz)
    got = t_smooth.build_m2l_E_fine_np(g, tcfg, level, NP, cf)
    want = j_smooth.build_m2l_E_fine_np(jg, jt, level, NP, cf)
    m2 = tcfg.boxes(level) // 2
    assert got.shape == (4, m2, m2, R, 27 * R)
    assert rel(got.reshape(want.shape), want) < TOL_BUILD


@pytest.mark.parametrize("sz,level", levels(16, False) + levels(32, False))
def test_coarse_dgemm_level_np_matches_jax(sz, level):
    """The per-offset host GEMMs with the mirror fill, (4, m2, m2, 27, r,
    r), at every coarse level (called directly: at these grids the
    production path takes the per-pair engine)."""
    g, jg, tcfg, jt, cf = medium(sz)
    got = t_smooth._coarse_dgemm_level_np(g, tcfg, level, NP, cf)
    want = j_smooth._coarse_dgemm_level_np(jg, jt, level, NP, cf)
    assert rel(got, want) < TOL_BUILD


@pytest.mark.parametrize("sz,level", levels(16, False) + levels(32, False))
def test_coarse_oracle_and_production_np_match_jax(sz, level):
    """The all-pairs per-pair oracle and the production coarse builder
    (here the canonical per-pair half and the mirror fill), on the port's
    host engine and the reference's native library alike."""
    g, jg, tcfg, jt, cf = medium(sz)
    got = t_smooth.build_m2l_E_coarse_oracle_np(g, tcfg, level, NP, cf)
    want = j_smooth.build_m2l_E_coarse_oracle_np(jg, jt, level, NP, None,
                                                  coeffs_np=cf)
    assert rel(got, want) < TOL_BUILD
    got = t_smooth.build_m2l_E_coarse_np(g, tcfg, level, NP, cf)
    want = j_smooth.build_m2l_E_coarse_np(jg, jt, level, NP, None,
                                          coeffs_np=cf)
    assert rel(got, want) < TOL_BUILD


@pytest.mark.parametrize("sz", [16, 32])
def test_coarse_all_np_and_host_cache_match_jax(sz):
    """Every coarse level on the host, and the host twin's whole M2L cache
    (dense at every level, CPU float64 tensors in K1's layout), with and
    without the coarse levels shared."""
    g, jg, tcfg, jt, cf = medium(sz)
    coarse = t_smooth.build_m2l_E_coarse_all_np(g, tcfg, NP, cf)
    jcoarse = j_smooth.build_m2l_E_coarse_all_np(jg, jt, NP, cf)
    assert set(coarse) == set(jcoarse) == set(t_smooth.coarse_m2l_levels(tcfg))
    for lv in coarse:
        assert rel(coarse[lv], jcoarse[lv]) < TOL_BUILD
    want = j_smooth.build_m2l_E_host(jg, jt, NP, cf, coarse_np=jcoarse)
    for shared in (coarse, None):
        got = t_smooth.build_m2l_E_host(g, tcfg, NP, cf, coarse_np=shared)
        assert sorted(got) == sorted(want) == list(range(2,
                                                         tcfg.leaf_level + 1))
        for lv, E in got.items():
            m2 = tcfg.boxes(lv) // 2
            assert E.dtype == torch.float64 and E.device.type == "cpu"
            assert E.shape == (4, m2, m2, R, 27 * R)
            assert rel(E.numpy().reshape(4, m2, m2, -1),
                       np.asarray(want[lv])) < TOL_BUILD
    shared = t_smooth.build_m2l_E_host(g, tcfg, NP, cf, coarse_np=coarse)
    lv = min(coarse)
    assert np.shares_memory(shared[lv].numpy(), coarse[lv])


def observable_max_diff(E_a, E_b, m2):
    """Max |E_a - E_b| over the (box, offset) entries whose source box
    lies in the domain (tests/test_coarse_e.py's measure)."""
    A = np.asarray(E_a).reshape(4, m2, m2, R, 27, R)
    B = np.asarray(E_b).reshape(4, m2, m2, R, 27, R)
    worst = 0.0
    for px in (0, 1):
        for py in (0, 1):
            for o, (di, dj) in enumerate(vlist_offsets(px, py)):
                xs = [x for x in range(m2) if 0 <= 2 * x + px + di < 2 * m2]
                ys = [y for y in range(m2) if 0 <= 2 * y + py + dj < 2 * m2]
                if xs and ys:
                    sub = np.ix_(xs, ys)
                    d = A[2 * px + py][sub] - B[2 * px + py][sub]
                    worst = max(worst, float(np.abs(d[..., o, :]).max()))
    return worst


@pytest.mark.parametrize("sz,level", [(32, 2), (64, 4)])
def test_coarse_oracle_matches_fast_levels(sz, level):
    """32^2 level 2 (B 8, m2 2): the canonical per-pair half and the
    mirror; 64^2 level 4 (B 4, m2 8): the host GEMMs and K6's plain
    version (build_m2l_E_coarse_device on CPU tensors), the levels the
    fast path builds, against the all-pairs oracle within 1e-11."""
    g = make_grid(sz, 3)
    tcfg = tree_config(sz)
    sig = 2.0 + np.random.default_rng(1234).uniform(0.0, 3.0,
                                                    g.nodes_x.shape)
    cf = project_field(g, sig)
    m2 = tcfg.boxes(level) // 2
    oracle = t_smooth.build_m2l_E_coarse_oracle_np(g, tcfg, level, NP, cf)
    fast = [t_smooth.build_m2l_E_coarse_np(g, tcfg, level, NP, cf)]
    if t_smooth._coarse_dgemm_eligible(g, tcfg, level, NP):
        fast.append(t_smooth.build_m2l_E_coarse_device(
            g, tcfg, level, NP, torch.as_tensor(cf)).numpy())
    assert len(fast) == (2 if sz == 64 else 1)
    for E in fast:
        assert observable_max_diff(E, oracle, m2) < 1e-11


# -- the refined solve --

KW = dict(domain_size=16, quad_rule=3, kernel_size=1, g=0.5, sing_rule=8,
          np_cheb=NP, dtype="float32", refine=True, tol=1e-11, restart=60,
          max_iter=300)


def problem(grid):
    sig = 8 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    q = np.exp(-25 * ((grid.nodes_x - 0.5) ** 2 + (grid.nodes_y - 0.5) ** 2))
    return sig, q


@functools.lru_cache(maxsize=None)
def host_pair():
    """(JAX solver, port solver, JAX result, port result): the 16^2 refined
    problem of tests/test_torch_refine.py with the twin on the host in both
    packages."""
    js = JSolver(j_config.SolverConfig(refine_twin="host", **KW),
                 backend="fmm")
    ts = TransportSolver(t_config.SolverConfig(refine_twin="host", **KW),
                         backend="fmm", device="cpu")
    sig, q = problem(ts.grid)
    js.set_coeff(sig, sig + 0.2)
    ts.set_coeff(sig, sig + 0.2)
    return js, ts, js.solve(q[None]), ts.solve(q)


def test_host_twin_layout():
    """The host twin: near E and every M2L level dense float64 on the CPU
    (no per-offset level, no coefficient field), the coarse levels shared
    with the fast path's cast; twin_host_s among the set_coeff phases."""
    _, ts, _, _ = host_pair()
    c64, c32 = ts._caches64, ts._caches
    assert ts._twin_device == torch.device("cpu")
    assert set(c64) == {"sigma_w", "near_E", "m2l_E"}
    assert all(t.dtype == torch.float64 and t.device.type == "cpu"
               for t in (c64["sigma_w"], c64["near_E"],
                         *c64["m2l_E"].values()))
    assert t_smooth.per_offset_levels(c64["m2l_E"]) == []
    assert torch.equal(c32["m2l_E"][2], c64["m2l_E"][2].float())
    assert {"coarse_s", "twin_host_s"} <= set(ts.set_coeff_phases)
    assert "twin_s" not in ts.set_coeff_phases


def test_host_twin_refined_solve_matches_jax():
    """The same rounds as JAX's host-twin solve, x within 1e-10 of its x,
    on the twin's device; the true f64 residual below the tol."""
    js, ts, ref, res = host_pair()
    assert isinstance(res, RefinedResult)
    assert res.converged and res.refinements == ref.refinements >= 2
    assert res.x.dtype == torch.float64 and res.x.device.type == "cpu"
    assert rel(res.x.numpy(), np.asarray(ref.x)) < 1e-10
    _, q = problem(ts.grid)
    b = ts._rhs64(q)
    true = float(torch.linalg.vector_norm(b - ts._forward64(res.x))
                 / torch.linalg.vector_norm(b))
    assert true < KW["tol"]
    assert set(res.phases) == set(ref.phases)


def test_host_twin_operator_matches_jax_and_device_twin():
    """The host twin's forward and rhs against JAX's host twin (1e-12),
    and against the port's device twin (every fine level per-offset there)
    built on the same medium (1e-12)."""
    js, ts, _, _ = host_pair()
    dev = TransportSolver(t_config.SolverConfig(**KW), backend="fmm",
                          device="cpu")
    sig, q = problem(ts.grid)
    dev.set_coeff(sig, sig + 0.2)
    assert t_smooth.per_offset_levels(dev._caches64["m2l_E"]) == [3, 4]
    u = np.random.default_rng(4).standard_normal((1,) + ts.grid.nodes_x.shape)
    got = ts._forward64(u)
    want = js._forward64(jax.device_put(u, js._twin_device))
    assert rel(got.numpy(), np.asarray(want)) < 1e-12
    assert rel(got.numpy(), dev._forward64(u).numpy()) < 1e-12
    assert rel(ts._rhs64(q).numpy(), dev._rhs64(q).numpy()) < 1e-12


# -- every data.cfg key --

BASE = {"domainSize": "8", "quadRule": "2", "singRule": "4", "np": "3",
        "dtype": "float32"}
# each _KEYMAP key at values JAX's validate accepts (the enumerated keys at
# every value, the numeric ones at two or three), and the refined solve
# with each twin
VALUES = {
    "kernelSize": ["1", "2"], "g": ["0.0", "0.95"],
    "domainSize": ["8", "16", "12"], "quadRule": ["1", "3"],
    "singRule": ["1", "8"], "np": ["2", "4", "6"], "maxLevel": ["2", "20"],
    "Krylov": ["GMRES", "gmres"], "Precdn": ["NONE", "DSA", "FFT"],
    "IO": ["0", "1"], "restart": ["1", "80"], "maxIter": ["1", "400"],
    "tol": ["1e-6", "1e-12"], "dtype": ["float32", "float64"],
    "Refine": ["0", "1"], "RefineTwin": ["device", "host"],
}
CFG_CASES = ([(k, v) for k in t_config._KEYMAP for v in VALUES[k]]
             + [("Refine", "1;RefineTwin=host")])


def test_cfg_cases_cover_every_key():
    assert set(VALUES) == set(t_config._KEYMAP) == set(j_config._KEYMAP)


def outcome(make):
    try:
        make()
    except Exception as e:      # the refusal's type is compared
        return type(e).__name__
    return "constructs"


@pytest.mark.parametrize("key,value", CFG_CASES)
def test_every_cfg_key_constructs_where_jax_does(tmp_path, key, value):
    """A data.cfg of BASE with `key = value` (and RefineTwin = host beside
    Refine = 1 in the last case) parses alike in both packages and JAX's
    validate accepts it; then TransportSolver(cfg, device="cpu") on each
    backend constructs where JAX's constructs, and where JAX's refuses
    (refine on the dense backend, a grid not a power of two on the FMM)
    refuses with the same exception."""
    lines = {**BASE, key: value.split(";")[0]}
    for extra in value.split(";")[1:]:
        k, v = extra.split("=")
        lines[k] = v
    path = tmp_path / "data.cfg"
    path.write_text("".join(f"{k} = {v}\n" for k, v in lines.items()))
    jcfg = j_config.load_cfg(str(path))
    tcfg = t_config.load_cfg(str(path))
    assert tcfg.to_dict() == jcfg.to_dict()
    for backend in ("fmm", "dense"):
        want = outcome(lambda: JSolver(jcfg, backend=backend))
        got = outcome(lambda: TransportSolver(tcfg, backend=backend,
                                              device="cpu"))
        assert got == want, (backend, got, want)
