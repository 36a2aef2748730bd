"""aniso_torch's multi-mode system against aniso_tpu's, f64 on the CPU.

The mode coupling tensor and chi (bitwise), the plain versions of the
all-modes kernels K1 and K2 against JAX's per-mode functions on the same
inputs, the all-modes FMM sweep, the coupled forward / rhs / f64 twin with
JAX's caches carried across by aniso_torch.convert, and the N = 2 solve
(K3's all-modes plain version and np 6 are in
test_torch_multimode_offsets.py, the f64 twin and the refined solve in
test_torch_multimode_refine.py).
JAX's fused programs run as its own tests run them on the CPU.  Tolerances:
1e-12 of the maximum for the kernels, the sweep and the operators (f64 sums
taken in another order), 1e-10 for the solve's x.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.fmm import apply as j_apply
from aniso_tpu.solver.operator import TransportSolver as JSolver
from aniso_tpu.solver.operator import _mode_coupling as j_mode_coupling

from aniso_torch.convert import (
    _m2l_level_from_jax, caches_from_jax_numpy, mode_stack_from_jax_numpy,
)
from aniso_torch.core.config import SolverConfig
from aniso_torch.fmm import apply as t_apply
from aniso_torch.fmm import smooth as t_smooth
from aniso_torch.kernels.m2l import m2l_translate_plain
from aniso_torch.kernels.near import near_contract_plain
from aniso_torch.solver.operator import (
    TransportSolver, _mode_coupling, mode_chi,
)

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64

# JAX's matvec internals under jit, as the JAX package's jitted matvec runs
# them: called eagerly, each of their primitives compiles on its own
translate_j = jax.jit(j_apply._m2l_translate)
translate_offsets_multi_j = jax.jit(j_apply._m2l_translate_offsets_multi)
vlist_gather_j = jax.jit(j_apply._vlist_gather)
near_apply_j = jax.jit(j_apply._near_apply, static_argnums=2)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def sigma(grid):
    s = 6 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x)) \
        + np.sin(3 * grid.nodes_y) ** 2
    return s, s + 0.2


@functools.lru_cache(maxsize=None)
def pair(N, compat=False, g=0.8):
    """(JAX solver, port solver) at 16^2, deg 3, np 4, f64, N modes."""
    kw = dict(domain_size=16, quad_rule=3, kernel_size=N, g=g, sing_rule=8,
              np_cheb=4, dtype="float64", tol=1e-10, restart=60,
              max_iter=300, compat_global_basis=compat)
    js = JSolver(JConfig(**kw), backend="fmm")
    ts = TransportSolver(SolverConfig(**kw), backend="fmm",
                         device="cpu")
    js.set_coeff(*sigma(js.grid))
    ts.set_coeff(*sigma(ts.grid))
    return js, ts


def jax_caches_np(c):
    """A JAX cache dict (dense, per-offset or twin) as numpy."""
    def level(E):
        if isinstance(E, dict):
            return {"Wo": tuple(np.asarray(w) for w in E["Wo"])}
        if isinstance(E, (tuple, list)):
            return tuple(np.asarray(b) for b in E)
        return np.asarray(E)

    out = {k: np.asarray(v) for k, v in c.items() if k != "m2l_E"}
    out["m2l_E"] = {lv: level(E) for lv, E in c["m2l_E"].items()}
    return out


def jax_mode_statics_np(mode_statics):
    out = []
    for ms in mode_statics:
        d = {"m2l_cosr": {lv: np.asarray(v)
                          for lv, v in ms["m2l_cosr"].items()},
             "near_cosrw": np.asarray(ms["near_cosrw"]),
             "near_static": np.asarray(ms["near_static"])}
        if "duffy" in ms:
            d["duffy"] = np.asarray(ms["duffy"])
        out.append(d)
    return out


def fields(grid, n, seed):
    return np.random.default_rng(seed).standard_normal(
        (n,) + grid.nodes_x.shape)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("N", [1, 2, 3, 5])
def test_mode_coupling_bitwise(N, weighted):
    chi = mode_chi(N, 0.8)
    got = _mode_coupling(N, chi, weighted)
    assert got.shape == (N, N, 2 * N - 1)
    assert np.array_equal(got, j_mode_coupling(N, chi, weighted))


@pytest.mark.parametrize("g", [0.0, 0.8])
def test_chi_matches_jax(g):
    js = JSolver(JConfig(domain_size=4, quad_rule=1, kernel_size=3, g=g,
                         sing_rule=4, np_cheb=3), backend="fmm")
    assert np.array_equal(mode_chi(3, g), js.chi)
    if g == 0.0:
        assert list(mode_chi(3, g)) == [1.0, 0.0, 0.0]


def test_mode_tables_match_jax():
    """The stacked tables built by the port equal JAX's per-mode tables
    carried across by convert, for every mode."""
    js, ts = pair(3)
    want = mode_stack_from_jax_numpy(jax_mode_statics_np(js._mode_statics),
                                     "cpu", F64)
    got = ts._mode_stack
    assert got["near_cosrw"].shape == (5, 9, 3, 3, 9)
    for lv, t in got["m2l_cosr"].items():
        assert t.shape == (5, 4, 16, 432)
        assert rel(t.numpy(), want["m2l_cosr"][lv].numpy()) < 1e-13
    for k in ("near_cosrw", "near_static"):
        assert rel(got[k].numpy(), want[k].numpy()) < 1e-13
    assert got["duffy"] is None and want["duffy"] is None
    # the per-mode tables are views of the stack
    assert ts._mode_statics[2]["near_cosrw"].data_ptr() == \
        got["near_cosrw"][2].data_ptr()


@pytest.mark.parametrize("level", [2, 3, 4])
def test_m2l_all_modes_plain_matches_jax_per_mode(level):
    """K1's plain version with the mode axis against JAX's _m2l_translate
    called once per mode, both on JAX's E of the level carried across by
    convert: the translates alone are compared.  (Level 2 at 16^2 is a
    per-pair coarse level, which JAX builds with the reference's native
    library when it loads; that library's build races between test
    workers, and the E it gives a worker is not this test's subject.)"""
    js, ts = pair(3)
    m = 1 << level
    M = np.random.default_rng(level).standard_normal((m, m, 16))
    gsel = vlist_gather_j(jnp.asarray(M))
    E = torch.tensor(_m2l_level_from_jax(
        jax_caches_np(js._caches)["m2l_E"][level]), dtype=F64)
    assert E.shape == ts._caches["m2l_E"][level].shape
    got = m2l_translate_plain(
        E, ts._mode_stack["m2l_cosr"][level], torch.as_tensor(M),
        ts._fmm_static["shift"])
    assert got.shape == (5, m, m, 16)
    for d in range(5):
        want = translate_j(
            js._caches["m2l_E"][level],
            js._mode_statics[d]["m2l_cosr"][level], gsel)
        assert rel(got[d].numpy(), np.asarray(want)) < 1e-12
    # one mode of the stack is the D = 1 form
    one = m2l_translate_plain(
        E, ts._mode_statics[3]["m2l_cosr"][level], torch.as_tensor(M),
        ts._fmm_static["shift"])
    assert torch.equal(one, got[3])


@pytest.mark.parametrize("compat", [False, True])
def test_near_all_modes_plain_matches_jax_per_mode(compat):
    """K2's plain version with the mode axis against JAX's _near_apply per
    mode: the diagonal on mode 0 only, and in compat mode every mode's own
    Duffy blocks."""
    js, ts = pair(2, compat)
    u = fields(ts.grid, 1, 21)[0]
    st = ts._mode_stack
    assert (st["duffy"] is not None) == compat
    got = near_contract_plain(
        ts._caches["near_E"], st["near_cosrw"], st["near_static"],
        torch.as_tensor(u), ts._caches["sigma_w"], st["duffy"])
    assert got.shape == (3, 16, 16, 9)
    for d in range(3):
        want = near_apply_j(js._caches, js._mode_statics[d], d,
                            jnp.asarray(u))
        assert rel(got[d].numpy(), np.asarray(want)) < 1e-12
    if compat:
        assert st["duffy"].shape == (3, 16, 16, 9, 9)
        assert not torch.equal(st["duffy"][0], st["duffy"][1])


@pytest.mark.parametrize("caches", ["port", "from_jax"])
@pytest.mark.parametrize("compat", [False, True])
def test_fmm_apply_all_modes_matches_jax(compat, caches):
    js, ts = pair(2, compat)
    u = fields(ts.grid, 1, 31)[0]
    want = j_apply.fmm_apply_all_modes(
        js._tcfg.leaf_level, js._fmm_static, js._caches, js._mode_statics,
        jnp.asarray(u))
    if caches == "port":
        c, st = ts._caches, ts._mode_stack
    else:
        c = caches_from_jax_numpy(jax_caches_np(js._caches), ts.grid,
                                  ts._tcfg, "cpu", F64)
        st = mode_stack_from_jax_numpy(
            jax_mode_statics_np(js._mode_statics), "cpu", F64)
    got = t_apply.fmm_apply_all_modes(ts._tcfg.leaf_level, ts._fmm_static,
                                      c, st, torch.as_tensor(u))
    assert got.shape == (3, 16, 16, 9)
    for d in range(3):
        assert rel(got[d].numpy(), np.asarray(want[d])) < 1e-12


def test_all_modes_sweep_equals_per_mode_sweeps():
    """One all-modes sweep is the D one-mode sweeps of apply_mode."""
    _, ts = pair(3)
    u = fields(ts.grid, 1, 41)[0]
    got = t_apply.fmm_apply_all_modes(
        ts._tcfg.leaf_level, ts._fmm_static, ts._caches, ts._mode_stack,
        torch.as_tensor(u))
    for d in range(5):
        assert rel(got[d].numpy(), ts.apply_mode(d, u).numpy()) < 1e-13


def test_all_modes_sweep_with_per_offset_levels_matches_dense():
    """The torch analogue of the JAX package's
    test_offsets_multimode_forward_matches_dense: every fine level
    per-offset (K3 with the mode axis) against the dense sweep."""
    _, ts = pair(3)
    coeffs = ts.sigma_t_coeff
    coarse = t_smooth.build_m2l_E_coarse_all(ts.grid, ts._tcfg, 4,
                                             coeffs.numpy(), "cpu")
    virt = dict(ts._caches)
    virt["m2l_E"] = t_smooth.build_m2l_E(ts.grid, ts._tcfg, 4, coeffs,
                                         coarse, budget_bytes=0)
    virt["coeffs"] = coeffs
    assert t_smooth.per_offset_levels(virt["m2l_E"]) == [3, 4]
    u = torch.as_tensor(fields(ts.grid, 1, 43)[0])
    args = (ts._tcfg.leaf_level, ts._fmm_static)
    want = t_apply.fmm_apply_all_modes(*args, ts._caches, ts._mode_stack, u)
    got = t_apply.fmm_apply_all_modes(*args, virt, ts._mode_stack, u)
    assert rel(got.numpy(), want.numpy()) < 1e-12


@pytest.mark.parametrize("N", [2, 3])
@pytest.mark.parametrize("op", ["forward", "rhs"])
def test_coupled_operator_matches_jax(N, op):
    """forward and rhs with JAX's caches and tables carried across by
    convert, and with the port's own."""
    js, ts = pair(N)
    u = fields(ts.grid, N, 50 + N)
    want = np.asarray(getattr(js, op)(jnp.asarray(u)))
    own = getattr(ts, op)(u)
    assert own.shape == (N, 16, 16, 9)
    assert rel(own.numpy(), want) < 1e-12
    keep = ts._caches, ts._mode_stack
    ts._caches = caches_from_jax_numpy(jax_caches_np(js._caches), ts.grid,
                                       ts._tcfg, "cpu", F64)
    ts._mode_stack = mode_stack_from_jax_numpy(
        jax_mode_statics_np(js._mode_statics), "cpu", F64)
    try:
        carried = getattr(ts, op)(u)
    finally:
        ts._caches, ts._mode_stack = keep
    assert rel(carried.numpy(), want) < 1e-12


def test_forward_at_g0_scatters_mode_0_only():
    """chi = (1, 0, 0) at g = 0: forward agrees with JAX and rows i > 0
    couple to charge 0 alone."""
    js, ts = pair(3, g=0.0)
    u = fields(ts.grid, 3, 61)
    assert rel(ts.forward(u).numpy(),
               np.asarray(js.forward(jnp.asarray(u)))) < 1e-12
    assert float(ts._C_fwd[:, 1:].abs().max()) == 0.0


def test_n2_solve_16_matches_jax():
    js, ts = pair(2)
    g = ts.grid
    q = np.zeros((2,) + g.nodes_x.shape)
    q[0] = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    ref = js.solve(jnp.asarray(q))
    n0 = ts.n_matvecs
    got = ts.solve(q)
    assert got.converged and got.iterations == int(ref.iterations)
    assert got.x.shape == (2, 16, 16, 9)
    assert rel(got.x.numpy(), np.asarray(ref.x)) < 1e-10
    # N sweeps per operator application: rhs, r0, one per iteration, and
    # the true residual at the end of the restart cycle
    assert ts.n_matvecs - n0 == 2 * (got.iterations + 3)


def test_cache_report_counts_every_mode():
    _, ts = pair(3)
    rep = ts.cache_report()
    st = ts._mode_stack
    assert rep["mode_statics"] == 8 * (
        sum(t.numel() for t in st["m2l_cosr"].values())
        + st["near_cosrw"].numel() + st["near_static"].numel())
    _, one = pair(1)
    assert rep["mode_statics"] == 5 * one.cache_report()["mode_statics"]
    assert rep["total"] == sum(v for k, v in rep.items() if k != "total")
