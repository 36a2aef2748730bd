"""aniso_torch's FMM caches and matvec against aniso_tpu's, f64 on the CPU.

The same sigma field goes through both packages' set_coeff; the caches, the
plain versions of the kernels K1 (M2L translate) and K2 (near contraction)
and the whole corrected matvec are compared.  Tolerances: 1e-13 relative
for the caches (the same f64 quadrature sums taken in another order),
1e-12 for the kernels and the matvec (a few more f64 sums in another
order).
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu import native as j_native
from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.fmm import apply as j_apply
from aniso_tpu.fmm import smooth as j_smooth
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch import native as t_native
from aniso_torch.convert import caches_from_jax_numpy, mode_static_from_jax_numpy
from aniso_torch.core.config import SolverConfig
from aniso_torch.fmm import apply as t_apply
from aniso_torch.fmm import smooth as t_smooth
from aniso_torch.kernels.m2l import m2l_translate_plain
from aniso_torch.kernels.near import near_contract_plain
from aniso_torch.solver.operator import TransportSolver

F64 = torch.float64


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def sigma(grid):
    s = 16 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    return s, s + 0.2


@functools.lru_cache(maxsize=None)
def pair(sz, compat):
    """(JAX solver, port solver) at sz^2, deg 3, np 4, f64, same sigma."""
    kw = dict(domain_size=sz, quad_rule=3, kernel_size=1, g=0.95,
              sing_rule=8, np_cheb=4, dtype="float64",
              compat_global_basis=compat)
    js = JSolver(JConfig(**kw), backend="fmm")
    ts = TransportSolver(SolverConfig(**kw), device="cpu")
    js.set_coeff(*sigma(js.grid))
    ts.set_coeff(*sigma(ts.grid))
    return js, ts


def jax_caches_np(js):
    c = js._caches
    m2l = {
        lv: tuple(np.asarray(b) for b in E) if isinstance(E, tuple)
        else np.asarray(E)
        for lv, E in c["m2l_E"].items()
    }
    return {"near_E": np.asarray(c["near_E"]), "m2l_E": m2l,
            "sigma_w": np.asarray(c["sigma_w"])}


def jax_mode_static_np(js):
    ms = js._mode_statics[0]
    out = {"m2l_cosr": {lv: np.asarray(v) for lv, v in ms["m2l_cosr"].items()},
           "near_cosrw": np.asarray(ms["near_cosrw"]),
           "near_static": np.asarray(ms["near_static"])}
    if "duffy" in ms:
        out["duffy"] = np.asarray(ms["duffy"])
    return out


def field(grid, seed=3):
    return np.random.default_rng(seed).standard_normal(grid.nodes_x.shape)


@pytest.mark.parametrize("sz", [16, 32])
def test_near_E_and_sigma_w_match_jax(sz):
    js, ts = pair(sz, False)
    want = np.asarray(js._caches["near_E"]).transpose(4, 5, 2, 0, 1, 3)
    assert rel(ts._caches["near_E"].numpy(), want) < 1e-13
    assert rel(ts._caches["sigma_w"].numpy(),
               np.asarray(js._caches["sigma_w"])) < 1e-13


@pytest.mark.parametrize("sz,level", [(16, 2), (16, 3), (16, 4),
                                      (32, 2), (32, 3), (32, 4), (32, 5)])
def test_m2l_E_level_matches_jax(sz, level):
    js, ts = pair(sz, False)
    want = caches_from_jax_numpy(jax_caches_np(js), ts.grid, ts._tcfg,
                                 "cpu", F64)["m2l_E"][level]
    got = ts._caches["m2l_E"][level]
    assert got.shape == want.shape == (4, 1 << (level - 1), 1 << (level - 1),
                                       16, 432)
    assert rel(got.numpy(), want.numpy()) < 1e-13


def test_convert_reads_y_minor_fine_levels(monkeypatch):
    """JAX stores a fine level y-minor (m2, r, 27r, m2) when m2 is a
    multiple of its lane tile; with the tile shrunk to 4, both fine levels
    at 16^2 take that layout and caches_from_jax_numpy must undo it."""
    _, ts = pair(16, False)
    monkeypatch.setattr(j_smooth, "_DENSE_LANE_ALIGN", 4)
    js = JSolver(JConfig(domain_size=16, quad_rule=3, kernel_size=1, g=0.95,
                         sing_rule=8, np_cheb=4, dtype="float64"),
                 backend="fmm")
    js.set_coeff(*sigma(js.grid))
    caches = jax_caches_np(js)
    assert all(b.shape[-1] == b.shape[0] for lv in (3, 4)
               for b in caches["m2l_E"][lv])
    got = caches_from_jax_numpy(caches, ts.grid, ts._tcfg, "cpu", F64)
    for lv in (3, 4):
        assert rel(got["m2l_E"][lv].numpy(),
                   ts._caches["m2l_E"][lv].numpy()) < 1e-13


def test_coarse_dgemm_level_matches_jax():
    js, ts = pair(32, False)
    coeffs = ts.sigma_t_coeff.numpy()
    want = j_smooth._coarse_dgemm_level_np(js.grid, js._tcfg, 3, 4, coeffs)
    got = t_smooth._coarse_dgemm_level_np(ts.grid, ts._tcfg, 3, 4, coeffs)
    assert rel(got, want) < 1e-13


def test_host_engine_matches_jax_native():
    js, ts = pair(16, False)
    rng = np.random.default_rng(5)
    p0, p1 = rng.uniform(0, 1, (2, 500, 2))
    coeffs = ts.sigma_t_coeff.numpy()
    want = j_native.attenuation_batch(js.grid, coeffs, p0, p1)
    got = t_native.attenuation_batch(ts.grid, coeffs, p0, p1)
    assert rel(got, want) < 1e-13


@pytest.mark.parametrize("level", [2, 3, 4, 5])
def test_m2l_plain_matches_jax_translate(level):
    js, ts = pair(32, False)
    m = 1 << level
    M = np.random.default_rng(level).standard_normal((m, m, 16))
    E_j = js._caches["m2l_E"][level]
    cosr_j = js._mode_statics[0]["m2l_cosr"][level]
    want = j_apply._m2l_translate(E_j, cosr_j,
                                  j_apply._vlist_gather(jnp.asarray(M)))
    got = m2l_translate_plain(
        ts._caches["m2l_E"][level], ts._mode_statics[0]["m2l_cosr"][level],
        torch.as_tensor(M), ts._fmm_static["shift"],
    )
    assert rel(got.numpy(), np.asarray(want)) < 1e-12


@pytest.mark.parametrize("compat", [False, True])
def test_near_plain_matches_jax_near_apply(compat):
    js, ts = pair(16, compat)
    u = field(ts.grid)
    want = j_apply._near_apply(js._caches, js._mode_statics[0], 0,
                               jnp.asarray(u))
    ms = ts._mode_statics[0]
    assert (ms["duffy"] is not None) == compat
    got = near_contract_plain(
        ts._caches["near_E"], ms["near_cosrw"], ms["near_static"],
        torch.as_tensor(u), ts._caches["sigma_w"], ms["duffy"],
    )
    assert rel(got.numpy(), np.asarray(want)) < 1e-12


@pytest.mark.parametrize("caches", ["port", "from_jax"])
@pytest.mark.parametrize("compat", [False, True])
def test_apply_mode_matches_jax(compat, caches):
    js, ts = pair(16, compat)
    u = field(ts.grid, seed=11)
    want = np.asarray(js.apply_mode(0, jnp.asarray(u)))
    if caches == "port":
        got = ts.apply_mode(0, u)
    else:
        got = t_apply.fmm_apply_mode(
            ts._tcfg.leaf_level, ts._fmm_static,
            caches_from_jax_numpy(jax_caches_np(js), ts.grid, ts._tcfg,
                                  "cpu", F64),
            mode_static_from_jax_numpy(jax_mode_static_np(js), "cpu", F64),
            0, torch.as_tensor(u),
        )
    assert rel(got.numpy(), want) < 1e-12


def test_m2l_E_over_budget_raises():
    """A level that does not fit the dense budget is refused (its
    recompute form is a later slice), never silently dropped."""
    _, ts = pair(16, False)
    coeffs = ts.sigma_t_coeff
    coarse = t_smooth.build_m2l_E_coarse_all_np(
        ts.grid, ts._tcfg, 4, coeffs.numpy())
    leaf_bytes = ts._caches["m2l_E"][4].numel() * 8
    with pytest.raises(NotImplementedError):
        t_smooth.build_m2l_E(ts.grid, ts._tcfg, 4, coeffs, coarse,
                             budget_bytes=leaf_bytes)
    full = ts.cache_report()["m2l_E"]
    cache = t_smooth.build_m2l_E(ts.grid, ts._tcfg, 4, coeffs, coarse,
                                 budget_bytes=full)
    assert t_smooth.m2l_cache_bytes(cache) == full


def test_cache_report_counts_the_caches():
    _, ts = pair(16, False)
    rep = ts.cache_report()
    c = ts._caches
    assert rep["m2l_E"] == sum(t.numel() * 8 for t in c["m2l_E"].values())
    assert rep["near_E"] == 9 * 81 * 16 * 16 * 8
    assert rep["total"] == sum(v for k, v in rep.items() if k != "total")
