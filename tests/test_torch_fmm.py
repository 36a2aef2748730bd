"""aniso_torch's FMM caches and matvec against aniso_tpu's, f64 on the CPU.

The same sigma field goes through both packages' set_coeff; the caches, the
plain versions of the kernels K1 (M2L translate), K2 (near contraction) and
K3 (per-offset M2L translate), the device coarse build (K6, here on CPU
tensors) and the whole corrected matvec are compared.  Tolerances: 1e-13
relative for the caches and weight tables (the same f64 quadrature sums
taken in another order), 1e-12 for the kernels and the matvec (a few more
f64 sums in another order).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.fmm import apply as j_apply
from aniso_tpu.fmm import smooth as j_smooth
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch import native as t_native
from aniso_torch.convert import (
    _m2l_level_from_jax, caches_from_jax_numpy, mode_static_from_jax_numpy,
)
from aniso_torch.core.config import SolverConfig
from aniso_torch.fmm import apply as t_apply
from aniso_torch.fmm import smooth as t_smooth
from aniso_torch.kernels.m2l import m2l_translate_plain
from aniso_torch.kernels.near import near_contract_plain
from aniso_torch.kernels.offsets import (
    interleave_class_major, offset_plan_np, offsets_translate_plain,
    wo_numel,
)
from aniso_torch.solver.operator import TransportSolver

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F64 = torch.float64

# JAX's matvec internals under jit, as the JAX package's jitted matvec runs
# them: called eagerly, each of their primitives compiles on its own
translate_j = jax.jit(j_apply._m2l_translate)
translate_offsets_j = jax.jit(j_apply._m2l_translate_offsets)
vlist_gather_j = jax.jit(j_apply._vlist_gather)
near_apply_j = jax.jit(j_apply._near_apply, static_argnums=2)


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
    ts = TransportSolver(SolverConfig(**kw), backend="fmm",
                         device="cpu")
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


def _coarse_E6_to_port(E6):
    """JAX's (4, m2, m2, 27, r, r) coarse E -> the port's (4, m2, m2, r, 27r)."""
    m2, r = E6.shape[1], E6.shape[-1]
    return E6.transpose(0, 1, 2, 4, 3, 5).reshape(4, m2, m2, r, 27 * r)


def test_coarse_dgemm_level_matches_jax():
    """The port's device coarse build (K6), on CPU tensors, against JAX's
    host dgemm at the same level."""
    js, ts = pair(32, False)
    coeffs = ts.sigma_t_coeff.numpy()
    want = _coarse_E6_to_port(
        j_smooth._coarse_dgemm_level_np(js.grid, js._tcfg, 3, 4, coeffs))
    got = t_smooth.build_m2l_E_coarse_device(ts.grid, ts._tcfg, 3, 4,
                                             ts.sigma_t_coeff)
    assert got.dtype == F64
    assert rel(got.numpy(), want) < 1e-13


@pytest.mark.parametrize("level", [2, 3])
def test_coarse_device_build_matches_jax_device_build(level):
    """K6 against JAX's own device build (build_m2l_E_coarse_device, run
    by JAX on the CPU) at both coarse levels of 32^2."""
    js, ts = pair(32, False)
    coeffs = ts.sigma_t_coeff.numpy()
    want = np.asarray(j_smooth.build_m2l_E_coarse_device(
        js.grid, js._tcfg, level, 4, coeffs))
    got = t_smooth.build_m2l_E_coarse_device(ts.grid, ts._tcfg, level, 4,
                                             ts.sigma_t_coeff)
    m2 = 1 << (level - 1)
    assert rel(got.numpy(), want.reshape(4, m2, m2, 16, 432)) < 1e-13


def test_host_engine_matches_jax_native():
    """The port's host engine against JAX's pure line integral (the
    reference the JAX package's own native tests use)."""
    from aniso_tpu.ops.attenuation import line_integral_batch

    js, ts = pair(16, False)
    rng = np.random.default_rng(5)
    p0, p1 = rng.uniform(0, 1, (2, 500, 2))
    coeffs = ts.sigma_t_coeff.numpy()
    want = np.asarray(line_integral_batch(
        js.grid, jnp.asarray(coeffs), jnp.asarray(p0), jnp.asarray(p1),
        max_cross=4, n_pieces=4,
    ))
    got = t_native.attenuation_batch(ts.grid, coeffs, p0, p1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("np_cheb", [3, 4])
def test_fine_offset_entries_match_jax(np_cheb):
    assert t_smooth._fine_offset_entries(np_cheb) == \
        j_smooth._fine_offset_entries(np_cheb)


@pytest.mark.parametrize("level", [3, 4])
def test_offsets_Wo_match_jax(level):
    """The per-offset weight blocks at B = 2 (level 3) and B = 1 (level 4)
    of 16^2, in K3's layout, against JAX's (transposed by convert)."""
    js, ts = pair(16, False)
    want = _m2l_level_from_jax(j_smooth.build_m2l_offsets_fine(
        js.grid, js._tcfg, level, 4, jnp.float64))["Wo"]
    got = t_smooth.build_m2l_offsets_fine(ts.grid, ts._tcfg, level, 4, F64,
                                          "cpu")["Wo"]
    B = 16 >> level
    assert got.shape == (wo_numel(4, B, 9),)
    assert rel(got.numpy(), want) < 1e-13


@pytest.mark.parametrize("sz,level", [(16, 3), (16, 4), (32, 4), (32, 5)])
def test_offsets_plain_matches_jax_translate(sz, level):
    """K3's plain version against JAX's _m2l_translate_offsets at every
    fine level of 16^2 and 32^2, where several mirror slices are empty or
    partial (m2 = 4, 8, 8, 16)."""
    js, ts = pair(sz, False)
    m = 1 << level
    M = np.random.default_rng(level).standard_normal((m, m, 16))
    Wo = j_smooth.build_m2l_offsets_fine(js.grid, js._tcfg, level, 4,
                                         jnp.float64)
    want = translate_offsets_j(
        {"Wo": Wo["Wo"], "coeffs": jnp.asarray(js._coeffs_np)},
        js._mode_statics[0]["m2l_cosr"][level],
        vlist_gather_j(jnp.asarray(M)),
    )
    got = offsets_translate_plain(
        t_smooth.build_m2l_offsets_fine(ts.grid, ts._tcfg, level, 4, F64,
                                        "cpu")["Wo"],
        ts.sigma_t_coeff, ts._mode_statics[0]["m2l_cosr"][level],
        torch.as_tensor(M), ts._fmm_static["shift"],
    )
    assert rel(got.numpy(), np.asarray(want)) < 1e-12


def test_offset_plan_covers_every_entry_once():
    """The 54 canonical entries and their mirrors cover all 4 x 27 (class,
    offset) pairs exactly once, and the weight blocks tile Wo."""
    plan = offset_plan_np(4, 2, 9)
    assert plan.shape == (54, 12)
    pairs = [(c, o) for c, o in plan[:, :2]] + [(c, o) for c, o in plan[:, 6:8]]
    assert sorted(pairs) == [(c, o) for c in range(4) for o in range(27)]
    starts = sorted(set(zip(plan[:, 10], plan[:, 11])))
    end = 0
    for woff, K in starts:
        assert woff == end
        end = woff + K * 256
    assert end == wo_numel(4, 2, 9)


@pytest.mark.parametrize("m2,D", [(1, 1), (2, 3), (5, 9)])
def test_interleave_class_major_matches_jax(m2, D):
    """K3's kernel adds into a class-major scratch (D, 4, m2, r, m2); its
    wrapper's interleave gives, per mode, JAX's _interleave_classes of the
    four class planes (x, y, a), bit for bit."""
    Lc = np.random.default_rng(m2).standard_normal((D, 4, m2, 16, m2))
    got = interleave_class_major(torch.as_tensor(Lc)).numpy()
    assert got.shape == (D, 2 * m2, 2 * m2, 16)
    for d in range(D):
        outs = [jnp.asarray(Lc[d, c].transpose(0, 2, 1)) for c in range(4)]
        want = np.asarray(j_apply._interleave_classes(outs, m2, 16))
        assert np.array_equal(got[d], want)


@pytest.mark.parametrize("level", [2, 3, 4, 5])
def test_m2l_plain_matches_jax_translate(level):
    js, ts = pair(32, False)
    m = 1 << level
    M = np.random.default_rng(level).standard_normal((m, m, 16))
    E_j = js._caches["m2l_E"][level]
    cosr_j = js._mode_statics[0]["m2l_cosr"][level]
    want = translate_j(E_j, cosr_j, vlist_gather_j(jnp.asarray(M)))
    got = m2l_translate_plain(
        ts._caches["m2l_E"][level], ts._mode_statics[0]["m2l_cosr"][level],
        torch.as_tensor(M), ts._fmm_static["shift"],
    )
    assert rel(got.numpy(), np.asarray(want)) < 1e-12


@pytest.mark.parametrize("compat", [False, True])
def test_near_plain_matches_jax_near_apply(compat):
    js, ts = pair(16, compat)
    u = field(ts.grid)
    want = near_apply_j(js._caches, js._mode_statics[0], 0, jnp.asarray(u))
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
    """A fine level that does not fit the dense budget takes the per-offset
    form, never an error and never a silent drop; levels are allocated
    coarsest-first, so the leaf is the first to go, and a zero budget
    leaves every fine level per-offset (coarse levels stay dense)."""
    _, ts = pair(16, False)
    coeffs = ts.sigma_t_coeff
    coarse = t_smooth.build_m2l_E_coarse_all(ts.grid, ts._tcfg, 4,
                                             coeffs.numpy(), "cpu")

    def reprs(budget):
        cache = t_smooth.build_m2l_E(ts.grid, ts._tcfg, 4, coeffs,
                                     dict(coarse), budget_bytes=budget)
        return {lv: "offsets" if isinstance(v, dict) else "dense"
                for lv, v in cache.items()}, cache

    full = ts.cache_report()["m2l_E"]
    fine = full - sum(t.numel() * 8 for t in coarse.values())
    dense, cache = reprs(fine)
    assert set(dense.values()) == {"dense"}
    assert t_smooth.m2l_cache_bytes(cache) == full
    leaf_bytes = ts._caches["m2l_E"][4].numel() * 8
    partial, cache = reprs(fine - 1)
    assert partial == {2: "dense", 3: "dense", 4: "offsets"}
    assert t_smooth.per_offset_levels(cache) == [4]
    assert t_smooth.m2l_cache_bytes(cache) == \
        full - leaf_bytes + cache[4]["Wo"].numel() * 8
    assert reprs(0)[0] == {2: "dense", 3: "offsets", 4: "offsets"}


@pytest.mark.parametrize("sz", [16, 32])
def test_offsets_apply_mode_matches_dense(sz):
    """The corrected matvec with every fine level per-offset (K3's plain
    version) equals the dense one (K1's), as the JAX package's
    test_offsets_fine_E_matches_dense holds for its own."""
    _, ts = pair(sz, False)
    coeffs = ts.sigma_t_coeff
    coarse = t_smooth.build_m2l_E_coarse_all(ts.grid, ts._tcfg, 4,
                                             coeffs.numpy(), "cpu")
    virt = dict(ts._caches)
    virt["m2l_E"] = t_smooth.build_m2l_E(ts.grid, ts._tcfg, 4, coeffs,
                                         coarse, budget_bytes=0)
    virt["coeffs"] = coeffs
    assert t_smooth.per_offset_levels(virt["m2l_E"]) == [
        ts._tcfg.leaf_level - 1, ts._tcfg.leaf_level]
    u = torch.as_tensor(field(ts.grid, seed=13))
    want = ts.apply_mode(0, u)
    got = t_apply.fmm_apply_mode(ts._tcfg.leaf_level, ts._fmm_static, virt,
                                 ts._mode_statics[0], 0, u)
    assert rel(got.numpy(), want.numpy()) < 1e-12


def test_convert_reads_per_offset_levels():
    """JAX's per-offset fine levels ({'Wo'}, flat (r*r, K) blocks) carried
    across by caches_from_jax_numpy give the port's own matvec."""
    js, ts = pair(16, False)
    jc = jax_caches_np(js)
    jc["m2l_E"] = {
        lv: ({"Wo": tuple(np.asarray(w) for w in E["Wo"])}
             if isinstance(E, dict) else
             tuple(np.asarray(b) for b in E) if isinstance(E, tuple)
             else np.asarray(E))
        for lv, E in j_smooth.build_m2l_E(
            js.grid, js._tcfg, 4, jnp.asarray(js._coeffs_np),
            dtype=jnp.float64, coeffs_np=js._coeffs_np, budget_bytes=0,
            fine_fallback="offsets").items()
    }
    jc["coeffs"] = js._coeffs_np
    caches = caches_from_jax_numpy(jc, ts.grid, ts._tcfg, "cpu", F64)
    assert t_smooth.per_offset_levels(caches["m2l_E"]) == [3, 4]
    u = torch.as_tensor(field(ts.grid, seed=17))
    got = t_apply.fmm_apply_mode(ts._tcfg.leaf_level, ts._fmm_static, caches,
                                 ts._mode_statics[0], 0, u)
    assert rel(got.numpy(), ts.apply_mode(0, u).numpy()) < 1e-12


def test_cache_report_counts_the_caches():
    _, ts = pair(16, False)
    rep = ts.cache_report()
    c = ts._caches
    assert rep["m2l_E"] == sum(t.numel() * 8 for t in c["m2l_E"].values())
    assert rep["near_E"] == 9 * 81 * 16 * 16 * 8
    assert rep["total"] == sum(v for k, v in rep.items() if k != "total")
