"""aniso_torch's f64 twin and refined solve against aniso_tpu's, on the CPU.

The f64 twin (solver/operator.py: f64 coarse levels, every fine level
per-offset, f64 near E) is compared with JAX's twin matvec by matvec, and
the refined solve (solver/refine.py) end to end on the JAX package's own
refinement problem (tests/test_refine.py:18-48, one mode).  Tolerances:
1e-12 relative for the twin's matvecs (f64 sums taken in another order);
the refined x within 1e-9 of JAX's, since both inner solves run in f32 and
stop at different points below the 1e-11 f64 residual both reach.
"""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.convert import caches_from_jax_numpy
from aniso_torch.core.config import SolverConfig
from aniso_torch.fmm import apply as t_apply
from aniso_torch.fmm.smooth import build_m2l_E, per_offset_levels
from aniso_torch.solver.operator import TransportSolver
from aniso_torch.solver.refine import RefinedResult, refined_solve

F64 = torch.float64


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / np.abs(b).max()


def problem(grid):
    sig = 8 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    q = np.exp(-25 * ((grid.nodes_x - 0.5) ** 2 + (grid.nodes_y - 0.5) ** 2))
    return sig, q


@functools.lru_cache(maxsize=None)
def refine_pair():
    """(JAX solver, port solver, JAX result, port result): the 16^2 refined
    problem of tests/test_refine.py with N = 1, solved by both."""
    kw = dict(domain_size=16, quad_rule=3, kernel_size=1, g=0.5,
              sing_rule=8, np_cheb=4, dtype="float32", refine=True,
              tol=1e-11, restart=60, max_iter=300)
    js = JSolver(JConfig(**kw), backend="fmm")
    ts = TransportSolver(SolverConfig(**kw), device="cpu")
    sig, q = problem(ts.grid)
    js.set_coeff(sig, sig + 0.2)
    ts.set_coeff(sig, sig + 0.2)
    return js, ts, js.solve(q[None]), ts.solve(q)


def test_twin_layout():
    """The twin's fine levels are per-offset (with the coefficient field
    beside them), its coarse levels and near E dense f64; the fast path's
    coarse levels are the twin's, cast to f32."""
    _, ts, _, _ = refine_pair()
    c64, c32 = ts._caches64, ts._caches
    assert per_offset_levels(c64["m2l_E"]) == [3, 4]
    assert c64["coeffs"].dtype == F64 and c64["near_E"].dtype == F64
    assert c64["m2l_E"][2].dtype == F64
    assert per_offset_levels(c32["m2l_E"]) == [] and "coeffs" not in c32
    assert torch.equal(c32["m2l_E"][2], c64["m2l_E"][2].float())
    rep = ts.cache_report()
    assert rep["f64_twin"] == (
        sum(v["Wo"].numel() * 8 if isinstance(v, dict) else v.numel() * 8
            for v in c64["m2l_E"].values())
        + sum(c64[k].numel() * 8 for k in ("near_E", "sigma_w", "coeffs"))
    )
    assert rep["total"] == sum(v for k, v in rep.items() if k != "total")


@pytest.mark.parametrize("caches", ["port", "from_jax"])
def test_forward64_matches_jax(caches):
    """The twin's forward operator on a random vector, with the port's own
    twin caches and with JAX's twin carried across by convert."""
    js, ts, _, _ = refine_pair()
    u = np.random.default_rng(4).standard_normal((1,) + ts.grid.nodes_x.shape)
    want = np.asarray(js._forward64(jnp.asarray(u)))
    if caches == "from_jax":
        jc = {k: (v if k == "m2l_E" else np.asarray(v))
              for k, v in js._caches64.items()}
        jc["m2l_E"] = {
            lv: ({"Wo": tuple(np.asarray(w) for w in E["Wo"])}
                 if isinstance(E, dict) else np.asarray(E))
            for lv, E in js._caches64["m2l_E"].items()
        }
        ts._caches64, own = caches_from_jax_numpy(
            jc, ts.grid, ts._tcfg, "cpu", F64), ts._caches64
        try:
            got = ts._forward64(u)
        finally:
            ts._caches64 = own
    else:
        got = ts._forward64(u)
    assert got.dtype == F64
    assert rel(got.numpy(), want) < 1e-12


def test_rhs64_matches_jax():
    js, ts, _, _ = refine_pair()
    _, q = problem(ts.grid)
    want = np.asarray(js._rhs64(jnp.asarray(q[None])))
    got = ts._rhs64(q)
    assert got.shape == (1, 16, 16, 9)
    assert rel(got.numpy(), want) < 1e-12


def test_refined_solve_16_matches_jax():
    """A true f64 residual below 1e-11, recomputed independently, after at
    least two rounds; x within 1e-9 of JAX's refined x."""
    _, ts, ref, res = refine_pair()
    assert isinstance(res, RefinedResult)
    assert res.converged and res.refinements >= 2
    assert res.x.dtype == F64 and res.x.shape == (1, 16, 16, 9)
    _, q = problem(ts.grid)
    b = ts._rhs64(q)
    true = float(torch.linalg.vector_norm(b - ts._forward64(res.x))
                 / torch.linalg.vector_norm(b))
    assert true < 1e-11
    assert res.history[1] < 1e-4 * res.history[0]
    assert rel(res.x.numpy(), np.asarray(ref.x)) < 1e-9


def test_refined_solve_phases_match_jax():
    """The same phase keys as JAX's, one inner solve per round, and one
    f64 residual per round beyond the skipped first matvec."""
    _, _, ref, res = refine_pair()
    assert set(res.phases) == set(ref.phases)
    assert len(res.phases["inner_iters"]) == res.refinements
    assert len(res.phases["forward64_s"]) == res.refinements + 1
    assert res.iterations == sum(res.phases["inner_iters"])
    assert len(res.history) == res.refinements + 1


def test_refined_solve_counts_twin_sweeps():
    """rhs64 plus one f64 residual per round after the first: the twin
    sweeps chip_smoke.py counts K3-f64 launches against."""
    _, ts, _, _ = refine_pair()
    _, q = problem(ts.grid)
    n0, f0 = ts.n_matvecs64, ts.n_matvecs
    res = ts.solve(q)
    assert ts.n_matvecs64 - n0 == 1 + res.refinements
    assert ts.n_matvecs - f0 >= res.iterations


def test_refined_solve_zero_charge():
    _, ts, _, _ = refine_pair()
    res = refined_solve(ts, np.zeros(ts.grid.nodes_x.shape))
    assert res.converged and res.refinements == 0
    assert float(res.x.abs().max()) == 0.0


def test_float64_solve_with_per_offset_levels_matches_jax():
    """A float64 TransportSolver whose fine levels are per-offset (K3's
    plain version in every matvec) against JAX's dense f64 solve."""
    kw = dict(domain_size=16, quad_rule=3, kernel_size=1, g=0.5,
              sing_rule=8, np_cheb=4, dtype="float64", tol=1e-10,
              restart=80, max_iter=400)
    js = JSolver(JConfig(**kw), backend="fmm")
    ts = TransportSolver(SolverConfig(**kw), device="cpu")
    sig, q = problem(ts.grid)
    js.set_coeff(sig, sig + 0.2)
    ts.set_coeff(sig, sig + 0.2)
    cf = ts.sigma_t_coeff
    ts._caches["m2l_E"] = build_m2l_E(
        ts.grid, ts._tcfg, 4, cf, {2: ts._caches["m2l_E"][2]},
        budget_bytes=0)
    ts._caches["coeffs"] = cf
    assert per_offset_levels(ts._caches["m2l_E"]) == [3, 4]
    ref = js.solve(q)
    got = ts.solve(q)
    assert got.converged and got.iterations == int(ref.iterations)
    assert rel(got.x.numpy(), np.asarray(ref.x)) < 1e-10


def test_twin_apply_needs_refine():
    ts = TransportSolver(SolverConfig(domain_size=8, quad_rule=2, np_cheb=3),
                         device="cpu")
    g = ts.grid
    ts.set_coeff(np.ones(g.nodes_x.shape), 2 * np.ones(g.nodes_x.shape))
    assert ts._caches64 is None and "f64_twin" not in ts.cache_report()
    with pytest.raises(RuntimeError):
        ts._forward64(np.ones(g.nodes_x.shape))
    # the f64 matvec of a float64 solver is the plain f64 operator
    u = torch.as_tensor(np.random.default_rng(0).random(g.nodes_x.shape))
    K = ts.apply_mode(0, u)
    assert K.dtype == F64
    assert rel(K.numpy(), t_apply.fmm_apply_mode(
        ts._tcfg.leaf_level, ts._fmm_static, ts._caches,
        ts._mode_statics[0], 0, u).numpy()) == 0.0
