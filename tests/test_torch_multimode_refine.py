"""aniso_torch's multi-mode f64 twin and refined solve against aniso_tpu's,
on the CPU: the refined N = 2 problem at 16^2.

The twin's coupled operators (per-offset fine levels, C in f64) to 1e-12 of
the maximum, with the port's own twin caches and with JAX's carried across
by aniso_torch.convert; the refined x within 1e-9 of JAX's (both inner
solves run in f32 and stop at different points below the f64 residual both
reach).  A file of its own so that the test workers can run it beside
test_torch_multimode.py.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.convert import (
    caches_from_jax_numpy, mode_stack_from_jax_numpy,
)
from aniso_torch.core.config import SolverConfig
from aniso_torch.solver.operator import TransportSolver
from aniso_torch.solver.refine import RefinedResult

from test_torch_multimode import (
    F64, fields, jax_caches_np, jax_mode_statics_np, rel, sigma,
)

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@functools.lru_cache(maxsize=None)
def refine_pair():
    """(JAX solver, port solver, charge) of the refined N = 2 problem."""
    kw = dict(domain_size=16, quad_rule=3, kernel_size=2, g=0.6,
              sing_rule=8, np_cheb=4, dtype="float32", refine=True,
              tol=1e-11, restart=60, max_iter=300)
    js = JSolver(JConfig(**kw), backend="fmm")
    ts = TransportSolver(SolverConfig(**kw), backend="fmm",
                         device="cpu")
    js.set_coeff(*sigma(js.grid))
    ts.set_coeff(*sigma(ts.grid))
    g = ts.grid
    q = np.zeros((2,) + g.nodes_x.shape)
    q[0] = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    q[1] = 0.3 * np.sin(2 * np.pi * g.nodes_x) * g.nodes_y
    return js, ts, q


@pytest.mark.parametrize("caches", ["port", "from_jax"])
@pytest.mark.parametrize("op", ["_forward64", "_rhs64"])
def test_twin_coupled_operator_matches_jax(op, caches):
    """The f64 twin's coupled operators (per-offset fine levels, C in f64)
    with the port's own twin caches and with JAX's carried across."""
    js, ts, _ = refine_pair()
    u = fields(ts.grid, 2, 71)
    # placed as JAX's refined_solve places its vectors (committed to the
    # twin's device), so that the solve below reuses these compiles
    want = np.asarray(getattr(js, op)(jax.device_put(u, js._twin_device)))
    keep = ts._caches64, ts._mode_stack64
    if caches == "from_jax":
        ts._caches64 = caches_from_jax_numpy(
            jax_caches_np(js._caches64), ts.grid, ts._tcfg, "cpu", F64)
        ts._mode_stack64 = mode_stack_from_jax_numpy(
            jax_mode_statics_np(js._mode_statics64), "cpu", F64)
    try:
        got = getattr(ts, op)(u)
    finally:
        ts._caches64, ts._mode_stack64 = keep
    assert got.dtype == F64 and got.shape == (2, 16, 16, 9)
    assert ts._C_fwd64.dtype == F64 and ts._C_fwd.dtype == torch.float32
    assert rel(got.numpy(), want) < 1e-12


def test_refined_n2_solve_matches_jax():
    """The refined two-mode solve: a true f64 residual below 1e-11,
    recomputed here, and x within 1e-9 of JAX's refined x."""
    js, ts, q = refine_pair()
    ref = js.solve(jnp.asarray(q))
    n0 = ts.n_matvecs64
    res = ts.solve(q)
    assert isinstance(res, RefinedResult)
    assert res.converged and res.refinements >= 2
    assert res.x.dtype == F64 and res.x.shape == (2, 16, 16, 9)
    assert ts.n_matvecs64 - n0 == 2 * (1 + res.refinements)
    b = ts._rhs64(q)
    true = float(torch.linalg.vector_norm(b - ts._forward64(res.x))
                 / torch.linalg.vector_norm(b))
    assert true < 1e-11
    assert rel(res.x.numpy(), np.asarray(ref.x)) < 1e-9
