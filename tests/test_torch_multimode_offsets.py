"""aniso_torch's multi-mode translates against aniso_tpu's, f64 on the
CPU, split from test_torch_multimode.py (whose helpers they use) so that no
test file holds a test worker much longer than the others.

K3's plain version with the mode axis against JAX's multi-mode per-offset
translate at np 4; K1's and K3's at np 6 (r = 36); K3's operation count.
Tolerance: 1e-12 of the maximum (f64 sums taken in another order).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aniso_tpu.core.config import SolverConfig as JConfig
from aniso_tpu.fmm import smooth as j_smooth
from aniso_tpu.solver.operator import TransportSolver as JSolver

from aniso_torch.convert import _m2l_level_from_jax
from aniso_torch.core.config import SolverConfig
from aniso_torch.core.geometry import project_field
from aniso_torch.fmm import smooth as t_smooth
from aniso_torch.kernels.m2l import m2l_translate_plain
from aniso_torch.kernels.offsets import (
    offsets_translate_plain, translate_flops,
)
from aniso_torch.solver.operator import TransportSolver

from test_torch_multimode import (
    F64, pair, rel, sigma, translate_j, translate_offsets_multi_j,
    vlist_gather_j,
)

from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("level", [3, 4])
def test_offsets_all_modes_plain_matches_jax_multi(level):
    """K3's plain version with the mode axis against JAX's
    _m2l_translate_offsets_multi."""
    js, ts = pair(3)
    m = 1 << level
    M = np.random.default_rng(10 + level).standard_normal((m, m, 16))
    Wo = j_smooth.build_m2l_offsets_fine(js.grid, js._tcfg, level, 4,
                                         jnp.float64)
    want = translate_offsets_multi_j(
        {"Wo": Wo["Wo"], "coeffs": jnp.asarray(js._coeffs_np)},
        [ms["m2l_cosr"][level] for ms in js._mode_statics],
        vlist_gather_j(jnp.asarray(M)),
    )
    got = offsets_translate_plain(
        t_smooth.build_m2l_offsets_fine(ts.grid, ts._tcfg, level, 4, F64,
                                        "cpu")["Wo"],
        ts.sigma_t_coeff, ts._mode_stack["m2l_cosr"][level],
        torch.as_tensor(M), ts._fmm_static["shift"])
    assert got.shape == (5, m, m, 16) and len(want) == 5
    for d in range(5):
        assert rel(got[d].numpy(), np.asarray(want[d])) < 1e-12


@functools.lru_cache(maxsize=None)
def np6_pair():
    """(JAX solver, port solver, coefficients) at 16^2, deg 2, N = 2, np 6,
    built once a worker: the tests read them and change neither."""
    kw = dict(domain_size=16, quad_rule=2, kernel_size=2, g=0.8,
              sing_rule=6, np_cheb=6, dtype="float64")
    js = JSolver(JConfig(**kw), backend="fmm")
    ts = TransportSolver(SolverConfig(**kw), backend="fmm", device="cpu")
    return js, ts, project_field(ts.grid, sigma(ts.grid)[1])


@pytest.mark.parametrize("level", [3, 4])
def test_np6_translates_plain_match_jax(level):
    """np 6 (r = 36), past the compiled all-modes r of earlier kernels:
    K1's plain version with the mode axis against JAX's _m2l_translate per
    mode on JAX's dense E of the level, and K3's plain version against
    JAX's _m2l_translate_offsets_multi on JAX's weight blocks, both carried
    across by convert (16^2, deg 2, N = 2: 3 modes; B = 2 and 1)."""
    js, ts, coeffs = np6_pair()
    m, r = 1 << level, 36
    M = np.random.default_rng(30 + level).standard_normal((m, m, r))
    gsel = vlist_gather_j(jnp.asarray(M))
    shift = ts._fmm_static["shift"]
    cosr = ts._mode_stack["m2l_cosr"][level]
    assert cosr.shape == (3, 4, r, 27 * r)
    E_j = j_smooth.build_m2l_E_fine(js.grid, js._tcfg, level, 6,
                                    jnp.asarray(coeffs), jnp.float64)
    E = torch.tensor(_m2l_level_from_jax(E_j))
    got = m2l_translate_plain(E, cosr, torch.as_tensor(M), shift)
    assert got.shape == (3, m, m, r)
    for d in range(3):
        want = translate_j(
            E_j, js._mode_statics[d]["m2l_cosr"][level], gsel)
        assert rel(got[d].numpy(), np.asarray(want)) < 1e-12
    Wo_j = j_smooth.build_m2l_offsets_fine(js.grid, js._tcfg, level, 6,
                                           jnp.float64)
    got = offsets_translate_plain(
        torch.tensor(_m2l_level_from_jax(Wo_j)["Wo"]),
        torch.as_tensor(coeffs), cosr, torch.as_tensor(M), shift)
    want = translate_offsets_multi_j(
        {"Wo": Wo_j["Wo"], "coeffs": jnp.asarray(coeffs)},
        [ms["m2l_cosr"][level] for ms in js._mode_statics], gsel)
    for d in range(3):
        assert rel(got[d].numpy(), np.asarray(want[d])) < 1e-12


def test_translate_flops_counts_the_modes():
    """The window GEMM and the two source multiplies once, a multiply-add
    per contraction per mode."""
    one, nine = translate_flops(4, 2, 9, 8), translate_flops(4, 2, 9, 8, 9)
    assert nine - one == 8 * 4 * 8 * 8 * 256 * 54
    assert translate_flops(4, 2, 9, 8, 1) == one
