"""aniso_torch.utils.roofline against aniso_tpu.utils.roofline, the
packaging extra, and chip_smoke.py's bounds.

The same config (16^2, deg 2, np 3: tests/test_aux.py's) is built in both
packages.  Operations are JAX's formulas, so the port's flops equal JAX's
matvec_costs exactly.  Bytes differ only by layout, and each difference is
asserted: JAX pads a 4D array to the TPU's (8, 128) tile (_nbytes_tiled,
patched out here: the port's layouts are unpadded), hard-codes 4 bytes for
the multipole and local planes (the port counts the solver's itemsize),
and counts each per-offset level's E as written and read again (K3 keeps
E in its MMA accumulators: the port's transient is 0).
"""

import importlib.util
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest

import aniso_tpu.fmm.smooth as JS
import aniso_tpu.utils.roofline as JR
from aniso_tpu.solver.operator import TransportSolver as JSolver
from aniso_tpu import SolverConfig as JConfig

import aniso_torch.solver.operator as operator
from aniso_torch.core.config import SolverConfig
from aniso_torch.fmm.smooth import _fine_offset_entries
from aniso_torch.solver.operator import TransportSolver
from aniso_torch.utils import roofline

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(domain_size=16, quad_rule=2, kernel_size=1, g=0.5, sing_rule=4,
           np_cheb=3)


def sigma(grid):
    sig = np.full_like(grid.nodes_x, 5.0)
    return sig, sig + 0.2


def port(dtype="float32", compat=False, offsets=False, monkeypatch=None):
    """The port's solver; offsets: every fine level per-offset (a zero
    dense budget)."""
    if offsets:
        monkeypatch.setattr(operator, "dense_budget_bytes", lambda dev: 0)
    s = TransportSolver(SolverConfig(**CFG, dtype=dtype,
                                     compat_global_basis=compat),
                        backend="fmm", device="cpu")
    s.set_coeff(*sigma(s.grid))
    return s


def jax_solver(dtype="float32", compat=False, offsets=False,
               monkeypatch=None):
    """JAX's solver; offsets: its dense cap at 0 and its unsharded build,
    so that every fine level takes the per-offset form."""
    if offsets:
        monkeypatch.setattr(JS, "_DENSE_E_LEVEL_CAP_BYTES", 0)
        monkeypatch.setattr(JS, "_UNSHARDED_BUILD", True)
    s = JSolver(JConfig(**CFG, dtype=dtype, compat_global_basis=compat),
                backend="fmm")
    s.set_coeff(*sigma(s.grid))
    return s


def jax_costs(s, monkeypatch):
    """JAX's matvec_costs without the TPU's tile padding."""
    monkeypatch.setattr(JR, "_nbytes_tiled", JR._nbytes)
    return JR.matvec_costs(s)


def planes_bytes(s, item):
    """Bytes of every level's multipole and local planes at `item` bytes a
    value."""
    r = s.cfg.np_cheb ** 2
    return sum(2 * 4 * (s._tcfg.boxes(lv) // 2) ** 2 * r * item
               for lv in s._caches["m2l_E"])


@pytest.mark.parametrize("compat", [False, True])
def test_dense_levels_equal_jax(compat, monkeypatch):
    """float32, every level dense: flops equal, bytes equal once JAX's
    tile padding is patched out, no transients in either; compat adds the
    Duffy blocks to both."""
    mine = roofline.matvec_costs(port(compat=compat))
    ref = jax_costs(jax_solver(compat=compat), monkeypatch)
    assert set(mine["level_repr"].values()) == {"dense"}
    assert mine["level_repr"] == ref["level_repr"]
    assert mine["flops"] == ref["flops"]
    assert mine["min_hbm_bytes"] == ref["min_hbm_bytes"]
    assert mine["transient_hbm_bytes"] == ref["transient_hbm_bytes"] == 0


def test_per_offset_levels_equal_jax(monkeypatch):
    """float32, every fine level per-offset: flops equal, bytes equal, and
    the transients differ by exactly JAX's E written and read again per
    canonical block, which K3 never writes."""
    s = port(offsets=True, monkeypatch=monkeypatch)
    mine = roofline.matvec_costs(s)
    ref = jax_costs(jax_solver(offsets=True, monkeypatch=monkeypatch),
                    monkeypatch)
    offsets = [k for k, v in mine["level_repr"].items() if v == "offsets"]
    assert offsets == ["m2l_level_3", "m2l_level_4"]
    assert mine["level_repr"] == ref["level_repr"]
    assert mine["flops"] == ref["flops"]
    assert mine["min_hbm_bytes"] == ref["min_hbm_bytes"]
    assert mine["transient_hbm_bytes"] == 0
    entries = len(_fine_offset_entries(3)[0])
    r = 9
    jax_transient = sum(
        2 * entries * (s._tcfg.boxes(int(k.rsplit("_", 1)[1])) // 2) ** 2
        * r * r * 4 for k in offsets)
    assert ref["transient_hbm_bytes"] == jax_transient


def test_float64_counts_the_solver_itemsize(monkeypatch):
    """float64: the closed form of the bytes (every E level, the planes,
    the near E, sigma_w and three fields at 8 bytes); JAX counts the planes
    at 4 bytes, so it is short by exactly half their bytes; flops equal."""
    s = port(dtype="float64")
    mine = roofline.matvec_costs(s)
    g, r = s.grid, 9
    field = g.sz * g.sz * g.nq * 8
    closed = (sum(4 * (s._tcfg.boxes(lv) // 2) ** 2 * r * 27 * r * 8
                  for lv in s._caches["m2l_E"])
              + planes_bytes(s, 8)
              + 9 * g.nq * g.nq * g.sz * g.sz * 8 + field + 3 * field)
    assert mine["min_hbm_bytes"] == closed
    ref = jax_costs(jax_solver(dtype="float64"), monkeypatch)
    assert mine["flops"] == ref["flops"]
    assert (mine["min_hbm_bytes"] - ref["min_hbm_bytes"]
            == planes_bytes(s, 8) - planes_bytes(s, 4))


@pytest.mark.parametrize("dtype,peak", [("float32", "f32"),
                                        ("float64", "f64_tensor_cores")])
def test_roofline_summary(dtype, peak):
    """The keys, the H100's peaks, bound_ms = max(bytes / 3.35e12, flops /
    67e12) in ms and which bound it is, the shares of a 1 ms matvec."""
    s = port(dtype=dtype)
    c = roofline.matvec_costs(s)
    out = roofline.roofline_summary(s, 1e-3)
    assert out["peaks"] == {"hbm_bytes_per_s": 3.35e12, "flop_per_s": 67e12,
                            "flop_peak": peak}
    t_bytes, t_ops = c["min_hbm_bytes"] / 3.35e12, c["flops"] / 67e12
    assert out["bound_ms"] == pytest.approx(1e3 * max(t_bytes, t_ops),
                                            rel=1e-15)
    assert out["bound_by"] == ("bytes" if t_bytes >= t_ops
                               else "operations")
    assert out["matvec_ms"] == pytest.approx(1.0)
    assert out["achieved_gbps_min"] == pytest.approx(
        c["min_hbm_bytes"] / 1e-3 / 1e9)
    assert out["pct_hbm_peak"] == pytest.approx(
        100 * c["min_hbm_bytes"] / 1e-3 / 3.35e12)
    assert out["achieved_tflops"] == pytest.approx(c["flops"] / 1e-3 / 1e12)
    assert out[f"pct_{peak}_peak"] == pytest.approx(
        100 * c["flops"] / 1e-3 / 67e12)
    assert not any("mxu" in k for k in out)
    for k in ("min_hbm_bytes", "transient_hbm_bytes", "flops", "level_repr",
              "achieved_gbps_incl_transients",
              "pct_hbm_peak_incl_transients"):
        assert k in out


def test_roofline_imports_no_jax():
    code = ("import sys, aniso_torch.utils.roofline\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'aniso_tpu'))]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_chip_smoke_bounds_are_the_module_s():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_roofline_check", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.bound_ms is roofline.bound_ms


def test_pyproject_declares_the_torch_extra():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        project = tomllib.load(f)["project"]
    assert project["dependencies"] == []
    assert project["optional-dependencies"]["torch"] == ["numpy", "torch"]
