"""The port's copied numpy tables are bitwise equal to aniso_tpu's.

aniso_torch keeps its own copy of every table function it needs (it never
imports aniso_tpu, whose package imports JAX); each case here builds one
table with both packages and requires np.array_equal.
"""

import os

import numpy as np
import pytest

import aniso_tpu.core.config as j_config
import aniso_tpu.core.geometry as j_geometry
import aniso_tpu.core.quadrature as j_quadrature
import aniso_tpu.fmm.apply as j_apply
import aniso_tpu.fmm.cheb as j_cheb
import aniso_tpu.fmm.smooth as j_smooth
import aniso_tpu.fmm.structure as j_structure
import aniso_tpu.ops.compat as j_compat
import aniso_tpu.ops.duffy as j_duffy
import aniso_tpu.ops.fields as j_fields
import aniso_tpu.ops.near as j_near

import aniso_torch.core.config as t_config
import aniso_torch.core.geometry as t_geometry
import aniso_torch.core.quadrature as t_quadrature
import aniso_torch.fmm.apply as t_apply
import aniso_torch.fmm.cheb as t_cheb
import aniso_torch.fmm.smooth as t_smooth
import aniso_torch.fmm.structure as t_structure
import aniso_torch.ops.compat as t_compat
import aniso_torch.ops.duffy as t_duffy
import aniso_torch.ops.fields as t_fields
import aniso_torch.ops.near as t_near

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ORACLE64 = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                        "oracle_64", "data.cfg")

GRID_FIELDS = ("qx", "qy", "w2d", "sqrt_w2d", "nodes_x", "nodes_y",
               "weights", "norms", "proj", "interpolate", "refine_x",
               "refine_y", "refine_w", "near_mapping")


def _coeffs(sz, deg):
    return np.random.default_rng(7).standard_normal((sz, sz, deg * deg))


def _nodes():
    g = j_geometry.make_grid(4, 3)
    return g.qx, g.qy


def _cheb(pkg):
    return [pkg.p2m_matrix(*_nodes(), 4), pkg.m2m_tensor(4),
            pkg.cheb_grid_2d(4)]


def _gauss(pkg, n):
    rule = pkg.gauss_legendre(n)
    return [rule.points, rule.weights]


def _grid(pkg, deg):
    g = pkg.make_grid(5, deg)
    return [np.asarray(g.dx)] + [getattr(g, f) for f in GRID_FIELDS]


def _vlists(pkg):
    return [np.array(pkg.vlist_offsets(px, py))
            for px in (0, 1) for py in (0, 1)] + [
        np.array(pkg.all_vlist_offsets())]


def _coarse_offsets(smooth, B):
    out = []
    for (c, o, canonical, *_r) in smooth.coarse_mirror_table(4):
        if canonical:
            di, dj = j_structure.vlist_offsets(c >> 1, c & 1)[o]
            W, ox0, oy0 = smooth._coarse_offset_weight_cached(3, 4, B, di, dj)
            out += [W, np.array([ox0, oy0])]
    return out


def _stencil(pkg, compat):
    grid = (j_geometry if pkg is j_near else t_geometry).make_grid(6, 3)
    s, d = pkg.build_near_stencil(grid, 0, 8, compat, include_removal=False)
    return [s] + ([] if d is None else [d])


def _project(geometry, compat=None):
    g = geometry.make_grid(8, 3)
    c = geometry.project_field(g, _coeffs(8, 3))
    if compat is not None:
        c = compat.to_local_equivalent(g, c)
    return [c]


def _fields(geometry, fields):
    g = geometry.make_grid(8, 3)
    return [fields.evaluate_at_nodes_np(g, _coeffs(8, 3))]


def _cfg(config):
    return [np.array(sorted(config.load_cfg(ORACLE64).to_dict().items()),
                     dtype=object)]


CASES = {}
for n in range(1, 9):
    CASES[f"gauss_legendre_{n}"] = (
        lambda p, n=n: _gauss(p[0], n), (j_quadrature, t_quadrature))
for deg in range(1, 5):
    CASES[f"grid_deg{deg}"] = (
        lambda p, d=deg: _grid(p[0], d), (j_geometry, t_geometry))
CASES.update({
    "vlist_offsets": (lambda p: _vlists(p[0]), (j_structure, t_structure)),
    "parity_shift_table": (lambda p: [p[0].parity_shift_table_np()],
                           (j_apply, t_apply)),
    "m2l_pair_geometry_np3": (lambda p: list(p[0].m2l_pair_geometry_np(3)),
                              (j_apply, t_apply)),
    "m2l_pair_geometry_np4": (lambda p: list(p[0].m2l_pair_geometry_np(4)),
                              (j_apply, t_apply)),
    "cheb_p2m_m2m": (lambda p: _cheb(p[0]), (j_cheb, t_cheb)),
    "near_weights_deg2": (lambda p: [p[0].near_weights_np(2)],
                          (j_smooth, t_smooth)),
    "near_weights_deg3": (lambda p: [p[0].near_weights_np(3)],
                          (j_smooth, t_smooth)),
    "fine_m2l_weights_B1": (lambda p: [p[0].fine_m2l_weights_np(3, 4, 1)],
                            (j_smooth, t_smooth)),
    "fine_m2l_weights_B2": (lambda p: [p[0].fine_m2l_weights_np(3, 4, 2)],
                            (j_smooth, t_smooth)),
    "fine_W_flat_B1": (lambda p: [p[0]._fine_W_flat_np(
        3, 4, 1, *(("float64",) if p[0] is j_smooth else ()))],
        (j_smooth, t_smooth)),
    "near_pair_geometry": (
        lambda p: list(p[0].near_pair_geometry(j_geometry.make_grid(8, 3))),
        (j_smooth, t_smooth)),
    "coarse_mirror_table": (lambda p: [np.array(p[0].coarse_mirror_table(4))],
                            (j_smooth, t_smooth)),
    "coarse_offset_weights_B4": (lambda p: _coarse_offsets(p[0], 4),
                                 (j_smooth, t_smooth)),
    "duffy_tables": (lambda p: list(p[0].duffy_tables(3, 8, *_nodes())),
                     (j_duffy, t_duffy)),
    "near_stencil_m0": (lambda p: _stencil(p[0], False), (j_near, t_near)),
    "near_stencil_m0_compat": (lambda p: _stencil(p[0], True),
                               (j_near, t_near)),
    "project_field": (lambda p: _project(p[0]), (j_geometry, t_geometry)),
    "to_local_equivalent": (lambda p: _project(*p),
                            ((j_geometry, j_compat), (t_geometry, t_compat))),
    "evaluate_at_nodes_np": (lambda p: _fields(*p),
                             ((j_geometry, j_fields), (t_geometry, t_fields))),
    "load_cfg_oracle64": (lambda p: _cfg(p[0]), (j_config, t_config)),
})


def _pkgs(spec, which):
    mod = spec[which]
    return mod if isinstance(mod, tuple) else (mod,)


@pytest.mark.parametrize("name", sorted(CASES))
def test_copied_table_bitwise_equal(name):
    build, spec = CASES[name]
    ref = build(_pkgs(spec, 0))
    got = build(_pkgs(spec, 1))
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b), name
