"""aniso_torch's device policy and kernel wrappers.

The port imports neither JAX nor aniso_tpu; its entry points default to the
GPU and raise without one; a kernel wrapper takes the plain version only
for CPU tensors and otherwise launches its CUDA kernel or raises.  The
tests marked `cuda` hold the kernels against their plain versions on the
card and skip without one (run them there with
`python -m pytest tests/test_torch_device.py -m cuda --noconftest`).
"""

import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from aniso_torch import _build
from aniso_torch.core.config import SolverConfig
from aniso_torch.fmm.apply import parity_shift_table_np
from aniso_torch.core.geometry import make_grid, project_field
from aniso_torch.fmm.smooth import build_m2l_offsets_fine
from aniso_torch.fmm.structure import tree_config
from aniso_torch.kernels import (
    _cuda, attenuation, diffusion, halo, m2l, near, offsets, pcg, transfer,
)
from aniso_torch.ops.attenuation import make_line_integral
from aniso_torch.ops.dense import build_dense_smooth
from aniso_torch.solver.dsa import _face_coeffs
from aniso_torch.solver.operator import TransportSolver, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_port_imports_neither_jax_nor_aniso_tpu():
    code = (
        "import sys\n"
        "import aniso_torch, aniso_torch.convert, aniso_torch.native\n"
        "import aniso_torch.solver.operator, aniso_torch.kernels.m2l\n"
        "import aniso_torch.kernels.near, aniso_torch.kernels.offsets\n"
        "import aniso_torch.solver.refine, aniso_torch.solver.dsa\n"
        "import aniso_torch.kernels.diffusion, chip_smoke\n"
        "import aniso_torch.cli, aniso_torch.ops.dense, aniso_torch.utils\n"
        "import aniso_torch.kernels.attenuation, aniso_torch.kernels.pcg\n"
        "import aniso_torch.kernels.halo, aniso_torch.parallel.api\n"
        "import aniso_torch.parallel.halo, aniso_torch.parallel.distributed\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m.startswith('aniso_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        TransportSolver(SolverConfig(domain_size=8, quad_rule=2), "fmm")


def test_cpu_runs_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    s = TransportSolver(SolverConfig(domain_size=8, quad_rule=2, np_cheb=3),
                        backend="fmm", device="cpu")
    assert (s.device.type == "cpu"
            and s._fmm_static["m2m_1d"].device.type == "cpu")


def _k1_inputs(device, dtype=torch.float32, m2=2, r=16):
    rng = np.random.default_rng(1)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt).to(device)

    return (t(rng.uniform(0, 2, (4, m2, m2, r, 27 * r))),
            t(rng.standard_normal((4, r, 27 * r))),
            t(rng.standard_normal((2 * m2, 2 * m2, r))),
            t(parity_shift_table_np(), torch.int32))


def _k2_inputs(device, dtype=torch.float32, sz=4, nq=9):
    rng = np.random.default_rng(2)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype).to(device)

    return (t((sz, sz, nq, 3, 3, nq)).abs(), t((nq, 3, 3, nq)),
            t((nq, 3, 3, nq)), t((sz, sz, nq)), t((sz, sz, nq)),
            t((sz, sz, nq, nq)))


def _k3_inputs(device, dtype=torch.float32, sz=16, level=4, np_cheb=4):
    """K3 at a fine level of sz^2: the real weight blocks and a smooth
    coefficient field, random cosr and multipoles."""
    rng = np.random.default_rng(3)
    g = make_grid(sz, 3)
    m = 1 << level
    sig = 8 * (1 - np.cos(2 * np.pi * g.nodes_x)) + 0.2

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt).to(device)

    r = np_cheb * np_cheb
    Wo = build_m2l_offsets_fine(g, tree_config(sz), level, np_cheb, dtype,
                                "cpu")
    return (Wo["Wo"].to(device), t(project_field(g, sig)),
            t(rng.standard_normal((4, r, 27 * r))),
            t(rng.standard_normal((m, m, r))),
            t(parity_shift_table_np(), torch.int32))


def _k1s_inputs(device, dtype=torch.float32, m2x=2, m2y=3, r=16):
    """K1-S: a shard's (4, m2x, m2y, r, 27r) slice of E and its multipoles
    extended by two boxes."""
    rng = np.random.default_rng(4)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt).to(device)

    return (t(rng.uniform(0, 2, (4, m2x, m2y, r, 27 * r))),
            t(rng.standard_normal((4, r, 27 * r))),
            t(rng.standard_normal((2 * m2x + 4, 2 * m2y + 4, r))),
            t(parity_shift_table_np(), torch.int32))


def _k2s_inputs(device, dtype=torch.float32, lx=4, ly=3, nq=9):
    """K2-S: a shard's slices and its halo-extended u."""
    rng = np.random.default_rng(5)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype).to(device)

    return (t((lx, ly, nq, 3, 3, nq)).abs(), t((nq, 3, 3, nq)),
            t((nq, 3, 3, nq)), t((lx + 2, ly + 2, nq)), t((lx, ly, nq)),
            t((lx, ly, nq, nq)))


def _k7_inputs(device, dtype=torch.float64, sz=4, deg=2):
    """K7's whole-matrix entry: sigma_t's coefficients, the nodes, their
    weights and the m = 0 diagonal."""
    g = make_grid(sz, deg)
    rng = np.random.default_rng(6)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    return (t(rng.standard_normal((sz, sz, deg * deg)) + 3.0),
            t(g.flat_nodes()).contiguous(), t(g.weights.reshape(-1)),
            t(rng.random(g.n_nodes)))


def _k7_dense(coeffs, pts, w, diag):
    return attenuation.dense_smooth(make_grid(4, 2), coeffs, pts, w, diag,
                                    [0, 1, 2])


_INPUTS = {"m2l": (m2l.m2l_translate, _k1_inputs),
           "near": (near.near_contract, _k2_inputs),
           "offsets": (offsets.offsets_translate, _k3_inputs),
           "m2l_shard": (m2l.m2l_translate_shard, _k1s_inputs),
           "near_shard": (near.near_contract_shard, _k2s_inputs),
           "dense_smooth": (_k7_dense, _k7_inputs)}


@pytest.mark.parametrize("kernel", ["m2l", "near", "offsets", "m2l_shard",
                                    "near_shard", "dense_smooth"])
def test_wrappers_raise_on_tensors_off_the_cpu_without_a_kernel(kernel):
    """A tensor that is neither on the CPU nor a launchable CUDA tensor
    (here on the meta device) is refused, never computed by the plain
    version."""
    fn, inputs = _INPUTS[kernel]
    with pytest.raises(ValueError):
        fn(*inputs("meta"))


@pytest.mark.parametrize("kernel", ["m2l", "near", "offsets", "m2l_shard",
                                    "near_shard", "dense_smooth"])
def test_wrappers_refuse_other_dtypes(kernel):
    """Only the float32 and float64 instances exist: a float16 tensor off
    the CPU is refused before any launch."""
    fn, inputs = _INPUTS[kernel]
    args = [a.half() if a.is_floating_point() else a
            for a in inputs("meta")]
    with pytest.raises(TypeError):
        fn(*args)


@pytest.mark.parametrize("kernel", [m2l, near, offsets, diffusion,
                                    attenuation, pcg, halo, transfer])
def test_kernel_load_raises_without_cuda(no_cuda, kernel):
    symbols = getattr(kernel, "SYMBOLS", getattr(kernel, "UP_SYMBOLS", None))
    with pytest.raises(RuntimeError):
        _cuda.load(kernel.SOURCE, next(iter(symbols.values())), ())


def test_k7_wrappers_refuse_tensors_off_the_cpu_without_a_kernel():
    """K7 takes float64 CUDA tensors only: a meta tensor is refused, as is
    float32, before any launch."""
    g = make_grid(4, 2)
    f64 = dict(dtype=torch.float64, device="meta")
    c, p = torch.zeros((4, 4, 4), **f64), torch.zeros((5, 2), **f64)
    with pytest.raises(ValueError):
        attenuation.line_integral_pairs(g, c, p, p)
    with pytest.raises(TypeError):
        attenuation.line_integral_pairs(g, c.float(), p.float(), p.float())
    pts, w = torch.zeros((64, 2), **f64), torch.zeros(64, **f64)
    with pytest.raises(ValueError):
        attenuation.dense_smooth(g, c, pts, w, w, [0, 1])
    with pytest.raises(ValueError):
        attenuation.dense_smooth(g, c, pts, w, w, [0, 2])
    with pytest.raises(ValueError):
        attenuation.dense_smooth(g, c, pts[:63], w, w, [0, 1])
    with pytest.raises(TypeError):
        attenuation.dense_smooth(g, c, pts, w, w, [0, 1],
                                 dtype=torch.float16)


def test_build_dense_smooth_default_device_raises_without_cuda(no_cuda):
    """build_dense_smooth without a device means the card, as every entry
    point: without one it raises, and the CPU runs only when named."""
    g = make_grid(2, 2)
    coeffs = np.full((2, 2, 4), 0.5)
    with pytest.raises(RuntimeError):
        build_dense_smooth(g, 0, coeffs)
    assert build_dense_smooth(g, 0, coeffs, device="cpu").shape == (16, 16)


def _kernel_ab():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "kernel_ab", os.path.join(ROOT, "tools", "kernel_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_variant_trees(table, tmp_path):
    """tools/kernel_ab.py's A/B copies of one table: every patch finds its
    text in the committed file exactly once and changes the copy, and
    nothing else differs."""
    ab = _kernel_ab()
    groups, variants = ab.VARIANTS[table]
    assert all(any(g.startswith(p) for g in ab.GROUPS) for p in groups)
    for name, patches in variants.items():
        d = ab.patched_tree(ROOT, str(tmp_path), name, patches)
        for rel in {rel for rel, _, _ in patches}:
            with open(os.path.join(ROOT, rel)) as f, \
                    open(os.path.join(d, rel)) as g:
                assert f.read() != g.read(), (name, rel)
        with open(os.path.join(ROOT, "chip_smoke.py")) as f, \
                open(os.path.join(d, "chip_smoke.py")) as g:
            assert f.read() == g.read()


def test_k2_variants_patch_the_committed_source(tmp_path):
    """The K2 table of tools/kernel_ab.py patches csrc/near_contract.cu."""
    _check_variant_trees("k2", tmp_path)


def test_k10_variants_patch_the_committed_source(tmp_path):
    """The K10 table of tools/kernel_ab.py patches csrc/halo_fill.cu."""
    _check_variant_trees("k10", tmp_path)


def test_k1_variants_patch_the_committed_source(tmp_path):
    """The K1 table of tools/kernel_ab.py patches csrc/m2l_translate.cu
    and kernels/m2l.py's plan constants."""
    _check_variant_trees("k1", tmp_path)


def test_cuda_build_raises_without_nvcc(monkeypatch, tmp_path):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is on PATH")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError):
        _build.build([m2l.SOURCE])


# gates: 1e-5 max|plain| in float32 (sums of 432 to 729 terms in another
# order), 1e-12 in float64
_GATE = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m2,np_cheb", [(8, 4), (2, 4), (3, 3), (5, 5),
                                        (7, 2), (16, 7), (32, 4), (9, 8),
                                        (4, 3), (2, 5), (4, 6), (2, 6)])
def test_m2l_kernel_matches_plain_on_card(cuda_device, dtype, m2, np_cheb):
    """The one-mode kernel (one launch) at m2 2-32, box counts that fill
    no whole run of boxes a block (3^2, 5^2, 7^2, 9^2), rows that start
    off 16 bytes (np 3, 5, 7), np 6 at the np6 phase's levels 2-3 and
    np 8."""
    args = _k1_inputs(cuda_device, dtype, m2=m2, r=np_cheb * np_cheb)
    inst = _cuda.INSTANCES[dtype]
    n0 = m2l.launches[inst]
    got = m2l.m2l_translate(*args)
    want = m2l.m2l_translate_plain(*args)
    assert m2l.launches[inst] == n0 + 1
    assert float((got - want).abs().max()) <= \
        _GATE[dtype] * float(want.abs().max())
    with pytest.raises(TypeError):
        m2l.m2l_translate(*[a.half() if a.is_floating_point() else a
                            for a in args])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,r", [(torch.float32, 21 * 21),
                                     (torch.float32, 448),
                                     (torch.float64, 15 * 15),
                                     (torch.float64, 11 * 11)])
def test_m2l_kernel_at_the_row_limit_matches_plain_on_card(cuda_device,
                                                           dtype, r):
    """Long rows (np 21 in float32, 15 in float64, and r = 448, whose rows
    fill 16-byte vectors) run one row a group, cut into chunks over the
    stages; np 11 in float64 one whole row a stage.  A row over the opt-in
    limit (m2l.MAX_ROW_BYTES: np 33 in float64, 47 in float32) is
    refused."""
    args = _k1_inputs(cuda_device, dtype, m2=2, r=r)
    _gate(m2l.m2l_translate(*args), m2l.m2l_translate_plain(*args), dtype)
    del args
    item = 4 if dtype == torch.float32 else 8
    over = (m2l.max_np(item) + 1) ** 2
    z = dict(dtype=dtype, device=cuda_device)
    with pytest.raises(ValueError):
        m2l.m2l_translate(torch.zeros((4, 1, 1, over, 27 * over), **z),
                          torch.zeros((4, over, 27 * over), **z),
                          torch.zeros((2, 2, over), **z),
                          torch.as_tensor(parity_shift_table_np(),
                                          dtype=torch.int32,
                                          device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_m2l_kernels_refuse_misaligned_inputs_on_card(cuda_device, dtype):
    """The kernels copy E, cosr and M from 16-byte boundaries: a view
    that starts one value past one is refused, for K1 and K1-S."""
    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        return v

    args = list(_k1_inputs(cuda_device, dtype, m2=4))
    sargs = list(_k1s_inputs(cuda_device, dtype))
    for k in range(3):
        bad = list(args)
        bad[k] = shifted(bad[k])
        with pytest.raises(ValueError):
            m2l.m2l_translate(*bad)
        bad = list(sargs)
        bad[k] = shifted(bad[k])
        with pytest.raises(ValueError):
            m2l.m2l_translate_shard(*bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_near_kernel_matches_plain_on_card(cuda_device, dtype):
    args = _k2_inputs(cuda_device, dtype, sz=16)
    inst = _cuda.INSTANCES[dtype]
    for sigma_w, duffy in ((args[4], None), (args[4], args[5]),
                           (None, None)):
        n0 = near.launches[inst]
        got = near.near_contract(*args[:4], sigma_w, duffy)
        want = near.near_contract_plain(*args[:4], sigma_w, duffy)
        assert near.launches[inst] == n0 + 1
        assert float((got - want).abs().max()) <= \
            _GATE[dtype] * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sz,level", [(16, 3), (16, 4), (32, 5), (16, 2),
                                      (64, 5), (64, 6)])
def test_offsets_kernel_matches_plain_on_card(cuda_device, dtype, sz, level):
    """K3 against its plain version at fine levels where mirror slices are
    empty or partial (m2 = 2, 4, 8, 16, 32: below, at and past one tile of
    32 boxes) with windows of B = 4, 2 and 1 squares.  Its atomic sums
    change order from run to run, which the gates cover (27 terms per
    output)."""
    args = _k3_inputs(cuda_device, dtype, sz, level)
    inst = _cuda.INSTANCES[dtype]
    n0 = offsets.launches[inst]
    got = offsets.offsets_translate(*args)
    want = offsets.offsets_translate_plain(*args)
    assert offsets.launches[inst] == n0 + 1
    assert float((got - want).abs().max()) <= \
        _GATE[dtype] * float(want.abs().max())


def _gate(got, want, dtype):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= \
        _GATE[dtype] * float(want.abs().max())


def _mode_tables(shape, D, device, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((D,) + shape),
                           dtype=dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D,m2,np_cheb", [
    (2, 8, 4), (9, 8, 4), (11, 8, 4), (9, 2, 4), (3, 3, 4), (1, 3, 4),
    (5, 5, 4), (13, 5, 4), (1, 12, 4), (3, 12, 4), (5, 12, 4), (9, 12, 4),
    (13, 12, 4), (13, 8, 4),
] + [(D, m2, n) for n in (2, 3, 5, 6, 7)
     for (D, m2) in ((3, 5), (9, 12), (13, 3))])
def test_m2l_all_modes_kernel_matches_plain_on_card(cuda_device, dtype, D,
                                                    m2, np_cheb):
    """K1 with the mode axis (D = 11 and 13 take two chunks of modes, the
    last of 2 and 4; m2 = 2, 3 and 5 leave the last tile of boxes ragged:
    16 boxes a tile in f32, 8 in f64 and in f32 for np 6-7, 4 in f64 for
    np 6-7; coarse planes split their target points over two blocks; r =
    9, 25 and 49 rows are not whole 16-byte vectors) against its plain
    version and against D launches of the one-mode instance."""
    r = np_cheb * np_cheb
    E, _, M, shift = _k1_inputs(cuda_device, dtype, m2=m2, r=r)
    cosr = _mode_tables((4, r, 27 * r), D, cuda_device, dtype, 11)
    inst = _cuda.INSTANCES[dtype]
    n0 = m2l.launches[inst]
    got = m2l.m2l_translate(E, cosr, M, shift)
    assert m2l.launches[inst] == n0 + 1
    _gate(got, m2l.m2l_translate_plain(E, cosr, M, shift), dtype)
    each = torch.stack([m2l.m2l_translate(E, cosr[d], M, shift)
                        for d in range(D)])
    assert m2l.launches[inst] == n0 + 1 + D
    _gate(got, each, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [3, 9, 10])
def test_near_all_modes_kernel_matches_plain_on_card(cuda_device, dtype, D):
    """K2 with the mode axis: the diagonal on slot 0 only, each mode's own
    Duffy blocks."""
    E, _, _, u, sigma_w, _ = _k2_inputs(cuda_device, dtype, sz=16)
    cosrw = _mode_tables((9, 3, 3, 9), D, cuda_device, dtype, 12)
    S = _mode_tables((9, 3, 3, 9), D, cuda_device, dtype, 13)
    duffy = _mode_tables((16, 16, 9, 9), D, cuda_device, dtype, 14)
    inst = _cuda.INSTANCES[dtype]
    for sw, dfy in ((sigma_w, None), (sigma_w, duffy), (None, None)):
        n0 = near.launches[inst]
        got = near.near_contract(E, cosrw, S, u, sw, dfy)
        assert near.launches[inst] == n0 + 1
        _gate(got, near.near_contract_plain(E, cosrw, S, u, sw, dfy), dtype)
        each = torch.stack([
            near.near_contract(E, cosrw[d], S[d], u, sw if d == 0 else None,
                               None if dfy is None else dfy[d])
            for d in range(D)])
        _gate(got, each, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("nq", [1, 4, 9, 16])
@pytest.mark.parametrize("D", [1, 3, 5, 9, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_near_kernel_instances_match_plain_on_card(cuda_device, dtype, D, nq,
                                                   shard):
    """Every K2 instance against its plain version: compiled D (1, 3, 5, 9)
    and the runtime-D one (11: two blocks of modes), nq 1, 4, 9 and 16 (at
    nq 16, D 9 in f64 the tables of all target rows exceed shared memory:
    the rows are split over blocks), with and without the Duffy term, on
    the whole grid (13 x 13, the last tile ragged) and on a 7 x 5 shard
    with its halo-extended u."""
    rng = np.random.default_rng(100 * D + nq)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=dtype).to(cuda_device)

    lx, ly = (7, 5) if shard else (13, 13)
    E = t((lx, ly, nq, 3, 3, nq)).abs()
    cosrw, S = t((D, nq, 3, 3, nq)), t((D, nq, 3, 3, nq))
    u = t((lx + 2, ly + 2, nq)) if shard else t((lx, ly, nq))
    sigma_w, duffy = t((lx, ly, nq)), t((D, lx, ly, nq, nq))
    fn, plain = ((near.near_contract_shard, near.near_contract_shard_plain)
                 if shard else (near.near_contract, near.near_contract_plain))
    key = ("shard_" if shard else "") + _cuda.INSTANCES[dtype]
    for dfy in (None, duffy):
        n0 = near.launches[key]
        got = fn(E, cosrw, S, u, sigma_w, dfy)
        assert near.launches[key] == n0 + 1
        _gate(got, plain(E, cosrw, S, u, sigma_w, dfy), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sz,level,D,np_cheb", [
    (16, 3, 3, 4), (16, 4, 9, 4), (32, 5, 2, 4), (16, 2, 1, 4),
    (16, 2, 13, 4), (16, 3, 5, 4), (32, 5, 13, 4), (64, 5, 5, 4),
    (64, 6, 9, 4), (64, 6, 1, 4),
] + [(sz, level, D, n) for n in (2, 3, 5)
     for (sz, level, D) in ((16, 2, 3), (16, 3, 1), (32, 5, 9), (64, 6, 5))])
def test_offsets_all_modes_kernel_matches_plain_on_card(cuda_device, dtype,
                                                        sz, level, D,
                                                        np_cheb):
    """K3 with the mode axis at B = 4, 2 and 1, m2 = 2 to 32 (one tile of
    32 boxes), D = 1 (one mode with the mode axis) to 13, and np 2, 3 and
    5 (r^2 = 16, 81 and 625 pairs padded to 64, 128 and 640; rows of 9 and
    25 values copied one value at a time)."""
    Wo, coeffs, _, M, shift = _k3_inputs(cuda_device, dtype, sz, level,
                                         np_cheb)
    r = np_cheb * np_cheb
    cosr = _mode_tables((4, r, 27 * r), D, cuda_device, dtype, 15)
    inst = _cuda.INSTANCES[dtype]
    n0 = offsets.launches[inst]
    got = offsets.offsets_translate(Wo, coeffs, cosr, M, shift)
    assert offsets.launches[inst] == n0 + 1
    _gate(got, offsets.offsets_translate_plain(Wo, coeffs, cosr, M, shift),
          dtype)
    each = torch.stack([offsets.offsets_translate(Wo, coeffs, cosr[d], M,
                                                  shift) for d in range(D)])
    _gate(got, each, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sz", [1, 2, 33, 128])
def test_diffusion_kernel_matches_plain_on_card(cuda_device, dtype, sz):
    """K9d against its plain version; at sz = 1 and 2 every cell touches
    two or more sides of the domain."""
    rng = np.random.default_rng(8)
    dx = 1.0 / sz

    def t(a):
        return torch.as_tensor(a, dtype=dtype).to(cuda_device)

    Dx, Dy, robin = _face_coeffs(t(0.5 / (1.0 + 20 * rng.random((sz, sz)))),
                                 dx)
    sa = t(0.1 + rng.random((sz, sz)))
    z = t(rng.standard_normal((sz, sz)))
    inst = _cuda.INSTANCES[dtype]
    n0 = diffusion.launches[inst]
    got = diffusion.diffusion_apply(z, Dx, Dy, robin, sa, dx)
    assert diffusion.launches[inst] == n0 + 1
    _gate(got, diffusion.diffusion_apply_plain(z, Dx, Dy, robin, sa, dx),
          dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("np_cheb", [6, 7, 8])
@pytest.mark.parametrize("D", [1, 5])
def test_offsets_kernel_np6_to_8_matches_plain_on_card(cuda_device, dtype,
                                                       np_cheb, D):
    """K3 at np 6-8 (r^2 = 1296, 2401 and 4096 pairs cut into chunks of
    192 across blocks: the compile-time r = 36 and 49 instances and the
    runtime-r one) at B = 2 (16^2, level 3, m2 = 4) and B = 1 (32^2, level
    5, m2 = 16), one mode and D = 5, against its plain version."""
    r = np_cheb * np_cheb
    inst = _cuda.INSTANCES[dtype]
    for sz, level in ((16, 3), (32, 5)):
        Wo, coeffs, _, M, shift = _k3_inputs(cuda_device, dtype, sz, level,
                                             np_cheb)
        cosr = _mode_tables((4, r, 27 * r), D, cuda_device, dtype, 16)
        if D == 1:
            cosr = cosr[0]
        n0 = offsets.launches[inst]
        got = offsets.offsets_translate(Wo, coeffs, cosr, M, shift)
        assert offsets.launches[inst] == n0 + 1
        _gate(got, offsets.offsets_translate_plain(Wo, coeffs, cosr, M,
                                                   shift), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("np_cheb", [6, 7, 8])
@pytest.mark.parametrize("D,m2", [(3, 5), (9, 12), (13, 3)])
def test_m2l_all_modes_f64_np6_to_8_matches_plain_on_card(cuda_device,
                                                          np_cheb, D, m2):
    """K1-D in float64 at np 6-7 (one box a lane: the tile's source rows in
    48 KB) and np 8 (the runtime-r instance) against its plain version and
    D one-mode launches."""
    r = np_cheb * np_cheb
    E, _, M, shift = _k1_inputs(cuda_device, torch.float64, m2=m2, r=r)
    cosr = _mode_tables((4, r, 27 * r), D, cuda_device, torch.float64, 17)
    n0 = m2l.launches["f64"]
    got = m2l.m2l_translate(E, cosr, M, shift)
    assert m2l.launches["f64"] == n0 + 1
    _gate(got, m2l.m2l_translate_plain(E, cosr, M, shift), torch.float64)
    each = torch.stack([m2l.m2l_translate(E, cosr[d], M, shift)
                        for d in range(D)])
    _gate(got, each, torch.float64)


@pytest.mark.cuda
def test_refined_solve_np6_completes_on_card(cuda_device):
    """32^2, np 6, refine=True: every twin sweep runs K3 at r = 36 and K1
    f64, and the solve converges to its tol on the true f64 residual."""
    cfg = SolverConfig(domain_size=32, quad_rule=2, kernel_size=1, g=0.5,
                       sing_rule=6, np_cheb=6, dtype="float32", tol=1e-8,
                       refine=True, restart=80, max_iter=400)
    s = TransportSolver(cfg, backend="fmm", device=cuda_device)
    g = s.grid
    sig = 8 * (1 - np.cos(2 * np.pi * g.nodes_x))
    s.set_coeff(sig, sig + 0.2)
    q = np.exp(-25 * ((g.nodes_x - 0.5) ** 2 + (g.nodes_y - 0.5) ** 2))
    n0 = offsets.launches["f64"]
    res = s.solve(q)
    assert res.converged and offsets.launches["f64"] > n0
    b = s._rhs64(q)
    true = torch.linalg.vector_norm(b - s._forward64(res.x)) \
        / torch.linalg.vector_norm(b)
    assert float(true) < 1e-8


def _k7_pairs(rng, sz, n):
    """Random pairs, then axis-aligned ones, pairs through grid corners,
    endpoints on grid lines and zero-length ones."""
    h = 1.0 / sz
    odd = np.array([
        [(0.3, 0.2), (0.3, 0.9)], [(0.8, 0.55), (0.1, 0.55)],
        [(0.5 * h, 0.5 * h), (2.5 * h, 2.5 * h)], [(0.0, 0.0), (1.0, 1.0)],
        [(1.0, 0.0), (0.0, 1.0)], [(h, 0.3), (3 * h, 0.7)],
        [(0.0, 0.4), (1.0, 0.4)], [(0.37, 0.61), (0.37, 0.61)],
    ])
    return (np.concatenate([rng.random((n, 2)), odd[:, 0]]),
            np.concatenate([rng.random((n, 2)), odd[:, 1]]))


@pytest.mark.cuda
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("sz,deg", [(16, 3), (8, 2), (5, 1)])
def test_line_integral_kernel_matches_plain_on_card(cuda_device, compat, sz,
                                                    deg):
    """K7's pair-list form against its plain version (JAX's padded form,
    one piece of sz crossings per axis) on the same card."""
    rng = np.random.default_rng(sz)
    g = make_grid(sz, deg)
    coeffs = torch.as_tensor(rng.standard_normal((sz, sz, deg * deg)) + 3.0,
                             device=cuda_device)
    p0, p1 = (torch.as_tensor(p, device=cuda_device)
              for p in _k7_pairs(rng, sz, 3000))
    n0 = attenuation.launches["pairs"]
    got = attenuation.line_integral_pairs(g, coeffs, p0, p1, compat)
    assert attenuation.launches["pairs"] == n0 + 1
    want = make_line_integral(g, sz, compat)(coeffs, p0[:, 0], p0[:, 1],
                                             p1[:, 0], p1[:, 1])
    _gate(got, want, torch.float64)
    assert float(got[-1]) == 0.0


def _dense_gate(got, want, rows, dtype):
    """K7's whole matrix against its plain version on `rows` (targets of
    both triangles): 1e-12 of the maximum for float64; a float32 store
    rounds each value once more (2^-24 relative), so 1e-7 there."""
    sub = got[:, rows].double()
    assert got.dtype == dtype
    tol = 1e-12 if dtype == torch.float64 else 1e-7
    assert float((sub - want).abs().max()) <= tol * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("modes", [[0, 1, 2], [1, 2], [0]])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("sz,deg", [(8, 1), (8, 2), (8, 3), (16, 1),
                                    (16, 2), (16, 3), (8, 9)])
def test_dense_smooth_kernel_matches_plain_on_card(cuda_device, dtype,
                                                   compat, sz, deg, modes):
    """K7's whole-matrix entry (E once per unordered pair, fused with the
    mode factors, the diagonal and the weights) against the plain target
    -> source rows: the first and last rows (the upper triangle's tiles and
    the mirrored ones) and rows that cross the diagonal tiles, in both
    bases, for modes from 0 (the r = 0 diagonal on mode 0) and from 1 (no
    diagonal; the mirrored entries' (-1)^m sign from m = 1)."""
    rng = np.random.default_rng(sz + deg)
    g = make_grid(sz, deg)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=cuda_device)

    coeffs = t(rng.standard_normal((sz, sz, deg * deg)) + 3.0)
    pts, w = t(g.flat_nodes()).contiguous(), t(g.weights.reshape(-1))
    diag = t(rng.random(g.n_nodes))
    n = g.n_nodes
    inst = "dense_f64" if dtype == torch.float64 else "dense_f32"
    n0 = attenuation.launches[inst]
    got = attenuation.dense_smooth(g, coeffs, pts, w, diag, modes, compat,
                                   dtype)
    assert attenuation.launches[inst] == n0 + 1
    assert got.shape == (len(modes), n, n)
    for r0, nr in ((0, 40), (n - 40, 40), (n // 2 - 7, 30)):
        want = attenuation.dense_smooth_rows_plain(g, coeffs, pts, w, diag,
                                                   r0, nr, modes, compat)
        _dense_gate(got, want, slice(r0, r0 + nr), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [9, 10, 12])
def test_line_integral_kernel_high_deg_matches_plain_on_card(cuda_device,
                                                             deg):
    """K7's runtime-deg instance (deg > 8) on an 8^2 grid: the pair-list
    form against the plain line integral, and rows 0..199 and the last 100
    of the whole-matrix form against its plain version, both bases."""
    rng = np.random.default_rng(deg)
    g = make_grid(8, deg)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=cuda_device)

    coeffs = t(rng.standard_normal((8, 8, deg * deg)) + 3.0)
    p0, p1 = (t(p) for p in _k7_pairs(rng, 8, 3000))
    pts, w = t(g.flat_nodes()).contiguous(), t(g.weights.reshape(-1))
    diag = t(rng.random(g.n_nodes))
    n = g.n_nodes
    for compat in (False, True):
        n0 = attenuation.launches["pairs"]
        got = attenuation.line_integral_pairs(g, coeffs, p0, p1, compat)
        assert attenuation.launches["pairs"] == n0 + 1
        want = make_line_integral(g, 8, compat)(coeffs, p0[:, 0], p0[:, 1],
                                                p1[:, 0], p1[:, 1])
        _gate(got, want, torch.float64)
        got = attenuation.dense_smooth(g, coeffs, pts, w, diag, [0, 1],
                                       compat)
        for r0, nr in ((0, 200), (n - 100, 100)):
            want = attenuation.dense_smooth_rows_plain(
                g, coeffs, pts, w, diag, r0, nr, [0, 1], compat)
            _dense_gate(got, want, slice(r0, r0 + nr), torch.float64)


def _halo_jobs(device, dtype, lx, ly, q, w, seed, receive=False, shards=8):
    """K10's jobs for the shards of a mesh of (lx, ly, q) blocks (8: 2 x 4):
    each shard's regions as views of its neighbours' blocks, or (receive)
    as contiguous copies, the form of a P2P receive buffer."""
    from aniso_torch.parallel.api import make_mesh
    from aniso_torch.parallel.halo import DIRECTIONS, neighbour_region

    mesh = make_mesh(devices=[device] * shards)
    rng = np.random.default_rng(seed)
    blocks = [torch.as_tensor(rng.standard_normal((lx, ly, q)),
                              dtype=dtype).to(device) for _ in range(shards)]
    jobs = []
    for k in range(shards):
        regions = [[None] * 3 for _ in range(3)]
        regions[1][1] = blocks[k]
        for a, b in DIRECTIONS:
            nb = mesh.neighbour(k, a - 1, b - 1)
            if nb is not None:
                r = neighbour_region(blocks[nb], a, b, w)
                regions[a][b] = r.contiguous() if receive else r
        jobs.append(regions)
    return jobs


@pytest.mark.parametrize("receive", [False, True])
def test_halo_fill_plain_is_the_zero_padded_block(receive):
    """On the CPU: every shard's extended block is the window of the whole
    zero-padded array around its block, from neighbour views and from
    receive-buffer copies alike."""
    jobs = _halo_jobs("cpu", torch.float64, 4, 3, 5, 2, 0, receive)
    whole = torch.zeros((2 * 4 + 4, 4 * 3 + 4, 5), dtype=torch.float64)
    for k, regions in enumerate(jobs):
        ix, iy = divmod(k, 4)
        whole[2 + 4 * ix:6 + 4 * ix, 2 + 3 * iy:5 + 3 * iy] = regions[1][1]
    outs = halo.halo_fill(jobs, 2)
    for k, out in enumerate(outs):
        ix, iy = divmod(k, 4)
        assert torch.equal(out, whole[4 * ix:4 * ix + 8, 3 * iy:3 * iy + 7])


def test_halo_fill_refuses_what_the_kernel_does_not_take():
    jobs = _halo_jobs("meta", torch.float32, 4, 3, 5, 1, 0)
    with pytest.raises(ValueError):
        halo.halo_fill(jobs, 1)
    half = [[None if r is None else r.half() for r in row] for row in jobs[0]]
    with pytest.raises(TypeError):
        halo.halo_fill([half], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("w,q,receive,lx,ly,shards", [
    (1, 9, False, 12, 6, 8), (1, 16, False, 12, 6, 8),
    (2, 16, False, 12, 6, 8), (2, 16, True, 12, 6, 8),
    (2, 9, True, 12, 6, 8), (1, 9, False, 7, 5, 8), (1, 3, True, 9, 7, 8),
    (2, 5, False, 5, 3, 8), (1, 1, False, 3, 301, 8),
    (1, 9, False, 6, 5, 16), (2, 16, True, 4, 3, 17)])
def test_halo_fill_kernel_matches_plain_on_card(cuda_device, dtype, w, q,
                                                receive, lx, ly, shards):
    """K10 bitwise against its plain version: one launch for up to 16
    shards (two for 17), runs whose source and destination lie alike
    modulo 16 (q 16: 16-byte words), alike modulo 8 only, or not (q 9, 5,
    3, 1 and odd lx, ly: runs start off 16 bytes in both dtypes), a long
    interior run (ly 301: several warps), views and receive buffers."""
    jobs = _halo_jobs(cuda_device, dtype, lx, ly, q, w, q + w, receive,
                      shards)
    inst = _cuda.INSTANCES[dtype]
    n0 = halo.launches[inst]
    got = halo.halo_fill(jobs, w)
    assert halo.launches[inst] == n0 + -(-shards // halo.MAX_SHARDS)
    torch.cuda.synchronize()
    for out, regions in zip(got, jobs):
        assert torch.equal(out, halo.halo_fill_plain(regions, w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D,m2x,m2y,np_cheb", [(1, 4, 2, 4), (1, 2, 3, 3),
                                               (9, 4, 2, 4), (5, 8, 4, 4),
                                               (3, 2, 2, 3), (1, 2, 1, 2),
                                               (1, 3, 5, 5), (1, 16, 8, 4),
                                               (1, 7, 3, 7), (1, 4, 4, 8),
                                               (1, 32, 16, 4), (1, 4, 2, 6)])
def test_m2l_shard_kernel_matches_plain_on_card(cuda_device, dtype, D, m2x,
                                                m2y, np_cheb):
    """K1-S (the one-mode kernel at D = 1, the all-modes one above)
    against its plain version on a shard's rectangle: odd m2y, rows off
    16 bytes (np 3, 5, 7), np 6 and 8."""
    r = np_cheb * np_cheb
    E, cosr, Mext, shift = _k1s_inputs(cuda_device, dtype, m2x, m2y, r)
    if D > 1:
        cosr = _mode_tables((4, r, 27 * r), D, cuda_device, dtype, 15)
    inst = _cuda.INSTANCES[dtype]
    n0 = m2l.launches["shard_" + inst]
    got = m2l.m2l_translate_shard(E, cosr, Mext, shift)
    assert m2l.launches["shard_" + inst] == n0 + 1
    _gate(got, m2l.m2l_translate_shard_plain(E, cosr, Mext, shift), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [1, 9])
@pytest.mark.parametrize("compat", [False, True])
def test_near_shard_kernel_matches_plain_on_card(cuda_device, dtype, D,
                                                 compat):
    E, cosrw, S, ue, sigma_w, duffy = _k2s_inputs(cuda_device, dtype, 8, 4)
    if D > 1:
        cosrw = _mode_tables((9, 3, 3, 9), D, cuda_device, dtype, 16)
        S = _mode_tables((9, 3, 3, 9), D, cuda_device, dtype, 17)
        duffy = _mode_tables((8, 4, 9, 9), D, cuda_device, dtype, 18)
    duffy = duffy if compat else None
    inst = _cuda.INSTANCES[dtype]
    n0 = near.launches["shard_" + inst]
    got = near.near_contract_shard(E, cosrw, S, ue, sigma_w, duffy)
    assert near.launches["shard_" + inst] == n0 + 1
    _gate(got, near.near_contract_shard_plain(E, cosrw, S, ue, sigma_w,
                                              duffy), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sharded_matvec_on_card_matches_one_device(cuda_device, dtype):
    """The whole sharded matvec on a 2 x 4 mesh of shards on one card
    (K10, K1-S, K2-S; K1 whole-level at level 2) against the card's
    one-device matvec, with the launches per matvec."""
    from aniso_torch.parallel import api

    s = TransportSolver(SolverConfig(domain_size=32, quad_rule=3, np_cheb=4,
                                     g=0.5, dtype=dtype, sing_rule=8),
                        backend="fmm", device=cuda_device)
    g = s.grid
    sig = 8 * (1 - np.cos(2 * np.pi * g.nodes_x))
    s.set_coeff(sig, sig + 0.2)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (32, 32, g.nq)), dtype=s.dtype, device=cuda_device)
    mesh = api.make_mesh(devices=[cuda_device] * 8)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    inst = _cuda.INSTANCES[s.dtype]
    n = (halo.launches[inst], m2l.launches["shard_" + inst],
         near.launches["shard_" + inst], m2l.launches[inst])
    out = apply_fn(caches, ms[0], 0, api.shard_field(mesh, u)).full()
    # K10: u and levels 3-5; K1-S: 8 shards x levels 3-5; K2-S: 8 shards;
    # K1 at level 2 once for the device
    assert (halo.launches[inst] - n[0], m2l.launches["shard_" + inst] - n[1],
            near.launches["shard_" + inst] - n[2],
            m2l.launches[inst] - n[3]) == (4, 24, 8, 1)
    _gate(out, s.apply_mode(0, u), s.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,stop,shards", [((1, 8), 3, 8),
                                               ((2, 3), 2, 1)])
def test_sharded_matvec_on_other_meshes_on_card(cuda_device, shape, stop,
                                                shards):
    """The sharded matvec where the mesh's blocks do not split every
    level: (1, 8) at 32^2 (blocks of 32 x 4: the shards' up pass stops at
    level 3, K8's up_from and whole L2L chain run above it, each shard
    takes its block of the whole locals) and (2, 3), which the field does
    not divide (whole on mesh.whole); against the card's one-device
    matvec, with K8's launches."""
    from aniso_torch.parallel import api

    s = TransportSolver(SolverConfig(domain_size=32, quad_rule=3, np_cheb=4,
                                     g=0.5, dtype="float32", sing_rule=8),
                        backend="fmm", device=cuda_device)
    g = s.grid
    sig = 8 * (1 - np.cos(2 * np.pi * g.nodes_x))
    s.set_coeff(sig, sig + 0.2)
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (32, 32, g.nq)), dtype=s.dtype, device=cuda_device)
    mesh = api.Mesh(shape, [torch.device(cuda_device)] * (shape[0]
                                                          * shape[1]))
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    su = api.shard_field(mesh, u)
    assert su.mesh.size == shards
    block = tuple(su.blocks[su.mesh.local[0]].shape[:2])
    assert api.stop_level(block, 5) == stop
    n0 = dict(transfer.launches)
    out = apply_fn(caches, ms[0], 0, su).full()
    r, item = 16, 4
    n = 5 - stop
    up = shards * len(transfer.up_plan(*block, n, r, g.nq, item)) + len(
        transfer.up_plan(1 << stop, 1 << stop, stop - 2, r, 0, item))
    down = shards * len(transfer.down_plan(*block, n, r, g.nq, item)) + len(
        transfer.down_plan(1 << stop, 1 << stop, stop - 2, r, 0, item))
    assert (transfer.launches["up_f32"] - n0["up_f32"],
            transfer.launches["down_f32"] - n0["down_f32"]) == (up, down)
    _gate(out, s.apply_mode(0, u), s.dtype)


# K8 (kernels.transfer) against its plain versions: 1e-6 of the largest
# value in float32 (sums of up to 4 r terms a level, in another order), 1e-13
# in float64.  The kernels sum in float64 and round each output once, so the
# plain version runs in float64 on the same inputs (_plain64): in float32 it
# would add its own rounding, a level at a time.
_K8_GATE = {torch.float32: 1e-6, torch.float64: 1e-13}


def _k8_gate(got, want, dtype):
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= \
        _K8_GATE[dtype] * float(want.abs().max())


def _plain64(fn, *args):
    """fn (a plain version) on the float64 values of its tensor arguments
    (exact casts; lists of tensors too)."""
    def f64(a):
        if isinstance(a, torch.Tensor):
            return a.double()
        if isinstance(a, list):
            return [f64(x) for x in a]
        return a

    return fn(*[f64(a) for a in args])


def _k8_static(device, dtype, np_cheb, deg=3):
    from aniso_torch.fmm.apply import build_fmm_static
    return build_fmm_static(make_grid(8, deg), np_cheb, device, dtype)


def test_k8_wrappers_refuse_tensors_off_the_cpu_and_other_dtypes():
    """A meta tensor goes to the kernel's checks, never to the plain
    version; float16 is refused before any launch."""
    st = _k8_static("meta", torch.float64, 3)
    u = torch.zeros((8, 8, 9), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        transfer.up_pass(st["p2m_w"], st["m2m_1d"], u, 1)
    L0 = torch.zeros((4, 4, 9), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        transfer.down(st["m2m_1d"], L0, [])
    with pytest.raises(TypeError):
        transfer.down(st["m2m_1d"], L0.half(), [])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("np_cheb", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("lx,ly", [(64, 64), (32, 16), (512, 512)])
def test_k8_up_matches_plain_on_card(cuda_device, dtype, np_cheb, lx, ly):
    """K8's up pass from the leaf to level 2 of a whole grid (64^2: one
    launch; 512^2: two) and of a shard's rectangle, then the coarse up
    pass of a domain decomposition from one level's M."""
    st = _k8_static(cuda_device, dtype, np_cheb)
    n = int(math.log2(min(lx, ly))) - 2 if lx == ly else 3
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (lx, ly, 9)), dtype=dtype).to(cuda_device)
    inst = _cuda.INSTANCES[dtype]
    r = np_cheb * np_cheb
    n0 = transfer.launches["up_" + inst]
    got = transfer.up_pass(st["p2m_w"], st["m2m_1d"], u, n)
    assert transfer.launches["up_" + inst] - n0 == len(transfer.up_plan(
        lx, ly, n, r, 9, u.element_size())) == 1
    want = _plain64(transfer.up_pass_plain, st["p2m_w"], st["m2m_1d"], u, n)
    for g, w in zip(got, want):
        _k8_gate(g, w, dtype)
    M1 = want[1].to(dtype)
    got = transfer.up_from(st["m2m_1d"], M1, n - 1)
    for g, w in zip(got, _plain64(transfer.up_from_plain, st["m2m_1d"], M1,
                                  n - 1)):
        _k8_gate(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [None, 1, 5, 9])
@pytest.mark.parametrize("np_cheb", [2, 4, 7])
@pytest.mark.parametrize("lx,ly,n", [(64, 64, 4), (256, 128, 7), (16, 8, 0)])
def test_k8_down_matches_plain_on_card(cuda_device, dtype, D, np_cheb, lx,
                                       ly, n):
    """K8's down pass: the L2L chain with T added from level 2 to the leaf
    and the epilogue (L2T, near, 1/2pi), one mode (no mode axis) or D
    modes, on a whole grid and a shard's rectangle, and the epilogue alone
    (n = 0); the chain without the epilogue returns the leaf's L."""
    st = _k8_static(cuda_device, dtype, np_cheb)
    r = np_cheb * np_cheb
    rng = np.random.default_rng(6)
    lead = () if D is None else (D,)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(lead + shape),
                               dtype=dtype).to(cuda_device)

    L0 = t((lx >> n, ly >> n, r))
    Ts = [t((lx >> (n - j), ly >> (n - j), r)) for j in range(1, n + 1)]
    near_ = t((lx, ly, 9))
    inst = _cuda.INSTANCES[dtype]
    n0 = transfer.launches["down_" + inst]
    got = transfer.down(st["m2m_1d"], L0, Ts, st["l2t"], near_)
    assert transfer.launches["down_" + inst] - n0 == len(transfer.down_plan(
        lx, ly, n, r, 9, L0.element_size(), D or 1)) == 1
    _k8_gate(got, _plain64(transfer.down_plain, st["m2m_1d"], L0, Ts,
                           st["l2t"], near_), dtype)
    if n:
        _k8_gate(transfer.down(st["m2m_1d"], L0, Ts),
                 _plain64(transfer.down_plain, st["m2m_1d"], L0, Ts), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k8_at_np16_reads_its_weights_from_global_memory_on_card(cuda_device,
                                                                 dtype):
    """np 16 (r = 256): m2m (1 MB in float32, 2 MB in float64) does not
    fit beside the tile, so the passes read their weights in place; the up
    pass and the down pass with its epilogue on 16^2 against their plain
    versions.  A level's sums run over 4 r = 1024 terms, 16 times np 4's:
    float32 is held to 1e-5 of the largest value (chip_smoke.py's kernel
    gate), float64 to 1e-13."""
    gate = {torch.float32: 1e-5, torch.float64: 1e-13}[dtype]

    def hold(got, want):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= \
            gate * float(want.abs().max())

    st = _k8_static(cuda_device, dtype, 16)
    rng = np.random.default_rng(8)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=dtype).to(cuda_device)

    u = t((16, 16, 9))
    for g, w in zip(transfer.up_pass(st["p2m_w"], st["m2m_1d"], u, 2),
                    transfer.up_pass_plain(st["p2m_w"], st["m2m_1d"], u, 2)):
        hold(g, w)
    L0, Ts = t((3, 4, 4, 256)), [t((3, 8, 8, 256)), t((3, 16, 16, 256))]
    near_ = t((3, 16, 16, 9))
    hold(transfer.down(st["m2m_1d"], L0, Ts, st["l2t"], near_),
         transfer.down_plain(st["m2m_1d"], L0, Ts, st["l2t"], near_))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lx,ly,n", [(256, 128, 7), (512, 64, 6),
                                     (192, 64, 6)])
def test_k8_on_rectangles_off_the_big_tile_on_card(cuda_device, dtype, lx,
                                                   ly, n):
    """Rectangles whose sides are not a multiple of the 16 x 16 tile's
    plane (a sharded512 shard, the (1, 8) mesh's 512 x 64 blocks, 192 x
    64): the up pass, up_from and the down pass with D = 3 modes, each one
    launch, against their plain versions."""
    st = _k8_static(cuda_device, dtype, 4)
    rng = np.random.default_rng(lx + ly)

    def t(shape):
        return torch.as_tensor(rng.standard_normal(shape),
                               dtype=dtype).to(cuda_device)

    inst = _cuda.INSTANCES[dtype]
    u = t((lx, ly, 9))
    n0 = dict(transfer.launches)
    got = transfer.up_pass(st["p2m_w"], st["m2m_1d"], u, n)
    want = _plain64(transfer.up_pass_plain, st["p2m_w"], st["m2m_1d"], u, n)
    for g, w in zip(got, want):
        _k8_gate(g, w, dtype)
    M0 = got[0]
    for g, w in zip(transfer.up_from(st["m2m_1d"], M0, n),
                    _plain64(transfer.up_from_plain, st["m2m_1d"], M0, n)):
        _k8_gate(g, w, dtype)
    L0 = t((3, lx >> n, ly >> n, 16))
    Ts = [t((3, lx >> (n - j), ly >> (n - j), 16)) for j in range(1, n + 1)]
    near_ = t((3, lx, ly, 9))
    _k8_gate(transfer.down(st["m2m_1d"], L0, Ts, st["l2t"], near_),
             _plain64(transfer.down_plain, st["m2m_1d"], L0, Ts, st["l2t"],
                      near_), dtype)
    assert (transfer.launches["up_" + inst] - n0["up_" + inst],
            transfer.launches["down_" + inst] - n0["down_" + inst]) == (2, 1)


@pytest.mark.cuda
def test_k8_float64_repeats_bit_for_bit_in_graph_replays(cuda_device):
    """The passes captured in a CUDA graph: two replays give the eager
    launch's bits (the tickets are 0 again after every launch)."""
    st = _k8_static(cuda_device, torch.float64, 4)
    rng = np.random.default_rng(9)
    u = torch.as_tensor(rng.standard_normal((256, 128, 9))).to(cuda_device)
    L0 = torch.as_tensor(rng.standard_normal((3, 2, 1, 16))).to(cuda_device)
    Ts = [torch.as_tensor(rng.standard_normal((3, 2 << j, 1 << j, 16)))
          .to(cuda_device) for j in range(1, 8)]
    near_ = torch.as_tensor(rng.standard_normal((3, 256, 128, 9))).to(
        cuda_device)

    def passes():
        return (transfer.up_pass(st["p2m_w"], st["m2m_1d"], u, 7),
                transfer.down(st["m2m_1d"], L0, Ts, st["l2t"], near_))

    ups, down_ = passes()
    eager = [x.clone() for x in ups] + [down_.clone()]
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        ups, down_ = passes()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        for x in ups + [down_]:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(ups + [down_], eager))
    assert not transfer._ticket_buffer(u.device).any()


@pytest.mark.cuda
def test_k8_float64_is_the_same_bit_for_bit_run_to_run(cuda_device):
    """No atomics: two runs of the f64 sweep's passes agree exactly."""
    st = _k8_static(cuda_device, torch.float64, 4)
    u = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (512, 512, 9))).to(cuda_device)
    a = transfer.up_pass(st["p2m_w"], st["m2m_1d"], u, 7)
    b = transfer.up_pass(st["p2m_w"], st["m2m_1d"], u, 7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    Ts = [m[None].expand(9, -1, -1, -1).contiguous() for m in a[::-1]]
    near_ = u[None].expand(9, -1, -1, -1).contiguous()
    x = transfer.down(st["m2m_1d"], Ts[0], Ts[1:], st["l2t"], near_)
    y = transfer.down(st["m2m_1d"], Ts[0], Ts[1:], st["l2t"], near_)
    assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,np_cheb", [(torch.float64, 16),
                                           (torch.float32, 22)])
def test_m2l_kernels_at_large_np_match_plain_on_card(cuda_device, dtype,
                                                     np_cheb):
    """Rows of 27 r values over 48 KB (np 16 in float64: 55 KB; np 22 in
    float32: 52 KB) through the opt-in shared memory: K1 one mode, K1-D
    (D = 3), K1-S on a 2 x 1 shard plane and K3 (its runtime-r instance,
    sources read from M) at 8^2's levels, against their plain versions."""
    r = np_cheb * np_cheb
    args = _k1_inputs(cuda_device, dtype, m2=2, r=r)
    _gate(m2l.m2l_translate(*args), m2l.m2l_translate_plain(*args), dtype)
    E, _, M, shift = args
    cosr = _mode_tables((4, r, 27 * r), 3, cuda_device, dtype, 19)
    _gate(m2l.m2l_translate(E, cosr, M, shift),
          m2l.m2l_translate_plain(E, cosr, M, shift), dtype)
    del args, E, cosr
    sargs = _k1s_inputs(cuda_device, dtype, m2x=2, m2y=1, r=r)
    _gate(m2l.m2l_translate_shard(*sargs),
          m2l.m2l_translate_shard_plain(*sargs), dtype)
    del sargs
    g = make_grid(8, 1)
    sig = 8 * (1 - np.cos(2 * np.pi * g.nodes_x)) + 0.2
    rng = np.random.default_rng(9)
    Wo = build_m2l_offsets_fine(g, tree_config(8), 3, np_cheb, dtype,
                                "cpu")["Wo"].to(cuda_device)
    coeffs = torch.as_tensor(project_field(g, sig), dtype=dtype).to(
        cuda_device)
    M = torch.as_tensor(rng.standard_normal((8, 8, r)), dtype=dtype).to(
        cuda_device)
    for D in (1, 3):
        cosr = _mode_tables((4, r, 27 * r), D, cuda_device, dtype, 20)
        if D == 1:
            cosr = cosr[0]
        n0 = offsets.launches[_cuda.INSTANCES[dtype]]
        got = offsets.offsets_translate(Wo, coeffs, cosr, M, shift)
        assert offsets.launches[_cuda.INSTANCES[dtype]] == n0 + 1
        _gate(got, offsets.offsets_translate_plain(Wo, coeffs, cosr, M,
                                                   shift), dtype)
