"""aniso_torch's device policy and kernel wrappers.

The port imports neither JAX nor aniso_tpu; its entry points default to the
GPU and raise without one; a kernel wrapper takes the plain version only
for CPU tensors and otherwise launches its CUDA kernel or raises.  The
tests marked `cuda` hold the kernels against their plain versions on the
card and skip without one (run them there with
`python -m pytest tests/test_torch_device.py -m cuda --noconftest`).
"""

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
    _cuda, attenuation, diffusion, m2l, near, offsets,
)
from aniso_torch.ops.attenuation import make_line_integral
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
        "import aniso_torch.kernels.attenuation\n"
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
    assert s.device.type == "cpu" and s._fmm_static["m2m"].device.type == "cpu"


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


_INPUTS = {"m2l": (m2l.m2l_translate, _k1_inputs),
           "near": (near.near_contract, _k2_inputs),
           "offsets": (offsets.offsets_translate, _k3_inputs)}


@pytest.mark.parametrize("kernel", ["m2l", "near", "offsets"])
def test_wrappers_raise_on_tensors_off_the_cpu_without_a_kernel(kernel):
    """A tensor that is neither on the CPU nor a launchable CUDA tensor
    (here on the meta device) is refused, never computed by the plain
    version."""
    fn, inputs = _INPUTS[kernel]
    with pytest.raises(ValueError):
        fn(*inputs("meta"))


@pytest.mark.parametrize("kernel", ["m2l", "near", "offsets"])
def test_wrappers_refuse_other_dtypes(kernel):
    """Only the float32 and float64 instances exist: a float16 tensor off
    the CPU is refused before any launch."""
    fn, inputs = _INPUTS[kernel]
    args = [a.half() if a.is_floating_point() else a
            for a in inputs("meta")]
    with pytest.raises(TypeError):
        fn(*args)


@pytest.mark.parametrize("kernel", [m2l, near, offsets, diffusion,
                                    attenuation])
def test_kernel_load_raises_without_cuda(no_cuda, kernel):
    with pytest.raises(RuntimeError):
        _cuda.load(kernel.SOURCE, next(iter(kernel.SYMBOLS.values())), ())


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
        attenuation.dense_smooth_rows(g, c, pts, w, w, 0, 8, [0, 1])
    with pytest.raises(ValueError):
        attenuation.dense_smooth_rows(g, c, pts, w, w, 0, 8, [0, 2])


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
def test_m2l_kernel_matches_plain_on_card(cuda_device, dtype):
    args = _k1_inputs(cuda_device, dtype, m2=8)
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
    16 boxes a tile in f32, 8 in f64 and for np 6-7; coarse planes split
    their target points over two blocks; r = 9, 25 and 49 rows are not
    whole 16-byte vectors; float64 refuses np 6-7) against its plain
    version and against D launches of the one-mode instance."""
    r = np_cheb * np_cheb
    E, _, M, shift = _k1_inputs(cuda_device, dtype, m2=m2, r=r)
    cosr = _mode_tables((4, r, 27 * r), D, cuda_device, dtype, 11)
    inst = _cuda.INSTANCES[dtype]
    if D > 1 and r not in m2l.MODES_R[inst]:
        with pytest.raises(ValueError):
            m2l.m2l_translate(E, cosr, M, shift)
        return
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
    n0 = attenuation.launches["f64"]
    got = attenuation.line_integral_pairs(g, coeffs, p0, p1, compat)
    assert attenuation.launches["f64"] == n0 + 1
    want = make_line_integral(g, sz, compat)(coeffs, p0[:, 0], p0[:, 1],
                                             p1[:, 0], p1[:, 1])
    _gate(got, want, torch.float64)
    assert float(got[-1]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("modes", [[0, 1, 2], [1, 2], [0]])
def test_dense_smooth_kernel_matches_plain_on_card(cuda_device, compat,
                                                   modes):
    """K7's dense-build form (E fused with the mode factors, the diagonal
    and the weights) against its plain version, rows 100..299 of 576."""
    rng = np.random.default_rng(len(modes))
    g = make_grid(8, 3)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=cuda_device)

    coeffs = t(rng.standard_normal((8, 8, 9)) + 3.0)
    pts, w = t(g.flat_nodes()).contiguous(), t(g.weights.reshape(-1))
    diag = t(rng.random(g.n_nodes))
    n0 = attenuation.launches["f64"]
    got = attenuation.dense_smooth_rows(g, coeffs, pts, w, diag, 100, 200,
                                        modes, compat)
    assert attenuation.launches["f64"] == n0 + 1
    want = attenuation.dense_smooth_rows_plain(g, coeffs, pts, w, diag, 100,
                                               200, modes, compat)
    assert got.shape == (len(modes), 200, g.n_nodes)
    _gate(got, want, torch.float64)
