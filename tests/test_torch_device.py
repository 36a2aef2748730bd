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
from aniso_torch.kernels import _cuda, m2l, near, offsets
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
        "import aniso_torch.solver.refine, chip_smoke\n"
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
                        device="cpu")
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


def _k3_inputs(device, dtype=torch.float32, sz=16, level=4):
    """K3 at a fine level of sz^2: the real weight blocks and a smooth
    coefficient field, random cosr and multipoles."""
    rng = np.random.default_rng(3)
    g = make_grid(sz, 3)
    m = 1 << level
    sig = 8 * (1 - np.cos(2 * np.pi * g.nodes_x)) + 0.2

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt).to(device)

    Wo = build_m2l_offsets_fine(g, tree_config(sz), level, 4, dtype, "cpu")
    return (Wo["Wo"].to(device), t(project_field(g, sig)),
            t(rng.standard_normal((4, 16, 432))),
            t(rng.standard_normal((m, m, 16))),
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


@pytest.mark.parametrize("kernel", [m2l, near, offsets])
def test_kernel_load_raises_without_cuda(no_cuda, kernel):
    with pytest.raises(RuntimeError):
        _cuda.load(kernel.SOURCE, kernel.SYMBOLS["f64"], ())


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
@pytest.mark.parametrize("sz,level", [(16, 3), (16, 4), (32, 5)])
def test_offsets_kernel_matches_plain_on_card(cuda_device, dtype, sz, level):
    """K3 against its plain version at fine levels where mirror slices are
    empty or partial (m2 = 4, 8, 16).  Its atomic sums change order from
    run to run, which the gates cover (27 terms per output)."""
    args = _k3_inputs(cuda_device, dtype, sz, level)
    inst = _cuda.INSTANCES[dtype]
    n0 = offsets.launches[inst]
    got = offsets.offsets_translate(*args)
    want = offsets.offsets_translate_plain(*args)
    assert offsets.launches[inst] == n0 + 1
    assert float((got - want).abs().max()) <= \
        _GATE[dtype] * float(want.abs().max())
