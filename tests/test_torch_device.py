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
from aniso_torch.kernels import _cuda, m2l, near
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
        "import aniso_torch.kernels.near, chip_smoke\n"
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


@pytest.mark.parametrize("kernel", ["m2l", "near"])
def test_wrappers_raise_on_tensors_off_the_cpu_without_a_kernel(kernel):
    """A tensor that is neither on the CPU nor a launchable CUDA tensor
    (here on the meta device) is refused, never computed by the plain
    version."""
    if kernel == "m2l":
        with pytest.raises(ValueError):
            m2l.m2l_translate(*_k1_inputs("meta"))
    else:
        with pytest.raises(ValueError):
            near.near_contract(*_k2_inputs("meta"))


def test_kernel_load_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError):
        _cuda.load(m2l.SOURCE, m2l.SYMBOL, ())


def test_cuda_build_raises_without_nvcc(monkeypatch, tmp_path):
    if shutil.which("nvcc"):
        pytest.skip("nvcc is on PATH")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    with pytest.raises(RuntimeError):
        _build.build([m2l.SOURCE])


@pytest.mark.cuda
def test_m2l_kernel_matches_plain_on_card(cuda_device):
    args = _k1_inputs(cuda_device, m2=8)
    n0 = m2l.launches
    got = m2l.m2l_translate(*args)
    want = m2l.m2l_translate_plain(*args)
    assert m2l.launches == n0 + 1
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    with pytest.raises(TypeError):
        m2l.m2l_translate(*[a.double() if a.is_floating_point() else a
                            for a in args])


@pytest.mark.cuda
def test_near_kernel_matches_plain_on_card(cuda_device):
    args = _k2_inputs(cuda_device, sz=16)
    for sigma_w, duffy in ((args[4], None), (args[4], args[5]),
                           (None, None)):
        n0 = near.launches
        got = near.near_contract(*args[:4], sigma_w, duffy)
        want = near.near_contract_plain(*args[:4], sigma_w, duffy)
        assert near.launches == n0 + 1
        assert float((got - want).abs().max()) <= \
            1e-5 * float(want.abs().max())
