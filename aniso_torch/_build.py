"""Build the port's native libraries from the sources in aniso_torch/csrc.

Two kinds, both with a plain C interface loaded by ctypes:

  * CUDA kernels (K1 and K1-S m2l_translate.cu, K2 and K2-S
    near_contract.cu, K3 offsets_translate.cu, K9d diffusion_apply.cu, K9
    pcg.cu, K10 halo_fill.cu, K11 and K11-S krylov.cu, K8 (the up pass, L2L and
    L2T) transfer.cu, each with a float32 and a float64 entry, and K12
    krylov.cu, float64; K7
    line_integral.cu, float64 arithmetic, its dense matrices stored in
    float64 or float32): one nvcc
    per source, ``-gencode arch=compute_90a,code=sm_90a -O3 -shared``, no fast
    math (E feeds exp/expm1; ``--use_fast_math`` would turn them into the
    approximate intrinsics and expm1 of a small E into exp - 1);
  * the host engine (aniso_host.cpp): g++ -O3 -fopenmp.

Libraries go into aniso_torch/_build/ (listed in .gitignore) at first use,
each with its compiler output beside it (lib*.so.log: ptxas's registers and
spills), and are rebuilt when their source (or, for a .cu, a .cuh header in
csrc) is newer.  A build writes a private file
and renames it into place, so concurrent processes never load a
half-written library.  A missing compiler or a failed build raises; nothing
falls back.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

CUDA_SOURCES = ("m2l_translate.cu", "near_contract.cu",
                "offsets_translate.cu", "diffusion_apply.cu", "pcg.cu",
                "line_integral.cu", "halo_fill.cu", "krylov.cu",
                "transfer.cu")
HOST_SOURCE = "aniso_host.cpp"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-O3", "-fopenmp", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
# compiler output (ptxas -v for the CUDA sources) of each library built or
# found up to date by this process, by source name; kept beside the library
build_logs: dict = {}


def lib_path(source: str) -> str:
    return os.path.join(BUILD_DIR, "lib" + os.path.splitext(source)[0] + ".so")


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA toolkit PyTorch would use."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels cannot "
        "be built"
    )


def _compile(source: str) -> str:
    src = os.path.join(CSRC, source)
    out = lib_path(source)
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in os.listdir(CSRC)
                 if f == source
                 or (source.endswith(".cu") and f.endswith(".cuh")))
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        if os.path.exists(out + ".log"):      # the build's compiler output
            with open(out + ".log") as f:
                build_logs[source] = f.read()
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    if source.endswith(".cu"):
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    else:
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the host engine cannot be built")
        cmd = [gxx, *GXX_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"building {source} failed ({proc.returncode}):\n{proc.stderr}"
        )
    build_logs[source] = proc.stdout + proc.stderr
    with open(f"{tmp}.log", "w") as f:
        f.write(build_logs[source])
    os.replace(f"{tmp}.log", out + ".log")
    os.replace(tmp, out)
    return out


def build(sources) -> dict:
    """Build every source in parallel (one compiler process each); returns
    {source: library path}.  Raises on the first failure."""
    sources = list(sources)
    with _lock, ThreadPoolExecutor(max_workers=max(1, len(sources))) as ex:
        futures = {s: ex.submit(_compile, s) for s in sources}
        return {s: f.result() for s, f in futures.items()}


def build_all() -> dict:
    """Every library the port's main path needs (what chip_smoke.py times)."""
    return build(CUDA_SOURCES + (HOST_SOURCE,))
