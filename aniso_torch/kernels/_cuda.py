"""Loading and calling the port's CUDA kernels (plain C interface, ctypes).

Every kernel wrapper in this package follows one rule: a tensor on the CPU
takes the kernel's plain PyTorch version; a CUDA tensor launches the kernel
or raises (wrong dtype, layout or shape, no CUDA, a failed build, a refused
launch).  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build


@functools.lru_cache(maxsize=None)
def load(source: str, symbol: str, argtypes: tuple):
    """The C entry `symbol` of the library built from csrc/`source`, which
    returns the cudaError_t of its launch."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{symbol}: CUDA is not available")
    path = _build.build([source])[source]
    fn = getattr(ctypes.CDLL(path), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: None means the GPU, and CUDA must then
    be present.  The CPU runs only when asked for by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


# kernel instances by the scalar type they take
INSTANCES = {torch.float32: "f32", torch.float64: "f64"}


def instance(name: str, t: torch.Tensor) -> str:
    """"f32" or "f64": the instance of a kernel template that takes t's
    dtype; any other dtype raises."""
    try:
        return INSTANCES[t.dtype]
    except KeyError:
        raise TypeError(
            f"{name}: the kernel takes float32 or float64, got {t.dtype}"
        ) from None


def _check_layout(name: str, t: torch.Tensor, shape: tuple, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_device(name: str, t: torch.Tensor):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")


def check(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32):
    """Raise unless t is a contiguous CUDA tensor of `shape` and `dtype`
    (TypeError for the dtype, ValueError for the rest)."""
    _check_layout(name, t, shape, dtype)
    _check_device(name, t)


def check_all(dtype, *specs):
    """check() of every (name, tensor, shape) in specs, the dtypes, shapes
    and layouts of all before any device."""
    for name, t, shape in specs:
        _check_layout(name, t, shape, dtype)
    for name, t, _ in specs:
        _check_device(name, t)


def check_aligned(**tensors):
    """Raise ValueError unless every tensor starts on 16 bytes: the
    kernels that take them copy from 16-byte boundaries."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel takes a 16-byte aligned "
                             f"{name}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(symbol: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc} at launch")
