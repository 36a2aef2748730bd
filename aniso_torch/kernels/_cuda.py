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


def check(name: str, t: torch.Tensor, shape: tuple, dtype=torch.float32):
    """Raise unless t is a contiguous CUDA tensor of `shape` and `dtype`."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on_error(symbol: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc} at launch")
