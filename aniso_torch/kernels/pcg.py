"""K9: the Jacobi-preconditioned CG of the DSA preconditioner, the whole
loop in one kernel launch.

Replaces aniso_tpu/solver/dsa.py:pcg (:114-141), which the JAX package runs
as one lax.while_loop on the device with its stopping test there too, with
the diffusion stencil (K9d, kernels.diffusion) inside.  The CUDA kernel is
csrc/pcg.cu; its header states the bound (bytes: p and the blocks' partial
sums an iteration; in practice the latency of its grid barriers) and the
design (one cooperative launch, the state in registers, deterministic grid
sums that every block takes alike).

    A z = sigma_a z - div(D grad z)   (the 5-point stencil of K9d)
    x = 0, r = b, z = r / diag, p = z
    while k < max_iter and r.r > tol^2 b.b (b.b taken as 1 where it is 0):
        alpha = r.z / p.Ap; x += alpha p; r -= alpha Ap; z = r / diag
        p = z + (r.z new / r.z) p

Layouts: b, diag, robin, sigma_a (sz, sz); Dx (sz-1, sz); Dy (sz, sz-1).

pcg takes pcg_plain for CPU tensors and launches the kernel for CUDA
tensors (float32 or float64, by b's dtype); it returns (x, k), k a Python
int from pcg_plain and a 0-d int32 tensor on the card from the kernel
(nothing is read back inside the call).  A grid the card cannot hold at
once in one cooperative launch raises.  `launches` counts kernel launches
per instance.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda
from .diffusion import diffusion_apply_plain

SOURCE = "pcg.cu"
SYMBOLS = {"f32": "aniso_pcg_f32", "f64": "aniso_pcg_f64"}
BARRIER_SYMBOLS = {"f32": "aniso_pcg_barriers_f32",
                   "f64": "aniso_pcg_barriers_f64"}
_ARGTYPES = ((ctypes.c_void_p,) * 9 + (ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_double,
                                       ctypes.c_double, ctypes.c_double,
                                       ctypes.c_int, ctypes.c_void_p))
_BARRIER_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p)
THREADS = 512                   # the kernel's block (kThreads in pcg.cu)

launches = {"f32": 0, "f64": 0}


class PcgResult(NamedTuple):
    x: torch.Tensor
    iterations: int | torch.Tensor


def pcg_plain(b, diag, Dx, Dy, robin, sigma_a, dx: float, *,
              tol: float = 1e-8, max_iter: int = 500) -> PcgResult:
    """The JAX loop step by step, with the stencil's plain version and one
    scalar read back per iteration for the stopping test."""
    inv_diag = 1.0 / diag
    bnorm2 = float((b * b).sum())
    bnorm2 = 1.0 if bnorm2 == 0.0 else bnorm2
    stop = tol * tol * bnorm2

    x = torch.zeros_like(b)
    r = b
    z = inv_diag * r
    p = z
    rz = (r * z).sum()
    k = 0
    while k < max_iter and float((r * r).sum()) > stop:
        ap = diffusion_apply_plain(p, Dx, Dy, robin, sigma_a, dx)
        alpha = rz / (p * ap).sum()
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = (r * z).sum()
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return PcgResult(x, k)


def _partials(n: int) -> int:
    """Values of the blocks' partial sums: three per block, at most one
    block per THREADS cells."""
    return 3 * -(-n // THREADS)


def pcg(b, diag, Dx, Dy, robin, sigma_a, dx: float, *, tol: float = 1e-8,
        max_iter: int = 500) -> PcgResult:
    if b.device.type == "cpu":
        return pcg_plain(b, diag, Dx, Dy, robin, sigma_a, dx, tol=tol,
                         max_iter=max_iter)
    inst = _cuda.instance("b", b)
    sz = b.shape[0]
    dt = b.dtype
    _cuda.check_all(dt, ("b", b, (sz, sz)), ("diag", diag, (sz, sz)),
                    ("Dx", Dx, (sz - 1, sz)), ("Dy", Dy, (sz, sz - 1)),
                    ("robin", robin, (sz, sz)),
                    ("sigma_a", sigma_a, (sz, sz)))
    symbol = SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
    x = torch.empty_like(b)
    p = torch.empty_like(b)
    part = torch.empty(_partials(sz * sz), dtype=dt, device=b.device)
    k = torch.empty((), dtype=torch.int32, device=b.device)
    rc = fn(_cuda.ptr(Dx), _cuda.ptr(Dy), _cuda.ptr(robin),
            _cuda.ptr(sigma_a), _cuda.ptr(diag), _cuda.ptr(b), _cuda.ptr(x),
            _cuda.ptr(p), _cuda.ptr(part), part.numel(), _cuda.ptr(k), sz,
            1.0 / (dx * dx), 1.0 / dx, tol * tol, max_iter,
            _cuda.stream(b.device))
    _cuda.raise_on_error(symbol, rc)
    launches[inst] += 1
    return PcgResult(x, k)


def barrier_loop(n: int, iters: int, dtype, device) -> None:
    """K9's loop skeleton alone (its block sums, grid sums and three grid
    barriers an iteration, no stencil or vector update) for `iters`
    iterations on the grid K9 takes for n cells: its time is the loop's
    latency floor.  Not K9: it counts no launch."""
    inst = _cuda.INSTANCES[dtype]
    symbol = BARRIER_SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _BARRIER_ARGTYPES)
    part = torch.empty(_partials(n), dtype=dtype, device=device)
    rc = fn(_cuda.ptr(part), part.numel(), n, iters,
            _cuda.stream(torch.device(device)))
    _cuda.raise_on_error(symbol, rc)
