"""K9d: the 5-point finite-volume diffusion apply of the DSA preconditioner.

Replaces the stencil of aniso_tpu/solver/dsa.py:make_diffusion_apply
(:85-99), one fused program inside the JAX CG's while_loop.  The CUDA kernel
is csrc/diffusion_apply.cu; its header states the bound (bytes: six fields
of sz^2 values) and the design (one thread per cell).

    out = sigma_a z + sum over the cell's interior faces of
          D_face (z - z_neighbour) / dx^2
        + robin z / dx on each side of the domain the cell touches

Layouts: z, robin, sigma_a, out (sz, sz); Dx (sz-1, sz) couples (i, j) with
(i+1, j); Dy (sz, sz-1) couples (i, j) with (i, j+1).

diffusion_apply takes diffusion_apply_plain for CPU tensors and launches the
kernel for CUDA tensors (float32 or float64, by z's dtype); `launches`
counts kernel launches per instance.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

SOURCE = "diffusion_apply.cu"
SYMBOLS = {"f32": "aniso_diffusion_apply_f32",
           "f64": "aniso_diffusion_apply_f64"}
_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_double,
                                       ctypes.c_double, ctypes.c_void_p))

launches = {"f32": 0, "f64": 0}


def diffusion_apply_plain(z, Dx, Dy, robin, sigma_a, dx: float):
    """The JAX math step by step: absorption, the interior face fluxes
    added to one cell and taken from the other, the Marshak outflux on the
    four sides."""
    inv_dx2 = 1.0 / (dx * dx)
    inv_dx = 1.0 / dx
    out = sigma_a * z
    fx = Dx * (z[:-1, :] - z[1:, :]) * inv_dx2       # flux from i to i+1
    out[:-1, :] += fx
    out[1:, :] -= fx
    fy = Dy * (z[:, :-1] - z[:, 1:]) * inv_dx2
    out[:, :-1] += fy
    out[:, 1:] -= fy
    out[0, :] += robin[0, :] * z[0, :] * inv_dx
    out[-1, :] += robin[-1, :] * z[-1, :] * inv_dx
    out[:, 0] += robin[:, 0] * z[:, 0] * inv_dx
    out[:, -1] += robin[:, -1] * z[:, -1] * inv_dx
    return out


def diffusion_apply(z, Dx, Dy, robin, sigma_a, dx: float) -> torch.Tensor:
    if z.device.type == "cpu":
        return diffusion_apply_plain(z, Dx, Dy, robin, sigma_a, dx)
    inst = _cuda.instance("z", z)
    sz = z.shape[0]
    dt = z.dtype
    _cuda.check("z", z, (sz, sz), dt)
    _cuda.check("Dx", Dx, (sz - 1, sz), dt)
    _cuda.check("Dy", Dy, (sz, sz - 1), dt)
    _cuda.check("robin", robin, (sz, sz), dt)
    _cuda.check("sigma_a", sigma_a, (sz, sz), dt)
    symbol = SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
    out = torch.empty_like(z)
    rc = fn(_cuda.ptr(z), _cuda.ptr(Dx), _cuda.ptr(Dy), _cuda.ptr(robin),
            _cuda.ptr(sigma_a), _cuda.ptr(out), sz, 1.0 / (dx * dx), 1.0 / dx,
            _cuda.stream(z.device))
    _cuda.raise_on_error(symbol, rc)
    launches[inst] += 1
    return out
