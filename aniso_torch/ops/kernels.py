"""Fourier-mode transport kernels (torch).

Counterpart of aniso_tpu/ops/kernels.py (reference KernelFactory.cpp:240-267
`makeKernels`): for mode m,

  real_m(a, b)   = cos(m * theta) / r                  (0 at r = 0)
  smooth_m(a, b) = (exp(-E(a,b)) - 1) cos(m * theta) / r
                   (at r = 0: sigma_t(a) for m = 0, else 0)

with r = |a - b|, theta = atan2(a - b).  Shape-polymorphic torch
expressions; they compute in the dtype of their inputs.
"""

from __future__ import annotations

import torch


def cos_m_theta(m: int, dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """cos(m * atan2(dy, dx)) without trig, via the Chebyshev recurrence
    cos(m theta) = T_m(dx / r).  Ones for m = 0; callers mask r = 0."""
    if m == 0:
        return torch.ones_like(dx)
    r = torch.sqrt(dx * dx + dy * dy)
    c = dx / torch.where(r == 0.0, torch.ones_like(r), r)
    if m == 1:
        return c
    t_prev, t = torch.ones_like(c), c
    for _ in range(2, m + 1):
        t_prev, t = t, 2.0 * c * t - t_prev
    return t


def real_kernel(m: int, ax, ay, bx, by) -> torch.Tensor:
    """cos(m theta)/r with 0 on the diagonal (KernelFactory.cpp:243-253)."""
    dx = ax - bx
    dy = ay - by
    r = torch.sqrt(dx * dx + dy * dy)
    safe = torch.where(r == 0.0, torch.ones_like(r), r)
    return torch.where(r == 0.0, torch.zeros_like(r),
                       cos_m_theta(m, dx, dy) / safe)


def smooth_kernel_from_E(m: int, ax, ay, bx, by, E, diag_sigma=None):
    """(exp(-E)-1) cos(m theta)/r given E (KernelFactory.cpp:255-265).

    diag_sigma: sigma_t at `a`, used on the diagonal for m = 0 (reference
    `evaluate(a)`); None when no pair coincides."""
    dx = ax - bx
    dy = ay - by
    r = torch.sqrt(dx * dx + dy * dy)
    safe = torch.where(r == 0.0, torch.ones_like(r), r)
    val = torch.expm1(-E) * cos_m_theta(m, dx, dy) / safe
    if m == 0 and diag_sigma is not None:
        return torch.where(r == 0.0, diag_sigma, val)
    return torch.where(r == 0.0, torch.zeros_like(val), val)


def anisotropy_weights(g: float, n_modes: int,
                       dtype=torch.float64) -> torch.Tensor:
    """chi_i = (g^i - g^N) / (1 - g^N), i = 0..N-1 (KernelFactory.cpp:18-20);
    at g = 0 only chi_0 = 1."""
    i = torch.arange(n_modes, dtype=dtype)
    if g == 0.0:
        return torch.where(i == 0, 1.0, 0.0).to(dtype)
    gN = g ** n_modes
    return (g ** i - gN) / (1.0 - gN)
