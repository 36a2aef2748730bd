"""Application of the 3x3 near-field stencil (torch).

Counterpart of aniso_tpu/ops/stencil.py, which runs it as one XLA
convolution:

  out[x, y, kt] = sum_{a, b, ks} stencil[a, b, kt, ks] * u[x-1+a, y-1+b, ks]

with zero boundary (squares outside the domain contribute nothing,
KernelFactory.cpp:462-463).  Here an einsum over the zero-padded 3x3
windows (ops.windows.patch_3x3), so no convolution algorithm (and no TF32)
is involved.
"""

from __future__ import annotations

import torch

from .windows import patch_3x3


def apply_near_stencil(stencil: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """stencil: (3, 3, nq, nq) [a, b, kt, ks]; u: (sz, sz, nq) -> (sz, sz, nq)."""
    return torch.einsum("ijabs,abts->ijt", patch_3x3(u), stencil)


def apply_per_square(mats: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-square (sz, sz, nq, nq) block-diagonal application (compat Duffy)."""
    return torch.einsum("ijts,ijs->ijt", mats, u)
