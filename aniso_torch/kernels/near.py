"""K2: the near-field contraction of the corrected FMM matvec.

Replaces aniso_tpu/fmm/apply.py:_near_block_contract (:577) with the rest of
_near_apply (:639-681) and _patch_3x3 (:554).  The CUDA kernel is
csrc/near_contract.cu; its header states the bound (bytes: E is read once,
11.9 MB per matvec at 64^2) and the design.

    out[i,j,t] = sum_{a,b,s} (expm1(-E[i,j,t,a,b,s]) * cosrw[t,a,b,s]
                              + S[t,a,b,s]) * u[i+a-1, j+b-1, s]
               + sigma_w[i,j,t] * u[i,j,t]          (mode 0; else None)
               + sum_s duffy[i,j,t,s] * u[i,j,s]    (compat mode; else None)

with u zero off the grid.  Layouts (the port's own, square major):
    E       (sz, sz, nq, 3, 3, nq)
    cosrw   (nq, 3, 3, nq)   cos(m theta)/r * w_src, 0 at r = 0
    S       (nq, 3, 3, nq)   refined + Duffy correction stencil (ops.near)
    u, sigma_w, out (sz, sz, nq);  duffy (sz, sz, nq, nq)

near_contract takes near_contract_plain for CPU tensors and launches the
kernel for CUDA tensors (float32 only); `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.windows import patch_3x3
from . import _cuda

SOURCE = "near_contract.cu"
SYMBOL = "aniso_near_contract_f32"
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

launches = 0


def near_contract_plain(E, cosrw, S, u, sigma_w=None, duffy=None):
    """The JAX math step by step (block, 3x3 windows, einsum, then the
    diagonal and Duffy terms)."""
    block = torch.expm1(-E) * cosrw + S                  # (sz, sz, t, a, b, s)
    out = torch.einsum("ijtabs,ijabs->ijt", block, patch_3x3(u))
    if sigma_w is not None:
        out = out + sigma_w * u
    if duffy is not None:
        out = out + torch.einsum("ijts,ijs->ijt", duffy, u)
    return out


def near_contract(E, cosrw, S, u, sigma_w=None, duffy=None) -> torch.Tensor:
    global launches
    if E.device.type == "cpu":
        return near_contract_plain(E, cosrw, S, u, sigma_w, duffy)
    sz, _, nq = u.shape
    _cuda.check("E", E, (sz, sz, nq, 3, 3, nq))
    _cuda.check("cosrw", cosrw, (nq, 3, 3, nq))
    _cuda.check("S", S, (nq, 3, 3, nq))
    _cuda.check("u", u, (sz, sz, nq))
    if sigma_w is not None:
        _cuda.check("sigma_w", sigma_w, (sz, sz, nq))
    if duffy is not None:
        _cuda.check("duffy", duffy, (sz, sz, nq, nq))
    fn = _cuda.load(SOURCE, SYMBOL, _ARGTYPES)
    out = torch.empty_like(u)
    rc = fn(_cuda.ptr(E), _cuda.ptr(cosrw), _cuda.ptr(S), _cuda.ptr(u),
            _cuda.ptr(sigma_w), _cuda.ptr(duffy), _cuda.ptr(out), sz, nq,
            _cuda.stream(E.device))
    _cuda.raise_on_error(SYMBOL, rc)
    launches += 1
    return out
