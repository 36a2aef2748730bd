"""K1: the fused dense M2L translate of one FMM level.

Replaces aniso_tpu/fmm/apply.py:_m2l_translate, dense branch (:317-372),
with its producer _vlist_gather (:158) and _interleave_classes (:230).  The
CUDA kernel is csrc/m2l_translate.cu; its header states the bound (bytes:
E is read once, 150.8 MB per matvec at 64^2) and the design.

    L[2x+px, 2y+py, a] = sum_{o,b} exp(-E[c,x,y,a,o,b]) * cosr[c,a,o,b]
                                   * M[2(x+shx)+sx, 2(y+shy)+sy, b]

with c = 2px+py, (sx, sy, shx+1, shy+1) = shift[c, o] and the source zero
off the (m2, m2) parity plane.

Layouts (the port's own, contiguous, no padding):
    E      (4, m2, m2, r, 27r)   one per level, coarse and fine alike
    cosr   (4, r, 27r)           cos(m theta)/r per class, (a, o, b)
    M      (2m2, 2m2, r)         the level's multipoles
    shift  (4, 27, 4) int32      parity_shift_table_np
returns L (2m2, 2m2, r).

m2l_translate takes m2l_translate_plain for CPU tensors and launches the
kernel for CUDA tensors (float32 only); `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

SOURCE = "m2l_translate.cu"
SYMBOL = "aniso_m2l_translate_f32"
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)

launches = 0


def vlist_gather(M: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(4, m2, m2, 27, r): per target class c and box, the 27 V-list source
    multipoles, zero off the parity plane (aniso_tpu _vlist_gather)."""
    m, r = M.shape[0], M.shape[-1]
    m2 = m // 2
    P4 = M.reshape(m2, 2, m2, 2, r)
    pad = M.new_zeros((2, 2, m2 + 2, m2 + 2, r))
    pad[:, :, 1:-1, 1:-1] = P4.permute(1, 3, 0, 2, 4)
    tab = shift.tolist()
    return torch.stack([
        torch.stack([
            pad[sx, sy, ax:ax + m2, ay:ay + m2]
            for (sx, sy, ax, ay) in tab[c]
        ], dim=2)
        for c in range(4)
    ])


def m2l_translate_plain(E, cosr, M, shift) -> torch.Tensor:
    """The JAX math step by step: gather, exp(-E) * cosr * gsel summed over
    (o, b), interleave the 4 classes."""
    _, m2, _, r, ob = E.shape
    g = vlist_gather(M, shift).reshape(4, m2, m2, 1, ob)
    T = (torch.exp(-E) * cosr[:, None, None] * g).sum(-1)   # (4, m2, m2, r)
    return (
        T.reshape(2, 2, m2, m2, r).permute(2, 0, 3, 1, 4)
        .reshape(2 * m2, 2 * m2, r)
    )


def m2l_translate(E, cosr, M, shift) -> torch.Tensor:
    global launches
    if E.device.type == "cpu":
        return m2l_translate_plain(E, cosr, M, shift)
    _, m2, _, r, ob = E.shape
    if ob != 27 * r:
        raise ValueError(f"E: last dim {ob}, expected 27 r = {27 * r}")
    _cuda.check("E", E, (4, m2, m2, r, ob))
    _cuda.check("cosr", cosr, (4, r, ob))
    _cuda.check("M", M, (2 * m2, 2 * m2, r))
    _cuda.check("shift", shift, (4, 27, 4), torch.int32)
    if ob * 4 > 48 * 1024:
        raise ValueError(f"r = {r}: the gathered multipoles exceed 48 KB")
    fn = _cuda.load(SOURCE, SYMBOL, _ARGTYPES)
    L = torch.empty_like(M)
    rc = fn(_cuda.ptr(E), _cuda.ptr(cosr), _cuda.ptr(M), _cuda.ptr(shift),
            _cuda.ptr(L), m2, r, _cuda.stream(E.device))
    _cuda.raise_on_error(SYMBOL, rc)
    launches += 1
    return L
