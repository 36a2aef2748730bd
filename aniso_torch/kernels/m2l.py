"""K1: the fused dense M2L translate of one FMM level, for one Fourier
mode or for all D modes of one charge.

Replaces aniso_tpu/fmm/apply.py:_m2l_translate, dense branch (:317-372),
with its producer _vlist_gather (:158) and _interleave_classes (:230), and
the per-mode loop around it in fmm_apply_all_modes (:745-750).  The CUDA
kernel is csrc/m2l_translate.cu; its header states the bound (bytes: E is
read once per charge whatever D is, 150.8 MB at 64^2) and the design.  The
all-modes kernel (D > 1) is built for r = np^2 with np 2-5, and np 6-7 in
float32 (MODES_R).

    L[d, 2x+px, 2y+py, a] = sum_{o,b} exp(-E[c,x,y,a,o,b]) * cosr[d,c,a,o,b]
                                      * M[2(x+shx)+sx, 2(y+shy)+sy, b]

with c = 2px+py, (sx, sy, shx+1, shy+1) = shift[c, o] and the source zero
off the (m2, m2) parity plane.

Layouts (the port's own, contiguous, no padding):
    E      (4, m2, m2, r, 27r)   one per level, coarse and fine alike
    cosr   (D, 4, r, 27r)        cos(d theta)/r per mode and class, (a, o, b)
    M      (2m2, 2m2, r)         the level's multipoles
    shift  (4, 27, 4) int32      parity_shift_table_np
returns L (D, 2m2, 2m2, r).  A cosr without the mode axis, (4, r, 27r), is
one mode and returns L (2m2, 2m2, r).

m2l_translate takes m2l_translate_plain for CPU tensors and launches the
kernel for CUDA tensors: the float32 instance or the float64 one (the
refinement twin's coarse levels and the plain f64 solve), by E's dtype;
`launches` counts kernel launches per instance.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

SOURCE = "m2l_translate.cu"
SYMBOLS = {"f32": "aniso_m2l_translate_f32", "f64": "aniso_m2l_translate_f64"}
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)

launches = {"f32": 0, "f64": 0}

# the r the all-modes kernel is built for, per instance
MODES_R = {"f32": (4, 9, 16, 25, 36, 49), "f64": (4, 9, 16, 25)}


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
    (o, b) for each mode, interleave the 4 classes."""
    if cosr.dim() == 3:
        return m2l_translate_plain(E, cosr[None], M, shift)[0]
    D = cosr.shape[0]
    _, m2, _, r, ob = E.shape
    g = vlist_gather(M, shift).reshape(4, m2, m2, 1, ob)
    X = torch.exp(-E)
    T = torch.stack([(X * cosr[d, :, None, None] * g).sum(-1)
                     for d in range(D)])                 # (D, 4, m2, m2, r)
    return (
        T.reshape(D, 2, 2, m2, m2, r).permute(0, 3, 1, 4, 2, 5)
        .reshape(D, 2 * m2, 2 * m2, r)
    )


def m2l_translate(E, cosr, M, shift) -> torch.Tensor:
    if cosr.dim() == 3:
        return m2l_translate(E, cosr[None], M, shift)[0]
    if E.device.type == "cpu":
        return m2l_translate_plain(E, cosr, M, shift)
    inst = _cuda.instance("E", E)
    _, m2, _, r, ob = E.shape
    D = cosr.shape[0]
    if ob != 27 * r:
        raise ValueError(f"E: last dim {ob}, expected 27 r = {27 * r}")
    _cuda.check("E", E, (4, m2, m2, r, ob), E.dtype)
    _cuda.check("cosr", cosr, (D, 4, r, ob), E.dtype)
    _cuda.check("M", M, (2 * m2, 2 * m2, r), E.dtype)
    _cuda.check("shift", shift, (4, 27, 4), torch.int32)
    # shared memory: one box's multipoles (one mode)
    if D == 1 and ob * E.element_size() > 48 * 1024:
        raise ValueError(f"r = {r}: a row of 27 r values exceeds 48 KB")
    if D > 1 and r not in MODES_R[inst]:
        raise ValueError(f"r = {r}: the all-modes {inst} kernel takes r in "
                         f"{MODES_R[inst]}")
    symbol = SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
    L = torch.empty((D,) + tuple(M.shape), dtype=M.dtype, device=M.device)
    rc = fn(_cuda.ptr(E), _cuda.ptr(cosr), _cuda.ptr(M), _cuda.ptr(shift),
            _cuda.ptr(L), m2, r, D, _cuda.stream(E.device))
    _cuda.raise_on_error(symbol, rc)
    launches[inst] += 1
    return L
