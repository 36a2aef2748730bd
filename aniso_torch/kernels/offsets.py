"""K3: the per-offset M2L translate of one fine FMM level, for one Fourier
mode or for all D modes of one charge.

Replaces aniso_tpu/fmm/apply.py:_offsets_translate_impl (:440-521), which
the JAX package runs through _m2l_translate_offsets (:436, one mode) and
_m2l_translate_offsets_multi (:427, all modes) for every fine level of the
f64 refinement twin and for f32 fine levels that the dense budget evicts.
The CUDA kernel is csrc/offsets_translate.cu; its
header states the bound (operations: 120.8 GFLOP of window GEMM per level
at 512^2, on the FP64 tensor cores) and the design.

A per-offset level stores no E.  For each canonical (class, offset) entry
of _fine_offset_entries it re-forms the (m2, m2, r, r) block as a GEMM of
B-granular coefficient windows against the static weight block Wo, takes
X = exp(-E) once, and uses it, for every mode, for the direct contraction
into class c and, transposed, for the mirror contraction into class c2 on
the shifted box plane (E(a->b) = E(b->a), coarse_mirror_table).

Layouts (the port's own, contiguous):
    Wo      flat: per distinct offset (di, dj) in _fine_offset_entries' key
            order, a (K, r*r) block, K = bbx*bby*nq in (a, b, q) cell order,
            bbx = (|di|+1) B, bby = (|dj|+1) B, grid.dx folded in
    coeffs  (sz, sz, nq)       the sigma_t Legendre coefficient field
    cosr    (D, 4, r, 27r)     cos(d theta)/r per mode and class, as K1's
    M       (2m2, 2m2, r)      the level's multipoles
    shift   (4, 27, 4) int32   parity_shift_table_np
returns L (D, 2m2, 2m2, r), the interleaved locals K1 returns.  A cosr
without the mode axis, (4, r, 27r), is one mode and returns L (2m2, 2m2, r).
The kernel adds into a class-major scratch (D, 4, m2, r, m2), boxes along
y last, so that a warp's atomic adds are contiguous; interleave_class_major
turns it into L.  The kernel is built for r = np^2 with np 2-7; any other r
runs in its runtime-r instance, up to the r whose row of 27 r values fits
48 KB (as K1): np 15 in float64, 21 in float32.

offsets_translate takes offsets_translate_plain for CPU tensors and launches
the kernel for CUDA tensors (float32 or float64); `launches` counts kernel
launches per instance.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..fmm.smooth import _fine_offset_entries, box_windows, pad_coeffs
from . import _cuda
from .m2l import vlist_gather

SOURCE = "offsets_translate.cu"
SYMBOLS = {"f32": "aniso_offsets_translate_f32",
           "f64": "aniso_offsets_translate_f64"}
_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_void_p)
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))

launches = {"f32": 0, "f64": 0}


@functools.lru_cache(maxsize=None)
def offset_plan_np(np_cheb: int, B: int, nq: int) -> np.ndarray:
    """(54, 12) int32: per canonical entry (c, o, px, py, di, dj, c2, o2,
    sx, sy, woff, K) with the mirror partner (c2, o2) and its box-plane
    shift (sx, sy), and the entry's weight block at Wo[woff : woff + K r^2]
    as (K, r^2)."""
    entries, keys, mirrors = _fine_offset_entries(np_cheb)
    r2 = (np_cheb * np_cheb) ** 2
    sizes = [(abs(di) + 1) * (abs(dj) + 1) * B * B * nq for (di, dj) in keys]
    woff = np.concatenate([[0], np.cumsum(sizes)]) * r2
    rows = [
        (c, o, px, py, di, dj, *mirrors[(c, o)], woff[ki], sizes[ki])
        for (c, o, px, py, di, dj, ki) in entries
    ]
    return np.asarray(rows, dtype=np.int32)


def wo_numel(np_cheb: int, B: int, nq: int) -> int:
    plan = offset_plan_np(np_cheb, B, nq)
    return int(max(plan[:, 10].astype(np.int64)
                   + plan[:, 11].astype(np.int64) * (np_cheb ** 4)))


def translate_flops(np_cheb: int, B: int, nq: int, m2: int,
                    D: int = 1) -> int:
    """Operations of one call: the window GEMM (2 m2^2 r^2 K per entry,
    once for all modes) and the two contractions (per pair, one multiply by
    the source multipole for all modes, then a multiply by cosr and an add
    per mode, each); exponentials not counted."""
    plan = offset_plan_np(np_cheb, B, nq)
    r2 = np_cheb ** 4
    return int(2 * m2 * m2 * r2 * plan[:, 11].astype(np.int64).sum()
               + (2 + 4 * D) * m2 * m2 * r2 * len(plan))


def offsets_translate_plain(Wo, coeffs, cosr, M, shift) -> torch.Tensor:
    """The JAX math step by step: per canonical entry, windows @ Wo, one
    exp, then per mode the direct add into class c and the transposed
    mirror add into class c2 on the on-plane slice; last, interleave the 4
    classes."""
    if cosr.dim() == 3:
        return offsets_translate_plain(Wo, coeffs, cosr[None], M, shift)[0]
    D = cosr.shape[0]
    m, r = M.shape[0], M.shape[-1]
    m2 = m // 2
    sz, nq = coeffs.shape[0], coeffs.shape[-1]
    B = sz // m
    plan = offset_plan_np(math.isqrt(r), B, nq)
    pad = pad_coeffs(coeffs, B)
    g = vlist_gather(M, shift).reshape(4, m2, m2, 27, r)
    cos4 = cosr.reshape(D, 4, r, 27, r)
    T = M.new_zeros((D, 4, m2, m2, r))
    for (c, o, px, py, di, dj, c2, o2, sx, sy, woff, K) in plan.tolist():
        win = box_windows(pad, B, m2, px, py, di, dj)       # (m2, m2, K)
        W = Wo[woff:woff + K * r * r].reshape(K, r * r)
        E = (win.reshape(m2 * m2, K) @ W).reshape(m2, m2, r, r)
        X = torch.exp(-E)
        xd = slice(max(0, sx), m2 + min(0, sx))
        yd = slice(max(0, sy), m2 + min(0, sy))
        xs = slice(max(0, -sx), m2 + min(0, -sx))
        ys = slice(max(0, -sy), m2 + min(0, -sy))
        XT = X.transpose(2, 3)[xs, ys]                      # (b, a)
        for d in range(D):
            T[d, c] += (X * cos4[d, c, :, o, :]
                        * g[c, :, :, None, o, :]).sum(-1)
            T[d, c2, xd, yd] += (
                XT * cos4[d, c2, :, o2, :] * g[c2, xd, yd][:, :, None, o2, :]
            ).sum(-1)
    return (
        T.reshape(D, 2, 2, m2, m2, r).permute(0, 3, 1, 4, 2, 5)
        .reshape(D, 2 * m2, 2 * m2, r)
    )


def interleave_class_major(Lc: torch.Tensor) -> torch.Tensor:
    """(D, 4, m2, r, m2) per class c = 2px+py, box row x, point a, box
    column y -> L (D, 2m2, 2m2, r) with L[d, 2x+px, 2y+py, a]."""
    D, _, m2, r, _ = Lc.shape
    return (
        Lc.reshape(D, 2, 2, m2, r, m2).permute(0, 3, 1, 5, 2, 4)
        .reshape(D, 2 * m2, 2 * m2, r)
    )


@functools.lru_cache(maxsize=None)
def _plan_device(np_cheb: int, B: int, nq: int, device: torch.device):
    return torch.as_tensor(offset_plan_np(np_cheb, B, nq), device=device)


def offsets_translate(Wo, coeffs, cosr, M, shift) -> torch.Tensor:
    if cosr.dim() == 3:
        return offsets_translate(Wo, coeffs, cosr[None], M, shift)[0]
    if Wo.device.type == "cpu":
        return offsets_translate_plain(Wo, coeffs, cosr, M, shift)
    inst = _cuda.instance("Wo", Wo)
    m, r = M.shape[0], M.shape[-1]
    m2 = m // 2
    sz, nq = coeffs.shape[0], coeffs.shape[-1]
    np_cheb = math.isqrt(r)
    if 27 * r * Wo.element_size() > 48 * 1024:
        raise ValueError(f"r = {r}: a row of 27 r values exceeds 48 KB")
    if m < 4 or sz % m:
        raise ValueError(f"M {tuple(M.shape)} does not tile a {sz}^2 field")
    B = sz // m
    D = cosr.shape[0]
    dtype = Wo.dtype
    _cuda.check("Wo", Wo, (wo_numel(np_cheb, B, nq),), dtype)
    _cuda.check("coeffs", coeffs, (sz, sz, nq), dtype)
    _cuda.check("cosr", cosr, (D, 4, r, 27 * r), dtype)
    _cuda.check("M", M, (m, m, r), dtype)
    _cuda.check("shift", shift, (4, 27, 4), torch.int32)
    if Wo.numel() >= 2 ** 31:
        raise ValueError("Wo exceeds the kernel's 32-bit offsets")
    plan = _plan_device(np_cheb, B, nq, Wo.device)
    symbol = SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
    Lc = torch.zeros((D, 4, m2, r, m2), dtype=dtype, device=M.device)
    rc = fn(_cuda.ptr(Wo), _cuda.ptr(coeffs), _cuda.ptr(cosr), _cuda.ptr(M),
            _cuda.ptr(shift), _cuda.ptr(plan), plan.shape[0], _cuda.ptr(Lc),
            sz, nq, m2, B, r, D, _cuda.stream(Wo.device))
    _cuda.raise_on_error(symbol, rc)
    launches[inst] += 1
    return interleave_class_major(Lc)
