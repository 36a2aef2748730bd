"""K1: the fused dense M2L translate of one FMM level, for one Fourier
mode or for all D modes of one charge.

Replaces aniso_tpu/fmm/apply.py:_m2l_translate, dense branch (:317-372),
with its producer _vlist_gather (:158) and _interleave_classes (:230), and
the per-mode loop around it in fmm_apply_all_modes (:745-750).  The CUDA
kernel is csrc/m2l_translate.cu; its header states the bound (bytes: E is
read once per charge whatever D is, 150.8 MB at 64^2) and the design.  The
all-modes kernel (D > 1) is built for r = np^2 with np 2-7; any other r
runs in its runtime-r instance.  Both forms take every r whose row
of 27 r values fits 48 KB (np 15 in float64, 21 in float32).

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

K1-S, m2l_translate_shard (after aniso_tpu/parallel/halo.py:
make_fine_translate_shardmap, :106-186), is the same translate on one shard
of a domain decomposition: E is the shard's slice (4, m2x, m2y, r, 27r), M
the shard's multipoles extended by two boxes on each side (2 m2x + 4,
2 m2y + 4, r; parallel.halo.halo_exchange), and L the shard's (D, 2 m2x,
2 m2y, r) block.  Its launches count under "shard_f32" / "shard_f64".
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

SOURCE = "m2l_translate.cu"
SYMBOLS = {"f32": "aniso_m2l_translate_f32", "f64": "aniso_m2l_translate_f64"}
SHARD_SYMBOLS = {"f32": "aniso_m2l_translate_shard_f32",
                 "f64": "aniso_m2l_translate_shard_f64"}
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
_SHARD_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4
                   + (ctypes.c_void_p,))

launches = {"f32": 0, "f64": 0, "shard_f32": 0, "shard_f64": 0}


def _gather_planes(planes, m2x, m2y, shift) -> torch.Tensor:
    """(4, m2x, m2y, 27, r) from the four parity planes (2, 2, m2x + 2,
    m2y + 2, r), each with one box of halo: per target class c and box,
    the 27 V-list source multipoles."""
    tab = shift.tolist()
    return torch.stack([
        torch.stack([
            planes[sx, sy, ax:ax + m2x, ay:ay + m2y]
            for (sx, sy, ax, ay) in tab[c]
        ], dim=2)
        for c in range(4)
    ])


def vlist_gather(M: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(4, m2, m2, 27, r): per target class c and box, the 27 V-list source
    multipoles, zero off the parity plane (aniso_tpu _vlist_gather)."""
    m, r = M.shape[0], M.shape[-1]
    m2 = m // 2
    P4 = M.reshape(m2, 2, m2, 2, r)
    pad = M.new_zeros((2, 2, m2 + 2, m2 + 2, r))
    pad[:, :, 1:-1, 1:-1] = P4.permute(1, 3, 0, 2, 4)
    return _gather_planes(pad, m2, m2, shift)


def _translate_gathered(E, cosr, g) -> torch.Tensor:
    """exp(-E) * cosr * g summed over (o, b) for each mode, the 4 classes
    interleaved: (D, 2 m2x, 2 m2y, r)."""
    D = cosr.shape[0]
    _, m2x, m2y, r, ob = E.shape
    g = g.reshape(4, m2x, m2y, 1, ob)
    X = torch.exp(-E)
    T = torch.stack([(X * cosr[d, :, None, None] * g).sum(-1)
                     for d in range(D)])               # (D, 4, m2x, m2y, r)
    return (
        T.reshape(D, 2, 2, m2x, m2y, r).permute(0, 3, 1, 4, 2, 5)
        .reshape(D, 2 * m2x, 2 * m2y, r)
    )


def m2l_translate_plain(E, cosr, M, shift) -> torch.Tensor:
    """The JAX math step by step: gather, exp(-E) * cosr * gsel summed over
    (o, b) for each mode, interleave the 4 classes."""
    if cosr.dim() == 3:
        return m2l_translate_plain(E, cosr[None], M, shift)[0]
    return _translate_gathered(E, cosr, vlist_gather(M, shift))


def m2l_translate_shard_plain(E, cosr, Mext, shift) -> torch.Tensor:
    """K1-S's plain version: the same steps on the extended plane, whose
    parity planes carry one box of halo where vlist_gather pads zeros (the
    local body of aniso_tpu make_fine_translate_shardmap, :135-170)."""
    if cosr.dim() == 3:
        return m2l_translate_shard_plain(E, cosr[None], Mext, shift)[0]
    _, m2x, m2y, r, _ = E.shape
    planes = Mext.reshape(m2x + 2, 2, m2y + 2, 2, r).permute(1, 3, 0, 2, 4)
    return _translate_gathered(E, cosr, _gather_planes(planes, m2x, m2y,
                                                       shift))


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
    # shared memory: one box's multipoles
    if ob * E.element_size() > 48 * 1024:
        raise ValueError(f"r = {r}: a row of 27 r values exceeds 48 KB")
    symbol = SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
    L = torch.empty((D,) + tuple(M.shape), dtype=M.dtype, device=M.device)
    rc = fn(_cuda.ptr(E), _cuda.ptr(cosr), _cuda.ptr(M), _cuda.ptr(shift),
            _cuda.ptr(L), m2, r, D, _cuda.stream(E.device))
    _cuda.raise_on_error(symbol, rc)
    launches[inst] += 1
    return L


def m2l_translate_shard(E, cosr, Mext, shift) -> torch.Tensor:
    """K1-S: (D, 2 m2x, 2 m2y, r), or (2 m2x, 2 m2y, r) for one mode's
    cosr (4, r, 27r)."""
    if cosr.dim() == 3:
        return m2l_translate_shard(E, cosr[None], Mext, shift)[0]
    if E.device.type == "cpu":
        return m2l_translate_shard_plain(E, cosr, Mext, shift)
    inst = _cuda.instance("E", E)
    _, m2x, m2y, r, ob = E.shape
    D = cosr.shape[0]
    if ob != 27 * r:
        raise ValueError(f"E: last dim {ob}, expected 27 r = {27 * r}")
    if ob * E.element_size() > 48 * 1024:
        raise ValueError(f"r = {r}: a row of 27 r values exceeds 48 KB")
    _cuda.check_all(E.dtype, ("E", E, (4, m2x, m2y, r, ob)),
                    ("cosr", cosr, (D, 4, r, ob)),
                    ("Mext", Mext, (2 * m2x + 4, 2 * m2y + 4, r)))
    _cuda.check("shift", shift, (4, 27, 4), torch.int32)
    symbol = SHARD_SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _SHARD_ARGTYPES)
    L = torch.empty((D, 2 * m2x, 2 * m2y, r), dtype=E.dtype, device=E.device)
    rc = fn(_cuda.ptr(E), _cuda.ptr(cosr), _cuda.ptr(Mext), _cuda.ptr(shift),
            _cuda.ptr(L), m2x, m2y, r, D, _cuda.stream(E.device))
    _cuda.raise_on_error(symbol, rc)
    launches["shard_" + inst] += 1
    return L
