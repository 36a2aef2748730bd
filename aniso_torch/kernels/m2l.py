"""K1: the fused dense M2L translate of one FMM level, for one Fourier
mode or for all D modes of one charge.

Replaces aniso_tpu/fmm/apply.py:_m2l_translate, dense branch (:317-372),
with its producer _vlist_gather (:158) and _interleave_classes (:230), and
the per-mode loop around it in fmm_apply_all_modes (:745-750).  The CUDA
kernels are csrc/m2l_translate.cu; its header states the bound (bytes: E is
read once per charge whatever D is, 150.8 MB at 64^2; 9.9 GB at 512^2,
2.95 ms at 3.35 TB/s) and the designs.  One mode is a persistent kernel
whose producer warp streams each box's rows of E into a ring in shared
memory by bulk copies, beside the box's sources, while the table rows stay
resident; plan_one cuts its work.  The all-modes kernel (D > 1) is built
for r = np^2 with np 2-7; any other r runs in its runtime-r instance.  Both
forms take every r whose row of 27 r values fits MAX_ROW_BYTES of the
opt-in dynamic shared memory (np 32 in float64, 46 in float32: max_np),
as K3 does; TransportSolver refuses a larger np on the card before it
builds anything (check_np).

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
one mode and returns L (2m2, 2m2, r).  The kernels copy E, cosr and M from
16-byte boundaries: the wrappers refuse tensors that do not start on one.

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
import functools
import math
from typing import NamedTuple

import torch

from . import _cuda

SOURCE = "m2l_translate.cu"
# D >= 2 modes: whole level and shard; one mode: both (an `ext` argument)
SYMBOLS = {"f32": "aniso_m2l_translate_f32", "f64": "aniso_m2l_translate_f64"}
SHARD_SYMBOLS = {"f32": "aniso_m2l_translate_shard_f32",
                 "f64": "aniso_m2l_translate_shard_f64"}
ONE_SYMBOLS = {"f32": "aniso_m2l_translate_one_f32",
               "f64": "aniso_m2l_translate_one_f64"}
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
_SHARD_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4
                   + (ctypes.c_void_p,))
_ONE_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3
                 + (ctypes.c_void_p,) * 2)

launches = {"f32": 0, "f64": 0, "shard_f32": 0, "shard_f64": 0}

# The H100's limits that the one-mode plan works in.
SMEM_BLOCK = 227 * 1024   # dynamic shared memory a block may take
SMEM_SM = 228 * 1024      # an SM's, of which 1 KB is reserved a block
THREADS_SM = 2048
REGS_SM = 65536
# registers a thread, by itemsize: the most ptxas gives an instance (40-56
# in float32, 71-72 in float64; chip_smoke.py's redesigned_kernels line)
REGS_THREAD = {4: 56, 8: 72}
NUM_SMS = 132
# E a stage, about, and the plan's other choices: from the A/B of
# `tools/kernel_ab.py --variants k1` (PERF.md)
STAGE_BYTES = 32768
MIN_BLOCKS = 128          # blocks a level, at least, where its rows allow
MAX_CONSUMERS = 8         # consumer warps a block (kOneThreads in the source)
STAGES = (4, 3, 2)        # ring depths tried; ties go to the deepest
# a row of 27 r values, at most: the one-mode kernel keeps one table row
# resident beside two stages of a chunk of E and its sources, the
# all-modes runtime-r instance one row of sources; both in the opt-in
# dynamic shared memory (cudaFuncAttributeMaxDynamicSharedMemorySize)
MAX_ROW_BYTES = SMEM_BLOCK - 1024


def max_np(itemsize: int) -> int:
    """The largest np_cheb whose row of 27 np^2 values of `itemsize` bytes
    the M2L kernels (K1, K1-D, K1-S, K3) take: 32 in float64, 46 in
    float32."""
    return math.isqrt(MAX_ROW_BYTES // (27 * itemsize))


def check_np(np_cheb: int, dtype) -> None:
    """Raise ValueError, naming the limit, where the card's M2L kernels do
    not take np_cheb in `dtype`."""
    item = torch.finfo(dtype).bits // 8
    if np_cheb > max_np(item):
        raise ValueError(
            f"np_cheb {np_cheb} in {dtype}: the card's M2L kernels take np "
            f"up to {max_np(item)} (a row of 27 np^2 values within "
            f"{MAX_ROW_BYTES} bytes of shared memory)")


def _row_check(r: int, item: int) -> None:
    if 27 * r * item > MAX_ROW_BYTES:
        raise ValueError(f"r = {r}: a row of 27 r values exceeds "
                         f"{MAX_ROW_BYTES} bytes")


class Plan(NamedTuple):
    """One-mode launch: the first 11 fields go to the kernel (Plan1 in the
    source, which checks them); threads, grid and vw follow from them."""
    r: int        # target points a box
    G: int        # target rows a group: a block's a0 .. a0 + G - 1
    ng: int       # row groups, ceil(r / G)
    S: int        # stages of the ring
    nq: int       # values of a row a stage (27 r, or a chunk where G = 1)
    nchunk: int   # stages a row takes
    per: int      # boxes a block
    nsplit: int   # blocks a (class, row group): boxes split * per, ...
    WG: int       # consumer warps a group (rows j, j + WG, ... of a stage)
    NGRP: int     # consumer groups (group k takes items k, k + NGRP, ...,
                  # in the stages k, k + NGRP, ...: S is a multiple)
    smem: int     # bytes of dynamic shared memory
    threads: int  # 32 (1 + WG NGRP): a producer warp and the consumers
    grid: int     # 4 ng nsplit blocks, (class, row group, split)
    vw: int       # values a 16-byte vector, or 1 where a row of 27 r
                  # values does not fill whole vectors


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _r16(nbytes: int) -> int:
    return _cdiv(nbytes, 16) * 16


def smem_layout(r: int, G: int, S: int, nq: int, nchunk: int,
                item: int) -> dict:
    """Byte offsets of the one-mode kernel's shared memory (layout1 in the
    source): 2 S + 1 barriers, the table span of G rows, then S stages of
    an E span and the sources.  A span covers its run from the 16-byte
    boundary below it: 16 bytes more than the run."""
    row = 27 * r
    tab = _r16(8 * (2 * S + 1))
    stage0 = tab + _r16(G * row * item) + 16
    espan = _r16((G * row if nchunk == 1 else nq) * item) + 16
    stage = espan + _r16(nq * item)
    return {"tab": tab, "stage0": stage0, "espan": espan, "stage": stage,
            "total": stage0 + S * stage}


def _blocks_per_sm(smem: int, threads: int, item: int) -> int:
    return min(SMEM_SM // (smem + 1024), THREADS_SM // threads,
               REGS_SM // (threads * REGS_THREAD[item]), 32)


@functools.lru_cache(maxsize=None)
def plan_one(m2x: int, m2y: int, r: int, item: int,
             num_sms: int = NUM_SMS) -> Plan:
    """The one-mode kernel's cut of a (m2x, m2y) plane of boxes with r
    target points and `item`-byte values: rows a group G (about
    STAGE_BYTES of E a stage; fewer on a coarse level, so that 4 classes x
    boxes x row groups reach MIN_BLOCKS; fewer, down to one row cut into
    chunks, where two stages and the table would not fit), the stages (the
    most of 4, 3, 2 that keep as many blocks an SM), persistent blocks,
    each a run of `per` boxes (the fewest rounds of blocks: one wave where
    the rows allow), and the consumer warps: 1, 2 or 4 groups of WG <= 8
    warps (the G rows spread evenly), each group the only reader of its
    stages."""
    row = 27 * r
    _row_check(r, item)
    vw = 16 // item if row * item % 16 == 0 else 1
    nb = m2x * m2y
    G = _cdiv(r, _cdiv(r, max(1, min(r, STAGE_BYTES // (row * item)))))
    while G > 1 and 4 * nb * _cdiv(r, G) < MIN_BLOCKS:
        G -= 1
    while G > 1 and smem_layout(r, G, 2, row, 1, item)["total"] > SMEM_BLOCK:
        G -= 1
    ng = _cdiv(r, G)
    if _cdiv(r, _cdiv(r, ng)) == ng:  # the same groups, evened out
        G = _cdiv(r, ng)
    nq, nchunk = row, 1
    while smem_layout(r, G, 2, nq, nchunk, item)["total"] > SMEM_BLOCK:
        nchunk += 1
        nq = _cdiv(_cdiv(row, nchunk), vw) * vw
    nchunk = _cdiv(row, nq)
    WG = _cdiv(G, _cdiv(G, MAX_CONSUMERS))  # rows a warp evened out

    def fit(ngrp):
        # each stage serves one group (S a multiple of NGRP), so a group
        # waits on a stage only after its own last use of it
        threads = 32 * (1 + WG * ngrp)
        options = [(_blocks_per_sm(smem_layout(r, G, s, nq, nchunk,
                                               item)["total"], threads,
                                   item), s)
                   for s in STAGES if s % ngrp == 0
                   and smem_layout(r, G, s, nq, nchunk,
                                   item)["total"] <= SMEM_BLOCK]
        if not options:
            return None
        bps, S = max(options)
        return threads, S, max(1, bps)

    # consumer groups: 1, 2 or 4, about MAX_CONSUMERS warps in all
    NGRP = 1 if nchunk > 1 else min(4, max(1, MAX_CONSUMERS // WG))
    NGRP = 1 << (NGRP.bit_length() - 1)
    while NGRP > 1 and fit(NGRP) is None:
        NGRP //= 2
    threads, S, bps = fit(NGRP)
    # boxes a block: the fewest rounds of blocks times boxes a block (and
    # a block's start, about two boxes), ties to fewer blocks
    slots = bps * num_sms

    def rounds(ns):
        per = _cdiv(nb, ns)
        return _cdiv(4 * ng * _cdiv(nb, per), slots) * (per + 2), per

    _, per = min(rounds(ns) for ns in range(1, min(nb, 4 * slots) + 1))
    nsplit = _cdiv(nb, per)
    while NGRP > per * nchunk:        # fewer stages a block than groups
        NGRP //= 2
        threads, S, _ = fit(NGRP)
    smem = smem_layout(r, G, S, nq, nchunk, item)["total"]
    return Plan(r, G, ng, S, nq, nchunk, per, nsplit, WG, NGRP, smem,
                threads, 4 * ng * nsplit, vw)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_one(E, cosr, M, shift, L, ext: int, plan: Plan, inst: str):
    """One launch of the one-mode kernel with `plan` (plan_one's, or
    another that the kernel's checks accept)."""
    symbol = ONE_SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ONE_ARGTYPES)
    arr = (ctypes.c_int * 11)(*plan[:11])
    rc = fn(_cuda.ptr(E), _cuda.ptr(cosr), _cuda.ptr(M), _cuda.ptr(shift),
            _cuda.ptr(L), E.shape[1], E.shape[2], ext,
            ctypes.cast(arr, ctypes.c_void_p), _cuda.stream(E.device))
    _cuda.raise_on_error(symbol, rc)


def _translate_cuda(E, cosr, M, shift, ext: int) -> torch.Tensor:
    """The CUDA launch of K1 (ext 0) or K1-S (ext 2) once the shapes are
    checked: one mode (cosr (1, 4, r, 27r)) by plan_one, D >= 2 modes by
    the all-modes kernel."""
    inst = _cuda.INSTANCES[E.dtype]
    _, m2x, m2y, r, _ = E.shape
    D = cosr.shape[0]
    _cuda.check_aligned(E=E, cosr=cosr, M=M)
    L = torch.empty((D, 2 * m2x, 2 * m2y, r), dtype=E.dtype,
                    device=E.device)
    if D == 1:
        plan = plan_one(m2x, m2y, r, E.element_size(),
                        _num_sms(E.device.index or 0))
        _launch_one(E, cosr, M, shift, L, ext, plan, inst)
    elif ext == 0:
        symbol = SYMBOLS[inst]
        fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
        rc = fn(_cuda.ptr(E), _cuda.ptr(cosr), _cuda.ptr(M),
                _cuda.ptr(shift), _cuda.ptr(L), m2x, r, D,
                _cuda.stream(E.device))
        _cuda.raise_on_error(symbol, rc)
    else:
        symbol = SHARD_SYMBOLS[inst]
        fn = _cuda.load(SOURCE, symbol, _SHARD_ARGTYPES)
        rc = fn(_cuda.ptr(E), _cuda.ptr(cosr), _cuda.ptr(M),
                _cuda.ptr(shift), _cuda.ptr(L), m2x, m2y, r, D,
                _cuda.stream(E.device))
        _cuda.raise_on_error(symbol, rc)
    launches[("shard_" if ext else "") + inst] += 1
    return L


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
    _cuda.instance("E", E)
    _, m2, _, r, ob = E.shape
    D = cosr.shape[0]
    if ob != 27 * r:
        raise ValueError(f"E: last dim {ob}, expected 27 r = {27 * r}")
    _cuda.check("E", E, (4, m2, m2, r, ob), E.dtype)
    _cuda.check("cosr", cosr, (D, 4, r, ob), E.dtype)
    _cuda.check("M", M, (2 * m2, 2 * m2, r), E.dtype)
    _cuda.check("shift", shift, (4, 27, 4), torch.int32)
    _row_check(r, E.element_size())
    return _translate_cuda(E, cosr, M, shift, 0)


def m2l_translate_shard(E, cosr, Mext, shift) -> torch.Tensor:
    """K1-S: (D, 2 m2x, 2 m2y, r), or (2 m2x, 2 m2y, r) for one mode's
    cosr (4, r, 27r)."""
    if cosr.dim() == 3:
        return m2l_translate_shard(E, cosr[None], Mext, shift)[0]
    if E.device.type == "cpu":
        return m2l_translate_shard_plain(E, cosr, Mext, shift)
    _cuda.instance("E", E)
    _, m2x, m2y, r, ob = E.shape
    D = cosr.shape[0]
    if ob != 27 * r:
        raise ValueError(f"E: last dim {ob}, expected 27 r = {27 * r}")
    _row_check(r, E.element_size())
    _cuda.check_all(E.dtype, ("E", E, (4, m2x, m2y, r, ob)),
                    ("cosr", cosr, (D, 4, r, ob)),
                    ("Mext", Mext, (2 * m2x + 4, 2 * m2y + 4, r)))
    _cuda.check("shift", shift, (4, 27, 4), torch.int32)
    return _translate_cuda(E, cosr, Mext, shift, 2)
