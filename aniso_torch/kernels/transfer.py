"""K8: the FMM's transfer passes, the up pass (P2M, then M2M level by level)
and the down pass's L2L chain with the leaf epilogue (L2T, the near field,
the 1/2pi scale), for one Fourier mode or for all D modes of one charge.

Replaces aniso_tpu/fmm/apply.py:_up_pass (:141-155), the L2L of _down_pass
(:549-551, and of fmm_apply_all_modes, :752-760) and the far field's L2T
with the near-field add and the scale (:707-711, :763-766).  The CUDA
kernels are csrc/transfer.cu; its header states the bound (bytes) and the
design.

    M_leaf[i, j, c]  = sum_k p2m_w[c, k] u[i, j, k]                     (P2M)
    M_{l-1}[x, y, a] = sum_{h,g,c} m2m[h, g, a, c] M_l[2x+h, 2y+g, c]   (M2M)
    L_{l+1}[2x+h, 2y+g, c] = sum_a m2m[h, g, a, c] L_l[x, y, a]
                             + T_{l+1}[2x+h, 2y+g, c]                   (L2L)
    out[i, j, k]     = (sum_c l2t[k, c] L_leaf[i, j, c] + near[i, j, k])
                       / (2 pi)                                         (L2T)

where m2m is the tensor product of the one-dimensional child transfer
m2m_1d (2, np, np) (fmm/cheb.py:child_transfer, m2m_tensor):
m2m[h, g, (a, b), (i, j)] = m2m_1d[h, i, a] m2m_1d[g, j, b].  The entries
take m2m_1d: the kernels transfer through it, two one-dimensional products
a child; the plain versions form m2m from it (m2m_tensor) and run the
einsums the port ran before.

Layouts (the port's own, contiguous): u (lx, ly, nq); M and L (mx, my, r)
at each level, mx = lx / 2^s, r = np^2; p2m_w (r, nq), l2t (nq, r); with
the mode axis, L, T, near and out carry a leading D (the up pass has none:
there is one charge).  The extents are rectangular: a shard's block
(parallel.api) is the same call as the whole grid.

up_pass(p2m_w, m2m_1d, u, n) gives the multipoles of the leaf and of the
n levels above it; up_from(m2m_1d, M, n) the n levels above a given level
(the coarse levels of a domain decomposition, from the gathered M);
down(m2m_1d, L0, Ts, l2t, near) runs the chain from L0 through the levels
of Ts, each twice as fine as the one before, and returns the last level's
locals, or, given l2t and near, the corrected matvec.  The down pass takes
every level's T at once: holding them costs about 4/3 of the leaf's
locals (200 MB at 512^2 with D = 9 in float32).

Each takes its plain PyTorch version for CPU tensors and launches the
kernels for CUDA tensors, by dtype; `launches` counts kernel launches per
pass and instance ("up_f32", "down_f64", ...).  A pass is one launch
(up_plan, down_plan): a block owns a tile of 2^t x 2^t leaf boxes, enough
of them to fill the card; the up pass finishes the levels above the tiles
in the same launch by tickets, int32 counters a box in a buffer of
TICKETS per device that every launch leaves at 0 (launches on one device
share it, so they run on one stream at a time, as the port's do).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _cuda
from .m2l import SMEM_BLOCK

SOURCE = "transfer.cu"
UP_SYMBOLS = {"f32": "aniso_transfer_up_f32", "f64": "aniso_transfer_up_f64"}
DOWN_SYMBOLS = {"f32": "aniso_transfer_down_f32",
                "f64": "aniso_transfer_down_f64"}
_UP_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_longlong,)
                + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
_DOWN_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7
                  + (ctypes.c_void_p,))

launches = {"up_f32": 0, "up_f64": 0, "down_f32": 0, "down_f64": 0}

MAX_LEVELS = 16       # offsets a pass spans (kMaxLevels in the source)
MAX_T = 3             # levels inside a block: 8 x 8 leaf boxes (kMaxT)
MIN_BLOCKS = 256      # blocks a launch is planned to have, where it can
TICKETS = 1 << 18     # ticket counters a device (1 MB): a 16384^2 plane


def _up16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def smem_bytes(down: bool, t: int, r: int, nq: int, item: int,
               staged: bool, n: int = 0) -> int:
    """Shared memory of a block (csrc/transfer.cu's layout, each buffer on
    16 bytes): in float64, its tile of 4^t boxes (at least 4 in the up
    pass: a parent's children), the level above the tile, the first
    products (half a tile), the 1-D weights (up: m2m_1d; down: it and its
    transpose) and, staged, p2m_w or l2t (r nq); in the kernel's type, the
    tile's u (up, nq > 0: P2M) or, down, what the block reads (its
    ancestor's L0, the T of its chain's n - t boxes and of its subtree, the
    tile's near field).  nq = 0: from a level's M (up) or no epilogue
    (down)."""
    s2 = 4 ** t
    gathered = (r * (1 + n - t + sum(4 ** (t - s) for s in range(t)))
                + s2 * nq)
    parts = [(s2 if down else max(s2, 4)) * r * 8,
             0 if down else s2 * nq * item,
             max(s2 // 4, 1) * r * 8,
             max(s2 // 2, 1 if down else 2) * r * 8,
             (4 if down else 2) * r * 8,
             r * nq * 8 if staged else 0,
             gathered * item if down else 0]
    return sum(_up16(b) for b in parts)


class Launch(NamedTuple):
    """One launch of a pass: tiles of 2^t x 2^t boxes at the finest level
    (the leaf, or the given level of up_from), gx x gy of them (x D blocks
    for the down pass's modes)."""
    t: int
    gx: int        # tiles along x
    gy: int        # tiles along y
    blocks: int
    tickets: int   # counters of the boxes above the tiles (up)
    smem: int      # bytes of dynamic shared memory
    staged: bool   # p2m_w / l2t in shared memory (else read in place)


def _plan(lx, ly, n, r, nq, item, down, D) -> Launch:
    if n < 0 or n >= MAX_LEVELS or lx % (1 << n) or ly % (1 << n):
        raise ValueError(f"({lx}, {ly}) boxes do not reduce by {n} levels")
    for t in range(min(MAX_T, n), -1, -1):
        gx, gy = lx >> t, ly >> t
        if t and gx * gy * D < MIN_BLOCKS:
            continue
        for staged in (True, False):
            smem = smem_bytes(down, t, r, nq, item, staged, n)
            if smem <= SMEM_BLOCK:
                tickets = 0 if down else sum(
                    (lx >> s) * (ly >> s) for s in range(t + 1, n + 1))
                return Launch(t, gx, gy, gx * gy * D, tickets, smem,
                              staged and nq > 0)
    raise ValueError(f"r = {r}: one box's transfer does not fit a block's "
                     "shared memory")


@functools.lru_cache(maxsize=None)
def up_plan(lx: int, ly: int, n: int, r: int, nq: int, item: int) -> tuple:
    """The launches of an up pass through n levels above an (lx, ly) plane
    of leaf squares (nq values each: P2M) or, with nq = 0, of boxes of a
    given level (up_from; no launch for n = 0): one Launch, the most
    levels a tile (up to MAX_T) that leave MIN_BLOCKS blocks and fit a
    block's shared memory."""
    if nq == 0 and n == 0:
        return ()
    return (_plan(lx, ly, n, r, nq, item, False, 1),)


@functools.lru_cache(maxsize=None)
def down_plan(lx: int, ly: int, n: int, r: int, nq: int, item: int,
              D: int = 1) -> tuple:
    """The launches of a down pass from the (lx >> n, ly >> n) plane of
    boxes through n finer levels to an (lx, ly) plane, for D modes, with
    the epilogue (nq values a square) or, nq = 0, the last level's L
    (no launch for n = 0): one Launch."""
    if nq == 0 and n == 0:
        return ()
    return (_plan(lx, ly, n, r, nq, item, True, D),)


# ---- plain versions: the einsums of aniso_tpu/fmm/apply.py ----

def m2m_tensor(m2m_1d):
    """(2, 2, r, r) m2m, the tensor product of m2m_1d (each value one
    product, as fmm/cheb.py:m2m_from_1d)."""
    n = m2m_1d.shape[-1]
    return torch.einsum("hia,gjb->hgabij", m2m_1d, m2m_1d).reshape(
        2, 2, n * n, n * n)


def _m2m(m2m, child):
    r = child.shape[-1]
    c4 = child.reshape(child.shape[0] // 2, 2, child.shape[1] // 2, 2, r)
    return torch.einsum("hgac,xhygc->xya", m2m, c4)


def up_pass_plain(p2m_w, m2m_1d, u, n: int) -> list:
    """[M_leaf, ..., M_{leaf-n}] (aniso_tpu _up_pass)."""
    M = [torch.einsum("ck,ijk->ijc", p2m_w, u)]
    m2m = m2m_tensor(m2m_1d) if n else None
    for _ in range(n):
        M.append(_m2m(m2m, M[-1]))
    return M


def up_from_plain(m2m_1d, M, n: int) -> list:
    """[M, M_{-1}, ..., M_{-n}]: the n levels above M's."""
    out = [M]
    m2m = m2m_tensor(m2m_1d) if n else None
    for _ in range(n):
        out.append(_m2m(m2m, out[-1]))
    return out


def down_plain(m2m_1d, L0, Ts, l2t=None, near=None):
    """L2L from L0 through Ts (aniso_tpu apply.py:549-551), then, given
    l2t and near, the leaf epilogue (:707-711)."""
    L = L0
    m2m = m2m_tensor(m2m_1d) if Ts else None
    for T in Ts:
        Lc = torch.einsum("hgac,...xya->...xhygc", m2m, L)
        L = Lc.reshape(T.shape) + T
    if l2t is None:
        return L
    far = torch.einsum("kc,...ijc->...ijk", l2t, L)
    return (far + near) / (2.0 * math.pi)


# ---- the kernels ----

def _ptrs(tensors) -> ctypes.Array:
    """The device pointers of `tensors` as the C array the entries read
    (at launch: a captured launch keeps their values)."""
    arr = (ctypes.c_void_p * MAX_LEVELS)()
    for i, t in enumerate(tensors):
        arr[i] = t.data_ptr()
    return arr


_tickets: dict = {}


def _ticket_buffer(device) -> torch.Tensor:
    """The device's ticket counters, zeroed once; every launch leaves them
    at 0."""
    key = device.index or 0
    if key not in _tickets:
        _tickets[key] = torch.zeros(TICKETS, dtype=torch.int32,
                                    device=device)
    return _tickets[key]


def _check_ops(p2m_w, m2m_1d, l2t, np_, nq, dtype):
    r = np_ * np_
    specs = [("m2m_1d", m2m_1d, (2, np_, np_))]
    if p2m_w is not None:
        specs.append(("p2m_w", p2m_w, (r, nq)))
    if l2t is not None:
        specs.append(("l2t", l2t, (nq, r)))
    _cuda.check_all(dtype, *specs)


def _up_cuda(p2m_w, m2m_1d, src, n: int, p2m: bool) -> list:
    inst = _cuda.INSTANCES[src.dtype]
    lx, ly = src.shape[:2]
    np_ = m2m_1d.shape[-1]
    r = np_ * np_
    nq = src.shape[-1] if p2m else 0
    plan = up_plan(lx, ly, n, r, nq, src.element_size())
    out = [] if p2m else [src]
    for s in range(0 if p2m else 1, n + 1):
        out.append(torch.empty((lx >> s, ly >> s, r), dtype=src.dtype,
                               device=src.device))
    for launch in plan:
        tickets = _ticket_buffer(src.device)
        symbol = UP_SYMBOLS[inst]
        fn = _cuda.load(SOURCE, symbol, _UP_ARGTYPES)
        ptrs = _ptrs(out)
        rc = fn(_cuda.ptr(src if p2m else None),
                _cuda.ptr(p2m_w if p2m else None), _cuda.ptr(m2m_1d),
                ctypes.cast(ptrs, ctypes.c_void_p), _cuda.ptr(tickets),
                tickets.numel(), lx, ly, np_, nq, n, launch.t,
                _cuda.stream(src.device))
        _cuda.raise_on_error(symbol, rc)
        launches["up_" + inst] += 1
    return out


def up_pass(p2m_w, m2m_1d, u, n: int) -> list:
    """[M_leaf, M_{leaf-1}, ..., M_{leaf-n}] from the charges u (lx, ly,
    nq)."""
    if u.device.type == "cpu":
        return up_pass_plain(p2m_w, m2m_1d, u, n)
    _cuda.instance("u", u)
    dt = u.dtype
    nq = p2m_w.shape[-1]
    _check_ops(p2m_w, m2m_1d, None, m2m_1d.shape[-1], nq, dt)
    _cuda.check("u", u, tuple(u.shape[:2]) + (nq,), dt)
    return _up_cuda(p2m_w, m2m_1d, u, n, True)


def up_from(m2m_1d, M, n: int) -> list:
    """[M, M_{-1}, ..., M_{-n}] from the multipoles M (mx, my, r) of one
    level."""
    if M.device.type == "cpu":
        return up_from_plain(m2m_1d, M, n)
    _cuda.instance("M", M)
    dt = M.dtype
    np_ = m2m_1d.shape[-1]
    _check_ops(None, m2m_1d, None, np_, 0, dt)
    _cuda.check("M", M, tuple(M.shape[:2]) + (np_ * np_,), dt)
    return _up_cuda(None, m2m_1d, M, n, False)


def down(m2m_1d, L0, Ts, l2t=None, near=None):
    """L2L from L0 (D, mx, my, r) through Ts (each (D, 2^j mx, 2^j my,
    r)); with l2t and near (D, lx, ly, nq), the corrected matvec (D, lx,
    ly, nq), else the last level's L.  Without the mode axis: one mode."""
    if L0.dim() == 3:
        return down(m2m_1d, L0[None], [T[None] for T in Ts], l2t,
                    None if near is None else near[None])[0]
    if L0.device.type == "cpu":
        return down_plain(m2m_1d, L0, Ts, l2t, near)
    return _down_cuda(m2m_1d, L0, Ts, l2t, near)


def _down_cuda(m2m_1d, L0, Ts, l2t, near):
    inst = _cuda.instance("L0", L0)
    dt = L0.dtype
    D, mx, my, r = L0.shape
    np_ = m2m_1d.shape[-1]
    n = len(Ts)
    nq = 0 if l2t is None else l2t.shape[0]
    _check_ops(None, m2m_1d, l2t, np_, nq, dt)
    specs = [("L0", L0, (D, mx, my, np_ * np_))]
    specs += [(f"T[{j}]", T, (D, mx << (j + 1), my << (j + 1), r))
              for j, T in enumerate(Ts)]
    lx, ly = mx << n, my << n
    if l2t is not None:
        specs.append(("near", near, (D, lx, ly, nq)))
    _cuda.check_all(dt, *specs)
    plan = down_plan(lx, ly, n, r, nq, L0.element_size(), D)
    if not plan:
        return L0
    out = torch.empty((D, lx, ly, nq or r), dtype=dt, device=L0.device)
    symbol = DOWN_SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _DOWN_ARGTYPES)
    ptrs = _ptrs(Ts[::-1])              # by offset from the leaf
    rc = fn(_cuda.ptr(L0), ctypes.cast(ptrs, ctypes.c_void_p),
            _cuda.ptr(m2m_1d), _cuda.ptr(l2t), _cuda.ptr(near),
            _cuda.ptr(out), lx, ly, np_, nq, n, plan[0].t, D,
            _cuda.stream(L0.device))
    _cuda.raise_on_error(symbol, rc)
    launches["down_" + inst] += 1
    return out
