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

Layouts (the port's own, contiguous): u (lx, ly, nq); M and L (mx, my, r)
at each level, mx = lx / 2^s; p2m_w (r, nq), m2m (2, 2, r, r), l2t (nq, r);
with the mode axis, L, T, near and out carry a leading D (the up pass has
none: there is one charge).  The extents are rectangular: a shard's block
(parallel.api) is the same call as the whole grid.

up_pass(p2m_w, m2m, u, n) gives the multipoles of the leaf and of the n
levels above it; up_from(m2m, M, n) the n levels above a given level (the
coarse levels of a domain decomposition, from the gathered M); down(m2m,
L0, Ts, l2t, near) runs the chain from L0 through the levels of Ts, each
twice as fine as the one before, and returns the last level's locals, or,
given l2t and near, the corrected matvec.  The down pass takes every
level's T at once: holding them costs about 4/3 of the leaf's locals
(200 MB at 512^2 with D = 9 in float32).

Each takes its plain PyTorch version (the einsums that fmm/apply.py ran
before) for CPU tensors and launches the kernels for CUDA tensors, by
dtype; `launches` counts kernel launches per pass and instance ("up_f32",
"down_f64", ...).  A pass is cut into
phases (pass_plan): a phase is one launch whose block owns a tile of up to
16 x 16 boxes at its finest level, so one launch reduces up to MAX_K
levels; 64^2 is one launch each way, 512^2 two.
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
_UP_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
                + (ctypes.c_void_p,))
_DOWN_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6
                  + (ctypes.c_void_p,))

launches = {"up_f32": 0, "up_f64": 0, "down_f32": 0, "down_f64": 0}

MAX_K = 4                  # levels a launch reduces (kMaxK in the source)


def tile_bytes(k: int, r: int, item: int) -> int:
    """Shared memory of a block that spans k levels: its tile at the
    finest one, 4^k boxes of r values, and the level above it.  The
    launch stages the weights (4 r^2 + r nq values) beside them where
    both fit in SMEM_BLOCK (np 2-7), else reads them from global memory."""
    return (4 ** k + (4 ** (k - 1) if k else 0)) * r * item


@functools.lru_cache(maxsize=None)
def max_k(r: int, item: int) -> int:
    """The most levels one launch takes at r values a box (at least 1)."""
    k = MAX_K
    while k > 1 and tile_bytes(k, r, item) > SMEM_BLOCK:
        k -= 1
    if tile_bytes(k, r, item) > SMEM_BLOCK:
        raise ValueError(f"r = {r}: two levels of one box do not fit a "
                         "block's shared memory")
    return k


class Phase(NamedTuple):
    """One launch: k levels below (up) or above (down) its block's top
    box; the grid is ax x ay blocks (up: tiles of 2^k x 2^k boxes at the
    phase's finest level; down: the boxes of its coarsest level), and D
    blocks more along y for the modes of the down pass."""
    k: int
    ax: int       # blocks along x
    ay: int       # blocks along y
    smem: int     # bytes of dynamic shared memory


@functools.lru_cache(maxsize=None)
def pass_plan(n: int, r: int, item: int, down: bool = False) -> tuple:
    """The k of each launch of a pass over n levels, in launch order: the
    up pass takes the most levels it can from the leaf, the down pass the
    remainder first, so that the finest levels never leave shared memory.
    n = 0 is one launch of k = 0 (P2M alone, or the epilogue alone)."""
    if n == 0:
        return (0,)
    km = max_k(r, item)
    ks = [km] * (n // km) + ([n % km] if n % km else [])
    return tuple(reversed(ks)) if down else tuple(ks)


def up_plan(lx: int, ly: int, n: int, r: int, item: int,
            p2m: bool = True) -> tuple:
    """The up pass's launches on an (lx, ly) plane of leaf squares (p2m)
    or of boxes of a given level: one Phase each."""
    if not p2m and n == 0:
        return ()
    out = []
    for k in pass_plan(n, r, item):
        out.append(Phase(k, lx >> k, ly >> k, tile_bytes(k, r, item)))
        lx, ly = lx >> k, ly >> k
    return tuple(out)


def down_plan(mx: int, my: int, n: int, r: int, item: int,
              epilogue: bool = True) -> tuple:
    """The down pass's launches from an (mx, my) plane of boxes through n
    finer levels: one Phase each."""
    if not epilogue and n == 0:
        return ()
    out = []
    for k in pass_plan(n, r, item, down=True):
        out.append(Phase(k, mx, my, tile_bytes(k, r, item)))
        mx, my = mx << k, my << k
    return tuple(out)


# ---- plain versions: the einsums of aniso_tpu/fmm/apply.py ----

def _m2m(m2m, child):
    r = child.shape[-1]
    c4 = child.reshape(child.shape[0] // 2, 2, child.shape[1] // 2, 2, r)
    return torch.einsum("hgac,xhygc->xya", m2m, c4)


def up_pass_plain(p2m_w, m2m, u, n: int) -> list:
    """[M_leaf, ..., M_{leaf-n}] (aniso_tpu _up_pass)."""
    M = [torch.einsum("ck,ijk->ijc", p2m_w, u)]
    for _ in range(n):
        M.append(_m2m(m2m, M[-1]))
    return M


def up_from_plain(m2m, M, n: int) -> list:
    """[M, M_{-1}, ..., M_{-n}]: the n levels above M's."""
    out = [M]
    for _ in range(n):
        out.append(_m2m(m2m, out[-1]))
    return out


def down_plain(m2m, L0, Ts, l2t=None, near=None):
    """L2L from L0 through Ts (aniso_tpu apply.py:549-551), then, given
    l2t and near, the leaf epilogue (:707-711)."""
    L = L0
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
    arr = (ctypes.c_void_p * (MAX_K + 1))()
    for i, t in enumerate(tensors):
        arr[i] = t.data_ptr()
    return arr


def _check_ops(p2m_w, m2m, l2t, r, nq, dtype):
    specs = [("m2m", m2m, (2, 2, r, r))]
    if p2m_w is not None:
        specs.append(("p2m_w", p2m_w, (r, nq)))
    if l2t is not None:
        specs.append(("l2t", l2t, (nq, r)))
    _cuda.check_all(dtype, *specs)


def _up_launch(src, p2m_w, m2m, outs, phase: Phase, r: int, nq: int):
    inst = _cuda.INSTANCES[src.dtype]
    symbol = UP_SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _UP_ARGTYPES)
    ptrs = _ptrs(outs)
    rc = fn(_cuda.ptr(src), _cuda.ptr(p2m_w), _cuda.ptr(m2m),
            ctypes.cast(ptrs, ctypes.c_void_p),
            phase.ax << phase.k, phase.ay << phase.k, r, nq, phase.k,
            _cuda.stream(src.device))
    _cuda.raise_on_error(symbol, rc)
    launches["up_" + inst] += 1


def _up_cuda(p2m_w, m2m, src, n: int, p2m: bool) -> list:
    lx, ly = src.shape[:2]
    r = m2m.shape[-1]
    nq = src.shape[-1] if p2m else 0
    item = src.element_size()
    if lx % (1 << n) or ly % (1 << n):
        raise ValueError(f"({lx}, {ly}) boxes do not reduce by {n} levels")
    out = [] if p2m else [src]
    for s in range(0 if p2m else 1, n + 1):
        out.append(torch.empty((lx >> s, ly >> s, r), dtype=src.dtype,
                               device=src.device))
    level = 0                         # the phase's finest, from the leaf
    for phase in up_plan(lx, ly, n, r, item, p2m):
        first = p2m and level == 0
        _up_launch(src if first else out[level], p2m_w if first else None,
                   m2m, out[level + (0 if first else 1):level + phase.k + 1],
                   phase, r, nq)
        level += phase.k
    return out


def up_pass(p2m_w, m2m, u, n: int) -> list:
    """[M_leaf, M_{leaf-1}, ..., M_{leaf-n}] from the charges u (lx, ly,
    nq)."""
    if u.device.type == "cpu":
        return up_pass_plain(p2m_w, m2m, u, n)
    _cuda.instance("u", u)
    dt = u.dtype
    r, nq = p2m_w.shape
    _check_ops(p2m_w, m2m, None, r, nq, dt)
    _cuda.check("u", u, tuple(u.shape[:2]) + (nq,), dt)
    return _up_cuda(p2m_w, m2m, u, n, True)


def up_from(m2m, M, n: int) -> list:
    """[M, M_{-1}, ..., M_{-n}] from the multipoles M (mx, my, r) of one
    level."""
    if M.device.type == "cpu":
        return up_from_plain(m2m, M, n)
    _cuda.instance("M", M)
    dt = M.dtype
    r = M.shape[-1]
    _check_ops(None, m2m, None, r, 0, dt)
    _cuda.check("M", M, tuple(M.shape[:2]) + (r,), dt)
    return _up_cuda(None, m2m, M, n, False)


def down(m2m, L0, Ts, l2t=None, near=None):
    """L2L from L0 (D, mx, my, r) through Ts (each (D, 2^j mx, 2^j my,
    r)); with l2t and near (D, lx, ly, nq), the corrected matvec (D, lx,
    ly, nq), else the last level's L.  Without the mode axis: one mode."""
    if L0.dim() == 3:
        return down(m2m, L0[None], [T[None] for T in Ts], l2t,
                    None if near is None else near[None])[0]
    if L0.device.type == "cpu":
        return down_plain(m2m, L0, Ts, l2t, near)
    return _down_cuda(m2m, L0, Ts, l2t, near)


def _down_cuda(m2m, L0, Ts, l2t, near):
    inst = _cuda.instance("L0", L0)
    dt = L0.dtype
    D, mx, my, r = L0.shape
    n = len(Ts)
    nq = 0 if l2t is None else l2t.shape[0]
    _check_ops(None, m2m, l2t, r, nq, dt)
    specs = [("L0", L0, (D, mx, my, r))]
    specs += [(f"T[{j}]", T, (D, mx << (j + 1), my << (j + 1), r))
              for j, T in enumerate(Ts)]
    lx, ly = mx << n, my << n
    if l2t is not None:
        specs.append(("near", near, (D, lx, ly, nq)))
    _cuda.check_all(dt, *specs)
    symbol = DOWN_SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _DOWN_ARGTYPES)
    plan = down_plan(mx, my, n, r, L0.element_size(), l2t is not None)
    L, j = L0, 0
    for i, phase in enumerate(plan):
        last = i == len(plan) - 1
        ex, ey = phase.ax << phase.k, phase.ay << phase.k
        epi = last and l2t is not None
        out = torch.empty((D, ex, ey, nq if epi else r), dtype=dt,
                          device=L0.device)
        ptrs = _ptrs(Ts[j:j + phase.k])
        rc = fn(_cuda.ptr(L), ctypes.cast(ptrs, ctypes.c_void_p),
                _cuda.ptr(m2m), _cuda.ptr(l2t if epi else None),
                _cuda.ptr(near if epi else None), _cuda.ptr(out),
                phase.ax, phase.ay, r, nq, phase.k, D,
                _cuda.stream(L0.device))
        _cuda.raise_on_error(symbol, rc)
        launches["down_" + inst] += 1
        L, j = out, j + phase.k
    return L
