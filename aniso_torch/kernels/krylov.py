"""K11 and K12: one Arnoldi step of GMRES with its state on the device.

Replace the body of aniso_tpu/solver/gmres.py's inner lax.while_loop
(:158-193), which the JAX package runs on the device with its stopping
test (:154-156, :191-192), and the back-substitution that follows it
(:200-212):

  K11 (cgs2): CGS2 of w against V[:i+1] (_dots / _comb :45-58, the mask
      :162-167): h1 = V w, w' = w - h1 V, h2 = V w', w'' = w' - h2 V,
      V[i+1] = w'' / (|w''| or 1), the column h1 + h2 with |w''| at i + 1.
      The new basis vector also goes into u, the next step's matvec input.
  K12 (givens_step, givens_backsub): the Givens bookkeeping (:172-193,
      _givens :66-86) and, at a cycle's end, y from the leading i x i block.

The CUDA kernels are csrc/krylov.cu; its header states the bound (bytes for
K11, a launch's latency for K12) and the design (K11 one cooperative launch
in three phases between grid barriers, fixed-order float64 sums, V read
once where a block's chunk of it fits shared memory (cgs2_plan); K12 one
thread).  The step's i, j,
stopping flag, tolerances and H, s, cs, sn live in one float64 `state`
tensor (state_layout); every kernel reads i, j and done from it and does
nothing when the step is inactive (done, i = m or j > max_iter), so a
captured step can be replayed without the host looking.

Wrappers: a state on the CPU takes the plain version (JAX's masked
full-basis pass for K11, the bookkeeping in tensor operations for K12); a
CUDA one launches the kernel or raises.  `launches` counts K11 launches per
instance, `givens_launches` K12's two entries.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _cuda
from .m2l import SMEM_BLOCK

SOURCE = "krylov.cu"
SYMBOLS = {"f32": "aniso_cgs2_f32", "f64": "aniso_cgs2_f64"}
_ARGTYPES = ((ctypes.c_void_p,) * 5
             + (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_longlong)
             + (ctypes.c_int,) * 4 + (ctypes.c_void_p,))
_STATE_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
THREADS = 512                   # K11's block (kThreads in the source)
WARPS = THREADS // 32
ROWS = 8                        # rows the streamed pass (a) holds (kRows)
TILE = 128                      # the narrowest streamed (b) tile (kTile)
MIN_VECTORS = 32                # a block's least share of a row, in vectors

launches = {"f32": 0, "f64": 0}                  # K11
givens_launches = {"step": 0, "backsub": 0}      # K12

# the header of the state
I, J, DONE, NORMB, TOL, MAX_ITER, RESID = range(7)
HEADER = 8


class Layout(NamedTuple):
    H: int          # m columns of m + 1: H[r, c] at H + c (m + 1) + r
    s: int          # m + 1
    cs: int         # m
    sn: int         # m
    col: int        # m + 1: the new column
    h2: int         # m + 1: the second pass's coefficients
    y: int          # m: the back-substitution's solution
    len: int


@functools.lru_cache(maxsize=None)
def state_layout(m: int) -> Layout:
    """Offsets into the float64 state for restart m (csrc/krylov.cu's
    layout)."""
    H = HEADER
    s = H + m * (m + 1)
    cs = s + m + 1
    sn = cs + m
    col = sn + m
    h2 = col + m + 1
    y = h2 + m + 1
    return Layout(H, s, cs, sn, col, h2, y, y + m)


def active_row(header, m: int) -> int:
    """i when a step from this state header is active, else -1."""
    if header[DONE] != 0.0 or header[I] >= m or header[J] > header[MAX_ITER]:
        return -1
    return int(header[I])


def hessenberg(state: torch.Tensor, m: int) -> torch.Tensor:
    """H (m + 1, m) as a view of the state."""
    L = state_layout(m)
    return state[L.H:L.s].view(m, m + 1).t()


# -- K11 --

def cgs2_plain(V, w, u, state) -> None:
    """JAX's step: both passes over all m + 1 rows, masked above i, in the
    field's type; the column in float64 into the state, the second pass's
    coefficients into its h2."""
    m = V.shape[0] - 1
    i = active_row(state[:HEADER].tolist(), m)
    if i < 0:
        return
    L = state_layout(m)
    mask = (torch.arange(m + 1, device=V.device) <= i).to(V.dtype)
    h1 = (V @ w) * mask
    w1 = w - h1 @ V
    h2 = (V @ w1) * mask
    w2 = w1 - h2 @ V
    wnorm = torch.linalg.vector_norm(w2)
    v = w2 / torch.where(wnorm == 0.0, 1.0, wnorm)
    V[i + 1] = v
    u.copy_(v)
    w.copy_(w2)
    col = (h1 + h2).to(torch.float64)
    col[i + 1] = wnorm.to(torch.float64)
    state[L.col:L.col + i + 2] = col[:i + 2]
    state[L.h2:L.h2 + i + 1] = h2[:i + 1].to(torch.float64)


class Cgs2Plan(NamedTuple):
    """K11's launch: `blocks` blocks (at most one an SM), each owning
    `chunk` elements of every row; resident: the block's chunk of V's m
    rows and of w held in shared memory (V read once), else V streamed
    three times, pass (b) keeping up to `stash` rows of a tile of TILE
    vectors (fewer rows of a wider tile) in shared memory, the others read
    again."""
    blocks: int
    chunk: int
    resident: bool
    stash: int
    smem: int       # bytes of dynamic shared memory


def _head_bytes(m: int) -> int:
    """h1, h2 and the warps' row sums (csrc/krylov.cu:cgs2_head)."""
    return 8 * ((2 * (m + 1) + WARPS * max(m + 1, ROWS) + 1) & ~1)


@functools.lru_cache(maxsize=None)
def cgs2_plan(n: int, m: int, item: int, vec: int, sms: int,
              smem_max: int = SMEM_BLOCK, resident=None) -> Cgs2Plan:
    """The launch of K11 on rows of n values of `item` bytes, restart m,
    vec values a load, on a card of `sms` SMs with `smem_max` bytes of
    shared memory a block: one block an SM (fewer where a block would own
    less than MIN_VECTORS vectors), resident where the chunk of m + 1
    rows fits (resident=None; True or False forces the branch, True
    raising where it does not fit)."""
    nv = n // vec
    cv = -(-nv // max(1, min(sms, -(-nv // MIN_VECTORS))))
    blocks = -(-nv // cv)
    pack = vec * item
    head = _head_bytes(m)
    res_smem = head + (m + 1) * cv * pack
    fits = res_smem <= smem_max
    if resident is None:
        resident = fits
    if resident:
        if not fits:
            raise ValueError(f"K11: {m + 1} rows of {cv * vec} values do "
                             "not fit a block's shared memory")
        return Cgs2Plan(blocks, cv * vec, True, 0, res_smem)
    fixed = head + THREADS * (pack + 8 * vec)
    stash = max(0, min(m, (smem_max - fixed) // (TILE * pack)))
    return Cgs2Plan(blocks, cv * vec, False, stash,
                    fixed + stash * TILE * pack)


@functools.lru_cache(maxsize=None)
def _check_layout(m: int) -> None:
    """Raise unless csrc/krylov.cu lays the state out as state_layout."""
    n = _cuda.load(SOURCE, "aniso_krylov_state_len", (ctypes.c_int,))(m)
    if n != state_layout(m).len:
        raise RuntimeError(f"krylov.cu's state for restart {m} has {n} "
                           f"values, state_layout {state_layout(m).len}")


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cgs2(V, w, u, state) -> None:
    """K11 on V (m + 1, n), w (n) (left as w''), u (n), state: the step's
    CGS2 in place."""
    m = V.shape[0] - 1
    if state.device.type == "cpu":
        return cgs2_plain(V, w, u, state)
    inst = _cuda.instance("V", V)
    n = V.shape[1]
    _cuda.check_all(V.dtype, ("V", V, (m + 1, n)), ("w", w, (n,)),
                    ("u", u, (n,)))
    _check_state(state, m)
    item = V.element_size()
    vec = 16 // item
    if n % vec or any(t.data_ptr() % 16 for t in (V, w, u)):
        vec = 1                   # one value a load
    plan = cgs2_plan(n, m, item, vec, _num_sms(state.device.index or 0))
    part = torch.empty((2 * (m + 1) + 1) * plan.blocks, dtype=torch.float64,
                       device=state.device)
    symbol = SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
    rc = fn(_cuda.ptr(V), _cuda.ptr(w), _cuda.ptr(u), _cuda.ptr(state),
            _cuda.ptr(part), part.numel(), n, m, plan.blocks, plan.chunk,
            int(plan.resident), plan.stash, vec, plan.smem,
            _cuda.stream(state.device))
    _cuda.raise_on_error(symbol, rc)
    launches[inst] += 1


# -- K12 --

def _givens(dx, dy):
    """(cs, sn) of gmres.cpp:26-39 on 0-d tensors, JAX's three branches."""
    big = dy.abs() > dx.abs()
    t1 = dx / dy
    sn1 = 1.0 / torch.sqrt(1.0 + t1 * t1)
    t2 = dy / dx
    cs2 = 1.0 / torch.sqrt(1.0 + t2 * t2)
    zero = dy == 0.0
    cs = torch.where(zero, 1.0, torch.where(big, t1 * sn1, cs2))
    sn = torch.where(zero, 0.0, torch.where(big, sn1, t2 * cs2))
    return cs, sn


def givens_step_plain(state, m: int) -> None:
    header = state[:HEADER].tolist()
    i = active_row(header, m)
    if i < 0:
        return
    L = state_layout(m)
    col = state[L.col:L.col + m + 1]
    cs, sn, s = state[L.cs:L.sn], state[L.sn:L.col], state[L.s:L.cs]
    for k in range(i):                       # the earlier rotations
        t = cs[k] * col[k] + sn[k] * col[k + 1]
        col[k + 1] = -sn[k] * col[k] + cs[k] * col[k + 1]
        col[k] = t
    c, g = _givens(col[i].clone(), col[i + 1].clone())
    cs[i], sn[i] = c, g
    col[i] = c * col[i] + g * col[i + 1]
    col[i + 1] = 0.0
    si = c * s[i] + g * s[i + 1]
    si1 = -g * s[i] + c * s[i + 1]
    s[i], s[i + 1] = si, si1
    hessenberg(state, m)[:i + 2, i] = col[:i + 2]
    resid = si1.abs() / header[NORMB]
    state[RESID] = resid
    state[DONE] = (resid < header[TOL]).to(torch.float64)
    state[I] = i + 1
    state[J] = header[J] + 1


def givens_backsub_plain(state, m: int) -> None:
    """y[:i] = H[:i, :i]^-1 s[:i] by back-substitution, y[i:] = 0."""
    L = state_layout(m)
    k = int(state[I])
    H = hessenberg(state, m)
    s, y = state[L.s:L.cs], state[L.y:L.len]
    y.zero_()
    for r in range(k - 1, -1, -1):
        y[r] = (s[r] - H[r, r + 1:k] @ y[r + 1:k]) / H[r, r]


def _launch_state(symbol, state, m):
    fn = _cuda.load(SOURCE, symbol, _STATE_ARGTYPES)
    rc = fn(_cuda.ptr(state), m, _cuda.stream(state.device))
    _cuda.raise_on_error(symbol, rc)


def _check_state(state, m):
    _cuda.check("state", state, (state_layout(m).len,), torch.float64)
    _check_layout(m)


def givens_step(state, m: int) -> None:
    """K12: the active step's Givens bookkeeping, then i += 1, j += 1."""
    if state.device.type == "cpu":
        return givens_step_plain(state, m)
    _check_state(state, m)
    _launch_state("aniso_givens_step", state, m)
    givens_launches["step"] += 1


def givens_backsub(state, m: int) -> None:
    """K12's cycle end: y from the leading i x i block of H and s."""
    if state.device.type == "cpu":
        return givens_backsub_plain(state, m)
    _check_state(state, m)
    _launch_state("aniso_givens_backsub", state, m)
    givens_launches["backsub"] += 1


def launch_floor(device) -> None:
    """An empty one-block launch: the latency floor K12 is held against.
    Not K12: it counts no launch."""
    fn = _cuda.load(SOURCE, "aniso_krylov_floor", (ctypes.c_void_p,))
    _cuda.raise_on_error("aniso_krylov_floor",
                         fn(_cuda.stream(torch.device(device))))
