"""K11, K11-S and K12: one Arnoldi step of GMRES with its state on the
device.

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
      The Givens step is K11's epilogue (cgs2_givens: one launch a step)
      and K11-S's.  cgs2, K11 without the epilogue, and givens_step, the
      Givens step alone, run on no solver path: they serve to measure K11
      and the step apart, and the tests.
  K11-S (cgs2_givens_shards): the same step on a sharded basis (JAX's
      "per-shard contraction + an (m+1)-scalar psum", gmres.py:13-21, as
      benchmarks/sharded_solve.py:107-112 runs it): per local shard k its
      part V_k (m + 1, n_k) of the basis, its part w_k of the matvec's
      output and its input buffer u_k; rows above i masked, never sliced,
      so that no shape depends on i.  One cooperative launch a step, the
      Givens step its epilogue, where every shard of the process is on one
      card and no process group is up (the fused route); else four
      launches a card with the caller's sum over cards and processes
      between them (the split route).  cgs2_shard_plain, with
      givens_step_masked, is its plain version: no host read, so that the
      CPU runs the sharded step as the card's graph does.

The CUDA kernels are csrc/krylov.cu; its header states the bound (bytes for
K11, a launch's latency for K12) and the design (K11 and K11-S one block
code, one cooperative launch in three passes between grid barriers over
the shards' vectors cut into one range an SM, fixed-order float64 sums;
on a small field the lean instance, its range resident or read in place;
else at step i a block keeps the most of its range that fits shared memory
and streams the rest through a ring of bulk copies (k11_plan, a pure
function of the shapes; step_shape, what a block does at step i), block 0
running the Givens step after the last barrier; K12's step alone one
thread; the back-substitution one block, H's triangle in shared memory,
32-column diagonal blocks solved on one warp).  The step's i, j,
stopping flag, tolerances and H, s, cs, sn live in one float64 `state`
tensor (state_layout); every kernel reads i, j and done from it and does
nothing when the step is inactive (done, i = m or j > max_iter), so a
captured step can be replayed without the host looking.

Wrappers: a state on the CPU takes the plain version (JAX's masked
full-basis pass for K11, the bookkeeping in tensor operations for K12); a
CUDA one launches the kernel or raises.  `launches` counts K11 launches per
instance (with or without the Givens epilogue), `shard_launches` K11-S's,
`givens_launches` K12's two entries of their own.
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
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
_STATE_ARGTYPES = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)
SHARD_SYMBOLS = {"f32": "aniso_cgs2_shards_f32",
                 "f64": "aniso_cgs2_shards_f64"}
_SHARD_ARGTYPES = ((ctypes.c_void_p, ctypes.c_int)
                   + (ctypes.c_void_p,) * 2
                   + (ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_int, ctypes.c_longlong) + (ctypes.c_int,) * 7
                   + (ctypes.c_void_p,))
MAX_SHARDS = 16                 # K11-S's shards a launch (kMaxShards)
FUSED = 4                       # K11-S's one-launch phase (kFused)
EMPTY = 5                       # the empty step's phase (kEmpty)
CONSUMER_WARPS = 12             # K11's consumer warps (kConsumerWarps)
LEAN_WARPS = 16                 # the lean instance's warps (kLeanWarps)
RMAX = 8                        # rows a thread sums in registers (kRmax)
MAX_STAGES = 4                  # the ring's stages at most (kMaxStages)
ALIGN = 8                       # vectors of a 128-byte line (kAlign)
STAGE_MAX = 65536               # a stage's bytes at most
STAGES = 3                      # the ring's stages
L2_BLOCK = 320 * 1024           # a vector block's rows' bytes (kL2Block)
BULK_MIN = 2048                 # a bulk-copied row's least bytes (kBulkMin)
MIN_VECTORS = 32                # a block's least share, in vectors

launches = {"f32": 0, "f64": 0}                  # K11
shard_launches = {"f32": 0, "f64": 0}            # K11-S
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


class K11Plan(NamedTuple):
    """K11's and K11-S's launch (csrc/krylov.cu's Plan): `blocks` blocks
    (at most one an SM), each owning `chunk` vectors of vec values of the
    shards' concatenated rows (the last block fewer); a ring of `stages`
    stages of `stage_bytes` (none: the lean instance, where a block's range
    of every row fits its shared memory); `res_bytes` beside it for the
    resident share (none on the split route); `smem` bytes of dynamic
    shared memory, `pool` of them after the ring instance's head."""
    blocks: int
    chunk: int
    vec: int
    stages: int
    stage_bytes: int
    res_bytes: int
    smem: int
    pool: int       # the shared memory after the head: a block's whole
                    # range, where it fits there, needs no ring


class StepShape(NamedTuple):
    """What a block of the plan does at step i (csrc/krylov.cu:shape_of):
    R rows; the resident share, r vectors at row stride rs packs, read G
    lanes a vector, the rows in `rounds`; the rest in nvb vector blocks of
    vb vectors (gs lanes a vector), each nc chunks of rc rows, a chunk a
    stage at row stride ts."""
    R: int
    G: int
    rounds: int
    r: int
    rs: int
    vb: int
    gs: int
    rc: int
    nc: int
    ts: int
    nvb: int
    tile: bool
    whole: bool     # the range resident in the pool, no ring this step


def head_bytes(m: int) -> int:
    """h1, h2, the consumer warps' row and norm sums, the mbarriers, the
    block's segments and the step's shape (csrc/krylov.cu:k11_head)."""
    n = ((2 + CONSUMER_WARPS) * (m + 1) + CONSUMER_WARPS + 2 * MAX_STAGES
         + 1 + 3 * MAX_SHARDS + 1 + 8 + 1) & ~1
    return 8 * n


def lean_head_bytes(m: int) -> int:
    """The lean instance's head: h1, h2 and its warps' row sums
    (csrc/krylov.cu:lean_head)."""
    return 8 * (((2 + LEAN_WARPS) * (m + 1) + 1) & ~1)


def lanes(R: int) -> int:
    """The lanes that share a vector at R rows (csrc/krylov.cu:lanes_of)."""
    G = 1
    while G < 32 and -(-R // G) > RMAX:
        G *= 2
    return G


def _stride_floor(x: int, G: int) -> int:
    """The largest row stride up to x that keeps a quarter-warp's loads in
    eight bank groups at G lanes a vector (0 if none)."""
    if x <= 0:
        return 0
    if G == 1:
        return x
    if G >= 8:
        return x if x & 1 else x - 1
    return max(0, x - (x - 8 // G) % 8)


def _stride_ceil(x: int, G: int) -> int:
    if x <= 0:
        return 0
    if G == 1:
        return x
    if G >= 8:
        return x if x & 1 else x + 1
    return x + (8 // G - x) % 8


def _whole_lines(x: int) -> int:
    return x - x % ALIGN if x >= ALIGN else x


def step_shape(i: int, cv: int, pack: int, plan: K11Plan,
               resident: bool = True) -> StepShape:
    """The shape of step i for a block of cv vectors of `pack` bytes: the
    resident share the whole range where it fits the pool, else the most
    that fits res_bytes beside the ring; tiles of every row and w
    where a stage holds them for rows of BULK_MIN bytes or more; else a
    vector block a vector for each group of gs lanes of the consumer
    threads, gs the fewest (a power of two up to 32) that keep its rows
    under L2_BLOCK bytes and one row in a stage.  A plan with no ring (the
    lean instance, which has no step shape of its own): the whole range
    resident on the fused route, read in place on the split one."""
    R = i + 1
    G = lanes(R)
    rounds = -(-R // (RMAX * G))
    if not plan.stages:
        r = cv if resident else 0
        return StepShape(R, G, rounds, r, r, 0, 0, 0, 0, 0, 0, False,
                         resident)
    r = 0
    whole = resident and (R + 1) * _stride_ceil(cv, G) * pack <= plan.pool
    if whole:
        r = cv
    elif resident and plan.res_bytes > 0:
        r = min(cv, _whole_lines(_stride_floor(
            plan.res_bytes // ((R + 1) * pack), G)))
    vb = gs = rc = nc = ts = nvb = 0
    tv = (_whole_lines(_stride_floor(plan.stage_bytes // ((R + 1) * pack), G))
          if plan.stages else 0)
    tile = bool(plan.stages and cv > r and tv * pack >= BULK_MIN)
    if tile:
        vb, gs, ts, rc, nc = tv, G, _stride_ceil(tv, G), R, 1
        nvb = -(-(cv - r) // tv)
    elif plan.stages and cv > r:
        threads = CONSUMER_WARPS * 32
        l2 = L2_BLOCK // (R * pack)
        one = plan.stage_bytes // pack
        gs = 1
        while gs < 32 and not (threads // gs <= l2 and
                               _stride_ceil(threads // gs, gs) <= one):
            gs *= 2
        vb = threads // gs
        ts = _stride_ceil(vb, gs)
        rc = min(plan.stage_bytes // (ts * pack), R, RMAX * gs)
        nc = -(-R // rc)
        nvb = -(-(cv - r) // vb)
    return StepShape(R, G, rounds, r, _stride_ceil(r, G), vb, gs, rc, nc,
                     ts, nvb, tile, whole)


def shard_resident(i: int, plan: K11Plan, item: int, cv=None,
                   split: bool = False) -> int:
    """The vectors a block of the plan (cv of them; default a whole chunk)
    keeps in shared memory at step i: rows 0..i and w."""
    cv = plan.chunk if cv is None else cv
    return step_shape(i, cv, plan.vec * item, plan, not split).r


@functools.lru_cache(maxsize=None)
def k11_plan(ns: tuple, m: int, item: int, vec: int, sms: int,
             split: bool = False, smem_max: int = SMEM_BLOCK) -> K11Plan:
    """The launch of K11 (ns = (n,)) or K11-S on shards of ns values a row,
    restart m, `item` bytes a value, vec values a load, on a card of `sms`
    SMs with `smem_max` bytes of shared memory a block; a pure function of
    the shapes (no step), so that one captured graph serves every step.
    One block an SM (fewer where a block would own less than MIN_VECTORS
    vectors), each a range of whole 128-byte lines.  The lean instance (no
    ring) where a block's range of the m rows and w fits its shared memory
    beside its head (bench's 64^2 field, the 4 x 32^2 shards): fused, the
    range resident; split, read in place.  Else a ring of STAGES stages of
    up to STAGE_MAX bytes and, fused, the rest beside it for the resident
    share, a step whose whole range fits the pool keeping it all there
    (sharded512's steps 0 and 1)."""
    total = sum(n // vec for n in ns)
    blocks = max(1, min(sms, -(-total // MIN_VECTORS)))
    chunk = -(-total // blocks)
    chunk += -chunk % ALIGN
    blocks = -(-total // chunk)
    pack = vec * item
    lean = lean_head_bytes(m)
    if lean + (m + 1) * chunk * pack <= smem_max:
        smem = lean + (1 if split else m + 1) * chunk * pack
        return K11Plan(blocks, chunk, vec, 0, 0, 0, smem, 0)
    head = head_bytes(m)
    stage = min(STAGE_MAX, (smem_max - head) // STAGES // 16 * 16)
    res = 0 if split else (smem_max - head - STAGES * stage) // 16 * 16
    smem = head + STAGES * stage + res
    plan = K11Plan(blocks, chunk, vec, STAGES, stage, res, smem, smem - head)
    if step_shape(m - 1, chunk, pack, plan, False).rc < 1:
        raise ValueError(f"K11: a stage of {stage} bytes holds no chunk of "
                         f"{m + 1} rows")
    return plan


def block_ranges(ns: tuple, plan: K11Plan):
    """Each block's segments in block order: (shard, first vector in the
    shard's row, vectors), the blocks' ranges cutting the shards'
    concatenation (csrc/krylov.cu, the kernel's first lines)."""
    off = [0]
    for n in ns:
        off.append(off[-1] + n // plan.vec)
    out = []
    for b in range(plan.blocks):
        x0 = b * plan.chunk
        x1 = min(x0 + plan.chunk, off[-1])
        out.append([(s, max(x0, off[s]) - off[s],
                     min(x1, off[s + 1]) - max(x0, off[s]))
                    for s in range(len(ns))
                    if max(x0, off[s]) < min(x1, off[s + 1])])
    return out


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
    CGS2 in place, the column into the state."""
    if state.device.type == "cpu":
        return cgs2_plain(V, w, u, state)
    _launch_cgs2(V, w, u, state, givens=False)


def cgs2_givens(V, w, u, state) -> None:
    """One device's step after its matvec: K11 with K12's Givens step as its
    epilogue, one launch (cgs2_plain, then givens_step_plain, on the
    CPU)."""
    m = V.shape[0] - 1
    if state.device.type == "cpu":
        cgs2_plain(V, w, u, state)
        return givens_step_plain(state, m)
    _launch_cgs2(V, w, u, state, givens=True)


def _vec(item, tensors) -> int:
    """Values a load: 16 bytes where every row and pointer takes them."""
    vec = 16 // item
    if any(t.shape[-1] % vec or t.data_ptr() % 16 for t in tensors):
        return 1
    return vec


def _launch_cgs2(V, w, u, state, givens: bool) -> None:
    m = V.shape[0] - 1
    inst = _cuda.instance("V", V)
    n = V.shape[1]
    _cuda.check_all(V.dtype, ("V", V, (m + 1, n)), ("w", w, (n,)),
                    ("u", u, (n,)))
    _check_state(state, m)
    item = V.element_size()
    vec = _vec(item, (V, w, u))
    plan = k11_plan((n,), m, item, vec, _num_sms(state.device.index or 0))
    part = torch.empty((2 * (m + 1) + 1) * plan.blocks, dtype=torch.float64,
                       device=state.device)
    symbol = SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
    rc = fn(_cuda.ptr(V), _cuda.ptr(w), _cuda.ptr(u), _cuda.ptr(state),
            _cuda.ptr(part), part.numel(), n, m, plan.blocks, plan.chunk,
            plan.stages, plan.stage_bytes, plan.res_bytes, vec, int(givens),
            plan.smem, _cuda.stream(state.device))
    _cuda.raise_on_error(symbol, rc)
    launches[inst] += 1


# -- K11-S --

def _step_of(state, m: int):
    """(i, active) of the state's step as tensors, no host read: i clamped
    into [0, m - 1], active iff not done, i < m and j <= max_iter."""
    hdr = state[:HEADER]
    active = ((hdr[DONE] == 0.0) & (hdr[I] < m)
              & (hdr[J] <= hdr[MAX_ITER]))
    return hdr[I].clamp(0, m - 1).long(), active


def cgs2_shard_plain(V, w, u, state, reduce=None) -> None:
    """K11-S's CGS2 in torch: V, w, u this process's shards' (m + 1, n_k),
    (n_k) and (n_k) parts in shard order.  Each pass a per-shard
    contraction on the basis masked above i (torch.where: a row above i is
    never read, whatever it holds), summed in shard order on the state's
    device and then by `reduce` (in place, over processes; None: this
    process holds every shard); V[i+1] = u = w'' / (|w''| or 1), w'' into
    w, the column and h2 into the state, as cgs2_plain.  Nothing depends on
    a host read: an inactive step selects the old values everywhere."""
    m = V[0].shape[0] - 1
    L = state_layout(m)
    dev = state.device
    i, active = _step_of(state, m)
    rows = torch.arange(m + 1, device=dev)
    mask = (rows <= i) & active

    def total(parts):
        acc = parts[0].to(dev, copy=True)
        for p in parts[1:]:
            acc += p.to(dev)
        if reduce is not None:
            reduce(acc)
        return acc

    Vm = [torch.where(mask.to(Vk.device)[:, None], Vk, 0) for Vk in V]
    h1 = total([Vk @ wk for Vk, wk in zip(Vm, w)])
    w1 = [wk - h1.to(wk.device) @ Vk for Vk, wk in zip(Vm, w)]
    h2 = total([Vk @ wk for Vk, wk in zip(Vm, w1)])
    w2 = [wk - h2.to(wk.device) @ Vk for Vk, wk in zip(Vm, w1)]
    wnorm = torch.sqrt(total([wk @ wk for wk in w2]))
    scale = torch.where(wnorm == 0.0, 1.0, wnorm)
    nxt = (i + 1).clamp(max=m)[None]
    for Vk, wk, uk, w2k in zip(V, w, u, w2):
        on = active.to(Vk.device)
        idx = nxt.to(Vk.device)
        v = w2k / scale.to(Vk.device)
        Vk.index_copy_(0, idx, torch.where(on, v, Vk.index_select(0, idx)))
        uk.copy_(torch.where(on, v, uk))
        wk.copy_(torch.where(on, w2k, wk))
    col = torch.where(rows == i + 1, wnorm.to(torch.float64),
                      (h1 + h2).to(torch.float64))
    seg = state[L.col:L.col + m + 1]
    seg.copy_(torch.where(active & (rows <= i + 1), col, seg))
    seg = state[L.h2:L.h2 + m + 1]
    seg.copy_(torch.where(mask, h2.to(torch.float64), seg))


def cgs2_givens_shards(groups, state, combine=None) -> None:
    """K11-S: one step after its matvec on a sharded basis.  groups: per
    card, in order, (V, w, u): lists of its shards' (m + 1, n_k) basis
    parts, (n_k) matvec outputs (left as w'') and (n_k) input buffers; the
    first card holds the state, and a card's shards are at most
    MAX_SHARDS.  combine: None where one card holds every shard of the
    solve (the fused route: one launch a step); else a function that sums
    a list of tensors, one a group, in place across the groups and the
    processes (the split route: four launches a group, `combine` between
    them).  On the CPU cgs2_shard_plain, then givens_step_masked."""
    m = groups[0][0][0].shape[0] - 1
    if state.device.type == "cpu":
        V, w, u = ([t for g in groups for t in g[j]] for j in range(3))
        cgs2_shard_plain(V, w, u, state, None if combine is None
                         else lambda t: combine([t]))
        return givens_step_masked(state, m)
    if combine is None and len(groups) != 1:
        raise ValueError("K11-S: shards on more than one card (or more than "
                         f"{MAX_SHARDS} on one) need the split route")
    _check_state(state, m)
    L = state_layout(m)
    launch = []
    for g, (V, w, u) in enumerate(groups):
        st = state
        if g:                    # a copy of the header, for i and activity
            st = torch.empty(L.len, dtype=torch.float64,
                             device=V[0].device)
            st[:HEADER].copy_(state[:HEADER])
        launch.append(_shard_launch(V, w, u, st, m, split=combine is not None,
                                    givens=g == 0))
    if combine is None:
        return launch[0](FUSED)
    for phase, sl in enumerate((slice(0, m + 1), slice(m + 1, 2 * m + 2),
                                slice(2 * m + 2, 2 * m + 3), None)):
        for fn in launch:
            fn(phase)
        if sl is not None:
            combine([fn.sums[sl] for fn in launch])


def cgs2_shards_empty(V, w, u, state) -> None:
    """K11-S's empty step on one card's shards (a plan with a ring): the
    fused launch's grid, its three grid barriers and sums at the state's
    step with no vector and no write (its fixed cost, for measurement; no
    solver path launches it)."""
    m = V[0].shape[0] - 1
    _check_state(state, m)
    _shard_launch(V, w, u, state, m, split=False, givens=False)(EMPTY)


def _shard_launch(V, w, u, st, m, split: bool, givens: bool):
    """K11-S's launch on one card's shards: its table, plan and scratch,
    as fn(phase); fn.sums: the split route's h1, h2 and |w''|^2."""
    if not 1 <= len(V) <= MAX_SHARDS or not len(V) == len(w) == len(u):
        raise ValueError(f"K11-S: {len(V)} shards on a card, at most "
                         f"{MAX_SHARDS}")
    inst = _cuda.instance("V", V[0])
    device = V[0].device
    for Vk, wk, uk in zip(V, w, u):
        n = Vk.shape[1]
        _cuda.check_all(V[0].dtype, ("V", Vk, (m + 1, n)), ("w", wk, (n,)),
                        ("u", uk, (n,)))
        if Vk.device != device or wk.device != device or uk.device != device:
            raise ValueError("K11-S: a group's shards on more than one card")
    item = V[0].element_size()
    vec = _vec(item, (*V, *w, *u))
    plan = k11_plan(tuple(Vk.shape[1] for Vk in V), m, item, vec,
                    _num_sms(device.index or 0), split=split)
    if plan.chunk >= 1 << 31:
        raise ValueError(f"K11-S: {plan.chunk} vectors a block")
    part = torch.empty((2 * (m + 1) + 1) * plan.blocks, dtype=torch.float64,
                       device=device)
    sums = (torch.empty(2 * m + 3, dtype=torch.float64, device=device)
            if split else None)
    table = []
    for Vk, wk, uk in zip(V, w, u):
        table += [Vk.data_ptr(), wk.data_ptr(), uk.data_ptr(), Vk.shape[1]]
    arr = (ctypes.c_longlong * len(table))(*table)
    symbol = SHARD_SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _SHARD_ARGTYPES)

    def run(phase):
        rc = fn(ctypes.cast(arr, ctypes.c_void_p), len(V), _cuda.ptr(st),
                _cuda.ptr(part), part.numel(), _cuda.ptr(sums), m,
                plan.blocks, plan.chunk, plan.stages, plan.stage_bytes,
                plan.res_bytes, vec, int(givens), phase, plan.smem,
                _cuda.stream(device))
        _cuda.raise_on_error(symbol, rc)
        shard_launches[inst] += 1

    run.sums = sums
    run.blocks = plan.blocks
    return run


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


def givens_step_masked(state, m: int) -> None:
    """givens_step_plain with no host read (K11-S's plain epilogue): the
    same operations in the same order, each result selected by
    torch.where (the earlier rotations for k < i, the writes where the
    step is active), so that an active step's state is bitwise
    givens_step_plain's and an inactive one changes nothing."""
    L = state_layout(m)
    i, active = _step_of(state, m)
    ii = i[None]
    rows = torch.arange(m + 1, device=state.device)
    col = state[L.col:L.col + m + 1].clone()
    cs, sn, s = state[L.cs:L.sn], state[L.sn:L.col], state[L.s:L.cs]
    for k in range(m - 1):                   # the earlier rotations, k < i
        on = i > k
        t = cs[k] * col[k] + sn[k] * col[k + 1]
        nx = -sn[k] * col[k] + cs[k] * col[k + 1]
        col[k] = torch.where(on, t, col[k])
        col[k + 1] = torch.where(on, nx, col[k + 1])
    dx, dy = col.gather(0, ii)[0], col.gather(0, ii + 1)[0]
    c, g = _givens(dx, dy)
    col = col.scatter(0, ii, (c * dx + g * dy)[None])
    col = col.scatter(0, ii + 1, torch.zeros_like(dx)[None])
    s0, s1 = s.gather(0, ii)[0], s.gather(0, ii + 1)[0]
    si = c * s0 + g * s1
    si1 = -g * s0 + c * s1
    Hc = state[L.H:L.s].view(m, m + 1)       # row c: H's column c
    hcol = torch.where(rows <= i + 1, col, Hc.index_select(0, ii)[0])
    resid = si1.abs() / state[NORMB]
    head = {RESID: resid, DONE: (resid < state[TOL]).to(torch.float64),
            I: state[I] + 1, J: state[J] + 1}
    news = [(state[L.col:L.col + m + 1], col),
            (cs, cs.scatter(0, ii, c[None])),
            (sn, sn.scatter(0, ii, g[None])),
            (s, s.scatter(0, ii, si[None]).scatter(0, ii + 1, si1[None]))]
    Hc.index_copy_(0, ii, torch.where(active, hcol,
                                      Hc.index_select(0, ii)[0])[None])
    for seg, new in news:
        seg.copy_(torch.where(active, new, seg))
    for k, v in head.items():
        state[k] = torch.where(active, v, state[k])


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
    """K12: the active step's Givens bookkeeping, then i += 1, j += 1, on
    its own (the sharded route; one device folds it into K11,
    cgs2_givens)."""
    if state.device.type == "cpu":
        return givens_step_plain(state, m)
    _check_state(state, m)
    _launch_state("aniso_givens_step", state, m)
    givens_launches["step"] += 1


def givens_backsub(state, m: int) -> None:
    """K12's cycle end: y from the leading i x i block of H and s (one block,
    H's triangle in shared memory, diagonal blocks of 32 columns on one
    warp)."""
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
