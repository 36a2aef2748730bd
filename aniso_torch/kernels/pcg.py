"""K9: the Jacobi-preconditioned CG of the DSA preconditioner, the whole
loop in one kernel launch.

Replaces aniso_tpu/solver/dsa.py:pcg (:114-141), which the JAX package runs
as one lax.while_loop on the device with its stopping test there too, with
the diffusion stencil (K9d, kernels.diffusion) inside.  The CUDA kernels
are csrc/pcg.cu; its header states the bound (bytes: p and the blocks'
partial sums an iteration, or for the strided instance the state and the
stencil's fields; in practice the latency of its two barriers an
iteration) and the design (the state in registers, or in global memory
for the strided instance; deterministic sums across blocks that every
block takes alike, the neighbours' p formed from their z and old p so that
two barriers an iteration suffice).

    A z = sigma_a z - div(D grad z)   (the 5-point stencil of K9d)
    x = 0, r = b, z = r / diag, p = z
    while k < max_iter and r.r > tol^2 b.b (b.b taken as 1 where it is 0):
        alpha = r.z / p.Ap; x += alpha p; r -= alpha Ap; z = r / diag
        p = z + (r.z new / r.z) p

Layouts: b, diag, robin, sigma_a (sz, sz); Dx (sz-1, sz); Dy (sz, sz-1).

Three instances, chosen before the launch by pcg_plan, a pure function of
the grid, the dtype, the card's SMs and each instance's occupancy:
"cluster", one thread-block cluster of at most MAX_CLUSTER blocks, each
owning whole rows of the grid in its shared memory (the neighbours' rows
through distributed shared memory), where one cluster holds the grid, the
card can schedule it and the grid is no larger than CLUSTER_MAX_SZ; else
"grid", one cooperative launch of as many blocks as the cells need at up
to 16 cells a thread, the state in registers, if the card holds them at
once; else "strided", one cooperative launch of as many blocks as the card
holds at once, each thread taking its cells by a grid-stride loop with the
state in global memory (every grid past 1039^2 on the H100).

pcg takes pcg_plain for CPU tensors and launches the kernel for CUDA
tensors (float32 or float64, by b's dtype); it returns (x, k), k a Python
int from pcg_plain and a 0-d int32 tensor on the card from the kernel
(nothing is read back inside the call).  `launches` counts kernel launches
per instance and dtype ("cluster_f32", "grid_f64", "strided_f32", ...).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from . import _cuda
from .diffusion import diffusion_apply_plain
from .m2l import SMEM_BLOCK

SOURCE = "pcg.cu"
SYMBOLS = {"f32": "aniso_pcg_f32", "f64": "aniso_pcg_f64"}
BARRIER_SYMBOLS = {"f32": "aniso_pcg_barriers_f32",
                   "f64": "aniso_pcg_barriers_f64"}
OCCUPANCY_SYMBOLS = {"f32": "aniso_pcg_occupancy_f32",
                     "f64": "aniso_pcg_occupancy_f64"}
_ARGTYPES = ((ctypes.c_void_p,) * 12
             + (ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_double, ctypes.c_double, ctypes.c_double)
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
_BARRIER_ARGTYPES = ((ctypes.c_void_p,) + (ctypes.c_int,) * 8
                     + (ctypes.c_void_p,))
_OCCUPANCY_ARGTYPES = (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
THREADS = 512                   # the kernel's block (kThreads in pcg.cu)
CELLS = (1, 2, 4, 8, 16)        # cells a thread, the compiled instances
MAX_CLUSTER = 16                # blocks a cluster (kMaxCluster in pcg.cu)
# the largest grid side the cluster instance takes: the largest at which it
# was timed against the grid instance on the same card and beat it
# (tools/kernel_ab.py --variants k9; at 256^2 the grid's 128 blocks beat a
# cluster of 16 at 8 cells a thread)
CLUSTER_MAX_SZ = 128
# pcg.cu's kGrid, kCluster, kStrided
INSTANCE_CODES = {"grid": 0, "cluster": 1, "strided": 2}

launches = {f"{inst}_{dt}": 0
            for inst in INSTANCE_CODES for dt in ("f32", "f64")}


class PcgResult(NamedTuple):
    x: torch.Tensor
    iterations: int | torch.Tensor


def pcg_plain(b, diag, Dx, Dy, robin, sigma_a, dx: float, *,
              tol: float = 1e-8, max_iter: int = 500) -> PcgResult:
    """The JAX loop step by step, with the stencil's plain version and one
    scalar read back per iteration for the stopping test."""
    inv_diag = 1.0 / diag
    bnorm2 = float((b * b).sum())
    bnorm2 = 1.0 if bnorm2 == 0.0 else bnorm2
    stop = tol * tol * bnorm2

    x = torch.zeros_like(b)
    r = b
    z = inv_diag * r
    p = z
    rz = (r * z).sum()
    k = 0
    while k < max_iter and float((r * r).sum()) > stop:
        ap = diffusion_apply_plain(p, Dx, Dy, robin, sigma_a, dx)
        alpha = rz / (p * ap).sum()
        x = x + alpha * p
        r = r - alpha * ap
        z = inv_diag * r
        rz_new = (r * z).sum()
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return PcgResult(x, k)


class PcgPlan(NamedTuple):
    """K9's launch on a sz x sz grid: the instance, `cells` cells a thread
    (THREADS a block; the strided instance: the most any thread takes) and
    `blocks` blocks; the cluster instance is one cluster of `blocks`, each
    owning `rows` whole rows of the grid (the last one the rest) with
    `smem` bytes of dynamic shared memory: their z and old p with a halo
    row on each side, and the ranks' partial sums."""
    instance: str       # "cluster", "grid" or "strided"
    cells: int
    blocks: int
    rows: int           # cluster: grid rows a block; grid: 0
    smem: int           # cluster: dynamic shared memory bytes; grid: 0


def cluster_smem(rows: int, sz: int, item: int) -> int:
    """The cluster instance's dynamic shared memory (pcg.cu's
    cluster_smem): z and the old p of the block's rows and a halo row
    above and below, then the ranks' three partial sums."""
    return item * (2 * (rows + 2) * sz + 3 * MAX_CLUSTER)


def pcg_plan(sz: int, item: int, sms: int,
             occupancy: Callable[[str, int, int, int], int],
             smem_max: int = SMEM_BLOCK) -> PcgPlan:
    """The instance K9 takes for a sz x sz grid of `item`-byte values on a
    card of `sms` SMs.  occupancy(instance, cells, blocks, smem): for
    "cluster" the clusters of `blocks` blocks the card schedules at once
    (0: none), for "grid" and "strided" the blocks an SM holds at once.  Up
    to CLUSTER_MAX_SZ, the cluster instance with the fewest cells a thread
    whose whole rows make at most MAX_CLUSTER blocks, fit shared memory and
    can be scheduled; else the grid instance with the fewest cells a thread
    whose blocks the card holds at once; else the strided instance on as
    many blocks as the card holds at once (no more than the cells fill).
    ValueError for an empty grid, or a card that holds no block of the
    strided instance."""
    if sz < 1:
        raise ValueError(f"K9: a {sz} x {sz} grid")
    for cells in CELLS if sz <= CLUSTER_MAX_SZ else ():
        rows = min(sz, THREADS * cells // sz)
        if rows < 1:
            continue
        blocks = -(-sz // rows)
        smem = cluster_smem(rows, sz, item)
        if (blocks <= MAX_CLUSTER and smem <= smem_max
                and occupancy("cluster", cells, blocks, smem) > 0):
            return PcgPlan("cluster", cells, blocks, rows, smem)
    for cells in CELLS:
        blocks = -(-sz * sz // (THREADS * cells))
        if blocks <= occupancy("grid", cells, blocks, 0) * sms:
            return PcgPlan("grid", cells, blocks, 0, 0)
    per_sm = occupancy("strided", 1, 1, 0)
    if per_sm < 1:
        raise ValueError("K9: the card holds no block of the strided "
                         "instance")
    n = sz * sz
    blocks = min(per_sm * sms, -(-n // THREADS))
    return PcgPlan("strided", -(-n // (blocks * THREADS)), blocks, 0, 0)


def _occupancy(index: int, inst: str):
    """occupancy() for pcg_plan from the card (pcg.cu's occupancy)."""
    fn = _cuda.load(SOURCE, OCCUPANCY_SYMBOLS[inst], _OCCUPANCY_ARGTYPES)

    @functools.lru_cache(maxsize=None)
    def occ(instance: str, cells: int, blocks: int, smem: int) -> int:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = fn(INSTANCE_CODES[instance], cells, blocks, smem,
                    ctypes.byref(out))
        _cuda.raise_on_error(OCCUPANCY_SYMBOLS[inst], rc)
        return out.value

    return occ


@functools.lru_cache(maxsize=None)
def plan_on(index: int, sz: int, inst: str) -> PcgPlan:
    """pcg_plan for card `index`, a sz x sz grid, dtype `inst`."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return pcg_plan(sz, 4 if inst == "f32" else 8, sms,
                    _occupancy(index, inst))


def _scratch(plan: PcgPlan, sz: int, dtype, device):
    """(z, old p, r, A p, partial sums): the grid instance's z and old p
    buffers and its partial sums (three a block), and for the strided
    instance its r and A p buffers beside them; None where an instance
    keeps the value elsewhere (the cluster in shared memory, the grid r and
    A p in registers)."""
    if plan.instance == "cluster":
        return None, None, None, None, None
    n_fields = 4 if plan.instance == "strided" else 2
    fields = [torch.empty((sz, sz), dtype=dtype, device=device)
              for _ in range(n_fields)] + [None] * (4 - n_fields)
    return (*fields, torch.empty(3 * plan.blocks, dtype=dtype, device=device))


def pcg(b, diag, Dx, Dy, robin, sigma_a, dx: float, *, tol: float = 1e-8,
        max_iter: int = 500) -> PcgResult:
    if b.device.type == "cpu":
        return pcg_plain(b, diag, Dx, Dy, robin, sigma_a, dx, tol=tol,
                         max_iter=max_iter)
    inst = _cuda.instance("b", b)
    sz = b.shape[0]
    dt = b.dtype
    _cuda.check_all(dt, ("b", b, (sz, sz)), ("diag", diag, (sz, sz)),
                    ("Dx", Dx, (sz - 1, sz)), ("Dy", Dy, (sz, sz - 1)),
                    ("robin", robin, (sz, sz)),
                    ("sigma_a", sigma_a, (sz, sz)))
    plan = plan_on(b.device.index or 0, sz, inst)
    symbol = SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
    x = torch.empty_like(b)
    zb, pb, rb, ab, part = _scratch(plan, sz, dt, b.device)
    k = torch.empty((), dtype=torch.int32, device=b.device)
    rc = fn(_cuda.ptr(Dx), _cuda.ptr(Dy), _cuda.ptr(robin),
            _cuda.ptr(sigma_a), _cuda.ptr(diag), _cuda.ptr(b), _cuda.ptr(x),
            _cuda.ptr(zb), _cuda.ptr(pb), _cuda.ptr(rb), _cuda.ptr(ab),
            _cuda.ptr(part),
            0 if part is None else part.numel(), _cuda.ptr(k), sz,
            1.0 / (dx * dx), 1.0 / dx, tol * tol, max_iter,
            INSTANCE_CODES[plan.instance], plan.cells, plan.blocks,
            plan.rows, plan.smem, _cuda.stream(b.device))
    _cuda.raise_on_error(symbol, rc)
    launches[f"{plan.instance}_{inst}"] += 1
    return PcgResult(x, k)


def barrier_loop(sz: int, iters: int, dtype, device) -> None:
    """K9's loop skeleton alone (its block sums, sums across blocks and two
    barriers an iteration, no stencil or vector update) for `iters`
    iterations in the instance and on the blocks K9 takes for a sz x sz
    grid: its time is the loop's latency floor.  Not K9: it counts no
    launch."""
    inst = _cuda.INSTANCES[dtype]
    device = torch.device(device)
    plan = plan_on(device.index or 0, sz, inst)
    symbol = BARRIER_SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _BARRIER_ARGTYPES)
    part = _scratch(plan, sz, dtype, device)[4]
    rc = fn(_cuda.ptr(part), 0 if part is None else part.numel(), sz,
            INSTANCE_CODES[plan.instance], plan.cells, plan.blocks,
            plan.rows, plan.smem, iters, _cuda.stream(device))
    _cuda.raise_on_error(symbol, rc)
