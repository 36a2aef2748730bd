"""K10: the halo fill of domain decomposition.

Replaces aniso_tpu/parallel/halo.py:halo_exchange_1 (:30) applied along x
and then y, the halo-extension step of the shard-local near contraction
(:56) and fine M2L translate (:106).  The CUDA kernel is csrc/halo_fill.cu;
its header states the bound (bytes: the extended blocks written once and
what they copy read once, 19.2 MB for u at 512^2 in f32 on 8 shards: 5.7
us at 3.35 TB/s) and the design: the unit is a run (one output row of one
region column, contiguous on both sides), a warp or a few a run, found by
32-bit index arithmetic, copied in 16- or 8-byte words where source and
destination lie alike, value by value otherwise.

A job is one shard's 3 x 3 grid of regions: regions[a][b] for a, b in
(0, 1, 2) = (low halo, interior, high halo) along x and y.  regions[1][1] is
the shard's own (lx, ly, q) block; the others are (w or lx, w or ly, q)
views of a neighbour's edge slab or corner, or of a receive buffer that
torch.distributed filled (parallel.halo), or None off the global grid
(zeros).  A view's columns are q values apart and its values contiguous;
its rows may lie anywhere (one stride).  The job's result is the
halo-extended block (lx + 2w, ly + 2w, q).

halo_fill takes halo_fill_plain for CPU tensors and launches the kernel for
CUDA tensors, one launch for up to MAX_SHARDS jobs of one device: the
float32 instance or the float64 one, by the blocks' dtype; `launches`
counts kernel launches per instance.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

SOURCE = "halo_fill.cu"
SYMBOLS = {"f32": "aniso_halo_fill_f32", "f64": "aniso_halo_fill_f64"}
_ARGTYPES = ((ctypes.c_void_p,) + (ctypes.c_int,) * 5 + (ctypes.c_void_p,))
MAX_SHARDS = 16           # jobs a launch (kMaxShards in the source)

launches = {"f32": 0, "f64": 0}


def region_shape(a: int, b: int, lx: int, ly: int, w: int, q: int) -> tuple:
    return ((lx if a == 1 else w), (ly if b == 1 else w), q)


def halo_fill_plain(regions, w: int) -> torch.Tensor:
    """The slicing and concatenation of halo_exchange_1 along x, then along
    y on the x-extended block, whose y slabs are the corners and the edge
    slabs of the y neighbours stacked along x."""
    u = regions[1][1]
    lx, ly, q = u.shape

    def part(a, b):
        r = regions[a][b]
        if r is None:
            return u.new_zeros(region_shape(a, b, lx, ly, w, q))
        return r

    ext = torch.cat([part(0, 1), u, part(2, 1)], dim=0)
    lo = torch.cat([part(0, 0), part(1, 0), part(2, 0)], dim=0)
    hi = torch.cat([part(0, 2), part(1, 2), part(2, 2)], dim=0)
    return torch.cat([lo, ext, hi], dim=1)


def _table_row(out, regions, lx, ly, w, q):
    """One job's 19 table entries: out, 9 region pointers, 9 row strides
    in values."""
    ptrs, rows = [], []
    for a in range(3):
        for b in range(3):
            r = regions[a][b]
            if r is None:
                ptrs.append(0)
                rows.append(0)
                continue
            shape = region_shape(a, b, lx, ly, w, q)
            if tuple(r.shape) != shape:
                raise ValueError(f"region ({a}, {b}): shape "
                                 f"{tuple(r.shape)}, expected {shape}")
            if r.dtype != out.dtype:
                raise TypeError(f"region ({a}, {b}): {r.dtype}, expected "
                                f"{out.dtype}")
            if r.device != out.device:
                raise ValueError(f"region ({a}, {b}) on {r.device}, the job "
                                 f"on {out.device}")
            if r.stride(2) != 1 or (r.shape[1] > 1 and r.stride(1) != q):
                raise ValueError(f"region ({a}, {b}): strides {r.stride()}, "
                                 f"expected (*, {q}, 1)")
            ptrs.append(r.data_ptr())
            rows.append(r.stride(0))
    return [out.data_ptr()] + ptrs + rows


def halo_fill(jobs, w: int) -> list:
    """The halo-extended block of every job (all on one device, one dtype,
    one (lx, ly, q))."""
    if not jobs:
        return []
    u0 = jobs[0][1][1]
    if u0.device.type == "cpu":
        return [halo_fill_plain(regions, w) for regions in jobs]
    inst = _cuda.instance("block", u0)
    lx, ly, q = u0.shape
    for regions in jobs:
        _cuda.check("block", regions[1][1], (lx, ly, q), u0.dtype)
        if regions[1][1].device != u0.device:
            raise ValueError("halo_fill: jobs on more than one device")
    symbol = SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
    outs = [torch.empty((lx + 2 * w, ly + 2 * w, q), dtype=u0.dtype,
                        device=u0.device) for _ in jobs]
    for k0 in range(0, len(jobs), MAX_SHARDS):
        table = []
        for out, regions in zip(outs[k0:k0 + MAX_SHARDS],
                                jobs[k0:k0 + MAX_SHARDS]):
            table += _table_row(out, regions, lx, ly, w, q)
        n = len(table) // 19
        arr = (ctypes.c_longlong * len(table))(*table)
        rc = fn(ctypes.cast(arr, ctypes.c_void_p), n, lx, ly, q, w,
                _cuda.stream(u0.device))
        _cuda.raise_on_error(symbol, rc)
        launches[inst] += 1
    return outs
