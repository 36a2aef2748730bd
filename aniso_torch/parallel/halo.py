"""Halo exchange, gathers and sums between the shards of a mesh, and the
shard-local near field and fine-level translate.

Counterpart of aniso_tpu/parallel/halo.py.  JAX extends a shard's block by
`lax.ppermute` inside `shard_map` (halo_exchange_1, :30, once along x and
once along y); here halo_exchange fills every shard's halo-extended block
with one launch of K10 (kernels.halo) per device, reading its eight
neighbours: the neighbour's own block when it lives in this process, a
receive buffer that torch.distributed P2P filled when it lives in another.
The corners come from the diagonal neighbours, as JAX's second exchange
carries them; the halo is zero at the global boundary.

near_apply_local (after make_near_apply_shardmap, :56-103) runs K2-S on the
one-square halo of u; fine_translate_local (after
make_fine_translate_shardmap, :106-186) runs K1-S on the multipoles
extended by two boxes, which are the four parity planes of :135-150
extended by one parent box each.

The counterpart of aniso_tpu/parallel/inspect.py, which reads XLA's
collectives out of compiled HLO, is the accounting here: every exchange,
gather and sum is counted at its transport site, by kind ("permute": halo
slabs and corners, one count per direction that carried any; "all-gather":
a level's multipoles or a field assembled whole on a device, its bytes once
per device; "all-reduce": the sums over shards of GMRES, those K11-S takes
inside its launch included), with its bytes summed over the shards.
collective_stats() returns them as a CollectiveStats.  The counts are host
counters: a captured GMRES step bumps them once, at its capture, and
solver.gmres adds the capture's increments on each replay (the space's
`counters`, collective_counters()).  Nothing here reads a tensor on the
host, so that a step that exchanges, gathers and sums can be captured.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.distributed as dist

from ..kernels.halo import halo_fill, region_shape
from ..kernels.m2l import m2l_translate_shard
from ..kernels.near import near_contract_shard

# the eight neighbours as region indices (a, b) of the 3 x 3 grid around a
# shard: offset (a - 1, b - 1) in shards
DIRECTIONS = tuple((a, b) for a in range(3) for b in range(3)
                   if (a, b) != (1, 1))


class CollectiveStats(NamedTuple):
    """Copy of aniso_tpu/parallel/inspect.py:CollectiveStats."""
    counts: Dict[str, int]    # op name -> number of instructions
    bytes: Dict[str, int]     # op name -> total output bytes (per shard)

    def total_bytes(self) -> int:
        return sum(self.bytes.values())


KINDS = ("permute", "all-gather", "all-reduce")
_counts: Dict[str, int] = {}
_bytes: Dict[str, int] = {}


def reset_collectives() -> None:
    _counts.clear()
    _bytes.clear()


def collective_stats() -> CollectiveStats:
    """What was exchanged since the last reset_collectives()."""
    return CollectiveStats(dict(_counts), dict(_bytes))


def collective_counters() -> list:
    """(dict, kind) of every count and byte total: what a captured GMRES
    step's replays add to (a kind not counted yet reads as 0)."""
    return [(d, kind) for d in (_counts, _bytes) for kind in KINDS]


def _count(kind: str, nbytes: int, n: int = 1) -> None:
    _counts[kind] = _counts.get(kind, 0) + n
    _bytes[kind] = _bytes.get(kind, 0) + nbytes


def count_kernel_sums(nbytes: int, n: int) -> None:
    """n sums over shards that a kernel takes inside its launch (K11-S's
    fused route), counted as the all-reduces they stand for."""
    _count("all-reduce", nbytes, n)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def neighbour_region(block: torch.Tensor, a: int, b: int, w: int):
    """The part of a neighbour's block that fills region (a, b) of the
    shard it borders: its last w rows for the shard's low halo (a = 0),
    all of them for a = 1, its first w for a = 2; the same along y."""
    lx, ly = block.shape[:2]
    rows = (slice(lx - w, lx), slice(0, lx), slice(0, w))[a]
    cols = (slice(ly - w, ly), slice(0, ly), slice(0, w))[b]
    return block[rows, cols]


def _exchange_remote(mesh, blocks, w: int) -> dict:
    """Regions whose neighbour lives in another process, by P2P: {(k, a,
    b): receive buffer} for this process's shards k.  Every process walks
    the same global order of (k, a, b), which pairs the sends and receives
    between two processes (a tag names each for gloo)."""
    if not mesh.multiprocess:
        return {}
    lx, ly, q = next(blocks[k] for k in mesh.local).shape
    ops, recv = [], {}
    for k in range(mesh.size):
        for a, b in DIRECTIONS:
            nb = mesh.neighbour(k, a - 1, b - 1)
            if nb is None or mesh.ranks[nb] == mesh.ranks[k]:
                continue
            tag = 9 * k + 3 * a + b
            if mesh.ranks[nb] == mesh.rank:
                slab = neighbour_region(blocks[nb], a, b, w).contiguous()
                ops.append(dist.P2POp(dist.isend, slab, mesh.ranks[k],
                                      tag=tag))
            elif mesh.ranks[k] == mesh.rank:
                buf = blocks[k].new_empty(region_shape(a, b, lx, ly, w, q))
                recv[k, a, b] = buf
                ops.append(dist.P2POp(dist.irecv, buf, mesh.ranks[nb],
                                      tag=tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def exchange_jobs(mesh, blocks, w: int):
    """K10's jobs (kernels.halo) for every local device, {device: (shards,
    jobs)}, after the P2P of the regions other processes hold; and the
    bytes each direction carries, {(a, b): bytes}."""
    recv = _exchange_remote(mesh, blocks, w)
    moved = dict.fromkeys(DIRECTIONS, 0)
    groups = {}
    for device, ks in mesh.local_groups().items():
        jobs = []
        for k in ks:
            regions = [[None] * 3 for _ in range(3)]
            regions[1][1] = blocks[k]
            for a, b in DIRECTIONS:
                nb = mesh.neighbour(k, a - 1, b - 1)
                if nb is None:
                    continue
                if mesh.ranks[nb] != mesh.rank:
                    r = recv[k, a, b]
                else:
                    r = neighbour_region(blocks[nb], a, b, w).to(device)
                regions[a][b] = r
                moved[a, b] += _nbytes(r)
            jobs.append(regions)
        groups[device] = (ks, jobs)
    return groups, moved


def halo_exchange(mesh, blocks, w: int) -> list:
    """Every local shard's (lx, ly, q) block extended by w on each side,
    (lx + 2w, ly + 2w, q), in shard order (None for other processes'
    shards): K10, one launch a device (the plain version on the CPU)."""
    groups, moved = exchange_jobs(mesh, blocks, w)
    out = [None] * mesh.size
    for ks, jobs in groups.values():
        for k, ext in zip(ks, halo_fill(jobs, w)):
            out[k] = ext
    _count("permute", sum(moved.values()),
           sum(1 for v in moved.values() if v))
    return out


def gather_full(mesh, blocks, devices=None) -> dict:
    """The whole (mx bx, my by, ...) array from every shard's (bx, by, ...)
    block, assembled on each local device (or on `devices`): {device:
    tensor}.  Blocks of other processes come by one all_gather."""
    parts = list(blocks)
    local = mesh.local
    ref = blocks[local[0]]
    if mesh.multiprocess:
        dev0 = ref.device
        flat = torch.cat([blocks[k].reshape(-1).to(dev0) for k in local])
        got = [torch.empty_like(flat) for _ in range(mesh.world)]
        dist.all_gather(got, flat)
        for rank, buf in enumerate(got):
            ks = [k for k in range(mesh.size) if mesh.ranks[k] == rank]
            for k, piece in zip(ks, buf.chunk(len(ks))):
                parts[k] = piece.reshape(ref.shape)
    bx, by = ref.shape[:2]
    mx, my = mesh.shape
    shape = (mx * bx, my * by) + tuple(ref.shape[2:])
    out = {}
    for device in devices or mesh.local_groups():
        full = ref.new_empty(shape, device=device)
        for k, part in enumerate(parts):
            ix, iy = mesh.coords(k)
            full[ix * bx:(ix + 1) * bx, iy * by:(iy + 1) * by] = part
        out[device] = full
    _count("all-gather", sum(_nbytes(t) for t in out.values()))
    return out


def reduce_sum(mesh, parts) -> torch.Tensor:
    """The sum of the local partial results (same shape), in their order
    on the first one's device, then over the processes by one all_reduce
    when a process group is up."""
    acc = parts[0].clone()
    for p in parts[1:]:
        acc += p.to(acc.device)
    if mesh.distributed:
        dist.all_reduce(acc)
    _count("all-reduce", _nbytes(acc))
    return acc


def reduce_sum_(mesh, parts) -> None:
    """reduce_sum in place: every part (one a card or a launch, K11-S's
    split route) becomes the sum of them all over the processes."""
    acc = reduce_sum(mesh, parts)
    for p in parts:
        p.copy_(acc)


def near_apply_local(near_E, near_cosrw, near_static, sigma_w, duffy, ue,
                     mode: int) -> torch.Tensor:
    """One shard's near field (the local body of aniso_tpu
    make_near_apply_shardmap, :70-81) by K2-S: the 3 x 3 contraction on the
    halo-extended ue (lx + 2, ly + 2, nq), the m = 0 diagonal sigma_w * u
    and, in compat mode, the Duffy term; (lx, ly, nq)."""
    return near_contract_shard(near_E, near_cosrw, near_static, ue,
                               sigma_w if mode == 0 else None, duffy)


def fine_translate_local(E, cosr, Mext, shift) -> torch.Tensor:
    """One shard's M2L translate at a sharded level (the local body of
    aniso_tpu make_fine_translate_shardmap, :135-170) by K1-S: E the shard's
    (4, m2x, m2y, r, 27r) slice, Mext its multipoles extended by two boxes
    (halo_exchange with w = 2); the shard's (2 m2x, 2 m2y, r) block of T."""
    return m2l_translate_shard(E, cosr, Mext, shift)
