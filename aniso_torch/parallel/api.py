"""Domain decomposition of the FMM matvec and GMRES over a 2D mesh of shards.

Counterpart of aniso_tpu/parallel/api.py.  JAX shards arrays over a
jax.sharding.Mesh and lets GSPMD (or its shard_map path) place the halos;
torch has no partitioner, so here the decomposition is written out:

  * a Mesh is (mx, my) shards, shard k = ix * my + iy owning the contiguous
    (sz / mx, sz / my) block of squares at (ix, iy), a device and, after
    distributed.init, a process (rank);
  * per-square and per-box caches and fields are Sharded: each shard holds
    its block, made contiguous once at placement; small operators and
    whatever does not divide the mesh are Replicated, one copy a device;
  * a matvec runs the up pass (K8) per shard from the leaf to the coarsest
    level whose boxes fall into whole shard blocks (`stop`); the levels
    above it on the whole level on each device, from the gathered M of
    `stop`; the near field and the fine dense M2L levels per shard on
    halo-extended blocks (K10, then K2-S and K1-S, parallel.halo); the
    other levels (a level whose parity plane does not divide the mesh, a
    per-offset level) on the whole level on each device from the gathered
    M (K1 or K3), each shard keeping its block of T; the locals of the
    levels down to `stop` whole on each device, then per shard from its
    block of them the L2L chain and the leaf's L2T (K8);
  * a field that does not divide the mesh at all (a power-of-two grid on a
    mesh axis of 3) is replicated whole, as shard_pytree replicates what
    does not divide: its Sharded lives on mesh.whole, one shard on this
    process's first device, which computes all of it;
  * GMRES runs on Sharded fields: the basis stays with each shard, CGS2 and
    the norms sum per-shard contractions over the shards (solver.gmres).

Shards that share a device are the port's counterpart of JAX's virtual host
devices (tests/conftest.py): on one card, or on the CPU, every step above
runs, and the halos are copies within the device.  Any mesh make_mesh
builds is taken, as in JAX.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ..fmm.apply import _up_pass, fmm_apply_mode
from ..fmm.structure import coarsest_m2l_level
from ..kernels.krylov import state_layout
from ..kernels.m2l import m2l_translate
from ..kernels.offsets import offsets_translate
from ..kernels.transfer import down, up_from
from . import distributed
from .halo import (
    fine_translate_local, gather_full, halo_exchange, near_apply_local,
    reduce_sum,
)


class Mesh:
    """(mx, my) shards; per shard its device (None for another process's
    shard) and its process."""

    def __init__(self, shape, devices, ranks=None, rank=0, world=1,
                 distributed=False):
        self.shape = tuple(shape)
        self.devices = tuple(devices)
        self.size = self.shape[0] * self.shape[1]
        self.ranks = tuple(ranks or [0] * self.size)
        self.rank = rank
        self.world = world
        self.distributed = distributed      # a process group is up
        self.local = [k for k in range(self.size) if self.ranks[k] == rank]

    @property
    def multiprocess(self) -> bool:
        return self.world > 1

    @functools.cached_property
    def whole(self) -> "Mesh":
        """One shard on this process's first device: where a field that
        does not divide this mesh lives, whole (each process holds and
        computes all of it)."""
        return Mesh((1, 1), [self.devices[self.local[0]]], [self.rank],
                    self.rank)

    def coords(self, k: int) -> tuple:
        return divmod(k, self.shape[1])

    def neighbour(self, k: int, dx: int, dy: int) -> Optional[int]:
        """The shard at (ix + dx, iy + dy), or None off the mesh."""
        ix, iy = self.coords(k)
        ix, iy = ix + dx, iy + dy
        if 0 <= ix < self.shape[0] and 0 <= iy < self.shape[1]:
            return ix * self.shape[1] + iy
        return None

    def local_groups(self) -> dict:
        """{device: this process's shards on it, in shard order}."""
        out = {}
        for k in self.local:
            out.setdefault(self.devices[k], []).append(k)
        return out

    def __repr__(self):
        return (f"Mesh(shape={self.shape}, devices={self.devices}, "
                f"ranks={self.ranks}, rank={self.rank})")


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """A 2D mesh as square as possible (8 -> 2 x 4) over the given devices.

    `devices`: this process's shards' devices, in shard order; a device may
    appear more than once (shards that share it).  Default: every CUDA card
    of the machine, or after distributed.init this process's device.
    n_devices keeps the first n of them.  Across processes (after
    distributed.init) every process names the same number of shards, and
    process p holds the p-th run of them."""
    world, rank = distributed.process_count(), distributed.process_index()
    if devices is None:
        if distributed.is_initialized():
            devices = [distributed.local_device()]
        else:
            if not torch.cuda.is_available():
                raise RuntimeError("make_mesh: CUDA is not available; name "
                                   "the devices (e.g. ['cpu'] * 8)")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    per = len(devices)
    n = per * world
    a = math.isqrt(n)
    while n % a:
        a -= 1
    ranks = [k // per for k in range(n)]
    devs = [devices[k % per] if ranks[k] == rank else None for k in range(n)]
    if distributed.is_initialized() and world > 1:
        # NCCL pairs P2P only once every rank has joined a collective
        torch.distributed.barrier()
    return Mesh((a, n // a), devs, ranks, rank, world,
                distributed.is_initialized())


class Sharded:
    """An array cut into (mx, my) blocks along its dims `dims`: per shard
    its block on its device (None for other processes' shards).  Fields
    (dims (0, 1)) take elementwise arithmetic with Sharded fields and
    scalars, so GMRES runs on them (krylov_space)."""

    def __init__(self, mesh: Mesh, blocks, dims=(0, 1)):
        self.mesh, self.blocks, self.dims = mesh, list(blocks), tuple(dims)

    def local_blocks(self):
        return [self.blocks[k] for k in self.mesh.local]

    def map(self, fn, *others):
        """fn on each local block (and the same shard's block of others)."""
        out = [None] * self.mesh.size
        for k in self.mesh.local:
            out[k] = fn(self.blocks[k], *(
                o.blocks[k] if isinstance(o, Sharded) else o for o in others))
        return Sharded(self.mesh, out, self.dims)

    def __add__(self, o):
        return self.map(torch.add, o)

    def __sub__(self, o):
        return self.map(torch.sub, o)

    def __mul__(self, o):
        return self.map(torch.mul, o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self.map(torch.div, o)

    def clone(self):
        return self.map(torch.clone)

    def full(self) -> torch.Tensor:
        """The whole array on the first local device (every process gets
        it)."""
        if self.dims != (0, 1):
            raise ValueError("full() assembles fields (dims (0, 1))")
        dev = self.blocks[self.mesh.local[0]].device
        return gather_full(self.mesh, self.blocks, [dev])[dev]

    def krylov_space(self):
        return ShardedSpace(self.mesh)


class Replicated:
    """One copy of an array on each device of this process's shards."""

    def __init__(self, per_device: dict):
        self.per_device = per_device

    def on(self, device):
        return self.per_device[device]


class ShardedBasis:
    """A Krylov basis of Sharded fields: each shard's (n, lx, ly, nq) part
    on its device."""

    def __init__(self, mesh: Mesh, parts):
        self.mesh, self.parts = mesh, parts

    def __getitem__(self, i):
        return Sharded(self.mesh, [None if p is None else p[i]
                                   for p in self.parts])

    def __setitem__(self, i, v: Sharded):
        for k in self.mesh.local:
            self.parts[k][i] = v.blocks[k]


class ShardedSpace:
    """GMRES's arithmetic on Sharded fields (solver.gmres.TensorSpace's
    counterpart): every inner product and norm is a per-shard contraction
    summed over the shards in shard order (parallel.halo.reduce_sum, one
    all_reduce of the (i + 1)-vector across processes); no field is
    gathered.  The sums land on the first local shard's device, where the
    solve's state lives and K12 runs on this process's copy of the column;
    nothing is read back inside a step.  The step is not captured."""

    capturable = False

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        first = mesh.local[0]
        self.device = mesh.devices[first]

    def shaped(self, v):
        return v

    def zeros(self, b):
        return b.map(torch.zeros_like)

    def _sum(self, parts):
        return reduce_sum(self.mesh, parts)

    def norm(self, v) -> torch.Tensor:
        return torch.sqrt(self._sum([(blk * blk).sum()
                                     for blk in v.local_blocks()]))

    def basis(self, b, n: int):
        parts = [None] * self.mesh.size
        for k in self.mesh.local:
            blk = b.blocks[k]
            parts[k] = torch.empty((n,) + tuple(blk.shape), dtype=blk.dtype,
                                   device=blk.device)
        return ShardedBasis(self.mesh, parts)

    def start(self, V: ShardedBasis, u: Sharded, r: Sharded, beta):
        """V[0] = r / beta; u views it."""
        for k in self.mesh.local:
            row = V.parts[k][0]
            torch.div(r.blocks[k], beta.to(row.device), out=row)
            u.blocks[k] = row

    def cgs2(self, V: ShardedBasis, w: Sharded, u: Sharded, state, i: int):
        """CGS2 of w against V[:i + 1] (i the host's count of the cycle's
        steps: the host runs only active steps, reading each state at
        once): V[i + 1] = w'' / |w''|, u made its view, the column h1 + h2,
        |w''| written into the state."""
        local = self.mesh.local
        Vf = {k: V.parts[k].view(V.parts[k].shape[0], -1)[: i + 1]
              for k in local}
        wf = {k: w.blocks[k].reshape(-1) for k in local}

        def project(wf):
            h = self._sum([Vf[k] @ wf[k] for k in local])
            return h, {k: wf[k] - h.to(wf[k].device) @ Vf[k] for k in local}

        h1, wf = project(wf)
        h2, wf = project(wf)
        wnorm = torch.sqrt(self._sum([wf[k] @ wf[k] for k in local]))
        scale = torch.where(wnorm == 0.0, 1.0, wnorm)
        for k in local:
            row = V.parts[k][i + 1]
            torch.div(wf[k].view(row.shape), scale.to(row.device), out=row)
            u.blocks[k] = row
        col = state_layout(V.parts[local[0]].shape[0] - 1).col
        state[col:col + i + 2] = torch.cat([h1 + h2, wnorm[None]])

    def combine(self, V: ShardedBasis, y, i: int) -> Sharded:
        out = [None] * self.mesh.size
        for k in self.mesh.local:
            P = V.parts[k]
            yt = y[:i].to(dtype=P.dtype, device=P.device)
            out[k] = torch.tensordot(yt, P[:i], dims=1)
        return Sharded(self.mesh, out)


def _block(mesh: Mesh, x: torch.Tensor, k: int, dims) -> torch.Tensor:
    d0, d1 = dims
    bx, by = x.shape[d0] // mesh.shape[0], x.shape[d1] // mesh.shape[1]
    ix, iy = mesh.coords(k)
    blk = x.narrow(d0, ix * bx, bx).narrow(d1, iy * by, by)
    return blk.to(mesh.devices[k]).contiguous()


def _divisible(shape, mesh: Mesh, d0: int, d1: int) -> bool:
    return (len(shape) > d1
            and shape[d0] % mesh.shape[0] == 0
            and shape[d1] % mesh.shape[1] == 0
            and shape[d0] >= mesh.shape[0] and shape[d1] >= mesh.shape[1])


def shard(mesh: Mesh, x: torch.Tensor, dims=(0, 1)) -> Sharded:
    """x cut into the mesh's blocks along dims, each shard's block made
    contiguous on its device."""
    if not _divisible(x.shape, mesh, *dims):
        raise ValueError(f"shape {tuple(x.shape)} does not divide the mesh "
                         f"{mesh.shape} along dims {dims}")
    blocks = [None] * mesh.size
    for k in mesh.local:
        blocks[k] = _block(mesh, x, k, dims)
    return Sharded(mesh, blocks, dims)


def shard_field(mesh: Mesh, arr) -> Sharded:
    """Place an (sz, sz, ...) per-square array sharded over the mesh; one
    that does not divide it whole on mesh.whole."""
    x = torch.as_tensor(arr)
    if _divisible(x.shape, mesh, 0, 1):
        return shard(mesh, x, (0, 1))
    whole = mesh.whole
    return Sharded(whole, [x.to(whole.devices[0]).contiguous()])


def replicate(mesh: Mesh, arr) -> Replicated:
    x = torch.as_tensor(arr)
    return Replicated({d: x.to(d) for d in mesh.local_groups()})


# per-mode tables: small, replicated whatever their shape
_TABLES = ("m2l_cosr", "near_cosrw", "near_static", "shift", "p2m_w", "l2t",
           "m2m_1d")


def shard_pytree(mesh: Mesh, tree):
    """Place a solver cache / mode-static tree in the port's layouts
    (aniso_tpu shard_pytree's counterpart; its dispatch is on the root key):

      near_E       (sz, sz, nq, 3, 3, nq)    spatial dims 0, 1
      duffy        (D, sz, sz, nq, nq)       spatial dims 1, 2
                   or (sz, sz, nq, nq)       spatial dims 0, 1
      m2l_E levels (4, m2, m2, r, 27r)       spatial dims 1, 2
                   per-offset {'Wo'}         replicated
      fields       (sz, sz, ...)             spatial dims 0, 1 (sigma_w,
                                             coeffs)
      the per-mode tables and anything not divisible: replicated.
    """
    def place(root, x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: place(root or k, v) for k, v in x.items()}
        if root in _TABLES:
            return replicate(mesh, x)
        if root == "m2l_E":
            dims = (1, 2) if x.ndim == 5 else None
        elif root == "near_E":
            dims = (0, 1) if x.ndim == 6 else None
        elif root == "duffy":
            dims = (1, 2) if x.ndim == 5 else (0, 1)
        else:
            dims = (0, 1)
        if dims is not None and _divisible(x.shape, mesh, *dims):
            return shard(mesh, x, dims)
        return replicate(mesh, x)

    return place(None, tree)


def _local(tree, mesh: Mesh, k: int):
    """Shard k's view of a placed tree: its block, or the copy on its
    device."""
    if isinstance(tree, dict):
        return {key: _local(v, mesh, k) for key, v in tree.items()}
    if isinstance(tree, Sharded):
        return tree.blocks[k]
    if isinstance(tree, Replicated):
        return tree.on(mesh.devices[k])
    return tree


class _Sweep:
    """One sharded matvec's exchanges and whole-level work, each done once
    for every shard when its first shard asks (the shards' up passes all
    ran before, from the leaf to level `stop`): the halo-extended M of a
    sharded level, a level's M gathered whole on each device (above `stop`:
    the up pass from the gathered M of `stop`), the whole-level T of a
    replicated-route level, the locals of the levels down to `stop`, the
    gathered coefficient field, the halo-extended u."""

    def __init__(self, mesh, views, caches, M, u, stop):
        self.mesh, self.caches, self.M, self.u = mesh, caches, M, u
        self.stop = stop
        # every device's view of the replicated operators and tables
        self.dev = {device: views[ks[0]]
                    for device, ks in mesh.local_groups().items()}
        self.memo = {}

    def _once(self, key, fn):
        if key not in self.memo:
            self.memo[key] = fn()
        return self.memo[key]

    def _level(self, level):
        return [None if m is None else m[level] for m in self.M]

    def _block(self, k, whole, level):
        """Shard k's block of a whole level's (..., m, m, r) array."""
        bx, by = self.M[k][level].shape[:2]
        ix, iy = self.mesh.coords(k)
        return whole[..., ix * bx:(ix + 1) * bx, iy * by:(iy + 1) * by, :]

    def whole_M(self, level) -> dict:
        """{device: the whole level's M}: gathered at `stop` and below, by
        K8's up pass on each device above it."""
        if level >= self.stop:
            return self._once(("M", level), lambda: gather_full(
                self.mesh, self._level(level)))
        ups = self._once("up", lambda: {
            device: up_from(self.dev[device][0]["m2m_1d"], M,
                            self.stop - coarsest_m2l_level())
            for device, M in self.whole_M(self.stop).items()})
        return {device: Ms[self.stop - level] for device, Ms in ups.items()}

    def translate(self, k, shift, level, E_l, cosr_l, M_l):
        """Shard k's T at `level` (the _down_pass hook)."""
        if isinstance(self.caches["m2l_E"][level], Sharded):
            ext = self._once(("halo", level), lambda: halo_exchange(
                self.mesh, self._level(level), 2))
            return fine_translate_local(E_l, cosr_l, ext[k], shift)
        # replicated route: the whole level on each device, from the
        # gathered M; each shard keeps its block of T
        T = self._once(("T", level), lambda: self._whole_T(level))
        return self._block(k, T[self.mesh.devices[k]], level).contiguous()

    def _whole_T(self, level):
        """{device: the whole level's T} by K1 or K3 on each device; the
        tables and E are replicated."""
        out = {}
        for device, Mw in self.whole_M(level).items():
            static, caches, ms = self.dev[device]
            E_l, cosr_l = caches["m2l_E"][level], ms["m2l_cosr"][level]
            if isinstance(E_l, dict):
                coeffs = self._once("coeffs", lambda: gather_full(
                    self.mesh, self.caches["coeffs"].blocks))[device]
                out[device] = offsets_translate(E_l["Wo"], coeffs, cosr_l,
                                                Mw, static["shift"])
            else:
                out[device] = m2l_translate(E_l, cosr_l, Mw, static["shift"])
        return out

    def start(self, k):
        """(stop, shard k's block of the locals at `stop`), the levels down
        to it run whole on each device by K8's L2L chain; None where `stop`
        is the coarsest level (the shard's chain starts with its T)."""
        lo = coarsest_m2l_level()
        if self.stop == lo:
            return None

        def whole_L():
            T = [self._once(("T", lv), lambda lv=lv: self._whole_T(lv))
                 for lv in range(lo, self.stop + 1)]
            return {device: down(self.dev[device][0]["m2m_1d"], T[0][device],
                                 [t[device] for t in T[1:]])
                    for device in self.dev}

        L = self._once("L", whole_L)[self.mesh.devices[k]]
        return self.stop, self._block(k, L, self.stop).contiguous()

    def near(self, k, caches, ms, mode, u):
        """Shard k's near field (the fmm_apply_mode hook)."""
        ue = self._once("u", lambda: halo_exchange(self.mesh, self.u.blocks,
                                                   1))
        return near_apply_local(caches["near_E"], ms["near_cosrw"],
                                ms["near_static"], caches["sigma_w"],
                                ms["duffy"], ue[k], mode)


def stop_level(block, leaf: int) -> int:
    """The coarsest level (not above the coarsest M2L level) whose boxes
    fall into whole blocks of (bx, by) squares."""
    bx, by = block
    level = leaf
    while (level > coarsest_m2l_level()
           and bx % (1 << (leaf - level + 1)) == 0
           and by % (1 << (leaf - level + 1)) == 0):
        level -= 1
    return level


def _sharded_apply(leaf, static, caches, ms, mode, u: Sharded):
    mesh = u.mesh
    views = {k: (_local(static, mesh, k), _local(caches, mesh, k),
                 _local(ms, mesh, k)) for k in mesh.local}
    stop = stop_level(u.blocks[mesh.local[0]].shape[:2], leaf)
    M = [None] * mesh.size
    for k in mesh.local:
        M[k] = _up_pass(views[k][0], leaf, u.blocks[k], stop)
    sweep = _Sweep(mesh, views, caches, M, u, stop)
    out = [None] * mesh.size
    for k in mesh.local:
        st, cch, msk = views[k]
        out[k] = fmm_apply_mode(
            leaf, st, cch, msk, mode, u.blocks[k],
            translate_fn=functools.partial(sweep.translate, k, st["shift"]),
            near_fn=functools.partial(sweep.near, k), multipoles=M[k],
            start=sweep.start(k))
    return Sharded(mesh, out)


def sharded_solver(solver, mesh: Mesh, halo: str = "gspmd"):
    """Wrap a TransportSolver (fmm backend, after set_coeff) for mesh
    execution: (apply_fn, caches, mode_statics), where apply_fn(caches, ms,
    mode, u) is the corrected mode-m matvec on a Sharded field u (ms =
    mode_statics[m]), a Sharded field back.

    halo: JAX's two names are kept.  torch has no partitioner, so "gspmd"
    and "shardmap" both run the explicit exchange (parallel.halo: K10 halos,
    K2-S and K1-S per shard, whole-level K1 / K3 where a level does not
    split); any other value raises ValueError, as in JAX.  Any mesh: what
    does not divide it is replicated, and a field that does not divide it
    at all (shard_field) is computed whole on each process.
    """
    if halo not in ("gspmd", "shardmap"):
        raise ValueError(f"unknown halo mode {halo!r}")
    if solver.backend_name != "fmm" or solver._caches is None:
        raise ValueError("sharded_solver needs an fmm solver after "
                         "set_coeff")
    static = shard_pytree(mesh, solver._fmm_static)
    caches = shard_pytree(mesh, solver._caches)
    mode_statics = [shard_pytree(mesh, ms) for ms in solver._mode_statics]
    apply_fn = functools.partial(_sharded_apply, solver._tcfg.leaf_level,
                                 static)
    return apply_fn, caches, mode_statics
