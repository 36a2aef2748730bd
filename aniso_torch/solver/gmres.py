"""Restarted GMRES with CGS2 orthogonalization and Givens rotations, its
Krylov state on the device.

Counterpart of aniso_tpu/solver/gmres.py (reference gmres.cpp:53-169,
relative residual |Ax - b| / |b|), as the JAX package runs it, one jitted
program (_gmres_jit, aniso_tpu/solver/operator.py:240-259): the same
arithmetic and the same iteration accounting (:154-156, :191-192, :213-241):
j starts at 1 and counts Arnoldi steps (matvecs), the inner loop runs while
i < restart, j <= max_iter and not converged, and iterations = j - 1.

An optional left preconditioner (aniso_tpu gmres.py:97-120; MATLAB's
gmres(A, b, ..., M), which is how the reference applies its diffusion solve,
aniso.m:111-119): `precond` is the action of inv(M), the solve is of
inv(M) A x = inv(M) b, and the reported residual is the preconditioned one.

The Krylov state lives on the field's device:
  * the basis V (restart + 1, *field) in the field's dtype, in natural
    field shape, and u, the matvec's input, which holds V[i];
  * i, j, the stopping flag, normb, tol, max_iter, H, s, cs and sn in one
    float64 tensor (kernels.krylov.state_layout).
One Arnoldi step is w = A(u), then the space's cgs2_givens: CGS2 (V[i+1]
and u written, the column into the state) and the Givens step (the
rotations, s, H, the stopping test, i and j); on one tensor both are one
launch, K11 with K12's step as its epilogue (kernels.krylov.cgs2_givens).
A step is active iff not done, i < restart and j <= max_iter; an inactive
one changes neither V, u nor the state (its matvec runs and is wasted).

Where the space is capturable (a CUDA tensor field; a sharded field whose
shards share one card, parallel.api.ShardedSpace) the step is captured once
into a torch.cuda.CUDAGraph (after one eager step outside the capture,
which makes every first-use build, attribute, plan and communicator) and
replayed; a matvec that cannot be captured raises.  `graphs`, a dict the
caller keeps (TransportSolver's; for a sharded solve one a placed
sharded_solver triple), caches the step's buffers by the space's key (dtype
and shape; a sharded field's mesh shape, block shape and dtype), restart
and whether a preconditioner is applied, for one matvec, and with them one
graph: repeated solves and refinement rounds replay it, and another
preconditioner object replaces it (the plan holds the one it was captured
with, so that what the graph reads stays allocated).  The caller drops
`graphs` when what the matvec reads is replaced.  A replay runs no Python,
so each host counter a step bumps (every kernel module's launches, the
space's own, such as a sharded field's collectives, plus the caller's
`counters`) gets the step's increments, taken at capture, added on each
replay.

The host queues steps and reads the state's header of step t (pinned
buffer, async copy, event) only once step t + 1 is queued, so the card never
waits on the host between steps; when the read shows convergence, the one
step queued behind it is the wasted one (stats["steps_after_done"]; an
eager step, on the CPU or on a mesh that cannot be captured, has nothing to
overlap: each state is read at once).  The
cycle's end runs eagerly on every route: K12's back-substitution, x +=
V[:i]^T y, r = b - A(x), beta, and resid and done on the device, then one
read.  stats
counts every device-to-host read (host_reads: at most iterations +
2 cycles + 2 a solve), the steps run (eager or replayed) and those
replayed, the cycles, solves and captures, and the seconds spent
capturing.

The field arithmetic goes through a space: TensorSpace for one tensor, or
the one a field brings with it (`krylov_space()`): a sharded field's
(parallel.api.Sharded) keeps each shard's part of the basis on the shard's
device and sums each CGS2 pass and each norm over the shards (JAX's
"per-shard contraction + an (m+1)-scalar psum", aniso_tpu/solver/gmres.py
:8-21), its step's CGS2 and Givens step one K11-S launch.  On the CPU the
same loop runs the kernels' plain versions, no graph.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, NamedTuple, Optional

import torch

from ..kernels import krylov, launch_counters
from ..kernels.krylov import DONE, HEADER, I, J, MAX_ITER, NORMB, RESID, TOL

# counted over every solve of the process (differences give one solve's)
stats = {"host_reads": 0, "steps": 0, "replays": 0, "steps_after_done": 0,
         "cycles": 0, "solves": 0, "captures": 0, "capture_s": 0.0}


class GmresResult(NamedTuple):
    x: torch.Tensor
    residual: float            # final relative residual estimate
    iterations: int            # total matvec count (inner iterations)
    converged: bool


class TensorSpace:
    """The arithmetic of a solve on one tensor: the basis one (restart + 1,
    *field) tensor, CGS2 by K11 on its (restart + 1, n) view."""

    counters = ()

    def __init__(self, b: torch.Tensor):
        self.shape = b.shape
        self.device = b.device
        self.capturable = b.device.type == "cuda"

    def key(self, b) -> tuple:
        return (b.dtype, tuple(b.shape))

    def shaped(self, v):
        return v.reshape(self.shape)

    def zeros(self, b):
        return torch.zeros_like(b)

    def norm(self, v) -> torch.Tensor:
        return torch.linalg.vector_norm(v)

    def basis(self, b, n: int):
        # zeros: JAX's masked passes read every row
        return torch.zeros((n,) + tuple(self.shape), dtype=b.dtype,
                           device=b.device)

    def start(self, V, u, r, beta):
        """V[0] = u = r / beta."""
        V[0] = r / beta
        u.copy_(V[0])

    def cgs2_givens(self, V, w, u, state):
        """The step after its matvec: K11 with K12's Givens step as its
        epilogue, one launch (the step's i comes from the state)."""
        krylov.cgs2_givens(V.view(V.shape[0], -1), w.reshape(-1),
                           u.view(-1), state)

    def combine(self, V, y, i: int):
        """sum_k y[k] V[k] over the first i basis vectors (y on the
        device)."""
        Vf = V.view(V.shape[0], -1)
        return (y[:i].to(V.dtype) @ Vf[:i]).reshape(self.shape)


class _Reader:
    """Copies of the state's header read by the host: on the card into a
    ring of pinned slots, each with its event."""

    def __init__(self, state: torch.Tensor, slots: int):
        self.cuda = state.is_cuda
        self.buf = torch.empty((slots, HEADER), dtype=torch.float64,
                               pin_memory=self.cuda)
        self.events = ([torch.cuda.Event() for _ in range(slots)]
                       if self.cuda else None)
        self.n = 0

    def post(self, state) -> int:
        slot = self.n % len(self.buf)
        self.n += 1
        self.buf[slot].copy_(state[:HEADER], non_blocking=self.cuda)
        if self.cuda:
            self.events[slot].record()
        return slot

    def read(self, slot: int) -> list:
        if self.cuda:
            self.events[slot].synchronize()
        stats["host_reads"] += 1
        return self.buf[slot].tolist()

    def now(self, state) -> list:
        return self.read(self.post(state))


class _Plan:
    """A solve's step buffers (V, u, the state) and, on the card, the step
    captured as a CUDA graph with the increments it makes to the counters
    (`delta`, in the counters' order)."""

    def __init__(self, space, b, m: int):
        self.V = space.basis(b, m + 1)
        self.u = space.zeros(b)
        self.state = torch.zeros(krylov.state_layout(m).len,
                                 dtype=torch.float64, device=space.device)
        self.graph = self.delta = self.precond = None


def _lookahead(plan: _Plan) -> int:
    """Steps queued before the oldest one's state is read: 1 behind a
    captured step, so that the card never waits on the host; 0 behind an
    eager one, whose host work overlaps no replay (no step runs after
    convergence)."""
    return 1 if plan.graph is not None else 0


def _get(holder, key):
    """A counter's value; a dict's key not counted yet reads as 0."""
    if isinstance(holder, dict):
        return holder.get(key, 0)
    return getattr(holder, key)


def _bump(counters, delta):
    for (holder, key), d in zip(counters, delta):
        if not d:
            continue
        if isinstance(holder, dict):
            holder[key] = holder.get(key, 0) + d
        else:
            setattr(holder, key, getattr(holder, key) + d)


def _capture(plan: _Plan, step, counters) -> None:
    """One eager step on an inactive state (first-use builds, attributes,
    plans), then the step captured on a side stream, as torch.cuda.graph
    does but without its garbage collection and emptied allocator cache
    (0.2-0.4 s in a large process); the counters keep only real launches.
    The graph keeps its cudaGraph_t beside the instantiated one, so that a
    check can count its kernel nodes (raw_cuda_graph)."""
    dev = plan.state.device
    plan.state[DONE] = 1.0
    step()
    stats["steps"] += 1
    torch.cuda.synchronize(dev)
    before = [_get(h, k) for h, k in counters]
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream(dev)
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            step()
        finally:
            graph.capture_end()
    graph.instantiate()
    torch.cuda.current_stream(dev).wait_stream(side)
    stats["capture_s"] += time.perf_counter() - t0
    stats["captures"] += 1
    delta = [_get(h, k) - b for (h, k), b in zip(counters, before)]
    _bump(counters, [-d for d in delta])       # the capture ran nothing
    plan.graph, plan.delta = graph, delta


def gmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    restart: int = 80,
    max_iter: int = 400,
    tol: float = 1e-12,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    graphs: Optional[dict] = None,
    counters=(),
) -> GmresResult:
    """Solve A x = b for a field b of any shape (a tensor, or a field that
    brings its own space, such as a sharded one).

    graphs: a dict that keeps the captured step between solves of this
    matvec (None: capture for this solve alone).  counters: (holder, key)
    pairs, a dict's item or an object's attribute, that the matvec or the
    preconditioner bump besides the kernels' launches."""
    space = (b.krylov_space() if hasattr(b, "krylov_space")
             else TensorSpace(b))
    m = restart
    L = krylov.state_layout(m)
    x = space.zeros(b) if x0 is None else space.shaped(x0).clone()
    stats["solves"] += 1

    def A(v):
        out = matvec(v)
        if precond is not None:
            out = precond(out)
        return space.shaped(out)

    if precond is not None:
        b = space.shaped(precond(b))

    normb = space.norm(b)
    normb = torch.where(normb == 0.0, 1.0, normb)
    r = b - A(x)
    beta = space.norm(r)

    key = (None if graphs is None
           else space.key(b) + (m, precond is not None))
    plan = None if graphs is None else graphs.get(key)
    if plan is None:
        plan = _Plan(space, b, m)
    if plan.precond is not precond:
        plan.graph, plan.precond = None, precond
    V, u, st = plan.V, plan.u, plan.state

    def step():
        space.cgs2_givens(V, A(u), u, st)

    counters = launch_counters() + list(space.counters) + list(counters)
    if space.capturable and plan.graph is None:
        _capture(plan, step, counters)
    if graphs is not None:
        graphs[key] = plan

    def run():
        if plan.graph is not None:
            plan.graph.replay()
            _bump(counters, plan.delta)
            stats["replays"] += 1
        else:
            step()
        stats["steps"] += 1

    lookahead = _lookahead(plan)
    resid = (beta / normb).to(torch.float64)
    st[I], st[J] = 0.0, 1.0
    st[NORMB] = normb
    st[TOL], st[MAX_ITER] = float(tol), float(max_iter)
    st[RESID] = resid
    st[DONE] = (resid <= tol).to(torch.float64)
    reader = _Reader(st, lookahead + 2)
    hdr = reader.now(st)
    j = 1
    while j <= max_iter and hdr[DONE] == 0.0:
        stats["cycles"] += 1
        space.start(V, u, r, beta)
        st[L.H:L.y].zero_()                    # H, s, cs, sn, col, h2
        st[L.s] = beta
        st[I] = 0.0
        # steps; the state of each read once the next one is queued
        t = k = 0
        pending = collections.deque()
        inner_done = False
        while not inner_done:
            if t < m and j + t <= max_iter:
                run()
                pending.append(reader.post(st))
                t += 1
                if len(pending) <= lookahead:
                    continue
            if not pending:
                break
            inner_done = reader.read(pending.popleft())[DONE] != 0.0
            k += 1
        stats["steps_after_done"] += t - k
        j += k
        # back-substitution on the leading k x k block (gmres.cpp:12-24)
        krylov.givens_backsub(st, m)
        x = x + space.combine(V, st[L.y:L.y + k], k)
        r = b - A(x)
        beta = space.norm(r)
        resid = torch.where(st[DONE] != 0.0, st[L.s + k].abs(),
                            beta.to(torch.float64)) / st[NORMB]
        st[RESID] = resid
        st[DONE] = (resid < tol).to(torch.float64)
        hdr = reader.now(st)

    return GmresResult(x=x, residual=hdr[RESID], iterations=j - 1,
                       converged=hdr[DONE] != 0.0)
