"""Wall times of the sharded GMRES solves of chip_smoke.py's sharded512,
sharded64_compat and distributed1 phases, repeated in one process, for
comparing two checkouts of the port on one card.

    python3 tools/sharded_times.py [--tree DIR] [--reps 5]

imports aniso_torch from DIR (default: the checkout that holds this file),
builds each phase's solver and its sharded operator once, solves once
untimed (where the tree captures the sharded step, into a dict of graphs
kept for the phase, as chip_smoke.py keeps one), then times `reps` solves
(the rhs matvec and GMRES, as the phases time them) and profiles one
more.  It prints one JSON line: the card and its power limit, the tree,
and per phase whether its steps were captured, the times, their median,
the iterations, and the device seconds, device kernels and busy share
(device seconds over its wall seconds) of the profiled solve;
matvec_host_s: the host seconds spent inside GMRES's matvec calls made
from Python (issuing their kernels: the card runs behind; a replayed
step makes none), rest_host_s: the solve's other seconds (the rhs,
GMRES's own work, its replays and its waits on the card).
Run two trees alternately (A B B A ...) on one card to compare them.  The
phases' shapes are those of chip_smoke.py:
  sharded512: 512^2, deg 3, g 0.5, np 4, f32, tol 1e-7, a 2 x 4 mesh;
  sharded64_compat: 64^2, N = 2, g 0.95, the reference's basis quirk, a
  2 x 2 mesh;
  distributed1: 64^2, N = 1, g 0.95, the basis quirk, a 2 x 2 mesh over a
  world-size-1 NCCL group on a free localhost port (K11-S's split route,
  its all_reduces in the captured step).
"""

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import numpy as np

PHASES = {
    # name: (sz, g, compat, kernel_size, shards, process group)
    "sharded512": (512, 0.5, False, 1, 8, False),
    "sharded64_compat": (64, 0.95, True, 2, 4, False),
    "distributed1": (64, 0.95, True, 1, 4, True),
}


def solver(sz, g, compat, kernel_size):
    from aniso_torch.core.config import SolverConfig
    from aniso_torch.solver.operator import TransportSolver

    cfg = SolverConfig(domain_size=sz, quad_rule=3, kernel_size=kernel_size,
                       g=g, sing_rule=8, np_cheb=4, dtype="float32",
                       tol=1e-7, restart=80, max_iter=400,
                       compat_global_basis=compat)
    s = TransportSolver(cfg, backend="fmm", device="cuda")
    x = s.grid.nodes_x
    sig = 16 * 0.5 * (1 - np.cos(2 * np.pi * x))
    s.set_coeff(sig, sig + 0.2)
    return s


def phase(torch, name, reps):
    sz, g, compat, kernel_size, shards, group = PHASES[name]
    if not group:
        return solves(torch, name, reps)
    from aniso_torch.parallel import distributed

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    distributed.init(f"127.0.0.1:{port}", 1, 0)
    try:
        return solves(torch, name, reps)
    finally:
        distributed.shutdown()


def solves(torch, name, reps):
    from aniso_torch.parallel import api
    from aniso_torch.solver.gmres import gmres
    from torch.profiler import ProfilerActivity, profile

    sz, g, compat, kernel_size, shards, _ = PHASES[name]
    s = solver(sz, g, compat, kernel_size)
    grid = s.grid
    mesh = api.make_mesh(devices=["cuda"] * shards)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    sig = api.shard_field(mesh, s.sigma_s)
    q = np.exp(-25 * ((grid.nodes_x - 0.5) ** 2 + (grid.nodes_y - 0.5) ** 2))
    u = api.shard_field(mesh, torch.as_tensor(q, dtype=s.dtype,
                                              device="cuda"))

    in_matvec = [0.0]

    def matvec(v):
        t0 = time.perf_counter()
        out = v - apply_fn(caches, ms[0], 0, sig * v)
        in_matvec[0] += time.perf_counter() - t0
        return out

    # a tree whose sharded step can be captured (ShardedSpace.capturable a
    # property) keeps its graphs; an older one steps eagerly
    captured = isinstance(getattr(api.ShardedSpace, "capturable", None),
                          property)
    graphs = {} if captured else None

    def solve():
        b = apply_fn(caches, ms[0], 0, u)
        res = gmres(matvec, b, restart=80, max_iter=400, tol=1e-7,
                    graphs=graphs)
        torch.cuda.synchronize()
        return res

    res = solve()
    times, matvec_s = [], []
    for _ in range(reps):
        in_matvec[0] = 0.0
        t0 = time.perf_counter()
        solve()
        times.append(time.perf_counter() - t0)
        matvec_s.append(in_matvec[0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    device_s = sum(e.self_device_time_total for e in rows) / 1e6
    return {"captured": captured, "solve_s": times,
            "median_s": statistics.median(times),
            "matvec_host_s": matvec_s,
            "rest_host_s": [t - mv for t, mv in zip(times, matvec_s)],
            "iterations": res.iterations, "converged": bool(res.converged),
            "device_s": device_s, "profiled_wall_s": wall,
            "device_busy_share": device_s / wall,
            "device_kernels": sum(e.count for e in rows)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(here))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("sharded_times: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    import aniso_torch

    out = {"card": card, "tree": tree, "module": aniso_torch.__file__}
    for name in args.phases.split(","):
        out[name] = phase(torch, name, args.reps)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
