"""Device kernels of one 64^2 matvec, of one captured 64^2 GMRES step and of
one sharded512 matvec, counted the same way for any checkout of the port on
one card.

    python3 tools/kernel_counts.py [--tree DIR] [--calls 10]

imports aniso_torch from DIR (default: the checkout that holds this file)
and counts, with torch.profiler recording device activity only, the device
kernels (the records with device time) of `calls` calls, per call:

  matvec_64: apply_mode(0, u) on chip_smoke.py's bench problem (64^2, deg 3,
    g 0.95, np 4, f32, bench sigma and charge);
  captured_step_64: one replay of the Arnoldi step that a solve of that
    problem captured;
  sharded512_matvec: the sharded matvec of chip_smoke.py's sharded512 phase
    (512^2, g 0.5, a 2 x 4 mesh of shards on the card).

Each window starts and ends with 50 ms of idle and starts with a kernel of
no interest (left out), as chip_smoke.py's device_ms_per_call counts.  It
prints one JSON line: the card and its power limit, the tree and the
counts with their device milliseconds a call.  Run it on two trees in one
call to compare them.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def solver(torch, sz, g):
    from aniso_torch.core.config import SolverConfig
    from aniso_torch.solver.operator import TransportSolver

    cfg = SolverConfig(domain_size=sz, quad_rule=3, kernel_size=1, g=g,
                       sing_rule=8, np_cheb=4, dtype="float32", tol=1e-7,
                       restart=80, max_iter=400, compat_global_basis=False)
    s = TransportSolver(cfg, backend="fmm", device="cuda")
    x, y = s.grid.nodes_x, s.grid.nodes_y
    sig = 16 * 0.5 * (1 - np.cos(2 * np.pi * x))
    s.set_coeff(sig, sig + 0.2)
    q = np.exp(-25 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
    return s, q


def per_call(torch, fn, calls):
    """(device ms, device kernels) a call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warm_up = torch.empty(1, dtype=torch.int8, device="cuda")
        warm_up.fill_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        warm_up.fill_(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and e.device_type != DeviceType.CPU
            and "FillFunctor<signed char>" not in e.key]
    return (sum(e.self_device_time_total for e in rows) / 1e3 / calls,
            sum(e.count for e in rows) / calls)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--tree", default=os.path.dirname(here))
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("kernel_counts: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    import aniso_torch
    from aniso_torch import _build
    from aniso_torch.parallel import api

    _build.build(_build.CUDA_SOURCES)
    out = {"card": card, "tree": tree, "module": aniso_torch.__file__}

    s, q = solver(torch, 64, 0.95)
    u = torch.as_tensor(q, dtype=s.dtype, device="cuda")
    out["matvec_64"] = per_call(torch, lambda: s.apply_mode(0, u),
                                args.calls)
    s.solve(q)
    plan = next(iter(s._graphs.values()))
    out["captured_step_64"] = per_call(torch, plan.graph.replay, args.calls)
    del s, plan, u
    torch.cuda.empty_cache()

    s, q = solver(torch, 512, 0.5)
    mesh = api.make_mesh(devices=["cuda"] * 8)
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    u = api.shard_field(mesh, torch.as_tensor(q, dtype=s.dtype,
                                              device="cuda"))
    out["sharded512_matvec"] = per_call(
        torch, lambda: apply_fn(caches, ms[0], 0, u), args.calls)
    out["mesh"] = list(mesh.shape)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
