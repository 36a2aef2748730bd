#!/usr/bin/env python
"""End-to-end multi-mode anisotropic demo on the PyTorch/CUDA port
(reference demo.m:1-33 parity; the counterpart of examples/demo.py).

The reference MATLAB demo builds `aniso(0.8, 5)`: a 128x128 grid at degree
1 with N = 5 Fourier modes, constant sigma_s = 20, sigma_a = 0.2, a centered
Gaussian charge on mode 0, and an unpreconditioned GMRES solve to 1e-11
(aniso.m:24, demo.m:9-32).  This script runs the same problem through
aniso_torch on the GPU; `--dsa` additionally applies the DSA preconditioner
(aniso.m:111-119 role), `--refine` runs f32 inner solves with f64 residuals
(the way to the 1e-11 target), `--cpu` runs on the CPU instead (the kernels'
plain PyTorch versions: for checking, not for speed).

Defaults are the full demo.m scale; use --size/--modes/--deg to shrink for
a quick CPU run (e.g. --cpu --size 16 --modes 2).  The arguments and the
JSON record are those of examples/demo.py, plus the device's name.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--size", type=int, default=128, help="squares per axis")
    p.add_argument("--deg", type=int, default=1, help="quadrature degree")
    p.add_argument("--modes", type=int, default=5, help="N Fourier modes")
    p.add_argument("--g", type=float, default=0.8, help="HG anisotropy")
    p.add_argument("--sigma-s", type=float, default=20.0)
    p.add_argument("--sigma-a", type=float, default=0.2)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--dsa", action="store_true", help="DSA preconditioner")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--refine", action="store_true",
                   help="mixed-precision refinement (f32 inner + f64 "
                        "residuals); reaches the demo.m 1e-11 target")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (device='cpu') instead of the GPU")
    p.add_argument("--json-out", default=None,
                   help="write a JSON record of the run (sizes, timings, "
                        "residual) to this path")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from aniso_torch.core.config import SolverConfig
    from aniso_torch.solver.dsa import DsaPreconditioner
    from aniso_torch.solver.operator import TransportSolver

    times = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if not args.cpu:
            torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    # aniso.m:24 -- Aniso(128, 1, N, g, 10, 4, 20)
    cfg = SolverConfig(
        domain_size=args.size, quad_rule=args.deg, kernel_size=args.modes,
        g=args.g, sing_rule=10, np_cheb=4,
        dtype="float32" if args.refine else args.dtype, refine=args.refine,
        tol=args.tol, restart=80, max_iter=400,
    )
    solver = timed("build solver", lambda: TransportSolver(
        cfg, backend="fmm", device="cpu" if args.cpu else None))
    grid = solver.grid

    # demo.m:15-19 -- constant coefficients
    sig_s = np.full_like(grid.nodes_x, args.sigma_s)
    timed("set coefficients (caches)",
          lambda: solver.set_coeff(sig_s, sig_s + args.sigma_a))

    # demo.m:24-29 -- Gaussian charge on mode 0 only
    q = np.zeros((args.modes,) + grid.nodes_x.shape)
    q[0] = np.exp(-25 * ((grid.nodes_x - 0.5) ** 2
                         + (grid.nodes_y - 0.5) ** 2))

    precond = None
    if args.dsa:
        precond = timed("build DSA", lambda: DsaPreconditioner(solver))

    res = timed("GMRES solve", lambda: solver.solve(q, precond=precond))

    ok = bool(res.converged)
    device = ("cpu" if args.cpu
              else torch.cuda.get_device_name(solver.device))
    print(f"GMRES {'CONVERGED' if ok else 'NOT CONVERGED'} "
          f"relres={float(res.residual):.3e} iters={int(res.iterations)} "
          f"on {device}")
    x0 = res.x[0].double().cpu().numpy()
    print(f"mode-0 intensity: min={x0.min():.6f} max={x0.max():.6f}")
    for name, t in times.items():
        print(f"{name:>28s}  {t:10.3f} s")
    if args.json_out:
        rec = {
            "size": args.size, "deg": args.deg, "modes": args.modes,
            "g": args.g, "sigma_s": args.sigma_s, "sigma_a": args.sigma_a,
            "tol": args.tol, "dsa": bool(args.dsa),
            "refine": bool(args.refine),
            "converged": ok,
            "residual": float(res.residual),
            "iterations": int(res.iterations),
            "refinements": int(getattr(res, "refinements", 0)),
            "phase_seconds": {k: round(v, 2) for k, v in times.items()},
            "set_coeff_phases": {k: round(v, 2) for k, v in
                                 solver.set_coeff_phases.items()},
            "mode0_min": float(x0.min()), "mode0_max": float(x0.max()),
            "device": device,
        }
        if precond is not None:
            # counts stay on the card until read (K9 reads nothing back)
            calls = [int(k) for k in precond.cg_iterations]
            rec["cg_iterations_per_call"] = sum(calls) / max(len(calls), 1)
        # append-or-replace into a list so the plain and --dsa runs
        # accumulate in one artifact
        recs = []
        if os.path.exists(args.json_out):
            try:
                with open(args.json_out) as f:
                    prior = json.load(f)
                recs = prior if isinstance(prior, list) else [prior]
            except (OSError, ValueError):
                recs = []
        key = ("size", "deg", "modes", "dsa", "refine")
        recs = [r for r in recs
                if tuple(r.get(k) for k in key) != tuple(rec[k] for k in key)]
        recs.append(rec)
        with open(args.json_out, "w") as f:
            json.dump(recs, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
