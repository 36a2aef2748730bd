"""Command-line front end (role of the reference CLI, main.cpp:7-149) on
aniso_torch; counterpart of aniso_tpu/cli.py.

`python -m aniso_torch run data.cfg` (or `aniso-torch run data.cfg`)
reproduces the reference binary's end-to-end flow: config banner, solver
build, the same default coefficient/source fields (main.cpp:29-46),
phase-timed setup, warm start from result.csv (main.cpp:138-140), GMRES
solve, and points.csv/result.csv output (main.cpp:143-146).  It runs on
the CUDA card unless `--device cpu` asks for the CPU; without a card and
without that flag it raises.  `--compat-global-basis` evaluates sigma's
expansion at global coordinates as the reference binary does
(KernelFactory.cpp:180-205; data.cfg has no key for it): with it the
result matches the reference's result.csv (benchmarks/oracle_*), without
it the solution is the mathematically consistent one, as aniso_tpu's CLI
gives.  `--distributed [--coordinator host:port --num-processes N
--process-id K]` first joins the processes' torch.distributed group
(parallel.distributed.init: NCCL on the card, gloo with `--device cpu`), as
aniso_tpu/cli.py:54-58 joins jax.distributed; each process then runs the
solve, and only process 0 prints the banner and writes files.

Extra subcommands the reference lacks:
  `info`        - torch's CUDA device report
  `checkpoint`  - inspect a solver checkpoint
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _banner(cfg) -> str:
    # role of config::print (utility/config.cpp:46-53)
    head = "========= aniso-torch configuration ========="
    lines = [head]
    for k, v in cfg.to_dict().items():
        lines.append(f"  {k:<22} = {v}")
    lines.append("=" * len(head))
    return "\n".join(lines)


def default_fields(grid):
    """The reference CLI's built-in fields (main.cpp:29-46)."""
    x, y = grid.nodes_x, grid.nodes_y
    charge = np.exp(-25.0 * ((x - 0.5) ** 2 + (y - 0.5) ** 2))
    sigma_s = 16.0 * 0.5 * (1.0 - np.cos(2.0 * np.pi * x))
    sigma_t = sigma_s + 0.2
    return charge, sigma_s, sigma_t


def cmd_run(args) -> int:
    from .parallel import distributed

    if args.distributed:
        distributed.init(args.coordinator, args.num_processes,
                         args.process_id,
                         backend="gloo" if args.device == "cpu" else None)
    try:
        return _run(args)
    finally:
        distributed.shutdown()


def _run(args) -> int:
    from .core.config import load_cfg
    from .parallel.distributed import process_index
    from .solver.operator import TransportSolver
    from .utils.io import (
        load_result_csv, save_checkpoint, write_points_csv, write_result_csv,
    )
    from .utils.logging import log
    from .utils.profiler import Profiler

    lead = process_index() == 0
    cfg = load_cfg(args.config)
    if args.dtype:
        cfg.dtype = args.dtype
    if args.refine:
        cfg.dtype = "float32"
        cfg.refine = True
    if args.tol is not None:
        cfg.tol = args.tol
    if args.max_iter is not None:
        cfg.max_iter = args.max_iter
    if args.compat_global_basis:
        cfg.compat_global_basis = True
    if lead:
        print(_banner(cfg))

    timer = Profiler()
    timer.tic("build solver")
    solver = TransportSolver(cfg, backend=args.backend, device=args.device)
    timer.toc()
    grid = solver.grid
    N = cfg.kernel_size

    charge, sigma_s, sigma_t = default_fields(grid)

    # interpolation + singular precompute + kernel caches (main.cpp:48-76)
    timer.tic("set coefficients (caches)")
    solver.set_coeff(sigma_s, sigma_t)
    timer.toc()

    x0 = None
    warm = load_result_csv(args.result, n=grid.n_nodes)
    if warm is not None:
        log.info(f"warm start from {args.result}")
        # result.csv is the mode-0 solution (main.cpp:138-140); higher
        # modes start from zero
        x0 = np.zeros((N,) + grid.nodes_x.shape)
        x0[0] = warm.reshape(grid.nodes_x.shape)

    q = np.zeros((N,) + grid.nodes_x.shape)
    q[0] = charge  # isotropic source: only mode 0 charged (demo.m:23-30)

    precond = None
    if cfg.precdn.upper() == "DSA":
        from .solver.dsa import DsaPreconditioner
        timer.tic("build DSA preconditioner")
        precond = DsaPreconditioner(solver)
        timer.toc()

    timer.tic("GMRES solve")
    res = solver.solve(q, x0=x0, precond=precond)
    timer.toc()

    ok = bool(res.converged)
    print(
        f"GMRES {'CONVERGED' if ok else 'NOT CONVERGED'}: "
        f"relres={float(res.residual):.3e} iters={int(res.iterations)}"
    )

    x = res.x.cpu().numpy()
    if cfg.io and lead:
        write_points_csv(grid.nodes_x, grid.nodes_y, args.points)
        write_result_csv(x.reshape((N, -1))[0], args.result)
        print(f"wrote {args.points}, {args.result}")
    if args.checkpoint and lead:
        save_checkpoint(
            args.checkpoint, x=x, config=cfg.to_dict(),
            sigma_s=sigma_s, sigma_t=sigma_t,
            residual=float(res.residual), iterations=int(res.iterations),
        )
        print(f"wrote checkpoint {args.checkpoint}")

    print(timer.report())
    return 0 if ok else 1


def cmd_info(args) -> int:
    import torch

    from .parallel.distributed import process_count, process_index

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    info = {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": n,
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
        "process_index": process_index(),
        "process_count": process_count(),
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_checkpoint(args) -> int:
    from .utils.io import load_checkpoint

    ck = load_checkpoint(args.path)
    if ck is None:
        print(f"no checkpoint at {args.path}", file=sys.stderr)
        return 1
    meta = {
        k: (list(v.shape) if hasattr(v, "shape") else v)
        for k, v in ck.items()
    }
    print(json.dumps(meta, indent=2, default=str))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="aniso-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="end-to-end solve from a data.cfg")
    run.add_argument("config", help="reference-format data.cfg path")
    run.add_argument("--backend", default="fmm", choices=["fmm", "dense"])
    run.add_argument("--dtype", default=None, choices=["float32", "float64"])
    run.add_argument("--tol", type=float, default=None)
    run.add_argument("--max-iter", type=int, default=None)
    run.add_argument("--points", default="points.csv")
    run.add_argument("--result", default="result.csv")
    run.add_argument("--checkpoint", default=None)
    run.add_argument(
        "--refine", action="store_true",
        help="mixed-precision refinement: f32 inner GMRES + f64 residuals",
    )
    run.add_argument(
        "--compat-global-basis", action="store_true",
        help="evaluate sigma at global coordinates, as the reference binary",
    )
    run.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; 'cpu' runs on the CPU)",
    )
    run.add_argument(
        "--distributed", action="store_true",
        help="join a torch.distributed group first (multi-process runs)",
    )
    run.add_argument("--coordinator", default=None,
                     help="host:port of process 0 (with --distributed)")
    run.add_argument("--num-processes", type=int, default=None)
    run.add_argument("--process-id", type=int, default=None)
    run.set_defaults(fn=cmd_run)

    info = sub.add_parser("info", help="CUDA device report")
    info.set_defaults(fn=cmd_info)

    ck = sub.add_parser("checkpoint", help="inspect a checkpoint file")
    ck.add_argument("path")
    ck.set_defaults(fn=cmd_checkpoint)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
