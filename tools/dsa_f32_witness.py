"""Where a float32 DSA solve's true residual comes from at large grids.

chip_smoke.py's dsa2048 problem (benchmarks/dsa_bench.py case 2: deg 2,
N = 1, g 0, sigma_s 20, sigma_a 0.2, the mode-0 Gaussian) in float32 to
tol 1e-7 with GMRES(80), at each grid of --sizes, solved three ways:

  plain    no preconditioner;
  dsa_cg32 DsaPreconditioner as the solver runs it: its CG in float32 (K9);
  dsa_cg64 the same preconditioner built from float64 cell fields, so its
           CG runs in float64 (K9's float64 instance) and its correction is
           rounded to float32 when it is added to the field.

Each solve reports its iterations, the GMRES estimate (the preconditioned
residual), the true residual |A x - b| / |b| as chip_smoke.py takes it
(the solver's float32 operator), the residual after each preconditioner,
|P (b - A x)| / |P b|, and the CG iterations a call.  For the first
preconditioner call's right-hand side it also runs K9 in float32,
pcg_plain in float32 and K9 in float64 alone, and reports each solution's
own residual |rhs - A z| / |rhs| taken in float64 and its distance from the
float64 solution: whether the float32 kernel and its plain version reach
the same z.

    python3 tools/dsa_f32_witness.py [--sizes 512,1024,2048] > out.jsonl

Needs one CUDA card (2048^2 holds about 56 GB) and a few minutes, one of
them the kernels' build.  Prints the nvidia-smi name and power limit line,
then one JSON line a grid.
"""

import argparse
import os
import subprocess
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

TOL = 1e-7


def rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


class Cast:
    """A preconditioner of float64 fields applied to a float32 field."""

    def __init__(self, pre):
        self.pre = pre

    @property
    def calls(self):            # the solver's captured step bumps it
        return self.pre.calls

    @calls.setter
    def calls(self, v):
        self.pre.calls = v

    def __call__(self, h):
        return self.pre(h.double()).to(h.dtype)


def cg_alone(pre32, pre64, b):
    """K9 f32, pcg_plain f32 and K9 f64 on the first preconditioner call's
    right-hand side (sigma_s times the cell means of b's mode 0)."""
    from aniso_torch.kernels import pcg as k9
    from aniso_torch.solver.dsa import cell_average

    h0 = b[0]
    rhs32 = pre32.sigma_s_bar * cell_average(pre32.grid, h0, pre32.w)
    rhs64 = pre64.sigma_s_bar * cell_average(pre64.grid, h0.double(),
                                            pre64.w)
    max_iter = cs.DSA2048_CG_MAX_ITER
    args32 = (pre32.diag, *pre32.apply_diff)
    runs = {"k9_f32": k9.pcg(rhs32, *args32, tol=pre32.tol,
                             max_iter=max_iter),
            "plain_f32": k9.pcg_plain(rhs32, *args32, tol=pre32.tol,
                                      max_iter=max_iter),
            "k9_f64": k9.pcg(rhs64, pre64.diag, *pre64.apply_diff,
                             tol=pre64.tol, max_iter=max_iter)}
    z64 = runs["k9_f64"].x
    out = {"rhs_f32_vs_f64": rel(rhs32.double(), rhs64)}
    for name, r in runs.items():
        z = r.x.double()
        out[name] = {"iterations": int(r.iterations),
                     "own_residual_f64": rel(pre64.apply_diff(z), rhs64),
                     "vs_k9_f64": rel(z, z64)}
    out["k9_f32_vs_plain_f32"] = rel(runs["k9_f32"].x, runs["plain_f32"].x)
    return out


def witness(sz):
    from aniso_torch.solver.dsa import DsaPreconditioner

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s = cs.make_solver(torch, sz, 0.0, False, dtype="float32", tol=TOL,
                       quad_rule=2)
    sig_s = np.full_like(s.grid.nodes_x, 20.0)
    t0 = time.perf_counter()
    s.set_coeff(sig_s, sig_s + 0.2)
    torch.cuda.synchronize()
    out = {"sz": sz, "dtype": "float32", "tol": TOL,
           "set_coeff_s": time.perf_counter() - t0}
    q = cs.mode0_charge(s.grid, 1)
    b = s.rhs(q)
    max_iter = cs.DSA2048_CG_MAX_ITER
    pre32 = DsaPreconditioner(s, max_iter=max_iter)
    pre64 = DsaPreconditioner(SimpleNamespace(
        grid=s.grid, sigma_s=s.sigma_s.double(),
        sigma_t=s.sigma_t.double()), max_iter=max_iter)
    variants = {"plain": (None, None), "dsa_cg32": (pre32, pre32),
                "dsa_cg64": (Cast(pre64), pre64)}
    for name, (pre, owner) in variants.items():
        if owner is not None:
            owner.reset()
        t0 = time.perf_counter()
        res = s.solve(q, precond=pre)
        torch.cuda.synchronize()
        run = {"solve_s": time.perf_counter() - t0,
               "iterations": res.iterations, "converged": res.converged,
               "residual_estimate": float(res.residual),
               "true_relative_residual": cs.true_residual(torch, s, q,
                                                          res.x)}
        if owner is not None:
            cg = owner.cg_iterations
            run.update({"precond_calls": len(cg),
                        "cg_iterations_per_call": cg})
        r = b - s.forward(res.x)
        for pname, p in (("cg32", pre32), ("cg64", Cast(pre64))):
            run[f"precond_residual_{pname}"] = float(
                torch.linalg.vector_norm(p(r))
                / torch.linalg.vector_norm(p(b)))
        out[name] = run
    out["cg_alone"] = cg_alone(pre32, pre64, b)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del s, pre32, pre64, variants, b
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="512,1024,2048")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dsa_f32_witness: CUDA is not available", file=sys.stderr)
        return 1
    from aniso_torch import _build
    import aniso_torch.solver.operator  # noqa: F401  (sets the TF32 pins)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    for sz in (int(v) for v in args.sizes.split(",")):
        t0 = time.perf_counter()
        out = witness(sz)
        out["seconds"] = time.perf_counter() - t0
        cs.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
