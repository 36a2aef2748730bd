#!/usr/bin/env python3
"""On-GPU smoke test of aniso_torch: builds the CUDA kernels, holds each
against its plain PyTorch version, and drives the port's main path.

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one) and the repository's
aniso_torch package beside it.  Phases, each printing one JSON line:

  device   first the nvidia-smi name and power limit line as nvidia-smi
           prints it, then torch / CUDA versions and the TF32 pins
  build    nvcc of K1 and K2 and g++ of the host engine, in parallel
  kernels  at 64^2 and at 128^2 (every size solved below): K1 at every M2L
           level and K2 (m = 0; compat off and on) against their plain
           versions in float32 on random inputs from a seed:
           max|kernel - plain| <= 1e-5 max|plain| (f32 sums of 432 or 729
           terms taken in another order), with CUDA-event times
  bench    bench.py's problem: 64^2, deg 3, g=0.95, np 4, f32, tol 1e-7,
           GMRES(80): set_coeff, matvec time, solve; 14 +- 1 iterations,
           true residual < 1e-5, K1/K2 launch counts = launches per matvec
           x matvecs
  oracle64 the same with compat_global_basis=True: 18 +- 1 iterations and
           relative Linf error < 1e-3 against benchmarks/oracle_64
  oracle128  128^2, g=0.5, compat on: converged, true residual < 1e-5,
           relative Linf error < 1e-3 against benchmarks/oracle_128

then the kernels line (times at the bench problem's shapes, launches
counted in its solve) and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises before the last line.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
TOL_KERNEL = 1e-5
HOLD_CYCLES = 5_000_000          # GPU sleep before a kernel sample: ~2.5 ms
SEED = 0
DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def event_ms(torch, fn, reps=21, flush=None):
    """Median CUDA-event time of fn() over reps runs after 3 warm-up runs.

    Without `flush` the events time what a caller waits for, host launch
    latency included.  With it (the kernel timings), each sample first runs
    `flush`, which evicts the 50 MB L2 so that a cache is read cold as
    inside a matvec, then holds the stream with a GPU sleep long enough for
    the host to queue all of fn's launches: the events then time the device
    work alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
            torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def node_permutation(grid, pts):
    """Reference node order -> ours (the reference lists Gauss points
    centre-first, we list them ascending): compare by coordinates."""
    mine = np.stack([grid.nodes_x.reshape(-1), grid.nodes_y.reshape(-1)], -1)
    order_m = np.lexsort((mine[:, 1], mine[:, 0]))
    order_r = np.lexsort((pts[:, 1], pts[:, 0]))
    assert np.allclose(mine[order_m], pts[order_r], atol=1e-12)
    perm = np.empty(len(pts), dtype=int)
    perm[order_m] = order_r
    return perm


def kernel_checks(torch, m2l, near, flush, sz):
    """K1 and K2 against their plain versions at the shapes a sz^2 solve
    gives them: K1 at every M2L level 2..leaf, K2 with and without the
    compat Duffy term."""
    rng = np.random.default_rng([SEED, sz])
    dev = torch.device(DEVICE)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()

    from aniso_torch.fmm.apply import parity_shift_table_np
    from aniso_torch.fmm.structure import coarsest_m2l_level, tree_config

    r, nq = 16, 9
    shift = t(parity_shift_table_np(), torch.int32)
    k1 = {"levels": [], "err": 0.0, "ms": 0.0, "plain_ms": 0.0,
          "bytes": 0, "flops": 0}
    for level in range(coarsest_m2l_level(), tree_config(sz).leaf_level + 1):
        m2 = (1 << level) // 2
        E = t(3.0 * rng.random((4, m2, m2, r, 27 * r), dtype=np.float32))
        cosr = t(rng.standard_normal((4, r, 27 * r)))
        M = t(rng.standard_normal((2 * m2, 2 * m2, r)))
        got = m2l.m2l_translate(E, cosr, M, shift)
        want = m2l.m2l_translate_plain(E, cosr, M, shift)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= TOL_KERNEL * scale,
              f"K1 {sz}^2 level {level}: max err {err} > {TOL_KERNEL} x "
              f"{scale}")
        ms = event_ms(torch, lambda: m2l.m2l_translate(E, cosr, M, shift),
                      flush=flush)
        plain = event_ms(
            torch, lambda: m2l.m2l_translate_plain(E, cosr, M, shift),
            flush=flush,
        )
        nbytes = 4 * (E.numel() + cosr.numel() + M.numel() + shift.numel()
                      + M.numel())
        bms, _ = bound_ms(nbytes, 4 * E.numel())
        k1["levels"].append({"level": level, "m2": m2, "max_abs_err": err,
                             "max_abs_plain": scale, "ms": ms,
                             "plain_ms": plain, "bytes": nbytes,
                             "bound_ms": bms})
        k1["err"] = max(k1["err"], err)
        k1["ms"] += ms
        k1["plain_ms"] += plain
        k1["bytes"] += nbytes
        k1["flops"] += 4 * E.numel()
    k1["bound_ms"], k1["bound_by"] = bound_ms(k1["bytes"], k1["flops"])

    E = t(rng.uniform(0.0, 0.5, (sz, sz, nq, 3, 3, nq)))
    cosrw = t(rng.standard_normal((nq, 3, 3, nq)))
    S = t(rng.standard_normal((nq, 3, 3, nq)))
    u = t(rng.standard_normal((sz, sz, nq)))
    sigma_w = t(rng.standard_normal((sz, sz, nq)))
    duffy = t(rng.standard_normal((sz, sz, nq, nq)))
    k2 = {"variants": [], "err": 0.0}
    for name, dfy in (("m0", None), ("m0_compat", duffy)):
        got = near.near_contract(E, cosrw, S, u, sigma_w, dfy)
        want = near.near_contract_plain(E, cosrw, S, u, sigma_w, dfy)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= TOL_KERNEL * scale,
              f"K2 {sz}^2 {name}: max err {err} > {TOL_KERNEL} x {scale}")
        ms = event_ms(torch, lambda: near.near_contract(E, cosrw, S, u,
                                                        sigma_w, dfy),
                      flush=flush)
        plain = event_ms(torch, lambda: near.near_contract_plain(
            E, cosrw, S, u, sigma_w, dfy), flush=flush)
        nbytes = 4 * (E.numel() + cosrw.numel() + S.numel() + 2 * u.numel()
                      + sigma_w.numel()
                      + (0 if dfy is None else dfy.numel()))
        bms, bby = bound_ms(nbytes, 4 * E.numel())
        k2["variants"].append({"variant": name, "max_abs_err": err,
                               "max_abs_plain": scale, "ms": ms,
                               "plain_ms": plain, "bytes": nbytes,
                               "bound_ms": bms, "bound_by": bby})
        k2["err"] = max(k2["err"], err)
    return k1, k2


def layer_split_ms(torch, solver, u):
    """CUDA-event time of each layer of one matvec (fmm.apply's steps)."""
    from aniso_torch.fmm import apply as A

    static, caches = solver._fmm_static, solver._caches
    ms_tab = solver._mode_statics[0]
    leaf = solver._tcfg.leaf_level
    M = A._up_pass(static, leaf, u)
    L = A._down_pass(static, leaf, M, caches["m2l_E"], ms_tab["m2l_cosr"])
    out = {
        "up_pass": event_ms(torch, lambda: A._up_pass(static, leaf, u)),
        "down_pass_k1_l2l": event_ms(torch, lambda: A._down_pass(
            static, leaf, M, caches["m2l_E"], ms_tab["m2l_cosr"])),
        "l2t": event_ms(torch, lambda: torch.einsum(
            "kc,ijc->ijk", static["l2t"], L)),
        "near_k2": event_ms(torch, lambda: A._near_apply(
            caches, ms_tab, 0, u)),
    }
    return out


def device_ms_per_call(torch, fn, calls=10):
    """Summed device (kernel) time per call from torch.profiler, or None
    when the profiler records no device time on this machine."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages())
    return us / 1e3 / calls if us > 0 else None


def run_problem(torch, m2l, near, name, sz, g, compat, oracle=None,
                expect_iters=None, timing=False):
    from aniso_torch.core.config import SolverConfig
    from aniso_torch.solver.operator import TransportSolver

    cfg = SolverConfig(domain_size=sz, quad_rule=3, kernel_size=1, g=g,
                       sing_rule=8, np_cheb=4, dtype="float32", tol=1e-7,
                       restart=80, max_iter=400, compat_global_basis=compat)
    s = TransportSolver(cfg, backend="fmm", device=DEVICE)
    grid = s.grid
    sig_s = 16 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))
    t0 = time.perf_counter()
    s.set_coeff(sig_s, sig_s + 0.2)
    torch.cuda.synchronize()
    set_coeff_s = time.perf_counter() - t0
    q = np.exp(-25 * ((grid.nodes_x - 0.5) ** 2 + (grid.nodes_y - 0.5) ** 2))
    out = {"phase": name, "sz": sz, "g": g, "compat_global_basis": compat,
           "set_coeff_s": set_coeff_s,
           "set_coeff_phases_s": s.set_coeff_phases,
           "cache_report_bytes": s.cache_report()}
    if timing:
        u = torch.as_tensor(q, dtype=torch.float32, device=DEVICE)
        out["apply_ms"] = event_ms(torch, lambda: s.apply_mode(0, u))
        x = u[None].clone()

        def chain():
            nonlocal x
            for _ in range(10):
                x = s.forward(x)

        out["forward_chained_ms"] = event_ms(torch, chain) / 10
        out["matvec_layers_ms"] = layer_split_ms(torch, s, u)
        out["matvec_device_ms"] = device_ms_per_call(
            torch, lambda: s.apply_mode(0, u))
        if out["matvec_device_ms"] is not None:
            out["matvec_device_busy_share"] = (
                out["matvec_device_ms"] / out["apply_ms"])

    # a first solve pays one-time costs (library handles, first launches
    # of each shape); the second is the steady state the counters read
    t0 = time.perf_counter()
    s.solve(q)
    torch.cuda.synchronize()
    out["solve_first_s"] = time.perf_counter() - t0

    # the main path's run: counters read around it and nowhere else
    m2l.launches = 0
    near.launches = 0
    n0 = s.n_matvecs
    t0 = time.perf_counter()
    res = s.solve(q)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k1_launches, k2_launches = m2l.launches, near.launches
    matvecs = s.n_matvecs - n0

    b = s.rhs(q)
    true_res = float(torch.linalg.vector_norm(s.forward(res.x) - b)
                     / torch.linalg.vector_norm(b))
    x = res.x.double().cpu().numpy().reshape(-1)
    n_levels = s._tcfg.leaf_level - 1
    out.update({
        "solve_s": solve_s, "iterations": res.iterations,
        "converged": res.converged, "givens_estimate": res.residual,
        "true_relative_residual": true_res, "matvecs": matvecs,
        "k1_launches": k1_launches, "k2_launches": k2_launches,
        "k1_launches_per_matvec": k1_launches / max(matvecs, 1),
        "k2_launches_per_matvec": k2_launches / max(matvecs, 1),
        "finite": bool(np.isfinite(x).all()),
    })
    if oracle is not None:
        ref = np.loadtxt(os.path.join(ROOT, "benchmarks", oracle, "result.csv"))
        pts = np.loadtxt(os.path.join(ROOT, "benchmarks", oracle, "points.csv"))
        perm = node_permutation(grid, pts)
        out["oracle_rel_linf"] = float(
            np.abs(x - ref[perm]).max() / np.abs(ref).max()
        )
    emit(out)

    check(out["finite"] and x.shape == (grid.n_nodes,), f"{name}: bad x")
    check(res.converged, f"{name}: GMRES did not converge")
    check(true_res < 1e-5, f"{name}: true residual {true_res}")
    if expect_iters is not None:
        check(abs(res.iterations - expect_iters) <= 1,
              f"{name}: {res.iterations} iterations, expected "
              f"{expect_iters} +- 1")
    check(k1_launches == n_levels * matvecs and k2_launches == matvecs,
          f"{name}: launches K1 {k1_launches} K2 {k2_launches} for "
          f"{matvecs} matvecs")
    if oracle is not None:
        check(out["oracle_rel_linf"] < 1e-3,
              f"{name}: {out['oracle_rel_linf']} vs {oracle}")
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from aniso_torch import _build
    from aniso_torch.kernels import m2l, near
    import aniso_torch.solver.operator  # noqa: F401  (sets the TF32 pins)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)          # the card's name and power limit, verbatim
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()},
          "ptxas": {k: [ln for ln in v.splitlines() if "registers" in ln
                        or "smem" in ln]
                    for k, v in _build.build_logs.items()}})

    scratch = torch.empty(96 * 1024 * 1024 // 4, device=DEVICE)

    def flush():
        scratch.zero_()

    # every size a problem below is solved at: K1 at each of its levels, K2
    # with and without the Duffy term
    checks = {}
    for sz in (64, 128):
        k1, k2 = kernel_checks(torch, m2l, near, flush, sz)
        checks[sz] = (k1, k2)
        emit({"phase": "kernels_vs_plain", "sz": sz,
              "k1_levels": k1["levels"], "k2_variants": k2["variants"]})

    bench = run_problem(torch, m2l, near, "bench", 64, 0.95, False,
                        expect_iters=14, timing=True)
    run_problem(torch, m2l, near, "oracle64", 64, 0.95, True,
                oracle="oracle_64", expect_iters=18)
    run_problem(torch, m2l, near, "oracle128", 128, 0.5, True,
                oracle="oracle_128")

    # times and bounds at the bench problem's shapes (64^2, compat off);
    # errors the worst over every checked size
    k1, k2 = checks[64]
    k2_main = k2["variants"][0]
    emit({"kernels": [
        {"name": "m2l_translate", "route": "cuda",
         "source": "aniso_torch/csrc/m2l_translate.cu",
         "replaces": "aniso_tpu/fmm/apply.py:317",
         "launches": bench["k1_launches"],
         "max_abs_err": max(c[0]["err"] for c in checks.values()),
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None,
         "launches_per_matvec": bench["k1_launches_per_matvec"],
         "bytes_per_matvec": k1["bytes"]},
        {"name": "near_contract", "route": "cuda",
         "source": "aniso_torch/csrc/near_contract.cu",
         "replaces": "aniso_tpu/fmm/apply.py:577",
         "launches": bench["k2_launches"],
         "max_abs_err": max(c[1]["err"] for c in checks.values()),
         "ms": k2_main["ms"], "plain_ms": k2_main["plain_ms"],
         "bound_ms": k2_main["bound_ms"], "bound_by": k2_main["bound_by"],
         "library_ms": None,
         "launches_per_matvec": bench["k2_launches_per_matvec"],
         "bytes_per_matvec": k2_main["bytes"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
