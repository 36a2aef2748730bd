#!/usr/bin/env python3
"""On-GPU smoke test of aniso_torch: builds the CUDA kernels, holds each
against its plain PyTorch version, and drives the port's paths.

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one) and the repository's
aniso_torch package beside it.  Phases, each printing one JSON line:

  device   first the nvidia-smi name and power limit line as nvidia-smi
           prints it, then torch / CUDA versions and the TF32 pins
  build    nvcc of K1, K2 and K3 and g++ of the host engine, in parallel
  kernels_vs_plain  at every size solved below, each kernel at the shapes
           the paths give it, against its plain version on inputs from a
           seed (random E, M, cosr; the bench sigma field's coefficients
           for K3), with CUDA-event device times and bounds:
             64^2, 128^2: K1 f32 at every level, K2 f32 (compat off, on);
             64^2: K1/K2 f64, K3 f32/f64 at the fine levels;
             512^2: K1 f32 at every level, K1 f64 at the coarse levels,
             K2 f32/f64, K3 f32/f64 at both fine levels.
           Gates: max|kernel - plain| <= 1e-5 max|plain| in f32 (sums of
           432 to 729 terms, or K3's 27 atomic adds, in another order) and
           1e-12 max|plain| in f64
  bench    bench.py's problem: 64^2, deg 3, g=0.95, np 4, f32, tol 1e-7,
           GMRES(80): set_coeff, matvec time, solve; 14 +- 1 iterations,
           true residual < 1e-5, K1/K2 launch counts = launches per matvec
           x matvecs
  oracle64 the same with compat_global_basis=True: 18 +- 1 iterations and
           relative Linf error < 1e-3 against benchmarks/oracle_64
  oracle128  128^2, g=0.5, compat on: 18 +- 1 iterations, true residual
           < 1e-5, relative Linf error < 1e-3 against benchmarks/oracle_128
  refined512  the north star: 512^2, g=0.5, f32 inner GMRES(80) with f64
           refinement to tol 1e-8: set_coeff cold and warm with their
           phases, the refined solve's phases, rounds, history and inner
           iterations; converged in <= 3 rounds with the true f64 residual
           |b - A64 x| / |b| < 1e-8 recomputed here, and x's residual
           through the f32 fast path < 1e-5; K3-f64 launches = 2 fine
           levels x the twin sweeps; K6 (the device coarse build) timed
           per level, and at its coarsest level within 1e-11 relative of
           the host engine's exact per-pair build
  f32_512  the same grid in f32 without refinement, tol 1e-7: 14 +- 1
           iterations, true residual < 1e-5, x within 1e-4 relative (2-norm)
           of the refined x, matvec time and busy share
  offsets_leaf512  the f32_512 solver with its cache rebuilt through
           build_m2l_E so that the leaf level is per-offset (K3 f32): its
           matvec within 1e-5 relative of the dense-leaf matvec, the same
           iterations +- 1
  f64_64   the oracle64 problem in float64 to tol 1e-10: K1/K2 f64, true
           residual < 1e-9, relative Linf error < 1e-3 against oracle_64

then the kernels line (times at each kernel's main-path shapes, launches
counted in the run of that path) and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The bench phase also prints the rows of the kernel table left to torch
(K4, K5, K8: time, launches, bound).  Any failed check raises before the
last line.  Takes about 45-60 s on one H100, the kernel builds included
(PERF.md).
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
# H100 SXM peaks for the operation bound: float32 outside the tensor cores,
# float64 on the tensor cores (the card's fastest f64 rate; 34 TFLOP/s on
# the CUDA cores)
PEAK_FLOP_PER_S = {"f32": 67e12, "f64": 67e12}
TOL_KERNEL = {"f32": 1e-5, "f64": 1e-12}
HOLD_CYCLES = 5_000_000          # GPU sleep before a kernel sample: ~2.5 ms
SEED = 0
DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
R, NQ = 16, 9                    # np_cheb 4, deg 3: every problem below
NORTH = 512                      # the north-star grid (BASELINE.json)


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


def bound_ms(nbytes, flops, inst="f32"):
    """The least time for the work: bytes at the memory rate or operations
    at the type's peak, whichever is longer, and which of the two."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOP_PER_S[inst]
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


class Kernels:
    """The kernel modules, their launch counters and the checks against
    their plain versions."""

    def __init__(self, torch, flush):
        from aniso_torch.fmm.apply import parity_shift_table_np
        from aniso_torch.kernels import m2l, near, offsets

        self.torch, self.flush = torch, flush
        self.m2l, self.near, self.offsets = m2l, near, offsets
        self.shift = torch.as_tensor(parity_shift_table_np(),
                                     dtype=torch.int32, device=DEVICE)

    def reset(self):
        for mod in (self.m2l, self.near, self.offsets):
            mod.launches.update(f32=0, f64=0)

    def counts(self):
        return {f"{k}_{inst}": mod.launches[inst]
                for k, mod in (("k1", self.m2l), ("k2", self.near),
                               ("k3", self.offsets))
                for inst in ("f32", "f64")}

    def rand(self, shape, inst, lo=0.0, hi=1.0, normal=False, seed=0):
        """Inputs made on the card from a seed (GBs at 512^2)."""
        torch = self.torch
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        dtype = torch.float32 if inst == "f32" else torch.float64
        if normal:
            return torch.randn(shape, generator=gen, dtype=dtype,
                               device=DEVICE)
        return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=dtype,
                                           device=DEVICE)

    def compare(self, what, inst, fn, plain, nbytes, flops):
        """One kernel call against its plain version, then both timed."""
        torch = self.torch
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= TOL_KERNEL[inst] * scale,
              f"{what}: max err {err} > {TOL_KERNEL[inst]} x {scale}")
        del got, want
        bms, bby = bound_ms(nbytes, flops, inst)
        return {"max_abs_err": err, "max_abs_plain": scale,
                "ms": event_ms(torch, fn, flush=self.flush),
                "plain_ms": event_ms(torch, plain, flush=self.flush),
                "bytes": nbytes, "flops": flops, "bound_ms": bms,
                "bound_by": bby}

    @staticmethod
    def total(rows):
        """Sum over levels: one matvec's (or twin sweep's) worth."""
        out = {k: sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bytes", "flops", "bound_ms")}
        out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        out["bound_by"] = rows[-1]["bound_by"]
        return out

    def k1(self, sz, inst, levels):
        """K1 at the given levels of a sz^2 solve: E in [0, 3)."""
        m2l = self.m2l
        rows = []
        for level in levels:
            m2 = (1 << level) // 2
            seed = 1000 * level + sz
            E = self.rand((4, m2, m2, R, 27 * R), inst, 0.0, 3.0, seed=seed)
            cosr = self.rand((4, R, 27 * R), inst, normal=True, seed=seed + 1)
            M = self.rand((2 * m2, 2 * m2, R), inst, normal=True,
                          seed=seed + 2)
            item = E.element_size()
            row = self.compare(
                f"K1 {inst} {sz}^2 level {level}", inst,
                lambda: m2l.m2l_translate(E, cosr, M, self.shift),
                lambda: m2l.m2l_translate_plain(E, cosr, M, self.shift),
                item * (E.numel() + cosr.numel() + 2 * M.numel())
                + 4 * self.shift.numel(),
                4 * E.numel())
            rows.append({"level": level, "m2": m2, **row})
            del E
        return rows

    def k2(self, sz, inst, variants=(("m0", False),)):
        """K2 on a sz^2 grid (m = 0), with and without the Duffy term."""
        near = self.near
        E = self.rand((sz, sz, NQ, 3, 3, NQ), inst, 0.0, 0.5, seed=sz)
        cosrw, S, u, sigma_w = (
            self.rand(shape, inst, normal=True, seed=sz + k)
            for k, shape in enumerate(((NQ, 3, 3, NQ), (NQ, 3, 3, NQ),
                                       (sz, sz, NQ), (sz, sz, NQ)), 1))
        duffy = self.rand((sz, sz, NQ, NQ), inst, normal=True, seed=sz + 5)
        rows = []
        for name, compat in variants:
            dfy = duffy if compat else None
            item = E.element_size()
            row = self.compare(
                f"K2 {inst} {sz}^2 {name}", inst,
                lambda: near.near_contract(E, cosrw, S, u, sigma_w, dfy),
                lambda: near.near_contract_plain(E, cosrw, S, u, sigma_w,
                                                 dfy),
                item * (E.numel() + cosrw.numel() + S.numel()
                        + 3 * u.numel() + (0 if dfy is None else dfy.numel())),
                4 * E.numel())
            rows.append({"variant": name, **row})
        return rows

    def k3(self, sz, inst, levels, coeffs_np):
        """K3 at the given fine levels of a sz^2 solve, on the coefficient
        field of the problem solved there and its real weight blocks."""
        torch, offsets = self.torch, self.offsets
        from aniso_torch.core.geometry import make_grid
        from aniso_torch.fmm.smooth import build_m2l_offsets_fine
        from aniso_torch.fmm.structure import tree_config

        dtype = torch.float32 if inst == "f32" else torch.float64
        grid, tcfg = make_grid(sz, 3), tree_config(sz)
        coeffs = torch.as_tensor(coeffs_np, dtype=dtype, device=DEVICE)
        rows = []
        for level in levels:
            m2 = (1 << level) // 2
            B = sz >> level
            Wo = build_m2l_offsets_fine(grid, tcfg, level, 4, dtype,
                                        DEVICE)["Wo"]
            seed = 2000 * level + sz
            cosr = self.rand((4, R, 27 * R), inst, normal=True, seed=seed)
            M = self.rand((2 * m2, 2 * m2, R), inst, normal=True,
                          seed=seed + 1)
            item = coeffs.element_size()
            row = self.compare(
                f"K3 {inst} {sz}^2 level {level}", inst,
                lambda: offsets.offsets_translate(Wo, coeffs, cosr, M,
                                                  self.shift),
                lambda: offsets.offsets_translate_plain(Wo, coeffs, cosr, M,
                                                        self.shift),
                item * (Wo.numel() + coeffs.numel() + cosr.numel()
                        + 2 * M.numel()) + 4 * self.shift.numel(),
                offsets.translate_flops(4, B, NQ, m2))
            rows.append({"level": level, "m2": m2, "B": B, **row})
        return rows


def bench_coeffs(sz):
    """The bench sigma_t field's Legendre coefficients at sz^2 (compat
    off): what K3 reads on that grid."""
    from aniso_torch.core.geometry import make_grid, project_field

    grid = make_grid(sz, 3)
    return project_field(grid, bench_sigma(grid) + 0.2)


def bench_sigma(grid):
    """sigma_s of bench.py and benchmarks/scale_series.py:52-55."""
    return 16 * 0.5 * (1 - np.cos(2 * np.pi * grid.nodes_x))


def bench_charge(grid):
    return np.exp(-25 * ((grid.nodes_x - 0.5) ** 2
                         + (grid.nodes_y - 0.5) ** 2))


def layer_split_ms(torch, solver, u):
    """CUDA-event time of each layer of one matvec (fmm.apply's steps)."""
    from aniso_torch.fmm import apply as A

    static, caches = solver._fmm_static, solver._caches
    ms_tab = solver._mode_statics[0]
    leaf = solver._tcfg.leaf_level
    M = A._up_pass(static, leaf, u)
    coeffs = caches.get("coeffs")
    L = A._down_pass(static, leaf, M, caches["m2l_E"], ms_tab["m2l_cosr"],
                     coeffs)
    out = {
        "up_pass": event_ms(torch, lambda: A._up_pass(static, leaf, u)),
        "down_pass_k1_l2l": event_ms(torch, lambda: A._down_pass(
            static, leaf, M, caches["m2l_E"], ms_tab["m2l_cosr"], coeffs)),
        "l2t": event_ms(torch, lambda: torch.einsum(
            "kc,ijc->ijk", static["l2t"], L)),
        "near_k2": event_ms(torch, lambda: A._near_apply(
            caches, ms_tab, 0, u)),
    }
    return out


def device_ms_per_call(torch, fn, calls=10):
    """Summed device (kernel) time per call from torch.profiler and the
    number of device kernels per call, or (None, None) when the profiler
    records no device time on this machine."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    us = sum(e.self_device_time_total for e in rows)
    if us <= 0:
        return None, None
    return us / 1e3 / calls, sum(e.count for e in rows) / calls


def torch_op_rows(torch, s):
    """The kernel-table rows left to torch, at this solver's shapes: K4
    (the dense fine E build of set_coeff), K5 (the near E build) and K8
    (the small FMM transfers of a matvec: P2M/M2M, L2L, L2T).  Times by
    CUDA events (K8's from the per-layer split), torch kernel launches by
    the profiler, and bounds from the shapes (each input read once, each
    output written once; operations at the f32 peak)."""
    from aniso_torch.fmm import apply as A
    from aniso_torch.fmm import smooth

    g, tcfg = s.grid, s._tcfg
    coeffs = s.sigma_t_coeff          # the field set_coeff used (compat off)
    fine = [lv for lv in range(2, tcfg.leaf_level + 1)
            if tcfg.box_size_squares(lv) <= 2]
    P = 27 * R * R
    k4_flops = k4_bytes = 0
    for lv in fine:
        m2, B = tcfg.boxes(lv) // 2, tcfg.box_size_squares(lv)
        Q = 49 * B * B * NQ
        k4_flops += 4 * 2 * m2 * m2 * Q * P
        k4_bytes += 4 * 4 * (m2 * m2 * Q + Q * P + m2 * m2 * P)
    sz2 = g.sz * g.sz
    k5_flops = 2 * sz2 * (9 * NQ) * (9 * NQ * NQ)
    k5_bytes = 4 * (sz2 * NQ + 81 * NQ ** 3 + sz2 * 9 * NQ * NQ)
    # K8: u and the far field once each, every level's multipoles and
    # locals written once and read once; operations: P2M + L2T (2 r nq per
    # node each) and M2M + L2L (2 r^2 per child box each)
    boxes = sum(4 ** lv for lv in range(2, tcfg.leaf_level + 1))
    k8_bytes = 4 * (2 * sz2 * NQ + 4 * boxes * R)
    k8_flops = 2 * (2 * sz2 * NQ * R) + 2 * (2 * boxes * R * R)

    def build_k4():
        for lv in fine:
            smooth.build_m2l_E_fine(g, tcfg, lv, 4, coeffs)

    u = torch.as_tensor(bench_charge(g), dtype=s.dtype, device=DEVICE)
    static, ms = s._fmm_static, s._mode_statics[0]
    leaf = tcfg.leaf_level
    M = A._up_pass(static, leaf, u)
    L = A._down_pass(static, leaf, M, s._caches["m2l_E"], ms["m2l_cosr"])
    kernels = [device_ms_per_call(torch, fn)[1] for fn in (
        lambda: A._up_pass(static, leaf, u),
        lambda: A._down_pass(static, leaf, M, s._caches["m2l_E"],
                             ms["m2l_cosr"]),
        lambda: torch.einsum("kc,ijc->ijk", static["l2t"], L))]
    rows = {}
    for name, fn, flops, nbytes in (
            ("K4", build_k4, k4_flops, k4_bytes),
            ("K5", lambda: smooth.build_near_E(g, coeffs), k5_flops,
             k5_bytes)):
        bms, bby = bound_ms(nbytes, flops)
        rows[name] = {"ms": event_ms(torch, fn, reps=5),
                      "launches_per_set_coeff": device_ms_per_call(
                          torch, fn, calls=2)[1],
                      "bytes": nbytes, "flops": flops, "bound_ms": bms,
                      "bound_by": bby}
    bms, bby = bound_ms(k8_bytes, k8_flops)
    # the down pass's kernels less its K1 launches (one per level)
    rows["K8"] = {"launches_per_matvec": (
                      None if None in kernels
                      else sum(kernels) - (leaf - 1)),
                  "bytes": k8_bytes, "flops": k8_flops, "bound_ms": bms,
                  "bound_by": bby}
    return rows


def make_solver(torch, sz, g, compat, dtype="float32", tol=1e-7,
                refine=False):
    from aniso_torch.core.config import SolverConfig
    from aniso_torch.solver.operator import TransportSolver

    cfg = SolverConfig(domain_size=sz, quad_rule=3, kernel_size=1, g=g,
                       sing_rule=8, np_cheb=4, dtype=dtype, tol=tol,
                       restart=80, max_iter=400, compat_global_basis=compat,
                       refine=refine)
    return TransportSolver(cfg, backend="fmm", device=DEVICE)


def timed_set_coeff(torch, s):
    sig = bench_sigma(s.grid)
    t0 = time.perf_counter()
    s.set_coeff(sig, sig + 0.2)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def matvec_timing(torch, s):
    """Matvec wall time (CUDA events), chained forwards, the per-layer
    split and the profiler's device time with the busy share."""
    u = torch.as_tensor(bench_charge(s.grid), dtype=s.dtype, device=DEVICE)
    out = {"apply_ms": event_ms(torch, lambda: s.apply_mode(0, u))}
    x = u[None].clone()

    def chain():
        nonlocal x
        for _ in range(10):
            x = s.forward(x)

    out["forward_chained_ms"] = event_ms(torch, chain) / 10
    out["matvec_layers_ms"] = layer_split_ms(torch, s, u)
    out["matvec_device_ms"], out["matvec_device_kernels"] = \
        device_ms_per_call(torch, lambda: s.apply_mode(0, u))
    if out["matvec_device_ms"] is not None:
        out["matvec_device_busy_share"] = (
            out["matvec_device_ms"] / out["apply_ms"])
    return out


def counted_solve(torch, kern, s, q):
    """A first solve (one-time costs: library handles, first launches of
    each shape), then the main path's run with the counters set to 0 just
    before it and read just after."""
    t0 = time.perf_counter()
    s.solve(q)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    kern.reset()
    n0, n64 = s.n_matvecs, s.n_matvecs64
    t0 = time.perf_counter()
    res = s.solve(q)
    torch.cuda.synchronize()
    out = {"solve_first_s": first, "solve_s": time.perf_counter() - t0,
           "matvecs": s.n_matvecs - n0, "twin_sweeps": s.n_matvecs64 - n64,
           "launches": kern.counts()}
    return res, out


def true_residual(torch, s, q, x):
    """|A x - b| / |b| recomputed with the solver's own operator."""
    b = s.rhs(q)
    return float(torch.linalg.vector_norm(s.forward(x) - b)
                 / torch.linalg.vector_norm(b))


def observable_rel_diff(E, ref, m2):
    """max |E - ref| / max |ref| of two coarse E levels (4, m2, m2, r*27*r)
    over the (box, offset) entries whose source box lies in the domain: the
    others multiply the zero multipoles of boxes outside it."""
    from aniso_torch.fmm.structure import vlist_offsets

    A = E.reshape(4, m2, m2, R, 27, R)
    B = ref.reshape(4, m2, m2, R, 27, R)
    worst = 0.0
    for px in (0, 1):
        for py in (0, 1):
            for o, (di, dj) in enumerate(vlist_offsets(px, py)):
                xs = [x for x in range(m2) if 0 <= 2 * x + px + di < 2 * m2]
                ys = [y for y in range(m2) if 0 <= 2 * y + py + dj < 2 * m2]
                if xs and ys:
                    sub = np.ix_(xs, ys)
                    d = A[2 * px + py][sub] - B[2 * px + py][sub]
                    worst = max(worst, float(np.abs(d[..., o, :]).max()))
    return worst / float(np.abs(ref).max())


def check_launches(name, out, expect):
    got = out["launches"]
    want = {k: expect.get(k, 0) for k in got}
    check(got == want, f"{name}: launches {got}, expected {want}")


def run_problem(torch, kern, name, sz, g, compat, oracle=None,
                expect_iters=None, timing=False, dtype="float32", tol=1e-7,
                max_true_res=1e-5):
    s = make_solver(torch, sz, g, compat, dtype, tol)
    grid = s.grid
    inst = "f32" if dtype == "float32" else "f64"
    out = {"phase": name, "sz": sz, "g": g, "compat_global_basis": compat,
           "dtype": dtype, "tol": tol,
           "set_coeff_s": timed_set_coeff(torch, s),
           "set_coeff_phases_s": s.set_coeff_phases,
           "cache_report_bytes": s.cache_report()}
    if timing:
        out.update(matvec_timing(torch, s))
        out["torch_rows"] = torch_op_rows(torch, s)
    q = bench_charge(grid)
    res, run = counted_solve(torch, kern, s, q)
    true_res = true_residual(torch, s, q, res.x)
    x = res.x.double().cpu().numpy().reshape(-1)
    matvecs = run["matvecs"]
    n_levels = s._tcfg.leaf_level - 1
    out.update(run)
    out.update({
        "iterations": res.iterations, "converged": res.converged,
        "givens_estimate": res.residual, "true_relative_residual": true_res,
        "k1_launches_per_matvec": run["launches"][f"k1_{inst}"] / max(matvecs, 1),
        "k2_launches_per_matvec": run["launches"][f"k2_{inst}"] / max(matvecs, 1),
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
    check(true_res < max_true_res, f"{name}: true residual {true_res}")
    if expect_iters is not None:
        check(abs(res.iterations - expect_iters) <= 1,
              f"{name}: {res.iterations} iterations, expected "
              f"{expect_iters} +- 1")
    check_launches(name, out, {f"k1_{inst}": n_levels * matvecs,
                               f"k2_{inst}": matvecs})
    if oracle is not None:
        check(out["oracle_rel_linf"] < 1e-3,
              f"{name}: {out['oracle_rel_linf']} vs {oracle}")
    return out


def run_refined512(torch, kern):
    """The north-star configuration solved to a true f64 residual."""
    from aniso_torch.fmm import smooth

    torch.cuda.reset_peak_memory_stats()
    s = make_solver(torch, NORTH, 0.5, False, tol=1e-8, refine=True)
    grid, tcfg = s.grid, s._tcfg
    out = {"phase": "refined512", "sz": NORTH, "g": 0.5, "tol": 1e-8,
           "set_coeff_cold_s": timed_set_coeff(torch, s),
           "set_coeff_cold_phases_s": s.set_coeff_phases}
    out["set_coeff_warm_s"] = timed_set_coeff(torch, s)
    out["set_coeff_warm_phases_s"] = s.set_coeff_phases
    out["cache_report_bytes"] = s.cache_report()

    # K6 alone, warm, per device level (CUDA events around each build)
    coeffs = torch.as_tensor(s._caches64["coeffs"])
    out["k6_ms"] = {
        lv: event_ms(torch, lambda lv=lv: smooth.build_m2l_E_coarse_device(
            grid, tcfg, lv, 4, coeffs), reps=3)
        for lv in smooth.coarse_m2l_levels(tcfg)
        if smooth._coarse_dgemm_eligible(grid, tcfg, lv, 4)
    }
    # K6 at its coarsest level (B = 32, the largest weight blocks) against
    # exact per-pair line integrals on the host engine, every entry
    # computed directly (no mirror fill)
    k6_lv = min(out["k6_ms"])
    m2 = tcfg.boxes(k6_lv) // 2
    t0 = time.perf_counter()
    E_pp = smooth._coarse_perpair_level_np(
        grid, tcfg, k6_lv, 4, coeffs.cpu().numpy(), canonical_only=False)
    out["k6_perpair_host_s"] = time.perf_counter() - t0
    E_k6 = smooth.build_m2l_E_coarse_device(grid, tcfg, k6_lv, 4, coeffs)
    out["k6_vs_perpair_level"] = k6_lv
    out["k6_vs_perpair_rel_err"] = observable_rel_diff(
        E_k6.cpu().numpy(), E_pp, m2)
    del E_pp, E_k6
    u = torch.as_tensor(bench_charge(grid), device=DEVICE)
    out["apply_ms"] = event_ms(torch, lambda: s.apply_mode(0, u))
    out["apply64_ms"] = event_ms(torch, lambda: s._apply64(u), reps=5)

    q = bench_charge(grid)
    res, run = counted_solve(torch, kern, s, q)
    out.update(run)
    b = s._rhs64(q)
    true_res = float(torch.linalg.vector_norm(b - s._forward64(res.x))
                     / torch.linalg.vector_norm(b))
    x = res.x.cpu().numpy()
    out.update({
        "converged": res.converged, "refinements": res.refinements,
        "history": list(res.history), "inner_iterations": res.iterations,
        "refine_phases_s": res.phases, "true_f64_residual": true_res,
        # x through the f32 fast path, which shares no fine level, no near
        # E and no kernel instance with the twin: at that path's floor
        "f32_path_residual": true_residual(torch, s, q, res.x),
        "finite": bool(np.isfinite(x).all()),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    })
    emit(out)
    check(out["finite"] and x.shape == (1, NORTH, NORTH, NQ),
          "refined512: bad x")
    check(res.converged and true_res < 1e-8,
          f"refined512: true f64 residual {true_res}")
    check(out["f32_path_residual"] < 1e-5,
          f"refined512: f32-path residual {out['f32_path_residual']}")
    check(out["k6_vs_perpair_rel_err"] < 1e-11,
          f"refined512: K6 level {k6_lv} differs from the per-pair build "
          f"by {out['k6_vs_perpair_rel_err']}")
    check(res.refinements <= 3, f"refined512: {res.refinements} rounds")
    sweeps, matvecs = run["twin_sweeps"], run["matvecs"]
    check(sweeps == 1 + res.refinements, f"refined512: {sweeps} twin sweeps")
    # f32: every level dense (8 K1 per matvec at 512^2); the twin: the
    # coarse levels dense f64 (6 K1), the two fine levels per-offset (2 K3)
    n_levels = tcfg.leaf_level - 1
    check_launches("refined512", out, {
        "k1_f32": n_levels * matvecs, "k2_f32": matvecs,
        "k1_f64": (n_levels - 2) * sweeps, "k2_f64": sweeps,
        "k3_f64": 2 * sweeps})
    return out, x


def run_f32_512(torch, kern, x_refined):
    """512^2 in f32 to tol 1e-7, its x held against the refined x; then the
    same solver with the leaf level per-offset (K3 f32)."""
    from aniso_torch.fmm import smooth

    s = make_solver(torch, NORTH, 0.5, False)
    out = {"phase": "f32_512", "sz": NORTH, "g": 0.5, "tol": 1e-7,
           "set_coeff_s": timed_set_coeff(torch, s),
           "set_coeff_phases_s": s.set_coeff_phases,
           "cache_report_bytes": s.cache_report()}
    out.update(matvec_timing(torch, s))
    q = bench_charge(s.grid)
    res, run = counted_solve(torch, kern, s, q)
    out.update(run)
    true_res = true_residual(torch, s, q, res.x)
    x = res.x.double().cpu().numpy().reshape(x_refined.shape)
    out.update({"iterations": res.iterations, "converged": res.converged,
                "givens_estimate": res.residual,
                "true_relative_residual": true_res,
                "x_rel_diff_vs_refined": float(
                    np.linalg.norm(x - x_refined) / np.linalg.norm(x_refined))})
    emit(out)
    check(res.converged and true_res < 1e-5,
          f"f32_512: true residual {true_res}")
    # the f32 x is off by about its residual times the operator's condition
    check(out["x_rel_diff_vs_refined"] < 1e-4,
          f"f32_512: x differs from the refined x by "
          f"{out['x_rel_diff_vs_refined']}")
    check(abs(res.iterations - 14) <= 1,
          f"f32_512: {res.iterations} iterations, expected 14 +- 1")
    tcfg = s._tcfg
    leaf = tcfg.leaf_level
    check_launches("f32_512", out, {"k1_f32": (leaf - 1) * run["matvecs"],
                                    "k2_f32": run["matvecs"]})

    # the leaf per-offset: the budget admits every fine level but the leaf
    m2l_E = s._caches["m2l_E"]
    u = torch.as_tensor(bench_charge(s.grid), dtype=torch.float32,
                        device=DEVICE)
    dense = s.apply_mode(0, u)
    coarse = {lv: m2l_E[lv] for lv in smooth.coarse_m2l_levels(tcfg)}
    budget = smooth.m2l_cache_bytes(m2l_E) - smooth.m2l_cache_bytes(coarse) - 1
    s._caches["m2l_E"] = None
    del m2l_E
    s._caches["m2l_E"] = smooth.build_m2l_E(
        s.grid, tcfg, 4, s.sigma_t_coeff, coarse, budget_bytes=budget)
    s._caches["coeffs"] = s.sigma_t_coeff
    check(smooth.per_offset_levels(s._caches["m2l_E"]) == [leaf],
          "offsets_leaf512: the leaf is not per-offset")
    virt = s.apply_mode(0, u)
    diff = float((virt - dense).abs().max() / dense.abs().max())
    off = {"phase": "offsets_leaf512", "matvec_rel_diff_vs_dense": diff,
           "cache_report_bytes": s.cache_report(),
           "apply_ms": event_ms(torch, lambda: s.apply_mode(0, u))}
    res2, run2 = counted_solve(torch, kern, s, q)
    off.update(run2)
    true2 = true_residual(torch, s, q, res2.x)
    off.update({"iterations": res2.iterations, "converged": res2.converged,
                "true_relative_residual": true2})
    emit(off)
    check(diff < 1e-5, f"offsets_leaf512: matvec differs by {diff}")
    check(res2.converged and true2 < 1e-5,
          f"offsets_leaf512: true residual {true2}")
    check(abs(res2.iterations - res.iterations) <= 1,
          f"offsets_leaf512: {res2.iterations} iterations vs "
          f"{res.iterations}")
    check_launches("offsets_leaf512", off, {
        "k1_f32": (leaf - 2) * run2["matvecs"], "k2_f32": run2["matvecs"],
        "k3_f32": run2["matvecs"]})
    return out, off


def kernel_line(name, source, replaces, launches, rows, **extra):
    t = Kernels.total(rows)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, **extra}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from aniso_torch import _build
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

    kern = Kernels(torch, flush)
    # each size a path below is solved at, each kernel at that path's shapes
    chk = {}
    lv = {sz: list(range(2, int(math.log2(sz)) + 1))
          for sz in (64, 128, NORTH)}
    for sz in (64, 128):
        chk[sz, "k1_f32"] = kern.k1(sz, "f32", lv[sz])
        chk[sz, "k2_f32"] = kern.k2(sz, "f32", (("m0", False),
                                                ("m0_compat", True)))
    chk[64, "k1_f64"] = kern.k1(64, "f64", lv[64])
    chk[64, "k2_f64"] = kern.k2(64, "f64", (("m0", False),
                                            ("m0_compat", True)))
    chk[NORTH, "k1_f32"] = kern.k1(NORTH, "f32", lv[NORTH])
    chk[NORTH, "k2_f32"] = kern.k2(NORTH, "f32")
    chk[NORTH, "k1_f64"] = kern.k1(NORTH, "f64", lv[NORTH][:-2])
    chk[NORTH, "k2_f64"] = kern.k2(NORTH, "f64")
    for sz in (64, NORTH):
        cf = bench_coeffs(sz)
        for inst in ("f32", "f64"):
            chk[sz, f"k3_{inst}"] = kern.k3(sz, inst, lv[sz][-2:], cf)
    for sz in (64, 128, NORTH):
        emit({"phase": "kernels_vs_plain", "sz": sz,
              **{k: rows for (z, k), rows in chk.items() if z == sz}})

    bench = run_problem(torch, kern, "bench", 64, 0.95, False,
                        expect_iters=14, timing=True)
    run_problem(torch, kern, "oracle64", 64, 0.95, True,
                oracle="oracle_64", expect_iters=18)
    run_problem(torch, kern, "oracle128", 128, 0.5, True,
                oracle="oracle_128", expect_iters=18)
    refined, x_refined = run_refined512(torch, kern)
    torch.cuda.empty_cache()
    _, leaf512 = run_f32_512(torch, kern, x_refined)
    torch.cuda.empty_cache()
    f64 = run_problem(torch, kern, "f64_64", 64, 0.95, True,
                      oracle="oracle_64", dtype="float64", tol=1e-10,
                      max_true_res=1e-9)

    # times and bounds at each kernel's main-path shapes (summed over the
    # levels one matvec or twin sweep runs); errors the worst over every
    # checked size; launches counted in that path's run
    def worst(key):
        return max(r["max_abs_err"] for (_, k), rows in chk.items()
                   if k == key for r in rows)

    rl = refined["launches"]
    emit({"kernels": [
        kernel_line("m2l_translate", "aniso_torch/csrc/m2l_translate.cu",
                    "aniso_tpu/fmm/apply.py:317", bench["launches"]["k1_f32"],
                    chk[64, "k1_f32"], shapes="bench 64^2, levels 2-6",
                    max_abs_err_all_sizes=worst("k1_f32")),
        kernel_line("near_contract", "aniso_torch/csrc/near_contract.cu",
                    "aniso_tpu/fmm/apply.py:577", bench["launches"]["k2_f32"],
                    chk[64, "k2_f32"][:1], shapes="bench 64^2",
                    max_abs_err_all_sizes=worst("k2_f32")),
        kernel_line("m2l_translate_f64", "aniso_torch/csrc/m2l_translate.cu",
                    "aniso_tpu/fmm/apply.py:317", rl["k1_f64"],
                    chk[NORTH, "k1_f64"],
                    shapes="refined512 twin, coarse levels 2-7",
                    launches_f64_64=f64["launches"]["k1_f64"],
                    max_abs_err_all_sizes=worst("k1_f64")),
        kernel_line("near_contract_f64", "aniso_torch/csrc/near_contract.cu",
                    "aniso_tpu/fmm/apply.py:577", rl["k2_f64"],
                    chk[NORTH, "k2_f64"], shapes="refined512 twin",
                    launches_f64_64=f64["launches"]["k2_f64"],
                    max_abs_err_all_sizes=worst("k2_f64")),
        kernel_line("offsets_translate_f64",
                    "aniso_torch/csrc/offsets_translate.cu",
                    "aniso_tpu/fmm/apply.py:440", rl["k3_f64"],
                    chk[NORTH, "k3_f64"],
                    shapes="refined512 twin, fine levels 8-9",
                    max_abs_err_all_sizes=worst("k3_f64")),
        kernel_line("offsets_translate_f32",
                    "aniso_torch/csrc/offsets_translate.cu",
                    "aniso_tpu/fmm/apply.py:440",
                    leaf512["launches"]["k3_f32"], chk[NORTH, "k3_f32"][-1:],
                    shapes="offsets_leaf512, leaf level 9",
                    max_abs_err_all_sizes=worst("k3_f32")),
    ]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
