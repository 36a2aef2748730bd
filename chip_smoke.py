#!/usr/bin/env python3
"""On-GPU smoke test of aniso_torch: builds the CUDA kernels, holds each
against its plain PyTorch version, and drives the port's paths.

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one) and the repository's
aniso_torch package beside it.  Phases, each printing one JSON line:

  device   first the nvidia-smi name and power limit line as nvidia-smi
           prints it, then torch / CUDA versions and the TF32 pins
  build    nvcc of K1, K2, K3, K9d and K7 and g++ of the host engine, in
           parallel; per library the entry functions ptxas compiled, their
           most registers and any spill
  redesigned_kernels  ptxas's registers, spills and static shared memory
           of the r = 16 (np 4) instances of K1's all-modes kernel and of
           K3 (K3's dynamic shared memory is in PERF.md)
  kernels_vs_plain  at every size solved below, each kernel at the shapes
           the paths give it, against its plain version on inputs from a
           seed (random E, M, cosr; the sigma field's coefficients of the
           problem solved there for K3), with CUDA-event device times and
           bounds:
             64^2, 128^2: K1 f32 at every level, K2 f32 (compat off, on);
             64^2: K1/K2 f64, K3 f32/f64 at the fine levels;
             512^2: K1 f32 at every level, K1 f64 at the coarse levels,
             K2 f32/f64, K3 f32/f64 at both fine levels;
           the all-modes instances (D = 9 modes of one charge per launch),
           each also against D launches of its one-mode instance:
             128^2 deg 1 (demo128) and 512^2 deg 3 (mm512): K1-D f32 at
             every level and f64 at the twin's coarse levels, K2-D f32/f64
             (compat off, on), K3-D f64 at both fine levels;
             64^2 deg 2 (dsa64): K1-D and K2-D f64 at D = 5, less than one
             chunk of modes, and the one-mode K2 f64 at 4 nodes per square;
           K9d (the DSA diffusion stencil) f32/f64 at 64^2, 128^2, 512^2;
           K7 (the exact line integral, f64) at 16^2 (all 2304^2 pairs) and
           64^2 (512 target rows x all 36,864 sources): the dense-build
           form and the pair-list form, the basis at local coordinates on
           the compat-transformed coefficients and at global ones on the
           raw coefficients, with its operation bound on the FP64 CUDA
           cores from the sub-segments of these pairs.
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
  oracle16_dense  the JAX package's dense gate (tests/test_golden_oracle.py
           :86-105): benchmarks/oracle_16, compat on, f64, tol 1e-12,
           backend "dense": relative Linf error < 1e-2 against oracle_16,
           JAX's CPU iteration count +- 1 (ORACLE16_DENSE_ITERS), true
           residual < 1e-10; K7 launches = the row chunks of set_coeff, no
           other kernel of the port
  dense64  the reference CLI's default problem on the dense backend
           (benchmarks/oracle_64, compat on, f64, tol 1e-10): set_coeff
           split into the real matrices, K7 (with its chunk copies) and the
           rest, peak memory, the matvec against its byte bound (the two
           f64 matrices read once), true residual < 1e-9, relative Linf
           error < 1e-2 against oracle_64, distance from f64_64's FMM x,
           and apply_mode(0, u) of the FMM against the dense one on a
           seeded u < 6e-3 (the JAX property-test bound); K7 launches as
           in oracle16_dense
  demo128  the reference's demo.m problem (examples/demo_torch.py): 128^2,
           deg 1, N = 5 coupled modes, g = 0.8, sigma_s = 20, sigma_a =
           0.2, Gaussian charge on mode 0, f32 inner GMRES(80) with f64
           refinement to tol 1e-11; plain and with the DSA preconditioner.
           Converged in <= 4 rounds with the true f64 residual < 1e-11
           recomputed here; inner iterations within 10% of the JAX
           package's on the CPU for the same command (DEMO_ITERS), fewer
           with DSA than without; the two x within 1e-8 relative; K1/K2/K3
           launches = launches per sweep x sweeps (N sweeps per forward);
           K9d launches = the CG iterations counted; CG iterations per
           preconditioner call and its share of the solve time
  dsa64    benchmarks/dsa_bench.py's 64^2 cases in float64 on the card (deg
           2, tol 1e-8, sigma_s = 20): (N = 1, g = 0) and (N = 3, g = 0.9),
           plain and DSA: the JAX package's CPU iteration counts +- 1
           (DSA64_ITERS), DSA never above plain, true residual < 1e-7
           (< 1e-6 with DSA, which stops on the preconditioned residual),
           the two x within 1e-6 relative
  mm512    the multi-mode system at the north-star grid: 512^2, deg 3, N =
           5, g = 0.8, the bench sigma, its charge on mode 0, refined to
           tol 1e-8: forward(u) on a seeded u within 1e-5 of its maximum of
           u - sum C_fwd[i, a, d] apply_mode(d, sigma_s u_a) composed from
           the one-mode kernels, the twin's forward within 1e-12 of the
           same composition in f64; converged in <= 3 rounds, true f64
           residual < 1e-8, x's residual through the f32 path < 1e-5;
           forward() time, device time and busy share, time per mode pair,
           the twin forward's time, launches per forward
  cli      `python -m aniso_torch run ...` in subprocesses in a temporary
           directory: oracle_64 on the FMM backend to tol 1e-10 and
           oracle_16 on the dense one, both with --compat-global-basis:
           exit code 0, result.csv within 1e-3 / 1e-2 of the oracle, and a
           second run warm-started from it in <= 1 iteration; oracle_16
           also without the flag (its error reported, no gate)

then the kernels line (times at each kernel's main-path shapes, launches
counted in the run of that path) and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The bench phase also prints the rows of the kernel table left to torch
(K4, K5, K8: time, launches, bound).  Any failed check raises before the
last line.  PERF.md states the time of the whole run on one H100, the
kernel builds included.
"""

import json
import math
import os
import re
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
# float64 on the CUDA cores: K7's scalar multiply-adds (no matrix product
# for the tensor cores)
PEAK_F64_CUDA_CORES = 33.5e12
TOL_KERNEL = {"f32": 1e-5, "f64": 1e-12}
HOLD_CYCLES = 5_000_000          # GPU sleep before a kernel sample: ~2.5 ms
SEED = 0
DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
R, NQ = 16, 9                    # np_cheb 4 everywhere; deg 3 but in demo128
NORTH = 512                      # the north-star grid (BASELINE.json)
DEMO = 128                       # demo.m's grid, deg 1 (one node per square)
DSA_SZ = 64                      # benchmarks/dsa_bench.py's larger grid, deg 2
MODES = 5                        # N of demo128 and mm512: D = 9 kernel modes
# inner iterations of the JAX package on the CPU for the same problems:
# `python examples/demo.py --cpu --refine --tol 1e-11 [--dsa]`, and
# benchmarks/dsa_bench.py's run_case at (64, 20.0, 0.0, 1) and
# (64, 20.0, 0.9, 3)
DEMO_ITERS = {"plain": 57, "dsa": 50}
DSA64_ITERS = {(1, 0.0): {"plain": 18, "dsa": 7},
               (3, 0.9): {"plain": 28, "dsa": 19}}
# the JAX package's dense solve of benchmarks/oracle_16 on the CPU
# (tests/test_golden_oracle.py::test_solution_matches_reference_cli: compat
# on, f64, tol 1e-12): 35 iterations, 4.18e-3 from the oracle
ORACLE16_DENSE_ITERS = 35


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def event_ms(torch, fn, reps=21, flush=None, warmup=3):
    """Median CUDA-event time of fn() over reps runs after 3 warm-up runs.

    Without `flush` the events time what a caller waits for, host launch
    latency included.  With it (the kernel timings), each sample first runs
    `flush`, which evicts the 50 MB L2 so that a cache is read cold as
    inside a matvec, then holds the stream with a GPU sleep long enough for
    the host to queue all of fn's launches: the events then time the device
    work alone."""
    for _ in range(warmup):
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


def bound_ms(nbytes, flops, inst="f32", peak=None):
    """The least time for the work: bytes at the memory rate or operations
    at the type's peak (or `peak`), whichever is longer, and which."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (peak or PEAK_FLOP_PER_S[inst])
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
        from aniso_torch.kernels import (
            attenuation, diffusion, m2l, near, offsets,
        )

        self.torch, self.flush = torch, flush
        self.m2l, self.near, self.offsets = m2l, near, offsets
        self.diffusion, self.attenuation = diffusion, attenuation
        self.modules = (("k1", m2l), ("k2", near), ("k3", offsets),
                        ("k9d", diffusion), ("k7", attenuation))
        self.shift = torch.as_tensor(parity_shift_table_np(),
                                     dtype=torch.int32, device=DEVICE)

    def reset(self):
        for _, mod in self.modules:
            for inst in mod.launches:
                mod.launches[inst] = 0

    def counts(self):
        return {f"{k}_{inst}": n
                for k, mod in self.modules for inst, n in mod.launches.items()}

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

    def compare(self, what, inst, fn, plain, nbytes, flops, per_mode=None,
                reps=21, peak=None, plain_reps=None):
        """One kernel call against its plain version, then both timed.
        per_mode: the same result from one launch of the one-mode instance
        per mode, held to the same gate and timed as well.  peak: the
        operation rate of the bound (default: the type's); plain_reps:
        fewer samples of a slow plain version, after one warm-up."""
        torch = self.torch
        got, want = fn(), plain()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= TOL_KERNEL[inst] * scale,
              f"{what}: max err {err} > {TOL_KERNEL[inst]} x {scale}")
        del want
        bms, bby = bound_ms(nbytes, flops, inst, peak)
        out = {"max_abs_err": err, "max_abs_plain": scale,
               "ms": event_ms(torch, fn, reps=reps, flush=self.flush),
               "plain_ms": event_ms(torch, plain, reps=plain_reps or reps,
                                    flush=self.flush,
                                    warmup=1 if plain_reps else 3),
               "bytes": nbytes, "flops": flops, "bound_ms": bms,
               "bound_by": bby}
        if per_mode is not None:
            err1 = float((got - per_mode()).abs().max())
            check(err1 <= TOL_KERNEL[inst] * scale,
                  f"{what}: differs from the one-mode launches by {err1}")
            out["max_abs_err_vs_one_mode_launches"] = err1
            out["one_mode_launches_ms"] = event_ms(torch, per_mode, reps=reps,
                                                   flush=self.flush)
        return out

    @staticmethod
    def total(rows):
        """Sum over levels: one matvec's (or twin sweep's) worth."""
        out = {k: sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bytes", "flops", "bound_ms",
                         "one_mode_launches_ms") if k in rows[0]}
        out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        out["bound_by"] = rows[-1]["bound_by"]
        return out

    def k1(self, sz, inst, levels, D=None):
        """K1 at the given levels of a sz^2 solve: E in [0, 3).  D: the
        all-modes instance with D mode tables (None: one mode)."""
        torch, m2l = self.torch, self.m2l
        rows = []
        for level in levels:
            m2 = (1 << level) // 2
            seed = 1000 * level + sz
            E = self.rand((4, m2, m2, R, 27 * R), inst, 0.0, 3.0, seed=seed)
            cosr = self.rand(((D,) if D else ()) + (4, R, 27 * R), inst,
                             normal=True, seed=seed + 1)
            M = self.rand((2 * m2, 2 * m2, R), inst, normal=True,
                          seed=seed + 2)
            item = E.element_size()
            nd = D or 1
            row = self.compare(
                f"K1 {inst} {sz}^2 level {level} D {D}", inst,
                lambda: m2l.m2l_translate(E, cosr, M, self.shift),
                lambda: m2l.m2l_translate_plain(E, cosr, M, self.shift),
                item * (E.numel() + cosr.numel() + (1 + nd) * M.numel())
                + 4 * self.shift.numel(),
                (2 + 2 * nd) * E.numel(),
                per_mode=D and (lambda: torch.stack(
                    [m2l.m2l_translate(E, cosr[d], M, self.shift)
                     for d in range(D)])),
                reps=7 if D else 21)
            rows.append({"level": level, "m2": m2, **row})
            del E
        return rows

    def k2(self, sz, inst, variants=(("m0", False),), D=None, nq=NQ):
        """K2 on a sz^2 grid with nq nodes per square (slot 0 is mode 0),
        with and without the Duffy term.  D: the all-modes instance."""
        torch, near = self.torch, self.near
        lead = (D,) if D else ()
        nd = D or 1
        E = self.rand((sz, sz, nq, 3, 3, nq), inst, 0.0, 0.5, seed=sz)
        cosrw, S, u, sigma_w = (
            self.rand(shape, inst, normal=True, seed=sz + k)
            for k, shape in enumerate((lead + (nq, 3, 3, nq),
                                       lead + (nq, 3, 3, nq),
                                       (sz, sz, nq), (sz, sz, nq)), 1))
        duffy = self.rand(lead + (sz, sz, nq, nq), inst, normal=True,
                          seed=sz + 5)
        rows = []
        for name, compat in variants:
            dfy = duffy if compat else None
            item = E.element_size()
            row = self.compare(
                f"K2 {inst} {sz}^2 nq {nq} {name} D {D}", inst,
                lambda: near.near_contract(E, cosrw, S, u, sigma_w, dfy),
                lambda: near.near_contract_plain(E, cosrw, S, u, sigma_w,
                                                 dfy),
                item * (E.numel() + cosrw.numel() + S.numel()
                        + (2 + nd) * u.numel()
                        + (0 if dfy is None else dfy.numel())),
                (1 + 3 * nd) * E.numel(),
                per_mode=D and (lambda: torch.stack([
                    near.near_contract(E, cosrw[d], S[d], u,
                                       sigma_w if d == 0 else None,
                                       None if dfy is None else dfy[d])
                    for d in range(D)])),
                reps=7 if D else 21)
            rows.append({"variant": name, **row})
        return rows

    def k3(self, sz, inst, levels, coeffs_np, D=None, deg=3):
        """K3 at the given fine levels of a sz^2 solve at degree deg, on the
        coefficient field of the problem solved there and its real weight
        blocks.  D: the all-modes instance."""
        torch, offsets = self.torch, self.offsets
        from aniso_torch.core.geometry import make_grid
        from aniso_torch.fmm.smooth import build_m2l_offsets_fine
        from aniso_torch.fmm.structure import tree_config

        dtype = torch.float32 if inst == "f32" else torch.float64
        grid, tcfg = make_grid(sz, deg), tree_config(sz)
        coeffs = torch.as_tensor(coeffs_np, dtype=dtype, device=DEVICE)
        nd = D or 1
        rows = []
        for level in levels:
            m2 = (1 << level) // 2
            B = sz >> level
            Wo = build_m2l_offsets_fine(grid, tcfg, level, 4, dtype,
                                        DEVICE)["Wo"]
            seed = 2000 * level + sz
            cosr = self.rand(((D,) if D else ()) + (4, R, 27 * R), inst,
                             normal=True, seed=seed)
            M = self.rand((2 * m2, 2 * m2, R), inst, normal=True,
                          seed=seed + 1)
            item = coeffs.element_size()
            row = self.compare(
                f"K3 {inst} {sz}^2 level {level} D {D}", inst,
                lambda: offsets.offsets_translate(Wo, coeffs, cosr, M,
                                                  self.shift),
                lambda: offsets.offsets_translate_plain(Wo, coeffs, cosr, M,
                                                        self.shift),
                item * (Wo.numel() + coeffs.numel() + cosr.numel()
                        + (1 + nd) * M.numel()) + 4 * self.shift.numel(),
                offsets.translate_flops(4, B, grid.nq, m2, nd),
                per_mode=D and (lambda: torch.stack(
                    [offsets.offsets_translate(Wo, coeffs, cosr[d], M,
                                               self.shift)
                     for d in range(D)])),
                reps=5 if D else 21)
            rows.append({"level": level, "m2": m2, "B": B, **row})
        return rows

    def k9d(self, sz, inst):
        """K9d on a sz^2 grid of cells: the diffusion coefficient of a
        medium with sigma_t in [1, 21), absorption in [0.1, 1.1)."""
        from aniso_torch.solver.dsa import _face_coeffs

        diffusion = self.diffusion
        dx = 1.0 / sz
        D = 0.5 / self.rand((sz, sz), inst, 1.0, 21.0, seed=sz + 10)
        Dx, Dy, robin = _face_coeffs(D, dx)
        sigma_a = self.rand((sz, sz), inst, 0.1, 1.1, seed=sz + 11)
        z = self.rand((sz, sz), inst, normal=True, seed=sz + 12)
        row = self.compare(
            f"K9d {inst} {sz}^2", inst,
            lambda: diffusion.diffusion_apply(z, Dx, Dy, robin, sigma_a, dx),
            lambda: diffusion.diffusion_apply_plain(z, Dx, Dy, robin,
                                                    sigma_a, dx),
            z.element_size() * (4 * z.numel() + Dx.numel() + Dy.numel()),
            17 * z.numel())
        return [row]

    def k7(self, sz, nrows, reps=5, plain_reps=None):
        """K7 at sz^2, deg 3, on the oracle problem's sigma_t: the
        dense-build form for target rows 0..nrows-1 against every source,
        one mode (D = 1, as oracle16_dense and dense64 build), against its
        plain version; then the pair-list form on the same pairs.  Variant
        m0: the coefficients the solver passes under the global-basis quirk
        (to_local_equivalent) with the basis at local coordinates; compat:
        the raw coefficients with the basis at global coordinates (the same
        E, by another path).  Bound: operations on the FP64 CUDA cores, the
        sub-segments counted exactly from this run's pairs."""
        torch, k7 = self.torch, self.attenuation
        from aniso_torch.core.geometry import make_grid, project_field
        from aniso_torch.ops.attenuation import make_line_integral
        from aniso_torch.ops.compat import to_local_equivalent
        from aniso_torch.ops.fields import evaluate_at_nodes_np

        grid = make_grid(sz, 3)
        n = grid.n_nodes
        raw = project_field(grid, bench_sigma(grid) + 0.2)
        local = to_local_equivalent(grid, raw)

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                   device=DEVICE)

        pts_np = grid.flat_nodes()
        pts, w = dev(pts_np).contiguous(), dev(grid.weights.reshape(-1))
        diag = dev(evaluate_at_nodes_np(grid, local).reshape(-1))
        nsub = k7.subsegments(grid, pts_np[:nrows], pts_np)
        p0 = pts[:nrows, None, :].expand(nrows, n, 2).reshape(-1, 2)
        p1 = pts[None].expand(nrows, n, 2).reshape(-1, 2)
        rows = []
        for name, compat, cf in (("m0", False, dev(local)),
                                 ("compat", True, dev(raw))):
            flops = nsub * k7.flops_per_subsegment(3, compat)
            row = self.compare(
                f"K7 {sz}^2 rows {nrows} {name}", "f64",
                lambda: k7.dense_smooth_rows(grid, cf, pts, w, diag, 0, nrows,
                                             [0], compat),
                lambda: k7.dense_smooth_rows_plain(grid, cf, pts, w, diag, 0,
                                                   nrows, [0], compat),
                8 * (nrows * n + 4 * n + cf.numel()), flops, reps=reps,
                peak=PEAK_F64_CUDA_CORES, plain_reps=plain_reps)
            got = k7.line_integral_pairs(grid, cf, p0, p1, compat)
            want = make_line_integral(grid, sz, compat)(
                cf, p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1])
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(err <= TOL_KERNEL["f64"] * scale,
                  f"K7 pairs {sz}^2 {name}: max err {err} > 1e-12 x {scale}")
            pbms, _ = bound_ms(8 * 5 * p0.shape[0], flops, "f64",
                               PEAK_F64_CUDA_CORES)
            rows.append({"variant": name, "pairs": nrows * n,
                         "subsegments": nsub, **row,
                         "pairs_max_abs_err": err,
                         "pairs_ms": event_ms(torch, lambda: k7.line_integral_pairs(
                             grid, cf, p0, p1, compat), reps=reps,
                             flush=self.flush),
                         "pairs_bound_ms": pbms})
            del got, want
        return rows


def bench_coeffs(sz):
    """The bench sigma_t field's Legendre coefficients at sz^2 (compat
    off): what K3 reads on that grid."""
    from aniso_torch.core.geometry import make_grid, project_field

    grid = make_grid(sz, 3)
    return project_field(grid, bench_sigma(grid) + 0.2)


def demo_coeffs(sz):
    """demo.m's constant sigma_t = 20.2 at sz^2, deg 1: what K3 reads in
    demo128's twin."""
    from aniso_torch.core.geometry import make_grid, project_field

    grid = make_grid(sz, 1)
    return project_field(grid, np.full_like(grid.nodes_x, 20.2))


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
                refine=False, backend="fmm", **changes):
    from aniso_torch.core.config import SolverConfig
    from aniso_torch.solver.operator import TransportSolver

    kw = dict(domain_size=sz, quad_rule=3, kernel_size=1, g=g, sing_rule=8,
              np_cheb=4, dtype=dtype, tol=tol, restart=80, max_iter=400,
              compat_global_basis=compat, refine=refine)
    kw.update(changes)
    return TransportSolver(SolverConfig(**kw), backend=backend, device=DEVICE)


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


def counted_solve(torch, kern, s, q, precond=None, warm=True):
    """A first solve (one-time costs: library handles, first launches of
    each shape; skipped with warm=False), then the main path's run with the
    counters set to 0 just before it and read just after.  matvecs and
    twin_sweeps count FMM sweeps: N per forward of an N-mode solver.
    solve_is_first says that solve_s holds those one-time costs."""
    out = {"solve_is_first": not warm}
    if warm:
        t0 = time.perf_counter()
        s.solve(q, precond=precond)
        torch.cuda.synchronize()
        out["solve_first_s"] = time.perf_counter() - t0
    kern.reset()
    n0, n64 = s.n_matvecs, s.n_matvecs64
    t0 = time.perf_counter()
    res = s.solve(q, precond=precond)
    torch.cuda.synchronize()
    out.update({"solve_s": time.perf_counter() - t0,
                "matvecs": s.n_matvecs - n0,
                "twin_sweeps": s.n_matvecs64 - n64,
                "launches": kern.counts()})
    return res, out


class TimedPrecond:
    """A preconditioner with the seconds spent in it (the card drained
    before and after each call) and its calls counted."""

    def __init__(self, torch, precond):
        self.torch, self.precond = torch, precond
        self.seconds, self.calls = 0.0, 0

    def __call__(self, h):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.precond(h)
        self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def true_residual64(torch, s, q, x):
    """|b - A64 x| / |b| recomputed with the solver's f64 twin."""
    b = s._rhs64(q)
    return float(torch.linalg.vector_norm(b - s._forward64(x))
                 / torch.linalg.vector_norm(b))


def fine_levels(tcfg):
    """The levels whose boxes are one or two squares wide: per-offset in
    the f64 twin."""
    return [lv for lv in range(2, tcfg.leaf_level + 1)
            if tcfg.box_size_squares(lv) <= 2]


def mode0_charge(grid, N):
    """The Gaussian source on mode 0 (demo.m:24-29; bench.py's charge)."""
    q = np.zeros((N,) + grid.nodes_x.shape)
    q[0] = bench_charge(grid)
    return q


def fields_from_seed(grid, N, seed=SEED):
    return np.random.default_rng(seed).standard_normal(
        (N,) + grid.nodes_x.shape)


def dsa_stats(pre, timed, solve_s):
    calls = pre.cg_iterations
    return {"precond_calls": len(calls), "cg_iterations_total": sum(calls),
            "cg_iterations_per_call": sum(calls) / max(len(calls), 1),
            "cg_iterations_max": max(calls, default=0),
            "precond_s": timed.seconds,
            "precond_share_of_solve": timed.seconds / solve_s,
            "precond_ms_per_cg_iteration":
                1e3 * timed.seconds / max(sum(calls), 1)}


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
                max_true_res=1e-5, warm=True):
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
    res, run = counted_solve(torch, kern, s, q, warm=warm)
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
        out["oracle_rel_linf"] = oracle_error(grid, oracle, x)
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
    return out, x


def oracle_error(grid, oracle, x):
    """Relative Linf distance of x from the reference CLI's result.csv."""
    ref = np.loadtxt(os.path.join(ROOT, "benchmarks", oracle, "result.csv"))
    pts = np.loadtxt(os.path.join(ROOT, "benchmarks", oracle, "points.csv"))
    perm = node_permutation(grid, pts)
    return float(np.abs(x - ref[perm]).max() / np.abs(ref).max())


def dense_run(torch, kern, s):
    """set_coeff and the solve of the oracle problem on a dense solver, the
    counters set to 0 before set_coeff and read after the solve: the path
    launches K7 in set_coeff (one launch per row chunk) and no other kernel
    of the port (its GEMVs are torch.matmul)."""
    from aniso_torch.ops.dense import _row_chunks

    grid = s.grid
    q = bench_charge(grid)
    kern.reset()
    out = {"set_coeff_s": timed_set_coeff(torch, s),
           "set_coeff_phases_s": s.set_coeff_phases,
           "cache_report_bytes": s.cache_report()}
    n0 = s.n_matvecs
    t0 = time.perf_counter()
    res = s.solve(q)
    torch.cuda.synchronize()
    out.update({"solve_s": time.perf_counter() - t0,
                "matvecs": s.n_matvecs - n0, "launches": kern.counts()})
    x = res.x.cpu().numpy().reshape(-1)
    out.update({
        "iterations": res.iterations, "converged": res.converged,
        "givens_estimate": res.residual,
        "true_relative_residual": true_residual(torch, s, q, res.x),
        "finite": bool(np.isfinite(x).all()),
        "k7_launches_expected": len(list(_row_chunks(grid.n_nodes,
                                                     grid.n_nodes))),
    })
    return res, out, x


def run_oracle16_dense(torch, kern):
    """The JAX package's dense gate (tests/test_golden_oracle.py:86-105) on
    the card: benchmarks/oracle_16, compat on, f64, tol 1e-12."""
    s = make_solver(torch, 16, 0.95, True, dtype="float64", tol=1e-12,
                    backend="dense")
    res, out, x = dense_run(torch, kern, s)
    out = {"phase": "oracle16_dense", "sz": 16, "g": 0.95,
           "compat_global_basis": True, "dtype": "float64", "tol": 1e-12,
           "backend": "dense", **out,
           "expected_iterations": ORACLE16_DENSE_ITERS,
           "oracle_rel_linf": oracle_error(s.grid, "oracle_16", x)}
    emit(out)
    check(out["finite"] and x.shape == (s.grid.n_nodes,),
          "oracle16_dense: bad x")
    check(res.converged, "oracle16_dense: GMRES did not converge")
    check(out["true_relative_residual"] < 1e-10,
          f"oracle16_dense: true residual {out['true_relative_residual']}")
    check(abs(res.iterations - ORACLE16_DENSE_ITERS) <= 1,
          f"oracle16_dense: {res.iterations} iterations, expected "
          f"{ORACLE16_DENSE_ITERS} +- 1")
    check(out["oracle_rel_linf"] < 1e-2,
          f"oracle16_dense: {out['oracle_rel_linf']} vs oracle_16")
    check_launches("oracle16_dense", out,
                   {"k7_f64": out["k7_launches_expected"]})
    return out


def run_dense64(torch, kern, x_fmm):
    """The reference CLI's default problem (benchmarks/oracle_64, compat
    on, f64, tol 1e-10) on the dense backend: the exact operator at full
    CLI size, held against the oracle, the f64 FMM solve's x (f64_64) and
    the FMM's apply_mode on one seeded u."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s = make_solver(torch, 64, 0.95, True, dtype="float64", tol=1e-10,
                    backend="dense")
    grid = s.grid
    n = grid.n_nodes
    res, run, x = dense_run(torch, kern, s)
    phases = run["set_coeff_phases_s"]
    out = {"phase": "dense64", "sz": 64, "g": 0.95,
           "compat_global_basis": True, "dtype": "float64", "tol": 1e-10,
           "backend": "dense", **run,
           "set_coeff_k7_s": phases["dense_smooth_s"],
           "set_coeff_rest_s": run["set_coeff_s"] - phases["dense_smooth_s"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "oracle_rel_linf": oracle_error(grid, "oracle_64", x),
           "x_rel_linf_vs_fmm_f64_64": float(
               np.abs(x - x_fmm).max() / np.abs(x_fmm).max())}
    u = torch.as_tensor(fields_from_seed(grid, 1)[0], device=DEVICE)
    out["apply_ms"] = event_ms(torch, lambda: s.apply_mode(0, u), reps=11)
    # the bytes a matvec must move: the two (n, n) f64 matrices, once
    out["apply_bound_ms"] = 1e3 * 2 * n * n * 8 / HBM_BYTES_PER_S
    dense_u = s.apply_mode(0, u)
    fmm = make_solver(torch, 64, 0.95, True, dtype="float64", tol=1e-10)
    timed_set_coeff(torch, fmm)
    fmm_u = fmm.apply_mode(0, u)
    out["fmm_vs_dense_apply_rel_err"] = float(
        (fmm_u - dense_u).abs().max() / dense_u.abs().max())
    emit(out)
    check(out["finite"] and x.shape == (n,), "dense64: bad x")
    check(res.converged and out["true_relative_residual"] < 1e-9,
          f"dense64: true residual {out['true_relative_residual']}")
    check(out["oracle_rel_linf"] < 1e-2,
          f"dense64: {out['oracle_rel_linf']} vs oracle_64")
    check(out["fmm_vs_dense_apply_rel_err"] < 6e-3,
          f"dense64: FMM apply_mode differs from the dense one by "
          f"{out['fmm_vs_dense_apply_rel_err']}")
    check_launches("dense64", out, {"k7_f64": out["k7_launches_expected"]})
    return out


def run_cli(torch):
    """The CLI as its users run it, in subprocesses in a temporary
    directory: the reference CLI's default problem on the FMM backend and
    oracle_16 on the dense one, each with the reference's basis quirk
    (--compat-global-basis) against its oracle, then again, warm-started
    from the result.csv it wrote; oracle_16 also without the quirk (the
    mathematically consistent solution, which misses the oracle)."""
    import tempfile

    from aniso_torch.core.geometry import make_grid

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cases = (("oracle_64", "fmm", ["--tol", "1e-10", "--compat-global-basis"],
              1e-3),
             ("oracle_16", "dense", ["--compat-global-basis"], 1e-2),
             ("oracle_16", "dense", [], None))
    out = {"phase": "cli", "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        for k, (oracle, backend, extra, gate) in enumerate(cases):
            cwd = os.path.join(tmp, str(k))
            os.makedirs(cwd)
            cmd = [sys.executable, "-m", "aniso_torch", "run",
                   os.path.join(ROOT, "benchmarks", oracle, "data.cfg"),
                   "--backend", backend, *extra]
            for warm in ((False, True) if gate else (False,)):
                t0 = time.perf_counter()
                proc = subprocess.run(cmd, cwd=cwd, env=env,
                                      capture_output=True, text=True,
                                      timeout=600)
                seconds = time.perf_counter() - t0
                check(proc.returncode == 0,
                      f"cli {oracle} {backend}: exit {proc.returncode}\n"
                      f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
                line = [ln for ln in proc.stdout.splitlines()
                        if ln.startswith("GMRES ")][-1]
                sz = 64 if oracle == "oracle_64" else 16
                x = np.loadtxt(os.path.join(cwd, "result.csv"))
                run = {"oracle": oracle, "backend": backend, "args": extra,
                       "warm": warm, "seconds": seconds, "gmres": line,
                       "iterations": int(line.rsplit("iters=", 1)[1]),
                       "oracle_rel_linf": oracle_error(make_grid(sz, 3),
                                                       oracle, x)}
                out["runs"].append(run)
                if gate is not None:
                    check(run["oracle_rel_linf"] < gate,
                          f"cli {oracle} {backend}: "
                          f"{run['oracle_rel_linf']} vs the oracle")
                if warm:
                    check(run["iterations"] <= 1,
                          f"cli {oracle} {backend}: the warm run took "
                          f"{run['iterations']} iterations")
    emit(out)
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
    true_res = true_residual64(torch, s, q, res.x)
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
    res2, run2 = counted_solve(torch, kern, s, q, warm=False)
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


def run_demo128(torch, kern):
    """The reference's demo.m problem, plain and DSA-preconditioned."""
    from aniso_torch.solver.dsa import DsaPreconditioner

    N = MODES
    s = make_solver(torch, DEMO, 0.8, False, tol=1e-11, refine=True,
                    quad_rule=1, kernel_size=N, sing_rule=10)
    grid, tcfg = s.grid, s._tcfg
    sig_s = np.full_like(grid.nodes_x, 20.0)
    t0 = time.perf_counter()
    s.set_coeff(sig_s, sig_s + 0.2)
    torch.cuda.synchronize()
    out = {"phase": "demo128", "sz": DEMO, "deg": 1, "modes": N, "g": 0.8,
           "sigma_s": 20.0, "sigma_a": 0.2, "tol": 1e-11,
           "set_coeff_s": time.perf_counter() - t0,
           "set_coeff_phases_s": s.set_coeff_phases,
           "cache_report_bytes": s.cache_report()}
    q = mode0_charge(grid, N)
    u = torch.as_tensor(fields_from_seed(grid, N), dtype=s.dtype,
                        device=DEVICE)
    out["forward_ms"] = event_ms(torch, lambda: s.forward(u))
    out["forward64_ms"] = event_ms(torch, lambda: s._forward64(u), reps=5)

    pre = DsaPreconditioner(s)
    n_levels = tcfg.leaf_level - 1
    n_fine = len(fine_levels(tcfg))
    runs = {}
    for name in ("plain", "dsa"):
        # a first solve for the one-time costs, then the counted one, whose
        # preconditioner calls are timed and whose CG iterations counted
        t0 = time.perf_counter()
        s.solve(q, precond=pre if name == "dsa" else None)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        pre.cg_iterations.clear()
        timed = TimedPrecond(torch, pre) if name == "dsa" else None
        res, run = counted_solve(torch, kern, s, q, precond=timed,
                                 warm=False)
        run.update({
            "solve_first_s": first,
            "converged": res.converged, "refinements": res.refinements,
            "history": list(res.history), "inner_iterations": res.iterations,
            "inner_iterations_per_round": res.phases["inner_iters"],
            "true_f64_residual": true_residual64(torch, s, q, res.x),
            "finite": bool(torch.isfinite(res.x).all()),
        })
        if timed is not None:
            run.update(dsa_stats(pre, timed, run["solve_s"]))
        runs[name] = (res, run)
        out[name] = run
    res_dsa, run_dsa = runs["dsa"]
    x_plain, x_dsa = runs["plain"][0].x, res_dsa.x
    out["x_rel_diff_dsa_vs_plain"] = float(
        torch.linalg.vector_norm(x_dsa - x_plain)
        / torch.linalg.vector_norm(x_plain))
    out["expected_inner_iterations"] = DEMO_ITERS
    emit(out)

    for name, (res, run) in runs.items():
        what = f"demo128 {name}"
        check(run["finite"] and tuple(res.x.shape) == (N, DEMO, DEMO, 1),
              f"{what}: bad x")
        check(res.converged and run["true_f64_residual"] < 1e-11,
              f"{what}: true f64 residual {run['true_f64_residual']}")
        check(res.refinements <= 4, f"{what}: {res.refinements} rounds")
        want = DEMO_ITERS[name]
        check(abs(res.iterations - want) <= 0.1 * want,
              f"{what}: {res.iterations} inner iterations, expected "
              f"{want} +- 10%")
        sweeps, fast = run["twin_sweeps"], run["matvecs"]
        check(sweeps == N * (1 + res.refinements),
              f"{what}: {sweeps} twin sweeps")
        check_launches(what, run, {
            "k1_f32": n_levels * fast, "k2_f32": fast,
            "k1_f64": (n_levels - n_fine) * sweeps, "k2_f64": sweeps,
            "k3_f64": n_fine * sweeps,
            "k9d_f32": run.get("cg_iterations_total", 0)})
    check(res_dsa.iterations < runs["plain"][0].iterations,
          "demo128: DSA did not cut the iterations")
    check(run_dsa["cg_iterations_total"] > 0, "demo128: no CG iteration")
    check(out["x_rel_diff_dsa_vs_plain"] < 1e-8,
          f"demo128: the two x differ by {out['x_rel_diff_dsa_vs_plain']}")
    return out


def run_dsa64(torch, kern):
    """benchmarks/dsa_bench.py's two 64^2 cases in float64 on the card."""
    from aniso_torch.solver.dsa import DsaPreconditioner

    outs = []
    for (N, g), want in DSA64_ITERS.items():
        s = make_solver(torch, DSA_SZ, g, False, dtype="float64", tol=1e-8,
                        quad_rule=2, kernel_size=N, max_iter=200)
        grid = s.grid
        sig_s = np.full_like(grid.nodes_x, 20.0)
        s.set_coeff(sig_s, sig_s + 0.2)
        q = mode0_charge(grid, N)
        n_levels = s._tcfg.leaf_level - 1
        out = {"phase": "dsa64", "sz": DSA_SZ, "deg": 2, "modes": N, "g": g,
               "sigma_s": 20.0, "dtype": "float64", "tol": 1e-8,
               "expected_iterations": want}
        pre = DsaPreconditioner(s)
        xs = {}
        for name in ("plain", "dsa"):
            pre.cg_iterations.clear()
            timed = TimedPrecond(torch, pre) if name == "dsa" else None
            res, run = counted_solve(torch, kern, s, q, precond=timed,
                                     warm=False)
            run.update({"iterations": res.iterations,
                        "converged": res.converged,
                        "residual_estimate": res.residual,
                        "true_relative_residual":
                            true_residual(torch, s, q, res.x)})
            if timed is not None:
                run.update(dsa_stats(pre, timed, run["solve_s"]))
            out[name] = run
            xs[name] = res.x
        out["x_rel_diff_dsa_vs_plain"] = float(
            torch.linalg.vector_norm(xs["dsa"] - xs["plain"])
            / torch.linalg.vector_norm(xs["plain"]))
        emit(out)
        for name in ("plain", "dsa"):
            run = out[name]
            what = f"dsa64 N={N} g={g} {name}"
            check(run["converged"], f"{what}: GMRES did not converge")
            check(abs(run["iterations"] - want[name]) <= 1,
                  f"{what}: {run['iterations']} iterations, expected "
                  f"{want[name]} +- 1")
            # the preconditioned solve stops on the preconditioned
            # residual; the plain one it leaves is up to |M| times larger
            check(run["true_relative_residual"]
                  < (1e-7 if name == "plain" else 1e-6),
                  f"{what}: true residual {run['true_relative_residual']}")
            check_launches(what, run, {
                "k1_f64": n_levels * run["matvecs"],
                "k2_f64": run["matvecs"],
                "k9d_f64": run.get("cg_iterations_total", 0)})
        check(out["dsa"]["iterations"] <= out["plain"]["iterations"],
              f"dsa64 N={N}: DSA above plain")
        check(out["dsa"]["cg_iterations_total"] > 0,
              f"dsa64 N={N}: no CG iteration")
        check(out["x_rel_diff_dsa_vs_plain"] < 1e-6,
              f"dsa64 N={N}: the two x differ by "
              f"{out['x_rel_diff_dsa_vs_plain']}")
        outs.append(out)
    return outs


def composed_forward(torch, s, u, twin):
    """u - sum_{a,d} C_fwd[i, a, d] K_d(sigma_s u_a) from one-mode sweeps:
    apply_mode on the fast path, the twin's tables through fmm_apply_mode
    in f64."""
    from aniso_torch.fmm.apply import fmm_apply_mode

    N, D = s.cfg.kernel_size, s.n_modes
    if twin:
        C, sigma_s = s._C_fwd64, s._sigma_s64

        def K(d, v):
            return fmm_apply_mode(s._tcfg.leaf_level, s._fmm_static64,
                                  s._caches64, s._mode_statics64[d], d, v)
    else:
        C, sigma_s, K = s._C_fwd, s.sigma_s, s.apply_mode
    out = u.clone()
    for a in range(N):
        v = (sigma_s * u[a]).contiguous()
        for d in range(D):
            if bool((C[:, a, d] != 0).any()):
                out -= C[:, a, d, None, None, None] * K(d, v)[None]
    return out


def run_mm512(torch, kern):
    """The N = 5 coupled system at the north-star grid, refined to 1e-8."""
    N = MODES
    torch.cuda.reset_peak_memory_stats()
    s = make_solver(torch, NORTH, 0.8, False, tol=1e-8, refine=True,
                    kernel_size=N)
    grid, tcfg = s.grid, s._tcfg
    out = {"phase": "mm512", "sz": NORTH, "modes": N, "g": 0.8, "tol": 1e-8,
           "set_coeff_s": timed_set_coeff(torch, s),
           "set_coeff_phases_s": s.set_coeff_phases,
           "cache_report_bytes": s.cache_report()}
    n_levels = tcfg.leaf_level - 1
    n_fine = len(fine_levels(tcfg))

    # forward against its composition from the one-mode kernels
    u64 = torch.as_tensor(fields_from_seed(grid, N), device=DEVICE)
    u = u64.float()
    want = composed_forward(torch, s, u, twin=False)
    kern.reset()
    got = s.forward(u)
    out["launches_per_forward"] = kern.counts()
    out["forward_vs_composed"] = float((got - want).abs().max()
                                       / want.abs().max())
    want = composed_forward(torch, s, u64, twin=True)
    kern.reset()
    got = s._forward64(u64)
    out["launches_per_forward64"] = kern.counts()
    out["forward64_vs_composed"] = float((got - want).abs().max()
                                         / want.abs().max())
    del got, want

    out["forward_ms"] = event_ms(torch, lambda: s.forward(u), reps=7)
    out["forward_ms_per_mode_pair"] = out["forward_ms"] / (N * s.n_modes)
    out["forward_device_ms"], out["forward_device_kernels"] = \
        device_ms_per_call(torch, lambda: s.forward(u), calls=3)
    if out["forward_device_ms"] is not None:
        out["forward_device_busy_share"] = (
            out["forward_device_ms"] / out["forward_ms"])
    v = u[0].contiguous()
    out["apply_mode_ms"] = event_ms(torch, lambda: s.apply_mode(0, v),
                                    reps=7)
    out["forward64_ms"] = event_ms(torch, lambda: s._forward64(u64), reps=3)

    q = mode0_charge(grid, N)
    res, run = counted_solve(torch, kern, s, q, warm=False)
    out.update(run)
    out.update({
        "converged": res.converged, "refinements": res.refinements,
        "history": list(res.history), "inner_iterations": res.iterations,
        "inner_iterations_per_round": res.phases["inner_iters"],
        "refine_phases_s": res.phases,
        "true_f64_residual": true_residual64(torch, s, q, res.x),
        "f32_path_residual": true_residual(torch, s, q, res.x),
        "finite": bool(torch.isfinite(res.x).all()),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    })
    emit(out)
    check(out["forward_vs_composed"] < 1e-5,
          f"mm512: forward differs from its composition by "
          f"{out['forward_vs_composed']}")
    check(out["forward64_vs_composed"] < 1e-12,
          f"mm512: the twin's forward differs from its composition by "
          f"{out['forward64_vs_composed']}")
    check_launches("mm512 forward", {"launches": out["launches_per_forward"]},
                   {"k1_f32": n_levels * N, "k2_f32": N})
    check_launches("mm512 forward64",
                   {"launches": out["launches_per_forward64"]},
                   {"k1_f64": (n_levels - n_fine) * N, "k2_f64": N,
                    "k3_f64": n_fine * N})
    check(out["finite"] and tuple(res.x.shape) == (N, NORTH, NORTH, NQ),
          "mm512: bad x")
    check(res.converged and out["true_f64_residual"] < 1e-8,
          f"mm512: true f64 residual {out['true_f64_residual']}")
    check(res.refinements <= 3, f"mm512: {res.refinements} rounds")
    check(out["f32_path_residual"] < 1e-5,
          f"mm512: f32-path residual {out['f32_path_residual']}")
    sweeps, fast = run["twin_sweeps"], run["matvecs"]
    check(sweeps == N * (1 + res.refinements), f"mm512: {sweeps} twin sweeps")
    check_launches("mm512", out, {
        "k1_f32": n_levels * fast, "k2_f32": fast,
        "k1_f64": (n_levels - n_fine) * sweeps, "k2_f64": sweeps,
        "k3_f64": n_fine * sweeps})
    return out


def ptxas_usage(log, names):
    """Per entry function of an nvcc -Xptxas -v log whose mangled name
    holds one of `names`: the function, its registers, its spill line and
    its static shared memory, as ptxas reports them."""
    out, row = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            row = ({"function": m.group(1)}
                   if any(n in m.group(1) for n in names) else None)
        elif row is not None and "spill" in ln:
            row["spill"] = ln.strip()
        elif row is not None and "registers" in ln:
            smem = re.search(r"(\d+) bytes smem", ln)
            row["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            row["static_smem"] = int(smem.group(1)) if smem else 0
            out.append(row)
            row = None
    return out


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
    usage = {k: ptxas_usage(v, ("",)) for k, v in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {k: os.path.relpath(v, ROOT) for k, v in libs.items()},
          "ptxas": {k: {"functions": len(rows),
                        "max_registers": max(
                            (row["registers"] for row in rows), default=0),
                        "spills": [row for row in rows
                                   if re.search(r"[1-9]\d* bytes spill",
                                                row.get("spill", ""))]}
                    for k, rows in usage.items()}})

    # the two kernels redesigned for the card, at r = 16 (np 4): registers,
    # spills and static shared memory, per instance
    from aniso_torch.kernels import m2l, offsets
    emit({"phase": "redesigned_kernels",
          "ptxas": [row for src in (m2l.SOURCE, offsets.SOURCE)
                    for row in usage.get(src, [])
                    if "Li16E" in row["function"]
                    and ("m2l_translate_modes_kernel" in row["function"]
                         or "offsets_translate_kernel" in row["function"])]})

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
    # the all-modes instances at demo128's shapes (deg 1: one node per
    # square) and mm512's (deg 3), D = 2N - 1 = 9 modes per launch; K9d at
    # the grids of dsa64, demo128 and, for scale, 512^2
    D = 2 * MODES - 1
    both = (("m0", False), ("m0_compat", True))
    lv[DEMO] = list(range(2, int(math.log2(DEMO)) + 1))
    for sz, nq, deg, cf in ((DEMO, 1, 1, demo_coeffs(DEMO)),
                            (NORTH, NQ, 3, bench_coeffs(NORTH))):
        tag = "deg1" if deg == 1 else "deg3"
        chk[sz, f"k1d_f32_{tag}"] = kern.k1(sz, "f32", lv[sz], D=D)
        chk[sz, f"k1d_f64_{tag}"] = kern.k1(sz, "f64", lv[sz][:-2], D=D)
        for inst in ("f32", "f64"):
            chk[sz, f"k2d_{inst}_{tag}"] = kern.k2(sz, inst, both, D=D, nq=nq)
        chk[sz, f"k3d_f64_{tag}"] = kern.k3(sz, "f64", lv[sz][-2:], cf, D=D,
                                            deg=deg)
        torch.cuda.empty_cache()
    # dsa64's shapes (float64, deg 2: 4 nodes per square, all levels dense):
    # one mode for N = 1, and for N = 3 the all-modes instances at D = 5,
    # less than one chunk of modes (their partly filled epilogues)
    lv[DSA_SZ] = list(range(2, int(math.log2(DSA_SZ)) + 1))
    for N, _ in DSA64_ITERS:
        if N == 1:
            chk[DSA_SZ, "k2_f64_deg2"] = kern.k2(DSA_SZ, "f64", both, nq=4)
        else:
            chk[DSA_SZ, "k1d_f64_deg2"] = kern.k1(DSA_SZ, "f64", lv[DSA_SZ],
                                                  D=2 * N - 1)
            chk[DSA_SZ, "k2d_f64_deg2"] = kern.k2(DSA_SZ, "f64", both,
                                                  D=2 * N - 1, nq=4)
    for sz in (DSA_SZ, DEMO, NORTH):
        for inst in ("f32", "f64"):
            chk[sz, f"k9d_{inst}"] = kern.k9d(sz, inst)
    # K7 at oracle16_dense's shapes (all 2304^2 pairs: its whole build) and
    # at dense64's (512 target rows x all 36,864 sources)
    chk[16, "k7"] = kern.k7(16, 16 * 16 * NQ)
    chk[64, "k7"] = kern.k7(64, 512, plain_reps=1)
    torch.cuda.empty_cache()
    for sz in sorted({16, 64, 128, DSA_SZ, DEMO, NORTH}):
        emit({"phase": "kernels_vs_plain", "sz": sz,
              **{k: rows for (z, k), rows in chk.items() if z == sz}})

    bench, _ = run_problem(torch, kern, "bench", 64, 0.95, False,
                           expect_iters=14, timing=True)
    run_problem(torch, kern, "oracle64", 64, 0.95, True,
                oracle="oracle_64", expect_iters=18)
    run_problem(torch, kern, "oracle128", 128, 0.5, True,
                oracle="oracle_128", expect_iters=18, warm=False)
    refined, x_refined = run_refined512(torch, kern)
    torch.cuda.empty_cache()
    _, leaf512 = run_f32_512(torch, kern, x_refined)
    torch.cuda.empty_cache()
    f64, x_f64 = run_problem(torch, kern, "f64_64", 64, 0.95, True,
                             oracle="oracle_64", dtype="float64", tol=1e-10,
                             max_true_res=1e-9)
    run_oracle16_dense(torch, kern)
    dense64 = run_dense64(torch, kern, x_f64)
    torch.cuda.empty_cache()
    demo = run_demo128(torch, kern)
    torch.cuda.empty_cache()
    dsa64 = run_dsa64(torch, kern)
    torch.cuda.empty_cache()
    mm = run_mm512(torch, kern)
    torch.cuda.empty_cache()
    run_cli(torch)

    # times and bounds at each kernel's main-path shapes (summed over the
    # levels one matvec or twin sweep runs); errors the worst over every
    # checked size; launches counted in that path's run
    def worst(key):
        return max(r["max_abs_err"] for (_, k), rows in chk.items()
                   if k == key or k.startswith(key + "_deg") for r in rows)

    rl = refined["launches"]
    dl = demo["plain"]["launches"]
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
        # the all-modes instances (D = 9 modes of one charge per launch):
        # times at demo128's shapes, launches from its plain refined solve;
        # mm512's solve beside them
        kernel_line("m2l_translate_modes", "aniso_torch/csrc/m2l_translate.cu",
                    "aniso_tpu/fmm/apply.py:745", dl["k1_f32"],
                    chk[DEMO, "k1d_f32_deg1"], id="K1-D",
                    shapes=f"demo128 {DEMO}^2, D = {D}, levels 2-7",
                    launches_mm512=mm["launches"]["k1_f32"],
                    ms_mm512=Kernels.total(chk[NORTH, "k1d_f32_deg3"])["ms"],
                    one_mode_launches_ms=Kernels.total(
                        chk[DEMO, "k1d_f32_deg1"])["one_mode_launches_ms"],
                    max_abs_err_all_sizes=worst("k1d_f32")),
        kernel_line("m2l_translate_modes_f64",
                    "aniso_torch/csrc/m2l_translate.cu",
                    "aniso_tpu/fmm/apply.py:745", dl["k1_f64"],
                    chk[DEMO, "k1d_f64_deg1"], id="K1-D f64",
                    shapes=f"demo128 twin, D = {D}, coarse levels 2-5",
                    launches_mm512=mm["launches"]["k1_f64"],
                    launches_dsa64=sum(o[k]["launches"]["k1_f64"]
                                       for o in dsa64 if o["modes"] > 1
                                       for k in ("plain", "dsa")),
                    ms_dsa64=Kernels.total(chk[DSA_SZ, "k1d_f64_deg2"])["ms"],
                    max_abs_err_all_sizes=worst("k1d_f64")),
        kernel_line("near_contract_modes", "aniso_torch/csrc/near_contract.cu",
                    "aniso_tpu/fmm/apply.py:762", dl["k2_f32"],
                    chk[DEMO, "k2d_f32_deg1"][:1], id="K2-D",
                    shapes=f"demo128 {DEMO}^2, deg 1, D = {D}",
                    launches_mm512=mm["launches"]["k2_f32"],
                    ms_mm512=chk[NORTH, "k2d_f32_deg3"][0]["ms"],
                    max_abs_err_all_sizes=worst("k2d_f32")),
        kernel_line("near_contract_modes_f64",
                    "aniso_torch/csrc/near_contract.cu",
                    "aniso_tpu/fmm/apply.py:762", dl["k2_f64"],
                    chk[DEMO, "k2d_f64_deg1"][:1], id="K2-D f64",
                    shapes=f"demo128 twin, deg 1, D = {D}",
                    launches_mm512=mm["launches"]["k2_f64"],
                    ms_mm512=chk[NORTH, "k2d_f64_deg3"][0]["ms"],
                    launches_dsa64=sum(o[k]["launches"]["k2_f64"]
                                       for o in dsa64 if o["modes"] > 1
                                       for k in ("plain", "dsa")),
                    ms_dsa64=chk[DSA_SZ, "k2d_f64_deg2"][0]["ms"],
                    max_abs_err_all_sizes=worst("k2d_f64")),
        kernel_line("offsets_translate_modes_f64",
                    "aniso_torch/csrc/offsets_translate.cu",
                    "aniso_tpu/fmm/apply.py:427", dl["k3_f64"],
                    chk[DEMO, "k3d_f64_deg1"], id="K3-D f64",
                    shapes=f"demo128 twin, deg 1, D = {D}, fine levels 6-7",
                    launches_mm512=mm["launches"]["k3_f64"],
                    ms_mm512=Kernels.total(chk[NORTH, "k3d_f64_deg3"])["ms"],
                    max_abs_err_all_sizes=worst("k3d_f64")),
        kernel_line("diffusion_apply", "aniso_torch/csrc/diffusion_apply.cu",
                    "aniso_tpu/solver/dsa.py:85",
                    demo["dsa"]["launches"]["k9d_f32"], chk[DEMO, "k9d_f32"],
                    id="K9d", shapes=f"demo128 DSA, {DEMO}^2 cells",
                    max_abs_err_all_sizes=worst("k9d_f32")),
        kernel_line("diffusion_apply_f64",
                    "aniso_torch/csrc/diffusion_apply.cu",
                    "aniso_tpu/solver/dsa.py:85",
                    sum(o["dsa"]["launches"]["k9d_f64"] for o in dsa64),
                    chk[DSA_SZ, "k9d_f64"], id="K9d f64",
                    shapes=f"dsa64 DSA, {DSA_SZ}^2 cells",
                    max_abs_err_all_sizes=worst("k9d_f64")),
        # K7: times of one launch at dense64's shapes (512 rows; its
        # set_coeff launches 82 of up to 455 rows), the bound on the FP64
        # CUDA cores; the whole 16^2 build and the pair-list form beside
        kernel_line("line_integral", "aniso_torch/csrc/line_integral.cu",
                    "aniso_tpu/ops/attenuation.py:112",
                    dense64["launches"]["k7_f64"], chk[64, "k7"][:1],
                    id="K7", shapes="dense64 64^2: 512 target rows x 36864 "
                    "sources, one mode",
                    ms_16=chk[16, "k7"][0]["ms"],
                    plain_ms_16=chk[16, "k7"][0]["plain_ms"],
                    bound_ms_16=chk[16, "k7"][0]["bound_ms"],
                    pairs_ms=chk[64, "k7"][0]["pairs_ms"],
                    max_abs_err_all_sizes=worst("k7")),
    ]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
