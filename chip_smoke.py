#!/usr/bin/env python3
"""On-GPU smoke test of aniso_torch: builds the CUDA kernels, holds each
against its plain PyTorch version, and drives the port's paths.

    python3 chip_smoke.py

Needs one CUDA card (it exits non-zero without one) and the repository's
aniso_torch package beside it.  Phases, each printing one JSON line:

  device   first the nvidia-smi name and power limit line as nvidia-smi
           prints it, then torch / CUDA versions and the TF32 pins
  build    nvcc of K1, K2, K3, K9d, K9, K7, K10, K11 / K12 and K8 and g++
           of the host engine,
           in parallel; per library the entry functions ptxas compiled, their
           most registers and any spill
  redesigned_kernels  ptxas's registers, spills and static shared memory
           of the r = 16 (np 4) instances of K1's one-mode and all-modes
           kernels and of K3 (their dynamic shared memory is in PERF.md),
           of every K2, K10, K8 and K11 instance and of K7's deg 3
           instances; K8's two kernels and K11's one compiled in both
           types
  kernels_vs_plain  at every size solved below, each kernel at the shapes
           the paths give it, against its plain version on inputs from a
           seed (random E, M, cosr; the sigma field's coefficients of the
           problem solved there for K3), with CUDA-event device times and
           bounds:
             64^2, 128^2: K1 f32 at every level, K2 f32 (compat off, on);
             64^2: K1/K2 f64, K3 f32/f64 at the fine levels, and the
             one-mode K1 at np 3 and 5 in f32 and f64 (rows that start
             off 16 bytes);
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
           K9 (the DSA CG, one launch a call) at dsa64's, demo128's and
           dsa512's grids and dtypes on their medium and first right-hand
           side, against pcg_plain (counts within 1, x within K9_TOL of
           |x|), with its time per CG iteration and the barrier floor of
           its loop; np 6 and 7: K3 f32/f64 at the np6 phase's fine levels,
           K1-D f64 and K3-D f64 at demo128's twin shapes;
           K7 (the exact line integral, f64 arithmetic) at 16^2 and 64^2:
           the whole-matrix form (one launch, E once per unordered pair)
           against the plain target -> source rows on the first and last
           rows (at 16^2 all 2304; at 64^2 512 each, the last ones from
           mirrored tiles), timed whole, and the pair-list form on the
           first rows' pairs, the basis at local coordinates on the
           compat-transformed coefficients and at global ones on the raw
           coefficients, with its operation bound on the FP64 CUDA cores
           from the sub-segments of the unique pairs (all ordered pairs
           beside); its runtime-deg instance at deg 9, 10 and 12 on 8^2
           (128 rows checked at each end);
           at sharded512's shapes (8 shards of 256 x 128): K10, the halo
           fill, f32 and f64, on u (one square) and on the leaf's M (two
           boxes), bitwise against its plain version, with one Tensor.copy_
           of the same bytes beside it; K1-S on one shard at levels 3-9 and
           K2-S on one shard (compat off, on), f32 and f64;
           K8, the up pass (P2M, M2M) and the down pass (L2L with T, the
           leaf's L2T, near add and 1/2pi), at 64^2 (f32), at 512^2 (f32,
           f64), with D = 9 modes at 512^2 (f32, f64) and on one sharded512
           shard (f32, f64), with the plain version's summed device time by
           the profiler as library_ms (the torch einsums K8 replaces).
           Gates: max|kernel - plain| <= 1e-5 max|plain| in f32 (sums of
           432 to 729 terms, or K3's 27 atomic adds, in another order) and
           1e-12 max|plain| in f64
  krylov_vs_plain  the GMRES step's kernels at restart 80 and steps i = 0,
           14 and 79: K11 (CGS2) f32 and f64 on the one-mode fields of 64^2
           and 512^2 (deg 3) against cgs2_plain (the new basis vector, u
           and the column within TOL_KERNEL of their largest value; rows
           other than i + 1 untouched; an inactive step a no-op), timed
           beside its plain version and torch.mv(V[:i+1], w) (library_ms);
           K12's step against givens_step_plain (1e-14) and its
           back-substitution (1e-12), beside an empty launch's floor
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
           residual < 1e-10; one K7 launch (the f64 store) in set_coeff,
           no other kernel of the port
  dense64  the reference CLI's default problem on the dense backend
           (benchmarks/oracle_64, compat on, f64, tol 1e-10): set_coeff
           split into the real matrices, K7 and the rest, peak memory, the
           matvec against its byte bound (the two
           f64 matrices read once), true residual < 1e-9, relative Linf
           error < 1e-2 against oracle_64, distance from f64_64's FMM x,
           and apply_mode(0, u) of the FMM against the dense one on a
           seeded u < 6e-3 (the JAX property-test bound); K7 launches as
           in oracle16_dense
  dense64_f32  the same problem on the dense backend in float32, tol 1e-7
           (K7 stores the matrices in float32): true residual < 1e-5,
           relative Linf error < 1e-2 against oracle_64; one K7 launch (the
           f32 store)
  demo128  the reference's demo.m problem (examples/demo_torch.py): 128^2,
           deg 1, N = 5 coupled modes, g = 0.8, sigma_s = 20, sigma_a =
           0.2, Gaussian charge on mode 0, f32 inner GMRES(80) with f64
           refinement to tol 1e-11; plain and with the DSA preconditioner.
           Converged in <= 4 rounds with the true f64 residual < 1e-11
           recomputed here; inner iterations within 10% of the JAX
           package's on the CPU for the same command (DEMO_ITERS), fewer
           with DSA than without; the two x within 1e-8 relative; K1/K2/K3
           launches = launches per sweep x sweeps (N sweeps per forward);
           K9 launches = the preconditioner calls, K9d launches 0; CG
           iterations per preconditioner call, its time per CG iteration
           and its share of the solve time
  dsa64    benchmarks/dsa_bench.py's 64^2 cases in float64 on the card (deg
           2, tol 1e-8, sigma_s = 20): (N = 1, g = 0) and (N = 3, g = 0.9),
           plain and DSA: the JAX package's CPU iteration counts +- 1
           (DSA64_ITERS), DSA never above plain, true residual < 1e-7
           (< 1e-6 with DSA, which stops on the preconditioned residual),
           the two x within 1e-6 relative; K9 launches = the
           preconditioner calls, K9d launches 0
  dsa512   dsa64's first case (N = 1, g = 0, sigma_s = 20) on the 512^2
           grid at deg 2, f32 inner GMRES(80) refined to tol 1e-8, plain
           and with DsaPreconditioner(max_iter=4000): both converged with
           a true f64 residual < 1e-8, fewer inner iterations with DSA, K9
           launches = the preconditioner calls, K9d launches 0, no call at
           max_iter; CG iterations per call, time per CG iteration, the
           preconditioner's share of the solve
  np6      np_cheb 6 (r = 36) on 32^2, deg 2, refined to tol 1e-8: the
           twin's fine levels through K3's split-pair instance; converged
           with a true f64 residual < 1e-8, launches per sweep x sweeps
  np16     np_cheb 16 (r = 256: a float64 row of 27 r values is 55 KB,
           past 48 KB) on 8^2, deg 1, refined to tol 1e-8, both levels
           per-offset (K3's runtime-r instance in f32 and f64): converged
           with a true f64 residual < 1e-8, launches per sweep x sweeps
  mm512    the multi-mode system at the north-star grid: 512^2, deg 3, N =
           5, g = 0.8, the bench sigma, its charge on mode 0, refined to
           tol 1e-8: forward(u) on a seeded u within 1e-5 of its maximum of
           u - sum C_fwd[i, a, d] apply_mode(d, sigma_s u_a) composed from
           the one-mode kernels, the twin's forward within 1e-12 of the
           same composition in f64; converged in <= 3 rounds, true f64
           residual < 1e-8, x's residual through the f32 path < 1e-5;
           forward() time, device time and busy share, time per mode pair,
           the twin forward's time, launches per forward
  sharded512  domain decomposition (aniso_torch.parallel) at the north
           star's grid: 512^2, deg 3, g 0.5, np 4, f32, tol 1e-7, GMRES(80),
           bench sigma and charge, on a 2 x 4 mesh of 8 shards on the card
           (level 2 the replicated route, levels 3-9 sharded): the sharded
           matvec within 1e-6 (relative 2-norm) of the one-device one, its
           wall and device time beside the one-device matvec's, the
           sharded GMRES solve in 14 +- 1 iterations with the true residual
           (one-device operator) < 1e-5, K10 / K1-S / K2-S / K1 launches =
           launches per matvec x matvecs, permute bytes per matvec < 8
           fields, all-gather bytes those of level 2's M; the shard copies'
           bytes and the peak memory
  sharded64_compat  benchmarks/oracle_64 (compat on) on a 2 x 2 mesh, every
           level 2-6 sharded: 18 +- 1 iterations, relative Linf < 1e-3
           against oracle_64, one mode-1 sharded matvec within 1e-6 of the
           one-device one, the same launch and byte gates
  distributed1  parallel.distributed.init as a world-size-1 NCCL group on a
           free localhost port, a 2 x 2 mesh of 4 shards on the card over
           it: one sharded matvec within 1e-6 of the one-device one and one
           all_reduce (the norm over the shards), then the group destroyed
  cli      `python -m aniso_torch run ...` in subprocesses in a temporary
           directory: oracle_64 on the FMM backend to tol 1e-10 and
           oracle_16 on the dense one, both with --compat-global-basis:
           exit code 0, result.csv within 1e-3 / 1e-2 of the oracle, and a
           second run warm-started from it in <= 1 iteration; oracle_16
           also without the flag (its error reported, no gate); oracle_64
           with --distributed as one process of an NCCL group (exit 0,
           within 1e-3 of the oracle)

Every solve of one device runs GMRES with its state on the card and its
Arnoldi step (the matvec, K11, K12; the preconditioner and its K9 in the
DSA runs) captured as a CUDA graph at the solver's first solve and
replayed; the sharded phases step the same state uncaptured.  Each solve
phase reports its gmres counts (steps, replays, cycles, solves, captures),
host_reads, steps_after_done, graph_capture_s, and repeat_s, device_s /
device_busy_share from the same solve repeated under torch.profiler (K9's
device time there gives the DSA runs' precond_s); gates: the steps
replayed but one eager step per capture, at most one step after
convergence and iterations + 2 cycles + 2 host reads per inner solve,
the matvecs the steps add up to, and K11 / K12 launches = steps (K12's
back-substitution = cycles) beside every other launch count.  A replay
runs no Python, so its launches are counted by the capture's increments:
each captured step's graph holds them family by family against its kernel
nodes, read through the driver API (replay_launches); one of each call a
solve makes outside its captured step (the rhs, a forward, the f64 twin's,
the preconditioner, the back-substitution; a sharded solve's matvec and
Givens step) is captured into a throwaway graph, its counted launches held
the same way (eager_launches); the repeat's counts stand beside what the
profiler saw there (profiled_launches), which may be fewer by at most
PROFILER_MISS_MAX records the profiler lost (profiler_missed), never more.

then the device kernels of one 64^2 matvec, of one replay of bench's
captured step and of one sharded512 matvec beside the parent tree's,
counted the same way (device records only) by tools/kernel_counts.py on
the parent (PARENT_KERNELS), the kernels line
(times at each kernel's main-path shapes, launches counted in the run of
that path) and last
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The bench phase also prints the rows of the kernel table left to torch
(K4, K5: time, launches, bound).  Any failed check raises before the
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
# K7's float32 store (float64 arithmetic, each value rounded once to
# float32: at most 2^-24 of the largest) against its float64 plain rows
TOL_STORE_F32 = 1e-7
# K9 against pcg_plain: |x - x_plain| / |x_plain|, and the iteration
# counts within K9_COUNTS (f64: 1; f32: 15% of plain's, since at tol 1e-8
# the loop stops on a residual below float32's resolution, where the two
# orders of the dot products' sums part: 237 against 258 at 128^2 on an
# NVIDIA H100)
K9_TOL = {"f32": 1e-4, "f64": 1e-10}
K9_COUNTS = {"f32": 0.15, "f64": 0.0}
HOLD_CYCLES = 5_000_000          # GPU sleep before a kernel sample: ~2.5 ms
SEED = 0
DEVICE = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
R, NQ = 16, 9                    # np_cheb 4 everywhere; deg 3 but in demo128
NORTH = 512                      # the north-star grid (BASELINE.json)
DEMO = 128                       # demo.m's grid, deg 1 (one node per square)
DSA_SZ = 64                      # benchmarks/dsa_bench.py's larger grid, deg 2
NP6_LEVELS = [2, 3, 4, 5]        # the np6 phase's (32^2), the last 2 fine
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

# the parent tree's (the port before K8 and K11 were redesigned: two K8
# launches a 512^2 pass, six K11 launches a step) device kernels a 64^2
# matvec, a replay of bench's captured step and a sharded512 matvec:
# `python3 tools/kernel_counts.py --tree <parent>` on an NVIDIA H100 80GB
# HBM3 at 700 W, device records only, as device_ms_per_call counts (PERF.md
# section 5)
PARENT_KERNELS = {"matvec_64": 8.0, "captured_step_64": 18.0,
                  "sharded512_matvec": 121.0}


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
            attenuation, diffusion, halo, krylov, m2l, near, offsets, pcg,
            transfer,
        )

        self.torch, self.flush = torch, flush
        self.transfer = transfer
        self.m2l, self.near, self.offsets = m2l, near, offsets
        self.diffusion, self.attenuation, self.pcg = diffusion, attenuation, pcg
        self.halo, self.krylov = halo, krylov
        # K1-S and K2-S count under k1_shard_* / k2_shard_*; K12 under
        # k12_step and k12_backsub; K8 under k8_up_* and k8_down_*
        self.counters = (("k1", m2l.launches), ("k2", near.launches),
                         ("k3", offsets.launches),
                         ("k9d", diffusion.launches), ("k9", pcg.launches),
                         ("k7", attenuation.launches), ("k10", halo.launches),
                         ("k11", krylov.launches),
                         ("k12", krylov.givens_launches),
                         ("k8", transfer.launches))
        self.shift = torch.as_tensor(parity_shift_table_np(),
                                     dtype=torch.int32, device=DEVICE)

    def reset(self):
        for _, launches in self.counters:
            for inst in launches:
                launches[inst] = 0

    def counts(self):
        return {f"{k}_{inst}": n
                for k, launches in self.counters
                for inst, n in launches.items()}

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
                reps=21, peak=None):
        """One kernel call against its plain version, then both timed.
        per_mode: the same result from one launch of the one-mode instance
        per mode, held to the same gate and timed as well.  peak: the
        operation rate of the bound (default: the type's)."""
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
               "plain_ms": event_ms(torch, plain, reps=reps,
                                    flush=self.flush),
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

    def k1(self, sz, inst, levels, D=None, np_cheb=4):
        """K1 at the given levels of a sz^2 solve: E in [0, 3).  D: the
        all-modes instance with D mode tables (None: one mode)."""
        torch, m2l = self.torch, self.m2l
        r = np_cheb * np_cheb
        rows = []
        for level in levels:
            m2 = (1 << level) // 2
            seed = 1000 * level + sz
            E = self.rand((4, m2, m2, r, 27 * r), inst, 0.0, 3.0, seed=seed)
            cosr = self.rand(((D,) if D else ()) + (4, r, 27 * r), inst,
                             normal=True, seed=seed + 1)
            M = self.rand((2 * m2, 2 * m2, r), inst, normal=True,
                          seed=seed + 2)
            item = E.element_size()
            nd = D or 1
            row = self.compare(
                f"K1 {inst} {sz}^2 level {level} D {D} np {np_cheb}", inst,
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

    def k10(self, inst, lx, ly, q, w, mesh_n=8):
        """K10 at one exchange of a mesh of mesh_n shards of (lx, ly, q)
        on the card (the jobs parallel.halo builds: one launch), bitwise
        against its plain version.  Bound: the extended blocks written once
        and the regions they copy read once.  No PyTorch call computes the
        fill; copy_ms is one Tensor.copy_ of the extended blocks' bytes,
        the floor a copy reaches."""
        from aniso_torch.parallel import api
        from aniso_torch.parallel import halo as phalo

        torch, halo = self.torch, self.halo
        mesh = api.make_mesh(devices=[DEVICE] * mesh_n)
        blocks = [self.rand((lx, ly, q), inst, normal=True, seed=100 + k)
                  for k in range(mesh_n)]
        groups, _ = phalo.exchange_jobs(mesh, blocks, w)
        ((_, jobs),) = groups.values()
        got = halo.halo_fill(jobs, w)
        want = [halo.halo_fill_plain(regions, w) for regions in jobs]
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K10 {inst} w {w}: not bitwise its plain version ({err})")
        item = blocks[0].element_size()
        written = sum(o.numel() for o in got) * item
        read = item * sum(r.numel() for regions in jobs for row in regions
                          for r in row if r is not None)
        bms, bby = bound_ms(written + read, 0, inst)
        src = torch.empty(written // item, dtype=blocks[0].dtype,
                          device=DEVICE)
        dst = torch.empty_like(src)
        del got, want
        return [{"w": w, "lx": lx, "ly": ly, "q": q, "shards": mesh_n,
                 "max_abs_err": err, "bitwise": True,
                 "ms": event_ms(torch, lambda: halo.halo_fill(jobs, w),
                                flush=self.flush),
                 "plain_ms": event_ms(torch, lambda: [
                     halo.halo_fill_plain(regions, w) for regions in jobs],
                     flush=self.flush),
                 "copy_ms": event_ms(torch, lambda: dst.copy_(src),
                                     flush=self.flush),
                 "bytes": written + read, "flops": 0, "bound_ms": bms,
                 "bound_by": bby}]

    def k1s(self, sz, inst, levels, mesh=(2, 4), np_cheb=4):
        """K1-S on one shard of an (mx, my) mesh of sz^2 at the given
        levels: its (4, m2 / mx, m2 / my, r, 27r) slice of E in [0, 3) and
        its multipoles extended by two boxes."""
        m2l = self.m2l
        r = np_cheb * np_cheb
        rows = []
        for level in levels:
            m2 = (1 << level) // 2
            m2x, m2y = m2 // mesh[0], m2 // mesh[1]
            seed = 2000 * level + sz
            E = self.rand((4, m2x, m2y, r, 27 * r), inst, 0.0, 3.0,
                          seed=seed)
            cosr = self.rand((4, r, 27 * r), inst, normal=True,
                             seed=seed + 1)
            Mext = self.rand((2 * m2x + 4, 2 * m2y + 4, r), inst,
                             normal=True, seed=seed + 2)
            item = E.element_size()
            row = self.compare(
                f"K1-S {inst} {sz}^2 shard {mesh} level {level}", inst,
                lambda: m2l.m2l_translate_shard(E, cosr, Mext, self.shift),
                lambda: m2l.m2l_translate_shard_plain(E, cosr, Mext,
                                                      self.shift),
                item * (E.numel() + cosr.numel() + Mext.numel()
                        + 4 * m2x * m2y * r) + 4 * self.shift.numel(),
                4 * E.numel())
            rows.append({"level": level, "m2x": m2x, "m2y": m2y, **row})
            del E
        return rows

    def k2s(self, lx, ly, inst, variants=(("m0", False),), nq=NQ):
        """K2-S on one (lx, ly) shard with its halo-extended u, with and
        without the Duffy term (slot 0 is mode 0)."""
        near = self.near
        seed = 3000 + lx
        E = self.rand((lx, ly, nq, 3, 3, nq), inst, 0.0, 0.5, seed=seed)
        cosrw, S, ue, sigma_w, duffy = (
            self.rand(shape, inst, normal=True, seed=seed + k)
            for k, shape in enumerate(((nq, 3, 3, nq), (nq, 3, 3, nq),
                                       (lx + 2, ly + 2, nq), (lx, ly, nq),
                                       (lx, ly, nq, nq)), 1))
        rows = []
        for name, compat in variants:
            dfy = duffy if compat else None
            item = E.element_size()
            row = self.compare(
                f"K2-S {inst} shard {lx} x {ly} {name}", inst,
                lambda: near.near_contract_shard(E, cosrw, S, ue, sigma_w,
                                                 dfy),
                lambda: near.near_contract_shard_plain(E, cosrw, S, ue,
                                                       sigma_w, dfy),
                item * (E.numel() + cosrw.numel() + S.numel() + ue.numel()
                        + 2 * sigma_w.numel()
                        + (0 if dfy is None else dfy.numel())),
                4 * E.numel())
            rows.append({"variant": name, "lx": lx, "ly": ly, **row})
        return rows

    def k3(self, sz, inst, levels, coeffs_np, D=None, deg=3, np_cheb=4):
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
        r = np_cheb * np_cheb
        rows = []
        for level in levels:
            m2 = (1 << level) // 2
            B = sz >> level
            Wo = build_m2l_offsets_fine(grid, tcfg, level, np_cheb, dtype,
                                        DEVICE)["Wo"]
            seed = 2000 * level + sz
            cosr = self.rand(((D,) if D else ()) + (4, r, 27 * r), inst,
                             normal=True, seed=seed)
            M = self.rand((2 * m2, 2 * m2, r), inst, normal=True,
                          seed=seed + 1)
            item = coeffs.element_size()
            row = self.compare(
                f"K3 {inst} {sz}^2 level {level} D {D} np {np_cheb}", inst,
                lambda: offsets.offsets_translate(Wo, coeffs, cosr, M,
                                                  self.shift),
                lambda: offsets.offsets_translate_plain(Wo, coeffs, cosr, M,
                                                        self.shift),
                item * (Wo.numel() + coeffs.numel() + cosr.numel()
                        + (1 + nd) * M.numel()) + 4 * self.shift.numel(),
                offsets.translate_flops(np_cheb, B, grid.nq, m2, nd),
                per_mode=D and (lambda: torch.stack(
                    [offsets.offsets_translate(Wo, coeffs, cosr[d], M,
                                               self.shift)
                     for d in range(D)])),
                reps=5 if D else 21)
            rows.append({"level": level, "m2": m2, "B": B, **row})
        return rows

    def k8(self, lx, ly, n, inst, D=None, np_cheb=4, nq=NQ):
        """K8 on an (lx, ly) plane of squares through n levels above its
        leaf (a shard's rectangle as a whole grid's): the up pass (P2M,
        M2M) on seeded charges, then the down pass (L2L with a seeded T per
        level, the leaf's L2T, near add and 1/2pi) for D modes (None: one
        mode), each against its plain version.  Bound: bytes, each input
        read once (u; L0, every T and the near field) and each output
        written once (every level's M; the far field).  library_ms: the
        plain version's summed device time by torch.profiler (the einsums
        the port ran before), the one PyTorch form of the function."""
        from aniso_torch.core.geometry import make_grid
        from aniso_torch.fmm.apply import build_fmm_static

        torch, tr = self.torch, self.transfer
        dtype = torch.float32 if inst == "f32" else torch.float64
        st = build_fmm_static(make_grid(max(lx, ly), math.isqrt(nq)),
                              np_cheb, DEVICE, dtype)
        r, nd = np_cheb * np_cheb, D or 1
        lead = (D,) if D else ()
        seed = 4000 + lx + ly + n
        u = self.rand((lx, ly, nq), inst, normal=True, seed=seed)
        L0 = self.rand(lead + (lx >> n, ly >> n, r), inst, normal=True,
                       seed=seed + 1)
        Ts = [self.rand(lead + (lx >> (n - j), ly >> (n - j), r), inst,
                        normal=True, seed=seed + 1 + j)
              for j in range(1, n + 1)]
        near = self.rand(lead + (lx, ly, nq), inst, normal=True,
                         seed=seed + 99)
        item = u.element_size()
        boxes = sum((lx >> s) * (ly >> s) for s in range(n + 1))
        ops = item * (r * nq + 2 * r)
        # a transfer as two 1-D products: 12 np^3 operations a parent (M2M)
        # or 6 np^3 + r a child (L2L with T)
        parents = boxes - lx * ly
        children = boxes - (lx >> n) * (ly >> n)
        passes = {
            "up": (lambda: tr.up_pass(st["p2m_w"], st["m2m_1d"], u, n),
                   lambda: tr.up_pass_plain(st["p2m_w"], st["m2m_1d"], u, n),
                   item * (u.numel() + boxes * r) + ops,
                   2 * lx * ly * nq * r + 12 * np_cheb ** 3 * parents),
            "down": (lambda: tr.down(st["m2m_1d"], L0, Ts, st["l2t"], near),
                     lambda: tr.down_plain(st["m2m_1d"], L0, Ts, st["l2t"],
                                           near),
                     item * nd * (boxes * r + 2 * lx * ly * nq) + ops,
                     nd * ((6 * np_cheb ** 3 + r) * children
                           + (2 * r + 2) * lx * ly * nq))}
        rows = []
        for name, (fn, plain, nbytes, flops) in passes.items():
            before = dict(tr.launches)
            got = fn()
            launched = sum(tr.launches[k] - before[k] for k in before)
            want = plain()
            torch.cuda.synchronize()
            if name == "up":
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                scale = max(float(b.abs().max()) for b in want)
            else:
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
            check(err <= TOL_KERNEL[inst] * scale,
                  f"K8 {name} {inst} {lx} x {ly} D {D}: max err {err} > "
                  f"{TOL_KERNEL[inst]} x {scale}")
            del got, want
            bms, bby = bound_ms(nbytes, flops, inst)
            lib_ms, lib_kernels = device_ms_per_call(torch, plain)
            rows.append({
                "pass": name, "lx": lx, "ly": ly, "levels": n, "D": D,
                "np_cheb": np_cheb, "max_abs_err": err,
                "max_abs_plain": scale,
                "ms": event_ms(torch, fn, flush=self.flush),
                "plain_ms": event_ms(torch, plain, flush=self.flush),
                "library_ms": lib_ms, "plain_kernels": lib_kernels,
                "launches_per_call": launched, "bytes": nbytes,
                "flops": flops, "bound_ms": bms, "bound_by": bby})
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

    def k9(self, sz, inst, max_iter=4000):
        """K9, the whole CG of one preconditioner call, on a sz^2 grid of
        cells with the DSA phases' medium (sigma_t 20.2, sigma_a 0.2, so D
        = 0.5 / 20.2) and their first right-hand side (sigma_s times the
        cell means of the Gaussian charge), at the preconditioner's tol
        1e-8, against pcg_plain.  Gate: iteration
        counts within 1 (f32: within K9_COUNTS of plain's), |x - x_plain|
        <= K9_TOL |x_plain| (the same recurrences, each operation rounded
        alike, over hundreds of iterations; only the dot products are
        summed in another order).  Bound, for this run's k iterations: bytes (the six
        input fields read once, x written once, p written and read once an
        iteration) against operations (30 a cell an iteration: the stencil
        17, three dot products 6, the four vector updates 7) at the type's
        peak; beside it the loop's barrier floor (kernels.pcg.barrier_loop
        for the same k on the same grid)."""
        from aniso_torch.solver.dsa import make_diffusion_apply

        torch, pcg = self.torch, self.pcg
        dtype = torch.float32 if inst == "f32" else torch.float64
        full = torch.full((sz, sz), 0.5 / 20.2, dtype=dtype, device=DEVICE)
        st, diag = make_diffusion_apply(full, 0.2 + 0 * full, 1.0 / sz)
        c = (torch.arange(sz, dtype=dtype, device=DEVICE) + 0.5) / sz - 0.5
        b = 20.0 * torch.exp(-25 * (c[:, None] ** 2 + c[None, :] ** 2))
        args = (b, diag, *st)

        def run():
            return pcg.pcg(*args, tol=1e-8, max_iter=max_iter)

        def plain():
            return pcg.pcg_plain(*args, tol=1e-8, max_iter=max_iter)

        got, want = run(), plain()
        k, k_plain = int(got.iterations), want.iterations
        err = float(torch.linalg.vector_norm(got.x - want.x)
                    / torch.linalg.vector_norm(want.x))
        what = f"K9 {inst} {sz}^2"
        check(abs(k - k_plain) <= max(1, K9_COUNTS[inst] * k_plain),
              f"{what}: {k} iterations, plain {k_plain}")
        check(0 < k < max_iter, f"{what}: {k} iterations of {max_iter}")
        check(err <= K9_TOL[inst], f"{what}: x differs by {err}")
        n, item = sz * sz, b.element_size()
        nbytes = item * (7 * n + 2 * n * k)
        flops = 30 * n * k
        bms, bby = bound_ms(nbytes, flops, inst)
        ms = event_ms(torch, run, reps=7, flush=self.flush)
        floor = event_ms(torch, lambda: pcg.barrier_loop(n, k, dtype,
                                                         DEVICE),
                         reps=7, flush=self.flush)
        return [{"max_abs_err": err, "max_abs_err_is": "relative 2-norm",
                 "iterations": k, "iterations_plain": k_plain,
                 "max_iter": max_iter, "ms": ms,
                 "ms_per_cg_iteration": ms / k,
                 "plain_ms": event_ms(torch, plain, reps=3, flush=self.flush,
                                      warmup=1),
                 "bytes": nbytes, "flops": flops, "bound_ms": bms,
                 "bound_by": bby, "barrier_floor_ms": floor,
                 "barrier_floor_ms_per_iteration": floor / k}]

    def krylov_state(self, m, i, j=1, done=0.0):
        """A GMRES state (kernels.krylov.state_layout) at step i, active
        unless `done`, with the rotations, s and the new column of a seeded
        earlier cycle: cs, sn from angles, s and the column normal."""
        torch, kr = self.torch, self.krylov
        rng = np.random.default_rng(i)
        L = kr.state_layout(m)
        st = np.zeros(L.len)
        st[[kr.I, kr.J, kr.DONE, kr.NORMB, kr.TOL, kr.MAX_ITER]] = (
            i, j, done, 2.0, 1e-10, 400)
        ang = rng.uniform(0.0, 2 * np.pi, i)
        st[L.cs:L.cs + i], st[L.sn:L.sn + i] = np.cos(ang), np.sin(ang)
        st[L.s:L.s + i + 1] = rng.standard_normal(i + 1)
        st[L.col:L.col + i + 2] = rng.standard_normal(i + 2)
        H = np.triu(rng.standard_normal((m + 1, m)), -1) + 4 * np.eye(m + 1, m)
        st[L.H:L.s] = H.T.reshape(-1)
        return torch.as_tensor(st, device=DEVICE)

    def k11(self, sz, inst, i, m=80, nq=NQ):
        """K11, the CGS2 of GMRES step i (restart m) on the field of a sz^2
        one-mode solve (n = sz^2 nq): rows of V of unit norm and w from a
        seed, against cgs2_plain (JAX's masked full-basis pass in the
        field's type: V[i+1], u and the column; gate TOL_KERNEL of their
        largest value), and a step made inactive (done) changing nothing.
        Timed beside its plain version and torch.mv(V[:i+1], w), pass (a)
        alone in one PyTorch call (library_ms).  Bound: bytes, V[:i+1] and
        w read once, V[i+1] and u written once, ((i + 1) + 3) n itemsize
        (operations: 8 (i + 1) n on the FP64 CUDA cores); beside it the
        bytes of CGS2 as the kernel does it, V read three times, (3 (i + 1)
        + 8) n itemsize."""
        torch, kr = self.torch, self.krylov
        n = sz * sz * nq
        V = self.rand((m + 1, n), inst, normal=True, seed=i)
        V /= torch.linalg.vector_norm(V, dim=1, keepdim=True)
        w = self.rand((n,), inst, normal=True, seed=1000 + i)
        st = self.krylov_state(m, i)
        got = [V.clone(), w.clone(), torch.zeros_like(w), st.clone()]
        want = [V.clone(), w.clone(), torch.zeros_like(w), st.clone()]
        kr.cgs2(*got)
        kr.cgs2_plain(*want)
        torch.cuda.synchronize()
        L = kr.state_layout(m)
        col = slice(L.col, L.col + i + 2)
        err = float((got[0][i + 1] - want[0][i + 1]).abs().max())
        scale = float(want[0][i + 1].abs().max())
        err_col = float((got[3][col] - want[3][col]).abs().max())
        scale_col = float(want[3][col].abs().max())
        what = f"K11 {inst} {sz}^2 i={i}"
        check(err <= TOL_KERNEL[inst] * scale,
              f"{what}: V[i+1] max err {err} > {TOL_KERNEL[inst]} x {scale}")
        check(err_col <= TOL_KERNEL[inst] * scale_col,
              f"{what}: column max err {err_col} of {scale_col}")
        check(torch.equal(got[2], got[0][i + 1]), f"{what}: u != V[i+1]")
        check(torch.equal(got[0][[k for k in range(m + 1) if k != i + 1]],
                          V[[k for k in range(m + 1) if k != i + 1]]),
              f"{what}: a row other than i + 1 moved")
        idle = [V.clone(), w.clone(), torch.zeros_like(w),
                self.krylov_state(m, i, done=1.0)]
        before = [t.clone() for t in idle]
        kr.cgs2(*idle)
        kr.givens_step(idle[3], m)
        check(all(torch.equal(a, b) for a, b in zip(idle, before)),
              f"{what}: an inactive step changed its inputs")
        del idle, before
        item = V.element_size()
        nbytes = (i + 4) * n * item
        bms, bby = bound_ms(nbytes, 8 * (i + 1) * n,
                            peak=PEAK_F64_CUDA_CORES)
        basis = V[:i + 1]
        row = {"i": i, "n": n, "restart": m, "max_abs_err": err,
               "max_abs_plain": scale, "max_abs_err_column": err_col,
               "ms": event_ms(torch, lambda: kr.cgs2(*got), flush=self.flush),
               "plain_ms": event_ms(torch, lambda: kr.cgs2_plain(*want),
                                    reps=5, flush=self.flush),
               "library_ms": event_ms(torch, lambda: torch.mv(basis, w),
                                      flush=self.flush),
               "bytes": nbytes, "bound_ms": bms, "bound_by": bby,
               "bytes_cgs2_three_reads": (3 * (i + 1) + 8) * n * item}
        row["bound_ms_cgs2_three_reads"] = bound_ms(
            row["bytes_cgs2_three_reads"], 0)[0]
        return row

    def k12(self, i, m=80):
        """K12 at step i (restart m): the Givens step on a seeded state
        against givens_step_plain (the whole state; gate 1e-14 of its
        largest value: the same operations, each rounded alike) and the
        back-substitution against givens_backsub_plain (1e-12: its sums in
        another order).  Each timed call takes a fresh copy of the state
        (a step moves i).  Beside it the floor of one empty one-block
        launch (kernels.krylov.launch_floor).  Bound: bytes of the state
        it reads and writes, (4 i + 22) x 8."""
        torch, kr = self.torch, self.krylov
        st = self.krylov_state(m, i, j=i + 1)
        copies = [st.clone() for _ in range(60)]
        got, want = copies.pop(), st.clone()
        kr.givens_step(got, m)
        kr.givens_step_plain(want, m)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(err <= 1e-14 * scale, f"K12 i={i}: max err {err} of {scale}")
        L = kr.state_layout(m)
        kr.givens_backsub(got, m)
        kr.givens_backsub_plain(want, m)
        torch.cuda.synchronize()
        err_y = float((got[L.y:] - want[L.y:]).abs().max())
        scale_y = float(want[L.y:].abs().max())
        check(err_y <= 1e-12 * scale_y,
              f"K12 backsub i={i}: max err {err_y} of {scale_y}")
        it = iter(copies)
        nbytes = (4 * i + 22) * 8
        bms, bby = bound_ms(nbytes, 6 * i + 20, "f64")
        it_plain = iter([st.clone() for _ in range(8)])
        return {"i": i, "restart": m, "max_abs_err": err,
                "max_abs_plain": scale, "backsub_max_abs_err": err_y,
                "ms": event_ms(torch, lambda: kr.givens_step(next(it), m),
                               flush=self.flush),
                "plain_ms": event_ms(
                    torch, lambda: kr.givens_step_plain(next(it_plain), m),
                    reps=5, flush=self.flush),
                "floor_ms": event_ms(torch, lambda: kr.launch_floor(DEVICE),
                                     flush=self.flush),
                "backsub_ms": event_ms(torch, lambda: kr.givens_backsub(
                    got, m), flush=self.flush),
                "backsub_plain_ms": event_ms(
                    torch, lambda: kr.givens_backsub_plain(want, m), reps=5,
                    flush=self.flush),
                "bytes": nbytes, "bound_ms": bms, "bound_by": bby}

    def k7(self, sz, nrows, reps=3, deg=3, f32=False):
        """K7 at sz^2, degree deg, on the oracle problem's sigma_t: the
        whole-matrix form (one mode, D = 1, as oracle16_dense and dense64
        build; one launch, E once per unordered pair), its first and last
        nrows rows (the last ones from mirrored tiles) against the plain
        target -> source rows; then the pair-list form on the first rows'
        pairs.  f32: also the float32 store of variant m0 (dense64_f32's
        instance), held to the same rows at TOL_STORE_F32, as a row of
        variant "m0_f32".  Variant m0: the coefficients the solver passes
        under the global-basis quirk (to_local_equivalent) with the basis at
        local coordinates; compat: the raw coefficients with the basis at
        global coordinates (the same E, by another path).  Times: the whole
        build and the plain version of the first nrows rows (the whole
        build when nrows = n).  Bounds: operations on the FP64 CUDA cores, from the
        sub-segments of the unique pairs the build needs (each E once), and
        of all ordered pairs (the row form's work) beside."""
        torch, k7 = self.torch, self.attenuation
        from aniso_torch.core.geometry import make_grid, project_field
        from aniso_torch.ops.attenuation import make_line_integral
        from aniso_torch.ops.compat import to_local_equivalent
        from aniso_torch.ops.fields import evaluate_at_nodes_np

        grid = make_grid(sz, deg)
        n = grid.n_nodes
        raw = project_field(grid, bench_sigma(grid) + 0.2)
        local = to_local_equivalent(grid, raw)

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                   device=DEVICE)

        pts_np = grid.flat_nodes()
        pts, w = dev(pts_np).contiguous(), dev(grid.weights.reshape(-1))
        diag = dev(evaluate_at_nodes_np(grid, local).reshape(-1))
        # every ordered pair's sub-segments; a pair and its reverse have the
        # same, a node with itself none: the unique pairs hold half
        nsub_all = k7.subsegments(grid, pts_np, pts_np)
        nsub_rows = k7.subsegments(grid, pts_np[:nrows], pts_np)
        p0 = pts[:nrows, None, :].expand(nrows, n, 2).reshape(-1, 2)
        p1 = pts[None].expand(nrows, n, 2).reshape(-1, 2)
        blocks = [(0, nrows)] + ([(n - nrows, nrows)] if nrows < n else [])
        rows = []
        for name, compat, cf in (("m0", False, dev(local)),
                                 ("compat", True, dev(raw))):
            fpp = k7.flops_per_subsegment(deg, compat)

            def build(dtype=torch.float64):
                return k7.dense_smooth(grid, cf, pts, w, diag, [0], compat,
                                       dtype)

            def plain_rows(r0=0):
                return k7.dense_smooth_rows_plain(grid, cf, pts, w, diag, r0,
                                                  nrows, [0], compat)

            store32 = f32 and name == "m0"
            wants = [plain_rows(r0) for r0, _ in blocks]
            scale = max(float(want.abs().max()) for want in wants)

            def max_err(dtype):
                # one whole matrix at a time (10.9 GB in f64 at 64^2)
                got = build(dtype)
                return max(float((got[:, r0:r0 + nr].double() - want)
                                 .abs().max())
                           for (r0, nr), want in zip(blocks, wants))

            err = max_err(torch.float64)
            err32 = max_err(torch.float32) if store32 else 0.0
            del wants
            torch.cuda.synchronize()
            check(err <= TOL_KERNEL["f64"] * scale,
                  f"K7 {sz}^2 deg {deg} {name}: rows of both triangles: max "
                  f"err {err} > 1e-12 x {scale}")
            check(err32 <= TOL_STORE_F32 * scale,
                  f"K7 f32 store {sz}^2 deg {deg}: rows of both triangles: "
                  f"max err {err32} > {TOL_STORE_F32} x {scale}")
            nbytes = 8 * (n * n + 4 * n + cf.numel())
            bms, bby = bound_ms(nbytes, (nsub_all // 2) * fpp, "f64",
                                PEAK_F64_CUDA_CORES)
            row = {"variant": name, "n": n, "rows_checked": blocks,
                   "max_abs_err": err, "max_abs_plain": scale,
                   "ms": event_ms(torch, build, reps=reps, flush=self.flush,
                                  warmup=1),
                   "plain_ms": event_ms(torch, plain_rows, reps=1,
                                        flush=self.flush, warmup=0),
                   "plain_rows": nrows,
                   "subsegments_unique_pairs": nsub_all // 2,
                   "subsegments_all_pairs": nsub_all,
                   "bytes": nbytes, "flops": (nsub_all // 2) * fpp,
                   "bound_ms": bms, "bound_by": bby,
                   "bound_ms_all_pairs": bound_ms(
                       nbytes, nsub_all * fpp, "f64", PEAK_F64_CUDA_CORES)[0]}
            if store32:
                nbytes32 = nbytes - 4 * n * n
                bms32, bby32 = bound_ms(nbytes32, (nsub_all // 2) * fpp, "f64",
                                        PEAK_F64_CUDA_CORES)
                rows.append({
                    **row, "variant": "m0_f32", "max_abs_err": err32,
                    "tolerance": TOL_STORE_F32,
                    "ms": event_ms(torch, lambda: build(torch.float32),
                                   reps=reps, flush=self.flush, warmup=1),
                    "bytes": nbytes32, "bound_ms": bms32, "bound_by": bby32,
                    "bound_ms_all_pairs": bound_ms(
                        nbytes32, nsub_all * fpp, "f64",
                        PEAK_F64_CUDA_CORES)[0]})
            got = k7.line_integral_pairs(grid, cf, p0, p1, compat)
            want = make_line_integral(grid, sz, compat)(
                cf, p0[:, 0], p0[:, 1], p1[:, 0], p1[:, 1])
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(err <= TOL_KERNEL["f64"] * scale,
                  f"K7 pairs {sz}^2 {name}: max err {err} > 1e-12 x {scale}")
            pbms, _ = bound_ms(8 * 5 * p0.shape[0], nsub_rows * fpp, "f64",
                               PEAK_F64_CUDA_CORES)
            rows.append({**row, "pairs": nrows * n,
                         "pairs_max_abs_err": err,
                         "pairs_ms": event_ms(torch, lambda: k7.line_integral_pairs(
                             grid, cf, p0, p1, compat), reps=reps,
                             flush=self.flush),
                         "pairs_bound_ms": pbms})
            del got, want
        return rows


def bench_coeffs(sz, deg=3):
    """The bench sigma_t field's Legendre coefficients at sz^2 (compat
    off): what K3 reads on that grid."""
    from aniso_torch.core.geometry import make_grid, project_field

    grid = make_grid(sz, deg)
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
    """CUDA-event time of each layer of one matvec (fmm.apply's steps):
    K8's up pass, every level's T (K1 / K3), K2's near field, K8's down
    pass (L2L, L2T, near add, scale)."""
    from aniso_torch.fmm import apply as A
    from aniso_torch.kernels import transfer

    static, caches = solver._fmm_static, solver._caches
    ms_tab = solver._mode_statics[0]
    leaf = solver._tcfg.leaf_level
    M = A._up_pass(static, leaf, u)
    near = A._near_apply(caches, ms_tab, 0, u)

    def translates():
        return A._translates(static, leaf, M, caches["m2l_E"],
                             ms_tab["m2l_cosr"], caches.get("coeffs"))

    T = translates()
    return {
        "up_pass_k8": event_ms(torch, lambda: A._up_pass(static, leaf, u)),
        "translates_k1_k3": event_ms(torch, translates),
        "near_k2": event_ms(torch, lambda: A._near_apply(
            caches, ms_tab, 0, u)),
        "down_pass_k8": event_ms(torch, lambda: transfer.down(
            static["m2m_1d"], T[0], T[1:], static["l2t"], near)),
    }


def device_ms_per_call(torch, fn, calls=10):
    """Summed device (kernel) time per call from torch.profiler and the
    number of device kernels per call, or (None, None) when the profiler
    records no device time on this machine.  Device activity only, as in
    device_profile: every profiled window of the run has one
    configuration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # as in device_profile: idle at both ends, a kernel left out first
        warm_up = torch.empty(1, dtype=torch.int8, device=DEVICE)
        warm_up.fill_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        warm_up.fill_(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    # device rows only (a torch operator's row, recorded with the CPU
    # activity on, would hold its kernels' device time too)
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and e.device_type != DeviceType.CPU
            and "FillFunctor<signed char>" not in e.key]
    us = sum(e.self_device_time_total for e in rows)
    if us <= 0:
        return None, None
    return us / 1e3 / calls, sum(e.count for e in rows) / calls


def torch_op_rows(torch, s):
    """The kernel-table rows left to torch, at this solver's shapes: K4
    (the dense fine E build of set_coeff) and K5 (the near E build).
    Times by CUDA events, torch kernel launches by the profiler, and bounds
    from the shapes (each input read once, each output written once;
    operations at the f32 peak)."""
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

    def build_k4():
        for lv in fine:
            smooth.build_m2l_E_fine(g, tcfg, lv, 4, coeffs)

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


def gmres_stats():
    from aniso_torch.solver import gmres

    return dict(gmres.stats)


def gmres_since(before):
    """solver.gmres's counts since `before` (a gmres_stats())."""
    now = gmres_stats()
    return {k: now[k] - before[k] for k in now}


def device_profile(torch, fn):
    """fn() under torch.profiler: ({kernel name: device seconds}, {kernel
    name: launches}, fn()'s wall seconds there), the kernels of CUDA graph
    replays included; empty dicts when the profiler records no device time
    on this machine."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: a solve's host operators would multiply the
    # events the profiler then sorts on the host
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # idle time at both ends of the window, and a kernel of no counted
        # family (left out of the results) first after the idle start: the
        # profiler was seen to lose the record of the first kernel of a
        # window (79 kernels seen for 10 matvecs of 8)
        warm_up = torch.empty(1, dtype=torch.int8, device=DEVICE)
        warm_up.fill_(1)
        torch.cuda.synchronize()
        time.sleep(0.05)
        warm_up.fill_(1)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(0.05)
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0
            and "FillFunctor<signed char>" not in e.key]
    return ({e.key: e.self_device_time_total / 1e6 for e in rows},
            {e.key: e.count for e in rows}, wall)


# the CUDA function each launch counter's wrapper launches once a call (the
# family: the counter's name before its instance; K12's two entries apart)
KERNEL_FUNCTIONS = {
    "k1": "m2l_translate_[a-z_]*kernel", "k2": "near_contract_kernel",
    "k3": "offsets_translate_kernel", "k9d": "diffusion_apply_kernel",
    "k9": "pcg_kernel", "k10": "halo_fill_kernel", "k11": "cgs2_kernel",
    "k12_step": "givens_kernel", "k12_backsub": "backsub_kernel",
    "k8": "transfer_(up|down)_kernel",
}


def counter_family(key):
    return key if key.startswith("k12_") else key.split("_")[0]


def profiled_launches(counts, launched):
    """{family: (launches the wrappers counted, launches of its CUDA
    function the profiler saw)} for every family counted in the run."""
    out = {}
    for key, n in counts.items():
        fam = counter_family(key)
        out[fam] = (out.get(fam, (0, 0))[0] + n, 0)
    for fam, (n, _) in out.items():
        check(fam in KERNEL_FUNCTIONS or n == 0,
              f"{fam}: launched {n} times in a solve, no function known")
        if fam in KERNEL_FUNCTIONS:
            # a profiler's demangled name, or a graph node's mangled one
            pat = re.compile(r"(^|[\s:\d])" + KERNEL_FUNCTIONS[fam]
                             + r"([<(IE]|$)")
            out[fam] = (n, sum(c for name, c in launched.items()
                               if pat.search(name)))
    return out


def graph_kernels(graph):
    """{kernel function name: kernel nodes} of a captured CUDA graph, read
    through the driver API from the cudaGraph_t the capture kept
    (solver.gmres): an exact count, no profiler."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def call(fn, *args):
        rc = getattr(cu, fn)(*args)
        check(rc == 0, f"{fn}: CUDA driver error {rc}")

    g = vp(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    call("cuGraphGetNodes", g, None, ctypes.byref(n))
    nodes = (vp * n.value)()
    call("cuGraphGetNodes", g, nodes, ctypes.byref(n))
    out = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        call("cuGraphNodeGetType", vp(node), ctypes.byref(kind))
        if kind.value != 0:                   # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern (CUkernel) at 56
        params = (ctypes.c_byte * 128)()
        call("cuGraphKernelNodeGetParams_v2", vp(node), params)
        func = vp.from_buffer(params, 0).value
        name = ctypes.c_char_p()
        if func:
            call("cuFuncGetName", ctypes.byref(name), vp(func))
        else:
            call("cuKernelGetName", ctypes.byref(name),
                 vp(vp.from_buffer(params, 56).value))
        key = name.value.decode()
        out[key] = out.get(key, 0) + 1
    return out


def replay_launches(kern, s):
    """Each GMRES step that solver s holds captured: {plan: {family:
    (launches its capture counted for a replay, kernel nodes of the
    family's CUDA function in its graph)}}.  The capture's counts are all
    that a solve's counters infer: an eager launch is counted by its
    wrapper once the launch returned."""
    from aniso_torch.kernels import launch_counters

    names = {id(d): name for name, d in kern.counters}
    out = {}
    for key, plan in s._graphs.items():
        if plan.graph is None:
            continue
        counted = {}
        for (d, k), n in zip(launch_counters(), plan.delta):
            counted[f"{names[id(d)]}_{k}"] = n
        out[str(key)] = profiled_launches(counted, graph_kernels(plan.graph))
    return out


# kernel records the profiler may lose in one profiled solve: it lost one
# or two K8 records in one or two solves of a whole run, a different solve
# from run to run; every launch is held exactly against a graph's kernel
# nodes besides (replay_launches, eager_launches)
PROFILER_MISS_MAX = 2


def _value(holder, key):
    return holder[key] if isinstance(holder, dict) else getattr(holder, key)


def _set(holder, key, v):
    if isinstance(holder, dict):
        holder[key] = v
    else:
        setattr(holder, key, v)


def eager_launches(torch, kern, what, fn, hold=()):
    """fn(), one of each call a solve makes outside its captured step,
    captured into a throwaway CUDA graph, so that nothing runs: {family:
    (launches its wrappers counted in the capture, kernel nodes of the
    family's CUDA function in the graph)}, checked equal.  The launch
    counters and the (holder, key) counters in `hold` are as before when
    it returns."""
    from aniso_torch.kernels import launch_counters

    counters = launch_counters() + list(hold)
    saved = [_value(h, k) for h, k in counters]
    torch.cuda.synchronize()
    kern.reset()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    fams = profiled_launches(kern.counts(), graph_kernels(graph))
    del graph
    for (h, k), v in zip(counters, saved):
        _set(h, k, v)
    for fam, (n, nodes) in fams.items():
        check(n == nodes, f"{what}: the calls outside a captured step count "
              f"{n} launches of {fam}, their graph holds {nodes} kernel "
              "nodes")
    return fams


def solve_calls(torch, s, qd, precond=None):
    """One of each call s.solve(qd) makes outside its captured step: the
    rhs (with refine: the f64 twin's rhs and forward), a forward (r0 and
    each cycle's residual), the preconditioner and the back-substitution;
    for eager_launches, with the counters the calls bump."""
    from aniso_torch.kernels import krylov

    m = s.cfg.restart
    st = torch.zeros(krylov.state_layout(m).len, dtype=torch.float64,
                     device=DEVICE)

    def calls():
        if s.cfg.refine:
            s._forward64(s._rhs64(qd))
        v = s.forward(s.rhs(qd))
        if precond is not None:
            precond(v)
        krylov.givens_backsub(st, m)

    hold = [(s, "n_matvecs"), (s, "n_matvecs64")]
    if precond is not None:
        hold.append((precond, "calls"))
    return calls, hold


def solve_device_time(torch, kern, out, fn, precond=None, solver=None,
                      eager=None):
    """The counted solve again under the profiler (the same work: its
    counters were read; the graph is captured by now; the charge already
    on the card, so that no pageable copy lies in the window), with the
    launch counters set to 0 just before it.  repeat_s: its wall seconds
    there; device_s: its device seconds; device_busy_share = device_s /
    repeat_s.  profiled_launches: for each kernel family of the port, the
    launches its wrappers counted in the repeat (on a captured step: the
    capture's counts once a replay) beside the launches of its CUDA
    function that the profiler saw.  The profiler saw no more than was
    counted (a launch the counters missed); where it saw fewer, the
    deficit is reported as profiler_missed: the profiler was seen to lose
    one kernel record in one or two solves of a whole run, a different
    solve from run to run, every time in each profiled repeat of that
    solve, and none when the same solves ran outside a whole run; more
    than PROFILER_MISS_MAX fails.  Every launch is held exactly as well:
    what the counters infer, the launches of a captured step, by
    replay_launches (each of the solver's captured steps against the
    kernel nodes of its graph, family by family), and the eager launches
    by eager_launches on `eager` (fn, hold): one of each call the solve
    makes outside its captured step.  With the DSA preconditioner, K9's
    device seconds in the repeat (precond_s), their share of repeat_s and
    per CG iteration of the repeat (its own counts, read from the card
    after it)."""
    what = out.get("phase", "solve")
    if precond is not None:
        precond.reset()
    kern.reset()
    per, launched, wall = device_profile(torch, fn)
    out["repeat_s"] = wall
    out["device_s"] = sum(per.values()) if per else None
    out["device_busy_share"] = out["device_s"] / wall if per else None
    out["profiled_launches"] = (profiled_launches(kern.counts(), launched)
                                if per else None)
    out["profiler_missed"] = {
        fam: n - seen
        for fam, (n, seen) in (out["profiled_launches"] or {}).items()
        if seen < n}
    for fam, (n, seen) in (out["profiled_launches"] or {}).items():
        check(seen <= n, f"{what}: {fam} counted {n} launches in the "
              f"profiled solve, the profiler saw {seen}")
    check(sum(out["profiler_missed"].values()) <= PROFILER_MISS_MAX,
          f"{what}: the profiler missed {out['profiler_missed']} launches, "
          f"more than {PROFILER_MISS_MAX}")
    if precond is not None:
        k9 = sum(v for k, v in per.items() if "pcg_kernel" in k)
        cg = sum(precond.cg_iterations)
        out.update({"precond_s": k9 if per else None,
                    "precond_share_of_solve": k9 / wall if per else None,
                    "precond_ms_per_cg_iteration":
                        1e3 * k9 / max(cg, 1) if per else None})
    if solver is not None:
        out["replay_launches"] = replay_launches(kern, solver)
        for key, fams in out["replay_launches"].items():
            for fam, (n, nodes) in fams.items():
                check(n == nodes, f"{what}: a replay of the step {key} "
                      f"counts {n} launches of {fam}, its graph holds "
                      f"{nodes} kernel nodes")
    if eager is not None:
        out["eager_launches"] = eager_launches(torch, kern, what, *eager)


def counted_solve(torch, kern, s, q, precond=None, warm=True):
    """A first solve (one-time costs: library handles, first launches of
    each shape, the GMRES step's capture; skipped with warm=False), then
    the main path's run with the counters set to 0 just before it and read
    just after, then the same solve profiled for its device time.  matvecs
    and twin_sweeps count FMM sweeps: N per forward of an N-mode solver.
    solve_is_first says that solve_s holds those one-time costs.  gmres:
    solver.gmres's counts in the counted solve (host_reads,
    steps_after_done and the steps replayed from the graph among them);
    graph_capture_s: the seconds spent capturing, first solve included.
    With a DsaPreconditioner, its calls and their CG iterations in the
    counted solve."""
    out = {"solve_is_first": not warm}
    g0 = gmres_stats()
    if warm:
        t0 = time.perf_counter()
        s.solve(q, precond=precond)
        torch.cuda.synchronize()
        out["solve_first_s"] = time.perf_counter() - t0
    kern.reset()
    if precond is not None:
        precond.reset()
    n0, n64 = s.n_matvecs, s.n_matvecs64
    g1 = gmres_stats()
    t0 = time.perf_counter()
    res = s.solve(q, precond=precond)
    torch.cuda.synchronize()
    out.update({"solve_s": time.perf_counter() - t0,
                "matvecs": s.n_matvecs - n0,
                "twin_sweeps": s.n_matvecs64 - n64,
                "launches": kern.counts(), "gmres": gmres_since(g1)})
    out["host_reads"] = out["gmres"]["host_reads"]
    out["steps_after_done"] = out["gmres"]["steps_after_done"]
    out["graph_capture_s"] = gmres_since(g0)["capture_s"]
    if precond is not None:
        out.update(dsa_counts(precond))
    qd = torch.as_tensor(q, device=DEVICE)
    solve_device_time(torch, kern, out,
                      lambda: s.solve(qd, precond=precond), precond, s,
                      solve_calls(torch, s, qd, precond))
    return res, out


def gmres_launches(run, inst, sharded=False):
    """K11 and K12 launches of a counted solve: K11 and K12's step once a
    step (K11 on one device only: the sharded CGS2 is torch per shard),
    K12's back-substitution once a cycle."""
    g = run["gmres"]
    out = {"k12_step": g["steps"], "k12_backsub": g["cycles"]}
    if not sharded:
        out[f"k11_{inst}"] = g["steps"]
    return out


def check_gmres(name, run, iterations, per_forward=1, extra=0,
                sharded=False):
    """The counted solve's GMRES steps: one device, every step replayed
    from the captured graph but one eager step per capture (sharded: none
    captured); at most one step after convergence per inner solve;
    host_reads within iterations + 2 cycles + 2 per inner solve; and the
    matvecs the steps' replays add up to: per_forward sweeps for r0, each
    step and each cycle's residual of every inner solve, plus `extra` (the
    rhs, counted where it goes through the same counter)."""
    g = run["gmres"]
    if sharded:
        check(g["replays"] == 0, f"{name}: sharded steps replayed")
    else:
        check(g["replays"] > 0 and g["replays"] == g["steps"] - g["captures"],
              f"{name}: {g['steps']} steps, {g['replays']} replayed, "
              f"{g['captures']} captures")
    check(g["steps_after_done"] <= g["solves"],
          f"{name}: {g['steps_after_done']} steps after convergence in "
          f"{g['solves']} solves")
    bound = iterations + 2 * g["cycles"] + 2 * g["solves"]
    check(g["host_reads"] <= bound,
          f"{name}: {g['host_reads']} host reads, bound {bound}")
    want = per_forward * (g["solves"] + g["steps"] + g["cycles"]) + extra
    check(run["matvecs"] == want,
          f"{name}: {run['matvecs']} matvecs, the steps make {want}")


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


def dsa_counts(pre):
    """The preconditioner's calls and their CG iterations since its
    reset(), read from the card's log after the solve."""
    calls = pre.cg_iterations
    return {"precond_calls": len(calls), "cg_iterations_total": sum(calls),
            "cg_iterations_per_call": sum(calls) / max(len(calls), 1),
            "cg_iterations_max": max(calls, default=0)}


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


def k8_launches(s, sweeps, twin_sweeps=0):
    """K8's launches (counter keys k8_up_* / k8_down_*) in `sweeps` sweeps
    of solver s in its dtype and twin_sweeps of its f64 twin, each one up
    pass and one down pass over the leaf and every level above it to level
    2."""
    from aniso_torch.kernels import transfer

    lx = ly = s.grid.sz
    n, r, nq = s._tcfg.leaf_level - 2, s.cfg.np_cheb ** 2, s.grid.nq
    out = {}
    item = s.dtype.itemsize
    for inst, item, k in (({4: "f32", 8: "f64"}[item], item, sweeps),
                          ("f64", 8, twin_sweeps)):
        up = k * len(transfer.up_plan(lx, ly, n, r, nq, item))
        down = k * len(transfer.down_plan(lx, ly, n, r, nq, item))
        for key, v in ((f"k8_up_{inst}", up), (f"k8_down_{inst}", down)):
            if v:
                out[key] = out.get(key, 0) + v
    return out


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
    if timing:
        # the kernel nodes of the captured Arnoldi step
        plan = next(iter(s._graphs.values()))
        out["captured_step_kernels"] = sum(graph_kernels(plan.graph).values())
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
    check_gmres(name, run, res.iterations, extra=1)
    check_launches(name, out, {f"k1_{inst}": n_levels * matvecs,
                               f"k2_{inst}": matvecs,
                               **k8_launches(s, matvecs),
                               **gmres_launches(run, inst)})
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
    launches K7's whole-matrix entry once in set_coeff (the instance that
    stores the solver's dtype) and no other kernel of the port (its GEMVs
    are torch.matmul)."""
    grid = s.grid
    q = bench_charge(grid)
    kern.reset()
    out = {"set_coeff_s": timed_set_coeff(torch, s),
           "set_coeff_phases_s": s.set_coeff_phases,
           "cache_report_bytes": s.cache_report()}
    n0 = s.n_matvecs
    g0 = gmres_stats()
    t0 = time.perf_counter()
    res = s.solve(q)
    torch.cuda.synchronize()
    out.update({"solve_s": time.perf_counter() - t0,
                "matvecs": s.n_matvecs - n0, "launches": kern.counts(),
                "gmres": gmres_since(g0)})
    out.update({"host_reads": out["gmres"]["host_reads"],
                "steps_after_done": out["gmres"]["steps_after_done"],
                "graph_capture_s": out["gmres"]["capture_s"]})
    qd = torch.as_tensor(q, device=DEVICE)
    solve_device_time(torch, kern, out, lambda: s.solve(qd), solver=s,
                      eager=solve_calls(torch, s, qd))
    x = res.x.cpu().numpy().reshape(-1)
    out.update({
        "iterations": res.iterations, "converged": res.converged,
        "givens_estimate": res.residual,
        "true_relative_residual": true_residual(torch, s, q, res.x),
        "finite": bool(np.isfinite(x).all()),
    })
    inst = "f64" if s.dtype == torch.float64 else "f32"
    out["k7_launches_expected"] = {"k7_dense_" + inst: 1,
                                   **gmres_launches(out, inst)}
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
    check_gmres("oracle16_dense", out, res.iterations, extra=1)
    check_launches("oracle16_dense", out, out["k7_launches_expected"])
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
    check_gmres("dense64", out, res.iterations, extra=1)
    check_launches("dense64", out, out["k7_launches_expected"])
    return out


def run_dense64_f32(torch, kern):
    """dense64's problem (benchmarks/oracle_64, compat on) on the dense
    backend in float32, tol 1e-7: K7 stores the matrices in float32 (f64
    arithmetic); true residual < 1e-5, relative Linf error < 1e-2 against
    oracle_64."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s = make_solver(torch, 64, 0.95, True, dtype="float32", tol=1e-7,
                    backend="dense")
    res, run, x = dense_run(torch, kern, s)
    out = {"phase": "dense64_f32", "sz": 64, "g": 0.95,
           "compat_global_basis": True, "dtype": "float32", "tol": 1e-7,
           "backend": "dense", **run,
           "set_coeff_k7_s": run["set_coeff_phases_s"]["dense_smooth_s"],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "oracle_rel_linf": oracle_error(s.grid, "oracle_64", x)}
    emit(out)
    check(out["finite"] and x.shape == (s.grid.n_nodes,), "dense64_f32: bad x")
    check(res.converged and out["true_relative_residual"] < 1e-5,
          f"dense64_f32: true residual {out['true_relative_residual']}")
    check(out["oracle_rel_linf"] < 1e-2,
          f"dense64_f32: {out['oracle_rel_linf']} vs oracle_64")
    check_gmres("dense64_f32", out, res.iterations, extra=1)
    check_launches("dense64_f32", out, out["k7_launches_expected"])
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
             ("oracle_16", "dense", [], None),
             # one process of a torch.distributed group (NCCL), cold only
             ("oracle_64", "fmm", ["--compat-global-basis", "--distributed",
                                   "--coordinator", f"127.0.0.1:{free_port()}",
                                   "--num-processes", "1",
                                   "--process-id", "0"], 1e-3))
    out = {"phase": "cli", "runs": []}
    with tempfile.TemporaryDirectory() as tmp:
        for k, (oracle, backend, extra, gate) in enumerate(cases):
            cwd = os.path.join(tmp, str(k))
            os.makedirs(cwd)
            cmd = [sys.executable, "-m", "aniso_torch", "run",
                   os.path.join(ROOT, "benchmarks", oracle, "data.cfg"),
                   "--backend", backend, *extra]
            rerun = gate and "--distributed" not in extra
            for warm in ((False, True) if rerun else (False,)):
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
    check_gmres("refined512", run, res.iterations)
    check_launches("refined512", out, {
        "k1_f32": n_levels * matvecs, "k2_f32": matvecs,
        "k1_f64": (n_levels - 2) * sweeps, "k2_f64": sweeps,
        "k3_f64": 2 * sweeps, **k8_launches(s, matvecs, sweeps),
        **gmres_launches(run, "f32")})
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
    check_gmres("f32_512", run, res.iterations, extra=1)
    check_launches("f32_512", out, {"k1_f32": (leaf - 1) * run["matvecs"],
                                    "k2_f32": run["matvecs"],
                                    **k8_launches(s, run["matvecs"]),
                                    **gmres_launches(run, "f32")})

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
    check_gmres("offsets_leaf512", run2, res2.iterations, extra=1)
    # the step captured at 512^2 read the swapped caches: the solver drops
    # it by itself and captures the step anew
    check(run2["gmres"]["captures"] == 1,
          f"offsets_leaf512: {run2['gmres']['captures']} captures after the "
          "caches were swapped")
    check_launches("offsets_leaf512", off, {
        "k1_f32": (leaf - 2) * run2["matvecs"], "k2_f32": run2["matvecs"],
        "k3_f32": run2["matvecs"], **k8_launches(s, run2["matvecs"]),
        **gmres_launches(run2, "f32")})
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
        # a first solve for the one-time costs (the step's capture among
        # them), then the counted one, profiled for K9's device time and
        # its CG iterations counted
        t0 = time.perf_counter()
        s.solve(q, precond=pre if name == "dsa" else None)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        res, run = counted_solve(torch, kern, s, q,
                                 precond=pre if name == "dsa" else None,
                                 warm=False)
        run.update({
            "solve_first_s": first,
            "converged": res.converged, "refinements": res.refinements,
            "history": list(res.history), "inner_iterations": res.iterations,
            "inner_iterations_per_round": res.phases["inner_iters"],
            "true_f64_residual": true_residual64(torch, s, q, res.x),
            "finite": bool(torch.isfinite(res.x).all()),
        })
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
        check_gmres(what, run, res.iterations, per_forward=N)
        check_launches(what, run, {
            "k1_f32": n_levels * fast, "k2_f32": fast,
            "k1_f64": (n_levels - n_fine) * sweeps, "k2_f64": sweeps,
            "k3_f64": n_fine * sweeps,
            "k9_f32": run.get("precond_calls", 0),
            **k8_launches(s, fast, sweeps),
            **gmres_launches(run, "f32")})
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
            res, run = counted_solve(torch, kern, s, q,
                                     precond=pre if name == "dsa" else None,
                                     warm=False)
            run.update({"iterations": res.iterations,
                        "converged": res.converged,
                        "residual_estimate": res.residual,
                        "true_relative_residual":
                            true_residual(torch, s, q, res.x)})
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
            check_gmres(what, run, run["iterations"], per_forward=N,
                        extra=N)
            check_launches(what, run, {
                "k1_f64": n_levels * run["matvecs"],
                "k2_f64": run["matvecs"],
                "k9_f64": run.get("precond_calls", 0),
                **k8_launches(s, run["matvecs"]),
                **gmres_launches(run, "f64")})
        check(out["dsa"]["iterations"] <= out["plain"]["iterations"],
              f"dsa64 N={N}: DSA above plain")
        check(out["dsa"]["cg_iterations_total"] > 0,
              f"dsa64 N={N}: no CG iteration")
        check(out["x_rel_diff_dsa_vs_plain"] < 1e-6,
              f"dsa64 N={N}: the two x differ by "
              f"{out['x_rel_diff_dsa_vs_plain']}")
        outs.append(out)
    return outs


def run_dsa512(torch, kern):
    """dsa64's first case (N = 1, g = 0, sigma_s = 20, sigma_a = 0.2, the
    mode-0 Gaussian) on the north star's 512^2 grid at deg 2, f32 inner
    GMRES(80) refined to tol 1e-8: plain, then with DSA, whose CG may take
    up to 4000 iterations a call; the first DSA run at 512^2 and the first
    K9 grid across every SM."""
    from aniso_torch.solver.dsa import DsaPreconditioner

    torch.cuda.reset_peak_memory_stats()
    s = make_solver(torch, NORTH, 0.0, False, tol=1e-8, refine=True,
                    quad_rule=2)
    grid = s.grid
    sig_s = np.full_like(grid.nodes_x, 20.0)
    t0 = time.perf_counter()
    s.set_coeff(sig_s, sig_s + 0.2)
    torch.cuda.synchronize()
    out = {"phase": "dsa512", "sz": NORTH, "deg": 2, "modes": 1, "g": 0.0,
           "sigma_s": 20.0, "sigma_a": 0.2, "tol": 1e-8, "cg_max_iter": 4000,
           "set_coeff_s": time.perf_counter() - t0}
    q = mode0_charge(grid, 1)
    pre = DsaPreconditioner(s, max_iter=4000)
    runs = {}
    for name in ("plain", "dsa"):
        # a first solve for the one-time costs (the step's capture among
        # them), then the counted one, profiled for K9's device time and
        # its CG iterations counted
        t0 = time.perf_counter()
        s.solve(q, precond=pre if name == "dsa" else None)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        res, run = counted_solve(torch, kern, s, q,
                                 precond=pre if name == "dsa" else None,
                                 warm=False)
        run.update({
            "solve_first_s": first,
            "converged": res.converged, "refinements": res.refinements,
            "inner_iterations": res.iterations,
            "inner_iterations_per_round": res.phases["inner_iters"],
            "true_f64_residual": true_residual64(torch, s, q, res.x),
            "finite": bool(torch.isfinite(res.x).all()),
        })
        runs[name] = res
        out[name] = run
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    emit(out)
    n_levels = s._tcfg.leaf_level - 1
    n_fine = len(fine_levels(s._tcfg))
    for name, res in runs.items():
        run, what = out[name], f"dsa512 {name}"
        check(run["finite"] and tuple(res.x.shape) == (1, NORTH, NORTH, 4),
              f"{what}: bad x")
        check(res.converged and run["true_f64_residual"] < 1e-8,
              f"{what}: true f64 residual {run['true_f64_residual']}")
        sweeps, fast = run["twin_sweeps"], run["matvecs"]
        check_gmres(what, run, res.iterations)
        check_launches(what, run, {
            "k1_f32": n_levels * fast, "k2_f32": fast,
            "k1_f64": (n_levels - n_fine) * sweeps, "k2_f64": sweeps,
            "k3_f64": n_fine * sweeps,
            "k9_f32": run.get("precond_calls", 0),
            **k8_launches(s, fast, sweeps),
            **gmres_launches(run, "f32")})
    dsa = out["dsa"]
    check(runs["dsa"].iterations < runs["plain"].iterations,
          "dsa512: DSA did not cut the inner iterations")
    check(dsa["precond_calls"] > 0 and dsa["cg_iterations_max"] < 4000,
          f"dsa512: a CG call reached max_iter ({dsa['cg_iterations_max']})")
    return out


def run_np6(torch, kern):
    """np_cheb = 6 (r = 36) with refine=True on 32^2, deg 2, f32 inner to
    tol 1e-8: the twin's fine levels through K3's r = 36 instance (the
    split pair axis), its coarse ones through K1 f64; converged with a true
    f64 residual below the tol."""
    s = make_solver(torch, 32, 0.5, False, tol=1e-8, refine=True,
                    quad_rule=2, sing_rule=6, np_cheb=6)
    t0 = time.perf_counter()
    timed_set_coeff(torch, s)
    out = {"phase": "np6", "sz": 32, "deg": 2, "np_cheb": 6, "g": 0.5,
           "tol": 1e-8, "set_coeff_s": time.perf_counter() - t0}
    q = bench_charge(s.grid)
    res, run = counted_solve(torch, kern, s, q)
    out.update(run)
    out.update({"converged": res.converged, "refinements": res.refinements,
                "inner_iterations": res.iterations,
                "true_f64_residual": true_residual64(torch, s, q, res.x)})
    emit(out)
    check(res.converged and out["true_f64_residual"] < 1e-8,
          f"np6: true f64 residual {out['true_f64_residual']}")
    n_levels = s._tcfg.leaf_level - 1
    n_fine = len(fine_levels(s._tcfg))
    sweeps, fast = run["twin_sweeps"], run["matvecs"]
    check(n_fine > 0 and sweeps > 0, "np6: no per-offset twin sweep")
    check(list(range(2, s._tcfg.leaf_level + 1)) == NP6_LEVELS
          and list(fine_levels(s._tcfg)) == NP6_LEVELS[-2:],
          "np6: its levels are not the ones its kernel rows checked")
    check_gmres("np6", run, res.iterations)
    check_launches("np6", out, {
        "k1_f32": n_levels * fast, "k2_f32": fast,
        "k1_f64": (n_levels - n_fine) * sweeps, "k2_f64": sweeps,
        "k3_f64": n_fine * sweeps, **k8_launches(s, fast, sweeps),
        **gmres_launches(run, "f32")})
    return out


def run_np16(torch, kern):
    """np_cheb = 16 (r = 256: a row of 27 r float64 values is 55 KB, over
    the 48 KB a block takes without the opt-in) with refine=True on 8^2,
    deg 1, f32 inner to tol 1e-8.  Both of its levels are fine; they are
    built per-offset in the fast path too (a zero dense budget, as a full
    card gives them: the dense fine weight operator at np 16 is an 11 GB
    host build), so every sweep runs K3's runtime-r instance (f32 and the
    twin's f64) and K8 at r = 256; converged with a true f64 residual
    below the tol."""
    from aniso_torch.solver import operator

    s = make_solver(torch, 8, 0.5, False, tol=1e-8, refine=True,
                    quad_rule=1, sing_rule=6, np_cheb=16)
    budget = operator.dense_budget_bytes
    operator.dense_budget_bytes = lambda device: 0
    try:
        set_coeff_s = timed_set_coeff(torch, s)
    finally:
        operator.dense_budget_bytes = budget
    out = {"phase": "np16", "sz": 8, "deg": 1, "np_cheb": 16, "g": 0.5,
           "tol": 1e-8, "set_coeff_s": set_coeff_s,
           "set_coeff_phases_s": s.set_coeff_phases,
           "cache_report_bytes": s.cache_report()}
    q = bench_charge(s.grid)
    res, run = counted_solve(torch, kern, s, q)
    out.update(run)
    out.update({"converged": res.converged, "refinements": res.refinements,
                "inner_iterations": res.iterations,
                "true_f64_residual": true_residual64(torch, s, q, res.x)})
    emit(out)
    check(res.converged and out["true_f64_residual"] < 1e-8,
          f"np16: true f64 residual {out['true_f64_residual']}")
    n_levels = s._tcfg.leaf_level - 1
    sweeps, fast = run["twin_sweeps"], run["matvecs"]
    check(sweeps > 0, "np16: no twin sweep")
    check_gmres("np16", run, res.iterations)
    check_launches("np16", out, {
        "k3_f32": n_levels * fast, "k2_f32": fast,
        "k3_f64": n_levels * sweeps, "k2_f64": sweeps,
        **k8_launches(s, fast, sweeps), **gmres_launches(run, "f32")})
    return out


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
                   {"k1_f32": n_levels * N, "k2_f32": N,
                    **k8_launches(s, N)})
    check_launches("mm512 forward64",
                   {"launches": out["launches_per_forward64"]},
                   {"k1_f64": (n_levels - n_fine) * N, "k2_f64": N,
                    "k3_f64": n_fine * N, **k8_launches(s, 0, N)})
    check(out["finite"] and tuple(res.x.shape) == (N, NORTH, NORTH, NQ),
          "mm512: bad x")
    check(res.converged and out["true_f64_residual"] < 1e-8,
          f"mm512: true f64 residual {out['true_f64_residual']}")
    check(res.refinements <= 3, f"mm512: {res.refinements} rounds")
    check(out["f32_path_residual"] < 1e-5,
          f"mm512: f32-path residual {out['f32_path_residual']}")
    sweeps, fast = run["twin_sweeps"], run["matvecs"]
    check(sweeps == N * (1 + res.refinements), f"mm512: {sweeps} twin sweeps")
    check_gmres("mm512", run, res.iterations, per_forward=N)
    check_launches("mm512", out, {
        "k1_f32": n_levels * fast, "k2_f32": fast,
        "k1_f64": (n_levels - n_fine) * sweeps, "k2_f64": sweeps,
        "k3_f64": n_fine * sweeps, **k8_launches(s, fast, sweeps),
        **gmres_launches(run, "f32")})
    return out


def free_port() -> int:
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def sharded_solve(torch, kern, s, mesh, q, tol, restart=80, max_iter=400):
    """The sharded corrected matvec and a GMRES solve of u - K0(sigma_s u)
    = K0 q on Sharded fields (the JAX package's tests/test_parallel.py
    solve), with the counters set to 0 just before and read just after:
    launches, collectives (parallel.halo), matvecs."""
    from aniso_torch.parallel import api, halo
    from aniso_torch.solver.gmres import gmres

    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    sig = api.shard_field(mesh, s.sigma_s)
    u = api.shard_field(mesh, torch.as_tensor(q, dtype=s.dtype,
                                              device=DEVICE))
    calls = []

    def matvec(v):
        calls.append(1)
        return v - apply_fn(caches, ms[0], 0, sig * v)

    def solve():
        b = apply_fn(caches, ms[0], 0, u)
        return gmres(matvec, b, restart=restart, max_iter=max_iter, tol=tol)

    kern.reset()
    halo.reset_collectives()
    g0 = gmres_stats()
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    out = {"solve_s": time.perf_counter() - t0, "matvecs": 1 + len(calls),
           "launches": kern.counts(),
           "collectives": halo.collective_stats()._asdict(),
           "gmres": gmres_since(g0),
           "iterations": res.iterations, "converged": res.converged,
           "givens_estimate": res.residual}
    out.update({"host_reads": out["gmres"]["host_reads"],
                "steps_after_done": out["gmres"]["steps_after_done"],
                "graph_capture_s": out["gmres"]["capture_s"]})
    from aniso_torch.kernels import krylov

    st = torch.zeros(krylov.state_layout(restart).len, dtype=torch.float64,
                     device=DEVICE)

    def eager_calls():
        # the rhs and every matvec, each step's Givens step, each cycle's
        # back-substitution: no step of a sharded solve is captured
        apply_fn(caches, ms[0], 0, sig * u)
        krylov.givens_step(st, restart)
        krylov.givens_backsub(st, restart)

    solve_device_time(torch, kern, out, solve, eager=(eager_calls, ()))
    x = res.x.full()
    # the true residual through the one-device operator
    qt = torch.as_tensor(q, dtype=s.dtype, device=DEVICE)
    b1 = s.apply_mode(0, qt)
    out["true_relative_residual"] = float(torch.linalg.vector_norm(
        x - s.apply_mode(0, s.sigma_s * x) - b1)
        / torch.linalg.vector_norm(b1))
    return res, out, x, (apply_fn, caches, ms)


def sharded_k8(s, mesh):
    """K8's launches in one sharded matvec of solver s on `mesh` (every
    shard on one card), by counter key: per shard the up pass from the leaf
    to `stop` (parallel.api.stop_level) on its block and the down pass from
    `stop` with the epilogue; above `stop`, once, the up pass from the
    gathered M of `stop` (up_from) and the L2L chain of the whole levels
    down to it.  A field that does not divide the mesh is one shard, the
    whole grid."""
    from aniso_torch.kernels import transfer
    from aniso_torch.parallel import api

    sz, leaf, lo = s.grid.sz, s._tcfg.leaf_level, 2
    r, nq, item = s.cfg.np_cheb ** 2, s.grid.nq, s.dtype.itemsize
    inst = {4: "f32", 8: "f64"}[item]
    if sz % mesh.shape[0] or sz % mesh.shape[1]:
        shards, (bx, by) = 1, (sz, sz)
    else:
        shards, (bx, by) = mesh.size, (sz // mesh.shape[0],
                                       sz // mesh.shape[1])
    stop = api.stop_level((bx, by), leaf)
    n = leaf - stop
    up = shards * len(transfer.up_plan(bx, by, n, r, nq, item))
    down = shards * len(transfer.down_plan(bx, by, n, r, nq, item))
    up += len(transfer.up_plan(1 << stop, 1 << stop, stop - lo, r, 0, item))
    down += len(transfer.down_plan(1 << stop, 1 << stop, stop - lo, r, 0,
                                   item))
    return {f"k8_up_{inst}": up, f"k8_down_{inst}": down}


def check_sharded_counts(name, out, mesh, s, sharded_levels, field_bytes,
                         inst="f32"):
    """Launches per matvec: K10 once for u and once per sharded level
    (one launch: every shard on one card), K1-S and K2-S once per shard and
    sharded level, K1 whole-level once per replicated level, K8's passes
    as sharded_k8 counts them; permute bytes O(halo), all-gather bytes only
    those of the replicated levels' M."""
    tcfg = s._tcfg
    n, shards = out["matvecs"], mesh.size
    repl = [lv for lv in range(2, tcfg.leaf_level + 1)
            if lv not in sharded_levels]
    check_gmres(name, out, out["iterations"], extra=1, sharded=True)
    check_launches(name, out, {
        f"k10_{inst}": n * (1 + len(sharded_levels)),
        f"k1_shard_{inst}": n * shards * len(sharded_levels),
        f"k2_shard_{inst}": n * shards,
        f"k1_{inst}": n * len(repl),
        **{k: n * v for k, v in sharded_k8(s, mesh).items()},
        **gmres_launches(out, inst, sharded=True)})
    st = out["collectives"]
    itemsize = 4 if inst == "f32" else 8
    gathered = n * sum(4 ** lv * R * itemsize for lv in repl)
    check(st["bytes"].get("permute", 0) / n < 8 * field_bytes,
          f"{name}: permute bytes {st['bytes']} per matvec vs 8 fields")
    check(st["bytes"].get("all-gather", 0) == gathered,
          f"{name}: all-gather bytes {st['bytes']}, expected {gathered} "
          "(the replicated levels' M)")


# meshes whose blocks do not split every level at 512^2 (make_mesh's 2 x 4
# does): (1, 8) blocks of 512 x 64, whose up pass stops at level 3 (K8's
# up_from and whole L2L chain above it); (2, 3), which the field does not
# divide (replicated whole on mesh.whole)
OTHER_MESHES = ((1, 8), (2, 3))


def other_meshes(torch, kern, s, qt, ref):
    """One sharded matvec of solver s on each of OTHER_MESHES (every shard
    on the card) against the one-device matvec ref of qt: its relative
    error, its launches counted (K8's against sharded_k8) and held exactly
    against the kernel nodes of its capture (eager_launches)."""
    from aniso_torch.parallel import api

    out = {}
    for shape in OTHER_MESHES:
        name = f"mesh_{shape[0]}x{shape[1]}"
        mesh = api.Mesh(shape, [torch.device(DEVICE)] * (shape[0]
                                                          * shape[1]))
        apply_fn, caches, ms = api.sharded_solver(s, mesh)
        u = api.shard_field(mesh, qt)
        kern.reset()
        got = apply_fn(caches, ms[0], 0, u).full()
        torch.cuda.synchronize()
        counts = kern.counts()
        err = float(torch.linalg.vector_norm(got - ref)
                    / torch.linalg.vector_norm(ref))
        want = sharded_k8(s, mesh)
        k8 = {k: v for k, v in counts.items()
              if k.startswith("k8_") and (v or k in want)}
        out[name] = {
            "stop_level": api.stop_level(u.blocks[u.mesh.local[0]].shape[:2],
                                         s._tcfg.leaf_level),
            "shards": u.mesh.size, "matvec_rel_err": err,
            "launches": {k: v for k, v in counts.items() if v},
            "eager_launches": eager_launches(
                torch, kern, name, lambda: apply_fn(caches, ms[0], 0, u))}
        check(err < 1e-6, f"{name}: matvec {err} from the one-device")
        check(k8 == want, f"{name}: K8 launches {k8}, expected {want}")
        del apply_fn, caches, ms, u, got
        torch.cuda.empty_cache()
    check(out["mesh_1x8"]["stop_level"] == 3,
          f"mesh_1x8: the up pass stops at {out['mesh_1x8']['stop_level']}")
    return out


def run_sharded512(torch, kern):
    """The north star's grid on a 2 x 4 mesh of 8 shards on the card:
    512^2, deg 3, g 0.5, np 4, f32, tol 1e-7, GMRES(80), bench sigma and
    charge.  Level 2 takes the replicated route, levels 3-9 are sharded.
    Then one matvec on each of OTHER_MESHES (other_meshes)."""
    from aniso_torch.parallel import api

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    s = make_solver(torch, NORTH, 0.5, False)
    grid, tcfg = s.grid, s._tcfg
    out = {"phase": "sharded512", "sz": NORTH, "g": 0.5, "tol": 1e-7,
           "set_coeff_s": timed_set_coeff(torch, s),
           "cache_report_bytes": s.cache_report()}
    mesh = api.make_mesh(devices=[DEVICE] * 8)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    apply_fn, caches, ms = api.sharded_solver(s, mesh)
    torch.cuda.synchronize()
    out.update({"mesh": list(mesh.shape), "placement_s":
                time.perf_counter() - t0,
                "shard_copies_bytes": torch.cuda.memory_allocated() - before})
    q = bench_charge(grid)
    qt = torch.as_tensor(q, dtype=s.dtype, device=DEVICE)
    u = api.shard_field(mesh, qt)
    ref = s.apply_mode(0, qt)
    got = apply_fn(caches, ms[0], 0, u).full()
    out["matvec_rel_err"] = float(torch.linalg.vector_norm(got - ref)
                                  / torch.linalg.vector_norm(ref))
    out["apply_ms"] = event_ms(torch, lambda: s.apply_mode(0, qt))
    out["sharded_apply_ms"] = event_ms(
        torch, lambda: apply_fn(caches, ms[0], 0, u))
    out["matvec_device_ms"], _ = device_ms_per_call(
        torch, lambda: s.apply_mode(0, qt))
    (out["sharded_matvec_device_ms"],
     out["sharded_matvec_device_kernels"]) = device_ms_per_call(
        torch, lambda: apply_fn(caches, ms[0], 0, u))
    del apply_fn, caches, ms
    res, run, x, _ = sharded_solve(torch, kern, s, mesh, q, 1e-7)
    out.update(run)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["other_meshes"] = other_meshes(torch, kern, s, qt, ref)
    out["finite"] = bool(torch.isfinite(x).all())
    emit(out)
    check(out["finite"] and x.shape == (NORTH, NORTH, NQ),
          "sharded512: bad x")
    check(out["matvec_rel_err"] < 1e-6,
          f"sharded512: matvec {out['matvec_rel_err']} from the one-device")
    check(res.converged and abs(res.iterations - 14) <= 1,
          f"sharded512: {res.iterations} iterations, expected 14 +- 1")
    check(out["true_relative_residual"] < 1e-5,
          f"sharded512: true residual {out['true_relative_residual']}")
    check_sharded_counts("sharded512", out, mesh, s,
                         list(range(3, tcfg.leaf_level + 1)),
                         grid.n_nodes * 4)
    return out


def run_sharded64_compat(torch, kern):
    """benchmarks/oracle_64 with the reference's basis quirk on a 2 x 2
    mesh (every level 2-6 sharded): the oracle solve, and one mode-1
    sharded matvec (no diagonal) against the one-device one."""
    from aniso_torch.parallel import api

    s = make_solver(torch, 64, 0.95, True, kernel_size=2)
    grid, tcfg = s.grid, s._tcfg
    out = {"phase": "sharded64_compat", "sz": 64, "g": 0.95,
           "compat_global_basis": True, "tol": 1e-7,
           "set_coeff_s": timed_set_coeff(torch, s)}
    mesh = api.make_mesh(devices=[DEVICE] * 4)
    res, run, x, (apply_fn, caches, ms) = sharded_solve(
        torch, kern, s, mesh, bench_charge(grid), 1e-7)
    out.update(run)
    out["mesh"] = list(mesh.shape)
    xf = x.double().cpu().numpy().reshape(-1)
    out["oracle_rel_linf"] = oracle_error(grid, "oracle_64", xf)
    u1 = torch.as_tensor(fields_from_seed(grid, 1)[0], dtype=s.dtype,
                         device=DEVICE)
    ref1 = s.apply_mode(1, u1)
    got1 = apply_fn(caches, ms[1], 1, api.shard_field(mesh, u1)).full()
    out["mode1_matvec_rel_err"] = float(torch.linalg.vector_norm(
        got1 - ref1) / torch.linalg.vector_norm(ref1))
    emit(out)
    check(bool(np.isfinite(xf).all()), "sharded64_compat: bad x")
    check(res.converged and abs(res.iterations - 18) <= 1,
          f"sharded64_compat: {res.iterations} iterations, expected 18 +- 1")
    check(out["oracle_rel_linf"] < 1e-3,
          f"sharded64_compat: {out['oracle_rel_linf']} vs oracle_64")
    check(out["mode1_matvec_rel_err"] < 1e-6,
          f"sharded64_compat: mode-1 matvec {out['mode1_matvec_rel_err']}")
    check_sharded_counts("sharded64_compat", out, mesh, s,
                         list(range(2, tcfg.leaf_level + 1)),
                         grid.n_nodes * 4)
    return out


def run_distributed1(torch, kern):
    """parallel.distributed.init as a world-size-1 NCCL group on a free
    localhost port, a 2 x 2 mesh of 4 shards on the card over it: one
    sharded matvec against the one-device one, and one all_reduce (the
    norm of its result over the shards)."""
    from aniso_torch.parallel import api, distributed, halo

    port = free_port()
    distributed.init(f"127.0.0.1:{port}", 1, 0)
    try:
        backend = torch.distributed.get_backend()
        s = make_solver(torch, 64, 0.95, True)
        timed_set_coeff(torch, s)
        mesh = api.make_mesh(devices=[DEVICE] * 4)
        apply_fn, caches, ms = api.sharded_solver(s, mesh)
        u = torch.as_tensor(bench_charge(s.grid), dtype=s.dtype,
                            device=DEVICE)
        ref = s.apply_mode(0, u)
        out_sh = apply_fn(caches, ms[0], 0, api.shard_field(mesh, u))
        halo.reset_collectives()
        norm = float(out_sh.krylov_space().norm(out_sh))
        st = halo.collective_stats()
        got = out_sh.full()
        out = {"phase": "distributed1", "backend": backend, "port": port,
               "world_size": torch.distributed.get_world_size(),
               "mesh": list(mesh.shape), "distributed": mesh.distributed,
               "collectives": st._asdict(),
               "matvec_rel_err": float(torch.linalg.vector_norm(got - ref)
                                       / torch.linalg.vector_norm(ref)),
               "norm_rel_err": abs(norm - float(torch.linalg.vector_norm(
                   ref.double()))) / float(torch.linalg.vector_norm(
                       ref.double()))}
    finally:
        distributed.shutdown()
    emit(out)
    check(out["backend"] == "nccl" and out["world_size"] == 1
          and out["distributed"], f"distributed1: {out}")
    check(out["matvec_rel_err"] < 1e-6,
          f"distributed1: matvec {out['matvec_rel_err']}")
    check(st.counts == {"all-reduce": 1} and out["norm_rel_err"] < 1e-5,
          f"distributed1: {st}, norm {out['norm_rel_err']}")
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


def k9_extra(row):
    """K9's own numbers for the kernels line: its call's CG iterations,
    time per iteration and the barrier floor beside them."""
    return {k: row[k] for k in ("iterations", "ms_per_cg_iteration",
                                "barrier_floor_ms",
                                "barrier_floor_ms_per_iteration")}


def krylov_line(name, kid, kry, sz, inst, launches, **extra):
    """K11's kernels line: bench's (or f64_64's) field at step 14, every
    step and 512^2 beside."""
    row = kry[sz, inst][14]
    big = kry[NORTH, inst]
    return {"name": name, "id": kid, "route": "cuda",
            "source": "aniso_torch/csrc/krylov.cu",
            "replaces": "aniso_tpu/solver/gmres.py:45",
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for z, t in kry
                               if t == inst for r in kry[z, t].values()),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms",
                                   "bound_ms_cgs2_three_reads")},
            "shapes": f"{sz}^2 deg 3 (n = {row['n']}), step 14, restart 80",
            **{f"ms_i{i}": r["ms"] for i, r in kry[sz, inst].items()},
            **{f"ms_512_i{i}": r["ms"] for i, r in big.items()},
            **{f"bound_ms_512_i{i}": r["bound_ms"] for i, r in big.items()},
            **{f"library_ms_512_i{i}": r["library_ms"]
               for i, r in big.items()},
            **extra}


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

    # the kernels redesigned for the card: K1's one-mode kernel (its four
    # instances), K1-D and K3 at r = 16 (np 4), every K2, K10 and K8
    # instance, K7's deg 3 instances and K11's eight: registers, spills and
    # static shared memory
    from aniso_torch.kernels import (
        attenuation, halo, krylov, m2l, near, offsets, transfer,
    )
    redesigned = ([row for src in (m2l.SOURCE, offsets.SOURCE)
                   for row in usage.get(src, [])
                   if "m2l_translate_one_kernel" in row["function"]
                   or "Li16E" in row["function"]
                   and any(k in row["function"] for k in (
                       "m2l_translate_modes_kernel",
                       "offsets_translate_kernel"))]
                  + usage.get(near.SOURCE, []) + usage.get(halo.SOURCE, [])
                  + [row for row in usage.get(attenuation.SOURCE, [])
                     if "ILi3E" in row["function"]]
                  + usage.get(transfer.SOURCE, [])
                  + [row for row in usage.get(krylov.SOURCE, [])
                     if "cgs2_kernel" in row["function"]])
    emit({"phase": "redesigned_kernels", "ptxas": redesigned})
    # K8's two kernels and K11's one, compiled in both instances
    for fam, src in (("k8", transfer.SOURCE), ("k11", krylov.SOURCE)):
        pat = re.compile(KERNEL_FUNCTIONS[fam])
        for inst in ("If", "Id"):          # float, double in the mangling
            check(any(pat.search(row["function"]) and inst in row["function"]
                      for row in usage.get(src, [])),
                  f"{src}: no {KERNEL_FUNCTIONS[fam]} {inst} compiled")

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
    for n in (3, 5):
        for inst in ("f32", "f64"):
            chk[64, f"k1_{inst}_np{n}"] = kern.k1(64, inst, lv[64], np_cheb=n)
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
    # K9, one preconditioner call, at the grids and dtypes of dsa64 (f64),
    # demo128 and dsa512 (f32)
    for sz, inst in ((DSA_SZ, "f64"), (DEMO, "f32"), (NORTH, "f32")):
        chk[sz, f"k9_{inst}"] = kern.k9(sz, inst)
    # K7's whole build at oracle16_dense's shapes (all 2304^2 pairs) and at
    # dense64's (36,864^2 pairs; the first and last 512 rows checked); its
    # runtime-deg instance at deg 9, 10 and 12 (8^2; 128 rows checked)
    chk[16, "k7"] = kern.k7(16, 16 * 16 * NQ)
    k7_rows = kern.k7(64, 512, f32=True)
    chk[64, "k7"] = [r for r in k7_rows if r["variant"] != "m0_f32"]
    chk[64, "k7_f32"] = [r for r in k7_rows if r["variant"] == "m0_f32"]
    torch.cuda.empty_cache()
    for deg in (9, 10, 12):
        chk[8, f"k7_deg{deg}"] = kern.k7(8, 128, deg=deg)
    # np 6 and 7: K3 at the np6 phase's fine levels (32^2, deg 2: the split
    # pair axis, r = 36 and 49), K1-D f64 and K3-D f64 at demo128's twin
    # shapes (D = 9; K1-D f64 one box a lane); the one-mode K1 at np 6 as
    # the np6 phase runs it (f32 at every level, f64 at the twin's coarse
    # ones)
    chk[32, "k1_f32_np6"] = kern.k1(32, "f32", NP6_LEVELS, np_cheb=6)
    chk[32, "k1_f64_np6"] = kern.k1(32, "f64", NP6_LEVELS[:-2], np_cheb=6)
    cf32 = bench_coeffs(32, deg=2)
    for n in (6, 7):
        for inst in ("f32", "f64"):
            chk[32, f"k3_{inst}_deg2_np{n}"] = kern.k3(
                32, inst, [4, 5], cf32, deg=2, np_cheb=n)
        chk[DEMO, f"k1d_f64_deg1_np{n}"] = kern.k1(DEMO, "f64", lv[DEMO][:-2],
                                                   D=D, np_cheb=n)
        chk[DEMO, f"k3d_f64_deg1_np{n}"] = kern.k3(
            DEMO, "f64", lv[DEMO][-2:], demo_coeffs(DEMO), D=D, deg=1,
            np_cheb=n)
        torch.cuda.empty_cache()
    # K10 at sharded512's exchanges (8 shards of 256 x 128: u with one
    # square of halo, the leaf's M with two boxes); K1-S at one of its
    # shards at every sharded level (3-9), K2-S at one of its shards
    shard = (NORTH // 2, NORTH // 4)
    for inst in ("f32", "f64"):
        chk[NORTH, f"k10_{inst}"] = (kern.k10(inst, *shard, NQ, 1)
                                     + kern.k10(inst, *shard, R, 2))
        chk[NORTH, f"k1s_{inst}"] = kern.k1s(NORTH, inst, lv[NORTH][1:])
        chk[NORTH, f"k2s_{inst}"] = kern.k2s(*shard, inst, both)
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    # K8: the up and down passes at bench's 64^2 (levels 6 to 2), at 512^2
    # (f32, and f64 as the twin runs it), with mm512's D = 9 modes (f32 and
    # the twin's f64) and on one sharded512 shard (256 x 128)
    chk[64, "k8_f32"] = kern.k8(64, 64, 4, "f32")
    for inst in ("f32", "f64"):
        chk[NORTH, f"k8_{inst}"] = kern.k8(NORTH, NORTH, 7, inst)
        chk[NORTH, f"k8d_{inst}_deg3"] = kern.k8(NORTH, NORTH, 7, inst,
                                                 D=D)
        chk[NORTH, f"k8s_{inst}"] = kern.k8(*shard, 7, inst)
        torch.cuda.empty_cache()
    for sz in sorted({8, 16, 32, 64, 128, DSA_SZ, DEMO, NORTH}):
        emit({"phase": "kernels_vs_plain", "sz": sz,
              **{k: rows for (z, k), rows in chk.items() if z == sz}})
    # K11 at the one-mode fields of bench / f64_64 (64^2) and of refined512
    # / f32_512 and its f64 twin's size (512^2), restart 80, steps 0, 14
    # (bench's and f32_512's last) and 79 (a full cycle's last); K12 at
    # the same steps
    steps = (0, 14, 79)
    kry = {}
    for sz in (64, NORTH):
        for inst in ("f32", "f64"):
            kry[sz, inst] = {i: kern.k11(sz, inst, i) for i in steps}
            torch.cuda.empty_cache()
    k12 = {i: kern.k12(i) for i in steps}
    emit({"phase": "krylov_vs_plain",
          "k11": {f"{sz}_{inst}": rows for (sz, inst), rows in kry.items()},
          "k12": k12})

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
    dense64_f32 = run_dense64_f32(torch, kern)
    torch.cuda.empty_cache()
    demo = run_demo128(torch, kern)
    torch.cuda.empty_cache()
    dsa64 = run_dsa64(torch, kern)
    torch.cuda.empty_cache()
    dsa512 = run_dsa512(torch, kern)
    torch.cuda.empty_cache()
    np6 = run_np6(torch, kern)
    torch.cuda.empty_cache()
    np16 = run_np16(torch, kern)
    torch.cuda.empty_cache()
    mm = run_mm512(torch, kern)
    torch.cuda.empty_cache()
    sh512 = run_sharded512(torch, kern)
    torch.cuda.empty_cache()
    sh64 = run_sharded64_compat(torch, kern)
    dist1 = run_distributed1(torch, kern)
    torch.cuda.empty_cache()
    run_cli(torch)

    # times and bounds at each kernel's main-path shapes (summed over the
    # levels one matvec or twin sweep runs); errors the worst over every
    # checked size; launches counted in that path's run
    def worst(key):
        return max(r["max_abs_err"] for (_, k), rows in chk.items()
                   if k == key or k.startswith(key + "_deg")
                   or k.startswith(key + "_np") for r in rows)

    rl = refined["launches"]
    dl = demo["plain"]["launches"]
    # device kernels per matvec and per captured step, beside the parent
    # tree's counted the same way
    per_matvec = {
        "k8_launches_per_matvec_64": (
            bench["launches"]["k8_up_f32"]
            + bench["launches"]["k8_down_f32"]) / bench["matvecs"],
        "k8_launches_per_matvec_sharded512": (
            sh512["launches"]["k8_up_f32"]
            + sh512["launches"]["k8_down_f32"]) / sh512["matvecs"]}
    emit({"phase": "kernels_per_matvec",
          "matvec_64": bench["matvec_device_kernels"],
          "captured_step_64": bench["captured_step_kernels"],
          "sharded512_matvec": sh512["sharded_matvec_device_kernels"],
          **{"parent_" + k: v for k, v in PARENT_KERNELS.items()},
          **per_matvec})
    # K8 is one launch a pass: the plan's count at bench's 64^2
    from aniso_torch.kernels import transfer
    plan64 = (len(transfer.up_plan(64, 64, 4, R, NQ, 4))
              + len(transfer.down_plan(64, 64, 4, R, NQ, 4)))
    check(per_matvec["k8_launches_per_matvec_64"] == plan64,
          f"K8 launches a 64^2 matvec {per_matvec}, the plan's {plan64}")

    def k8_line(name, inst, pass_, launches, replaces, **extra):
        """K8's up or down pass: times at bench's 64^2 (f32) or the
        twin's 512^2 (f64), 512^2, mm512's D = 9 and a sharded512 shard
        beside."""
        pick = {"up": 0, "down": 1}[pass_]
        first = chk[64, "k8_f32"] if inst == "f32" else chk[NORTH, "k8_f64"]
        row = first[pick]
        big, modes, shard_ = (chk[NORTH, f"k8_{inst}"][pick],
                              chk[NORTH, f"k8d_{inst}_deg3"][pick],
                              chk[NORTH, f"k8s_{inst}"][pick])
        return kernel_line(
            name, "aniso_torch/csrc/transfer.cu", replaces, launches, [row],
            library_ms=row["library_ms"], launches_per_call=row[
                "launches_per_call"], torch_kernels_replaced=row[
                "plain_kernels"],
            shapes=f"{row['lx']}^2, leaf to level 2 ({row['levels']} "
            "levels), one mode",
            ms_512=big["ms"], bound_ms_512=big["bound_ms"],
            library_ms_512=big["library_ms"], ms_512_d9=modes["ms"],
            bound_ms_512_d9=modes["bound_ms"],
            library_ms_512_d9=modes["library_ms"],
            ms_shard_256x128=shard_["ms"],
            library_ms_shard_256x128=shard_["library_ms"],
            max_abs_err_all_sizes=max(r["max_abs_err"] for (z, k), rows
                                      in chk.items() if k.startswith("k8")
                                      and k.endswith(inst)
                                      or k == f"k8d_{inst}_deg3"
                                      for r in rows if r["pass"] == pass_),
            **extra)

    emit({"kernels": [
        kernel_line("m2l_translate", "aniso_torch/csrc/m2l_translate.cu",
                    "aniso_tpu/fmm/apply.py:317", bench["launches"]["k1_f32"],
                    chk[64, "k1_f32"], shapes="bench 64^2, levels 2-6",
                    launches_refined512=rl["k1_f32"],
                    ms_512=Kernels.total(chk[NORTH, "k1_f32"])["ms"],
                    bound_ms_512=Kernels.total(chk[NORTH, "k1_f32"])[
                        "bound_ms"],
                    leaf512_tb_per_s=chk[NORTH, "k1_f32"][-1]["bytes"]
                    / chk[NORTH, "k1_f32"][-1]["ms"] / 1e9,
                    ms_np3=Kernels.total(chk[64, "k1_f32_np3"])["ms"],
                    ms_np5=Kernels.total(chk[64, "k1_f32_np5"])["ms"],
                    ms_np6=Kernels.total(chk[32, "k1_f32_np6"])["ms"],
                    launches_np6=np6["launches"]["k1_f32"],
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
                    ms_64=Kernels.total(chk[64, "k1_f64"])["ms"],
                    bound_ms_64=Kernels.total(chk[64, "k1_f64"])["bound_ms"],
                    ms_np3=Kernels.total(chk[64, "k1_f64_np3"])["ms"],
                    ms_np5=Kernels.total(chk[64, "k1_f64_np5"])["ms"],
                    ms_np6=Kernels.total(chk[32, "k1_f64_np6"])["ms"],
                    launches_np6=np6["launches"]["k1_f64"],
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
                    launches_np6=np6["launches"]["k3_f64"],
                    ms_np6=Kernels.total(chk[32, "k3_f64_deg2_np6"])["ms"],
                    ms_np7=Kernels.total(chk[32, "k3_f64_deg2_np7"])["ms"],
                    bound_ms_np6=Kernels.total(
                        chk[32, "k3_f64_deg2_np6"])["bound_ms"],
                    shapes_np6="np6 twin 32^2, deg 2, fine levels 4-5",
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
                    ms_np6=Kernels.total(chk[DEMO, "k1d_f64_deg1_np6"])["ms"],
                    ms_np7=Kernels.total(chk[DEMO, "k1d_f64_deg1_np7"])["ms"],
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
                    ms_np6=Kernels.total(chk[DEMO, "k3d_f64_deg1_np6"])["ms"],
                    ms_np7=Kernels.total(chk[DEMO, "k3d_f64_deg1_np7"])["ms"],
                    max_abs_err_all_sizes=worst("k3d_f64")),
        # K9: one launch per preconditioner call (times of one call at the
        # phase's grid: its CG iterations, the barrier floor beside);
        # K9d's stencil runs inside it, so K9d is launched on no path
        kernel_line("pcg", "aniso_torch/csrc/pcg.cu",
                    "aniso_tpu/solver/dsa.py:114",
                    demo["dsa"]["launches"]["k9_f32"], chk[DEMO, "k9_f32"],
                    id="K9", shapes=f"demo128 DSA, {DEMO}^2 cells, one call",
                    **k9_extra(chk[DEMO, "k9_f32"][0]),
                    launches_dsa512=dsa512["dsa"]["launches"]["k9_f32"],
                    dsa512=k9_extra(chk[NORTH, "k9_f32"][0]),
                    max_abs_err_all_sizes=worst("k9_f32")),
        kernel_line("pcg_f64", "aniso_torch/csrc/pcg.cu",
                    "aniso_tpu/solver/dsa.py:114",
                    sum(o["dsa"]["launches"]["k9_f64"] for o in dsa64),
                    chk[DSA_SZ, "k9_f64"], id="K9 f64",
                    shapes=f"dsa64 DSA, {DSA_SZ}^2 cells, one call",
                    **k9_extra(chk[DSA_SZ, "k9_f64"][0]),
                    max_abs_err_all_sizes=worst("k9_f64")),
        kernel_line("diffusion_apply", "aniso_torch/csrc/diffusion_apply.cu",
                    "aniso_tpu/solver/dsa.py:85",
                    demo["dsa"]["launches"]["k9d_f32"], chk[DEMO, "k9d_f32"],
                    id="K9d", shapes=f"demo128 DSA, {DEMO}^2 cells",
                    on_main_path=False,
                    max_abs_err_all_sizes=worst("k9d_f32")),
        kernel_line("diffusion_apply_f64",
                    "aniso_torch/csrc/diffusion_apply.cu",
                    "aniso_tpu/solver/dsa.py:85",
                    sum(o["dsa"]["launches"]["k9d_f64"] for o in dsa64),
                    chk[DSA_SZ, "k9d_f64"], id="K9d f64",
                    shapes=f"dsa64 DSA, {DSA_SZ}^2 cells",
                    on_main_path=False,
                    max_abs_err_all_sizes=worst("k9d_f64")),
        # K7: the whole 16^2 build (oracle16_dense, one launch: the kernel,
        # its plain version and the bound on the same work); the whole 64^2
        # build (dense64, f64 and f32 stores: one launch each) beside, with
        # its bounds on the unique pairs and on all ordered pairs
        kernel_line("line_integral", "aniso_torch/csrc/line_integral.cu",
                    "aniso_tpu/ops/attenuation.py:112",
                    dense64["launches"]["k7_dense_f64"], chk[16, "k7"][:1],
                    id="K7", shapes="oracle16_dense 16^2: the whole (1, 2304, "
                    "2304) build, one mode",
                    ms_64=chk[64, "k7"][0]["ms"],
                    bound_ms_64=chk[64, "k7"][0]["bound_ms"],
                    bound_ms_64_all_pairs=chk[64, "k7"][0][
                        "bound_ms_all_pairs"],
                    plain_ms_64_512_rows=chk[64, "k7"][0]["plain_ms"],
                    shapes_64="dense64 64^2: the whole (1, 36864, 36864) build",
                    launches_dense64_f32=dense64_f32["launches"][
                        "k7_dense_f32"],
                    pairs_ms_64_512_rows=chk[64, "k7"][0]["pairs_ms"],
                    **{f"ms_8_deg{d}": chk[8, f"k7_deg{d}"][0]["ms"]
                       for d in (9, 10, 12)},
                    **{f"bound_ms_8_deg{d}": chk[8, f"k7_deg{d}"][0]["bound_ms"]
                       for d in (9, 10, 12)},
                    max_abs_err_all_sizes=worst("k7")),
        # K7's float32 store (dense64_f32's instance, one launch): the whole
        # 64^2 build, first and last 512 rows against the float64 plain rows
        kernel_line("line_integral_f32", "aniso_torch/csrc/line_integral.cu",
                    "aniso_tpu/ops/attenuation.py:112",
                    dense64_f32["launches"]["k7_dense_f32"],
                    chk[64, "k7_f32"], id="K7 f32 store",
                    shapes="dense64_f32 64^2: the whole (1, 36864, 36864) "
                    "build, stored in float32",
                    tolerance=TOL_STORE_F32,
                    bound_ms_all_pairs=chk[64, "k7_f32"][0][
                        "bound_ms_all_pairs"],
                    plain_rows=chk[64, "k7_f32"][0]["plain_rows"]),
        # domain decomposition (sharded512: 8 shards of 256 x 128 on one
        # card): K10 per matvec's u exchange plus its leaf M exchange, one
        # launch each; K1-S and K2-S on one shard (levels 3-9), launched
        # once per shard
        kernel_line("halo_fill", "aniso_torch/csrc/halo_fill.cu",
                    "aniso_tpu/parallel/halo.py:30",
                    sh512["launches"]["k10_f32"], chk[NORTH, "k10_f32"],
                    id="K10", shapes="sharded512: u (w 1) + leaf M (w 2), "
                    "8 shards of 256 x 128, one launch each",
                    copy_ms=sum(r["copy_ms"] for r in chk[NORTH, "k10_f32"]),
                    ms_f64=Kernels.total(chk[NORTH, "k10_f64"])["ms"],
                    bound_ms_f64=Kernels.total(chk[NORTH, "k10_f64"])[
                        "bound_ms"],
                    copy_ms_f64=sum(r["copy_ms"]
                                    for r in chk[NORTH, "k10_f64"]),
                    launches_sharded64=sh64["launches"]["k10_f32"],
                    bitwise=True, max_abs_err_all_sizes=worst("k10_f32")),
        kernel_line("m2l_translate_shard", "aniso_torch/csrc/m2l_translate.cu",
                    "aniso_tpu/parallel/halo.py:106",
                    sh512["launches"]["k1_shard_f32"], chk[NORTH, "k1s_f32"],
                    id="K1-S", shapes="one sharded512 shard, levels 3-9",
                    ms_f64=Kernels.total(chk[NORTH, "k1s_f64"])["ms"],
                    bound_ms_f64=Kernels.total(chk[NORTH, "k1s_f64"])[
                        "bound_ms"],
                    launches_sharded64=sh64["launches"]["k1_shard_f32"],
                    max_abs_err_all_sizes=worst("k1s_f32")),
        kernel_line("near_contract_shard", "aniso_torch/csrc/near_contract.cu",
                    "aniso_tpu/parallel/halo.py:56",
                    sh512["launches"]["k2_shard_f32"],
                    chk[NORTH, "k2s_f32"][:1], id="K2-S",
                    shapes="one sharded512 shard, 256 x 128",
                    ms_compat=chk[NORTH, "k2s_f32"][1]["ms"],
                    ms_f64=chk[NORTH, "k2s_f64"][0]["ms"],
                    launches_sharded64=sh64["launches"]["k2_shard_f32"],
                    max_abs_err_all_sizes=worst("k2s_f32")),
        # K8: the up pass (P2M, M2M) and the down pass (L2L, L2T, near add,
        # 1/2pi), launches from bench's solve (f32) and refined512's twin
        # (f64); the sharded512 shards' beside
        k8_line("transfer_up", "f32", "up", bench["launches"]["k8_up_f32"],
                "aniso_tpu/fmm/apply.py:141", id="K8-up",
                launches_sharded512=sh512["launches"]["k8_up_f32"],
                launches_np16=np16["launches"]["k8_up_f32"]),
        k8_line("transfer_down", "f32", "down",
                bench["launches"]["k8_down_f32"],
                "aniso_tpu/fmm/apply.py:549", id="K8-down",
                replaces_l2t="aniso_tpu/fmm/apply.py:707",
                launches_sharded512=sh512["launches"]["k8_down_f32"],
                launches_mm512=mm["launches"]["k8_down_f32"]),
        k8_line("transfer_up_f64", "f64", "up", rl["k8_up_f64"],
                "aniso_tpu/fmm/apply.py:141", id="K8-up f64",
                launches_np16=np16["launches"]["k8_up_f64"]),
        k8_line("transfer_down_f64", "f64", "down", rl["k8_down_f64"],
                "aniso_tpu/fmm/apply.py:549", id="K8-down f64",
                replaces_l2t="aniso_tpu/fmm/apply.py:707",
                launches_mm512=mm["launches"]["k8_down_f64"]),
        # the GMRES step (K11, K12): launches once a step of bench's solve
        # (K12's back-substitution once a cycle); times at step 14 of a
        # restart-80 cycle on bench's field, the other steps and sizes
        # beside; K11's library_ms is pass (a) alone, torch.mv
        krylov_line("cgs2", "K11", kry, 64, "f32",
                    bench["launches"]["k11_f32"],
                    launches_refined512=rl["k11_f32"],
                    launches_demo128=dl["k11_f32"]),
        krylov_line("cgs2_f64", "K11 f64", kry, 64, "f64",
                    f64["launches"]["k11_f64"],
                    launches_dsa64=sum(o[k]["launches"]["k11_f64"]
                                       for o in dsa64
                                       for k in ("plain", "dsa"))),
        {"name": "givens", "id": "K12", "route": "cuda",
         "source": "aniso_torch/csrc/krylov.cu",
         "replaces": "aniso_tpu/solver/gmres.py:66",
         "launches": bench["launches"]["k12_step"],
         "launches_backsub": bench["launches"]["k12_backsub"],
         "launches_refined512": rl["k12_step"],
         "launches_sharded512": sh512["launches"]["k12_step"],
         "max_abs_err": max(r["max_abs_err"] for r in k12.values()),
         **{k: k12[14][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "floor_ms", "backsub_ms",
                                    "backsub_plain_ms")},
         "library_ms": None, "shapes": "step 14 of a restart-80 cycle",
         **{f"ms_i{i}": k12[i]["ms"] for i in steps},
         "backsub_max_abs_err": max(r["backsub_max_abs_err"]
                                    for r in k12.values())},
    ]})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
