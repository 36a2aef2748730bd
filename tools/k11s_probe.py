"""Probes of the CGS2 kernels (K11, K11-S) for tools/kernel_ab.py, for a
tree of either kernel design (the one-shard-a-block-range K11-S before the
resident share and the ring, or after):

  floor(k, cs, shard, shards, i): the empty step, the fixed cost of one
      K11-S launch: the cooperative grid of the shards' plan, its three
      grid barriers and grid_rows sums at step i, with no basis.  On a tree
      that has it, krylov.cgs2_shards_empty; on an older one, the same
      launch (plan, grid, shared memory) on shards of one vector each, so
      that every block but one a shard owns nothing.  No Givens epilogue,
      so the state stays at step i between samples.
  partition(k, cs, sz, i, sms): K11 on the one-mode field of a sz^2 solve
      (f32, restart 80, no Givens epilogue) planned for `sms` SMs: 132 is
      its own grid on the H100, 128 the partition K11-S gives 8 shards (16
      blocks a shard, each owning n / 128 of every row); held against
      cgs2_plain (TOL_KERNEL of the largest value of V[i+1] and of the
      column) before it is timed.

  stream(k, cs, shard, shards, i): on a tree of the ring design whose
      krylov.cu was built with K11_PROBE set (tools/kernel_ab.py --variants
      k11s_probe), the step's copies alone at step i (phase STREAM: the
      resident share and every pass's chunks brought in and released, no
      arithmetic), beside the bytes of one read of V[:i+1] and w: the
      ring's floor.

  trace(k, cs, shard, shards, i, empty): on such a build and a plan with a
      ring (the lean instance stamps nothing), one fused step (or the
      empty step) traced (the phase bit TRACE: thread 0 of each
      block stamps the global timer at TRACE_MARKS): the median block's
      time at each mark (pass ends, barriers and sums, V[i+1], the end), in
      ms.

  warm(k, cs, sz, i): K11 alone (krylov.cgs2, no Givens epilogue, so the
      state stays at step i) on the one-mode field of a sz^2 solve, 20
      launches captured in one CUDA graph and replayed: the device time a
      launch back to back with its L2 and caches warm, as in a solve (the
      other rows flush L2 before each sample); either design.

Each returns chip_smoke-style rows ({"ms": ..., ...}: median CUDA-event
device time, cold L2).  Needs a CUDA card; run through tools/kernel_ab.py
(--only k11s_floor,k11s_stream,k11_partition).
"""

from __future__ import annotations

import ctypes

STREAM = 6                      # the copies alone (kStream, K11_PROBE)
TRACE = 16                      # a traced launch's phase bit (kTrace)
TRACE_BLOCKS = 256              # (kTraceBlocks)
# the marks a traced fused launch stamps (kTraceMarks)
TRACE_MARKS = ("start", "a", "a_sum", "b", "b_sum", "c", "c_sum", "final",
               "end", "entry")


def _new_api(kr) -> bool:
    return hasattr(kr, "cgs2_shards_empty")


def _probe_build(kr):
    """The traced stamps' entry of a K11_PROBE build of krylov.cu, or
    None."""
    try:
        return kr._cuda.load(kr.SOURCE, "aniso_k11_trace",
                             (ctypes.c_void_p,))
    except AttributeError:
        return None


def floor(k, cs, shard, shards, i, m=80, inst="f32"):
    torch, kr = k.torch, k.krylov
    dtype = torch.float32 if inst == "f32" else torch.float64
    n = shard[0] * shard[1] * cs.NQ
    st = k.krylov_state(m, i, j=i + 1)
    if _new_api(kr):
        V = torch.zeros((shards, m + 1, n), dtype=dtype, device=cs.DEVICE)
        w = torch.zeros((shards, n), dtype=dtype, device=cs.DEVICE)
        u = torch.zeros_like(w)
        args = (list(V.unbind(0)), list(w.unbind(0)), list(u.unbind(0)))

        def run():
            kr.cgs2_shards_empty(*args, st)
        how = "cgs2_shards_empty"
    else:
        item = torch.finfo(dtype).bits // 8
        vec = 16 // item
        sms = kr._num_sms(torch.device(cs.DEVICE).index or 0)
        plan = kr.cgs2_plan(n, m, item, vec, max(1, sms // shards))
        V = torch.zeros((shards, m + 1, vec), dtype=dtype, device=cs.DEVICE)
        w = torch.zeros((shards, vec), dtype=dtype, device=cs.DEVICE)
        u = torch.zeros_like(w)
        table = []
        for s in range(shards):
            table += [V[s].data_ptr(), w[s].data_ptr(), u[s].data_ptr(), vec]
        arr = (ctypes.c_longlong * len(table))(*table)
        blocks = plan.blocks * shards
        part = torch.empty((2 * (m + 1) + 1) * blocks, dtype=torch.float64,
                           device=cs.DEVICE)
        symbol = kr.SHARD_SYMBOLS[inst]
        fn = kr._cuda.load(kr.SOURCE, symbol, kr._SHARD_ARGTYPES)

        def run():
            rc = fn(ctypes.cast(arr, ctypes.c_void_p), shards, plan.blocks,
                    kr._cuda.ptr(st), kr._cuda.ptr(part), part.numel(),
                    None, m, plan.chunk, int(plan.resident), plan.stash, vec,
                    0, kr.FUSED, plan.smem, kr._cuda.stream(st.device))
            kr._cuda.raise_on_error(symbol, rc)
        how = "one vector a shard"
    run()
    torch.cuda.synchronize()
    return [{"i": i, "shards": shards, "n_shard": n, "restart": m,
             "inst": inst, "how": how, "max_abs_err": 0.0,
             "bytes": 0, "bound_ms": 0.0, "bound_by": "bytes",
             "ms": cs.event_ms(torch, run, flush=k.flush)}]


def partition(k, cs, sz, i, sms, m=80):
    torch, kr = k.torch, k.krylov
    n = sz * sz * cs.NQ
    V = k.rand((m + 1, n), "f32", normal=True, seed=i)
    V /= torch.linalg.vector_norm(V, dim=1, keepdim=True)
    w = k.rand((n,), "f32", normal=True, seed=1000 + i)
    st = k.krylov_state(m, i)
    got = [V.clone(), w.clone(), torch.zeros_like(w), st.clone()]
    want = [V.clone(), w.clone(), torch.zeros_like(w), st.clone()]
    if _new_api(kr):
        plan = kr.k11_plan((n,), m, 4, 4, sms)
        part = torch.empty((2 * (m + 1) + 1) * plan.blocks,
                           dtype=torch.float64, device=cs.DEVICE)
        fn = kr._cuda.load(kr.SOURCE, kr.SYMBOLS["f32"], kr._ARGTYPES)

        def run():
            rc = fn(*(kr._cuda.ptr(t) for t in got), kr._cuda.ptr(part),
                    part.numel(), n, m, plan.blocks, plan.chunk,
                    plan.stages, plan.stage_bytes, plan.res_bytes, 4, 0,
                    plan.smem, kr._cuda.stream(st.device))
            kr._cuda.raise_on_error(kr.SYMBOLS["f32"], rc)
        blocks = plan.blocks
    else:
        plan = kr.cgs2_plan(n, m, 4, 4, sms)
        part = torch.empty((2 * (m + 1) + 1) * plan.blocks,
                           dtype=torch.float64, device=cs.DEVICE)
        fn = kr._cuda.load(kr.SOURCE, kr.SYMBOLS["f32"], kr._ARGTYPES)

        def run():
            rc = fn(*(kr._cuda.ptr(t) for t in got), kr._cuda.ptr(part),
                    part.numel(), n, m, plan.blocks, plan.chunk,
                    int(plan.resident), plan.stash, 4, 0, plan.smem,
                    kr._cuda.stream(st.device))
            kr._cuda.raise_on_error(kr.SYMBOLS["f32"], rc)
        blocks = plan.blocks
    run()
    kr.cgs2_plain(*want)
    torch.cuda.synchronize()
    L = kr.state_layout(m)
    col = slice(L.col, L.col + i + 2)
    errs = []
    for a, b in ((got[0][i + 1], want[0][i + 1]), (got[3][col], want[3][col])):
        errs.append(float((a - b).abs().max()))
        scale = float(b.abs().max())
        cs.check(errs[-1] <= cs.TOL_KERNEL["f32"] * scale,
                 f"K11 {sz}^2 i={i} on {sms} SMs: max err {errs[-1]} of "
                 f"{scale}")
    nbytes = (i + 4) * n * 4
    bms, bby = cs.bound_ms(nbytes, 8 * (i + 1) * n,
                           peak=cs.PEAK_F64_CUDA_CORES)
    return [{"i": i, "n": n, "restart": m, "sms": sms, "blocks": blocks,
             "max_abs_err": errs[0], "max_abs_err_column": errs[1],
             "bytes": nbytes, "bound_ms": bms, "bound_by": bby,
             "ms": cs.event_ms(torch, run, flush=k.flush)}]


def stream(k, cs, shard, shards, i, m=80, inst="f32"):
    torch, kr = k.torch, k.krylov
    if not _new_api(kr) or _probe_build(kr) is None:
        return []
    n = shard[0] * shard[1] * cs.NQ
    V = k.rand((shards, m + 1, n), inst, normal=True, seed=i)
    w = k.rand((shards, n), inst, normal=True, seed=1000 + i)
    u = torch.zeros_like(w)
    st = k.krylov_state(m, i, j=i + 1)
    args = [list(t.unbind(0)) for t in (V, w, u)]

    def run():
        kr._shard_launch(*args, st, m, split=False, givens=False)(STREAM)

    run()
    torch.cuda.synchronize()
    nbytes = (i + 2) * shards * n * V.element_size()
    bms, bby = cs.bound_ms(nbytes, 0)
    return [{"i": i, "shards": shards, "n_shard": n, "restart": m,
             "inst": inst, "max_abs_err": 0.0, "bytes": nbytes,
             "bound_ms": bms, "bound_by": bby,
             "ms": cs.event_ms(torch, run, flush=k.flush)}]


def trace(k, cs, shard, shards, i, m=80, inst="f32", empty=False):
    torch, kr = k.torch, k.krylov
    stamps = _probe_build(kr) if _new_api(kr) else None
    if stamps is None:
        return []
    n = shard[0] * shard[1] * cs.NQ
    item = 4 if inst == "f32" else 8
    if not kr.k11_plan((n,) * shards, m, item, 16 // item,
                       kr._num_sms(0)).stages:
        return []                      # the lean instance: no marks

    V = k.rand((shards, m + 1, n), inst, normal=True, seed=i)
    V /= torch.linalg.vector_norm(V, dim=(0, 2), keepdim=True)
    w = k.rand((shards, n), inst, normal=True, seed=1000 + i)
    u = torch.zeros_like(w)
    args = [list(t.unbind(0)) for t in (V, w, u)]
    out = []
    for _ in range(3):              # the last of three, L2 cold
        k.flush()
        torch.cuda.synchronize()
        st = k.krylov_state(m, i, j=i + 1)
        marks = _traced(kr, stamps, *args, st, empty)
    last = "c_sum" if empty else "end"
    row = {"i": i, "shards": shards, "n_shard": n, "restart": m,
           "inst": inst, "empty": empty, "max_abs_err": 0.0, "bytes": 0,
           "bound_ms": 0.0, "bound_by": "bytes",
           "ms": marks[last] * 1e-6}
    row.update({f"{name}_ms": v * 1e-6 for name, v in marks.items()})
    out.append(row)
    return out


def warm(k, cs, sz, i, m=80, inst="f32", reps=20):
    torch, kr = k.torch, k.krylov
    n = sz * sz * cs.NQ
    V = k.rand((m + 1, n), inst, normal=True, seed=i)
    V /= torch.linalg.vector_norm(V, dim=1, keepdim=True)
    w = k.rand((n,), inst, normal=True, seed=1000 + i)
    u = torch.zeros_like(w)
    st = k.krylov_state(m, i)
    kr.cgs2(V, w, u, st)                 # builds, plans
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        for _ in range(reps):
            kr.cgs2(V, w, u, st)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return [{"i": i, "n": n, "restart": m, "inst": inst, "max_abs_err": 0.0,
             "bytes": 0, "bound_ms": 0.0, "bound_by": "bytes",
             "ms": times[len(times) // 2]}]


def _traced(kr, stamps, V, w, u, st, empty):
    """One fused step (or the empty step) of a K11_PROBE build, traced:
    {mark: ns since "start"}, each the median over the blocks (at most
    TRACE_BLOCKS)."""
    import torch

    m = V[0].shape[0] - 1
    run = kr._shard_launch(V, w, u, st, m, split=False, givens=True)
    run((kr.EMPTY if empty else kr.FUSED) | TRACE)
    torch.cuda.synchronize(st.device)
    buf = (ctypes.c_ulonglong * (TRACE_BLOCKS * len(TRACE_MARKS)))()
    kr._cuda.raise_on_error("aniso_k11_trace",
                            stamps(ctypes.cast(buf, ctypes.c_void_p)))
    blocks = min(run.blocks, TRACE_BLOCKS)
    t = torch.tensor(list(buf), dtype=torch.float64).view(
        TRACE_BLOCKS, len(TRACE_MARKS))[:blocks]
    rel = t - t[:, :1]
    return {k: float(rel[:, j].median()) for j, k in enumerate(TRACE_MARKS)}
