"""The kernel records the profiler loses in chip_smoke.py's profiled solves,
counted over repeats in a whole run.

    python3 tools/profiler_misses.py [--reps 5] \\
        [--phases np16,sharded512,sharded64_compat] [--out FILE]

runs the whole of chip_smoke.py (every phase and gate, as it runs alone),
with the profiled solve of each phase named in --phases followed at once by
--reps more profiled repeats of the same solve.  A repeat runs as
chip_smoke.py's profiled solve does (solve_device_time): the launch
counters set to 0, the solve inside device_profile's padded window, then
profiled_launches; the records it lost are, per kernel family, the
launches counted beyond those the profiler saw.  chip_smoke.py's own gate
(at most PROFILER_MISS_MAX records lost) holds the first solve of each
phase; the repeats are counted, not gated.  chip_smoke.py's lines go to
stdout as they come; after its last (or a failed gate), one JSON line per
phase (the records lost by the gated solve and by each repeat) and a
summary, also written to --out.  Exits with chip_smoke.py's code.  Needs
one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--phases", default="np16,sharded512,sharded64_compat")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    phase = [None]
    records = []

    def in_phase(name, run):
        def wrapped(*a, **kw):
            phase[0] = name
            try:
                return run(*a, **kw)
            finally:
                phase[0] = None
        return wrapped

    for name in args.phases.split(","):
        setattr(cs, "run_" + name, in_phase(name, getattr(cs, "run_" + name)))
    gated = cs.solve_device_time

    def repeated(torch, kern, out, fn, precond=None, graphs=None,
                 eager=None):
        gated(torch, kern, out, fn, precond, graphs, eager)
        if phase[0] is None:
            return
        lost = [out["profiler_missed"]]
        for _ in range(args.reps):
            if precond is not None:
                precond.reset()
            kern.reset()
            per, launched, _ = cs.device_profile(torch, fn)
            fams = cs.profiled_launches(kern.counts(), launched) if per else {}
            lost.append({fam: n - seen for fam, (n, seen) in fams.items()
                         if seen < n})
        records.append({"phase": phase[0], "lost": lost,
                        "lost_total": [sum(d.values()) for d in lost]})

    cs.solve_device_time = repeated
    try:
        return cs.main()
    finally:        # the records so far, also where a gate failed
        totals = [t for r in records for t in r["lost_total"]]
        lines = records + [{"profiled_solves": len(totals),
                            "records_lost": sum(totals),
                            "most_in_one_solve": max(totals, default=None),
                            "cap": cs.PROFILER_MISS_MAX}]
        sink = open(args.out, "w") if args.out else None
        for obj in lines:
            line = json.dumps(obj)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
        if sink:
            sink.close()


if __name__ == "__main__":
    sys.exit(main())
