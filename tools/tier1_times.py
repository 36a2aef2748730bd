"""Per-file and per-case times of a Tier-1 run, from its junit XML.

The Tier-1 command (ROADMAP.md) writes a junit file; this sums each test
file's case times (worker-seconds: under xdist a file runs whole on one
worker) and lists the cases above a threshold.  Given several junit files
(say, before and after a change), it prints the files side by side.

    python tools/tier1_times.py before.xml after.xml [--over 10] [--top 30]

Times are the junit's, on whatever host ran the tests: CPU-host seconds,
never a device measurement.
"""

from __future__ import annotations

import argparse
import collections
import os
import xml.etree.ElementTree as ET


def read(path: str):
    """({file: [seconds, cases, passed]}, {case id: seconds}) of one run."""
    files = collections.defaultdict(lambda: [0.0, 0, 0])
    cases = {}
    for tc in ET.parse(path).getroot().iter("testcase"):
        name = tc.get("classname").rsplit(".", 1)[-1] + ".py"
        seconds = float(tc.get("time", 0.0))
        passed = not any(ch.tag in ("skipped", "failure", "error")
                         for ch in tc)
        row = files[name]
        row[0] += seconds
        row[1] += 1
        row[2] += passed
        cases[f"{name}::{tc.get('name')}"] = seconds
    return files, cases


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit", nargs="+")
    ap.add_argument("--over", type=float, default=10.0,
                    help="list the cases of the last run above this (s)")
    ap.add_argument("--top", type=int, default=30,
                    help="files to list, longest in the last run first")
    args = ap.parse_args(argv)
    runs = [read(p) for p in args.junit]
    last = runs[-1][0]
    names = sorted(set().union(*(f for f, _ in runs)),
                   key=lambda n: -last.get(n, [0.0])[0])
    print("| file | cases | "
          + " | ".join(os.path.basename(p) for p in args.junit) + " |")
    print("|---|---|" + "---|" * len(runs))
    for name in names[:args.top]:
        n = " → ".join(dict.fromkeys(str(f[name][1]) for f, _ in runs
                                     if name in f))
        cells = [f"{f[name][0]:.1f}" if name in f else "—" for f, _ in runs]
        print(f"| {name} | {n} | " + " | ".join(cells) + " |")
    totals = [sum(v[0] for v in f.values()) for f, _ in runs]
    passed = [sum(v[2] for v in f.values()) for f, _ in runs]
    print("| all (worker-seconds; passed) | | " + " | ".join(
        f"{t:.0f}; {p}" for t, p in zip(totals, passed)) + " |")
    print(f"\ncases over {args.over:g} s in {args.junit[-1]}:")
    for case, s in sorted(runs[-1][1].items(), key=lambda kv: -kv[1]):
        if s > args.over:
            print(f"{s:8.1f}  {case}")


if __name__ == "__main__":
    main()
