"""BASELINE.json config 5 alone: chip_smoke.py's 1024^2 kernel rows and its
north1024 and sharded1024 phases, without the rest of the smoke run.

    python3 tools/phases1024.py > p1024.jsonl

Needs one CUDA card (80 GB: sharded1024 peaks at about 75 GB while the
caches move onto the mesh) and about two minutes, one of them the kernels'
build.  Prints the nvidia-smi name and power limit line, then one JSON line
a stage: the build, each kernel's rows at north1024's and sharded1024's
shapes (K1 at every level of 1024^2, K2, K8, K11 at steps 0, 14 and 79;
K10, K1-S, K2-S on one 512 x 256 shard, K11-S on eight of them at steps
0, 14 and 79; each against its plain version,
then timed, as chip_smoke.py's kernels_vs_plain rows), then the two phases'
lines with their gates.  K6's resident weights are built by north1024's
set_coeff here (chip_smoke.py builds them earlier, in refined512), so its
coarse_s is the cold one.  Exits non-zero if a row or a gate failed.
"""

import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("phases1024: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from aniso_torch import _build
    import aniso_torch.solver.operator  # noqa: F401  (sets the TF32 pins)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    smi = smi.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    cs.emit({"phase": "build", "seconds": time.perf_counter() - t0})
    scratch = torch.empty(96 * 1024 * 1024 // 4, device="cuda")
    kern = cs.Kernels(torch, scratch.zero_)
    big = cs.BIG
    lv = list(range(2, int(math.log2(big)) + 1))
    shard = (big // 2, big // 4)
    failed = []
    for name, fn in (
            ("k1_f32", lambda: kern.k1(big, "f32", lv)),
            ("k2_f32", lambda: kern.k2(big, "f32")),
            ("k8_f32", lambda: kern.k8(big, big, 8, "f32")),
            ("k10_f32", lambda: kern.k10("f32", *shard, cs.NQ, 1)
             + kern.k10("f32", *shard, cs.R, 2)),
            ("k1s_f32", lambda: kern.k1s(big, "f32", lv[1:])),
            ("k2s_f32", lambda: kern.k2s(*shard, "f32")),
            ("k11_f32", lambda: [kern.k11(big, "f32", i)
                                 for i in (0, 14, 79)]),
            ("k11s_f32", lambda: [kern.k11s(shard, 8, "f32", i)
                                  for i in (0, 14, 79)])):
        t0 = time.perf_counter()
        try:
            cs.emit({"phase": "row", "name": name, "rows": fn(),
                     "s": time.perf_counter() - t0})
        except AssertionError as e:       # a row's gate (chip_smoke.check)
            failed.append(name)
            cs.emit({"phase": "row", "name": name, "error": str(e)})
        torch.cuda.empty_cache()
    s, _, x = cs.run_north1024(torch, kern, smi)
    cs.run_sharded1024(torch, kern, s, x)
    print(f"phases1024: {time.perf_counter() - t_start:.1f} s",
          file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
