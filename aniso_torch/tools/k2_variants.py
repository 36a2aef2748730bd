"""K2's launch choices, A/B on one card: the committed near_contract.cu
against copies of it that each change one choice, at the shapes the
solver's paths give K2.

    python3 aniso_torch/tools/k2_variants.py \
        [--out chiprun_out/k2_variants.jsonl]

Each variant is the committed source with one textual patch (listed in
VARIANTS; a patch whose text is missing fails the run), built with the
port's nvcc flags into aniso_torch/_build/k2_variants/<name>/, all builds
in parallel.  Per shape the inputs are made once on the card (the seeds of
chip_smoke.Kernels.k2 / k2s), every variant is held against the plain
version (chip_smoke.TOL_KERNEL) and timed as chip_smoke times a kernel
(median CUDA-event device time, cold L2).  The committed source runs first
and last ("base", "base_again"): their gap is the noise of the run.  One
JSON object a line on stdout (and in --out); the card's name and power
limit first.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

SOURCE = "near_contract.cu"

# name -> [(text in the committed source, its replacement)]
VARIANTS = {
    # the ring three stages deep for every D, or two (committed: three for
    # one mode, two for several)
    "ring_3_stages": [("return DC == 1 ? 3 : 2;", "return 3;")],
    "ring_2_stages": [("return DC == 1 ? 3 : 2;", "return 2;")],
    # a TMA bulk prefetch of the next tile's E into L2 (none committed)
    "l2_prefetch": [
        ("__device__ __forceinline__ void cp_async_commit() {",
         "__device__ __forceinline__ void prefetch_l2(const void* src,\n"
         "                                            unsigned size) {\n"
         '    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n"\n'
         '                 :: "l"(src), "r"(size) : "memory");\n'
         "}\n\n"
         "__device__ __forceinline__ void cp_async_commit() {"),
        ("    for (int s = 0; s < kStages - 1; ++s) {",
         "    const size_t tile_elems = (size_t)NS * P.nq * P.K;\n"
         "    auto prefetch_tile = [&](int tl2) {\n"
         "        if (threadIdx.x == 0 && tl2 < P.tiles) {\n"
         "            const size_t from = (size_t)tl2 * tile_elems;\n"
         "            const size_t n = min(tile_elems, P.nE - from)\n"
         "                * sizeof(T) / 16;\n"
         "            prefetch_l2(E + from, (unsigned)(n * 16));\n"
         "        }\n"
         "    };\n"
         "    prefetch_tile(blockIdx.x);\n"
         "    prefetch_tile(blockIdx.x + gridDim.x);\n"
         "    for (int s = 0; s < kStages - 1; ++s) {"),
        ("        const int c = s % P.nchunks;\n",
         "        const int c = s % P.nchunks;\n"
         "        if (c == 0 && s > 0) {\n"
         "            prefetch_tile(tile + gridDim.x);\n"
         "        }\n")],
    # plan_score without its penalty on a split of the target rows
    "no_row_split_penalty": [("- 8.0 * (ns - 1)", "- 0.0 * (ns - 1)")],
    # runs of 32 bytes allowed (64 the committed floor)
    "runs_from_32_bytes": [("(slot_bytes < 64 ? 1000.0",
                            "(slot_bytes < 32 ? 1000.0")],
    # no cap of NG at the groups that fill every SM with a tile
    "no_fill_cap": [("if (NG > 1 && NG > ngfill) {", "if (false) {")],
    # at most 32 resident warps an SM counted (none committed: 64 at most)
    "warps_up_to_32": [("return warps - 8.0",
                        "return (warps < 32 ? warps : 32) - 8.0")],
    # ties to the longer runs (committed: to the shorter)
    "longer_runs": [("SLOT * (int)sizeof(T));",
                     "SLOT * (int)sizeof(T)) + 0.01 * SLOT;")],
}
# the four choices before the A/B at once: three stages for every D, the
# L2 prefetch, 32 warps counted, ties to the longer runs
VARIANTS["before_ab"] = [p for name in ("ring_3_stages", "l2_prefetch",
                                        "warps_up_to_32", "longer_runs")
                         for p in VARIANTS[name]]

# (label, grid (lx, ly), nq, D or None for the one-mode tables, instance,
#  shard): the shapes of chip_smoke.py's K2 rows
SHAPES = [
    ("bench64 one mode", (64, 64), 9, None, "f32", False),
    ("refined512 one mode", (512, 512), 9, None, "f32", False),
    ("refined512 twin one mode", (512, 512), 9, None, "f64", False),
    ("mm512 D 9", (512, 512), 9, 9, "f32", False),
    ("mm512 twin D 9", (512, 512), 9, 9, "f64", False),
    ("demo128 D 9", (128, 128), 1, 9, "f32", False),
    ("dsa64 N 1", (64, 64), 4, None, "f64", False),
    ("dsa64 N 3 D 5", (64, 64), 4, 5, "f64", False),
    ("sharded512 shard", (256, 128), 9, None, "f32", True),
]


def variant_sources(csrc, out_dir):
    """{name: directory holding its near_contract.cu}, base included."""
    with open(os.path.join(csrc, SOURCE)) as f:
        base = f.read()
    dirs = {}
    for name, patches in [("base", [])] + list(VARIANTS.items()):
        text = base
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in "
                                   f"{SOURCE} exactly once")
            text = text.replace(old, new)
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, SOURCE), "w") as f:
            f.write(text)
        dirs[name] = d
    return dirs


def build(d, nvcc, flags):
    src = os.path.join(d, SOURCE)
    lib = os.path.join(d, "lib" + os.path.splitext(SOURCE)[0] + ".so")
    proc = subprocess.run([nvcc, *flags, "-o", lib, src], capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{proc.stderr}")
    with open(lib + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    return lib


def inputs(kern, grid, nq, D, inst, shard):
    """chip_smoke.Kernels.k2's (or k2s's) inputs, Duffy term off."""
    lx, ly = grid
    lead = (D,) if D else ()
    seed = 3000 + lx if shard else lx
    E = kern.rand((lx, ly, nq, 3, 3, nq), inst, 0.0, 0.5, seed=seed)
    ushape = (lx + 2, ly + 2, nq) if shard else (lx, ly, nq)
    cosrw, S, u, sigma_w = (
        kern.rand(shape, inst, normal=True, seed=seed + k)
        for k, shape in enumerate((lead + (nq, 3, 3, nq),
                                   lead + (nq, 3, 3, nq), ushape,
                                   (lx, ly, nq)), 1))
    return E, cosrw, S, u, sigma_w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "k2_variants.jsonl"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("k2_variants: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from aniso_torch import _build
    from aniso_torch.kernels import _cuda, near

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    sink = open(args.out, "w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    emit({"card": smi, "torch": torch.__version__})
    out_dir = os.path.join(_build.BUILD_DIR, "k2_variants")
    dirs = variant_sources(_build.CSRC, out_dir)
    nvcc = _build.nvcc_path()
    with ThreadPoolExecutor(max_workers=len(dirs)) as ex:
        libs = dict(zip(dirs, ex.map(lambda d: build(d, nvcc,
                                                     _build.NVCC_FLAGS),
                                     dirs.values())))
    emit({"built": list(libs)})
    order = ["base"] + list(VARIANTS) + ["base_again"]

    def use(name):
        # near.py loads csrc/near_contract.cu through _build: point both
        # at the variant's directory (its library is newer than its source)
        d = dirs["base" if name == "base_again" else name]
        _build.CSRC = _build.BUILD_DIR = d
        _cuda.load.cache_clear()

    scratch = torch.empty(96 * 1024 * 1024 // 4, device="cuda")
    kern = cs.Kernels(torch, scratch.zero_)
    for label, grid, nq, D, inst, shard in SHAPES:
        E, cosrw, S, u, sigma_w = inputs(kern, grid, nq, D, inst, shard)
        fn = near.near_contract_shard if shard else near.near_contract
        plain = (near.near_contract_shard_plain if shard
                 else near.near_contract_plain)
        want = plain(E, cosrw, S, u, sigma_w)
        scale = float(want.abs().max())
        item = E.element_size()
        nd = D or 1
        nbytes = item * (E.numel() + cosrw.numel() + S.numel() + u.numel()
                         + (1 + nd) * sigma_w.numel())
        bms, _ = cs.bound_ms(nbytes, (1 + 3 * nd) * E.numel(), inst)
        row = {"shape": label, "grid": list(grid), "nq": nq, "D": D,
               "inst": inst, "shard": shard, "bound_ms": bms}
        for name in order:
            use(name)
            got = fn(E, cosrw, S, u, sigma_w)
            err = float((got - want).abs().max())
            cs.check(err <= cs.TOL_KERNEL[inst] * scale,
                     f"{name} {label}: max err {err} > "
                     f"{cs.TOL_KERNEL[inst]} x {scale}")
            del got
            row[name] = cs.event_ms(torch, lambda: fn(E, cosrw, S, u,
                                                      sigma_w),
                                    reps=21, flush=kern.flush)
        emit(row)
        del E, cosrw, S, u, sigma_w, want
        torch.cuda.empty_cache()
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
