"""A/B of the port's hand kernels on one card: chip_smoke.py's kernel rows
(each kernel held against its plain version, then timed: median CUDA-event
device time, cold L2) for several trees in one call.

    python3 tools/kernel_ab.py [--root DIR ...] \\
        [--variants k1|k2|k8|k9|k10|k11s|k11s_probe] [--only PREFIX,...] \\
        [--out FILE]

The trees are each --root (default: this checkout; another one is, say, a
parent commit unpacked with `git archive` into a gitignored directory),
then, with --variants, copies of the first root that each change one
choice by a textual patch (VARIANTS; a patch whose text is not in its file
exactly once fails the run), then the first root again: its two runs
bracket the others, and their gap is the run's noise.  Every tree's
libraries are built first, all in parallel; the rows of each tree then run
in a process of their own, one tree after another.  --only keeps the row
groups (GROUPS) whose names start with one of its prefixes (default: the
variant table's own groups, or every group).  One JSON object a line on
stdout and in --out: the card's name and power limit first, then each
tree's rows and per-group totals, tagged, then a summary of the totals.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M2L_PY = "aniso_torch/kernels/m2l.py"
NEAR_CU = "aniso_torch/csrc/near_contract.cu"
HALO_CU = "aniso_torch/csrc/halo_fill.cu"
TRANSFER_PY = "aniso_torch/kernels/transfer.py"
TRANSFER_CU = "aniso_torch/csrc/transfer.cu"
PCG_PY = "aniso_torch/kernels/pcg.py"
KRYLOV_PY = "aniso_torch/kernels/krylov.py"
KRYLOV_CU = "aniso_torch/csrc/krylov.cu"

# group -> (source it launches, rows from (chip_smoke.Kernels, chip_smoke)):
# the shapes of the paths that launch each kernel
GROUPS = {
    # K1: refined512's sweep, bench 64^2, the twin's coarse levels,
    # f64_64, the np6 phase (32^2: every level in f32, the twin's coarse
    # ones in f64), rows off 16 bytes (np 3 and 5 at 64^2)
    "k1_f32_512": ("m2l_translate.cu",
                   lambda k, cs: k.k1(512, "f32", list(range(2, 10)))),
    "k1_f32_64": ("m2l_translate.cu",
                  lambda k, cs: k.k1(64, "f32", list(range(2, 7)))),
    "k1_f64_512": ("m2l_translate.cu",
                   lambda k, cs: k.k1(512, "f64", list(range(2, 8)))),
    "k1_f64_64": ("m2l_translate.cu",
                  lambda k, cs: k.k1(64, "f64", list(range(2, 7)))),
    "k1_f32_np6": ("m2l_translate.cu",
                   lambda k, cs: k.k1(32, "f32", [2, 3, 4, 5], np_cheb=6)),
    "k1_f64_np6": ("m2l_translate.cu",
                   lambda k, cs: k.k1(32, "f64", [2, 3], np_cheb=6)),
    "k1_odd_np": ("m2l_translate.cu",
                  lambda k, cs: [dict(row, inst=inst, np_cheb=n)
                                 for n in (3, 5) for inst in ("f32", "f64")
                                 for row in k.k1(64, inst, list(range(2, 7)),
                                                 np_cheb=n)]),
    # K1-S: one sharded512 shard (2 x 4 mesh) at levels 3-9
    "k1s_f32": ("m2l_translate.cu",
                lambda k, cs: k.k1s(512, "f32", list(range(3, 10)))),
    "k1s_f64": ("m2l_translate.cu",
                lambda k, cs: k.k1s(512, "f64", list(range(3, 10)))),
    # K2: bench 64^2, refined512 and its twin, mm512 (D 9) and its twin,
    # demo128 (deg 1, D 9), dsa64 (deg 2: N 1, and N 3 at D 5), a
    # sharded512 shard
    "k2_f32_64": ("near_contract.cu", lambda k, cs: k.k2(64, "f32")),
    "k2_f32_512": ("near_contract.cu", lambda k, cs: k.k2(512, "f32")),
    "k2_f64_512": ("near_contract.cu", lambda k, cs: k.k2(512, "f64")),
    "k2d_f32_512": ("near_contract.cu",
                    lambda k, cs: k.k2(512, "f32", D=9)),
    "k2d_f64_512": ("near_contract.cu",
                    lambda k, cs: k.k2(512, "f64", D=9)),
    "k2d_f32_128": ("near_contract.cu",
                    lambda k, cs: k.k2(128, "f32", D=9, nq=1)),
    "k2_f64_dsa64": ("near_contract.cu",
                     lambda k, cs: k.k2(64, "f64", nq=4)),
    "k2d_f64_dsa64": ("near_contract.cu",
                      lambda k, cs: k.k2(64, "f64", D=5, nq=4)),
    "k2s_f32": ("near_contract.cu", lambda k, cs: k.k2s(256, 128, "f32")),
    # K8: bench 64^2 (f32), 512^2 (f32; f64, the twin's), mm512's D = 9
    # and a sharded512 shard (256 x 128), each level above the leaf to 2
    "k8_f32_64": ("transfer.cu", lambda k, cs: k.k8(64, 64, 4, "f32")),
    "k8_f32_512": ("transfer.cu", lambda k, cs: k.k8(512, 512, 7, "f32")),
    "k8_f64_512": ("transfer.cu", lambda k, cs: k.k8(512, 512, 7, "f64")),
    "k8d_f32_512": ("transfer.cu",
                    lambda k, cs: k.k8(512, 512, 7, "f32", D=9)),
    "k8d_f64_512": ("transfer.cu",
                    lambda k, cs: k.k8(512, 512, 7, "f64", D=9)),
    "k8s_f32": ("transfer.cu", lambda k, cs: k.k8(256, 128, 7, "f32")),
    # K11: GMRES's CGS2 at restart 80, steps 0, 14 and 79, on the one-mode
    # fields of bench / f64_64 (64^2, deg 3) and of refined512 / its twin
    # (512^2)
    **{f"k11_{inst}_{sz}": (
        "krylov.cu", lambda k, cs, sz=sz, inst=inst: [
            dict(k.k11(sz, inst, i), step=i) for i in (0, 14, 79)])
       for inst in ("f32", "f64") for sz in (64, 512)},
    # K11-S: the sharded step (CGS2 with the Givens epilogue) at the shards
    # of sharded512 (8 of 256 x 128; f32 at steps 0, 1, 2, 14 and 79, where
    # step 1 is the last to hold a block's whole range in shared memory and
    # step 2 the first to keep a share, and f64 at 14), sharded1024 (8 of
    # 512 x 256) and sharded64_compat (4 of 32 x 32, the fused and the
    # split route)
    "k11s_f32_512": ("krylov.cu", lambda k, cs: [
        dict(k.k11s((256, 128), 8, "f32", i), step=i)
        for i in (0, 1, 2, 14, 79)]),
    "k11s_f64_512": ("krylov.cu", lambda k, cs: [
        dict(k.k11s((256, 128), 8, "f64", 14), step=14)]),
    "k11s_f32_1024": ("krylov.cu", lambda k, cs: [
        dict(k.k11s((512, 256), 8, "f32", i), step=i) for i in (0, 14, 79)]),
    "k11s_f32_64": ("krylov.cu", lambda k, cs: [
        dict(k.k11s((32, 32), 4, "f32", 14, split=split), step=14)
        for split in (False, True)]),
    # K11-S's fixed cost, the empty step (tools/k11s_probe.py), at the
    # shards of sharded512 and sharded1024
    "k11s_floor": ("krylov.cu", lambda k, cs: [
        dict(row, step=i) for shard in ((256, 128), (512, 256))
        for i in (0, 14, 79)
        for row in _probe().floor(k, cs, shard, 8, i)]),
    # pass (a)'s copies alone (the ring's floor; a K11_PROBE build of a
    # tree of the ring design: --variants k11s_probe)
    "k11s_stream": ("krylov.cu", lambda k, cs: [
        dict(row, step=i) for shard in ((256, 128), (512, 256))
        for i in (0, 14, 79)
        for row in _probe().stream(k, cs, shard, 8, i)]),
    # one fused step traced (and the empty step at sharded512's shards):
    # the median block's time at each mark (a K11_PROBE build, as above)
    "k11s_trace": ("krylov.cu", lambda k, cs: [
        dict(row, step=i) for shard, empty in (((256, 128), False),
                                               ((512, 256), False),
                                               ((256, 128), True),
                                               ((32, 32), False))
        for i in (0, 14, 79)
        for row in _probe().trace(k, cs, shard, 8, i, empty=empty)]),
    # K11 alone, 20 launches replayed from one graph, caches warm (the
    # other rows flush L2 before each sample), on bench's 64^2 field and
    # at 512^2
    "k11_warm": ("krylov.cu", lambda k, cs: [
        dict(row, step=i, sz=sz) for sz, steps in ((64, (0, 14, 79)),
                                                   (512, (0, 14)))
        for i in steps for row in _probe().warm(k, cs, sz, i)]),
    # K11 on the 1024^2 field on its own 132 blocks and on K11-S's
    # partition of 8 shards (128 blocks)
    "k11_partition": ("krylov.cu", lambda k, cs: [
        dict(row, step=i) for i in (0, 14, 79) for sms in (132, 128)
        for row in _probe().partition(k, cs, 1024, i, sms)]),
    # K9: one DSA preconditioner call at the grids and dtypes of dsa64
    # (64^2 f64), demo128 (128^2 f32) and dsa512 (512^2 f32), and between
    # them, where kernels/pcg.py's plan chooses between its instances; each
    # row names the instance its tree's plan took (the parent has one)
    **{f"k9_{inst}_{sz}": ("pcg.cu",
                           lambda k, cs, sz=sz, inst=inst: k.k9(sz, inst))
       for sz, inst in ((64, "f64"), (128, "f32"), (512, "f32"),
                        (64, "f32"), (128, "f64"), (256, "f32"),
                        (256, "f64"))},
    # K12 at restart 80, steps 0, 14 and 79: the Givens step alone and the
    # back-substitution of the steps it leaves (with
    # torch.linalg.solve_triangular beside it where the tree times it)
    "k12": ("krylov.cu",
            lambda k, cs: [dict(k.k12(i), step=i) for i in (0, 14, 79)]),
    # K10: sharded512's u (w 1) and leaf M (w 2) exchanges, 8 shards
    "k10_f32": ("halo_fill.cu",
                lambda k, cs: (k.k10("f32", 256, 128, cs.NQ, 1)
                               + k.k10("f32", 256, 128, cs.R, 2))),
    "k10_f64": ("halo_fill.cu",
                lambda k, cs: (k.k10("f64", 256, 128, cs.NQ, 1)
                               + k.k10("f64", 256, 128, cs.R, 2))),
}

# table -> (its groups, {variant: [(file in the tree, text, replacement)]})
VARIANTS = {
    "k1": (("k1_", "k1s_"), {
        # one plan choice at a time (kernels/m2l.py's constants)
        "stage_8kb": [(M2L_PY, "STAGE_BYTES = 32768", "STAGE_BYTES = 8192")],
        "stage_16kb": [(M2L_PY, "STAGE_BYTES = 32768",
                        "STAGE_BYTES = 16384")],
        "stage_64kb": [(M2L_PY, "STAGE_BYTES = 32768",
                        "STAGE_BYTES = 65536")],
        "min_blocks_64": [(M2L_PY, "MIN_BLOCKS = 128", "MIN_BLOCKS = 64")],
        "min_blocks_256": [(M2L_PY, "MIN_BLOCKS = 128", "MIN_BLOCKS = 256")],
        "consumers_4": [(M2L_PY, "MAX_CONSUMERS = 8", "MAX_CONSUMERS = 4")],
        "stages_3_at_most": [(M2L_PY, "STAGES = (4, 3, 2)",
                              "STAGES = (3, 2)")],
        "stages_2": [(M2L_PY, "STAGES = (4, 3, 2)", "STAGES = (2,)")],
    }),
    "k2": (("k2",), {
        # the ring three stages deep for every D, or two (committed: three
        # for one mode, two for several)
        "ring_3_stages": [(NEAR_CU, "return DC == 1 ? 3 : 2;", "return 3;")],
        "ring_2_stages": [(NEAR_CU, "return DC == 1 ? 3 : 2;", "return 2;")],
        # plan_score without its penalty on a split of the target rows
        "no_row_split_penalty": [(NEAR_CU, "- 8.0 * (ns - 1)",
                                  "- 0.0 * (ns - 1)")],
        # runs of 32 bytes allowed (64 the committed floor)
        "runs_from_32_bytes": [(NEAR_CU, "(slot_bytes < 64 ? 1000.0",
                                "(slot_bytes < 32 ? 1000.0")],
        # no cap of NG at the groups that fill every SM with a tile
        "no_fill_cap": [(NEAR_CU, "if (NG > 1 && NG > ngfill) {",
                         "if (false) {")],
        # at most 32 resident warps an SM counted (none committed)
        "warps_up_to_32": [(NEAR_CU, "return warps - 8.0",
                            "return (warps < 32 ? warps : 32) - 8.0")],
        # ties to the longer runs (committed: to the shorter)
        "longer_runs": [(NEAR_CU, "SLOT * (int)sizeof(T));",
                         "SLOT * (int)sizeof(T)) + 0.01 * SLOT;")],
    }),
    "k8": (("k8",), {
        # the most levels a block's tile spans (committed: 3, 8 x 8 leaf
        # boxes), 2 or 4
        "max_t_2": [(TRANSFER_PY, "MAX_T = 3 ", "MAX_T = 2 ")],
        "max_t_4": [(TRANSFER_PY, "MAX_T = 3 ", "MAX_T = 4 "),
                    (TRANSFER_CU, "constexpr int kMaxT = 3;",
                     "constexpr int kMaxT = 4;")],
    }),
    "k9": (("k9_",), {
        # the grid instance at every size (committed: one cluster up to
        # CLUSTER_MAX_SZ), and the cluster wherever it holds the grid
        "grid_only": [(PCG_PY, "if sz <= CLUSTER_MAX_SZ else ()",
                       "if False else ()")],
        "cluster_wherever_it_fits": [(PCG_PY, "if sz <= CLUSTER_MAX_SZ "
                                      "else ()", "if True else ()")],
    }),
    "k11s": (("k11s_f32_512", "k11s_f32_1024", "k11s_f32_64",
              "k11s_floor", "k11s_stream", "k11_f32_64", "k11_f32_512"), {
        # a vector block's rows at most 160 KB (committed: 320 KB):
        # narrower blocks at many rows, (b)'s second sweep more often in L2
        "l2_block_160k": [(KRYLOV_CU, "constexpr int kL2Block = 320 * 1024;",
                           "constexpr int kL2Block = 160 * 1024;")],
        # a ring of 4 stages of 32 KB (committed: 3 of 64 KB)
        "ring_4x32k": [(KRYLOV_PY, "STAGE_MAX = 65536 ", "STAGE_MAX = 32768 "),
                       (KRYLOV_PY, "STAGES = 3 ", "STAGES = 4 ")],
    }),
    # the measurement-only phases of the ring kernel (the copies alone, a
    # traced step), compiled in a copy of the tree with K11_PROBE set
    "k11s_probe": (("k11s_stream", "k11s_trace"), {
        "probe": [(KRYLOV_CU, "#define K11_PROBE 0", "#define K11_PROBE 1")],
    }),
    "k10": (("k10",), {
        # an interior run's warps: half as many (one for each 4 x 32 x
        # kUnroll values), or twice as many (committed: 2 x 32 x kUnroll)
        "half_the_warps": [(HALO_CU, "(len + 2 * 32 * kUnroll - 1) / "
                            "(2 * 32 * kUnroll)", "(len + 4 * 32 * kUnroll "
                            "- 1) / (4 * 32 * kUnroll)")],
        "twice_the_warps": [(HALO_CU, "(len + 2 * 32 * kUnroll - 1) / "
                             "(2 * 32 * kUnroll)", "(len + 32 * kUnroll - 1)"
                             " / (32 * kUnroll)")],
        # 4 words in flight a lane (committed: 8)
        "unroll_4": [(HALO_CU, "constexpr int kUnroll = 8;",
                      "constexpr int kUnroll = 4;")],
    }),
}


def _probe():
    """tools/k11s_probe.py of this checkout (it serves both designs)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import k11s_probe
    return k11s_probe


def patched_tree(root, out_dir, name, patches):
    """A copy of root's package and chip_smoke.py in out_dir/name with
    the patches applied; returns its directory."""
    d = os.path.join(out_dir, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(os.path.join(root, "aniso_torch"),
                    os.path.join(d, "aniso_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(root, "chip_smoke.py"), d)
    for rel, old, new in patches:
        path = os.path.join(d, rel)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {rel} "
                               f"exactly once")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return d


def build(root, sources):
    """Build the tree's libraries of `sources` in a process of its own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from aniso_torch import _build; _build.build(sys.argv[2:])")
    proc = subprocess.run([sys.executable, "-c", code, root, *sources],
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"building {root} failed:\n{proc.stderr}")


def rows(root, tag, groups):
    """The groups' rows of the tree at root, in this process: one JSON
    line each, then the group's total."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as cs
    import aniso_torch

    for mod in (cs, aniso_torch):       # the tree's own, not an installed one
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{mod.__name__} is {mod.__file__}, not "
                               f"from {root}")
    scratch = torch.empty(96 * 1024 * 1024 // 4, device="cuda")
    k = cs.Kernels(torch, scratch.zero_)
    for name in groups:
        out = GROUPS[name][1](k, cs)
        if not out:                   # a probe this tree's design lacks
            continue
        for row in out:
            print(json.dumps({"tag": tag, "group": name, **row}), flush=True)
        print(json.dumps({"tag": tag, "group": name,
                          "total": cs.Kernels.total(out)}), flush=True)
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--variants", choices=sorted(VARIANTS), default=None)
    ap.add_argument("--only", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rows", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    roots = [os.path.abspath(r) for r in (args.root or [HERE])]
    own, variants = VARIANTS.get(args.variants, ((), {}))
    only = tuple(p for p in args.only.split(",") if p) or own
    groups = [g for g in GROUPS if not only or g.startswith(only)]
    if args.rows is not None:         # one tree's rows, in its own process
        rows(roots[0], args.rows, groups)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    sink = open(args.out, "w") if args.out else None

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    emit({"card": smi, "torch": torch.__version__})
    trees = [(os.path.relpath(r, HERE), r) for r in roots]
    out_dir = os.path.join(roots[0], "aniso_torch", "_build", "ab")
    trees += [(name, patched_tree(roots[0], out_dir, name, patches))
              for name, patches in variants.items()]
    sources = sorted({GROUPS[g][0] for g in groups})
    with ThreadPoolExecutor(max_workers=len(trees)) as ex:
        list(ex.map(lambda t: build(t[1], sources), trees))
    emit({"built": [tag for tag, _ in trees], "sources": sources})
    totals = {}
    for tag, root in trees + [(trees[0][0] + " again", trees[0][1])]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", root,
             "--rows", tag, "--only", ",".join(groups)],
            capture_output=True, text=True, timeout=1800)
        for line in proc.stdout.splitlines():
            obj = json.loads(line)
            emit(obj)
            if "total" in obj:
                totals.setdefault(obj["group"], {})[tag] = obj["total"]["ms"]
        if proc.returncode != 0:
            emit({"tag": tag, "failed": proc.returncode,
                  "stderr": proc.stderr[-4000:]})
            return 1
    emit({"summary_ms": totals})
    return 0


if __name__ == "__main__":
    sys.exit(main())
