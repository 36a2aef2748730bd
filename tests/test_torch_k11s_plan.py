"""K11-S's (and K11's) launch plan and step shapes, pure functions that the
CPU can test (kernels/krylov.py: k11_plan, step_shape, shard_resident,
block_ranges; csrc/krylov.cu's shape_of and the kernel's first lines do the
same arithmetic on the card).

On an H100 (132 SMs, 227 KB of shared memory a block), restart 80, at the
shard shapes of the paths that run K11-S (sharded512, sharded1024 and
sharded64_compat in float32, sharded512 in float64, the (1, 8) mesh's
512^2 shards, the (2, 3) mesh's one shard of the whole field) and at
unequal shards, fused and split:
  * the plan fits a block's shared memory, is cached, and its blocks' ranges
    of whole 128-byte lines cover the shards' vectors;
  * at every step i from 0 to m - 1 the resident share and a stage's chunk
    fit what the plan set aside, the chunks cover the rows, and the resident
    vectors plus the streamed vector blocks cover each shard's n exactly
    once;
  * the launch does not depend on i (the wrapper's arguments at two steps,
    the state never read on the host);
  * the blocks' segments run in (shard, position) order, the order of the
    sums;
  * sharded512's range is whole in shared memory at steps 0 and 1 and not
    at step 2; a field whose block ranges of every row fit (bench's 64^2,
    the 4 x 32^2 shards) takes the lean instance, no ring, on both routes.
  * tools/kernel_ab.py's K11-S variant tables patch the committed source.
No JAX, no card, but for one test marked `cuda`: step_shape against the
kernel's own shape_of (aniso_k11_shape) at every shape and step.
"""

import ctypes

import numpy as np
import pytest
import torch

from aniso_torch.kernels import krylov

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

M = 80
SMS = 132
NQ = 9
SHAPES = {
    "sharded512_f32": ((256 * 128 * NQ,) * 8, 4),
    "sharded1024_f32": ((512 * 256 * NQ,) * 8, 4),
    "sharded64_compat_f32": ((32 * 32 * NQ,) * 4, 4),
    "sharded512_f64": ((256 * 128 * NQ,) * 8, 8),
    "mesh_1x8_512_f32": ((512 * 64 * NQ,) * 8, 4),
    "mesh_2x3_512_f32": ((512 * 512 * NQ,), 4),
    "unequal_f32": ((171 * 512 * NQ, 171 * 512 * NQ, 170 * 512 * NQ), 4),
}


def _ceil_rows(cv, G):
    return krylov._stride_ceil(cv, G)


def plan_of(name, split=False):
    ns, item = SHAPES[name]
    return ns, item, krylov.k11_plan(ns, M, item, 16 // item, SMS, split)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plan_fits_and_covers_the_shards(name, split):
    ns, item, plan = plan_of(name, split)
    assert plan is krylov.k11_plan(ns, M, item, 16 // item, SMS, split)
    assert plan.smem <= krylov.SMEM_BLOCK
    pack = plan.vec * item
    lean = krylov.lean_head_bytes(M)
    if plan.stages == 0:         # the lean instance: every row of a range
        assert lean + (M + 1) * plan.chunk * pack <= krylov.SMEM_BLOCK
        assert plan.smem == lean + (1 if split else M + 1) * plan.chunk * pack
        assert plan.stage_bytes == plan.res_bytes == plan.pool == 0
    else:
        assert lean + (M + 1) * plan.chunk * pack > krylov.SMEM_BLOCK
        assert plan.smem >= (krylov.head_bytes(M)
                             + plan.stages * plan.stage_bytes + plan.res_bytes)
    assert 1 <= plan.blocks <= SMS and plan.chunk % krylov.ALIGN == 0
    total = sum(n // plan.vec for n in ns)
    assert (plan.blocks - 1) * plan.chunk < total <= plan.blocks * plan.chunk
    assert plan.stages <= krylov.MAX_STAGES and plan.stage_bytes % 16 == 0
    assert plan.res_bytes % 16 == 0
    if split:
        assert plan.res_bytes == 0
    if plan.stages:
        assert plan.stages >= 3


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_resident_and_streamed_cover_each_shard_once(name, split):
    ns, item, plan = plan_of(name, split)
    pack = plan.vec * item
    off = np.cumsum([0] + [n // plan.vec for n in ns])
    ranges = krylov.block_ranges(ns, plan)
    threads = krylov.CONSUMER_WARPS * 32
    for i in range(M):
        starts, ends = [], []
        for b, segs in enumerate(ranges):
            cv = sum(length for _, _, length in segs)
            sh = krylov.step_shape(i, cv, pack, plan, not split)
            assert sh.r == krylov.shard_resident(i, plan, item, cv, split)
            if plan.stages == 0:
                # the lean instance: fused, rows 0..i and w of the whole
                # range in shared memory; split, the range read in place
                assert sh.whole == (not split) and sh.nvb == 0
                assert sh.r == (0 if split else cv)
                starts.append(b * plan.chunk)
                ends.append(b * plan.chunk + cv)
                continue
            assert sh.R == i + 1 and 1 <= sh.G <= 32
            assert -(-sh.R // sh.G) <= krylov.RMAX * sh.rounds
            if sh.whole:                       # the range in the pool
                assert sh.r == cv and sh.nvb == 0
                assert (sh.R + 1) * sh.rs * pack <= plan.pool
            else:                              # a share beside the ring
                assert (sh.R + 1) * sh.rs * pack <= plan.res_bytes \
                    or sh.r == 0
                assert plan.stages and \
                    (sh.R + 1) * _ceil_rows(cv, sh.G) * pack > plan.pool \
                    or split
            assert sh.r <= sh.rs
            if split:
                assert sh.r == 0 and not sh.whole
            if sh.whole:
                pass
            elif sh.tile:
                # tiles: every row and w of vb vectors in a stage, rows of
                # BULK_MIN bytes or more
                assert sh.rc == sh.R and sh.nc == 1 and sh.gs == sh.G
                assert (sh.R + 1) * sh.ts * pack <= plan.stage_bytes
                assert sh.vb * pack >= krylov.BULK_MIN and sh.vb <= sh.ts
            else:
                # vector blocks of vb, gs lanes a vector filling the
                # consumer threads; chunks of rc rows (each lane at most
                # RMAX of them) fit a stage; the chunks cover the rows
                assert sh.gs & (sh.gs - 1) == 0 and sh.vb * sh.gs == threads
                assert sh.rc * sh.ts * pack <= plan.stage_bytes
                assert 1 <= sh.rc <= krylov.RMAX * sh.gs
                assert (sh.nc - 1) * sh.rc < sh.R <= sh.nc * sh.rc
                assert sh.gs == 32 or sh.R * sh.vb * pack <= krylov.L2_BLOCK
            # the block-local pieces: [0, r), then nvb vector blocks
            x0 = sh.r + sh.vb * np.arange(sh.nvb)
            nt = np.minimum(sh.vb, cv - x0)
            assert (nt > 0).all()
            assert (x0[1:] == x0[:-1] + nt[:-1]).all()
            assert (x0[-1] + nt[-1] if sh.nvb else sh.r) == cv
            base = b * plan.chunk              # in the concatenation
            pieces = [(0, sh.r)] if sh.r else []
            pieces += list(zip(x0.tolist(), nt.tolist()))
            starts += [base + a for a, _ in pieces]
            ends += [base + a + n for a, n in pieces]
        count = np.zeros(off[-1] + 1, dtype=np.int64)
        np.add.at(count, starts, 1)
        np.add.at(count, ends, -1)
        assert (np.cumsum(count)[:-1] == 1).all(), f"step {i}"


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_block_order_is_shard_order(name):
    """The blocks' segments, in block order, walk each shard's row from 0
    to its end, shard after shard: the blocks' partials summed in block
    order are summed in (shard, position) order."""
    ns, item, plan = plan_of(name)
    walk = [seg for segs in krylov.block_ranges(ns, plan) for seg in segs]
    s_prev, end = 0, 0
    for s, first, length in walk:
        if s != s_prev:
            assert s == s_prev + 1 and end == ns[s_prev] // plan.vec
            s_prev, end = s, 0
        assert first == end and length > 0
        end = first + length
    assert s_prev == len(ns) - 1 and end == ns[-1] // plan.vec


def test_sharded512_is_whole_at_steps_0_and_1_only():
    """sharded512 in float32: a block's range (4472 vectors) and w fit its
    shared memory whole at steps 0 and 1 (no ring then) and not at step 2,
    where a share stays beside a ring of 3 stages; bench's 64^2 field (K11)
    and sharded64_compat's shards (both routes) take the lean instance."""
    ns, item, plan = plan_of("sharded512_f32")
    assert plan.stages == 3 and plan.chunk == 4472
    for i in (0, 1):
        assert krylov.step_shape(i, plan.chunk, 16, plan).whole
        assert krylov.shard_resident(i, plan, item) == plan.chunk
    assert not krylov.step_shape(2, plan.chunk, 16, plan).whole
    assert 0 < krylov.shard_resident(2, plan, item) < plan.chunk
    assert all(krylov.shard_resident(i, plan, item)
               >= krylov.shard_resident(i + 1, plan, item) for i in range(M - 1))
    bench = krylov.k11_plan((64 * 64 * NQ,), M, 4, 4, SMS)
    assert bench.stages == 0 and bench.smem <= krylov.SMEM_BLOCK
    for split in (False, True):
        assert plan_of("sharded64_compat_f32", split)[2].stages == 0
    big = krylov.k11_plan((512 * 256 * NQ,) * 8, M, 4, 4, SMS)
    assert big.stages == krylov.STAGES and big.stage_bytes == krylov.STAGE_MAX
    assert 0 < krylov.shard_resident(0, big, 4) < big.chunk


@pytest.mark.parametrize("split", [False, True])
def test_launch_does_not_depend_on_the_step(monkeypatch, split):
    """The wrapper's arguments to the kernel at steps 0 and 50 are the same
    (the table, the plan, the scratch's length; pointers aside), and the
    state is never read on the host: one captured graph serves every
    step."""
    calls = []

    def fake_load(source, symbol, argtypes):
        def fn(*args):
            calls.append([a.value if isinstance(a, ctypes.c_void_p) else a
                          for a in args])
            return 0
        return fn

    monkeypatch.setattr(krylov._cuda, "load", fake_load)
    monkeypatch.setattr(krylov._cuda, "check_all", lambda *a: None)
    monkeypatch.setattr(krylov._cuda, "stream", lambda d: ctypes.c_void_p(0))
    monkeypatch.setattr(krylov, "_num_sms", lambda index: SMS)
    n, shards = 32 * 32 * NQ, 4
    V = [torch.zeros(M + 1, n) for _ in range(shards)]
    w = [torch.zeros(n) for _ in range(shards)]
    u = [torch.zeros(n) for _ in range(shards)]
    seen = []
    for i in (0, 50):
        st = torch.zeros(krylov.state_layout(M).len, dtype=torch.float64)
        st[krylov.I] = i
        with monkeypatch.context() as mp:
            mp.setattr(torch.Tensor, "tolist", _no_host_read)
            mp.setattr(torch.Tensor, "item", _no_host_read)
            run = krylov._shard_launch(V, w, u, st, M, split=split,
                                       givens=True)
            for phase in (range(4) if split else (krylov.FUSED,)):
                run(phase)
        # the pointer arguments (table, state, scratch, sums, stream) aside
        seen.append([[a for k, a in enumerate(c) if k not in (0, 2, 3, 5, 16)]
                     for c in calls])
        calls.clear()
    assert seen[0] == seen[1] and len(seen[0]) == (4 if split else 1)


def _no_host_read(*args, **kwargs):
    raise AssertionError("K11-S's launch read a tensor on the host")


@pytest.mark.cuda
def test_step_shape_is_the_kernels_shape_of_on_card():
    """kernels/krylov.py:step_shape against csrc/krylov.cu:shape_of (through
    aniso_k11_shape, built from the same source as the kernel) field by
    field, at every shape of SHAPES with a ring, fused and split, for a
    whole chunk and the last block's range, at every step: the CPU tests
    above hold what the kernel does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fn = krylov._cuda.load(krylov.SOURCE, "aniso_k11_shape",
                           (ctypes.c_int, ctypes.c_longlong)
                           + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))
    out = (ctypes.c_longlong * 13)()
    checked = 0
    for name in sorted(SHAPES):
        for split in (False, True):
            ns, item, plan = plan_of(name, split)
            if plan.stages == 0:
                continue
            pack = plan.vec * item
            total = sum(n // plan.vec for n in ns)
            for cv in {plan.chunk, total - (plan.blocks - 1) * plan.chunk}:
                for i in range(M):
                    assert fn(i, cv, pack, plan.stages, plan.stage_bytes,
                              plan.res_bytes, plan.pool, int(not split),
                              ctypes.cast(out, ctypes.c_void_p)) == 0
                    want = krylov.step_shape(i, cv, pack, plan, not split)
                    assert list(out) == [int(x) for x in want], \
                        (name, split, cv, i)
                    checked += 1
    assert checked


@pytest.mark.parametrize("table", ["k11s", "k11s_probe"])
def test_k11s_variants_patch_the_committed_source(table, tmp_path):
    """tools/kernel_ab.py's K11-S tables (the vector block's L2 budget and
    the ring's stages; the K11_PROBE build of the probe's phases): every
    patch finds its text in the committed file exactly once and changes
    the copy, and chip_smoke.py stays as it is."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "kernel_ab", os.path.join(root, "tools", "kernel_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    groups, variants = ab.VARIANTS[table]
    assert all(any(g.startswith(p) for g in ab.GROUPS) for p in groups)
    for name, patches in variants.items():
        d = ab.patched_tree(root, str(tmp_path), name, patches)
        for rel in {rel for rel, _, _ in patches}:
            with open(os.path.join(root, rel)) as f, \
                    open(os.path.join(d, rel)) as g:
                assert f.read() != g.read(), (name, rel)
        with open(os.path.join(root, "chip_smoke.py")) as f, \
                open(os.path.join(d, "chip_smoke.py")) as g:
            assert f.read() == g.read()
