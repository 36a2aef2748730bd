"""K1's one-mode plan (kernels/m2l.py:plan_one), on the CPU.

The kernel cuts a level by the plan alone, so the plan is held here to
what the kernel needs: every (class, box, target row) and every value of a
row is computed exactly once, the shared memory fits a block, and every
bulk copy the kernel issues (the table rows, each box's run of E, the
source rows of M) starts on 16 bytes, is a multiple of 16 bytes, lies
inside its tensor and fits its place in shared memory.  The copies'
addresses below are the kernel's own index arithmetic
(csrc/m2l_translate.cu: m2l_translate_one_kernel, span16), on tensors that
start on 16 bytes, as the wrapper requires.
"""

import numpy as np
import pytest

from aniso_torch.fmm.apply import parity_shift_table_np
from aniso_torch.kernels import m2l

SHIFT = parity_shift_table_np()


def _check_spans(start, nbytes, total, room, what):
    """span16 of runs of nbytes at byte offsets start: the aligned
    covering spans lie in [0, total) and fit `room` bytes."""
    lo = start // 16 * 16
    size = -(-(start + nbytes) // 16) * 16 - lo
    assert np.all(size > 0) and np.all(size % 16 == 0), what
    assert np.all(lo >= 0) and np.all(lo + size <= total), what
    assert np.all(size <= room), what


def _check_fields(p, nb, r, item):
    """The kernel's own checks of a plan (launch_one) and the launch
    limits."""
    row = 27 * r
    lay = m2l.smem_layout(r, p.G, p.S, p.nq, p.nchunk, item)
    assert p.smem == lay["total"] <= m2l.SMEM_BLOCK
    assert 1 <= p.G <= r and p.ng == -(-r // p.G)
    assert p.nq % p.vw == 0 and p.nchunk == -(-row // p.nq)
    assert p.nchunk == 1 or (p.G == 1 and p.NGRP == 1)
    assert p.per * (p.nsplit - 1) < nb <= p.per * p.nsplit
    assert 1 <= p.WG <= p.G and p.WG * p.NGRP <= 8
    assert p.S % p.NGRP == 0       # each stage read by one group
    assert p.threads == 32 * (1 + p.WG * p.NGRP)
    assert p.grid == 4 * p.ng * p.nsplit
    return lay


def _check_plan(m2x, m2y, np_cheb, item, ext):
    r = np_cheb * np_cheb
    row = 27 * r
    nb = m2x * m2y
    p = m2l.plan_one(m2x, m2y, r, item)
    lay = _check_fields(p, nb, r, item)
    # a coarse level still spreads where its rows allow
    assert 4 * nb * p.ng >= min(m2l.MIN_BLOCKS, 4 * nb * r)

    # the blocks (class, row group, split) and their boxes and rows
    blk = np.arange(p.grid)
    split, cg = blk % p.nsplit, blk // p.nsplit
    c, a0 = cg // p.ng, (cg % p.ng) * p.G
    Gg = np.minimum(p.G, r - a0)
    b0 = split * p.per
    b1 = np.minimum(b0 + p.per, nb)
    # every (class, box, row) exactly once: +1 at b0, -1 at b1 for each of
    # a block's rows, summed along the boxes
    diff = np.zeros((4, r, nb + 1), np.int32)
    rows = np.concatenate([np.arange(a, a + g) for a, g in zip(a0, Gg)])
    blk_of_row = np.repeat(blk, Gg)
    np.add.at(diff, (c[blk_of_row], rows, b0[blk_of_row]), 1)
    np.add.at(diff, (c[blk_of_row], rows, b1[blk_of_row]), -1)
    assert np.all(np.cumsum(diff, axis=2)[:, :, :nb] == 1)
    # every value of a row once: chunks of nq values tile [0, 27 r)
    q0s = np.arange(p.nchunk) * p.nq
    nqs = np.minimum(p.nq, row - q0s)
    assert nqs.min() > 0 and nqs.sum() == row

    # the table rows, once a block
    _check_spans((c * r + a0) * row * item, Gg * row * item,
                 4 * r * row * item, lay["stage0"] - lay["tab"], "table")
    # each item's run of E: the Gg rows of a box, or a chunk of one row
    box = np.concatenate([np.arange(a, b) for a, b in zip(b0, b1)])
    ib = np.repeat(blk, b1 - b0)
    for q0, nqc in zip(q0s, nqs):
        run = (((c[ib] * nb + box) * r + a0[ib]) * row + q0) * item
        _check_spans(run, (Gg[ib] * row if p.nchunk == 1 else nqc) * item,
                     4 * nb * r * row * item, lay["espan"], "E")
    if p.vw == 1:
        return                     # the sources are loads, not copies
    # the sources' copies: per (class, box) and offset, its part of the
    # stage's values, from the V-list source row of M
    sx, sy = 2 * m2x + 2 * ext, 2 * m2y + 2 * ext
    cc, bb = np.divmod(np.arange(4 * nb), nb)
    x, y = np.divmod(bb, m2y)
    for q0, nqc in zip(q0s, nqs):
        for o in range(27):
            lo, hi = max(q0, o * r), min(q0 + nqc, o * r + r)
            if lo >= hi:
                continue
            tsx, tsy, shx, shy = SHIFT[cc, o].T
            fx = 2 * (x + shx - 1) + tsx + ext
            fy = 2 * (y + shy - 1) + tsy + ext
            on = (fx >= 0) & (fx < sx) & (fy >= 0) & (fy < sy)
            if ext:
                assert on.all()    # a shard's plane holds every source
            src = ((fx[on] * sy + fy[on]) * r + lo - o * r) * item
            _check_spans(src, (hi - lo) * item, sx * sy * r * item,
                         (hi - lo) * item, "source")
            assert np.all(src % 16 == 0) and (lo - q0) * item % 16 == 0
            assert (hi - q0) * item <= lay["stage"] - lay["espan"]


@pytest.mark.parametrize("item", [4, 8])
@pytest.mark.parametrize("m2x,m2y,ext,nps", [
    (2, 2, 0, range(2, 9)), (4, 4, 0, range(2, 9)), (8, 8, 0, range(2, 9)),
    (16, 16, 0, range(2, 9)), (256, 256, 0, (3, 4)),
    (2, 1, 2, range(2, 9)), (4, 2, 2, range(2, 9)), (64, 32, 2, (3, 4, 8)),
    (3, 5, 2, range(2, 9)), (7, 3, 2, range(2, 9))])
def test_plan_covers_each_row_once_with_aligned_copies(m2x, m2y, ext, nps,
                                                       item):
    """Whole levels and shards (odd m2y among them), np 2-8, and on the
    small planes np 15 in float64 and 21 in float32 (rows cut into
    chunks over the stages)."""
    nps = list(nps)
    if m2x * m2y <= 64:
        nps.append(15 if item == 8 else 21)
    for np_cheb in nps:
        _check_plan(m2x, m2y, np_cheb, item, ext)


def test_plan_coarse_levels_spread_and_leaf_is_one_wave():
    """Level 2 (16 boxes) over at least 128 blocks, a box each; the 512^2
    leaf in one wave of persistent blocks, 16-32 KB of E a stage."""
    coarse = m2l.plan_one(2, 2, 16, 4)
    assert coarse.grid >= m2l.MIN_BLOCKS and coarse.per == 1
    leaf = m2l.plan_one(256, 256, 16, 4)
    per_sm = m2l._blocks_per_sm(leaf.smem, leaf.threads, 4)
    assert leaf.grid <= per_sm * m2l.NUM_SMS
    assert m2l.STAGE_BYTES // 2 <= leaf.G * 27 * 16 * 4 <= m2l.STAGE_BYTES


def test_plan_refuses_rows_over_48_kb():
    """Rows past 48 KB now run in the opt-in shared memory (np 16 in
    float64, 22 in float32); the plan refuses the first np past
    m2l.MAX_ROW_BYTES (33 in float64, 47 in float32)."""
    for r, item in ((16 * 16, 8), (22 * 22, 4)):
        assert m2l.plan_one(2, 2, r, item).smem <= m2l.SMEM_BLOCK
    with pytest.raises(ValueError):
        m2l.plan_one(2, 2, 33 * 33, 8)
    with pytest.raises(ValueError):
        m2l.plan_one(2, 2, 47 * 47, 4)


@pytest.mark.parametrize("consts", [
    {}, {"STAGE_BYTES": 8192}, {"STAGE_BYTES": 16384},
    {"STAGE_BYTES": 65536}, {"MIN_BLOCKS": 64}, {"MIN_BLOCKS": 256},
    {"MAX_CONSUMERS": 4}, {"STAGES": (3, 2)}, {"STAGES": (2,)}])
def test_k1_plans_variants_pass_the_kernels_checks(monkeypatch, consts):
    """Plans made with other constants (the choices the K1 A/B varies) are
    plans the kernel accepts, at the planes of the paths: whole levels
    2-9 and one shard of a 2 x 4 mesh at levels 3-9, np 4, both
    itemsizes."""
    for k, v in consts.items():
        monkeypatch.setattr(m2l, k, v)
    for item in (4, 8):
        for level in range(2, 10):
            m2 = (1 << level) // 2
            planes = [(m2, m2)] + ([(m2 // 2, m2 // 4)] if level > 2 else [])
            for m2x, m2y in planes:
                p = m2l.plan_one.__wrapped__(m2x, m2y, 16, item)
                _check_fields(p, m2x * m2y, 16, item)
