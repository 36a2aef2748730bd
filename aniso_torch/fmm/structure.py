"""Implicit quadtree structure over the uniform grid of squares.

Copy of aniso_tpu/fmm/structure.py.  domain_size = 2^L squares per axis
gives a perfect quadtree: level l has 2^l x 2^l boxes.  V-list offsets
follow the parity rule: source box I+d is in the target's V list iff the
boxes are non-adjacent but their parents are adjacent, i.e. d in [-2, 3]
for parity 0 and [-3, 2] for parity 1, minus the 3x3 adjacency.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np


def axis_offsets(parity: int) -> range:
    return range(-2 - parity, 4 - parity)  # [-2,3] or [-3,2]


@lru_cache(maxsize=None)
def vlist_offsets(px: int, py: int) -> tuple:
    """Offsets (di, dj) in the V list of a box with parities (px, py)."""
    out = []
    for di in axis_offsets(px):
        for dj in axis_offsets(py):
            if max(abs(di), abs(dj)) >= 2:
                out.append((di, dj))
    return tuple(out)


@lru_cache(maxsize=None)
def all_vlist_offsets() -> tuple:
    """The 40 distinct physical offsets across all parity classes."""
    s = set()
    for px in (0, 1):
        for py in (0, 1):
            s.update(vlist_offsets(px, py))
    return tuple(sorted(s))


@dataclass(frozen=True)
class TreeConfig:
    sz: int           # grid squares per axis (power of two)
    levels: int       # leaf level L = log2(sz); boxes at level l: 2^l

    @property
    def leaf_level(self) -> int:
        return self.levels

    def boxes(self, level: int) -> int:
        return 1 << level

    def box_size_squares(self, level: int) -> int:
        return self.sz >> level


def tree_config(sz: int, max_level: int = 20) -> TreeConfig:
    """max_level mirrors the reference cap (data.cfg:37, bbfmm.h:250-317
    stops splitting at maxLevel).  The implicit tree's depth is log2(sz);
    a cap that binds would coarsen leaf boxes to >1 square, which this
    framework does not implement -- reject it loudly rather than silently
    building a different operator than asked."""
    if sz & (sz - 1) != 0 or sz < 4:
        raise ValueError(
            f"FMM backend needs domain_size a power of two >= 4, got {sz}"
        )
    levels = int(np.log2(sz))
    if max_level < levels:
        raise NotImplementedError(
            f"max_level={max_level} would cap the implicit quadtree below "
            f"its natural depth log2({sz})={levels}; coarsened leaf boxes "
            "are not supported"
        )
    return TreeConfig(sz=sz, levels=levels)


def coarsest_m2l_level() -> int:
    """M2L starts at level 2 (at levels 0-1 all boxes are adjacent)."""
    return 2
