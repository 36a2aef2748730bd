"""Neighbour windows on the square grid (torch), shared by the near-E cache
build (fmm.smooth) and K2's plain version (kernels.near)."""

from __future__ import annotations

import torch


def patch_3x3(u: torch.Tensor) -> torch.Tensor:
    """(sz, sz, q) -> (sz, sz, 3, 3, q) zero-padded neighbour windows:
    out[i, j, a, b] = u[i + a - 1, j + b - 1]."""
    sz = u.shape[0]
    pad = u.new_zeros((sz + 2, sz + 2) + tuple(u.shape[2:]))
    pad[1:-1, 1:-1] = u
    return patch_3x3_valid(pad)


def patch_3x3_valid(ue: torch.Tensor) -> torch.Tensor:
    """(lx + 2, ly + 2, q) block with its halo -> (lx, ly, 3, 3, q)
    windows: out[i, j, a, b] = ue[i + a, j + b]."""
    lx, ly = ue.shape[0] - 2, ue.shape[1] - 2
    return torch.stack([
        torch.stack([ue[a:a + lx, b:b + ly] for b in range(3)], dim=2)
        for a in range(3)
    ], dim=2)
