"""Evaluation of per-square Legendre expansions at the grid nodes (numpy).

evaluate_at_nodes_np of aniso_tpu/ops/fields.py, copied.
"""

from __future__ import annotations

import numpy as np

from ..core.geometry import Grid
from ..core.legendre import basis2d_np


def evaluate_at_nodes_np(grid: Grid, coeffs) -> np.ndarray:
    """sigma_hat at the grid's own nodes from local-basis coefficients.

    Under the global-basis quirk callers pass the compat-transformed
    coefficients (ops.compat), which is equivalent.
    """
    bt = basis2d_np(grid.deg, grid.qx, grid.qy) / grid.norms[:, None]
    return np.einsum("bq,ijb->ijq", bt, np.asarray(coeffs))
