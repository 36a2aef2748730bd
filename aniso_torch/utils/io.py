"""Field IO + solver checkpointing.

Copy of aniso_tpu/utils/io.py (it imports no JAX, but importing it imports
aniso_tpu/__init__.py, which does).

CSV functions are read/write-compatible with the reference's artifacts
(matlab_io.h:14-59): `result.csv` one value per line at 32 significant
digits, `points.csv` one "x y" pair per line, and a warm start that loads
`result.csv` if present and silently proceeds from zero otherwise
(main.cpp:138-140, matlab_io.h:47-50).

Checkpointing is a superset of the reference's result.csv warm start
(SURVEY.md section 5 "Checkpoint / resume"): `save_checkpoint` stores the
solution, the coefficient fields, and the config dict in one .npz so a
solve can resume bit-for-bit on a different host count.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


def write_result_csv(x, path: str) -> None:
    """One value per line, 32 significant digits (matlab_io.h:24-33)."""
    x = np.asarray(x).reshape(-1)
    with open(path, "w") as f:
        for v in x:
            f.write(f"{v:.32g}\n")


def write_points_csv(xs, ys, path: str, sep: str = " ") -> None:
    """One "x<sep>y" per line (matlab_io.h:35-45)."""
    xs = np.asarray(xs).reshape(-1)
    ys = np.asarray(ys).reshape(-1)
    with open(path, "w") as f:
        for a, b in zip(xs, ys):
            f.write(f"{a:.32g}{sep}{b:.32g}\n")


def load_result_csv(path: str, n: Optional[int] = None) -> Optional[np.ndarray]:
    """Load a result.csv; returns None when absent (warm-start semantics of
    main.cpp:138-140).  If n is given the size must match."""
    if not os.path.exists(path):
        return None
    data = np.loadtxt(path, dtype=np.float64).reshape(-1)
    if n is not None and data.shape[0] != n:
        raise ValueError(
            f"{path}: expected {n} values, found {data.shape[0]}"
        )
    return data


def save_checkpoint(path: str, *, x, config: dict, sigma_s=None,
                    sigma_t=None, residual: float = None,
                    iterations: int = None) -> None:
    """Solver-state checkpoint (.npz).  `x` may be the current iterate at any
    point — restarted GMRES resumes exactly from an iterate, so saving x at a
    restart boundary loses nothing."""
    payload = {"x": np.asarray(x), "config": json.dumps(config)}
    if sigma_s is not None:
        payload["sigma_s"] = np.asarray(sigma_s)
    if sigma_t is not None:
        payload["sigma_t"] = np.asarray(sigma_t)
    if residual is not None:
        payload["residual"] = np.float64(residual)
    if iterations is not None:
        payload["iterations"] = np.int64(iterations)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        out = {k: z[k] for k in z.files}
    out["config"] = json.loads(str(out["config"]))
    return out
