"""Carry aniso_tpu's caches and per-mode tables across into the port.

Both functions take numpy arrays (the caller converts JAX arrays with
np.asarray) and import nothing of JAX, so a test can feed both packages the
same caches and compare the apply alone.

JAX layouts read here (aniso_tpu/fmm/smooth.py, fmm/apply.py,
solver/operator.py:150-152):
  near_E     (3, 3, nq_t, nq_s, sz, sz)
  m2l_E[l]   coarse: stacked (4, m2, m2, P) with P = r*27r in (a, o, b) order;
             fine: a tuple of 4 per-class blocks, row-major (m2, m2, r, 27r),
             y-minor (m2, r, 27r, m2) when m2 % 128 == 0 (smooth.py:337-341),
             or flat (m2, m2, P)
  sigma_w    (sz, sz, nq)
  m2l_cosr   {level: (4, r*27*r)};  near_cosrw, near_static (3, 3, nq_t, nq_s);
  duffy      (nq_t, nq_s, sz, sz)
"""

from __future__ import annotations

import numpy as np
import torch


def _m2l_level_from_jax(E) -> np.ndarray:
    """One JAX M2L level -> the port's (4, m2, m2, r, 27r)."""
    if isinstance(E, (tuple, list)):
        blocks = []
        for Ec in map(np.asarray, E):
            if Ec.ndim == 4 and Ec.shape[-1] == Ec.shape[0]:   # y-minor
                Ec = Ec.transpose(0, 3, 1, 2)
            blocks.append(Ec.reshape(Ec.shape[0], Ec.shape[1], -1))
        E = np.stack(blocks)
    E = np.asarray(E)
    m2, P = E.shape[1], E.shape[-1]
    r = int(round(np.sqrt(P / 27)))
    return E.reshape(4, m2, m2, r, 27 * r)


def caches_from_jax_numpy(caches_np: dict, grid, tcfg, device, dtype) -> dict:
    """aniso_tpu's dense FMM caches {'near_E', 'm2l_E', 'sigma_w'} (numpy)
    -> the port's caches on `device` in `dtype`."""
    near = np.asarray(caches_np["near_E"])
    if near.shape[-2:] != (grid.sz, grid.sz):
        raise ValueError(f"near_E {near.shape} is not on a {grid.sz}^2 grid")
    levels = sorted(caches_np["m2l_E"])
    if levels[-1] != tcfg.leaf_level:
        raise ValueError(f"m2l_E levels {levels}, leaf {tcfg.leaf_level}")
    m2l = {
        level: torch.tensor(
            np.ascontiguousarray(_m2l_level_from_jax(E)),
            dtype=dtype, device=device,
        )
        for level, E in caches_np["m2l_E"].items()
    }
    return {
        "near_E": torch.tensor(
            np.ascontiguousarray(near.transpose(4, 5, 2, 0, 1, 3)),
            dtype=dtype, device=device,
        ),
        "m2l_E": m2l,
        "sigma_w": torch.tensor(
            np.asarray(caches_np["sigma_w"]), dtype=dtype, device=device
        ),
    }


def mode_static_from_jax_numpy(ms_np: dict, device, dtype) -> dict:
    """aniso_tpu's per-mode tables (build_mode_static, plus 'duffy' in
    compat mode) -> the port's, in the kernels' layouts."""
    def t(a):
        return torch.tensor(
            np.ascontiguousarray(a), dtype=dtype, device=device
        )

    cosr = {}
    for level, c in ms_np["m2l_cosr"].items():
        c = np.asarray(c)
        r = int(round(np.sqrt(c.shape[-1] / 27)))
        cosr[level] = t(c.reshape(4, r, 27 * r))
    duffy = ms_np.get("duffy")
    return {
        "m2l_cosr": cosr,
        "near_cosrw": t(np.asarray(ms_np["near_cosrw"]).transpose(2, 0, 1, 3)),
        "near_static": t(np.asarray(ms_np["near_static"]).transpose(2, 0, 1, 3)),
        "duffy": None if duffy is None else t(
            np.asarray(duffy).transpose(2, 3, 0, 1)
        ),
    }
