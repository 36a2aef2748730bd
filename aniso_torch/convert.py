"""Carry aniso_tpu's caches and per-mode tables across into the port.

The functions take numpy arrays (the caller converts JAX arrays with
np.asarray) and import nothing of JAX, so a test can feed both packages the
same caches and compare the apply alone.

JAX layouts read here (aniso_tpu/fmm/smooth.py, fmm/apply.py,
solver/operator.py:150-152):
  near_E     (3, 3, nq_t, nq_s, sz, sz)
  m2l_E[l]   coarse: stacked (4, m2, m2, P) with P = r*27r in (a, o, b) order;
             fine: a tuple of 4 per-class blocks, row-major (m2, m2, r, 27r),
             y-minor (m2, r, 27r, m2) when m2 % 128 == 0 (smooth.py:337-341),
             or flat (m2, m2, P); per-offset: {'Wo': tuple of flat
             (r*r, bbx*bby*nq) blocks} (smooth.py:381-422)
  sigma_w    (sz, sz, nq);  coeffs (sz, sz, nq) beside per-offset levels
  the f64 twin (operator.py:462-483) holds near_W (3, 3, nq, nq, 3, 3, nq,
             dx folded in) and coeffs in place of near_E
  p2m_w (r, nq), l2t (nq, r), m2m (2, 2, r, r)   the static sweep operators
  m2l_cosr   {level: (4, r*27*r)};  near_cosrw, near_static (3, 3, nq_t, nq_s);
  duffy      (nq_t, nq_s, sz, sz)
  dense      k_smooth, k_real: lists of (n, n) per mode (ops/dense.py)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fmm.apply import parity_shift_table_np, stack_mode_statics
from .fmm.cheb import child_transfer, m2m_from_1d
from .fmm.smooth import near_E_from_weights


def _m2l_level_from_jax(E):
    """One JAX M2L level -> the port's (4, m2, m2, r, 27r), or a per-offset
    level -> the port's {'Wo'}: each block transposed to (K, r*r), back to
    back in the same key order."""
    if isinstance(E, dict):
        return {"Wo": np.concatenate(
            [np.asarray(W).T.ravel() for W in E["Wo"]])}
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
    """aniso_tpu's FMM caches {'near_E' or 'near_W', 'm2l_E', 'sigma_w'
    [, 'coeffs']} (numpy) -> the port's caches on `device` in `dtype`; a
    twin's near_W is contracted with its coeffs into the port's near E."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)

    levels = sorted(caches_np["m2l_E"])
    if levels[-1] != tcfg.leaf_level:
        raise ValueError(f"m2l_E levels {levels}, leaf {tcfg.leaf_level}")
    m2l = {}
    for level, E in caches_np["m2l_E"].items():
        E = _m2l_level_from_jax(E)
        m2l[level] = {"Wo": t(E["Wo"])} if isinstance(E, dict) else t(E)
    out = {"m2l_E": m2l, "sigma_w": t(caches_np["sigma_w"])}
    if "coeffs" in caches_np:
        out["coeffs"] = t(caches_np["coeffs"])
    if "near_E" in caches_np:
        near = np.asarray(caches_np["near_E"])
        if near.shape[-2:] != (grid.sz, grid.sz):
            raise ValueError(f"near_E {near.shape} is not on a {grid.sz}^2 "
                             "grid")
        out["near_E"] = t(near.transpose(4, 5, 2, 0, 1, 3))
    else:
        out["near_E"] = near_E_from_weights(t(caches_np["near_W"]),
                                            out["coeffs"])
    return out


def dense_from_jax_numpy(k_smooth, k_real, device, dtype):
    """aniso_tpu's dense matrices, per-mode lists of (n, n) (numpy), ->
    the port's (D, n, n) smooth and real tensors on `device` in `dtype`."""
    def t(mats):
        return torch.tensor(np.stack([np.asarray(k) for k in mats]),
                            dtype=dtype, device=device)

    return t(k_smooth), t(k_real)


def static_from_jax_numpy(static_np: dict, device, dtype) -> dict:
    """aniso_tpu's static sweep operators (fmm/apply.py:build_fmm_static:
    'p2m_w' (r, nq), 'l2t' (nq, r), 'm2m' (2, 2, r, r)) -> the port's, in
    the layouts K8 reads (p2m_w and l2t the same ones), with the int32
    parity shift table the M2L kernels read.  In place of m2m the port
    keeps its one-dimensional factor m2m_1d (2, np, np), r = np^2
    (fmm/cheb.py:child_transfer); JAX's m2m must be its tensor product
    (ValueError otherwise)."""
    def t(a):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                            device=device)

    m2m = np.asarray(static_np["m2m"])
    n = math.isqrt(m2m.shape[-1])
    tc = child_transfer(n)
    err = np.abs(m2m_from_1d(tc) - m2m).max()
    if n * n != m2m.shape[-1] or err > 1e-12 * np.abs(m2m).max():
        raise ValueError("m2m is not the tensor product of the child "
                         f"transfer at np {n} (max error {err})")
    return {
        "p2m_w": t(static_np["p2m_w"]), "l2t": t(static_np["l2t"]),
        "m2m_1d": t(tc),
        "shift": torch.as_tensor(parity_shift_table_np(), dtype=torch.int32,
                                 device=device),
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


def mode_stack_from_jax_numpy(ms_list, device, dtype) -> dict:
    """aniso_tpu's per-mode tables of modes 0..D-1 (solver._mode_statics)
    -> the port's stacked tables with the leading mode axis, as the
    all-modes sweep reads them (fmm.apply.stack_mode_statics)."""
    return stack_mode_statics(
        [mode_static_from_jax_numpy(ms, device, dtype) for ms in ms_list])
