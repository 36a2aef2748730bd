"""K2: the near-field contraction of the corrected FMM matvec, for one
Fourier mode or for all D modes of one charge.

Replaces aniso_tpu/fmm/apply.py:_near_block_contract (:577) with the rest of
_near_apply (:639-681), _patch_3x3 (:554) and the per-mode loop around it in
fmm_apply_all_modes (:762-767).  The CUDA kernel is csrc/near_contract.cu;
its header states the bound (bytes: E is read once per charge whatever D is,
11.9 MB at 64^2) and the design.

    out[d,i,j,t] = sum_{a,b,s} (expm1(-E[i,j,t,a,b,s]) * cosrw[d,t,a,b,s]
                                + S[d,t,a,b,s]) * u[i+a-1, j+b-1, s]
                 + sigma_w[i,j,t] * u[i,j,t]            (d = 0; else None)
                 + sum_s duffy[d,i,j,t,s] * u[i,j,s]    (compat mode; else None)

with u zero off the grid.  Layouts (the port's own, square major):
    E       (sz, sz, nq, 3, 3, nq)
    cosrw   (D, nq, 3, 3, nq)   cos(d theta)/r * w_src, 0 at r = 0
    S       (D, nq, 3, 3, nq)   refined + Duffy correction stencil (ops.near)
    u, sigma_w (sz, sz, nq);  duffy (D, sz, sz, nq, nq);  out (D, sz, sz, nq)
Tables without the mode axis, cosrw (nq, 3, 3, nq) and duffy (sz, sz, nq,
nq), are one mode and return out (sz, sz, nq).  sigma_w goes to slot 0 only:
pass it when slot 0 is Fourier mode 0.

near_contract takes near_contract_plain for CPU tensors and launches the
kernel for CUDA tensors: the float32 instance or the float64 one (the
refinement twin and the plain f64 solve), by E's dtype; `launches` counts
kernel launches per instance.

K2-S, near_contract_shard (the contraction of aniso_tpu/parallel/halo.py:
make_near_apply_shardmap, :56-103), is the same contraction on one shard of
a domain decomposition: E, sigma_w and duffy are the shard's (lx, ly, ...)
slices and u comes halo-extended, (lx + 2, ly + 2, nq)
(parallel.halo.halo_exchange), so the kernel reads it with no bounds test.
Its launches count under "shard_f32" / "shard_f64".
"""

from __future__ import annotations

import ctypes

import torch

from ..ops.windows import patch_3x3, patch_3x3_valid
from . import _cuda

SOURCE = "near_contract.cu"
SYMBOLS = {"f32": "aniso_near_contract_f32", "f64": "aniso_near_contract_f64"}
SHARD_SYMBOLS = {"f32": "aniso_near_contract_shard_f32",
                 "f64": "aniso_near_contract_shard_f64"}
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
_SHARD_ARGTYPES = ((ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 4
                   + (ctypes.c_void_p,))

launches = {"f32": 0, "f64": 0, "shard_f32": 0, "shard_f64": 0}


def _one_mode(fn, E, cosrw, S, u, sigma_w, duffy):
    return fn(E, cosrw[None], S[None], u, sigma_w,
              None if duffy is None else duffy[None])[0]


def near_contract_plain(E, cosrw, S, u, sigma_w=None, duffy=None):
    """The JAX math step by step (3x3 windows, then per mode the block, the
    einsum and the Duffy term; the diagonal on slot 0)."""
    if cosrw.dim() == 4:
        return _one_mode(near_contract_plain, E, cosrw, S, u, sigma_w, duffy)
    return _contract_windows(E, cosrw, S, u, patch_3x3(u), sigma_w, duffy)


def near_contract_shard_plain(E, cosrw, S, ue, sigma_w=None, duffy=None):
    """K2-S's plain version: the same steps on the halo-extended block's
    windows (the local body of aniso_tpu make_near_apply_shardmap,
    :70-81)."""
    if cosrw.dim() == 4:
        return _one_mode(near_contract_shard_plain, E, cosrw, S, ue, sigma_w,
                         duffy)
    return _contract_windows(E, cosrw, S, ue[1:-1, 1:-1], patch_3x3_valid(ue),
                             sigma_w, duffy)


def _contract_windows(E, cosrw, S, u, up, sigma_w, duffy):
    X = torch.expm1(-E)                                  # (lx, ly, t, a, b, s)
    outs = []
    for d in range(cosrw.shape[0]):
        out = torch.einsum("ijtabs,ijabs->ijt", X * cosrw[d] + S[d], up)
        if sigma_w is not None and d == 0:
            out = out + sigma_w * u
        if duffy is not None:
            out = out + torch.einsum("ijts,ijs->ijt", duffy[d], u)
        outs.append(out)
    return torch.stack(outs)


def near_contract(E, cosrw, S, u, sigma_w=None, duffy=None) -> torch.Tensor:
    if cosrw.dim() == 4:
        return _one_mode(near_contract, E, cosrw, S, u, sigma_w, duffy)
    if E.device.type == "cpu":
        return near_contract_plain(E, cosrw, S, u, sigma_w, duffy)
    inst = _cuda.instance("E", E)
    sz, _, nq = u.shape
    D = cosrw.shape[0]
    dt = E.dtype
    _cuda.check("E", E, (sz, sz, nq, 3, 3, nq), dt)
    _cuda.check("cosrw", cosrw, (D, nq, 3, 3, nq), dt)
    _cuda.check("S", S, (D, nq, 3, 3, nq), dt)
    _cuda.check("u", u, (sz, sz, nq), dt)
    if sigma_w is not None:
        _cuda.check("sigma_w", sigma_w, (sz, sz, nq), dt)
    if duffy is not None:
        _cuda.check("duffy", duffy, (D, sz, sz, nq, nq), dt)
    _cuda.check_aligned(E=E)
    symbol = SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _ARGTYPES)
    out = torch.empty((D,) + tuple(u.shape), dtype=dt, device=u.device)
    rc = fn(_cuda.ptr(E), _cuda.ptr(cosrw), _cuda.ptr(S), _cuda.ptr(u),
            _cuda.ptr(sigma_w), _cuda.ptr(duffy), _cuda.ptr(out), sz, nq, D,
            _cuda.stream(E.device))
    _cuda.raise_on_error(symbol, rc)
    launches[inst] += 1
    return out


def near_contract_shard(E, cosrw, S, ue, sigma_w=None, duffy=None):
    """K2-S: (D, lx, ly, nq), or (lx, ly, nq) for one mode's tables."""
    if cosrw.dim() == 4:
        return _one_mode(near_contract_shard, E, cosrw, S, ue, sigma_w, duffy)
    if E.device.type == "cpu":
        return near_contract_shard_plain(E, cosrw, S, ue, sigma_w, duffy)
    inst = _cuda.instance("E", E)
    lx, ly, nq = E.shape[:3]
    D = cosrw.shape[0]
    specs = [("E", E, (lx, ly, nq, 3, 3, nq)),
             ("cosrw", cosrw, (D, nq, 3, 3, nq)), ("S", S, (D, nq, 3, 3, nq)),
             ("ue", ue, (lx + 2, ly + 2, nq))]
    if sigma_w is not None:
        specs.append(("sigma_w", sigma_w, (lx, ly, nq)))
    if duffy is not None:
        specs.append(("duffy", duffy, (D, lx, ly, nq, nq)))
    _cuda.check_all(E.dtype, *specs)
    _cuda.check_aligned(E=E)
    symbol = SHARD_SYMBOLS[inst]
    fn = _cuda.load(SOURCE, symbol, _SHARD_ARGTYPES)
    out = torch.empty((D, lx, ly, nq), dtype=E.dtype, device=E.device)
    rc = fn(_cuda.ptr(E), _cuda.ptr(cosrw), _cuda.ptr(S), _cuda.ptr(ue),
            _cuda.ptr(sigma_w), _cuda.ptr(duffy), _cuda.ptr(out), lx, ly, nq,
            D, _cuda.stream(E.device))
    _cuda.raise_on_error(symbol, rc)
    launches["shard_" + inst] += 1
    return out
