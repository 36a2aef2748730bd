"""Restarted GMRES with CGS2 orthogonalization and Givens rotations.

Counterpart of aniso_tpu/solver/gmres.py (reference gmres.cpp:53-169,
relative residual |Ax - b| / |b|), with the same arithmetic and the same
iteration accounting (:195-241): j starts at 1 and counts Arnoldi steps
(matvecs), the inner loop runs while i < restart, j <= max_iter and not
converged, and iterations = j - 1.

An optional left preconditioner (aniso_tpu gmres.py:97-120; MATLAB's
gmres(A, b, ..., M), which is how the reference applies its diffusion solve,
aniso.m:111-119): `precond` is the action of inv(M), the solve is of
inv(M) A x = inv(M) b, and the reported residual is the preconditioned one.

The Krylov basis (restart + 1, *field) and the matvecs stay on the field's
device in its dtype, in natural field shape.  The Hessenberg column, the
rotations and s are kept in float64 on the host: each Arnoldi step reads
its (i + 2) projections back, one small transfer per iteration.  (JAX runs
the whole solve as one device while_loop; a CUDA graph of the Arnoldi step
is later work.)

The field arithmetic of a solve goes through a space: TensorSpace for one
tensor, or the one a field brings with it (`krylov_space()`): a sharded
field's (parallel.api.Sharded) keeps each shard's part of the basis on the
shard's device and sums each CGS2 pass and each norm over the shards, the
counterpart of JAX's sharded-basis CGS2 (aniso_tpu/solver/gmres.py:8-21,
"a per-shard contraction + an (m+1)-scalar psum").
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch


class GmresResult(NamedTuple):
    x: torch.Tensor
    residual: float            # final relative residual estimate
    iterations: int            # total matvec count (inner iterations)
    converged: bool


class TensorSpace:
    """The arithmetic of a solve on one tensor: the basis one (restart + 1,
    *field) tensor, CGS2 as two batched GEMVs."""

    def __init__(self, b: torch.Tensor):
        self.shape = b.shape

    def shaped(self, v):
        return v.reshape(self.shape)

    def zeros(self, b):
        return torch.zeros_like(b)

    def norm(self, v) -> float:
        return float(torch.linalg.vector_norm(v))

    def basis(self, b, n: int):
        return torch.empty((n,) + tuple(self.shape), dtype=b.dtype,
                           device=b.device)

    def arnoldi(self, V, i: int, w) -> np.ndarray:
        """Orthogonalize w against V[:i + 1] (CGS2, two passes), store it
        normalized as V[i + 1]; the (i + 2) column h1 + h2, |w| on the
        host."""
        Vf = V.view(V.shape[0], -1)
        w = w.reshape(-1)
        basis = Vf[: i + 1]
        h1 = basis @ w
        w = w - h1 @ basis
        h2 = basis @ w
        w = w - h2 @ basis
        wnorm = torch.linalg.vector_norm(w)
        Vf[i + 1] = w / torch.where(wnorm == 0.0, 1.0, wnorm)
        return torch.cat([h1 + h2, wnorm[None]]).cpu().numpy()

    def combine(self, V, y: np.ndarray):
        """sum_k y[k] V[k] over the first len(y) basis vectors."""
        Vf = V.view(V.shape[0], -1)
        yt = torch.as_tensor(y, dtype=V.dtype, device=V.device)
        return (yt @ Vf[: len(y)]).reshape(self.shape)


def _givens(dx: float, dy: float):
    """Generate a plane rotation (gmres.cpp:26-39)."""
    if dy == 0.0:
        return 1.0, 0.0
    if abs(dy) > abs(dx):
        t = dx / dy
        sn = 1.0 / np.sqrt(1.0 + t * t)
        return t * sn, sn
    t = dy / dx
    cs = 1.0 / np.sqrt(1.0 + t * t)
    return cs, t * cs


def gmres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    *,
    restart: int = 80,
    max_iter: int = 400,
    tol: float = 1e-12,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> GmresResult:
    """Solve A x = b for a field b of any shape (a tensor, or a field that
    brings its own space, such as a sharded one)."""
    space = (b.krylov_space() if hasattr(b, "krylov_space")
             else TensorSpace(b))
    m = restart
    x = space.zeros(b) if x0 is None else space.shaped(x0).clone()

    def A(v):
        out = matvec(v)
        if precond is not None:
            out = precond(out)
        return space.shaped(out)

    if precond is not None:
        b = space.shaped(precond(b))

    normb = space.norm(b)
    normb = 1.0 if normb == 0.0 else normb
    r = b - A(x)
    beta = space.norm(r)
    j = 1
    resid = beta / normb
    done = resid <= tol
    V = space.basis(b, m + 1)

    while j <= max_iter and not done:
        # one restart cycle
        V[0] = r / beta
        H = np.zeros((m + 1, m))
        s = np.zeros(m + 1)
        s[0] = beta
        cs = np.zeros(m)
        sn = np.zeros(m)
        i = 0
        inner_done = False
        while i < m and j <= max_iter and not inner_done:
            col = np.zeros(m + 1)
            col[: i + 2] = space.arnoldi(V, i, A(V[i]))
            for k in range(i):                    # previous rotations
                t = cs[k] * col[k] + sn[k] * col[k + 1]
                col[k + 1] = -sn[k] * col[k] + cs[k] * col[k + 1]
                col[k] = t
            c_new, s_new = _givens(col[i], col[i + 1])
            cs[i], sn[i] = c_new, s_new
            col[i] = c_new * col[i] + s_new * col[i + 1]
            col[i + 1] = 0.0
            s_i = c_new * s[i] + s_new * s[i + 1]
            s_i1 = -s_new * s[i] + c_new * s[i + 1]
            s[i], s[i + 1] = s_i, s_i1
            H[:, i] = col
            inner_done = bool(abs(s_i1) / normb < tol)
            i += 1
            j += 1

        # back-substitution on the leading i x i block (gmres.cpp:12-24)
        y = np.zeros(i)
        for k in range(i - 1, -1, -1):
            y[k] = (s[k] - H[k, k + 1: i] @ y[k + 1:]) / H[k, k]
        x = x + space.combine(V, y)
        r = b - A(x)
        beta = space.norm(r)
        resid = float(abs(s[i]) / normb if inner_done else beta / normb)
        done = resid < tol

    return GmresResult(x=x, residual=resid, iterations=j - 1,
                       converged=bool(done))
