// The 5-point finite-volume diffusion stencil of the DSA preconditioner at
// one cell, shared by K9d (diffusion_apply.cu: one launch per apply) and K9
// (pcg.cu: the whole CG in one launch).
//
// Replaces the stencil of aniso_tpu/solver/dsa.py:make_diffusion_apply
// (:85-99).  For every cell (i, j) of the (sz, sz) grid of squares:
//
//   out[i, j] = sigma_a[i, j] z[i, j]
//             + Dx[i, j]   (z[i, j] - z[i+1, j]) / dx^2      (i < sz-1)
//             - Dx[i-1, j] (z[i-1, j] - z[i, j]) / dx^2      (i > 0)
//             + Dy[i, j]   (z[i, j] - z[i, j+1]) / dx^2      (j < sz-1)
//             - Dy[i, j-1] (z[i, j-1] - z[i, j]) / dx^2      (j > 0)
//             + robin[i, j] z[i, j] / dx   once per side of the domain the
//                                          cell touches (Marshak outflux)
//
// in this order, which is the order of the JAX adds; apply_cell is the one
// place that order is written.  Each multiply, add and subtract is rounded
// on its own (the _rn intrinsics, which the compiler never fuses into a
// multiply-add), as the separate PyTorch operations of the plain version
// round them.  Dx (sz-1, sz) and Dy (sz, sz-1) are the harmonic-mean face
// coefficients, robin (sz, sz) the boundary factor 2D/(dx + 4D).

#pragma once

#include <cuda_runtime.h>

namespace aniso {

// a + b, a - b, a * b, each rounded to nearest on its own (never fused)
__device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
}

// The stencil's coefficients at one cell (a face the cell lacks holds 0 and
// is skipped by its index test).
template <typename T>
struct Cell {
    int i, j;
    T sigma_a, dx_hi, dx_lo, dy_hi, dy_lo, robin;
};

template <typename T>
__device__ __forceinline__ Cell<T> load_cell(
    const T* __restrict__ Dx, const T* __restrict__ Dy,
    const T* __restrict__ robin, const T* __restrict__ sigma_a, int idx,
    int sz) {
    Cell<T> c;
    c.i = idx / sz;
    c.j = idx - c.i * sz;
    c.sigma_a = sigma_a[idx];
    c.dx_hi = c.i < sz - 1 ? Dx[idx] : T(0);
    c.dx_lo = c.i > 0 ? Dx[idx - sz] : T(0);
    c.dy_hi = c.j < sz - 1 ? Dy[c.i * (sz - 1) + c.j] : T(0);
    c.dy_lo = c.j > 0 ? Dy[c.i * (sz - 1) + c.j - 1] : T(0);
    c.robin = robin[idx];
    return c;
}

// (A z) at the cell from its value zc and its neighbours' z at (i+1, j),
// (i-1, j), (i, j+1), (i, j-1) (any value where the neighbour is off the
// grid: it is not read).
template <typename T>
__device__ __forceinline__ T apply_cell(const Cell<T>& c, int sz, T zc,
                                        T z_ip, T z_im, T z_jp, T z_jm,
                                        T inv_dx2, T inv_dx) {
    T acc = mul(c.sigma_a, zc);
    if (c.i < sz - 1) {
        acc = add(acc, mul(mul(c.dx_hi, sub(zc, z_ip)), inv_dx2));
    }
    if (c.i > 0) {
        acc = sub(acc, mul(mul(c.dx_lo, sub(z_im, zc)), inv_dx2));
    }
    if (c.j < sz - 1) {
        acc = add(acc, mul(mul(c.dy_hi, sub(zc, z_jp)), inv_dx2));
    }
    if (c.j > 0) {
        acc = sub(acc, mul(mul(c.dy_lo, sub(z_jm, zc)), inv_dx2));
    }
    const T rb = mul(mul(c.robin, zc), inv_dx);
    if (c.i == 0) {
        acc = add(acc, rb);
    }
    if (c.i == sz - 1) {
        acc = add(acc, rb);
    }
    if (c.j == 0) {
        acc = add(acc, rb);
    }
    if (c.j == sz - 1) {
        acc = add(acc, rb);
    }
    return acc;
}

}  // namespace aniso
