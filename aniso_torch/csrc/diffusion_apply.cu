// K9d: the 5-point finite-volume diffusion apply of the DSA preconditioner,
// for sm_90a, in two instances from one template: float32 and float64.
//
// Replaces the stencil of aniso_tpu/solver/dsa.py:make_diffusion_apply
// (:85-99), which the JAX package runs as one fused program inside the
// while_loop of its CG (:114-142).  For every cell (i, j) of the (sz, sz)
// grid of squares:
//
//   out[i, j] = sigma_a[i, j] z[i, j]
//             + Dx[i, j]   (z[i, j] - z[i+1, j]) / dx^2      (i < sz-1)
//             - Dx[i-1, j] (z[i-1, j] - z[i, j]) / dx^2      (i > 0)
//             + Dy[i, j]   (z[i, j] - z[i, j+1]) / dx^2      (j < sz-1)
//             - Dy[i, j-1] (z[i, j-1] - z[i, j]) / dx^2      (j > 0)
//             + robin[i, j] z[i, j] / dx   once per side of the domain the
//                                          cell touches (Marshak outflux)
//
// in this order, which is the order of the JAX adds.  Dx (sz-1, sz) and
// Dy (sz, sz-1) are the harmonic-mean face coefficients, robin (sz, sz) the
// boundary factor 2D/(dx + 4D).
//
// Bound on the H100: bytes, six fields of sz^2 values (z, Dx, Dy, robin,
// sigma_a read once, out written once: 6.3 MB in f32 at 512^2, ~1.9 us at
// 3.35 TB/s; at 128^2 the 0.4 MB sit in the cache and the launch itself
// costs more).  One thread per cell; the neighbours of z come from the
// cache.  In eager PyTorch the same stencil is about a dozen small
// launches, up to 500 times per preconditioner call.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void diffusion_apply_kernel(
    const T* __restrict__ z,          // (sz, sz)
    const T* __restrict__ Dx,         // (sz - 1, sz)
    const T* __restrict__ Dy,         // (sz, sz - 1)
    const T* __restrict__ robin,      // (sz, sz)
    const T* __restrict__ sigma_a,    // (sz, sz)
    T* __restrict__ out,              // (sz, sz)
    int sz, T inv_dx2, T inv_dx) {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= sz * sz) {
        return;
    }
    const int i = idx / sz;
    const int j = idx - i * sz;
    const T zc = z[idx];
    T acc = sigma_a[idx] * zc;
    if (i < sz - 1) {
        acc += Dx[idx] * (zc - z[idx + sz]) * inv_dx2;
    }
    if (i > 0) {
        acc -= Dx[idx - sz] * (z[idx - sz] - zc) * inv_dx2;
    }
    if (j < sz - 1) {
        acc += Dy[i * (sz - 1) + j] * (zc - z[idx + 1]) * inv_dx2;
    }
    if (j > 0) {
        acc -= Dy[i * (sz - 1) + j - 1] * (z[idx - 1] - zc) * inv_dx2;
    }
    const T rb = robin[idx] * zc * inv_dx;
    if (i == 0) {
        acc += rb;
    }
    if (i == sz - 1) {
        acc += rb;
    }
    if (j == 0) {
        acc += rb;
    }
    if (j == sz - 1) {
        acc += rb;
    }
    out[idx] = acc;
}

template <typename T>
int launch(const void* z, const void* Dx, const void* Dy, const void* robin,
           const void* sigma_a, void* out, int sz, double inv_dx2,
           double inv_dx, void* stream) {
    const int blocks = (sz * sz + kThreads - 1) / kThreads;
    diffusion_apply_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const T*>(z), static_cast<const T*>(Dx),
        static_cast<const T*>(Dy), static_cast<const T*>(robin),
        static_cast<const T*>(sigma_a), static_cast<T*>(out), sz,
        (T)inv_dx2, (T)inv_dx);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aniso_diffusion_apply_f32(
    const void* z, const void* Dx, const void* Dy, const void* robin,
    const void* sigma_a, void* out, int sz, double inv_dx2, double inv_dx,
    void* stream) {
    return launch<float>(z, Dx, Dy, robin, sigma_a, out, sz, inv_dx2, inv_dx,
                         stream);
}

extern "C" int aniso_diffusion_apply_f64(
    const void* z, const void* Dx, const void* Dy, const void* robin,
    const void* sigma_a, void* out, int sz, double inv_dx2, double inv_dx,
    void* stream) {
    return launch<double>(z, Dx, Dy, robin, sigma_a, out, sz, inv_dx2, inv_dx,
                          stream);
}
