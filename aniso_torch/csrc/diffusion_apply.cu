// K9d: the 5-point finite-volume diffusion apply of the DSA preconditioner,
// for sm_90a, in two instances from one template: float32 and float64.
//
// Replaces the stencil of aniso_tpu/solver/dsa.py:make_diffusion_apply
// (:85-99), which the JAX package runs as one fused program inside the
// while_loop of its CG (:114-142).  The stencil and the order of its adds
// are diffusion_stencil.cuh's apply_cell, which K9 (pcg.cu, the whole CG in
// one launch) runs too; the DSA solve launches K9, and this kernel is the
// stencil alone, held against its plain version.
//
// Bound on the H100: bytes, six fields of sz^2 values (z, Dx, Dy, robin,
// sigma_a read once, out written once: 6.3 MB in f32 at 512^2, ~1.9 us at
// 3.35 TB/s; at 128^2 the 0.4 MB sit in the cache and the launch itself
// costs more).  One thread per cell; the neighbours of z come from the
// cache.

#include <cuda_runtime.h>

#include "diffusion_stencil.cuh"

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
    const aniso::Cell<T> c = aniso::load_cell(Dx, Dy, robin, sigma_a, idx,
                                              sz);
    const T zero = T(0);
    out[idx] = aniso::apply_cell(
        c, sz, z[idx], c.i < sz - 1 ? z[idx + sz] : zero,
        c.i > 0 ? z[idx - sz] : zero, c.j < sz - 1 ? z[idx + 1] : zero,
        c.j > 0 ? z[idx - 1] : zero, inv_dx2, inv_dx);
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
