// K9: the Jacobi-preconditioned CG of the DSA preconditioner, the whole
// loop in one launch, for sm_90a, in two instances from one template:
// float32 and float64.
//
// Replaces aniso_tpu/solver/dsa.py:pcg (:114-141), which the JAX package
// runs as one lax.while_loop on the device with its stopping test there too
// (:126-128), and the diffusion stencil inside it (make_diffusion_apply
// :85-99; diffusion_stencil.cuh's apply_cell, as K9d runs it).  In the JAX
// order, with every dot product summed in the field's type:
//
//   inv_diag = 1 / diag;  bnorm2 = b.b, taken as 1 where it is 0
//   x = 0, r = b, z = inv_diag r, p = z, rz = r.z
//   while k < max_iter and r.r > tol^2 bnorm2:
//       Ap = A p;  alpha = rz / p.Ap
//       x += alpha p;  r -= alpha Ap;  z = inv_diag r;  rz' = r.z
//       p = z + (rz' / rz) p;  rz = rz';  k += 1
//
// and writes x and k.  Nothing is read back to the host inside the call.
// Every elementwise product, sum and difference is rounded on its own
// (diffusion_stencil.cuh's add / sub / mul: no fused multiply-add), as the
// plain version's separate PyTorch operations round them; only the order
// of the dot products' sums differs.
//
// Bound on the H100: with the state in registers an iteration moves only p
// (written once, read once with its neighbours) and the blocks' partial
// sums: 2 * 4 * sz^2 bytes in f32, 0.13 MB at 128^2, 0.04 us at 3.35 TB/s.
// The practical floor is the latency of the loop's three grid barriers and
// two grid sums, which barrier_loop_kernel measures alone.
//
// Design: one persistent cooperative launch per call (cudaLaunchCooperative
// Kernel on the caller's stream), as many blocks of 512 threads as the
// cells need, at most as many as the card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs); C cells a
// thread (1, 2, 4, 8 or 16, the fewest that cover the grid; more raise).
//   * A thread owns its cells for the whole loop: x, r, z, inv_diag, p,
//     Ap and the stencil's coefficients stay in registers.  Only p crosses
//     threads, through global memory, read with ld.global.cg (L2).
//   * Reductions are deterministic and the same in every block: a block
//     sums its threads' values (an xor butterfly in each warp, so every
//     lane holds the same bits, then the warps in order) and writes one
//     partial; after the grid barrier every block sums all partials in the
//     same fixed order.  So every block takes the bitwise-same alpha, beta
//     and stop decision: a block that left the loop while another waited at
//     a barrier would hang the card.
//   * Three grid barriers an iteration (cooperative_groups grid sync):
//     after the p.Ap partials, after the r.r and r.z partials (one
//     barrier), and after p is written, before the stencil reads its
//     neighbours.  Each partial array is written again only after a barrier
//     that follows every read of it.
// No reordering (pipelined CG) that would change the rounding and the
// counts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "diffusion_stencil.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// v[k] summed over the block in one fixed order; every thread gets the same
// bits (x + y == y + x, so the butterfly's lanes agree).  sh is free again
// when it returns.
template <typename T, int NV>
__device__ __forceinline__ void block_sum(T (&v)[NV], T (*sh)[NV]) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
        }
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            sh[warp][k] = v[k];
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        T s = sh[0][k];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
            s += sh[w][k];
        }
        v[k] = s;
    }
    __syncthreads();
}

// The block's partial sums v into part[k * nb + block].
template <typename T, int NV>
__device__ __forceinline__ void write_partial(const T (&v)[NV], T* part,
                                              int nb) {
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            part[k * nb + blockIdx.x] = v[k];
        }
    }
}

// The grid's sums of the partials part[k * nb + b] over b, in the same
// order in every block (read from L2: other SMs wrote them).
template <typename T, int NV>
__device__ __forceinline__ void grid_sum(const T* part, int nb, T (&v)[NV],
                                         T (*sh)[NV]) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        v[k] = T(0);
    }
    for (int b = threadIdx.x; b < nb; b += kThreads) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            v[k] += __ldcg(part + k * nb + b);
        }
    }
    block_sum(v, sh);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads) pcg_kernel(
    const T* __restrict__ Dx,         // (sz - 1, sz)
    const T* __restrict__ Dy,         // (sz, sz - 1)
    const T* __restrict__ robin,      // (sz, sz)
    const T* __restrict__ sigma_a,    // (sz, sz)
    const T* __restrict__ diag,       // (sz, sz) the Jacobi diagonal
    const T* __restrict__ b,          // (sz, sz)
    T* __restrict__ x,                // (sz, sz) out
    T* p,                             // (sz, sz) scratch, shared by blocks
    T* part,                          // (3, blocks) scratch
    int* iters,                       // (1,) out
    int sz, T inv_dx2, T inv_dx, double tol2, int max_iter) {
    cg::grid_group grid = cg::this_grid();
    __shared__ T sh1[kWarps][1];
    __shared__ T sh2[kWarps][2];
    const int n = sz * sz;
    const int nb = gridDim.x;
    const int stride = nb * kThreads;
    T* part_pap = part;               // (1, nb)
    T* part_rr_rz = part + nb;        // (2, nb)

    aniso::Cell<T> cell[C];
    int idx[C];
    bool in[C];
    T xv[C], rv[C], iv[C], pv[C], zv[C], ap[C];
    T s2[2] = {T(0), T(0)};           // r.r, r.z
#pragma unroll
    for (int c = 0; c < C; ++c) {
        idx[c] = blockIdx.x * kThreads + threadIdx.x + c * stride;
        in[c] = idx[c] < n;
        xv[c] = rv[c] = iv[c] = pv[c] = zv[c] = ap[c] = T(0);
        cell[c] = aniso::Cell<T>{};
        if (in[c]) {
            cell[c] = aniso::load_cell(Dx, Dy, robin, sigma_a, idx[c], sz);
            iv[c] = T(1) / diag[idx[c]];
            rv[c] = b[idx[c]];
            zv[c] = aniso::mul(iv[c], rv[c]);
            pv[c] = zv[c];
            p[idx[c]] = pv[c];
            s2[0] = aniso::add(s2[0], aniso::mul(rv[c], rv[c]));
            s2[1] = aniso::add(s2[1], aniso::mul(rv[c], zv[c]));
        }
    }
    block_sum(s2, sh2);
    write_partial(s2, part_rr_rz, nb);
    grid.sync();
    grid_sum(part_rr_rz, nb, s2, sh2);
    T rr = s2[0];
    T rz = s2[1];
    const double stop = tol2 * (rr == T(0) ? 1.0 : (double)rr);
    int k = 0;
    while (k < max_iter && (double)rr > stop) {
        T s1[1] = {T(0)};             // p.Ap
#pragma unroll
        for (int c = 0; c < C; ++c) {
            if (in[c]) {
                const aniso::Cell<T>& e = cell[c];
                const int id = idx[c];
                ap[c] = aniso::apply_cell(
                    e, sz, pv[c], e.i < sz - 1 ? __ldcg(p + id + sz) : T(0),
                    e.i > 0 ? __ldcg(p + id - sz) : T(0),
                    e.j < sz - 1 ? __ldcg(p + id + 1) : T(0),
                    e.j > 0 ? __ldcg(p + id - 1) : T(0), inv_dx2, inv_dx);
                s1[0] = aniso::add(s1[0], aniso::mul(pv[c], ap[c]));
            }
        }
        block_sum(s1, sh1);
        write_partial(s1, part_pap, nb);
        grid.sync();
        grid_sum(part_pap, nb, s1, sh1);
        const T alpha = rz / s1[0];
        s2[0] = s2[1] = T(0);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            if (in[c]) {
                xv[c] = aniso::add(xv[c], aniso::mul(alpha, pv[c]));
                rv[c] = aniso::sub(rv[c], aniso::mul(alpha, ap[c]));
                zv[c] = aniso::mul(iv[c], rv[c]);
                s2[0] = aniso::add(s2[0], aniso::mul(rv[c], rv[c]));
                s2[1] = aniso::add(s2[1], aniso::mul(rv[c], zv[c]));
            }
        }
        block_sum(s2, sh2);
        write_partial(s2, part_rr_rz, nb);
        grid.sync();
        grid_sum(part_rr_rz, nb, s2, sh2);
        rr = s2[0];
        const T beta = s2[1] / rz;
        rz = s2[1];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            if (in[c]) {
                pv[c] = aniso::add(zv[c], aniso::mul(beta, pv[c]));
                p[idx[c]] = pv[c];
            }
        }
        ++k;
        grid.sync();
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
        if (in[c]) {
            x[idx[c]] = xv[c];
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        *iters = k;
    }
}

// K9's loop without its arithmetic: iters iterations of the same block
// sums, partial writes, grid sums and three grid barriers, on the grid K9
// takes for the same cells.  Its time is the loop's latency floor.
template <typename T>
__global__ void __launch_bounds__(kThreads) barrier_loop_kernel(T* part,
                                                                int iters) {
    cg::grid_group grid = cg::this_grid();
    __shared__ T sh1[kWarps][1];
    __shared__ T sh2[kWarps][2];
    const int nb = gridDim.x;
    for (int k = 0; k < iters; ++k) {
        T s1[1] = {T(1)};
        block_sum(s1, sh1);
        write_partial(s1, part, nb);
        grid.sync();
        grid_sum(part, nb, s1, sh1);
        T s2[2] = {s1[0], T(1)};
        block_sum(s2, sh2);
        write_partial(s2, part + nb, nb);
        grid.sync();
        grid_sum(part + nb, nb, s2, sh2);
        grid.sync();
    }
}

// The blocks instance C runs for n cells: as many as the cells need, if the
// card holds that many at once; else 0.
template <typename T, int C>
cudaError_t plan(int n, int* blocks) {
    int dev = 0, sms = 0, occ = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, pcg_kernel<T, C>, kThreads, 0);
    }
    const long long need =
        ((long long)n + (long long)kThreads * C - 1) / ((long long)kThreads * C);
    *blocks = need <= (long long)occ * sms ? (int)need : 0;
    return err;
}

// The fewest cells a thread (C) whose grid fits on the card at once, and
// its blocks; cudaErrorCooperativeLaunchTooLarge when none does.
template <typename T>
cudaError_t choose(int n, int* cells, int* blocks) {
    int dev = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev);
    }
    if (err != cudaSuccess) {
        return err;
    }
    if (!coop) {
        return cudaErrorNotSupported;
    }
#define ANISO_K9_TRY(CV)                      \
    err = plan<T, CV>(n, blocks);             \
    if (err != cudaSuccess) {                 \
        return err;                           \
    }                                         \
    if (*blocks > 0) {                        \
        *cells = CV;                          \
        return cudaSuccess;                   \
    }
    ANISO_K9_TRY(1)
    ANISO_K9_TRY(2)
    ANISO_K9_TRY(4)
    ANISO_K9_TRY(8)
    ANISO_K9_TRY(16)
#undef ANISO_K9_TRY
    return cudaErrorCooperativeLaunchTooLarge;
}

template <typename T, int C>
cudaError_t run(int blocks, const T* Dx, const T* Dy, const T* robin,
                const T* sigma_a, const T* diag, const T* b, T* x, T* p,
                T* part, int* iters, int sz, T inv_dx2, T inv_dx,
                double tol2, int max_iter, cudaStream_t stream) {
    void* args[] = {&Dx,   &Dy,    &robin,   &sigma_a, &diag,
                    &b,    &x,     &p,       &part,    &iters,
                    &sz,   &inv_dx2, &inv_dx, &tol2,   &max_iter};
    return cudaLaunchCooperativeKernel((const void*)pcg_kernel<T, C>,
                                       dim3(blocks), dim3(kThreads), args, 0,
                                       stream);
}

template <typename T>
int launch(const void* Dx, const void* Dy, const void* robin,
           const void* sigma_a, const void* diag, const void* b, void* x,
           void* p, void* part, int part_len, void* iters, int sz,
           double inv_dx2, double inv_dx, double tol2, int max_iter,
           void* stream) {
    int cells = 0, blocks = 0;
    cudaError_t err = choose<T>(sz * sz, &cells, &blocks);
    if (err != cudaSuccess) {
        return (int)err;
    }
    if (3 * blocks > part_len) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t st = (cudaStream_t)stream;
#define ANISO_K9_RUN(CV)                                                  \
    case CV:                                                              \
        err = run<T, CV>(                                                 \
            blocks, static_cast<const T*>(Dx), static_cast<const T*>(Dy), \
            static_cast<const T*>(robin), static_cast<const T*>(sigma_a), \
            static_cast<const T*>(diag), static_cast<const T*>(b),        \
            static_cast<T*>(x), static_cast<T*>(p), static_cast<T*>(part),\
            static_cast<int*>(iters), sz, (T)inv_dx2, (T)inv_dx, tol2,    \
            max_iter, st);                                                \
        break;
    switch (cells) {
        ANISO_K9_RUN(1)
        ANISO_K9_RUN(2)
        ANISO_K9_RUN(4)
        ANISO_K9_RUN(8)
        ANISO_K9_RUN(16)
        default:
            return (int)cudaErrorInvalidValue;
    }
#undef ANISO_K9_RUN
    if (err != cudaSuccess) {
        return (int)err;
    }
    return (int)cudaGetLastError();
}

template <typename T>
int launch_barriers(void* part, int part_len, int n, int iters,
                    void* stream) {
    int cells = 0, blocks = 0;
    cudaError_t err = choose<T>(n, &cells, &blocks);
    if (err != cudaSuccess) {
        return (int)err;
    }
    if (3 * blocks > part_len) {
        return (int)cudaErrorInvalidValue;
    }
    T* pt = static_cast<T*>(part);
    void* args[] = {&pt, &iters};
    err = cudaLaunchCooperativeKernel((const void*)barrier_loop_kernel<T>,
                                      dim3(blocks), dim3(kThreads), args, 0,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) {
        return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace

#define ANISO_K9_ENTRY(NAME, T)                                             \
    extern "C" int NAME(const void* Dx, const void* Dy, const void* robin,  \
                        const void* sigma_a, const void* diag,              \
                        const void* b, void* x, void* p, void* part,        \
                        int part_len, void* iters, int sz, double inv_dx2,  \
                        double inv_dx, double tol2, int max_iter,           \
                        void* stream) {                                     \
        return launch<T>(Dx, Dy, robin, sigma_a, diag, b, x, p, part,       \
                         part_len, iters, sz, inv_dx2, inv_dx, tol2,        \
                         max_iter, stream);                                 \
    }
ANISO_K9_ENTRY(aniso_pcg_f32, float)
ANISO_K9_ENTRY(aniso_pcg_f64, double)
#undef ANISO_K9_ENTRY

// The barrier floor: iters iterations of K9's loop skeleton on K9's grid
// for n cells (part: 3 x blocks values of scratch).
extern "C" int aniso_pcg_barriers_f32(void* part, int part_len, int n,
                                      int iters, void* stream) {
    return launch_barriers<float>(part, part_len, n, iters, stream);
}

extern "C" int aniso_pcg_barriers_f64(void* part, int part_len, int n,
                                      int iters, void* stream) {
    return launch_barriers<double>(part, part_len, n, iters, stream);
}
