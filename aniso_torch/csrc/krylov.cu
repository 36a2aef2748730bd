// K11 and K12: one Arnoldi step of the restarted GMRES on the card, for
// sm_90a, with the Krylov state in one float64 buffer that the kernels read
// and write, so that nothing is read back to the host inside a step and a
// step can be replayed from a CUDA graph.
//
// Replaces the body of aniso_tpu/solver/gmres.py's inner lax.while_loop
// (:158-193), which the JAX package runs on the device with its stopping
// test there too (:154-156, :191-192):
//
//   K11, the CGS2 projection (_dots / _comb, :45-58, mask :162-167,
//   :168-170): h1 = V[:i+1] w;  w' = w - h1 V;  h2 = V[:i+1] w';
//   w'' = w' - h2 V;  wnorm = |w''|;  V[i+1] = w'' / (wnorm or 1);
//   col = h1 + h2, col[i+1] = wnorm.  Here the new basis vector is also
//   written into u, the matvec's input buffer of the next step.
//
//   K12, the Givens step (:172-193; _givens :66-86, gmres.cpp:26-39): the
//   i earlier rotations on col, the new rotation from (col[i], col[i+1]),
//   s, H[:, i], resid = |s[i+1]| / normb, done = resid < tol, i += 1,
//   j += 1; and at the end of a cycle the back-substitution on the
//   leading i x i block (:200-212), y into the state.
//
// A step is active iff !done && i < m && j <= max_iter (:154-156).  Every
// kernel reads that from the state first and returns at once when the step
// is not: an inactive step changes neither V, u nor the state.
//
// State (float64, m = restart; layout() below and kernels/krylov.py's
// state_layout agree, as the wrappers check through
// aniso_krylov_state_len): i, j, done, normb, tol, max_iter, resid, one
// spare; H (m columns of m + 1), s (m + 1), cs (m), sn (m), col (m + 1),
// h2 (m + 1), y (m).  i, j, done and max_iter are integers held exactly.
//
// Arithmetic: the projections, their sums and the norm in float64 (the
// accumulator of both instances; V, w and u in the field's type, float32 or
// float64).  K12 rounds every product, sum and quotient on its own
// (__dmul_rn, __dadd_rn, ...: no fused multiply-add), as the plain version's
// separate operations and JAX's do.
//
// Bound on the H100: bytes.  K11 must read V[:i+1] and w and write V[i+1]
// and u: ((i + 1) + 3) n itemsize bytes at 3.35 TB/s (CGS2 as written reads
// V three times: 3 (i + 1) n itemsize).  K12 moves a few KB of state: its
// floor is one launch's latency, which floor_kernel measures alone.
//
// Design.  K11 is six launches on the caller's stream, no atomics, with
// 16-byte loads and stores where n and the vectors allow (one value a load
// otherwise):
//   (a) dots_kernel: each block sums V[k] w over its grid-stride share for
//       8 rows at a time held in registers (8 independent loads in
//       flight a thread), then one block sum a row: one partial a row;
//   finish_kernel: one block sums the partials of each row over the blocks
//       in block order (one warp a row) into the state;
//   (b) update_dots_kernel: w' = w - h1 V, stored, and h2's partials from
//       the same read of V: a thread keeps its elements of V's first 16
//       rows in shared memory, its own slots, and reads rows beyond that
//       again (from the L1 / L2 where they still are); a warp's butterfly
//       a row a tile, summed in the warp's slot;
//   finish_kernel for h2;
//   (c) norm_kernel: w'' = w' - h2 V, stored, and |w''|^2's partials;
//   (d) scale_kernel: every block sums the norm's partials in the same
//       order, then V[i+1] = u = w'' / scale; block 0 writes the column.
// Every sum runs in a fixed order, so a replay repeats bitwise.  K12 is one
// thread of one block: its work is O(i) dependent operations.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;        // (a), (c), (d) and the finishes
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;             // rows (a) holds in registers
constexpr int kStashThreads = 128;   // (b): one 16-byte pack a thread a tile
constexpr int kStashWarps = kStashThreads / 32;
constexpr int kStashRows = 16;       // rows (b) keeps in shared memory
constexpr int kBlocksPerSm = 4;      // the grid of (a), (c), (d)

enum { kI = 0, kJ = 1, kDone = 2, kNormb = 3, kTol = 4, kMaxIt = 5,
       kResid = 6, kHeader = 8 };

struct Layout {
    int H, s, cs, sn, col, h2, y, len;
};

__host__ __device__ inline Layout layout(int m) {
    Layout L;
    L.H = kHeader;
    L.s = L.H + m * (m + 1);
    L.cs = L.s + m + 1;
    L.sn = L.cs + m;
    L.col = L.sn + m;
    L.h2 = L.col + m + 1;
    L.y = L.h2 + m + 1;
    L.len = L.y + m;
    return L;
}

// i when the step is active, else -1.
__device__ __forceinline__ int active_row(const double* st, int m) {
    if (st[kDone] != 0.0 || st[kI] >= (double)m || st[kJ] > st[kMaxIt]) {
        return -1;
    }
    return (int)st[kI];
}

// The sum over the warp, the same bits in every lane.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
}

// VEC values of T as one aligned load or store (16 bytes when VEC > 1).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p, long long e) {
    return *reinterpret_cast<const Pack<T, VEC>*>(p + e);
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> zero_pack() {
    Pack<T, VEC> x;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
        x.v[q] = T(0);
    }
    return x;
}

// (a): part[b * (m + 1) + k] = block b's sum of V[k][e] w[e], k <= i:
// kRows rows at a time in registers, every element of the block's
// grid-stride share, then one block sum a row.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
dots_kernel(const T* __restrict__ V, const T* __restrict__ w,
            const double* __restrict__ st, double* __restrict__ part,
            long long n, int m) {
    const int i = active_row(st, m);
    if (i < 0) {
        return;
    }
    const int rows = i + 1;
    const long long nv = n / VEC;
    __shared__ double sh[kWarps][kRows];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k0 = 0; k0 < rows; k0 += kRows) {
        double acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            acc[r] = 0.0;
        }
        for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
             e < nv; e += (long long)gridDim.x * kThreads) {
            const Pack<T, VEC> wv = load<T, VEC>(w, e * VEC);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                if (k0 + r < rows) {
                    const Pack<T, VEC> v =
                        load<T, VEC>(V + (long long)(k0 + r) * n, e * VEC);
#pragma unroll
                    for (int q = 0; q < VEC; ++q) {
                        acc[r] += (double)v.v[q] * (double)wv.v[q];
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            acc[r] = warp_sum(acc[r]);
        }
        if (lane == 0) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                sh[warp][r] = acc[r];
            }
        }
        __syncthreads();
        if (threadIdx.x < kRows && k0 + (int)threadIdx.x < rows) {
            double s = 0.0;
            for (int wp = 0; wp < kWarps; ++wp) {
                s += sh[wp][threadIdx.x];
            }
            part[(long long)blockIdx.x * (m + 1) + k0 + threadIdx.x] = s;
        }
        __syncthreads();
    }
}

// st[dst + k] = sum over b < nb of part[b * (m + 1) + k], k <= i: one warp
// a row, lane l taking b = l, l + 32, ..., then the butterfly.
__global__ void __launch_bounds__(kThreads)
finish_kernel(const double* __restrict__ part, double* st, int nb, int m,
              int dst) {
    const int i = active_row(st, m);
    if (i < 0) {
        return;
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = warp; k <= i; k += kWarps) {
        double s = 0.0;
        for (int b = lane; b < nb; b += 32) {
            s += part[(long long)b * (m + 1) + k];
        }
        s = warp_sum(s);
        if (lane == 0) {
            st[dst + k] = s;
        }
    }
}

// Shared memory of (b) before its stash, in doubles: h1 and the warps'
// sums, rounded to 16 bytes.
__host__ __device__ inline int stash_offset(int m) {
    return (1 + kStashWarps) * (m + 1) + 1 & ~1;
}

// (b): w' = w - sum_k h1[k] V[k] (stored in w) and block b's partials of
// V[k] w' into part, from one read of V's first kStashRows rows: a thread
// keeps its elements of them in shared memory (its own slots, read back by
// itself alone); rows beyond are read again.  h1 in the state's col.
template <typename T, int VEC>
__global__ void __launch_bounds__(kStashThreads)
update_dots_kernel(const T* __restrict__ V, T* __restrict__ w,
                   const double* __restrict__ st, double* __restrict__ part,
                   long long n, int m) {
    const int i = active_row(st, m);
    if (i < 0) {
        return;
    }
    const Layout L = layout(m);
    const int rows = i + 1;
    const long long nv = n / VEC;
    extern __shared__ double sm[];
    double* h1 = sm;                            // [m + 1]
    double* wsum = sm + (m + 1);                // [kStashWarps][m + 1]
    Pack<T, VEC>* stash =                       // [kStashRows][threads]
        reinterpret_cast<Pack<T, VEC>*>(sm + stash_offset(m));
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = threadIdx.x; k < rows; k += kStashThreads) {
        h1[k] = st[L.col + k];
    }
    for (int k = threadIdx.x; k < kStashWarps * (m + 1);
         k += kStashThreads) {
        wsum[k] = 0.0;
    }
    __syncthreads();
    // every thread of a warp runs every tile: the butterflies need all lanes
    for (long long t0 = (long long)blockIdx.x * kStashThreads; t0 < nv;
         t0 += (long long)gridDim.x * kStashThreads) {
        const long long e = t0 + threadIdx.x;
        const bool in = e < nv;
        double acc[VEC];
        {
            const Pack<T, VEC> wv =
                in ? load<T, VEC>(w, e * VEC) : zero_pack<T, VEC>();
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                acc[q] = (double)wv.v[q];
            }
        }
#pragma unroll 4
        for (int k = 0; k < rows; ++k) {
            const Pack<T, VEC> v =
                in ? load<T, VEC>(V + (long long)k * n, e * VEC)
                   : zero_pack<T, VEC>();
            if (k < kStashRows) {
                stash[k * kStashThreads + threadIdx.x] = v;
            }
            const double h = h1[k];
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                acc[q] -= h * (double)v.v[q];
            }
        }
        Pack<T, VEC> wr;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
            wr.v[q] = (T)acc[q];
        }
        if (in) {
            *reinterpret_cast<Pack<T, VEC>*>(w + e * VEC) = wr;
        }
#pragma unroll 2
        for (int k = 0; k < rows; ++k) {
            const Pack<T, VEC> v =
                k < kStashRows ? stash[k * kStashThreads + threadIdx.x]
                : in ? load<T, VEC>(V + (long long)k * n, e * VEC)
                     : zero_pack<T, VEC>();
            double p = 0.0;
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                p += (double)v.v[q] * (double)wr.v[q];
            }
            p = warp_sum(p);
            if (lane == 0) {
                wsum[warp * (m + 1) + k] += p;
            }
        }
    }
    __syncthreads();
    for (int k = threadIdx.x; k < rows; k += kStashThreads) {
        double s = 0.0;
        for (int wp = 0; wp < kStashWarps; ++wp) {
            s += wsum[wp * (m + 1) + k];
        }
        part[(long long)blockIdx.x * (m + 1) + k] = s;
    }
}

// (c): w'' = w' - sum_k h2[k] V[k] (stored in w) and block b's partial of
// |w''|^2 in part[b].
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
norm_kernel(const T* __restrict__ V, T* __restrict__ w,
            const double* __restrict__ st, double* __restrict__ part,
            long long n, int m) {
    const int i = active_row(st, m);
    if (i < 0) {
        return;
    }
    const Layout L = layout(m);
    const int rows = i + 1;
    const long long nv = n / VEC;
    extern __shared__ double h2[];             // [rows], then [kWarps]
    for (int k = threadIdx.x; k < rows; k += kThreads) {
        h2[k] = st[L.h2 + k];
    }
    __syncthreads();
    double nrm = 0.0;
    for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
         e < nv; e += (long long)gridDim.x * kThreads) {
        double acc[VEC];
        {
            const Pack<T, VEC> wv = load<T, VEC>(w, e * VEC);
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                acc[q] = (double)wv.v[q];
            }
        }
#pragma unroll 4
        for (int k = 0; k < rows; ++k) {
            const Pack<T, VEC> v = load<T, VEC>(V + (long long)k * n, e * VEC);
            const double h = h2[k];
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                acc[q] -= h * (double)v.v[q];
            }
        }
        Pack<T, VEC> wr;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
            wr.v[q] = (T)acc[q];
            nrm += (double)wr.v[q] * (double)wr.v[q];
        }
        *reinterpret_cast<Pack<T, VEC>*>(w + e * VEC) = wr;
    }
    double* red = h2 + rows;
    nrm = warp_sum(nrm);
    if ((threadIdx.x & 31) == 0) {
        red[threadIdx.x >> 5] = nrm;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        double s = 0.0;
        for (int wp = 0; wp < kWarps; ++wp) {
            s += red[wp];
        }
        part[blockIdx.x] = s;
    }
}

// (d): wnorm from the nb partials (the same order in every block), then
// V[i+1] = u = w'' / (wnorm or 1); block 0 writes col = h1 + h2 and
// col[i+1] = wnorm.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
scale_kernel(T* __restrict__ V, const T* __restrict__ w, T* __restrict__ u,
             double* st, const double* __restrict__ part, int nb,
             long long n, int m) {
    const int i = active_row(st, m);
    if (i < 0) {
        return;
    }
    const Layout L = layout(m);
    __shared__ double wn;
    if (threadIdx.x < 32) {
        double s = 0.0;
        for (int b = threadIdx.x; b < nb; b += 32) {
            s += part[b];
        }
        s = warp_sum(s);
        if (threadIdx.x == 0) {
            wn = sqrt(s);
        }
    }
    __syncthreads();
    const double wnorm = wn;
    const double scale = wnorm == 0.0 ? 1.0 : wnorm;
    if (blockIdx.x == 0) {
        for (int k = threadIdx.x; k <= i + 1; k += kThreads) {
            st[L.col + k] = k <= i ? st[L.col + k] + st[L.h2 + k] : wnorm;
        }
    }
    T* out = V + (long long)(i + 1) * n;
    const long long nv = n / VEC;
    for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < nv;
         e += (long long)gridDim.x * kThreads) {
        const Pack<T, VEC> wv = load<T, VEC>(w, e * VEC);
        Pack<T, VEC> v;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
            v.v[q] = (T)((double)wv.v[q] / scale);
        }
        *reinterpret_cast<Pack<T, VEC>*>(out + e * VEC) = v;
        *reinterpret_cast<Pack<T, VEC>*>(u + e * VEC) = v;
    }
}

// K12's step: the Givens bookkeeping of JAX's body, one thread.
__global__ void givens_kernel(double* st, int m) {
    if (threadIdx.x != 0) {
        return;
    }
    const int i = active_row(st, m);
    if (i < 0) {
        return;
    }
    const Layout L = layout(m);
    double* col = st + L.col;
    double* cs = st + L.cs;
    double* sn = st + L.sn;
    double* s = st + L.s;
    for (int k = 0; k < i; ++k) {        // the earlier rotations
        const double t = __dadd_rn(__dmul_rn(cs[k], col[k]),
                                   __dmul_rn(sn[k], col[k + 1]));
        col[k + 1] = __dadd_rn(__dmul_rn(-sn[k], col[k]),
                               __dmul_rn(cs[k], col[k + 1]));
        col[k] = t;
    }
    const double dx = col[i], dy = col[i + 1];
    double c, g;
    if (dy == 0.0) {
        c = 1.0;
        g = 0.0;
    } else if (fabs(dy) > fabs(dx)) {
        const double t = __ddiv_rn(dx, dy);
        g = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(t, t))));
        c = __dmul_rn(t, g);
    } else {
        const double t = __ddiv_rn(dy, dx);
        c = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(t, t))));
        g = __dmul_rn(t, c);
    }
    cs[i] = c;
    sn[i] = g;
    col[i] = __dadd_rn(__dmul_rn(c, col[i]), __dmul_rn(g, col[i + 1]));
    col[i + 1] = 0.0;
    const double si = __dadd_rn(__dmul_rn(c, s[i]), __dmul_rn(g, s[i + 1]));
    const double si1 = __dadd_rn(__dmul_rn(-g, s[i]), __dmul_rn(c, s[i + 1]));
    s[i] = si;
    s[i + 1] = si1;
    double* Hc = st + L.H + i * (m + 1);
    for (int r = 0; r <= i + 1; ++r) {
        Hc[r] = col[r];
    }
    const double resid = __ddiv_rn(fabs(si1), st[kNormb]);
    st[kResid] = resid;
    st[kDone] = resid < st[kTol] ? 1.0 : 0.0;
    st[kI] = (double)(i + 1);
    st[kJ] = st[kJ] + 1.0;
}

// K12's back-substitution: y[:i] from the leading i x i block of H and
// s[:i] (gmres.cpp:12-24), y[i:] = 0; one thread.
__global__ void backsub_kernel(double* st, int m) {
    if (threadIdx.x != 0) {
        return;
    }
    const Layout L = layout(m);
    const int k = (int)st[kI];
    const double* H = st + L.H;
    const double* s = st + L.s;
    double* y = st + L.y;
    for (int r = m - 1; r >= k; --r) {
        y[r] = 0.0;
    }
    for (int r = k - 1; r >= 0; --r) {
        double acc = s[r];
        for (int c = r + 1; c < k; ++c) {
            acc = __dsub_rn(acc, __dmul_rn(H[c * (m + 1) + r], y[c]));
        }
        y[r] = __ddiv_rn(acc, H[r * (m + 1) + r]);
    }
}

__global__ void floor_kernel() {}

int sm_count() {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev) != cudaSuccess) {
        return 0;
    }
    return sms;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename T, int VEC>
int cgs2_vec(T* V, T* w, T* u, double* sd, double* pd, long long part_len,
             long long n, int m, cudaStream_t st) {
    const int sms = sm_count();
    if (sms == 0) {
        return (int)cudaErrorInvalidValue;
    }
    const Layout L = layout(m);
    const int rows = m + 1;
    const int smem_b = stash_offset(m) * (int)sizeof(double)
                       + kStashRows * kStashThreads * (int)sizeof(Pack<T, VEC>);
    // set once per size (the first call, outside any graph capture)
    static int smem_set = 48 * 1024, occ_at = -1, occ = 0;
    cudaError_t err = cudaSuccess;
    if (smem_b > smem_set) {
        err = cudaFuncSetAttribute(update_dots_kernel<T, VEC>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_b);
        if (err != cudaSuccess) {
            return (int)err;
        }
        smem_set = smem_b;
    }
    if (occ_at != smem_b) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &occ, update_dots_kernel<T, VEC>, kStashThreads, smem_b);
        if (err != cudaSuccess) {
            return (int)err;
        }
        occ_at = smem_b;
    }
    const long long nv = n / VEC;
    const int nb_a = (int)std::min(cdiv(nv, kThreads),
                                   (long long)kBlocksPerSm * sms);
    const int nb_b = (int)std::min(cdiv(nv, kStashThreads),
                                   (long long)std::max(occ, 1) * sms);
    if ((long long)std::max(nb_a, nb_b) * rows > part_len) {
        return (int)cudaErrorInvalidValue;
    }
    dots_kernel<T, VEC><<<nb_a, kThreads, 0, st>>>(V, w, sd, pd, n, m);
    finish_kernel<<<1, kThreads, 0, st>>>(pd, sd, nb_a, m, L.col);
    update_dots_kernel<T, VEC><<<nb_b, kStashThreads, smem_b, st>>>(
        V, w, sd, pd, n, m);
    finish_kernel<<<1, kThreads, 0, st>>>(pd, sd, nb_b, m, L.h2);
    norm_kernel<T, VEC><<<nb_a, kThreads, (rows + kWarps) * sizeof(double),
                          st>>>(V, w, sd, pd, n, m);
    scale_kernel<T, VEC><<<nb_a, kThreads, 0, st>>>(V, w, u, sd, pd, nb_a, n,
                                                     m);
    return (int)cudaGetLastError();
}

// 16-byte loads when every row and vector starts on 16 bytes, one value a
// load otherwise.
template <typename T>
int cgs2(void* V, void* w, void* u, void* state, void* part,
         long long part_len, long long n, int m, void* stream) {
    if (n <= 0 || m < 1) {
        return (int)cudaErrorInvalidValue;
    }
    constexpr int kVec = 16 / sizeof(T);
    const bool aligned =
        n % kVec == 0
        && ((reinterpret_cast<uintptr_t>(V) | reinterpret_cast<uintptr_t>(w)
             | reinterpret_cast<uintptr_t>(u)) & 15) == 0;
    T* Vt = static_cast<T*>(V);
    T* wt = static_cast<T*>(w);
    T* ut = static_cast<T*>(u);
    double* sd = static_cast<double*>(state);
    double* pd = static_cast<double*>(part);
    const cudaStream_t st = (cudaStream_t)stream;
    return aligned
               ? cgs2_vec<T, kVec>(Vt, wt, ut, sd, pd, part_len, n, m, st)
               : cgs2_vec<T, 1>(Vt, wt, ut, sd, pd, part_len, n, m, st);
}

}  // namespace

// K11: V (m + 1, n), w (n), u (n) in the field's type; state (layout(m).len)
// float64; part: at least part_len = 16 x SMs x (m + 1) float64 of scratch.
extern "C" int aniso_cgs2_f32(void* V, void* w, void* u, void* state,
                              void* part, long long part_len, long long n,
                              int m, void* stream) {
    return cgs2<float>(V, w, u, state, part, part_len, n, m, stream);
}

extern "C" int aniso_cgs2_f64(void* V, void* w, void* u, void* state,
                              void* part, long long part_len, long long n,
                              int m, void* stream) {
    return cgs2<double>(V, w, u, state, part, part_len, n, m, stream);
}

// K12: the Givens step of an active step (a no-op otherwise).
extern "C" int aniso_givens_step(void* state, int m, void* stream) {
    givens_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        static_cast<double*>(state), m);
    return (int)cudaGetLastError();
}

// K12's back-substitution at the end of a cycle.
extern "C" int aniso_givens_backsub(void* state, int m, void* stream) {
    backsub_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        static_cast<double*>(state), m);
    return (int)cudaGetLastError();
}

// The launch floor K12 is held against: an empty one-block launch.
extern "C" int aniso_krylov_floor(void* stream) {
    floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// The state's length in float64 for restart m (kernels/krylov.py checks its
// own layout against it).
extern "C" int aniso_krylov_state_len(int m) { return layout(m).len; }
