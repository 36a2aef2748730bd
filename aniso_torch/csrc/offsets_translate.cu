// K3: the per-offset M2L translate of one fine FMM level, for sm_90a, in two
// instances from one template: float32 (fine levels the dense budget
// evicts) and float64 (every fine level of the refinement twin), each for
// all D Fourier modes of one charge at once (D = 1: one mode).
//
// Replaces aniso_tpu/fmm/apply.py:_offsets_translate_impl (:440-521, with
// its loop over the modes at :509-520, reached through
// _m2l_translate_offsets_multi :427) with its producer _vlist_gather (:158)
// and _interleave_classes (:230).  The level stores no E: for each of the
// 54 canonical (class, offset) entries e = (c, o, px, py, di, dj) of the
// plan (kernels/offsets.py offset_plan_np) and each box (x, y) of the
// (m2, m2) parity plane
//
//   E[a, b]  = sum_k win[x, y, k] * Wo_e[k, a * r + b]       (re-formed E)
//   X        = exp(-E)                                       (one exp)
//   L[d, 2x+px, 2y+py, a]    += sum_b X[a, b] * cosr[d, c, a, o, b]   * M[src(c, o, x, y), b]
//   L[d, 2xt+px2, 2yt+py2, b] += sum_a X[a, b] * cosr[d, c2, b, o2, a] * M[src(c2, o2, xt, yt), a]
//
// for every mode d: the window GEMM and the exponential serve all modes.
// win is the B-granular bounding-box window of the coefficient field
// (cells [px B + min(0, di B) + 2Bx, + (|di|+1) B) x [...] in (a, b, q)
// order, zero off the grid), Wo_e is the entry's static weight block
// (grid.dx folded in), and the second line is the mirror: the line-integral
// symmetry E(a->b) = E(b->a) reuses X transposed for the partner entry
// (c2, o2) on the box (xt, yt) = (x + sx, y + sy) of class c2's plane,
// added only where that box is on the plane.  src is the V-list source of
// parity_shift_table_np (zero off the plane), as in K1.
//
// Bound on the H100: operations.  At 512^2, deg 3 (nq 9), np 4 (r 16) each
// fine level is 120.8 GFLOP of window GEMM (sum over entries of
// 2 m2^2 r^2 K_e, K_e = (|di|+1)(|dj|+1) B^2 nq; the same at every depth),
// i.e. 241.6 GFLOP per f64 twin sweep, with ~1.1 G exponentials, plus
// (2 + 4 D) m2^2 r^2 operations per entry for the contractions, while the
// bytes it must move are the 19 MB f64 coefficient field, the ~15 MB of
// weights and the multipoles: at 67 TFLOP/s (f64 on the tensor cores, the
// card's fastest f64 rate; 34 on the CUDA cores) a level takes >= 1.8 ms,
// at 3.35 TB/s its bytes take ~0.01 ms.
//
// Design (a simple CUDA-core kernel; DMMA, wgmma and TMA are later work):
// one block per (entry, box row x, tile of kNB boxes along y).  Thread p
// owns the pair p = a * r + b and keeps E of the tile's kNB boxes in
// registers, so each weight read (coalesced over p) serves kNB boxes; the
// windows are gathered straight from the coefficient field into shared
// memory in chunks of kKC, so neither the padded field nor a window tensor
// is materialised.  After exp, the two contractions go through shared
// memory (sum over b for the direct add, over a for the mirror) and are
// accumulated into L with atomicAdd.  With several modes, X is first
// multiplied by the direct and by the mirror source multipole (neither
// depends on the mode) and kept in 2 kNB registers, and the two
// contractions then run once per mode (four barriers and 2 kNB r atomics
// each); the one-mode instance is compiled without that (kModes = false),
// because the extra registers cost it a block of occupancy per SM.
// atomicAdd is native for f32 and f64 on sm_90; an
// L value receives the 27 offsets' contributions in an order that changes
// from run to run, so two runs agree to rounding (about 27 ulp of the
// largest term), not bitwise.  expf / exp, not __expf: the library is
// built without fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kOffsets = 27;
constexpr int kPlanCols = 12;   // c o px py di dj c2 o2 sx sy woff K
constexpr int kNB = 16;         // boxes per block, along y
constexpr int kKC = 32;         // contraction chunk staged in shared memory

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }

// M at the V-list source of (class c, offset o) for target box (x, y), or 0
// off the parity plane.
template <typename T>
__device__ __forceinline__ T source(const T* M, const int* shift, int c,
                                    int o, int x, int y, int m2, int r,
                                    int k) {
    const int* t = shift + (c * kOffsets + o) * 4;
    const int bx = x + t[2] - 1;
    const int by = y + t[3] - 1;
    if (bx < 0 || bx >= m2 || by < 0 || by >= m2) {
        return T(0);
    }
    return M[((size_t)(2 * bx + t[0]) * (2 * m2) + (2 * by + t[1])) * r + k];
}

// The direct add of a tile: L[2x+px, 2y+py, a] += sum_b red[n, a, b] for
// the tile's boxes y = y0 + n inside the plane (red holds the products).
template <typename T>
__device__ __forceinline__ void add_direct(const T* red, T* L, int x, int y0,
                                           int px, int py, int m2, int r) {
    const int r2 = r * r;
    const int m = 2 * m2;
    for (int j = threadIdx.x; j < kNB * r; j += blockDim.x) {
        const int n = j / r;
        const int ta = j - n * r;
        const int y = y0 + n;
        if (y < m2) {
            const T* rn = red + n * r2 + ta * r;
            T s = T(0);
            for (int tb = 0; tb < r; ++tb) {
                s += rn[tb];
            }
            atomicAdd(&L[((size_t)(2 * x + px) * m + (2 * y + py)) * r + ta],
                      s);
        }
    }
}

// The mirror add: L[2xt+px2, 2yt+py2, b] += sum_a red[n, a, b] for the
// shifted boxes (xt, yt = y0 + n + sy) that lie inside the plane.
template <typename T>
__device__ __forceinline__ void add_mirror(const T* red, T* L, int xt, int y0,
                                           int sy, int px2, int py2, int m2,
                                           int r) {
    const int r2 = r * r;
    const int m = 2 * m2;
    for (int j = threadIdx.x; j < kNB * r; j += blockDim.x) {
        const int n = j / r;
        const int tb = j - n * r;
        const int yt = y0 + n + sy;
        if (y0 + n < m2 && xt >= 0 && xt < m2 && yt >= 0 && yt < m2) {
            const T* rn = red + n * r2 + tb;
            T s = T(0);
            for (int ta = 0; ta < r; ++ta) {
                s += rn[ta * r];
            }
            atomicAdd(&L[((size_t)(2 * xt + px2) * m + (2 * yt + py2)) * r + tb],
                      s);
        }
    }
}

template <typename T, bool kModes>
__global__ void offsets_translate_kernel(
    const T* __restrict__ Wo,         // per key (K, r*r), back to back
    const T* __restrict__ coeffs,     // (sz, sz, nq)
    const T* __restrict__ cosr,       // (D, 4, r, 27 r)
    const T* __restrict__ M,          // (2 m2, 2 m2, r)
    const int* __restrict__ shift,    // (4, 27, 4)
    const int* __restrict__ plan,     // (entries, kPlanCols)
    T* __restrict__ L,                // (D, 2 m2, 2 m2, r), zeroed
    int sz, int nq, int m2, int B, int r, int D) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* win = reinterpret_cast<T*>(smem);   // (kKC, kNB) window chunk
    T* red = win + kKC * kNB;              // (kNB, r*r) products

    const int* e = plan + blockIdx.z * kPlanCols;
    const int c = e[0], o = e[1], px = e[2], py = e[3], di = e[4], dj = e[5];
    const int c2 = e[6], o2 = e[7], sx = e[8], sy = e[9];
    const T* W = Wo + (size_t)(unsigned)e[10];
    const int K = e[11];
    const int bby = (abs(dj) + 1) * B;
    const int r2 = r * r;
    const int ob = kOffsets * r;
    const int x = blockIdx.y;
    const int y0 = blockIdx.x * kNB;
    const int row0 = px * B + min(0, di * B) + 2 * B * x;
    const int col0 = py * B + min(0, dj * B) + 2 * B * y0;
    const int p = threadIdx.x;
    const bool active = p < r2;

    // E of the tile's boxes: (K, r*r) weights against (K, kNB) windows
    T acc[kNB];
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
        acc[n] = T(0);
    }
    for (int k0 = 0; k0 < K; k0 += kKC) {
        __syncthreads();
        for (int i = threadIdx.x; i < kKC * kNB; i += blockDim.x) {
            const int n = i / kKC;
            const int kk = i - n * kKC;
            const int k = k0 + kk;
            T v = T(0);
            if (k < K && y0 + n < m2) {
                const int q = k % nq;
                const int ab = k / nq;
                const int row = row0 + ab / bby;
                const int col = col0 + 2 * B * n + ab % bby;
                if (row >= 0 && row < sz && col >= 0 && col < sz) {
                    v = coeffs[((size_t)row * sz + col) * nq + q];
                }
            }
            win[kk * kNB + n] = v;
        }
        __syncthreads();
        if (active) {
            const int kend = min(kKC, K - k0);
            const T* Wk = W + (size_t)k0 * r2 + p;
            for (int kk = 0; kk < kend; ++kk) {
                const T w = Wk[(size_t)kk * r2];
#pragma unroll
                for (int n = 0; n < kNB; ++n) {
                    acc[n] += w * win[kk * kNB + n];
                }
            }
        }
    }

    const int a = p / r;
    const int b = p - a * r;
    const int m = 2 * m2;

    if constexpr (!kModes) {
        // one mode: X stays in the registers that held E, the sources are
        // read where they are used (this instance keeps its registers and
        // with them its occupancy)
        // direct: L[2x+px, 2y+py, a] += sum_b X cosr[c, a, o, b] M[src, b]
        const T cd = active ? cosr[((size_t)c * r + a) * ob + o * r + b] : T(0);
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
            T v = T(0);
            if (active) {
                acc[n] = exp_(-acc[n]);
                if (y0 + n < m2) {
                    v = acc[n] * cd
                        * source(M, shift, c, o, x, y0 + n, m2, r, b);
                }
                red[n * r2 + p] = v;
            }
        }
        __syncthreads();
        add_direct(red, L, x, y0, px, py, m2, r);
        __syncthreads();

        // mirror: L[2xt+px2, 2yt+py2, b] += sum_a X cosr[c2, b, o2, a] M[src2, a]
        const int xt = x + sx;
        const T cm = active ? cosr[((size_t)c2 * r + b) * ob + o2 * r + a] : T(0);
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
            const int yt = y0 + n + sy;
            T v = T(0);
            if (active) {
                if (y0 + n < m2 && xt >= 0 && xt < m2 && yt >= 0 && yt < m2) {
                    v = acc[n] * cm
                        * source(M, shift, c2, o2, xt, yt, m2, r, a);
                }
                red[n * r2 + p] = v;
            }
        }
        __syncthreads();
        add_mirror(red, L, xt, y0, sy, c2 >> 1, c2 & 1, m2, r);
    } else {
        // all modes: X = exp(-E) times the direct source M[src(c, o), b]
        // (kept in acc) and times the mirror source M[src(c2, o2) of the
        // shifted box, a] (xm), neither of which depends on the mode
        const int xt = x + sx;
        T xm[kNB];
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
            const int yt = y0 + n + sy;
            T vd = T(0), vm = T(0);
            if (active && y0 + n < m2) {
                const T X = exp_(-acc[n]);
                vd = X * source(M, shift, c, o, x, y0 + n, m2, r, b);
                if (xt >= 0 && xt < m2 && yt >= 0 && yt < m2) {
                    vm = X * source(M, shift, c2, o2, xt, yt, m2, r, a);
                }
            }
            acc[n] = vd;
            xm[n] = vm;
        }

        const size_t plane = (size_t)m * m * r;
        const size_t mode_stride = (size_t)4 * r * ob;
        for (int d = 0; d < D; ++d) {
            const T* cos_d = cosr + (size_t)d * mode_stride;
            T* Ld = L + (size_t)d * plane;
            // direct: L[d, 2x+px, 2y+py, a] += sum_b X cosr[d, c, a, o, b] M[src, b]
            if (active) {
                const T cd = cos_d[((size_t)c * r + a) * ob + o * r + b];
#pragma unroll
                for (int n = 0; n < kNB; ++n) {
                    red[n * r2 + p] = acc[n] * cd;
                }
            }
            __syncthreads();
            add_direct(red, Ld, x, y0, px, py, m2, r);
            __syncthreads();

            // mirror: L[d, 2xt+px2, 2yt+py2, b] += sum_a X cosr[d, c2, b, o2, a] M[src2, a]
            if (active) {
                const T cm = cos_d[((size_t)c2 * r + b) * ob + o2 * r + a];
#pragma unroll
                for (int n = 0; n < kNB; ++n) {
                    red[n * r2 + p] = xm[n] * cm;
                }
            }
            __syncthreads();
            add_mirror(red, Ld, xt, y0, sy, c2 >> 1, c2 & 1, m2, r);
            __syncthreads();
        }
    }
}

template <typename T>
int launch(const void* Wo, const void* coeffs, const void* cosr,
           const void* M, const void* shift, const void* plan,
           int n_entries, void* L, int sz, int nq, int m2, int B, int r,
           int D, void* stream) {
    const int r2 = r * r;
    const int threads = (r2 + 31) / 32 * 32;
    const size_t smem = (size_t)(kKC * kNB + kNB * r2) * sizeof(T);
    auto kernel = D == 1 ? offsets_translate_kernel<T, false>
                         : offsets_translate_kernel<T, true>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) {
            return (int)err;
        }
    }
    const dim3 grid((m2 + kNB - 1) / kNB, m2, n_entries);
    kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(Wo), static_cast<const T*>(coeffs),
        static_cast<const T*>(cosr), static_cast<const T*>(M),
        static_cast<const int*>(shift), static_cast<const int*>(plan),
        static_cast<T*>(L), sz, nq, m2, B, r, D);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aniso_offsets_translate_f32(
    const void* Wo, const void* coeffs, const void* cosr, const void* M,
    const void* shift, const void* plan, int n_entries, void* L, int sz,
    int nq, int m2, int B, int r, int D, void* stream) {
    return launch<float>(Wo, coeffs, cosr, M, shift, plan, n_entries, L, sz,
                         nq, m2, B, r, D, stream);
}

extern "C" int aniso_offsets_translate_f64(
    const void* Wo, const void* coeffs, const void* cosr, const void* M,
    const void* shift, const void* plan, int n_entries, void* L, int sz,
    int nq, int m2, int B, int r, int D, void* stream) {
    return launch<double>(Wo, coeffs, cosr, M, shift, plan, n_entries, L, sz,
                          nq, m2, B, r, D, stream);
}
