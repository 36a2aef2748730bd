// K2: the near-field contraction of the corrected FMM matvec, for sm_90a,
// in two instances from one template: float32 (the fast path) and float64
// (the refinement twin and the plain f64 solve), each for one Fourier mode
// or for all D modes of one charge at once.
//
// Replaces aniso_tpu/fmm/apply.py:_near_block_contract (:577) with the
// rest of _near_apply (:639-681), its window extraction _patch_3x3 (:554)
// and the per-mode loop around it in fmm_apply_all_modes (:762-767).  For
// every mode d, square (i, j) and target node t:
//
//   out[d, i, j, t] = sum_{a, b, s} (expm1(-E[i, j, t, a, b, s]) * cosrw[d, t, a, b, s]
//                                    + S[d, t, a, b, s]) * u[i + a - 1, j + b - 1, s]
//                   + sigma_w[i, j, t] * u[i, j, t]              (d = 0 only)
//                   + sum_s duffy[d, i, j, t, s] * u[i, j, s]    (compat mode only)
//
// with u zero off the grid.  sigma_w and duffy are optional (null); the
// caller passes sigma_w only when slot 0 is Fourier mode 0.
//
// Bound on the H100: bytes.  E is read once per charge whatever D is, 81 nq
// values per square (11.9 MB in f32 at 64^2, deg 3: ~3.6 us at 3.35 TB/s;
// 1.53 GB in f64 at 512^2: ~0.46 ms); u, the tables (2 D nq 81 values, read
// through the cache) and the D outputs are small.  One block per square
// stages the zero-padded 3 x 3 neighbourhood of u in shared memory (no
// im2col tensor), and each warp reduces the 9 nq contiguous values of E of
// one target node (layout (sz, sz, nq, 3, 3, nq), square major, which
// set_coeff writes): one expm1 per value, then per mode two multiply-adds
// into a register accumulator, in fixed chunks of kModeChunk modes; the
// diagonal and Duffy terms go into the epilogue.  expm1f / expm1, not
// exp - 1: E is small on near pairs and the difference would cancel.  The
// library is built without fast math.
//
// K2-S, K2 on one shard of a domain decomposition (the kShard instances):
// replaces the contraction of aniso_tpu/parallel/halo.py:
// make_near_apply_shardmap (:56, body :70-81).  The grid is the shard's
// (lx, ly) block of squares, with its contiguous slices of E, sigma_w and
// duffy, and u comes halo-extended by one square on each side, (lx + 2,
// ly + 2, nq), filled by K10 (csrc/halo_fill.cu): the neighbourhood load
// reads it with no bounds test.  Everything else is K2's code; the bound is
// K2's on the shard's bytes (a 256 x 128 shard of 512^2 reads 1/8 of E).

#include <cuda_runtime.h>

namespace {

constexpr int kModeChunk = 9;

__device__ __forceinline__ float expm1_(float v) { return expm1f(v); }
__device__ __forceinline__ double expm1_(double v) { return expm1(v); }

// The end of one target node's row for one mode: the Duffy term (the nq
// weights at duffy + row, when there is a Duffy table) and the warp's sum,
// which lane 0 gets.
template <typename T>
__device__ __forceinline__ T finish_row(T v, const T* __restrict__ duffy,
                                        size_t row, const T* uc, int nq,
                                        int lane) {
    if (duffy != nullptr) {
        const T* dt = duffy + row;
        for (int s = lane; s < nq; s += 32) {
            v += dt[s] * uc[s];
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
    }
    return v;
}

// The grid is (nx, ny) squares: the whole (sz, sz) grid, u zero off it, or
// with kShard a shard's block, u halo-extended to (nx + 2, ny + 2, nq).
template <typename T, int DC, bool kShard>
__global__ void near_contract_kernel(
    const T* __restrict__ E,            // (nx, ny, nq, 3, 3, nq)
    const T* __restrict__ cosrw,        // (D, nq, 3, 3, nq)
    const T* __restrict__ S,            // (D, nq, 3, 3, nq)
    const T* __restrict__ u,            // (nx, ny, nq), or extended
    const T* __restrict__ sigma_w,      // (nx, ny, nq) or null
    const T* __restrict__ duffy,        // (D, nx, ny, nq, nq) or null
    T* __restrict__ out,                // (D, nx, ny, nq)
    int nx, int ny, int nq, int D) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* un = reinterpret_cast<T*>(smem);  // (3, 3, nq) neighbourhood of u
    const int K = 9 * nq;
    const int i = blockIdx.x / ny;
    const int j = blockIdx.x - i * ny;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        const int ab = k / nq;
        const int s = k - ab * nq;
        if constexpr (kShard) {
            const int ii = i + ab / 3;
            const int jj = j + ab % 3;
            un[k] = u[((size_t)ii * (ny + 2) + jj) * nq + s];
        } else {
            const int ii = i + ab / 3 - 1;
            const int jj = j + ab % 3 - 1;
            T v = 0;
            if (ii >= 0 && ii < nx && jj >= 0 && jj < ny) {
                v = u[((size_t)ii * ny + jj) * nq + s];
            }
            un[k] = v;
        }
    }
    __syncthreads();

    const T* uc = un + 4 * nq;          // the square's own values
    const size_t sq = (size_t)blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    if constexpr (DC == 1) {
        // one mode: a single accumulator and nothing of the mode axis, so
        // that this instance keeps its registers and its occupancy
        for (int t = warp; t < nq; t += nwarps) {
            const size_t row = (sq * nq + t) * K;
            const T* Et = E + row;
            const T* ct = cosrw + (size_t)t * K;
            const T* st = S + (size_t)t * K;
            T acc = 0;
            for (int k = lane; k < K; k += 32) {
                acc += (expm1_(-Et[k]) * ct[k] + st[k]) * un[k];
            }
            acc = finish_row(acc, duffy, (sq * nq + t) * nq, uc, nq, lane);
            if (lane == 0) {
                if (sigma_w != nullptr) {
                    acc += sigma_w[sq * nq + t] * uc[t];
                }
                out[sq * nq + t] = acc;
            }
        }
    } else {
        const size_t field = (size_t)nx * ny * nq;
        const size_t table = (size_t)nq * K;
        for (int t = warp; t < nq; t += nwarps) {
            const T* Et = E + (sq * nq + t) * K;
            for (int d0 = 0; d0 < D; d0 += DC) {
                const int nd = min(DC, D - d0);
                const T* ct = cosrw + (size_t)d0 * table + (size_t)t * K;
                const T* st = S + (size_t)d0 * table + (size_t)t * K;
                T acc[DC];
#pragma unroll
                for (int d = 0; d < DC; ++d) {
                    acc[d] = T(0);
                }
                for (int k = lane; k < K; k += 32) {
                    const T e = expm1_(-Et[k]);
                    const T uk = un[k];
#pragma unroll
                    for (int d = 0; d < DC; ++d) {
                        if (d < nd) {
                            acc[d] += (e * ct[d * table + k]
                                       + st[d * table + k]) * uk;
                        }
                    }
                }
#pragma unroll
                for (int d = 0; d < DC; ++d) {
                    if (d < nd) {
                        const size_t at = (size_t)(d0 + d) * field + sq * nq + t;
                        T v = finish_row(acc[d], duffy, at * nq, uc, nq, lane);
                        if (lane == 0) {
                            if (sigma_w != nullptr && d0 + d == 0) {
                                v += sigma_w[sq * nq + t] * uc[t];
                            }
                            out[at] = v;
                        }
                    }
                }
            }
        }
    }
}

template <typename T, bool kShard>
int launch(const void* E, const void* cosrw, const void* S, const void* u,
           const void* sigma_w, const void* duffy, void* out, int nx,
           int ny, int nq, int D, void* stream) {
    const int warps = nq < 32 ? nq : 32;
    const size_t smem = (size_t)9 * nq * sizeof(T);
    // one mode takes the single-accumulator instance
    auto kernel = D == 1 ? near_contract_kernel<T, 1, kShard>
                         : near_contract_kernel<T, kModeChunk, kShard>;
    kernel<<<nx * ny, 32 * warps, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(E), static_cast<const T*>(cosrw),
        static_cast<const T*>(S), static_cast<const T*>(u),
        static_cast<const T*>(sigma_w), static_cast<const T*>(duffy),
        static_cast<T*>(out), nx, ny, nq, D);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aniso_near_contract_f32(
    const void* E, const void* cosrw, const void* S, const void* u,
    const void* sigma_w, const void* duffy, void* out, int sz, int nq,
    int D, void* stream) {
    return launch<float, false>(E, cosrw, S, u, sigma_w, duffy, out, sz, sz,
                                nq, D, stream);
}

extern "C" int aniso_near_contract_f64(
    const void* E, const void* cosrw, const void* S, const void* u,
    const void* sigma_w, const void* duffy, void* out, int sz, int nq,
    int D, void* stream) {
    return launch<double, false>(E, cosrw, S, u, sigma_w, duffy, out, sz, sz,
                                 nq, D, stream);
}

// K2-S: ue is the shard's halo-extended (lx + 2, ly + 2, nq) block
extern "C" int aniso_near_contract_shard_f32(
    const void* E, const void* cosrw, const void* S, const void* ue,
    const void* sigma_w, const void* duffy, void* out, int lx, int ly,
    int nq, int D, void* stream) {
    return launch<float, true>(E, cosrw, S, ue, sigma_w, duffy, out, lx, ly,
                               nq, D, stream);
}

extern "C" int aniso_near_contract_shard_f64(
    const void* E, const void* cosrw, const void* S, const void* ue,
    const void* sigma_w, const void* duffy, void* out, int lx, int ly,
    int nq, int D, void* stream) {
    return launch<double, true>(E, cosrw, S, ue, sigma_w, duffy, out, lx, ly,
                                nq, D, stream);
}
