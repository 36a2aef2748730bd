// K1: the fused dense M2L translate of one FMM level, for sm_90a, in two
// instances from one template: float32 (the fast path) and float64 (the
// refinement twin's coarse levels and the plain f64 solve), each for one
// Fourier mode or for all D modes of one charge at once.
//
// Replaces aniso_tpu/fmm/apply.py:_m2l_translate (dense branch, :317-372)
// together with its producer _vlist_gather (:158) and _interleave_classes
// (:230), and the per-mode loop around it in fmm_apply_all_modes (:745-750).
// For every mode d, parity class c = 2px+py and box (x, y) of the level's
// (m2, m2) parity plane:
//
//   L[d, 2x+px, 2y+py, a] = sum_{o, b} exp(-E[c, x, y, a, o, b])
//                               * cosr[d, c, a, o, b] * M[src(c, o, x, y), b]
//
// where the source box of V-list offset o is one box away at most on its
// parity plane: src = (2(x + shx) + sx, 2(y + shy) + sy) with
// (sx, sy, shx + 1, shy + 1) = shift[c, o] (parity_shift_table_np), and the
// source is zero when it falls off the plane.  E and M do not depend on the
// mode; only the cos(d theta)/r table does.
//
// Bound on the H100: bytes.  E is read once per charge, 4 * r * 27r values
// per box (150.8 MB in f32 over levels 2-6 at 64^2, deg 3, np 4: ~45 us at
// 3.35 TB/s; 9.9 GB over levels 2-9 at 512^2: 2.95 ms), plus D tables of
// 4 * r * 27r values, against one exp and (1 + D) multiply-adds per value.
// Both kernels read E exactly once, coalesced, and gather the 27 x r source
// multipoles of a box straight from M into shared memory (no gsel tensor).
//
// One mode (m2l_translate_kernel): one block per (c, x, y), its warps take
// the r target points in turn, a warp reduces a whole 27r-value row of E
// (contiguous in the layout (4, m2, m2, r, 27r) that set_coeff writes) for
// one target point a; the table row comes through the cache.  It reaches
// ~60% of its byte bound at 512^2.
//
// All modes (m2l_translate_modes_kernel), r a compile-time parameter
// (np 2-5 in both instances, and np 6-7 in float32).  For a fixed class c
// and target point a the sum is a product (boxes x 27r) @ (27r x D) whose
// right-hand side, the table slice cosr[:, c, a, :], is the same for every
// box of the class.  Eight lanes share a row of E, 16 bytes each where r
// values are a multiple of 16 bytes (one value each otherwise), so that a
// warp instruction reads four runs of 128 contiguous bytes, and a lane
// holds NB boxes (4 in f32, 2 in f64 and for np 6-7):
//   * E is streamed with vector loads (ld.global.cs, read once), one vector
//     of each of the lane's NB rows per step, loaded a step ahead; the last
//     step of a row may be ragged;
//   * each table vector (one load from L1/L2 per mode, at a compile-time
//     offset from one base pointer: no 64-bit address arithmetic per mode)
//     serves the lane's NB boxes;
//   * the modes of a chunk are a compile-time count ND (1..9), so no
//     multiply-add carries a predicate; a larger D loops over chunks of 9
//     and the last chunk takes its own ND;
//   * the box tile's source multipoles (4 NB boxes x 27r, under 48 KB)
//     sit in shared memory, gathered once per block;
//   * on a coarse level (few tiles: the target points are split over two
//     blocks, one row a warp) a warp asks L2 for its row of E, and every
//     warp for its chunk's table rows, before it walks them
//     (prefetch.global.L2): a step then waits on L2, not on device memory,
//     which too few warps would not hide.
// A block is one class, a tile of 4 NB boxes and a group of target points;
// its eight warps take different a, each its own table slice.  Per value
// of E a step costs ~1/8 load of E and of the source tile, one exp, one
// multiply and ND multiply-adds, and ND / (8 NB) table loads; the sums over
// the eight lanes of a box are three shuffle steps per (box, mode, a).
// How the rows of E are cut into requests (128-byte runs) is what the leaf
// level's time is most sensitive to (PERF.md).  expf / exp, not __expf:
// the library is built without fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOffsets = 27;
constexpr int kModeChunk = 9;   // modes accumulated in registers at a time
constexpr int kMinBlocks = 512; // about four for each of the card's SMs
constexpr int kLanes = 8;       // lanes on one row of E, all-modes kernel
constexpr int kSlots = 32 / kLanes;  // box slots of a warp

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }

// g[o, b] = M at the V-list source of (class c, offset o) for target box
// (x, y), or 0 off the parity plane; by all threads of the block.
template <typename T>
__device__ __forceinline__ void gather_sources(
    T* g, const T* __restrict__ M, const int* __restrict__ shift, int c,
    int x, int y, int m2, int r) {
    const int m = 2 * m2;
    for (int k = threadIdx.x; k < kOffsets * r; k += blockDim.x) {
        const int o = k / r;
        const int b = k - o * r;
        const int* t = shift + (c * kOffsets + o) * 4;
        const int bx = x + t[2] - 1;
        const int by = y + t[3] - 1;
        T v = 0;
        if (bx >= 0 && bx < m2 && by >= 0 && by < m2) {
            v = M[((size_t)(2 * bx + t[0]) * m + (2 * by + t[1])) * r + b];
        }
        g[k] = v;
    }
}

template <typename T>
__global__ void m2l_translate_kernel(
    const T* __restrict__ E,          // (4, m2, m2, r, 27 r)
    const T* __restrict__ cosr,       // (4, r, 27 r)
    const T* __restrict__ M,          // (2 m2, 2 m2, r)
    const int* __restrict__ shift,    // (4, 27, 4)
    T* __restrict__ L,                // (2 m2, 2 m2, r)
    int m2, int r) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* g = reinterpret_cast<T*>(smem);  // (27, r) source multipoles
    const int ob = kOffsets * r;
    const int blk = blockIdx.x;       // (c, x, y), y fastest
    const int c = blk / (m2 * m2);
    const int x = (blk / m2) % m2;
    const int y = blk % m2;
    const int m = 2 * m2;

    gather_sources(g, M, shift, c, x, y, m2, r);
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const T* Eb = E + (size_t)blk * r * ob;
    const T* cb = cosr + (size_t)c * r * ob;
    const int px = c >> 1;
    const int py = c & 1;
    for (int a = warp; a < r; a += nwarps) {
        const T* Ea = Eb + (size_t)a * ob;
        const T* ca = cb + (size_t)a * ob;
        T acc = 0;
        for (int q = lane; q < ob; q += 32) {
            acc += exp_(-Ea[q]) * ca[q] * g[q];
        }
        for (int off = 16; off > 0; off >>= 1) {
            acc += __shfl_down_sync(0xffffffffu, acc, off);
        }
        if (lane == 0) {
            L[((size_t)(2 * x + px) * m + (2 * y + py)) * r + a] = acc;
        }
    }
}

// The all-modes kernel's shapes by scalar type and r: a vector V of VW
// values (16 bytes where r values fill whole vectors, else one value), NB
// boxes per lane (TB = kSlots NB boxes per block), OB = 27 r values a row.
template <typename T, int VW> struct Vec { using V = T; };
template <> struct Vec<float, 4> { using V = float4; };
template <> struct Vec<double, 2> { using V = double2; };

template <typename T, int R> struct Modes {
    static constexpr int VW = R * sizeof(T) % 16 == 0 ? 16 / sizeof(T) : 1;
    using V = typename Vec<T, VW>::V;
    static constexpr int NB = sizeof(T) == 4 && R <= 25 ? 4 : 2;
    static constexpr int TB = kSlots * NB;
    static constexpr int OB = kOffsets * R;
    static constexpr size_t smem_bytes = (size_t)TB * OB * sizeof(T);
    static_assert(smem_bytes <= 48 * 1024, "source tile over 48 KB");
};

// Ask L2 for the 128-byte lines of [p, p + bytes): this lane takes lines
// first, first + step, ...  No registers, no wait.
__device__ __forceinline__ void prefetch_lines(const void* p, int bytes,
                                               int first, int step) {
    const char* c = static_cast<const char*>(p);
    const char* line = c - ((size_t)c & 127) + 128 * first;
    for (; line < c + bytes; line += 128 * step) {
        asm volatile("prefetch.global.L2 [%0];\n" :: "l"(line));
    }
}

template <typename T, typename V>
__device__ __forceinline__ T lane_of(const V& v, int i) {
    return reinterpret_cast<const T*>(&v)[i];
}

// One target point a for the lane's NB boxes and ND modes: acc[k][d] +=
// exp(-E[row k, q]) g[k, q] cosr[d, q] over the lane's q, then summed over
// the kLanes lanes of a box.  Er: the rows of E; gk: the boxes' rows of the
// source tile; ca: cosr[d0, c, a, :]; j: the lane's vector in each step.
template <typename T, int R, int ND>
__device__ __forceinline__ void modes_row(
    const T* (&Er)[Modes<T, R>::NB], const T* (&gk)[Modes<T, R>::NB],
    const T* __restrict__ ca, int j, T (&out)[Modes<T, R>::NB][kModeChunk]) {
    using S = Modes<T, R>;
    using V = typename S::V;
    constexpr int NB = S::NB, VW = S::VW, OB = S::OB;
    constexpr int kNV = OB / VW;            // vectors in a row
    constexpr int kSteps = (kNV + kLanes - 1) / kLanes;
    constexpr size_t kModeStride = (size_t)4 * R * OB;
    // the chunk's table rows into L2: one line per lane and mode
#pragma unroll
    for (int d = 0; d < ND; ++d) {
        prefetch_lines(ca + d * kModeStride, OB * sizeof(T),
                       threadIdx.x & 31, 32);
    }
    T acc[NB][ND];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
#pragma unroll
        for (int d = 0; d < ND; ++d) {
            acc[k][d] = T(0);
        }
    }
    V e[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
        e[k] = __ldcs(reinterpret_cast<const V*>(Er[k]) + j);
    }
#pragma unroll 1
    for (int t = 0; t < kSteps; ++t) {
        int v = j + kLanes * t;             // the lane's vector of the row
        const bool in = v < kNV;            // the last step may be ragged
        v = in ? v : 0;
        V en[NB];
        if (t + 1 < kSteps) {
            const int vn = v + kLanes < kNV ? v + kLanes : 0;
#pragma unroll
            for (int k = 0; k < NB; ++k) {
                en[k] = __ldcs(reinterpret_cast<const V*>(Er[k]) + vn);
            }
        }
        T y[NB][VW];
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            const V gv = reinterpret_cast<const V*>(gk[k])[v];
#pragma unroll
            for (int i = 0; i < VW; ++i) {
                y[k][i] = in ? exp_(-lane_of<T>(e[k], i)) * lane_of<T>(gv, i)
                             : T(0);
            }
        }
#pragma unroll
        for (int d = 0; d < ND; ++d) {
            const V cv = __ldg(reinterpret_cast<const V*>(ca + d * kModeStride)
                               + v);
#pragma unroll
            for (int k = 0; k < NB; ++k) {
#pragma unroll
                for (int i = 0; i < VW; ++i) {
                    acc[k][d] += y[k][i] * lane_of<T>(cv, i);
                }
            }
        }
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            e[k] = en[k];
        }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
#pragma unroll
        for (int d = 0; d < ND; ++d) {
            T s = acc[k][d];
#pragma unroll
            for (int off = 1; off < kLanes; off <<= 1) {
                s += __shfl_xor_sync(0xffffffffu, s, off);
            }
            out[k][d] = s;
        }
    }
}

// All D modes of one charge.  One block per class c, tile of TB boxes of its
// parity plane and group of target points; lane (i, j) of a warp holds the
// tile's boxes i, i + kSlots, ... and vector j of each step of kLanes
// vectors along the rows.  Warp w takes the target points a0 + w,
// a0 + w + 8, ...  The modes come in chunks of kModeChunk, the last chunk
// of NDL.
template <typename T, int R, int NDL>
__global__ void __launch_bounds__(kThreads, 2) m2l_translate_modes_kernel(
    const T* __restrict__ E,          // (4, m2, m2, r, 27 r)
    const T* __restrict__ cosr,       // (D, 4, r, 27 r)
    const T* __restrict__ M,          // (2 m2, 2 m2, r)
    const int* __restrict__ shift,    // (4, 27, 4)
    T* __restrict__ L,                // (D, 2 m2, 2 m2, r)
    int m2, int n_full, int a_per_block) {
    using S = Modes<T, R>;
    using V = typename S::V;
    constexpr int NB = S::NB, TB = S::TB, OB = S::OB;
    constexpr int kVecsPerRow = R / S::VW;
    __shared__ __align__(16) T g[TB * OB];  // the tile's source multipoles
    const int nboxes = m2 * m2;
    const int tiles = (nboxes + TB - 1) / TB;
    const int c = blockIdx.x / tiles;
    const int box0 = (blockIdx.x - c * tiles) * TB;
    const int m = 2 * m2;

    // the tile's source multipoles, one (box, offset) row of r values per
    // job, zero off the parity plane and past the last box
    for (int job = threadIdx.x; job < TB * kOffsets; job += blockDim.x) {
        const int tb = job / kOffsets;
        const int o = job - tb * kOffsets;
        const int box = box0 + tb;
        const int x = box / m2;
        const int y = box - x * m2;
        const int* t = shift + (c * kOffsets + o) * 4;
        const int bx = x + t[2] - 1;
        const int by = y + t[3] - 1;
        V* dst = reinterpret_cast<V*>(g + tb * OB + o * R);
        if (box < nboxes && bx >= 0 && bx < m2 && by >= 0 && by < m2) {
            const V* src = reinterpret_cast<const V*>(
                M + ((size_t)(2 * bx + t[0]) * m + (2 * by + t[1])) * R);
#pragma unroll
            for (int v = 0; v < kVecsPerRow; ++v) {
                dst[v] = __ldg(src + v);
            }
        } else {
#pragma unroll
            for (int v = 0; v < kVecsPerRow; ++v) {
                dst[v] = V{};
            }
        }
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int i = lane / kLanes;
    const int j = lane % kLanes;
    const int a0 = blockIdx.y * a_per_block;
    const int a1 = min(R, a0 + a_per_block);
    const size_t plane = (size_t)m * m * R;
    const size_t mode_stride = (size_t)4 * R * OB;
    const T* gk[NB];
    T* Lk[NB];
    int rowbox[NB];
    bool valid[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
        const int box = box0 + i + kSlots * k;
        valid[k] = box < nboxes;
        rowbox[k] = valid[k] ? box : box0;  // its g row is zero
        const int x = rowbox[k] / m2;
        const int y = rowbox[k] - x * m2;
        gk[k] = g + (i + kSlots * k) * OB;
        Lk[k] = L + ((size_t)(2 * x + (c >> 1)) * m + (2 * y + (c & 1))) * R;
    }
    for (int a = a0 + warp; a < a1; a += kThreads / 32) {
        const T* Er[NB];
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            Er[k] = E + (((size_t)c * nboxes + rowbox[k]) * R + a) * OB;
            // on a coarse level (target points split over blocks: one row
            // a warp) the row into L2 now
            if (a_per_block < R) {
                prefetch_lines(Er[k], OB * sizeof(T), j, kLanes);
            }
        }
        const T* ca = cosr + ((size_t)c * R + a) * OB;
        T out[NB][kModeChunk];
        int d0 = 0;
        for (int ch = 0; ch <= n_full; ++ch) {
            int nd = kModeChunk;
            if (ch < n_full) {
                modes_row<T, R, kModeChunk>(Er, gk, ca + d0 * mode_stride, j,
                                            out);
            } else {
                modes_row<T, R, NDL>(Er, gk, ca + d0 * mode_stride, j, out);
                nd = NDL;
            }
            // every lane of a box holds the sums: lane j writes d = j mod 8
#pragma unroll
            for (int k = 0; k < NB; ++k) {
#pragma unroll
                for (int d = 0; d < kModeChunk; ++d) {
                    if (d < nd && d % kLanes == j && valid[k]) {
                        Lk[k][(size_t)(d0 + d) * plane + a] = out[k][d];
                    }
                }
            }
            d0 += kModeChunk;
        }
    }
}

template <typename T, int R, int NDL>
int launch_modes(const void* E, const void* cosr, const void* M,
                 const void* shift, void* L, int m2, int n_full,
                 cudaStream_t stream) {
    constexpr int TB = Modes<T, R>::TB;
    // a coarse level has few tiles: its target points go to two blocks
    const int tiles = (m2 * m2 + TB - 1) / TB;
    const int a_per_block = 4 * tiles < kMinBlocks ? (R + 1) / 2 : R;
    const dim3 grid(4 * tiles, (R + a_per_block - 1) / a_per_block);
    m2l_translate_modes_kernel<T, R, NDL><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(E), static_cast<const T*>(cosr),
        static_cast<const T*>(M), static_cast<const int*>(shift),
        static_cast<T*>(L), m2, n_full, a_per_block);
    return (int)cudaGetLastError();
}

// chunks of kModeChunk modes, the last one of 1..kModeChunk
template <typename T, int R>
int launch_modes_r(const void* E, const void* cosr, const void* M,
                   const void* shift, void* L, int m2, int D,
                   cudaStream_t st) {
    const int n_full = (D - 1) / kModeChunk;
#define ANISO_K1D_ND(N)                                                   \
    case N:                                                               \
        return launch_modes<T, R, N>(E, cosr, M, shift, L, m2, n_full, st);
    switch (D - n_full * kModeChunk) {
        ANISO_K1D_ND(1)
        ANISO_K1D_ND(2)
        ANISO_K1D_ND(3)
        ANISO_K1D_ND(4)
        ANISO_K1D_ND(5)
        ANISO_K1D_ND(6)
        ANISO_K1D_ND(7)
        ANISO_K1D_ND(8)
        default:
            return launch_modes<T, R, 9>(E, cosr, M, shift, L, m2, n_full,
                                         st);
    }
#undef ANISO_K1D_ND
}

// The all-modes kernel takes r = np^2 for np 2-5, and np 6-7 in float32
// (where 16 boxes' source rows still fit 48 KB of shared memory).
template <typename T>
int launch(const void* E, const void* cosr, const void* M, const void* shift,
           void* L, int m2, int r, int D, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (D == 1) {
        const size_t row = (size_t)kOffsets * r * sizeof(T);
        m2l_translate_kernel<T><<<4 * m2 * m2, kThreads, row, st>>>(
            static_cast<const T*>(E), static_cast<const T*>(cosr),
            static_cast<const T*>(M), static_cast<const int*>(shift),
            static_cast<T*>(L), m2, r);
        return (int)cudaGetLastError();
    }
#define ANISO_K1D_R(RV)                                                   \
    case RV:                                                              \
        return launch_modes_r<T, RV>(E, cosr, M, shift, L, m2, D, st);
    switch (r) {
        ANISO_K1D_R(4)
        ANISO_K1D_R(9)
        ANISO_K1D_R(16)
        ANISO_K1D_R(25)
        default:
            break;
    }
    if constexpr (sizeof(T) == 4) {
        switch (r) {
            ANISO_K1D_R(36)
            ANISO_K1D_R(49)
            default:
                break;
        }
    }
#undef ANISO_K1D_R
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int aniso_m2l_translate_f32(
    const void* E, const void* cosr, const void* M, const void* shift,
    void* L, int m2, int r, int D, void* stream) {
    return launch<float>(E, cosr, M, shift, L, m2, r, D, stream);
}

extern "C" int aniso_m2l_translate_f64(
    const void* E, const void* cosr, const void* M, const void* shift,
    void* L, int m2, int r, int D, void* stream) {
    return launch<double>(E, cosr, M, shift, L, m2, r, D, stream);
}
