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
// 3.35 TB/s; twice that in f64), plus D tables of 4 * r * 27r values,
// against ~0.1 GFLOP of exp and (1 + D) multiply-adds per value.  Both
// kernels read E exactly once, coalesced, and gather the 27 x r source
// multipoles of a box straight from M into shared memory (no gsel tensor);
// a warp reduces a whole 27r-value row of E (contiguous in the layout
// (4, m2, m2, r, 27r) that set_coeff writes) for one target point a and
// writes the interleaved L directly.
//
// One mode (m2l_translate_kernel): one block per (c, x, y), its warps take
// the r target points in turn; the table row comes through the cache.
//
// All modes (m2l_translate_modes_kernel): per value of E one exp, one
// multiply by the gathered multipole and one multiply-add per mode into a
// register accumulator.  With one block per box and its warps on different
// target points, the D table rows of all r points of a class (D * 27 KB in
// f32) are live at once, do not stay in L1, and every block fetches them
// from L2 again, D values for each value of E (measured on an H100 80GB
// HBM3 at 700 W: 28 ms for the 512^2 leaf against a byte bound of 2.2 ms).  So a block takes a tile of
// kTile boxes of one class, one warp per box, and every warp walks the
// target points a in the same order: the D rows cosr[:, c, a, :] in use at
// a time are 16 KB and stay in L1.  Staging them in shared memory, loading
// a row of E ahead of its exps, and two or four boxes per warp were each
// measured and none was faster; what helped was one instruction less per
// multiply-add (kFull in reduce_row): the kernel is bound by the
// instructions it issues, at ~10 ms for the 512^2 leaf, so vector loads are
// what a later change should try.  A coarse level has few tiles, and its
// target points are then spread over blocks too (blockIdx.y).  The
// accumulators are a fixed chunk of kModeChunk modes (D = 9 for N = 5 takes
// one pass); a larger D loops over chunks and reads E again.  expf / exp,
// not __expf: the library is built without fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOffsets = 27;
constexpr int kModeChunk = 9;   // modes accumulated in registers at a time
constexpr int kTile = 8;        // boxes (and warps) per block, all modes
constexpr int kMinBlocks = 512; // about four for each of the card's SMs

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

// One row of E against the table rows of nd modes: acc[d] += exp(-E[q])
// g[q] cosr[d, q] over the lane's q.  kFull: nd = kModeChunk, which saves
// the kernel a predicate on every multiply-add (it is bound by the
// instructions it issues, not by the bytes it moves).
template <typename T, bool kFull>
__device__ __forceinline__ void reduce_row(
    const T* __restrict__ Ea, const T* gb, const T* __restrict__ ca,
    size_t mode_stride, int ob, int nd, int lane, T (&acc)[kModeChunk]) {
    for (int q = lane; q < ob; q += 32) {
        const T e = exp_(-Ea[q]) * gb[q];
#pragma unroll
        for (int d = 0; d < kModeChunk; ++d) {
            if (kFull || d < nd) {
                acc[d] += e * ca[d * mode_stride + q];
            }
        }
    }
}

// All D modes of one charge.  One block per class c and tile of kTile boxes
// of its parity plane, one warp per box: the warp gathers nothing itself
// (the block gathers the tile's source multipoles once), then walks the
// target points a in order and reduces its box's row of E for each: one exp
// per value, one multiply-add per mode.  The kTile warps of a block, and
// the blocks that share an SM, walk a in step, so the D table rows
// cosr[:, c, a, :] they all read stay in L1.
template <typename T>
__global__ void m2l_translate_modes_kernel(
    const T* __restrict__ E,          // (4, m2, m2, r, 27 r)
    const T* __restrict__ cosr,       // (D, 4, r, 27 r)
    const T* __restrict__ M,          // (2 m2, 2 m2, r)
    const int* __restrict__ shift,    // (4, 27, 4)
    T* __restrict__ L,                // (D, 2 m2, 2 m2, r)
    int m2, int r, int D, int a_per_block) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int ob = kOffsets * r;
    T* g = reinterpret_cast<T*>(smem);      // (kTile, 27, r) multipoles
    const int nboxes = m2 * m2;
    const int tiles = (nboxes + kTile - 1) / kTile;
    const int c = blockIdx.x / tiles;
    const int box0 = (blockIdx.x - c * tiles) * kTile;
    const int m = 2 * m2;
    const int a0 = blockIdx.y * a_per_block;
    const int a1 = min(r, a0 + a_per_block);

    for (int tb = 0; tb < kTile && box0 + tb < nboxes; ++tb) {
        const int box = box0 + tb;
        gather_sources(g + tb * ob, M, shift, c, box / m2, box % m2, m2, r);
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;      // one warp per box of the tile
    const int lane = threadIdx.x & 31;
    const int box = box0 + warp;
    if (box >= nboxes) {
        return;
    }
    const T* gb = g + warp * ob;
    const int x = box / m2;
    const int y = box - x * m2;
    const size_t mode_stride = (size_t)4 * r * ob;
    const size_t plane = (size_t)m * m * r;
    T* Lb = L + ((size_t)(2 * x + (c >> 1)) * m + (2 * y + (c & 1))) * r;
    for (int d0 = 0; d0 < D; d0 += kModeChunk) {
        const int nd = min(kModeChunk, D - d0);
        for (int a = a0; a < a1; ++a) {
            const T* Ea = E + (((size_t)c * nboxes + box) * r + a) * ob;
            const T* ca = cosr + (size_t)d0 * mode_stride
                          + ((size_t)c * r + a) * ob;
            T acc[kModeChunk];
#pragma unroll
            for (int d = 0; d < kModeChunk; ++d) {
                acc[d] = T(0);
            }
            if (nd == kModeChunk) {
                reduce_row<T, true>(Ea, gb, ca, mode_stride, ob, nd, lane, acc);
            } else {
                reduce_row<T, false>(Ea, gb, ca, mode_stride, ob, nd, lane,
                                     acc);
            }
#pragma unroll
            for (int d = 0; d < kModeChunk; ++d) {
                if (d < nd) {
                    T v = acc[d];
                    for (int off = 16; off > 0; off >>= 1) {
                        v += __shfl_down_sync(0xffffffffu, v, off);
                    }
                    if (lane == 0) {
                        Lb[(size_t)(d0 + d) * plane + a] = v;
                    }
                }
            }
        }
    }
}

template <typename T>
int launch(const void* E, const void* cosr, const void* M, const void* shift,
           void* L, int m2, int r, int D, void* stream) {
    const size_t row = (size_t)kOffsets * r * sizeof(T);
    if (D == 1) {
        m2l_translate_kernel<T><<<4 * m2 * m2, kThreads, row,
                                  (cudaStream_t)stream>>>(
            static_cast<const T*>(E), static_cast<const T*>(cosr),
            static_cast<const T*>(M), static_cast<const int*>(shift),
            static_cast<T*>(L), m2, r);
        return (int)cudaGetLastError();
    }
    // a coarse level has few tiles: its target points go to separate blocks
    const int tiles = (m2 * m2 + kTile - 1) / kTile;
    int a_per_block = r;
    while (a_per_block > 1
           && 4 * tiles * ((r + a_per_block - 1) / a_per_block) < kMinBlocks) {
        a_per_block = (a_per_block + 1) / 2;
    }
    const dim3 grid(4 * tiles, (r + a_per_block - 1) / a_per_block);
    m2l_translate_modes_kernel<T><<<grid, 32 * kTile, kTile * row,
                                    (cudaStream_t)stream>>>(
        static_cast<const T*>(E), static_cast<const T*>(cosr),
        static_cast<const T*>(M), static_cast<const int*>(shift),
        static_cast<T*>(L), m2, r, D, a_per_block);
    return (int)cudaGetLastError();
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
