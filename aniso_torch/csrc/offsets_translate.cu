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
// 2 m2^2 r^2 K_e, K_e = (|di|+1)(|dj|+1) B^2 nq, 27..144 at the leaf and
// 108..576 at level 8; the same total at every depth), i.e. 241.6 GFLOP per
// twin sweep, plus (2 + 4 D) m2^2 r^2 operations per entry for the
// contractions, all at 67 TFLOP/s (f64 on the tensor cores: 3.7 ms per twin
// sweep at D = 1, 4.25 at D = 9), beside ~1.13 G exponentials per twin
// sweep on the CUDA cores; the bytes it must move (the 19 MB f64
// coefficient field, the weights, the multipoles and L) take ~0.03 ms.
//
// Design: one block of eight warps per (entry, box row x, tile of 32 boxes
// along y), with r a compile-time parameter (4, 9, 16, 25: np 2-5; the
// split instances below take np 6-7 and any r).
//   * The window GEMM (M = 32 boxes, N = r^2 pairs padded to a multiple of
//     64, K = K_e) runs on the FP64 tensor cores, mma.sync.m16n8k4 f64
//     (DMMA; wgmma takes no f64).  Warp w owns NT n-tiles of 8 pairs (NT = 4
//     at r = 16: 32 accumulators a lane).  K goes in chunks of 16 through a
//     double-buffered ring in shared memory: Wo_e's rows by cp.async
//     (16-byte copies where a row of r^2 values is a multiple of 16 bytes,
//     else one value a copy; zero-filled past K and past r^2), the windows
//     gathered from the coefficient field one chunk ahead through registers
//     (they are B-granular boxes of the field, not a copyable tile), their
//     (row, column, node) indices advanced by the chunk with two divisions,
//     not eight: the index arithmetic beside the DMMA sets the pace, so it
//     is kept out of the inner loop.  Row strides are padded so that the
//     fragment loads hit distinct banks.  The float32 instance feeds its
//     operands to the same f64 MMA (no TF32 anywhere): E is formed in f64.
//   * Epilogue: one exp per value from the accumulator fragments, X stored
//     once to shared memory as (pair, box) over the ring's space.  The two
//     contractions sum X over different indices (b for the direct add, a
//     for the mirror), so no split of the pairs over warps keeps both in a
//     warp: lane n takes box n and warp w the target points a = w, w + 8,
//     ... for the direct sum and b = w, w + 8, ... for the mirror: Y = X
//     times the source multipole (mode-free, r values in registers), then
//     per mode one r-term dot product with the table row (through L1, the
//     same for all lanes) and one atomicAdd.  No barrier per mode.
//   * The atomics go to a class-major scratch (D, 4, m2, r, m2), so a warp's
//     32 boxes add into 32 consecutive values; the wrapper interleaves it
//     into L (D, 2 m2, 2 m2, r).  Each (box, a, d) gets one add per entry.
//   * np >= 6 (r >= 36): the pair axis is split across blocks instead of
//     growing the per-thread tile (np 5 already holds ~250 registers at one
//     block an SM).  A block takes 192 consecutive pairs p = a r + b of the
//     entry (NT = 3), so the grid's z axis is (entry, chunk of pairs); the
//     GEMM is the same, on Wo_e's columns [p0, p0 + 192).  Its direct sums
//     then cover the b of its chunk and its mirror sums the a, so both are
//     partial sums, added with the same atomics (one per (box, row, mode)
//     a chunk touches), one mode at a time: simple, not tuned.  r = 36 and
//     49 are compile-time instances; other r one runtime-r instance (R = 0),
//     which reads each source row from M (L1) instead of a tile of r x 32
//     values in shared memory, so that its shared memory does not grow
//     with r: it takes every r K1 takes (np 32 in float64, 46 in float32;
//     kernels/m2l.py:max_np).  The chunks of pairs run along the grid's x
//     with the tiles of boxes, the entries along z.
// atomicAdd is native for f32 and f64 on sm_90; an L value receives the 27
// offsets' contributions in an order that changes from run to run, so two
// runs agree to rounding (about 27 ulp of the largest term), not bitwise.
// expf / exp, not __expf: the library is built without fast math.

#include <cuda_runtime.h>

#include "smem_limits.cuh"

namespace {

using aniso::kMaxRowBytes;      // a row of 27 r values, at most, as K1

constexpr int kOffsets = 27;
constexpr int kPlanCols = 12;   // c o px py di dj c2 o2 sx sy woff K
constexpr int kNB = 32;         // boxes per block, along y: the GEMM's M
constexpr int kKC = 16;         // K chunk: four m16n8k4 steps
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAS = kNB + 4;    // row stride of the window chunk (doubles)

// The shapes of one instance: r target points a box (R = 0: r at run
// time), P = r^2 pairs, NT n-tiles of 8 pairs a warp (PP = 64 NT pairs a
// block, padded), the row strides BS of the Wo chunk (PP + 32 bytes of pad)
// and XS of X (pair, box), the width CW of a weight copy in values, and the
// blocks an SM is built to hold.  kSplit: the r^2 pairs are cut into
// chunks of PP, one a block.
template <typename T, int R> struct Shape {
    static constexpr bool kSplit = R == 0 || R > 25;
    static constexpr int P = R * R;
    static constexpr int NT =
        kSplit ? 3 : ((P + 7) / 8 + kWarps - 1) / kWarps;
    static constexpr int PP = 8 * kWarps * NT;
    static constexpr int BS = PP + 32 / (int)sizeof(T);
    static constexpr int XS = kNB + (sizeof(T) == 4 ? 4 : 2);
    static constexpr int CW =
        R > 0 && P * sizeof(T) % 16 == 0 ? 16 / sizeof(T) : 1;
    static constexpr int VW = R * sizeof(T) % 16 == 0 ? 16 / sizeof(T) : 1;
    static constexpr int kMinBlocks = NT <= 4 ? 2 : 1;
    static constexpr size_t ring_bytes =
        2 * (kKC * kAS * sizeof(double) + kKC * BS * sizeof(T));
    static constexpr size_t x_bytes = (size_t)PP * XS * sizeof(T);
    // the ring, or X over it; then the tile's source multipoles
    static constexpr size_t main_bytes =
        ring_bytes > x_bytes ? ring_bytes : x_bytes;
    // R = 0 reads the sources from M and keeps no tile of them
    static size_t smem_bytes(int r) {
        return main_bytes + (R == 0 ? 0 : 2 * (size_t)r * kNB * sizeof(T));
    }
};

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }

// d = a * b + d on one 16 x 8 x 4 tile, f64 in and out (DMMA).
__device__ __forceinline__ void mma_16x8x4(double (&d)[4], double a0,
                                           double a1, double b0) {
    asm volatile(
        "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a0), "d"(a1), "d"(b0));
}

// Copy BYTES (4, 8 or 16) to shared memory, zero-filled past src_bytes.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(s), "l"(src), "r"(src_bytes));
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(s), "l"(src), "n"(BYTES), "r"(src_bytes));
    }
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::);
}

// The row of M at the V-list source of (class c, offset o) for target box
// (x, y), or null off the parity plane.
template <typename T>
__device__ __forceinline__ const T* source_row(const T* M, const int* shift,
                                               int c, int o, int x, int y,
                                               int m2, int r) {
    const int* t = shift + (c * kOffsets + o) * 4;
    const int bx = x + t[2] - 1;
    const int by = y + t[3] - 1;
    if (bx < 0 || bx >= m2 || by < 0 || by >= m2) {
        return nullptr;
    }
    return M + ((size_t)(2 * bx + t[0]) * (2 * m2) + (2 * by + t[1])) * r;
}

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

// VW values of one load: a 16-byte vector, or one value.
template <typename T, int VW> struct Vec { using V = T; };
template <> struct Vec<float, 4> { using V = float4; };
template <> struct Vec<double, 2> { using V = double2; };

// One output row: s[d] = sum_k y[k] * tab[d * mode_stride + k] over the r
// k of the row, added to out[d * out_stride] for every mode d.
template <typename T, int R>
__device__ __forceinline__ void contract_row(const T (&y)[R],
                                             const T* __restrict__ tab,
                                             size_t mode_stride, int D,
                                             T* out, size_t out_stride) {
    constexpr int VW = Shape<T, R>::VW;
    using V = typename Vec<T, VW>::V;
    for (int d = 0; d < D; ++d) {
        const V* tv = reinterpret_cast<const V*>(tab + d * mode_stride);
        T s = T(0);
#pragma unroll
        for (int v = 0; v < R / VW; ++v) {
            const V w = __ldg(tv + v);
            const T* wv = reinterpret_cast<const T*>(&w);
#pragma unroll
            for (int i = 0; i < VW; ++i) {
                s += y[v * VW + i] * wv[i];
            }
        }
        atomicAdd(out + d * out_stride, s);
    }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads, Shape<T, R>::kMinBlocks)
offsets_translate_kernel(
    const T* __restrict__ Wo,         // per key (K, r^2), back to back
    const T* __restrict__ coeffs,     // (sz, sz, nq)
    const T* __restrict__ cosr,       // (D, 4, r, 27 r)
    const T* __restrict__ M,          // (2 m2, 2 m2, r)
    const int* __restrict__ shift,    // (4, 27, 4)
    const int* __restrict__ plan,     // (entries, kPlanCols)
    T* __restrict__ Lc,               // (D, 4, m2, r, m2), zeroed
    int sz, int nq, int m2, int B, int D, int r_rt) {
    using S = Shape<T, R>;
    constexpr int NT = S::NT, PP = S::PP, BS = S::BS, XS = S::XS;
    const int r = R > 0 ? R : r_rt;
    const int P = r * r;
    extern __shared__ __align__(16) unsigned char smem[];
    double* As = reinterpret_cast<double*>(smem);           // 2 x (kKC, kAS)
    T* Bs = reinterpret_cast<T*>(As + 2 * kKC * kAS);       // 2 x (kKC, BS)
    T* Xs = reinterpret_cast<T*>(smem);                     // (PP, XS)
    T* Md = reinterpret_cast<T*>(smem + S::main_bytes);
    T* Mm = Md + r * kNB;                                   // (r, kNB) each

    // the block's entry, tile of boxes and, split, chunk of pairs
    // [p0, p0 + PP) (chunks along x after the tiles)
    const int entry = blockIdx.z;
    const int tiles = (m2 + kNB - 1) / kNB;
    const int tile = blockIdx.x % tiles;
    const int p0 = S::kSplit ? (int)(blockIdx.x / tiles) * PP : 0;
    const int* e = plan + entry * kPlanCols;
    const int c = e[0], o = e[1], px = e[2], py = e[3], di = e[4], dj = e[5];
    const int c2 = e[6], o2 = e[7], sx = e[8], sy = e[9];
    const T* W = Wo + (size_t)(unsigned)e[10];
    const int K = e[11];
    const int bby = (abs(dj) + 1) * B;
    const int x = blockIdx.y;
    const int y0 = tile * kNB;
    const int xt = x + sx;
    const int row0 = px * B + min(0, di * B) + 2 * B * x;
    const int col0 = py * B + min(0, dj * B) + 2 * B * y0;
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;          // fragment row / column group
    const int t = lane & 3;           // fragment thread in group

    // the direct and mirror source multipoles of the tile: Md[b][n],
    // Mm[a][n], zero off the plane and past the last box (R = 0: none)
    for (int i = tid; i < (R == 0 ? 0 : 2 * r * kNB); i += kThreads) {
        const int mirror = i >= r * kNB;
        const int k = (i / kNB) % r;
        const int n = i % kNB;
        const int y = y0 + n;
        T v = T(0);
        if (y < m2) {
            if (!mirror) {
                v = source<T>(M, shift, c, o, x, y, m2, r, k);
            } else if (xt >= 0 && xt < m2 && y + sy >= 0 && y + sy < m2) {
                v = source<T>(M, shift, c2, o2, xt, y + sy, m2, r, k);
            }
        }
        (mirror ? Mm : Md)[k * kNB + n] = v;
    }

    // The window elements of the thread: k = k0 + kk with kk = tid % kKC
    // fixed (both slots share it) and boxes n = tid / kKC + 16 s.  k is
    // kept as (cell row dr, cell column dc, node q) of the window and
    // advanced by kKC a chunk: two divisions a chunk, not eight.
    const int kk = tid % kKC;
    int wq = kk % nq, wab = kk / nq;
    int wdc = wab % bby, wdr = wab / bby;
    auto advance = [&]() {
        wq += kKC;
        const int cq = wq / nq;
        wq -= cq * nq;
        wdc += cq;
        const int cc = wdc / bby;
        wdc -= cc * bby;
        wdr += cc;
    };
    auto window = [&](int k0, int s) -> double {
        const int n = tid / kKC + 16 * s;
        T v = T(0);
        if (k0 + kk < K && y0 + n < m2) {
            const int row = row0 + wdr;
            const int col = col0 + 2 * B * n + wdc;
            if (row >= 0 && row < sz && col >= 0 && col < sz) {
                v = coeffs[((size_t)row * sz + col) * nq + wq];
            }
        }
        return (double)v;
    };
    auto store_window = [&](double* A, const double (&v)[2]) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int i = tid + s * kThreads;
            const int n = i / kKC;
            A[(i - n * kKC) * kAS + n] = v[s];
        }
    };
    // Wo_e rows k0..k0+15, columns p0.., into a ring slot, CW values a
    // copy, zero past K and past the r^2 pairs.  Where a row's copies
    // divide the block, the thread copies the same column of rows wr,
    // wr + kPass, ...
    constexpr int CW = S::CW;
    constexpr int kBytes = CW * sizeof(T);
    constexpr int kPerRow = PP / CW;
    auto load_weights = [&](T* dst, int k0) {
        if constexpr (kThreads % kPerRow == 0) {
            constexpr int kPass = kThreads / kPerRow;   // rows a pass copies
            const int wr = tid / kPerRow;
            const int wc = (tid % kPerRow) * CW;
            const T* src = W + (size_t)(k0 + wr) * P + p0 + wc;
#pragma unroll
            for (int p = 0; p < kKC / kPass; ++p) {
                const bool in = k0 + wr + p * kPass < K
                                && ((!S::kSplit && PP == S::P)
                                    || p0 + wc < P);
                cp_async<kBytes>(dst + (wr + p * kPass) * BS + wc,
                                 in ? src + p * kPass * P : W,
                                 in ? kBytes : 0);
            }
        } else {
#pragma unroll 4
            for (int i = tid; i < kKC * kPerRow; i += kThreads) {
                const int row = i / kPerRow;
                const int wc = (i - row * kPerRow) * CW;
                const bool in = k0 + row < K && p0 + wc < P;
                cp_async<kBytes>(dst + row * BS + wc,
                                 in ? W + (size_t)(k0 + row) * P + p0 + wc
                                    : W,
                                 in ? kBytes : 0);
            }
        }
        cp_async_commit();
    };

    double acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                acc[mt][nt][i] = 0.0;
            }
        }
    }

    const int n_chunks = (K + kKC - 1) / kKC;
    load_weights(Bs, 0);
    {
        const double v[2] = {window(0, 0), window(0, 1)};
        store_window(As, v);
    }
    cp_async_wait_all();
    __syncthreads();
    const int col = warp * 8 * NT + g;  // the lane's B column in n-tile 0
    for (int ch = 0; ch < n_chunks; ++ch) {
        const int cur = ch & 1;
        const bool more = ch + 1 < n_chunks;
        double next[2] = {0.0, 0.0};
        if (more) {
            load_weights(Bs + (cur ^ 1) * kKC * BS, (ch + 1) * kKC);
            advance();
            next[0] = window((ch + 1) * kKC, 0);
            next[1] = window((ch + 1) * kKC, 1);
        }
        const double* A = As + cur * kKC * kAS;
        const T* Bc = Bs + cur * kKC * BS;
#pragma unroll
        for (int ks = 0; ks < kKC; ks += 4) {
            const double* Ar = A + (ks + t) * kAS + g;
            const double a[2][2] = {{Ar[0], Ar[8]}, {Ar[16], Ar[24]}};
            const T* Br = Bc + (ks + t) * BS + col;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
                const double b = (double)Br[8 * nt];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    mma_16x8x4(acc[mt][nt], a[mt][0], a[mt][1], b);
                }
            }
        }
        if (more) {
            store_window(As + (cur ^ 1) * kKC * kAS, next);
        }
        cp_async_wait_all();
        __syncthreads();
    }

    // X = exp(-E) into shared memory as (pair, box), over the ring
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int n = 16 * mt + g + 8 * (i >> 1);
                const int p = warp * 8 * NT + 8 * nt + 2 * t + (i & 1);
                Xs[p * XS + n] = exp_(-(T)acc[mt][nt][i]);
            }
        }
    }
    __syncthreads();

    // contractions: lane n is box y0 + n
    const int n = lane;
    const int y = y0 + n;
    if (y >= m2) {
        return;
    }
    const size_t mode_stride = (size_t)4 * r * kOffsets * r;
    const size_t out_stride = (size_t)4 * m2 * r * m2;
    const int ob = kOffsets * r;
    const int yt = y + sy;
    const bool on_plane = xt >= 0 && xt < m2 && yt >= 0 && yt < m2;
    if constexpr (S::kSplit) {
        // the lane's source rows, from the tile or (R = 0) from M
        const T* rowd = R == 0 ? source_row(M, shift, c, o, x, y, m2, r)
                               : nullptr;
        const T* rowm = R == 0 && on_plane
                            ? source_row(M, shift, c2, o2, xt, yt, m2, r)
                            : nullptr;
        auto md = [&](int b) -> T {
            if constexpr (R == 0) {
                return rowd ? rowd[b] : T(0);
            } else {
                return Md[b * kNB + n];
            }
        };
        auto mm = [&](int a) -> T {
            if constexpr (R == 0) {
                return rowm ? rowm[a] : T(0);
            } else {
                return Mm[a * kNB + n];
            }
        };
        // the chunk's pairs p0 <= a r + b < p0 + pn: partial sums over the
        // chunk's b (direct) and a (mirror), one mode at a time
        const int pn = min(PP, P - p0);
        const int a_lo = p0 / r;
        const int a_hi = (p0 + pn - 1) / r;
#pragma unroll 1
        for (int a = a_lo + warp; a <= a_hi; a += kWarps) {
            const int b_lo = max(0, p0 - a * r);
            const int b_hi = min(r, p0 + pn - a * r);
            const T* tab = cosr + ((size_t)c * r + a) * ob + o * r;
            T* out = Lc + (((size_t)c * m2 + x) * r + a) * m2 + y;
#pragma unroll 1
            for (int d = 0; d < D; ++d) {
                T s = T(0);
                for (int b = b_lo; b < b_hi; ++b) {
                    s += Xs[(a * r + b - p0) * XS + n] * md(b)
                         * __ldg(tab + d * mode_stride + b);
                }
                atomicAdd(out + d * out_stride, s);
            }
        }
        if (!on_plane) {
            return;
        }
#pragma unroll 1
        for (int b = warp; b < r; b += kWarps) {
            const int last = p0 + pn - 1 - b;
            if (last < 0) {
                continue;
            }
            const int a0 = (p0 - b + r - 1) / r;   // p0 - b > -r
            const int a1 = last / r;
            if (a0 > a1) {
                continue;
            }
            const T* tab = cosr + ((size_t)c2 * r + b) * ob + o2 * r;
            T* out = Lc + (((size_t)c2 * m2 + xt) * r + b) * m2 + yt;
#pragma unroll 1
            for (int d = 0; d < D; ++d) {
                T s = T(0);
                for (int a = a0; a <= a1; ++a) {
                    s += Xs[(a * r + b - p0) * XS + n] * mm(a)
                         * __ldg(tab + d * mode_stride + a);
                }
                atomicAdd(out + d * out_stride, s);
            }
        }
    } else {
        // direct: Lc[d, c, x, a, y] += sum_b X[a, b] Md[b] cosr[d, c, a, o, b]
#pragma unroll 1
        for (int a = warp; a < R; a += kWarps) {
            T yv[R];
#pragma unroll
            for (int b = 0; b < R; ++b) {
                yv[b] = Xs[(a * R + b) * XS + n] * Md[b * kNB + n];
            }
            contract_row<T, R>(yv, cosr + ((size_t)c * R + a) * ob + o * R,
                               mode_stride, D,
                               Lc + (((size_t)c * m2 + x) * R + a) * m2 + y,
                               out_stride);
        }
        // mirror: Lc[d, c2, xt, b, yt]
        //     += sum_a X[a, b] Mm[a] cosr[d, c2, b, o2, a]
        if (!on_plane) {
            return;
        }
#pragma unroll 1
        for (int b = warp; b < R; b += kWarps) {
            T yv[R];
#pragma unroll
            for (int a = 0; a < R; ++a) {
                yv[a] = Xs[(a * R + b) * XS + n] * Mm[a * kNB + n];
            }
            contract_row<T, R>(
                yv, cosr + ((size_t)c2 * R + b) * ob + o2 * R, mode_stride, D,
                Lc + (((size_t)c2 * m2 + xt) * R + b) * m2 + yt, out_stride);
        }
    }
}

template <typename T, int R>
int launch_r(const void* Wo, const void* coeffs, const void* cosr,
             const void* M, const void* shift, const void* plan,
             int n_entries, void* L, int sz, int nq, int m2, int B, int r,
             int D, cudaStream_t stream) {
    using S = Shape<T, R>;
    const size_t smem = S::smem_bytes(r);
    const int pair_chunks = S::kSplit ? (r * r + S::PP - 1) / S::PP : 1;
    const int tiles = (m2 + kNB - 1) / kNB;
    if (n_entries > 65535 || m2 > 65535
        || (long long)tiles * pair_chunks > 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    auto kernel = offsets_translate_kernel<T, R>;
    // the attribute belongs to the current device: set it every launch
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
        return (int)err;
    }
    const dim3 grid(tiles * pair_chunks, m2, n_entries);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(Wo), static_cast<const T*>(coeffs),
        static_cast<const T*>(cosr), static_cast<const T*>(M),
        static_cast<const int*>(shift), static_cast<const int*>(plan),
        static_cast<T*>(L), sz, nq, m2, B, D, r);
    return (int)cudaGetLastError();
}

// r = np^2: np 2-7 compiled for their r, any other r at run time up to
// K1's row limit (kMaxRowBytes)
template <typename T>
int launch(const void* Wo, const void* coeffs, const void* cosr,
           const void* M, const void* shift, const void* plan,
           int n_entries, void* L, int sz, int nq, int m2, int B, int r,
           int D, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
#define ANISO_K3_R(RV)                                                    \
    case RV:                                                              \
        return launch_r<T, RV>(Wo, coeffs, cosr, M, shift, plan,          \
                               n_entries, L, sz, nq, m2, B, r, D, st);
    switch (r) {
        ANISO_K3_R(4)
        ANISO_K3_R(9)
        ANISO_K3_R(16)
        ANISO_K3_R(25)
        ANISO_K3_R(36)
        ANISO_K3_R(49)
        default:
            break;
    }
#undef ANISO_K3_R
    if (r < 1 || (size_t)kOffsets * r * sizeof(T) > kMaxRowBytes) {
        return (int)cudaErrorInvalidValue;
    }
    return launch_r<T, 0>(Wo, coeffs, cosr, M, shift, plan, n_entries, L, sz,
                          nq, m2, B, r, D, st);
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
