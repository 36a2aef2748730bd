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
// One mode (m2l_translate_one_kernel), for every r: a block owns one class
// c, one group of G target rows a0 .. a0 + G - 1 and a run of boxes; for
// each box the G rows of E are one contiguous run of 27 r G values, read
// once.  A warp that loads its row 4 bytes a lane keeps too few bytes in
// flight at the fine levels and walks a dozen dependent cold loads at the
// coarse ones, so:
//   * warp 0 is the producer: one lane streams each box's run of E by a
//     1-D bulk copy (cp.async.bulk, evict-first in L2: read once) into a
//     ring of S stages in shared memory, completing on an mbarrier; no
//     thread spends registers on the copy.  A run that does not start on
//     16 bytes (np odd) is copied as the aligned span that covers it, and
//     read at its offset; E's size is 108 r^2 values, a multiple of 16
//     bytes, so no span reaches past its end;
//   * the block's G rows of the table cosr[c] come in once, the same way,
//     and stay: no table value is read from device memory per value of E;
//   * lanes 1-27 of the producer bring the box's 27 V-list source rows
//     beside the stage (bulk copies where r values fill 16-byte vectors,
//     loads otherwise; zeros off the plane);
//   * the consumer warps read E, the table and the sources from shared
//     memory in 16-byte vectors (one value where rows are not on 16
//     bytes), take one exp a value, end a row in one warp reduction and
//     store its sum; NGRP groups of warps take alternate stages;
//   * the plan (kernels/m2l.py:plan_one, from m2x, m2y, r and the
//     itemsize) picks G (about 32 KB of E a stage; fewer rows on a coarse
//     level, so that it still spreads over about 128 blocks, each waiting
//     on one round trip), the stages, the boxes a block (persistent
//     blocks, about one wave) and the consumer warps; where one row does
//     not fit twice with its table, G = 1 and a row is cut into chunks
//     over stages.  r is a launch argument: one instance a dtype reads
//     16-byte vectors, another one value at a time (rows off 16 bytes).
// On an H100 80GB HBM3 at 700 W the f32 sweep of levels 2-9 at 512^2
// takes 3.40 ms against its 2.90 ms bound (a warp-a-row kernel 4.92), the
// leaf at 88% of its bound (2.94 TB/s); the f64 twin's levels 2-7 0.536 ms
// against 0.363 (0.930); PERF.md §6.
//
// All modes (m2l_translate_modes_kernel), r a compile-time parameter
// (np 2-7 in both instances).  For a fixed class c
// and target point a the sum is a product (boxes x 27r) @ (27r x D) whose
// right-hand side, the table slice cosr[:, c, a, :], is the same for every
// box of the class.  Eight lanes share a row of E, 16 bytes each where r
// values are a multiple of 16 bytes (one value each otherwise), so that a
// warp instruction reads four runs of 128 contiguous bytes, and a lane
// holds NB boxes (np 2-5: 4 in f32, 2 in f64; np 6-7: 2 in f32, 1 in f64,
// so that the tile's source rows fit 48 KB):
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
// level's time is most sensitive to (PERF.md).
//
// All modes at any other r (m2l_translate_modes_any_kernel): a block per
// box, a warp per target point, lanes along the row, with up to
// kModeChunk modes accumulated per pass over the row: simple and not
// tuned, for the np no instance is compiled for.  Every r whose 27 r-value
// row fits 48 KB of shared memory runs, as in the one-mode kernel.  expf / exp, not __expf: the library is built without
// fast math.
//
// K1-S, K1 on one shard of a domain decomposition (the one-mode entries
// with ext = 2, the aniso_m2l_translate_shard_* entries for D >= 2):
// replaces the translate of aniso_tpu/parallel/halo.py:
// make_fine_translate_shardmap (:106, body :135-170).  The same kernels run
// on the shard's (m2x, m2y) rectangle of each parity plane, with its
// contiguous slice of E (4, m2x, m2y, r, 27r), and read the shard's
// multipoles extended by two boxes on each side, (2 m2x + 4, 2 m2y + 4, r),
// filled by K10 (csrc/halo_fill.cu): one parent box on each of the four
// parity planes, the V list's reach, so every source lies inside the
// extended plane and none is zeroed.  They write the shard's (2 m2x, 2 m2y,
// r) block of L.  The plane's geometry is a kernel argument (Plane): the
// whole-level launch is the case m2x = m2y = m2 with no extension, so K1
// and K1-S share every compiled instance, and the one-mode plan is made
// for the shard's rectangle.  The bound is K1's on the shard's slice of E.

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

// The translated plane: (m2x, m2y) boxes of each parity plane (the whole
// level's (m2, m2), or a shard's rectangle), and the multipoles M as an
// (sx, sy) plane of fine boxes whose box (ext, ext) is the plane's first
// (the whole level: (2 m2, 2 m2), ext 0; a shard: extended by ext = 2).
struct Plane {
    int m2x, m2y, sx, sy, ext;
};

// The row of M at the V-list source of (class c, offset o) for target box
// (x, y), or null off the plane.
template <typename T>
__device__ __forceinline__ const T* source_row(
    const T* __restrict__ M, const int* __restrict__ shift, int c, int o,
    int x, int y, const Plane& P, int r) {
    const int* t = shift + (c * kOffsets + o) * 4;
    const int fx = 2 * (x + t[2] - 1) + t[0] + P.ext;
    const int fy = 2 * (y + t[3] - 1) + t[1] + P.ext;
    if (fx < 0 || fx >= P.sx || fy < 0 || fy >= P.sy) {
        return nullptr;
    }
    return M + ((size_t)fx * P.sy + fy) * r;
}

// g[o, b] = M at the V-list source of (class c, offset o) for target box
// (x, y), or 0 off the plane; by all threads of the block.
template <typename T>
__device__ __forceinline__ void gather_sources(
    T* g, const T* __restrict__ M, const int* __restrict__ shift, int c,
    int x, int y, const Plane& P, int r) {
    for (int k = threadIdx.x; k < kOffsets * r; k += blockDim.x) {
        const int o = k / r;
        const int b = k - o * r;
        const T* src = source_row(M, shift, c, o, x, y, P, r);
        g[k] = src != nullptr ? src[b] : T(0);
    }
}

// L's row of target box (x, y) of class c: (2 m2x, 2 m2y, r) a mode.
template <typename T>
__device__ __forceinline__ T* target_row(T* L, int c, int x, int y,
                                         const Plane& P, int r) {
    return L + ((size_t)(2 * x + (c >> 1)) * (2 * P.m2y)
                + (2 * y + (c & 1))) * r;
}

// All D modes at a runtime r: one block per (c, x, y) as the one-mode
// kernel, the modes in chunks of kModeChunk, one pass over the row each.
template <typename T>
__global__ void m2l_translate_modes_any_kernel(
    const T* __restrict__ E,          // (4, m2x, m2y, r, 27 r)
    const T* __restrict__ cosr,       // (D, 4, r, 27 r)
    const T* __restrict__ M,          // (sx, sy, r)
    const int* __restrict__ shift,    // (4, 27, 4)
    T* __restrict__ L,                // (D, 2 m2x, 2 m2y, r)
    const Plane P, int r, int D) {
    extern __shared__ __align__(16) unsigned char smem[];
    T* g = reinterpret_cast<T*>(smem);  // (27, r) source multipoles
    const int ob = kOffsets * r;
    const int blk = blockIdx.x;       // (c, x, y), y fastest
    const int c = blk / (P.m2x * P.m2y);
    const int x = (blk / P.m2y) % P.m2x;
    const int y = blk % P.m2y;

    gather_sources(g, M, shift, c, x, y, P, r);
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    const T* Eb = E + (size_t)blk * r * ob;
    const size_t mode_stride = (size_t)4 * r * ob;
    const size_t plane = (size_t)4 * P.m2x * P.m2y * r;
    T* Lb = target_row(L, c, x, y, P, r);
    for (int a = warp; a < r; a += nwarps) {
        const T* Ea = Eb + (size_t)a * ob;
        const T* ca = cosr + ((size_t)c * r + a) * ob;
        for (int d0 = 0; d0 < D; d0 += kModeChunk) {
            const int nd = min(kModeChunk, D - d0);
            T acc[kModeChunk];
#pragma unroll
            for (int d = 0; d < kModeChunk; ++d) {
                acc[d] = T(0);
            }
            for (int q = lane; q < ob; q += 32) {
                const T v = exp_(-Ea[q]) * g[q];
#pragma unroll
                for (int d = 0; d < kModeChunk; ++d) {
                    if (d < nd) {
                        acc[d] += v * ca[(d0 + d) * mode_stride + q];
                    }
                }
            }
#pragma unroll
            for (int d = 0; d < kModeChunk; ++d) {
                T s = acc[d];
                for (int off = 16; off > 0; off >>= 1) {
                    s += __shfl_down_sync(0xffffffffu, s, off);
                }
                if (lane == 0 && d < nd) {
                    Lb[(d0 + d) * plane + a] = s;
                }
            }
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
    static constexpr int NB =
        (sizeof(T) == 4 ? 4 : 2) / (R <= 25 ? 1 : 2);
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

// ---- K1, one mode: bulk copies into a ring, the table in shared memory ----

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more from bulk copies in this phase
__device__ __forceinline__ void mbar_arrive_tx(unsigned long long* bar,
                                               unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
    unsigned done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// `bytes` from global src to shared dst, both on 16 bytes and bytes a
// multiple of 16 (the 1-D TMA copy: no tensor map), completing on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// the same for data read once: evict first from L2
__device__ __forceinline__ void bulk_copy_once(void* dst, const void* src,
                                               unsigned bytes,
                                               unsigned long long* bar) {
    unsigned long long policy;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(policy));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)),
           "l"(policy)
        : "memory");
}

__host__ __device__ constexpr int round16(long long bytes) {
    return (int)((bytes + 15) & ~15LL);
}

// A one-mode launch's cut of the work, from kernels/m2l.py:plan_one (the
// same fields in the same order), and its shared-memory layout.
struct Plan1 {
    int r;        // target points a box (plan[0]; the others follow)
    int G;        // target rows a row group: a block's a0 .. a0 + G - 1
    int ng;       // row groups, ceil(r / G)
    int S;        // stages of the ring
    int nq;       // values of a row a stage (27 r, or a chunk where G = 1)
    int nchunk;   // stages a row takes
    int per;      // boxes a block
    int nsplit;   // blocks a (class, row group)
    int WG;       // consumer warps a group: rows j, j + WG, ... of a stage
    int NGRP;     // consumer groups: group k takes items k, k + NGRP, ...
                  // and so the stages k, k + NGRP, ... (S a multiple of
                  // NGRP): a group waits on a stage's barrier only after
                  // its own last use of the stage, so a parity never
                  // stands for a phase two behind
    int smem;     // bytes of dynamic shared memory
    // the layout, from layout1()
    int tab_off;  // the G table rows (after 2 S + 1 barriers)
    int stage_off, espan, stage_bytes;
};

// bars | table span | S x (E span | sources): a span covers its run from
// the 16-byte boundary below it, so it holds 16 bytes more than the run
inline void layout1(Plan1& Q, int item) {
    const long long row = (long long)kOffsets * Q.r;
    Q.tab_off = round16(8LL * (2 * Q.S + 1));
    Q.stage_off = Q.tab_off + round16(Q.G * row * item) + 16;
    Q.espan = round16((Q.nchunk == 1 ? Q.G * row : Q.nq) * item) + 16;
    Q.stage_bytes = Q.espan + round16((long long)Q.nq * item);
}

// The 16-byte aligned span that covers [p, p + n): its start, its bytes
// and the run's offset in it, in values.
struct Span {
    const void* lo;
    unsigned bytes;
    int off;
};

template <typename T>
__device__ __forceinline__ Span span16(const T* p, long long n) {
    const size_t a = reinterpret_cast<size_t>(p);
    const size_t lo = a & ~(size_t)15;
    const size_t hi = (a + n * sizeof(T) + 15) & ~(size_t)15;
    return {reinterpret_cast<const void*>(lo), (unsigned)(hi - lo),
            (int)((a - lo) / sizeof(T))};
}

// sum over the lanes' values of e * t * g, exp(-e) taken once a value:
// n values from shared memory, 16-byte vectors where VW > 1 (then n, and
// every row start, a multiple of VW)
template <typename T, int VW>
__device__ __forceinline__ T row_dot(const T* e, const T* t, const T* g,
                                     int n, int lane) {
    if constexpr (VW > 1) {
        using V = typename Vec<T, VW>::V;
        const V* ev = reinterpret_cast<const V*>(e);
        const V* tv = reinterpret_cast<const V*>(t);
        const V* gv = reinterpret_cast<const V*>(g);
        T a[VW];
#pragma unroll
        for (int i = 0; i < VW; ++i) {
            a[i] = T(0);
        }
        const int nv = n / VW;
#pragma unroll 2
        for (int v = lane; v < nv; v += 32) {
            const V x = ev[v], y = tv[v], z = gv[v];
#pragma unroll
            for (int i = 0; i < VW; ++i) {
                a[i] += exp_(-lane_of<T>(x, i)) * lane_of<T>(y, i)
                        * lane_of<T>(z, i);
            }
        }
        T s = a[0];
#pragma unroll
        for (int i = 1; i < VW; ++i) {
            s += a[i];
        }
        return s;
    } else {
        T a0 = T(0), a1 = T(0);
        int q = lane;
        for (; q + 32 < n; q += 64) {
            a0 += exp_(-e[q]) * t[q] * g[q];
            a1 += exp_(-e[q + 32]) * t[q + 32] * g[q + 32];
        }
        if (q < n) {
            a0 += exp_(-e[q]) * t[q] * g[q];
        }
        return a0 + a1;
    }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
}

constexpr int kOneThreads = 32 * 9;   // a producer warp, up to 8 consumers

// One mode.  Block (c, row group, split) owns class c, the target rows a0
// .. a0 + Gg - 1 and the boxes b0 .. b0 + per - 1 of its parity plane; its
// work items are (box, chunk of the rows' values) in order.  Warp 0 is the
// producer: lane 0 brings the table rows once and each item's run of E
// (the Gg rows of a box are one contiguous run in E's layout) by bulk
// copies, lanes 1..27 each the item's part of one V-list source row (a
// bulk copy where rows lie on 16 bytes, loads otherwise; zeros off the
// plane), into stage it mod S; every lane then arrives on the stage's
// `full` barrier (32 arrivals and the copies' bytes).  The other warps are
// NGRP groups of WG consumers: group k takes items k, k + NGRP, ..., which
// fall in its own stages (S is a multiple of NGRP); its
// warps take rows j, j + WG, ... of the stage, reduce a row with one exp
// a value from shared memory and store its sum (a chunked row carries its
// lanes' sums to the next stage), and arrive on the stage's `empty`
// barrier, which the producer waits on before it refills the stage.
// VW: values a 16-byte vector, or 1 where rows do not lie on 16 bytes.
template <typename T, int VW>
__global__ void __launch_bounds__(kOneThreads) m2l_translate_one_kernel(
    const T* __restrict__ E,          // (4, m2x, m2y, r, 27 r)
    const T* __restrict__ cosr,       // (4, r, 27 r)
    const T* __restrict__ M,          // (sx, sy, r)
    const int* __restrict__ shift,    // (4, 27, 4)
    T* __restrict__ L,                // (2 m2x, 2 m2y, r)
    const Plane P, const Plan1 Q) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int r = Q.r;
    const int row = kOffsets * r;
    const int nb = P.m2x * P.m2y;
    unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
    unsigned long long* empty = full + Q.S;
    unsigned long long* tbar = empty + Q.S;
    T* tab = reinterpret_cast<T*>(smem + Q.tab_off);

    const int split = blockIdx.x % Q.nsplit;
    const int cg = blockIdx.x / Q.nsplit;
    const int c = cg / Q.ng;
    const int a0 = (cg - c * Q.ng) * Q.G;
    const int Gg = min(Q.G, r - a0);
    const int b0 = split * Q.per;
    const int nitems = min(Q.per, nb - b0) * Q.nchunk;
    const T* trow = cosr + ((size_t)c * r + a0) * row;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < Q.S; ++s) {
            mbar_init(full + s, 32);
            mbar_init(empty + s, Q.WG);
        }
        mbar_init(tbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 0) {
        // the producer
        if (lane == 0) {
            const Span t = span16(trow, (long long)Gg * row);
            mbar_arrive_tx(tbar, t.bytes);
            bulk_copy(tab, t.lo, t.bytes, tbar);
        }
        for (int it = 0; it < nitems; ++it) {
            const int s = it % Q.S;
            if (it >= Q.S) {
                mbar_wait(empty + s, (unsigned)(it / Q.S - 1) & 1u);
            }
            const int bi = it / Q.nchunk;
            const int q0 = (it - bi * Q.nchunk) * Q.nq;
            const int nqc = min(Q.nq, row - q0);
            const int box = b0 + bi;
            unsigned char* st = smem + Q.stage_off + s * Q.stage_bytes;
            T* sg = reinterpret_cast<T*>(st + Q.espan);
            bool arrived = false;
            if (lane == 0) {
                const T* run = E + (((size_t)c * nb + box) * r + a0) * row
                               + q0;
                const Span e = span16(
                    run, Q.nchunk == 1 ? (long long)Gg * row : nqc);
                mbar_arrive_tx(full + s, e.bytes);
                bulk_copy_once(st, e.lo, e.bytes, full + s);
                arrived = true;
            }
            const int o = lane - 1;
            const int lo = max(q0, o * r);
            const int hi = min(q0 + nqc, o * r + r);
            if (o >= 0 && o < kOffsets && lo < hi) {
                const int x = box / P.m2y;
                const T* src = source_row(M, shift, c, o, x, box - x * P.m2y,
                                          P, r);
                T* dst = sg + (lo - q0);
                const int n = hi - lo;
                if (src == nullptr) {
                    for (int k = 0; k < n; ++k) {
                        dst[k] = T(0);
                    }
                } else if (VW > 1) {
                    mbar_arrive_tx(full + s, (unsigned)(n * sizeof(T)));
                    bulk_copy(dst, src + (lo - o * r),
                              (unsigned)(n * sizeof(T)), full + s);
                    arrived = true;
                } else {
                    src += lo - o * r;
                    int k = 0;
                    for (; k + 8 <= n; k += 8) {
                        T v[8];
#pragma unroll
                        for (int i = 0; i < 8; ++i) {
                            v[i] = __ldg(src + k + i);
                        }
#pragma unroll
                        for (int i = 0; i < 8; ++i) {
                            dst[k + i] = v[i];
                        }
                    }
                    for (; k < n; ++k) {
                        dst[k] = __ldg(src + k);
                    }
                }
            }
            if (!arrived) {
                mbar_arrive(full + s);
            }
        }
        return;
    }

    // the consumers
    const int cw = warp - 1;
    const int grp = cw / Q.WG;
    const int wi = cw - grp * Q.WG;
    const T* tb = tab + span16(trow, 0).off;
    mbar_wait(tbar, 0);
    T carry = T(0);                   // a chunked row's lane sums so far
    for (int it = grp; it < nitems; it += Q.NGRP) {
        const int s = it % Q.S;
        mbar_wait(full + s, (unsigned)(it / Q.S) & 1u);
        const int bi = it / Q.nchunk;
        const int ch = it - bi * Q.nchunk;
        const int q0 = ch * Q.nq;
        const int n = min(Q.nq, row - q0);
        const int box = b0 + bi;
        const T* run = E + (((size_t)c * nb + box) * r + a0) * row + q0;
        const T* se = reinterpret_cast<const T*>(smem + Q.stage_off
                                                 + s * Q.stage_bytes)
                      + span16(run, 0).off;
        const T* sg = reinterpret_cast<const T*>(smem + Q.stage_off
                                                 + s * Q.stage_bytes
                                                 + Q.espan);
        const int x = box / P.m2y;
        T* Lb = target_row(L, c, x, box - x * P.m2y, P, r) + a0;
        for (int j = wi; j < Gg; j += Q.WG) {
            T acc = carry + row_dot<T, VW>(se + (Q.nchunk == 1 ? j * row : 0),
                                           tb + j * row + q0, sg, n, lane);
            if (ch + 1 < Q.nchunk) {
                carry = acc;
                continue;
            }
            carry = T(0);
            acc = warp_sum(acc);
            if (lane == 0) {
                Lb[j] = acc;
            }
        }
        __syncwarp();
        if (lane == 0) {
            mbar_arrive(empty + s);
        }
    }
}

template <typename T, int VW>
int launch_one_inst(const void* E, const void* cosr, const void* M,
                    const void* shift, void* L, const Plane& P,
                    const Plan1& Q, cudaStream_t st) {
    auto kern = m2l_translate_one_kernel<T, VW>;
    // the attribute is per device: set on every launch
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Q.smem);
    if (err != cudaSuccess) {
        return (int)err;
    }
    kern<<<4 * Q.ng * Q.nsplit, 32 * (1 + Q.WG * Q.NGRP), Q.smem, st>>>(
        static_cast<const T*>(E), static_cast<const T*>(cosr),
        static_cast<const T*>(M), static_cast<const int*>(shift),
        static_cast<T*>(L), P, Q);
    return (int)cudaGetLastError();
}

template <typename T>
constexpr int vw_of(int r) {
    return kOffsets * r * (int)sizeof(T) % 16 == 0 ? 16 / (int)sizeof(T) : 1;
}

// The plan's ints (kernels/m2l.py:plan_one) checked against the shape and
// the layout.
template <typename T>
int launch_one(const void* E, const void* cosr, const void* M,
               const void* shift, void* L, const Plane& P, const int* plan,
               cudaStream_t st) {
    Plan1 Q;
    Q.r = plan[0];
    Q.G = plan[1];
    Q.ng = plan[2];
    Q.S = plan[3];
    Q.nq = plan[4];
    Q.nchunk = plan[5];
    Q.per = plan[6];
    Q.nsplit = plan[7];
    Q.WG = plan[8];
    Q.NGRP = plan[9];
    const int smem = plan[10];
    const int r = Q.r, row = kOffsets * r;
    const int vw = vw_of<T>(r);
    const int nb = P.m2x * P.m2y;
    layout1(Q, (int)sizeof(T));
    Q.smem = Q.stage_off + Q.S * Q.stage_bytes;
    const bool ok =
        r >= 1 && Q.G >= 1 && Q.G <= r && Q.ng == (r + Q.G - 1) / Q.G
        && Q.S >= 1 && Q.nq >= 1 && Q.nq <= row && Q.nq % vw == 0
        && Q.nchunk == (row + Q.nq - 1) / Q.nq && (Q.nchunk == 1 || Q.G == 1)
        && Q.per >= 1 && Q.nsplit >= 1 && Q.per * (Q.nsplit - 1) < nb
        && Q.per * Q.nsplit >= nb && Q.WG >= 1 && Q.WG <= Q.G
        && Q.NGRP >= 1 && Q.WG * Q.NGRP <= kOneThreads / 32 - 1
        && Q.S % Q.NGRP == 0
        && (Q.nchunk == 1 || Q.NGRP == 1) && Q.smem == smem
        && Q.smem <= 227 * 1024;
    if (!ok) {
        return (int)cudaErrorInvalidValue;
    }
    if (vw > 1) {
        return launch_one_inst<T, 16 / sizeof(T)>(E, cosr, M, shift, L, P, Q,
                                                  st);
    }
    return launch_one_inst<T, 1>(E, cosr, M, shift, L, P, Q, st);
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
    const T* __restrict__ E,          // (4, m2x, m2y, r, 27 r)
    const T* __restrict__ cosr,       // (D, 4, r, 27 r)
    const T* __restrict__ M,          // (sx, sy, r)
    const int* __restrict__ shift,    // (4, 27, 4)
    T* __restrict__ L,                // (D, 2 m2x, 2 m2y, r)
    const Plane P, int n_full, int a_per_block) {
    using S = Modes<T, R>;
    using V = typename S::V;
    constexpr int NB = S::NB, TB = S::TB, OB = S::OB;
    constexpr int kVecsPerRow = R / S::VW;
    __shared__ __align__(16) T g[TB * OB];  // the tile's source multipoles
    const int nboxes = P.m2x * P.m2y;
    const int tiles = (nboxes + TB - 1) / TB;
    const int c = blockIdx.x / tiles;
    const int box0 = (blockIdx.x - c * tiles) * TB;

    // the tile's source multipoles, one (box, offset) row of r values per
    // job, zero off the plane and past the last box
    for (int job = threadIdx.x; job < TB * kOffsets; job += blockDim.x) {
        const int tb = job / kOffsets;
        const int o = job - tb * kOffsets;
        const int box = box0 + tb;
        const int x = box / P.m2y;
        const int y = box - x * P.m2y;
        V* dst = reinterpret_cast<V*>(g + tb * OB + o * R);
        const T* row = box < nboxes
            ? source_row(M, shift, c, o, x, y, P, R) : nullptr;
        if (row != nullptr) {
            const V* src = reinterpret_cast<const V*>(row);
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
    const size_t plane = (size_t)4 * nboxes * R;
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
        const int x = rowbox[k] / P.m2y;
        const int y = rowbox[k] - x * P.m2y;
        gk[k] = g + (i + kSlots * k) * OB;
        Lk[k] = target_row(L, c, x, y, P, R);
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
                 const void* shift, void* L, const Plane& P, int n_full,
                 cudaStream_t stream) {
    constexpr int TB = Modes<T, R>::TB;
    // a coarse level has few tiles: its target points go to two blocks
    const int tiles = (P.m2x * P.m2y + TB - 1) / TB;
    const int a_per_block = 4 * tiles < kMinBlocks ? (R + 1) / 2 : R;
    const dim3 grid(4 * tiles, (R + a_per_block - 1) / a_per_block);
    m2l_translate_modes_kernel<T, R, NDL><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(E), static_cast<const T*>(cosr),
        static_cast<const T*>(M), static_cast<const int*>(shift),
        static_cast<T*>(L), P, n_full, a_per_block);
    return (int)cudaGetLastError();
}

// chunks of kModeChunk modes, the last one of 1..kModeChunk
template <typename T, int R>
int launch_modes_r(const void* E, const void* cosr, const void* M,
                   const void* shift, void* L, const Plane& P, int D,
                   cudaStream_t st) {
    const int n_full = (D - 1) / kModeChunk;
#define ANISO_K1D_ND(N)                                                   \
    case N:                                                               \
        return launch_modes<T, R, N>(E, cosr, M, shift, L, P, n_full, st);
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
            return launch_modes<T, R, 9>(E, cosr, M, shift, L, P, n_full,
                                         st);
    }
#undef ANISO_K1D_ND
}

// The all-modes kernel (D >= 2; one mode is launch_one) takes r = np^2
// for np 2-7 at compile time and any other r whose row fits 48 KB at run
// time.
template <typename T>
int launch(const void* E, const void* cosr, const void* M, const void* shift,
           void* L, const Plane& P, int r, int D, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    const int blocks = 4 * P.m2x * P.m2y;
    if (D < 2) {
        return (int)cudaErrorInvalidValue;
    }
#define ANISO_K1D_R(RV)                                                   \
    case RV:                                                              \
        return launch_modes_r<T, RV>(E, cosr, M, shift, L, P, D, st);
    switch (r) {
        ANISO_K1D_R(4)
        ANISO_K1D_R(9)
        ANISO_K1D_R(16)
        ANISO_K1D_R(25)
        ANISO_K1D_R(36)
        ANISO_K1D_R(49)
        default:
            break;
    }
#undef ANISO_K1D_R
    const size_t row = (size_t)kOffsets * r * sizeof(T);
    if (row > 48 * 1024) {
        return (int)cudaErrorInvalidValue;
    }
    m2l_translate_modes_any_kernel<T><<<blocks, kThreads, row, st>>>(
        static_cast<const T*>(E), static_cast<const T*>(cosr),
        static_cast<const T*>(M), static_cast<const int*>(shift),
        static_cast<T*>(L), P, r, D);
    return (int)cudaGetLastError();
}

// The plane of a whole level (ext 0) or of a shard extended by ext = 2
// boxes on each side
inline Plane plane(int m2x, int m2y, int ext) {
    return Plane{m2x, m2y, 2 * m2x + 2 * ext, 2 * m2y + 2 * ext, ext};
}

}  // namespace

// One mode, whole level (ext 0) or shard (K1-S, ext 2): `plan` is the 11
// ints of kernels/m2l.py:plan_one for (m2x, m2y, r, itemsize).
extern "C" int aniso_m2l_translate_one_f32(
    const void* E, const void* cosr, const void* M, const void* shift,
    void* L, int m2x, int m2y, int ext, const int* plan, void* stream) {
    return launch_one<float>(E, cosr, M, shift, L, plane(m2x, m2y, ext),
                             plan, (cudaStream_t)stream);
}

extern "C" int aniso_m2l_translate_one_f64(
    const void* E, const void* cosr, const void* M, const void* shift,
    void* L, int m2x, int m2y, int ext, const int* plan, void* stream) {
    return launch_one<double>(E, cosr, M, shift, L, plane(m2x, m2y, ext),
                              plan, (cudaStream_t)stream);
}

// All D >= 2 modes
extern "C" int aniso_m2l_translate_f32(
    const void* E, const void* cosr, const void* M, const void* shift,
    void* L, int m2, int r, int D, void* stream) {
    return launch<float>(E, cosr, M, shift, L, plane(m2, m2, 0), r, D,
                         stream);
}

extern "C" int aniso_m2l_translate_f64(
    const void* E, const void* cosr, const void* M, const void* shift,
    void* L, int m2, int r, int D, void* stream) {
    return launch<double>(E, cosr, M, shift, L, plane(m2, m2, 0), r, D,
                          stream);
}

// K1-S, all D >= 2 modes: Mext is the shard's (2 m2x + 4, 2 m2y + 4, r)
// extended multipoles
extern "C" int aniso_m2l_translate_shard_f32(
    const void* E, const void* cosr, const void* Mext, const void* shift,
    void* L, int m2x, int m2y, int r, int D, void* stream) {
    return launch<float>(E, cosr, Mext, shift, L, plane(m2x, m2y, 2), r, D,
                         stream);
}

extern "C" int aniso_m2l_translate_shard_f64(
    const void* E, const void* cosr, const void* Mext, const void* shift,
    void* L, int m2x, int m2y, int r, int D, void* stream) {
    return launch<double>(E, cosr, Mext, shift, L, plane(m2x, m2y, 2), r, D,
                          stream);
}
