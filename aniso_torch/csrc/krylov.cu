// K11, K11-S and K12: one Arnoldi step of the restarted GMRES on the card,
// for sm_90a, with the Krylov state in one float64 buffer that the kernels
// read and write, so that nothing is read back to the host inside a step
// and a step can be replayed from a CUDA graph.
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
//   K11-S, the same CGS2 on a sharded basis (JAX's "per-shard contraction
//   + an (m+1)-scalar psum", :13-21, under benchmarks/sharded_solve.py
//   :107-112): each shard k holds its part V_k (m + 1, n_k) of the basis,
//   its part w_k of the matvec's output and its input buffer u_k; every
//   sum runs over all shards.
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
// and u: ((i + 1) + 3) n itemsize bytes at 3.35 TB/s (CGS2 from device
// memory reads V three times: 3 (i + 1) n itemsize); K11-S the same with n
// the shards' n_k summed.  K12 moves a few KB of state: its floor is one
// launch's latency, which floor_kernel measures alone; the
// back-substitution's is its chain of i dependent steps.
//
// Design.  K11 and K11-S are one block code (cgs2_step) over a table of up
// to 16 shards of one card passed by value (ShardTable; K11 is the table of
// one shard), one cooperative launch a step on the caller's stream
// (captured in the step's graph), a block of 12 consumer warps and one
// producer warp on each SM.  The shards' vectors (16 bytes, or one value
// where a row does not start on 16 bytes) are taken as one concatenation
// in shard order and cut into `blocks` ranges of whole 128-byte lines, one
// a block: every SM serves, shards of any size, and a block's range may
// cross from one shard into the next.  The partials of the blocks, summed
// in block order, are then summed in (shard, chunk) order, in float64 and
// with no atomics: the result does not depend on the run, and a replay
// repeats bitwise.  Three passes, each ending with a grid barrier and
// every block summing the partials:
//   (a) h1 = V[:i+1] w;  (b) w' = w - h1 V and h2 = V[:i+1] w';
//   (c) w'' = w - (h1 + h2) V from w as it came in in the ring instance
//   (w' lives in registers only there: the plain version, and the lean
//   instance below, round w' to the field's type first; the two differ
//   by at most 2 float32 ulps of V[i+1]'s largest value at the timed
//   shapes, PERF.md §6) and |w''|^2;  then every block writes V[i+1] = u = w'' / (|w''| or 1)
//   and w'' into w, and block 0 the column col = h1 + h2, col[i+1] =
//   |w''| and h2 into the state, and on one card (givens = 1) runs K12's
//   Givens step as the kernel's epilogue: the column, cs, sn and s staged
//   in shared memory in parallel, the chain of rotations on one thread,
//   the rotated column into col and H[:, i] in parallel.  No block reads
//   the header after the first barrier, so block 0's writes of i, j and
//   done race with nothing.
// The launch (grid, shared memory, ring) is a pure function of the shapes
// (kernels/krylov.py:k11_plan), so that one captured graph serves every
// step.  Two instances, chosen by the plan from the shapes:
//   * the lean instance (lean_step; no ring, stages = 0) where a block's
//     range of all m + 1 rows fits its shared memory (small fields: bench's
//     64^2, the 4 x 32^2 shards): 16 warps, no producer, no mbarrier and
//     no step shape to work out, so that a launch costs what a resident
//     step must.  Fused, the range of rows 0..i and w is copied in by
//     cp.async and every pass reads it there; split, each launch reads V
//     and w in place (w' and w'' go into w).  A thread a vector forms w'
//     and w'' (rounded to the field's type each, as the plain version),
//     a warp a row sums V[k] . w.
//   * the ring instance (cgs2_step) for every larger field.
// What a ring block does depends on the step, read from the state (one
// thread works the step's shape out, shape_of, while others set up the
// mbarriers and the block's segments; kernels/krylov.py:step_shape mirrors
// it, aniso_k11_shape exports it to the tests):
//   * the resident share: rows 0..i and w of the first r vectors of the
//     block's range, copied in once in (a) and read from shared memory by
//     (a), (b) and (c): the whole range where it fits all the shared memory
//     after the head (no ring that step: sharded512's steps 0 and 1), else
//     the most that fits beside a ring of 3 stages of up to 64 KB (a small
//     share: a ring too small to stream at the memory's rate costs more
//     than the share saves, PERF.md §6).
//   * the rest streams through the ring, the producer warp issuing a
//     slot's next item as soon as every consumer warp has released it (and
//     the next pass's first items before the grid barrier), by 1-D bulk
//     copies (cp.async.bulk, a row and shard a copy, completing on the
//     stage's mbarrier).  On the H100 a bulk copy holds the SM's copy
//     engine about 65 cycles whatever its length below a few KB, so every
//     row of an item is 2 KB or more.  With few rows an item is a tile:
//     every row and w of as many vectors as a stage holds, read as the
//     resident share is, (b) in one sweep.  With many rows an item is a
//     chunk of rc rows of a vector block (kConsumers / gs vectors, its rows
//     0..i within 320 KB), a block's w read into registers while the block
//     before it streams, (b) sweeping a block twice: w' from its rows, then
//     V[k] . w' from the same rows again, read from L2.  (a) walks the items
//     forward, (b) backward, (c) forward again, so that each pass starts on
//     the bytes the last one ended on, still in the 50 MB L2.
//   * a consumer thread owns a vector's rows k = g mod G (G = 1 for up to 8
//     rows a lane, doubling to 32; more in rounds), a vector block's gs
//     lanes likewise within a chunk; (b)'s and (c)'s sums h V from G (gs)
//     lanes by a butterfly give w' and w''; (a)'s and (b)'s row sums go
//     into the warp's slot by a transposing butterfly (each halving step
//     keeps half of a lane's rows and swaps the rest), once a tile or
//     chunk; the warps' slots are summed in warp order.  Row strides are
//     padded so that a quarter-warp's 16-byte loads fall in eight bank
//     groups.  No barrier of the block inside a pass.
// The split route (a process group, or shards on more than one card) runs
// the step in four launches a card, (a), (b), (c) each ending with block 0
// writing its sum over the card's shards into `sums`, which the caller sums
// over cards and processes (one all_reduce each) before the next launch
// reads it; the fourth normalises, and block 0 of the card that holds the
// state writes the column and runs the Givens step after a grid barrier.
// Nothing stays resident between launches there: each ring launch streams
// its pass through the ring in the same L2 order; w stays as it came until
// (c) writes w'' into it for the fourth.  For measurement, the empty step
// (phase kEmpty, ring plans) runs the same grid, its three barriers and
// sums with no basis: the fixed cost of a launch.  Built with K11_PROBE
// set (tools/kernel_ab.py's k11s_probe variant; never the solver's
// library), the ring kernel also takes kStream (the resident share and
// every pass's chunks brought in and released, no arithmetic: the ring's
// floor) and the kTrace bit (thread 0 of each block stamps the global
// timer at the step's marks).
// K12's step alone (givens_kernel; no solver path launches it: it times
// the Givens step apart) is one thread of one block: its work is O(i)
// dependent operations.  The back-substitution (backsub_kernel) is one
// block: H's upper triangle copied into shared memory with coalesced loads,
// then diagonal blocks of 32 columns solved on one warp with the rows in
// registers, i dependent steps (a quotient, a shuffle, a
// multiply-subtract), the rows above each block updated by every thread.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_limits.cuh"

// 1: the measurement-only phases (kStream, kTrace) in the ring kernel
#ifndef K11_PROBE
#define K11_PROBE 0
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int kConsumerWarps = 12;   // kernels/krylov.py CONSUMER_WARPS
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kWarps = kThreads / 32;
constexpr int kProducer = kConsumerWarps;
constexpr int kLeanWarps = 16;       // the lean instance's (LEAN_WARPS)
constexpr int kLeanThreads = 32 * kLeanWarps;
constexpr int kRmax = 8;             // rows a thread sums in registers (RMAX)
constexpr int kMaxStages = 4;        // the ring's stages at most (MAX_STAGES)
constexpr int kBsThreads = 256;      // the back-substitution's block
constexpr int kMaxShards = 16;       // K11-S's shards a launch (MAX_SHARDS)
constexpr int kAlign = 8;            // vectors of a 128-byte line (ALIGN)
// a bulk-copied row's least bytes (a bulk copy costs the SM's copy engine
// about the same time whatever its size below this): a shorter resident
// share comes by every thread's own 16-byte copies, and the ring's items
// are tiles only where their rows reach it
constexpr int kBulkMin = 2048;
// a streamed vector block: one vector a consumer thread's lane group, its
// rows 0..i at most kL2Block bytes where it can, so that (b)'s second
// sweep of it finds them in L2 (132 blocks of 320 KB: 42 MB of the 50 MB;
// 160 KB measured slower at step 79, PERF.md §6)
constexpr int kL2Block = 320 * 1024;

// K11's phases: all in one launch (K11, K11-S's fused route), one a launch
// (K11-S's split route); for measurement, the fused launch's grid with no
// basis (kEmpty) and, in a K11_PROBE build, the step's copies alone, no
// arithmetic (kStream)
enum { kPhaseA = 0, kPhaseB = 1, kPhaseC = 2, kPhaseD = 3, kFused = 4,
       kEmpty = 5, kStream = 6 };

// The shards of one card, a kernel parameter (__grid_constant__, as K10's
// table): shard s's basis part V (m + 1, n), its matvec output w and its
// input buffer u, each n values; off: the vectors before shard s in the
// concatenation of the shards' rows.
struct ShardTable {
    void* V[kMaxShards];
    void* w[kMaxShards];
    void* u[kMaxShards];
    long long n[kMaxShards];
    long long off[kMaxShards + 1];
    int shards;
};

// The launch's plan (kernels/krylov.py:k11_plan): `chunk` vectors a block,
// a ring of `stages` stages of `stage_bytes` (none: the lean instance),
// `res_bytes` beside it for the resident share, `pool` the shared memory
// after the head (a block's whole range, where it fits there, needs no
// ring that step).
struct Plan {
    long long chunk;
    int m, stages, stage_bytes, res_bytes, pool, givens, phase, trace;
};

#if K11_PROBE
// A traced launch (phase | kTrace): thread 0 of each of the first
// kTraceBlocks blocks stamps the global timer at the step's marks
// (tools/k11s_probe.py:TRACE_MARKS) into k11_trace.
constexpr int kTrace = 16;
constexpr int kTraceBlocks = 256;
constexpr int kTraceMarks = 10;
__device__ unsigned long long k11_trace[kTraceBlocks][kTraceMarks];
#endif

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
__device__ __forceinline__ Pack<T, VEC> zero_pack() {
    Pack<T, VEC> x;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
        x.v[q] = T(0);
    }
    return x;
}

// x . y with y already in float64
template <typename T, int VEC>
__device__ __forceinline__ double dot(const Pack<T, VEC>& x, const double* y) {
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
        s += (double)x.v[q] * y[q];
    }
    return s;
}

// x . y, both packs of the field's type, in float64
template <typename T, int VEC>
__device__ __forceinline__ double dot(const Pack<T, VEC>& x,
                                      const Pack<T, VEC>& y) {
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
        s += (double)x.v[q] * (double)y.v[q];
    }
    return s;
}

// a pass as a type, for the block code's instances of each
template <int P>
struct Pass {
    static constexpr int value = P;
};

// ---- the step's shape: a pure function of i and the plan ----

// The head of the shared memory, in doubles: h1, h2 (m + 1 each), the
// consumer warps' row sums (kConsumerWarps x (m + 1)), their norm sums, the
// ring's and the resident share's mbarriers, the block's segments (3 each)
// and their count, the step's shape (8); rounded up to 16 bytes
// (kernels/krylov.py:head_bytes).
__host__ __device__ inline int k11_head(int m) {
    return ((2 + kConsumerWarps) * (m + 1) + kConsumerWarps
            + 2 * kMaxStages + 1 + 3 * kMaxShards + 1 + 8 + 1) & ~1;
}

// G, the lanes that share a vector at R rows: the least power of two up to
// 32 that leaves a lane at most kRmax rows (kernels/krylov.py:lanes).
__host__ __device__ inline int lanes_of(int R) {
    int G = 1;
    while (G < 32 && (R + G - 1) / G > kRmax) {
        G <<= 1;
    }
    return G;
}

// A row stride (in packs) for G lanes a vector: the 8 lanes of a
// quarter-warp (G = 2: 4 vectors x 2 rows; 4: 2 x 4; 8 or more: 1 x 8)
// then load from 8 different 16-byte bank groups: stride = 8 / G mod 8
// for G = 2, 4; odd for G >= 8; any for G = 1.  The largest such stride
// up to x (0 if none), and the least from x.
__host__ __device__ inline long long stride_floor(long long x, int G) {
    if (x <= 0) {
        return 0;
    }
    if (G == 1) {
        return x;
    }
    if (G >= 8) {
        return (x & 1) ? x : x - 1;
    }
    const long long y = x - ((x - 8 / G) & 7);
    return y > 0 ? y : 0;
}

__host__ __device__ inline long long stride_ceil(long long x, int G) {
    if (x <= 0) {
        return 0;
    }
    if (G == 1) {
        return x;
    }
    if (G >= 8) {
        return (x & 1) ? x : x + 1;
    }
    return x + ((8 / G - x) & 7);
}

// What a block of cv vectors does at step i (kernels/krylov.py:step_shape):
// R = i + 1 rows.  The resident share: r vectors (rows 0..i and w) at row
// stride rs: the block's whole range where it fits the pool (whole = 1: no
// ring then), else the most that fit res_bytes beside the ring, whole
// 128-byte lines where it reaches one (none on the split route); read G
// lanes a vector, the rows in `rounds` of kRmax G.  The rest streams in nvb items: where
// a stage holds every row and w of whole lines whose rows are kBulkMin
// bytes or more (few rows), tiles (tile = 1) of vb such vectors at row
// stride ts, rc = R, nc = 1, read as the resident share is; else vector
// blocks of vb = kConsumers / gs vectors (gs lanes a vector, the fewest, a
// power of two, that keep a block's rows within kL2Block bytes and a row
// within a stage), each as nc chunks of rc rows, a chunk a stage (at row
// stride ts).
struct Shape {
    int R, G, rounds, vb, gs, rc, nc, tile, whole;
    long long r, rs, ts, nvb;
};

__host__ __device__ inline long long whole_lines(long long x) {
    return x >= kAlign ? x - x % kAlign : x;
}

__host__ __device__ inline Shape shape_of(int i, long long cv, int pack,
                                          int stages, int stage_bytes,
                                          int res_bytes, int pool,
                                          bool resident) {
    // 32-bit quotients (a 64-bit one is a long chain of dependent
    // instructions): bytes and vectors of a block stay below 2^31
    Shape s;
    s.R = i + 1;
    s.G = lanes_of(s.R);
    s.rounds = (unsigned)(s.R + kRmax * s.G - 1) / (unsigned)(kRmax * s.G);
    s.r = 0;
    s.whole = resident
        && (long long)(s.R + 1) * stride_ceil(cv, s.G) * pack <= pool;
    if (s.whole) {
        s.r = cv;
    } else if (resident && res_bytes > 0) {
        const long long fit = whole_lines(stride_floor(
            (unsigned)res_bytes / ((unsigned)(s.R + 1) * pack), s.G));
        s.r = cv < fit ? cv : fit;
    }
    s.rs = stride_ceil(s.r, s.G);
    s.vb = s.gs = s.rc = s.nc = s.tile = 0;
    s.ts = s.nvb = 0;
    const long long tv = stages > 0 ? whole_lines(stride_floor(
        (unsigned)stage_bytes / ((unsigned)(s.R + 1) * pack), s.G)) : 0;
    if (stages > 0 && cv > s.r && tv * pack >= kBulkMin) {
        s.tile = 1;
        s.vb = (int)tv;
        s.gs = s.G;
        s.ts = stride_ceil(tv, s.G);
        s.rc = s.R;
        s.nc = 1;
        s.nvb = (unsigned)(cv - s.r + tv - 1) / (unsigned)tv;
    } else if (stages > 0 && cv > s.r) {
        const unsigned l2 = kL2Block / ((unsigned)s.R * pack);
        const unsigned one = (unsigned)stage_bytes / (unsigned)pack;
        for (s.gs = 1; s.gs < 32; s.gs <<= 1) {
            const int vb = kConsumers / s.gs;
            if ((unsigned)vb <= l2 && stride_ceil(vb, s.gs) <= (long long)one) {
                break;
            }
        }
        s.vb = kConsumers / s.gs;
        s.ts = stride_ceil(s.vb, s.gs);
        int rc = (int)((unsigned)stage_bytes / ((unsigned)s.ts * pack));
        rc = rc < s.R ? rc : s.R;
        s.rc = rc < kRmax * s.gs ? rc : kRmax * s.gs;
        s.nc = (s.R + s.rc - 1) / s.rc;
        s.nvb = (unsigned)(cv - s.r + s.vb - 1) / (unsigned)s.vb;
    }
    return s;
}

// ---- asynchronous copies ----

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

// One VEC-value copy from global into shared memory in flight (cp.async;
// 16 bytes through L2 only).
template <typename P>
__device__ __forceinline__ void copy_async(P* dst, const P* src) {
    if constexpr (sizeof(P) == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(smem_u32(dst)), "l"(src) : "memory");
    } else {
        __pipeline_memcpy_async(dst, src, sizeof(P));
    }
}

// ---- the block's vectors in the shards ----

// A block's range in segments, one a shard it crosses: seg[3 j] the
// segment's first vector in the block, seg[3 j + 1] in its shard's row,
// seg[3 j + 2] the shard.
struct Loc {
    int s;
    long long e;        // the vector in shard s's row
};

__device__ __forceinline__ Loc locate(const long long* seg, int nseg,
                                      long long x) {
    int j = 0;
    while (j + 1 < nseg && x >= seg[3 * (j + 1)]) {
        ++j;
    }
    return {(int)seg[3 * j + 2], x - seg[3 * j] + seg[3 * j + 1]};
}

// The producer (warp kProducer, between its own items): rows k0..k0+nr-1
// of V (and w into row wrow, when with_w) of the block's vectors [x0, x0 +
// nt), into dst at row stride st packs, completing on bar: a 1-D bulk copy
// a row and segment, the lanes taking the rows in turn; one value a load
// (VEC = 1: rows off 16 bytes), copied by the lanes, then one arrival.
template <typename T, int VEC>
__device__ void load_chunk(const ShardTable& tab, const long long* seg,
                           int nseg, long long cv, long long x0, long long nt,
                           int k0, int nr, bool with_w, int wrow,
                           long long st, Pack<T, VEC>* dst,
                           unsigned long long* bar, int lane) {
    using P = Pack<T, VEC>;
    const long long x1 = x0 + nt;
    const int rows = nr + (with_w ? 1 : 0);
    if constexpr (VEC > 1) {
        if (lane == 0) {
            mbar_arrive_tx(bar, (unsigned)(rows * nt * (long long)sizeof(P)));
        }
        __syncwarp();
    }
    for (int j = 0; j < nseg; ++j) {
        const long long s0 = seg[3 * j];
        const long long s1 = j + 1 < nseg ? seg[3 * (j + 1)] : cv;
        const long long lo = x0 > s0 ? x0 : s0, hi = x1 < s1 ? x1 : s1;
        if (lo >= hi) {
            continue;
        }
        const int s = (int)seg[3 * j + 2];
        const long long e = lo - s0 + seg[3 * j + 1];
        for (int k = VEC > 1 ? lane : 0; k < rows; k += VEC > 1 ? 32 : 1) {
            const P* src = reinterpret_cast<const P*>(
                k < nr ? static_cast<const T*>(tab.V[s]) + (k0 + k) * tab.n[s]
                       : static_cast<const T*>(tab.w[s])) + e;
            P* d = dst + (k < nr ? k : wrow) * st + (lo - x0);
            if constexpr (VEC > 1) {
                bulk_copy(d, src, (unsigned)((hi - lo) * sizeof(P)), bar);
            } else {
                for (long long v = lane; v < hi - lo; v += 32) {
                    d[v] = src[v];
                }
            }
        }
    }
    if constexpr (VEC == 1) {
        __syncwarp();
        if (lane == 0) {
            mbar_arrive(bar);
        }
    }
}

// h[k] = sum over b < nb of part[k nb + b], k < rows, in the same order in
// every block of W warps: a warp a row (kJ rows a warp at once), a lane the
// partials b = lane, lane + 32, ... in that order, then the butterfly;
// every load of a batch in flight together (read from L2: other blocks
// wrote them).
template <int W>
__device__ void grid_rows(const double* part, int nb, int rows, double* h) {
    constexpr int kJ = 7, kQ = 8;          // 91 rows in one round (W = 13)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k0 = warp; k0 < rows; k0 += W * kJ) {
        double acc[kJ];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
            acc[j] = 0.0;
        }
        for (int b0 = lane; b0 < nb; b0 += 32 * kQ) {
#pragma unroll
            for (int j = 0; j < kJ; ++j) {
                const int k = k0 + j * W;
#pragma unroll
                for (int q = 0; q < kQ; ++q) {
                    const int b = b0 + 32 * q;
                    if (k < rows && b < nb) {
                        acc[j] += __ldcg(part + (long long)k * nb + b);
                    }
                }
            }
        }
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
            const double s = warp_sum(acc[j]);
            if (lane == 0 && k0 + j * W < rows) {
                h[k0 + j * W] = s;
            }
        }
    }
    __syncthreads();
}

// The new rotation (cs, sn) from (dx, dy): gmres.cpp:26-39, JAX's three
// branches, every operation rounded on its own.
__device__ __forceinline__ void rotation(double dx, double dy, double* c,
                                         double* g) {
    if (dy == 0.0) {
        *c = 1.0;
        *g = 0.0;
    } else if (fabs(dy) > fabs(dx)) {
        const double t = __ddiv_rn(dx, dy);
        *g = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(t, t))));
        *c = __dmul_rn(t, *g);
    } else {
        const double t = __ddiv_rn(dy, dx);
        *c = __ddiv_rn(1.0, __dsqrt_rn(__dadd_rn(1.0, __dmul_rn(t, t))));
        *g = __dmul_rn(t, *c);
    }
}

// K12's Givens step on an active step's column col[0..i+1] (shared or
// global memory; cs, sn: the i earlier rotations, read from `csr` /
// `snr`), one thread: the earlier rotations, the new one into the state's
// cs[i], sn[i], s[i], s[i+1], resid, done, i += 1, j += 1.  The column is
// left rotated in col (col[i+1] = 0); the caller writes it into the
// state's col and H[:, i].  The running col[k] stays in a register, so
// the chain of dependent operations reads col, cs and sn only ahead of it.
__device__ void givens_chain(double* st, int m, int i, double* col,
                             const double* csr, const double* snr) {
    const Layout L = layout(m);
    double a = col[0];                   // col[k], rotated by rotations < k
    for (int k = 0; k < i; ++k) {        // the earlier rotations
        const double c = csr[k], g = snr[k], nx = col[k + 1];
        col[k] = __dadd_rn(__dmul_rn(c, a), __dmul_rn(g, nx));
        a = __dadd_rn(__dmul_rn(-g, a), __dmul_rn(c, nx));
    }
    const double dx = a, dy = col[i + 1];
    double c, g;
    rotation(dx, dy, &c, &g);
    double* s = st + L.s;
    st[L.cs + i] = c;
    st[L.sn + i] = g;
    col[i] = __dadd_rn(__dmul_rn(c, dx), __dmul_rn(g, dy));
    col[i + 1] = 0.0;
    const double s0 = s[i], s1 = s[i + 1];
    const double si = __dadd_rn(__dmul_rn(c, s0), __dmul_rn(g, s1));
    const double si1 = __dadd_rn(__dmul_rn(-g, s0), __dmul_rn(c, s1));
    s[i] = si;
    s[i + 1] = si1;
    const double resid = __ddiv_rn(fabs(si1), st[kNormb]);
    st[kResid] = resid;
    st[kDone] = resid < st[kTol] ? 1.0 : 0.0;
    st[kI] = (double)(i + 1);
    st[kJ] = st[kJ] + 1.0;
}

// K11's epilogue with K12's Givens step folded in (block 0, every thread,
// after the last grid barrier): the column h1 + h2, |w''| into shared
// memory (over h1) and h2 into the state, the i earlier rotations into
// `rot` (shared), all in parallel; then the chain on one thread from
// shared memory; then the rotated column into the state's col and H[:, i]
// in parallel.  Every other block read the header before the first grid
// barrier and reads no state after it.
__device__ void givens_epilogue(double* st, int m, int i, double* h1,
                                const double* h2, double* rot,
                                double wnorm) {
    const Layout L = layout(m);
    double* col = h1;
    double* csr = rot;                   // [m]
    double* snr = rot + m;               // [m]
    const int nt = blockDim.x;
    for (int k = threadIdx.x; k <= i + 1; k += nt) {
        if (k <= i) {
            const double h = h2[k];
            col[k] = h1[k] + h;
            st[L.h2 + k] = h;
        } else {
            col[k] = wnorm;
        }
    }
    for (int k = threadIdx.x; k < i; k += nt) {
        csr[k] = st[L.cs + k];
        snr[k] = st[L.sn + k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        givens_chain(st, m, i, col, csr, snr);
    }
    __syncthreads();
    double* Hc = st + L.H + (long long)i * (m + 1);
    for (int k = threadIdx.x; k <= i + 1; k += nt) {
        st[L.col + k] = col[k];
        Hc[k] = col[k];
    }
}

// One block's share of a CGS2 step (the header states the passes): block
// b = blockIdx.x of nb owns the vectors [b chunk, (b + 1) chunk) of the
// shards' concatenation (fewer at the end), cv of them.  part: (a)'s and
// (b)'s partials, (m + 1) nb each as [row][block], then (c)'s, nb.  phase
// kFused: (a), (b), (c) and the epilogue in one launch; kEmpty: the same
// launch with no vector and no write; kStream (K11_PROBE): the copies
// alone;
// kPhaseA, kPhaseB, kPhaseC, kPhaseD (the split route, one launch each):
// (a), (b) and (c) each stop after their sum, block 0 writing it into
// `sums` (h1, h2: m + 1 each, then |w''|^2), which the caller sums over
// the launches of its other cards and processes before the next phase
// reads it there; kPhaseD normalises and, after a grid barrier (no block
// reads the header after it), block 0 writes the column and runs the
// Givens step.
template <typename T, int VEC>
__device__ __forceinline__ void cgs2_step(const ShardTable& tab,
                                          const Plan& pl, double* st,
                                          double* __restrict__ part,
                                          double* __restrict__ sums) {
    const int m = pl.m;
#if K11_PROBE
    if (pl.trace && threadIdx.x == 0 && blockIdx.x < kTraceBlocks) {
        unsigned long long t;              // the block's entry
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        k11_trace[blockIdx.x][kTraceMarks - 1] = t;
    }
#endif
    const int i = active_row(st, m);
    if (i < 0) {
        return;
    }
    using P = Pack<T, VEC>;
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) double sm[];
    double* h1 = sm;                                  // [m + 1]
    double* h2 = h1 + (m + 1);                        // [m + 1]
    double* red = h2 + (m + 1);                       // [warps][m + 1]
    double* nrms = red + kConsumerWarps * (m + 1);    // [warps]
    unsigned long long* full =
        reinterpret_cast<unsigned long long*>(nrms + kConsumerWarps);
    unsigned long long* empty = full + kMaxStages;
    unsigned long long* resbar = empty + kMaxStages;
    long long* seg = reinterpret_cast<long long*>(resbar + 1);
    int* nsegp = reinterpret_cast<int*>(seg + 3 * kMaxShards);
    Shape* shp = reinterpret_cast<Shape*>(seg + 3 * kMaxShards + 1);
    unsigned char* ring = reinterpret_cast<unsigned char*>(sm + k11_head(m));
    const Layout L = layout(m);
    const int phase = pl.phase;
    const bool none = phase == kEmpty;
    const bool copies = K11_PROBE && phase == kStream;
    const bool fused = phase == kFused || none || copies;
    const int nb = gridDim.x, b = blockIdx.x;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const bool producer = warp == kProducer;
    const long long total = tab.off[tab.shards];
    const long long bx0 = (long long)b * pl.chunk;
    const long long cv = none || bx0 >= total
        ? 0 : (total - bx0 < pl.chunk ? total - bx0 : pl.chunk);
    double* pa = part;
    double* pb = pa + (long long)(m + 1) * nb;
    double* pc = pb + (long long)(m + 1) * nb;

    // the set-up, three threads at once: the mbarriers, the block's
    // segments, the step's shape
    if (threadIdx.x == 0) {
        for (int s = 0; s < pl.stages; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, kConsumerWarps);
        }
        mbar_init(resbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    } else if (threadIdx.x == 32) {
        int ns = 0;
        for (int s = 0; s < tab.shards; ++s) {
            const long long lo = bx0 > tab.off[s] ? bx0 : tab.off[s];
            const long long hi = bx0 + cv < tab.off[s + 1] ? bx0 + cv
                                                           : tab.off[s + 1];
            if (lo < hi) {
                seg[3 * ns] = lo - bx0;
                seg[3 * ns + 1] = lo - tab.off[s];
                seg[3 * ns + 2] = s;
                ++ns;
            }
        }
        *nsegp = ns;
    } else if (threadIdx.x == 64) {
        *shp = shape_of(i, cv, (int)sizeof(P), pl.stages, pl.stage_bytes,
                        pl.res_bytes, pl.pool, fused);
    }
    for (int e = threadIdx.x; e < kConsumerWarps * (m + 1); e += kThreads) {
        red[e] = 0.0;
    }
    if (!fused) {                 // the sums of the earlier launches
        for (int k = threadIdx.x; k <= i; k += kThreads) {
            h1[k] = sums[k];
            h2[k] = sums[m + 1 + k];
        }
    }
    __syncthreads();
    auto mark = [&](int k) {
#if K11_PROBE
        if (pl.trace && threadIdx.x == 0 && b < kTraceBlocks) {
            unsigned long long t;
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
            k11_trace[b][k] = t;
        }
#endif
    };
    mark(0);
    const int nseg = *nsegp;
    const Shape sh = *shp;
    const int R = sh.R, S = pl.stages;
    // the resident share: the whole pool where the block's range fits it,
    // else beside the ring
    P* res = reinterpret_cast<P*>(
        ring + (sh.whole ? 0LL : (long long)pl.stages * pl.stage_bytes));
    const int first = fused ? kPhaseA : phase;
    const int npass = fused ? 3 : (phase == kPhaseD ? 0 : 1);
    auto stage = [&](int slot) {
        return reinterpret_cast<P*>(ring + (long long)slot * pl.stage_bytes);
    };
    // (b) sweeps each vector block twice: w' from its rows, then V[k] . w'
    // from the same rows again (in L2 by then)
    auto sweeps = [&](int p) { return p == kPhaseB && !sh.tile ? 2 : 1; };
    const long long per_sweep = sh.nvb * sh.nc;

    double acc[kRmax];
#pragma unroll
    for (int j = 0; j < kRmax; ++j) {
        acc[j] = 0.0;
    }
    double nrm = 0.0;
    // acc's rows row0 + g + gl j (j < kRmax, below k1), each summed over
    // the 32 / gl lanes that share g, into the warp's slot: a transposing
    // butterfly, each halving step keeping half of a lane's rows and
    // swapping the other half with its partner (8 rows: 4 + 2 + 1
    // exchanges, then the plain butterfly of the one left), the lane that
    // ends holding a row adding it; the order is the same every run
    auto flush = [&](int gl, int row0, int k1) {
        double* rw = red + warp * (m + 1);
        const int g = lane & (gl - 1), t = lane / gl;
        // the rows a lane holds, rounded up to a power of two
        const int nrl = (k1 - row0 + gl - 1) / gl;
        int c = nrl > 4 ? 8 : nrl > 2 ? 4 : nrl > 1 ? 2 : 1;
        int rowoff = 0, off = gl, hd = 0;
#pragma unroll
        for (int half = kRmax / 2; half >= 1; half >>= 1) {
            if (off < 32 && half < c) {          // the same in every lane
                const bool upper = (t >> hd) & 1;
#pragma unroll
                for (int j = 0; j < half; ++j) {
                    const double send = upper ? acc[j] : acc[j + half];
                    const double keep = upper ? acc[j + half] : acc[j];
                    acc[j] = keep + __shfl_xor_sync(0xffffffffu, send, off);
                }
                rowoff += upper ? half : 0;
                off <<= 1;
                ++hd;
                c = half;
            }
        }
        for (; off < 32; off <<= 1) {
#pragma unroll
            for (int j = 0; j < kRmax; ++j) {
                if (j < c) {
                    acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
                }
            }
        }
        if (t < (1 << hd)) {
#pragma unroll
            for (int j = 0; j < kRmax; ++j) {
                const int k = row0 + g + gl * (rowoff + j);
                if (j < c && k < k1) {
                    rw[k] += acc[j];
                }
            }
        }
#pragma unroll
        for (int j = 0; j < kRmax; ++j) {
            acc[j] = 0.0;
        }
    };

    // The resident share, all rows at once: vectors v = vslot, vslot +
    // nslot, ... of its r, G lanes a vector, a lane the rows k = g mod G.
    // (a) the row sums V[k] . w; (b) w' = w - h1 V (in registers) and V[k]
    // . w'; (c) w'' = w - (h1 + h2) V from w as it came in (one rounding
    // where the plain version rounds w' first) into the w row, and
    // |w''|^2
    auto whole = [&](auto pass, P* base, long long rs, long long nv,
                     long long x0, bool resident) {
        constexpr int p = decltype(pass)::value;
        const int G = sh.G, g = lane & (G - 1);
        const int vslot = threadIdx.x / G, nslot = kConsumers / G;
        P* wr = base + R * rs;
        for (long long vb = 0; vb < nv; vb += nslot) {     // warp-uniform
            const long long v = vb + vslot;
            const bool in = v < nv;
            const P wv = in ? wr[v] : zero_pack<T, VEC>();
            double y[VEC];
            if constexpr (p == kPhaseA) {
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    y[q] = (double)wv.v[q];
                }
            } else {
                double a[VEC];
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    a[q] = 0.0;
                }
                for (int rd = 0; rd < sh.rounds; ++rd) {
#pragma unroll
                    for (int j = 0; j < kRmax; ++j) {
                        const int k = rd * kRmax * G + g + G * j;
                        if (in && k < R) {
                            const P x = base[k * rs + v];
                            const double hk =
                                p == kPhaseB ? h1[k] : h1[k] + h2[k];
#pragma unroll
                            for (int q = 0; q < VEC; ++q) {
                                a[q] += hk * (double)x.v[q];
                            }
                        }
                    }
                }
                for (int off = 1; off < G; off <<= 1) {
#pragma unroll
                    for (int q = 0; q < VEC; ++q) {
                        a[q] += __shfl_xor_sync(0xffffffffu, a[q], off);
                    }
                }
                P out;
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    out.v[q] = (T)((double)wv.v[q] - a[q]);
                    y[q] = (double)out.v[q];
                }
                if constexpr (p == kPhaseC) {
                    if (in && g == 0) {
                        if (resident) {
                            wr[v] = out;
                        } else {
                            const Loc at = locate(seg, nseg, x0 + v);
                            reinterpret_cast<P*>(tab.w[at.s])[at.e] = out;
                        }
#pragma unroll
                        for (int q = 0; q < VEC; ++q) {
                            nrm += y[q] * y[q];
                        }
                    }
                }
            }
            if constexpr (p != kPhaseC) {
                for (int rd = 0; rd < sh.rounds; ++rd) {
#pragma unroll
                    for (int j = 0; j < kRmax; ++j) {
                        const int k = rd * kRmax * G + g + G * j;
                        if (in && k < R) {
                            acc[j] += dot(base[k * rs + v], y);
                        }
                    }
                    if (sh.rounds > 1) {
                        flush(G, rd * kRmax * G, R);
                    }
                }
            }
        }
        if (p != kPhaseC && sh.rounds == 1) {
            flush(G, 0, R);
        }
    };

    // A streamed chunk: rows k0..k1-1 of a vector block's nt vectors at d
    // (row stride ts), gs lanes a vector, a lane the rows k0 + g + gs j; wv
    // the block's w (loaded while the block before it streamed).  (a) and (b)'s second sweep
    // add each chunk's row sums into the warps' slots; (b)'s first sweep
    // and (c) carry a (the h V sums) in registers from a block's first
    // chunk to its last, where the gs lanes' sums give w' or w''.
    const int gs = sh.gs > 0 ? sh.gs : 1;
    const int sg = lane & (gs - 1);
    const long long sv = threadIdx.x / gs;       // this lane group's vector
    P wv = zero_pack<T, VEC>(), wp = zero_pack<T, VEC>();
    double a2[VEC];
    auto chunk = [&](auto pass, int sweep, int c, const P* d, long long x0,
                     long long nt) {
        constexpr int p = decltype(pass)::value;
        const int k0 = c * sh.rc;
        const int k1 = k0 + sh.rc < R ? k0 + sh.rc : R;
        const bool in = sv < nt;
        if (p == kPhaseA || (p == kPhaseB && sweep == 1)) {
            const P& x0p = p == kPhaseA ? wv : wp;
            double y[VEC];
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                y[q] = (double)x0p.v[q];
            }
#pragma unroll
            for (int jr = 0; jr < kRmax; ++jr) {
                const int k = k0 + sg + gs * jr;
                if (in && k < k1) {
                    acc[jr] += dot(d[(k - k0) * sh.ts + sv], y);
                }
            }
            flush(gs, k0, k1);
            return;
        }
        if (c == 0) {
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                a2[q] = 0.0;
            }
        }
#pragma unroll
        for (int jr = 0; jr < kRmax; ++jr) {
            const int k = k0 + sg + gs * jr;
            if (in && k < k1) {
                const P x = d[(k - k0) * sh.ts + sv];
                const double hk = p == kPhaseB ? h1[k] : h1[k] + h2[k];
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    a2[q] += hk * (double)x.v[q];
                }
            }
        }
        if (c == sh.nc - 1) {
            for (int off = 1; off < gs; off <<= 1) {
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    a2[q] += __shfl_xor_sync(0xffffffffu, a2[q], off);
                }
            }
            P out;
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                out.v[q] = (T)((double)wv.v[q] - a2[q]);
            }
            if constexpr (p == kPhaseB) {
                wp = out;
            } else {
                if (in && sg == 0) {
                    const Loc at = locate(seg, nseg, x0 + sv);
                    reinterpret_cast<P*>(tab.w[at.s])[at.e] = out;
#pragma unroll
                    for (int q = 0; q < VEC; ++q) {
                        nrm += (double)out.v[q] * (double)out.v[q];
                    }
                }
            }
        }
    };
    auto chunk_of = [&](int p, int sweep, int c, const P* d, long long x0,
                        long long nt) {
        if (p == kPhaseA) {
            chunk(Pass<kPhaseA>{}, sweep, c, d, x0, nt);
        } else if (p == kPhaseB) {
            chunk(Pass<kPhaseB>{}, sweep, c, d, x0, nt);
        } else {
            chunk(Pass<kPhaseC>{}, sweep, c, d, x0, nt);
        }
    };
    auto whole_of = [&](int p, P* base, long long rs, long long nv,
                        long long x0, bool resident) {
        if (p == kPhaseA) {
            whole(Pass<kPhaseA>{}, base, rs, nv, x0, resident);
        } else if (p == kPhaseB) {
            whole(Pass<kPhaseB>{}, base, rs, nv, x0, resident);
        } else {
            whole(Pass<kPhaseC>{}, base, rs, nv, x0, resident);
        }
    };
    // the vector block bb of pass p: its first vector and its count
    auto block_x0 = [&](int p, long long bb) {
        return sh.r + (p == kPhaseB ? sh.nvb - 1 - bb : bb) * sh.vb;
    };

    // The producer issues a slot's next chunk once every warp has released
    // the slot's last: S chunks ahead of its own, into the next pass before
    // the barrier (whose slots every warp frees first).  Its place in the
    // stream: pass, vector block, sweep, chunk.
    long long issued = 0, pbb = 0;
    int ppass = first, psw = 0, pch = 0, pslot = 0;
    unsigned pwrap = 0;
    auto produce = [&](long long hi) {
        for (; issued < hi; ++issued) {
            if (issued >= S) {
                mbar_wait(empty + pslot, pwrap ^ 1u);
            }
            const long long x0 = block_x0(ppass, pbb);
            const int k0 = pch * sh.rc;
            load_chunk<T, VEC>(tab, seg, nseg, cv, x0,
                               cv - x0 < sh.vb ? cv - x0 : sh.vb, k0,
                               (k0 + sh.rc < R ? k0 + sh.rc : R) - k0,
                               sh.tile, R, sh.ts,
                               stage(pslot), full + pslot, lane);
            if (++pslot == S) {
                pslot = 0;
                pwrap ^= 1u;
            }
            if (++pch == sh.nc) {
                pch = 0;
                if (++psw == sweeps(ppass)) {
                    psw = 0;
                    if (++pbb == sh.nvb) {
                        pbb = 0;
                        ++ppass;
                    }
                }
            }
        }
    };

    // the resident share: by bulk copies where its rows are long, else each
    // thread its own rows and (lane g = 0) w
    const bool res_bulk = sh.r * (long long)sizeof(P) >= kBulkMin;
    if (sh.r > 0 && res_bulk) {
        if (producer) {
            load_chunk<T, VEC>(tab, seg, nseg, cv, 0, sh.r, 0, R, true, R,
                               sh.rs, res, resbar, lane);
        }
    } else if (sh.r > 0 && !producer) {
        const int G = sh.G, g = lane & (G - 1);
        for (long long v = threadIdx.x / G; v < sh.r; v += kConsumers / G) {
            const Loc at = locate(seg, nseg, v);
            const T* Vs = static_cast<const T*>(tab.V[at.s]);
            for (int k = g; k < R; k += G) {
                copy_async(res + k * sh.rs + v, reinterpret_cast<const P*>(
                               Vs + k * tab.n[at.s]) + at.e);
            }
            if (g == 0) {
                copy_async(res + R * sh.rs + v,
                           reinterpret_cast<const P*>(tab.w[at.s]) + at.e);
            }
        }
        __pipeline_commit();
    }
    // the passes
    int cslot = 0;
    unsigned cwrap = 0;
    long long cn = 0;                 // the consumers' place in the stream
    double wnorm2 = none || fused ? 0.0 : sums[2 * (m + 1)];
    for (int pi = 0; pi < npass; ++pi) {
        const int p = first + pi;
        const long long pass_end = cn + per_sweep * sweeps(p);
        if (producer) {
            // this pass's chunks, then the next pass's first (their slots
            // are freed before the consumers reach the barrier)
            long long hi = pass_end;
            if (pi + 1 < npass) {
                const long long next = per_sweep * sweeps(p + 1);
                hi += next < S ? next : S;
            }
            produce(hi);
            cn = pass_end;
        } else {
            if (sh.r > 0) {
                if (p == kPhaseA && res_bulk) {
                    mbar_wait(resbar, 0);
                } else if (p == kPhaseA) {
                    __pipeline_wait_prior(0);
                    __syncwarp();
                }
                if (!copies) {
                    whole_of(p, res, sh.rs, sh.r, 0, true);
                }
            }
            // w of a block, read while the block before it streams
            auto w_of = [&](long long bb) {
                const long long x0 = block_x0(p, bb);
                const long long v = x0 + sv;
                if (copies || sv >= (cv - x0 < sh.vb ? cv - x0 : sh.vb)) {
                    return zero_pack<T, VEC>();
                }
                const Loc at = locate(seg, nseg, v);
                return reinterpret_cast<const P*>(tab.w[at.s])[at.e];
            };
            P wnext = sh.nvb > 0 && !sh.tile ? w_of(0) : zero_pack<T, VEC>();
            for (long long bb = 0; bb < sh.nvb && sh.tile; ++bb) {
                // a tile: every row and w in one stage
                const long long x0 = block_x0(p, bb);
                mbar_wait(full + cslot, cwrap);
                if (!copies) {
                    whole_of(p, stage(cslot), sh.ts,
                             cv - x0 < sh.vb ? cv - x0 : sh.vb, x0, false);
                }
                __syncwarp();
                if (lane == 0) {
                    mbar_arrive(empty + cslot);
                }
                if (++cslot == S) {
                    cslot = 0;
                    cwrap ^= 1u;
                }
                ++cn;
            }
            for (long long bb = 0; bb < sh.nvb && !sh.tile; ++bb) {
                const long long x0 = block_x0(p, bb);
                const long long nt = cv - x0 < sh.vb ? cv - x0 : sh.vb;
                wv = wnext;
                if (bb + 1 < sh.nvb) {
                    wnext = w_of(bb + 1);
                }
                for (int sw = 0; sw < sweeps(p); ++sw) {
                    for (int c = 0; c < sh.nc; ++c) {
                        mbar_wait(full + cslot, cwrap);
                        if (!copies) {
                            chunk_of(p, sw, c, stage(cslot), x0, nt);
                        }
                        __syncwarp();
                        if (lane == 0) {
                            mbar_arrive(empty + cslot);
                        }
                        if (++cslot == S) {
                            cslot = 0;
                            cwrap ^= 1u;
                        }
                        ++cn;
                    }
                }
            }
        }
        mark(1 + 2 * pi);
        if (p != kPhaseC) {
            __syncthreads();
            // row k's slots summed by warp k mod kWarps, a lane a slot
            double* out = p == kPhaseA ? pa : pb;
            for (int k = warp; k < R; k += kWarps) {
                double s = 0.0;
                if (lane < kConsumerWarps) {
                    s = red[lane * (m + 1) + k];
                    red[lane * (m + 1) + k] = 0.0;
                }
                s = warp_sum(s);
                if (lane == 0) {
                    out[(long long)k * nb + b] = s;
                }
            }
        } else {
            nrm = warp_sum(nrm);
            if (lane == 0 && !producer) {
                nrms[warp] = nrm;
            }
            __syncthreads();
            if (warp == 0) {
                const double s =
                    warp_sum(lane < kConsumerWarps ? nrms[lane] : 0.0);
                if (lane == 0) {
                    pc[b] = s;
                }
            }
        }
        grid.sync();
        if (p == kPhaseA) {
            grid_rows<kWarps>(pa, nb, R, h1);
        } else if (p == kPhaseB) {
            grid_rows<kWarps>(pb, nb, R, h2);
        } else {          // |w''|^2 from the nb partials, in every warp
            double s = 0.0;
            for (int bb = lane; bb < nb; bb += 32) {
                s += __ldcg(pc + bb);
            }
            wnorm2 = warp_sum(s);
        }
        mark(2 + 2 * pi);
        if (!fused) {
            if (b == 0) {
                for (int k = threadIdx.x; k <= m; k += kThreads) {
                    if (p == kPhaseA) {
                        sums[k] = k < R ? h1[k] : 0.0;
                    } else if (p == kPhaseB) {
                        sums[m + 1 + k] = k < R ? h2[k] : 0.0;
                    } else if (k == 0) {
                        sums[2 * (m + 1)] = wnorm2;
                    }
                }
            }
            return;
        }
    }
    if (none || copies) {
        return;
    }

    // V[i+1] = u = w'' / (|w''| or 1); the resident w'' into w
    const double wnorm = sqrt(wnorm2);
    const double scale = wnorm == 0.0 ? 1.0 : wnorm;
    const P* rw = res + R * sh.rs;
#pragma unroll 4
    for (long long x = threadIdx.x; x < cv; x += kThreads) {
        const Loc at = locate(seg, nseg, x);
        P* wg = reinterpret_cast<P*>(tab.w[at.s]) + at.e;
        const P y = x < sh.r ? rw[x] : *wg;
        P z;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
            z.v[q] = (T)((double)y.v[q] / scale);
        }
        reinterpret_cast<P*>(static_cast<T*>(tab.V[at.s])
                             + (long long)(i + 1) * tab.n[at.s])[at.e] = z;
        reinterpret_cast<P*>(tab.u[at.s])[at.e] = z;
        if (x < sh.r) {
            *wg = y;
        }
    }
    mark(7);
    if (!fused) {
        grid.sync();             // every block has read the header
    }
    if (b == 0) {
        if (pl.givens) {
            givens_epilogue(st, m, i, h1, h2, red, wnorm);
        } else {
            for (int k = threadIdx.x; k <= i + 1; k += kThreads) {
                st[L.col + k] = k <= i ? h1[k] + h2[k] : wnorm;
                if (k <= i) {
                    st[L.h2 + k] = h2[k];
                }
            }
        }
    }
    mark(8);
}

// K11 on one tensor: the table of one shard.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
cgs2_kernel(const __grid_constant__ ShardTable tab, const Plan pl,
            double* st, double* __restrict__ part) {
    cgs2_step<T, VEC>(tab, pl, st, part, nullptr);
}

// K11-S on the shards of one card.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
cgs2_shards_kernel(const __grid_constant__ ShardTable tab, const Plan pl,
                   double* st, double* __restrict__ part,
                   double* __restrict__ sums) {
    cgs2_step<T, VEC>(tab, pl, st, part, sums);
}

// ---- the lean instance: no ring ----

// The lean instance's head, in doubles: h1, h2 (m + 1 each), the warps'
// row sums (kLeanWarps x (m + 1); then the norm sums, and the epilogue's
// rotations), rounded up to 16 bytes (kernels/krylov.py:lean_head_bytes).
__host__ __device__ inline int lean_head(int m) {
    return ((2 + kLeanWarps) * (m + 1) + 1) & ~1;
}

// One block's share of a CGS2 step where its range of the m + 1 rows fits
// its shared memory (the header states the passes).  Block b of nb owns the
// vectors [b chunk, (b + 1) chunk) of the shards' concatenation, cv of
// them.  RES (the fused phase): rows 0..i and w of the range copied into
// shared memory (Vs at row stride chunk, ws) by cp.async, every pass
// reading them there, w' and w'' into ws; else (the split route, one phase
// a launch) V and w read in place, w' and w'' written into w (w' also into
// ws for (b)'s row sums).  A thread a vector forms w' = w - h1 V and w'' =
// w' - h2 V, each rounded to the field's type as the plain version does; a
// warp a row sums V[k] . w, the lanes in vector order.  part and sums as in
// cgs2_step.
template <typename T, int VEC, bool RES>
__device__ __forceinline__ void lean_step(const ShardTable& tab,
                                          const Plan& pl, double* st,
                                          double* __restrict__ part,
                                          double* __restrict__ sums) {
    const int m = pl.m;
    const int i = active_row(st, m);
    if (i < 0) {
        return;
    }
    using P = Pack<T, VEC>;
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) double sm[];
    double* h1 = sm;                                  // [m + 1]
    double* h2 = h1 + (m + 1);                        // [m + 1]
    double* red = h2 + (m + 1);                       // [warps][m + 1]
    P* ws = reinterpret_cast<P*>(sm + lean_head(m));  // [chunk]
    P* Vs = ws + pl.chunk;                            // RES: [i + 1][chunk]
    const Layout L = layout(m);
    const int R = i + 1, nb = gridDim.x, b = blockIdx.x;
    const bool fused = pl.phase == kFused;
    const int phase = pl.phase;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long total = tab.off[tab.shards];
    const long long x0 = (long long)b * pl.chunk;
    const int cv = (int)(total - x0 < pl.chunk ? total - x0 : pl.chunk);
    const int rs = (int)pl.chunk;
    int s0 = 0;                       // the shard of the range's first vector
    while (x0 >= tab.off[s0 + 1]) {
        ++s0;
    }
    // the block's vector v in its shard
    auto at = [&](int v) {
        const long long x = x0 + v;
        int s = s0;
        while (x >= tab.off[s + 1]) {
            ++s;
        }
        return Loc{s, x - tab.off[s]};
    };
    auto vrow = [&](const Loc& a, int k) {
        return reinterpret_cast<P*>(static_cast<T*>(tab.V[a.s])
                                    + (long long)k * tab.n[a.s]) + a.e;
    };
    auto wat = [&](const Loc& a) {
        return reinterpret_cast<P*>(tab.w[a.s]) + a.e;
    };
    double* pa = part;
    double* pb = pa + (long long)(m + 1) * nb;
    double* pc = pb + (long long)(m + 1) * nb;

    // (a): h1's partials
    if (fused || phase == kPhaseA) {
        if constexpr (RES) {
            for (int v = threadIdx.x; v < cv; v += kLeanThreads) {
                copy_async(ws + v, wat(at(v)));
            }
            for (int e = threadIdx.x; e < R * cv; e += kLeanThreads) {
                const int k = e / cv, v = e - k * cv;
                copy_async(Vs + k * rs + v, vrow(at(v), k));
            }
            __pipeline_commit();
            __pipeline_wait_prior(0);
            __syncthreads();
        }
        for (int k = warp; k < R; k += kLeanWarps) {
            double acc = 0.0;
            for (int v = lane; v < cv; v += 32) {
                if constexpr (RES) {
                    acc += dot(Vs[k * rs + v], ws[v]);
                } else {
                    const Loc a = at(v);
                    acc += dot(*vrow(a, k), *wat(a));
                }
            }
            acc = warp_sum(acc);
            if (lane == 0) {
                pa[(long long)k * nb + b] = acc;
            }
        }
        grid.sync();
        grid_rows<kLeanWarps>(pa, nb, R, h1);
        if (!fused) {
            if (b == 0) {
                for (int k = threadIdx.x; k <= m; k += kLeanThreads) {
                    sums[k] = k < R ? h1[k] : 0.0;
                }
            }
            return;
        }
    } else {
        for (int k = threadIdx.x; k < R; k += kLeanThreads) {
            h1[k] = sums[k];
            h2[k] = sums[m + 1 + k];
        }
        __syncthreads();
    }

    // (b): w' = w - h1 V and h2's partials
    if (fused || phase == kPhaseB) {
        for (int v = threadIdx.x; v < cv; v += kLeanThreads) {
            const Loc a = at(v);
            const P x0v = RES ? ws[v] : *wat(a);
            double y[VEC];
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                y[q] = (double)x0v.v[q];
            }
#pragma unroll 4
            for (int k = 0; k < R; ++k) {
                const P x = RES ? Vs[k * rs + v] : *vrow(a, k);
                const double h = h1[k];
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    y[q] -= h * (double)x.v[q];
                }
            }
            P out;
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                out.v[q] = (T)y[q];
            }
            ws[v] = out;
            if (!RES) {
                *wat(a) = out;
            }
        }
        __syncthreads();
        for (int k = warp; k < R; k += kLeanWarps) {
            double acc = 0.0;
            for (int v = lane; v < cv; v += 32) {
                acc += dot(RES ? Vs[k * rs + v] : *vrow(at(v), k), ws[v]);
            }
            acc = warp_sum(acc);
            if (lane == 0) {
                pb[(long long)k * nb + b] = acc;
            }
        }
        grid.sync();
        grid_rows<kLeanWarps>(pb, nb, R, h2);
        if (!fused) {
            if (b == 0) {
                for (int k = threadIdx.x; k <= m; k += kLeanThreads) {
                    sums[m + 1 + k] = k < R ? h2[k] : 0.0;
                }
            }
            return;
        }
    }

    // (c): w'' = w' - h2 V and |w''|^2's partials; then |w''|^2 from the
    // nb partials, the same order in every warp of every block
    double wnorm2;
    if (fused || phase == kPhaseC) {
        double nrm = 0.0;
        for (int v = threadIdx.x; v < cv; v += kLeanThreads) {
            const Loc a = at(v);
            const P x0v = RES ? ws[v] : *wat(a);
            double y[VEC];
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                y[q] = (double)x0v.v[q];
            }
#pragma unroll 4
            for (int k = 0; k < R; ++k) {
                const P x = RES ? Vs[k * rs + v] : *vrow(a, k);
                const double h = h2[k];
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    y[q] -= h * (double)x.v[q];
                }
            }
            P out;
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                out.v[q] = (T)y[q];
                nrm += (double)out.v[q] * (double)out.v[q];
            }
            if (RES) {
                ws[v] = out;
            } else {
                *wat(a) = out;
            }
        }
        nrm = warp_sum(nrm);
        if (lane == 0) {
            red[warp] = nrm;
        }
        __syncthreads();
        if (warp == 0) {
            const double s = warp_sum(lane < kLeanWarps ? red[lane] : 0.0);
            if (lane == 0) {
                pc[b] = s;
            }
        }
        grid.sync();
        double s = 0.0;
        for (int bb = lane; bb < nb; bb += 32) {
            s += __ldcg(pc + bb);
        }
        wnorm2 = warp_sum(s);
        if (!fused) {
            if (b == 0 && threadIdx.x == 0) {
                sums[2 * (m + 1)] = wnorm2;
            }
            return;
        }
    } else {
        wnorm2 = sums[2 * (m + 1)];
    }

    // V[i+1] = u = w'' / (|w''| or 1); the resident w'' into w
    const double wnorm = sqrt(wnorm2);
    const double scale = wnorm == 0.0 ? 1.0 : wnorm;
#pragma unroll 4
    for (int v = threadIdx.x; v < cv; v += kLeanThreads) {
        const Loc a = at(v);
        const P x = RES ? ws[v] : *wat(a);
        P z;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
            z.v[q] = (T)((double)x.v[q] / scale);
        }
        *vrow(a, i + 1) = z;
        reinterpret_cast<P*>(tab.u[a.s])[a.e] = z;
        if (RES) {
            *wat(a) = x;
        }
    }
    if (!fused) {
        grid.sync();             // every block has read the header
    }
    if (b == 0) {
        if (pl.givens) {
            givens_epilogue(st, m, i, h1, h2, red, wnorm);
        } else {
            for (int k = threadIdx.x; k <= i + 1; k += kLeanThreads) {
                st[L.col + k] = k <= i ? h1[k] + h2[k] : wnorm;
                if (k <= i) {
                    st[L.h2 + k] = h2[k];
                }
            }
        }
    }
}

// K11 (the table of one shard) on a plan with no ring.
template <typename T, int VEC>
__global__ void __launch_bounds__(kLeanThreads, 1)
cgs2_lean_kernel(const __grid_constant__ ShardTable tab, const Plan pl,
                 double* st, double* __restrict__ part) {
    lean_step<T, VEC, true>(tab, pl, st, part, nullptr);
}

// K11-S on a plan with no ring: the fused route (RES) or the split one.
template <typename T, int VEC, bool RES>
__global__ void __launch_bounds__(kLeanThreads, 1)
cgs2_shards_lean_kernel(const __grid_constant__ ShardTable tab,
                        const Plan pl, double* st,
                        double* __restrict__ part,
                        double* __restrict__ sums) {
    lean_step<T, VEC, RES>(tab, pl, st, part, sums);
}

// K12's step alone (on no solver path: K11 and K11-S run it as their
// epilogue): the Givens bookkeeping of JAX's body on the state's column,
// one thread.
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
    givens_chain(st, m, i, col, st + L.cs, st + L.sn);
    double* Hc = st + L.H + i * (m + 1);
    for (int r = 0; r <= i + 1; ++r) {
        Hc[r] = col[r];
    }
}

// K12's back-substitution: y[:k] from the leading k x k block of H and
// s[:k] (gmres.cpp:12-24), k = the state's i, y[k:] = 0; one block.  The
// columns of H, diagonal and above, go into shared memory in panels of
// `panel` columns (all of them at restart 80), a warp a column, coalesced,
// every copy in flight at once (cp.async), each diagonal's reciprocal
// beside.  Each panel is then solved in
// diagonal blocks of 32 columns from the last: warp 0 holds the block's
// rows in registers (a lane a row) and runs its chain of dependent steps,
// y[c] = acc[c] / H[c, c] on the lane of row c, broadcast by a shuffle,
// H[r, c] y[c] subtracted on the lanes of rows r < c; then every thread
// subtracts the block's columns from the rows above it that it owns, in
// the same order (c descending).  The quotient is the reciprocal's
// product with one Newton correction (fma): the correctly rounded
// quotient for operands away from overflow and underflow, off the chain's
// longer division.  Every other operation is rounded on its own.
__global__ void __launch_bounds__(kBsThreads)
backsub_kernel(double* st, int m, int panel) {
    extern __shared__ __align__(16) double bs[];
    const Layout L = layout(m);
    const int k = (int)st[kI];
    const double* H = st + L.H;
    const double* s = st + L.s;
    double* y = st + L.y;
    double* acc = bs;                            // [m]
    double* ys = acc + m;                        // [m] y, for the updates
    double* rd = ys + m;                         // [m] 1 / H[c, c]
    double* Hp = rd + m;                         // [panel][m]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int r = threadIdx.x; r < m; r += kBsThreads) {
        if (r < k) {
            acc[r] = s[r];
        } else {
            y[r] = 0.0;
        }
    }
    for (int p1 = k; p1 > 0;) {
        const int p0 = p1 > panel ? p1 - panel : 0;
        __syncthreads();                         // the last panel is done
        for (int c = p0 + warp; c < p1; c += kBsThreads / 32) {
            const double* src = H + (long long)c * (m + 1);
            double* dst = Hp + (c - p0) * m;
            for (int r = lane; r <= c; r += 32) {
                copy_async(dst + r, src + r);    // every load in flight
            }
        }
        __pipeline_commit();
        __pipeline_wait_prior(0);
        __syncthreads();
        for (int c = p0 + threadIdx.x; c < p1; c += kBsThreads) {
            rd[c] = __drcp_rn(Hp[(c - p0) * m + c]);
        }
        __syncthreads();
        for (int c1 = p1; c1 > p0;) {
            const int c0 = c1 - 32 > p0 ? c1 - 32 : p0;
            if (warp == 0) {
                double a = lane < c1 - c0 ? acc[c0 + lane] : 0.0;
                for (int c = c1 - 1; c >= c0; --c) {
                    const int lc = c - c0;
                    const double* hc = Hp + (c - p0) * m;
                    const double h = lane < lc ? hc[c0 + lane] : 0.0;
                    double yc = 0.0;
                    if (lane == lc) {
                        const double q = __dmul_rn(a, rd[c]);
                        yc = __fma_rn(__fma_rn(-q, hc[c], a), rd[c], q);
                        ys[c] = yc;
                        y[c] = yc;
                    }
                    yc = __shfl_sync(0xffffffffu, yc, lc);
                    if (lane < lc) {
                        a = __dsub_rn(a, __dmul_rn(h, yc));
                    }
                }
            }
            __syncthreads();
            for (int r = threadIdx.x; r < c0; r += kBsThreads) {
                double a = acc[r];
                for (int c = c1 - 1; c >= c0; --c) {
                    a = __dsub_rn(a, __dmul_rn(Hp[(c - p0) * m + r], ys[c]));
                }
                acc[r] = a;
            }
            __syncthreads();
            c1 = c0;
        }
        p1 = p0;
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

// A cooperative launch of `kern` on `blocks` blocks of `threads` with
// `smem` bytes of dynamic shared memory, after the checks that the card
// takes it and holds the grid at once.
template <typename K>
int coop_launch(K kern, int blocks, int threads, int smem, void** args,
                cudaStream_t st) {
    int dev = 0, coop = 0, occ = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    }
    if (err == cudaSuccess && !coop) {
        err = cudaErrorNotSupported;
    }
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                            threads, smem);
    }
    if (err != cudaSuccess) {
        return (int)err;
    }
    // a cooperative grid must fit the card at once
    if ((long long)occ * sm_count() < blocks) {
        return (int)cudaErrorCooperativeLaunchTooLarge;
    }
    err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                      dim3(threads), args, smem, st);
    if (err != cudaSuccess) {
        return (int)err;
    }
    return (int)cudaGetLastError();
}

// The table (per shard its V, w and u pointers and n, as long longs) and
// the plan checked again: VEC-value packs only where every shard's rows
// and pointers take them; the blocks cover the shards' vectors, the last
// block not empty; no ring: the lean instance, a block's m rows and w in
// its shared memory on the fused route, no measurement phase; a ring:
// every stage holding a chunk at the last step, the resident share on the
// fused route only; the shared memory the plan's.
int make_table(const long long* table, int shards, int vec, ShardTable* tab) {
    if (shards < 1 || shards > kMaxShards || vec < 1) {
        return (int)cudaErrorInvalidValue;
    }
    *tab = ShardTable{};
    tab->shards = shards;
    for (int s = 0; s < shards; ++s) {
        const long long* t = table + 4 * s;
        const bool aligned = ((t[0] | t[1] | t[2]) & 15) == 0;
        if (t[3] <= 0 || (vec != 1 && (t[3] % vec || !aligned))) {
            return (int)cudaErrorInvalidValue;
        }
        tab->V[s] = reinterpret_cast<void*>(t[0]);
        tab->w[s] = reinterpret_cast<void*>(t[1]);
        tab->u[s] = reinterpret_cast<void*>(t[2]);
        tab->n[s] = t[3];
        tab->off[s + 1] = tab->off[s] + t[3] / vec;
    }
    return 0;
}

bool plan_ok(const ShardTable& tab, int pack, int blocks, const Plan& pl,
             long long part_len, int smem) {
    const long long total = tab.off[tab.shards];
    const int m = pl.m;
    const bool fused = pl.phase >= kFused;
    if (m < 1 || blocks < 1 || pl.chunk < 1 || pl.phase < kPhaseA
        || pl.phase > (K11_PROBE ? kStream : kEmpty)
        || (pl.givens != 0 && pl.givens != 1)
        || (long long)blocks * pl.chunk < total
        || (long long)(blocks - 1) * pl.chunk >= total
        || pl.stages < 0 || pl.stages > kMaxStages || pl.stage_bytes < 0
        || pl.chunk >= (1LL << 31)
        || pl.stage_bytes % 16 || pl.res_bytes < 0 || pl.res_bytes % 16
        || (!fused && pl.res_bytes)
        || part_len < (2LL * (m + 1) + 1) * blocks
        || (size_t)smem > aniso::kSmemBlock) {
        return false;
    }
    if (pl.stages == 0) {
        return pl.phase <= kFused && pl.stage_bytes == 0 && pl.res_bytes == 0
            && 8LL * lean_head(m)
                   + (pl.phase == kFused ? m + 1LL : 1LL) * pl.chunk * pack
               <= smem;
    }
    return 8LL * k11_head(m) + (long long)pl.stages * pl.stage_bytes
               + pl.res_bytes <= smem
        && shape_of(m - 1, pl.chunk, pack, pl.stages, pl.stage_bytes, 0, 0,
                    false).rc >= 1;
}

template <typename T, int VEC>
int cgs2_launch(const ShardTable& tab, const Plan& pl, int blocks, double* st,
                double* part, double* sums, bool shards, int smem,
                cudaStream_t s) {
    // (K11's kernels take the first four)
    void* args[] = {const_cast<ShardTable*>(&tab), const_cast<Plan*>(&pl),
                    &st, &part, &sums};
    if (pl.stages == 0 && !shards) {
        return coop_launch(cgs2_lean_kernel<T, VEC>, blocks, kLeanThreads,
                           smem, args, s);
    }
    if (pl.stages == 0) {
        return pl.phase == kFused
            ? coop_launch(cgs2_shards_lean_kernel<T, VEC, true>, blocks,
                          kLeanThreads, smem, args, s)
            : coop_launch(cgs2_shards_lean_kernel<T, VEC, false>, blocks,
                          kLeanThreads, smem, args, s);
    }
    if (shards) {
        return coop_launch(cgs2_shards_kernel<T, VEC>, blocks, kThreads,
                           smem, args, s);
    }
    return coop_launch(cgs2_kernel<T, VEC>, blocks, kThreads, smem, args, s);
}

// K11 (shards false: one shard, the fused phase) or K11-S: the plan's
// numbers checked again, then the instance of its vector width.
template <typename T>
int cgs2(const long long* table, int shards, bool as_shards, void* state,
         void* part, long long part_len, void* sums, int m, int blocks,
         long long chunk, int stages, int stage_bytes, int res_bytes,
         int vec, int givens, int phase, int smem, void* stream) {
    constexpr int kVec = 16 / sizeof(T);
    if (vec != 1 && vec != kVec) {
        return (int)cudaErrorInvalidValue;
    }
    ShardTable tab;
    const int rc = make_table(table, shards, vec, &tab);
    if (rc) {
        return rc;
    }
#if K11_PROBE
    const int trace = (phase & kTrace) ? 1 : 0;
    phase &= ~kTrace;
#else
    const int trace = 0;
#endif
    const Plan pl = {chunk, m, stages, stage_bytes, res_bytes,
                     stages ? smem - 8 * k11_head(m) : 0, givens, phase,
                     trace};
    if (!plan_ok(tab, vec * (int)sizeof(T), blocks, pl, part_len, smem)
        || (phase < kFused && sums == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    double* sd = static_cast<double*>(state);
    double* pd = static_cast<double*>(part);
    double* hd = static_cast<double*>(sums);
    const cudaStream_t st = (cudaStream_t)stream;
    return vec == 1
        ? cgs2_launch<T, 1>(tab, pl, blocks, sd, pd, hd, as_shards, smem, st)
        : cgs2_launch<T, kVec>(tab, pl, blocks, sd, pd, hd, as_shards, smem,
                               st);
}

}  // namespace

// K11: V (m + 1, n), w (n), u (n) in the field's type; state (layout(m).len)
// float64; part: at least part_len = (2 (m + 1) + 1) blocks float64 of
// scratch; blocks, chunk (in vectors of vec values), stages, stage_bytes,
// res_bytes, vec and smem from kernels/krylov.py:k11_plan, checked again
// here; givens 1: K12's Givens step as the epilogue (the one-device step,
// every solver path's), 0: the column alone, for measurement only (K11's
// cost apart from the epilogue; no solver path launches it).
extern "C" int aniso_cgs2_f32(void* V, void* w, void* u, void* state,
                              void* part, long long part_len, long long n,
                              int m, int blocks, long long chunk, int stages,
                              int stage_bytes, int res_bytes, int vec,
                              int givens, int smem, void* stream) {
    const long long table[4] = {(long long)V, (long long)w, (long long)u, n};
    return cgs2<float>(table, 1, false, state, part, part_len, nullptr, m,
                       blocks, chunk, stages, stage_bytes, res_bytes, vec,
                       givens, kFused, smem, stream);
}

extern "C" int aniso_cgs2_f64(void* V, void* w, void* u, void* state,
                              void* part, long long part_len, long long n,
                              int m, int blocks, long long chunk, int stages,
                              int stage_bytes, int res_bytes, int vec,
                              int givens, int smem, void* stream) {
    const long long table[4] = {(long long)V, (long long)w, (long long)u, n};
    return cgs2<double>(table, 1, false, state, part, part_len, nullptr, m,
                        blocks, chunk, stages, stage_bytes, res_bytes, vec,
                        givens, kFused, smem, stream);
}

// K11-S: one step's CGS2 on the shards of one card, `shards` of them
// (<= 16); table: per shard its V (m + 1, n), w (n) and u (n) pointers and
// n, as long longs; state (layout(m).len) float64; part: at least part_len
// = (2 (m + 1) + 1) blocks float64 of scratch; sums: 2 (m + 1) + 1
// float64 (the split route's; null on the fused one); blocks, chunk,
// stages, stage_bytes, res_bytes, vec and smem from
// kernels/krylov.py:k11_plan; phase 4: the fused route, the whole step and
// K12's Givens step (givens 1) in one launch; 0-3: one phase of the split
// route, the caller summing `sums` over cards and processes between them,
// givens 1 on the card that holds the state (the others pass a copy of its
// header and 0); 5: the empty step (measurement only, a plan with a ring:
// the fused launch's grid, barriers and sums with no vector; it writes no
// state); in a K11_PROBE build also 6: the copies alone (the resident share
// and every pass's chunks brought in and released, no arithmetic, no
// write), and the bit 16: a traced launch.
extern "C" int aniso_cgs2_shards_f32(const long long* table, int shards,
                                     void* state, void* part,
                                     long long part_len, void* sums, int m,
                                     int blocks, long long chunk, int stages,
                                     int stage_bytes, int res_bytes, int vec,
                                     int givens, int phase, int smem,
                                     void* stream) {
    return cgs2<float>(table, shards, true, state, part, part_len, sums, m,
                       blocks, chunk, stages, stage_bytes, res_bytes, vec,
                       givens, phase, smem, stream);
}

extern "C" int aniso_cgs2_shards_f64(const long long* table, int shards,
                                     void* state, void* part,
                                     long long part_len, void* sums, int m,
                                     int blocks, long long chunk, int stages,
                                     int stage_bytes, int res_bytes, int vec,
                                     int givens, int phase, int smem,
                                     void* stream) {
    return cgs2<double>(table, shards, true, state, part, part_len, sums, m,
                        blocks, chunk, stages, stage_bytes, res_bytes, vec,
                        givens, phase, smem, stream);
}

// K12: the Givens step of an active step (a no-op otherwise), on its own
// (no solver path's: it times the step apart from K11).
extern "C" int aniso_givens_step(void* state, int m, void* stream) {
    givens_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        static_cast<double*>(state), m);
    return (int)cudaGetLastError();
}

// K12's back-substitution at the end of a cycle: panels of as many
// columns as fit a block's shared memory beside acc, y and the
// reciprocals.
extern "C" int aniso_givens_backsub(void* state, int m, void* stream) {
    const long long fit = ((long long)aniso::kSmemBlock / 8 - 3LL * m) / m;
    if (m < 1 || fit < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const int panel = fit < m ? (int)fit : m;
    const int smem = 8 * (3 * m + panel * m);
    cudaError_t err = cudaFuncSetAttribute(
        backsub_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
        return (int)err;
    }
    backsub_kernel<<<1, kBsThreads, smem, (cudaStream_t)stream>>>(
        static_cast<double*>(state), m, panel);
    return (int)cudaGetLastError();
}

#if K11_PROBE
// A traced launch's stamps (kTraceBlocks x kTraceMarks, nanoseconds of
// the global timer), copied to the host.
extern "C" int aniso_k11_trace(unsigned long long* out) {
    return (int)cudaMemcpyFromSymbol(out, k11_trace, sizeof(k11_trace));
}
#endif

// shape_of on the host, for the tests that hold kernels/krylov.py's
// step_shape against it: out[0..12] = R, G, rounds, r, rs, vb, gs, rc, nc,
// ts, nvb, tile, whole (StepShape's order).
extern "C" int aniso_k11_shape(int i, long long cv, int pack, int stages,
                               int stage_bytes, int res_bytes, int pool,
                               int resident, long long* out) {
    const Shape s = shape_of(i, cv, pack, stages, stage_bytes, res_bytes,
                             pool, resident != 0);
    const long long v[13] = {s.R, s.G, s.rounds, s.r, s.rs, s.vb, s.gs,
                             s.rc, s.nc, s.ts, s.nvb, s.tile, s.whole};
    for (int k = 0; k < 13; ++k) {
        out[k] = v[k];
    }
    return 0;
}

// The launch floor K12 is held against: an empty one-block launch.
extern "C" int aniso_krylov_floor(void* stream) {
    floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// The state's length in float64 for restart m (kernels/krylov.py checks its
// own layout against it).
extern "C" int aniso_krylov_state_len(int m) { return layout(m).len; }
