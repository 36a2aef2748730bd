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
// the shards' n_k summed.  K12 moves a few KB of
// state: its floor is one launch's latency, which floor_kernel measures
// alone; the back-substitution's is its chain of i dependent steps.
//
// Design.  K11 is one cooperative launch a step (cgs2_kernel, on the
// caller's stream, captured in the step's graph as K9 is), a grid the card
// holds at once, a block of 512 threads on each SM or fewer for a short n;
// block b owns the contiguous chunk [b chunk, (b + 1) chunk) of every row.
// Three phases, separated by grid barriers:
//   (a) h1 = V[:i+1] w: each block writes one partial a row;
//   (b) every block sums the partials of each row in the same order
//       (h1), w' = w - h1 V, and h2's partials, V w';
//   (c) h2 likewise, w'' = w' - h2 V and |w''|^2's partials; after the last
//       barrier every block sums the norm's partials in the same order,
//       writes V[i+1] = u = w'' / (|w''| or 1) and w'' into w, and block 0
//       the column col = h1 + h2, col[i+1] = |w''|, and h2 into the state.
//       On one device (givens = 1) block 0 then runs K12's Givens step as
//       the kernel's epilogue: the column, cs, sn and s staged in shared
//       memory in parallel, the chain of rotations on one thread out of
//       shared memory, the rotated column into col and H[:, i] in
//       parallel.  No block reads the header after the first barrier, so
//       block 0's writes of i, j and done race with nothing.
// K11-S is the same block code (cgs2_step) over a table of up to 16 shards
// of one card, passed by value in the kernel's parameters (ShardTable, as
// K10's table): `per` blocks a shard, block b on shard b / per, so that the
// partials of all blocks, summed in block order, are summed in (shard,
// chunk) order, with float64 sums: the result does not depend on the run.
// Fused route (every local shard on one card, no process group): one
// cooperative launch a step, K12's Givens step its epilogue, as K11's on
// one device.  Split route (a process group, or shards on more than one
// card): the step in four launches a card, (a), (b), (c) each ending with
// block 0 writing its sum over the card's shards into `sums`, which the
// caller sums over cards and processes (one all_reduce each) before the
// next launch reads it; the fourth normalises, and block 0 of the card that
// holds the state writes the column and runs the Givens step after a grid
// barrier.  The split route always streams V (nothing stays in shared
// memory between launches), w carrying w' and w'' from one launch to the
// next.
// Where the block's chunk of the m rows of V and of w fits its shared
// memory (kernels/krylov.py:cgs2_plan; bench's 64^2 field in float32 and
// float64), (a) copies it there (cp.async, every copy in flight at once)
// and (a), (b), (c) run from shared memory: V is read once.  Otherwise
// (512^2) V is read three times with 16-byte loads: (a) 8 rows at a time in
// registers; (b) a tile of 128, 256 or 512 vectors at a time (the widest
// whose rows fit the row buffer), its rows split over 4, 2 or 1 groups of
// threads and kept in shared memory, w' from the groups' sums, then a warp
// a row for h2's partials; (c) a thread's elements row by row.  The partials are laid out
// a row at a time, so that a warp reads a row's contiguously, every load of
// a batch of rows in flight together.  Every sum is float64 in a fixed order and no value
// is added atomically, so a replay repeats bitwise.  An inactive step
// returns in every block before the first barrier: every block reads the
// same header.  K12's step alone (givens_kernel; since K11-S no solver
// path launches it: it times the Givens step apart) is one thread of one
// block: its work is O(i) dependent operations.  The back-substitution (backsub_kernel) is one
// block: H's upper triangle copied into shared memory with coalesced
// loads, then diagonal blocks of 32 columns solved on one warp with the
// rows in registers, i dependent steps (a quotient, a shuffle, a
// multiply-subtract), the rows above each block updated by every thread.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_limits.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;        // K11's block (kernels/krylov.py THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;             // rows (a) holds in registers, streamed
constexpr int kTile = 128;           // narrowest streamed (b) tile (TILE)
constexpr int kBsThreads = 256;      // the back-substitution's block
constexpr int kMaxShards = 16;       // K11-S's shards a launch (MAX_SHARDS)

// K11's phases: all in one launch (K11, K11-S's fused route) or one a
// launch (K11-S's split route)
enum { kPhaseA = 0, kPhaseB = 1, kPhaseC = 2, kPhaseD = 3, kFused = 4 };

// K11-S's shards of one card, a kernel parameter (__grid_constant__, as
// K10's table): shard s's basis part V (m + 1, n), its matvec output w and
// its input buffer u, each n values.
struct ShardTable {
    void* V[kMaxShards];
    void* w[kMaxShards];
    void* u[kMaxShards];
    long long n[kMaxShards];
};

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

// The head of K11's shared memory, in doubles: h1, h2 (m + 1 each) and the
// warps' row sums (kWarps x max(m + 1, kRows)), rounded up to 16 bytes
// (kernels/krylov.py:cgs2_plan agrees).
__host__ __device__ inline int cgs2_head(int m) {
    return (2 * (m + 1) + kWarps * (m + 1 > kRows ? m + 1 : kRows) + 1) & ~1;
}

// h[k] = sum over b < nb of part[k nb + b], k < rows, in the same order in
// every block: a warp a row (kJ rows a warp at once), a lane the partials
// b = lane, lane + 32, ... in that order, then the butterfly; every load of
// a batch in flight together (read from L2: other blocks wrote them).
__device__ void grid_rows(const double* part, int nb, int rows, double* h) {
    constexpr int kJ = 6, kQ = 8;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k0 = warp; k0 < rows; k0 += kWarps * kJ) {
        double acc[kJ];
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
            acc[j] = 0.0;
        }
        for (int b0 = lane; b0 < nb; b0 += 32 * kQ) {
#pragma unroll
            for (int j = 0; j < kJ; ++j) {
                const int k = k0 + j * kWarps;
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
            if (lane == 0 && k0 + j * kWarps < rows) {
                h[k0 + j * kWarps] = s;
            }
        }
    }
    __syncthreads();
}

// One VEC-value copy from global into shared memory in flight (cp.async).
template <typename P>
__device__ __forceinline__ void copy_async(P* dst, const P* src) {
    __pipeline_memcpy_async(dst, src, sizeof(P));
}

// Pass (b) of the streamed branch: tiles of TW = kThreads / G vectors;
// thread (g, l) takes the rows k = g mod G of the tile's vector l, keeping
// the first `kept` rows in shared memory (buf: the row buffer of cap
// packs, then the tile's w', then the groups' sums); w' from the groups'
// sums of h1[k] V[k] in a fixed order; then a warp a row sums V[k] w' over
// the tile into red[k] (rows past the buffer read again); h2's partials of
// this block into pb.
template <typename T, int VEC, int G>
__device__ void streamed_b(const Pack<T, VEC>* Vb, Pack<T, VEC>* wb,
                           const double* h1, double* red,
                           Pack<T, VEC>* buf, double* pb, int cv,
                           long long nv, int rows, int nb, int cap) {
    using P = Pack<T, VEC>;
    constexpr int TW = kThreads / G;
    const int kept = rows < cap / TW ? rows : cap / TW;
    P* rowbuf = buf;                             // [kept][TW]
    P* wt = buf + cap;                           // [TW] w' of the tile
    double* wpart = reinterpret_cast<double*>(wt + kThreads);
    const int g = threadIdx.x / TW, l = threadIdx.x % TW;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = threadIdx.x; k < rows; k += kThreads) {
        red[k] = 0.0;
    }
    for (int t0 = 0; t0 < cv; t0 += TW) {
        const int v = t0 + l;
        const bool in = v < cv;
        const P wv = in && g == 0 ? wb[v] : zero_pack<T, VEC>();
        double a[VEC];
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
            a[q] = 0.0;
        }
#pragma unroll 8
        for (int k = g; k < rows; k += G) {
            const P x = in ? Vb[k * nv + v] : zero_pack<T, VEC>();
            if (k < kept) {
                rowbuf[k * TW + l] = x;
            }
            const double h = h1[k];
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                a[q] += h * (double)x.v[q];
            }
        }
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
            wpart[(g * TW + l) * VEC + q] = a[q];
        }
        __syncthreads();
        if (g == 0) {
            P y;
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                double s = 0.0;
#pragma unroll
                for (int gg = 0; gg < G; ++gg) {
                    s += wpart[(gg * TW + l) * VEC + q];
                }
                y.v[q] = (T)((double)wv.v[q] - s);
            }
            wt[l] = y;
            if (in) {
                wb[v] = y;
            }
        }
        __syncthreads();
        for (int k = warp; k < rows; k += kWarps) {
            double p = 0.0;
#pragma unroll
            for (int ll = lane; ll < TW; ll += 32) {
                if (t0 + ll < cv) {
                    const P x = k < kept ? rowbuf[k * TW + ll]
                                         : Vb[k * nv + t0 + ll];
                    p += dot(x, wt[ll]);
                }
            }
            p = warp_sum(p);
            if (lane == 0) {
                red[k] += p;
            }
        }
        __syncthreads();
    }
    for (int k = threadIdx.x; k < rows; k += kThreads) {
        pb[(long long)k * nb + blockIdx.x] = red[k];
    }
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
    for (int k = threadIdx.x; k <= i + 1; k += kThreads) {
        if (k <= i) {
            const double h = h2[k];
            col[k] = h1[k] + h;
            st[L.h2 + k] = h;
        } else {
            col[k] = wnorm;
        }
    }
    for (int k = threadIdx.x; k < i; k += kThreads) {
        csr[k] = st[L.cs + k];
        snr[k] = st[L.sn + k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        givens_chain(st, m, i, col, csr, snr);
    }
    __syncthreads();
    double* Hc = st + L.H + (long long)i * (m + 1);
    for (int k = threadIdx.x; k <= i + 1; k += kThreads) {
        st[L.col + k] = col[k];
        Hc[k] = col[k];
    }
}

// One block's share of a CGS2 step (the header states the phases): the
// chunk [c0, c0 + chunk) of the rows of V (m + 1, n), of w and of u; nb =
// gridDim.x blocks in all, this one b, whose partials are summed in block
// order.  part: (a)'s and (b)'s partials, (m + 1) nb each as [row][block],
// then (c)'s, nb.  RES: the chunk of V's rows and of w held in shared
// memory from (a) on (the fused phase only); otherwise `stash` rows of a
// tile of (b).  phase kFused: (a), (b), (c) and the epilogue in one launch.
// kPhaseA, kPhaseB, kPhaseC, kPhaseD (K11-S's split route, one launch
// each): (a), (b) and (c) each stop after their sum, block 0 writing it
// into `sums` (h1, h2: m + 1 each, then |w''|^2), which the caller sums
// over the launches of its other cards and processes before the next
// phase reads it there; kPhaseD normalises and, after a grid barrier (no
// block reads the header after it), block 0 writes the column and runs the
// Givens step.
template <typename T, int VEC, bool RES>
__device__ __forceinline__ void cgs2_step(T* __restrict__ V,
                                          T* __restrict__ w,
                                          T* __restrict__ u, long long n,
                                          long long c0, int b, double* st,
                                          double* __restrict__ part,
                                          double* __restrict__ sums, int m,
                                          long long chunk, int stash,
                                          int givens, int phase) {
    const int i = active_row(st, m);
    if (i < 0) {
        return;
    }
    using P = Pack<T, VEC>;
    cg::grid_group grid = cg::this_grid();
    extern __shared__ __align__(16) double sm[];
    double* h1 = sm;                            // [m + 1]
    double* h2 = h1 + (m + 1);                  // [m + 1]
    double* red = h2 + (m + 1);                 // [kWarps][m + 1 or kRows]
    P* buf = reinterpret_cast<P*>(sm + cgs2_head(m));
    const Layout L = layout(m);
    const int rows = i + 1;
    const int nb = gridDim.x;
    const bool fused = phase == kFused;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int cv = (int)((c0 < n ? (n - c0 < chunk ? n - c0 : chunk) : 0)
                         / VEC);               // vectors of this block
    const long long cvmax = chunk / VEC;
    const long long nv = n / VEC;               // a row, in vectors
    const P* Vb = reinterpret_cast<const P*>(V + c0);
    P* wb = reinterpret_cast<P*>(w + c0);
    double* pa = part;
    double* pb = pa + (long long)(m + 1) * nb;
    double* pc = pb + (long long)(m + 1) * nb;
    double* sh1 = sums;                         // split: h1, h2, |w''|^2
    double* sh2 = sums + (m + 1);
    double* snrm = sums + 2 * (m + 1);
    P* ws = buf;                                // RES: [cvmax] w, w', w''
    P* Vs = buf + cvmax;                        // RES: [m][cvmax]

    // (a): h1's partials
    if (fused || phase == kPhaseA) {
        if constexpr (RES) {
            for (int v = threadIdx.x; v < cv; v += kThreads) {
                copy_async(ws + v, wb + v);
            }
            for (int e = threadIdx.x; e < rows * cv; e += kThreads) {
                const int k = e / cv, v = e % cv;
                copy_async(Vs + k * cvmax + v, Vb + k * nv + v);
            }
            __pipeline_commit();
            __pipeline_wait_prior(0);
            __syncthreads();
            for (int k = warp; k < rows; k += kWarps) {
                double acc = 0.0;
                for (int v = lane; v < cv; v += 32) {
                    acc += dot(Vs[k * cvmax + v], ws[v]);
                }
                acc = warp_sum(acc);
                if (lane == 0) {
                    pa[(long long)k * nb + b] = acc;
                }
            }
        } else {
            for (int k0 = 0; k0 < rows; k0 += kRows) {
                double acc[kRows];
#pragma unroll
                for (int r = 0; r < kRows; ++r) {
                    acc[r] = 0.0;
                }
#pragma unroll 2
                for (int v = threadIdx.x; v < cv; v += kThreads) {
                    const P wv = wb[v];
#pragma unroll
                    for (int r = 0; r < kRows; ++r) {
                        if (k0 + r < rows) {
                            acc[r] += dot(Vb[(k0 + r) * nv + v], wv);
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
                        red[warp * kRows + r] = acc[r];
                    }
                }
                __syncthreads();
                if (threadIdx.x < kRows && k0 + (int)threadIdx.x < rows) {
                    double s = 0.0;
                    for (int wp = 0; wp < kWarps; ++wp) {
                        s += red[wp * kRows + threadIdx.x];
                    }
                    pa[(long long)(k0 + threadIdx.x) * nb + b] = s;
                }
                __syncthreads();
            }
        }
        grid.sync();
        grid_rows(pa, nb, rows, h1);
        if (!fused) {
            if (b == 0) {
                for (int k = threadIdx.x; k <= m; k += kThreads) {
                    sh1[k] = k < rows ? h1[k] : 0.0;
                }
            }
            return;
        }
    } else {
        for (int k = threadIdx.x; k < rows; k += kThreads) {
            h1[k] = sh1[k];
        }
        __syncthreads();
    }

    // (b): w' = w - h1 V and h2's partials
    if (fused || phase == kPhaseB) {
        if constexpr (RES) {
            for (int v = threadIdx.x; v < cv; v += kThreads) {
                double a[VEC];
                const P x0 = ws[v];
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    a[q] = (double)x0.v[q];
                }
#pragma unroll 4
                for (int k = 0; k < rows; ++k) {
                    const P x = Vs[k * cvmax + v];
                    const double h = h1[k];
#pragma unroll
                    for (int q = 0; q < VEC; ++q) {
                        a[q] -= h * (double)x.v[q];
                    }
                }
                P y;
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    y.v[q] = (T)a[q];
                }
                ws[v] = y;
            }
            __syncthreads();
            for (int k = warp; k < rows; k += kWarps) {
                double acc = 0.0;
                for (int v = lane; v < cv; v += 32) {
                    acc += dot(Vs[k * cvmax + v], ws[v]);
                }
                acc = warp_sum(acc);
                if (lane == 0) {
                    pb[(long long)k * nb + b] = acc;
                }
            }
        } else {
            // tiles of kThreads / G vectors, G = 1, 2 or 4 groups of threads
            // (the widest tile whose rows all fit the row buffer)
            const int cap = stash * kTile;
            if (rows * kThreads <= cap) {
                streamed_b<T, VEC, 1>(Vb, wb, h1, red, buf, pb, cv, nv, rows,
                                      nb, cap);
            } else if (rows * (kThreads / 2) <= cap) {
                streamed_b<T, VEC, 2>(Vb, wb, h1, red, buf, pb, cv, nv, rows,
                                      nb, cap);
            } else {
                streamed_b<T, VEC, 4>(Vb, wb, h1, red, buf, pb, cv, nv, rows,
                                      nb, cap);
            }
        }
        grid.sync();
        grid_rows(pb, nb, rows, h2);
        if (!fused) {
            if (b == 0) {
                for (int k = threadIdx.x; k <= m; k += kThreads) {
                    sh2[k] = k < rows ? h2[k] : 0.0;
                }
            }
            return;
        }
    } else {
        for (int k = threadIdx.x; k < rows; k += kThreads) {
            h2[k] = sh2[k];
        }
        __syncthreads();
    }

    // (c): w'' = w' - h2 V and |w''|^2's partials; then |w''| from the nb
    // partials, the same order in every warp of every block
    double wnorm;
    if (fused || phase == kPhaseC) {
        double nrm = 0.0;
#pragma unroll 2
        for (int v = threadIdx.x; v < cv; v += kThreads) {
            double a[VEC];
            {
                const P x0 = RES ? ws[v] : wb[v];
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    a[q] = (double)x0.v[q];
                }
            }
#pragma unroll 4
            for (int k = 0; k < rows; ++k) {
                const P x = RES ? Vs[k * cvmax + v] : Vb[k * nv + v];
                const double h = h2[k];
#pragma unroll
                for (int q = 0; q < VEC; ++q) {
                    a[q] -= h * (double)x.v[q];
                }
            }
            P y;
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
                y.v[q] = (T)a[q];
                nrm += (double)y.v[q] * (double)y.v[q];
            }
            if (RES) {
                ws[v] = y;
            } else {
                wb[v] = y;
            }
        }
        nrm = warp_sum(nrm);
        if (lane == 0) {
            red[warp] = nrm;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            double s = 0.0;
            for (int wp = 0; wp < kWarps; ++wp) {
                s += red[wp];
            }
            pc[b] = s;
        }
        grid.sync();
        double s = 0.0;
        for (int bb = lane; bb < nb; bb += 32) {
            s += __ldcg(pc + bb);
        }
        s = warp_sum(s);
        if (!fused) {
            if (b == 0 && threadIdx.x == 0) {
                *snrm = s;
            }
            return;
        }
        wnorm = sqrt(s);
    } else {
        wnorm = sqrt(*snrm);
    }

    // V[i+1] = u = w'' / (|w''| or 1)
    const double scale = wnorm == 0.0 ? 1.0 : wnorm;
    P* Vn = reinterpret_cast<P*>(V + (long long)(i + 1) * n + c0);
    P* ub = reinterpret_cast<P*>(u + c0);
#pragma unroll 4
    for (int v = threadIdx.x; v < cv; v += kThreads) {
        const P x = RES ? ws[v] : wb[v];
        P y;
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
            y.v[q] = (T)((double)x.v[q] / scale);
        }
        Vn[v] = y;
        ub[v] = y;
        if (RES) {
            wb[v] = x;
        }
    }
    if (!fused) {
        grid.sync();             // every block has read the header
    }
    if (b == 0) {
        if (givens) {
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
}

// K11 on one tensor: block b owns [b chunk, (b + 1) chunk) of every row.
template <typename T, int VEC, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
cgs2_kernel(T* __restrict__ V, T* __restrict__ w, T* __restrict__ u,
            double* st, double* __restrict__ part, long long n, int m,
            long long chunk, int stash, int givens) {
    cgs2_step<T, VEC, RES>(V, w, u, n, (long long)blockIdx.x * chunk,
                           blockIdx.x, st, part, nullptr, m, chunk, stash,
                           givens, kFused);
}

// K11-S on the shards of one card: `per` blocks a shard, block b on shard
// b / per, its chunk (b mod per) of that shard's rows; the partials of all
// the card's blocks summed in block order, so in (shard, chunk) order.
template <typename T, int VEC, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
cgs2_shards_kernel(const __grid_constant__ ShardTable tab, int per,
                   double* st, double* __restrict__ part,
                   double* __restrict__ sums, int m, long long chunk,
                   int stash, int givens, int phase) {
    const int s = blockIdx.x / per;
    cgs2_step<T, VEC, RES>(static_cast<T*>(tab.V[s]),
                           static_cast<T*>(tab.w[s]),
                           static_cast<T*>(tab.u[s]), tab.n[s],
                           (long long)(blockIdx.x % per) * chunk, blockIdx.x,
                           st, part, sums, m, chunk, stash, givens, phase);
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

// The shared memory a plan needs: the head, then the chunk of m rows of V
// and of w (resident) or `stash` rows of a (b) tile, its w' and the
// groups' sums (cgs2_plan agrees).
long long cgs2_smem(int m, long long chunk, int vec, int item, int resident,
                    int stash) {
    const long long pack = (long long)vec * item;
    const long long head = 8LL * cgs2_head(m);
    return resident ? head + (m + 1) * (chunk / vec) * pack
                    : head + (long long)stash * kTile * pack
                          + kThreads * (pack + 8LL * vec);
}

// A cooperative launch of `kern` on `blocks` blocks of kThreads with
// `smem` bytes of dynamic shared memory, after the checks that the card
// takes it and holds the grid at once.
template <typename K>
int coop_launch(K kern, int blocks, int smem, void** args, cudaStream_t st) {
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
                                                            kThreads, smem);
    }
    if (err != cudaSuccess) {
        return (int)err;
    }
    // a cooperative grid must fit the card at once
    if ((long long)occ * sm_count() < blocks) {
        return (int)cudaErrorCooperativeLaunchTooLarge;
    }
    err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                      dim3(kThreads), args, smem, st);
    if (err != cudaSuccess) {
        return (int)err;
    }
    return (int)cudaGetLastError();
}

template <typename T, int VEC, bool RES>
int cgs2_launch(void* V, void* w, void* u, void* state, void* part,
                long long n, int m, int blocks, long long chunk, int stash,
                int givens, int smem, cudaStream_t st) {
    T* Vt = static_cast<T*>(V);
    T* wt = static_cast<T*>(w);
    T* ut = static_cast<T*>(u);
    double* sd = static_cast<double*>(state);
    double* pd = static_cast<double*>(part);
    void* args[] = {&Vt, &wt, &ut, &sd, &pd, &n, &m, &chunk, &stash,
                    &givens};
    return coop_launch(cgs2_kernel<T, VEC, RES>, blocks, smem, args, st);
}

// The plan's numbers checked again, then the instance of its vector width
// and branch.
template <typename T>
int cgs2(void* V, void* w, void* u, void* state, void* part,
         long long part_len, long long n, int m, int blocks, long long chunk,
         int resident, int stash, int vec, int givens, int smem,
         void* stream) {
    constexpr int kVec = 16 / sizeof(T);
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(V) | reinterpret_cast<uintptr_t>(w)
          | reinterpret_cast<uintptr_t>(u)) & 15) == 0;
    if (n <= 0 || m < 1 || blocks < 1 || chunk < 1
        || (vec != 1 && (vec != kVec || n % vec || !aligned))
        || chunk % vec || (long long)blocks * chunk < n
        || (long long)(blocks - 1) * chunk >= n
        || stash < 0 || stash > m || (givens != 0 && givens != 1)
        || part_len < (2LL * (m + 1) + 1) * blocks
        || cgs2_smem(m, chunk, vec, (int)sizeof(T), resident, stash) > smem
        || (size_t)smem > aniso::kSmemBlock) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t st = (cudaStream_t)stream;
#define ANISO_K11(VC, RS)                                                   \
    cgs2_launch<T, VC, RS>(V, w, u, state, part, n, m, blocks, chunk, stash, \
                           givens, smem, st)
    if (vec == 1) {
        return resident ? ANISO_K11(1, true) : ANISO_K11(1, false);
    }
    return resident ? ANISO_K11(kVec, true) : ANISO_K11(kVec, false);
#undef ANISO_K11
}

template <typename T, int VEC, bool RES>
int cgs2_shards_launch(const ShardTable& tab, int shards, int per,
                       void* state, void* part, void* sums, int m,
                       long long chunk, int stash, int givens, int phase,
                       int smem, cudaStream_t st) {
    double* sd = static_cast<double*>(state);
    double* pd = static_cast<double*>(part);
    double* hd = static_cast<double*>(sums);
    void* args[] = {const_cast<ShardTable*>(&tab), &per, &sd, &pd, &hd, &m,
                    &chunk, &stash, &givens, &phase};
    return coop_launch(cgs2_shards_kernel<T, VEC, RES>, shards * per, smem,
                       args, st);
}

// K11-S: the table (per shard its V, w and u pointers and n) checked
// against the plan: every shard's n covered by `per` chunks, 16-byte packs
// only where every shard's rows and pointers take them, the resident
// branch only on the fused route, `sums` on the split one.
template <typename T>
int cgs2_shards(const long long* table, int shards, int per, void* state,
                void* part, long long part_len, void* sums, int m,
                long long chunk, int resident, int stash, int vec,
                int givens, int phase, int smem, void* stream) {
    constexpr int kVec = 16 / sizeof(T);
    if (shards < 1 || shards > kMaxShards || per < 1 || m < 1 || chunk < 1
        || (vec != 1 && vec != kVec) || chunk % vec
        || stash < 0 || stash > m || (givens != 0 && givens != 1)
        || phase < kPhaseA || phase > kFused
        || (resident && phase != kFused)
        || (phase != kFused && sums == nullptr)
        || part_len < (2LL * (m + 1) + 1) * shards * per
        || cgs2_smem(m, chunk, vec, (int)sizeof(T), resident, stash) > smem
        || (size_t)smem > aniso::kSmemBlock) {
        return (int)cudaErrorInvalidValue;
    }
    ShardTable tab = {};
    for (int s = 0; s < shards; ++s) {
        const long long* t = table + 4 * s;
        tab.V[s] = reinterpret_cast<void*>(t[0]);
        tab.w[s] = reinterpret_cast<void*>(t[1]);
        tab.u[s] = reinterpret_cast<void*>(t[2]);
        tab.n[s] = t[3];
        const bool aligned = ((t[0] | t[1] | t[2]) & 15) == 0;
        if (t[3] <= 0 || (long long)per * chunk < t[3]
            || (vec != 1 && (t[3] % vec || !aligned))) {
            return (int)cudaErrorInvalidValue;
        }
    }
    const cudaStream_t st = (cudaStream_t)stream;
#define ANISO_K11S(VC, RS)                                                  \
    cgs2_shards_launch<T, VC, RS>(tab, shards, per, state, part, sums, m,   \
                                  chunk, stash, givens, phase, smem, st)
    if (vec == 1) {
        return resident ? ANISO_K11S(1, true) : ANISO_K11S(1, false);
    }
    return resident ? ANISO_K11S(kVec, true) : ANISO_K11S(kVec, false);
#undef ANISO_K11S
}

}  // namespace

// K11: V (m + 1, n), w (n), u (n) in the field's type; state (layout(m).len)
// float64; part: at least part_len = (2 (m + 1) + 1) blocks float64 of
// scratch; blocks, chunk, resident, stash, vec and smem from
// kernels/krylov.py:cgs2_plan, checked again here; givens 1: K12's Givens
// step as the epilogue (the one-device step, every solver path's), 0: the
// column alone, for measurement only (K11's cost apart from the epilogue;
// no solver path launches it).
extern "C" int aniso_cgs2_f32(void* V, void* w, void* u, void* state,
                              void* part, long long part_len, long long n,
                              int m, int blocks, long long chunk,
                              int resident, int stash, int vec, int givens,
                              int smem, void* stream) {
    return cgs2<float>(V, w, u, state, part, part_len, n, m, blocks, chunk,
                       resident, stash, vec, givens, smem, stream);
}

extern "C" int aniso_cgs2_f64(void* V, void* w, void* u, void* state,
                              void* part, long long part_len, long long n,
                              int m, int blocks, long long chunk,
                              int resident, int stash, int vec, int givens,
                              int smem, void* stream) {
    return cgs2<double>(V, w, u, state, part, part_len, n, m, blocks, chunk,
                        resident, stash, vec, givens, smem, stream);
}

// K11-S: one step's CGS2 on the shards of one card, `shards` of them
// (<= 16), `per` blocks each; table: per shard its V (m + 1, n), w (n) and
// u (n) pointers and n, as long longs; state (layout(m).len) float64; part:
// at least part_len = (2 (m + 1) + 1) shards per float64 of scratch; sums:
// 2 (m + 1) + 1 float64 (the split route's; null on the fused one);
// chunk, resident, stash, vec and smem from kernels/krylov.py:cgs2_plan;
// phase 4: the fused route, the whole step and K12's Givens step (givens
// 1) in one launch; 0-3: one phase of the split route, the caller summing
// `sums` over cards and processes between them, givens 1 on the card that
// holds the state (the others pass a copy of its header and 0).
extern "C" int aniso_cgs2_shards_f32(const long long* table, int shards,
                                     int per, void* state, void* part,
                                     long long part_len, void* sums, int m,
                                     long long chunk, int resident, int stash,
                                     int vec, int givens, int phase, int smem,
                                     void* stream) {
    return cgs2_shards<float>(table, shards, per, state, part, part_len, sums,
                              m, chunk, resident, stash, vec, givens, phase,
                              smem, stream);
}

extern "C" int aniso_cgs2_shards_f64(const long long* table, int shards,
                                     int per, void* state, void* part,
                                     long long part_len, void* sums, int m,
                                     long long chunk, int resident, int stash,
                                     int vec, int givens, int phase, int smem,
                                     void* stream) {
    return cgs2_shards<double>(table, shards, per, state, part, part_len,
                               sums, m, chunk, resident, stash, vec, givens,
                               phase, smem, stream);
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

// The launch floor K12 is held against: an empty one-block launch.
extern "C" int aniso_krylov_floor(void* stream) {
    floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

// The state's length in float64 for restart m (kernels/krylov.py checks its
// own layout against it).
extern "C" int aniso_krylov_state_len(int m) { return layout(m).len; }
