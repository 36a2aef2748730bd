// K8: the FMM's transfer passes, for sm_90a, in two instances from one
// template: float32 and float64.
//
// Replaces aniso_tpu/fmm/apply.py:_up_pass (:141-155: P2M, then one M2M
// einsum a level), the L2L einsum of _down_pass (:549-551; :752-760 in
// fmm_apply_all_modes) and the leaf's L2T with the near-field add and the
// 1/2pi scale (:707-711; :763-766):
//
//   M_leaf[i, j, c]  = sum_k p2m_w[c, k] u[i, j, k]
//   M_{l-1}[x, y, a] = sum_{h,g,c} m2m[h, g, a, c] M_l[2x+h, 2y+g, c]
//   L_{l+1}[2x+h, 2y+g, c] = sum_a m2m[h, g, a, c] L_l[x, y, a] + T_{l+1}
//   out[d, i, j, k]  = (sum_c l2t[k, c] L_leaf[d, i, j, c] + near[d, i, j, k])
//                      / (2 pi)
//
// with u (lx, ly, nq), M and L (mx, my, r) at each level (a leading mode
// axis D on L, T, near and out), p2m_w (r, nq), l2t (nq, r), all
// contiguous.  m2m is the tensor product of the one-dimensional child
// transfer tc (2, np, np), r = np^2 (fmm/cheb.py:m2m_tensor):
// m2m[h, g, (a, b), (i, j)] = tc[h, i, a] tc[g, j, b].  The kernels take tc
// and run each transfer as two one-dimensional products, 2 np^3
// operations a child where m2m takes np^4, with 2 np^2 weights where m2m
// has 4 np^4:
//   M2M  Q[hx, i, b] = sum_{hy, j} tc[hy, j, b] C_{hx,hy}[i, j]
//        P[a, b]     = sum_{hx, i} tc[hx, i, a] Q[hx, i, b]
//   L2L  R[hy, a, j] = sum_b tc[hy, j, b] L[a, b]
//        C_{hx,hy}[i, j] = sum_a tc[hx, i, a] R[hy, a, j] + T
// The extents are rectangular, so a shard's block is the same launch as the
// whole grid.
//
// Bound on the H100: bytes.  A sweep reads u, every level's T and the near
// field once and writes every level's M and the far field once: at 64^2,
// deg 3, np 4 in float32 1.7 MB (0.5 us at 3.35 TB/s); its operations are
// a few MFLOP.  The design is one launch a pass at every size, with enough
// blocks to fill the card (kernels/transfer.py plans it):
//   * up (transfer_up_kernel): a block owns a tile of 2^t x 2^t leaf
//     boxes (t levels; 4 x 4 at 64^2, 256 blocks).  It stages the tile's u
//     (or M) in shared memory with 16-byte loads where its rows allow,
//     forms the multipoles by P2M and reduces them level by level to the
//     tile's one box, writing each level's M (the M2L translates read
//     them).  The levels above the tiles are finished in the same launch:
//     a block that wrote its box takes a ticket of the parent box (an
//     atomic counter a box), and the last of the four to arrive reduces
//     the parent from its children's M, read from L2, in a fixed order,
//     then takes the next ticket.  Each box is reduced by one block, no
//     value is added atomically, and the last arriver sets its counter
//     back to 0, so the counters are 0 again for the next launch and a
//     graph replay;
//   * down (transfer_down_kernel): the levels' translates T do not depend
//     on L, so they are all formed first (K1, K3 or the shard's); a block
//     owns a leaf tile and a mode.  It forms its ancestors' L along its one
//     path from the launch's top level (one box a level), then its subtree
//     in shared memory, level by level with T added, and runs the epilogue
//     (L2T, near, scale) from there, or writes the last level's L.  No
//     block waits for another;
//   * every sum runs in float64 in a fixed order, in both instances, and a
//     block's levels stay in float64 in shared memory (an output is rounded
//     to the kernel's type once; the separable form's extra products would
//     otherwise add a rounding a level): results are the same bit for bit
//     from run to run;
//   * tc is staged in shared memory (and transposed for L2L's first
//     product), so that a warp's lanes, which run along the output's last
//     axis, read consecutive words; p2m_w (as (k, c)) and l2t (as (c, k))
//     are staged beside the tile where they fit, else read in place;
//   * np 2-7 are compiled (constant divisions, unrolled products), any other
//     np runs one runtime instance; a tile's side is a power of two, so its
//     box indices are shifts;
//   * the launch takes its levels' pointers as a kernel parameter (no table
//     copy), allocates nothing and does not synchronise, so a CUDA graph
//     captures it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "smem_limits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 16;    // offsets 0..15 of a pass (MAX_LEVELS)
constexpr int kMaxT = 3;          // levels inside a block (MAX_T)

// the pointers of a pass's levels, by offset from its finest level
struct Levels {
    const void* p[kMaxLevels];
};

__host__ __device__ inline long long at_least(long long a, long long b) {
    return a > b ? a : b;
}

// Shared memory of a block in bytes, with the offsets of its buffers
// (kernels/transfer.py:smem_bytes agrees), each on 16 bytes.  Every buffer
// but U holds float64 (the kernels' sums and intermediates in both
// instances):
//   up:   A the tile (at least 4 boxes: a parent's children), U the
//         tile's u in the kernel's type (P2M only), B the level above the
//         tile, Q the first products, W tc, P p2m_w where staged;
//   down: A the tile, B the level above it, Q (R) the first products,
//         W tc and its transpose, P l2t where staged, and G what the block
//         reads from global memory, in the kernel's type, all copied at its
//         start: its ancestor's L0, the T of its chain's n - t boxes and of
//         its subtree's levels, and the tile's near field (epilogue).
struct Layout {
    long long A, U, B, Q, W, P, G, total;
};

// values of the down pass's G (see layout)
__host__ __device__ inline long long gathered(int t, int r, int nq, int n) {
    long long v = (long long)(1 + n - t) * r;
    for (int s = 0; s < t; ++s) {
        v += (1LL << (2 * (t - s))) * r;
    }
    return v + (1LL << (2 * t)) * nq;
}

__host__ __device__ inline long long up16(long long b) {
    return (b + 15) & ~15LL;
}

__host__ __device__ inline Layout layout(bool down, int t, int r, int nq,
                                         int item, bool staged, int n) {
    const long long S2 = 1LL << (2 * t);
    Layout L;
    L.A = 0;
    L.U = L.A + up16((down ? S2 : at_least(S2, 4)) * r * 8);
    L.B = L.U + up16(down || nq == 0 ? 0 : S2 * nq * item);
    L.Q = L.B + up16(at_least(S2 / 4, 1) * r * 8);
    L.W = L.Q + up16(at_least(S2 / 2, down ? 1 : 2) * r * 8);
    L.P = L.W + up16((down ? 4 : 2) * (long long)r * 8);
    L.G = L.P + up16(staged ? (long long)r * nq * 8 : 0);
    L.total = L.G + up16(down ? gathered(t, r, nq, n) * item : 0);
    return L;
}

// The tile's S rows of S boxes, `per` values a box, from a plane with gy
// boxes along y into dst (S rows of S * per values): 16-byte loads where
// every run starts on 16 bytes and is a multiple of 16 (vec), else one
// value a load.
template <typename T>
__device__ void stage_rows(T* dst, const T* __restrict__ src, int X0, int Y0,
                           int S, int gy, int per, int vec) {
    const int run = S * per;
    if (vec) {
        const int rv = run * (int)sizeof(T) / 16;
        for (int i = threadIdx.x; i < S * rv; i += kThreads) {
            const int x = i / rv;
            const uint4* s = reinterpret_cast<const uint4*>(
                src + ((size_t)(X0 + x) * gy + Y0) * per);
            reinterpret_cast<uint4*>(dst + (size_t)x * run)[i % rv] =
                s[i % rv];
        }
    } else {
        for (int i = threadIdx.x; i < S * run; i += kThreads) {
            const int x = i / run;
            dst[i] = src[((size_t)(X0 + x) * gy + Y0) * per + i % run];
        }
    }
}

// np at compile time (NP = 2..7: constant divisions, unrolled loops) or,
// NP = 0, at run time (the argument np)
#define NPV (NP ? NP : np)

// M2M of one level in shared memory: the children (side 2^(lh + 1),
// row-major boxes of r values) in C, their first products in Q, the
// parents (side h = 2^lh) into P and, rounded to T, into Mo at box
// (x0 + px, y0 + py) of a plane with gy boxes along y.  W: tc[h][i][a] at
// W[(h np + i) np + a].
template <typename T, int NP>
__device__ void m2m_level(const double* C, double* Q, double* P,
                          const double* W, int lh, int np, T* Mo, int x0,
                          int y0, int gy) {
    const int n_ = NPV, r = n_ * n_;
    const int h = 1 << lh, lw = lh + 1;
    for (int i = threadIdx.x; i < (2 * r) << (2 * lh); i += kThreads) {
        const int b = i % n_;
        const int ii = (i / n_) % n_;
        const int hx = (i / r) & 1;
        const int p = i / (2 * r);
        const int px = p >> lh, py = p & (h - 1);
        double v = 0.0;
#pragma unroll
        for (int hy = 0; hy < 2; ++hy) {
            const double* c = C + ((size_t)(((2 * px + hx) << lw)
                                            + 2 * py + hy)) * r + ii * n_;
            const double* tw = W + hy * r + b;
#pragma unroll
            for (int j = 0; j < n_; ++j) {
                v += tw[j * n_] * c[j];
            }
        }
        Q[i] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < r << (2 * lh); i += kThreads) {
        const int b = i % n_;
        const int a = (i / n_) % n_;
        const int p = i / r;
        double v = 0.0;
#pragma unroll
        for (int hx = 0; hx < 2; ++hx) {
            const double* q = Q + ((size_t)p * 2 + hx) * r + b;
            const double* tw = W + hx * r + a;
#pragma unroll
            for (int ii = 0; ii < n_; ++ii) {
                v += tw[ii * n_] * q[ii * n_];
            }
        }
        P[i] = v;
        Mo[((size_t)(x0 + (p >> lh)) * gy + (y0 + (p & (h - 1)))) * r + i % r]
            = (T)v;
    }
    __syncthreads();
}

// L2L of one level in shared memory: the parents (side h = 2^lh) in Lp,
// their first products in R, the children (side 2h) into Lc with T added
// from Tl, the children's T in the same row-major order.  W as in
// m2m_level; Wt: tc[g][j][b] at Wt[(g np + b) np + j].
template <typename T, int NP>
__device__ void l2l_level(const double* Lp, double* R, double* Lc,
                          const double* W, const double* Wt, int lh, int np,
                          const T* Tl) {
    const int n_ = NPV, r = n_ * n_;
    const int lw = lh + 1;
    for (int i = threadIdx.x; i < (2 * r) << (2 * lh); i += kThreads) {
        const int j = i % n_;
        const int a = (i / n_) % n_;
        const int hy = (i / r) & 1;
        const int p = i / (2 * r);
        const double* lp = Lp + (size_t)p * r + a * n_;
        const double* tw = Wt + hy * r + j;
        double v = 0.0;
#pragma unroll
        for (int b = 0; b < n_; ++b) {
            v += tw[b * n_] * lp[b];
        }
        R[i] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < r << (2 * lw); i += kThreads) {
        const int c = i % r;
        const int box = i / r;
        const int cx = box >> lw, cy = box & ((2 << lh) - 1);
        const int p = ((cx >> 1) << lh) + (cy >> 1);
        const int ii = c / n_, j = c % n_;
        const double* rr = R + ((size_t)p * 2 + (cy & 1)) * r + j;
        const double* tw = W + ((cx & 1) * n_ + ii) * n_;
        double v = 0.0;
#pragma unroll
        for (int a = 0; a < n_; ++a) {
            v += tw[a] * rr[a * n_];
        }
        Lc[i] = v + (double)Tl[i];
    }
    __syncthreads();
}

// L2L of one box to its child (hx, hy) alone (the down pass's chain above
// the tile), T added from Tbox.
template <typename T, int NP>
__device__ void l2l_one(const double* Lp, double* R, double* Lc,
                        const double* W, const double* Wt, int hx, int hy,
                        int np, const T* Tbox) {
    const int n_ = NPV, r = n_ * n_;
    for (int i = threadIdx.x; i < r; i += kThreads) {
        const int j = i % n_, a = i / n_;
        const double* tw = Wt + hy * r + j;
        double v = 0.0;
#pragma unroll
        for (int b = 0; b < n_; ++b) {
            v += tw[b * n_] * Lp[a * n_ + b];
        }
        R[i] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < r; i += kThreads) {
        const int j = i % n_, ii = i / n_;
        const double* tw = W + (hx * n_ + ii) * n_;
        double v = 0.0;
#pragma unroll
        for (int a = 0; a < n_; ++a) {
            v += tw[a] * R[a * n_ + j];
        }
        Lc[i] = v + (double)Tbox[i];
    }
    __syncthreads();
}

// Up: block (bx, by) owns the leaf tile of S = 2^t boxes a side at
// (bx S, by S) of the (lx, ly) plane: P2M from u (p2m_w given; M.p[0] is
// written) or M.p[0] read, then levels 1..t in shared memory, then the
// levels t + 1..n by tickets.  M.p[s] is M at offset s.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads) transfer_up_kernel(
    const T* __restrict__ u,          // (lx, ly, nq) or null (M.p[0] given)
    const T* __restrict__ p2m_w,      // (r, nq) or null
    const T* __restrict__ tc,         // (2, np, np)
    const Levels M, int* __restrict__ tickets, int lx, int ly, int np,
    int nq, int n, int t, int staged, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int n_ = NPV, r = n_ * n_;
    const bool p2m = p2m_w != nullptr;
    const Layout L = layout(false, t, r, p2m ? nq : 0, (int)sizeof(T),
                            staged, n);
    double* A = reinterpret_cast<double*>(smem + L.A);
    T* U = reinterpret_cast<T*>(smem + L.U);
    double* B = reinterpret_cast<double*>(smem + L.B);
    double* Q = reinterpret_cast<double*>(smem + L.Q);
    double* W = reinterpret_cast<double*>(smem + L.W);
    const int S = 1 << t;
    const int X0 = blockIdx.x * S, Y0 = blockIdx.y * S;
    for (int i = threadIdx.x; i < 2 * r; i += kThreads) {
        W[i] = (double)tc[i];
    }
    if (p2m) {
        stage_rows(U, u, X0, Y0, S, ly, nq, vec);
        if (staged) {                 // p2m_w as (q, c)
            double* P = reinterpret_cast<double*>(smem + L.P);
            for (int i = threadIdx.x; i < r * nq; i += kThreads) {
                P[(i % nq) * r + i / nq] = (double)p2m_w[i];
            }
        }
    } else {
        const T* M0 = static_cast<const T*>(M.p[0]);
        for (int i = threadIdx.x; i < r << (2 * t); i += kThreads) {
            const int b = i / r;
            A[i] = (double)M0[((size_t)(X0 + (b >> t)) * ly + Y0
                               + (b & (S - 1))) * r + i % r];
        }
    }
    __syncthreads();
    if (p2m) {
        const double* P = reinterpret_cast<const double*>(smem + L.P);
        T* M0 = (T*)M.p[0];
        for (int i = threadIdx.x; i < r << (2 * t); i += kThreads) {
            const int c = i % r;
            const int b = i / r;
            const T* ub = U + (size_t)b * nq;
            double v = 0.0;
            if (staged) {
                for (int q = 0; q < nq; ++q) {
                    v += P[q * r + c] * (double)ub[q];
                }
            } else {
                for (int q = 0; q < nq; ++q) {
                    v += (double)p2m_w[c * nq + q] * (double)ub[q];
                }
            }
            A[i] = v;
            M0[((size_t)(X0 + (b >> t)) * ly + Y0 + (b & (S - 1))) * r + c] =
                (T)v;
        }
        __syncthreads();
    }
    // offset s of the tile in A (s even) or B (s odd)
    for (int s = 1; s <= t; ++s) {
        m2m_level<T, NP>((s & 1) ? A : B, Q, (s & 1) ? B : A, W, t - s, np,
                         (T*)M.p[s], X0 >> s, Y0 >> s, ly >> s);
    }
    // above the tile: the last of a parent's four children to arrive
    // reduces it
    int x = blockIdx.x, y = blockIdx.y;     // the block's box at offset s
    long long base = 0;                     // tickets of offset s + 1
    for (int s = t; s < n; ++s) {
        const int gy1 = ly >> (s + 1);
        __syncthreads();                    // the block's M at offset s ...
        int last = 0;
        if (threadIdx.x == 0) {
            int* tk = tickets + base + (long long)(x >> 1) * gy1 + (y >> 1);
            __threadfence();                // ... visible before the ticket
            last = atomicAdd(tk, 1) == 3;
            if (last) {
                atomicExch(tk, 0);          // all four came: 0 for the next
            }
            __threadfence();
        }
        if (!__syncthreads_or(last)) {      // thread 0's answer, to all
            return;
        }
        base += (long long)(lx >> (s + 1)) * gy1;
        x >>= 1;
        y >>= 1;
        const T* Ms = static_cast<const T*>(M.p[s]);
        const int gy = ly >> s;
        for (int i = threadIdx.x; i < 4 * r; i += kThreads) {
            const int hg = i / r;
            A[i] = (double)__ldcg(Ms + ((size_t)(2 * x + (hg >> 1)) * gy
                                        + (2 * y + (hg & 1))) * r + i % r);
        }
        __syncthreads();
        m2m_level<T, NP>(A, Q, B, W, 0, np, (T*)M.p[s + 1], x, y, gy1);
    }
}

// Down: block (tile, mode d) owns the leaf tile of S = 2^t boxes a side at
// (bx S, by S): its ancestor's L at offset n from L0, the chain to offset
// t, the subtree to offset 0, then the epilogue (l2t given) or L written.
// Ts.p[s] is T at offset s, s < n.
template <typename T, int NP>
__global__ void __launch_bounds__(kThreads) transfer_down_kernel(
    const T* __restrict__ L0,         // (D, lx >> n, ly >> n, r)
    const Levels Ts,                  // (D, lx >> s, ly >> s, r)
    const T* __restrict__ tc,         // (2, np, np)
    const T* __restrict__ l2t,        // (nq, r) or null
    const T* __restrict__ near,       // (D, lx, ly, nq) or null
    T* __restrict__ out,              // (D, lx, ly, nq or r)
    int lx, int ly, int np, int nq, int n, int t, int staged) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int n_ = NPV, r = n_ * n_;
    const Layout L = layout(true, t, r, l2t ? nq : 0, (int)sizeof(T), staged,
                            n);
    double* A = reinterpret_cast<double*>(smem + L.A);
    double* B = reinterpret_cast<double*>(smem + L.B);
    double* R = reinterpret_cast<double*>(smem + L.Q);
    double* W = reinterpret_cast<double*>(smem + L.W);
    double* Wt = W + 2 * r;
    const int S = 1 << t;
    const int tiles_y = ly >> t;
    const int bx = blockIdx.x / tiles_y, by = blockIdx.x % tiles_y;
    const int d = blockIdx.y;
    // G: every value the block reads from global memory, copies in flight
    // together: the ancestor's L0 (r), the chain's T (offsets n - 1 .. t,
    // a box each), the subtree's T (offsets t - 1 .. 0, (S >> s)^2 boxes
    // row-major each), the tile's near field (S^2 squares of nq)
    T* G = reinterpret_cast<T*>(smem + L.G);
    T* Gc = G + r;
    T* Gs = Gc + (size_t)(n - t) * r;
    {
        const T* src = L0 + (((size_t)d * (lx >> n) + (bx >> (n - t)))
                             * (ly >> n) + (by >> (n - t))) * r;
        for (int i = threadIdx.x; i < r; i += kThreads) {
            __pipeline_memcpy_async(G + i, src + i, sizeof(T));
        }
        for (int i = threadIdx.x; i < (n - t) * r; i += kThreads) {
            const int s = n - 1 - i / r;
            const T* box = static_cast<const T*>(Ts.p[s])
                           + (((size_t)d * (lx >> s) + (bx >> (s - t)))
                              * (ly >> s) + (by >> (s - t))) * r;
            __pipeline_memcpy_async(Gc + i, box + i % r, sizeof(T));
        }
        T* g = Gs;
        for (int s = t - 1; s >= 0; --s) {
            const int lw = t - s, w = 1 << lw;
            const T* Tl = static_cast<const T*>(Ts.p[s])
                          + (size_t)d * (lx >> s) * (ly >> s) * r;
            for (int i = threadIdx.x; i < r << (2 * lw); i += kThreads) {
                const int k = i / r, x = k >> lw;
                __pipeline_memcpy_async(
                    g + i, Tl + ((size_t)(bx * w + x) * (ly >> s) + by * w) * r
                               + (i - (x << lw) * r), sizeof(T));
            }
            g += (size_t)r << (2 * lw);
        }
        if (l2t != nullptr) {
            const T* nr = near + (size_t)d * lx * ly * nq;
            const int run = S * nq;
            for (int i = threadIdx.x; i < S * run; i += kThreads) {
                const int x = i / run;
                __pipeline_memcpy_async(
                    g + i, nr + ((size_t)(bx * S + x) * ly + by * S) * nq
                               + (i - x * run), sizeof(T));
            }
        }
        __pipeline_commit();
    }
    for (int i = threadIdx.x; i < 2 * r; i += kThreads) {
        const int g = i / r, j = (i / n_) % n_, b = i % n_;
        W[i] = (double)tc[i];
        Wt[(g * n_ + b) * n_ + j] = (double)tc[i];
    }
    if (l2t != nullptr && staged) {   // l2t as (c, q)
        double* P = reinterpret_cast<double*>(smem + L.P);
        for (int i = threadIdx.x; i < nq * r; i += kThreads) {
            P[(i % r) * nq + i / r] = (double)l2t[i];
        }
    }
    __pipeline_wait_prior(0);
    __syncthreads();
    // offset s in A (s even) or B (s odd): the ancestor at offset n
    {
        double* Ln = (n & 1) ? B : A;
        for (int i = threadIdx.x; i < r; i += kThreads) {
            Ln[i] = (double)G[i];
        }
    }
    __syncthreads();
    for (int s = n - 1; s >= t; --s) {
        const int cx = bx >> (s - t), cy = by >> (s - t);
        l2l_one<T, NP>((s & 1) ? A : B, R, (s & 1) ? B : A, W, Wt, cx & 1,
                       cy & 1, np, Gc + (size_t)(n - 1 - s) * r);
    }
    const T* Gl = Gs;                  // the subtree's T, offset t - 1 first
    for (int s = t - 1; s >= 0; --s) {
        const int lh = t - s - 1;
        l2l_level<T, NP>((s & 1) ? A : B, R, (s & 1) ? B : A, W, Wt, lh, np,
                         Gl);
        Gl += (size_t)r << (2 * lh + 2);
    }
    const size_t plane = (size_t)d * lx * ly;
    if (l2t == nullptr) {
        for (int i = threadIdx.x; i < r << (2 * t); i += kThreads) {
            const int b = i / r;
            const size_t sq = (size_t)(bx * S + (b >> t)) * ly + by * S
                              + (b & (S - 1));
            out[(plane + sq) * r + i % r] = (T)A[i];
        }
        return;
    }
    const double* P = reinterpret_cast<const double*>(smem + L.P);
    const double two_pi = 6.283185307179586;
    for (int i = threadIdx.x; i < S * S * nq; i += kThreads) {
        const int q = i % nq;
        const int b = i / nq;
        const size_t at = (plane + (size_t)(bx * S + (b >> t)) * ly
                           + by * S + (b & (S - 1))) * nq + q;
        const double* Lb = A + (size_t)b * r;
        double far = 0.0;
        if (staged) {
#pragma unroll 4
            for (int c = 0; c < r; ++c) {
                far += P[c * nq + q] * Lb[c];
            }
        } else {
            for (int c = 0; c < r; ++c) {
                far += (double)l2t[q * r + c] * Lb[c];
            }
        }
        out[at] = (T)((far + (double)Gl[i]) / two_pi);   // Gl: the near field
    }
}

#undef NPV

// The launch's shared memory, with p2m_w or l2t staged where it fits
// (*staged = 1), and the kernel's attribute for it.
template <typename Kern>
int prepare(Kern kern, bool down, int t, int r, int nq, int n, int item,
            size_t* smem, int* staged) {
    *staged = (size_t)layout(down, t, r, nq, item, true, n).total
              <= aniso::kSmemBlock;
    *smem = (size_t)layout(down, t, r, nq, item, *staged, n).total;
    if (*smem > aniso::kSmemBlock) {
        return (int)cudaErrorInvalidValue;
    }
    // the attribute belongs to the current device: set it every launch
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

// the extents every launch takes: n levels above an (lx, ly) plane that
// 2^n divides, tiles of t <= n levels
bool extents_ok(int lx, int ly, int np, int n, int t) {
    return np >= 1 && n >= 0 && n < kMaxLevels && t >= 0 && t <= kMaxT
           && t <= n && lx >= (1 << n) && ly >= (1 << n)
           && lx % (1 << n) == 0 && ly % (1 << n) == 0
           && (long long)lx * ly <= 0x7fffffffLL;
}

// the tickets of the levels above the tiles: one a box
long long tickets_needed(int lx, int ly, int n, int t) {
    long long k = 0;
    for (int s = t + 1; s <= n; ++s) {
        k += (long long)(lx >> s) * (ly >> s);
    }
    return k;
}

// the instance of np: 2-7 compiled, any other at run time
#define ANISO_K8_NP(CALL)          \
    switch (np) {                  \
        case 2: CALL(2); break;    \
        case 3: CALL(3); break;    \
        case 4: CALL(4); break;    \
        case 5: CALL(5); break;    \
        case 6: CALL(6); break;    \
        case 7: CALL(7); break;    \
        default: CALL(0); break;   \
    }

template <typename T, int NP>
int up_np(const void* u, const void* p2m_w, const void* tc, const Levels& lv,
          void* tickets, int lx, int ly, int np, int nq, int n, int t,
          int vec, cudaStream_t stream) {
    auto kern = transfer_up_kernel<T, NP>;
    const bool p2m = p2m_w != nullptr;
    size_t smem = 0;
    int staged = 0;
    const int err = prepare(kern, false, t, np * np, p2m ? nq : 0, n,
                            (int)sizeof(T), &smem, &staged);
    if (err != 0) {
        return err;
    }
    const dim3 grid(lx >> t, ly >> t);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(u), static_cast<const T*>(p2m_w),
        static_cast<const T*>(tc), lv, static_cast<int*>(tickets), lx, ly,
        np, nq, n, t, staged, vec);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_up(const void* u, const void* p2m_w, const void* tc,
              const void* const* levels, void* tickets, long long tickets_len,
              int lx, int ly, int np, int nq, int n, int t, void* stream) {
    const bool p2m = p2m_w != nullptr;
    if (!extents_ok(lx, ly, np, n, t) || (ly >> t) > 65535
        || (p2m && (nq < 1 || u == nullptr))
        || tickets_needed(lx, ly, n, t) > tickets_len) {
        return (int)cudaErrorInvalidValue;
    }
    Levels lv{};
    for (int s = 0; s <= n; ++s) {
        lv.p[s] = levels[s];
    }
    // 16-byte loads of the tile's u: every run starts on 16 bytes
    const long long per = nq * (long long)sizeof(T);
    const int vec = p2m && reinterpret_cast<uintptr_t>(u) % 16 == 0
                    && (per << t) % 16 == 0 && (per * ly) % 16 == 0;
    int rc = 0;
#define ANISO_K8_UP(NPC)                                                     \
    rc = up_np<T, NPC>(u, p2m_w, tc, lv, tickets, lx, ly, np, nq, n, t, vec, \
                       (cudaStream_t)stream)
    ANISO_K8_NP(ANISO_K8_UP)
#undef ANISO_K8_UP
    return rc;
}

template <typename T, int NP>
int down_np(const void* L0, const Levels& lv, const void* tc,
            const void* l2t, const void* near, void* out, int lx, int ly,
            int np, int nq, int n, int t, int D, cudaStream_t stream) {
    auto kern = transfer_down_kernel<T, NP>;
    size_t smem = 0;
    int staged = 0;
    const int err = prepare(kern, true, t, np * np, l2t ? nq : 0, n,
                            (int)sizeof(T), &smem, &staged);
    if (err != 0) {
        return err;
    }
    const dim3 grid((lx >> t) * (ly >> t), D);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(L0), lv, static_cast<const T*>(tc),
        static_cast<const T*>(l2t), static_cast<const T*>(near),
        static_cast<T*>(out), lx, ly, np, nq, n, t, staged);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_down(const void* L0, const void* const* Ts, const void* tc,
                const void* l2t, const void* near, void* out, int lx, int ly,
                int np, int nq, int n, int t, int D, void* stream) {
    if (!extents_ok(lx, ly, np, n, t) || D < 1 || D > 65535
        || (l2t && (nq < 1 || near == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    Levels lv{};
    for (int s = 0; s < n; ++s) {
        lv.p[s] = Ts[s];
    }
    int rc = 0;
#define ANISO_K8_DOWN(NPC)                                                  \
    rc = down_np<T, NPC>(L0, lv, tc, l2t, near, out, lx, ly, np, nq, n, t, \
                         D, (cudaStream_t)stream)
    ANISO_K8_NP(ANISO_K8_DOWN)
#undef ANISO_K8_DOWN
    return rc;
}

#undef ANISO_K8_NP

}  // namespace

// Up: one launch over the n levels above an (lx, ly) plane of boxes at its
// finest level, tiles of t levels; levels: M at offsets 0..n (offset 0 is
// written by P2M when p2m_w is given, else read); tickets: tickets_len
// int32 counters, 0 on entry and on return.
extern "C" int aniso_transfer_up_f32(const void* u, const void* p2m_w,
                                     const void* tc,
                                     const void* const* levels, void* tickets,
                                     long long tickets_len, int lx, int ly,
                                     int np, int nq, int n, int t,
                                     void* stream) {
    return launch_up<float>(u, p2m_w, tc, levels, tickets, tickets_len, lx,
                            ly, np, nq, n, t, stream);
}

extern "C" int aniso_transfer_up_f64(const void* u, const void* p2m_w,
                                     const void* tc,
                                     const void* const* levels, void* tickets,
                                     long long tickets_len, int lx, int ly,
                                     int np, int nq, int n, int t,
                                     void* stream) {
    return launch_up<double>(u, p2m_w, tc, levels, tickets, tickets_len, lx,
                             ly, np, nq, n, t, stream);
}

// Down: one launch from L0 at offset n above an (lx, ly) leaf plane for D
// modes, tiles of t levels; Ts: T at offsets 0..n-1; with l2t (and near)
// the epilogue, else out is the leaf's L.
extern "C" int aniso_transfer_down_f32(const void* L0, const void* const* Ts,
                                       const void* tc, const void* l2t,
                                       const void* near, void* out, int lx,
                                       int ly, int np, int nq, int n, int t,
                                       int D, void* stream) {
    return launch_down<float>(L0, Ts, tc, l2t, near, out, lx, ly, np, nq, n,
                              t, D, stream);
}

extern "C" int aniso_transfer_down_f64(const void* L0, const void* const* Ts,
                                       const void* tc, const void* l2t,
                                       const void* near, void* out, int lx,
                                       int ly, int np, int nq, int n, int t,
                                       int D, void* stream) {
    return launch_down<double>(L0, Ts, tc, l2t, near, out, lx, ly, np, nq, n,
                               t, D, stream);
}
