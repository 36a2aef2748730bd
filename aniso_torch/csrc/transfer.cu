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
// axis D on L, T, near and out), p2m_w (r, nq), m2m (2, 2, r, r), l2t
// (nq, r), all contiguous.  The extents are rectangular, so a shard's block
// is the same launch as the whole grid.
//
// Bound on the H100: bytes.  A sweep reads u, every level's T and the near
// field once and writes every level's M and the far field once: at 64^2,
// deg 3, np 4 in float32 1.7 MB (0.5 us at 3.35 TB/s); its operations
// (2 r nq a square for P2M and for L2T, 8 r^2 a parent box for M2M and for
// L2L) are a few MFLOP.  What it costs in torch is launches: 39 small
// kernels a 64^2 matvec (17 up, 22 down), each a few microseconds of launch
// and host time, so the design is few launches, each carrying several
// levels, and the locals of the finest levels never leave shared memory:
//   * up (transfer_up_kernel): a block owns a tile of 2^k x 2^k boxes at
//     its finest level (k <= kMaxK = 4: 16 x 16 leaf squares).  It forms
//     the tile's multipoles by P2M from u (or reads them, for a launch that
//     starts from a level's M), keeps them in shared memory and reduces
//     them level by level to the tile's one box, writing each level's M
//     (the M2L translates read them).  A pass over n levels is ceil(n / k)
//     launches (kernels/transfer.py:pass_plan): one at 64^2 (levels 6 to
//     2), two at 512^2;
//   * down (transfer_down_kernel): the levels' translates T do not depend
//     on L, so they are all formed first (K1, K3 or the shard's); a block
//     then owns one box of the launch's coarsest level and its subtree of
//     k levels: L2L into shared memory level by level, T added, and at the
//     leaf the epilogue (L2T, near, scale) straight from shared memory.
//     One block a (box, mode); a launch that does not reach the leaf
//     writes its last level's L for the next;
//   * every sum runs in the kernel's type in a fixed order (no atomics):
//     float64 results are the same bit for bit from run to run;
//   * the weights (m2m and p2m_w up, m2m and l2t down) are staged in
//     shared memory beside the tile where they fit (np 2-7), laid out so
//     that a warp's lanes, which run along the output's last axis, read
//     consecutive words: the up pass stores m2m as (h, g, c, a) and p2m_w
//     as (k, c), the down pass l2t as (c, k).  Read in place from global
//     memory, m2m's row (h, g, a, :) lies r values apart from lane to lane
//     in the up pass.  Where they do not fit (np 16: 2 MB of m2m in
//     float64) they are read from global memory through L1 in their own
//     layout;
//   * the launch takes its levels' pointers as a kernel parameter (no table
//     copy), allocates nothing and does not synchronise, so a CUDA graph
//     captures it.
// A block holds its tile and the level above it, (4^k + 4^(k-1)) r values
// (20 KB at np 4 in float32), and the staged weights, 4 r^2 + r nq values
// (4.6 KB); more than 48 KB takes the opt-in dynamic shared memory
// (cudaFuncAttributeMaxDynamicSharedMemorySize), up to kSmemBlock, and the
// plan cuts k for large r.  Simple and right, not tuned: a 64^2 pass is 16
// blocks.

#include <cuda_runtime.h>

#include "smem_limits.cuh"

namespace {

constexpr int kMaxK = 4;          // levels a launch spans (MAX_K)
constexpr int kThreads = 256;

// the k + 1 (up) or k (down) level pointers of a launch
struct Levels {
    const void* p[kMaxK + 1];
};

__host__ __device__ constexpr long long tile_values(int k) {
    return (1LL << (2 * k)) + (k ? (1LL << (2 * (k - 1))) : 0);
}

// the tile and the level above it, in values (the staged weights follow)
__host__ __device__ constexpr long long weights_at(int k, int r) {
    return tile_values(k) * r;
}

// Up: the block's tile of S x S boxes at level f (S = 2^k) from P2M of u
// (p2m_w given; out.p[0] is M_f) or from M_f (src; out.p[j - 1] is
// M_{f-j}), reduced to one box; level f - j is written to out.  staged:
// m2m (and p2m_w) copied into shared memory after the tile, transposed.
template <typename T>
__global__ void __launch_bounds__(kThreads) transfer_up_kernel(
    const T* __restrict__ src,        // u (ax, ay, nq) or M_f (ax, ay, r)
    const T* __restrict__ p2m_w,      // (r, nq) or null
    const T* __restrict__ m2m,        // (2, 2, r, r)
    const Levels out, int ax, int ay, int r, int nq, int k, int staged) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = 1 << k;
    // level f - j lives in buffer (j even: A, the tile's size; odd: B)
    T* A = reinterpret_cast<T*>(smem);
    T* B = A + ((size_t)S * S) * r;
    const int X0 = blockIdx.x * S;
    const int Y0 = blockIdx.y * S;
    const bool p2m = p2m_w != nullptr;
    const int rr = r * r;
    // m2m[h, g, a, c] at W[hg r^2 + a wa + c wc]; p2m_w[c, q] at
    // P[c pc + q pq]
    const T* W = m2m;
    const T* P = p2m_w;
    int wa = r, wc = 1, pc = nq, pq = 1;
    if (staged) {
        T* Ws = A + weights_at(k, r);
        T* Ps = Ws + 4 * rr;
        for (int i = threadIdx.x; i < 4 * rr; i += kThreads) {
            const int hg = i / rr, a = (i / r) % r, c = i % r;
            Ws[hg * rr + c * r + a] = m2m[i];
        }
        if (p2m) {
            for (int i = threadIdx.x; i < r * nq; i += kThreads) {
                Ps[(i % nq) * r + i / nq] = p2m_w[i];
            }
        }
        W = Ws;
        P = Ps;
        wa = 1;
        wc = r;
        pc = 1;
        pq = r;
        __syncthreads();
    }
    {
        const int n = S * S * r;
        T* Mf = p2m ? (T*)out.p[0] : nullptr;
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const int c = i % r;
            const int b = i / r;
            const size_t box = (size_t)(X0 + b / S) * ay + (Y0 + b % S);
            T v;
            if (p2m) {
                const T* ur = src + box * nq;
                const T* w = P + c * pc;
                v = T(0);
                for (int q = 0; q < nq; ++q) {
                    v += w[q * pq] * ur[q];
                }
                Mf[box * r + c] = v;
            } else {
                v = src[box * r + c];
            }
            A[i] = v;
        }
    }
    __syncthreads();
    for (int j = 1; j <= k; ++j) {
        const T* prev = (j & 1) ? A : B;
        T* cur = (j & 1) ? B : A;
        const int s = S >> j;          // the tile's side at level f - j
        const int ps = 2 * s;
        const int gy = ay >> j;
        const int x0 = X0 >> j, y0 = Y0 >> j;
        T* Mo = (T*)out.p[p2m ? j : j - 1];
        const int n = s * s * r;
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const int a = i % r;
            const int b = i / r;
            const int x = b / s, y = b % s;
            T v = T(0);
#pragma unroll
            for (int hg = 0; hg < 4; ++hg) {
                const T* ch = prev + ((size_t)(2 * x + (hg >> 1)) * ps
                                      + (2 * y + (hg & 1))) * r;
                const T* w = W + hg * rr + a * wa;
                for (int c = 0; c < r; ++c) {
                    v += w[c * wc] * ch[c];
                }
            }
            cur[i] = v;
            Mo[((size_t)(x0 + x) * gy + (y0 + y)) * r + a] = v;
        }
        __syncthreads();
    }
}

// Down: block (box of the launch's coarsest level, mode d): L from L0,
// then k levels of L2L with T added (Ts.p[j - 1] is T at level top + j),
// then the epilogue at the last level (l2t given) or its L written.
// staged: m2m (and l2t, transposed) copied into shared memory after the
// tile.
template <typename T>
__global__ void __launch_bounds__(kThreads) transfer_down_kernel(
    const T* __restrict__ L0,         // (D, ax, ay, r)
    const Levels Ts,                  // (D, ax 2^j, ay 2^j, r), j = 1..k
    const T* __restrict__ m2m,        // (2, 2, r, r)
    const T* __restrict__ l2t,        // (nq, r) or null
    const T* __restrict__ near,       // (D, ax 2^k, ay 2^k, nq) or null
    T* __restrict__ out,              // (D, ax 2^k, ay 2^k, nq or r)
    int ax, int ay, int r, int nq, int k, int staged) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = 1 << k;
    // level top + j lives in buffer (k - j even: A, the tile's size; odd: B)
    T* A = reinterpret_cast<T*>(smem);
    T* B = A + ((size_t)S * S) * r;
    const int bx = blockIdx.x / ay;
    const int by = blockIdx.x % ay;
    const int d = blockIdx.y;
    // m2m in its own layout; l2t[q, c] at Lt[q lq + c lc]
    const T* W = m2m;
    const T* Lt = l2t;
    int lq = r, lc = 1;
    if (staged) {
        T* Ws = A + weights_at(k, r);
        T* Ls = Ws + 4 * r * r;
        for (int i = threadIdx.x; i < 4 * r * r; i += kThreads) {
            Ws[i] = m2m[i];
        }
        if (l2t != nullptr) {
            for (int i = threadIdx.x; i < nq * r; i += kThreads) {
                Ls[(i % r) * nq + i / r] = l2t[i];
            }
            Lt = Ls;
            lq = 1;
            lc = nq;
        }
        W = Ws;
    }
    {
        T* L = (k & 1) ? B : A;
        const T* src = L0 + (((size_t)d * ax + bx) * ay + by) * r;
        for (int i = threadIdx.x; i < r; i += kThreads) {
            L[i] = src[i];
        }
    }
    __syncthreads();
    for (int j = 1; j <= k; ++j) {
        const T* prev = ((k - j + 1) & 1) ? B : A;
        T* cur = ((k - j) & 1) ? B : A;
        const int s = 1 << j;          // the subtree's side at level top + j
        const int hs = s >> 1;
        const int gx = ax << j, gy = ay << j;
        const T* Tj = static_cast<const T*>(Ts.p[j - 1])
                      + (size_t)d * gx * gy * r;
        const int n = s * s * r;
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const int c = i % r;
            const int b = i / r;
            const int x = b / s, y = b % s;
            const int hg = 2 * (x & 1) + (y & 1);
            const T* par = prev + ((size_t)(x >> 1) * hs + (y >> 1)) * r;
            const T* w = W + (size_t)hg * r * r + c;
            T v = T(0);
            for (int a = 0; a < r; ++a) {
                v += w[(size_t)a * r] * par[a];
            }
            cur[i] = v + Tj[((size_t)(bx * s + x) * gy + (by * s + y)) * r
                            + c];
        }
        __syncthreads();
    }
    const T* L = A;                    // level top + k: k - k = 0, even
    const int gx = ax << k, gy = ay << k;
    if (l2t == nullptr) {
        T* o = out + (size_t)d * gx * gy * r;
        for (int i = threadIdx.x; i < S * S * r; i += kThreads) {
            const int b = i / r;
            o[((size_t)(bx * S + b / S) * gy + (by * S + b % S)) * r
              + i % r] = L[i];
        }
        return;
    }
    const T two_pi = T(6.283185307179586);
    const size_t plane = (size_t)d * gx * gy * nq;
    for (int i = threadIdx.x; i < S * S * nq; i += kThreads) {
        const int q = i % nq;
        const int b = i / nq;
        const size_t sq = (size_t)(bx * S + b / S) * gy + (by * S + b % S);
        const T* Lb = L + (size_t)b * r;
        const T* w = Lt + q * lq;
        T far = T(0);
        for (int c = 0; c < r; ++c) {
            far += w[c * lc] * Lb[c];
        }
        out[plane + sq * nq + q] = (far + near[plane + sq * nq + q]) / two_pi;
    }
}

// The launch's dynamic shared memory: the tile, and the weights (4 r^2 +
// r nq values) staged beside it where both fit (*staged = 1).
template <typename Kern>
int prepare(Kern kern, int k, int r, int nq, int item, size_t* smem,
            int* staged) {
    if (k < 0 || k > kMaxK || r < 1 || nq < 0) {
        return (int)cudaErrorInvalidValue;
    }
    *smem = (size_t)weights_at(k, r) * item;
    if (*smem > aniso::kSmemBlock) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t with = *smem + (size_t)(4 * r + nq) * r * item;
    *staged = with <= aniso::kSmemBlock;
    if (*staged) {
        *smem = with;
    }
    // the attribute belongs to the current device: set it every launch
    return (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <typename T>
int launch_up(const void* src, const void* p2m_w, const void* m2m,
              const void* const* outs, int ax, int ay, int r, int nq, int k,
              void* stream) {
    auto kern = transfer_up_kernel<T>;
    size_t smem = 0;
    int staged = 0;
    const int err = prepare(kern, k, r, p2m_w ? nq : 0, (int)sizeof(T),
                            &smem, &staged);
    if (err != 0) {
        return err;
    }
    const int S = 1 << k;
    if (ax < S || ay < S || ax % S || ay % S || (p2m_w && nq < 1)
        || (!p2m_w && k < 1)) {
        return (int)cudaErrorInvalidValue;
    }
    Levels out{};
    for (int j = 0; j < k + (p2m_w ? 1 : 0); ++j) {
        out.p[j] = outs[j];
    }
    const dim3 grid(ax / S, ay / S);
    kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(src), static_cast<const T*>(p2m_w),
        static_cast<const T*>(m2m), out, ax, ay, r, nq, k, staged);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_down(const void* L0, const void* const* Ts, const void* m2m,
                const void* l2t, const void* near, void* out, int ax, int ay,
                int r, int nq, int k, int D, void* stream) {
    auto kern = transfer_down_kernel<T>;
    size_t smem = 0;
    int staged = 0;
    const int err = prepare(kern, k, r, l2t ? nq : 0, (int)sizeof(T), &smem,
                            &staged);
    if (err != 0) {
        return err;
    }
    if (ax < 1 || ay < 1 || D < 1 || D > 65535
        || (long long)ax * ay > 0x7fffffffLL
        || (l2t && (nq < 1 || near == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    Levels lv{};
    for (int j = 0; j < k; ++j) {
        lv.p[j] = Ts[j];
    }
    const dim3 grid(ax * ay, D);
    kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(L0), lv, static_cast<const T*>(m2m),
        static_cast<const T*>(l2t), static_cast<const T*>(near),
        static_cast<T*>(out), ax, ay, r, nq, k, staged);
    return (int)cudaGetLastError();
}

}  // namespace

// Up: one launch of k levels over an (ax, ay) plane at its finest level;
// outs: M of level f (with p2m_w) then f - 1 .. f - k.
extern "C" int aniso_transfer_up_f32(const void* src, const void* p2m_w,
                                     const void* m2m, const void* const* outs,
                                     int ax, int ay, int r, int nq, int k,
                                     void* stream) {
    return launch_up<float>(src, p2m_w, m2m, outs, ax, ay, r, nq, k, stream);
}

extern "C" int aniso_transfer_up_f64(const void* src, const void* p2m_w,
                                     const void* m2m, const void* const* outs,
                                     int ax, int ay, int r, int nq, int k,
                                     void* stream) {
    return launch_up<double>(src, p2m_w, m2m, outs, ax, ay, r, nq, k,
                             stream);
}

// Down: one launch of k levels from an (ax, ay) plane of L0 for D modes;
// Ts: T of the k finer levels; with l2t (and near) the epilogue.
extern "C" int aniso_transfer_down_f32(const void* L0, const void* const* Ts,
                                       const void* m2m, const void* l2t,
                                       const void* near, void* out, int ax,
                                       int ay, int r, int nq, int k, int D,
                                       void* stream) {
    return launch_down<float>(L0, Ts, m2m, l2t, near, out, ax, ay, r, nq, k,
                              D, stream);
}

extern "C" int aniso_transfer_down_f64(const void* L0, const void* const* Ts,
                                       const void* m2m, const void* l2t,
                                       const void* near, void* out, int ax,
                                       int ay, int r, int nq, int k, int D,
                                       void* stream) {
    return launch_down<double>(L0, Ts, m2m, l2t, near, out, ax, ay, r, nq, k,
                               D, stream);
}
