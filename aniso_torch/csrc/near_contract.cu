// K2: the near-field contraction of the corrected FMM matvec, for sm_90a,
// float32 (the fast path) and float64 (the refinement twin and the plain
// f64 solve), for one Fourier mode or for all D modes of one charge at
// once, on the whole grid or on one shard (K2-S), all from one template.
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
// K2-S, K2 on one shard of a domain decomposition (the kShard instances):
// replaces the contraction of aniso_tpu/parallel/halo.py:
// make_near_apply_shardmap (:56, body :70-81).  The grid is the shard's
// (lx, ly) block of squares, with its contiguous slices of E, sigma_w and
// duffy, and u comes halo-extended by one square on each side, (lx + 2,
// ly + 2, nq), filled by K10 (csrc/halo_fill.cu): the window load reads it
// with no bounds test.
//
// Bound on the H100: bytes.  E, (nx, ny, nq, 3, 3, nq) square major as
// set_coeff writes it, is read once per charge whatever D is (764 MB in
// f32 at 512^2, deg 3: 0.23 ms at 3.35 TB/s); u, the tables and the D
// outputs are small.  Per value of E the work is one expm1 and 2 D
// multiply-adds, so the issue rate and the reads of the mode tables are
// what keeps a kernel from that bound.  The design:
//
//   * One thread per target row t and square: a warp is one target row of
//     32 neighbouring squares (a lane a square), so every table value a
//     warp reads is the same for its 32 lanes, one broadcast from shared
//     memory.  A thread holds its D sums in registers and takes one expm1
//     per value of E.  No shuffle reduction: a thread owns its row's sums.
//   * A block stages the mode tables cosrw and S of its target rows (and
//     of its modes) in shared memory once and is persistent: it walks the
//     tiles blockIdx.x, blockIdx.x + gridDim.x, ... of 32 NG squares (NG
//     groups of 32, TR rows: 32 TR NG threads).  No table value is read
//     from device memory per value of E; a table vector (16 bytes: 4 f32
//     or 2 f64 values of k) serves W values.
//   * E streams through a ring in shared memory in chunks of KC values of
//     k (three stages for one mode, two for several: ring_stages): the
//     warp of row t copies that row's runs of its 32 squares with 16-byte
//     cp.async pieces from the 16-byte boundary below each run (a run
//     keeps its offset modulo 16; run_at places the runs so that a warp's
//     reads at one k hit 32 banks), and the block copies the 3 x 3 windows
//     of u element by element (zero fill off the grid and past k = 9 nq,
//     where the tables are zero too).  One barrier a stage.
//   * Where the tables of every target row do not fit with the ring
//     (2 D nq 9 nq itemsize: 332 KB in f64 at nq 16, D 9), the target rows
//     are split over blocks (grid y), each staging only its rows' tables;
//     the host plan picks the row split, KC and NG.
//   * The mode count is compiled (D = 1, 3, 5, 7, 9: DC); any other D runs
//     the DC = 9 instance whose multiply-adds carry a predicate, with the
//     modes split over blocks (grid z, up to 9 modes a block): that
//     instance reads E once per block of modes.
//   * The sigma_w and Duffy terms are the epilogue of a square's rows.
// On an H100 at 512^2 this design takes 1.07 ms for D = 9 in f32 (the
// earlier one-block-a-square kernel 3.5) and 0.85 ms for one mode (0.81):
// the copies into the ring, not the tables, hold it (PERF.md, with
// the designs tried on the way).
// expm1f / expm1, not exp - 1: E is small on near pairs and the difference
// would cancel.  The library is built without fast math.

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kModeChunk = 9;   // modes a block of the runtime-D instance
constexpr int kSmemPerSm = 233472;   // the H100's 228 KB a multiprocessor

// The ring's stages, one fewer in flight: three for one mode, two where a
// stage's copies serve several modes' sums (measured on an H100 with
// `tools/kernel_ab.py --variants k2`, PERF.md).
__host__ __device__ constexpr int ring_stages(int DC) {
    return DC == 1 ? 3 : 2;
}

__device__ __forceinline__ float expm1_(float v) { return expm1f(v); }
__device__ __forceinline__ double expm1_(double v) { return expm1(v); }

template <typename T>
struct Vec;
template <>
struct Vec<float> {
    using V = float4;
    static constexpr int W = 4;
    __device__ static void get(const V& v, float* o) {
        o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
    }
};
template <>
struct Vec<double> {
    using V = double2;
    static constexpr int W = 2;
    __device__ static void get(const V& v, double* o) {
        o[0] = v.x; o[1] = v.y;
    }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src));
}

// N bytes (4 or 8), or N zero bytes when !valid (src is then not read)
template <int N>
__device__ __forceinline__ void cp_async_el(void* dst, const void* src,
                                            bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "n"(N),
                    "r"(valid ? N : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// all but the newest kSt - 2 groups have landed
template <int kSt>
__device__ __forceinline__ void cp_async_wait_ring() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kSt - 2));
}

// The launch's cut of the work, from plan() on the host.
struct Plan {
    int nx, ny, nq, K;   // squares (nx, ny), nq nodes a square, K = 9 nq
    int D;               // modes in the output
    int mpb;             // modes a block (grid z = ceil(D / mpb))
    int TR;              // target rows a block (grid y = ceil(nq / TR))
    int NG;              // groups of 32 squares a tile: 32 TR NG threads
    int SLOT, lgL;       // elements of a square's run in the ring, W 2^lgL
    int KC, nchunks;     // chunk of k (KC = SLOT - W), chunks = ceil(K / KC)
    int tiles;           // ceil(nx ny / (32 NG))
    int stages;          // of the ring, ring_stages(DC)
    size_t smem;         // dynamic shared memory
    size_t nE;           // elements of E
};

// Shared memory: the tables (2, mpb, TR, KP = nchunks KC), then the ring
// of P.stages stages, each E (TR rows of 32 NG runs: 32 NG (SLOT + 1)
// elements, see run_at) and u (32 NG, KC + 1), then the window position of
// each k (two tables of KP ints, pos and uoff).
__host__ __device__ inline size_t table_elems(const Plan& P) {
    return (size_t)P.mpb * P.TR * P.nchunks * P.KC;
}

__host__ __device__ inline size_t stage_elems(const Plan& P) {
    return (size_t)32 * P.NG * (P.TR * (P.SLOT + 1) + P.KC + 1);
}

// Where the run of square q (0 .. 32 NG - 1 in a tile) starts in its row's
// region: q SLOT + W (q / W) elements.  A run keeps its source's offset
// modulo W (pad < W), so lane q of a warp reads element k at run_at(q) +
// pad(q) + k.  In 16-byte units the run of lane q = r + W m starts at
// r SLOT / W + m (SLOT + 1), SLOT + 1 odd: the 8 lanes of one r fall in
// the 8 different 16-byte bank groups, and with the pads of W consecutive
// squares all different (nq odd: a square holds an odd number of values)
// the 32 lanes (a half-warp's 16 in f64) hit 32 different banks.
template <int W>
__device__ __forceinline__ int run_at(int q, int slot) {
    return q * slot + W * (q / W);
}

template <typename T>
__host__ __device__ inline size_t smem_bytes(const Plan& P) {
    return (2 * table_elems(P) + P.stages * stage_elems(P)) * sizeof(T)
        + 2 * (size_t)P.nchunks * P.KC * sizeof(int);
}

// Queue the copies of stage (tile, chunk c) into `buf`: the warp of row
// (tl, group ng) copies its row of E for its 32 squares, the block the
// windows of u.  For k = (a, b, s): pos[k] = 1 << a | 8 << b (0 past K),
// uoff[k] the offset of its value of u from the square's first.
template <typename T, bool kShard>
__device__ __forceinline__ void issue_stage(
    T* buf, const T* __restrict__ E, const T* __restrict__ u,
    const int* pos, const int* uoff, const Plan& P, int tile, int c, int t0,
    int tl, int ng, int lane) {
    const int nsq = P.nx * P.ny;
    const int NS = 32 * P.NG;
    const int sq0 = tile * NS;
    const int kc0 = c * P.KC;
    const int t = t0 + tl;
    constexpr int W = Vec<T>::W;
    if (t < P.nq) {
        // L lanes a run (L = SLOT / W, a power of two): lane piece v of
        // the runs of squares q0 + lane / L, q0 + lane / L + 32 / L, ...:
        // 16-byte pieces from the aligned one holding the run's first
        // value; a piece past the end of E goes by element
        T* row = buf + (size_t)tl * NS * (P.SLOT + 1);
        const int len = min(P.KC, P.K - kc0);
        const int v = lane & ((1 << P.lgL) - 1);
        const int step = 32 >> P.lgL;
        const int q0 = ng * 32;
        const size_t dat = (size_t)step * P.nq * P.K;
        size_t at = ((size_t)(sq0 + q0 + (lane >> P.lgL)) * P.nq + t) * P.K
            + kc0;
        for (int q = q0 + (lane >> P.lgL); q < q0 + 32 && sq0 + q < nsq;
             q += step, at += dat) {
            const int pad = (int)(at % W);
            if (v * W >= pad + len) {
                continue;
            }
            const size_t from = at - pad + (size_t)v * W;
            T* dst = row + run_at<W>(q, P.SLOT) + v * W;
            if (from + W <= P.nE) {
                cp_async16(dst, E + from);
            } else {
                for (int w = 0; from + w < P.nE; ++w) {
                    cp_async_el<(int)sizeof(T)>(dst + w, E + from + w, true);
                }
            }
        }
    }
    // the windows of u: a warp a square at a time, its lanes along k; the
    // offset of k's value from the square's own (uoff) and which window
    // row and column it lies in (pos: 1 << a | 8 << b) come from tables
    const int stride = P.KC + 1;
    T* ub = buf + (size_t)P.TR * NS * (P.SLOT + 1);
    const int nwarps = blockDim.x >> 5;
    for (int q = threadIdx.x >> 5; q < NS; q += nwarps) {
        const int sq = sq0 + q;
        const int i = sq / P.ny;
        const int j = sq - i * P.ny;
        const T* base;
        int forbid = 0;
        if constexpr (kShard) {
            base = u + ((size_t)i * (P.ny + 2) + j) * P.nq;
        } else {
            base = u + (size_t)sq * P.nq;
            forbid = (i == 0 ? 1 : 0) | (i == P.nx - 1 ? 4 : 0)
                | (j == 0 ? 8 : 0) | (j == P.ny - 1 ? 32 : 0);
        }
        for (int kk = lane; kk < P.KC; kk += 32) {
            const int code = pos[kc0 + kk];
            const bool valid = code != 0 && (code & forbid) == 0 && sq < nsq;
            cp_async_el<(int)sizeof(T)>(ub + q * stride + kk,
                                        valid ? base + uoff[kc0 + kk] : u,
                                        valid);
        }
    }
}

// The grid: (persistent tile walkers, row groups, mode blocks).  DC: the
// modes of a block, compiled; kPred: the runtime-D instance (DC = 9, the
// block's modes nd <= 9 as a predicate).
template <typename T, int DC, bool kPred, bool kShard>
__global__ void __launch_bounds__(kMaxThreads) near_contract_kernel(
    const T* __restrict__ E,            // (nx, ny, nq, 3, 3, nq)
    const T* __restrict__ cosrw,        // (D, nq, 3, 3, nq)
    const T* __restrict__ S,            // (D, nq, 3, 3, nq)
    const T* __restrict__ u,            // (nx, ny, nq), or extended
    const T* __restrict__ sigma_w,      // (nx, ny, nq) or null
    const T* __restrict__ duffy,        // (D, nx, ny, nq, nq) or null
    T* __restrict__ out,                // (D, nx, ny, nq)
    const Plan P) {
    using VT = Vec<T>;
    using V = typename VT::V;
    constexpr int W = VT::W;
    constexpr int kStages = ring_stages(DC);
    extern __shared__ __align__(16) unsigned char smem[];
    const int NS = 32 * P.NG;
    const int KP = P.nchunks * P.KC;
    const int t0 = blockIdx.y * P.TR;
    const int d0 = blockIdx.z * P.mpb;
    const int nd = kPred ? min(P.mpb, P.D - d0) : DC;
    const int nsq = P.nx * P.ny;

    // the tables of the block's rows and modes, zero past k = K, rows past
    // nq and modes past nd
    T* ct = reinterpret_cast<T*>(smem);
    const int tab = (int)table_elems(P);
    T* st = ct + tab;
    for (int idx = threadIdx.x; idx < tab; idx += blockDim.x) {
        const int d = idx / (P.TR * KP);
        const int rem = idx - d * P.TR * KP;
        const int tl = rem / KP;
        const int k = rem - tl * KP;
        T cv = 0, sv = 0;
        if (d < nd && t0 + tl < P.nq && k < P.K) {
            const size_t at = ((size_t)(d0 + d) * P.nq + t0 + tl) * P.K + k;
            cv = cosrw[at];
            sv = S[at];
        }
        ct[idx] = cv;
        st[idx] = sv;
    }
    T* ring = st + tab;
    const size_t sel = stage_elems(P);
    int* pos = reinterpret_cast<int*>(ring + kStages * sel);
    int* uoff = pos + KP;
    // values of a run past its end are summed against zero tables and
    // zero u: they must be finite, never uninitialized memory
    for (size_t x = threadIdx.x; x < kStages * sel; x += blockDim.x) {
        ring[x] = T(0);
    }
    for (int k = threadIdx.x; k < KP; k += blockDim.x) {
        const int ab = k / P.nq;
        const int a = ab / 3, b = ab % 3, x = k - ab * P.nq;
        pos[k] = k < P.K ? (1 << a) | (8 << b) : 0;
        uoff[k] = kShard ? (a * (P.ny + 2) + b) * P.nq + x
                         : ((a - 1) * P.ny + b - 1) * P.nq + x;
    }
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int tl = warp % P.TR;
    const int ng = warp / P.TR;
    const int t = t0 + tl;
    const int q = ng * 32 + lane;       // the lane's square in a tile
    const int stride = P.KC + 1;
    const int erun = run_at<W>(q, P.SLOT);
    const int my_tiles = blockIdx.x < P.tiles
        ? (P.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const int nstages = my_tiles * P.nchunks;
    const T* ctl = ct + tl * KP;
    const T* stl = st + tl * KP;
    const int mstride = P.TR * KP;

    for (int s = 0; s < kStages - 1; ++s) {
        if (s < nstages) {
            issue_stage<T, kShard>(ring + s * sel, E, u, pos, uoff, P,
                                   blockIdx.x + (s / P.nchunks) * gridDim.x,
                                   s % P.nchunks, t0, tl, ng, lane);
        }
        cp_async_commit();
    }
    T acc[DC];
    for (int s = 0; s < nstages; ++s) {
        const int tile = blockIdx.x + (s / P.nchunks) * gridDim.x;
        const int c = s % P.nchunks;
        // stage s has landed for every thread, and every thread is done
        // with stage s - 1, whose buffer stage s + kStages - 1 takes
        cp_async_wait_ring<kStages>();
        __syncthreads();
        const int s1 = s + kStages - 1;
        if (s1 < nstages) {
            issue_stage<T, kShard>(ring + (s1 % kStages) * sel, E, u, pos,
                                   uoff, P,
                                   blockIdx.x + (s1 / P.nchunks) * gridDim.x,
                                   s1 % P.nchunks, t0, tl, ng, lane);
        }
        cp_async_commit();
        if (t >= P.nq) {
            continue;
        }
        const T* buf = ring + (s % kStages) * sel;
        const int kc0 = c * P.KC;
        const int pad = (int)(((((size_t)tile * NS + q) * P.nq + t) * P.K
                               + kc0) % W);
        const T* er = buf + (size_t)tl * NS * (P.SLOT + 1) + erun + pad;
        const T* ur = buf + (size_t)P.TR * NS * (P.SLOT + 1) + q * stride;
        if (c == 0) {
#pragma unroll
            for (int d = 0; d < DC; ++d) {
                acc[d] = T(0);
            }
        }
        const T* cb = ctl + kc0;
        const T* sb = stl + kc0;
        for (int k = 0; k < P.KC; k += W) {
            T e[W], uu[W];
#pragma unroll
            for (int w = 0; w < W; ++w) {
                e[w] = expm1_(-er[k + w]);
                uu[w] = ur[k + w];
            }
#pragma unroll
            for (int d = 0; d < DC; ++d) {
                if (kPred && d >= nd) {
                    break;
                }
                T cv[W], sv[W];
                VT::get(*reinterpret_cast<const V*>(cb + d * mstride + k), cv);
                VT::get(*reinterpret_cast<const V*>(sb + d * mstride + k), sv);
#pragma unroll
                for (int w = 0; w < W; ++w) {
                    acc[d] += (e[w] * cv[w] + sv[w]) * uu[w];
                }
            }
        }
        const int sq = tile * NS + q;
        if (c == P.nchunks - 1 && sq < nsq) {
            // the epilogue: the Duffy term, the diagonal on mode 0, the store
            const T* uc;
            if constexpr (kShard) {
                const int i = sq / P.ny;
                const int j = sq - i * P.ny;
                uc = u + ((size_t)(i + 1) * (P.ny + 2) + j + 1) * P.nq;
            } else {
                uc = u + (size_t)sq * P.nq;
            }
#pragma unroll
            for (int d = 0; d < DC; ++d) {
                if (kPred && d >= nd) {
                    break;
                }
                const size_t at = ((size_t)(d0 + d) * nsq + sq) * P.nq + t;
                T v = acc[d];
                if (duffy != nullptr) {
                    const T* dr = duffy + at * P.nq;
                    for (int x = 0; x < P.nq; ++x) {
                        v += dr[x] * uc[x];
                    }
                }
                if (sigma_w != nullptr && d0 + d == 0) {
                    v += sigma_w[(size_t)sq * P.nq + t] * uc[t];
                }
                out[at] = v;
            }
        }
    }
}

// The score of a cut: resident warps an SM, less 8 for each extra block
// of target rows (each copies the windows of u again), and runs under 64
// bytes only where nothing else fits.  Ties go to the first cut found:
// fewer row blocks, shorter runs, fewer groups.
inline double plan_score(int warps, int ns, int slot_bytes) {
    return warps - 8.0 * (ns - 1) - (slot_bytes < 64 ? 1000.0 : 0.0);
}

// The cut of the work for a launch: target rows a block TR (split where
// the tables do not fit), the run length SLOT (KC = SLOT - W values of k a
// stage) and the groups NG of 32 squares, by plan_score; NG no larger than
// fills every SM with a tile.  False if nothing fits.  Each rule was held
// against its absence on an H100 (tools/kernel_ab.py, PERF.md).
template <typename T>
bool plan(Plan* out, int nx, int ny, int nq, int D, int mpb, int stages,
          int nsm, size_t smem_max) {
    constexpr int W = 16 / (int)sizeof(T);
    const int K = 9 * nq;
    const long nsq = (long)nx * ny;
    const long ngfill = nsq / (32L * nsm);
    double best = -1e9;
    for (int ns = 1; ns <= nq; ++ns) {
        const int TR = (nq + ns - 1) / ns;
        if ((ns > 1 && (nq + ns - 2) / (ns - 1) == TR) || TR > 32) {
            continue;
        }
        for (int lgL = 1; (W << lgL) <= 64; ++lgL) {
            const int SLOT = W << lgL;
            const int KC = SLOT - W;
            if (lgL > 1 && SLOT / 2 - W >= K) {
                continue;
            }
            const int nchunks = (K + KC - 1) / KC;
            for (int NG = 1; 32 * NG * TR <= kMaxThreads; ++NG) {
                if (NG > 1 && NG > ngfill) {
                    break;
                }
                Plan P{nx, ny, nq, K, D, mpb, TR, NG, SLOT, lgL, KC, nchunks,
                       0, stages, 0, (size_t)nsq * nq * K};
                const size_t smem = smem_bytes<T>(P);
                if (smem > smem_max) {
                    break;
                }
                int blocks = (int)(kSmemPerSm / (smem + 1024));
                const int warps_block = TR * NG;
                blocks = blocks < 64 / warps_block ? blocks : 64 / warps_block;
                if (blocks < 1) {
                    continue;
                }
                const double score = plan_score(blocks * warps_block, ns,
                                                SLOT * (int)sizeof(T));
                if (score > best) {
                    best = score;
                    P.tiles = (int)((nsq + 32L * NG - 1) / (32L * NG));
                    P.smem = smem;
                    *out = P;
                }
            }
        }
    }
    return best > -1e9;
}

// A launch's plan and grid, made once per device and shape for each
// instance.
struct Launch {
    Plan P;
    dim3 grid;
    int threads;
};

template <typename T, int DC, bool kPred, bool kShard>
cudaError_t make_launch(Launch* L, int dev, int nx, int ny, int nq, int D) {
    int nsm = 0, optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (err != cudaSuccess) {
        return err;
    }
    // the runtime-D instance takes blocks of 9 modes, fewer where the
    // tables of one row would not fit
    Plan& P = L->P;
    bool ok = false;
    for (int mpb = kPred ? kModeChunk : DC; mpb >= 1 && !ok;
         mpb = kPred ? mpb - 1 : 0) {
        ok = plan<T>(&P, nx, ny, nq, D, kPred ? (mpb < D ? mpb : D) : DC,
                     ring_stages(DC), nsm, (size_t)optin);
    }
    if (!ok) {
        return cudaErrorInvalidConfiguration;
    }
    auto kernel = near_contract_kernel<T, DC, kPred, kShard>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.smem);
    L->threads = 32 * P.TR * P.NG;
    int per_sm = 0;
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, L->threads, P.smem);
    }
    if (err != cudaSuccess) {
        return err;
    }
    if (per_sm < 1) {
        return cudaErrorInvalidConfiguration;
    }
    const int gy = (nq + P.TR - 1) / P.TR;
    const int gz = (D + P.mpb - 1) / P.mpb;
    const long want = ((long)per_sm * nsm + gy * gz - 1) / (gy * gz);
    L->grid = dim3((unsigned)(want < P.tiles ? want : P.tiles), gy, gz);
    return cudaSuccess;
}

template <typename T, int DC, bool kPred, bool kShard>
int launch_dc(const void* E, const void* cosrw, const void* S, const void* u,
              const void* sigma_w, const void* duffy, void* out, int nx,
              int ny, int nq, int D, cudaStream_t stream) {
    static std::mutex mu;
    static std::map<std::tuple<int, int, int, int, int>, Launch> made;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) {
        return (int)err;
    }
    const auto key = std::make_tuple(dev, nx, ny, nq, D);
    Launch L;
    {
        std::lock_guard<std::mutex> hold(mu);
        auto it = made.find(key);
        if (it == made.end()) {
            err = make_launch<T, DC, kPred, kShard>(&L, dev, nx, ny, nq, D);
            if (err != cudaSuccess) {
                return (int)err;
            }
            it = made.emplace(key, L).first;
        }
        L = it->second;
    }
    // the shared-memory attribute on every launch, cached plan or not
    auto kernel = near_contract_kernel<T, DC, kPred, kShard>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.P.smem);
    if (err != cudaSuccess) {
        return (int)err;
    }
    kernel<<<L.grid, L.threads, L.P.smem, stream>>>(
        static_cast<const T*>(E), static_cast<const T*>(cosrw),
        static_cast<const T*>(S), static_cast<const T*>(u),
        static_cast<const T*>(sigma_w), static_cast<const T*>(duffy),
        static_cast<T*>(out), L.P);
    return (int)cudaGetLastError();
}

template <typename T, bool kShard>
int launch(const void* E, const void* cosrw, const void* S, const void* u,
           const void* sigma_w, const void* duffy, void* out, int nx,
           int ny, int nq, int D, void* stream) {
    const cudaStream_t st = (cudaStream_t)stream;
    if (nx < 1 || ny < 1 || nq < 1 || D < 1) {
        return (int)cudaErrorInvalidValue;
    }
#define ANISO_K2_D(DV)                                                      \
    case DV:                                                                \
        return launch_dc<T, DV, false, kShard>(E, cosrw, S, u, sigma_w,     \
                                               duffy, out, nx, ny, nq, D,   \
                                               st);
    switch (D) {
        ANISO_K2_D(1)
        ANISO_K2_D(3)
        ANISO_K2_D(5)
        ANISO_K2_D(7)
        ANISO_K2_D(9)
        default:
            return launch_dc<T, kModeChunk, true, kShard>(
                E, cosrw, S, u, sigma_w, duffy, out, nx, ny, nq, D, st);
    }
#undef ANISO_K2_D
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
