// K10: the halo fill of domain decomposition, for sm_90a, in two instances
// from one template: float32 and float64.
//
// Replaces aniso_tpu/parallel/halo.py:halo_exchange_1 (:30), applied along x
// and then y, the `lax.ppermute` exchange that halo-extends a shard's block
// before the shard-local near contraction (:56, body :70-81) and the
// shard-local fine M2L translate (:106, body :135-170).  For every shard of
// one device, one launch writes the halo-extended block
//
//   out (lx + 2w, ly + 2w, q),  out[X, Y, t] = region(a, b)[i, j, t]
//
// where a = 0 / 1 / 2 as X lies in the low halo [0, w), the interior
// [w, w + lx) or the high halo, i the row inside that part, and b, j the
// same along Y.  Region (1, 1) is the shard's own block, the other eight its
// neighbours' edge slabs and corners; a region with no source (off the
// global grid) is zeros, as the zero padding of the one-device stencil.  A
// region is a pointer and a row stride: a view into a neighbour's block on
// the same device, or a receive buffer the wrapper filled by
// torch.distributed P2P (collectives stay outside the kernel).  The columns
// of a region are q values apart, its values contiguous.
//
// w = 1 square for the field u (the near field's 3 x 3 windows), w = 2 boxes
// for the multipoles M of a fine level (one parent box on each of the four
// parity planes, the V list's reach).
//
// Bound on the H100: bytes, the extended blocks written once and what they
// copy read once (u at 512^2 in f32 on 8 shards: 19.2 MB, 5.7 us at 3.35
// TB/s).  A copy has no arithmetic, so the design keeps the integer work
// off the values and enough loads in flight:
//   * the unit is a run: one output row X of one region column b, w or ly
//     squares x q values, contiguous in the region and in the output.  The
//     runs of all shards are one flat 32-bit index space, (shard, X, b);
//     each output row gets one warp for each of its two halo runs and WL
//     warps for its interior run (WL from the run's length), and a warp
//     finds its run with two 32-bit divisions: no division or 64-bit
//     arithmetic per value;
//   * a run is copied in 16-byte words where its source and destination lie
//     alike modulo 16, else in 8-byte words where they lie alike modulo 8,
//     else value by value, kUnroll words in flight a lane; the head up to
//     the destination's first word boundary and the tail go value by
//     value.  A run with no source is stored as zeros, loads none;
//   * the shards' tables (up to kMaxShards a launch) travel as a
//     __grid_constant__ kernel parameter: no table copy, no local copy.
// On an H100 80GB HBM3 at 700 W, u in f32 takes 0.0147 ms (the old kernel
// 0.0213, a Tensor.copy_ of its bytes 0.0156) and the leaf's M 0.0186
// (0.0189); in f64 the leaf's M is 3% slower than the old kernel
// (PERF.md, the K10 rows of §6).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;        // words in flight a lane
constexpr int kMaxInterior = 8;   // warps on an interior run, at most

struct HaloTable {
    const void* src[kMaxShards][9];   // region (a, b) at 3 a + b, or null
    long long row[kMaxShards][9];     // its row stride, in values
    void* out[kMaxShards];
};

template <typename T> struct Words;
template <> struct Words<float> {
    using W16 = float4;
    using W8 = float2;
};
template <> struct Words<double> {
    using W16 = double2;
    using W8 = double;
};

// n values of T from src (zeros where src is null) to dst by the nt threads
// t = 0 .. nt - 1 of a run, in words W from dst's first W boundary
template <typename W, typename T>
__device__ __forceinline__ void copy_run(T* __restrict__ dst,
                                         const T* __restrict__ src, int n,
                                         int t, int nt) {
    constexpr int k = sizeof(W) / sizeof(T);
    const int mis = (int)(reinterpret_cast<size_t>(dst) % sizeof(W));
    const int head =
        min(n, (int)((sizeof(W) - mis) % sizeof(W)) / (int)sizeof(T));
    const int nw = (n - head) / k;
    const int done = head + nw * k;
    W* dw = reinterpret_cast<W*>(dst + head);
    if (src == nullptr) {
        if (t < head) {
            dst[t] = T(0);
        }
        for (int i = t; i < nw; i += nt) {
            dw[i] = W{};
        }
        if (t < n - done) {
            dst[done + t] = T(0);
        }
        return;
    }
    if (t < head) {
        dst[t] = src[t];
    }
    const W* sw = reinterpret_cast<const W*>(src + head);
    int i = t;
    for (; i + (kUnroll - 1) * nt < nw; i += kUnroll * nt) {
        W v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            v[u] = sw[i + u * nt];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            dw[i + u * nt] = v[u];
        }
    }
    for (; i < nw; i += nt) {
        dw[i] = sw[i];
    }
    if (t < n - done) {
        dst[done + t] = src[done + t];
    }
}

// One warp a halo run and wl warps an interior run: output row (s, X) has
// warps 2 + wl; its warp 0 takes run b = 0, warp 1 run b = 2, the others
// run b = 1.
template <typename T>
__global__ void __launch_bounds__(kThreads) halo_fill_kernel(
    const __grid_constant__ HaloTable tab, int n, int lx, int ly, int q,
    int w, int wl) {
    const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    const int rows = lx + 2 * w;
    const int rowid = warp / (2 + wl);
    if (rowid >= n * rows) {
        return;
    }
    const int j = warp - rowid * (2 + wl);
    const int s = rowid / rows;
    const int X = rowid - s * rows;
    const int b = j == 0 ? 0 : (j == 1 ? 2 : 1);
    const int t = b == 1 ? (j - 2) * 32 + lane : lane;
    const int nt = b == 1 ? 32 * wl : 32;
    const int a = X < w ? 0 : (X < w + lx ? 1 : 2);
    const int i = X - (a == 0 ? 0 : (a == 1 ? w : w + lx));
    const int y0 = b == 0 ? 0 : (b == 1 ? w : w + ly);
    const int len = (b == 1 ? ly : w) * q;
    T* dst = static_cast<T*>(tab.out[s])
             + ((size_t)X * (ly + 2 * w) + y0) * q;
    const T* src = static_cast<const T*>(tab.src[s][3 * a + b]);
    if (src != nullptr) {
        src += (size_t)i * tab.row[s][3 * a + b];
    }
    const size_t rel = reinterpret_cast<size_t>(src)
                       ^ reinterpret_cast<size_t>(dst);
    if (src == nullptr || rel % 16 == 0) {
        copy_run<typename Words<T>::W16>(dst, src, len, t, nt);
    } else if (rel % 8 == 0) {
        copy_run<typename Words<T>::W8>(dst, src, len, t, nt);
    } else {
        copy_run<T>(dst, src, len, t, nt);
    }
}

template <typename T>
int launch(const long long* table, int n, int lx, int ly, int q, int w,
           void* stream) {
    if (n < 1 || n > kMaxShards || lx < 1 || ly < 1 || q < 1 || w < 1) {
        return (int)cudaErrorInvalidValue;
    }
    // table: per shard the out pointer, the 9 region pointers and the 9
    // row strides
    HaloTable tab = {};
    for (int s = 0; s < n; ++s) {
        const long long* t = table + 19 * s;
        tab.out[s] = reinterpret_cast<void*>(t[0]);
        for (int k = 0; k < 9; ++k) {
            tab.src[s][k] = reinterpret_cast<const void*>(t[1 + k]);
            tab.row[s][k] = t[10 + k];
        }
    }
    // an interior run's warps: one for each 2 x 32 x kUnroll values (a
    // lane walks it in two rounds of single values, or in one of 16-byte
    // words: sized by words, half the warps, the w = 2 rows ran 7-10%
    // slower on an H100, PERF.md)
    const long long len = (long long)ly * q;
    long long wl = (len + 2 * 32 * kUnroll - 1) / (2 * 32 * kUnroll);
    wl = wl < 1 ? 1 : (wl > kMaxInterior ? kMaxInterior : wl);
    const long long warps = (long long)n * (lx + 2 * w) * (2 + wl);
    if (warps * 32 > 0x7fffffffLL || len > 0x7fffffffLL) {
        return (int)cudaErrorInvalidValue;
    }
    const unsigned blocks = (unsigned)((warps + kWarps - 1) / kWarps);
    halo_fill_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        tab, n, lx, ly, q, w, (int)wl);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aniso_halo_fill_f32(const long long* table, int n, int lx,
                                   int ly, int q, int w, void* stream) {
    return launch<float>(table, n, lx, ly, q, w, stream);
}

extern "C" int aniso_halo_fill_f64(const long long* table, int n, int lx,
                                   int ly, int q, int w, void* stream) {
    return launch<double>(table, n, lx, ly, q, w, stream);
}
