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
// TB/s).
// A copy has no arithmetic.  The shards' tables (up to kMaxShards a launch)
// travel as a kernel parameter, so a launch needs no table copy of its own;
// blockIdx.y is the shard, and the threads of the grid's x dimension stride
// over the shard's extended block in 16-byte vectors where q values fill
// whole vectors and every region's rows start on 16 bytes (the wrapper
// checks), one value a thread otherwise.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 16;
constexpr int kThreads = 256;

struct HaloTable {
    const void* src[kMaxShards][9];   // region (a, b) at 3 a + b, or null
    long long row[kMaxShards][9];     // its row stride, in values
    void* out[kMaxShards];
};

template <typename T, int VW> struct Vec { using V = T; };
template <> struct Vec<float, 4> { using V = float4; };
template <> struct Vec<double, 2> { using V = double2; };

// One shard's extended block per blockIdx.y, in vectors of VW values:
// lx + 2w rows of (ly + 2w) q / VW vectors each.
template <typename T, int VW>
__global__ void __launch_bounds__(kThreads) halo_fill_kernel(
    const HaloTable tab, int lx, int ly, int q, int w) {
    using V = typename Vec<T, VW>::V;
    const int s = blockIdx.y;
    const long long qv = q / VW;                  // vectors a square
    const long long row_len = (long long)(ly + 2 * w) * qv;
    const long long total = (long long)(lx + 2 * w) * row_len;
    const long long wq = (long long)w * qv;
    const long long lyq = (long long)ly * qv;
    V* out = static_cast<V*>(tab.out[s]);
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         e < total; e += (long long)gridDim.x * blockDim.x) {
        const int X = (int)(e / row_len);
        const long long Y = e - (long long)X * row_len;
        const int a = X < w ? 0 : (X < w + lx ? 1 : 2);
        const int i = X - (a == 0 ? 0 : (a == 1 ? w : w + lx));
        const int b = Y < wq ? 0 : (Y < wq + lyq ? 1 : 2);
        const long long j = Y - (b == 0 ? 0 : (b == 1 ? wq : wq + lyq));
        const V* src = static_cast<const V*>(tab.src[s][3 * a + b]);
        V v{};
        if (src != nullptr) {
            v = src[(long long)i * (tab.row[s][3 * a + b] / VW) + j];
        }
        out[e] = v;
    }
}

template <typename T>
int launch(const long long* table, int n, int lx, int ly, int q, int w,
           int vec, void* stream) {
    if (n < 1 || n > kMaxShards) {
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
    const int vw = vec ? 16 / (int)sizeof(T) : 1;
    const long long total =
        (long long)(lx + 2 * w) * (ly + 2 * w) * q / vw;
    long long blocks = (total + kThreads - 1) / kThreads;
    if (blocks > 1024) {
        blocks = 1024;
    }
    const dim3 grid((unsigned)blocks, (unsigned)n);
    const cudaStream_t st = (cudaStream_t)stream;
    if (vec) {
        halo_fill_kernel<T, 16 / sizeof(T)><<<grid, kThreads, 0, st>>>(
            tab, lx, ly, q, w);
    } else {
        halo_fill_kernel<T, 1><<<grid, kThreads, 0, st>>>(tab, lx, ly, q, w);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aniso_halo_fill_f32(const long long* table, int n, int lx,
                                   int ly, int q, int w, int vec,
                                   void* stream) {
    return launch<float>(table, n, lx, ly, q, w, vec, stream);
}

extern "C" int aniso_halo_fill_f64(const long long* table, int n, int lx,
                                   int ly, int q, int w, int vec,
                                   void* stream) {
    return launch<double>(table, n, lx, ly, q, w, vec, stream);
}
