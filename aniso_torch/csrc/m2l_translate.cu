// K1: the fused dense M2L translate of one FMM level, for sm_90a, in two
// instances from one template: float32 (the fast path) and float64 (the
// refinement twin's coarse levels and the plain f64 solve).
//
// Replaces aniso_tpu/fmm/apply.py:_m2l_translate (dense branch, :317-372)
// together with its producer _vlist_gather (:158) and _interleave_classes
// (:230).  For every parity class c = 2px+py and box (x, y) of the level's
// (m2, m2) parity plane:
//
//   L[2x+px, 2y+py, a] = sum_{o, b} exp(-E[c, x, y, a, o, b])
//                                   * cosr[c, a, o, b] * M[src(c, o, x, y), b]
//
// where the source box of V-list offset o is one box away at most on its
// parity plane: src = (2(x + shx) + sx, 2(y + shy) + sy) with
// (sx, sy, shx + 1, shy + 1) = shift[c, o] (parity_shift_table_np), and the
// source is zero when it falls off the plane.
//
// Bound on the H100: bytes.  E is read once per matvec, 4 * r * 27r values
// per box (150.8 MB in f32 over levels 2-6 at 64^2, deg 3, np 4: ~45 us at
// 3.35 TB/s; twice that in f64), against ~0.1 GFLOP of exp and
// multiply-add.  The design reads
// E exactly once, coalesced, and nothing else from device memory at that
// scale: one block per (c, x, y) gathers its 27 x r source multipoles
// straight from M into shared memory (no gsel tensor), then each warp
// reduces whole 27r-value rows of E (contiguous in the layout
// (4, m2, m2, r, 27r) that set_coeff writes) for one target point a at a
// time, and writes the interleaved L directly.  expf / exp, not __expf:
// the library is built without fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOffsets = 27;

__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }

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

    for (int k = threadIdx.x; k < ob; k += blockDim.x) {
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

template <typename T>
int launch(const void* E, const void* cosr, const void* M, const void* shift,
           void* L, int m2, int r, void* stream) {
    const int blocks = 4 * m2 * m2;
    const size_t smem = (size_t)kOffsets * r * sizeof(T);
    m2l_translate_kernel<T><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        static_cast<const T*>(E), static_cast<const T*>(cosr),
        static_cast<const T*>(M), static_cast<const int*>(shift),
        static_cast<T*>(L), m2, r);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aniso_m2l_translate_f32(
    const void* E, const void* cosr, const void* M, const void* shift,
    void* L, int m2, int r, void* stream) {
    return launch<float>(E, cosr, M, shift, L, m2, r, stream);
}

extern "C" int aniso_m2l_translate_f64(
    const void* E, const void* cosr, const void* M, const void* shift,
    void* L, int m2, int r, void* stream) {
    return launch<double>(E, cosr, M, shift, L, m2, r, stream);
}
