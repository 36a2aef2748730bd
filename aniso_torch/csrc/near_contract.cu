// K2: the near-field contraction of the corrected FMM matvec, float32, for
// sm_90a.
//
// Replaces aniso_tpu/fmm/apply.py:_near_block_contract (:577) with the
// rest of _near_apply (:639-681) and its window extraction _patch_3x3
// (:554).  For every square (i, j) and target node t:
//
//   out[i, j, t] = sum_{a, b, s} (expm1(-E[i, j, t, a, b, s]) * cosrw[t, a, b, s]
//                                 + S[t, a, b, s]) * u[i + a - 1, j + b - 1, s]
//                + sigma_w[i, j, t] * u[i, j, t]            (mode 0 only)
//                + sum_s duffy[i, j, t, s] * u[i, j, s]     (compat mode only)
//
// with u zero off the grid.  sigma_w and duffy are optional (null).
//
// Bound on the H100: bytes.  E is read once, 81 nq floats per square
// (11.9 MB at 64^2, deg 3: ~3.6 us at 3.35 TB/s); u, the tables and the
// output are small.  One block per square stages the zero-padded 3 x 3
// neighbourhood of u in shared memory (no im2col tensor), and each warp
// reduces the 9 nq contiguous floats of E of one target node (layout
// (sz, sz, nq, 3, 3, nq), square major, which set_coeff writes), then adds
// the diagonal and Duffy terms in its epilogue.  expm1f, not expf - 1:
// E is small on near pairs and the difference would cancel.  The library is
// built without fast math.

#include <cuda_runtime.h>

namespace {

__global__ void near_contract_kernel(
    const float* __restrict__ E,        // (sz, sz, nq, 3, 3, nq)
    const float* __restrict__ cosrw,    // (nq, 3, 3, nq)
    const float* __restrict__ S,        // (nq, 3, 3, nq)
    const float* __restrict__ u,        // (sz, sz, nq)
    const float* __restrict__ sigma_w,  // (sz, sz, nq) or null
    const float* __restrict__ duffy,    // (sz, sz, nq, nq) or null
    float* __restrict__ out,            // (sz, sz, nq)
    int sz, int nq) {
    extern __shared__ float un[];       // (3, 3, nq) neighbourhood of u
    const int K = 9 * nq;
    const int i = blockIdx.x / sz;
    const int j = blockIdx.x - i * sz;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
        const int ab = k / nq;
        const int s = k - ab * nq;
        const int ii = i + ab / 3 - 1;
        const int jj = j + ab % 3 - 1;
        float v = 0.0f;
        if (ii >= 0 && ii < sz && jj >= 0 && jj < sz) {
            v = u[((size_t)ii * sz + jj) * nq + s];
        }
        un[k] = v;
    }
    __syncthreads();

    const float* uc = un + 4 * nq;      // the square's own values
    const size_t sq = (size_t)blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int nwarps = blockDim.x >> 5;
    for (int t = warp; t < nq; t += nwarps) {
        const size_t row = (sq * nq + t) * K;
        const float* Et = E + row;
        const float* ct = cosrw + (size_t)t * K;
        const float* st = S + (size_t)t * K;
        float acc = 0.0f;
        for (int k = lane; k < K; k += 32) {
            acc += (expm1f(-Et[k]) * ct[k] + st[k]) * un[k];
        }
        if (duffy != nullptr) {
            const float* dt = duffy + (sq * nq + t) * nq;
            for (int s = lane; s < nq; s += 32) {
                acc += dt[s] * uc[s];
            }
        }
        for (int off = 16; off > 0; off >>= 1) {
            acc += __shfl_down_sync(0xffffffffu, acc, off);
        }
        if (lane == 0) {
            if (sigma_w != nullptr) {
                acc += sigma_w[sq * nq + t] * uc[t];
            }
            out[sq * nq + t] = acc;
        }
    }
}

}  // namespace

extern "C" int aniso_near_contract_f32(
    const void* E, const void* cosrw, const void* S, const void* u,
    const void* sigma_w, const void* duffy, void* out, int sz, int nq,
    void* stream) {
    const int warps = nq < 32 ? nq : 32;
    const size_t smem = (size_t)9 * nq * sizeof(float);
    near_contract_kernel<<<sz * sz, 32 * warps, smem, (cudaStream_t)stream>>>(
        static_cast<const float*>(E), static_cast<const float*>(cosrw),
        static_cast<const float*>(S), static_cast<const float*>(u),
        static_cast<const float*>(sigma_w), static_cast<const float*>(duffy),
        static_cast<float*>(out), sz, nq);
    return (int)cudaGetLastError();
}
