// K9: the Jacobi-preconditioned CG of the DSA preconditioner, the whole
// loop in one launch, for sm_90a, in three instances from one template
// each: float32 and float64.
//
// Replaces aniso_tpu/solver/dsa.py:pcg (:114-141), which the JAX package
// runs as one lax.while_loop on the device with its stopping test there too
// (:126-128), and the diffusion stencil inside it (make_diffusion_apply
// :85-99; diffusion_stencil.cuh's apply_cell, as K9d runs it).  In the JAX
// order, with every dot product summed in the field's type:
//
//   inv_diag = 1 / diag;  bnorm2 = b.b, taken as 1 where it is 0
//   x = 0, r = b, z = inv_diag r, p = z, rz = r.z
//   while k < max_iter and r.r > tol^2 bnorm2:
//       Ap = A p;  alpha = rz / p.Ap
//       x += alpha p;  r -= alpha Ap;  z = inv_diag r;  rz' = r.z
//       p = z + (rz' / rz) p;  rz = rz';  k += 1
//
// and writes x and k.  Nothing is read back to the host inside the call.
// Every elementwise product, sum and difference is rounded on its own
// (diffusion_stencil.cuh's add / sub / mul: no fused multiply-add), as the
// plain version's separate PyTorch operations round them; only the order
// of the dot products' sums differs.
//
// Bound on the H100: with the state in registers an iteration moves only p
// (written once, read once with its neighbours) and the blocks' partial
// sums: 2 * 4 * sz^2 bytes in f32, 0.13 MB at 128^2, 0.04 us at 3.35 TB/s.
// The practical floor is the latency of the loop's two barriers and two
// sums across blocks, which the barrier loop kernels measure alone.  The
// strided instance keeps the state in global memory: an iteration must read
// and write x, r and p once each and read the stencil's five fields and
// diag, 11 values a cell (z = r / diag can be formed where it is used; 185
// MB a CG iteration at 2048^2 in f32, 55 us at 3.35 TB/s); as written it
// moves 17 (z stored, z and p of its own cells read in both halves, A p
// written and read again).
//
// Design.  In the cluster and grid instances a thread owns C cells (1, 2,
// 4, 8 or 16) for the whole loop: x, r, z, inv_diag, p, Ap and the
// stencil's coefficients stay in registers.  Three instances, chosen by
// kernels/pcg.py:pcg_plan before the launch:
//   * cluster (pcg_cluster_kernel): the grids one thread-block cluster
//     holds (at most 16 blocks of 512 threads; dsa64's 64^2, demo128's
//     128^2).  One cluster, launched by cudaLaunchKernelEx with a cluster
//     dimension (non-portable sizes above 8 allowed), no cooperative
//     launch.  Block b owns `rows` whole rows of the grid and keeps their z
//     and old p in shared memory; the rows above and below come from ranks
//     b -+ 1 through distributed shared memory (map_shared_rank).  A
//     block's partial sums lie in its shared memory; after the cluster
//     barrier every warp of every block reads the ranks' partials in rank
//     order (a lane a rank, then an xor butterfly), so all take the same
//     alpha, beta and stopping decision.  The kernel ends with a cluster
//     barrier: no block leaves while another may still read its shared
//     memory.
//   * grid (pcg_grid_kernel): any grid the card holds at once in one
//     cooperative launch (cudaLaunchCooperativeKernel; 512^2).  z and the
//     old p go through global memory, read with ld.global.cg (L2); partial
//     sums, one a block, are summed by every block in the same fixed order
//     after the grid barrier.
//   * strided (pcg_strided_kernel): every other grid (past 1039^2 on the
//     H100: 132 SMs x 512 threads x 16 cells), in one cooperative launch of
//     as many blocks as the card holds at once.  A thread takes its cells
//     by a grid-stride loop in each half of an iteration; x, r, z, the old
//     p and A p live in global memory (read with ld.global.cg), nothing of
//     a cell in registers across a barrier.  The first half forms p of the
//     cell and of its neighbours from z and the old p, applies the stencil
//     and writes A p; the second forms the cell's p again (the same bits),
//     updates x, r and z and writes z and p as the old p of the next
//     iteration.  Each half touches other cells only by reading z and the
//     old p in the first, which the second writes after the barrier
//     between them; the sums are the grid instance's.
// All run two barriers an iteration: after the p.Ap partials and after
// the r.r / r.z partials.  After the first, each thread writes its new z
// and its current p (the old p of the next iteration) to two buffers;
// after the second, once beta is known, the stencil forms each
// neighbour's new p itself, add(z_nb, mul(beta, p_nb)): the bits its owner
// computes.  The first iteration reads p0 = z0, written before the
// barrier that precedes the loop.
//   Why one buffer of each suffices: the writes of iteration k fall after
//   its first barrier; the stencil reads of iteration k come before that
//   barrier and those of iteration k + 1 after its second, and the writes
//   of iteration k + 1 after its own first barrier, after every read of
//   k + 1.  The partial sums likewise: each slot is written before one
//   barrier, read after it, and written again only after the other
//   barrier, which follows every read.
// Reductions are deterministic: a block sums its threads' values (an xor
// butterfly in each warp, every lane the same bits, then the warps in
// order); across blocks every block sums the partials in the same order.
// A block that left the loop while another waited at a barrier would hang
// the card.  No reordering (pipelined CG) that would change the rounding
// and the counts.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "diffusion_stencil.cuh"
#include "smem_limits.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;        // kernels/pcg.py THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;      // kernels/pcg.py MAX_CLUSTER

// The butterfly sum over the warp: every lane gets the same bits.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
    }
    return v;
}

// v[k] summed over the block in one fixed order; every thread gets the same
// bits (x + y == y + x, so the butterfly's lanes agree).  sh is free again
// when it returns.
template <typename T, int NV>
__device__ __forceinline__ void block_sum(T (&v)[NV], T (*sh)[NV]) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        v[k] = warp_sum(v[k]);
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            sh[warp][k] = v[k];
        }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        T s = sh[0][k];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) {
            s += sh[w][k];
        }
        v[k] = s;
    }
    __syncthreads();
}

// A neighbour's p from its z and old p: z0 in the first iteration, else
// formed as its owner forms it (the same bits).
template <typename T>
__device__ __forceinline__ T p_from(T z, T p, T beta, bool first) {
    return first ? z : aniso::add(z, aniso::mul(beta, p));
}

// The offsets of a cell's four neighbours (i + 1, i - 1, j + 1, j - 1) in
// a row-major array of rows of `sz` whose cell sits at `at`, each clamped
// to the cell itself where the neighbour is off the grid: every load is
// issued at once, and a value off the grid is read but not used.
template <typename T>
__device__ __forceinline__ void neighbours(const aniso::Cell<T>& e, int sz,
                                           int at, int (&q)[4]) {
    q[0] = e.i < sz - 1 ? at + sz : at;
    q[1] = e.i > 0 ? at - sz : at;
    q[2] = e.j < sz - 1 ? at + 1 : at;
    q[3] = e.j > 0 ? at - 1 : at;
}

// -- the grid instance --

// The block's partial sums v into part[k * nb + block].
template <typename T, int NV>
__device__ __forceinline__ void write_partial(const T (&v)[NV], T* part,
                                              int nb) {
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            part[k * nb + blockIdx.x] = v[k];
        }
    }
}

// The grid's sums of the partials part[k * nb + b] over b, in the same
// order in every block (read from L2: other SMs wrote them).
template <typename T, int NV>
__device__ __forceinline__ void grid_sum(const T* part, int nb, T (&v)[NV],
                                         T (*sh)[NV]) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        v[k] = T(0);
    }
    for (int b = threadIdx.x; b < nb; b += kThreads) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            v[k] += __ldcg(part + k * nb + b);
        }
    }
    block_sum(v, sh);
}

// v summed over the grid: the block's sum, its partial, the grid barrier,
// then every partial in the same order.
template <typename T, int NV>
__device__ __forceinline__ void grid_reduce(T (&v)[NV], T (*sh)[NV],
                                            T* part, cg::grid_group& grid) {
    block_sum(v, sh);
    write_partial(v, part, gridDim.x);
    grid.sync();
    grid_sum(part, gridDim.x, v, sh);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1) pcg_grid_kernel(
    const T* __restrict__ Dx,         // (sz - 1, sz)
    const T* __restrict__ Dy,         // (sz, sz - 1)
    const T* __restrict__ robin,      // (sz, sz)
    const T* __restrict__ sigma_a,    // (sz, sz)
    const T* __restrict__ diag,       // (sz, sz) the Jacobi diagonal
    const T* __restrict__ b,          // (sz, sz)
    T* __restrict__ x,                // (sz, sz) out
    T* zb,                            // (sz, sz) scratch: z, shared by blocks
    T* pb,                            // (sz, sz) scratch: the old p
    T* part,                          // (3, blocks) scratch
    int* iters,                       // (1,) out
    int sz, T inv_dx2, T inv_dx, double tol2, int max_iter) {
    cg::grid_group grid = cg::this_grid();
    __shared__ T sh1[kWarps][1];
    __shared__ T sh2[kWarps][2];
    const int n = sz * sz;
    const int nb = gridDim.x;
    const int stride = nb * kThreads;
    T* part_pap = part;               // (1, nb)
    T* part_rr_rz = part + nb;        // (2, nb)

    aniso::Cell<T> cell[C];
    int idx[C];
    bool in[C];
    T xv[C], rv[C], iv[C], pv[C], zv[C], ap[C];
    T s2[2] = {T(0), T(0)};           // r.r, r.z
#pragma unroll
    for (int c = 0; c < C; ++c) {
        idx[c] = blockIdx.x * kThreads + threadIdx.x + c * stride;
        in[c] = idx[c] < n;
        xv[c] = rv[c] = iv[c] = pv[c] = zv[c] = ap[c] = T(0);
        cell[c] = aniso::Cell<T>{};
        if (in[c]) {
            cell[c] = aniso::load_cell(Dx, Dy, robin, sigma_a, idx[c], sz);
            iv[c] = T(1) / diag[idx[c]];
            rv[c] = b[idx[c]];
            zv[c] = aniso::mul(iv[c], rv[c]);
            pv[c] = zv[c];
            zb[idx[c]] = zv[c];       // p0 = z0 for the first stencil
            s2[0] = aniso::add(s2[0], aniso::mul(rv[c], rv[c]));
            s2[1] = aniso::add(s2[1], aniso::mul(rv[c], zv[c]));
        }
    }
    grid_reduce(s2, sh2, part_rr_rz, grid);
    T rr = s2[0];
    T rz = s2[1];
    T beta = T(0);
    const double stop = tol2 * (rr == T(0) ? 1.0 : (double)rr);
    int k = 0;
    while (k < max_iter && (double)rr > stop) {
        // every neighbour's z and old p loaded at once (L2), then combined
        T zn[C][4], pn[C][4];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            int q[4];
            neighbours(cell[c], sz, in[c] ? idx[c] : 0, q);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                zn[c][t] = __ldcg(zb + q[t]);
                pn[c][t] = __ldcg(pb + q[t]);
            }
        }
        T s1[1] = {T(0)};             // p.Ap
#pragma unroll
        for (int c = 0; c < C; ++c) {
            if (in[c]) {
                T nb4[4];
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    nb4[t] = p_from(zn[c][t], pn[c][t], beta, k == 0);
                }
                ap[c] = aniso::apply_cell(cell[c], sz, pv[c], nb4[0], nb4[1],
                                          nb4[2], nb4[3], inv_dx2, inv_dx);
                s1[0] = aniso::add(s1[0], aniso::mul(pv[c], ap[c]));
            }
        }
        grid_reduce(s1, sh1, part_pap, grid);          // barrier 1
        const T alpha = rz / s1[0];
        s2[0] = s2[1] = T(0);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            if (in[c]) {
                xv[c] = aniso::add(xv[c], aniso::mul(alpha, pv[c]));
                rv[c] = aniso::sub(rv[c], aniso::mul(alpha, ap[c]));
                zv[c] = aniso::mul(iv[c], rv[c]);
                zb[idx[c]] = zv[c];
                pb[idx[c]] = pv[c];
                s2[0] = aniso::add(s2[0], aniso::mul(rv[c], rv[c]));
                s2[1] = aniso::add(s2[1], aniso::mul(rv[c], zv[c]));
            }
        }
        grid_reduce(s2, sh2, part_rr_rz, grid);        // barrier 2
        rr = s2[0];
        beta = s2[1] / rz;
        rz = s2[1];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            pv[c] = aniso::add(zv[c], aniso::mul(beta, pv[c]));
        }
        ++k;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
        if (in[c]) {
            x[idx[c]] = xv[c];
        }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        *iters = k;
    }
}

// -- the strided instance --

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) pcg_strided_kernel(
    const T* __restrict__ Dx,         // (sz - 1, sz)
    const T* __restrict__ Dy,         // (sz, sz - 1)
    const T* __restrict__ robin,      // (sz, sz)
    const T* __restrict__ sigma_a,    // (sz, sz)
    const T* __restrict__ diag,       // (sz, sz) the Jacobi diagonal
    const T* __restrict__ b,          // (sz, sz)
    T* x,                             // (sz, sz) out: the iterate
    T* zb,                            // (sz, sz) scratch: z
    T* pb,                            // (sz, sz) scratch: the old p
    T* rb,                            // (sz, sz) scratch: r
    T* ab,                            // (sz, sz) scratch: A p
    T* part,                          // (3, blocks) scratch
    int* iters,                       // (1,) out
    int sz, T inv_dx2, T inv_dx, double tol2, int max_iter) {
    cg::grid_group grid = cg::this_grid();
    __shared__ T sh1[kWarps][1];
    __shared__ T sh2[kWarps][2];
    const int n = sz * sz;
    const int nb = gridDim.x;
    const int stride = nb * kThreads;
    const int start = blockIdx.x * kThreads + threadIdx.x;
    T* part_pap = part;               // (1, nb)
    T* part_rr_rz = part + nb;        // (2, nb)

    T s2[2] = {T(0), T(0)};           // r.r, r.z
    for (int id = start; id < n; id += stride) {
        const T r = b[id];
        const T z = aniso::mul(T(1) / diag[id], r);
        x[id] = T(0);
        rb[id] = r;
        zb[id] = z;                   // p0 = z0 for the first stencil
        s2[0] = aniso::add(s2[0], aniso::mul(r, r));
        s2[1] = aniso::add(s2[1], aniso::mul(r, z));
    }
    grid_reduce(s2, sh2, part_rr_rz, grid);
    T rr = s2[0];
    T rz = s2[1];
    T beta = T(0);
    const double stop = tol2 * (rr == T(0) ? 1.0 : (double)rr);
    int k = 0;
    while (k < max_iter && (double)rr > stop) {
        const bool first = k == 0;
        T s1[1] = {T(0)};             // p.Ap
        for (int id = start; id < n; id += stride) {
            const aniso::Cell<T> cell =
                aniso::load_cell(Dx, Dy, robin, sigma_a, id, sz);
            int q[4];
            neighbours(cell, sz, id, q);
            T zn[4], pn[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                zn[t] = __ldcg(zb + q[t]);
                pn[t] = __ldcg(pb + q[t]);
            }
            const T p = p_from(__ldcg(zb + id), __ldcg(pb + id), beta, first);
            T nb4[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                nb4[t] = p_from(zn[t], pn[t], beta, first);
            }
            const T ap = aniso::apply_cell(cell, sz, p, nb4[0], nb4[1],
                                           nb4[2], nb4[3], inv_dx2, inv_dx);
            ab[id] = ap;
            s1[0] = aniso::add(s1[0], aniso::mul(p, ap));
        }
        grid_reduce(s1, sh1, part_pap, grid);          // barrier 1
        const T alpha = rz / s1[0];
        s2[0] = s2[1] = T(0);
        for (int id = start; id < n; id += stride) {
            const T p = p_from(__ldcg(zb + id), __ldcg(pb + id), beta, first);
            const T r = aniso::sub(__ldcg(rb + id),
                                   aniso::mul(alpha, __ldcg(ab + id)));
            const T z = aniso::mul(T(1) / diag[id], r);
            x[id] = aniso::add(__ldcg(x + id), aniso::mul(alpha, p));
            rb[id] = r;
            zb[id] = z;
            pb[id] = p;
            s2[0] = aniso::add(s2[0], aniso::mul(r, r));
            s2[1] = aniso::add(s2[1], aniso::mul(r, z));
        }
        grid_reduce(s2, sh2, part_rr_rz, grid);        // barrier 2
        rr = s2[0];
        beta = s2[1] / rz;
        rz = s2[1];
        ++k;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        *iters = k;
    }
}

// The grid and strided instances' loop without its arithmetic: iters
// iterations of the same block sums, partial writes, grid sums and two grid
// barriers.
template <typename T>
__global__ void __launch_bounds__(kThreads) barrier_grid_kernel(T* part,
                                                                int iters) {
    cg::grid_group grid = cg::this_grid();
    __shared__ T sh1[kWarps][1];
    __shared__ T sh2[kWarps][2];
    const int nb = gridDim.x;
    for (int k = 0; k < iters; ++k) {
        T s1[1] = {T(1)};
        grid_reduce(s1, sh1, part, grid);
        T s2[2] = {s1[0], T(1)};
        grid_reduce(s2, sh2, part + nb, grid);
    }
}

// -- the cluster instance --

// v summed over the cluster: the block's sum (warp butterflies, then the
// warps in order) pushed by threads t < nb into slot [k][rank] of rank t's
// shared memory (a remote store, off the critical path), the cluster
// barrier, then every thread of every block sums its own slots [k][0, nb)
// in rank order: the same bits everywhere, no remote load.  slots:
// [NV][kMaxCluster] of this block's shared memory.
template <typename T, int NV>
__device__ __forceinline__ void cluster_reduce(T (&v)[NV], T (*sh)[2],
                                               T* slots,
                                               cg::cluster_group& cluster,
                                               int nb, int rank) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        v[k] = warp_sum(v[k]);
    }
    if (lane == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            sh[warp][k] = v[k];
        }
    }
    __syncthreads();
    if ((int)threadIdx.x < nb) {
        T* dst = cluster.map_shared_rank(slots, threadIdx.x);
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            T s = sh[0][k];
#pragma unroll
            for (int w = 1; w < kWarps; ++w) {
                s += sh[w][k];
            }
            dst[k * kMaxCluster + rank] = s;
        }
    }
    cluster.sync();
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        T s = slots[k * kMaxCluster];
        for (int b = 1; b < nb; ++b) {
            s += slots[k * kMaxCluster + b];
        }
        v[k] = s;
    }
}

// Dynamic shared memory of the cluster instance: z and the old p of the
// block's rows with a halo row above and below each, then the ranks'
// partial sums, [3][kMaxCluster] (kernels/pcg.py agrees).
__host__ __device__ inline int cluster_smem(int rows, int sz, int item) {
    return item * (2 * (rows + 2) * sz + 3 * kMaxCluster);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads, 1) pcg_cluster_kernel(
    const T* __restrict__ Dx, const T* __restrict__ Dy,
    const T* __restrict__ robin, const T* __restrict__ sigma_a,
    const T* __restrict__ diag, const T* __restrict__ b,
    T* __restrict__ x, int* iters, int sz, int rows, T inv_dx2, T inv_dx,
    double tol2, int max_iter) {
    cg::cluster_group cluster = cg::this_cluster();
    __shared__ T sh[kWarps][2];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // [rows + 2][sz] each: row 0 the halo above (global row r0 - 1), rows
    // 1..nrows the block's own, the next the halo below; halos off the
    // grid are read but not used
    T* zs = reinterpret_cast<T*>(smem_raw);
    T* ps = zs + (rows + 2) * sz;
    T* slots = ps + (rows + 2) * sz;           // [3][kMaxCluster]
    const int rank = (int)cluster.block_rank();
    const int nb = (int)cluster.num_blocks();
    const int r0 = rank * rows;
    const int nrows = sz - r0 < rows ? sz - r0 : rows;
    const int ncell = nrows * sz;
    // where the block's first row goes in the rank above (its halo below:
    // that rank holds `rows` rows) and its last row in the rank below (its
    // halo above)
    T* z_up = nullptr;
    T* p_up = nullptr;
    T* z_dn = nullptr;
    T* p_dn = nullptr;
    if (rank > 0) {
        z_up = cluster.map_shared_rank(zs, rank - 1) + (rows + 1) * sz;
        p_up = cluster.map_shared_rank(ps, rank - 1) + (rows + 1) * sz;
    }
    if (rank + 1 < nb) {
        z_dn = cluster.map_shared_rank(zs, rank + 1);
        p_dn = cluster.map_shared_rank(ps, rank + 1);
    }
    // every block has started before any remote store
    cluster.sync();

    aniso::Cell<T> cell[C];
    int loc[C];
    bool in[C];
    T xv[C], rv[C], iv[C], pv[C], zv[C], ap[C];
    T s2[2] = {T(0), T(0)};
#pragma unroll
    for (int c = 0; c < C; ++c) {
        loc[c] = threadIdx.x + c * kThreads;
        in[c] = loc[c] < ncell;
        xv[c] = rv[c] = iv[c] = pv[c] = zv[c] = ap[c] = T(0);
        cell[c] = aniso::Cell<T>{};
        if (in[c]) {
            const int id = r0 * sz + loc[c];
            cell[c] = aniso::load_cell(Dx, Dy, robin, sigma_a, id, sz);
            iv[c] = T(1) / diag[id];
            rv[c] = b[id];
            zv[c] = aniso::mul(iv[c], rv[c]);
            pv[c] = zv[c];
            // p0 = z0 for the first stencil, the edge rows into the
            // neighbours' halos too
            zs[loc[c] + sz] = zv[c];
            if (loc[c] < sz && z_up != nullptr) {
                z_up[loc[c]] = zv[c];
            }
            if (loc[c] >= ncell - sz && z_dn != nullptr) {
                z_dn[loc[c] - (ncell - sz)] = zv[c];
            }
            s2[0] = aniso::add(s2[0], aniso::mul(rv[c], rv[c]));
            s2[1] = aniso::add(s2[1], aniso::mul(rv[c], zv[c]));
        }
    }
    cluster_reduce(s2, sh, slots + kMaxCluster, cluster, nb, rank);
    T rr = s2[0];
    T rz = s2[1];
    T beta = T(0);
    const double stop = tol2 * (rr == T(0) ? 1.0 : (double)rr);
    int k = 0;
    while (k < max_iter && (double)rr > stop) {
        // every neighbour's z and old p from this block's shared memory
        // (own rows and halos), loaded at once, then combined
        T zn[C][4], pn[C][4];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            int q[4];
            neighbours(cell[c], sz, (in[c] ? loc[c] : 0) + sz, q);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                zn[c][t] = zs[q[t]];
                pn[c][t] = ps[q[t]];
            }
        }
        T s1[1] = {T(0)};
#pragma unroll
        for (int c = 0; c < C; ++c) {
            if (in[c]) {
                T nb4[4];
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    nb4[t] = p_from(zn[c][t], pn[c][t], beta, k == 0);
                }
                ap[c] = aniso::apply_cell(cell[c], sz, pv[c], nb4[0], nb4[1],
                                          nb4[2], nb4[3], inv_dx2, inv_dx);
                s1[0] = aniso::add(s1[0], aniso::mul(pv[c], ap[c]));
            }
        }
        cluster_reduce(s1, sh, slots, cluster, nb, rank);      // barrier 1
        const T alpha = rz / s1[0];
        s2[0] = s2[1] = T(0);
#pragma unroll
        for (int c = 0; c < C; ++c) {
            if (in[c]) {
                const int l = loc[c];
                xv[c] = aniso::add(xv[c], aniso::mul(alpha, pv[c]));
                rv[c] = aniso::sub(rv[c], aniso::mul(alpha, ap[c]));
                zv[c] = aniso::mul(iv[c], rv[c]);
                zs[l + sz] = zv[c];
                ps[l + sz] = pv[c];
                if (l < sz && z_up != nullptr) {
                    z_up[l] = zv[c];
                    p_up[l] = pv[c];
                }
                if (l >= ncell - sz && z_dn != nullptr) {
                    z_dn[l - (ncell - sz)] = zv[c];
                    p_dn[l - (ncell - sz)] = pv[c];
                }
                s2[0] = aniso::add(s2[0], aniso::mul(rv[c], rv[c]));
                s2[1] = aniso::add(s2[1], aniso::mul(rv[c], zv[c]));
            }
        }
        cluster_reduce(s2, sh, slots + kMaxCluster, cluster, nb,
                       rank);                                  // barrier 2
        rr = s2[0];
        beta = s2[1] / rz;
        rz = s2[1];
#pragma unroll
        for (int c = 0; c < C; ++c) {
            pv[c] = aniso::add(zv[c], aniso::mul(beta, pv[c]));
        }
        ++k;
    }
    // no block leaves while another may still access its shared memory
    cluster.sync();
#pragma unroll
    for (int c = 0; c < C; ++c) {
        if (in[c]) {
            x[r0 * sz + loc[c]] = xv[c];
        }
    }
    if (rank == 0 && threadIdx.x == 0) {
        *iters = k;
    }
}

// The cluster instance's loop without its arithmetic: iters iterations of
// the same block sums, slot writes, cluster barriers and rank sums.
template <typename T>
__global__ void __launch_bounds__(kThreads) barrier_cluster_kernel(
    int iters) {
    cg::cluster_group cluster = cg::this_cluster();
    __shared__ T sh[kWarps][2];
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* slots = reinterpret_cast<T*>(smem_raw);
    const int rank = (int)cluster.block_rank();
    const int nb = (int)cluster.num_blocks();
    cluster.sync();
    for (int k = 0; k < iters; ++k) {
        T s1[1] = {T(1)};
        cluster_reduce(s1, sh, slots, cluster, nb, rank);
        T s2[2] = {s1[0], T(1)};
        cluster_reduce(s2, sh, slots + kMaxCluster, cluster, nb, rank);
    }
    cluster.sync();
}

// -- launches --

enum { kGrid = 0, kCluster = 1, kStrided = 2 };

// The kernel of an instance, C cells a thread (nullptr: not compiled; the
// strided instance takes any number of cells a thread).
template <typename T>
const void* pcg_function(int instance, int cells) {
    if (instance == kStrided) {
        return cells >= 1 ? (const void*)pcg_strided_kernel<T> : nullptr;
    }
    if (instance != kGrid && instance != kCluster) {
        return nullptr;
    }
#define ANISO_K9_FN(CV)                                                   \
    case CV:                                                              \
        return instance == kCluster                                       \
                   ? (const void*)pcg_cluster_kernel<T, CV>               \
                   : (const void*)pcg_grid_kernel<T, CV>;
    switch (cells) {
        ANISO_K9_FN(1)
        ANISO_K9_FN(2)
        ANISO_K9_FN(4)
        ANISO_K9_FN(8)
        ANISO_K9_FN(16)
        default:
            return nullptr;
    }
#undef ANISO_K9_FN
}

// A launch configuration of one cluster of `blocks` blocks (attr: its
// storage).
cudaLaunchConfig_t cluster_config(int blocks, int smem, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = blocks;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

// The attributes a cluster launch of fn needs: sizes above 8 and dynamic
// shared memory above 48 KB.
cudaError_t cluster_attributes(const void* fn, int smem) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    }
    return err;
}

// The occupancy the plan weighs: for the grid and strided instances the
// blocks an SM holds at once, for the cluster instance the clusters of `blocks` blocks
// with `smem` bytes each the card holds at once (0: none can be scheduled).
template <typename T>
int occupancy(int instance, int cells, int blocks, int smem, int* out) {
    *out = 0;
    const void* fn = pcg_function<T>(instance, cells);
    if (fn == nullptr || blocks < 1
        || (instance == kCluster && blocks > kMaxCluster) || smem < 0
        || (size_t)smem > aniso::kSmemBlock) {
        return (int)cudaErrorInvalidValue;
    }
    if (instance != kCluster) {
        return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            out, fn, kThreads, 0);
    }
    cudaError_t err = cluster_attributes(fn, smem);
    if (err != cudaSuccess) {
        return (int)err;
    }
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(blocks, smem, nullptr, &attr);
    return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

// A cooperative grid of `blocks` must fit the card at once.
cudaError_t check_cooperative(const void* fn, int blocks) {
    int dev = 0, coop = 0, sms = 0, occ = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev);
    }
    if (err == cudaSuccess) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    }
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn,
                                                            kThreads, 0);
    }
    if (err != cudaSuccess) {
        return err;
    }
    if (!coop) {
        return cudaErrorNotSupported;
    }
    return (long long)occ * sms < blocks ? cudaErrorCooperativeLaunchTooLarge
                                         : cudaSuccess;
}

// The plan (kernels/pcg.py:pcg_plan) checked again: the grid instance's
// blocks cover the cells, C cells a thread; the cluster's blocks own whole
// rows, at most 16 blocks, rows x sz cells within a block's C x 512; the
// strided instance's blocks cover the cells at C cells a thread, and its
// cell indices stay within an int.
bool plan_ok(int instance, int cells, int blocks, int rows, int smem,
             int sz, int item, int part_len) {
    const long long n = (long long)sz * sz;
    const long long per = (long long)kThreads * cells;
    if (sz < 1 || blocks < 1 || pcg_function<float>(instance, cells)
        == nullptr) {
        return false;
    }
    if (instance == kStrided) {
        return blocks * per >= n && 3LL * blocks <= part_len
               && n + (long long)blocks * kThreads <= 0x7fffffffLL;
    }
    if (instance == kGrid) {
        return blocks * per >= n && (blocks - 1) * per < n
               && 3LL * blocks <= part_len;
    }
    return blocks <= kMaxCluster && rows >= 1 && (long long)rows * sz <= per
           && (long long)blocks * rows >= sz
           && (long long)(blocks - 1) * rows < sz
           && smem >= cluster_smem(rows, sz, item)
           && (size_t)smem <= aniso::kSmemBlock;
}

template <typename T>
int launch(const void* Dx, const void* Dy, const void* robin,
           const void* sigma_a, const void* diag, const void* b, void* x,
           void* zb, void* pb, void* rb, void* ab, void* part, int part_len,
           void* iters, int sz, double inv_dx2, double inv_dx, double tol2,
           int max_iter, int instance, int cells, int blocks, int rows,
           int smem, void* stream) {
    if (!plan_ok(instance, cells, blocks, rows, smem, sz, (int)sizeof(T),
                 part_len)) {
        return (int)cudaErrorInvalidValue;
    }
    const void* fn = pcg_function<T>(instance, cells);
    const cudaStream_t st = (cudaStream_t)stream;
    const T* Dxt = static_cast<const T*>(Dx);
    const T* Dyt = static_cast<const T*>(Dy);
    const T* rt = static_cast<const T*>(robin);
    const T* st_a = static_cast<const T*>(sigma_a);
    const T* dt = static_cast<const T*>(diag);
    const T* bt = static_cast<const T*>(b);
    T* xt = static_cast<T*>(x);
    int* it = static_cast<int*>(iters);
    T idx2 = (T)inv_dx2, idx = (T)inv_dx;
    cudaError_t err;
    if (instance == kStrided) {
        err = check_cooperative(fn, blocks);
        if (err != cudaSuccess) {
            return (int)err;
        }
        T* zt = static_cast<T*>(zb);
        T* pt = static_cast<T*>(pb);
        T* rbt = static_cast<T*>(rb);
        T* at = static_cast<T*>(ab);
        T* part_t = static_cast<T*>(part);
        void* args[] = {&Dxt, &Dyt, &rt,  &st_a, &dt,   &bt,
                        &xt,  &zt,  &pt,  &rbt,  &at,   &part_t,
                        &it,  &sz,  &idx2, &idx, &tol2, &max_iter};
        err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads),
                                          args, 0, st);
    } else if (instance == kGrid) {
        err = check_cooperative(fn, blocks);
        if (err != cudaSuccess) {
            return (int)err;
        }
        T* zt = static_cast<T*>(zb);
        T* pt = static_cast<T*>(pb);
        T* part_t = static_cast<T*>(part);
        void* args[] = {&Dxt, &Dyt, &rt,   &st_a, &dt,   &bt,
                        &xt,  &zt,  &pt,   &part_t, &it, &sz,
                        &idx2, &idx, &tol2, &max_iter};
        err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads),
                                          args, 0, st);
    } else {
        err = cluster_attributes(fn, smem);
        if (err != cudaSuccess) {
            return (int)err;
        }
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg = cluster_config(blocks, smem, st, &attr);
        void* args[] = {&Dxt, &Dyt, &rt,   &st_a, &dt,   &bt,
                        &xt,  &it,  &sz,   &rows, &idx2, &idx,
                        &tol2, &max_iter};
        err = cudaLaunchKernelExC(&cfg, fn, args);
    }
    if (err != cudaSuccess) {
        return (int)err;
    }
    return (int)cudaGetLastError();
}

template <typename T>
int launch_barriers(void* part, int part_len, int sz, int instance,
                    int cells, int blocks, int rows, int smem, int iters,
                    void* stream) {
    if (!plan_ok(instance, cells, blocks, rows, smem, sz, (int)sizeof(T),
                 part_len)) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t st = (cudaStream_t)stream;
    cudaError_t err;
    if (instance != kCluster) {
        const void* fn = (const void*)barrier_grid_kernel<T>;
        err = check_cooperative(fn, blocks);
        if (err != cudaSuccess) {
            return (int)err;
        }
        T* pt = static_cast<T*>(part);
        void* args[] = {&pt, &iters};
        err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads),
                                          args, 0, st);
    } else {
        const void* fn = (const void*)barrier_cluster_kernel<T>;
        err = cluster_attributes(fn, smem);
        if (err != cudaSuccess) {
            return (int)err;
        }
        cudaLaunchAttribute attr;
        cudaLaunchConfig_t cfg = cluster_config(blocks, smem, st, &attr);
        void* args[] = {&iters};
        err = cudaLaunchKernelExC(&cfg, fn, args);
    }
    if (err != cudaSuccess) {
        return (int)err;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// K9 on one plan (kernels/pcg.py:pcg_plan; instance 0 grid, 1 cluster, 2
// strided), checked again here.  zb, pb: (sz, sz) scratch and part:
// part_len >= 3 blocks values of scratch, for the grid and strided
// instances (the cluster keeps them in shared memory; null there); rb, ab:
// (sz, sz) scratch for the strided instance (null for the others).
#define ANISO_K9_ENTRY(NAME, T)                                             \
    extern "C" int NAME(const void* Dx, const void* Dy, const void* robin,  \
                        const void* sigma_a, const void* diag,              \
                        const void* b, void* x, void* zb, void* pb,         \
                        void* rb, void* ab, void* part, int part_len,       \
                        void* iters, int sz, double inv_dx2, double inv_dx, \
                        double tol2, int max_iter, int instance, int cells, \
                        int blocks, int rows, int smem, void* stream) {     \
        return launch<T>(Dx, Dy, robin, sigma_a, diag, b, x, zb, pb, rb,    \
                         ab, part, part_len, iters, sz, inv_dx2, inv_dx,    \
                         tol2, max_iter, instance, cells, blocks, rows,     \
                         smem, stream);                                     \
    }
ANISO_K9_ENTRY(aniso_pcg_f32, float)
ANISO_K9_ENTRY(aniso_pcg_f64, double)
#undef ANISO_K9_ENTRY

// The occupancy of an instance for the plan (kernels/pcg.py:_occupancy).
extern "C" int aniso_pcg_occupancy_f32(int instance, int cells, int blocks,
                                       int smem, int* out) {
    return occupancy<float>(instance, cells, blocks, smem, out);
}

extern "C" int aniso_pcg_occupancy_f64(int instance, int cells, int blocks,
                                       int smem, int* out) {
    return occupancy<double>(instance, cells, blocks, smem, out);
}

// The barrier floor: iters iterations of the loop skeleton of the plan's
// instance on its grid (part: 3 x blocks values of scratch for the grid and
// strided instances, which share the skeleton).
extern "C" int aniso_pcg_barriers_f32(void* part, int part_len, int sz,
                                      int instance, int cells, int blocks,
                                      int rows, int smem, int iters,
                                      void* stream) {
    return launch_barriers<float>(part, part_len, sz, instance, cells,
                                  blocks, rows, smem, iters, stream);
}

extern "C" int aniso_pcg_barriers_f64(void* part, int part_len, int sz,
                                      int instance, int cells, int blocks,
                                      int rows, int smem, int iters,
                                      void* stream) {
    return launch_barriers<double>(part, part_len, sz, instance, cells,
                                   blocks, rows, smem, iters, stream);
}
