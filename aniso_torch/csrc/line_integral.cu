// K7: the exact attenuation line integral E(p, q) = int sigma_t along the
// segment p -> q, for sm_90a, float64, in two entries:
//
//   aniso_line_integral_pairs_f64  E[k] for a list of pairs p0[k] -> p1[k]
//   aniso_dense_smooth_rows_f64    rows [row0, row0 + nrows) of the dense
//       smooth matrices of modes m0 .. m0 + D - 1, fused:
//         out[d, t - row0, s] = expm1(-E(t -> s)) cos(m theta) / r * w[s]
//       with (dx, dy) = x_s - x_t, r = |(dx, dy)|, cos(m theta) = T_m(dx / r)
//       by the Chebyshev recurrence; at r = 0 diag[t] * w[t] for m = 0 and
//       0 for the other modes.
//
// Replaces aniso_tpu/ops/attenuation.py:make_line_integral (:112, with
// _crossings :67 and _merge_breakpoints :92) and the all-pairs loops of
// aniso_tpu/ops/dense.py (build_dense_smooth :43, build_dense_E :115,
// build_dense_smooth_all :166).
//
// The integral is the reference's (KernelFactory.cpp:67-190): split the
// segment at every grid-line crossing, take each piece's cell from its
// midpoint, integrate the cell's normalized-Legendre expansion of sigma_t
// with the deg-point Gauss rule (exact: a polynomial of degree <= 2(deg-1)
// in t), sum.  The JAX form pads the crossings of each axis to a static
// count and merges them by ranks and one-hot products, a TPU workaround.
// Here a thread walks the crossings of both axes in ascending t, as a 2-D
// DDA: the next breakpoint is the smaller of the next x and y crossing,
// each computed by JAX's expression clip((k/sz - a0) / (a1 - a0), 0, 1)
// with the lines k walked in the direction of travel.  A zero-length piece
// contributes 0, as in JAX.  No bound on the crossings (JAX's max_cross and
// n_pieces) is needed.
//
// Bound on the H100: operations on the FP64 CUDA cores (33.5 TFLOP/s; the
// 67 TFLOP/s of the FP64 tensor cores serve only matrix products, and this
// is a data-dependent walk of scalar multiply-adds).  Per sub-segment about
// 16 + deg (16 + 2 deg^2 + 2 deg + 10 (deg - 2)) operations (deg 3: 166;
// kernels/attenuation.py:flops_per_subsegment); at 64^2, deg 3 the 1.36e9
// pairs hold 5.9e10 sub-segments, ~1e13 operations, a bound of ~0.3 s.
// Writing the f64 matrix (10.9 GB at 64^2) takes 3.2 ms at 3.35 TB/s.
//
// Design: one thread per pair.  In the dense entry a block row is one
// target t and its threads take consecutive sources s, so the threads of a
// warp walk segments of similar length through neighbouring cells
// (divergence stays low, the coefficient rows they read overlap in L1) and
// their stores are coalesced.  The coefficients (sz^2 deg^2 values, 295 KB
// at 64^2, divided by the basis norms by the wrapper) stay in L2 and are
// read through __ldg.  The instances are templates on deg (1..8) so that
// the Legendre values and a cell's coefficients live in registers; any
// higher deg runs in one runtime-deg instance (DEG = 0) that reads the
// cell's deg^2 coefficients and the Gauss rule through __ldg as it sums
// them and takes each Legendre value by the same recurrence as it goes (no
// array of deg values: simple, not tuned).  E is
// symmetric, but every pair is computed: simple first.  Indices of the
// output are 64-bit (D n^2 exceeds 2^31 at 64^2).

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Field {
    int sz;
    int deg;               // the runtime-deg instance's degree
    int compat;            // basis at global coordinates (reference quirk)
    const double* gx;      // (deg) Gauss points on [-1, 1]
    const double* gw;      // (deg) Gauss weights
    const double* cn;      // (sz * sz, deg * deg) coefficient / norm
};

// The crossings of one axis: n lines k = first, first + step, ...
struct Axis {
    double a0, denom, first, step;
    int n;
};

__device__ inline Axis make_axis(double a0, double a1, int sz) {
    Axis ax;
    const double lo = fmin(a0, a1), hi = fmax(a0, a1);
    const double i_lo = floor(lo * sz), i_hi = floor(hi * sz);
    ax.a0 = a0;
    ax.denom = a1 - a0;
    ax.n = ax.denom != 0.0 ? (int)(i_hi - i_lo) : 0;
    // walk the lines in the direction of travel: t ascends
    ax.first = ax.denom >= 0.0 ? i_lo + 1.0 : i_hi;
    ax.step = ax.denom >= 0.0 ? 1.0 : -1.0;
    return ax;
}

__device__ inline double crossing(const Axis& ax, int m, int sz) {
    const double k = ax.step > 0.0 ? ax.first + (double)m : ax.first - m;
    const double t = (k / sz - ax.a0) / ax.denom;
    return fmin(fmax(t, 0.0), 1.0);
}

template <int DEG>
__device__ inline void legendre(double x, double* p) {
    p[0] = 1.0;
    if constexpr (DEG > 1) {
        p[1] = x;
    }
#pragma unroll
    for (int n = 2; n < DEG; ++n) {
        p[n] = ((2.0 * n - 1.0) * x * p[n - 1] - (n - 1.0) * p[n - 2]) / n;
    }
}

// P_{n+1}(x) from P_n = p and P_{n-1} = pm (legendre's recurrence)
__device__ inline double legendre_next(double x, int n, double p, double pm) {
    if (n == 0) {
        return x;
    }
    const int k = n + 1;
    return ((2.0 * k - 1.0) * x * p - (k - 1.0) * pm) / k;
}

// sum over a, b of P_a(ex) c[a * deg + b] P_b(ey) at a runtime deg, in the
// order of the compiled instances' sum
__device__ inline double expansion(const double* c, int deg, double ex,
                                   double ey) {
    double v = 0.0;
    double pa = 1.0, pa_m = 0.0;
    for (int a = 0; a < deg; ++a) {
        double row = 0.0;
        double pb = 1.0, pb_m = 0.0;
        for (int b = 0; b < deg; ++b) {
            row += __ldg(c + a * deg + b) * pb;
            const double next = legendre_next(ey, b, pb, pb_m);
            pb_m = pb;
            pb = next;
        }
        v += pa * row;
        const double next = legendre_next(ex, a, pa, pa_m);
        pa_m = pa;
        pa = next;
    }
    return v;
}

// sum_g w_g sigma(t_g) over the Gauss points of [ta, tb], times the piece's
// length |p1 - p0| (tb - ta); DEG = 0: the runtime-deg instance
template <int DEG>
__device__ inline double piece(const Field& F, const double* gx,
                               const double* gw, double x0, double y0,
                               double dx, double dy, double len, double ta,
                               double tb) {
    const int sz = F.sz;
    const double tm = 0.5 * (ta + tb);
    const double half = 0.5 * (tb - ta);
    // the cell from the piece's midpoint (reference integral_helper:176)
    const int i = min(max((int)floor((x0 + tm * dx) * sz), 0), sz - 1);
    const int j = min(max((int)floor((y0 + tm * dy) * sz), 0), sz - 1);
    if constexpr (DEG == 0) {
        const int deg = F.deg;
        const double* c = F.cn + (size_t)(i * sz + j) * (deg * deg);
        double seg = 0.0;
        for (int g = 0; g < deg; ++g) {
            const double tg = tm + half * __ldg(F.gx + g);
            const double xg = x0 + tg * dx;
            const double yg = y0 + tg * dy;
            double ex = xg, ey = yg;
            if (!F.compat) {
                ex = 2.0 * (xg * sz - i) - 1.0;
                ey = 2.0 * (yg * sz - j) - 1.0;
            }
            seg += __ldg(F.gw + g) * expansion(c, deg, ex, ey);
        }
        return seg * (len * (tb - ta));
    }
    constexpr int NC = DEG > 0 ? DEG : 1;    // array sizes of the instance
    const double* c = F.cn + (size_t)(i * sz + j) * (DEG * DEG);
    double cr[NC * NC];
#pragma unroll
    for (int q = 0; q < DEG * DEG; ++q) {
        cr[q] = __ldg(c + q);
    }
    double seg = 0.0;
#pragma unroll
    for (int g = 0; g < DEG; ++g) {
        const double tg = tm + half * gx[g];
        const double xg = x0 + tg * dx;
        const double yg = y0 + tg * dy;
        double ex = xg, ey = yg;
        if (!F.compat) {
            ex = 2.0 * (xg * sz - i) - 1.0;
            ey = 2.0 * (yg * sz - j) - 1.0;
        }
        double px[NC], py[NC];
        legendre<DEG>(ex, px);
        legendre<DEG>(ey, py);
        double v = 0.0;
#pragma unroll
        for (int a = 0; a < DEG; ++a) {
            double row = 0.0;
#pragma unroll
            for (int b = 0; b < DEG; ++b) {
                row += cr[a * DEG + b] * py[b];
            }
            v += px[a] * row;
        }
        seg += gw[g] * v;
    }
    return seg * (len * (tb - ta));
}

template <int DEG>
__device__ double line_integral(const Field& F, const double* gx,
                                const double* gw, double x0, double y0,
                                double x1, double y1) {
    const double dx = x1 - x0, dy = y1 - y0;
    const double len = sqrt(dx * dx + dy * dy);
    if (len == 0.0) {
        return 0.0;
    }
    const int sz = F.sz;
    const Axis ax = make_axis(x0, x1, sz);
    const Axis ay = make_axis(y0, y1, sz);
    int mx = 0, my = 0;
    double tx = mx < ax.n ? crossing(ax, 0, sz) : 2.0;
    double ty = my < ay.n ? crossing(ay, 0, sz) : 2.0;
    double ta = 0.0, acc = 0.0;
    for (;;) {
        // the next breakpoint: an x crossing first on a tie, as JAX's merge
        double tb;
        if (mx < ax.n && tx <= ty) {
            tb = tx;
            ++mx;
            tx = mx < ax.n ? crossing(ax, mx, sz) : 2.0;
        } else if (my < ay.n) {
            tb = ty;
            ++my;
            ty = my < ay.n ? crossing(ay, my, sz) : 2.0;
        } else {
            break;
        }
        acc += piece<DEG>(F, gx, gw, x0, y0, dx, dy, len, ta, tb);
        ta = tb;
    }
    acc += piece<DEG>(F, gx, gw, x0, y0, dx, dy, len, ta, 1.0);
    return acc / 2.0;
}

// the Gauss rule into registers (the runtime-deg instance reads it as it
// goes)
template <int DEG>
__device__ inline void load_rule(const Field& F, double* gx, double* gw) {
#pragma unroll
    for (int g = 0; g < DEG; ++g) {
        gx[g] = __ldg(F.gx + g);
        gw[g] = __ldg(F.gw + g);
    }
}

template <int DEG>
__global__ void pairs_kernel(Field F, const double* __restrict__ p0,
                             const double* __restrict__ p1, long long n,
                             double* __restrict__ out) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= n) {
        return;
    }
    double gx[DEG > 0 ? DEG : 1], gw[DEG > 0 ? DEG : 1];
    load_rule<DEG>(F, gx, gw);
    out[k] = line_integral<DEG>(F, gx, gw, p0[2 * k], p0[2 * k + 1],
                                p1[2 * k], p1[2 * k + 1]);
}

template <int DEG>
__global__ void dense_kernel(Field F, const double* __restrict__ pts,
                             const double* __restrict__ w,
                             const double* __restrict__ diag, int n,
                             int row0, int nrows, int m0, int D,
                             double* __restrict__ out) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= n) {
        return;
    }
    const int row = blockIdx.y;
    const int t = row0 + row;
    const double xt = pts[2 * t], yt = pts[2 * t + 1];
    const double xs = pts[2 * s], ys = pts[2 * s + 1];
    const double dx = xs - xt, dy = ys - yt;
    const double r = sqrt(dx * dx + dy * dy);
    const size_t stride = (size_t)nrows * n;
    double* o = out + (size_t)row * n + s;
    if (r == 0.0) {
        for (int d = 0; d < D; ++d) {
            o[d * stride] = m0 + d == 0 ? diag[t] * w[t] : 0.0;
        }
        return;
    }
    double gx[DEG > 0 ? DEG : 1], gw[DEG > 0 ? DEG : 1];
    load_rule<DEG>(F, gx, gw);
    // E from the target to the source, as JAX's pure path
    const double E = line_integral<DEG>(F, gx, gw, xt, yt, xs, ys);
    const double v = expm1(-E) / r;
    const double c = dx / r;
    const double ws = w[s];
    double t_prev = 1.0, t_m = 1.0;      // T_{m-1}, T_m at m = 0
    for (int m = 0; m < m0 + D; ++m) {
        if (m == 1) {
            t_prev = 1.0;
            t_m = c;
        } else if (m > 1) {
            const double t_next = 2.0 * c * t_m - t_prev;
            t_prev = t_m;
            t_m = t_next;
        }
        if (m >= m0) {
            o[(m - m0) * stride] = v * t_m * ws;
        }
    }
}

dim3 blocks_for(long long n) {
    return dim3((unsigned)((n + kThreads - 1) / kThreads));
}

template <int DEG>
void launch_pairs(const Field& F, const double* p0, const double* p1,
                  long long n, double* out, cudaStream_t stream) {
    pairs_kernel<DEG><<<blocks_for(n), kThreads, 0, stream>>>(F, p0, p1, n,
                                                                out);
}

template <int DEG>
void launch_dense(const Field& F, const double* pts, const double* w,
                  const double* diag, int n, int row0, int nrows, int m0,
                  int D, double* out, cudaStream_t stream) {
    dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)nrows);
    dense_kernel<DEG><<<grid, kThreads, 0, stream>>>(F, pts, w, diag, n,
                                                     row0, nrows, m0, D, out);
}

#define ANISO_K7_DEGREES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

}  // namespace

extern "C" int aniso_line_integral_pairs_f64(
    int sz, int deg, const void* gx, const void* gw, const void* cn,
    int compat, const void* p0, const void* p1, long long n, void* out,
    void* stream) {
    const Field F{sz, deg, compat, static_cast<const double*>(gx),
                  static_cast<const double*>(gw),
                  static_cast<const double*>(cn)};
    if (deg < 1) {
        return (int)cudaErrorInvalidValue;
    }
    if (n <= 0) {
        return 0;
    }
    const auto* a = static_cast<const double*>(p0);
    const auto* b = static_cast<const double*>(p1);
    auto* o = static_cast<double*>(out);
    auto st = (cudaStream_t)stream;
    switch (deg) {
#define ANISO_K7_CASE(D)                          \
    case D:                                       \
        launch_pairs<D>(F, a, b, n, o, st);       \
        break;
        ANISO_K7_DEGREES(ANISO_K7_CASE)
#undef ANISO_K7_CASE
        default:
            launch_pairs<0>(F, a, b, n, o, st);
    }
    return (int)cudaGetLastError();
}

extern "C" int aniso_dense_smooth_rows_f64(
    int sz, int deg, const void* gx, const void* gw, const void* cn,
    int compat, const void* pts, const void* w, const void* diag, int n,
    int row0, int nrows, int m0, int D, void* out, void* stream) {
    const Field F{sz, deg, compat, static_cast<const double*>(gx),
                  static_cast<const double*>(gw),
                  static_cast<const double*>(cn)};
    if (deg < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const auto* p = static_cast<const double*>(pts);
    const auto* wp = static_cast<const double*>(w);
    const auto* dg = static_cast<const double*>(diag);
    auto* o = static_cast<double*>(out);
    auto st = (cudaStream_t)stream;
    switch (deg) {
#define ANISO_K7_CASE(DG)                                                \
    case DG:                                                             \
        launch_dense<DG>(F, p, wp, dg, n, row0, nrows, m0, D, o, st);    \
        break;
        ANISO_K7_DEGREES(ANISO_K7_CASE)
#undef ANISO_K7_CASE
        default:
            launch_dense<0>(F, p, wp, dg, n, row0, nrows, m0, D, o, st);
    }
    return (int)cudaGetLastError();
}
