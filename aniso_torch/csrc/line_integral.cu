// K7: the exact attenuation line integral E(p, q) = int sigma_t along the
// segment p -> q, for sm_90a, float64 arithmetic, in two entries:
//
//   aniso_line_integral_pairs_f64  E[k] for a list of pairs p0[k] -> p1[k]
//   aniso_dense_smooth_f64 / _f32  the whole dense smooth matrices of modes
//       m0 .. m0 + D - 1, fused, stored in float64 or float32:
//         out[d, t, s] = expm1(-E(t -> s)) cos(m theta) / r * w[s]
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
// kernels/attenuation.py:flops_per_subsegment).  The dense matrices need E
// of each unordered pair once: at 64^2, deg 3 the 6.8e8 pairs hold 2.95e10
// sub-segments, ~4.9e12 operations, a bound of ~147 ms (all ordered pairs,
// as the row form computed them: 294 ms).  Writing the f64 matrix (10.9 GB
// at 64^2) takes 3.2 ms at 3.35 TB/s.
//
// Design: one thread per pair.  The dense entry is symmetric: E(t -> s) =
// E(s -> t) and, with the direction reversed, cos(m theta) turns into
// (-1)^m cos(m theta), so a block takes a tile of 16 targets x 16 sources
// in the upper triangle of tiles (target tile <= source tile; the grid
// walks that triangle row by row), computes E once per pair and writes
// K[t, s] for every mode, then passes expm1(-E) / r and dx / r through
// shared memory and writes the mirrored tile K[s, t] = expm1(-E) / r
// T_m(-dx / r) w[t]: both stores are rows of 16 contiguous values.  A
// diagonal tile computes its upper half and the r = 0 entries.  The
// threads of a warp take two targets and 16 neighbouring sources, so they
// walk segments of similar length through neighbouring cells.  The whole
// matrix is one launch, written in the solver's dtype: no row chunks and
// no temporary.  Occupancy: the Gauss rule sits in shared memory and the
// walk keeps only the start, direction, next line and count of each axis
// (the start point and direction serve as the JAX expression's a0 and
// a1 - a0), under __launch_bounds__ of 4 blocks of 256 threads an SM at
// deg <= 4 (2 at deg 5).  A piece lies in one cell by construction (it ends
// at the next grid line), so its deg^2 coefficients are loaded once into
// registers for its deg Gauss points and no further reuse exists.  The
// coefficients (sz^2 deg^2 values, 295 KB at 64^2, divided by the basis
// norms by the wrapper) stay in L2 and are read through __ldg.  The
// instances are templates on deg (1..8) so that the Legendre values and a
// cell's coefficients live in registers; any higher deg runs in one
// runtime-deg instance (DEG = 0) that reads the cell's deg^2 coefficients
// and the Gauss rule through __ldg as it sums them and takes each Legendre
// value by the same recurrence as it goes (no array of deg values: simple,
// not tuned).  Indices of the output are 64-bit (D n^2 exceeds 2^31 at
// 64^2).

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;        // a dense block: 16 targets x 16 sources

struct Field {
    int sz;
    int deg;               // the runtime-deg instance's degree
    int compat;            // basis at global coordinates (reference quirk)
    const double* gx;      // (deg) Gauss points on [-1, 1]
    const double* gw;      // (deg) Gauss weights
    const double* cn;      // (sz * sz, deg * deg) coefficient / norm
};

// The crossings of one axis from a0 to a1: n lines, the next one k, walked
// in the direction of travel (step +-1)
struct Axis {
    double k, step;
    int n;
};

__device__ inline Axis make_axis(double a0, double a1, int sz) {
    Axis ax;
    const double lo = fmin(a0, a1), hi = fmax(a0, a1);
    const double i_lo = floor(lo * sz), i_hi = floor(hi * sz);
    const double denom = a1 - a0;
    ax.n = denom != 0.0 ? (int)(i_hi - i_lo) : 0;
    // t ascends
    ax.k = denom >= 0.0 ? i_lo + 1.0 : i_hi;
    ax.step = denom >= 0.0 ? 1.0 : -1.0;
    return ax;
}

// JAX's crossing parameter of line k: clip((k / sz - a0) / (a1 - a0), 0, 1)
__device__ inline double crossing(double k, double a0, double denom, int sz) {
    const double t = (k / sz - a0) / denom;
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
// length |p1 - p0| (tb - ta); rule: the deg points then the deg weights
// (shared memory); DEG = 0: the runtime-deg instance (rule unused)
template <int DEG>
__device__ inline double piece(const Field& F, const double* rule, double x0,
                               double y0, double dx, double dy, double len,
                               double ta, double tb) {
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
        const double tg = tm + half * rule[g];
        const double xg = x0 + tg * dx;
        const double yg = y0 + tg * dy;
        double ex = xg, ey = yg;
        if (!F.compat) {
            ex = 2.0 * (xg * sz - i) - 1.0;
            ey = 2.0 * (yg * sz - j) - 1.0;
        }
        double py[NC];
        legendre<DEG>(ey, py);
        // sum_a P_a(ex) row_a, with P_a by the recurrence as it goes
        double v = 0.0, pa = 1.0, pa_m = 0.0;
#pragma unroll
        for (int a = 0; a < DEG; ++a) {
            double row = 0.0;
#pragma unroll
            for (int b = 0; b < DEG; ++b) {
                row += cr[a * DEG + b] * py[b];
            }
            v += pa * row;
            const double next = legendre_next(ex, a, pa, pa_m);
            pa_m = pa;
            pa = next;
        }
        seg += rule[DEG + g] * v;
    }
    return seg * (len * (tb - ta));
}

template <int DEG>
__device__ double line_integral(const Field& F, const double* rule,
                                double x0, double y0, double x1, double y1) {
    const double dx = x1 - x0, dy = y1 - y0;
    const double len = sqrt(dx * dx + dy * dy);
    if (len == 0.0) {
        return 0.0;
    }
    const int sz = F.sz;
    Axis ax = make_axis(x0, x1, sz);
    Axis ay = make_axis(y0, y1, sz);
    double tx = ax.n > 0 ? crossing(ax.k, x0, dx, sz) : 2.0;
    double ty = ay.n > 0 ? crossing(ay.k, y0, dy, sz) : 2.0;
    double ta = 0.0, acc = 0.0;
    for (;;) {
        // the next breakpoint: an x crossing first on a tie, as JAX's merge
        double tb;
        if (ax.n > 0 && tx <= ty) {
            tb = tx;
            --ax.n;
            ax.k += ax.step;
            tx = ax.n > 0 ? crossing(ax.k, x0, dx, sz) : 2.0;
        } else if (ay.n > 0) {
            tb = ty;
            --ay.n;
            ay.k += ay.step;
            ty = ay.n > 0 ? crossing(ay.k, y0, dy, sz) : 2.0;
        } else {
            break;
        }
        acc += piece<DEG>(F, rule, x0, y0, dx, dy, len, ta, tb);
        ta = tb;
    }
    acc += piece<DEG>(F, rule, x0, y0, dx, dy, len, ta, 1.0);
    return acc / 2.0;
}

// the Gauss rule (points, then weights) into shared memory, by the block;
// the runtime-deg instance reads it from device memory as it goes
template <int DEG>
__device__ inline void load_rule(const Field& F, double* rule) {
    if constexpr (DEG > 0) {
        if (threadIdx.x < 2 * DEG) {
            rule[threadIdx.x] = threadIdx.x < DEG
                ? F.gx[threadIdx.x] : F.gw[threadIdx.x - DEG];
        }
    }
    __syncthreads();
}

// 4 blocks of 256 threads an SM at deg <= 4 (64 registers), 2 at deg 5;
// from deg 6, and at run time, the registers a thread needs (under a bound
// of 128, deg 7-8 spilled 1.3-3.9 KB a thread)
template <int DEG>
struct Occupancy {
    static constexpr int blocks =
        DEG >= 1 && DEG <= 4 ? 4 : (DEG == 5 ? 2 : 1);
};

template <int DEG>
__global__ void __launch_bounds__(kThreads, Occupancy<DEG>::blocks)
pairs_kernel(Field F, const double* __restrict__ p0,
             const double* __restrict__ p1, long long n,
             double* __restrict__ out) {
    __shared__ double rule[2 * (DEG > 0 ? DEG : 1)];
    load_rule<DEG>(F, rule);
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= n) {
        return;
    }
    out[k] = line_integral<DEG>(F, rule, p0[2 * k], p0[2 * k + 1], p1[2 * k],
                                p1[2 * k + 1]);
}

// K_m for m = m0 .. m0 + D - 1 at out[m - m0, row, col] of an (n, n) plane:
// v T_m(c) w, or at r = 0 (at_zero: only t = s) dg * w for m = 0, else 0
template <typename TO>
__device__ inline void store_modes(TO* __restrict__ o, size_t plane,
                                   double v, double c, double wv,
                                   double dg, bool at_zero, int m0, int D) {
    if (at_zero) {
        for (int d = 0; d < D; ++d) {
            o[d * plane] = (TO)(m0 + d == 0 ? dg * wv : 0.0);
        }
        return;
    }
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
            o[(m - m0) * plane] = (TO)(v * t_m * wv);
        }
    }
}

// The whole (D, n, n) matrix from the upper triangle of its 16 x 16 tiles:
// block p is tile pair (bi, bj), bi <= bj, row by row.
template <int DEG, typename TO>
__global__ void __launch_bounds__(kThreads, Occupancy<DEG>::blocks)
dense_sym_kernel(Field F, const double* __restrict__ pts,
                 const double* __restrict__ w,
                 const double* __restrict__ diag, int n, int nt, int m0,
                 int D, TO* __restrict__ out) {
    __shared__ double rule[2 * (DEG > 0 ? DEG : 1)];
    __shared__ double sv[kTile][kTile + 1], sc[kTile][kTile + 1];
    load_rule<DEG>(F, rule);
    // row bi of the triangle starts at bi nt - bi (bi - 1) / 2
    const long long p = blockIdx.x;
    const double b = 2.0 * nt + 1.0;
    long long bi = (long long)floor((b - sqrt(b * b - 8.0 * (double)p)) / 2.0);
    bi = bi < 0 ? 0 : (bi >= nt ? nt - 1 : bi);
    while (bi > 0 && bi * nt - bi * (bi - 1) / 2 > p) {
        --bi;
    }
    while (bi + 1 < nt && (bi + 1) * nt - (bi + 1) * bi / 2 <= p) {
        ++bi;
    }
    const long long bj = bi + (p - (bi * nt - bi * (bi - 1) / 2));
    const int ty = threadIdx.x / kTile;
    const int tx = threadIdx.x % kTile;
    const size_t plane = (size_t)n * n;

    // K[t, s] for target t = 16 bi + ty, source s = 16 bj + tx, s >= t on a
    // diagonal tile
    const int t = (int)(bi * kTile) + ty;
    const int s = (int)(bj * kTile) + tx;
    double v = 0.0, c = 0.0;
    if (t < n && s < n && (bi < bj || tx >= ty)) {
        const double xt = pts[2 * t], yt = pts[2 * t + 1];
        const double xs = pts[2 * s], ys = pts[2 * s + 1];
        const double dx = xs - xt, dy = ys - yt;
        const double r = sqrt(dx * dx + dy * dy);
        if (r != 0.0) {
            // E from the target to the source, as JAX's pure path
            const double E = line_integral<DEG>(F, rule, xt, yt, xs, ys);
            v = expm1(-E) / r;
            c = dx / r;
        }
        store_modes(out + (size_t)t * n + s, plane, v, c, w[s], diag[t],
                    r == 0.0, m0, D);
    }
    sv[ty][tx] = v;
    sc[ty][tx] = c;
    __syncthreads();
    // the mirrored entry K[s', t'] (s' = 16 bj + ty, t' = 16 bi + tx) of the
    // pair computed by thread (tx, ty): E the same, the direction reversed,
    // strictly below the diagonal on a diagonal tile (t' != s': r != 0)
    const int ms = (int)(bj * kTile) + ty;
    const int mt = (int)(bi * kTile) + tx;
    if (ms < n && mt < n && (bi < bj || ty > tx)) {
        store_modes(out + (size_t)ms * n + mt, plane, sv[tx][ty],
                    -sc[tx][ty], w[mt], 0.0, false, m0, D);
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

template <int DEG, typename TO>
void launch_dense(const Field& F, const double* pts, const double* w,
                  const double* diag, int n, int nt, long long tiles, int m0,
                  int D, TO* out, cudaStream_t stream) {
    dense_sym_kernel<DEG, TO><<<dim3((unsigned)tiles), kThreads, 0,
                                stream>>>(F, pts, w, diag, n, nt, m0, D, out);
}

#define ANISO_K7_DEGREES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

template <typename TO>
int dense_smooth(int sz, int deg, const void* gx, const void* gw,
                 const void* cn, int compat, const void* pts, const void* w,
                 const void* diag, int n, int m0, int D, void* out,
                 void* stream) {
    const Field F{sz, deg, compat, static_cast<const double*>(gx),
                  static_cast<const double*>(gw),
                  static_cast<const double*>(cn)};
    if (deg < 1 || n < 1 || D < 1 || m0 < 0) {
        return (int)cudaErrorInvalidValue;
    }
    const int nt = (n + kTile - 1) / kTile;
    const long long tiles = (long long)nt * (nt + 1) / 2;
    if (tiles > 0x7fffffffLL) {
        return (int)cudaErrorInvalidConfiguration;
    }
    const auto* p = static_cast<const double*>(pts);
    const auto* wp = static_cast<const double*>(w);
    const auto* dg = static_cast<const double*>(diag);
    auto* o = static_cast<TO*>(out);
    auto st = (cudaStream_t)stream;
    switch (deg) {
#define ANISO_K7_CASE(DG)                                                  \
    case DG:                                                               \
        launch_dense<DG, TO>(F, p, wp, dg, n, nt, tiles, m0, D, o, st);    \
        break;
        ANISO_K7_DEGREES(ANISO_K7_CASE)
#undef ANISO_K7_CASE
        default:
            launch_dense<0, TO>(F, p, wp, dg, n, nt, tiles, m0, D, o, st);
    }
    return (int)cudaGetLastError();
}

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

// the (D, n, n) smooth matrices of modes m0 .. m0 + D - 1 into out, stored
// as float64 or float32
extern "C" int aniso_dense_smooth_f64(
    int sz, int deg, const void* gx, const void* gw, const void* cn,
    int compat, const void* pts, const void* w, const void* diag, int n,
    int m0, int D, void* out, void* stream) {
    return dense_smooth<double>(sz, deg, gx, gw, cn, compat, pts, w, diag, n,
                                m0, D, out, stream);
}

extern "C" int aniso_dense_smooth_f32(
    int sz, int deg, const void* gx, const void* gw, const void* cn,
    int compat, const void* pts, const void* w, const void* diag, int n,
    int m0, int D, void* out, void* stream) {
    return dense_smooth<float>(sz, deg, gx, gw, cn, compat, pts, w, diag, n,
                               m0, D, out, stream);
}
