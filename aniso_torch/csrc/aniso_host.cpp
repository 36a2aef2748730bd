// Host engine of aniso_torch: exact attenuation line integrals on the CPU.
//
// A copy of the attenuation part of the repository's csrc/aniso_host.cpp
// (aniso_attenuation_batch and the line integral it calls), kept beside the
// port so that the port builds its own library and never writes into the
// reference package's build.  The coarse per-pair M2L levels use it
// (fmm/smooth.py: _coarse_perpair_level_np).
//
// The quadrature is the reference lineIntegral (KernelFactory.cpp:67-190):
// the segment is split at gridline crossings and each piece is integrated
// with the per-cell Gauss rule on the per-square normalized Legendre
// expansion.  float64 throughout, OpenMP over pairs.
//
// Build: aniso_torch/_build.py (g++ -O3 -fopenmp -fPIC -shared -std=c++17).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// P_0..P_{deg-1} at x via the Legendre recurrence.
inline void legendre_all(int deg, double x, double* out) {
    out[0] = 1.0;
    if (deg > 1) out[1] = x;
    for (int n = 2; n < deg; ++n) {
        out[n] = ((2.0 * n - 1.0) * x * out[n - 1] -
                  (n - 1.0) * out[n - 2]) / n;
    }
}

struct Tables {
    int sz;
    int deg;
    const double* gauss_x;   // (deg) on [-1, 1]
    const double* gauss_w;   // (deg)
    const double* norms;     // (deg*deg)
    const double* coeffs;    // (sz*sz, deg*deg) row-major, cell (i, j) at i*sz+j
    int compat_global;       // evaluate basis at global coords (reference quirk)
};

// sigma_hat at one point inside cell (i, j), local coords (ex, ey) in [-1,1].
inline double eval_sigma(const Tables& T, int i, int j, double ex, double ey) {
    const int deg = T.deg;
    double px[64], py[64];
    legendre_all(deg, ex, px);
    legendre_all(deg, ey, py);
    const double* c = T.coeffs + (size_t)(i * T.sz + j) * deg * deg;
    double acc = 0.0;
    for (int a = 0; a < deg; ++a) {
        double pa = px[a];
        const double* row = c + a * deg;
        const double* nrm = T.norms + a * deg;
        for (int b = 0; b < deg; ++b) {
            acc += row[b] * pa * py[b] / nrm[b];
        }
    }
    return acc;
}

// Exact attenuation integral along p0 -> p1 (physical coords in [0,1]^2).
double line_integral(const Tables& T, double x0, double y0,
                     double x1, double y1, std::vector<double>& ts) {
    const int sz = T.sz;
    const int deg = T.deg;
    const double dx = x1 - x0, dy = y1 - y0;
    const double len = std::sqrt(dx * dx + dy * dy);
    if (len == 0.0) return 0.0;

    ts.clear();
    ts.push_back(0.0);
    ts.push_back(1.0);
    // gridline crossings per axis (reference lineIntegral's 9-case split,
    // KernelFactory.cpp:67-166, reduced to crossing enumeration)
    for (int axis = 0; axis < 2; ++axis) {
        double a0 = axis ? y0 : x0;
        double a1 = axis ? y1 : x1;
        if (a0 == a1) continue;
        double lo = std::min(a0, a1), hi = std::max(a0, a1);
        long k_lo = (long)std::floor(lo * sz);
        long k_hi = (long)std::floor(hi * sz);
        for (long k = k_lo + 1; k <= k_hi; ++k) {
            double t = ((double)k / sz - a0) / (a1 - a0);
            if (t > 0.0 && t < 1.0) ts.push_back(t);
        }
    }
    std::sort(ts.begin(), ts.end());

    double E = 0.0;
    for (size_t s = 0; s + 1 < ts.size(); ++s) {
        double ta = ts[s], tb = ts[s + 1];
        double h = tb - ta;
        if (h <= 0.0) continue;
        double tm = 0.5 * (ta + tb);
        double xm = x0 + tm * dx, ym = y0 + tm * dy;
        int i = std::min(std::max((int)std::floor(xm * sz), 0), sz - 1);
        int j = std::min(std::max((int)std::floor(ym * sz), 0), sz - 1);
        double seg = 0.0;
        for (int g = 0; g < deg; ++g) {
            double tg = tm + 0.5 * h * T.gauss_x[g];
            double xg = x0 + tg * dx, yg = y0 + tg * dy;
            double ex, ey;
            if (T.compat_global) {
                ex = xg; ey = yg;
            } else {
                ex = 2.0 * (xg * sz - i) - 1.0;
                ey = 2.0 * (yg * sz - j) - 1.0;
            }
            seg += T.gauss_w[g] * eval_sigma(T, i, j, ex, ey);
        }
        E += seg * len * h * 0.5;
    }
    return E;
}

}  // namespace

extern "C" {

// E[k] = int_{p0_k -> p1_k} sigma_hat.  p0/p1: (n, 2) row-major physical.
void aniso_attenuation_batch(
    int sz, int deg,
    const double* gauss_x, const double* gauss_w, const double* norms,
    const double* coeffs, int compat_global,
    const double* p0, const double* p1, long n, double* out) {
    Tables T{sz, deg, gauss_x, gauss_w, norms, coeffs, compat_global};
#pragma omp parallel
    {
        std::vector<double> ts;
        ts.reserve(2 * sz + 4);
#pragma omp for schedule(static)
        for (long k = 0; k < n; ++k) {
            out[k] = line_integral(T, p0[2 * k], p0[2 * k + 1],
                                   p1[2 * k], p1[2 * k + 1], ts);
        }
    }
}

}  // extern "C"
