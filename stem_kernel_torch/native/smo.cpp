// Native SMO solver for the C-SVC dual on precomputed kernels.
//
// The port's copy of stem_kernel_tpu/native/smo.cpp, arithmetic unchanged:
// the C++ counterpart of stem_kernel_torch/svm/solver.py (and of the
// reference's modified LIBSVM Solver, stem_kernel/libsvm/solver.cpp:82-475):
// maximal violating pair selection with second-order (WSS-3) tie-breaking.
// Exposed with C linkage for ctypes (stem_kernel_torch/native/__init__.py);
// the NumPy implementation stays as the plain version, agreeing to solver
// tolerance.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {
constexpr double TAU = 1e-12;
}

// Templated on the K element type: the Gram matrices of this framework are
// float32-born, and converting an n*n matrix to double cost 50x the solve
// itself at n = 30k (measured for the JAX package) — the f32 instantiation
// reads K directly and keeps all solver arithmetic in double.
template <typename KT>
static int smo_solve_impl(
    const KT* K,          // n*n kernel matrix, row-major
    const double* y,      // labels +-1
    const double* p,      // linear term (usually -1)
    int n,
    double C_p, double C_n,
    double eps,
    long max_iter,
    double* alpha_out,    // n
    double* rho_out,      // 1
    double* obj_out,      // 1
    long* iter_out)       // 1
{
    std::vector<double> alpha(n, 0.0), G(p, p + n), C(n), Kd(n);
    for (int i = 0; i < n; ++i) {
        C[i] = y[i] > 0 ? C_p : C_n;
        Kd[i] = K[(int64_t)i * n + i];
    }

    long it = 0;
    while (it < max_iter) {
        // select i: max over I_up of -y_i G_i
        int i = -1;
        double G_max = -1e300, G_min = 1e300;
        for (int t = 0; t < n; ++t) {
            bool up = (y[t] > 0 && alpha[t] < C[t]) || (y[t] < 0 && alpha[t] > 0);
            if (up) {
                double v = -y[t] * G[t];
                if (v > G_max) { G_max = v; i = t; }
            }
        }
        if (i < 0) break;
        const KT* Ki = K + (int64_t)i * n;
        // select j: second-order among I_low with violation
        int j = -1;
        double best = 1e300;
        for (int t = 0; t < n; ++t) {
            bool low = (y[t] > 0 && alpha[t] > 0) || (y[t] < 0 && alpha[t] < C[t]);
            if (!low) continue;
            double nyG = -y[t] * G[t];
            if (nyG < G_min) G_min = nyG;
            double b = G_max + y[t] * G[t];
            if (b > 0) {
                double a = Kd[i] + Kd[t] - 2.0 * Ki[t];
                if (a <= 0) a = TAU;
                double od = -(b * b) / a;
                if (od < best) { best = od; j = t; }
            }
        }
        if (G_max - G_min < eps || j < 0) break;
        const KT* Kj = K + (int64_t)j * n;

        double quad = Kd[i] + Kd[j] - 2.0 * Ki[j];
        if (quad <= 0) quad = TAU;
        double ai = alpha[i], aj = alpha[j];
        if (y[i] != y[j]) {
            double delta = (-G[i] - G[j]) / quad;
            double diff = ai - aj;
            ai += delta; aj += delta;
            if (diff > 0) { if (aj < 0) { aj = 0; ai = diff; } }
            else { if (ai < 0) { ai = 0; aj = -diff; } }
            if (diff > C[i] - C[j]) { if (ai > C[i]) { ai = C[i]; aj = C[i] - diff; } }
            else { if (aj > C[j]) { aj = C[j]; ai = C[j] + diff; } }
        } else {
            double delta = (G[i] - G[j]) / quad;
            double sum = ai + aj;
            ai -= delta; aj += delta;
            if (sum > C[i]) { if (ai > C[i]) { ai = C[i]; aj = sum - C[i]; } }
            else { if (aj < 0) { aj = 0; ai = sum; } }
            if (sum > C[j]) { if (aj > C[j]) { aj = C[j]; ai = sum - C[j]; } }
            else { if (ai < 0) { ai = 0; aj = sum; } }
        }
        double d_i = ai - alpha[i], d_j = aj - alpha[j];
        alpha[i] = ai; alpha[j] = aj;
        double yi = y[i], yj = y[j];
        for (int t = 0; t < n; ++t)
            G[t] += yi * y[t] * Ki[t] * d_i + yj * y[t] * Kj[t] * d_j;
        ++it;
    }

    // rho (calculate_rho): free SVs have y_i G_i == rho
    double sum_free = 0; int n_free = 0;
    double ub = 1e300, lb = -1e300;
    for (int t = 0; t < n; ++t) {
        double yG = y[t] * G[t];
        if (alpha[t] > 0 && alpha[t] < C[t]) { sum_free += yG; ++n_free; }
        else if ((y[t] > 0 && alpha[t] == 0) || (y[t] < 0 && alpha[t] == C[t])) {
            if (yG < ub) ub = yG;
        } else {
            if (yG > lb) lb = yG;
        }
    }
    double rho = n_free > 0 ? sum_free / n_free : (ub + lb) / 2.0;

    double obj = 0;
    for (int t = 0; t < n; ++t) obj += alpha[t] * (G[t] + p[t]);
    obj *= 0.5;

    for (int t = 0; t < n; ++t) alpha_out[t] = alpha[t];
    *rho_out = rho;
    *obj_out = obj;
    *iter_out = it;
    return 0;
}

extern "C" int smo_solve(
    const double* K, const double* y, const double* p, int n,
    double C_p, double C_n, double eps, long max_iter,
    double* alpha_out, double* rho_out, double* obj_out, long* iter_out)
{
    return smo_solve_impl<double>(K, y, p, n, C_p, C_n, eps, max_iter,
                                  alpha_out, rho_out, obj_out, iter_out);
}

extern "C" int smo_solve_f32(
    const float* K, const double* y, const double* p, int n,
    double C_p, double C_n, double eps, long max_iter,
    double* alpha_out, double* rho_out, double* obj_out, long* iter_out)
{
    return smo_solve_impl<float>(K, y, p, n, C_p, C_n, eps, max_iter,
                                 alpha_out, rho_out, obj_out, iter_out);
}

// nu-formulation SMO (the reference's Solver_NU, libsvm/solver.cpp:559-718):
// two equality constraints, so working pairs must share a class — the
// maximal-violating-pair / second-order criterion runs independently inside
// y=+1 and y=-1 and takes the better of the two.  Native counterpart of
// stem_kernel_torch/svm/solver.py:smo_solve_nu_numpy.
template <typename KT>
static int smo_solve_nu_impl(
    const KT* K,
    const double* y,
    const double* p,
    int n,
    double C_p, double C_n,
    const double* alpha0,   // feasible start (fixes both equality constants)
    double eps,
    long max_iter,
    double* alpha_out,
    double* rho_out,        // (r1 - r2)/2
    double* r_out,          // (r1 + r2)/2
    double* obj_out,
    long* iter_out)
{
    std::vector<double> alpha(alpha0, alpha0 + n), G(n), C(n), Kd(n);
    for (int i = 0; i < n; ++i) {
        C[i] = y[i] > 0 ? C_p : C_n;
        Kd[i] = K[(int64_t)i * n + i];
    }
    // G = y * (K @ (y*alpha)) + p
    for (int t = 0; t < n; ++t) {
        double acc = 0;
        const KT* Kt = K + (int64_t)t * n;
        for (int u = 0; u < n; ++u) acc += (double)Kt[u] * y[u] * alpha[u];
        G[t] = y[t] * acc + p[t];
    }

    long it = 0;
    while (it < max_iter) {
        int ip = -1, in_ = -1;
        double Gmaxp = -1e300, Gmaxn = -1e300, Gmaxp2 = -1e300, Gmaxn2 = -1e300;
        for (int t = 0; t < n; ++t) {
            if (y[t] > 0) {
                if (alpha[t] < C[t] && -G[t] > Gmaxp) { Gmaxp = -G[t]; ip = t; }
                if (alpha[t] > 0 && G[t] > Gmaxp2) Gmaxp2 = G[t];
            } else {
                if (alpha[t] > 0 && G[t] > Gmaxn) { Gmaxn = G[t]; in_ = t; }
                if (alpha[t] < C[t] && -G[t] > Gmaxn2) Gmaxn2 = -G[t];
            }
        }
        double viol = Gmaxp + Gmaxp2 > Gmaxn + Gmaxn2 ? Gmaxp + Gmaxp2
                                                      : Gmaxn + Gmaxn2;
        if (viol < eps) break;

        int bi = -1, bj = -1;
        double best = 1e300;
        if (ip >= 0) {
            const KT* Ki = K + (int64_t)ip * n;
            for (int t = 0; t < n; ++t) {
                if (!(y[t] > 0 && alpha[t] > 0)) continue;
                double b = Gmaxp + G[t];
                if (b > 0) {
                    double a = Kd[ip] + Kd[t] - 2.0 * Ki[t];
                    if (a <= 0) a = TAU;
                    double od = -(b * b) / a;
                    if (od < best) { best = od; bi = ip; bj = t; }
                }
            }
        }
        if (in_ >= 0) {
            const KT* Ki = K + (int64_t)in_ * n;
            for (int t = 0; t < n; ++t) {
                if (!(y[t] < 0 && alpha[t] < C[t])) continue;
                double b = Gmaxn - G[t];
                if (b > 0) {
                    double a = Kd[in_] + Kd[t] - 2.0 * Ki[t];
                    if (a <= 0) a = TAU;
                    double od = -(b * b) / a;
                    if (od < best) { best = od; bi = in_; bj = t; }
                }
            }
        }
        if (bi < 0) break;
        int i = bi, j = bj;
        const KT* Ki = K + (int64_t)i * n;
        const KT* Kj = K + (int64_t)j * n;

        // same-class 2-variable update
        double quad = Kd[i] + Kd[j] - 2.0 * Ki[j];
        if (quad <= 0) quad = TAU;
        double delta = (G[i] - G[j]) / quad;
        double s = alpha[i] + alpha[j];
        double ai = alpha[i] - delta, aj = alpha[j] + delta;
        if (s > C[i]) { if (ai > C[i]) { ai = C[i]; aj = s - C[i]; } }
        else { if (aj < 0) { aj = 0; ai = s; } }
        if (s > C[j]) { if (aj > C[j]) { aj = C[j]; ai = s - C[j]; } }
        else { if (ai < 0) { ai = 0; aj = s; } }

        double d_i = ai - alpha[i], d_j = aj - alpha[j];
        alpha[i] = ai; alpha[j] = aj;
        double yi = y[i], yj = y[j];
        for (int t = 0; t < n; ++t)
            G[t] += yi * y[t] * Ki[t] * d_i + yj * y[t] * Kj[t] * d_j;
        ++it;
    }

    // per-class r (calculate_rho, solver.cpp:676-718)
    double r_cls[2];
    for (int cls = 0; cls < 2; ++cls) {
        double want = cls == 0 ? 1.0 : -1.0;
        double sum_free = 0; int n_free = 0;
        double ub = 1e300, lb = -1e300;
        for (int t = 0; t < n; ++t) {
            if ((y[t] > 0) != (want > 0)) continue;
            if (alpha[t] > 0 && alpha[t] < C[t]) { sum_free += G[t]; ++n_free; }
            else if (alpha[t] >= C[t]) { if (G[t] > lb) lb = G[t]; }
            else { if (G[t] < ub) ub = G[t]; }
        }
        r_cls[cls] = n_free > 0 ? sum_free / n_free : (ub + lb) / 2.0;
    }
    *rho_out = (r_cls[0] - r_cls[1]) / 2.0;
    *r_out = (r_cls[0] + r_cls[1]) / 2.0;

    double obj = 0;
    for (int t = 0; t < n; ++t) obj += alpha[t] * (G[t] + p[t]);
    *obj_out = 0.5 * obj;
    for (int t = 0; t < n; ++t) alpha_out[t] = alpha[t];
    *iter_out = it;
    return 0;
}

extern "C" int smo_solve_nu(
    const double* K, const double* y, const double* p, int n,
    double C_p, double C_n, const double* alpha0, double eps, long max_iter,
    double* alpha_out, double* rho_out, double* r_out, double* obj_out,
    long* iter_out)
{
    return smo_solve_nu_impl<double>(K, y, p, n, C_p, C_n, alpha0, eps,
                                     max_iter, alpha_out, rho_out, r_out,
                                     obj_out, iter_out);
}

extern "C" int smo_solve_nu_f32(
    const float* K, const double* y, const double* p, int n,
    double C_p, double C_n, const double* alpha0, double eps, long max_iter,
    double* alpha_out, double* rho_out, double* r_out, double* obj_out,
    long* iter_out)
{
    return smo_solve_nu_impl<float>(K, y, p, n, C_p, C_n, alpha0, eps,
                                    max_iter, alpha_out, rho_out, r_out,
                                    obj_out, iter_out);
}
