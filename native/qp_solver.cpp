// Dense convex QP solver:  min 0.5 z'Pz + q'z  s.t.  G z <= h
//
// Native (C++) counterpart of the compiled solvers the reference
// outsources to via CVXPY -- ECOS (interior point) and OSQP (ADMM),
// reference environment.yml:31-33, core/risk_metrics.py:156 and
// core/mpc_filter.py:151.  This engine's hot path runs the batched
// XLA/Pallas solvers on the GPU; this library is the host-side native
// backend: a CVXPY-free verification oracle for tests and a fallback
// solver where no accelerator is present.
//
// Algorithm: primal-dual interior point with Mehrotra
// predictor-corrector, dense Cholesky on the condensed normal matrix
// P + G' diag(lam/w) G.  Independent implementation (own linear
// algebra), deliberately NOT sharing code with the JAX solver so the
// two can serve as cross-checks.
//
// C ABI:
//   int qp_solve(int n, int m, const double* P, const double* q,
//                const double* G, const double* h,
//                int max_iters, double tol,
//                double* z_out, double* lam_out, double* info_out);
// info_out[0..3] = {gap, primal_violation, dual_residual, iterations}
// return 0 on convergence, 1 on max-iters without convergence,
// -1 on a numerical failure (Cholesky breakdown).

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Cholesky factorization A = L L' in place (lower). Returns false if a
// pivot drops below a tiny floor (numerical breakdown).
bool cholesky(std::vector<double>& A, int n) {
    for (int j = 0; j < n; ++j) {
        double d = A[j * n + j];
        for (int k = 0; k < j; ++k) d -= A[j * n + k] * A[j * n + k];
        if (d < 1e-300) return false;
        const double Ljj = std::sqrt(d);
        A[j * n + j] = Ljj;
        const double inv = 1.0 / Ljj;
        for (int i = j + 1; i < n; ++i) {
            double s = A[i * n + j];
            for (int k = 0; k < j; ++k) s -= A[i * n + k] * A[j * n + k];
            A[i * n + j] = s * inv;
        }
    }
    return true;
}

void chol_solve(const std::vector<double>& L, int n, double* x) {
    // L y = x
    for (int i = 0; i < n; ++i) {
        double s = x[i];
        for (int k = 0; k < i; ++k) s -= L[i * n + k] * x[k];
        x[i] = s / L[i * n + i];
    }
    // L' x = y
    for (int i = n - 1; i >= 0; --i) {
        double s = x[i];
        for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * x[k];
        x[i] = s / L[i * n + i];
    }
}

}  // namespace

extern "C" int qp_solve(int n, int m, const double* P, const double* q,
                        const double* G_in, const double* h_in,
                        int max_iters, double tol,
                        double* z_out, double* lam_out, double* info_out) {
    std::vector<double> G(G_in, G_in + (size_t)m * n);
    std::vector<double> h(h_in, h_in + m);

    // Row equilibration (match the JAX solver's conditioning strategy).
    std::vector<double> row_scale(m);
    for (int i = 0; i < m; ++i) {
        double mx = 0.0;
        for (int j = 0; j < n; ++j)
            mx = std::max(mx, std::fabs(G[(size_t)i * n + j]));
        row_scale[i] = std::max(mx, 1e-8);
        const double inv = 1.0 / row_scale[i];
        for (int j = 0; j < n; ++j) G[(size_t)i * n + j] *= inv;
        h[i] *= inv;
    }

    double q_scale = 1.0;
    for (int j = 0; j < n; ++j) q_scale = std::max(q_scale, std::fabs(q[j]));

    std::vector<double> z(n, 0.0), w(m), lam(m);
    for (int i = 0; i < m; ++i) {
        w[i] = std::max(h[i], 1.0);
        lam[i] = std::min(std::max(1.0 / w[i], 1e-6), 1e6);
    }

    std::vector<double> r_dual(n), r_prim(m), d(m);
    std::vector<double> M((size_t)n * n), rhs(n);
    std::vector<double> dz_a(n), dlam_a(m), dw_a(m);
    std::vector<double> dz(n), dlam(m), dw(m);
    std::vector<double> best_z(z), best_lam(lam);
    double best_merit = 1e300;
    const double reg = 1e-10;

    auto merit_of = [&](const std::vector<double>& zz,
                        const std::vector<double>& ll) {
        double mu = 0.0, viol = 0.0, rd = 0.0;
        for (int i = 0; i < m; ++i) {
            double gz = 0.0;
            for (int j = 0; j < n; ++j) gz += G[(size_t)i * n + j] * zz[j];
            viol = std::max(viol, gz - h[i]);
        }
        for (int j = 0; j < n; ++j) {
            double s = q[j];
            for (int k = 0; k < n; ++k) s += P[(size_t)j * n + k] * zz[k];
            for (int i = 0; i < m; ++i)
                s += G[(size_t)i * n + j] * ll[i];
            rd = std::max(rd, std::fabs(s));
        }
        for (int i = 0; i < m; ++i) mu += ll[i] * w[i];
        mu /= m;
        return (mu + std::max(viol, 0.0) + rd) / q_scale;
    };

    int it = 0;
    for (; it < max_iters; ++it) {
        // Residuals.
        for (int j = 0; j < n; ++j) {
            double s = q[j];
            for (int k = 0; k < n; ++k) s += P[(size_t)j * n + k] * z[k];
            for (int i = 0; i < m; ++i) s += G[(size_t)i * n + j] * lam[i];
            r_dual[j] = s;
        }
        double mu = 0.0;
        for (int i = 0; i < m; ++i) {
            double gz = 0.0;
            for (int j = 0; j < n; ++j) gz += G[(size_t)i * n + j] * z[j];
            r_prim[i] = gz + w[i] - h[i];
            mu += lam[i] * w[i];
        }
        mu /= m;

        const double merit = merit_of(z, lam);
        if (merit < best_merit) {
            best_merit = merit;
            best_z = z;
            best_lam = lam;
        }
        if (best_merit < tol) break;

        // Normal matrix M = P + G' D G + reg I.
        for (int i = 0; i < m; ++i)
            d[i] = std::min(std::max(lam[i] / w[i], 1e-10), 1e10);
        for (int j = 0; j < n; ++j)
            for (int k = 0; k <= j; ++k) {
                double s = P[(size_t)j * n + k];
                for (int i = 0; i < m; ++i)
                    s += G[(size_t)i * n + j] * d[i] * G[(size_t)i * n + k];
                M[(size_t)j * n + k] = s;
                M[(size_t)k * n + j] = s;
            }
        for (int j = 0; j < n; ++j) M[(size_t)j * n + j] += reg;
        if (!cholesky(M, n)) {
            it = -1;
            break;
        }

        auto newton = [&](const std::vector<double>& r_cent,
                          std::vector<double>& oz, std::vector<double>& ol,
                          std::vector<double>& ow) {
            for (int j = 0; j < n; ++j) {
                double s = -r_dual[j];
                for (int i = 0; i < m; ++i)
                    s -= G[(size_t)i * n + j] *
                         (d[i] * r_prim[i] - r_cent[i] / w[i]);
                rhs[j] = s;
            }
            oz.assign(rhs.begin(), rhs.end());
            chol_solve(M, n, oz.data());
            for (int i = 0; i < m; ++i) {
                double gdz = 0.0;
                for (int j = 0; j < n; ++j)
                    gdz += G[(size_t)i * n + j] * oz[j];
                ol[i] = d[i] * (gdz + r_prim[i]) - r_cent[i] / w[i];
                ow[i] = -(r_cent[i] + w[i] * ol[i]) / lam[i];
            }
        };

        auto pos_step = [&](const std::vector<double>& v,
                            const std::vector<double>& dv, double frac) {
            double a = 1.0;
            for (int i = 0; i < m; ++i)
                if (dv[i] < 0.0) a = std::min(a, frac * (-v[i] / dv[i]));
            return a;
        };

        // Predictor.
        std::vector<double> r_cent(m);
        for (int i = 0; i < m; ++i) r_cent[i] = lam[i] * w[i];
        newton(r_cent, dz_a, dlam_a, dw_a);
        const double ap_a = pos_step(w, dw_a, 1.0);
        const double ad_a = pos_step(lam, dlam_a, 1.0);
        double mu_aff = 0.0;
        for (int i = 0; i < m; ++i)
            mu_aff += (lam[i] + ad_a * dlam_a[i]) * (w[i] + ap_a * dw_a[i]);
        mu_aff /= m;
        const double sigma_r = mu_aff / std::max(mu, 1e-30);
        const double sigma = sigma_r * sigma_r * sigma_r;

        // Corrector.
        for (int i = 0; i < m; ++i)
            r_cent[i] = lam[i] * w[i] + dlam_a[i] * dw_a[i] - sigma * mu;
        newton(r_cent, dz, dlam, dw);
        const double ap = pos_step(w, dw, 0.99);
        const double ad = pos_step(lam, dlam, 0.99);
        for (int j = 0; j < n; ++j) z[j] += ap * dz[j];
        for (int i = 0; i < m; ++i) {
            w[i] += ap * dw[i];
            lam[i] += ad * dlam[i];
        }
    }

    const bool chol_fail = (it == -1);
    // Final candidate check.
    if (!chol_fail) {
        const double merit = merit_of(z, lam);
        if (merit < best_merit) {
            best_merit = merit;
            best_z = z;
            best_lam = lam;
        }
    }

    double gap = 0.0, viol = 0.0, rd = 0.0;
    for (int i = 0; i < m; ++i) gap += best_lam[i] * w[i];
    gap /= m;
    for (int i = 0; i < m; ++i) {
        double gz = 0.0;
        for (int j = 0; j < n; ++j) gz += G[(size_t)i * n + j] * best_z[j];
        viol = std::max(viol, gz - h[i]);
    }
    for (int j = 0; j < n; ++j) {
        double s = q[j];
        for (int k = 0; k < n; ++k) s += P[(size_t)j * n + k] * best_z[k];
        for (int i = 0; i < m; ++i) s += G[(size_t)i * n + j] * best_lam[i];
        rd = std::max(rd, std::fabs(s));
    }

    std::memcpy(z_out, best_z.data(), sizeof(double) * n);
    for (int i = 0; i < m; ++i) lam_out[i] = best_lam[i] / row_scale[i];
    info_out[0] = gap;
    info_out[1] = std::max(viol, 0.0);
    info_out[2] = rd;
    info_out[3] = (double)(chol_fail ? max_iters : it);

    if (chol_fail) return -1;
    return best_merit < tol ? 0 : 1;
}
