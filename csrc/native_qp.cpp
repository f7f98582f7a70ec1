// Native CPU QP engine: OSQP-style ADMM in long-double precision.
//
// Role in the framework (the C++ runtime component, parallel to the
// reference library's native C++ core):
//   * high-precision ORACLE for property-based conformance tests — solves
//     arbitrary QPs to ~1e-14 so the JAX solver's accuracy can be
//     measured against ground truth on random instances, not just the
//     fixtures (tests and bench.py only; never a solver fallback).
//
// Algorithm: the same design as sqp_solver_tpu.qp (Schur-
// complement reduction of the KKT system + dense Cholesky, per-constraint
// rho with loose/equality classification, over-relaxation, residual
// termination, adaptive rho with re-factorization) — written from scratch
// in C++17, no external dependencies.  Semantics cite the reference
// implementation (src/qp.cpp) for parity, not for code.
//
// Build: g++ -O2 -std=c++17 -shared -fPIC -o libnative_qp.so native_qp.cpp -lpthread

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using Real = long double;

constexpr Real RHO_MIN = 1e-6L;
constexpr Real RHO_MAX = 1e+6L;
constexpr Real RHO_TOL = 1e-4L;
constexpr Real RHO_EQ_FACTOR = 1e+3L;
constexpr Real LOOSE_THRESH = 1e+16L;

struct Settings {
    double rho, sigma, alpha, eps_abs, eps_rel, adaptive_rho_tolerance;
    int32_t max_iter, check_termination, adaptive_rho_interval;
    int32_t adaptive_rho;  // bool
};

// dense column-major-free helpers (row-major throughout)
class Work {
   public:
    int n, m;
    std::vector<Real> P, q, A, l, u;      // problem data
    std::vector<Real> M, L;               // Schur matrix + Cholesky factor
    std::vector<Real> rho_vec, rho_inv;
    std::vector<int> ctype;
    std::vector<Real> x, z, y, xt, zt, rhs, tmp_m, tmp_n;

    Work(int n_, int m_) : n(n_), m(m_) {
        P.resize(n * n);
        q.resize(n);
        A.resize(m * n);
        l.resize(m);
        u.resize(m);
        M.resize(n * n);
        L.resize(n * n);
        rho_vec.resize(m);
        rho_inv.resize(m);
        ctype.resize(m);
        x.assign(n, 0);
        z.assign(m, 0);
        y.assign(m, 0);
        xt.resize(n);
        zt.resize(m);
        rhs.resize(n);
        tmp_m.resize(m);
        tmp_n.resize(n);
    }

    void classify() {
        // loose / equality / inequality rows (reference src/qp.cpp:284-294)
        for (int i = 0; i < m; ++i) {
            if (l[i] < -LOOSE_THRESH && u[i] > LOOSE_THRESH)
                ctype[i] = 2;
            else if (u[i] - l[i] < RHO_TOL)
                ctype[i] = 1;
            else
                ctype[i] = 0;
        }
    }

    void rho_update(Real rho0) {
        for (int i = 0; i < m; ++i) {
            Real r = ctype[i] == 2 ? RHO_MIN : (ctype[i] == 1 ? RHO_EQ_FACTOR * rho0 : rho0);
            rho_vec[i] = r;
            rho_inv[i] = Real(1) / r;
        }
    }

    // M = P + sigma*I + A' diag(rho) A; factor M = L L'
    bool factor(Real sigma) {
        for (int i = 0; i < n; ++i)
            for (int j = 0; j < n; ++j) M[i * n + j] = P[i * n + j];
        for (int i = 0; i < n; ++i) M[i * n + i] += sigma;
        for (int k = 0; k < m; ++k) {
            const Real* ak = &A[k * n];
            const Real rk = rho_vec[k];
            for (int i = 0; i < n; ++i) {
                const Real s = rk * ak[i];
                if (s == Real(0)) continue;
                for (int j = 0; j < n; ++j) M[i * n + j] += s * ak[j];
            }
        }
        // left-looking Cholesky
        for (int j = 0; j < n; ++j) {
            Real d = M[j * n + j];
            for (int k = 0; k < j; ++k) d -= L[j * n + k] * L[j * n + k];
            if (!(d > Real(0))) return false;
            const Real lj = sqrtl(d);
            L[j * n + j] = lj;
            for (int i = j + 1; i < n; ++i) {
                Real s = M[i * n + j];
                for (int k = 0; k < j; ++k) s -= L[i * n + k] * L[j * n + k];
                L[i * n + j] = s / lj;
            }
        }
        return true;
    }

    void cho_solve(Real* b) {
        for (int i = 0; i < n; ++i) {
            Real s = b[i];
            for (int k = 0; k < i; ++k) s -= L[i * n + k] * b[k];
            b[i] = s / L[i * n + i];
        }
        for (int i = n - 1; i >= 0; --i) {
            Real s = b[i];
            for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * b[k];
            b[i] = s / L[i * n + i];
        }
    }

    Real linf(const Real* v, int len) const {
        Real r = 0;
        for (int i = 0; i < len; ++i) r = std::max(r, fabsl(v[i]));
        return r;
    }

    // out = A x (len m) / out = A' y (len n)
    void Ax(const Real* v, Real* out) const {
        for (int i = 0; i < m; ++i) {
            Real s = 0;
            for (int j = 0; j < n; ++j) s += A[i * n + j] * v[j];
            out[i] = s;
        }
    }
    void ATy(const Real* v, Real* out) const {
        for (int j = 0; j < n; ++j) out[j] = 0;
        for (int i = 0; i < m; ++i) {
            const Real vi = v[i];
            if (vi == Real(0)) continue;
            for (int j = 0; j < n; ++j) out[j] += A[i * n + j] * vi;
        }
    }
    void Px(const Real* v, Real* out) const {
        for (int i = 0; i < n; ++i) {
            Real s = 0;
            for (int j = 0; j < n; ++j) s += P[i * n + j] * v[j];
            out[i] = s;
        }
    }

    // ADMM main loop (reference semantics: src/qp.cpp:65-157)
    int solve(const Settings& st, int32_t* iter_out) {
        const Real sigma = st.sigma, alpha = st.alpha;
        Real rho = st.rho;
        classify();
        rho_update(rho);
        if (!factor(sigma)) return 3;  // NUMERICAL_ISSUES

        Real res_prim = 0, res_dual = 0, max_Ax_z = 0, max_Px_ATy_q = 0;
        int iter = 1;
        bool solved = false;
        for (; iter <= st.max_iter; ++iter) {
            // x~ = M^-1 (sigma x - q + A'(rho z - y)); z~ = A x~
            for (int i = 0; i < m; ++i) tmp_m[i] = rho_vec[i] * z[i] - y[i];
            ATy(tmp_m.data(), rhs.data());
            for (int i = 0; i < n; ++i) rhs[i] += sigma * x[i] - q[i];
            cho_solve(rhs.data());
            for (int i = 0; i < n; ++i) xt[i] = rhs[i];
            Ax(xt.data(), zt.data());

            for (int i = 0; i < n; ++i) x[i] = alpha * xt[i] + (Real(1) - alpha) * x[i];
            for (int i = 0; i < m; ++i) {
                const Real z_pre = alpha * zt[i] + (Real(1) - alpha) * z[i];
                Real zn = z_pre + rho_inv[i] * y[i];
                zn = std::min(std::max(zn, l[i]), u[i]);
                y[i] += rho_vec[i] * (z_pre - zn);
                z[i] = zn;
            }

            const bool check =
                st.check_termination > 0 && iter % st.check_termination == 0;
            const bool adapt =
                st.adaptive_rho && iter % st.adaptive_rho_interval == 0;
            if (check || adapt) {
                Ax(x.data(), tmp_m.data());
                Real nAx = linf(tmp_m.data(), m);
                for (int i = 0; i < m; ++i) tmp_m[i] -= z[i];
                res_prim = linf(tmp_m.data(), m);
                Px(x.data(), tmp_n.data());
                Real nPx = linf(tmp_n.data(), n);
                ATy(y.data(), rhs.data());
                Real nATy = linf(rhs.data(), n);
                for (int i = 0; i < n; ++i) tmp_n[i] += q[i] + rhs[i];
                res_dual = linf(tmp_n.data(), n);
                max_Ax_z = std::max(nAx, linf(z.data(), m));
                max_Px_ATy_q = std::max(nPx, std::max(nATy, linf(q.data(), n)));
            }
            if (check) {
                const Real ep = st.eps_abs + st.eps_rel * max_Ax_z;
                const Real ed = st.eps_abs + st.eps_rel * max_Px_ATy_q;
                if (res_prim <= ep && res_dual <= ed) {
                    solved = true;
                    break;
                }
            }
            if (adapt) {
                const Real tinyv = 1e-30L;
                Real rp = res_prim / (max_Ax_z + tinyv);
                Real rd = res_dual / (max_Px_ATy_q + tinyv);
                Real nr = rho * sqrtl(rp / (rd + tinyv));
                nr = std::min(std::max(nr, RHO_MIN), RHO_MAX);
                if (nr < rho / (Real)st.adaptive_rho_tolerance ||
                    nr > rho * (Real)st.adaptive_rho_tolerance) {
                    rho = nr;
                    rho_update(rho);
                    if (!factor(sigma)) return 3;
                }
            }
        }
        *iter_out = iter;
        return solved ? 0 : 1;  // SOLVED / MAX_ITER_EXCEEDED
    }
};

void solve_one(const double* P, const double* q, const double* A, const double* l,
               const double* u, int n, int m, const Settings* st, double* x_out,
               double* y_out, int32_t* status, int32_t* iters) {
    Work w(n, m);
    for (int i = 0; i < n * n; ++i) w.P[i] = P[i];
    for (int i = 0; i < n; ++i) w.q[i] = q[i];
    for (int i = 0; i < m * n; ++i) w.A[i] = A[i];
    for (int i = 0; i < m; ++i) {
        w.l[i] = l[i];
        w.u[i] = u[i];
    }
    int32_t it = 0;
    *status = w.solve(*st, &it);
    *iters = it;
    for (int i = 0; i < n; ++i) x_out[i] = (double)w.x[i];
    for (int i = 0; i < m; ++i) y_out[i] = (double)w.y[i];
}

}  // namespace

extern "C" {

// Solve one QP.  Row-major double arrays; returns status code
// (0 SOLVED, 1 MAX_ITER_EXCEEDED, 3 NUMERICAL_ISSUES).
int32_t nq_solve(const double* P, const double* q, const double* A,
                 const double* l, const double* u, int32_t n, int32_t m,
                 const Settings* st, double* x_out, double* y_out,
                 int32_t* iters) {
    int32_t status = 0;
    solve_one(P, q, A, l, u, n, m, st, x_out, y_out, &status, iters);
    return status;
}

// Solve a batch of B QPs (contiguous layouts), multi-threaded.
void nq_solve_batch(const double* P, const double* q, const double* A,
                    const double* l, const double* u, int32_t n, int32_t m,
                    int32_t B, const Settings* st, double* x_out, double* y_out,
                    int32_t* status, int32_t* iters, int32_t n_threads) {
    if (n_threads <= 0) n_threads = (int32_t)std::thread::hardware_concurrency();
    n_threads = std::max(1, std::min((int)n_threads, (int)B));
    std::vector<std::thread> pool;
    const int64_t nn = (int64_t)n * n, mn = (int64_t)m * n;
    auto worker = [&](int tid) {
        for (int b = tid; b < B; b += n_threads) {
            solve_one(P + b * nn, q + b * n, A + b * mn, l + b * m, u + b * m, n,
                      m, st, x_out + b * n, y_out + b * m, status + b, iters + b);
        }
    };
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
    for (auto& th : pool) th.join();
}

}  // extern "C"
