// seqsmo — native sequential modified-SMO trainer + predictor.
//
// Native-runtime equivalent of the reference's CPU binaries: the
// sequential trainer seq.cpp (main loop seq.cpp:195-260, I-set selection
// seq.cpp:469-553, f update seq.cpp:378-386) and the CPU tester
// seq_test.cpp (decision sum, seq_test.cpp:187-210). The reference uses
// CBLAS saxpy/sdot per kernel evaluation; here rows are evaluated with
// plain tight loops that g++ -O3 auto-vectorizes, and the known reference
// bugs are fixed: eta is clamped (B2), b participates in prediction with
// one convention, f(x) = sum_j coef_j K(x_j, x) - b (B5/B6).
//
// This is the host-side correctness oracle and small-problem fast path;
// the device engines (solver/solve.py, parallel/dist_smo.py) are the
// scale path. A copy of the JAX package's engine, so both packages' host
// backends train alike. C ABI, consumed via ctypes
// (dpsvm_tpu_torch/utils/native.py).

#include <cmath>
#include <cstring>
#include <vector>

namespace {

// Kernel kinds, matching utils/native.py _KERNEL_KINDS.
enum Kind { LINEAR = 0, RBF = 1, POLY = 2, SIGMOID = 3 };

inline float dot(const float* a, const float* b, long d) {
    float s = 0.0f;
    for (long j = 0; j < d; ++j) s += a[j] * b[j];
    return s;
}

inline float kernel_value(float dp, float qa_sq, float qb_sq, int kind,
                          float gamma, int degree, float coef0) {
    switch (kind) {
        case LINEAR: return dp;
        case RBF: {
            float sq = qa_sq + qb_sq - 2.0f * dp;
            if (sq < 0.0f) sq = 0.0f;
            return std::exp(-gamma * sq);
        }
        case POLY: return std::pow(gamma * dp + coef0, (float)degree);
        default: return std::tanh(gamma * dp + coef0);
    }
}

// K(x_i, .) against all n rows into out[n].
void kernel_row(const float* x, const float* x_sq, long n, long d, long i,
                int kind, float gamma, int degree, float coef0, float* out) {
    const float* xi = x + i * d;
    const float xi_sq = x_sq[i];
    for (long r = 0; r < n; ++r) {
        float dp = dot(x + r * d, xi, d);
        out[r] = kernel_value(dp, x_sq[r], xi_sq, kind, gamma, degree, coef0);
    }
}

}  // namespace

extern "C" {

// Train binary C-SVC by sequential modified SMO (Keerthi et al.
// "modification 2": global most-violating (I_up, I_low) pair, the
// algorithm of seq.cpp:195-260).
//
//   x      n*d row-major features, y  n labels in {-1,+1}
//   c_pos/c_neg  per-class box bounds C * w_{+1} / C * w_{-1} (equal for
//                the unweighted problem)
//   out_alpha[n], out_f[n] caller-allocated; out_scalars[4] receives
//   {b, b_hi, b_lo, converged(0/1)}.
// Returns iterations executed, or negative on error.
long seqsmo_train(const float* x, const int* y, long n, long d,
                  float c_pos, float c_neg, float gamma, float eps, float tau,
                  long max_iter, int kernel_kind, int degree, float coef0,
                  float* out_alpha, float* out_f, float* out_scalars) {
    if (n <= 0 || d <= 0 || max_iter < 0) return -1;
    std::vector<float> x_sq((size_t)n);
    for (long i = 0; i < n; ++i) x_sq[(size_t)i] = dot(x + i * d, x + i * d, d);

    float* alpha = out_alpha;
    float* f = out_f;
    std::memset(alpha, 0, sizeof(float) * (size_t)n);
    for (long i = 0; i < n; ++i) f[i] = -(float)y[i];  // f=-y at alpha=0

    std::vector<float> k_hi((size_t)n), k_lo((size_t)n);
    float b_hi = 0.0f, b_lo = 0.0f;
    long it = 0;
    bool converged = (max_iter == 0);
    while (it < max_iter) {
        // Most-violating pair over the Keerthi I-sets (seq.cpp:469-553):
        // I_up = {alpha<C, y=+1} U {alpha>0, y=-1}, I_low mirrored.
        long i_hi = -1, i_lo = -1;
        float f_hi = 0.0f, f_lo = 0.0f;
        for (long i = 0; i < n; ++i) {
            bool pos = y[i] > 0;
            float ci = pos ? c_pos : c_neg;
            bool up = pos ? (alpha[i] < ci) : (alpha[i] > 0.0f);
            bool low = pos ? (alpha[i] > 0.0f) : (alpha[i] < ci);
            if (up && (i_hi < 0 || f[i] < f_hi)) { f_hi = f[i]; i_hi = i; }
            if (low && (i_lo < 0 || f[i] > f_lo)) { f_lo = f[i]; i_lo = i; }
        }
        if (i_hi < 0 || i_lo < 0) { converged = true; break; }
        b_hi = f_hi;
        b_lo = f_lo;

        kernel_row(x, x_sq.data(), n, d, i_hi, kernel_kind, gamma, degree,
                   coef0, k_hi.data());
        kernel_row(x, x_sq.data(), n, d, i_lo, kernel_kind, gamma, degree,
                   coef0, k_lo.data());
        float eta = k_hi[(size_t)i_hi] + k_lo[(size_t)i_lo]
                    - 2.0f * k_hi[(size_t)i_lo];
        if (eta < tau) eta = tau;  // B2 fix (reference divides unguarded)

        float y_hi = (float)y[i_hi], y_lo = (float)y[i_lo];
        float c_hi = y[i_hi] > 0 ? c_pos : c_neg;
        float c_lo = y[i_lo] > 0 ? c_pos : c_neg;
        float a_hi_old = alpha[i_hi], a_lo_old = alpha[i_lo];
        // Pair update with the joint [L, H] clip; the reference's
        // sequential double clip (seq.cpp:237-250) can violate
        // sum alpha_i y_i (see solver/smo.py pair_alpha_update).
        float s = y_hi * y_lo;
        float w = a_hi_old + s * a_lo_old;
        float lo_b = s > 0.0f ? (w - c_hi > 0.0f ? w - c_hi : 0.0f)
                              : (-w > 0.0f ? -w : 0.0f);
        float hi_b = s > 0.0f ? (w < c_lo ? w : c_lo)
                              : (c_hi - w < c_lo ? c_hi - w : c_lo);
        float a_lo_new = a_lo_old + y_lo * (b_hi - b_lo) / eta;
        if (a_lo_new < lo_b) a_lo_new = lo_b;
        if (a_lo_new > hi_b) a_lo_new = hi_b;
        // Bound snap (see solver/smo.py pair_alpha_update: avoids the
        // c - 1ulp livelock); a_lo snaps BEFORE a_hi is derived from it
        // so conservation survives the snap.
        float snap_lo = 1e-6f * c_lo;
        float snap_hi = 1e-6f * c_hi;
        if (a_lo_new < snap_lo) a_lo_new = 0.0f;
        else if (a_lo_new > c_lo - snap_lo) a_lo_new = c_lo;
        float a_hi_new = a_hi_old + s * (a_lo_old - a_lo_new);
        if (a_hi_new < 0.0f) a_hi_new = 0.0f;
        if (a_hi_new > c_hi) a_hi_new = c_hi;
        if (a_hi_new < snap_hi) a_hi_new = 0.0f;
        else if (a_hi_new > c_hi - snap_hi) a_hi_new = c_hi;
        alpha[i_lo] = a_lo_new;
        alpha[i_hi] = a_hi_new;

        float dh = (a_hi_new - a_hi_old) * y_hi;
        float dl = (a_lo_new - a_lo_old) * y_lo;
        for (long i = 0; i < n; ++i)
            f[i] += dh * k_hi[(size_t)i] + dl * k_lo[(size_t)i];
        ++it;
        // do-while: test AFTER the update (seq.cpp:260).
        if (!(b_lo > b_hi + 2.0f * eps)) { converged = true; break; }
    }
    out_scalars[0] = 0.5f * (b_lo + b_hi);  // b (svmTrainMain.cpp:329)
    out_scalars[1] = b_hi;
    out_scalars[2] = b_lo;
    out_scalars[3] = converged ? 1.0f : 0.0f;
    return it;
}

// Decision function over m query rows:
//   out[i] = sum_j coef_j K(sv_x_j, q_i) - b     (coef_j = alpha_j * y_j)
// The seq_test.cpp:187-210 role, with b applied (the reference tester
// drops it, seq_test.cpp:197 — bug B5).
long seqsmo_decision(const float* sv_x, const float* coef, long n_sv, long d,
                     float gamma, int kernel_kind, int degree, float coef0,
                     float b, const float* q, long m, float* out) {
    if (n_sv <= 0 || d <= 0 || m < 0) return -1;
    std::vector<float> sv_sq((size_t)n_sv);
    for (long j = 0; j < n_sv; ++j)
        sv_sq[(size_t)j] = dot(sv_x + j * d, sv_x + j * d, d);
    for (long i = 0; i < m; ++i) {
        const float* qi = q + i * d;
        float q_sq = dot(qi, qi, d);
        float acc = 0.0f;
        for (long j = 0; j < n_sv; ++j) {
            float dp = dot(sv_x + j * d, qi, d);
            acc += coef[j] * kernel_value(dp, sv_sq[(size_t)j], q_sq,
                                          kernel_kind, gamma, degree, coef0);
        }
        out[i] = acc - b;
    }
    return m;
}

}  // extern "C"
