// Clean-room CPU baseline for the conan_slam benchmarks.
//
// BASELINE.md: the reference publishes no numbers, so the baseline is
// self-established by running the reference *workload* (same world, noise,
// gates as /root/reference/test/main.cpp) in a straightforward C++ EKF-SLAM
// and measuring steps/s + ATE on this machine.  This file is an independent
// implementation of the textbook algorithm (Bailey-style EKF-SLAM), written
// against SURVEY.md's math inventory — it is not a copy of the reference
// (row-major flat arrays, functions not classes, proper RNG, fixed defects).
//
// Exposed via extern "C" for ctypes (conan_slam/native.py).

#include <cmath>
#include <cstdint>
#include <chrono>
#include <random>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

float wrap_angle(float a) {
  a = std::fmod(a + kPi, 2.0f * kPi);
  if (a < 0) a += 2.0f * kPi;
  return a - kPi;
}

// Dense row-major matrix helpers sized for D = 3 + 2K states.
struct Mat {
  int rows = 0, cols = 0;
  std::vector<float> a;
  Mat() = default;
  Mat(int r, int c) : rows(r), cols(c), a(static_cast<size_t>(r) * c, 0.0f) {}
  float& at(int r, int c) { return a[static_cast<size_t>(r) * cols + c]; }
  float at(int r, int c) const { return a[static_cast<size_t>(r) * cols + c]; }
};

// Cholesky solve: S x = b for SPD S (in place factor).  Returns false if the
// factorization fails.
bool chol_solve(Mat s, std::vector<std::vector<float>>& bs) {
  const int n = s.rows;
  for (int j = 0; j < n; ++j) {
    float d = s.at(j, j);
    for (int k = 0; k < j; ++k) d -= s.at(j, k) * s.at(j, k);
    if (d <= 0.0f) return false;
    d = std::sqrt(d);
    s.at(j, j) = d;
    for (int i = j + 1; i < n; ++i) {
      float v = s.at(i, j);
      for (int k = 0; k < j; ++k) v -= s.at(i, k) * s.at(j, k);
      s.at(i, j) = v / d;
    }
  }
  for (auto& b : bs) {
    // Forward then backward substitution with L.
    for (int i = 0; i < n; ++i) {
      float v = b[i];
      for (int k = 0; k < i; ++k) v -= s.at(i, k) * b[k];
      b[i] = v / s.at(i, i);
    }
    for (int i = n - 1; i >= 0; --i) {
      float v = b[i];
      for (int k = i + 1; k < n; ++k) v -= s.at(k, i) * b[k];
      b[i] = v / s.at(i, i);
    }
  }
  return true;
}

struct EkfSlam {
  int nxv = 3;
  int nf = 0;                 // active features
  std::vector<float> x;       // (3 + 2 nf)
  Mat p;                      // (3 + 2 nf)^2
  std::vector<int> table;     // landmark id -> feature index or -1

  explicit EkfSlam(int num_ids) : x(3, 0.0f), p(3, 3), table(num_ids, -1) {}

  int dim() const { return nxv + 2 * nf; }

  void predict(float v, float swa, const float q[4], float wb, float dt) {
    const int d = dim();
    const float phi = x[2];
    const float a = swa + phi;
    const float gv02 = -v * dt * std::sin(a), gv12 = v * dt * std::cos(a);
    // Pvv <- Gv Pvv Gv^T + Gu Q Gu^T  (Gv = I + e0 gv02 e2^T + e1 gv12 e2^T).
    // Row transform.
    for (int c = 0; c < d; ++c) {
      p.at(0, c) += gv02 * p.at(2, c);
      p.at(1, c) += gv12 * p.at(2, c);
    }
    // Column transform.
    for (int r = 0; r < d; ++r) {
      p.at(r, 0) += gv02 * p.at(r, 2);
      p.at(r, 1) += gv12 * p.at(r, 2);
    }
    const float gu[6] = {dt * std::cos(a), -v * dt * std::sin(a),
                         dt * std::sin(a), v * dt * std::cos(a),
                         dt * std::sin(swa) / wb, v * dt * std::cos(swa) / wb};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        p.at(r, c) += gu[2 * r] * q[0] * gu[2 * c] + gu[2 * r + 1] * q[3] * gu[2 * c + 1];
    x[0] += v * dt * std::cos(a);
    x[1] += v * dt * std::sin(a);
    x[2] = wrap_angle(x[2] + v * dt * std::sin(swa) / wb);
  }

  void observe_heading(float phi_meas, float sigma) {
    const int d = dim();
    const float r = sigma * sigma;
    const float s = p.at(2, 2) + r;
    std::vector<float> pc(d), w(d);
    for (int i = 0; i < d; ++i) pc[i] = p.at(i, 2);
    for (int i = 0; i < d; ++i) w[i] = pc[i] / s;
    const float v = wrap_angle(phi_meas - x[2]);
    for (int i = 0; i < d; ++i) x[i] += w[i] * v;
    for (int r_ = 0; r_ < d; ++r_)
      for (int c = 0; c < d; ++c)
        p.at(r_, c) += -w[r_] * pc[c] - pc[r_] * w[c] + s * w[r_] * w[c];
  }

  // Batched measurement update for m associated (range, bearing) returns.
  void update(const std::vector<float>& z, const std::vector<int>& feat_idx,
              const float re[4]) {
    const int m = static_cast<int>(feat_idx.size());
    if (m == 0) return;
    const int d = dim();
    // Sparse H: per measurement, pose block (2x3) + feature block (2x2).
    std::vector<float> hv(6 * m), hf(4 * m), v(2 * m);
    for (int i = 0; i < m; ++i) {
      const int fp = nxv + 2 * feat_idx[i];
      const float dx = x[fp] - x[0], dy = x[fp + 1] - x[1];
      const float d2 = dx * dx + dy * dy, dist = std::sqrt(d2);
      hv[6 * i + 0] = -dx / dist; hv[6 * i + 1] = -dy / dist; hv[6 * i + 2] = 0;
      hv[6 * i + 3] = dy / d2;    hv[6 * i + 4] = -dx / d2;   hv[6 * i + 5] = -1;
      hf[4 * i + 0] = dx / dist;  hf[4 * i + 1] = dy / dist;
      hf[4 * i + 2] = -dy / d2;   hf[4 * i + 3] = dx / d2;
      v[2 * i] = z[2 * i] - dist;
      v[2 * i + 1] = wrap_angle(z[2 * i + 1] - (std::atan2(dy, dx) - x[2]));
    }
    // PHT (d x 2m) using H sparsity.
    std::vector<float> pht(static_cast<size_t>(d) * 2 * m, 0.0f);
    for (int r = 0; r < d; ++r)
      for (int i = 0; i < m; ++i) {
        const int fp = nxv + 2 * feat_idx[i];
        for (int rr = 0; rr < 2; ++rr) {
          float acc = 0.0f;
          for (int c = 0; c < 3; ++c) acc += p.at(r, c) * hv[6 * i + 3 * rr + c];
          acc += p.at(r, fp) * hf[4 * i + 2 * rr] + p.at(r, fp + 1) * hf[4 * i + 2 * rr + 1];
          pht[static_cast<size_t>(r) * 2 * m + 2 * i + rr] = acc;
        }
      }
    // S = H PHT + R (2m x 2m), again via sparsity of H.
    Mat s(2 * m, 2 * m);
    for (int i = 0; i < m; ++i) {
      const int fp = nxv + 2 * feat_idx[i];
      for (int rr = 0; rr < 2; ++rr)
        for (int c = 0; c < 2 * m; ++c) {
          float acc = 0.0f;
          for (int k = 0; k < 3; ++k)
            acc += hv[6 * i + 3 * rr + k] * pht[static_cast<size_t>(k) * 2 * m + c];
          acc += hf[4 * i + 2 * rr] * pht[static_cast<size_t>(fp) * 2 * m + c];
          acc += hf[4 * i + 2 * rr + 1] * pht[static_cast<size_t>(fp + 1) * 2 * m + c];
          s.at(2 * i + rr, c) = acc;
        }
      s.at(2 * i, 2 * i) += re[0];
      s.at(2 * i + 1, 2 * i + 1) += re[3];
    }
    for (int r = 0; r < 2 * m; ++r)   // symmetrize
      for (int c = r + 1; c < 2 * m; ++c) {
        const float avg = 0.5f * (s.at(r, c) + s.at(c, r));
        s.at(r, c) = avg; s.at(c, r) = avg;
      }
    // Solve S y = v and S Y = PHT^T  =>  x += PHT y;  P -= PHT Y^T... use
    // W = PHT S^-1: columns of W from solves with rows of PHT.
    std::vector<std::vector<float>> rhs(d + 1, std::vector<float>(2 * m));
    for (int i = 0; i < 2 * m; ++i) rhs[0][i] = v[i];
    for (int r = 0; r < d; ++r)
      for (int c = 0; c < 2 * m; ++c) rhs[r + 1][c] = pht[static_cast<size_t>(r) * 2 * m + c];
    if (!chol_solve(s, rhs)) return;
    for (int r = 0; r < d; ++r) {
      float acc = 0.0f;
      for (int c = 0; c < 2 * m; ++c) acc += pht[static_cast<size_t>(r) * 2 * m + c] * rhs[0][c];
      x[r] += acc;
    }
    x[2] = wrap_angle(x[2]);
    for (int r = 0; r < d; ++r)
      for (int c = 0; c < d; ++c) {
        float acc = 0.0f;
        for (int k = 0; k < 2 * m; ++k)
          acc += pht[static_cast<size_t>(r) * 2 * m + k] * rhs[c + 1][k];
        p.at(r, c) -= acc;
      }
  }

  // ---- optimized (vectorizable) variants ----------------------------------
  //
  // Same algebra as update()/observe_heading() but scheduled for the SIMD
  // units: every O(d) / O(d^2) loop is a contiguous row operation (axpy/FMA
  // over the d-length rows of P), exploiting P's symmetry to turn the
  // column reads of the naive path into row reads (the same row-gather idea
  // as the JAX measurement operator).  Single-threaded, like the reference.

  void observe_heading_opt(float phi_meas, float sigma) {
    const int d = dim();
    const float r = sigma * sigma;
    const float s = p.at(2, 2) + r;
    // pc = P[:, 2] = P[2, :] (symmetry): one contiguous row read.
    std::vector<float> pc(p.a.begin() + static_cast<size_t>(2) * d,
                          p.a.begin() + static_cast<size_t>(3) * d);
    const float inv_s = 1.0f / s;
    const float v = wrap_angle(phi_meas - x[2]);
    for (int i = 0; i < d; ++i) x[i] += pc[i] * inv_s * v;
    // P += -w pc^T - pc w^T + s w w^T, rows: row_i += a_i pc + b_i pc
    // with w = pc/s:  a_i = -w_i, b_i = (s w_i - pc_i)/s = 0... combine:
    // row_i += (-pc_i/s) pc + (pc_i - pc_i) ... exactly: -w_i pc - pc_i w
    // + s w_i w = (-pc_i/s) pc + pc_i (-pc/s) + (pc_i/s) pc = (-pc_i/s) pc.
    // (Joseph rank-1 with H = e2^T collapses to one axpy per row.)
    for (int i = 0; i < d; ++i) {
      float* __restrict row = &p.a[static_cast<size_t>(i) * d];
      const float a = -pc[i] * inv_s;
      const float* __restrict pcp = pc.data();
      for (int c = 0; c < d; ++c) row[c] += a * pcp[c];
    }
  }

  void update_opt(const std::vector<float>& z, const std::vector<int>& feat_idx,
                  const float re[4]) {
    const int m = static_cast<int>(feat_idx.size());
    if (m == 0) return;
    const int d = dim();
    const int K = 2 * m;
    std::vector<float> hv(6 * m), hf(4 * m), v(2 * m);
    for (int i = 0; i < m; ++i) {
      const int fp = nxv + 2 * feat_idx[i];
      const float dx = x[fp] - x[0], dy = x[fp + 1] - x[1];
      const float d2 = dx * dx + dy * dy, dist = std::sqrt(d2);
      hv[6 * i + 0] = -dx / dist; hv[6 * i + 1] = -dy / dist; hv[6 * i + 2] = 0;
      hv[6 * i + 3] = dy / d2;    hv[6 * i + 4] = -dx / d2;   hv[6 * i + 5] = -1;
      hf[4 * i + 0] = dx / dist;  hf[4 * i + 1] = dy / dist;
      hf[4 * i + 2] = -dy / d2;   hf[4 * i + 3] = dx / d2;
      v[2 * i] = z[2 * i] - dist;
      v[2 * i + 1] = wrap_angle(z[2 * i + 1] - (std::atan2(dy, dx) - x[2]));
    }
    // AT = (H P)^T stored (K, d) row-major: each row is a 5-term combination
    // of contiguous ROWS of the symmetric P (P[:, c] == P[c, :]).
    std::vector<float> at(static_cast<size_t>(K) * d);
    for (int i = 0; i < m; ++i) {
      const int fp = nxv + 2 * feat_idx[i];
      const float* __restrict p0 = &p.a[0];
      const float* __restrict p1 = &p.a[static_cast<size_t>(1) * d];
      const float* __restrict p2 = &p.a[static_cast<size_t>(2) * d];
      const float* __restrict pf0 = &p.a[static_cast<size_t>(fp) * d];
      const float* __restrict pf1 = &p.a[static_cast<size_t>(fp + 1) * d];
      for (int rr = 0; rr < 2; ++rr) {
        float* __restrict out = &at[static_cast<size_t>(2 * i + rr) * d];
        const float a0 = hv[6 * i + 3 * rr], a1 = hv[6 * i + 3 * rr + 1],
                    a2 = hv[6 * i + 3 * rr + 2];
        const float b0 = hf[4 * i + 2 * rr], b1 = hf[4 * i + 2 * rr + 1];
        for (int c = 0; c < d; ++c)
          out[c] = a0 * p0[c] + a1 * p1[c] + a2 * p2[c] + b0 * pf0[c] + b1 * pf1[c];
      }
    }
    // S = H (AT^T) + R via the same 5-term sparsity (K x K, tiny).
    Mat s(K, K);
    for (int i = 0; i < m; ++i) {
      const int fp = nxv + 2 * feat_idx[i];
      for (int rr = 0; rr < 2; ++rr)
        for (int c = 0; c < K; ++c) {
          const float* __restrict col = &at[static_cast<size_t>(c) * d];
          s.at(2 * i + rr, c) =
              hv[6 * i + 3 * rr] * col[0] + hv[6 * i + 3 * rr + 1] * col[1] +
              hv[6 * i + 3 * rr + 2] * col[2] +
              hf[4 * i + 2 * rr] * col[fp] + hf[4 * i + 2 * rr + 1] * col[fp + 1];
        }
      s.at(2 * i, 2 * i) += re[0];
      s.at(2 * i + 1, 2 * i + 1) += re[3];
    }
    for (int r = 0; r < K; ++r)
      for (int c = r + 1; c < K; ++c) {
        const float avg = 0.5f * (s.at(r, c) + s.at(c, r));
        s.at(r, c) = avg; s.at(c, r) = avg;
      }
    // Cholesky factor S (in place), then W = S^-1 AT via two triangular
    // substitutions vectorized over the d contiguous columns of AT.
    for (int j = 0; j < K; ++j) {
      float diag = s.at(j, j);
      for (int k = 0; k < j; ++k) diag -= s.at(j, k) * s.at(j, k);
      if (diag <= 0.0f) return;  // degrade-don't-crash
      const float lj = std::sqrt(diag);
      s.at(j, j) = lj;
      for (int i = j + 1; i < K; ++i) {
        float val = s.at(i, j);
        for (int k = 0; k < j; ++k) val -= s.at(i, k) * s.at(j, k);
        s.at(i, j) = val / lj;
      }
    }
    std::vector<float> w = std::move(at);  // solve in place: AT -> W
    for (int i = 0; i < K; ++i) {          // forward: L z = rhs
      float* __restrict wi = &w[static_cast<size_t>(i) * d];
      for (int k = 0; k < i; ++k) {
        const float l = s.at(i, k);
        const float* __restrict wk = &w[static_cast<size_t>(k) * d];
        for (int c = 0; c < d; ++c) wi[c] -= l * wk[c];
      }
      const float inv = 1.0f / s.at(i, i);
      for (int c = 0; c < d; ++c) wi[c] *= inv;
    }
    for (int i = K - 1; i >= 0; --i) {     // backward: L^T y = z
      float* __restrict wi = &w[static_cast<size_t>(i) * d];
      for (int k = i + 1; k < K; ++k) {
        const float l = s.at(k, i);
        const float* __restrict wk = &w[static_cast<size_t>(k) * d];
        for (int c = 0; c < d; ++c) wi[c] -= l * wk[c];
      }
      const float inv = 1.0f / s.at(i, i);
      for (int c = 0; c < d; ++c) wi[c] *= inv;
    }
    // x += PHT S^-1 v = (S^-1 PHT^T)^T v with W = S^-1 PHT^T (K, d):
    // x[r] += sum_k W[k][r] * v[k]  (v, not a pre-solved y — W already
    // carries S^-1).
    for (int k = 0; k < K; ++k) {
      const float* __restrict wk = &w[static_cast<size_t>(k) * d];
      const float vk = v[k];
      for (int r = 0; r < d; ++r) x[r] += wk[r] * vk;
    }
    x[2] = wrap_angle(x[2]);
    // P -= PHT W = (W^T S) W ... use the factored downdate P -= U^T U with
    // U = L^T W ((K, d), contiguous rows): P -= PHT S^-1 PHT^T = W^T S W
    // and S = L L^T gives U = L^T W.
    std::vector<float> u(static_cast<size_t>(K) * d, 0.0f);
    for (int i = 0; i < K; ++i) {
      float* __restrict ui = &u[static_cast<size_t>(i) * d];
      for (int k = i; k < K; ++k) {
        const float l = s.at(k, i);  // L^T[i, k] = L[k, i]
        const float* __restrict wk = &w[static_cast<size_t>(k) * d];
        for (int c = 0; c < d; ++c) ui[c] += l * wk[c];
      }
    }
    for (int r = 0; r < d; ++r) {
      float* __restrict row = &p.a[static_cast<size_t>(r) * d];
      for (int k = 0; k < K; ++k) {
        const float* __restrict uk = &u[static_cast<size_t>(k) * d];
        const float a = -uk[r];
        for (int c = 0; c < d; ++c) row[c] += a * uk[c];
      }
    }
  }

  void augment(const std::vector<float>& z_new, const std::vector<int>& ids,
               const float re[4]) {
    for (size_t i = 0; i < ids.size(); ++i) {
      const float r = z_new[2 * i], b = z_new[2 * i + 1];
      const float sn = std::sin(x[2] + b), cs = std::cos(x[2] + b);
      const int old_d = dim();
      Mat pn(old_d + 2, old_d + 2);
      for (int rr = 0; rr < old_d; ++rr)
        for (int cc = 0; cc < old_d; ++cc) pn.at(rr, cc) = p.at(rr, cc);
      const float gv[6] = {1, 0, -r * sn, 0, 1, r * cs};
      const float gz[4] = {cs, -r * sn, sn, r * cs};
      // New rows: Gv @ P[0:3, :].
      for (int rr = 0; rr < 2; ++rr)
        for (int cc = 0; cc < old_d; ++cc) {
          float acc = 0.0f;
          for (int k = 0; k < 3; ++k) acc += gv[3 * rr + k] * p.at(k, cc);
          pn.at(old_d + rr, cc) = acc;
          pn.at(cc, old_d + rr) = acc;
        }
      // New diag block: Gv Pvv Gv^T + Gz R Gz^T.
      for (int rr = 0; rr < 2; ++rr)
        for (int cc = 0; cc < 2; ++cc) {
          float acc = 0.0f;
          for (int a_ = 0; a_ < 3; ++a_)
            for (int b_ = 0; b_ < 3; ++b_)
              acc += gv[3 * rr + a_] * p.at(a_, b_) * gv[3 * cc + b_];
          acc += gz[2 * rr] * re[0] * gz[2 * cc] + gz[2 * rr + 1] * re[3] * gz[2 * cc + 1];
          pn.at(old_d + rr, old_d + cc) = acc;
        }
      p = std::move(pn);
      x.push_back(x[0] + r * cs);
      x.push_back(x[1] + r * sn);
      if (ids[i] >= 0) table[ids[i]] = nf;  // gated path founds without ids
      ++nf;
    }
  }

  // Defect-fixed gated NN association (reference EKF::dataAssociate /
  // computeAssociation, EKF.cpp:235-326 + 131-144; the reference's gated
  // path never returns new features — SURVEY.md defect 4 — fixed here, and
  // in conan_slam/filters/ekf/associate.py with identical semantics):
  // per measurement x active feature, the EXACT pairwise innovation
  // covariance S_j = [Hv Hf] [[Pvv, Pvj], [Pjv, Pjj]] [Hv Hf]^T + R from
  // the pose block, pose-feature strip and feature diagonal block;
  // nis = v^T S^-1 v, nd = nis + log|S|.  Accept the nd-argmin among
  // features passing nis < gate1; found a new feature when the min NIS over
  // all features exceeds gate2.
  void associate_gated(const std::vector<float>& z, const float re[4],
                       float gate1, float gate2,
                       std::vector<float>& zf, std::vector<int>& idf,
                       std::vector<float>& zn) const {
    const int m = static_cast<int>(z.size() / 2);
    const float inf = 3.0e38f;
    for (int i = 0; i < m; ++i) {
      const float zr = z[2 * i], zb = z[2 * i + 1];
      float best_nd = inf, min_nis = inf;
      int best_j = -1;
      for (int j = 0; j < nf; ++j) {
        const int fp = nxv + 2 * j;
        const float dx = x[fp] - x[0], dy = x[fp + 1] - x[1];
        const float d2 = dx * dx + dy * dy;
        if (d2 < 1e-12f) continue;
        const float dist = std::sqrt(d2);
        const float hv0 = -dx / dist, hv1 = -dy / dist;             // row 0
        const float hv3 = dy / d2, hv4 = -dx / d2, hv5 = -1.0f;     // row 1
        const float hf0 = dx / dist, hf1 = dy / dist;
        const float hf2 = -dy / d2, hf3 = dx / d2;
        // a = H [P block columns]: rows of H against the 5 relevant
        // rows/cols of the symmetric P (pose 0..2 and fp, fp+1).
        float s00 = re[0], s01 = 0.0f, s11 = re[3];
        {
          // t_r[c] = (H row r) . P[:, c] over the 5 active columns c.
          const int cols[5] = {0, 1, 2, fp, fp + 1};
          float t0[5], t1[5];
          for (int cc = 0; cc < 5; ++cc) {
            const int c = cols[cc];
            const float p0c = p.at(0, c), p1c = p.at(1, c), p2c = p.at(2, c);
            const float pf0c = p.at(fp, c), pf1c = p.at(fp + 1, c);
            t0[cc] = hv0 * p0c + hv1 * p1c + hf0 * pf0c + hf1 * pf1c;
            t1[cc] = hv3 * p0c + hv4 * p1c + hv5 * p2c + hf2 * pf0c + hf3 * pf1c;
          }
          s00 += hv0 * t0[0] + hv1 * t0[1] + hf0 * t0[3] + hf1 * t0[4];
          s01 += hv3 * t0[0] + hv4 * t0[1] + hv5 * t0[2] + hf2 * t0[3] + hf3 * t0[4];
          s11 += hv3 * t1[0] + hv4 * t1[1] + hv5 * t1[2] + hf2 * t1[3] + hf3 * t1[4];
        }
        const float det = s00 * s11 - s01 * s01;
        if (det <= 1e-30f) continue;
        const float v1 = zr - dist;
        const float v2 = wrap_angle(zb - (std::atan2(dy, dx) - x[2]));
        const float nis =
            (s11 * v1 * v1 - 2.0f * s01 * v1 * v2 + s00 * v2 * v2) / det;
        if (nis < min_nis) min_nis = nis;
        if (nis < gate1) {
          const float nd = nis + std::log(det);
          if (nd < best_nd) { best_nd = nd; best_j = j; }
        }
      }
      if (best_j >= 0) {
        zf.push_back(zr); zf.push_back(zb); idf.push_back(best_j);
      } else if (min_nis > gate2) {
        zn.push_back(zr); zn.push_back(zb);
      }
    }
  }
};

}  // namespace

extern "C" {

// Runs the full valet-loop EKF-SLAM workload.  Returns the number of control
// steps executed; writes wall seconds (filter only) and position ATE RMSE.
// ``opt``: 0 = straightforward scalar loops (the reference-style baseline),
// 1 = SIMD-scheduled rows (the honest "how fast is this CPU really" bound).
int64_t run_ekf_baseline_v3(const float* lm_xy, int num_lm, const float* wp_xy,
                            int num_wp, int max_steps, uint64_t seed,
                            int with_noise, int prebuild_map, float sigma0,
                            int opt, int gated, float gate1, float gate2,
                            int max_obs,
                            double* out_seconds, float* out_ate,
                            float* out_traj /* may be null, 3*max_steps */) {
  // Reference parameter set (SURVEY.md section 2.4).
  const float velocity = 83.33f, max_swa = kPi / 4.0f,
              rate_swa = 70.0f * kPi / 180.0f, wheel_base = 73.0f, dt = 0.01f;
  const float sigma_v = 0.3f, sigma_swa = kPi / 180.0f;
  const float sigma_r = 0.1f, sigma_b = kPi / 180.0f;
  const float max_range = 2000.0f, at_waypoint = 1.0f;
  const float sigma_phi = 0.01f * kPi / 180.0f;
  const int observe_every = 6;  // ceil(5.058 dt / dt)
  const float q[4] = {sigma_v * sigma_v, 0, 0, sigma_swa * sigma_swa};
  const float qe[4] = {2 * q[0], 0, 0, 2 * q[3]};
  const float re[4] = {8 * sigma_r * sigma_r, 0, 0, 8 * sigma_b * sigma_b};

  std::mt19937_64 rng(seed);
  std::normal_distribution<float> gauss(0.0f, 1.0f);

  EkfSlam ekf(num_lm);
  if (prebuild_map) {
    // Steady-state start: every landmark pre-registered with sigma0^2 I
    // feature covariance (the full-map tracking benchmark configuration).
    ekf.nf = num_lm;
    const int d = 3 + 2 * num_lm;
    ekf.x.assign(d, 0.0f);
    for (int i = 0; i < num_lm; ++i) {
      ekf.x[3 + 2 * i] = lm_xy[2 * i];
      ekf.x[3 + 2 * i + 1] = lm_xy[2 * i + 1];
      ekf.table[i] = i;
    }
    ekf.p = Mat(d, d);
    for (int i = 3; i < d; ++i) ekf.p.at(i, i) = sigma0 * sigma0;
  }
  float xt[3] = {0, 0, 0};
  float swa = 0.0f;
  int iwp = 0;
  double err2_sum = 0.0;
  int64_t steps = 0;

  const auto t0 = std::chrono::steady_clock::now();
  for (int step = 0; step < max_steps; ++step) {
    // Steering controller.
    {
      const float dx = wp_xy[2 * iwp] - xt[0], dy = wp_xy[2 * iwp + 1] - xt[1];
      if (dx * dx + dy * dy < at_waypoint * at_waypoint) {
        ++iwp;
        if (iwp >= num_wp) break;
      }
      const float tx = wp_xy[2 * iwp] - xt[0], ty = wp_xy[2 * iwp + 1] - xt[1];
      float delta = wrap_angle(std::atan2(ty, tx) - xt[2] - swa);
      const float max_delta = rate_swa * dt;
      if (delta > max_delta) delta = max_delta;
      if (delta < -max_delta) delta = -max_delta;
      swa += delta;
      if (swa > max_swa) swa = max_swa;
      if (swa < -max_swa) swa = -max_swa;
    }
    // Ground truth motion.
    xt[0] += velocity * dt * std::cos(swa + xt[2]);
    xt[1] += velocity * dt * std::sin(swa + xt[2]);
    xt[2] = wrap_angle(xt[2] + velocity * dt * std::sin(swa) / wheel_base);
    // Noisy odometry.
    float vn = velocity, swan = swa;
    if (with_noise) {
      vn += gauss(rng) * sigma_v;
      swan += gauss(rng) * sigma_swa;
    }
    ekf.predict(vn, swan, qe, wheel_base, dt);
    if (opt) ekf.observe_heading_opt(xt[2], sigma_phi);
    else ekf.observe_heading(xt[2], sigma_phi);

    if ((step + 1) % observe_every == 0) {
      std::vector<float> zf, zn;
      std::vector<int> idf, idn;
      if (gated) {
        // Buffer all visible returns (first max_obs in landmark order,
        // mirroring the JAX path's fixed-size compact buffer), then gate.
        std::vector<float> z_all;
        for (int i = 0; i < num_lm; ++i) {
          const float dx = lm_xy[2 * i] - xt[0], dy = lm_xy[2 * i + 1] - xt[1];
          if (std::fabs(dx) >= max_range || std::fabs(dy) >= max_range) continue;
          if (dx * std::cos(xt[2]) + dy * std::sin(xt[2]) <= 0.0f) continue;
          if (dx * dx + dy * dy >= max_range * max_range) continue;
          float zr = std::sqrt(dx * dx + dy * dy);
          float zb = std::atan2(dy, dx) - xt[2];
          if (with_noise) {
            zr += gauss(rng) * sigma_r;
            zb += gauss(rng) * sigma_b;
          }
          if (max_obs > 0 &&
              static_cast<int>(z_all.size() / 2) >= max_obs) break;
          z_all.push_back(zr); z_all.push_back(zb);
        }
        ekf.associate_gated(z_all, re, gate1, gate2, zf, idf, zn);
        idn.assign(zn.size() / 2, -1);
      } else {
        for (int i = 0; i < num_lm; ++i) {
          const float dx = lm_xy[2 * i] - xt[0], dy = lm_xy[2 * i + 1] - xt[1];
          if (std::fabs(dx) >= max_range || std::fabs(dy) >= max_range) continue;
          if (dx * std::cos(xt[2]) + dy * std::sin(xt[2]) <= 0.0f) continue;
          if (dx * dx + dy * dy >= max_range * max_range) continue;
          float zr = std::sqrt(dx * dx + dy * dy);
          float zb = std::atan2(dy, dx) - xt[2];
          if (with_noise) {
            zr += gauss(rng) * sigma_r;
            zb += gauss(rng) * sigma_b;
          }
          if (ekf.table[i] >= 0) {
            zf.push_back(zr); zf.push_back(zb); idf.push_back(ekf.table[i]);
          } else {
            zn.push_back(zr); zn.push_back(zb); idn.push_back(i);
          }
        }
      }
      if (opt) ekf.update_opt(zf, idf, re);
      else ekf.update(zf, idf, re);
      ekf.augment(zn, idn, re);
    }
    const double ex = xt[0] - ekf.x[0], ey = xt[1] - ekf.x[1];
    err2_sum += ex * ex + ey * ey;
    if (out_traj) {
      out_traj[3 * step] = ekf.x[0];
      out_traj[3 * step + 1] = ekf.x[1];
      out_traj[3 * step + 2] = ekf.x[2];
    }
    ++steps;
  }
  const auto t1 = std::chrono::steady_clock::now();
  *out_seconds = std::chrono::duration<double>(t1 - t0).count();
  *out_ate = steps ? static_cast<float>(std::sqrt(err2_sum / steps)) : 0.0f;
  return steps;
}

int64_t run_ekf_baseline_v2(const float* lm_xy, int num_lm, const float* wp_xy,
                            int num_wp, int max_steps, uint64_t seed,
                            int with_noise, int prebuild_map, float sigma0,
                            int opt,
                            double* out_seconds, float* out_ate,
                            float* out_traj) {
  return run_ekf_baseline_v3(lm_xy, num_lm, wp_xy, num_wp, max_steps, seed,
                             with_noise, prebuild_map, sigma0, opt,
                             /*gated=*/0, /*gate1=*/50.0f, /*gate2=*/1000.0f,
                             /*max_obs=*/0, out_seconds, out_ate, out_traj);
}

int64_t run_ekf_baseline_ex(const float* lm_xy, int num_lm, const float* wp_xy,
                            int num_wp, int max_steps, uint64_t seed,
                            int with_noise, int prebuild_map, float sigma0,
                            double* out_seconds, float* out_ate,
                            float* out_traj) {
  return run_ekf_baseline_v2(lm_xy, num_lm, wp_xy, num_wp, max_steps, seed,
                             with_noise, prebuild_map, sigma0, /*opt=*/0,
                             out_seconds, out_ate, out_traj);
}

int64_t run_ekf_baseline(const float* lm_xy, int num_lm, const float* wp_xy,
                         int num_wp, int max_steps, uint64_t seed,
                         int with_noise, double* out_seconds, float* out_ate,
                         float* out_traj) {
  return run_ekf_baseline_v2(lm_xy, num_lm, wp_xy, num_wp, max_steps, seed,
                             with_noise, /*prebuild_map=*/0, /*sigma0=*/1.0f,
                             /*opt=*/0, out_seconds, out_ate, out_traj);
}

}  // extern "C"
