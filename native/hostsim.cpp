// Native host-side simulation rollout for conan_slam.
//
// Mirrors conan_slam/sim/precompute.py (rollout_truth /
// rollout_observations) in float32: the deterministic steering + truth
// motion chain (reference slam.h:279-332, 952-966) and the sensor
// visibility + ascending-id compaction (reference slam.h:575-683).  The
// Python loop costs ~0.5 s per 10k-step run — half of the whole timed
// benchmark region — so the host half of the pipeline is native, exactly
// like the runtime components of the reference.
//
// Exposed via extern "C" for ctypes (conan_slam/native.py).

#include <cmath>
#include <cstdint>

namespace {

const float kPi = 3.14159265358979323846f;

inline float wrap(float a) {
  // np.remainder(a + pi, 2 pi) - pi  (result in [-pi, pi)).
  float r = std::fmod(a + kPi, 2.0f * kPi);
  if (r < 0.0f) r += 2.0f * kPi;
  return r - kPi;
}

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// Deterministic truth rollout: outputs per-step pose (n_steps x 3), steering
// angle, active flag (step executed) and done flag.
void rollout_truth_native(
    const float* wp, int n_wp,
    int n_steps,
    float dt, float vel, float wb,
    float max_delta, float max_swa, float at2, int number_loops,
    float* x_true, float* swa_out, uint8_t* active_out, uint8_t* done_out) {
  float pose[3] = {0.0f, 0.0f, 0.0f};
  float swa = 0.0f;
  int iwp = 0;
  int loops_left = number_loops;
  bool done = false;

  for (int t = 0; t < n_steps; ++t) {
    bool was_done = done;
    if (!done) {
      // Steering (sim.steering.steer semantics).
      const float cx = wp[2 * iwp];
      const float cy = wp[2 * iwp + 1];
      const float ddx = cx - pose[0];
      const float ddy = cy - pose[1];
      const float d2 = ddx * ddx + ddy * ddy;
      const bool reached = d2 < at2;
      int iwp_next = iwp + (reached ? 1 : 0);
      const bool past_end = iwp_next >= n_wp;
      const bool restart = past_end && loops_left > 1;
      const bool finished = past_end && !restart;
      if (restart) loops_left -= 1;
      iwp = past_end ? 0 : iwp_next;
      if (!past_end) {
        const int ti = iwp_next < n_wp - 1 ? iwp_next : n_wp - 1;
        const float tx = wp[2 * ti];
        const float ty = wp[2 * ti + 1];
        float delta = wrap(std::atan2(ty - pose[1], tx - pose[0]) - pose[2] - swa);
        delta = clampf(delta, -max_delta, max_delta);
        swa = clampf(swa + delta, -max_swa, max_swa);
      }
      done = done || finished;
    }
    if (!done) {
      const float a = swa + pose[2];
      pose[0] += vel * dt * std::cos(a);
      pose[1] += vel * dt * std::sin(a);
      pose[2] = wrap(pose[2] + vel * dt * std::sin(swa) / wb);
    }
    x_true[3 * t] = pose[0];
    x_true[3 * t + 1] = pose[1];
    x_true[3 * t + 2] = pose[2];
    swa_out[t] = swa;
    active_out[t] = was_done ? 0 : 1;
    done_out[t] = done ? 1 : 0;
  }
}

// Noiseless sensor returns at each frame end (semicircular FoV, ascending-id
// compaction into nz slots).  z (F x nz x 2), ids (F x nz, -1 empty),
// mask (F x nz).
void rollout_observations_native(
    const float* x_true, int n_steps, int interval,
    const float* lm, int n_lm, float max_range, int nz,
    float* z_out, int32_t* ids_out, uint8_t* mask_out) {
  const int n_frames = n_steps / interval;
  const float r2 = max_range * max_range;
  for (int f = 0; f < n_frames; ++f) {
    const float* pose = x_true + 3 * ((f + 1) * interval - 1);
    const float c = std::cos(pose[2]);
    const float s = std::sin(pose[2]);
    float* zf = z_out + (size_t)f * nz * 2;
    int32_t* idf = ids_out + (size_t)f * nz;
    uint8_t* mf = mask_out + (size_t)f * nz;
    for (int k = 0; k < nz; ++k) {
      zf[2 * k] = 0.0f;
      zf[2 * k + 1] = 0.0f;
      idf[k] = -1;
      mf[k] = 0;
    }
    int count = 0;
    for (int l = 0; l < n_lm && count < nz; ++l) {
      const float dx = lm[2 * l] - pose[0];
      const float dy = lm[2 * l + 1] - pose[1];
      if (!(std::fabs(dx) < max_range) || !(std::fabs(dy) < max_range)) continue;
      if (!(dx * c + dy * s > 0.0f)) continue;
      const float d2 = dx * dx + dy * dy;
      if (!(d2 < r2)) continue;
      zf[2 * count] = std::sqrt(d2);
      zf[2 * count + 1] = wrap(std::atan2(dy, dx) - pose[2] + 0.0f);
      idf[count] = l;
      mf[count] = 1;
      ++count;
    }
  }
}

}  // extern "C"
