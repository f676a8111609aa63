// Shared per-(pixel, instance) blend step of the dense tile compositor.
//
// dense_forward.cu and dense_backward.cu both include this header, so the
// two kernels evaluate alpha and advance the transmittance with the same
// sequence of fp32 operations (both are built with --fmad=false). The
// backward recomputes the forward's front-to-back recurrence; if the two
// rounded differently, an instance whose T*(1-alpha) lies within ulps of
// T_STOP could contribute in one kernel and not in the other.

#pragma once

#include <cuda_runtime.h>

namespace gftorf {

constexpr int FEAT = 24;   // packed feature columns (pack_gaussian_features)
constexpr int BGC = 12;    // bg_tiles columns
constexpr int OUTC = 32;   // output / residual columns
constexpr float ALPHA_EPS = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float T_STOP = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

// One Gaussian instance seen from one pixel. `raw` is the unclamped
// opacity * falloff (the backward masks d_opacity where raw >= ALPHA_MAX).
struct Sample {
  float dx, dy, power, exp_p, raw, alpha;
  bool valid;  // power <= 0 and alpha >= ALPHA_EPS
};

// g: the instance's packed row (mean2d 0:2, conic 2:5, opacity 5).
__device__ __forceinline__ Sample eval_sample(const float* g, float px,
                                              float py) {
  Sample s;
  s.dx = g[0] - px;
  s.dy = g[1] - py;
  s.power = -0.5f * (g[2] * s.dx * s.dx + g[4] * s.dy * s.dy) -
            g[3] * s.dx * s.dy;
  s.exp_p = expf(fminf(s.power, 0.f));
  s.raw = g[5] * s.exp_p;
  s.alpha = fminf(ALPHA_MAX, s.raw);
  s.valid = s.power <= 0.f && s.alpha >= ALPHA_EPS;
  return s;
}

// Transmittance after a valid instance: the pixel stops (and the instance
// does not contribute) when it falls below T_STOP.
__device__ __forceinline__ float next_transmittance(float T, float alpha) {
  return T * (1.0f - alpha);
}

}  // namespace gftorf
