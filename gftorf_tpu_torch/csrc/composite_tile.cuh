// Per-tile bodies of the compositing kernels, forward and backward.
//
// One block composites one tile, one thread per pixel. The dense kernels
// (dense_forward.cu, dense_backward.cu) and the flat-stream kernels
// (flat_forward.cu, flat_backward.cu) differ only in where a tile's
// depth-sorted rows lie: lane 0 of the tile's (L, 24) slab of the dense
// block, or its segment of the aligned stream. Each entry finds the rows
// (`tile_feat`, `count`) and the range of per-row outputs it owns
// (`extent` rows of contrib or dfeat, zeroed past the last row reached)
// and calls the body here, so the two layouts run the same instructions
// on the same rows and give the same bits. The design notes and bounds
// are in the .cu files.

#pragma once

#include <cuda_runtime.h>

#include "dense_common.cuh"

namespace gftorf {

constexpr int BATCH = 256;        // rows staged per batch: 24 KB of shared memory
constexpr int BWD_MAX_PIX = 512;  // the backward runs one thread per pixel
constexpr int BWD_MAX_WARPS = BWD_MAX_PIX / 32;

// This thread's pixel in tile t (origins: (T, 2) int32 x, y of its corner).
struct Pixel {
  float x, y;
  bool inside;
};

__device__ __forceinline__ Pixel pixel_of(const int* origins, int t,
                                          int tile_w, int width, int height) {
  Pixel p;
  p.x = (float)origins[2 * t] + (float)(threadIdx.x % tile_w);
  p.y = (float)origins[2 * t + 1] + (float)(threadIdx.x / tile_w);
  p.inside = (p.x < (float)width) && (p.y < (float)height);
  return p;
}

// Forward. Blends rows [0, count) of tile_feat front to back at this
// thread's pixel, writes its (OUTC,) output row from its bg row `b`, and
// the per-row contributing-pixel counts to tile_contrib[0, extent).
// Shared memory: s_feat (BATCH * FEAT floats), s_hits (BATCH ints).
template <bool NEED_DD, bool NEED_DIST>
__device__ __forceinline__ void composite_tile_forward(
    const float* __restrict__ tile_feat, int count, int extent, Pixel p,
    const float* __restrict__ b, float* __restrict__ out_px,
    float* __restrict__ tile_contrib, float* s_feat, int* s_hits) {
  const int pid = threadIdx.x;
  const int pix = blockDim.x;
  const int lane = pid & 31;

  bool done = !p.inside;
  float T = 1.0f;
  float color[3] = {0.f, 0.f, 0.f};
  float phasor[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float flow[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float depth = 0.f, acc = 0.f;
  float dd = 0.f, wz_run = 0.f, wz2_run = 0.f;
  float first_alpha = 0.f, first_dist = 0.f, first_amp = 0.f;
  bool has_first = false;

  int base = 0;
  for (; base < count; base += BATCH) {
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(BATCH, count - base);
    const float* src = tile_feat + (size_t)base * FEAT;
    for (int i = pid; i < n * FEAT; i += pix) s_feat[i] = src[i];
    for (int i = pid; i < n; i += pix) s_hits[i] = 0;
    __syncthreads();

    if (!__all_sync(FULL, done)) {
      for (int j = 0; j < n; ++j) {
        const float* g = s_feat + j * FEAT;
        bool hit = false;
        if (!done) {
          const Sample smp = eval_sample(g, p.x, p.y);
          if (smp.valid) {
            const float alpha = smp.alpha;
            const float t_next = next_transmittance(T, alpha);
            if (t_next < T_STOP) {
              done = true;
            } else {
              hit = true;
              const float w = alpha * T;
              const float wp = w * T;
#pragma unroll
              for (int k = 0; k < 3; ++k) color[k] += w * g[7 + k];
              depth += w * g[10];
#pragma unroll
              for (int k = 0; k < 7; ++k) phasor[k] += wp * g[11 + k];
#pragma unroll
              for (int k = 0; k < 6; ++k) flow[k] += w * g[18 + k];
              if (NEED_DD) {
                const float z = g[6];
                const float wz = w * z;
                dd += w * (z * z) * acc - 2.0f * wz * wz_run + w * wz2_run;
                wz_run += wz;
                wz2_run += wz * z;
              }
              acc += w;
              if (NEED_DIST && !has_first) {
                first_alpha = alpha;
                first_dist = g[10];
                first_amp = g[13];
                has_first = true;
              }
              T = t_next;
            }
          }
        }
        const unsigned ballot = __ballot_sync(FULL, hit);
        if (lane == 0 && ballot) atomicAdd(&s_hits[j], __popc(ballot));
      }
    }
    __syncthreads();
    for (int i = pid; i < n; i += pix) tile_contrib[base + i] = (float)s_hits[i];
  }
  // Rows never reached (early exit, or past the count) touched no pixel.
  for (int i = min(base, count) + pid; i < extent; i += pix) tile_contrib[i] = 0.f;

  float o[OUTC];
#pragma unroll
  for (int k = 0; k < 3; ++k) o[k] = color[k] + T * b[k];
  o[3] = depth;
#pragma unroll
  for (int k = 0; k < 7; ++k) o[4 + k] = phasor[k] + T * b[4 + k];
  o[11] = acc;
  o[12] = NEED_DD ? dd : 0.f;
  o[13] = T;
  o[14] = NEED_DIST ? first_alpha : 0.f;
  o[15] = NEED_DIST ? first_dist : 0.f;
  o[16] = NEED_DIST ? first_amp : 0.f;
  o[17] = acc;
  o[18] = NEED_DD ? wz_run : 0.f;
  o[19] = NEED_DD ? wz2_run : 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) o[20 + k] = flow[k];
#pragma unroll
  for (int k = 26; k < OUTC; ++k) o[k] = 0.f;
  float4* dst = reinterpret_cast<float4*>(out_px);
#pragma unroll
  for (int k = 0; k < OUTC / 4; ++k)
    dst[k] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
}

// Backward. The gradient of the tile's output rows with respect to rows
// [0, count) of tile_feat, given this pixel's bg row `b`, forward output
// row `o` and cotangent row `gr`; writes tile_dfeat[0, extent) (zero rows
// past the last row reached). Shared memory: s_feat (BATCH * FEAT
// floats), s_part (2 * BWD_MAX_WARPS * FEAT floats).
template <bool NEED_DD, bool HAS_FLOW>
__device__ __forceinline__ void composite_tile_backward(
    const float* __restrict__ tile_feat, int count, int extent, Pixel p,
    const float* __restrict__ b, const float* __restrict__ o,
    const float* __restrict__ gr, float* __restrict__ tile_dfeat,
    float* s_feat, float* s_part) {
  const int pid = threadIdx.x;
  const int pix = blockDim.x;
  const int lane = pid & 31;
  const int warp = pid >> 5;
  const int nwarps = pix >> 5;

  // This pixel's residuals, cotangent and bg (pallas_composite.py:462-486).
  float gc[4], gp[7], gf[6];
#pragma unroll
  for (int k = 0; k < 4; ++k) gc[k] = gr[k];  // color 0:3, depth 3
#pragma unroll
  for (int k = 0; k < 7; ++k) gp[k] = gr[4 + k];
#pragma unroll
  for (int k = 0; k < 6; ++k) gf[k] = HAS_FLOW ? gr[20 + k] : 0.f;
  const float g_acc = gr[11];
  const float g_dd = NEED_DD ? gr[12] : 0.f;
  const float t_final = o[13];
  const float a_tot = o[17];
  const float wz_tot = NEED_DD ? o[18] : 0.f;
  const float wz2_tot = NEED_DD ? o[19] : 0.f;

  float e_tot = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) e_tot += gc[k] * (o[k] - t_final * b[k]);
  e_tot += gc[3] * o[3];
  e_tot += g_acc * a_tot;
  float ep_tot = 0.f;
#pragma unroll
  for (int k = 0; k < 7; ++k) ep_tot += gp[k] * (o[4 + k] - t_final * b[4 + k]);
  const float u_dd_tot = g_dd * 2.0f * (a_tot * wz2_tot - wz_tot * wz_tot);
  float bg_dot = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) bg_dot += b[k] * gc[k];
  float bg_dot_p = 0.f;
#pragma unroll
  for (int k = 0; k < 7; ++k) bg_dot_p += b[4 + k] * gp[k];
  bg_dot += bg_dot_p;

  bool done = !p.inside;
  float T = 1.0f, u_f = 0.f, u_p = 0.f, u_dd = 0.f;
  int base = 0;
  for (; base < count; base += BATCH) {
    if (__syncthreads_count(!done) == 0) break;
    const int n = min(BATCH, count - base);
    const float* src = tile_feat + (size_t)base * FEAT;
    for (int i = pid; i < n * FEAT; i += pix) s_feat[i] = src[i];
    __syncthreads();

    for (int j = 0; j < n; ++j) {
      const float* f = s_feat + j * FEAT;
      float d[FEAT];  // this pixel's share of instance j's gradient row
#pragma unroll
      for (int c = 0; c < FEAT; ++c) d[c] = 0.f;
      bool hit = false;
      if (!done) {
        const Sample s = eval_sample(f, p.x, p.y);
        if (s.valid) {
          const float t_next = next_transmittance(T, s.alpha);
          if (t_next < T_STOP) {
            done = true;
          } else {
            hit = true;
            const float w = s.alpha * T;
            const float wp = w * T;
            const float q = 1.0f - s.alpha;
            float e = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) e += gc[k] * f[7 + k];
            e += g_acc;
            float e_p = 0.f;
#pragma unroll
            for (int k = 0; k < 7; ++k) e_p += gp[k] * f[11 + k];
            u_f += w * e;
            u_p += wp * e_p;
            float d_alpha = T * e - (e_tot - u_f) / q + T * T * e_p -
                            2.0f * (ep_tot - u_p) / q - t_final / q * bg_dot;
            if (NEED_DD) {
              const float z = f[6];
              const float sym = z * z * a_tot - 2.0f * z * wz_tot + wz2_tot;
              u_dd += g_dd * w * sym;
              d_alpha += g_dd * T * sym - (u_dd_tot - u_dd) / q;
              d[6] = g_dd * 2.0f * w * (z * a_tot - wz_tot);
            }
            if (s.raw < ALPHA_MAX) {
              const float d_power = d_alpha * s.alpha;
              d[0] = d_power * -(f[2] * s.dx + f[3] * s.dy);
              d[1] = d_power * -(f[4] * s.dy + f[3] * s.dx);
              d[2] = -0.5f * s.dx * s.dx * d_power;
              d[3] = -s.dx * s.dy * d_power;
              d[4] = -0.5f * s.dy * s.dy * d_power;
              d[5] = d_alpha * s.exp_p;
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) d[7 + k] = gc[k] * w;
#pragma unroll
            for (int k = 0; k < 7; ++k) d[11 + k] = gp[k] * wp;
#pragma unroll
            for (int k = 0; k < 6; ++k) d[18 + k] = gf[k] * w;
            T = t_next;
          }
        }
      }

      // Fixed-order sum over the tile's pixels: shuffle tree per warp,
      // then the warps' partials in warp order.
      float* part = s_part + ((j & 1) * BWD_MAX_WARPS + warp) * FEAT;
      if (__any_sync(FULL, hit)) {
#pragma unroll
        for (int c = 0; c < FEAT; ++c) {
          const bool zero = (c == 6 && !NEED_DD) || (c >= 18 && !HAS_FLOW);
          float v = zero ? 0.f : d[c];
          if (!zero) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              v += __shfl_down_sync(FULL, v, off);
          }
          if (lane == 0) part[c] = v;
        }
      } else if (lane < FEAT) {
        part[lane] = 0.f;
      }
      __syncthreads();
      if (pid < FEAT) {
        const float* parts = s_part + (j & 1) * BWD_MAX_WARPS * FEAT;
        float sum = 0.f;
        for (int w2 = 0; w2 < nwarps; ++w2) sum += parts[w2 * FEAT + pid];
        tile_dfeat[(size_t)(base + j) * FEAT + pid] = sum;
      }
    }
  }
  // Rows never reached (early exit, or past the count) get zeros.
  const int reached = min(base, count);
  for (int i = reached * FEAT + pid; i < extent * FEAT; i += pix) tile_dfeat[i] = 0.f;
}

}  // namespace gftorf
