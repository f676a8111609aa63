// Dense-layout tile compositing, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gftorf_tpu/render/pallas_composite.py::
// _backward_kernel (launched by composite_backward_pallas; its custom VJP
// is _make_pallas_vjp). Same function: the gradient of the compositor's
// (T, PIX, 32) output block with respect to the packed (T, L, 24) feature
// block, given the forward's output block (its residual columns 13, 17,
// 18, 19) and the cotangent g. Rows of dfeat follow the packed columns
//   0:2 mean2d | 2:5 conic | 5 opacity | 6 dist_ndc | 7:10 rgb | 10 dist
//   11:18 phasor | 18:24 flow
// and lanes at or past counts[t], or never reached before the tile's
// early exit, get zero rows.
//
// Design. The Pallas kernel is a chunked prefix form (Hillis-Steele scans
// over 128 lanes, MXU dot products) because of the TPU's lanes. Here it is
// the sequential recurrence again: one block per tile, one thread per
// pixel, instances staged through shared memory in batches of BATCH rows.
// Each thread first forms its pixel's totals from the forward residuals
// and g (e_tot, ep_tot, u_dd_tot, bg_dot; pallas_composite.py:466-486),
// then walks the tile's instances front to back, recomputing alpha and T
// with the forward's own step (dense_common.cuh, so the early exit latches
// where the forward latched), keeping the inclusive running sums u_f, u_p,
// u_dd, and forming d_alpha exactly as pallas_composite.py:512-527: the
// suffix sums are totals minus inclusive prefixes, divided by
// q = 1 - alpha >= 0.01. From d_alpha come the pixel's shares of d_mean2d,
// d_conic and d_opacity (zero where the unclamped alpha reaches 0.99),
// d_dist_ndc (dd only), and the weighted color, distance, phasor and flow
// gradients (flow with detached weights: no d_alpha term).
//
// The per-instance sum over the tile's pixels is deterministic: a fixed
// warp-shuffle tree per column, lane 0 of each warp stores the warp's 24
// partials in shared memory, and 24 threads add the warps' partials in
// warp order and store the row. A warp none of whose pixels the instance
// reached stores zeros without shuffling. There is no float atomicAdd;
// the same inputs give the same bits on every run. The partials are
// double-buffered by instance parity, so one barrier per instance
// suffices. The block leaves when every pixel has stopped (checked per
// batch): past that point every partial is zero, so where it stops does
// not change the result.
//
// Bound on the H100: per tile one pass over the rows up to the early exit
// (96 B each), 368 B of bg, residuals and cotangent per pixel, and 96 B
// per lane of dfeat; against ~16 fp32 operations per evaluated (pixel,
// instance) pair and ~96 more per contributing pair (79 for d_alpha and
// the 24 gradient shares, 17 adds of the per-instance sums), +12 with
// flow and +20 with dd. At the training shapes (150 tiles of 512 pixels,
// L about 2,000) the operations dominate, so the bound is the fp32 rate
// (67 TFLOP/s); chip_smoke.py computes it from each run's data. The
// shuffle trees (5 per column per warp per instance) and the per-instance
// barrier are the overhead this first, simple version pays: later work
// can reduce 24 columns in one transposing butterfly, cull instances per
// warp, and double-buffer the batches (cp.async/TMA).
//
// At most 512 pixels per tile (the JAX backward has the same ceiling,
// pallas_composite.py:109-114): the kernel keeps ~80 registers per thread
// and runs one thread per pixel. Tile depth L has no ceiling: instances
// are staged in batches, so L=8192 needs the same 27 KB of shared memory
// as L=128. Built with --fmad=false, like dense_forward.cu.

#include <cuda_runtime.h>

#include "dense_common.cuh"

namespace {

using namespace gftorf;

constexpr int BATCH = 256;    // instances staged per batch: 24 KB of shared memory
constexpr int MAX_PIX = 512;  // one thread per pixel
constexpr int MAX_WARPS = MAX_PIX / 32;

template <bool NEED_DD, bool HAS_FLOW>
__global__ void __launch_bounds__(MAX_PIX)
dense_backward_kernel(const float* __restrict__ feat,
                      const float* __restrict__ bg,
                      const float* __restrict__ out_res,
                      const float* __restrict__ grad,
                      const int* __restrict__ counts,
                      const int* __restrict__ origins,
                      float* __restrict__ dfeat,
                      int L, int tile_w, int width, int height) {
  __shared__ float s_feat[BATCH * FEAT];
  __shared__ float s_part[2][MAX_WARPS][FEAT];

  const int t = blockIdx.x;
  const int pid = threadIdx.x;
  const int pix = blockDim.x;
  const int lane = pid & 31;
  const int warp = pid >> 5;
  const int nwarps = pix >> 5;
  const int count = min(max(counts[t], 0), L);
  const float px = (float)origins[2 * t] + (float)(pid % tile_w);
  const float py = (float)origins[2 * t + 1] + (float)(pid / tile_w);
  const bool inside = (px < (float)width) && (py < (float)height);

  // This pixel's residuals, cotangent and bg (pallas_composite.py:462-486).
  const size_t row = (size_t)t * pix + pid;
  const float* o = out_res + row * OUTC;
  const float* gr = grad + row * OUTC;
  const float* b = bg + row * BGC;
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

  bool done = !inside;
  float T = 1.0f, u_f = 0.f, u_p = 0.f, u_dd = 0.f;
  const float* tile_feat = feat + (size_t)t * L * FEAT;
  float* tile_dfeat = dfeat + (size_t)t * L * FEAT;
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
        const Sample s = eval_sample(f, px, py);
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
      float* part = s_part[j & 1][warp];
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
        float sum = 0.f;
        for (int w2 = 0; w2 < nwarps; ++w2) sum += s_part[j & 1][w2][pid];
        tile_dfeat[(size_t)(base + j) * FEAT + pid] = sum;
      }
    }
  }
  // Rows never reached (early exit, or past the count) get zeros.
  const int reached = min(base, count);
  for (int i = reached * FEAT + pid; i < L * FEAT; i += pix) tile_dfeat[i] = 0.f;
}

template <bool NEED_DD, bool HAS_FLOW>
void launch(dim3 grid, dim3 block, cudaStream_t s, const float* feat,
            const float* bg, const float* out_res, const float* grad,
            const int* counts, const int* origins, float* dfeat, int L,
            int tile_w, int width, int height) {
  dense_backward_kernel<NEED_DD, HAS_FLOW><<<grid, block, 0, s>>>(
      feat, bg, out_res, grad, counts, origins, dfeat, L, tile_w, width,
      height);
}

}  // namespace

// C entry, bound with ctypes. feat (T, L, 24), bg (T, pix, 12), out_res and
// grad (T, pix, 32), counts (T,) int32, origins (T, 2) int32, dfeat
// (T, L, 24); all contiguous float32 (ints int32) on the current device.
// pix is the block size: a multiple of 32, at most 512. Launches on
// `stream` and returns cudaGetLastError() (0 = the launch was accepted).
extern "C" int gftorf_dense_backward(const float* feat, const float* bg,
                                     const float* out_res, const float* grad,
                                     const int* counts, const int* origins,
                                     float* dfeat, int T, int L, int pix,
                                     int tile_w, int width, int height,
                                     int need_dd, int has_flow, void* stream) {
  if (pix <= 0 || pix > MAX_PIX || pix % 32 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(T), block(pix);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need_dd && has_flow)
    launch<true, true>(grid, block, s, feat, bg, out_res, grad, counts,
                       origins, dfeat, L, tile_w, width, height);
  else if (need_dd)
    launch<true, false>(grid, block, s, feat, bg, out_res, grad, counts,
                        origins, dfeat, L, tile_w, width, height);
  else if (has_flow)
    launch<false, true>(grid, block, s, feat, bg, out_res, grad, counts,
                        origins, dfeat, L, tile_w, width, height);
  else
    launch<false, false>(grid, block, s, feat, bg, out_res, grad, counts,
                         origins, dfeat, L, tile_w, width, height);
  return (int)cudaGetLastError();
}
