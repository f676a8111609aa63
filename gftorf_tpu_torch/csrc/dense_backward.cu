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
// pixel. Each thread forms its pixel's totals from the forward residuals
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
// The per-tile body (composite_tile.cuh, shared with flat_backward.cu;
// this entry only finds the tile's slab) is built for Hopper: warps walk
// 32-row sub-batches without a block barrier, two live rows at a time,
// and reduce each row with one butterfly reduce-scatter into per-warp
// partials, which all threads add in warp order once per sub-batch; each
// warp skips the rows whose cull box (warp_cull.cuh) misses its pixels,
// which is exact; batches of 256 rows are double-buffered by bulk copies.
// The composite_tile.cuh notes say what bounded the first version and
// what each of these does about it. There is no float atomicAdd: the
// same inputs give the same bits on every run, and in both layouts.
//
// Bound on the H100: per tile one pass over the rows up to the early exit
// (96 B each), 368 B of bg, residuals and cotangent per pixel, and 96 B
// per lane of dfeat; against ~16 fp32 operations per evaluated (pixel,
// instance) pair and ~96 more per contributing pair (79 for d_alpha and
// the 24 gradient shares, 17 adds of the per-instance sums), +12 with
// flow and +20 with dd. That counts the function's work, not this
// implementation's (culled pairs are work the function does not need);
// chip_smoke.py computes it from each run's data. At the ftorf training
// shapes the bytes bound it (PERF.md).
//
// At most 512 pixels per tile (the JAX backward has the same ceiling,
// pallas_composite.py:109-114): the kernel runs one thread per pixel.
// Tile depth L has no ceiling: instances are staged in batches, so L=8192
// needs the same shared memory as L=128. Built with --fmad=false, like
// dense_forward.cu.

#include <cuda_runtime.h>

#include "composite_tile.cuh"

namespace {

using namespace gftorf;

template <bool NEED_DD, bool HAS_FLOW>
__global__ void __launch_bounds__(BWD_MAX_PIX, BWD_MIN_BLOCKS)
dense_backward_kernel(const float* __restrict__ feat,
                      const float* __restrict__ bg,
                      const float* __restrict__ out_res,
                      const float* __restrict__ grad,
                      const int* __restrict__ counts,
                      const int* __restrict__ origins,
                      float* __restrict__ dfeat,
                      int L, int tile_w, int width, int height) {
  extern __shared__ __align__(128) unsigned char smem[];

  // Tile t's rows are lanes [0, counts[t]) of its (L, 24) slab; it owns
  // all L of its dfeat rows.
  const int t = blockIdx.x;
  const size_t row = (size_t)t * blockDim.x + threadIdx.x;
  composite_tile_backward<NEED_DD, HAS_FLOW>(
      feat + (size_t)t * L * FEAT, min(max(counts[t], 0), L), L,
      pixel_of(origins, t, threadIdx.x, tile_w, width, height),
      warp_rect(origins, t, tile_w), bg + row * BGC, out_res + row * OUTC,
      grad + row * OUTC, dfeat + (size_t)t * L * FEAT,
      *reinterpret_cast<BwdShared*>(smem));
}

template <bool NEED_DD, bool HAS_FLOW>
int launch(int T, int pix, cudaStream_t s, const float* feat, const float* bg,
           const float* out_res, const float* grad, const int* counts,
           const int* origins, float* dfeat, int L, int tile_w, int width,
           int height) {
  const auto kernel = dense_backward_kernel<NEED_DD, HAS_FLOW>;
  const cudaError_t err = kernel_prepare(kernel, sizeof(BwdShared));
  if (err != cudaSuccess) return (int)err;
  kernel<<<T, pix, sizeof(BwdShared), s>>>(feat, bg, out_res, grad, counts,
                                           origins, dfeat, L, tile_w, width,
                                           height);
  return (int)cudaGetLastError();
}

// One thread per (row, rectangle) pair: out[r * m + q] = 1 when row r is
// culled for rectangle q.
__global__ void warp_cull_mask_kernel(const float* __restrict__ rows, int n,
                                      const float* __restrict__ rects, int m,
                                      unsigned char* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * m) return;
  const long long r = i / m, q = i % m;
  const float4 rect = make_float4(rects[4 * q], rects[4 * q + 1],
                                  rects[4 * q + 2], rects[4 * q + 3]);
  out[i] = culled(cull_box(rows + r * FEAT), rect) ? 1 : 0;
}

}  // namespace

// C entry, bound with ctypes. feat (T, L, 24) 16-byte aligned, bg
// (T, pix, 12), out_res and grad (T, pix, 32), counts (T,) int32, origins
// (T, 2) int32, dfeat (T, L, 24); all contiguous float32 (ints int32) on
// the current device. pix is the block size: a multiple of 32, at most
// 512. Launches on `stream` and returns the first CUDA error (0 = the
// launch was accepted).
extern "C" int gftorf_dense_backward(const float* feat, const float* bg,
                                     const float* out_res, const float* grad,
                                     const int* counts, const int* origins,
                                     float* dfeat, int T, int L, int pix,
                                     int tile_w, int width, int height,
                                     int need_dd, int has_flow, void* stream) {
  if (pix <= 0 || pix > BWD_MAX_PIX || pix % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need_dd && has_flow)
    return launch<true, true>(T, pix, s, feat, bg, out_res, grad, counts,
                              origins, dfeat, L, tile_w, width, height);
  if (need_dd)
    return launch<true, false>(T, pix, s, feat, bg, out_res, grad, counts,
                               origins, dfeat, L, tile_w, width, height);
  if (has_flow)
    return launch<false, true>(T, pix, s, feat, bg, out_res, grad, counts,
                               origins, dfeat, L, tile_w, width, height);
  return launch<false, false>(T, pix, s, feat, bg, out_res, grad, counts,
                              origins, dfeat, L, tile_w, width, height);
}

// The template's occupancy at `pix` threads a block: info[0] blocks per
// SM, info[1] registers and info[2] local (spill) bytes per thread,
// info[3] shared bytes per block. Returns the first CUDA error.
extern "C" int gftorf_dense_backward_occupancy(int pix, int need_dd,
                                               int has_flow, int* info) {
  const int bytes = sizeof(BwdShared);
  if (need_dd && has_flow) return kernel_occupancy(dense_backward_kernel<true, true>, pix, bytes, info);
  if (need_dd) return kernel_occupancy(dense_backward_kernel<true, false>, pix, bytes, info);
  if (has_flow) return kernel_occupancy(dense_backward_kernel<false, true>, pix, bytes, info);
  return kernel_occupancy(dense_backward_kernel<false, false>, pix, bytes, info);
}

// The backward kernels' cull predicate (warp_cull.cuh) on n rows (n, 24)
// and m rectangles (m, 4) float32 {x0, x1, y0, y1}; out (n, m) uint8.
// Used by chip_smoke.py to hold the device predicate against its plain
// version and brute force. Returns the first CUDA error.
extern "C" int gftorf_warp_cull_mask(const float* rows, int n, const float* rects,
                                     int m, unsigned char* out, void* stream) {
  const long long pairs = (long long)n * m;
  if (pairs <= 0) return 0;
  const int threads = 256;
  warp_cull_mask_kernel<<<(unsigned)((pairs + threads - 1) / threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(rows, n, rects, m, out);
  return (int)cudaGetLastError();
}
