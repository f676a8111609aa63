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
// as L=128. Built with --fmad=false, like dense_forward.cu. The per-tile
// body lives in composite_tile.cuh, shared with flat_backward.cu: this
// entry only finds the tile's slab of the dense block.

#include <cuda_runtime.h>

#include "composite_tile.cuh"

namespace {

using namespace gftorf;

template <bool NEED_DD, bool HAS_FLOW>
__global__ void __launch_bounds__(BWD_MAX_PIX)
dense_backward_kernel(const float* __restrict__ feat,
                      const float* __restrict__ bg,
                      const float* __restrict__ out_res,
                      const float* __restrict__ grad,
                      const int* __restrict__ counts,
                      const int* __restrict__ origins,
                      float* __restrict__ dfeat,
                      int L, int tile_w, int width, int height) {
  __shared__ float s_feat[BATCH * FEAT];
  __shared__ float s_part[2 * BWD_MAX_WARPS * FEAT];

  // Tile t's rows are lanes [0, counts[t]) of its (L, 24) slab; it owns
  // all L of its dfeat rows.
  const int t = blockIdx.x;
  const size_t row = (size_t)t * blockDim.x + threadIdx.x;
  composite_tile_backward<NEED_DD, HAS_FLOW>(
      feat + (size_t)t * L * FEAT, min(max(counts[t], 0), L), L,
      pixel_of(origins, t, tile_w, width, height), bg + row * BGC,
      out_res + row * OUTC, grad + row * OUTC, dfeat + (size_t)t * L * FEAT,
      s_feat, s_part);
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
  if (pix <= 0 || pix > BWD_MAX_PIX || pix % 32 != 0) return (int)cudaErrorInvalidValue;
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
