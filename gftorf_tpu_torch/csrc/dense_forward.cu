// Dense-layout tile compositing, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gftorf_tpu/render/pallas_composite.py::
// _forward_kernel (launched by composite_forward_pallas). Same function:
// front-to-back alpha blending of up to L depth-sorted instances per tile,
// with the output column map of pallas_composite.py:30-37:
//   0:3 color(+bg) | 3 depth | 4:11 phasor(+bg) | 11 acc | 12 dd
//   13 final_T | 14:17 first-sample (alpha, dist, amp)
//   17 A_tot | 18 WZ_tot | 19 WZ2_tot | 20:26 flow (no bg) | 26:32 zero
// and a per-instance count of contributing pixels (T, L).
//
// Design. The Pallas kernel is a prefix-scan form (Hillis-Steele cumprod
// over 128-lane chunks, MXU dot products) because of the TPU's lanes.
// Here the sequential form of the reference's renderCUDA is the simple
// one: one block per tile, one thread per pixel, each thread running the
// front-to-back recurrence on its pixel. The tile's instances are staged
// through shared memory in batches of BATCH rows with a block-wide
// cooperative load, so each row is read from device memory once per tile.
// A warp whose pixels have all stopped skips the batch; the block leaves
// when every pixel has stopped (__syncthreads_count) or at counts[t].
// Per-instance pixel counts are integer adds into shared memory (one
// atomicAdd of a warp ballot's popcount per warp and instance): integer
// sums are exact in any order, so the result is deterministic and there
// is no float atomicAdd anywhere.
//
// Semantics kept from the TPU kernel:
//  - alpha = min(0.99, o * exp(min(power, 0))); an instance is valid when
//    power <= 0, alpha >= 1/255, the pixel is inside the image and the
//    lane is below counts[t] (lanes at or past the count are never read);
//  - a pixel stops at the first valid instance whose T * (1 - alpha)
//    falls below 1e-4, and that instance does not contribute;
//  - color, depth and flow weigh by w = alpha * T, the 7 phasor channels
//    by alpha * T^2;
//  - bg is added times the frozen T, the T after the last contributing
//    instance (pallas_composite.py:346-353, 420-421), which is the T the
//    recurrence holds when it stops;
//  - the dd moments are exclusive running sums across batches, kept in
//    registers; the first contributing sample is taken once per pixel.
//
// Bound on the H100: the work per tile is one pass over count[t] rows of
// 96 bytes plus 176 bytes of bg and output per pixel, against ~16 fp32
// operations per evaluated (pixel, instance) pair and ~50 more per
// contributing pair, none of which can use the tensor cores. At the
// serving shapes (150 tiles of 512 pixels, L up to a few thousand) the
// operations dominate the bytes, so the kernel is bound by the fp32 rate
// (67 TFLOP/s); chip_smoke.py computes the exact bound for each run from
// the data. This first version is the simple correct one: later work can
// cull instances per warp and double-buffer the batches (cp.async/TMA).
//
// Built with --fmad=false so each multiply and add rounds as the plain
// PyTorch version's elementwise ops do. The alpha and transmittance step
// lives in dense_common.cuh, shared with dense_backward.cu, so that the
// backward latches the early exit exactly where this kernel did. The
// per-tile body lives in composite_tile.cuh, shared with flat_forward.cu:
// this entry only finds the tile's slab of the dense block.

#include <cuda_runtime.h>

#include "composite_tile.cuh"

namespace {

using namespace gftorf;

template <bool NEED_DD, bool NEED_DIST>
__global__ void __launch_bounds__(1024)
dense_forward_kernel(const float* __restrict__ feat,
                     const float* __restrict__ bg,
                     const int* __restrict__ counts,
                     const int* __restrict__ origins,
                     float* __restrict__ out,
                     float* __restrict__ contrib,
                     int L, int tile_w, int width, int height) {
  __shared__ float s_feat[BATCH * FEAT];
  __shared__ int s_hits[BATCH];

  // Tile t's rows are lanes [0, counts[t]) of its (L, 24) slab; it owns
  // all L of its contrib lanes.
  const int t = blockIdx.x;
  const size_t row = (size_t)t * blockDim.x + threadIdx.x;
  composite_tile_forward<NEED_DD, NEED_DIST>(
      feat + (size_t)t * L * FEAT, min(max(counts[t], 0), L), L,
      pixel_of(origins, t, tile_w, width, height), bg + row * BGC,
      out + row * OUTC, contrib + (size_t)t * L, s_feat, s_hits);
}

}  // namespace

// C entry, bound with ctypes. feat (T, L, 24), bg (T, pix, 12),
// counts (T,) int32, origins (T, 2) int32, out (T, pix, 32),
// contrib (T, L); all contiguous on the current device. pix is the block
// size: a multiple of 32, at most 1024. Launches on `stream` and returns
// cudaGetLastError() (0 = the launch was accepted).
extern "C" int gftorf_dense_forward(const float* feat, const float* bg,
                                    const int* counts, const int* origins,
                                    float* out, float* contrib, int T, int L,
                                    int pix, int tile_w, int width, int height,
                                    int need_dd, int need_dist, void* stream) {
  if (pix <= 0 || pix > 1024 || pix % 32 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(T), block(pix);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need_dd && need_dist)
    dense_forward_kernel<true, true><<<grid, block, 0, s>>>(
        feat, bg, counts, origins, out, contrib, L, tile_w, width, height);
  else if (need_dd)
    dense_forward_kernel<true, false><<<grid, block, 0, s>>>(
        feat, bg, counts, origins, out, contrib, L, tile_w, width, height);
  else if (need_dist)
    dense_forward_kernel<false, true><<<grid, block, 0, s>>>(
        feat, bg, counts, origins, out, contrib, L, tile_w, width, height);
  else
    dense_forward_kernel<false, false><<<grid, block, 0, s>>>(
        feat, bg, counts, origins, out, contrib, L, tile_w, width, height);
  return (int)cudaGetLastError();
}
