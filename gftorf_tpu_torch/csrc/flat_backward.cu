// Flat sorted-stream tile compositing, backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gftorf_tpu/render/flat_stream.py::
// _backward_kernel_flat (launched by composite_backward_flat; its custom
// VJP is _make_flat_vjp). Same function: the gradient of the flat
// forward's (T, PIX, 32) output block with respect to the aligned stream
// (K, 24), given the forward's output block (its residual columns 13, 17,
// 18, 19) and the cotangent g. Rows of dfeat follow the packed columns of
// dense_backward.cu; rows outside every tile's walked range (padding, the
// tail, rows past a tile's early exit) are zero, as the TPU kernel writes
// zeros for the chunks it skips.
//
// Design. The TPU kernel carries the suffix-sum prefixes u_f, u_p, u_dd
// and the transmittance in VMEM scratch from one stream chunk of a tile
// to the next. Here one block owns one tile and walks its rows
// [tile_start[t], tile_start[t] + tile_count[t]) with those carries in
// registers: the dense backward's per-tile body (composite_tile.cuh) with
// another row base and count, so a tile gives the same bits in both
// layouts. That body (its notes say what bounded its first version and
// what it does now) lets warps walk 32-row sub-batches with one barrier
// each, two live rows at a time, reduces a row with one butterfly
// reduce-scatter per warp, skips the rows whose cull box misses a warp's
// pixels (warp_cull.cuh; exact) and double-buffers 256-row batches by
// bulk copies (every batch starts on a row, so 16-byte aligned in a
// 16-byte aligned stream). Its sums are in a fixed order, with no float
// atomicAdd, so the same inputs give the same bits on every run. The
// wrapper hands a zeroed dfeat (K, 24) and the block writes only its
// tile's rows, so no block walks the stream's padding.
//
// Bound on the H100: one pass over the rows walked before each tile's
// early exit (96 B each), 368 B of bg, residuals and cotangent per pixel,
// and 96 B of dfeat per stream slot (the (K, 24) gradient is the
// function's output: 155 MB at the ftorf training shapes, K = 1,611,264),
// against the dense backward's operation counts per evaluated and
// contributing pair. At most 512 pixels per tile, as the TPU kernel
// (flat_stream.py:471-483) and dense_backward.cu; tile depth has no
// ceiling, but the deepest tile is one block's serial work. Built with
// --fmad=false, like the dense kernels.

#include <cuda_runtime.h>

#include "composite_tile.cuh"

namespace {

using namespace gftorf;

template <bool NEED_DD, bool HAS_FLOW>
__global__ void __launch_bounds__(BWD_MAX_PIX, BWD_MIN_BLOCKS)
flat_backward_kernel(const float* __restrict__ feat,
                     const float* __restrict__ bg,
                     const float* __restrict__ out_res,
                     const float* __restrict__ grad,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const int* __restrict__ origins,
                     float* __restrict__ dfeat,
                     int K, int tile_w, int width, int height) {
  extern __shared__ __align__(128) unsigned char smem[];

  // Tile t's rows are its stream segment [start, start + count); it owns
  // the dfeat rows of those rows. A range outside [0, K) is cut.
  const int t = blockIdx.x;
  int start = tile_start[t];
  int count = tile_count[t];
  if (start < 0 || start > K) start = count = 0;
  count = min(max(count, 0), K - start);
  const size_t row = (size_t)t * blockDim.x + threadIdx.x;
  composite_tile_backward<NEED_DD, HAS_FLOW>(
      feat + (size_t)start * FEAT, count, count,
      pixel_of(origins, t, threadIdx.x, tile_w, width, height),
      warp_rect(origins, t, tile_w), bg + row * BGC, out_res + row * OUTC,
      grad + row * OUTC, dfeat + (size_t)start * FEAT,
      *reinterpret_cast<BwdShared*>(smem));
}

template <bool NEED_DD, bool HAS_FLOW>
int launch(int T, int pix, cudaStream_t s, const float* feat, const float* bg,
           const float* out_res, const float* grad, const int* tile_start,
           const int* tile_count, const int* origins, float* dfeat, int K,
           int tile_w, int width, int height) {
  const auto kernel = flat_backward_kernel<NEED_DD, HAS_FLOW>;
  const cudaError_t err = kernel_prepare(kernel, sizeof(BwdShared));
  if (err != cudaSuccess) return (int)err;
  kernel<<<T, pix, sizeof(BwdShared), s>>>(feat, bg, out_res, grad, tile_start,
                                           tile_count, origins, dfeat, K,
                                           tile_w, width, height);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. feat (K, 24) 16-byte aligned, bg (T, pix,
// 12), out_res and grad (T, pix, 32), tile_start and tile_count (T,)
// int32 (segments start at multiples of 256 rows), origins (T, 2) int32,
// dfeat (K, 24) zeroed by the caller; all contiguous on the current
// device. pix is the block size: a multiple of 32, at most 512. Launches
// on `stream` and returns the first CUDA error (0 = the launch was
// accepted).
extern "C" int gftorf_flat_backward(const float* feat, const float* bg,
                                    const float* out_res, const float* grad,
                                    const int* tile_start,
                                    const int* tile_count, const int* origins,
                                    float* dfeat, int T, int K, int pix,
                                    int tile_w, int width, int height,
                                    int need_dd, int has_flow, void* stream) {
  if (pix <= 0 || pix > BWD_MAX_PIX || pix % 32 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (need_dd && has_flow)
    return launch<true, true>(T, pix, s, feat, bg, out_res, grad, tile_start,
                              tile_count, origins, dfeat, K, tile_w, width, height);
  if (need_dd)
    return launch<true, false>(T, pix, s, feat, bg, out_res, grad, tile_start,
                               tile_count, origins, dfeat, K, tile_w, width, height);
  if (has_flow)
    return launch<false, true>(T, pix, s, feat, bg, out_res, grad, tile_start,
                               tile_count, origins, dfeat, K, tile_w, width, height);
  return launch<false, false>(T, pix, s, feat, bg, out_res, grad, tile_start,
                              tile_count, origins, dfeat, K, tile_w, width, height);
}

// The template's occupancy at `pix` threads a block: info[0] blocks per
// SM, info[1] registers and info[2] local (spill) bytes per thread,
// info[3] shared bytes per block. Returns the first CUDA error.
extern "C" int gftorf_flat_backward_occupancy(int pix, int need_dd,
                                              int has_flow, int* info) {
  const int bytes = sizeof(BwdShared);
  if (need_dd && has_flow) return kernel_occupancy(flat_backward_kernel<true, true>, pix, bytes, info);
  if (need_dd) return kernel_occupancy(flat_backward_kernel<true, false>, pix, bytes, info);
  if (has_flow) return kernel_occupancy(flat_backward_kernel<false, true>, pix, bytes, info);
  return kernel_occupancy(flat_backward_kernel<false, false>, pix, bytes, info);
}
