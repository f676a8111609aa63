// Flat sorted-stream tile compositing, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel gftorf_tpu/render/flat_stream.py::
// _forward_kernel_flat (launched by composite_forward_flat). Same
// function: the front-to-back blend of dense_forward.cu, with the same
// (T, PIX, 32) output block, over the aligned flat stream (K, 24): each
// tile's depth-sorted instances are one contiguous segment of it,
// starting at a FLAT_ALIGN (256) multiple, and every other row is
// padding. Besides the block it writes a contributing-pixel count per
// stream slot (K,).
//
// Design. The TPU kernel is a sequential grid over stream chunks: a
// scalar-prefetched chunk->tile map picks each chunk's bg and output
// block, and the per-tile state (T, accumulators, dd moments, first
// sample) lives in VMEM scratch, reset on a tile's first chunk and
// flushed on its last. Blocks on the card run in no order, so no state
// can be carried from one to the next; instead each block owns one tile
// and walks that tile's rows [tile_start[t], tile_start[t] +
// tile_count[t]) in shared-memory batches, keeping the per-tile state in
// registers for the whole walk. That is the dense forward's per-tile body
// (composite_tile.cuh) with another row base and count, so a tile gives
// the same bits in both layouts. The block reads only its tile's rows,
// never the padding: the tail blocks of the stream, which the TPU map
// assigns to the last tile (up to K - num_rendered rows at the training
// shapes), are walked by no one. Tile depth is a loop bound: a tile of any
// depth runs in the same 90,128 B of dynamic shared memory (two 256-row
// staging buffers, their cull boxes and the warps' count slots).
//
// Rows of `contrib` outside the walked rows are not written here: the
// wrapper (render/kernels/flat.py) hands a zeroed buffer, and the walked
// rows past the tile's early exit are zeroed by the body, so every slot
// but the contributing ones holds 0, as the TPU kernel writes.
//
// Bound on the H100: one pass over the rows walked before each tile's
// early exit (96 B each), 176 B of bg and output per pixel and 4 B of
// contrib per stream slot, against the dense forward's ~16 fp32
// operations per evaluated (pixel, instance) pair and ~41 per contributing
// pair; the operations dominate at the ftorf training shapes, and the
// fp32 rate counts fused multiply-adds this kernel is built without.
// chip_smoke.py computes the bound from each run's data. The design's
// answer is the dense forward's (dense_forward.cu, composite_tile.cuh):
// per-warp culling over 8x4 pixel blocks, warps free inside a batch,
// bulk-copy staging, two blocks per SM. A tile is still one block's
// serial work, so the deepest tile sets the launch's time (21,535 rows
// in chip_smoke.py's deep-tile scene). Built with --fmad=false, like the
// dense kernels.

#include <cuda_runtime.h>

#include "composite_tile.cuh"

namespace {

using namespace gftorf;

template <int MAX_PIX, bool NEED_DD, bool NEED_DIST>
__global__ void __launch_bounds__(MAX_PIX, MAX_PIX <= 512 ? FWD_MIN_BLOCKS : 1)
flat_forward_kernel(const float* __restrict__ feat,
                    const float* __restrict__ bg,
                    const int* __restrict__ tile_start,
                    const int* __restrict__ tile_count,
                    const int* __restrict__ origins,
                    float* __restrict__ out,
                    float* __restrict__ contrib,
                    int K, int tile_w, int width, int height) {
  extern __shared__ __align__(128) unsigned char smem[];

  // Tile t's rows are its stream segment [start, start + count); it owns
  // the contrib slots of those rows. A range outside [0, K) is cut.
  const int t = blockIdx.x;
  int start = tile_start[t];
  int count = tile_count[t];
  if (start < 0 || start > K) start = count = 0;
  count = min(max(count, 0), K - start);
  const int i = block_pixel(tile_w, blockDim.x);  // this thread's pixel
  const size_t row = (size_t)t * blockDim.x + i;
  composite_tile_forward<NEED_DD, NEED_DIST, MAX_PIX / 32>(
      feat + (size_t)start * FEAT, count, count,
      pixel_of(origins, t, i, tile_w, width, height),
      block_rect(origins, t, tile_w, blockDim.x),
      bg + row * BGC, out + row * OUTC, contrib + start,
      *reinterpret_cast<FwdShared<MAX_PIX / 32>*>(smem));
}

using Kernel = void (*)(const float*, const float*, const int*, const int*,
                        const int*, float*, float*, int, int, int, int);

template <int MAX_PIX>
Kernel gated(int need_dd, int need_dist) {
  if (need_dd && need_dist) return flat_forward_kernel<MAX_PIX, true, true>;
  if (need_dd) return flat_forward_kernel<MAX_PIX, true, false>;
  if (need_dist) return flat_forward_kernel<MAX_PIX, false, true>;
  return flat_forward_kernel<MAX_PIX, false, false>;
}

// The instance for blocks of `pix` threads, and its dynamic shared bytes.
Kernel instance(int pix, int need_dd, int need_dist, int* bytes) {
  if (pix <= 512) {
    *bytes = sizeof(FwdShared<16>);
    return gated<512>(need_dd, need_dist);
  }
  *bytes = sizeof(FwdShared<32>);
  return gated<1024>(need_dd, need_dist);
}

}  // namespace

// C entry, bound with ctypes. feat (K, 24) 16-byte aligned, bg (T, pix,
// 12), tile_start and tile_count (T,) int32 (segments start at multiples
// of 256 rows), origins (T, 2) int32, out (T, pix, 32), contrib (K,)
// zeroed by the caller; all contiguous on the current device. pix is the
// block size: a multiple of 32, at most 1024. Launches on `stream` and
// returns the first CUDA error (0 = the launch was accepted).
extern "C" int gftorf_flat_forward(const float* feat, const float* bg,
                                   const int* tile_start, const int* tile_count,
                                   const int* origins, float* out,
                                   float* contrib, int T, int K, int pix,
                                   int tile_w, int width, int height,
                                   int need_dd, int need_dist, void* stream) {
  if (pix <= 0 || pix > 1024 || pix % 32 != 0) return (int)cudaErrorInvalidValue;
  int bytes = 0;
  const Kernel kernel = instance(pix, need_dd, need_dist, &bytes);
  const cudaError_t err = kernel_prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<T, pix, bytes, static_cast<cudaStream_t>(stream)>>>(
      feat, bg, tile_start, tile_count, origins, out, contrib, K, tile_w,
      width, height);
  return (int)cudaGetLastError();
}

// The instance's occupancy at `pix` threads a block: info[0] blocks per
// SM, info[1] registers and info[2] local (spill) bytes per thread,
// info[3] shared bytes per block. Returns the first CUDA error.
extern "C" int gftorf_flat_forward_occupancy(int pix, int need_dd,
                                             int need_dist, int* info) {
  if (pix <= 0 || pix > 1024 || pix % 32 != 0) return (int)cudaErrorInvalidValue;
  int bytes = 0;
  const Kernel kernel = instance(pix, need_dd, need_dist, &bytes);
  return kernel_occupancy(kernel, pix, bytes, info);
}
