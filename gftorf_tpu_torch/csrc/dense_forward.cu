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
// front-to-back recurrence on its pixel, with the tile's rows staged
// through shared memory once per tile and the block leaving when every
// pixel has stopped (or at counts[t]). Per-instance pixel counts are
// integer sums in a fixed order, so there is no float atomicAdd anywhere
// and the result is the same on every run.
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
// Bound on the H100: one pass over the rows up to each tile's last
// evaluated instance (96 B each) and 176 B of bg and output per pixel,
// against ~16 fp32 operations per (pixel, instance) pair evaluated up to
// the pixel's early exit and ~41 more per contributing pair (+12 with
// dd), none of which can use the tensor cores. At the ftorf training
// shapes the operations dominate the bytes (PERF.md), so the bound is the
// fp32 rate, 67 TFLOP/s, which counts a fused multiply-add as two
// operations: the kernel is built without them (below), so it cannot come
// near that rate. chip_smoke.py computes the bound for each run from the
// data.
//
// What the design does about it. The function's work counts every
// evaluated pair; a warp of 32 pixels, though, issues a row's evaluation
// and blend once for all its lanes, so the cost is the instructions
// issued per (row, warp) pair. The per-tile body (composite_tile.cuh,
// whose notes have the details) issues as few of them as it can without
// changing a bit: its warps hold 8x4 pixel blocks and skip every row
// whose footprint cannot reach their pixels (exact per-warp culling,
// warp_cull.cuh) and every row after their pixels stopped; they run free
// through 256-row batches double-buffered by bulk copies, with one block
// barrier a batch; two 512-thread blocks per SM keep 150 tiles in one
// wave. What is left is a tile's serial walk: the deepest tile, or two
// tiles sharing an SM, set the launch's time.
//
// Built with --fmad=false so each multiply and add rounds as the plain
// PyTorch version's elementwise ops do. The alpha and transmittance step
// lives in dense_common.cuh, shared with dense_backward.cu, so that the
// backward latches the early exit exactly where this kernel did. This
// entry only finds the tile's slab of the dense block.

#include <cuda_runtime.h>

#include "composite_tile.cuh"

namespace {

using namespace gftorf;

template <int MAX_PIX, bool NEED_DD, bool NEED_DIST>
__global__ void __launch_bounds__(MAX_PIX, MAX_PIX <= 512 ? FWD_MIN_BLOCKS : 1)
dense_forward_kernel(const float* __restrict__ feat,
                     const float* __restrict__ bg,
                     const int* __restrict__ counts,
                     const int* __restrict__ origins,
                     float* __restrict__ out,
                     float* __restrict__ contrib,
                     int L, int tile_w, int width, int height) {
  extern __shared__ __align__(128) unsigned char smem[];

  // Tile t's rows are lanes [0, counts[t]) of its (L, 24) slab; it owns
  // all L of its contrib lanes.
  const int t = blockIdx.x;
  const int i = block_pixel(tile_w, blockDim.x);  // this thread's pixel
  const size_t row = (size_t)t * blockDim.x + i;
  composite_tile_forward<NEED_DD, NEED_DIST, MAX_PIX / 32>(
      feat + (size_t)t * L * FEAT, min(max(counts[t], 0), L), L,
      pixel_of(origins, t, i, tile_w, width, height),
      block_rect(origins, t, tile_w, blockDim.x),
      bg + row * BGC, out + row * OUTC, contrib + (size_t)t * L,
      *reinterpret_cast<FwdShared<MAX_PIX / 32>*>(smem));
}

using Kernel = void (*)(const float*, const float*, const int*, const int*,
                        float*, float*, int, int, int, int);

template <int MAX_PIX>
Kernel gated(int need_dd, int need_dist) {
  if (need_dd && need_dist) return dense_forward_kernel<MAX_PIX, true, true>;
  if (need_dd) return dense_forward_kernel<MAX_PIX, true, false>;
  if (need_dist) return dense_forward_kernel<MAX_PIX, false, true>;
  return dense_forward_kernel<MAX_PIX, false, false>;
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

// C entry, bound with ctypes. feat (T, L, 24) 16-byte aligned, bg
// (T, pix, 12), counts (T,) int32, origins (T, 2) int32, out (T, pix, 32),
// contrib (T, L); all contiguous on the current device. pix is the block
// size: a multiple of 32, at most 1024. Launches on `stream` and returns
// the first CUDA error (0 = the launch was accepted).
extern "C" int gftorf_dense_forward(const float* feat, const float* bg,
                                    const int* counts, const int* origins,
                                    float* out, float* contrib, int T, int L,
                                    int pix, int tile_w, int width, int height,
                                    int need_dd, int need_dist, void* stream) {
  if (pix <= 0 || pix > 1024 || pix % 32 != 0) return (int)cudaErrorInvalidValue;
  int bytes = 0;
  const Kernel kernel = instance(pix, need_dd, need_dist, &bytes);
  const cudaError_t err = kernel_prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<T, pix, bytes, static_cast<cudaStream_t>(stream)>>>(
      feat, bg, counts, origins, out, contrib, L, tile_w, width, height);
  return (int)cudaGetLastError();
}

// The instance's occupancy at `pix` threads a block: info[0] blocks per
// SM, info[1] registers and info[2] local (spill) bytes per thread,
// info[3] shared bytes per block. Returns the first CUDA error.
extern "C" int gftorf_dense_forward_occupancy(int pix, int need_dd,
                                              int need_dist, int* info) {
  if (pix <= 0 || pix > 1024 || pix % 32 != 0) return (int)cudaErrorInvalidValue;
  int bytes = 0;
  const Kernel kernel = instance(pix, need_dd, need_dist, &bytes);
  return kernel_occupancy(kernel, pix, bytes, info);
}
