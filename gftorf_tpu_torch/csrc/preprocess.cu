// Per-Gaussian preprocess, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this stage to XLA, which
// fuses render/preprocess.py's jnp body into a few loops. In eager
// PyTorch the same body (render/preprocess.py::preprocess_plain) is about
// 295 elementwise launches a render forward and 595 backward, each a few
// microseconds on the card but 20-24 us of the host's time to launch, so the
// host, not the card, set the pace of a training step. These two kernels
// do that work in one launch each way (two backward when phase_offset or
// dc_offset is a tensor that needs a gradient: the second sums their
// per-block partials).
//
// Design. One thread per Gaussian, everything in registers
// (preprocess_row.cuh has the math and its notes): projection and cull,
// the 3D covariance, the EWA projection with its clip, conic, radius and
// tile rect, the view direction, SH degrees 0-3 (a template parameter)
// for the colour and the phasor, and the ToF phasor channels. The
// backward recomputes the forward's intermediates from the inputs instead
// of storing them, and writes each Gaussian's gradients once: no atomics.
// The offsets' gradients are sums over the Gaussians: each block reduces
// its rows in a fixed tree order into a partial, and a one-block second
// pass sums the partials in a fixed order, so a step gives the same bits
// on every run.
//
// Bound on the H100: bytes. Per Gaussian the forward reads about 372 B at
// SH 3 with shs_p (means, scale, rotation, opacity, 48 + 32 SH
// coefficients, the NDC offset) and writes 97 B; the backward reads those
// inputs and 72 B of cotangents and writes about 368 B of gradients. At
// 131,072 rows that is about 61 MB and 106 MB: 18 and 32 us at 3.35
// TB/s. The arithmetic (a few hundred fp32 operations a row, more for SH
// 3's gradient) is far below the fp32 rate at that size. chip_smoke.py
// times both against this bound.
//
// Precision: float32 throughout, IEEE division and square root, the
// full-precision sinf/cosf, and --fmad=false (build.py) so each multiply
// and add rounds as the plain version's elementwise ops do. rsqrtf is
// what torch.rsqrt runs on the card.

#include <cuda_runtime.h>

#include "preprocess_row.cuh"

namespace {

using namespace gftorf::pre;

constexpr int THREADS = 256;

template <int DEG>
__global__ void __launch_bounds__(THREADS)
preprocess_forward_kernel(const Params p, const Outputs o) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= p.P) return;
  const Camera c = load_camera(p);
  forward_row<DEG>(p, c, o, i);
}

// Sums v[0][:] and v[1][:] of THREADS entries into v[.][0], in a fixed
// tree order.
__device__ __forceinline__ void block_sum2(float (&v)[2][THREADS]) {
  const int t = threadIdx.x;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      v[0][t] += v[0][t + s];
      v[1][t] += v[1][t + s];
    }
    __syncthreads();
  }
}

template <int DEG>
__global__ void __launch_bounds__(THREADS)
preprocess_backward_kernel(const Params p, const Grads g) {
  __shared__ float red[2][THREADS];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  float g_po = 0.0f, g_dc = 0.0f;
  if (i < p.P) {
    const Camera c = load_camera(p);
    backward_row<DEG>(p, c, g, i, g_po, g_dc);
  }
  if (g.partials == nullptr) return;  // uniform across the launch
  red[0][threadIdx.x] = g_po;
  red[1][threadIdx.x] = g_dc;
  block_sum2(red);
  if (threadIdx.x == 0) {
    g.partials[2 * blockIdx.x] = red[0][0];
    g.partials[2 * blockIdx.x + 1] = red[1][0];
  }
}

// The offsets' second pass: one block sums the per-block partials, each
// thread a fixed stride of them, then the tree.
__global__ void __launch_bounds__(THREADS)
offsets_sum_kernel(const float* __restrict__ partials, int blocks,
                   float* __restrict__ out) {
  __shared__ float red[2][THREADS];
  float a = 0.0f, b = 0.0f;
  for (int k = threadIdx.x; k < blocks; k += THREADS) {
    a += partials[2 * k];
    b += partials[2 * k + 1];
  }
  red[0][threadIdx.x] = a;
  red[1][threadIdx.x] = b;
  block_sum2(red);
  if (threadIdx.x == 0) {
    out[0] = red[0][0];
    out[1] = red[1][0];
  }
}

using Fwd = void (*)(const Params, const Outputs);
using Bwd = void (*)(const Params, const Grads);

Fwd forward_instance(int degree) {
  switch (degree) {
    case 0: return preprocess_forward_kernel<0>;
    case 1: return preprocess_forward_kernel<1>;
    case 2: return preprocess_forward_kernel<2>;
    case 3: return preprocess_forward_kernel<3>;
    default: return nullptr;
  }
}

Bwd backward_instance(int degree) {
  switch (degree) {
    case 0: return preprocess_backward_kernel<0>;
    case 1: return preprocess_backward_kernel<1>;
    case 2: return preprocess_backward_kernel<2>;
    case 3: return preprocess_backward_kernel<3>;
    default: return nullptr;
  }
}

int blocks_of(int P) { return (P + THREADS - 1) / THREADS; }

template <typename Kernel>
int occupancy(Kernel kernel, int* info) {
  int blocks = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = (int)attr.sharedSizeBytes;
  return 0;
}

}  // namespace

// C entries, bound with ctypes (render/kernels/preprocess.py fills the
// structs). `degree` is the active SH degree, 0-3; P >= 1. Each launches
// on `stream` and returns the first CUDA error (0 = accepted).
extern "C" int gftorf_preprocess_forward(const Params* p, const Outputs* o,
                                         int degree, void* stream) {
  const Fwd kernel = forward_instance(degree);
  if (kernel == nullptr || p->P <= 0) return (int)cudaErrorInvalidValue;
  kernel<<<blocks_of(p->P), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(*p, *o);
  return (int)cudaGetLastError();
}

// With g->partials (blocks_of(P) x 2 floats) and g->d_offsets (2 floats),
// the second pass writes the sums of the phase_offset and dc_offset
// gradients to d_offsets[0] and [1]. launched[0] and launched[1] count the
// launches of the backward kernel and of the second pass.
extern "C" int gftorf_preprocess_backward(const Params* p, const Grads* g,
                                          int degree, void* stream,
                                          int* launched) {
  launched[0] = launched[1] = 0;
  const Bwd kernel = backward_instance(degree);
  if (kernel == nullptr || p->P <= 0) return (int)cudaErrorInvalidValue;
  if ((g->partials == nullptr) != (g->d_offsets == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_of(p->P);
  kernel<<<blocks, THREADS, 0, s>>>(*p, *g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launched[0] = 1;
  if (g->partials == nullptr) return 0;
  offsets_sum_kernel<<<1, THREADS, 0, s>>>(g->partials, blocks, g->d_offsets);
  err = cudaGetLastError();
  if (err == cudaSuccess) launched[1] = 1;
  return (int)err;
}

// The instance's occupancy at its 256 threads a block: info[0] blocks per
// SM, info[1] registers and info[2] local (spill) bytes per thread,
// info[3] static shared bytes per block.
extern "C" int gftorf_preprocess_occupancy(int degree, int backward, int* info) {
  if (backward) {
    const Bwd kernel = backward_instance(degree);
    return kernel ? occupancy(kernel, info) : (int)cudaErrorInvalidValue;
  }
  const Fwd kernel = forward_instance(degree);
  return kernel ? occupancy(kernel, info) : (int)cudaErrorInvalidValue;
}
