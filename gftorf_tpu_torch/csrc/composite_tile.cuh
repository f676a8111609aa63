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
// on the same rows and give the same bits. The bounds are in the .cu
// files.
//
// The forward body. Its first version had every warp evaluate every row
// of a 256-row batch (eval_sample and its expf on all 32 lanes, then a
// ballot), whether or not the row's footprint could reach the warp's
// pixels; all 512 threads copied each batch into shared memory and met
// at three block barriers a batch; and each warp with a hit did a shared
// atomicAdd on the same word, row after row. A warp issues a row's
// evaluation and blend once for its 32 lanes, so a tile's time was its
// 16 warps' instructions over every row. Now:
//  1. The forward's warps hold 8x4 blocks of pixels (warp_cull.cuh,
//     block_pixel), not 16x2 rows: the squarest rectangle 32 pixels fill,
//     which the fewest footprints reach.
//  2. Before a sub-batch of SUB = 32 rows each lane tests one row against
//     the warp's rectangle (one cull box per row, computed once per batch)
//     and a ballot gives the rows the warp walks. A culled row has no
//     valid pixel in the rectangle: it changes no pixel's T, sums, dd
//     moments, first sample or latch, and counts no pixel of this warp,
//     so skipping it changes no bit. A warp whose pixels have all stopped
//     walks no row.
//  3. Warps run free through a batch. The only thing they share is each
//     row's integer count of contributing pixels: lane j of a warp keeps
//     its popcount for row j of the sub-batch and stores the 32 counts to
//     the warp's own slot in one store (0 for the rows it skipped); the
//     slots are double-buffered by batch parity and added in warp order
//     after the next batch's barrier. That barrier is the only one a batch
//     meets: there the boxes are ready, the batch before is fully walked
//     (its counts are stored and its buffer may be refilled), and the
//     block leaves when every pixel has stopped.
//  4. Batches are staged in two buffers by the bulk copy engine
//     (cp.async.bulk with an mbarrier, issued by one thread after the
//     barrier): batch k+1 lands while batch k is walked, and a block that
//     leaves has no copy in flight.
//  5. Two 512-thread blocks per SM (64 registers a thread): 150 tiles of
//     512 pixels run in one wave on 132 SMs. Tiles of more pixels run an
//     instance compiled for one 1024-thread block.
// Each pixel's sequence of fp32 operations is the first version's
// (eval_sample, next_transmittance and the same blend expressions), so the
// output and the counts keep their bits, and the backward, which
// recomputes the recurrence, latches T_STOP where the forward did.
// Measured and dropped: evaluating the next live row's sample before the
// current row's blend (it hides the expf latency on a deep tile with few
// warps at work, but costs registers and time at the training shapes), a
// shared atomicAdd per row with a hit in place of the count slots, a
// deepest-tile-first block order, and 16-byte loads of the blended
// columns. PERF.md has each choice's time against its alternative
// (chip_ab.py --pair forward).
//
// The backward body. Its first version walked the rows in lockstep: for
// every row, every warp that a row reached reduced 24 columns with 24
// shuffle trees (120 shuffles) and lane 0 stored them; then the whole
// 512-thread block met at a barrier and 24 threads each added 16 warp
// partials one after another before the next row could finish. At about
// 1,500 rows a tile that chain, not arithmetic, set the time (about
// 0.7 us a row); every warp also evaluated every row, whether or not its
// footprint could reach the warp's pixels; ~90 registers let one block
// fit an SM, so 150 tiles ran in two waves on 132 SMs; and each batch was
// loaded by the threads and fenced before its first row. Now:
//  1. Warps run free through a sub-batch of SUB = 32 rows. Per row each
//     warp writes its 24 column sums to its own slot of a partial buffer;
//     one barrier per sub-batch, after which all threads form the SUB x 24
//     (row, column) sums at once, each adding its 16 warp partials in warp
//     order, and store the sub-batch's rows as one contiguous run. The
//     partials are double-buffered by sub-batch parity, so that barrier is
//     the only one. The per-pixel recurrence stays per thread and
//     sequential: the sum over pixels never feeds back into it.
//  2. A warp reduces a row with one butterfly reduce-scatter over 32 slots
//     (31 shuffles and adds; lane c ends with column c), not 24 trees. It
//     adds the same pairs of lanes in the same tree as those trees did.
//  3. Before a sub-batch each lane tests one row against the warp's pixel
//     rectangle (warp_cull.cuh, one box per row computed once per batch)
//     and a ballot gives the rows the warp walks. A culled row has no
//     valid pixel in the rectangle: it would change no pixel's T, running
//     sums or latch and add zeros to the sums, so skipping it changes no
//     bit. A warp whose pixels have all stopped walks no row.
//  4. Batches are staged in two buffers by the bulk copy engine
//     (cp.async.bulk with an mbarrier, issued by one thread): batch k+1
//     lands while batch k is walked.
//  5. One block an SM, not two. Two (at most 64 registers, with spills)
//     were no faster at the ftorf training shapes, where a tile's time is
//     its warps' chains of dependent instructions, and slower on a deep
//     tile; one leaves the registers for 6.
//  6. A warp walks its live rows two at a time, each pixel's step written
//     without branches (selects, no divergent paths), so the two rows'
//     arithmetic and their two butterflies interleave; and a row divides
//     once (1/q), not four times. A contributing pixel's step is the
//     first version's, operation for operation, but for the reciprocal.
// The order of every add is fixed by the thread and the data alone, with
// no float atomics: the same inputs give the same bits, in both layouts.
// PERF.md has each choice's time against its alternative (chip_ab.py
// --pair backward).

#pragma once

#include <cuda_runtime.h>

#include "dense_common.cuh"
#include "warp_cull.cuh"

namespace gftorf {

constexpr int BATCH = 256;        // rows staged per batch: 24 KB of shared memory
constexpr int BWD_MAX_PIX = 512;  // the backward runs one thread per pixel
constexpr int BWD_MAX_WARPS = BWD_MAX_PIX / 32;

// Pixel i of tile t (origins: (T, 2) int32 x, y of its corner), at
// (i % tile_w, i / tile_w) from the corner.
struct Pixel {
  float x, y;
  bool inside;
};

__device__ __forceinline__ Pixel pixel_of(const int* origins, int t, int i,
                                          int tile_w, int width, int height) {
  Pixel p;
  p.x = (float)origins[2 * t] + (float)(i % tile_w);
  p.y = (float)origins[2 * t + 1] + (float)(i / tile_w);
  p.inside = (p.x < (float)width) && (p.y < (float)height);
  return p;
}

// ------------------------------------------------- staging, both directions

constexpr int SUB = 32;  // rows a warp tests with one ballot (a sub-batch)

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// Rows [0, n) from global `src` into shared `dst` by the bulk copy engine;
// `bar` completes its phase when the bytes have landed. One thread calls
// it. Both addresses are 16-byte aligned and n * 96 bytes is a multiple
// of 16 (the wrappers hand 16-byte aligned blocks; rows are 96 bytes).
__device__ __forceinline__ void bulk_load(float* dst, const float* src, int n,
                                          unsigned long long* bar) {
  const unsigned bytes = (unsigned)n * FEAT * sizeof(float);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  unsigned ok = 0;
  while (!ok) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------- forward

// Blocks per SM the forward's instance for tiles of up to 512 pixels is
// compiled for (__launch_bounds__): two, at most 64 registers a thread,
// keep 150 tiles of 512 pixels in one wave on 132 SMs. Tiles of 513-1024
// pixels run an instance compiled for one 1024-thread block.
constexpr int FWD_MIN_BLOCKS = 2;

// The forward's dynamic shared memory, for blocks of up to 32 * MAX_WARPS
// threads (90,128 B at 16 warps, 122,896 B at 32).
template <int MAX_WARPS>
struct FwdShared {
  float feat[2][BATCH * FEAT];    // staged batches of rows, filled by bulk copies
  float4 box[2][BATCH];           // each staged batch's cull boxes (warp_cull.cuh)
  int hits[2][MAX_WARPS][BATCH];  // each warp's contributing pixels per row of a batch
  unsigned long long full[2];     // mbarrier of each staging buffer
};

// One pixel's side of the forward: transmittance, the accumulators, the
// dd moments (exclusive running sums) and the first contributing sample.
template <bool NEED_DD, bool NEED_DIST>
struct PixelBlend {
  float px, py;
  bool done;
  float T;
  float color[3], phasor[7], flow[6];
  float depth, acc, dd, wz_run, wz2_run;
  float first_alpha, first_dist, first_amp;
  bool has_first;

  __device__ __forceinline__ explicit PixelBlend(Pixel p) {
    px = p.x;
    py = p.y;
    done = !p.inside;
    T = 1.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) color[k] = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) phasor[k] = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) flow[k] = 0.f;
    depth = acc = dd = wz_run = wz2_run = 0.f;
    first_alpha = first_dist = first_amp = 0.f;
    has_first = false;
  }

  // The sample of row g at this pixel, its six geometry columns read as
  // one 16-byte and one 8-byte load (g is 16-byte aligned).
  __device__ __forceinline__ Sample sample(const float* g) const {
    const float4 a = *reinterpret_cast<const float4*>(g);
    const float2 c = *reinterpret_cast<const float2*>(g + 4);
    const float h[6] = {a.x, a.y, a.z, a.w, c.x, c.y};
    return eval_sample(h, px, py);
  }

  // The blend of row g (sample s) at this pixel, the first version's step
  // operation for operation; returns whether the pixel contributes.
  __device__ __forceinline__ bool blend(const Sample& s, const float* g) {
    if (done || !s.valid) return false;
    const float alpha = s.alpha;
    const float t_next = next_transmittance(T, alpha);
    if (t_next < T_STOP) {
      done = true;
      return false;
    }
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
    return true;
  }

  // This pixel's (OUTC,) output row, bg row b added times the frozen T.
  __device__ __forceinline__ void write(const float* __restrict__ b,
                                        float* __restrict__ out_px) const {
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
};

// Rows [0, n) of a walked batch: each row's contributing pixels, the sum
// of the warps' counts, to dst[0, n).
template <int MAX_WARPS>
__device__ __forceinline__ void store_counts(const int (&hits)[MAX_WARPS][BATCH],
                                             int n, float* __restrict__ dst) {
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int sum = 0;
    for (int w = 0; w < nwarps; ++w) sum += hits[w][i];
    dst[i] = (float)sum;
  }
}

// Forward. Blends rows [0, count) of tile_feat (16-byte aligned) front to
// back at this thread's pixel, writes its (OUTC,) output row from its bg
// row `b`, and the per-row contributing-pixel counts to
// tile_contrib[0, extent) (zero past the last row reached). `rect` is the
// pixel rectangle of this thread's warp (warp_cull.cuh). The block runs
// blockDim.x = 32 * k <= 32 * MAX_WARPS threads with
// sizeof(FwdShared<MAX_WARPS>) bytes of dynamic shared memory.
template <bool NEED_DD, bool NEED_DIST, int MAX_WARPS>
__device__ __forceinline__ void composite_tile_forward(
    const float* __restrict__ tile_feat, int count, int extent, Pixel p,
    float4 rect, const float* __restrict__ b, float* __restrict__ out_px,
    float* __restrict__ tile_contrib, FwdShared<MAX_WARPS>& sm) {
  const int pid = threadIdx.x;
  const int pix = blockDim.x;
  const int lane = pid & 31;
  const int warp = pid >> 5;

  if (pid == 0) {
    mbar_init(&sm.full[0]);
    mbar_init(&sm.full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (count > 0) bulk_load(sm.feat[0], tile_feat, min(BATCH, count), &sm.full[0]);
  }
  PixelBlend<NEED_DD, NEED_DIST> px(p);
  __syncthreads();  // the barriers are initialised

  int base = 0, k = 0;
  for (; base < count; base += BATCH, ++k) {
    const int n = min(BATCH, count - base);
    const float* rows = sm.feat[k & 1];
    mbar_wait(&sm.full[k & 1], (k >> 1) & 1);
    float4* box = sm.box[k & 1];
    for (int i = pid; i < n; i += pix) box[i] = cull_box(rows + i * FEAT);
    // The only block barrier of a batch. Boxes written; every warp has
    // walked the batch before, so its counts can be stored and its
    // staging buffer refilled.
    const bool stop = __syncthreads_count(!px.done) == 0;
    if (k > 0) store_counts(sm.hits[(k - 1) & 1], BATCH, tile_contrib + base - BATCH);
    if (stop) break;
    if (pid == 0 && base + BATCH < count)
      bulk_load(sm.feat[(k + 1) & 1], tile_feat + (size_t)(base + BATCH) * FEAT,
                min(BATCH, count - base - BATCH), &sm.full[(k + 1) & 1]);

    // Warps run free through the batch: nothing a warp does here waits
    // for another warp.
    int* hits = sm.hits[k & 1][warp];
    for (int s0 = 0; s0 < n; s0 += SUB) {
      const int m = min(SUB, n - s0);
      // The rows of this sub-batch that can touch the warp's pixels.
      unsigned live = __ballot_sync(FULL, lane < m && !culled(box[s0 + lane], rect));
      if (__all_sync(FULL, px.done)) live = 0u;
      unsigned cnt = 0;  // lane j: the warp's contributing pixels of row s0 + j
      for (; live != 0u; live &= live - 1u) {
        const int j = __ffs(live) - 1;
        const float* g = rows + (s0 + j) * FEAT;
        const bool hit = px.blend(px.sample(g), g);
        const unsigned ballot = __ballot_sync(FULL, hit);
        if (lane == j) cnt = __popc(ballot);
      }
      if (lane < m) hits[s0 + lane] = (int)cnt;  // 0 for the rows it skips
    }
  }
  if (base >= count && k > 0) {  // every row walked: the last batch's counts
    __syncthreads();
    const int last = base - BATCH;
    store_counts(sm.hits[(k - 1) & 1], count - last, tile_contrib + last);
  }
  // Rows never reached (every pixel stopped, or past the count) touched
  // no pixel.
  for (int i = min(base, count) + pid; i < extent; i += pix) tile_contrib[i] = 0.f;
  px.write(b, out_px);
}

// ---------------------------------------------------------------- backward

constexpr int BWD_PART = BWD_MAX_WARPS * SUB * FEAT;  // floats of one partial buffer

// Blocks of 512 threads per SM the backward is compiled for
// (__launch_bounds__). One leaves up to 128 registers a thread, which it
// uses without spills. Two (64 registers with spills, and SUB = 16 to fit
// the shared memory) were slower (PERF.md, chip_ab.py).
constexpr int BWD_MIN_BLOCKS = 1;

// The backward's dynamic shared memory (151,568 B).
struct BwdShared {
  float feat[2][BATCH * FEAT];  // staged batches of rows, filled by bulk copies
  float part[2][BWD_PART];      // per-warp column sums of two sub-batches
  float4 box[BATCH];            // the staged batch's cull boxes (warp_cull.cuh)
  unsigned long long full[2];   // mbarrier of each staging buffer
};

// One step of the butterfly below: lanes whose bit N is set keep the upper
// N slots of x and hand the lower N to their partner, the others the
// reverse; each adds its partner's copy to its own.
template <int N>
__device__ __forceinline__ void butterfly_step(const float* x, float* y,
                                               int lane) {
  const bool upper = lane & N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? x[i] : x[i + N];
    const float keep = upper ? x[i + N] : x[i];
    y[i] = keep + __shfl_xor_sync(FULL, send, N);
  }
}

// Column `lane` of the sum of v over the warp (slots FEAT..31 are zero):
// a reduce-scatter of 16 + 8 + 4 + 2 + 1 shuffles and adds, in an order
// fixed by the lane alone.
__device__ __forceinline__ float warp_column_sum(const float (&v)[32],
                                                 int lane) {
  float a[16], b[8], c[4], d[2], e[1];
  butterfly_step<16>(v, a, lane);
  butterfly_step<8>(a, b, lane);
  butterfly_step<4>(b, c, lane);
  butterfly_step<2>(c, d, lane);
  butterfly_step<1>(d, e, lane);
  return e[0];
}

// warp_column_sum of v and of w, the two reductions interleaved.
__device__ __forceinline__ void warp_column_sum2(const float (&v)[32],
                                                 const float (&w)[32], int lane,
                                                 float& x, float& y) {
  float a[16], b[8], c[4], d[2], e[1];
  float a2[16], b2[8], c2[4], d2[2], e2[1];
  butterfly_step<16>(v, a, lane);
  butterfly_step<16>(w, a2, lane);
  butterfly_step<8>(a, b, lane);
  butterfly_step<8>(a2, b2, lane);
  butterfly_step<4>(b, c, lane);
  butterfly_step<4>(b2, c2, lane);
  butterfly_step<2>(c, d, lane);
  butterfly_step<2>(c2, d2, lane);
  butterfly_step<1>(d, e, lane);
  butterfly_step<1>(d2, e2, lane);
  x = e[0];
  y = e2[0];
}

// One pixel's side of the backward: its totals from the forward residuals
// and the cotangent (pallas_composite.py:462-486), and the recurrence it
// walks front to back (transmittance, inclusive running sums, latch).
template <bool NEED_DD, bool HAS_FLOW>
struct PixelGrad {
  float gc[4], gp[7], gf[6];
  float g_acc, g_dd, t_final, a_tot, wz_tot, wz2_tot, e_tot, ep_tot,
      u_dd_tot, bg_dot;
  float px, py;
  bool done;
  float T, u_f, u_p, u_dd;

  __device__ __forceinline__ PixelGrad(Pixel p, const float* __restrict__ b,
                                       const float* __restrict__ o,
                                       const float* __restrict__ gr) {
#pragma unroll
    for (int k = 0; k < 4; ++k) gc[k] = gr[k];  // color 0:3, depth 3
#pragma unroll
    for (int k = 0; k < 7; ++k) gp[k] = gr[4 + k];
#pragma unroll
    for (int k = 0; k < 6; ++k) gf[k] = HAS_FLOW ? gr[20 + k] : 0.f;
    g_acc = gr[11];
    g_dd = NEED_DD ? gr[12] : 0.f;
    t_final = o[13];
    a_tot = o[17];
    wz_tot = NEED_DD ? o[18] : 0.f;
    wz2_tot = NEED_DD ? o[19] : 0.f;
    e_tot = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) e_tot += gc[k] * (o[k] - t_final * b[k]);
    e_tot += gc[3] * o[3];
    e_tot += g_acc * a_tot;
    ep_tot = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) ep_tot += gp[k] * (o[4 + k] - t_final * b[4 + k]);
    u_dd_tot = g_dd * 2.0f * (a_tot * wz2_tot - wz_tot * wz_tot);
    bg_dot = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) bg_dot += b[k] * gc[k];
    float bg_dot_p = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) bg_dot_p += b[4 + k] * gp[k];
    bg_dot += bg_dot_p;
    px = p.x;
    py = p.y;
    done = !p.inside;
    T = 1.0f;
    u_f = u_p = u_dd = 0.f;
  }

  // This pixel's step over row f (sample s), without branches, so that
  // two rows' steps can interleave: advances the recurrence where the row
  // contributes, latches the early exit where the forward latched it, and
  // writes the pixel's share of the row's gradient to d (zeros where it
  // does not contribute, and past FEAT). For a contributing pixel that is
  // pallas_composite.py:512-527, each suffix sum times 1/q.
  __device__ __forceinline__ bool step(const Sample& s, const float* f,
                                       float (&d)[32]) {
    const bool valid = !done && s.valid;
    const float t_next = next_transmittance(T, s.alpha);
    const bool hit = valid && !(t_next < T_STOP);
    done = done || (valid && t_next < T_STOP);
    const float w = s.alpha * T;
    const float wp = w * T;
    const float q = 1.0f - s.alpha;
    const float iq = 1.0f / q;  // one division, not four
    float e = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) e += gc[k] * f[7 + k];
    e += g_acc;
    float e_p = 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) e_p += gp[k] * f[11 + k];
    const float uf = u_f + w * e;
    const float up = u_p + wp * e_p;
    float d_alpha = T * e - (e_tot - uf) * iq + T * T * e_p -
                    2.0f * (ep_tot - up) * iq - t_final * iq * bg_dot;
    float udd = u_dd;
    d[6] = 0.f;
    if (NEED_DD) {
      const float z = f[6];
      const float sym = z * z * a_tot - 2.0f * z * wz_tot + wz2_tot;
      udd = u_dd + g_dd * w * sym;
      d_alpha += g_dd * T * sym - (u_dd_tot - udd) * iq;
      d[6] = hit ? g_dd * 2.0f * w * (z * a_tot - wz_tot) : 0.f;
    }
    const bool geo = hit && s.raw < ALPHA_MAX;
    const float d_power = d_alpha * s.alpha;
    d[0] = geo ? d_power * -(f[2] * s.dx + f[3] * s.dy) : 0.f;
    d[1] = geo ? d_power * -(f[4] * s.dy + f[3] * s.dx) : 0.f;
    d[2] = geo ? -0.5f * s.dx * s.dx * d_power : 0.f;
    d[3] = geo ? -s.dx * s.dy * d_power : 0.f;
    d[4] = geo ? -0.5f * s.dy * s.dy * d_power : 0.f;
    d[5] = geo ? d_alpha * s.exp_p : 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) d[7 + k] = hit ? gc[k] * w : 0.f;
#pragma unroll
    for (int k = 0; k < 7; ++k) d[11 + k] = hit ? gp[k] * wp : 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) d[18 + k] = HAS_FLOW && hit ? gf[k] * w : 0.f;
#pragma unroll
    for (int c = FEAT; c < 32; ++c) d[c] = 0.f;
    if (hit) {
      T = t_next;
      u_f = uf;
      u_p = up;
      u_dd = udd;
    }
    return hit;
  }

  // Steps over row f; returns column `lane` of the warp's sum of its 32
  // pixels' shares of the row's gradient (0 past FEAT). The whole warp
  // calls it.
  __device__ __forceinline__ float row(const float* f, int lane) {
    const Sample s = eval_sample(f, px, py);
    if (!__any_sync(FULL, !done && s.valid)) return 0.f;  // changes nothing
    float d[32];
    const bool hit = step(s, f, d);
    if (!__any_sync(FULL, hit)) return 0.f;
    return warp_column_sum(d, lane);
  }

  // row() over f0 and then f1, the two rows' work interleaved.
  __device__ __forceinline__ void rows2(const float* f0, const float* f1,
                                        int lane, float& c0, float& c1) {
    const Sample s0 = eval_sample(f0, px, py);
    const Sample s1 = eval_sample(f1, px, py);
    c0 = c1 = 0.f;
    if (!__any_sync(FULL, !done && (s0.valid || s1.valid))) return;
    float d0[32], d1[32];
    const bool h0 = step(s0, f0, d0);
    const bool h1 = step(s1, f1, d1);
    const bool any0 = __any_sync(FULL, h0), any1 = __any_sync(FULL, h1);
    if (any0 && any1) {
      warp_column_sum2(d0, d1, lane, c0, c1);
    } else if (any0) {
      c0 = warp_column_sum(d0, lane);
    } else if (any1) {
      c1 = warp_column_sum(d1, lane);
    }
  }
};

// Backward. The gradient of the tile's output rows with respect to rows
// [0, count) of tile_feat (16-byte aligned), given this pixel's bg row
// `b`, forward output row `o` and cotangent row `gr`, and the pixel
// rectangle of this thread's warp (warp_cull.cuh); writes
// tile_dfeat[0, extent) (zero rows past the last row reached). The block
// runs blockDim.x = 32 * k <= BWD_MAX_PIX threads with sizeof(BwdShared)
// bytes of dynamic shared memory.
template <bool NEED_DD, bool HAS_FLOW>
__device__ __forceinline__ void composite_tile_backward(
    const float* __restrict__ tile_feat, int count, int extent, Pixel p,
    float4 rect, const float* __restrict__ b, const float* __restrict__ o,
    const float* __restrict__ gr, float* __restrict__ tile_dfeat,
    BwdShared& sm) {
  const int pid = threadIdx.x;
  const int pix = blockDim.x;
  const int lane = pid & 31;
  const int warp = pid >> 5;
  const int nwarps = pix >> 5;

  if (pid == 0) {
    mbar_init(&sm.full[0]);
    mbar_init(&sm.full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    if (count > 0) bulk_load(sm.feat[0], tile_feat, min(BATCH, count), &sm.full[0]);
  }
  PixelGrad<NEED_DD, HAS_FLOW> px(p, b, o, gr);
  __syncthreads();  // the barriers are initialised

  int reached = 0;  // rows [0, reached) have their gradient written
  int sub = 0;      // sub-batches walked: their parity picks the partial buffer
  for (int base = 0, k = 0; base < count; base += BATCH, ++k) {
    const int n = min(BATCH, count - base);
    const float* rows = sm.feat[k & 1];
    mbar_wait(&sm.full[k & 1], (k >> 1) & 1);
    for (int i = pid; i < n; i += pix) sm.box[i] = cull_box(rows + i * FEAT);
    // Boxes written; every read of the other buffer (the batch before)
    // is done, so the next batch may land there.
    if (__syncthreads_count(!px.done) == 0) break;
    const bool next = base + BATCH < count;
    if (pid == 0 && next)
      bulk_load(sm.feat[(k + 1) & 1], tile_feat + (size_t)(base + BATCH) * FEAT,
                min(BATCH, count - base - BATCH), &sm.full[(k + 1) & 1]);

    bool stop = false;
    for (int s0 = 0; s0 < n && !stop; s0 += SUB, ++sub) {
      const int m = min(SUB, n - s0);
      // The rows of this sub-batch that can touch the warp's pixels.
      unsigned live = __ballot_sync(FULL, lane < m && !culled(sm.box[s0 + lane], rect));
      if (__all_sync(FULL, px.done)) live = 0u;
      float* part = sm.part[sub & 1] + warp * (SUB * FEAT);
      for (unsigned rest = live; rest != 0u;) {
        const int j0 = __ffs(rest) - 1;
        rest &= rest - 1u;
        if (rest != 0u) {  // a second live row: walk the two together
          const int j1 = __ffs(rest) - 1;
          rest &= rest - 1u;
          float c0, c1;
          px.rows2(rows + (s0 + j0) * FEAT, rows + (s0 + j1) * FEAT, lane, c0, c1);
          if (lane < FEAT) {
            part[j0 * FEAT + lane] = c0;
            part[j1 * FEAT + lane] = c1;
          }
        } else {
          const float c0 = px.row(rows + (s0 + j0) * FEAT, lane);
          if (lane < FEAT) part[j0 * FEAT + lane] = c0;
        }
      }
      // The rows the warp skips add zeros.
      for (unsigned z = ~live & (m == 32 ? FULL : (1u << m) - 1u); z != 0u; z &= z - 1u)
        if (lane < FEAT) part[(__ffs(z) - 1) * FEAT + lane] = 0.f;
      // Every warp's partials are in (the other buffer is free again).
      stop = __syncthreads_count(!px.done) == 0;
      // The sub-batch's m rows of dfeat, one contiguous run: each thread
      // adds the warps' partials of its (row, column) in warp order.
      const float* parts = sm.part[sub & 1];
      float* dst = tile_dfeat + (size_t)(base + s0) * FEAT;
      for (int i = pid; i < m * FEAT; i += pix) {
        float sum = 0.f;
        for (int w = 0; w < nwarps; ++w) sum += parts[w * (SUB * FEAT) + i];
        dst[i] = sum;
      }
      reached = base + s0 + m;
    }
    if (stop) {
      // The block leaves early: the next batch's copy must land before its
      // shared memory is given up.
      if (next) mbar_wait(&sm.full[(k + 1) & 1], ((k + 1) >> 1) & 1);
      break;
    }
  }
  // Rows never reached (every pixel stopped, or past the count) get zeros.
  for (int i = reached * FEAT + pid; i < extent * FEAT; i += pix) tile_dfeat[i] = 0.f;
}

// Host side: the attributes every launch of a kernel with `bytes` of
// dynamic shared memory needs (past 48 KB only by this attribute, and the
// SM's shared memory preferred over its L1), and the occupancy report
// chip_smoke.py logs: blocks per SM, registers and local (spill) bytes per
// thread, shared bytes per block.
template <typename Kernel>
inline cudaError_t kernel_prepare(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename Kernel>
inline int kernel_occupancy(Kernel kernel, int pix, int bytes, int* info) {
  cudaError_t err = kernel_prepare(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, pix, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = bytes;
  return 0;
}

}  // namespace gftorf
