// Per-warp culling of instances that cannot touch any of a warp's pixels.
//
// A warp of a compositing block holds 32 pixels of the tile inside a
// rectangle. The backward kernels give warp w the 32 consecutive pixels
// [32 w, 32 w + 32) (16x2 pixels at tile_w 16, 32x1 at 32, 8x4 at 8;
// warp_rect). The forward kernels give it an 8x4 block of pixels wherever
// the tile's sides are multiples of 8 and 4 (block_pixel, block_rect): the
// squarest rectangle 32 pixels fill, so the fewest footprints reach it (at
// the ftorf training shapes its warps walk 47 % fewer (row, warp) pairs
// than with 16x2 rows, PERF.md). The backward keeps the consecutive map
// because its per-row sums add the warps' partials in warp order:
// regrouping pixels would change their bits. An instance is culled for a
// warp only when eval_sample(...).valid (dense_common.cuh) is false at
// every pixel of the rectangle, as the kernels evaluate it in fp32. A
// culled instance would leave every pixel's transmittance, running sums
// and early-exit latch untouched and add zero to every per-instance sum,
// so skipping it changes no bit of any result.
//
// Why the test is exact. With p = -Q/2, Q = a dx^2 + 2 b dx dy + c dy^2
// (the packed conic a, b, c = g[2], g[3], g[4]), a pixel is valid only if
// p <= 0 and fl(o * expf(p~)) >= 1/255, p~ being the fp32 evaluation of p.
//  - Opacity below 1/255 (fp32 compare, as the kernels make it): invalid
//    everywhere, because o * exp(p) <= o. Culled for every rectangle.
//  - Otherwise valid needs p~ >= -lambda' with lambda' = ln(o / (1/255))
//    plus CULL_LEVEL_SLACK (1e-5: the rounding of the product and of expf,
//    2 ulp, is under 4e-7 in p).
//  - eval_sample rounds each of its terms at most six times, so
//    |p~ - p| <= 6 eps A with A = (|a| dx^2 + |c| dy^2)/2 + |b| |dx dy|;
//    CULL_GAMMA (4e-6) is ten times that bound. Valid thus needs
//    Q - 2 gamma A <= 2 lambda', and Q - 2 gamma A is at least the form
//    of M' = [[a(1-gamma), -|b|(1+gamma)], [., c(1-gamma)]] at (|dx|, |dy|).
//  - Where M' is positive definite (det' = ac(1-gamma)^2 - b^2(1+gamma)^2
//    clearly above zero), that form is <= 2 lambda' only inside the box
//    |dx| <= sqrt(2 lambda' c(1-gamma) / det'), |dy| <= sqrt(2 lambda'
//    a(1-gamma) / det'). The box is widened by 1e-3 on its squared extent
//    and by half a pixel, computed in double, and rounded outwards to fp32.
//  - A row with a non-finite mean, conic or opacity, a conic that is not
//    positive definite (a <= 0 or det <= 0), or det' not clearly positive
//    (a conic too elongated for the bound) is never culled.
// render/kernels/dense.py::warp_cull_plain is this predicate in PyTorch,
// formula for formula; tests/test_torch_warp_cull.py holds it against
// brute force, and chip_smoke.py this code against both on the card.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dense_common.cuh"

namespace gftorf {

constexpr double CULL_GAMMA = 4e-6;
constexpr double CULL_LO1 = 1.0 - CULL_GAMMA;
constexpr double CULL_LO2 = (1.0 - CULL_GAMMA) * (1.0 - CULL_GAMMA);
constexpr double CULL_HI2 = (1.0 + CULL_GAMMA) * (1.0 + CULL_GAMMA);
constexpr double CULL_DET_FLOOR = 1e-9;     // det' must exceed this times a*c
constexpr double CULL_LEVEL_SLACK = 1e-5;
constexpr double CULL_REL_MARGIN = 1e-3;    // on the squared extent
constexpr double CULL_PIXEL_MARGIN = 0.5;

// The row's cull box {x_lo, x_hi, y_lo, y_hi} in pixel coordinates: no
// pixel outside it is valid. (-inf, inf, ...) keeps the row for every
// rectangle; (inf, -inf, ...) culls it for every rectangle.
__device__ __forceinline__ float4 cull_box(const float* g) {
  const float mx = g[0], my = g[1], a = g[2], b = g[3], c = g[4], o = g[5];
  const float4 keep = make_float4(-CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F,
                                  CUDART_INF_F);
  if (!(isfinite(mx) && isfinite(my) && isfinite(a) && isfinite(b) &&
        isfinite(c) && isfinite(o)))
    return keep;
  const double da = a, db = b, dc = c;
  const double det = da * dc - db * db;
  if (!(a > 0.f) || !(det > 0.0)) return keep;
  if (o < ALPHA_EPS)
    return make_float4(CUDART_INF_F, -CUDART_INF_F, CUDART_INF_F, -CUDART_INF_F);
  const double det_l = da * dc * CULL_LO2 - db * db * CULL_HI2;
  if (!(det_l > CULL_DET_FLOOR * (da * dc))) return keep;
  const double level = 2.0 * (log((double)o / (double)ALPHA_EPS) + CULL_LEVEL_SLACK) *
                       (1.0 + CULL_REL_MARGIN);
  const double hx = sqrt(level * dc * CULL_LO1 / det_l) + CULL_PIXEL_MARGIN;
  const double hy = sqrt(level * da * CULL_LO1 / det_l) + CULL_PIXEL_MARGIN;
  return make_float4(__double2float_rd((double)mx - hx),
                     __double2float_ru((double)mx + hx),
                     __double2float_rd((double)my - hy),
                     __double2float_ru((double)my + hy));
}

// The pixel rectangle {x0, x1, y0, y1} (inclusive pixel coordinates) of
// this thread's warp in tile t when thread i holds pixel i (pixel i of a
// tile at (i % tile_w, i / tile_w) from its corner).
__device__ __forceinline__ float4 warp_rect(const int* origins, int t,
                                            int tile_w) {
  const int first = threadIdx.x & ~31, last = first + 31;
  const int y0 = first / tile_w, y1 = last / tile_w;
  const int x0 = y0 == y1 ? first % tile_w : 0;
  const int x1 = y0 == y1 ? last % tile_w : tile_w - 1;
  const float ox = (float)origins[2 * t], oy = (float)origins[2 * t + 1];
  return make_float4(ox + (float)x0, ox + (float)x1, oy + (float)y0,
                     oy + (float)y1);
}

// Whether the forward's warps hold 8x4 pixel blocks in tiles of `pix`
// pixels, tile_w wide: both sides are multiples of the block's.
__device__ __forceinline__ bool warp_blocks(int tile_w, int pix) {
  return tile_w % 8 == 0 && pix % tile_w == 0 && (pix / tile_w) % 4 == 0;
}

// This thread's pixel index in the forward's map: lane l of warp w holds
// pixel (8 (w % (tile_w / 8)) + l % 8, 4 (w / (tile_w / 8)) + l / 8) from
// the tile's corner where warp_blocks holds, else pixel threadIdx.x.
__device__ __forceinline__ int block_pixel(int tile_w, int pix) {
  if (!warp_blocks(tile_w, pix)) return threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, across = tile_w / 8;
  return ((warp / across) * 4 + (lane >> 3)) * tile_w + (warp % across) * 8 +
         (lane & 7);
}

// The pixel rectangle of this thread's warp in tile t under block_pixel's
// map.
__device__ __forceinline__ float4 block_rect(const int* origins, int t,
                                             int tile_w, int pix) {
  if (!warp_blocks(tile_w, pix)) return warp_rect(origins, t, tile_w);
  const int warp = threadIdx.x >> 5, across = tile_w / 8;
  const float x0 = (float)origins[2 * t] + (float)((warp % across) * 8);
  const float y0 = (float)origins[2 * t + 1] + (float)((warp / across) * 4);
  return make_float4(x0, x0 + 7.f, y0, y0 + 3.f);
}

__device__ __forceinline__ bool culled(float4 box, float4 rect) {
  return box.y < rect.x || box.x > rect.y || box.w < rect.z || box.z > rect.w;
}

}  // namespace gftorf
