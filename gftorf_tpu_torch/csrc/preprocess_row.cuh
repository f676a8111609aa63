// Per-Gaussian preprocess, one row at a time: the forward and its adjoint.
//
// preprocess.cu runs these device functions with one thread per Gaussian.
//
// The forward follows render/preprocess.py::preprocess_plain operation by
// operation and in its order (built with --fmad=false, so every multiply
// and add rounds where the plain version's elementwise ops round). Python
// constants are rounded to float32 from their double value, as PyTorch
// rounds a Python scalar that multiplies a float32 tensor. Where the plain
// version hands a product to a library, the sums follow what the library
// does: the point transforms (``p @ m[:3]``, a GEMM on the CPU and on the
// card) are a multiply-add chain in index order, fma(p2, m2, fma(p1, m1,
// p0 * m0)), as the BLAS kernels accumulate, so mean2d and the view depth
// that decide the cull and the tile rect carry the CPU plain version's
// bits; the small batched 3x3 products, the SH sums and the norms run
// unfused in index order.
//
// The adjoint recomputes the forward's intermediates from the inputs (as
// the reference's backward.cu does) and is autograd's chain through the
// plain version's ops, with its forms kept:
//  - torch.clamp passes the gradient where the input equals a bound (the
//    1.3*tan(fov) clip, the colour and amplitude clamps at 0);
//  - torch.where's sanitised values (culled rows, det == 0) pass none;
//  - the phase DC removal is detached; the quaternion is unnormalized;
//  - the radius, the tile rect, tiles_touched and valid carry none.

#pragma once

#include <cuda_runtime.h>

#define GF_DEV __device__ __forceinline__

namespace gftorf {
namespace pre {

// Python's double constants as float32 (ops/sh.py, ops/covariance.py,
// ops/tof.py, render/preprocess.py).
constexpr float SH_C0 = (float)0.28209479177387814;
constexpr float SH_C1 = (float)0.4886025119029199;
constexpr float NEG_SH_C1 = (float)-0.4886025119029199;
constexpr float SH_C2_0 = (float)1.0925484305920792;
constexpr float SH_C2_1 = (float)-1.0925484305920792;
constexpr float SH_C2_2 = (float)0.31539156525252005;
constexpr float SH_C2_3 = (float)-1.0925484305920792;
constexpr float SH_C2_4 = (float)0.5462742152960396;
constexpr float SH_C3_0 = (float)-0.5900435899266435;
constexpr float SH_C3_1 = (float)2.890611442640554;
constexpr float SH_C3_2 = (float)-0.4570457994644658;
constexpr float SH_C3_3 = (float)0.3731763325901154;
constexpr float SH_C3_4 = (float)-0.4570457994644658;
constexpr float SH_C3_5 = (float)1.445305721320277;
constexpr float SH_C3_6 = (float)-0.5900435899266435;
constexpr float VIEW_CLIP = (float)1.3;
constexpr float W_EPS = (float)1e-7;
constexpr float COV2D_LOWPASS = (float)0.3;
constexpr float RADIUS_FLOOR = (float)0.1;
constexpr float DIR_EPS = (float)1e-20;
constexpr float FOUR_PI = (float)(4.0 * 3.141592653589793);

// The C entries' arguments; the Python wrapper (render/kernels/
// preprocess.py) fills the same layout with ctypes. A null input selects
// the branch: shs null -> rgb zeros (colors_precomp stays in Python);
// shs_p null -> phasors_pre, or zeros when that is null too; cov3d_pre
// non-null -> scales and rotations are not read.
struct Params {
  const float* means3d;      // (P, 3)
  const float* scales;       // (P, 3)
  const float* rotations;    // (P, 4)
  const float* opacities;    // (P,)
  const float* shs;          // (P, sh_m, 3)
  const float* shs_p;        // (P, shp_m, shp_c), shp_c >= 2
  const float* means2d_ndc;  // (P, 2)
  const float* phasors_pre;  // (P, pp_c), pp_c >= 2
  const float* cov3d_pre;    // (P, 6)
  const float* view;         // (4, 4) transposed world-to-view
  const float* proj;         // (4, 4) transposed full projection
  const float* campos;       // (3,)
  const float* tan_fovx;     // the camera's scalars, on the device
  const float* tan_fovy;
  const float* focal_x;
  const float* focal_y;
  const float* znear;
  const float* zfar;
  const float* depth_range;
  const float* phase_offset;  // device scalar, or null: phase_offset_value
  const float* dc_offset;     // device scalar, or null: dc_offset_value
  float phase_offset_value;
  float dc_offset_value;
  float scale_modifier;
  int P, sh_m, shp_m, shp_c, pp_c;
  int width, height, tile_w, tile_h, grid_w, grid_h;
  int use_vdp;  // use_view_dependent_phase
};

// Forward outputs, (P, ...) contiguous.
struct Outputs {
  float* mean2d;     // (P, 2)
  float* depth;      // (P,)
  float* conic;      // (P, 3)
  float* rgb;        // (P, 3)
  float* phasor;     // (P, 7)
  float* dist;       // (P,)
  float* dist_ndc;   // (P,)
  float* radius;     // (P,)
  int* rect;         // (P, 4)
  int* tiles;        // (P,)
  unsigned char* valid;  // (P,) bool
};

// Backward: the outputs' cotangents (null = zero; row stride in elements,
// columns contiguous) and the inputs' gradients (null = not wanted).
struct Grads {
  const float* mean2d;
  const float* depth;
  const float* conic;
  const float* rgb;
  const float* phasor;
  const float* dist;
  const float* dist_ndc;
  long long s_mean2d, s_depth, s_conic, s_rgb, s_phasor, s_dist, s_dist_ndc;
  float* d_means3d;      // (P, 3)
  float* d_scales;       // (P, 3)
  float* d_rotations;    // (P, 4)
  float* d_shs;          // (P, sh_m, 3)
  float* d_shs_p;        // (P, shp_m, shp_c)
  float* d_means2d_ndc;  // (P, 2)
  float* d_phasors_pre;  // (P, pp_c)
  float* d_cov3d_pre;    // (P, 6)
  float* partials;       // (blocks, 2): phase_offset, dc_offset sums, or null
  float* d_offsets;      // (2,) the second pass's sums, or null
};

// The camera's values, read once per thread.
struct Camera {
  float V[16], Pm[16], c[3];
  float tanx, tany, fx, fy, znear, zfar, depth_range, po, dc;
};

GF_DEV Camera load_camera(const Params& p) {
  Camera c;
  for (int k = 0; k < 16; ++k) {
    c.V[k] = __ldg(p.view + k);
    c.Pm[k] = __ldg(p.proj + k);
  }
  for (int k = 0; k < 3; ++k) c.c[k] = __ldg(p.campos + k);
  c.tanx = __ldg(p.tan_fovx);
  c.tany = __ldg(p.tan_fovy);
  c.fx = __ldg(p.focal_x);
  c.fy = __ldg(p.focal_y);
  c.znear = __ldg(p.znear);
  c.zfar = __ldg(p.zfar);
  c.depth_range = __ldg(p.depth_range);
  c.po = p.phase_offset ? __ldg(p.phase_offset) : p.phase_offset_value;
  c.dc = p.dc_offset ? __ldg(p.dc_offset) : p.dc_offset_value;
  return c;
}

// torch.clamp's forward, NaN passing through.
GF_DEV float clamp_min(float x, float lo) { return x < lo ? lo : x; }
GF_DEV float clamp2(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ---------------------------------------------------------------- forward

// Projection and frustum cull (preprocess_plain's first block).
struct Proj {
  float pv[3];  // view-space point, (1, 1, 1) where culled
  float depth;  // view-space z before the sanitising
  bool inside;  // in the frustum
  float ph[4];  // homogeneous projection
  float pw;     // 1 / (w + 1e-7), 1 where culled
};

// One column of ``p @ m[:3]`` (m row-major 4x4, column ``col``) summed as
// a GEMM sums it: a multiply-add chain over k in index order.
GF_DEV float gemm_dot3(const float m[3], const float* col) {
  return __fmaf_rn(m[2], col[8], __fmaf_rn(m[1], col[4], __fmul_rn(m[0], col[0])));
}

GF_DEV Proj project(const float m[3], const Camera& c) {
  Proj o;
  float raw[3];
  for (int j = 0; j < 3; ++j) raw[j] = gemm_dot3(m, c.V + j) + c.V[12 + j];
  o.depth = raw[2];
  o.inside = raw[2] >= c.znear && raw[2] <= c.zfar;
  for (int j = 0; j < 3; ++j) o.pv[j] = o.inside ? raw[j] : 1.0f;
  for (int j = 0; j < 4; ++j) o.ph[j] = gemm_dot3(m, c.Pm + j) + c.Pm[12 + j];
  const float denom = o.ph[3] + W_EPS;
  o.pw = 1.0f / (o.inside ? denom : 1.0f);
  return o;
}

GF_DEV float ndc2pix(float v, int size) {
  return ((v + 1.0f) * (float)size - 1.0f) * 0.5f;
}

// R (row-major) of the unnormalized quaternion (r, x, y, z).
GF_DEV void rotation(const float q[4], float R[9]) {
  const float r = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.0f - 2.0f * (y * y + z * z);
  R[1] = 2.0f * (x * y - r * z);
  R[2] = 2.0f * (x * z + r * y);
  R[3] = 2.0f * (x * y + r * z);
  R[4] = 1.0f - 2.0f * (x * x + z * z);
  R[5] = 2.0f * (y * z - r * x);
  R[6] = 2.0f * (x * z - r * y);
  R[7] = 2.0f * (y * z + r * x);
  R[8] = 1.0f - 2.0f * (x * x + y * y);
}

// Sigma = M M^T with M = R diag(s), packed [xx, xy, xz, yy, yz, zz].
GF_DEV void cov3d_of(const float R[9], const float s[3], float M[9],
                    float cov[6]) {
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) M[3 * a + b] = R[3 * a + b] * s[b];
  const int ia[6] = {0, 0, 0, 1, 1, 2}, ic[6] = {0, 1, 2, 1, 2, 2};
  for (int k = 0; k < 6; ++k) {
    const float* u = M + 3 * ia[k];
    const float* v = M + 3 * ic[k];
    cov[k] = (u[0] * v[0] + u[1] * v[1]) + u[2] * v[2];
  }
}

// The EWA projection (ops/covariance.py::ewa_project_cov2d) with what its
// adjoint needs.
struct Ewa {
  float limx, limy, rx, ry, cx, cy, tx, ty, tz, tz2;
  float u0[3], u1[3], su0[3], su1[3];
  float xx, xy, yy;  // cov2d
};

GF_DEV void sym3(const float c[6], float S[9]) {
  S[0] = c[0]; S[1] = c[1]; S[2] = c[2];
  S[3] = c[1]; S[4] = c[3]; S[5] = c[4];
  S[6] = c[2]; S[7] = c[4]; S[8] = c[5];
}

GF_DEV Ewa ewa(const float pv[3], const float cov[6], const Camera& c) {
  Ewa e;
  e.tz = pv[2];
  e.limx = VIEW_CLIP * c.tanx;
  e.limy = VIEW_CLIP * c.tany;
  e.rx = pv[0] / e.tz;
  e.ry = pv[1] / e.tz;
  e.cx = clamp2(e.rx, -e.limx, e.limx);
  e.cy = clamp2(e.ry, -e.limy, e.limy);
  e.tx = e.cx * e.tz;
  e.ty = e.cy * e.tz;
  e.tz2 = e.tz * e.tz;
  const float j00 = c.fx / e.tz;
  const float j02 = -(c.fx * e.tx) / e.tz2;
  const float j11 = c.fy / e.tz;
  const float j12 = -(c.fy * e.ty) / e.tz2;
  for (int k = 0; k < 3; ++k) {
    e.u0[k] = j00 * c.V[4 * k] + j02 * c.V[4 * k + 2];
    e.u1[k] = j11 * c.V[4 * k + 1] + j12 * c.V[4 * k + 2];
  }
  float S[9];
  sym3(cov, S);
  for (int a = 0; a < 3; ++a) {
    e.su0[a] = (S[3 * a] * e.u0[0] + S[3 * a + 1] * e.u0[1]) + S[3 * a + 2] * e.u0[2];
    e.su1[a] = (S[3 * a] * e.u1[0] + S[3 * a + 1] * e.u1[1]) + S[3 * a + 2] * e.u1[2];
  }
  e.xx = ((e.u0[0] * e.su0[0] + e.u0[1] * e.su0[1]) + e.u0[2] * e.su0[2]) + COV2D_LOWPASS;
  e.xy = (e.u0[0] * e.su1[0] + e.u0[1] * e.su1[1]) + e.u0[2] * e.su1[2];
  e.yy = ((e.u1[0] * e.su1[0] + e.u1[1] * e.su1[1]) + e.u1[2] * e.su1[2]) + COV2D_LOWPASS;
  return e;
}

// Real SH basis at a unit direction (ops/sh.py::sh_basis), degree DEG.
template <int DEG>
GF_DEV void sh_basis(float x, float y, float z, float b[16]) {
  b[0] = SH_C0;
  if (DEG > 0) {
    b[1] = NEG_SH_C1 * y;
    b[2] = SH_C1 * z;
    b[3] = NEG_SH_C1 * x;
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = SH_C2_0 * xy;
    b[5] = SH_C2_1 * yz;
    b[6] = SH_C2_2 * ((2.0f * zz - xx) - yy);
    b[7] = SH_C2_3 * xz;
    b[8] = SH_C2_4 * (xx - yy);
    if (DEG > 2) {
      b[9] = (SH_C3_0 * y) * (3.0f * xx - yy);
      b[10] = (SH_C3_1 * xy) * z;
      b[11] = (SH_C3_2 * y) * ((4.0f * zz - xx) - yy);
      b[12] = (SH_C3_3 * z) * ((2.0f * zz - 3.0f * xx) - 3.0f * yy);
      b[13] = (SH_C3_4 * x) * ((4.0f * zz - xx) - yy);
      b[14] = (SH_C3_5 * z) * (xx - yy);
      b[15] = (SH_C3_6 * x) * (xx - 3.0f * yy);
    }
  }
}

// The gradient of sum_j gb[j] * basis_j w.r.t. the direction.
template <int DEG>
GF_DEV void sh_basis_grad(float x, float y, float z, const float gb[16],
                         float g[3]) {
  g[0] = g[1] = g[2] = 0.0f;
  if (DEG > 0) {
    g[0] += NEG_SH_C1 * gb[3];
    g[1] += NEG_SH_C1 * gb[1];
    g[2] += SH_C1 * gb[2];
  }
  if (DEG > 1) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    g[0] += SH_C2_0 * y * gb[4] - 2.0f * SH_C2_2 * x * gb[6] +
            SH_C2_3 * z * gb[7] + 2.0f * SH_C2_4 * x * gb[8];
    g[1] += SH_C2_0 * x * gb[4] + SH_C2_1 * z * gb[5] -
            2.0f * SH_C2_2 * y * gb[6] - 2.0f * SH_C2_4 * y * gb[8];
    g[2] += SH_C2_1 * y * gb[5] + 4.0f * SH_C2_2 * z * gb[6] +
            SH_C2_3 * x * gb[7];
    if (DEG > 2) {
      g[0] += SH_C3_0 * 6.0f * xy * gb[9] + SH_C3_1 * yz * gb[10] -
              SH_C3_2 * 2.0f * xy * gb[11] - SH_C3_3 * 6.0f * xz * gb[12] +
              SH_C3_4 * (4.0f * zz - 3.0f * xx - yy) * gb[13] +
              SH_C3_5 * 2.0f * xz * gb[14] +
              SH_C3_6 * 3.0f * (xx - yy) * gb[15];
      g[1] += SH_C3_0 * 3.0f * (xx - yy) * gb[9] + SH_C3_1 * xz * gb[10] +
              SH_C3_2 * (4.0f * zz - xx - 3.0f * yy) * gb[11] -
              SH_C3_3 * 6.0f * yz * gb[12] - SH_C3_4 * 2.0f * xy * gb[13] -
              SH_C3_5 * 2.0f * yz * gb[14] - SH_C3_6 * 6.0f * xy * gb[15];
      g[2] += SH_C3_1 * xy * gb[10] + SH_C3_2 * 8.0f * yz * gb[11] +
              SH_C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * gb[12] +
              SH_C3_4 * 8.0f * xz * gb[13] + SH_C3_5 * (xx - yy) * gb[14];
    }
  }
}

// sum_j sh[j * stride + ch] * b[j] over the first (DEG + 1)^2 coefficients.
template <int DEG>
GF_DEV float sh_dot(const float* sh, int stride, int ch, const float b[16]) {
  constexpr int K = (DEG + 1) * (DEG + 1);
  float acc = __ldg(sh + ch) * b[0];
  for (int j = 1; j < K; ++j) acc = acc + __ldg(sh + j * stride + ch) * b[j];
  return acc;
}

// The view direction: (means3d - campos) * rsqrt(|.|^2 + 1e-20).
struct Dir {
  float d[3], inv, n[3];
};

GF_DEV Dir view_dir(const float m[3], const Camera& c) {
  Dir o;
  for (int k = 0; k < 3; ++k) o.d[k] = m[k] - c.c[k];
  o.inv = rsqrtf(((o.d[0] * o.d[0] + o.d[1] * o.d[1]) + o.d[2] * o.d[2]) + DIR_EPS);
  for (int k = 0; k < 3; ++k) o.n[k] = o.d[k] * o.inv;
  return o;
}

// The phasor's inputs: ops/tof.py::phasor_channels up to the cos and sin.
struct Tof {
  float scale, phase, factor, amp, af, c, s;
};

GF_DEV Tof tof_of(float dist, float phase_sh, float amp, float po,
                 bool vdp, const Camera& c) {
  Tof t;
  t.scale = (1.0f / c.depth_range) * FOUR_PI;
  t.phase = dist * t.scale + po;
  if (vdp) t.phase = t.phase + phase_sh;
  t.factor = 1.0f / (dist * dist);
  t.amp = amp;
  t.af = amp * t.factor;
  t.c = cosf(t.phase);
  t.s = sinf(t.phase);
  return t;
}

// Reads one row's means3d.
GF_DEV void load3(const float* p, int i, float m[3]) {
  for (int k = 0; k < 3; ++k) m[k] = __ldg(p + 3 * i + k);
}

// The row's 3D covariance (precomputed, or from scale and rotation).
GF_DEV void row_cov3d(const Params& p, int i, float R[9], float s[3],
                     float M[9], float cov[6]) {
  if (p.cov3d_pre) {
    for (int k = 0; k < 6; ++k) cov[k] = __ldg(p.cov3d_pre + 6 * i + k);
    return;
  }
  float q[4];
  for (int k = 0; k < 4; ++k) q[k] = __ldg(p.rotations + 4 * i + k);
  for (int k = 0; k < 3; ++k) s[k] = p.scale_modifier * __ldg(p.scales + 3 * i + k);
  rotation(q, R);
  cov3d_of(R, s, M, cov);
}

template <int DEG>
GF_DEV void forward_row(const Params& p, const Camera& c, const Outputs& o,
                       int i) {
  float m[3];
  load3(p.means3d, i, m);
  const Proj pr = project(m, c);
  const float ndc_x = pr.ph[0] * pr.pw + __ldg(p.means2d_ndc + 2 * i);
  const float ndc_y = pr.ph[1] * pr.pw + __ldg(p.means2d_ndc + 2 * i + 1);
  const float mx = ndc2pix(ndc_x, p.width);
  const float my = ndc2pix(ndc_y, p.height);

  float R[9], s[3], M[9], cov[6];
  row_cov3d(p, i, R, s, M, cov);
  const Ewa e = ewa(pr.pv, cov, c);
  const float det = e.xx * e.yy - e.xy * e.xy;
  const float det_inv = 1.0f / (det == 0.0f ? 1.0f : det);
  const float mid = 0.5f * (e.xx + e.yy);
  const float lambda1 = mid + sqrtf(clamp_min(mid * mid - det, RADIUS_FLOOR));
  const float radius = ceilf(3.0f * sqrtf(lambda1));

  // Tile rect (auxiliary.h:49-59).
  const float tw = (float)p.tile_w, th = (float)p.tile_h;
  const int x0 = (int)clamp2(floorf((mx - radius) / tw), 0.0f, (float)p.grid_w);
  const int y0 = (int)clamp2(floorf((my - radius) / th), 0.0f, (float)p.grid_h);
  const int x1 = (int)clamp2(floorf((((mx + radius) + tw) - 1.0f) / tw), 0.0f,
                             (float)p.grid_w);
  const int y1 = (int)clamp2(floorf((((my + radius) + th) - 1.0f) / th), 0.0f,
                             (float)p.grid_h);
  const int tiles = (x1 - x0) * (y1 - y0);
  const bool valid = pr.inside && det != 0.0f && tiles > 0 &&
                     __ldg(p.opacities + i) > 0.0f;

  o.mean2d[2 * i] = mx;
  o.mean2d[2 * i + 1] = my;
  o.depth[i] = pr.depth;
  o.conic[3 * i] = e.yy * det_inv;
  o.conic[3 * i + 1] = -e.xy * det_inv;
  o.conic[3 * i + 2] = e.xx * det_inv;
  o.radius[i] = valid ? radius : 0.0f;
  o.rect[4 * i] = x0;
  o.rect[4 * i + 1] = y0;
  o.rect[4 * i + 2] = x1;
  o.rect[4 * i + 3] = y1;
  o.tiles[i] = valid ? tiles : 0;
  o.valid[i] = valid ? 1 : 0;

  float b[16];
  const Dir d = view_dir(m, c);
  sh_basis<DEG>(d.n[0], d.n[1], d.n[2], b);
  for (int ch = 0; ch < 3; ++ch) {
    const float v = p.shs ? sh_dot<DEG>(p.shs + (size_t)i * p.sh_m * 3, 3, ch, b) + 0.5f
                          : 0.0f;
    o.rgb[3 * i + ch] = p.shs ? clamp_min(v, 0.0f) : 0.0f;
  }

  const float dist = sqrtf((pr.pv[0] * pr.pv[0] + pr.pv[1] * pr.pv[1]) +
                           pr.pv[2] * pr.pv[2]);
  o.dist[i] = dist;
  o.dist_ndc[i] = (c.zfar / (c.zfar - c.znear)) * (1.0f - c.znear / dist);

  float* ph = o.phasor + 7 * i;
  if (!p.shs_p && !p.phasors_pre) {
    for (int k = 0; k < 7; ++k) ph[k] = 0.0f;
    return;
  }
  float phase_sh, amp, po;
  if (p.shs_p) {
    const float* sp = p.shs_p + (size_t)i * p.shp_m * p.shp_c;
    const float pa0 = sh_dot<DEG>(sp, p.shp_c, 0, b) + 0.5f;
    const float pa1 = sh_dot<DEG>(sp, p.shp_c, 1, b) + 0.5f;
    phase_sh = pa0 - (0.5f + SH_C0 * __ldg(sp));
    amp = clamp_min(pa1, 0.0f);
    po = c.po;
  } else {
    // The reference's precomp branch omits phase_offset (forward.cu:367).
    phase_sh = __ldg(p.phasors_pre + (size_t)i * p.pp_c);
    amp = __ldg(p.phasors_pre + (size_t)i * p.pp_c + 1);
    po = 0.0f;
  }
  const Tof t = tof_of(dist, phase_sh, amp, po, p.use_vdp, c);
  ph[0] = t.c * t.af;
  ph[1] = t.s * t.af;
  ph[2] = t.af;
  ph[3] = (t.c + c.dc) * t.af;
  ph[4] = (-t.c + c.dc) * t.af;
  ph[5] = (t.s + c.dc) * t.af;
  ph[6] = (-t.s + c.dc) * t.af;
}

// --------------------------------------------------------------- backward

GF_DEV float cot(const float* g, long long stride, int i, int k) {
  return g ? __ldg(g + stride * i + k) : 0.0f;
}

// Writes row i's gradients; returns its terms of the offsets' gradients
// in g_po and g_dc.
template <int DEG>
GF_DEV void backward_row(const Params& p, const Camera& c, const Grads& g,
                        int i, float& g_po, float& g_dc) {
  g_po = g_dc = 0.0f;
  float m[3];
  load3(p.means3d, i, m);
  const Proj pr = project(m, c);
  float R[9], s[3], M[9], cov[6];
  row_cov3d(p, i, R, s, M, cov);
  const Ewa e = ewa(pr.pv, cov, c);
  const float det = e.xx * e.yy - e.xy * e.xy;
  const float det_inv = 1.0f / (det == 0.0f ? 1.0f : det);

  float g_m[3] = {0.0f, 0.0f, 0.0f};  // means3d
  float g_pv[3] = {0.0f, 0.0f, 0.0f};  // the sanitised view-space point
  const float dist = sqrtf((pr.pv[0] * pr.pv[0] + pr.pv[1] * pr.pv[1]) +
                           pr.pv[2] * pr.pv[2]);
  float g_dist = cot(g.dist, g.s_dist, i, 0);

  // dist_ndc = a * (1 - znear / dist)
  const float g_dndc = cot(g.dist_ndc, g.s_dist_ndc, i, 0);
  g_dist += (g_dndc * (c.zfar / (c.zfar - c.znear))) * c.znear / (dist * dist);

  // Directions and SH bases.
  const Dir d = view_dir(m, c);
  float b[16], gb[16];
  sh_basis<DEG>(d.n[0], d.n[1], d.n[2], b);
  constexpr int K = (DEG + 1) * (DEG + 1);
  for (int j = 0; j < K; ++j) gb[j] = 0.0f;

  // Phasor channels.
  const bool has_phasor = p.shs_p || p.phasors_pre;
  if (has_phasor) {
    const float* sp = p.shs_p ? p.shs_p + (size_t)i * p.shp_m * p.shp_c : nullptr;
    float phase_sh, amp, pa1 = 0.0f, po;
    if (sp) {
      const float pa0 = sh_dot<DEG>(sp, p.shp_c, 0, b) + 0.5f;
      pa1 = sh_dot<DEG>(sp, p.shp_c, 1, b) + 0.5f;
      phase_sh = pa0 - (0.5f + SH_C0 * __ldg(sp));
      amp = clamp_min(pa1, 0.0f);
      po = c.po;
    } else {
      phase_sh = __ldg(p.phasors_pre + (size_t)i * p.pp_c);
      amp = __ldg(p.phasors_pre + (size_t)i * p.pp_c + 1);
      po = 0.0f;
    }
    const Tof t = tof_of(dist, phase_sh, amp, po, p.use_vdp, c);
    float gp[7];
    for (int k = 0; k < 7; ++k) gp[k] = cot(g.phasor, g.s_phasor, i, k);
    const float g_c = (gp[0] + gp[3] - gp[4]) * t.af;
    const float g_s = (gp[1] + gp[5] - gp[6]) * t.af;
    const float g_af = gp[0] * t.c + gp[1] * t.s + gp[2] + gp[3] * (t.c + c.dc) +
                       gp[4] * (-t.c + c.dc) + gp[5] * (t.s + c.dc) +
                       gp[6] * (-t.s + c.dc);
    g_dc = (gp[3] + gp[4] + gp[5] + gp[6]) * t.af;
    const float g_phase = t.c * g_s - t.s * g_c;
    const float g_amp = g_af * t.factor;
    const float g_factor = g_af * t.amp;
    // factor = 1 / dist^2; phase = dist * scale + po (+ phase_sh)
    g_dist += -g_factor * t.factor * t.factor * 2.0f * dist;
    g_dist += g_phase * t.scale;
    const float g_phase_sh = p.use_vdp ? g_phase : 0.0f;
    if (sp) {
      g_po = g_phase;
      const float g_pa0 = g_phase_sh;
      const float g_pa1 = pa1 >= 0.0f ? g_amp : 0.0f;
      for (int j = 0; j < K; ++j)
        gb[j] += g_pa0 * __ldg(sp + j * p.shp_c) + g_pa1 * __ldg(sp + j * p.shp_c + 1);
      if (g.d_shs_p) {
        float* out = g.d_shs_p + (size_t)i * p.shp_m * p.shp_c;
        for (int j = 0; j < K; ++j) {
          out[j * p.shp_c] = g_pa0 * b[j];
          out[j * p.shp_c + 1] = g_pa1 * b[j];
          for (int ch = 2; ch < p.shp_c; ++ch) out[j * p.shp_c + ch] = 0.0f;
        }
        for (int k = K * p.shp_c; k < p.shp_m * p.shp_c; ++k) out[k] = 0.0f;
      }
    } else if (g.d_phasors_pre) {
      float* out = g.d_phasors_pre + (size_t)i * p.pp_c;
      out[0] = g_phase_sh;
      out[1] = g_amp;
      for (int k = 2; k < p.pp_c; ++k) out[k] = 0.0f;
    }
  } else if (g.d_shs_p) {
    float* out = g.d_shs_p + (size_t)i * p.shp_m * p.shp_c;
    for (int k = 0; k < p.shp_m * p.shp_c; ++k) out[k] = 0.0f;
  }

  // Colour.
  if (p.shs) {
    const float* sh = p.shs + (size_t)i * p.sh_m * 3;
    float gv[3];
    for (int ch = 0; ch < 3; ++ch) {
      const float v = sh_dot<DEG>(sh, 3, ch, b) + 0.5f;
      gv[ch] = v >= 0.0f ? cot(g.rgb, g.s_rgb, i, ch) : 0.0f;
    }
    for (int j = 0; j < K; ++j)
      gb[j] += (gv[0] * __ldg(sh + 3 * j) + gv[1] * __ldg(sh + 3 * j + 1)) +
               gv[2] * __ldg(sh + 3 * j + 2);
    if (g.d_shs) {
      float* out = g.d_shs + (size_t)i * p.sh_m * 3;
      for (int j = 0; j < K; ++j)
        for (int ch = 0; ch < 3; ++ch) out[3 * j + ch] = gv[ch] * b[j];
      for (int k = 3 * K; k < 3 * p.sh_m; ++k) out[k] = 0.0f;
    }
  }

  // dir_n = d * rsqrt(|d|^2 + eps): back to means3d.
  if (DEG > 0) {
    float g_n[3];
    sh_basis_grad<DEG>(d.n[0], d.n[1], d.n[2], gb, g_n);
    const float g_inv = (g_n[0] * d.d[0] + g_n[1] * d.d[1]) + g_n[2] * d.d[2];
    const float g_ss = g_inv * (-0.5f * d.inv * d.inv * d.inv);
    for (int k = 0; k < 3; ++k) g_m[k] += g_n[k] * d.inv + g_ss * 2.0f * d.d[k];
  }

  // dist = |pv|
  if (dist != 0.0f)
    for (int k = 0; k < 3; ++k) g_pv[k] += g_dist * pr.pv[k] / dist;

  // conic = [yy, -xy, xx] / det', det' = det (1 where det == 0)
  const float gc0 = cot(g.conic, g.s_conic, i, 0);
  const float gc1 = cot(g.conic, g.s_conic, i, 1);
  const float gc2 = cot(g.conic, g.s_conic, i, 2);
  float g_xx = gc2 * det_inv, g_yy = gc0 * det_inv, g_xy = -(gc1 * det_inv);
  const float g_dinv = gc0 * e.yy + gc1 * (-e.xy) + gc2 * e.xx;
  const float g_det = det != 0.0f ? -g_dinv * det_inv * det_inv : 0.0f;
  g_xx += g_det * e.yy;
  g_yy += g_det * e.xx;
  g_xy -= 2.0f * g_det * e.xy;

  // cov2d = [u0.S u0 + 0.3, u0.S u1, u1.S u1 + 0.3]
  float g_cov[6];
  {
    float G[9];
    for (int a = 0; a < 3; ++a)
      for (int k = 0; k < 3; ++k)
        G[3 * a + k] = g_xx * e.u0[a] * e.u0[k] + g_xy * e.u0[a] * e.u1[k] +
                       g_yy * e.u1[a] * e.u1[k];
    g_cov[0] = G[0];
    g_cov[1] = G[1] + G[3];
    g_cov[2] = G[2] + G[6];
    g_cov[3] = G[4];
    g_cov[4] = G[5] + G[7];
    g_cov[5] = G[8];
  }
  float g_u0[3], g_u1[3];
  for (int k = 0; k < 3; ++k) {
    g_u0[k] = 2.0f * g_xx * e.su0[k] + g_xy * e.su1[k];
    g_u1[k] = g_xy * e.su0[k] + 2.0f * g_yy * e.su1[k];
  }
  const float g_j00 = (g_u0[0] * c.V[0] + g_u0[1] * c.V[4]) + g_u0[2] * c.V[8];
  const float g_j02 = (g_u0[0] * c.V[2] + g_u0[1] * c.V[6]) + g_u0[2] * c.V[10];
  const float g_j11 = (g_u1[0] * c.V[1] + g_u1[1] * c.V[5]) + g_u1[2] * c.V[9];
  const float g_j12 = (g_u1[0] * c.V[2] + g_u1[1] * c.V[6]) + g_u1[2] * c.V[10];
  float g_tz = -(g_j00 * c.fx + g_j11 * c.fy) / e.tz2;
  float g_tx = -g_j02 * c.fx / e.tz2;
  float g_ty = -g_j12 * c.fy / e.tz2;
  g_tz += 2.0f * (g_j02 * c.fx * e.tx + g_j12 * c.fy * e.ty) / (e.tz2 * e.tz);
  // t = clamp(p / tz, -lim, lim) * tz
  g_tz += g_tx * e.cx + g_ty * e.cy;
  const float g_rx = (e.rx >= -e.limx && e.rx <= e.limx) ? g_tx * e.tz : 0.0f;
  const float g_ry = (e.ry >= -e.limy && e.ry <= e.limy) ? g_ty * e.tz : 0.0f;
  g_pv[0] += g_rx / e.tz;
  g_pv[1] += g_ry / e.tz;
  g_tz -= (g_rx * pr.pv[0] + g_ry * pr.pv[1]) / e.tz2;
  g_pv[2] += g_tz;

  // Back through the culled rows' sanitising and the view transform.
  float g_raw[3];
  for (int k = 0; k < 3; ++k) g_raw[k] = pr.inside ? g_pv[k] : 0.0f;
  g_raw[2] += cot(g.depth, g.s_depth, i, 0);
  for (int k = 0; k < 3; ++k)
    g_m[k] += (g_raw[0] * c.V[4 * k] + g_raw[1] * c.V[4 * k + 1]) +
              g_raw[2] * c.V[4 * k + 2];

  // mean2d = ndc2pix(ph[:2] * pw + means2d_ndc)
  const float g_ndc_x = cot(g.mean2d, g.s_mean2d, i, 0) * 0.5f * (float)p.width;
  const float g_ndc_y = cot(g.mean2d, g.s_mean2d, i, 1) * 0.5f * (float)p.height;
  if (g.d_means2d_ndc) {
    g.d_means2d_ndc[2 * i] = g_ndc_x;
    g.d_means2d_ndc[2 * i + 1] = g_ndc_y;
  }
  const float g_pw = g_ndc_x * pr.ph[0] + g_ndc_y * pr.ph[1];
  const float g_ph3 = pr.inside ? -g_pw * pr.pw * pr.pw : 0.0f;
  const float g_ph[4] = {g_ndc_x * pr.pw, g_ndc_y * pr.pw, 0.0f, g_ph3};
  for (int k = 0; k < 3; ++k)
    g_m[k] += ((g_ph[0] * c.Pm[4 * k] + g_ph[1] * c.Pm[4 * k + 1]) +
               g_ph[2] * c.Pm[4 * k + 2]) + g_ph[3] * c.Pm[4 * k + 3];
  if (g.d_means3d)
    for (int k = 0; k < 3; ++k) g.d_means3d[3 * i + k] = g_m[k];

  // The 3D covariance.
  if (p.cov3d_pre) {
    if (g.d_cov3d_pre)
      for (int k = 0; k < 6; ++k) g.d_cov3d_pre[6 * i + k] = g_cov[k];
    return;
  }
  if (!g.d_scales && !g.d_rotations) return;
  // Sigma = M M^T: dM = (G + G^T) M, G the upper-triangle cotangent.
  const float Gs[9] = {2.0f * g_cov[0], g_cov[1], g_cov[2],
                       g_cov[1], 2.0f * g_cov[3], g_cov[4],
                       g_cov[2], g_cov[4], 2.0f * g_cov[5]};
  float gR[9], g_s[3] = {0.0f, 0.0f, 0.0f};
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) {
      const float gM = (Gs[3 * a] * M[k] + Gs[3 * a + 1] * M[3 + k]) +
                       Gs[3 * a + 2] * M[6 + k];
      gR[3 * a + k] = gM * s[k];
      g_s[k] += gM * R[3 * a + k];
    }
  if (g.d_scales)
    for (int k = 0; k < 3; ++k) g.d_scales[3 * i + k] = g_s[k] * p.scale_modifier;
  if (g.d_rotations) {
    const float r = __ldg(p.rotations + 4 * i), x = __ldg(p.rotations + 4 * i + 1);
    const float y = __ldg(p.rotations + 4 * i + 2), z = __ldg(p.rotations + 4 * i + 3);
    float* q = g.d_rotations + 4 * i;
    q[0] = 2.0f * (-z * gR[1] + y * gR[2] + z * gR[3] - x * gR[5] - y * gR[6] +
                   x * gR[7]);
    q[1] = 2.0f * (y * gR[1] + z * gR[2] + y * gR[3] - 2.0f * x * gR[4] -
                   r * gR[5] + z * gR[6] + r * gR[7] - 2.0f * x * gR[8]);
    q[2] = 2.0f * (-2.0f * y * gR[0] + x * gR[1] + r * gR[2] + x * gR[3] +
                   z * gR[5] - r * gR[6] + z * gR[7] - 2.0f * y * gR[8]);
    q[3] = 2.0f * (-2.0f * z * gR[0] - r * gR[1] + x * gR[2] + r * gR[3] -
                   2.0f * z * gR[4] + y * gR[5] + x * gR[6] + y * gR[7]);
  }
}

}  // namespace pre
}  // namespace gftorf
