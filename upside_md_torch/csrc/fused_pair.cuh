// Shared device helpers of the pair kernels (fused_pair_fwd.cu,
// fused_pair_bwd.cu, quadspline.cu, table_cotangent.cu, nlist_spline.cu).
// Tile sizes must match ops/kernels.py.
#pragma once
#include <cuda_runtime.h>

#define TILE_ROWS 32    // rows per block tile
#define TILE_COLS 32    // bead columns per block tile (one warp wide)

struct PairGeom {
  float ux, uy, uz;   // unit vector from row site to column bead
  float dist, inv;    // distance and its inverse
  float cos1, cos2;   // row direction . u, -(column direction . u)
};

// as `_geometry` (upside_md_tpu/ops/pallas_quadspline.py:175).  The
// squared distance is summed in the plain version's order with
// round-to-nearest multiplies and adds that the compiler may not fuse, and
// the inverse is the correctly rounded reciprocal of the correctly
// rounded square root, as ops/fused_pair.py `_geometry` forms them, so the
// live test s = dist / dx < kcut gives the plain version's pairs bit for
// bit.
__device__ __forceinline__ PairGeom pair_geometry(const float* x1,
                                                  const float* x2) {
  PairGeom g;
  float dx = x2[0] - x1[0], dy = x2[1] - x1[1], dz = x2[2] - x1[2];
  float d2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz)), 1e-12f);
  g.inv = __frcp_rn(__fsqrt_rn(d2));
  g.dist = __fmul_rn(d2, g.inv);
  g.ux = dx * g.inv; g.uy = dy * g.inv; g.uz = dz * g.inv;
  g.cos1 = x1[3] * g.ux + x1[4] * g.uy + x1[5] * g.uz;
  g.cos2 = -(x2[3] * g.ux + x2[4] * g.uy + x2[5] * g.uz);
  return g;
}

// Horner on the interval's 4 cubic coefficients c[(i-1)*4 ...]; the
// clamped coordinate makes the boundary values exact, only the derivative
// needs the clamp mask.
__device__ __forceinline__ void poly_eval(const float* c, float x, int n,
                                          bool clamped, float& v, float& dv) {
  const float lo = 1.0f, hi = (float)(n - 2);
  float xc = fminf(fmaxf(x, lo), hi);
  float fi = fminf(fmaxf(floorf(xc), 1.0f), (float)(n - 3));
  float t = xc - fi;
  const float* q = c + ((int)fi - 1) * 4;
  v = ((q[3] * t + q[2]) * t + q[1]) * t + q[0];
  dv = (3.0f * q[3] * t + 2.0f * q[2]) * t + q[1];
  if (clamped && (x <= lo || x >= hi)) dv = 0.0f;
}

struct SplineTerms {
  float a1, da1, a2, da2, wide, dwide, nar, dnar;
};

// the four segments of one pair's spline and their derivatives (K4, K5
// and the neighbour lists' spline)
__device__ __forceinline__ SplineTerms spline_terms(const float* cf,
                                                    const PairGeom& g, int ka,
                                                    int k, float sd) {
  const int na = (ka - 3) * 4, nd = (k - 3) * 4;
  const float inv_dth = (ka - 3) * 0.5f;
  SplineTerms t;
  poly_eval(cf, (g.cos1 + 1.0f) * inv_dth + 1.0f, ka, false, t.a1, t.da1);
  poly_eval(cf + na, (g.cos2 + 1.0f) * inv_dth + 1.0f, ka, false, t.a2,
            t.da2);
  poly_eval(cf + 2 * na, sd, k, true, t.wide, t.dwide);
  poly_eval(cf + 2 * na + nd, sd, k, true, t.nar, t.dnar);
  return t;
}

// The cotangents of one live pair under pair cotangent gv, in the
// reference derivative partition (bead_interaction.h:61-73): rc[0..6) of
// its row site, cc[0..6) of its column site.
__device__ __forceinline__ void spline_cotangents(const SplineTerms& t,
                                                  const PairGeom& g,
                                                  const float* xr,
                                                  const float* xc, float gv,
                                                  float inv_dx, int ka,
                                                  float* rc, float* cc) {
  const float inv_dth = (ka - 3) * 0.5f;
  const float rad = gv * (t.dwide + t.a1 * t.a2 * t.dnar) * inv_dx;
  const float c1 = gv * t.da1 * inv_dth * t.a2 * t.nar;
  const float c2 = gv * t.da2 * inv_dth * t.a1 * t.nar;
  const float f1 = c1 * g.inv, f2 = c2 * g.inv;
  const float gx = rad * g.ux + f1 * (xr[3] - g.cos1 * g.ux)
                   - f2 * (xc[3] + g.cos2 * g.ux);
  const float gy = rad * g.uy + f1 * (xr[4] - g.cos1 * g.uy)
                   - f2 * (xc[4] + g.cos2 * g.uy);
  const float gz = rad * g.uz + f1 * (xr[5] - g.cos1 * g.uz)
                   - f2 * (xc[5] + g.cos2 * g.uz);
  rc[0] = -gx; rc[1] = -gy; rc[2] = -gz;
  rc[3] = c1 * g.ux; rc[4] = c1 * g.uy; rc[5] = c1 * g.uz;
  cc[0] = gx; cc[1] = gy; cc[2] = gz;
  cc[3] = -(c2 * g.ux); cc[4] = -(c2 * g.uy); cc[5] = -(c2 * g.uz);
}

// compact sigmoid (src/vector_math.h:640-658): value and d/dx
__device__ __forceinline__ void compact_sigmoid(float x, float sharp,
                                                float& v, float& dv) {
  float y = x * sharp;
  if (y < -1.0f) { v = 1.0f; dv = 0.0f; }
  else if (y > 1.0f) { v = 0.0f; dv = 0.0f; }
  else {
    v = 0.25f * (y + 2.0f) * (y - 1.0f) * (y - 1.0f);
    dv = sharp * 0.75f * (y * y - 1.0f);
  }
}

// fixed-order warp sum (lane 0 holds the result): deterministic
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}
