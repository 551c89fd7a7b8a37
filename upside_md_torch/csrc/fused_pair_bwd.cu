// The two backwards of the fused pair block, one template:
//
// * K1 backward (`fused_pair_bwd`, RECOMPUTE = false): cotangents from the
//   forward's residual planes.  Replaces upside_md_tpu/ops/
//   pallas_quadspline.py `_fused_bwd_resid_kernel` (:1276), launched by
//   `_fused_bwd_batched` (:1678, `planes` branch :1712-1759) for the VJP
//   of `fused_pair_block_env_prep` (:2426).
// * K3 (`fused_pair_bwd_recompute`, RECOMPUTE = true): the recomputing
//   backward.  Replaces `_fused_bwd_kernel` (:1132), launched by
//   `_fused_bwd_batched` (:1760-1810) for the VJPs of `fused_pair_block`
//   (no env band, :1926) and of `fused_pair_block_env` under
//   UPSIDE_FUSED_RESID=0 (:2186).  r_e == r_p is the block without its env
//   band.
//
// What bounds them on an H100.  K1 backward: device-memory reads of the
// three derivative planes, the coverage value plane and the pair-grid
// cotangent (about the bytes the forward wrote, ~4.5 MB per replica at
// ubiquitin shapes), plus the per-tile partial sums; the arithmetic is
// geometry and a few multiply-adds per pair.  K3 reads only the sites, the
// cotangents (the pair-grid cotangent, ~0.6 MB per replica, is the bulk)
// and the coefficient table (~180 KB, shared by all replicas, in L2), and
// recomputes each live pair's spline terms: ~150 flops per live pair and
// the geometry of every pair, so at ubiquitin shapes its bytes and its
// operations bound it about equally.
//
// Design: the forward's tiling (one thread per pair, 32x32 tiles, replica
// in grid z).  K1 backward recomputes only each pair's geometry and reads
// the spline derivatives from the planes; K3 runs the forward's per-pair
// coefficient lookup and Horner in registers instead (masked pairs and
// pairs beyond the cutoff skip the spline), so no plane exists in memory.
// The TPU kernel builds VMEM coefficient planes per tile through one-hot
// MXU matmuls because it cannot gather; here each live pair reads its 4
// cubic coefficients per segment directly.  The cotangent is selected,
// never multiplied, by mask AND inside-cutoff, and so are the coverage
// weight cotangents and the env rows.  The TPU kernels take the weight
// cotangents unguarded (`val * gcs`, :1254-1257) and K3's env cotangent as
// a product with the mask (`genv * m * w`, :1182), so a non-finite
// cotangent at a dead slot gives NaN there and stays out here.  The env
// band has no planes and recomputes its two compact sigmoids.  Row
// gradients (over columns) reduce through a fixed warp tree into
// per-column-tile partials, column gradients (over rows) through shared
// memory into per-row-tile partials; a second pass sums the partials in
// order.  No float atomics, so both are bitwise repeatable.
#include "fused_pair.cuh"

#define NCOMP 7   // 6 position/direction components + one weight

template <bool RECOMPUTE>
static __global__ void __launch_bounds__(TILE_COLS * ROW_THREADS)
fused_bwd_kernel(const float* __restrict__ x1, const float* __restrict__ w1,
                 const float* __restrict__ x2, const float* __restrict__ wcol,
                 const int* __restrict__ row_type,
                 const int* __restrict__ col_type,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ coef,
                 const float* __restrict__ env_tab,
                 const float* __restrict__ planes,
                 const float* __restrict__ vcov,
                 const float* __restrict__ g_cov,
                 const float* __restrict__ g_grid,
                 const float* __restrict__ g_env,
                 int n1, int n2, int n2p, int r_b, int r_e, int r_p,
                 int ka, int k, int n_ct, int ncoef, int n_env_t2,
                 float inv_dx, float kcut_cov, float kcut_pair,
                 float* __restrict__ d1part, float* __restrict__ d2part,
                 int n_rep) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * TILE_COLS + tx;
  const int rt = blockIdx.y;
  const int r = blockIdx.z;
  const bool jv = j < n2;
  const int n_e = r_p - r_e;
  const long plane = (long)n1 * n2;
  const int na = (ka - 3) * 4, nd = (k - 3) * 4;
  const float inv_dth = (ka - 3) * 0.5f;

  float xc[6] = {0, 0, 0, 0, 0, 0};
  float wc = 0.0f, gca = 0.0f, gcb = 0.0f;
  int ct[4] = {0, 0, 0, 0};
  if (jv) {
    for (int c = 0; c < 6; ++c) xc[c] = x2[((long)r * n2 + j) * 6 + c];
    wc = wcol[(long)r * n2 + j];
    gca = g_cov[((long)r * 2 + 0) * n2 + j];
    gcb = g_cov[((long)r * 2 + 1) * n2 + j];
    for (int b = 0; b < 4; ++b) ct[b] = col_type[b * n2 + j];
  }
  float colacc[NCOMP];
  for (int c = 0; c < NCOMP; ++c) colacc[c] = 0.0f;

  for (int s = 0; s < TILE_ROWS / ROW_THREADS; ++s) {
    const int i = rt * TILE_ROWS + s * ROW_THREADS + ty;   // warp-uniform
    if (i >= n1) break;
    const int band = (i >= r_b) + (i >= r_e) + (i >= r_p);
    float xr[6];
    for (int c = 0; c < 6; ++c) xr[c] = x1[((long)r * n1 + i) * 6 + c];
    float row[NCOMP] = {0, 0, 0, 0, 0, 0, 0};
    if (jv) {
      PairGeom g = pair_geometry(xr, xc);
      const bool m = mask[(long)i * n2 + j] != 0;
      if (band != 2) {
        const float kcut = band == 3 ? kcut_pair : kcut_cov;
        const float sd = g.dist * inv_dx;
        const bool live = m && sd < kcut;
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, val = 0.0f;
        if (RECOMPUTE) {
          if (live) {
            const float* cf =
                coef + ((long)row_type[i] * n_ct + ct[band]) * ncoef;
            float a1, da1, a2, da2, wide, dwide, nar, dnar;
            poly_eval(cf, (g.cos1 + 1.0f) * inv_dth + 1.0f, ka, false, a1,
                      da1);
            poly_eval(cf + na, (g.cos2 + 1.0f) * inv_dth + 1.0f, ka, false,
                      a2, da2);
            poly_eval(cf + 2 * na, sd, k, true, wide, dwide);
            poly_eval(cf + 2 * na + nd, sd, k, true, nar, dnar);
            val = wide + a1 * a2 * nar;
            p0 = (dwide + a1 * a2 * dnar) * inv_dx;
            p1 = da1 * inv_dth * a2 * nar;
            p2 = da2 * inv_dth * a1 * nar;
          }
        } else {
          const long pidx = (long)r * 3 * plane + (long)i * n2 + j;
          p0 = planes[pidx];
          p1 = planes[pidx + plane];
          p2 = planes[pidx + 2 * plane];
          if (band < 2 && live) val = vcov[((long)r * r_e + i) * n2 + j];
        }
        float graw, gc = band == 0 ? gca : gcb;
        if (band == 3)
          graw = g_grid[((long)r * n2p + (i - r_p)) * n2p + j];
        else
          graw = w1[(long)r * n1 + i] * gc;
        const float gv = live ? graw : 0.0f;
        const float rad = gv * p0;
        const float c1 = gv * p1;
        const float c2 = gv * p2;
        const float f1 = c1 * g.inv, f2 = c2 * g.inv;
        const float gx = rad * g.ux + f1 * (xr[3] - g.cos1 * g.ux)
                         - f2 * (xc[3] + g.cos2 * g.ux);
        const float gy = rad * g.uy + f1 * (xr[4] - g.cos1 * g.uy)
                         - f2 * (xc[4] + g.cos2 * g.uy);
        const float gz = rad * g.uz + f1 * (xr[5] - g.cos1 * g.uz)
                         - f2 * (xc[5] + g.cos2 * g.uz);
        row[0] = -gx; row[1] = -gy; row[2] = -gz;
        row[3] = c1 * g.ux; row[4] = c1 * g.uy; row[5] = c1 * g.uz;
        if (band < 2 && live) row[6] = val * gc;
        colacc[0] += gx; colacc[1] += gy; colacc[2] += gz;
        colacc[3] -= c2 * g.ux; colacc[4] -= c2 * g.uy; colacc[5] -= c2 * g.uz;
      } else if (m) {
        const float* pr =
            env_tab + ((long)row_type[i] * n_env_t2 + ct[2]) * 4;
        float rad, drad, ang, dang;
        compact_sigmoid(g.dist - pr[0], pr[1], rad, drad);
        compact_sigmoid(pr[2] - g.cos1, pr[3], ang, dang);
        const float ge_row = g_env[(long)r * n_e + (i - r_e)];
        const float ge = ge_row * wc;
        const float rr = ge * drad * ang;
        const float ce = -ge * rad * dang;
        const float fe = ce * g.inv;
        const float gx = rr * g.ux + fe * (xr[3] - g.cos1 * g.ux);
        const float gy = rr * g.uy + fe * (xr[4] - g.cos1 * g.uy);
        const float gz = rr * g.uz + fe * (xr[5] - g.cos1 * g.uz);
        row[0] = -gx; row[1] = -gy; row[2] = -gz;
        row[3] = ce * g.ux; row[4] = ce * g.uy; row[5] = ce * g.uz;
        colacc[0] += gx; colacc[1] += gy; colacc[2] += gz;
        colacc[6] += ge_row * rad * ang;
      }
    }
    // row gradients: sum over this tile's 32 columns (fixed warp tree)
    for (int c = 0; c < NCOMP; ++c) row[c] = warp_sum(row[c]);
    if (tx == 0) {
      float* dst = d1part + (((long)blockIdx.x * n_rep + r) * n1 + i) * 8;
      for (int c = 0; c < NCOMP; ++c) dst[c] = row[c];
      dst[7] = 0.0f;
    }
  }

  // column gradients: sum over this tile's rows
  __shared__ float sc[NCOMP][ROW_THREADS][TILE_COLS];
  for (int c = 0; c < NCOMP; ++c) sc[c][ty][tx] = colacc[c];
  __syncthreads();
  if (ty == 0 && jv) {
    float* dst = d2part + (((long)rt * n_rep + r) * n2 + j) * 8;
    for (int c = 0; c < NCOMP; ++c) {
      float t = 0.0f;
      for (int y = 0; y < ROW_THREADS; ++y) t += sc[c][y][tx];
      dst[c] = t;
    }
    dst[7] = 0.0f;
  }
}

template <bool RECOMPUTE>
static int launch_bwd(
    const float* x1, const float* w1, const float* x2, const float* wcol,
    const int* row_type, const int* col_type, const unsigned char* mask,
    const float* coef, const float* env_tab, const float* planes,
    const float* vcov, const float* g_cov, const float* g_grid,
    const float* g_env, int n_rep, int n1, int n2, int n2p, int r_b, int r_e,
    int r_p, int ka, int k, int n_ct, int ncoef, int n_env_t2, float inv_dx,
    float kcut_cov, float kcut_pair, float* d1part, float* d2part, float* d1,
    float* d2, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  dim3 block(TILE_COLS, ROW_THREADS);
  dim3 grid_dim((n2 + TILE_COLS - 1) / TILE_COLS,
                (n1 + TILE_ROWS - 1) / TILE_ROWS, n_rep);
  fused_bwd_kernel<RECOMPUTE><<<grid_dim, block, 0, stream>>>(
      x1, w1, x2, wcol, row_type, col_type, mask, coef, env_tab, planes,
      vcov, g_cov, g_grid, g_env, n1, n2, n2p, r_b, r_e, r_p, ka, k, n_ct,
      ncoef, n_env_t2, inv_dx, kcut_cov, kcut_pair, d1part, d2part, n_rep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_parts(d1part, (int)grid_dim.x, (long)n_rep * n1 * 8, d1, stream);
  sum_parts(d2part, (int)grid_dim.y, (long)n_rep * n2 * 8, d2, stream);
  return (int)cudaGetLastError();
}

extern "C" int fused_pair_bwd(
    const float* x1, const float* w1, const float* x2, const float* wcol,
    const int* row_type, const int* col_type, const unsigned char* mask,
    const float* env_tab, const float* planes, const float* vcov,
    const float* g_cov, const float* g_grid, const float* g_env,
    int n_rep, int n1, int n2, int n2p, int r_b, int r_e, int r_p,
    int n_env_t2, float inv_dx, float kcut_cov, float kcut_pair,
    float* d1part, float* d2part, float* d1, float* d2, void* stream_ptr) {
  return launch_bwd<false>(
      x1, w1, x2, wcol, row_type, col_type, mask, nullptr, env_tab, planes,
      vcov, g_cov, g_grid, g_env, n_rep, n1, n2, n2p, r_b, r_e, r_p, 4, 4, 0,
      0, n_env_t2, inv_dx, kcut_cov, kcut_pair, d1part, d2part, d1, d2,
      stream_ptr);
}

extern "C" int fused_pair_bwd_recompute(
    const float* x1, const float* w1, const float* x2, const float* wcol,
    const int* row_type, const int* col_type, const unsigned char* mask,
    const float* coef, const float* env_tab, const float* g_cov,
    const float* g_grid, const float* g_env, int n_rep, int n1, int n2,
    int n2p, int r_b, int r_e, int r_p, int ka, int k, int n_ct, int ncoef,
    int n_env_t2, float inv_dx, float kcut_cov, float kcut_pair,
    float* d1part, float* d2part, float* d1, float* d2, void* stream_ptr) {
  return launch_bwd<true>(
      x1, w1, x2, wcol, row_type, col_type, mask, coef, env_tab, nullptr,
      nullptr, g_cov, g_grid, g_env, n_rep, n1, n2, n2p, r_b, r_e, r_p, ka, k,
      n_ct, ncoef, n_env_t2, inv_dx, kcut_cov, kcut_pair, d1part, d2part, d1,
      d2, stream_ptr);
}
