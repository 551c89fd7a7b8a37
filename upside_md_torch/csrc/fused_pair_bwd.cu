// K1 backward: cotangents of the fused pair block from the forward's
// residual planes.
//
// Replaces: upside_md_tpu/ops/pallas_quadspline.py `_fused_bwd_resid_kernel`
// (:1276), launched by `_fused_bwd_batched` (:1678, `planes` branch
// :1712-1759) for the VJP of `fused_pair_block_env_prep` (:2426).
//
// What bounds it on an H100: device-memory reads of the three derivative
// planes, the coverage value plane and the pair-grid cotangent (about the
// bytes the forward wrote, ~4.5 MB per replica at ubiquitin shapes), plus
// the per-tile partial sums; the arithmetic is geometry and a few
// multiply-adds per pair.
//
// Design: the forward's tiling (one thread per pair, 32x32 tiles, replica
// in grid z).  Each pair recomputes only its geometry; the planes carry
// the spline derivatives.  The cotangent is selected, never multiplied, by
// mask AND inside-cutoff (the TPU kernel's rule), and so are the coverage
// weight cotangents, which the TPU kernel takes unguarded (a non-finite
// column-sum cotangent at a dead pair stays out here).  The env band has no
// planes and recomputes its two compact sigmoids.  Row gradients (over
// columns) reduce through a fixed warp tree into per-column-tile partials,
// column gradients (over rows) through shared memory into per-row-tile
// partials; a second pass sums the partials in order.  No float atomics.
#include "fused_pair.cuh"

#define NCOMP 7   // 6 position/direction components + one weight

static __global__ void __launch_bounds__(TILE_COLS * ROW_THREADS)
fused_bwd_kernel(const float* __restrict__ x1, const float* __restrict__ w1,
                 const float* __restrict__ x2, const float* __restrict__ wcol,
                 const int* __restrict__ row_type,
                 const int* __restrict__ col_type,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ env_tab,
                 const float* __restrict__ planes,
                 const float* __restrict__ vcov,
                 const float* __restrict__ g_cov,
                 const float* __restrict__ g_grid,
                 const float* __restrict__ g_env,
                 int n1, int n2, int n2p, int r_b, int r_e, int r_p,
                 int n_env_t2, float inv_dx, float kcut_cov, float kcut_pair,
                 float* __restrict__ d1part, float* __restrict__ d2part,
                 int n_rep) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * TILE_COLS + tx;
  const int rt = blockIdx.y;
  const int r = blockIdx.z;
  const bool jv = j < n2;
  const int n_e = r_p - r_e;
  const long plane = (long)n1 * n2;

  float xc[6] = {0, 0, 0, 0, 0, 0};
  float wc = 0.0f, gca = 0.0f, gcb = 0.0f;
  int cte = 0;
  if (jv) {
    for (int c = 0; c < 6; ++c) xc[c] = x2[((long)r * n2 + j) * 6 + c];
    wc = wcol[(long)r * n2 + j];
    gca = g_cov[((long)r * 2 + 0) * n2 + j];
    gcb = g_cov[((long)r * 2 + 1) * n2 + j];
    cte = col_type[2 * n2 + j];
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
        const bool live = m && g.dist * inv_dx < kcut;
        float graw, gc = band == 0 ? gca : gcb;
        if (band == 3)
          graw = g_grid[((long)r * n2p + (i - r_p)) * n2p + j];
        else
          graw = w1[(long)r * n1 + i] * gc;
        const float gv = live ? graw : 0.0f;
        const long pidx = (long)r * 3 * plane + (long)i * n2 + j;
        const float rad = gv * planes[pidx];
        const float c1 = gv * planes[pidx + plane];
        const float c2 = gv * planes[pidx + 2 * plane];
        const float f1 = c1 * g.inv, f2 = c2 * g.inv;
        const float gx = rad * g.ux + f1 * (xr[3] - g.cos1 * g.ux)
                         - f2 * (xc[3] + g.cos2 * g.ux);
        const float gy = rad * g.uy + f1 * (xr[4] - g.cos1 * g.uy)
                         - f2 * (xc[4] + g.cos2 * g.uy);
        const float gz = rad * g.uz + f1 * (xr[5] - g.cos1 * g.uz)
                         - f2 * (xc[5] + g.cos2 * g.uz);
        row[0] = -gx; row[1] = -gy; row[2] = -gz;
        row[3] = c1 * g.ux; row[4] = c1 * g.uy; row[5] = c1 * g.uz;
        if (band < 2 && live)
          row[6] = vcov[((long)r * r_e + i) * n2 + j] * gc;
        colacc[0] += gx; colacc[1] += gy; colacc[2] += gz;
        colacc[3] -= c2 * g.ux; colacc[4] -= c2 * g.uy; colacc[5] -= c2 * g.uz;
      } else if (m) {
        const float* pr = env_tab + ((long)row_type[i] * n_env_t2 + cte) * 4;
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

extern "C" int fused_pair_bwd(
    const float* x1, const float* w1, const float* x2, const float* wcol,
    const int* row_type, const int* col_type, const unsigned char* mask,
    const float* env_tab, const float* planes, const float* vcov,
    const float* g_cov, const float* g_grid, const float* g_env,
    int n_rep, int n1, int n2, int n2p, int r_b, int r_e, int r_p,
    int n_env_t2, float inv_dx, float kcut_cov, float kcut_pair,
    float* d1part, float* d2part, float* d1, float* d2, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  dim3 block(TILE_COLS, ROW_THREADS);
  dim3 grid_dim((n2 + TILE_COLS - 1) / TILE_COLS,
                (n1 + TILE_ROWS - 1) / TILE_ROWS, n_rep);
  fused_bwd_kernel<<<grid_dim, block, 0, stream>>>(
      x1, w1, x2, wcol, row_type, col_type, mask, env_tab, planes, vcov,
      g_cov, g_grid, g_env, n1, n2, n2p, r_b, r_e, r_p, n_env_t2, inv_dx,
      kcut_cov, kcut_pair, d1part, d2part, n_rep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_parts(d1part, (int)grid_dim.x, (long)n_rep * n1 * 8, d1, stream);
  sum_parts(d2part, (int)grid_dim.y, (long)n_rep * n2 * 8, d2, stream);
  return (int)cudaGetLastError();
}
