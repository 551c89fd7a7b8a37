// The two backwards of the fused pair block:
//
// * K1 backward (`fused_pair_bwd`, `fused_bwd_kernel`): cotangents from
//   the forward's residual planes.  Replaces upside_md_tpu/ops/
//   pallas_quadspline.py `_fused_bwd_resid_kernel` (:1276), launched by
//   `_fused_bwd_batched` (:1678, `planes` branch :1712-1759) for the VJP
//   of `fused_pair_block_env_prep` (:2426).
// * K3 (`fused_pair_bwd_recompute`, `k3_row_tile_kernel`): the
//   recomputing backward.  Replaces `_fused_bwd_kernel` (:1132), launched
//   by `_fused_bwd_batched` (:1760-1810) for the VJPs of
//   `fused_pair_block` (no env band, :1926) and of `fused_pair_block_env`
//   under UPSIDE_FUSED_RESID=0 (:2186).  r_e == r_p is the block without
//   its env band.
//
// What bounds them on an H100.  K1 backward: device-memory reads of the
// three derivative planes, the coverage value plane and the pair-grid
// cotangent (about the bytes the forward wrote, ~4.5 MB per replica at
// ubiquitin shapes), plus the per-tile partial sums; the arithmetic is
// geometry and a few multiply-adds per pair.  K3 reads only the sites, the
// cotangents (the pair-grid cotangent of the live pairs is the bulk) and
// the coefficient table (~180 KB, shared by all replicas, in L2), and
// recomputes each live pair's spline terms (~150 flops).  Only a few
// percent of the masked pairs are inside a cutoff (3.4% at no-env
// ubiquitin), and a row of 32 columns holds few of them, so what
// bounds K3 is the work spent on the dead pairs and on lanes that idle
// beside a live one: a thread per pair slot, as K1 backward has it, pays
// the distance test, the geometry and the row reduction of every slot.
//
// K1 backward's design: the forward's tiling (one thread per pair, 32x32
// tiles, replica in grid z); it recomputes only each pair's geometry and
// reads the spline derivatives from the planes.  Row gradients (over
// columns) reduce through a fixed warp tree into per-column-tile
// partials, column gradients (over rows) through shared memory into
// per-row-tile partials; a second pass sums the partials in order.
//
// K3's design (walk_row_tiles in pair_cull.cuh, with K3Pair below): a
// warp owns a 32-row tile of one replica, or shares it with three more
// while the row tiles alone would not fill the card.  It tests the row
// tile's box in this replica against every column tile's at the row
// tile's cutoff (env rows have no spline cutoff, so a row tile holding
// one is never culled) and walks the column tiles that are close enough,
// in order: the loop that stands for the TPU's sequential grid axis.  In
// a walked tile the static mask comes packed, one word per row, and a row
// whose word is 0 or whose site lies farther than its cutoff from the
// column tile's box is passed over; the other rows' masked-in pairs whose
// squared distance is below the squared cutoff with the cull's margin
// are listed, and the list is taken 32 pairs at a time, one a lane, so a
// live pair no longer idles 31 lanes.  Each listed pair takes the exact
// test of the TPU kernel and of the plain version, s = dist / dx < kcut,
// so the live pairs are the same.  Only live pairs read the grid
// cotangent.  A chunk's row and column cotangents are added in list order
// to the warp's sums in shared memory (lanes that share a row or a column
// take turns); the row sums are written once at the end, the group's
// warps' added in order (no row partials), and a walked tile's column
// sums are written as one partial when it held a listed pair, which a
// second pass adds in row-tile order (sum_col_partials).  The TPU kernel
// builds VMEM coefficient planes per tile through one-hot MXU matmuls
// because it cannot gather; here each live pair reads its 4 cubic
// coefficients per segment directly.  The cotangent is selected, never
// multiplied, by mask AND inside-cutoff, and so are the coverage weight
// cotangents and the env rows.  The TPU kernels take the weight cotangents
// unguarded (`val * gcs`, :1254-1257) and K3's env cotangent as a product
// with the mask (`genv * m * w`, :1182), so a non-finite cotangent at a
// dead slot gives NaN there and stays out here; a culled pair is never
// read.  The env band recomputes its two compact sigmoids.  No float
// atomics, so both kernels are bitwise repeatable.
#include "fused_pair.cuh"
#include "pair_cull.cuh"


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
        float val = 0.0f;
        const long pidx = (long)r * 3 * plane + (long)i * n2 + j;
        const float p0 = planes[pidx];
        const float p1 = planes[pidx + plane];
        const float p2 = planes[pidx + 2 * plane];
        if (band < 2 && live) val = vcov[((long)r * r_e + i) * n2 + j];
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

// K3's row threshold: the candidate test of a row's band (env rows:
// every masked-in pair).
struct K3RowThr {
  int r_e, r_p;
  float cut2_cov, cut2_pair;
  __device__ float operator()(int i) const {
    return i >= r_p ? cut2_pair
           : i >= r_e ? __int_as_float(0x7f800000) : cut2_cov;
  }
};

// K3's pair (i, j) of replica r: its row and column cotangents; false
// where it is not live (a spline-band pair beyond its cutoff).
struct K3Pair {
  const float* w1;
  const float* wcol;
  const int* row_type;
  const int* col_type;
  const float* coef;
  const float* env_tab;
  const float* g_cov;
  const float* g_grid;
  const float* g_env;
  int n1, n2, n2p, r_b, r_e, r_p, ka, k, n_ctype, ncoef, n_env_t2;
  float inv_dx, kcut_cov, kcut_pair;

  __device__ bool operator()(int r, int ii, int i, int j, const float* xr,
                             const float* xc, float* rc, float* cc) const {
    const int band = (i >= r_b) + (i >= r_e) + (i >= r_p);
    const PairGeom g = pair_geometry(xr, xc);
    if (band == 2) {                                  // env band, masked in
      const int n_e = r_p - r_e;
      const float* pr = env_tab
          + ((long)row_type[i] * n_env_t2 + col_type[2 * n2 + j]) * 4;
      float rad, drad, ang, dang;
      compact_sigmoid(g.dist - pr[0], pr[1], rad, drad);
      compact_sigmoid(pr[2] - g.cos1, pr[3], ang, dang);
      const float ge_row = g_env[(long)r * n_e + (i - r_e)];
      const float ge = ge_row * wcol[(long)r * n2 + j];
      const float rr = ge * drad * ang;
      const float ce = -ge * rad * dang;
      const float fe = ce * g.inv;
      const float gx = rr * g.ux + fe * (xr[3] - g.cos1 * g.ux);
      const float gy = rr * g.uy + fe * (xr[4] - g.cos1 * g.uy);
      const float gz = rr * g.uz + fe * (xr[5] - g.cos1 * g.uz);
      rc[0] = -gx; rc[1] = -gy; rc[2] = -gz;
      rc[3] = ce * g.ux; rc[4] = ce * g.uy; rc[5] = ce * g.uz;
      cc[0] = gx; cc[1] = gy; cc[2] = gz;
      cc[6] = ge_row * rad * ang;
      return true;
    }
    const float sd = g.dist * inv_dx;
    if (!(sd < (band == 3 ? kcut_pair : kcut_cov))) return false;
    const int na = (ka - 3) * 4, nd = (k - 3) * 4;
    const float inv_dth = (ka - 3) * 0.5f;
    const float* cf = coef
        + ((long)row_type[i] * n_ctype + col_type[band * n2 + j]) * ncoef;
    float a1, da1, a2, da2, wide, dwide, nar, dnar;
    poly_eval(cf, (g.cos1 + 1.0f) * inv_dth + 1.0f, ka, false, a1, da1);
    poly_eval(cf + na, (g.cos2 + 1.0f) * inv_dth + 1.0f, ka, false, a2, da2);
    poly_eval(cf + 2 * na, sd, k, true, wide, dwide);
    poly_eval(cf + 2 * na + nd, sd, k, true, nar, dnar);
    const float p0 = (dwide + a1 * a2 * dnar) * inv_dx;
    const float p1 = da1 * inv_dth * a2 * nar;
    const float p2 = da2 * inv_dth * a1 * nar;
    float gv, gc = 0.0f;
    if (band == 3) {
      gv = g_grid[((long)r * n2p + (i - r_p)) * n2p + j];
    } else {
      gc = g_cov[((long)r * 2 + band) * n2 + j];
      gv = w1[(long)r * n1 + i] * gc;
    }
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
    rc[0] = -gx; rc[1] = -gy; rc[2] = -gz;
    rc[3] = c1 * g.ux; rc[4] = c1 * g.uy; rc[5] = c1 * g.uz;
    if (band < 2) rc[6] = (wide + a1 * a2 * nar) * gc;
    cc[0] = gx; cc[1] = gy; cc[2] = gz;
    cc[3] = -(c2 * g.ux); cc[4] = -(c2 * g.uy); cc[5] = -(c2 * g.uz);
    return true;
  }
};

// K3 (walk_row_tiles, pair_cull.cuh, with K3Pair).  mask_words (n1,
// n_ct): the static mask, bit l of word (i, ct) for pair (i, 32 ct + l).
// tile_thr (n_rt,): each row tile's squared cull threshold
// (ops/tile_cull.py); cut2_cov, cut2_pair: the per-pair candidate
// thresholds of the coverage and pair bands.
static __global__ void __launch_bounds__(TILE_COLS * RT_WARPS)
k3_row_tile_kernel(const float* __restrict__ x1, const float* __restrict__ w1,
                   const float* __restrict__ x2,
                   const float* __restrict__ wcol,
                   const int* __restrict__ row_type,
                   const int* __restrict__ col_type,
                   const unsigned* __restrict__ mask_words,
                   const float* __restrict__ coef,
                   const float* __restrict__ env_tab,
                   const float* __restrict__ g_cov,
                   const float* __restrict__ g_grid,
                   const float* __restrict__ g_env,
                   const float* __restrict__ tile_thr,
                   int n1, int n2, int n2p, int r_b, int r_e, int r_p,
                   int ka, int k, int n_ctype, int ncoef, int n_env_t2,
                   float inv_dx, float kcut_cov, float kcut_pair,
                   float cut2_cov, float cut2_pair, int group,
                   float* __restrict__ d1, float* __restrict__ d2part,
                   unsigned char* __restrict__ flags) {
  const K3RowThr row_thr{r_e, r_p, cut2_cov, cut2_pair};
  const K3Pair pair{w1, wcol, row_type, col_type, coef, env_tab, g_cov,
                    g_grid, g_env, n1, n2, n2p, r_b, r_e, r_p, ka, k,
                    n_ctype, ncoef, n_env_t2, inv_dx, kcut_cov, kcut_pair};
  walk_row_tiles(x1, x2, mask_words, nullptr, tile_thr, 0.0f, n1, n2, group,
                 row_thr, pair, d1, d2part, flags);
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

// K3.  d2part (n_rep, n_rt, n2, 8) holds the column partials of the walked
// tiles with a candidate pair, flags (n_rep, n_rt, n_ct) the cull's
// decisions (CULL_KEPT, CULL_WRITTEN); both are written here, never read
// before.
extern "C" int fused_pair_bwd_recompute(
    const float* x1, const float* w1, const float* x2, const float* wcol,
    const int* row_type, const int* col_type, const unsigned* mask_words,
    const float* coef, const float* env_tab, const float* g_cov,
    const float* g_grid, const float* g_env, const float* tile_thr,
    int n_rep, int n1, int n2, int n2p, int r_b, int r_e, int r_p, int ka,
    int k, int n_ctype, int ncoef, int n_env_t2, float inv_dx,
    float kcut_cov, float kcut_pair, float cut2_cov, float cut2_pair,
    float* d2part, unsigned char* flags, float* d1, float* d2,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_rt = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  if (n_rep > 0 && n_rt > 0) {
    const int group = row_tile_group((long)n_rt * n_rep);
    const int per_block = RT_WARPS / group;
    k3_row_tile_kernel<<<dim3((n_rt + per_block - 1) / per_block, n_rep),
                         dim3(TILE_COLS, RT_WARPS),
                         n_ct * (6 * sizeof(float) + RT_WARPS * sizeof(int)),
                         stream>>>(
        x1, w1, x2, wcol, row_type, col_type, mask_words, coef, env_tab, g_cov,
        g_grid, g_env, tile_thr, n1, n2, n2p, r_b, r_e, r_p, ka, k, n_ctype,
        ncoef, n_env_t2, inv_dx, kcut_cov, kcut_pair, cut2_cov, cut2_pair,
        group, d1, d2part, flags);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_col_partials(d2part, flags, n_rep, n_rt, n_ct, n2, d2, stream);
  return (int)cudaGetLastError();
}
