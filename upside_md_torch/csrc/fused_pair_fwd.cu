// K1 forward: the fused pair block (hbond coverage, hydrophobe coverage,
// environment coverage and the rotamer bead-pair grid in one pass).
//
// Replaces: upside_md_tpu/ops/pallas_quadspline.py `_fused_fwd_kernel`
// (:1021), launched by `_fused_fwd_batched` (:1581) for
// `fused_pair_block_env_prep` (:2403) with want_planes, and for
// `fused_pair_block` (:1899, no env band, ITE < 0) and
// `fused_pair_block_env` (:2135) without them.  Null `planes`/`vcov` is
// the variant without residual planes; r_e == r_p is the block without
// its env band.
//
// What bounds it on an H100: with planes, device-memory writes.  Per
// replica it writes the three derivative planes over all rows x bead
// columns, the coverage value plane and the pair grid (about 4.5 MB at
// ubiquitin shapes, 149 + 228 + 76 + 374 rows by 374 columns), against
// ~100 flops per pair.  Without planes it writes the grid and the sums
// only (~0.6 MB) and the ~100 flops per pair bound it.  The coefficient
// table (~180 KB) and the mask are shared by all replicas and stay in L2.
//
// Design: one thread per (row, bead column) pair; a block is a 32-column
// by 32-row tile (32 x 8 threads, each thread walks 4 rows), the replica
// is grid z.  The TPU kernel's one-hot MXU table lookups, bf16 hi/lo
// split and VMEM coefficient scratch exist because gathers are slow on
// that chip; here each pair reads its 4 cubic coefficients per segment
// directly from the per-(row type, column type) table built once per
// advance, and runs Horner.  Reductions are deterministic: column sums
// (the two coverages) go to per-row-tile partials through shared memory,
// env row sums to per-column-tile partials through a fixed warp tree, and
// a second pass sums the partials in order.  No float atomics.
#include "fused_pair.cuh"

static __global__ void __launch_bounds__(TILE_COLS * ROW_THREADS)
fused_fwd_kernel(const float* __restrict__ x1, const float* __restrict__ w1,
                 const float* __restrict__ x2, const float* __restrict__ wcol,
                 const int* __restrict__ row_type,
                 const int* __restrict__ col_type,
                 const unsigned char* __restrict__ mask,
                 const float* __restrict__ coef,
                 const float* __restrict__ env_tab,
                 int n1, int n2, int n2p, int r_b, int r_e, int r_p,
                 int ka, int k, int n_ct, int ncoef, int n_env_t2,
                 float inv_dx, float kcut_cov, float kcut_pair,
                 float* __restrict__ planes, float* __restrict__ vcov,
                 float* __restrict__ grid, float* __restrict__ colpart,
                 float* __restrict__ rowpart, int n_rep) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * TILE_COLS + tx;
  const int rt = blockIdx.y;
  const int r = blockIdx.z;
  const bool jv = j < n2;
  const int n_e = r_p - r_e;
  const int na = (ka - 3) * 4, nd = (k - 3) * 4;
  const float inv_dth = (ka - 3) * 0.5f;

  float xc[6] = {0, 0, 0, 0, 0, 0};
  float wc = 0.0f;
  int ct[4] = {0, 0, 0, 0};
  if (jv) {
    for (int c = 0; c < 6; ++c) xc[c] = x2[((long)r * n2 + j) * 6 + c];
    wc = wcol[(long)r * n2 + j];
    for (int b = 0; b < 4; ++b) ct[b] = col_type[b * n2 + j];
  }
  float acc_a = 0.0f, acc_b = 0.0f;     // coverage column partials
  const long plane = (long)n1 * n2;

  for (int s = 0; s < TILE_ROWS / ROW_THREADS; ++s) {
    const int i = rt * TILE_ROWS + s * ROW_THREADS + ty;   // warp-uniform
    if (i >= n1) break;
    const int band = (i >= r_b) + (i >= r_e) + (i >= r_p);
    float xr[6];
    for (int c = 0; c < 6; ++c) xr[c] = x1[((long)r * n1 + i) * 6 + c];
    const long pidx = (long)r * 3 * plane + (long)i * n2 + j;
    if (band != 2) {
      float val = 0.0f, p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
      if (jv) {
        PairGeom g = pair_geometry(xr, xc);
        const float* cf = coef + ((long)row_type[i] * n_ct + ct[band]) * ncoef;
        float a1, da1, a2, da2, wide, dwide, nar, dnar;
        poly_eval(cf, (g.cos1 + 1.0f) * inv_dth + 1.0f, ka, false, a1, da1);
        poly_eval(cf + na, (g.cos2 + 1.0f) * inv_dth + 1.0f, ka, false, a2,
                  da2);
        const float sd = g.dist * inv_dx;
        poly_eval(cf + 2 * na, sd, k, true, wide, dwide);
        poly_eval(cf + 2 * na + nd, sd, k, true, nar, dnar);
        const float kcut = band == 3 ? kcut_pair : kcut_cov;
        if (mask[(long)i * n2 + j] && sd < kcut) {
          val = wide + a1 * a2 * nar;
          p0 = (dwide + a1 * a2 * dnar) * inv_dx;
          p1 = da1 * inv_dth * a2 * nar;
          p2 = da2 * inv_dth * a1 * nar;
        }
        if (planes) {
          planes[pidx] = p0;
          planes[pidx + plane] = p1;
          planes[pidx + 2 * plane] = p2;
        }
        if (band < 2) {
          if (vcov) vcov[((long)r * r_e + i) * n2 + j] = val;
          const float w = w1[(long)r * n1 + i];
          if (band == 0) acc_a += w * val; else acc_b += w * val;
        } else {
          grid[((long)r * n2p + (i - r_p)) * n2p + j] = val;
        }
      }
    } else {
      float ev = 0.0f;
      if (jv) {
        if (planes) {
          planes[pidx] = 0.0f;
          planes[pidx + plane] = 0.0f;
          planes[pidx + 2 * plane] = 0.0f;
        }
        if (mask[(long)i * n2 + j]) {
          PairGeom g = pair_geometry(xr, xc);
          const float* pr = env_tab + ((long)row_type[i] * n_env_t2 + ct[2]) * 4;
          float rad, drad, ang, dang;
          compact_sigmoid(g.dist - pr[0], pr[1], rad, drad);
          compact_sigmoid(pr[2] - g.cos1, pr[3], ang, dang);
          ev = wc * rad * ang;
        }
      }
      ev = warp_sum(ev);
      if (tx == 0)
        rowpart[((long)blockIdx.x * n_rep + r) * n_e + (i - r_e)] = ev;
    }
  }

  // column partials of the two coverage bands over this row tile
  __shared__ float sa[ROW_THREADS][TILE_COLS], sb[ROW_THREADS][TILE_COLS];
  sa[ty][tx] = acc_a;
  sb[ty][tx] = acc_b;
  __syncthreads();
  const int n_rt_cov = (r_e + TILE_ROWS - 1) / TILE_ROWS;
  if (ty == 0 && jv && rt < n_rt_cov) {
    float ta = 0.0f, tb = 0.0f;
    for (int y = 0; y < ROW_THREADS; ++y) { ta += sa[y][tx]; tb += sb[y][tx]; }
    colpart[(((long)rt * n_rep + r) * 2 + 0) * n2 + j] = ta;
    colpart[(((long)rt * n_rep + r) * 2 + 1) * n2 + j] = tb;
  }
}

extern "C" int fused_pair_fwd(
    const float* x1, const float* w1, const float* x2, const float* wcol,
    const int* row_type, const int* col_type, const unsigned char* mask,
    const float* coef, const float* env_tab,
    int n_rep, int n1, int n2, int n2p, int r_b, int r_e, int r_p,
    int ka, int k, int n_ct, int ncoef, int n_env_t2,
    float inv_dx, float kcut_cov, float kcut_pair,
    float* planes, float* vcov, float* grid, float* colpart, float* rowpart,
    float* cov, float* env, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  dim3 block(TILE_COLS, ROW_THREADS);
  dim3 grid_dim((n2 + TILE_COLS - 1) / TILE_COLS,
                (n1 + TILE_ROWS - 1) / TILE_ROWS, n_rep);
  fused_fwd_kernel<<<grid_dim, block, 0, stream>>>(
      x1, w1, x2, wcol, row_type, col_type, mask, coef, env_tab, n1, n2, n2p,
      r_b, r_e, r_p, ka, k, n_ct, ncoef, n_env_t2, inv_dx, kcut_cov,
      kcut_pair, planes, vcov, grid, colpart, rowpart, n_rep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_rt_cov = (r_e + TILE_ROWS - 1) / TILE_ROWS;
  sum_parts(colpart, n_rt_cov, (long)n_rep * 2 * n2, cov, stream);
  sum_parts(rowpart, (int)grid_dim.x, (long)n_rep * (r_p - r_e), env, stream);
  return (int)cudaGetLastError();
}
