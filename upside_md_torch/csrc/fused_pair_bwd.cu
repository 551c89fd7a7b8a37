// The two backwards of the fused pair block:
//
// * K1 backward (`fused_pair_bwd`, `k1_bwd_row_tile_kernel`): cotangents
//   from the forward's residual.  Replaces upside_md_tpu/ops/
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
// What bounds them on an H100.  Only a few percent of the masked pairs
// are inside a cutoff (3.4% at no-env ubiquitin), and only those have a
// cotangent.  K1 backward reads the sites, the forward's compact residual
// of the live pairs (a 2-byte code and 16 bytes of derivatives and value
// each), the grid cotangent of the live bead pairs and the other
// cotangents, and does the geometry and a few multiply-adds per live pair;
// the TPU kernel reads dense planes over every pair (~4.3 MB per replica
// at ubiquitin shapes).  K3 reads no residual and recomputes each live
// pair's spline terms (~150 flops) from the coefficient table (~180 KB,
// shared by all replicas, in L2).  So neither is bound by the card's
// rates: what bounds them is the work spent on pairs without a
// cotangent and on lanes that idle beside a live one.
//
// K1 backward's design (walk_residual_tiles in pair_cull.cuh, with
// K1BwdPair below): the row-tile blocks of K3, but no boxes, no cull and
// no listing: a warp takes the column tiles of its row tile that the
// forward found live pairs in (its counts) and their residual entries in
// order, 32 at a time, one a lane, and recomputes only each pair's
// geometry.  Row tiles with env rows take every column tile, for the env
// rows' two compact sigmoids.
//
// K3's design (walk_row_tiles in pair_cull.cuh, with K3Pair below): a
// warp owns a 32-row tile of one replica (a block holds that row tile in
// four replicas), or shares it with three more while the row tiles alone
// would not fill the card.  It tests the row
// tile's box in this replica against every column tile's at the row
// tile's cutoff (env rows have no spline cutoff, so a row tile holding
// one is never culled) and walks the column tiles that are close enough,
// in order: the loop that stands for the TPU's sequential grid axis.  In
// a walked tile the static mask comes packed, one word per row, and a
// spline row whose word is 0 or whose site lies farther than its cutoff
// from the column tile's box is passed over; the other spline rows'
// masked-in pairs whose squared distance is below the squared cutoff with
// the cull's margin are listed, and the list is taken 32 pairs at a time,
// one a lane, so a live pair no longer idles 31 lanes.  Each listed pair
// takes the exact test of the TPU kernel and of the plain version, s =
// dist / dx < kcut, so the live pairs are the same.  The TPU kernel
// builds VMEM coefficient planes per tile through one-hot MXU matmuls
// because it cannot gather; here each live pair reads its 4 cubic
// coefficients per segment directly.
//
// Both: only live pairs read the grid cotangent.  A chunk's row
// cotangents are summed by a segmented shuffle scan (a row's lanes are
// contiguous in the row-major list) and its column cotangents added in
// list order (lanes that share a column take turns) to the warp's sums in
// shared memory; the env rows' are reduced over the tile's 32 columns,
// four rows at a time, by one fixed shuffle tree (`transpose_sum`).  The row
// sums are written once at the end, the group's warps' added in order (no
// row partials), and a tile's column sums are written as one partial when
// a pair added to them, which a second pass adds in row-tile order
// (sum_col_partials).  The cotangent is selected, never multiplied, by
// mask AND inside-cutoff, and so are the coverage weight cotangents and
// the env rows.  The TPU kernels take the weight cotangents unguarded
// (`val * gcs`, :1254-1257) and K3's env cotangent as a product with the
// mask (`genv * m * w`, :1182), so a non-finite cotangent at a dead slot
// gives NaN there and stays out here; a culled pair is never read.  No
// float atomics, so both kernels are bitwise repeatable.
#include "fused_pair.cuh"
#include "pair_cull.cuh"

// What K1 backward and K3 share: the env rows' cotangents, the spline
// pairs' from their derivatives, and where the row sums go.
struct FusedBwdCommon {
  const float* w1;
  const float* wcol;
  const int* row_type;
  const int* col_type;
  const float* env_tab;
  const float* g_cov;
  const float* g_grid;
  const float* g_env;
  float* d1;                // (n_rep, n1, 8)
  int n1, n2, n2p, r_b, r_e, r_p, n_env_t2;
  static constexpr bool kEnvCols = true;

  __device__ bool rows(int) const { return true; }
  __device__ bool cols(int) const { return true; }
  __device__ void keep(int, int, int, int, int, int, int,
                       const float*) const {}
  __device__ void tile_done(int, int, int, int) const {}

  __device__ void row_out(int r, int i, const float* s) const {
    store8<NCOMP>(s, d1 + ((long)r * n1 + i) * 8);
  }

  __device__ EnvRow env_row(int r, int i) const {
    return {row_type[i], g_env[(long)r * (r_p - r_e) + (i - r_e)]};
  }
  __device__ EnvCol env_col(int r, int j) const {
    return {col_type[2 * n2 + j], wcol[(long)r * n2 + j]};
  }

  // an env pair, masked in: er and ec its row's and column's types, the
  // row's cotangent and the column's weight
  __device__ void env(const float* xr, const float* xc, EnvRow er,
                      EnvCol ec, float* rc, float* cc) const {
    const PairGeom g = pair_geometry(xr, xc);
    const float* pr = env_tab + ((long)er.type * n_env_t2 + ec.type) * 4;
    float rad, drad, ang, dang;
    compact_sigmoid(g.dist - pr[0], pr[1], rad, drad);
    compact_sigmoid(pr[2] - g.cos1, pr[3], ang, dang);
    const float ge = er.g * ec.w;
    const float rr = ge * drad * ang;
    const float ce = -ge * rad * dang;
    const float fe = ce * g.inv;
    const float gx = rr * g.ux + fe * (xr[3] - g.cos1 * g.ux);
    const float gy = rr * g.uy + fe * (xr[4] - g.cos1 * g.uy);
    const float gz = rr * g.uz + fe * (xr[5] - g.cos1 * g.uz);
    rc[0] = -gx; rc[1] = -gy; rc[2] = -gz;
    rc[3] = ce * g.ux; rc[4] = ce * g.uy; rc[5] = ce * g.uz;
    cc[0] = gx; cc[1] = gy; cc[2] = gz;
    cc[6] = er.g * rad * ang;
  }

  // live spline pair (i, j) of band `band` with derivatives p0 (d/d
  // dist), p1 (d/d cos1), p2 (d/d cos2) and value val: its row and column
  // cotangents (the coverage weight's in rc[6])
  __device__ void spline(int r, int band, int i, int j, const PairGeom& g,
                         const float* xr, const float* xc, float p0,
                         float p1, float p2, float val, float* rc,
                         float* cc) const {
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
    if (band < 2) rc[6] = val * gc;
    cc[0] = gx; cc[1] = gy; cc[2] = gz;
    cc[3] = -(c2 * g.ux); cc[4] = -(c2 * g.uy); cc[5] = -(c2 * g.uz);
  }
};

// K1 backward's entry v = (d/d dist, d/d cos1, d/d cos2, value) of pair
// (i, j), live: its cotangents.
struct K1BwdPair : FusedBwdCommon {
  __device__ void resid(int r, int, int i, int j, const float* xr,
                        const float* xc, float4 v, float* rc,
                        float* cc) const {
    const int band = (i >= r_b) + (i >= r_e) + (i >= r_p);
    spline(r, band, i, j, pair_geometry(xr, xc), xr, xc, v.x, v.y, v.z, v.w,
           rc, cc);
  }
};

// K3's pair (i, j) of replica r: its row and column cotangents; false
// where it is not live (beyond its band's cutoff).
struct K3Pair : FusedBwdCommon {
  const float* coef;
  int ka, k, n_ctype, ncoef;
  float inv_dx, kcut_cov, kcut_pair;

  __device__ bool operator()(int r, int, int i, int j, const float* xr,
                             const float* xc, float* rc, float* cc,
                             float*) const {
    const int band = (i >= r_b) + (i >= r_e) + (i >= r_p);
    const PairGeom g = pair_geometry(xr, xc);
    const float sd = __fmul_rn(g.dist, inv_dx);
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
    spline(r, band, i, j, g, xr, xc, (dwide + a1 * a2 * dnar) * inv_dx,
           da1 * inv_dth * a2 * nar, da2 * inv_dth * a1 * nar,
           wide + a1 * a2 * nar, rc, cc);
    return true;
  }
};

// K3's candidate test of a row's spline band (squared Angstrom)
struct K3RowThr {
  int r_p;
  float cut2_cov, cut2_pair;
  __device__ float operator()(int i) const {
    return i >= r_p ? cut2_pair : cut2_cov;
  }
};

// K1 backward (walk_residual_tiles, pair_cull.cuh, with K1BwdPair):
// counts, codes, vals the forward's residual; mask_words the static mask
// (read for the env rows only).
static __global__ void __launch_bounds__(TILE_COLS * RT_WARPS)
k1_bwd_row_tile_kernel(const float* __restrict__ x1,
                       const float* __restrict__ x2,
                       const unsigned* __restrict__ mask_words,
                       const short* __restrict__ counts,
                       const unsigned short* __restrict__ codes,
                       const float4* __restrict__ vals, int n_rep,
                       int group, K1BwdPair pair,
                       float* __restrict__ d2part,
                       unsigned char* __restrict__ flags) {
  walk_residual_tiles(x1, x2, mask_words, counts, codes, vals, n_rep,
                      pair.n1, pair.n2, pair.r_e, pair.r_p, group, pair,
                      d2part, flags);
}

// K3 (walk_row_tiles, pair_cull.cuh, with K3Pair).  mask_words (n1,
// n_ct): the static mask, bit l of word (i, ct) for pair (i, 32 ct + l).
// tile_thr (n_rt,): each row tile's squared cull threshold
// (ops/tile_cull.py); cut2_cov, cut2_pair: the per-pair candidate
// thresholds of the coverage and pair bands.  Capped at 80 registers (6
// blocks an SM) it ran 7-10% faster on an H100 with the env band than
// uncapped (tools/time_torch_bp.py --fused, PERF.md section 6); K1's
// backward did not, and is left uncapped.
static __global__ void __launch_bounds__(TILE_COLS * RT_WARPS, 6)
k3_row_tile_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                   const unsigned* __restrict__ mask_words,
                   const float* __restrict__ tile_thr, int n_rep,
                   float cut2_cov, float cut2_pair, int group, K3Pair pair,
                   float* __restrict__ d2part,
                   unsigned char* __restrict__ flags) {
  walk_row_tiles<NCOMP, NCOMP>(
      x1, x2, mask_words, nullptr, tile_thr, 0.0f, n_rep, pair.n1, pair.n2,
      pair.r_e, pair.r_p, group, K3RowThr{pair.r_p, cut2_cov, cut2_pair},
      pair, d2part, flags, nullptr);
}

// K1 backward.  counts (n_rep, n_rt, n_ct), codes and vals (n_rep, n_rt,
// n_ct, RESID_SLOTS): the forward's residual.  d2part (n_rep, n_rt, n2, 8)
// holds the column partials of the tiles a pair added to, flags (n_rep,
// n_rt, n_ct) which tiles those are; both are written here, never read
// before.
extern "C" int fused_pair_bwd(
    const float* x1, const float* w1, const float* x2, const float* wcol,
    const int* row_type, const int* col_type, const unsigned* mask_words,
    const float* env_tab, const short* counts, const unsigned short* codes,
    const float* vals, const float* g_cov, const float* g_grid,
    const float* g_env, int n_rep, int n1, int n2, int n2p, int r_b,
    int r_e, int r_p, int n_env_t2, float* d2part, unsigned char* flags,
    float* d1, float* d2, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_rt = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  if (n_rep > 0 && n_rt > 0) {
    K1BwdPair pair;
    static_cast<FusedBwdCommon&>(pair) = FusedBwdCommon{
        w1, wcol, row_type, col_type, env_tab, g_cov, g_grid, g_env, d1, n1,
        n2, n2p, r_b, r_e, r_p, n_env_t2};
    int group;
    const dim3 blocks = row_tile_blocks(n_rep, n_rt, &group);
    k1_bwd_row_tile_kernel<<<blocks, dim3(TILE_COLS, RT_WARPS),
                             n_ct * RT_WARPS * sizeof(int), stream>>>(
        x1, x2, mask_words, counts, codes,
        reinterpret_cast<const float4*>(vals), n_rep, group, pair, d2part,
        flags);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_col_partials<8>(d2part, flags, n_rep, n_rt, n_ct, n2, d2, stream);
  return (int)cudaGetLastError();
}

// K3.  d2part (n_rep, n_rt, n2, 8) holds the column partials of the walked
// tiles a pair added to, flags (n_rep, n_rt, n_ct) the cull's decisions
// (CULL_KEPT, CULL_WRITTEN); both are written here, never read before.
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
    K3Pair pair;
    static_cast<FusedBwdCommon&>(pair) = FusedBwdCommon{
        w1, wcol, row_type, col_type, env_tab, g_cov, g_grid, g_env, d1, n1,
        n2, n2p, r_b, r_e, r_p, n_env_t2};
    pair.coef = coef;
    pair.ka = ka;
    pair.k = k;
    pair.n_ctype = n_ctype;
    pair.ncoef = ncoef;
    pair.inv_dx = inv_dx;
    pair.kcut_cov = kcut_cov;
    pair.kcut_pair = kcut_pair;
    int group;
    const dim3 blocks = row_tile_blocks(n_rep, n_rt, &group);
    k3_row_tile_kernel<<<blocks, dim3(TILE_COLS, RT_WARPS), walk_smem(n2),
                         stream>>>(x1, x2, mask_words, tile_thr, n_rep,
                                   cut2_cov, cut2_pair, group, pair, d2part,
                                   flags);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_col_partials<8>(d2part, flags, n_rep, n_rt, n_ct, n2, d2, stream);
  return (int)cudaGetLastError();
}
