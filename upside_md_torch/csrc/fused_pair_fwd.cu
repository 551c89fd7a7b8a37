// K1 forward: the fused pair block (hbond coverage, hydrophobe coverage,
// environment coverage and the rotamer bead-pair grid in one pass).
//
// Replaces: upside_md_tpu/ops/pallas_quadspline.py `_fused_fwd_kernel`
// (:1021), launched by `_fused_fwd_batched` (:1581) for
// `fused_pair_block_env_prep` (:2403) with want_planes, and for
// `fused_pair_block` (:1899, no env band, ITE < 0) and
// `fused_pair_block_env` (:2135) without them.  Null residual pointers are
// the variant without residuals; r_e == r_p is the block without its env
// band.
//
// What bounds it on an H100.  The TPU kernel writes its residual as dense
// planes (three derivative planes over all rows x bead columns and the
// coverage value plane, ~4.3 MB per replica at ubiquitin shapes, 147 +
// 228 + 76 + 374 rows by 374 columns), almost all zeros: only a few
// percent of the masked pairs lie inside a cutoff.  What the function
// must move is the pair grid (0.59 MB per replica, written once), the
// sums, and the live pairs' residual; its work is the spline of the live
// pairs (~110 flops) and the env pairs' two compact sigmoids.  So what
// bounds it is the work spent on dead pairs and the bytes of zeros.
//
// Design: the row-tile walk with the per-replica cull of K3
// (walk_row_tiles in pair_cull.cuh, with K1FwdPair below): a warp owns a
// 32-row tile of one replica (a block holds that row tile in four
// replicas; while the row tiles would not fill the card, four warps share
// one), skips the column tiles whose box lies beyond its row tile's
// cutoff (the decisions of `cull_tiles`, bit for bit), and in a walked
// tile lists the spline rows' candidate pairs and takes them 32 at a
// time, one a lane.  Each candidate takes the exact
// test s = dist / dx < kcut of the plain version; only a live pair
// evaluates the four cubic pieces (4 coefficients per segment, read from
// the per-(row type, column type) table built once per advance; the TPU
// kernel's one-hot MXU lookups and bf16 hi/lo split do not exist here).
// A live pair of the bead band writes its E_pair entry (one writer each;
// the grid is zeroed once, by a memset, before the walk); one of a
// coverage band adds w * value to its column's sum, in list order, and a
// tile's column sums become one partial when such a pair was live, which
// a second pass adds in row-tile order.  Env rows have no cutoff: four at
// a time, each is reduced over a column tile by a fixed warp tree into its
// row sum, the tiles in the warp's order (no row-partial pass).  The residual is
// compact: for each (replica, row tile, column tile) the count of its
// live pairs, and for each live pair, in list order, its code (row * 32 +
// column in the tile) and (d/d dist, d/d cos1, d/d cos2, coverage value)
// in the tile's fixed region of 1024 slots, one lane a slot.  No float
// atomics: the results are bitwise repeatable.
#include "fused_pair.cuh"
#include "pair_cull.cuh"

// the candidate test of a row's spline band (squared Angstrom)
struct BandThr {
  int r_p;
  float cut2_cov, cut2_pair;
  __device__ float operator()(int i) const {
    return i >= r_p ? cut2_pair : cut2_cov;
  }
};

// K1 forward's pair (i, j) of replica r.  A spline pair: live when s <
// kcut of its band; then res = (d/d dist, d/d cos1, d/d cos2, value) and,
// on a coverage band, cc[band] = w1[i] * value.  An env pair (masked in):
// rc[0] = wcol[j] csig(r - r0) csig(dot0 - cos1), its types and wcol[j]
// from env_row and env_col.
struct K1FwdPair {
  const float* w1;
  const float* wcol;
  const int* row_type;
  const int* col_type;
  const float* coef;
  const float* env_tab;
  float* grid;              // (n_rep, n2p, n2p), zeroed
  float* env_out;           // (n_rep, n_e)
  short* counts;            // (n_rep, n_rt, n_ct), or null: no residual
  unsigned short* codes;    // (n_rep, n_rt, n_ct, RESID_SLOTS)
  float4* vals;             // (n_rep, n_rt, n_ct, RESID_SLOTS)
  int n1, n2, n2p, r_b, r_e, r_p, ka, k, n_ctype, ncoef, n_env_t2, n_rt,
      n_ct;
  float inv_dx, kcut_cov, kcut_pair;
  static constexpr bool kEnvCols = false;

  __device__ bool rows(int) const { return false; }
  __device__ bool cols(int i) const { return i < r_e; }

  __device__ bool operator()(int r, int, int i, int j, const float* xr,
                             const float* xc, float*, float* cc,
                             float* res) const {
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
    const float val = wide + a1 * a2 * nar;
    res[0] = (dwide + a1 * a2 * dnar) * inv_dx;
    res[1] = da1 * inv_dth * a2 * nar;
    res[2] = da2 * inv_dth * a1 * nar;
    res[3] = val;
    if (band < 2) cc[band] = w1[(long)r * n1 + i] * val;
    return true;
  }

  // a live pair: its E_pair entry, and its slot of the tile's residual
  // (the value only on the coverage bands, as the plain vcov holds it)
  __device__ void keep(int r, int rt, int ct, int slot, int code, int i,
                       int j, const float* res) const {
    if (i >= r_p) grid[((long)r * n2p + (i - r_p)) * n2p + j] = res[3];
    if (counts == nullptr) return;
    const long s = (((long)r * n_rt + rt) * n_ct + ct) * RESID_SLOTS + slot;
    codes[s] = (unsigned short)code;
    vals[s] = make_float4(res[0], res[1], res[2], i < r_e ? res[3] : 0.0f);
  }

  __device__ EnvRow env_row(int, int i) const { return {row_type[i], 0.0f}; }
  __device__ EnvCol env_col(int r, int j) const {
    return {col_type[2 * n2 + j], wcol[(long)r * n2 + j]};
  }

  __device__ void env(const float* xr, const float* xc, EnvRow er,
                      EnvCol ec, float* rc, float*) const {
    const PairGeom g = pair_geometry(xr, xc);
    const float* pr = env_tab + ((long)er.type * n_env_t2 + ec.type) * 4;
    float rad, drad, ang, dang;
    compact_sigmoid(g.dist - pr[0], pr[1], rad, drad);
    compact_sigmoid(pr[2] - g.cos1, pr[3], ang, dang);
    rc[0] = ec.w * rad * ang;
  }

  __device__ void tile_done(int r, int rt, int ct, int n_live) const {
    if (counts != nullptr)
      counts[((long)r * n_rt + rt) * n_ct + ct] = (short)n_live;
  }

  __device__ void row_out(int r, int i, const float* s) const {
    if (i >= r_e && i < r_p)
      env_out[(long)r * (r_p - r_e) + (i - r_e)] = s[0];
  }
};

// mask_words (n1, n_ct): the static mask, bit l of word (i, ct) for pair
// (i, 32 ct + l); tile_thr (n_rt,): each row tile's squared cull threshold
// (ops/tile_cull.py); cut2_cov, cut2_pair: the per-pair candidate
// thresholds of the coverage and pair bands.  The walk waits on loads
// more than it computes: capped at 64 registers (8 blocks an SM) it ran
// 5-11% faster on an H100 than at the 96-119 it takes uncapped, spills
// included (tools/time_torch_bp.py --fused, PERF.md section 6).
static __global__ void __launch_bounds__(TILE_COLS * RT_WARPS, 8)
k1_fwd_row_tile_kernel(const float* __restrict__ x1,
                       const float* __restrict__ x2,
                       const unsigned* __restrict__ mask_words,
                       const float* __restrict__ tile_thr, int n_rep,
                       int env_lo, int env_hi, float cut2_cov,
                       float cut2_pair, int group, K1FwdPair pair,
                       float* __restrict__ colpart,
                       unsigned char* __restrict__ flags) {
  walk_row_tiles<1, 2>(x1, x2, mask_words, nullptr, tile_thr, 0.0f, n_rep,
                       pair.n1, pair.n2, env_lo, env_hi, group,
                       BandThr{pair.r_p, cut2_cov, cut2_pair}, pair, colpart,
                       flags, pair.counts);
}

// colpart (n_rep, n_rt, n2, 2) holds the coverage column partials of the
// walked tiles with a live coverage pair, flags (n_rep, n_rt, n_ct) the
// cull's decisions (CULL_KEPT, CULL_WRITTEN); counts, codes and vals the
// residual (all three null: none).  All are written here, never read
// before; so are grid (zeroed here), cov and env.
extern "C" int fused_pair_fwd(
    const float* x1, const float* w1, const float* x2, const float* wcol,
    const int* row_type, const int* col_type, const unsigned* mask_words,
    const float* coef, const float* env_tab, const float* tile_thr,
    int n_rep, int n1, int n2, int n2p, int r_b, int r_e, int r_p, int ka,
    int k, int n_ctype, int ncoef, int n_env_t2, float inv_dx,
    float kcut_cov, float kcut_pair, float cut2_cov, float cut2_pair,
    unsigned char* flags, short* counts, unsigned short* codes, float* vals,
    float* colpart, float* grid, float* cov, float* env, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_rt = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  cudaError_t err = cudaMemsetAsync(
      grid, 0, (size_t)n_rep * n2p * n2p * sizeof(float), stream);
  if (err != cudaSuccess) return (int)err;
  if (n_rep > 0 && n_rt > 0) {
    const K1FwdPair pair{w1, wcol, row_type, col_type, coef, env_tab, grid,
                         env, counts, codes,
                         reinterpret_cast<float4*>(vals), n1, n2, n2p, r_b,
                         r_e, r_p, ka, k, n_ctype, ncoef, n_env_t2, n_rt,
                         n_ct, inv_dx, kcut_cov, kcut_pair};
    int group;
    const dim3 blocks = row_tile_blocks(n_rep, n_rt, &group);
    k1_fwd_row_tile_kernel<<<blocks, dim3(TILE_COLS, RT_WARPS),
                             walk_smem(n2), stream>>>(
        x1, x2, mask_words, tile_thr, n_rep, r_e, r_p, cut2_cov, cut2_pair,
        group, pair, colpart, flags);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_col_partials<2, true>(colpart, flags, n_rep, n_rt, n_ct, n2, cov,
                            stream);
  return (int)cudaGetLastError();
}
