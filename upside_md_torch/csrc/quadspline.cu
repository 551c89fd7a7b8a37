// K5 and K4: the unfused directional pair spline, forward and backward.
//
// Replaces: upside_md_tpu/ops/pallas_quadspline.py
//   K5 `_fwd_kernel` (:248) and `_bwd_kernel` (:277), launched by
//      `_fwd_batched` (:522) / `_bwd_batched` (:546) for `quadspline_pallas`
//      (:737): the dense (n1, n2) pair grid and its cotangents;
//   K4 `_colsum_fwd_kernel` (:356) and `_colsum_bwd_kernel` (:390),
//      launched by `_colsum_fwd_batched` (:585) / `_colsum_bwd_batched`
//      (:621) for `quadspline_colsum_pallas` (:883): the weighted column
//      sums sum_i w1[i] value(i, j) and their cotangents (d/dw1 in column 6).
//
// What bounds it on an H100: K5 forward writes, and its backward reads, the
// (n1, n2) float grid per replica (543 x 543 at the RNase A shapes, 1.2 MB
// per replica), against ~80 flops per live pair; the backward needs the
// grid cotangent only where a pair is live.  K4 moves only the site rows
// and one (n2,) row per replica.  Both masks hold far more pairs than the
// cutoff leaves live (K4's coverage mask is a sequence exclusion, so nearly
// every pair is masked in; under 1% are live; the rotamer grid's 4%):
// what bounds the dense designs is the work spent on pairs beyond the
// cutoff, and K5's forward, once that is culled, the bytes of its grid.
//
// All four are row-tile walks with the per-replica cull of K3's design
// (fused_pair_bwd.cu) with one band: a warp owns (or shares) a row tile of
// one replica, walks the column tiles whose static mask holds a pair and
// whose box in this replica lies within the cutoff of the row tile's, lists
// each tile's candidate pairs (masked in, squared distance below the squared
// cutoff with the cull's margin) and takes them 32 at a time, one a lane;
// each takes the exact test s < kcut (:273).  Only a live pair reads its
// coefficients (4 a segment, from the per-(row type, column type) table
// built once per table in ops/quadspline.py) and runs Horner; the TPU
// kernel's one-hot MXU lookups and bf16 hi/lo split do not exist here.  Only
// live pairs read the cotangent (K4: the column cotangent and the row
// weight; K5: its entry of the grid cotangent) and the K4 forward's row
// weight; cotangents are selected by that test, never multiplied.
//
// K5's forward (walk_grid_band, with K5FwdPair) is one kernel without a
// memset: a block owns a row tile's band of one replica (contiguous in
// memory), culls and lists its column tiles, stores zeros over the band with
// 16-byte stores, and then walks the listed tiles, each live pair's lane
// storing its value over its zero.  The others (K4's forward and backward
// and K5's backward: walk_row_tiles with K4FwdPair, K4Pair and K5Pair below)
// write row sums once (the backwards); a walked tile's column sums go to one
// partial when it held a live pair, added in row-tile order by a second pass
// (K4's forward: one float a column).  No float atomics: the results are
// bitwise repeatable.  K5's rotamer call passes one bead set as both x1 and
// x2; the walks only read them, so the aliased pointers are sound.
#include "fused_pair.cuh"
#include "pair_cull.cuh"

struct SplineTerms {
  float a1, da1, a2, da2, wide, dwide, nar, dnar;
};

// the four segments of one pair's spline and their derivatives
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

// The row-tile walks of K4 and K5: every row's candidate test is the one
// cutoff's.
struct SplineRowThr {
  float cut2;
  __device__ float operator()(int) const { return cut2; }
};

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

// What the walks' spline pairs share: the call site's statics and family.
// They have no env rows and keep nothing of a live pair.
struct SplinePair {
  const int* t1;
  const int* t2;
  const float* coef;
  int n1, n2, ka, k, n_t2, ncoef;
  float inv_dx, kcut;
  static constexpr bool kEnvCols = false;

  __device__ bool cols(int) const { return true; }
  __device__ void keep(int, int, int, int, int, int, int,
                       const float*) const {}
  __device__ EnvRow env_row(int, int) const { return {0, 0.0f}; }
  __device__ EnvCol env_col(int, int) const { return {0, 0.0f}; }
  __device__ void env(const float*, const float*, EnvRow, EnvCol, float*,
                      float*) const {}
  __device__ void tile_done(int, int, int, int) const {}

  // pair (i, j)'s geometry and, when it is live (s < kcut), its spline
  __device__ bool live(int i, int j, const float* xr, const float* xc,
                       PairGeom& g, SplineTerms& t) const {
    g = pair_geometry(xr, xc);
    const float sd = __fmul_rn(g.dist, inv_dx);
    if (!(sd < kcut)) return false;
    t = spline_terms(coef + ((long)t1[i] * n_t2 + t2[j]) * ncoef, g, ka, k,
                     sd);
    return true;
  }
};

// K4's forward, pair (i, j) of replica r: cc[0] = w1[i] value(i, j), w1
// read only for a live pair; no row sums.
struct K4FwdPair : SplinePair {
  const float* w1;

  __device__ bool rows(int) const { return false; }
  __device__ void row_out(int, int, const float*) const {}
  __device__ bool operator()(int r, int, int i, int j, const float* xr,
                             const float* xc, float*, float* cc,
                             float*) const {
    PairGeom g;
    SplineTerms t;
    if (!live(i, j, xr, xc, g, t)) return false;
    cc[0] = w1[(long)r * n1 + i] * (t.wide + t.a1 * t.a2 * t.nar);
    return true;
  }
};

// K4's backward, pair (i, j) of replica r: its row cotangent (d/dw1 in
// rc[6]) and column cotangent under the pair cotangent w1[i] g_col[j],
// both read only for a live pair; row sums to d1.
struct K4Pair : SplinePair {
  const float* w1;
  const float* g_col;
  float* d1;

  __device__ bool rows(int) const { return true; }
  __device__ void row_out(int r, int i, const float* s) const {
    store8<NCOMP>(s, d1 + ((long)r * n1 + i) * 8);
  }
  __device__ bool operator()(int r, int, int i, int j, const float* xr,
                             const float* xc, float* rc, float* cc,
                             float*) const {
    PairGeom g;
    SplineTerms t;
    if (!live(i, j, xr, xc, g, t)) return false;
    const float gcol = g_col[(long)r * n2 + j];
    spline_cotangents(t, g, xr, xc, w1[(long)r * n1 + i] * gcol, inv_dx, ka,
                      rc, cc);
    rc[6] = gcol * (t.wide + t.a1 * t.a2 * t.nar);
    return true;
  }
};

// K5's backward, pair (i, j) of replica r: its row and column cotangents
// under its entry of the grid cotangent g (n_rep, n1, n2), read only for a
// live pair; row sums to d1.  K5 has no row weight, so its sums have the
// six position and direction components.
struct K5Pair : SplinePair {
  const float* g;
  float* d1;

  __device__ bool rows(int) const { return true; }
  __device__ void row_out(int r, int i, const float* s) const {
    store8<6>(s, d1 + ((long)r * n1 + i) * 8);
  }
  __device__ bool operator()(int r, int, int i, int j, const float* xr,
                             const float* xc, float* rc, float* cc,
                             float*) const {
    PairGeom geo;
    SplineTerms t;
    if (!live(i, j, xr, xc, geo, t)) return false;
    spline_cotangents(t, geo, xr, xc, g[((long)r * n1 + i) * n2 + j],
                      inv_dx, ka, rc, cc);
    return true;
  }
};

// K5's forward, pair (i, j): whether it is live, and then its value v.
struct K5FwdPair : SplinePair {
  __device__ bool operator()(int i, int j, const float* xr, const float* xc,
                             float& v) const {
    PairGeom g;
    SplineTerms t;
    if (!live(i, j, xr, xc, g, t)) return false;
    v = t.wide + t.a1 * t.a2 * t.nar;
    return true;
  }
};

// The walks (walk_row_tiles and walk_grid_band, pair_cull.cuh), one kernel a
// pair, each with the call site's statics as separate read-only parameters
// from which it builds its pair: so built, K4's backward compiles to the
// registers and speed it had before K4's forward and K5's backward joined it
// (a pair passed whole, or its shape as one struct, took 4-6% more time on
// an H100; tools/time_torch_bp.py --spline-bwd, PERF.md section 6).  The
// rotamer call's x1 and x2 are one tensor: both are only read.  mask_words
// (n1, n_ct): the static mask, bit l of word (i, ct) for pair (i, 32 ct +
// l); tile_alive (n_rt, n_ct): the tiles it holds a pair in; cut2: the
// squared cull and candidate threshold (ops/tile_cull.py `cutoff_sq`).
//
// K5's forward, a block a band, capped at 56 registers: 9 blocks an SM,
// so the 1,088 bands of 64 RNase A replicas fit an H100 at once.
static __global__ void __launch_bounds__(TILE_COLS * RT_WARPS, 9)
quadspline_fwd_band_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const int* __restrict__ t1, const int* __restrict__ t2,
    const unsigned* __restrict__ mask_words,
    const unsigned char* __restrict__ tile_alive,
    const float* __restrict__ coef, int n1, int n2, int ka, int k, int n_t2,
    int ncoef, float inv_dx, float kcut, float cut2, float* __restrict__ out,
    unsigned char* __restrict__ flags) {
  const K5FwdPair pair{{t1, t2, coef, n1, n2, ka, k, n_t2, ncoef, inv_dx,
                        kcut}};
  walk_grid_band(x1, x2, mask_words, tile_alive, cut2, n1, n2, pair, out,
                 flags);
}

static __global__ void __launch_bounds__(TILE_COLS * RT_WARPS)
colsum_fwd_row_tile_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const int* __restrict__ t1, const int* __restrict__ t2,
    const unsigned* __restrict__ mask_words,
    const unsigned char* __restrict__ tile_alive,
    const float* __restrict__ coef, int n_rep, int n1, int n2, int ka, int k,
    int n_t2, int ncoef, float inv_dx, float kcut, float cut2, int group,
    const float* __restrict__ w1, float* __restrict__ part,
    unsigned char* __restrict__ flags) {
  const K4FwdPair pair{{t1, t2, coef, n1, n2, ka, k, n_t2, ncoef, inv_dx,
                        kcut},
                       w1};
  walk_row_tiles<1, 1>(x1, x2, mask_words, tile_alive, nullptr, cut2, n_rep,
                       n1, n2, 0, 0, group, SplineRowThr{cut2}, pair, part,
                       flags, nullptr);
}

static __global__ void __launch_bounds__(TILE_COLS * RT_WARPS)
colsum_bwd_row_tile_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const int* __restrict__ t1, const int* __restrict__ t2,
    const unsigned* __restrict__ mask_words,
    const unsigned char* __restrict__ tile_alive,
    const float* __restrict__ coef, int n_rep, int n1, int n2, int ka, int k,
    int n_t2, int ncoef, float inv_dx, float kcut, float cut2, int group,
    const float* __restrict__ w1, const float* __restrict__ g_col,
    float* __restrict__ d1, float* __restrict__ part,
    unsigned char* __restrict__ flags) {
  const K4Pair pair{{t1, t2, coef, n1, n2, ka, k, n_t2, ncoef, inv_dx, kcut},
                    w1, g_col, d1};
  walk_row_tiles<NCOMP, NCOMP>(x1, x2, mask_words, tile_alive, nullptr, cut2,
                               n_rep, n1, n2, 0, 0, group,
                               SplineRowThr{cut2}, pair, part, flags,
                               nullptr);
}

static __global__ void __launch_bounds__(TILE_COLS * RT_WARPS)
quadspline_bwd_row_tile_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const int* __restrict__ t1, const int* __restrict__ t2,
    const unsigned* __restrict__ mask_words,
    const unsigned char* __restrict__ tile_alive,
    const float* __restrict__ coef, int n_rep, int n1, int n2, int ka, int k,
    int n_t2, int ncoef, float inv_dx, float kcut, float cut2, int group,
    const float* __restrict__ g, float* __restrict__ d1,
    float* __restrict__ part, unsigned char* __restrict__ flags) {
  const K5Pair pair{{t1, t2, coef, n1, n2, ka, k, n_t2, ncoef, inv_dx, kcut},
                    g, d1};
  walk_row_tiles<6, 6>(x1, x2, mask_words, tile_alive, nullptr, cut2, n_rep,
                       n1, n2, 0, 0, group, SplineRowThr{cut2}, pair, part,
                       flags, nullptr);
}

// Runs launch(blocks, dynamic shared bytes, group), a walk over n_rep
// replicas of n1 rows and n2 columns, then the pass that adds its column
// partials part (n_rep, n_rt, n2, W) of the tiles flagged written, in
// row-tile order, into out (n_rep, n2, W; W = 1: (n_rep, n2)).  part and
// flags (n_rep, n_rt, n_ct: the cull's decisions, CULL_KEPT and
// CULL_WRITTEN) are written by the walk, never read before; so are the
// outputs.
template <int W, class Launch>
static int walk_and_sum(int n_rep, int n1, int n2, const float* part,
                        const unsigned char* flags, float* out,
                        cudaStream_t stream, const Launch& launch) {
  const int n_rt = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  if (n_rep > 0 && n_rt > 0) {
    int group;
    const dim3 blocks = row_tile_blocks(n_rep, n_rt, &group);
    launch(blocks, walk_smem(n2), group);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_col_partials<W>(part, flags, n_rep, n_rt, n_ct, n2, out, stream);
  return (int)cudaGetLastError();
}

// K5's forward: out (n_rep, n1, n2), every element written here;
// flags (n_rep, n_rt, n_ct) the cull's decisions (0, CULL_KEPT, and
// CULL_WRITTEN where the tile held a live pair), also never read before.
extern "C" int quadspline_fwd(
    const float* x1, const float* x2, const int* t1, const int* t2,
    const unsigned* mask_words, const unsigned char* tile_alive,
    const float* coef, int n_rep, int n1, int n2, int ka, int k, int n_t2,
    int ncoef, float inv_dx, float kcut, float cut2, unsigned char* flags,
    float* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_rt = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  if (n_rep <= 0 || n_rt <= 0 || n2 <= 0) return 0;
  quadspline_fwd_band_kernel<<<dim3(n_rt, n_rep), dim3(TILE_COLS, RT_WARPS),
                               grid_walk_smem(n2), stream>>>(
      x1, x2, t1, t2, mask_words, tile_alive, coef, n1, n2, ka, k, n_t2,
      ncoef, inv_dx, kcut, cut2, out, flags);
  return (int)cudaGetLastError();
}

// K4's forward: out (n_rep, n2) = sum_i w1[i] value(i, j); part (n_rep,
// n_rt, n2) its column partials.
extern "C" int colsum_fwd(
    const float* x1, const float* x2, const float* w1, const int* t1,
    const int* t2, const unsigned* mask_words,
    const unsigned char* tile_alive, const float* coef, int n_rep, int n1,
    int n2, int ka, int k, int n_t2, int ncoef, float inv_dx, float kcut,
    float cut2, float* part, unsigned char* flags, float* out,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return walk_and_sum<1>(
      n_rep, n1, n2, part, flags, out, stream,
      [&](dim3 blocks, size_t smem, int group) {
        colsum_fwd_row_tile_kernel<<<blocks, dim3(TILE_COLS, RT_WARPS), smem,
                                     stream>>>(
            x1, x2, t1, t2, mask_words, tile_alive, coef, n_rep, n1, n2, ka,
            k, n_t2, ncoef, inv_dx, kcut, cut2, group, w1, part, flags);
      });
}

// K5's backward: d1 (n_rep, n1, 8), d2 (n_rep, n2, 8) from the grid
// cotangent g (n_rep, n1, n2); d2part (n_rep, n_rt, n2, 8) its column
// partials.
extern "C" int quadspline_bwd(
    const float* x1, const float* x2, const float* g, const int* t1,
    const int* t2, const unsigned* mask_words,
    const unsigned char* tile_alive, const float* coef, int n_rep, int n1,
    int n2, int ka, int k, int n_t2, int ncoef, float inv_dx, float kcut,
    float cut2, float* d2part, unsigned char* flags, float* d1, float* d2,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return walk_and_sum<8>(
      n_rep, n1, n2, d2part, flags, d2, stream,
      [&](dim3 blocks, size_t smem, int group) {
        quadspline_bwd_row_tile_kernel<<<blocks, dim3(TILE_COLS, RT_WARPS),
                                         smem, stream>>>(
            x1, x2, t1, t2, mask_words, tile_alive, coef, n_rep, n1, n2, ka,
            k, n_t2, ncoef, inv_dx, kcut, cut2, group, g, d1, d2part, flags);
      });
}

// K4's backward: d1 (n_rep, n1, 8) with d/dw1 in column 6, d2 (n_rep, n2,
// 8); d2part (n_rep, n_rt, n2, 8) its column partials.
extern "C" int colsum_bwd(
    const float* x1, const float* x2, const float* w1, const float* g,
    const int* t1, const int* t2, const unsigned* mask_words,
    const unsigned char* tile_alive, const float* coef, int n_rep, int n1,
    int n2, int ka, int k, int n_t2, int ncoef, float inv_dx, float kcut,
    float cut2, float* d2part, unsigned char* flags, float* d1, float* d2,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return walk_and_sum<8>(
      n_rep, n1, n2, d2part, flags, d2, stream,
      [&](dim3 blocks, size_t smem, int group) {
        colsum_bwd_row_tile_kernel<<<blocks, dim3(TILE_COLS, RT_WARPS), smem,
                                     stream>>>(
            x1, x2, t1, t2, mask_words, tile_alive, coef, n_rep, n1, n2, ka,
            k, n_t2, ncoef, inv_dx, kcut, cut2, group, w1, g, d1, d2part,
            flags);
      });
}
