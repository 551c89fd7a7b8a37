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
// per replica), against ~100 flops per live pair: device-memory bytes.  K4
// moves only the site rows and one (n2,) row per replica, so it is bound by
// the pair arithmetic (~240 or 372 rows x 543 columns per replica); its
// coverage mask is a sequence exclusion, so nearly every pair is masked in
// and most lie beyond the cutoff: what bounds K4's backward is the work
// spent on those dead pairs.
//
// Design of K5 and K4's forward: one thread per (row, column) pair, a block
// is a 32-column by 32-row tile (32 x 8 threads, each thread walks 4
// rows), the replica is grid z; the tiling of the fused kernels
// (fused_pair.cuh).  Each pair reads the 4 cubic coefficients of its
// interval per segment from the per-(row type, column type) table built
// once per table (ops/quadspline.py) and runs Horner; the TPU kernel's
// one-hot MXU lookups and bf16 hi/lo split do not exist here.  Tiles whose
// static mask is all zero skip all spline work (the rotamer mask is
// upper-triangular).  Masked pairs skip the spline too; live = mask AND
// s < k - 2 - 1e-6 (:273), and cotangents are selected by it, never
// multiplied.  Reductions are deterministic: K4's column sums go to
// per-row-tile partials, K5's backward row gradients (over columns)
// through a fixed warp tree into per-column-tile partials and its column
// gradients (over rows) through shared memory into per-row-tile partials;
// a second pass sums the partials in order.  No float atomics.
//
// K4's backward (`colsum_bwd_row_tile_kernel`: walk_row_tiles in
// pair_cull.cuh, with K4Pair below) is K3's design (fused_pair_bwd.cu)
// with one band: a warp owns (or shares) a row tile of one replica, walks
// the column tiles whose static mask holds a pair and whose box in this
// replica lies within the cutoff of the row tile's, lists each tile's
// candidate pairs (masked in, squared distance below the squared cutoff
// with the cull's margin) and takes them 32 at a time, one a lane; each
// takes the exact test s < kcut.  Only live pairs read the column
// cotangent.  Row sums are written once; a walked tile's column sums go to
// one partial when it held a live pair, added in row-tile order by a
// second pass.
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

template <bool COLSUM>
static __global__ void __launch_bounds__(TILE_COLS * ROW_THREADS)
qs_fwd_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
              const float* __restrict__ w1, const int* __restrict__ t1,
              const int* __restrict__ t2,
              const unsigned char* __restrict__ mask,
              const unsigned char* __restrict__ tile_alive,
              const float* __restrict__ coef, int n1, int n2, int ka, int k,
              int n_t2, int ncoef, float inv_dx, float kcut,
              float* __restrict__ out, float* __restrict__ colpart,
              int n_rep) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * TILE_COLS + tx;
  const int rt = blockIdx.y;
  const int r = blockIdx.z;
  const bool jv = j < n2;
  const bool alive = tile_alive[rt * gridDim.x + blockIdx.x] != 0;

  float xc[6] = {0, 0, 0, 0, 0, 0};
  int ct = 0;
  if (jv) {
    for (int c = 0; c < 6; ++c) xc[c] = x2[((long)r * n2 + j) * 6 + c];
    ct = t2[j];
  }
  float acc = 0.0f;   // K4: this thread's rows of column j

  for (int s = 0; s < TILE_ROWS / ROW_THREADS; ++s) {
    const int i = rt * TILE_ROWS + s * ROW_THREADS + ty;   // warp-uniform
    if (i >= n1) break;
    float val = 0.0f;
    if (alive && jv && mask[(long)i * n2 + j]) {
      float xr[6];
      for (int c = 0; c < 6; ++c) xr[c] = x1[((long)r * n1 + i) * 6 + c];
      const PairGeom g = pair_geometry(xr, xc);
      const float sd = g.dist * inv_dx;
      if (sd < kcut) {
        const SplineTerms t = spline_terms(
            coef + ((long)t1[i] * n_t2 + ct) * ncoef, g, ka, k, sd);
        val = t.wide + t.a1 * t.a2 * t.nar;
        if (COLSUM) acc += w1[(long)r * n1 + i] * val;
      }
    }
    if (!COLSUM && jv) out[((long)r * n1 + i) * n2 + j] = val;
  }

  if (COLSUM) {
    __shared__ float sa[ROW_THREADS][TILE_COLS];
    sa[ty][tx] = acc;
    __syncthreads();
    if (ty == 0 && jv) {
      float t = 0.0f;
      for (int y = 0; y < ROW_THREADS; ++y) t += sa[y][tx];
      colpart[((long)rt * n_rep + r) * n2 + j] = t;
    }
  }
}


static __global__ void __launch_bounds__(TILE_COLS * ROW_THREADS)
qs_bwd_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
              const float* __restrict__ g_in, const int* __restrict__ t1,
              const int* __restrict__ t2,
              const unsigned char* __restrict__ mask,
              const unsigned char* __restrict__ tile_alive,
              const float* __restrict__ coef, int n1, int n2, int ka, int k,
              int n_t2, int ncoef, float inv_dx, float kcut,
              float* __restrict__ d1part, float* __restrict__ d2part,
              int n_rep) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * TILE_COLS + tx;
  const int rt = blockIdx.y;
  const int r = blockIdx.z;
  const bool jv = j < n2;
  const bool alive = tile_alive[rt * gridDim.x + blockIdx.x] != 0;
  const float inv_dth = (ka - 3) * 0.5f;

  float xc[6] = {0, 0, 0, 0, 0, 0};
  int ct = 0;
  if (jv) {
    for (int c = 0; c < 6; ++c) xc[c] = x2[((long)r * n2 + j) * 6 + c];
    ct = t2[j];
  }
  float colacc[6] = {0, 0, 0, 0, 0, 0};

  for (int s = 0; s < TILE_ROWS / ROW_THREADS; ++s) {
    const int i = rt * TILE_ROWS + s * ROW_THREADS + ty;   // warp-uniform
    if (i >= n1) break;
    float row[NCOMP] = {0, 0, 0, 0, 0, 0, 0};
    if (alive && jv && mask[(long)i * n2 + j]) {
      float xr[6];
      for (int c = 0; c < 6; ++c) xr[c] = x1[((long)r * n1 + i) * 6 + c];
      const PairGeom g = pair_geometry(xr, xc);
      const float sd = g.dist * inv_dx;
      if (sd < kcut) {
        const SplineTerms t = spline_terms(
            coef + ((long)t1[i] * n_t2 + ct) * ncoef, g, ka, k, sd);
        const float gv = g_in[((long)r * n1 + i) * n2 + j];
        // reference derivative partition (bead_interaction.h:61-73)
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
        row[0] = -gx; row[1] = -gy; row[2] = -gz;
        row[3] = c1 * g.ux; row[4] = c1 * g.uy; row[5] = c1 * g.uz;
        colacc[0] += gx; colacc[1] += gy; colacc[2] += gz;
        colacc[3] -= c2 * g.ux; colacc[4] -= c2 * g.uy; colacc[5] -= c2 * g.uz;
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
  __shared__ float sc[6][ROW_THREADS][TILE_COLS];
  for (int c = 0; c < 6; ++c) sc[c][ty][tx] = colacc[c];
  __syncthreads();
  if (ty == 0 && jv) {
    float* dst = d2part + (((long)rt * n_rep + r) * n2 + j) * 8;
    for (int c = 0; c < 6; ++c) {
      float t = 0.0f;
      for (int y = 0; y < ROW_THREADS; ++y) t += sc[c][y][tx];
      dst[c] = t;
    }
    dst[6] = 0.0f;
    dst[7] = 0.0f;
  }
}

// K4's backward: every row's candidate test is the one cutoff's.
struct K4RowThr {
  float cut2;
  __device__ float operator()(int) const { return cut2; }
};

// K4's backward, pair (i, j) of replica r: its row cotangent (d/dw1 in
// rc[6]) and column cotangent; false where it is beyond the cutoff.  K4
// has one band, no env rows and nothing kept from a live pair; its row
// sums go to d1.
struct K4Pair {
  const float* w1;
  const float* g_col;
  const int* t1;
  const int* t2;
  const float* coef;
  float* d1;
  int n1, n2, ka, k, n_t2, ncoef;
  float inv_dx, kcut;
  static constexpr bool kEnvCols = false;

  __device__ bool rows(int) const { return true; }
  __device__ bool cols(int) const { return true; }
  __device__ void keep(int, int, int, int, int, int, int,
                       const float*) const {}
  __device__ EnvRow env_row(int, int) const { return {0, 0.0f}; }
  __device__ EnvCol env_col(int, int) const { return {0, 0.0f}; }
  __device__ void env(const float*, const float*, EnvRow, EnvCol, float*,
                      float*) const {}
  __device__ void tile_done(int, int, int, int) const {}
  __device__ void row_out(int r, int i, const float* s) const {
    store8<NCOMP>(s, d1 + ((long)r * n1 + i) * 8);
  }

  __device__ bool operator()(int r, int, int i, int j, const float* xr,
                             const float* xc, float* rc, float* cc,
                             float*) const {
    const PairGeom g = pair_geometry(xr, xc);
    const float sd = __fmul_rn(g.dist, inv_dx);
    if (!(sd < kcut)) return false;
    const float inv_dth = (ka - 3) * 0.5f;
    const SplineTerms t = spline_terms(
        coef + ((long)t1[i] * n_t2 + t2[j]) * ncoef, g, ka, k, sd);
    const float gcol = g_col[(long)r * n2 + j];
    const float gv = w1[(long)r * n1 + i] * gcol;
    // reference derivative partition (bead_interaction.h:61-73)
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
    rc[6] = gcol * (t.wide + t.a1 * t.a2 * t.nar);
    cc[0] = gx; cc[1] = gy; cc[2] = gz;
    cc[3] = -(c2 * g.ux); cc[4] = -(c2 * g.uy); cc[5] = -(c2 * g.uz);
    return true;
  }
};

// K4's backward (walk_row_tiles, pair_cull.cuh, with K4Pair).  mask_words
// (n1, n_ct): the static mask, bit l of word (i, ct) for pair (i, 32 ct +
// l).  cut2: the squared cull and candidate threshold (ops/tile_cull.py
// `cutoff_sq`).
static __global__ void __launch_bounds__(TILE_COLS * RT_WARPS)
colsum_bwd_row_tile_kernel(const float* __restrict__ x1,
                           const float* __restrict__ x2,
                           const float* __restrict__ w1,
                           const float* __restrict__ g_col,
                           const int* __restrict__ t1,
                           const int* __restrict__ t2,
                           const unsigned* __restrict__ mask_words,
                           const unsigned char* __restrict__ tile_alive,
                           const float* __restrict__ coef, int n_rep,
                           int n1, int n2,
                           int ka, int k, int n_t2, int ncoef, float inv_dx,
                           float kcut, float cut2, int group,
                           float* __restrict__ d1,
                           float* __restrict__ d2part,
                           unsigned char* __restrict__ flags) {
  const K4Pair pair{w1, g_col, t1, t2, coef, d1, n1, n2, ka, k, n_t2,
                    ncoef, inv_dx, kcut};
  walk_row_tiles<NCOMP, NCOMP>(x1, x2, mask_words, tile_alive, nullptr, cut2,
                               n_rep, n1, n2, 0, 0, group, K4RowThr{cut2},
                               pair, d2part, flags, nullptr);
}

static inline dim3 tile_grid(int n_rep, int n1, int n2) {
  return dim3((n2 + TILE_COLS - 1) / TILE_COLS,
              (n1 + TILE_ROWS - 1) / TILE_ROWS, n_rep);
}

template <bool COLSUM>
static int launch_fwd(const float* x1, const float* x2, const float* w1,
                      const int* t1, const int* t2, const unsigned char* mask,
                      const unsigned char* tile_alive, const float* coef,
                      int n_rep, int n1, int n2, int ka, int k, int n_t2,
                      int ncoef, float inv_dx, float kcut, float* out,
                      float* colpart, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(n_rep, n1, n2);
  qs_fwd_kernel<COLSUM><<<grid, dim3(TILE_COLS, ROW_THREADS), 0, stream>>>(
      x1, x2, w1, t1, t2, mask, tile_alive, coef, n1, n2, ka, k, n_t2, ncoef,
      inv_dx, kcut, out, colpart, n_rep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !COLSUM) return (int)err;
  sum_parts(colpart, (int)grid.y, (long)n_rep * n2, out, stream);
  return (int)cudaGetLastError();
}

extern "C" int quadspline_fwd(
    const float* x1, const float* x2, const int* t1, const int* t2,
    const unsigned char* mask, const unsigned char* tile_alive,
    const float* coef, int n_rep, int n1, int n2, int ka, int k, int n_t2,
    int ncoef, float inv_dx, float kcut, float* out, void* stream) {
  return launch_fwd<false>(x1, x2, nullptr, t1, t2, mask, tile_alive, coef,
                           n_rep, n1, n2, ka, k, n_t2, ncoef, inv_dx, kcut,
                           out, nullptr, stream);
}

extern "C" int colsum_fwd(
    const float* x1, const float* x2, const float* w1, const int* t1,
    const int* t2, const unsigned char* mask, const unsigned char* tile_alive,
    const float* coef, int n_rep, int n1, int n2, int ka, int k, int n_t2,
    int ncoef, float inv_dx, float kcut, float* colpart, float* out,
    void* stream) {
  return launch_fwd<true>(x1, x2, w1, t1, t2, mask, tile_alive, coef, n_rep,
                          n1, n2, ka, k, n_t2, ncoef, inv_dx, kcut, out,
                          colpart, stream);
}

extern "C" int quadspline_bwd(
    const float* x1, const float* x2, const float* g, const int* t1,
    const int* t2, const unsigned char* mask, const unsigned char* tile_alive,
    const float* coef, int n_rep, int n1, int n2, int ka, int k, int n_t2,
    int ncoef, float inv_dx, float kcut, float* d1part, float* d2part,
    float* d1, float* d2, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid = tile_grid(n_rep, n1, n2);
  qs_bwd_kernel<<<grid, dim3(TILE_COLS, ROW_THREADS), 0, stream>>>(
      x1, x2, g, t1, t2, mask, tile_alive, coef, n1, n2, ka, k, n_t2, ncoef,
      inv_dx, kcut, d1part, d2part, n_rep);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_parts(d1part, (int)grid.x, (long)n_rep * n1 * 8, d1, stream);
  sum_parts(d2part, (int)grid.y, (long)n_rep * n2 * 8, d2, stream);
  return (int)cudaGetLastError();
}

// K4's backward.  d2part (n_rep, n_rt, n2, 8) holds the column partials of
// the walked tiles with a live pair, flags (n_rep, n_rt, n_ct) the
// cull's decisions (CULL_KEPT, CULL_WRITTEN); both are written here, never
// read before.
extern "C" int colsum_bwd(
    const float* x1, const float* x2, const float* w1, const float* g,
    const int* t1, const int* t2, const unsigned* mask_words,
    const unsigned char* tile_alive, const float* coef, int n_rep, int n1,
    int n2, int ka, int k, int n_t2, int ncoef, float inv_dx, float kcut,
    float cut2, float* d2part, unsigned char* flags, float* d1, float* d2,
    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n_rt = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  if (n_rep > 0 && n_rt > 0) {
    int group;
    const dim3 blocks = row_tile_blocks(n_rep, n_rt, &group);
    colsum_bwd_row_tile_kernel<<<blocks, dim3(TILE_COLS, RT_WARPS),
                                 walk_smem(n2), stream>>>(
        x1, x2, w1, g, t1, t2, mask_words, tile_alive, coef, n_rep, n1, n2,
        ka, k, n_t2, ncoef, inv_dx, kcut, cut2, group, d1, d2part, flags);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  sum_col_partials(d2part, flags, n_rep, n_rt, n_ct, n2, d2, stream);
  return (int)cudaGetLastError();
}
