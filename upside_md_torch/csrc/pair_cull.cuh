// The per-replica tile cull and the column-partial pass of the row-tile
// pair kernels (K3 in fused_pair_bwd.cu, K4's backward in quadspline.cu).
// The plain version, and the rule in words, is ops/tile_cull.py; the two
// must give the same decisions bit for bit.
//
// A block holds RT_WARPS warps of one replica: RT_WARPS row tiles of 32
// rows, one a warp, or, while the row tiles alone would not fill the card,
// one row tile whose column tiles its four warps share
// (row_tile_group).  The warps put the box (per-axis minimum and maximum
// over a tile's valid sites) of every column tile of the replica and of
// their row tiles into shared memory; then each warp lists the column
// tiles whose squared box gap does not exceed its row tile's threshold
// and walks its share of them in order, with no barrier until the row
// sums are written.  Boxes are exact; the gap is formed with
// round-to-nearest multiplies and adds that the compiler may not fuse
// (__fmul_rn, __fadd_rn), in the plain version's order.  In a walked
// tile, lane l takes row l for the row test and column l for the pair
// test: the static mask comes as one 32-bit word per (row, column tile)
// (bit c: column c), a row whose word is 0 or whose site is farther than
// its threshold from the column tile's box is passed over, and the other
// rows' candidate pairs are listed and then taken 32 at a time, one a
// lane.
#pragma once
#include <cuda_runtime.h>
#include "fused_pair.cuh"

#define CULL_KEPT 1      // flags: the tile pair was walked
#define CULL_WRITTEN 2   // ... and held a candidate pair: its partials exist

// Box of tile t of the n sites x (stride 6), computed by one warp: lane l
// reads site t * 32 + l; out[0..2] = lo, out[3..5] = hi (lane 0 writes).
__device__ __forceinline__ void tile_box(const float* __restrict__ x, int n,
                                         int t, int lane, float* out) {
  const int j = t * TILE_COLS + lane;
  const bool v = j < n;
  for (int a = 0; a < 3; ++a) {
    float lo = v ? x[(long)j * 6 + a] : __int_as_float(0x7f800000);
    float hi = v ? lo : -__int_as_float(0x7f800000);
    for (int off = 16; off > 0; off >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (lane == 0) { out[a] = lo; out[3 + a] = hi; }
  }
}

// squared gap between two boxes (lo[0..2], hi[3..5]); 0 where they overlap
__device__ __forceinline__ float box_gap_sq(const float* a, const float* b) {
  float g[3];
  for (int c = 0; c < 3; ++c)
    g[c] = fmaxf(fmaxf(a[c] - b[3 + c], b[c] - a[3 + c]), 0.0f);
  return __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                   __fmul_rn(g[2], g[2]));
}

#define RT_WARPS 4     // warps of a row-tile block
#define NCOMP 7        // 6 position/direction components + one weight

// squared gap between point p and box b (lo[0..2], hi[3..5])
__device__ __forceinline__ float point_box_gap_sq(const float* p,
                                                  const float* b) {
  float s = 0.0f;
  for (int c = 0; c < 3; ++c) {
    const float g = fmaxf(fmaxf(b[c] - p[c], p[c] - b[3 + c]), 0.0f);
    s += g * g;
  }
  return s;
}

// The cull of one row tile, by one warp: the column tiles to walk, in
// order, into kept[] (their count returned), and the flag 0 of every
// culled tile into fl (fl null: none; a walked tile's flag is written by
// the warp that walks it).  A tile is walked when its static mask holds a
// pair (alive[ct] != 0; alive null: always) and its box gap to the row
// tile's box rbox does not exceed thr.
__device__ __forceinline__ int cull_list(const float* rbox,
                                         const float* cbox, int n_ct,
                                         float thr,
                                         const unsigned char* alive,
                                         unsigned char* fl, int* kept) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  for (int base = 0; base < n_ct; base += TILE_COLS) {
    const int t = base + lane;
    bool keep = false;
    if (t < n_ct) {
      keep = (alive == nullptr || alive[t] != 0)
             && !(box_gap_sq(rbox, cbox + t * 6) > thr);
      if (fl != nullptr && !keep) fl[t] = 0;
    }
    const unsigned b = __ballot_sync(0xffffffffu, keep);
    if (keep) kept[n + __popc(b & below)] = t;
    n += __popc(b);
  }
  __syncwarp();
  return n;
}

// A warp's scratch for the tile it walks: the tile's candidate pairs in
// row-major order (row * 32 + column), its column sites, and its columns'
// cotangent sums.
struct WalkScratch {
  unsigned short list[TILE_ROWS * TILE_COLS];
  float xc[TILE_COLS][6];
  float colacc[TILE_COLS][NCOMP];
};

// Lists the candidate pairs of one tile into ws.list, row-major, and
// returns their count.  Lane l holds column l's site xc, the mask word of
// row l (bit c: column c masked in), and the tile's column box cb; a row
// is looked at only when its mask word is not 0 and its site lies within
// its threshold of the column box, and its masked-in pairs are candidates
// when their squared distance is not at or above the row's threshold
// thr_s[row] (+inf: every masked-in pair).  Also puts xc into ws.xc and
// clears ws.colacc.
__device__ __forceinline__ int list_candidates(unsigned word,
                                               const float* cb,
                                               float (*xr_s)[6],
                                               const float* thr_s,
                                               const float* xc,
                                               WalkScratch& ws) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < 6; ++c) ws.xc[lane][c] = xc[c];
  for (int c = 0; c < NCOMP; ++c) ws.colacc[lane][c] = 0.0f;
  unsigned rows = __ballot_sync(
      0xffffffffu,
      word != 0u && !(point_box_gap_sq(xr_s[lane], cb) >= thr_s[lane]));
  int n = 0;
  while (rows != 0u) {                                // warp-uniform
    const int ii = __ffs(rows) - 1;
    rows &= rows - 1u;
    const unsigned mw = __shfl_sync(0xffffffffu, word, ii);
    bool cand = false;
    if ((mw >> lane) & 1u) {
      const float* xr = xr_s[ii];
      const float dx = xc[0] - xr[0], dy = xc[1] - xr[1], dz = xc[2] - xr[2];
      cand = !(dx * dx + dy * dy + dz * dz >= thr_s[ii]);
    }
    const unsigned b = __ballot_sync(0xffffffffu, cand);
    if (cand) ws.list[n + __popc(b & below)] =
        (unsigned short)(ii * TILE_COLS + lane);
    n += __popc(b);
  }
  __syncwarp();
  return n;
}

// Adds one chunk of up to 32 candidates' contributions in list order:
// lane l's rc belongs to row ri of the tile and its cc to column ci (-1:
// none).  The lanes that share a row (or a column) add theirs in lane
// order, one lane of each group a round, to racc_w[ri] (or
// colacc_w[ci]), this warp's shared-memory sums.
__device__ __forceinline__ void add_chunk(const float* rc, const float* cc,
                                          int ri, int ci,
                                          float (*racc_w)[NCOMP],
                                          float (*colacc_w)[NCOMP]) {
  const unsigned below = (1u << threadIdx.x) - 1u;
  const unsigned grow = __match_any_sync(0xffffffffu, ri);
  const unsigned gcol = __match_any_sync(0xffffffffu, ci);
  const int rrank = ri >= 0 ? __popc(grow & below) : 0;
  const int crank = ci >= 0 ? __popc(gcol & below) : 0;
  const int rounds = __reduce_max_sync(0xffffffffu, max(rrank, crank));
  for (int q = 0; q <= rounds; ++q) {
    if (ri >= 0 && rrank == q)
      for (int c = 0; c < NCOMP; ++c) racc_w[ri][c] += rc[c];
    if (ci >= 0 && crank == q)
      for (int c = 0; c < NCOMP; ++c) colacc_w[ci][c] += cc[c];
    __syncwarp();
  }
}

// Lane l's 8 floats of a row (or column) cotangent: v[0..NC), then 0;
// two 16-byte stores.
template <int NC>
__device__ __forceinline__ void store8(const float* v,
                                       float* __restrict__ dst) {
  float o[8];
  for (int c = 0; c < 8; ++c) o[c] = c < NC ? v[c] : 0.0f;
  reinterpret_cast<float4*>(dst)[0] = make_float4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(o[4], o[5], o[6], o[7]);
}

// The body of a row-tile kernel (K3, K4's backward).  Block (blockIdx.x,
// replica blockIdx.y) of 32 x RT_WARPS threads holds RT_WARPS / group row
// tiles, `group` warps each: warp w takes row tile (RT_WARPS / group)
// blockIdx.x + w / group and, of its listed column tiles, those at
// positions w % group, w % group + group, ... of the list.  For each it
// lists the candidate pairs and takes them 32 at a time, one a lane:
// pair(r, ii, i, j, xr, xc, rc, cc) computes pair (i, j) (row ii of the
// tile), its row cotangent rc[0..NCOMP) and column cotangent cc[0..NCOMP),
// and returns whether it is live.  row_thr(i): row i's candidate
// threshold; the row tile's cull threshold is tile_thr[rt] (tile_thr
// null: thr_all); alive (n_rt, n_ct, or null): the tiles whose static
// mask holds a pair.  Each warp's row sums accumulate in shared memory,
// tile after tile in its order; the group's are added in warp order at
// the end.  Dynamic shared memory: n_ct * (6 floats + RT_WARPS ints).
template <class RowThr, class Pair>
__device__ __forceinline__ void walk_row_tiles(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const unsigned* __restrict__ mask_words,
    const unsigned char* __restrict__ alive,
    const float* __restrict__ tile_thr, float thr_all, int n1, int n2,
    int group, const RowThr& row_thr, const Pair& pair,
    float* __restrict__ d1, float* __restrict__ d2part,
    unsigned char* __restrict__ flags) {
  extern __shared__ float cbox[];
  __shared__ float rbox[RT_WARPS][6];
  __shared__ float xr_s[RT_WARPS][TILE_ROWS][6];
  __shared__ float thr_s[RT_WARPS][TILE_ROWS];
  __shared__ float racc[RT_WARPS][TILE_ROWS][NCOMP];
  __shared__ WalkScratch scratch[RT_WARPS];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int sub = warp % group, lead = warp - sub;
  const int r = blockIdx.y;
  const int rt = blockIdx.x * (RT_WARPS / group) + warp / group;
  const int n_rt = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  const bool active = rt < n_rt;                      // warp-uniform
  const int i0 = rt * TILE_ROWS;
  const float* x1r = x1 + (long)r * n1 * 6;
  const float* x2r = x2 + (long)r * n2 * 6;
  float (*xr_w)[6] = xr_s[lead];
  WalkScratch& ws = scratch[warp];

  for (int c = 0; c < NCOMP; ++c) racc[warp][lane][c] = 0.0f;
  if (active && sub == 0) {      // lane l: row i0 + l of the row tile
    const int i = i0 + lane;
    for (int c = 0; c < 6; ++c)
      xr_w[lane][c] = i < n1 ? x1r[(long)i * 6 + c] : 0.0f;
    thr_s[lead][lane] = i < n1 ? row_thr(i) : 0.0f;
    tile_box(x1r, n1, rt, lane, rbox[lead]);
  }
  for (int t = warp; t < n_ct; t += RT_WARPS)
    tile_box(x2r, n2, t, lane, cbox + t * 6);
  __syncthreads();

  if (active) {
    unsigned char* fl = flags + ((long)r * n_rt + rt) * n_ct;
    int* kept = reinterpret_cast<int*>(cbox + n_ct * 6) + warp * n_ct;
    const int n_kept = cull_list(
        rbox[lead], cbox, n_ct, tile_thr ? tile_thr[rt] : thr_all,
        alive ? alive + (long)rt * n_ct : nullptr, sub == 0 ? fl : nullptr,
        kept);
    for (int q = sub; q < n_kept; q += group) {
      const int ct = kept[q];
      const int j0 = ct * TILE_COLS;
      float xc[6] = {0, 0, 0, 0, 0, 0};
      if (j0 + lane < n2)
        for (int c = 0; c < 6; ++c) xc[c] = x2r[(long)(j0 + lane) * 6 + c];
      // lane l holds the mask word of row i0 + l (0 past the last row)
      const unsigned word =
          i0 + lane < n1 ? mask_words[(long)(i0 + lane) * n_ct + ct] : 0u;
      const int n_cand = list_candidates(word, cbox + ct * 6, xr_w,
                                         thr_s[lead], xc, ws);
      for (int k0 = 0; k0 < n_cand; k0 += TILE_COLS) {
        float rc[NCOMP] = {0, 0, 0, 0, 0, 0, 0};
        float cc[NCOMP] = {0, 0, 0, 0, 0, 0, 0};
        int ri = -1, ci = -1;
        if (k0 + lane < n_cand) {
          const int code = ws.list[k0 + lane];
          const int ii = code / TILE_COLS, col = code % TILE_COLS;
          if (pair(r, ii, i0 + ii, j0 + col, xr_w[ii], ws.xc[col], rc, cc)) {
            ri = ii;
            ci = col;
          }
        }
        add_chunk(rc, cc, ri, ci, racc[warp], ws.colacc);
      }
      if (n_cand > 0 && j0 + lane < n2)  // this tile's column sums
        store8<NCOMP>(ws.colacc[lane],
                      d2part + (((long)r * n_rt + rt) * n2 + j0 + lane) * 8);
      if (lane == 0)
        fl[ct] = n_cand > 0 ? CULL_KEPT | CULL_WRITTEN : CULL_KEPT;
    }
  }
  __syncthreads();
  if (active && sub == 0 && i0 + lane < n1) {     // lane l: row i0 + l
    float s[NCOMP];
    for (int c = 0; c < NCOMP; ++c) {
      s[c] = 0.0f;
      for (int g = 0; g < group; ++g) s[c] += racc[warp + g][lane][c];
    }
    store8<NCOMP>(s, d1 + ((long)r * n1 + i0 + lane) * 8);
  }
}

// Warps a row tile of a row-tile kernel gets: RT_WARPS while the row
// tiles alone, a warp each, would not fill the card once (its SMs x 32
// resident warps), else 1.  The SM count is read once per device.
static inline int row_tile_group(long row_tiles) {
  constexpr int RT_MAX_DEVICES = 64;
  static int sms[RT_MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= RT_MAX_DEVICES)
    return 1;
  if (sms[dev] == 0)
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return row_tiles < (long)sms[dev] * 32 ? RT_WARPS : 1;
}

// out[(r * n2 + j) * 8 + c] = sum over row tiles rt, in order, of the
// partials part[((r * n_rt + rt) * n2 + j) * 8 + c] of the tiles whose
// flag says they were written; 0 where none was.
static __global__ void sum_col_partials_kernel(
    const float* __restrict__ part, const unsigned char* __restrict__ flags,
    int n_rt, int n_ct, int n2, long total, float* __restrict__ out) {
  const long k = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  const long rj = k >> 3;
  const int r = (int)(rj / n2), j = (int)(rj % n2);
  const unsigned char* f = flags + (long)r * n_rt * n_ct + j / TILE_COLS;
  float s = 0.0f;
  for (int rt = 0; rt < n_rt; ++rt)
    if (f[(long)rt * n_ct] & CULL_WRITTEN)
      s += part[(((long)r * n_rt + rt) * n2) * 8 + (k - (long)r * n2 * 8)];
  out[k] = s;
}

static inline void sum_col_partials(const float* part,
                                    const unsigned char* flags, int n_rep,
                                    int n_rt, int n_ct, int n2, float* out,
                                    cudaStream_t stream) {
  const long total = (long)n_rep * n2 * 8;
  if (total <= 0) return;
  const int threads = 256;
  sum_col_partials_kernel<<<(unsigned)((total + threads - 1) / threads),
                            threads, 0, stream>>>(part, flags, n_rt, n_ct,
                                                  n2, total, out);
}
