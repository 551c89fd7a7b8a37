// The row-tile walks of the pair kernels: the per-replica tile cull with
// its candidate lists (K1's forward and K3 in fused_pair_{fwd,bwd}.cu,
// K4's forward and backward and K5's backward in quadspline.cu), its
// variant that writes a dense pair grid whole (K5's forward, in
// quadspline.cu: walk_grid_band), the walk over a forward's compact
// residual (K1's backward), and the column-partial pass they share.  The
// plain version of the cull, and the rule in words, is ops/tile_cull.py;
// the two must give the same decisions bit for bit.
//
// A block holds RT_WARPS warps and one row tile of 32 rows: its copies in
// RT_WARPS replicas, one a warp, or, while the row tiles alone would not
// fill the card, its copy in one replica, whose column tiles the four
// warps share (row_tile_group).  The warps put the box (per-axis minimum
// and maximum over a tile's valid sites) of every column tile of their
// replicas and of their row tiles into shared memory; then each warp lists
// the column tiles whose squared box gap does not exceed its row tile's
// threshold and walks its share of them in order, with no barrier until
// the row sums are written.  Boxes are exact; the gap is formed with
// round-to-nearest multiplies and adds that the compiler may not fuse
// (__fmul_rn, __fadd_rn), in the plain version's order.  In a walked
// tile, lane l takes row l for the row test and column l for the pair
// test: the static mask comes as one 32-bit word per (row, column tile)
// (bit c: column c), a row whose word is 0 or whose site is farther than
// its threshold from the column tile's box is passed over, and the other
// rows' candidate pairs are listed and then taken 32 at a time, one a
// lane.  Rows without a spline cutoff (the env band, rows [env_lo,
// env_hi)) are not listed: each such row is taken whole, a lane a column,
// and its row sums reduced over the tile's 32 columns by a fixed shuffle
// tree, several rows at once (env_rows).
#pragma once
#include <cuda_runtime.h>
#include "fused_pair.cuh"

#define CULL_KEPT 1      // flags: the tile pair was walked
#define CULL_WRITTEN 2   // ... and its column partial sums were written

#define RT_WARPS 4       // warps of a row-tile block
#define NCOMP 7          // 6 position/direction components + one weight
#define RESID_SLOTS (TILE_ROWS * TILE_COLS)   // residual slots of a tile

// What an env pair reads of its row and of its column besides the sites:
// the type that picks its sigmoid parameters, and the row's cotangent
// (backward) or the column's weight.  A walk loads a lane's row once per
// row tile and a lane's column once per column tile.
struct EnvRow {
  int type;
  float g;
};
struct EnvCol {
  int type;
  float w;
};

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

// Boxes of tiles t0, t0 + step, ... (< n_t) of the n sites x (stride 6),
// one a lane: lane l takes tile t0 + l (t0 + l + step, ...) and runs over
// its 32 sites; out[t * 6 + 0..2] = lo, out[t * 6 + 3..5] = hi.  Minima
// and maxima are exact in any order, so these are `tile_box`'s boxes.
__device__ __forceinline__ void tile_boxes(const float* __restrict__ x,
                                           int n, int n_t, int t0, int step,
                                           float* out) {
  for (int t = t0 + threadIdx.x; t < n_t; t += step) {
    float lo[3], hi[3];
    for (int a = 0; a < 3; ++a) {
      lo[a] = __int_as_float(0x7f800000);
      hi[a] = -__int_as_float(0x7f800000);
    }
    const int j1 = min(n, (t + 1) * TILE_COLS);
    for (int j = t * TILE_COLS; j < j1; ++j)
      for (int a = 0; a < 3; ++a) {
        const float v = x[(long)j * 6 + a];
        lo[a] = fminf(lo[a], v);
        hi[a] = fmaxf(hi[a], v);
      }
    for (int a = 0; a < 3; ++a) {
      out[t * 6 + a] = lo[a];
      out[t * 6 + 3 + a] = hi[a];
    }
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

// The column tiles a warp takes, in order, into kept[] (their count
// returned): lane l decides tile base + l (keep(t)); a tile not taken gets
// flag 0 in fl and count 0 in cnt (either null: none; a taken tile's are
// written by the warp that takes it).
template <class Keep>
__device__ __forceinline__ int list_tiles(int n_ct, const Keep& keep,
                                          unsigned char* fl, short* cnt,
                                          int* kept) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  for (int base = 0; base < n_ct; base += TILE_COLS) {
    const int t = base + lane;
    const bool k = t < n_ct && keep(t);
    if (t < n_ct && !k) {
      if (fl != nullptr) fl[t] = 0;
      if (cnt != nullptr) cnt[t] = 0;
    }
    const unsigned b = __ballot_sync(0xffffffffu, k);
    if (k) kept[n + __popc(b & below)] = t;
    n += __popc(b);
  }
  __syncwarp();
  return n;
}

// A warp's scratch for the tile it walks: the tile's candidate pairs in
// row-major order (row * 32 + column), its column sites, and its columns'
// sums of NC components.
template <int NC>
struct WalkScratch {
  unsigned short list[TILE_ROWS * TILE_COLS];
  float xc[TILE_COLS][6];
  float colacc[TILE_COLS][NC];
};

// Puts lane l's column site xc into xc_w[l] and clears its column sums.
template <int NC>
__device__ __forceinline__ void start_tile(const float* xc,
                                           float (*xc_w)[6],
                                           float (*colacc_w)[NC]) {
  const int lane = threadIdx.x;
  for (int c = 0; c < 6; ++c) xc_w[lane][c] = xc[c];
  for (int c = 0; c < NC; ++c) colacc_w[lane][c] = 0.0f;
  __syncwarp();
}

// Lists the candidate pairs of one tile into list, row-major, and returns
// their count.  Lane l holds column l's site xc, the mask word of row l
// (bit c: column c masked in; 0 for a row that is not to be listed), and
// the tile's column box cb; a row is looked at only when its mask word is
// not 0 and its site lies within its threshold of the column box, and its
// masked-in pairs are candidates when their squared distance is not at or
// above the row's threshold thr_s[row].
__device__ __forceinline__ int list_candidates(unsigned word,
                                               const float* cb,
                                               float (*xr_s)[6],
                                               const float* thr_s,
                                               const float* xc,
                                               unsigned short* list) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
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
    if (cand) list[n + __popc(b & below)] =
        (unsigned short)(ii * TILE_COLS + lane);
    n += __popc(b);
  }
  __syncwarp();
  return n;
}

// Adds one chunk of up to 32 pairs' contributions in list order: lane l's
// rc belongs to row ri of the tile and its cc to column ci (-1: none).
// The lanes of a row are contiguous (the list is row-major): a segmented
// scan over the lanes, a fixed shuffle tree, leaves each row's sum at its
// last lane, which adds it to racc_w[ri].  The lanes that share a column
// add theirs in lane order, one lane of each group a round, to
// colacc_w[ci].  racc_w and colacc_w are this warp's shared-memory sums.
template <int NR, int NC>
__device__ __forceinline__ void add_chunk(const float* rc, const float* cc,
                                          int ri, int ci,
                                          float (*racc_w)[NR],
                                          float (*colacc_w)[NC]) {
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  if (__any_sync(0xffffffffu, ri >= 0)) {
    const int prev = __shfl_up_sync(0xffffffffu, ri, 1);
    const unsigned starts = __ballot_sync(0xffffffffu, lane == 0 || ri != prev);
    const int head = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
    const bool last = lane == 31 || ((starts >> (lane + 1)) & 1u);
    float s[NR];
    for (int c = 0; c < NR; ++c) s[c] = rc[c];
#pragma unroll
    for (int d = 1; d < TILE_COLS; d <<= 1)
#pragma unroll
      for (int c = 0; c < NR; ++c) {
        const float t = __shfl_up_sync(0xffffffffu, s[c], d);
        if (lane - d >= head) s[c] += t;
      }
    if (last && ri >= 0)
      for (int c = 0; c < NR; ++c) racc_w[ri][c] += s[c];
  }
  const unsigned gcol = __match_any_sync(0xffffffffu, ci);
  const int crank = ci >= 0 ? __popc(gcol & below) : 0;
  const int rounds = __reduce_max_sync(0xffffffffu, crank);
  for (int q = 0; q <= rounds; ++q) {
    if (ci >= 0 && crank == q)
      for (int c = 0; c < NC; ++c) colacc_w[ci][c] += cc[c];
    __syncwarp();
  }
}

// Sums v[0..32) over the warp's lanes by a fixed butterfly that halves the
// values at each step (31 shuffles for 32 sums): lane l ends with the sum
// of value l in v[0].
template <int OFF>
__device__ __forceinline__ void transpose_step(float* v) {
  const bool upper = (threadIdx.x & OFF) != 0;
#pragma unroll
  for (int k = 0; k < OFF; ++k) {
    const float send = upper ? v[k] : v[k + OFF];
    const float keep = upper ? v[k + OFF] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

__device__ __forceinline__ void transpose_sum(float* v) {
  transpose_step<16>(v);
  transpose_step<8>(v);
  transpose_step<4>(v);
  transpose_step<2>(v);
  transpose_step<1>(v);
}

// The rows of a tile without a spline cutoff (env_row: lane l's row is
// one; word: its mask word; erow: its EnvRow; ecol: the EnvCol of column
// l).  Each such row whose word is not 0 is taken, lane l computing the
// pair with column l where it is masked in (pair.env(xr, xc, row, col,
// rc, cc)), ENV_BATCH rows at once (32 / NR with several cotangents a
// row): their NR row cotangents each are summed over the 32 columns by
// fixed shuffle trees (all together by `transpose_sum` when they are many,
// else one `warp_sum` each) and added to racc_w[row]; each lane keeps its
// column's cotangents in registers, row after row, and adds them to its
// column's sums once.  Returns whether the column sums took a
// contribution (warp-uniform).
template <int NR, int NC, class Pair>
__device__ __forceinline__ bool env_rows(unsigned word, bool env_row,
                                         EnvRow erow, EnvCol ecol,
                                         const Pair& pair, float (*xr_w)[6],
                                         float (*xc_w)[6],
                                         float (*racc_w)[NR],
                                         float (*colacc_w)[NC]) {
  constexpr int EB = NR > 1 ? TILE_COLS / NR : 4;   // rows a batch
  constexpr bool TRANSPOSE = EB * NR > 8;
  const int lane = threadIdx.x;
  unsigned rows = __ballot_sync(0xffffffffu, env_row && word != 0u);
  const bool any = rows != 0u;
  float cacc[NC];
  for (int c = 0; c < NC; ++c) cacc[c] = 0.0f;
  while (rows != 0u) {                                // warp-uniform
    float v[TRANSPOSE ? TILE_COLS : EB * NR];
    int ii[EB];
#pragma unroll
    for (int b = 0; b < EB; ++b) {
      ii[b] = rows != 0u ? __ffs(rows) - 1 : -1;      // warp-uniform
      rows &= rows - 1u;
#pragma unroll
      for (int c = 0; c < NR; ++c) v[b * NR + c] = 0.0f;
      if (ii[b] < 0) continue;
      const unsigned mw = __shfl_sync(0xffffffffu, word, ii[b]);
      const bool mine = (mw >> lane) & 1u;            // 0 past n2
      const EnvRow er{__shfl_sync(0xffffffffu, erow.type, ii[b]),
                      __shfl_sync(0xffffffffu, erow.g, ii[b])};
      // every lane computes the pair (on a valid column: ecol is) and
      // keeps it only where masked in
      float rc[NR], cc[NC];
#pragma unroll
      for (int c = 0; c < NR; ++c) rc[c] = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) cc[c] = 0.0f;
      pair.env(xr_w[ii[b]], xc_w[lane], er, ecol, rc, cc);
#pragma unroll
      for (int c = 0; c < NR; ++c) v[b * NR + c] = mine ? rc[c] : 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) cacc[c] += mine ? cc[c] : 0.0f;
    }
    if constexpr (TRANSPOSE) {
#pragma unroll
      for (int k = EB * NR; k < TILE_COLS; ++k) v[k] = 0.0f;
      transpose_sum(v);
      int my_row = -1;          // the row of the sum lane l ends with
#pragma unroll
      for (int b = 0; b < EB; ++b)
        if (lane / NR == b) my_row = ii[b];
      if (my_row >= 0 && lane < EB * NR) racc_w[my_row][lane % NR] += v[0];
    } else {
#pragma unroll
      for (int b = 0; b < EB; ++b)
#pragma unroll
        for (int c = 0; c < NR; ++c) {
          const float t = warp_sum(v[b * NR + c]);
          if (lane == 0 && ii[b] >= 0) racc_w[ii[b]][c] += t;
        }
    }
  }
  for (int c = 0; c < NC; ++c) colacc_w[lane][c] += cacc[c];
  __syncwarp();
  return any && Pair::kEnvCols;
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

// floats of a column partial of NC components: 1, 2, or 8 (16-byte
// stores)
template <int NC>
struct PartWidth {
  static constexpr int value = NC == 1 ? 1 : NC == 2 ? 2 : 8;
};

template <int NC>
__device__ __forceinline__ void store_part(const float* v,
                                           float* __restrict__ dst) {
  if constexpr (NC == 1)
    dst[0] = v[0];
  else if constexpr (NC == 2)
    reinterpret_cast<float2*>(dst)[0] = make_float2(v[0], v[1]);
  else
    store8<NC>(v, dst);
}

// What a row-tile block keeps in shared memory for its warps' row tiles:
// the row sites, their candidate thresholds and the warps' row sums.
template <int NR>
struct RowTiles {
  float xr[RT_WARPS][TILE_ROWS][6];
  float thr[RT_WARPS][TILE_ROWS];
  float racc[RT_WARPS][TILE_ROWS][NR];
};

// The row sums of a row tile, once its warps have walked it: lane l of the
// group's first warp adds the group's sums of row i0 + l in warp order and
// hands them to pair.row_out(r, i, s).
template <int NR, class Pair>
__device__ __forceinline__ void finish_rows(const RowTiles<NR>& rt_s,
                                            int r, int i0, int n1,
                                            int group, const Pair& pair) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  if (warp % group != 0 || i0 + lane >= n1) return;
  float s[NR];
  for (int c = 0; c < NR; ++c) {
    s[c] = 0.0f;
    for (int g = 0; g < group; ++g) s[c] += rt_s.racc[warp + g][lane][c];
  }
  pair.row_out(r, i0 + lane, s);
}

// The body of a row-tile kernel with the cull (K1's forward, K3, K4's
// forward and backward, K5's backward).  Block (blockIdx.x, blockIdx.y) of
// 32 x RT_WARPS threads holds row tile blockIdx.x of RT_WARPS / group
// replicas, `group` warps each (row_tile_blocks): warp w takes replica
// (RT_WARPS / group) blockIdx.y + w / group and, of its listed column
// tiles, those at positions w % group, w % group + group, ... of the list.
// For each it lists the candidate pairs of its spline rows and takes them
// 32 at a time, one a lane: pair(r, ii, i, j, xr, xc, rc, cc, res) computes
// pair (i, j) (row ii of the tile), its NR row and NC column cotangents (or
// sums) and returns whether it is live; a live pair adds rc to row ii where
// pair.rows(i) and cc to its column where pair.cols(i), and pair.keep(r,
// rt, ct, slot, code, i, j, res) takes it with its rank among the tile's
// live pairs in list order.  Then the rows [env_lo, env_hi) of the tile
// (env_rows, with pair.env_row(r, i) and pair.env_col(r, j)), then
// pair.tile_done(r, rt, ct, live pairs).  row_thr(i): row i's candidate
// threshold; the row tile's cull threshold is tile_thr[rt] (tile_thr null:
// thr_all); alive (n_rt, n_ct, or null): the tiles whose static mask holds
// a pair.  A walked tile's column sums go to part (n_rep, n_rt, n2,
// PartWidth<NC>) when a pair added to them, and its flag says so; a culled
// tile gets flag 0 and count 0 in counts (null: none).  Each warp's row
// sums accumulate in shared memory, tile after tile in its order; the
// group's are added in warp order at the end (finish_rows).  Dynamic shared
// memory: walk_smem(n2).
template <int NR, int NC, class RowThr, class Pair>
__device__ __forceinline__ void walk_row_tiles(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const unsigned* __restrict__ mask_words,
    const unsigned char* __restrict__ alive,
    const float* __restrict__ tile_thr, float thr_all, int n_rep, int n1,
    int n2, int env_lo, int env_hi, int group, const RowThr& row_thr,
    const Pair& pair, float* __restrict__ part,
    unsigned char* __restrict__ flags, short* __restrict__ counts) {
  extern __shared__ float cbox_s[];
  __shared__ float rbox[RT_WARPS][6];
  __shared__ RowTiles<NR> rows_s;
  __shared__ WalkScratch<NC> scratch[RT_WARPS];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const unsigned below = (1u << lane) - 1u;
  const int sub = warp % group, lead = warp - sub;
  const int r = blockIdx.y * (RT_WARPS / group) + warp / group;
  const int rt = blockIdx.x;
  const int n_rt = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  const bool active = r < n_rep;                      // warp-uniform
  const int i0 = rt * TILE_ROWS;
  const float* x1r = x1 + (long)r * n1 * 6;
  const float* x2r = x2 + (long)r * n2 * 6;
  float (*xr_w)[6] = rows_s.xr[lead];
  float* cbox = cbox_s + lead * n_ct * 6;   // the column boxes of replica r
  WalkScratch<NC>& ws = scratch[warp];

  for (int c = 0; c < NR; ++c) rows_s.racc[warp][lane][c] = 0.0f;
  if (active && sub == 0) {      // lane l: row i0 + l of the row tile
    const int i = i0 + lane;
    for (int c = 0; c < 6; ++c)
      xr_w[lane][c] = i < n1 ? x1r[(long)i * 6 + c] : 0.0f;
    rows_s.thr[lead][lane] = i < n1 ? row_thr(i) : 0.0f;
    tile_box(x1r, n1, rt, lane, rbox[lead]);
  }
  if (active)                    // the group's warps share the boxes
    tile_boxes(x2r, n2, n_ct, sub * TILE_COLS, group * TILE_COLS, cbox);
  __syncthreads();

  if (active) {
    const long tiles = ((long)r * n_rt + rt) * n_ct;
    unsigned char* fl = flags + tiles;
    int* kept = reinterpret_cast<int*>(cbox_s + RT_WARPS * n_ct * 6)
                + warp * n_ct;
    const float thr = tile_thr ? tile_thr[rt] : thr_all;
    const unsigned char* al = alive ? alive + (long)rt * n_ct : nullptr;
    const float* rb = rbox[lead];
    const float* cb = cbox;
    const int n_kept = list_tiles(
        n_ct,
        [=](int t) {
          return (al == nullptr || al[t] != 0)
                 && !(box_gap_sq(rb, cb + t * 6) > thr);
        },
        sub == 0 ? fl : nullptr,
        sub == 0 && counts != nullptr ? counts + tiles : nullptr, kept);
    const bool env_row = i0 + lane >= env_lo && i0 + lane < env_hi;
    const bool env_tile = __any_sync(0xffffffffu, env_row);
    const EnvRow erow = env_row ? pair.env_row(r, i0 + lane) : EnvRow{0, 0.0f};
    for (int q = sub; q < n_kept; q += group) {
      const int ct = kept[q];
      const int j0 = ct * TILE_COLS;
      float xc[6] = {0, 0, 0, 0, 0, 0};
      if (j0 + lane < n2)
        for (int c = 0; c < 6; ++c) xc[c] = x2r[(long)(j0 + lane) * 6 + c];
      start_tile<NC>(xc, ws.xc, ws.colacc);
      // lane l holds the mask word of row i0 + l (0 past the last row)
      const unsigned word =
          i0 + lane < n1 ? mask_words[(long)(i0 + lane) * n_ct + ct] : 0u;
      const int n_cand = list_candidates(env_row ? 0u : word, cbox + ct * 6,
                                         xr_w, rows_s.thr[lead], xc, ws.list);
      int n_live = 0;
      bool cols = false;
      for (int k0 = 0; k0 < n_cand; k0 += TILE_COLS) {
        float rc[NR], cc[NC], res[4];
        for (int c = 0; c < NR; ++c) rc[c] = 0.0f;
        for (int c = 0; c < NC; ++c) cc[c] = 0.0f;
        int ri = -1, ci = -1, code = 0;
        bool live = false;
        if (k0 + lane < n_cand) {
          code = ws.list[k0 + lane];
          const int ii = code / TILE_COLS, col = code % TILE_COLS;
          live = pair(r, ii, i0 + ii, j0 + col, xr_w[ii], ws.xc[col], rc, cc,
                      res);
          // a candidate that is not live adds rc = 0 to its row, which
          // keeps each row's lanes together for add_chunk
          if (pair.rows(i0 + ii)) ri = ii;
          if (live && pair.cols(i0 + ii)) ci = col;
        }
        const unsigned b = __ballot_sync(0xffffffffu, live);
        if (live)
          pair.keep(r, rt, ct, n_live + __popc(b & below), code,
                    i0 + code / TILE_COLS, j0 + code % TILE_COLS, res);
        n_live += __popc(b);
        cols |= __any_sync(0xffffffffu, ci >= 0);
        add_chunk<NR, NC>(rc, cc, ri, ci, rows_s.racc[warp], ws.colacc);
      }
      if (env_tile)
        cols |= env_rows<NR, NC>(word, env_row, erow,
                                 pair.env_col(r, min(j0 + lane, n2 - 1)),
                                 pair, xr_w, ws.xc, rows_s.racc[warp],
                                 ws.colacc);
      if (cols && j0 + lane < n2)   // this tile's column sums
        store_part<NC>(ws.colacc[lane],
                       part + (((long)r * n_rt + rt) * n2 + j0 + lane)
                                  * PartWidth<NC>::value);
      if (lane == 0) {
        fl[ct] = cols ? CULL_KEPT | CULL_WRITTEN : CULL_KEPT;
        pair.tile_done(r, rt, ct, n_live);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (active) finish_rows<NR>(rows_s, r, i0, n1, group, pair);
}

// Zeros into len floats at p, by thread t of nt: 16-byte stores between
// a head and a tail of single floats.
__device__ __forceinline__ void zero_fill(float* __restrict__ p, int len,
                                          int t, int nt) {
  const int mis = (int)((reinterpret_cast<size_t>(p) >> 2) & 3);
  const int head = min((4 - mis) & 3, len);
  const int n4 = (len - head) >> 2;
  if (t < head) p[t] = 0.0f;
  float4* b = reinterpret_cast<float4*>(p + head);
  for (int q = t; q < n4; q += nt) b[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int tail = head + 4 * n4;
  if (t < len - tail) p[tail + t] = 0.0f;
}

// The body of a kernel that writes a dense pair grid out (n_rep, n1, n2)
// with the per-replica cull (K5's forward).  Block (rt, r) of 32 x
// RT_WARPS threads owns the band of row tile rt of replica r: rows 32 rt
// ... of all n2 columns, contiguous in memory.  Its warps put the row
// tile's box and, a tile a warp at a time (tile_box), the column tiles'
// boxes into shared memory; each warp lists the column tiles whose static
// mask holds a pair and whose box lies within cut2 of the row tile's (the
// cull of walk_row_tiles, bit for bit; warp 0 writes the flags of the
// others).  Then the block stores zeros over the whole band (zero_fill,
// 16-byte stores in memory order) and, after a barrier that orders those
// zeros before every value, warp w takes the listed tiles at positions w,
// w + RT_WARPS, ...: it lists the tile's candidate pairs (masked in,
// squared distance below cut2) and takes them 32 at a time, one a lane;
// pair(i, j, xr, xc, v) returns whether pair (i, j) is live and its value
// v, which the lane stores over its zero.  A band's zeros and values come
// from one block within microseconds, so its lines reach memory once.
// flags (n_rep, n_rt, n_ct): 0 for a tile not walked, CULL_KEPT for a
// walked one, and CULL_WRITTEN too where it held a live pair.  One value
// an element and no float atomics: the grid is bitwise repeatable.
// Dynamic shared memory: grid_walk_smem(n2).
template <class Pair>
__device__ __forceinline__ void walk_grid_band(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const unsigned* __restrict__ mask_words,
    const unsigned char* __restrict__ alive, float cut2, int n1, int n2,
    const Pair& pair, float* __restrict__ out,
    unsigned char* __restrict__ flags) {
  extern __shared__ float cbox[];        // the column tiles' boxes
  __shared__ float rbox[6];
  __shared__ float xr_s[TILE_ROWS][6];
  __shared__ float thr_s[TILE_ROWS];
  __shared__ unsigned short list_s[RT_WARPS][TILE_ROWS * TILE_COLS];
  __shared__ float xc_s[RT_WARPS][TILE_COLS][6];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int rt = blockIdx.x, r = blockIdx.y;
  const int n_rt = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  const int i0 = rt * TILE_ROWS;
  const int rows = min(TILE_ROWS, n1 - i0);
  const float* x1r = x1 + (long)r * n1 * 6;
  const float* x2r = x2 + (long)r * n2 * 6;
  float* band = out + ((long)r * n1 + i0) * n2;
  unsigned char* fl = flags + ((long)r * n_rt + rt) * n_ct;

  if (warp == 0) {               // lane l: row i0 + l of the row tile
    const int i = i0 + lane;
    for (int c = 0; c < 6; ++c)
      xr_s[lane][c] = i < n1 ? x1r[(long)i * 6 + c] : 0.0f;
    thr_s[lane] = cut2;
    tile_box(x1r, n1, rt, lane, rbox);
  }
  for (int t = warp; t < n_ct; t += RT_WARPS)
    tile_box(x2r, n2, t, lane, cbox + t * 6);
  __syncthreads();

  const unsigned char* al = alive + (long)rt * n_ct;
  int* kept = reinterpret_cast<int*>(cbox + n_ct * 6) + warp * n_ct;
  const int n_kept = list_tiles(
      n_ct,
      [=](int t) {
        return al[t] != 0 && !(box_gap_sq(rbox, cbox + t * 6) > cut2);
      },
      warp == 0 ? fl : nullptr, nullptr, kept);
  zero_fill(band, rows * n2, warp * TILE_COLS + lane, RT_WARPS * TILE_COLS);
  __syncthreads();
  for (int q = warp; q < n_kept; q += RT_WARPS) {
    const int ct = kept[q];
    const int j0 = ct * TILE_COLS;
    float xc[6] = {0, 0, 0, 0, 0, 0};
    if (j0 + lane < n2)
      for (int c = 0; c < 6; ++c) xc[c] = x2r[(long)(j0 + lane) * 6 + c];
    for (int c = 0; c < 6; ++c) xc_s[warp][lane][c] = xc[c];
    __syncwarp();
    // lane l holds the mask word of row i0 + l (0 past the last row)
    const unsigned word =
        i0 + lane < n1 ? mask_words[(long)(i0 + lane) * n_ct + ct] : 0u;
    const int n_cand = list_candidates(word, cbox + ct * 6, xr_s, thr_s, xc,
                                       list_s[warp]);
    bool held = false;
    for (int k0 = 0; k0 < n_cand; k0 += TILE_COLS) {
      bool live = false;
      if (k0 + lane < n_cand) {
        const int code = list_s[warp][k0 + lane];
        const int ii = code / TILE_COLS, col = code % TILE_COLS;
        float v;
        live = pair(i0 + ii, j0 + col, xr_s[ii], xc_s[warp][col], v);
        if (live) band[(long)ii * n2 + j0 + col] = v;
      }
      held |= __any_sync(0xffffffffu, live);
    }
    if (lane == 0) fl[ct] = held ? CULL_KEPT | CULL_WRITTEN : CULL_KEPT;
    __syncwarp();                // the next tile reuses the scratch
  }
}

// Dynamic shared memory of walk_grid_band: the column boxes and each
// warp's list of walked tiles.
static inline size_t grid_walk_smem(int n2) {
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  return (size_t)n_ct * (6 * sizeof(float) + RT_WARPS * sizeof(int));
}

// The body of a row-tile kernel that walks a forward's compact residual
// instead of culling (K1's backward).  The blocks and warps are those of
// walk_row_tiles; a warp takes the column tiles of its row tile that hold
// a live pair (counts (n_rep, n_rt, n_ct) > 0), and all of them in a row
// tile with rows [env_lo, env_hi).  In a tile it takes the residual's
// entries in order, 32 at a time, one a lane: entry k of tile (r, rt, ct)
// is codes[((r n_rt + rt) n_ct + ct) RESID_SLOTS + k] (row * 32 + column
// in the tile) and vals[...] (float4); pair.resid(r, ii, i, j, xr, xc, v,
// rc, cc) gives its NCOMP row and column cotangents.  The env rows follow
// (env_rows), as in walk_row_tiles; so do the column partials, the flags
// (CULL_KEPT: taken; CULL_WRITTEN: its partial written; 0: not taken) and
// the row sums.  Dynamic shared memory: n_ct * RT_WARPS ints.
template <class Pair>
__device__ __forceinline__ void walk_residual_tiles(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const unsigned* __restrict__ mask_words,
    const short* __restrict__ counts,
    const unsigned short* __restrict__ codes,
    const float4* __restrict__ vals, int n_rep, int n1, int n2,
    int env_lo, int env_hi, int group, const Pair& pair,
    float* __restrict__ part, unsigned char* __restrict__ flags) {
  extern __shared__ int kept_s[];
  __shared__ RowTiles<NCOMP> rows_s;
  __shared__ float xc_s[RT_WARPS][TILE_COLS][6];
  __shared__ float colacc_s[RT_WARPS][TILE_COLS][NCOMP];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int sub = warp % group, lead = warp - sub;
  const int r = blockIdx.y * (RT_WARPS / group) + warp / group;
  const int rt = blockIdx.x;
  const int n_rt = (n1 + TILE_ROWS - 1) / TILE_ROWS;
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  const bool active = r < n_rep;                      // warp-uniform
  const int i0 = rt * TILE_ROWS;
  const float* x1r = x1 + (long)r * n1 * 6;
  const float* x2r = x2 + (long)r * n2 * 6;
  float (*xr_w)[6] = rows_s.xr[lead];

  for (int c = 0; c < NCOMP; ++c) rows_s.racc[warp][lane][c] = 0.0f;
  if (active && sub == 0) {
    const int i = i0 + lane;
    for (int c = 0; c < 6; ++c)
      xr_w[lane][c] = i < n1 ? x1r[(long)i * 6 + c] : 0.0f;
  }
  __syncthreads();

  if (active) {
    const long tiles = ((long)r * n_rt + rt) * n_ct;
    const short* cnt = counts + tiles;
    unsigned char* fl = flags + tiles;
    int* kept = kept_s + warp * n_ct;
    const bool env_row = i0 + lane >= env_lo && i0 + lane < env_hi;
    const bool env_tile = __any_sync(0xffffffffu, env_row);
    const EnvRow erow = env_row ? pair.env_row(r, i0 + lane) : EnvRow{0, 0.0f};
    const int n_kept = list_tiles(
        n_ct, [=](int t) { return env_tile || cnt[t] > 0; },
        sub == 0 ? fl : nullptr, nullptr, kept);
    for (int q = sub; q < n_kept; q += group) {
      const int ct = kept[q];
      const int j0 = ct * TILE_COLS;
      float xc[6] = {0, 0, 0, 0, 0, 0};
      if (j0 + lane < n2)
        for (int c = 0; c < 6; ++c) xc[c] = x2r[(long)(j0 + lane) * 6 + c];
      start_tile<NCOMP>(xc, xc_s[warp], colacc_s[warp]);
      const int n = cnt[ct];
      const long base = (tiles + ct) * RESID_SLOTS;
      bool cols = n > 0;
      for (int k0 = 0; k0 < n; k0 += TILE_COLS) {
        float rc[NCOMP], cc[NCOMP];
        for (int c = 0; c < NCOMP; ++c) rc[c] = cc[c] = 0.0f;
        int ri = -1, ci = -1;
        if (k0 + lane < n) {
          const int code = codes[base + k0 + lane];
          const float4 v = vals[base + k0 + lane];
          ri = code / TILE_COLS;
          ci = code % TILE_COLS;
          pair.resid(r, ri, i0 + ri, j0 + ci, xr_w[ri], xc_s[warp][ci], v,
                     rc, cc);
        }
        add_chunk<NCOMP, NCOMP>(rc, cc, ri, ci, rows_s.racc[warp],
                                colacc_s[warp]);
      }
      if (env_tile) {
        const unsigned word =
            i0 + lane < n1 ? mask_words[(long)(i0 + lane) * n_ct + ct] : 0u;
        cols |= env_rows<NCOMP, NCOMP>(
            word, env_row, erow, pair.env_col(r, min(j0 + lane, n2 - 1)),
            pair, xr_w, xc_s[warp], rows_s.racc[warp], colacc_s[warp]);
      }
      if (cols && j0 + lane < n2)
        store8<NCOMP>(colacc_s[warp][lane],
                      part + (((long)r * n_rt + rt) * n2 + j0 + lane) * 8);
      if (lane == 0) fl[ct] = cols ? CULL_KEPT | CULL_WRITTEN : CULL_KEPT;
      __syncwarp();
    }
  }
  __syncthreads();
  if (active) finish_rows<NCOMP>(rows_s, r, i0, n1, group, pair);
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

// The launch shape of a row-tile kernel: (blocks, group) for n_rep
// replicas of n_rt row tiles.  Block (x, y) holds row tile x of RT_WARPS /
// group replicas, from replica y RT_WARPS / group on: with group 1 the
// four warps take four replicas' copies of one row tile, so a block's
// warps carry alike loads (the env band's row tiles are the heaviest).
static inline dim3 row_tile_blocks(int n_rep, int n_rt, int* group) {
  *group = row_tile_group((long)n_rt * n_rep);
  const int per_block = RT_WARPS / *group;
  return dim3(n_rt, (n_rep + per_block - 1) / per_block);
}

// Dynamic shared memory of walk_row_tiles: the column boxes of the
// block's replicas and each warp's list of column tiles.
static inline size_t walk_smem(int n2) {
  const int n_ct = (n2 + TILE_COLS - 1) / TILE_COLS;
  return (size_t)n_ct * RT_WARPS * (6 * sizeof(float) + sizeof(int));
}

// The column sums from the partials of W floats a column: element c of
// column j of replica r is the sum over row tiles rt, in order, of
// part[((r * n_rt + rt) * n2 + j) * W + c] over the tiles whose flag says
// they were written (0 where none was), stored at out[(r * n2 + j) * W + c]
// or, with TRANSPOSED, at out[(r * W + c) * n2 + j].  A thread takes one
// column: it reads each row tile's flag once and the partial whole.
template <int W, bool TRANSPOSED>
static __global__ void sum_col_partials_kernel(
    const float* __restrict__ part, const unsigned char* __restrict__ flags,
    int n_rt, int n_ct, int n2, long n_cols, float* __restrict__ out) {
  const long rj = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (rj >= n_cols) return;
  const int r = (int)(rj / n2), j = (int)(rj % n2);
  const unsigned char* f = flags + (long)r * n_rt * n_ct + j / TILE_COLS;
  float s[W];
  for (int c = 0; c < W; ++c) s[c] = 0.0f;
  for (int rt = 0; rt < n_rt; ++rt) {
    if (!(f[(long)rt * n_ct] & CULL_WRITTEN)) continue;
    const float* p = part + (((long)r * n_rt + rt) * n2 + j) * W;
    if constexpr (W == 8) {
      const float4 a = reinterpret_cast<const float4*>(p)[0];
      const float4 b = reinterpret_cast<const float4*>(p)[1];
      s[0] += a.x; s[1] += a.y; s[2] += a.z; s[3] += a.w;
      s[4] += b.x; s[5] += b.y; s[6] += b.z; s[7] += b.w;
    } else {
      for (int c = 0; c < W; ++c) s[c] += p[c];
    }
  }
  for (int c = 0; c < W; ++c)
    out[TRANSPOSED ? ((long)r * W + c) * n2 + j : rj * W + c] = s[c];
}

// sum_col_partials_kernel over n_rep replicas: 8-float partials into (n_rep,
// n2, 8) (the backwards), 2-float ones TRANSPOSED into (n_rep, 2, n2) (K1's
// forward), or 1-float ones into (n_rep, n2) (K4's forward).
template <int W, bool TRANSPOSED = false>
static inline void sum_col_partials(const float* part,
                                    const unsigned char* flags, int n_rep,
                                    int n_rt, int n_ct, int n2, float* out,
                                    cudaStream_t stream) {
  const long n_cols = (long)n_rep * n2;
  if (n_cols <= 0) return;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n_cols + threads - 1) / threads);
  sum_col_partials_kernel<W, TRANSPOSED><<<blocks, threads, 0, stream>>>(
      part, flags, n_rt, n_ct, n2, n_cols, out);
}
