// K6: residue-plane rotamer BP -> Bethe free energy and envelope gradients.
//
// Replaces: upside_md_tpu/ops/pallas_bp.py `_bp_kernel` (:230), launched by
// `_bp_impl` (:306) for `bp_bethe_pallas` (:355): the BP path for more than
// 512 beads (nodes/rotamer.py:447-461).
//
// What bounds it on an H100: the bytes of the 36 gradient planes it writes
// (36 x R x R floats a replica, all but the adjacent i < j entries zero)
// and of the dense messages, plus the latency of a few dependent sweeps
// (bp_common.cuh).  The 36 factors of one edge lie R*R floats apart in the
// planes, 36 cache lines an edge, so the solve never reads the planes.
//
// Design: one C entry point, six launches on the caller's stream.  The
// Boltzmann planes P = exp(-E2) with validity folded in arrive from the
// wrapper (the JAX package forms them in XLA too, :313-321); the adjacency
// is an input, as in the TPU kernel; residues i != j are joined where
// either adj[i, j] or adj[j, i] is set, so the bit words are symmetric
// whatever the caller gives (the reverse-edge ranks rely on that).
//
// 1. `planes_adjacency_kernel`: one warp packs 32 adjacency bytes, each
//    ORed with its transposed byte, into a word with a ballot (no atomics),
//    dropping the diagonal.
// 2. `bp_index_kernel` (bp_common.cuh): compact edges and reverse indices.
// 3. `planes_factor_kernel`: gathers each adjacent directed edge's 36
//    factors out of the planes into its own 144-byte block (the planes at
//    (i, j) and (j, i) are read as given, so they need not be transposes of
//    each other), transposing tiles of 64 edges through shared memory so
//    that both the plane reads and the block writes run along memory.
// 4. `bp_solve_kernel<false>`, the per-replica solve, and behind it
//    `bp_bethe_edges_kernel`, the Bethe edge energy and gradient.
// 5. `planes_gradient_kernel` over (replica x row chunks) writes every
//    element of G2 once, 36 planes a thread, the compact gradient on
//    adjacent i < j and 0 elsewhere (:293-301), so nothing clears the planes first (a clear
//    and a scatter of the edges wrote the lines of the edges twice and took
//    half as long again); `bp_messages_kernel` writes the dense messages.
#include "bp_common.cuh"

// blockDim.x threads = blockDim.x / 32 words; word w of residue i covers
// partners 32 w .. 32 w + 31
static __global__ void __launch_bounds__(PASS_THREADS)
planes_adjacency_kernel(const unsigned char* __restrict__ adj_in, int R,
                        unsigned int* __restrict__ adjw) {
  const int r = blockIdx.y;
  const int t = blockIdx.x * PASS_THREADS + threadIdx.x;
  const int word = t >> 5, lane = t & 31;
  if (word >= R * ADJ_WORDS) return;            // a whole warp leaves
  const int i = word / ADJ_WORDS, j = (word % ADJ_WORDS) * 32 + lane;
  const unsigned char* a = adj_in + (long)r * R * R;
  const bool on = j < R && j != i && (a[i * R + j] | a[j * R + i]) != 0;
  const unsigned int bits = __ballot_sync(FULL_MASK, on);
  if (lane == 0) adjw[(long)r * R * ADJ_WORDS + word] = bits;
}

// Tiles of FAC_TILE edges: the block reads each plane at the tile's (i, j)
// (neighbouring threads neighbouring edges, which lie close in the plane)
// into shared memory, then writes the tile's factor blocks as one run.
#define FAC_TILE 64
static __global__ void __launch_bounds__(PASS_THREADS)
planes_factor_kernel(const float* __restrict__ Pl, int R, BPScratch sc,
                     long e_cap) {
  __shared__ float tile[NPAIR][FAC_TILE + 1];
  const int r = blockIdx.y;
  const long RR = (long)R * R;
  const int n_edges = sc.counts[r * N_COUNTS + COUNT_EDGES];
  const float* P = Pl + r * NPAIR * RR;
  const int* edge_ij = sc.edge_ij + r * e_cap;
  float* fac = sc.fac + r * e_cap * NPAIR;
  for (int e0 = blockIdx.x * FAC_TILE; e0 < n_edges;
       e0 += gridDim.x * FAC_TILE) {
    const int n = n_edges - e0 < FAC_TILE ? n_edges - e0 : FAC_TILE;
    for (int t = threadIdx.x; t < NPAIR * FAC_TILE; t += PASS_THREADS) {
      const int ab = t / FAC_TILE, k = t - ab * FAC_TILE;
      if (k < n) tile[ab][k] = __ldg(P + ab * RR + edge_ij[e0 + k]);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < n * NPAIR; t += PASS_THREADS) {
      const int k = t / NPAIR, ab = t - k * NPAIR;
      fac[(long)e0 * NPAIR + t] = tile[ab][k];
    }
    __syncthreads();
  }
}

// G2[r, ab, i, j] = the compact gradient of edge (i, j) on adjacent i < j,
// else 0: every element is written once, so nothing clears the planes
// first.  A thread takes one group of columns of one row and writes it in
// all 36 planes, which share the adjacency test: with VEC (R a multiple of
// four) four columns and one 16-byte store a plane, without one column.
// All but the few groups that hold an edge cost one adjacency word.
template <bool VEC>
static __global__ void __launch_bounds__(PASS_THREADS)
planes_gradient_kernel(int R, BPScratch sc, long e_cap,
                       float* __restrict__ G2) {
  const int r = blockIdx.y;
  const int RR = R * R, width = VEC ? 4 : 1;
  const int ij = width * (blockIdx.x * PASS_THREADS + threadIdx.x);
  if (ij >= RR) return;
  const int i = ij / R, j = ij - i * R;
  const unsigned int* adjw = sc.adjw + (long)r * R * ADJ_WORDS;
  // bits of columns j .. j + width - 1 beyond the diagonal; a group never
  // straddles a word
  unsigned int m = 0u;
  if (j + width - 1 > i)
    m = (__ldg(adjw + i * ADJ_WORDS + (j >> 5)) >> (j & 31))
        & ((1u << width) - 1u);
  for (int k = 0; k < width; ++k)
    if (j + k <= i) m &= ~(1u << k);
  int e[4] = {0, 0, 0, 0};
  if (m != 0u) {
    unsigned int row[ADJ_WORDS];
    load_row(adjw, i, row);
    const int first = __ldg(sc.row_start + (long)r * (R + 1) + i);
    for (int k = 0; k < width; ++k) e[k] = first + bits_below(row, j + k);
  }
  const float* G = sc.fac + r * e_cap * NPAIR;
  float* dst = G2 + (long)r * NPAIR * RR + ij;
#pragma unroll 4
  for (int ab = 0; ab < NPAIR; ++ab) {
    float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (m != 0u)
      for (int k = 0; k < width; ++k)
        if ((m >> k) & 1u) g[k] = G[(long)e[k] * NPAIR + ab];
    if (VEC) {
      *(float4*)(dst + (long)ab * RR) = make_float4(g[0], g[1], g[2], g[3]);
    } else {
      dst[(long)ab * RR] = g[0];
    }
  }
}

extern "C" int bp_bethe_planes(
    const float* E1, const float* P, const unsigned char* adj,
    const unsigned char* valid, const float* nb0, const float* eb0,
    int n_rep, int R, float damping, int max_iter, float tol, int chunk,
    float* F, float* G1, float* G2, float* nb, float* eb, float* dev,
    int* iters, int* iscratch, float* fscratch, void* stream_ptr) {
  if (R > MAX_RES || R < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long e_cap = (long)R * (R - 1);
  const BPScratch sc = make_scratch(iscratch, fscratch, n_rep, R, e_cap);
  planes_adjacency_kernel<<<pass_grid((long)R * ADJ_WORDS * 32, n_rep),
                            PASS_THREADS, 0, stream>>>(adj, R, sc.adjw);
  bp_index_kernel<<<n_rep, MAX_RES, 0, stream>>>(sc, R, e_cap, false);
  planes_factor_kernel<<<fill_grid(e_cap * (PASS_THREADS / FAC_TILE), n_rep),
                         PASS_THREADS, 0, stream>>>(P, R, sc, e_cap);
  const cudaError_t err = launch_solve<false>(
      E1, valid, nb0, eb0, n_rep, R, damping, max_iter, tol, chunk, sc, e_cap,
      e_cap, G1, nb, dev, iters, stream);
  if (err != cudaSuccess) return (int)err;
  if (R % 4 == 0) {
    planes_gradient_kernel<true><<<pass_grid((long)R * R / 4, n_rep),
                                   PASS_THREADS, 0, stream>>>(R, sc, e_cap,
                                                              G2);
  } else {
    planes_gradient_kernel<false><<<pass_grid((long)R * R, n_rep),
                                    PASS_THREADS, 0, stream>>>(R, sc, e_cap,
                                                               G2);
  }
  bp_messages_kernel<<<pass_grid((long)R * R, n_rep), PASS_THREADS, 0,
                       stream>>>(sc, R, e_cap, eb, F);
  return (int)cudaGetLastError();
}
