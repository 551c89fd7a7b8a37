// The rotamer BP passes shared by K2 (bp_bethe_pairs.cu) and K6
// (bp_bethe_planes.cu).  The schedule follows `_bp_solve`
// (upside_md_tpu/nodes/rotamer.py:60-140), the Bethe energy and its
// envelope gradients `bethe_free_energy` (:142).
//
// What bounds the solve on an H100: latency.  One replica's problem is
// small (76-124 residues, ~700-1,000 adjacent directed edges of ~5,700-
// 15,000 possible, 6x6 factors) and the sweeps depend on each other, so a
// block's time is the length of its chain of dependent loads and barriers.
// Everything that is done once per call has nothing sequential in it.
//
// Design: three kinds of pass on one stream behind one C entry point.
//
// * Grid-wide prologue (the kernel's own .cu): the adjacency as bit words
//   (R x 4 words per replica), then `bp_index_kernel` here: a warp scan of
//   the rows' popcounts gives the compact list of adjacent directed edges
//   in row-major (i, j) order, which is CSR by residue; each edge gets the
//   index of its reverse edge and of its 36-float factor block.  K2 keeps
//   one block per undirected pair (the edge (j, i), j > i, reads block
//   (i, j) transposed), K6 one per directed edge.  A second grid-wide pass
//   fills the blocks (144 bytes an edge, 16-byte aligned).
// * `bp_solve_kernel`: one block of 512 threads per replica, which stops
//   at its own convergence.  The compact messages (n_edges x 6, two
//   buffers), the packed edge records and, where they fit, the factor
//   blocks live in shared memory; the layout is chosen per replica from
//   its edge count and the block's dynamic shared memory (SOLVE_SMEM_BYTES):
//     0  messages and factors in shared memory,
//     1  messages in shared memory, factors read through L2,
//     2  both in global scratch (more edges than the block can hold).
//   A sweep is one thread per directed edge (nine float4 factor loads, 36
//   FMAs), a barrier, and the log-space node update as a sum over each
//   residue's contiguous run of incoming edges.  Reductions are warp
//   shuffles in a fixed order, so the kernel is bitwise repeatable.  The
//   quotients and logs of the sweep use __fdividef and __logf.
// * `bp_bethe_edges_kernel`, grid-wide behind the solve: the Bethe edge
//   energy and gradient, one thread per adjacent pair, which overwrites
//   each factor block of the global array with its gradient.
// * Grid-wide epilogue: `bp_messages_kernel` here spreads the compact
//   messages into the dense (R, R, 6) output, 1.0 off the edges; the
//   kernel's own .cu spreads the compact gradient.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define NROT 6
#define NPAIR 36
#define BP_EPS 1e-10f
#define MAX_RES 128
#define ADJ_WORDS (MAX_RES / 32)
#define SOLVE_THREADS 512
#define SOLVE_WARPS (SOLVE_THREADS / 32)
#define PASS_THREADS 256
#define BETHE_THREADS 64
#define BETHE_BLOCKS 16         // blocks per replica of the Bethe edge pass
#define N_FSUM (1 + BETHE_BLOCKS)
#define FILL_BLOCKS 64          // blocks per replica of a grid-stride fill
#define SMEM_PER_BLOCK 232448   // the most one block may ask for on sm_90
// dynamic shared memory of a solve block: the most a block may ask for less
// the solve's static node arrays (ops/bp_pairs.py states the same numbers)
#define SOLVE_STATIC_BYTES 13568
#define SOLVE_SMEM_BYTES (SMEM_PER_BLOCK - SOLVE_STATIC_BYTES)
#define MAX_DEVICES 64
#define FULL_MASK 0xffffffffu

// per-replica integers of `counts`
#define N_COUNTS 4
#define COUNT_EDGES 0           // adjacent directed edges
#define COUNT_PAIRS 1           // adjacent undirected pairs
#define COUNT_LAYOUT 2          // layout the solve took

// The scratch the wrapper allocates: one int and one float buffer, cut into
// arrays that each have a leading replica axis (ops/bp_pairs.py `BPScratch`
// cuts them the same way).
struct BPScratch {
  unsigned int* adjw;   // (R, ADJ_WORDS) adjacency bits, no diagonal
  unsigned int* cand;   // (R, ADJ_WORDS) K2: pairs i < j with a nonzero bead
  int* counts;          // (N_COUNTS)
  int* row_start;       // (R + 1) first directed edge of each residue
  int* edge_ij;         // (e_cap) i * R + j, row-major
  int* edge_rev;        // (e_cap) index of the edge (j, i)
  int* edge_fac;        // (e_cap) index of the edge's factor block
  int* upair;           // (e_cap / 2) the edge (i, j), i < j, of each pair
  float* fac;           // (f_cap, 36) factor blocks, then their gradient
  float* msg;           // (2, e_cap, 6); [0] holds the final messages
  float* fsum;          // (N_FSUM) F's node term, then the edge pass's blocks
};

static inline BPScratch make_scratch(int* ibuf, float* fbuf, long n_rep, int R,
                                     long f_cap) {
  const long e_cap = (long)R * (R - 1);
  BPScratch sc;
  int* p = ibuf;
  sc.adjw = (unsigned int*)p;  p += n_rep * R * ADJ_WORDS;
  sc.cand = (unsigned int*)p;  p += n_rep * R * ADJ_WORDS;
  sc.counts = p;               p += n_rep * N_COUNTS;
  sc.row_start = p;            p += n_rep * (R + 1);
  sc.edge_ij = p;              p += n_rep * e_cap;
  sc.edge_rev = p;             p += n_rep * e_cap;
  sc.edge_fac = p;             p += n_rep * e_cap;
  sc.upair = p;
  sc.fac = fbuf;
  sc.msg = fbuf + n_rep * f_cap * NPAIR;
  sc.fsum = sc.msg + n_rep * 2 * e_cap * NROT;
  return sc;
}

struct BPNodes {
  float prob[MAX_RES * NROT];
  float nb[MAX_RES * NROT];
  float nb_prev[MAX_RES * NROT];
  float lsum[MAX_RES * NROT];
  float offset[MAX_RES];
  float red[SOLVE_WARPS];
  int row_start[MAX_RES + 1];
  unsigned char vmask[MAX_RES];   // bit a: rotamer slot a is valid
};
static_assert(sizeof(BPNodes) <= SOLVE_STATIC_BYTES,
              "the solve's static shared memory outgrew SOLVE_STATIC_BYTES");

// number of set bits of a row's adjacency words below position j
__device__ __forceinline__ int bits_below(const unsigned int* row, int j) {
  int c = 0;
#pragma unroll
  for (int w = 0; w < ADJ_WORDS; ++w) {
    const int lo = w * 32;
    const unsigned int m = j >= lo + 32 ? FULL_MASK
                           : (j > lo ? (1u << (j - lo)) - 1u : 0u);
    c += __popc(row[w] & m);
  }
  return c;
}

__device__ __forceinline__ bool bit_at(const unsigned int* row, int j) {
  return (row[j >> 5] >> (j & 31)) & 1u;
}

__device__ __forceinline__ void load_row(const unsigned int* adjw, int i,
                                         unsigned int* row) {
  const uint4 v = __ldg((const uint4*)(adjw + (long)i * ADJ_WORDS));
  row[0] = v.x; row[1] = v.y; row[2] = v.z; row[3] = v.w;
}

// ---------------------------------------------------------------------------
// prologue: compact edge list, reverse and factor indices from the adjacency
// ---------------------------------------------------------------------------

// One block of MAX_RES threads per replica, thread i owns residue i.  With
// `shared_factors` (K2) the factor block of both (i, j) and (j, i) is that
// of the undirected pair; else (K6) each directed edge has its own.
static __global__ void __launch_bounds__(MAX_RES)
bp_index_kernel(BPScratch sc, int R, long e_cap, bool shared_factors) {
  __shared__ unsigned int adj[MAX_RES * ADJ_WORDS];
  __shared__ int rs[MAX_RES + 1], us[MAX_RES + 1];
  __shared__ int wsum[2][MAX_RES / 32];
  const int r = blockIdx.x, i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const unsigned int* adjw = sc.adjw + (long)r * R * ADJ_WORDS;
  for (int w = i; w < R * ADJ_WORDS; w += MAX_RES) adj[w] = adjw[w];
  __syncthreads();

  const unsigned int* row = adj + i * ADJ_WORDS;
  int deg = 0, below = 0;
  if (i < R) {
    deg = bits_below(row, MAX_RES);
    below = bits_below(row, i);
  }
  const int udeg = deg - below;
  int a = deg, b = udeg;                  // inclusive scans over residues
  for (int off = 1; off < 32; off <<= 1) {
    const int ta = __shfl_up_sync(FULL_MASK, a, off);
    const int tb = __shfl_up_sync(FULL_MASK, b, off);
    if (lane >= off) { a += ta; b += tb; }
  }
  if (lane == 31) { wsum[0][warp] = a; wsum[1][warp] = b; }
  __syncthreads();
  for (int w = 0; w < warp; ++w) { a += wsum[0][w]; b += wsum[1][w]; }
  if (i < R) { rs[i] = a - deg; us[i] = b - udeg; }
  if (i == R - 1) { rs[R] = a; us[R] = b; }
  __syncthreads();

  int* row_start = sc.row_start + (long)r * (R + 1);
  for (int t = i; t <= R; t += MAX_RES) row_start[t] = rs[t];
  if (i == 0) {
    sc.counts[r * N_COUNTS + COUNT_EDGES] = rs[R];
    sc.counts[r * N_COUNTS + COUNT_PAIRS] = us[R];
  }
  if (i >= R) return;

  int* edge_ij = sc.edge_ij + r * e_cap;
  int* edge_rev = sc.edge_rev + r * e_cap;
  int* edge_fac = sc.edge_fac + r * e_cap;
  int* upair = sc.upair + r * (e_cap / 2);
  int e = rs[i], k = 0;
  for (int w = 0; w < ADJ_WORDS; ++w) {
    unsigned int bits = row[w];
    while (bits) {
      const int j = w * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
      const unsigned int* rj = adj + j * ADJ_WORDS;
      const int kj = bits_below(rj, i);   // rank of i among j's partners
      const int u = i < j ? us[i] + k - below
                          : us[j] + kj - bits_below(rj, j);
      if (i < j) upair[u] = e;
      const int f = shared_factors ? u : e;
      edge_ij[e] = i * R + j;
      edge_rev[e] = rs[j] + kj;
      edge_fac[e] = f;
      ++e;
      ++k;
    }
  }
}

// ---------------------------------------------------------------------------
// the solve: one block per replica on compact edges
// ---------------------------------------------------------------------------

// an edge's (i, j, reverse edge, factor block): one packed record in shared
// memory (layouts 0 and 1) or the three global arrays (layout 2)
struct EdgeView {
  const int2* info;
  const int* ij;
  const int* rev;
  const int* fac;
  int R;
  __device__ __forceinline__ void get(int e, int& i, int& j, int& rv,
                                      int& f) const {
    if (info != nullptr) {
      const int2 v = info[e];
      rv = v.x;
      i = v.y & 127;
      j = (v.y >> 7) & 127;
      f = v.y >> 14;
    } else {
      const int t = ij[e];
      i = t / R;
      j = t - i * R;
      rv = rev[e];
      f = fac[e];
    }
  }
};

__device__ __forceinline__ bool slot_valid(const BPNodes& s, int i, int a) {
  return (s.vmask[i] >> a) & 1u;
}

// block-wide sum or max in a fixed order; every thread gets the result
__device__ inline float block_reduce(BPNodes& s, float v, bool is_max) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(FULL_MASK, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) s.red[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = s.red[0];
  for (int w = 1; w < SOLVE_WARPS; ++w)
    out = is_max ? fmaxf(out, s.red[w]) : out + s.red[w];
  __syncthreads();
  return out;
}

// node potentials: offset = min valid E1, prob = exp(offset - E1)
__device__ inline void node_potentials(BPNodes& s, const float* e1,
                                       const unsigned char* valid, int R) {
  for (int i = threadIdx.x; i < R; i += SOLVE_THREADS) {
    float off = INFINITY;
    unsigned int vm = 0u;
    for (int a = 0; a < NROT; ++a)
      if (valid[i * NROT + a]) {
        vm |= 1u << a;
        off = fminf(off, e1[i * NROT + a]);
      }
    s.vmask[i] = (unsigned char)vm;
    s.offset[i] = off;
    for (int a = 0; a < NROT; ++a)
      s.prob[i * NROT + a] = (vm >> a) & 1u ? expf(off - e1[i * NROT + a])
                                            : 0.0f;
  }
}

__device__ __forceinline__ void load_factors(const float* P, int f,
                                             float* p) {
  const float4* src = (const float4*)(P + (long)f * NPAIR);
#pragma unroll
  for (int q = 0; q < NPAIR / 4; ++q) {
    const float4 v = src[q];
    p[4 * q] = v.x; p[4 * q + 1] = v.y; p[4 * q + 2] = v.z; p[4 * q + 3] = v.w;
  }
}

__device__ __forceinline__ void load_message(const float* m, int e,
                                             float* out) {
  const float2* src = (const float2*)(m + (long)e * NROT);
#pragma unroll
  for (int q = 0; q < NROT / 2; ++q) {
    const float2 v = src[q];
    out[2 * q] = v.x; out[2 * q + 1] = v.y;
  }
}

// dst[e = (i, j)] = normalised sum_b P[i,j,:,b] V[b], V[b] = nbv[j,b] /
// (EPS + src[(j, i)][b])
template <bool SHARED_FACTORS>
__device__ inline void edge_update(const BPNodes& s, const float* nbv,
                                   const float* P, const EdgeView& ev,
                                   const float* src, float* dst, int n_edges) {
  for (int e = threadIdx.x; e < n_edges; e += SOLVE_THREADS) {
    int i, j, rv, f;
    ev.get(e, i, j, rv, f);
    float V[NROT], p[NPAIR], m[NROT], norm = 0.0f;
    load_message(src, rv, V);
    // __fdividef (2 ulp): the exact quotient's slow path took 1.6 of the
    // 5.5 us of a 670-edge sweep on an H100
#pragma unroll
    for (int b = 0; b < NROT; ++b)
      V[b] = __fdividef(nbv[j * NROT + b], BP_EPS + V[b]);
    load_factors(P, f, p);
    const bool transposed = SHARED_FACTORS && i > j;
#pragma unroll
    for (int a = 0; a < NROT; ++a) {
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < NROT; ++b)
        acc += (transposed ? p[b * NROT + a] : p[a * NROT + b]) * V[b];
      m[a] = slot_valid(s, i, a) ? acc : 0.0f;
      norm += m[a];
    }
    const float rn = 1.0f / fmaxf(norm, BP_EPS);
    float2* d = (float2*)(dst + (long)e * NROT);
#pragma unroll
    for (int q = 0; q < NROT / 2; ++q)
      d[q] = make_float2(m[2 * q] * rn, m[2 * q + 1] * rn);
  }
}

// log-space node update with max-centring, then the damped mix.  The
// messages lie in (0, 1], where __logf is off by at most 3 ulp or 4e-7,
// below the rounding of the sum itself; logf took 1.2 us of a sweep.
__device__ inline void node_update(BPNodes& s, const float* eb, int R,
                                   float damping) {
  for (int t = threadIdx.x; t < R * NROT; t += SOLVE_THREADS) {
    const int i = t / NROT, a = t - i * NROT;
    float acc = 0.0f;
    for (int e = s.row_start[i]; e < s.row_start[i + 1]; ++e)
      acc += __logf(fmaxf(eb[(long)e * NROT + a], 1e-30f));
    s.lsum[t] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R; i += SOLVE_THREADS) {
    float smax = s.lsum[i * NROT];
    for (int a = 1; a < NROT; ++a) smax = fmaxf(smax, s.lsum[i * NROT + a]);
    float nbn[NROT], mx = 0.0f;
    for (int a = 0; a < NROT; ++a) {
      nbn[a] = s.prob[i * NROT + a] * expf(s.lsum[i * NROT + a] - smax);
      mx = a == 0 ? nbn[a] : fmaxf(mx, nbn[a]);
    }
    const float rmx = 1.0f / fmaxf(mx, BP_EPS);
    for (int a = 0; a < NROT; ++a) {
      float* nb = &s.nb[i * NROT + a];
      *nb = (1.0f - damping) * (nbn[a] * rmx) + damping * (*nb);
    }
  }
  __syncthreads();
}

// max-normalised copy of per-residue values into s.nb
__device__ inline void max_normalise(BPNodes& s, const float* v, int R) {
  for (int i = threadIdx.x; i < R; i += SOLVE_THREADS) {
    float mx = v[i * NROT];
    for (int a = 1; a < NROT; ++a) mx = fmaxf(mx, v[i * NROT + a]);
    const float rmx = 1.0f / fmaxf(mx, BP_EPS);
    for (int a = 0; a < NROT; ++a) s.nb[i * NROT + a] = v[i * NROT + a] * rmx;
  }
}

// Bethe node term (this thread's share) and G1 = b q + (1 - sum b q)
// [first argmin], written to g1 (R, 6); b is in s.nb_prev
__device__ inline float bethe_nodes(const BPNodes& s, const float* e1, int R,
                                    float* g1) {
  const float* b = s.nb_prev;
  float part = 0.0f;
  for (int i = threadIdx.x; i < R; i += SOLVE_THREADS) {
    const float off = s.offset[i];
    float node_en = off, sum_bq = 0.0f, q[NROT];
    for (int a = 0; a < NROT; ++a) {
      const float pa = s.prob[i * NROT + a], ba = b[i * NROT + a];
      q[a] = pa / (BP_EPS + pa);
      if (slot_valid(s, i, a)) {
        node_en += ba * logf((BP_EPS + ba) / (BP_EPS + pa));
        sum_bq += ba * q[a];
      }
    }
    part += node_en;
    bool taken = false;
    for (int a = 0; a < NROT; ++a) {
      float g = 0.0f;
      if (slot_valid(s, i, a)) {
        const bool is_min = !taken && e1[i * NROT + a] <= off;
        taken |= is_min;
        g = b[i * NROT + a] * q[a] + (is_min ? 1.0f - sum_bq : 0.0f);
      }
      g1[(long)i * NROT + a] = g;
    }
  }
  return part;
}

// Start (cold: one undamped sweep from the priors; warm: the given dense
// messages and max-normalised beliefs of this replica), then damped sweeps
// with a convergence check every `chunk` sweeps; then the outputs of the
// solve and the Bethe node term.
template <bool SHARED_FACTORS>
static __global__ void __launch_bounds__(SOLVE_THREADS)
bp_solve_kernel(const float* __restrict__ E1,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ nb0, const float* __restrict__ eb0,
                int R, float damping, int max_iter, float tol, int chunk,
                BPScratch sc, long e_cap, long f_cap,
                float* __restrict__ G1, float* __restrict__ nb_out,
                float* __restrict__ dev_out, int* __restrict__ iters_out) {
  __shared__ BPNodes s;
  extern __shared__ float4 dyn[];
  const int r = blockIdx.x, tid = threadIdx.x;
  const int n_edges = sc.counts[r * N_COUNTS + COUNT_EDGES];
  const int n_fac = SHARED_FACTORS ? sc.counts[r * N_COUNTS + COUNT_PAIRS]
                                   : n_edges;
  const long info_bytes = ((long)n_edges * sizeof(int2) + 15) & ~15L;
  const long need_msg = info_bytes + 2L * n_edges * NROT * sizeof(float);
  const long need_all = need_msg + (long)n_fac * NPAIR * sizeof(float);
  const int layout = need_all <= SOLVE_SMEM_BYTES
                         ? 0 : (need_msg <= SOLVE_SMEM_BYTES ? 1 : 2);

  const float* e1 = E1 + (long)r * R * NROT;
  const int* edge_ij = sc.edge_ij + r * e_cap;
  float* Pg = sc.fac + r * f_cap * NPAIR;
  float* gA = sc.msg + r * 2 * e_cap * NROT;
  float* gB = gA + e_cap * NROT;
  int2* info = layout < 2 ? (int2*)dyn : nullptr;
  float* cur = layout < 2 ? (float*)((char*)dyn + info_bytes) : gA;
  float* nxt = layout < 2 ? cur + (long)n_edges * NROT : gB;
  float* Ps = nxt + (long)n_edges * NROT;         // used in layout 0 only
  const float* P = layout == 0 ? Ps : Pg;
  const EdgeView ev = {info, edge_ij, sc.edge_rev + r * e_cap,
                       sc.edge_fac + r * e_cap, R};

  if (tid == 0) sc.counts[r * N_COUNTS + COUNT_LAYOUT] = layout;
  node_potentials(s, e1, valid, R);
  for (int t = tid; t <= R; t += SOLVE_THREADS)
    s.row_start[t] = sc.row_start[(long)r * (R + 1) + t];
  if (layout < 2)
    for (int e = tid; e < n_edges; e += SOLVE_THREADS) {
      const int t = edge_ij[e], i = t / R, j = t - i * R;
      info[e] = make_int2(ev.rev[e], i | (j << 7) | (ev.fac[e] << 14));
    }
  if (layout == 0) {
    const float4* src = (const float4*)Pg;
    float4* dst = (float4*)Ps;
    for (int t = tid; t < n_fac * (NPAIR / 4); t += SOLVE_THREADS)
      dst[t] = src[t];
  }
  if (nb0 != nullptr) {
    const float2* eb0r = (const float2*)(eb0 + (long)r * R * R * NROT);
    for (int t = tid; t < n_edges * (NROT / 2); t += SOLVE_THREADS) {
      const int e = t / (NROT / 2);
      ((float2*)cur)[t] = __ldg(eb0r + (long)edge_ij[e] * (NROT / 2)
                                + (t - e * (NROT / 2)));
    }
    max_normalise(s, nb0 + (long)r * R * NROT, R);
    __syncthreads();
  } else {
    for (int t = tid; t < n_edges * NROT; t += SOLVE_THREADS) nxt[t] = 1.0f;
    __syncthreads();
    edge_update<SHARED_FACTORS>(s, s.prob, P, ev, nxt, cur, n_edges);
    max_normalise(s, s.prob, R);
    __syncthreads();
  }

  int it = 0;
  float dev = INFINITY;
  while (it < max_iter && dev > tol) {
    for (int c = 0; c < chunk; ++c) {
      for (int t = tid; t < R * NROT; t += SOLVE_THREADS)
        s.nb_prev[t] = s.nb[t];
      edge_update<SHARED_FACTORS>(s, s.nb, P, ev, cur, nxt, n_edges);
      float* tmp = cur; cur = nxt; nxt = tmp;
      __syncthreads();
      node_update(s, cur, R, damping);
    }
    float d = 0.0f;
    for (int t = tid; t < R * NROT; t += SOLVE_THREADS)
      d = fmaxf(d, fabsf(s.nb[t] - s.nb_prev[t]));
    dev = block_reduce(s, d, true);
    it += chunk;
  }

  // sum-normalised beliefs b (left in s.nb_prev), deviation, sweeps, and
  // the final messages in the first global buffer
  float* b = s.nb_prev;
  for (int i = tid; i < R; i += SOLVE_THREADS) {
    float tot = 0.0f;
    for (int a = 0; a < NROT; ++a) tot += s.nb[i * NROT + a];
    const float rt = 1.0f / fmaxf(tot, BP_EPS);
    for (int a = 0; a < NROT; ++a) {
      b[i * NROT + a] = s.nb[i * NROT + a] * rt;
      nb_out[((long)r * R + i) * NROT + a] = b[i * NROT + a];
    }
  }
  if (cur != gA)
    for (int t = tid; t < n_edges * NROT; t += SOLVE_THREADS) gA[t] = cur[t];
  if (tid == 0) {
    dev_out[r] = dev;
    iters_out[r] = it;
  }
  __syncthreads();

  const float part = bethe_nodes(s, e1, R, G1 + (long)r * R * NROT);
  const float total = block_reduce(s, part, false);
  if (tid == 0) sc.fsum[r * N_FSUM] = total;
}

// Bethe edge term over the adjacent pairs i < j, grid-wide: one thread per
// pair (36 logs and 72 quotients each, the quotients with __fdividef;
// inside the solve block this pass took 12 of its 31 us at ubiquitin's
// size, and a team of 36 threads a pair, each forming the pair's
// normalisation again, took longer than one thread), BETHE_BLOCKS blocks a
// replica.  dF/dE2[i,j,a,c] = m pbb / (EPS + pbb) overwrites the edge's
// factor block (a thread reads its block before it writes it); each
// block's share of the energy goes to its slot of `fsum`, summed in a
// fixed order.
static __global__ void __launch_bounds__(BETHE_THREADS)
bp_bethe_edges_kernel(const unsigned char* __restrict__ valid,
                      const float* __restrict__ nb, int R, BPScratch sc,
                      long e_cap, long f_cap) {
  __shared__ float red[BETHE_THREADS / 32];
  const int r = blockIdx.y;
  const int n_pairs = sc.counts[r * N_COUNTS + COUNT_PAIRS];
  const float* b = nb + (long)r * R * NROT;
  const float* msg = sc.msg + r * 2 * e_cap * NROT;
  const int* upair = sc.upair + r * (e_cap / 2);
  const int* edge_ij = sc.edge_ij + r * e_cap;
  const int* edge_rev = sc.edge_rev + r * e_cap;
  const int* edge_fac = sc.edge_fac + r * e_cap;
  float* G = sc.fac + r * f_cap * NPAIR;
  float part = 0.0f;
  for (int u = blockIdx.x * BETHE_THREADS + threadIdx.x; u < n_pairs;
       u += gridDim.x * BETHE_THREADS) {
    const int e = upair[u], ij = edge_ij[e], i = ij / R, j = ij - i * R;
    float p[NPAIR], bi[NROT], bj[NROT], bc1[NROT], bc2[NROT], norm = 0.0f;
    float4* blk = (float4*)(G + (long)edge_fac[e] * NPAIR);
    load_factors((const float*)blk, 0, p);
    load_message(msg, e, bc1);
    load_message(msg, edge_rev[e], bc2);
    unsigned int vi = 0u, vj = 0u;
#pragma unroll
    for (int a = 0; a < NROT; ++a) {
      vi |= (unsigned int)(__ldg(valid + i * NROT + a) != 0) << a;
      vj |= (unsigned int)(__ldg(valid + j * NROT + a) != 0) << a;
      bi[a] = b[i * NROT + a];
      bj[a] = b[j * NROT + a];
      bc1[a] = bi[a] / (BP_EPS + bc1[a]);
      bc2[a] = bj[a] / (BP_EPS + bc2[a]);
    }
#pragma unroll
    for (int a = 0; a < NROT; ++a)
#pragma unroll
      for (int c = 0; c < NROT; ++c)
        norm += p[a * NROT + c] * bc1[a] * bc2[c];
    const float rn = 1.0f / fmaxf(norm, BP_EPS);
#pragma unroll
    for (int q = 0; q < NPAIR / 4; ++q) {
      float g[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int a = (4 * q + k) / NROT, c = (4 * q + k) % NROT;
        g[k] = 0.0f;
        if (((vi >> a) & 1u) && ((vj >> c) & 1u)) {
          const float mm = p[4 * q + k] * bc1[a] * bc2[c] * rn;
          const float pbb = p[4 * q + k] * bi[a] * bj[c];
          part += mm * logf(__fdividef(BP_EPS + mm, BP_EPS + pbb));
          g[k] = __fdividef(mm * pbb, BP_EPS + pbb);
        }
      }
      blk[q] = make_float4(g[0], g[1], g[2], g[3]);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    part += __shfl_xor_sync(FULL_MASK, part, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = red[0];
    for (int w = 1; w < BETHE_THREADS / 32; ++w) total += red[w];
    sc.fsum[r * N_FSUM + 1 + blockIdx.x] = total;
  }
}

// the solve and, behind it, the Bethe edge pass; the solve's shared-memory
// attribute is set at its first launch on each device
template <bool SHARED_FACTORS>
static cudaError_t launch_solve(const float* E1, const unsigned char* valid,
                                const float* nb0, const float* eb0, int n_rep,
                                int R, float damping, int max_iter, float tol,
                                int chunk, BPScratch sc, long e_cap,
                                long f_cap, float* G1, float* nb, float* dev,
                                int* iters, cudaStream_t stream) {
  static bool attribute_set[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attribute_set[device]) {
    err = cudaFuncSetAttribute(bp_solve_kernel<SHARED_FACTORS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SOLVE_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    attribute_set[device] = true;
  }
  bp_solve_kernel<SHARED_FACTORS>
      <<<n_rep, SOLVE_THREADS, SOLVE_SMEM_BYTES, stream>>>(
          E1, valid, nb0, eb0, R, damping, max_iter, tol, chunk, sc, e_cap,
          f_cap, G1, nb, dev, iters);
  bp_bethe_edges_kernel<<<dim3(BETHE_BLOCKS, n_rep), BETHE_THREADS, 0,
                          stream>>>(valid, nb, R, sc, e_cap, f_cap);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// epilogue: the dense message output
// ---------------------------------------------------------------------------

// eb[r, i, j, :] = the message of edge (i, j), 1.0 where there is none; one
// thread per (i, j), three 8-byte stores.  Each replica's first thread also
// adds up F: the node term and the edge pass's blocks, in order.
static __global__ void __launch_bounds__(PASS_THREADS)
bp_messages_kernel(BPScratch sc, int R, long e_cap, float* __restrict__ eb,
                   float* __restrict__ F) {
  const int r = blockIdx.y;
  const int t = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (t == 0) {
    float total = sc.fsum[r * N_FSUM];
    for (int k = 1; k < N_FSUM; ++k) total += sc.fsum[r * N_FSUM + k];
    F[r] = total;
  }
  if (t >= R * R) return;
  const int i = t / R, j = t - i * R;
  unsigned int row[ADJ_WORDS];
  load_row(sc.adjw + (long)r * R * ADJ_WORDS, i, row);
  float2* dst = (float2*)(eb + ((long)r * R * R + t) * NROT);
  if (bit_at(row, j)) {
    const int e = __ldg(sc.row_start + (long)r * (R + 1) + i)
                  + bits_below(row, j);
    const float2* src = (const float2*)(sc.msg + (r * 2 * e_cap + e) * NROT);
    for (int q = 0; q < NROT / 2; ++q) dst[q] = src[q];
  } else {
    for (int q = 0; q < NROT / 2; ++q) dst[q] = make_float2(1.0f, 1.0f);
  }
}

static inline dim3 pass_grid(long items, int n_rep) {
  return dim3((unsigned int)((items + PASS_THREADS - 1) / PASS_THREADS),
              (unsigned int)n_rep);
}

static inline dim3 fill_grid(long cap_items, int n_rep) {
  const long blocks = (cap_items + PASS_THREADS - 1) / PASS_THREADS;
  return dim3((unsigned int)(blocks < FILL_BLOCKS ? blocks : FILL_BLOCKS),
              (unsigned int)n_rep);
}
