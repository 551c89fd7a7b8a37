// K2: bead-space rotamer BP -> Bethe free energy and envelope gradients.
//
// Replaces: upside_md_tpu/ops/pallas_bp.py `_bp_pairs_kernel_rb` (:965)
// with `_lockstep_solve` (:811) (and the per-replica `_bp_pairs_kernel`
// :417), launched by `_bp_pairs_impl` (:1086) for `bp_bethe_pairs` (:1303).
//
// What bounds it on an H100: the bytes of the bead grid it reads and of
// the dense gradient and message outputs it writes, plus the latency of a
// few dependent sweeps (bp_common.cuh).  Only the sweeps are sequential,
// so only they run in the one block a replica owns; the rest is spread
// over the card.
//
// Design: one C entry point; two clears and seven launches on the caller's
// stream.
//
// 1. `pairs_candidate_kernel`: one streaming pass over the bead grid (four
//    16-byte loads in flight a thread) marks the residue pair of every
//    nonzero element; then
//    `pairs_adjacency_kernel`, one thread per residue pair i < j, forms
//    the 36 summed energies of the marked pairs only (the rot-slot scatter
//    by index, slot -> bead table, exact in f32): a pair is adjacent when
//    any is nonzero.  Bits are set with atomicOr, whose result does not
//    depend on the order.  The statics (`slot_beads`, `bead_slot`, `valid`)
//    are a few KB shared by every block and are read through the read-only
//    cache.
// 2. `bp_index_kernel` (bp_common.cuh): compact edges, reverse and factor
//    indices.  Non-adjacent pairs have identity potentials, which leave
//    the fixed point unchanged, and never enter the solve.
// 3. `pairs_factor_kernel`: P = exp(-E2) for the adjacent pairs only, once
//    per undirected pair, one thread per factor (36 neighbouring threads
//    write one 144-byte block), summing with the same device function as
//    the adjacency test, so the two agree.
// 4. `bp_solve_kernel<true>`, the per-replica solve, and behind it
//    `bp_bethe_edges_kernel`, the Bethe edge energy and gradient.
// 5. dF/dE_pair: the grid is cleared with `cudaMemsetAsync` and
//    `pairs_gradient_kernel` writes the compact gradient to the bead pairs
//    of the adjacent slots (both orders); `bp_messages_kernel` writes the
//    dense messages.
#include "bp_common.cuh"

// U[i,j,a,b] + U[j,i,b,a]: the grid summed over the beads of slots (i, a)
// and (j, b), both orders; each sums its rows first, then its columns, as
// the plain version's two gathers do
__device__ __forceinline__ float pair_energy(const float* __restrict__ Ep,
                                             const int* __restrict__ slot_beads,
                                             int sa, int sb, int m_slot,
                                             int n_bead, int n2p) {
  float h1 = 0.0f, h2 = 0.0f;
  for (int k2 = 0; k2 < m_slot; ++k2) {
    const int q = __ldg(slot_beads + sb * m_slot + k2);
    if (q >= n_bead) continue;
    float rows = 0.0f;
    for (int k1 = 0; k1 < m_slot; ++k1) {
      const int p = __ldg(slot_beads + sa * m_slot + k1);
      if (p < n_bead) rows += __ldg(Ep + (long)p * n2p + q);
    }
    h1 += rows;
  }
  for (int k1 = 0; k1 < m_slot; ++k1) {
    const int p = __ldg(slot_beads + sa * m_slot + k1);
    if (p >= n_bead) continue;
    float rows = 0.0f;
    for (int k2 = 0; k2 < m_slot; ++k2) {
      const int q = __ldg(slot_beads + sb * m_slot + k2);
      if (q < n_bead) rows += __ldg(Ep + (long)q * n2p + p);
    }
    h2 += rows;
  }
  return h1 + h2;
}

// Candidate pairs: one streaming pass over the bead grid marks the residue
// pair of every nonzero element.  A thread takes CAND_LOADS groups of four
// columns, PASS_THREADS groups apart, and loads them all (one 16-byte load
// each where the grid's width allows) before it looks at any.  A superset
// of the adjacency (the summed energies of a marked pair can still cancel);
// `cand` holds one bit per pair i < j, as adjacency words.
#define CAND_LOADS 4
static __global__ void __launch_bounds__(PASS_THREADS)
pairs_candidate_kernel(const float* __restrict__ Epair,
                       const int* __restrict__ bead_slot, int R, int n_bead,
                       int n2p, unsigned int* __restrict__ cand) {
  const int r = blockIdx.y;
  const int nn = n2p * n2p;
  const float* src = Epair + (long)r * nn;
  const bool vec = (nn & 3) == 0;
  float v[CAND_LOADS][4];
  int t0[CAND_LOADS];
#pragma unroll
  for (int u = 0; u < CAND_LOADS; ++u) {
    t0[u] = 4 * ((blockIdx.x * CAND_LOADS + u) * PASS_THREADS + threadIdx.x);
    v[u][0] = v[u][1] = v[u][2] = v[u][3] = 0.0f;
    if (t0[u] >= nn) continue;
    if (vec) {
      const float4 q = __ldg((const float4*)(src + t0[u]));
      v[u][0] = q.x; v[u][1] = q.y; v[u][2] = q.z; v[u][3] = q.w;
    } else {
      for (int k = 0; k < 4 && t0[u] + k < nn; ++k)
        v[u][k] = __ldg(src + t0[u] + k);
    }
  }
  unsigned int* words = cand + (long)r * R * ADJ_WORDS;
  int last = -1;                  // the pair this thread marked last
#pragma unroll
  for (int u = 0; u < CAND_LOADS; ++u) {
    if (v[u][0] == 0.0f && v[u][1] == 0.0f && v[u][2] == 0.0f
        && v[u][3] == 0.0f)
      continue;
    int p = t0[u] / n2p, q = t0[u] - p * n2p;
    for (int k = 0; k < 4; ++k) {
      if (v[u][k] != 0.0f && p < n_bead && q < n_bead) {
        const int ri = __ldg(bead_slot + p) / NROT;
        const int rj = __ldg(bead_slot + q) / NROT;
        const int lo = ri < rj ? ri : rj, hi = ri < rj ? rj : ri;
        // neighbouring beads mostly share a residue, so a thread marks a
        // pair once; setting a bit twice changes nothing, and the atomic
        // returns nothing the thread waits for
        if (ri != rj && lo * MAX_RES + hi != last) {
          last = lo * MAX_RES + hi;
          atomicOr(words + lo * ADJ_WORDS + (hi >> 5), 1u << (hi & 31));
        }
      }
      if (++q == n2p) { q = 0; ++p; }
    }
  }
}

// The adjacency: one thread per residue pair i < j; a candidate pair is
// adjacent when any of its 36 summed energies is nonzero.
static __global__ void __launch_bounds__(PASS_THREADS)
pairs_adjacency_kernel(const float* __restrict__ Epair,
                       const int* __restrict__ slot_beads, int R, int n_bead,
                       int n2p, int m_slot,
                       const unsigned int* __restrict__ cand,
                       unsigned int* __restrict__ adjw) {
  const int r = blockIdx.y;
  const int t = blockIdx.x * PASS_THREADS + threadIdx.x;
  if (t >= R * R) return;
  const int i = t / R, j = t - i * R;
  if (i >= j) return;
  if (!((cand[((long)r * R + i) * ADJ_WORDS + (j >> 5)] >> (j & 31)) & 1u))
    return;
  const float* Ep = Epair + (long)r * n2p * n2p;
  bool any = false;
  if (m_slot == 1) {
    // one bead a slot: 12 indices, then 72 loads that do not wait for one
    // another (the sums are those of `pair_energy`)
    int p[NROT], q[NROT];
#pragma unroll
    for (int a = 0; a < NROT; ++a) {
      p[a] = __ldg(slot_beads + i * NROT + a);
      q[a] = __ldg(slot_beads + j * NROT + a);
    }
#pragma unroll
    for (int ab = 0; ab < NPAIR; ++ab) {
      const int pa = p[ab / NROT], qb = q[ab % NROT];
      const bool both = pa < n_bead && qb < n_bead;
      const float h1 = both ? __ldg(Ep + (long)pa * n2p + qb) : 0.0f;
      const float h2 = both ? __ldg(Ep + (long)qb * n2p + pa) : 0.0f;
      any |= h1 + h2 != 0.0f;
    }
  } else {
    for (int ab = 0; ab < NPAIR; ++ab)
      any |= pair_energy(Ep, slot_beads, i * NROT + ab / NROT,
                         j * NROT + ab % NROT, m_slot, n_bead, n2p) != 0.0f;
  }
  if (!any) return;
  unsigned int* adj = adjw + (long)r * R * ADJ_WORDS;
  atomicOr(&adj[i * ADJ_WORDS + (j >> 5)], 1u << (j & 31));
  atomicOr(&adj[j * ADJ_WORDS + (i >> 5)], 1u << (i & 31));
}

static __global__ void __launch_bounds__(PASS_THREADS)
pairs_factor_kernel(const float* __restrict__ Epair,
                    const int* __restrict__ slot_beads,
                    const unsigned char* __restrict__ valid, int R, int n_bead,
                    int n2p, int m_slot, BPScratch sc, long e_cap) {
  const int r = blockIdx.y;
  const int n = sc.counts[r * N_COUNTS + COUNT_PAIRS] * NPAIR;
  const float* Ep = Epair + (long)r * n2p * n2p;
  const int* upair = sc.upair + r * (e_cap / 2);
  const int* edge_ij = sc.edge_ij + r * e_cap;
  float* fac = sc.fac + r * (e_cap / 2) * NPAIR;
  for (int t = blockIdx.x * PASS_THREADS + threadIdx.x; t < n;
       t += gridDim.x * PASS_THREADS) {
    const int u = t / NPAIR, ab = t - u * NPAIR;
    const int ij = edge_ij[upair[u]], i = ij / R, j = ij - i * R;
    const int sa = i * NROT + ab / NROT, sb = j * NROT + ab % NROT;
    const float e2 = pair_energy(Ep, slot_beads, sa, sb, m_slot, n_bead, n2p);
    fac[t] = __ldg(valid + sa) && __ldg(valid + sb) ? expf(-e2) : 0.0f;
  }
}

// dF/dE_pair over the cleared grid: one thread per (adjacent pair i < j,
// a, b) writes its gradient to every bead pair of the two slots, both
// orders
static __global__ void __launch_bounds__(PASS_THREADS)
pairs_gradient_kernel(const int* __restrict__ slot_beads, int R, int n_bead,
                      int n2p, int m_slot, BPScratch sc, long e_cap,
                      float* __restrict__ dE) {
  const int r = blockIdx.y;
  const int n = sc.counts[r * N_COUNTS + COUNT_PAIRS] * NPAIR;
  const int* upair = sc.upair + r * (e_cap / 2);
  const int* edge_ij = sc.edge_ij + r * e_cap;
  const float* G = sc.fac + r * (e_cap / 2) * NPAIR;
  float* out = dE + (long)r * n2p * n2p;
  for (int t = blockIdx.x * PASS_THREADS + threadIdx.x; t < n;
       t += gridDim.x * PASS_THREADS) {
    const int u = t / NPAIR, ab = t - u * NPAIR;
    const int ij = edge_ij[upair[u]], i = ij / R, j = ij - i * R;
    const int sa = i * NROT + ab / NROT, sb = j * NROT + ab % NROT;
    const float g = G[t];
    for (int k1 = 0; k1 < m_slot; ++k1) {
      const int p = __ldg(slot_beads + sa * m_slot + k1);
      if (p >= n_bead) continue;
      for (int k2 = 0; k2 < m_slot; ++k2) {
        const int q = __ldg(slot_beads + sb * m_slot + k2);
        if (q >= n_bead) continue;
        out[(long)p * n2p + q] = g;
        out[(long)q * n2p + p] = g;
      }
    }
  }
}

extern "C" int bp_bethe_pairs(
    const float* E1, const float* Epair, const int* slot_beads,
    const int* bead_slot, const unsigned char* valid, const float* nb0,
    const float* eb0, int n_rep, int R, int n_bead, int n2p, int m_slot,
    float damping, int max_iter, float tol, int chunk, float* F, float* G1,
    float* dE, float* nb, float* eb, float* dev, int* iters, int* iscratch,
    float* fscratch, void* stream_ptr) {
  if (R > MAX_RES || R < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long e_cap = (long)R * (R - 1);
  const BPScratch sc = make_scratch(iscratch, fscratch, n_rep, R, e_cap / 2);
  // the candidate words follow the adjacency words in the scratch
  cudaError_t err = cudaMemsetAsync(
      sc.adjw, 0, 2 * sizeof(unsigned int) * n_rep * R * ADJ_WORDS, stream);
  if (err != cudaSuccess) return (int)err;
  pairs_candidate_kernel<<<pass_grid(((long)n2p * n2p + 4 * CAND_LOADS - 1)
                                         / (4 * CAND_LOADS), n_rep),
                           PASS_THREADS, 0, stream>>>(
      Epair, bead_slot, R, n_bead, n2p, sc.cand);
  pairs_adjacency_kernel<<<pass_grid((long)R * R, n_rep), PASS_THREADS, 0,
                           stream>>>(Epair, slot_beads, R, n_bead, n2p,
                                     m_slot, sc.cand, sc.adjw);
  bp_index_kernel<<<n_rep, MAX_RES, 0, stream>>>(sc, R, e_cap, true);
  pairs_factor_kernel<<<fill_grid(e_cap / 2 * NPAIR, n_rep), PASS_THREADS, 0,
                        stream>>>(Epair, slot_beads, valid, R, n_bead, n2p,
                                  m_slot, sc, e_cap);
  err = launch_solve<true>(E1, valid, nb0, eb0, n_rep, R, damping, max_iter,
                           tol, chunk, sc, e_cap, e_cap / 2, G1, nb, dev,
                           iters, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(dE, 0, sizeof(float) * n_rep * n2p * n2p, stream);
  if (err != cudaSuccess) return (int)err;
  pairs_gradient_kernel<<<fill_grid(e_cap / 2 * NPAIR, n_rep), PASS_THREADS,
                          0, stream>>>(slot_beads, R, n_bead, n2p, m_slot, sc,
                                       e_cap, dE);
  bp_messages_kernel<<<pass_grid((long)R * R, n_rep), PASS_THREADS, 0,
                       stream>>>(sc, R, e_cap, eb, F);
  return (int)cudaGetLastError();
}
