// K2: bead-space rotamer BP -> Bethe free energy and envelope gradients.
//
// Replaces: upside_md_tpu/ops/pallas_bp.py `_bp_pairs_kernel_rb` (:965)
// with `_lockstep_solve` (:811) (and the per-replica `_bp_pairs_kernel`
// :417), launched by `_bp_pairs_impl` (:1086) for `bp_bethe_pairs` (:1303).
//
// What bounds it on an H100: latency.  One replica's problem is small
// (76 residues, ~1-2k directed edges, 6x6 factors) and the solve is a
// chain of dependent sweeps, so each block spends its time waiting on
// L2 reads of the factor and message arrays between block-wide barriers.
// The pair factors P (R*R*36 floats, ~830 KB per replica) and the
// double-buffered messages do not fit in shared memory and live in global
// scratch, where they stay in L2.
//
// Design: one block per replica runs the whole solve, so each replica
// stops at its own convergence (the reference semantics; the TPU default
// sweeps a replica block in lockstep).  The rot-slot scatter is by index
// (slot -> bead table), exact in f32, one thread per residue pair: it
// forms the 36 summed energies, marks the pair adjacent when any is
// nonzero, and writes P = exp(-E2) for both orientations.  Non-adjacent
// pairs have identity potentials, which leave the fixed point unchanged,
// and are skipped: the sweeps run over a compact list of adjacent directed
// edges.  The schedule follows `_bp_solve` (upside_md_tpu/nodes/rotamer.py
// :60-140); the Bethe energy and gradients follow `bethe_free_energy`
// (:142).  The solve and the Bethe passes are shared with K6
// (bp_common.cuh).
#include "bp_common.cuh"

static __global__ void __launch_bounds__(BP_THREADS)
bp_kernel(const float* __restrict__ E1, const float* __restrict__ Epair,
          const int* __restrict__ slot_beads,
          const int* __restrict__ bead_slot,
          const unsigned char* __restrict__ valid,
          const float* __restrict__ nb0, const float* __restrict__ eb0,
          int R, int n_bead, int n2p, int m_slot, float damping,
          int max_iter, float tol, int chunk,
          float* __restrict__ F, float* __restrict__ G1,
          float* __restrict__ dE, float* __restrict__ nb_out,
          float* __restrict__ eb_out, float* __restrict__ dev_out,
          int* __restrict__ iters_out, float* __restrict__ pbuf,
          float* __restrict__ ebuf, int* __restrict__ edge_buf) {
  __shared__ BPSmem s;
  const int r = blockIdx.x, tid = threadIdx.x;
  const long RR = (long)R * R;
  const float* e1 = E1 + (long)r * R * NROT;
  const float* Ep = Epair + (long)r * n2p * n2p;
  float* P = pbuf + (long)r * RR * NPAIR;
  float* ebA = ebuf + (long)r * 2 * RR * NROT;
  float* ebB = ebA + RR * NROT;
  int* edges = edge_buf + (long)r * R * (R - 1);
  const PairLayout L = {NPAIR, 1};   // P[i][j][a*6+b]

  node_potentials(s, e1, valid, R);
  for (int w = tid; w < R * ADJ_WORDS; w += BP_THREADS) s.adj[w] = 0u;
  __syncthreads();

  // ---- rot-slot scatter by index, one thread per residue pair i < j
  for (long t = tid; t < RR; t += BP_THREADS) {
    const int i = (int)(t / R), j = (int)(t % R);
    if (i >= j) continue;
    float u[NPAIR];
    bool any = false;
    for (int a = 0; a < NROT; ++a)
      for (int b = 0; b < NROT; ++b) {
        float h1 = 0.0f, h2 = 0.0f;       // U[i,j,a,b] and U[j,i,b,a]
        for (int k1 = 0; k1 < m_slot; ++k1) {
          const int p = slot_beads[(i * NROT + a) * m_slot + k1];
          if (p >= n_bead) continue;
          for (int k2 = 0; k2 < m_slot; ++k2) {
            const int q = slot_beads[(j * NROT + b) * m_slot + k2];
            if (q >= n_bead) continue;
            h1 += Ep[(long)p * n2p + q];
          }
        }
        for (int k2 = 0; k2 < m_slot; ++k2) {
          const int q = slot_beads[(j * NROT + b) * m_slot + k2];
          if (q >= n_bead) continue;
          for (int k1 = 0; k1 < m_slot; ++k1) {
            const int p = slot_beads[(i * NROT + a) * m_slot + k1];
            if (p >= n_bead) continue;
            h2 += Ep[(long)q * n2p + p];
          }
        }
        const float e2 = h1 + h2;
        u[a * NROT + b] = e2;
        any |= e2 != 0.0f;
      }
    if (!any) continue;
    atomicOr(&s.adj[i * ADJ_WORDS + (j >> 5)], 1u << (j & 31));
    atomicOr(&s.adj[j * ADJ_WORDS + (i >> 5)], 1u << (i & 31));
    float* Pij = P + ((long)i * R + j) * NPAIR;
    float* Pji = P + ((long)j * R + i) * NPAIR;
    for (int a = 0; a < NROT; ++a)
      for (int b = 0; b < NROT; ++b) {
        const bool vm = valid[i * NROT + a] && valid[j * NROT + b];
        const float pv = vm ? expf(-u[a * NROT + b]) : 0.0f;
        Pij[a * NROT + b] = pv;
        Pji[b * NROT + a] = pv;
      }
  }
  __syncthreads();

  build_edges(s, edges, R);
  int it;
  float dev;
  const float* cur = bp_solve(
      s, P, L, edges, valid, R, nb0 ? nb0 + (long)r * R * NROT : nullptr,
      eb0 ? eb0 + (long)r * RR * NROT : nullptr, ebA, ebB, damping, max_iter,
      tol, chunk, it, dev);
  bp_outputs(s, cur, R, nb_out + (long)r * R * NROT, eb_out + r * RR * NROT,
             dev_out + r, iters_out + r, it, dev);

  // ---- Bethe terms; the edge gradient G overwrites P in place
  float part = bethe_nodes(s, e1, valid, R, G1 + (long)r * R * NROT);
  part += bethe_edges(s, P, L, cur, edges, valid, R, P, L, true);
  const float total = block_reduce(s, part, 0);
  if (tid == 0) F[r] = total;

  // ---- dF/dE_pair[p, q] = G at the ordered residue pair of beads p, q
  const long nn = (long)n2p * n2p;
  for (long t = tid; t < nn; t += BP_THREADS) {
    const int p = (int)(t / n2p), q = (int)(t % n2p);
    float g = 0.0f;
    if (p < n_bead && q < n_bead) {
      const int sp = bead_slot[p], sq = bead_slot[q];
      const int i = sp / NROT, j = sq / NROT;
      if (i != j && is_adj(s, i, j))
        g = P[((long)i * R + j) * NPAIR + (sp % NROT) * NROT + (sq % NROT)];
    }
    dE[(long)r * nn + t] = g;
  }
}

extern "C" int bp_bethe_pairs(
    const float* E1, const float* Epair, const int* slot_beads,
    const int* bead_slot, const unsigned char* valid, const float* nb0,
    const float* eb0, int n_rep, int R, int n_bead, int n2p, int m_slot,
    float damping, int max_iter, float tol, int chunk, float* F,
    float* G1, float* dE, float* nb, float* eb, float* dev, int* iters,
    float* pbuf, float* ebuf, int* edges, void* stream_ptr) {
  if (R > MAX_RES || R < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  bp_kernel<<<n_rep, BP_THREADS, 0, stream>>>(
      E1, Epair, slot_beads, bead_slot, valid, nb0, eb0, R, n_bead, n2p,
      m_slot, damping, max_iter, tol, chunk, F, G1, dE, nb, eb, dev,
      iters, pbuf, ebuf, edges);
  return (int)cudaGetLastError();
}
