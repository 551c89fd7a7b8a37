// K6: residue-plane rotamer BP -> Bethe free energy and envelope gradients.
//
// Replaces: upside_md_tpu/ops/pallas_bp.py `_bp_kernel` (:230), launched by
// `_bp_impl` (:306) for `bp_bethe_pallas` (:355): the BP path for more than
// 512 beads (nodes/rotamer.py:447-461).
//
// What bounds it on an H100: latency, as K2.  The solve is a chain of
// dependent sweeps over one replica's adjacent directed edges (124 residues
// at the RNase A shapes), each sweep two block-wide phases with barriers
// between them; the factor planes (36 x R x R floats, ~2.2 MB per replica)
// and the double-buffered messages live in global memory and L2.
//
// Design: one block per replica runs the whole solve and exits at its own
// convergence.  The Boltzmann planes P = exp(-E2) with validity folded in
// arrive from the wrapper (the JAX package forms them in XLA too, :313-321)
// and are read in place as 36 (a*6+b) planes: for one (a, b), neighbouring
// threads take neighbouring edges (i, j), (i, j+1), so plane reads
// coalesce.  The adjacency is an input, as in the TPU kernel; each thread
// packs whole 32-bit words of it (no atomics).  The sweeps, the Bethe terms
// and the gradients are K2's (bp_common.cuh) with the plane layout; G1 and
// the gradient planes G2 (nonzero on adjacent i < j only, :293-301) are
// written by the kernel, which zeroes its replica's G2 first.
#include "bp_common.cuh"

static __global__ void __launch_bounds__(BP_THREADS)
bp_planes_kernel(const float* __restrict__ E1, const float* __restrict__ Pl,
                 const unsigned char* __restrict__ adj_in,
                 const unsigned char* __restrict__ valid,
                 const float* __restrict__ nb0, const float* __restrict__ eb0,
                 int R, float damping, int max_iter, float tol, int chunk,
                 float* __restrict__ F, float* __restrict__ G1,
                 float* __restrict__ G2, float* __restrict__ nb_out,
                 float* __restrict__ eb_out, float* __restrict__ dev_out,
                 int* __restrict__ iters_out, float* __restrict__ ebuf,
                 int* __restrict__ edge_buf) {
  __shared__ BPSmem s;
  const int r = blockIdx.x, tid = threadIdx.x;
  const long RR = (long)R * R;
  const float* e1 = E1 + (long)r * R * NROT;
  const float* P = Pl + (long)r * NPAIR * RR;
  const unsigned char* adj = adj_in + (long)r * RR;
  float* G = G2 + (long)r * NPAIR * RR;
  float* ebA = ebuf + (long)r * 2 * RR * NROT;
  float* ebB = ebA + RR * NROT;
  int* edges = edge_buf + (long)r * R * (R - 1);
  const PairLayout L = {1, (int)RR};   // P[a*6+b][i][j]

  for (long t = tid; t < NPAIR * RR; t += BP_THREADS) G[t] = 0.0f;
  node_potentials(s, e1, valid, R);
  for (int w = tid; w < R * ADJ_WORDS; w += BP_THREADS) {
    const int i = w / ADJ_WORDS, j0 = (w % ADJ_WORDS) * 32;
    unsigned int bits = 0u;
    for (int j = j0; j < j0 + 32 && j < R; ++j)
      if (j != i && adj[(long)i * R + j]) bits |= 1u << (j & 31);
    s.adj[w] = bits;
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

  float part = bethe_nodes(s, e1, valid, R, G1 + (long)r * R * NROT);
  part += bethe_edges(s, P, L, cur, edges, valid, R, G, L, false);
  const float total = block_reduce(s, part, 0);
  if (tid == 0) F[r] = total;
}

extern "C" int bp_bethe_planes(
    const float* E1, const float* P, const unsigned char* adj,
    const unsigned char* valid, const float* nb0, const float* eb0,
    int n_rep, int R, float damping, int max_iter, float tol, int chunk,
    float* F, float* G1, float* G2, float* nb, float* eb, float* dev,
    int* iters, float* ebuf, int* edges, void* stream_ptr) {
  if (R > MAX_RES || R < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  bp_planes_kernel<<<n_rep, BP_THREADS, 0, stream>>>(
      E1, P, adj, valid, nb0, eb0, R, damping, max_iter, tol, chunk, F, G1,
      G2, nb, eb, dev, iters, ebuf, edges);
  return (int)cudaGetLastError();
}
