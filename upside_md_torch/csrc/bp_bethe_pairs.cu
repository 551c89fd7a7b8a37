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
// (:142).  Block reductions run in a fixed order.
#include <cuda_runtime.h>
#include <math.h>

#define NROT 6
#define NPAIR 36
#define BP_EPS 1e-10f
#define BP_THREADS 256
#define MAX_RES 128
#define ADJ_WORDS (MAX_RES / 32)

struct BPSmem {
  float prob[MAX_RES * NROT];
  float nb[MAX_RES * NROT];
  float nb_prev[MAX_RES * NROT];
  float lsum[MAX_RES * NROT];
  float offset[MAX_RES];
  unsigned int adj[MAX_RES * ADJ_WORDS];
  float red[BP_THREADS];
  int cnt[BP_THREADS];
  int n_edges;
};

__device__ __forceinline__ bool is_adj(const BPSmem& s, int i, int j) {
  return (s.adj[i * ADJ_WORDS + (j >> 5)] >> (j & 31)) & 1u;
}

// fixed-order tree reduction over the block (op: 0 = sum, 1 = max)
__device__ float block_reduce(BPSmem& s, float v, int op) {
  const int tid = threadIdx.x;
  s.red[tid] = v;
  __syncthreads();
  for (int w = BP_THREADS / 2; w > 0; w >>= 1) {
    if (tid < w)
      s.red[tid] = op == 0 ? s.red[tid] + s.red[tid + w]
                           : fmaxf(s.red[tid], s.red[tid + w]);
    __syncthreads();
  }
  float out = s.red[0];
  __syncthreads();
  return out;
}

// eb_dst[i,j,:] = normalised sum_b P[i,j,:,b] V[j,i,b] over adjacent
// directed edges, V[j,i,b] = nbv[j,b] / (EPS + eb_src[j,i,b])
__device__ void edge_update(const BPSmem& s, const float* nbv,
                            const float* P, const float* src, float* dst,
                            const int* edges, const unsigned char* valid,
                            int R) {
  for (int e = threadIdx.x; e < s.n_edges; e += BP_THREADS) {
    const int i = edges[e] / R, j = edges[e] % R;
    float V[NROT];
    const float* sji = src + ((long)j * R + i) * NROT;
    for (int b = 0; b < NROT; ++b) V[b] = nbv[j * NROT + b] / (BP_EPS + sji[b]);
    const float* Pij = P + ((long)i * R + j) * NPAIR;
    float m[NROT], norm = 0.0f;
    for (int a = 0; a < NROT; ++a) {
      float acc = 0.0f;
      for (int b = 0; b < NROT; ++b) acc += Pij[a * NROT + b] * V[b];
      m[a] = valid[i * NROT + a] ? acc : 0.0f;
      norm += m[a];
    }
    const float rn = 1.0f / fmaxf(norm, BP_EPS);
    float* dij = dst + ((long)i * R + j) * NROT;
    for (int a = 0; a < NROT; ++a) dij[a] = m[a] * rn;
  }
}

// log-space node update with max-centring, then the damped mix
__device__ void node_update(BPSmem& s, const float* eb, int R,
                            float damping) {
  for (int t = threadIdx.x; t < R * NROT; t += BP_THREADS) {
    const int i = t / NROT, a = t % NROT;
    float acc = 0.0f;
    for (int j = 0; j < R; ++j)
      if (is_adj(s, i, j))
        acc += logf(fmaxf(eb[((long)i * R + j) * NROT + a], 1e-30f));
    s.lsum[t] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < R; i += BP_THREADS) {
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

static __global__ void __launch_bounds__(BP_THREADS)
bp_kernel(const float* __restrict__ E1, const float* __restrict__ Epair,
          const int* __restrict__ slot_beads,
          const int* __restrict__ bead_slot,
          const unsigned char* __restrict__ valid,
          const float* __restrict__ nb0, const float* __restrict__ eb0,
          int R, int n_bead, int n2p, int m_slot, int warm, float damping,
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

  // ---- node potentials: offset = min valid E1, prob = exp(offset - E1)
  for (int i = tid; i < R; i += BP_THREADS) {
    float off = INFINITY;
    for (int a = 0; a < NROT; ++a)
      if (valid[i * NROT + a]) off = fminf(off, e1[i * NROT + a]);
    s.offset[i] = off;
    for (int a = 0; a < NROT; ++a)
      s.prob[i * NROT + a] = valid[i * NROT + a] ? expf(off - e1[i * NROT + a])
                                                 : 0.0f;
  }
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

  // ---- compact list of adjacent directed edges, row-major order
  {
    const long per = (RR + BP_THREADS - 1) / BP_THREADS;
    const long lo = tid * per, hi = lo + per < RR ? lo + per : RR;
    int c = 0;
    for (long t = lo; t < hi; ++t) {
      const int i = (int)(t / R), j = (int)(t % R);
      c += (i != j) && is_adj(s, i, j);
    }
    s.cnt[tid] = c;
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int k = 0; k < BP_THREADS; ++k) {
        const int v = s.cnt[k];
        s.cnt[k] = acc;
        acc += v;
      }
      s.n_edges = acc;
    }
    __syncthreads();
    int o = s.cnt[tid];
    for (long t = lo; t < hi; ++t) {
      const int i = (int)(t / R), j = (int)(t % R);
      if (i != j && is_adj(s, i, j)) edges[o++] = (int)t;
    }
    __syncthreads();
  }

  // ---- start: cold (one undamped sweep from the priors) or warm
  float* cur = ebA;
  float* nxt = ebB;
  if (warm) {
    for (int e = tid; e < s.n_edges; e += BP_THREADS) {
      const long base = (long)edges[e] * NROT;
      for (int a = 0; a < NROT; ++a)
        cur[base + a] = eb0[(long)r * RR * NROT + base + a];
    }
    for (int i = tid; i < R; i += BP_THREADS) {
      float mx = 0.0f;
      for (int a = 0; a < NROT; ++a)
        mx = a == 0 ? nb0[((long)r * R + i) * NROT]
                    : fmaxf(mx, nb0[((long)r * R + i) * NROT + a]);
      const float rmx = 1.0f / fmaxf(mx, BP_EPS);
      for (int a = 0; a < NROT; ++a)
        s.nb[i * NROT + a] = nb0[((long)r * R + i) * NROT + a] * rmx;
    }
    __syncthreads();
  } else {
    for (int e = tid; e < s.n_edges; e += BP_THREADS) {
      const long base = (long)edges[e] * NROT;
      for (int a = 0; a < NROT; ++a) nxt[base + a] = 1.0f;
    }
    __syncthreads();
    edge_update(s, s.prob, P, nxt, cur, edges, valid, R);
    for (int i = tid; i < R; i += BP_THREADS) {
      float mx = s.prob[i * NROT];
      for (int a = 1; a < NROT; ++a) mx = fmaxf(mx, s.prob[i * NROT + a]);
      const float rmx = 1.0f / fmaxf(mx, BP_EPS);
      for (int a = 0; a < NROT; ++a)
        s.nb[i * NROT + a] = s.prob[i * NROT + a] * rmx;
    }
    __syncthreads();
  }

  // ---- damped sweeps, convergence checked every `chunk` sweeps
  int it = 0;
  float dev = INFINITY;
  while (it < max_iter && dev > tol) {
    for (int c = 0; c < chunk; ++c) {
      for (int t = tid; t < R * NROT; t += BP_THREADS) s.nb_prev[t] = s.nb[t];
      edge_update(s, s.nb, P, cur, nxt, edges, valid, R);
      float* tmp = cur; cur = nxt; nxt = tmp;
      __syncthreads();
      node_update(s, cur, R, damping);
    }
    float d = 0.0f;
    for (int t = tid; t < R * NROT; t += BP_THREADS)
      d = fmaxf(d, fabsf(s.nb[t] - s.nb_prev[t]));
    dev = block_reduce(s, d, 1);
    it += chunk;
  }

  // ---- outputs of the solve: sum-normalised beliefs b, messages
  float* b = s.nb_prev;
  for (int i = tid; i < R; i += BP_THREADS) {
    float tot = 0.0f;
    for (int a = 0; a < NROT; ++a) tot += s.nb[i * NROT + a];
    const float rt = 1.0f / fmaxf(tot, BP_EPS);
    for (int a = 0; a < NROT; ++a) {
      b[i * NROT + a] = s.nb[i * NROT + a] * rt;
      nb_out[((long)r * R + i) * NROT + a] = b[i * NROT + a];
    }
  }
  for (long t = tid; t < RR * NROT; t += BP_THREADS) {
    const int i = (int)(t / ((long)R * NROT)), j = (int)((t / NROT) % R);
    eb_out[(long)r * RR * NROT + t] =
        (i != j && is_adj(s, i, j)) ? cur[t] : 1.0f;
  }
  if (tid == 0) {
    dev_out[r] = dev;
    iters_out[r] = it;
  }
  __syncthreads();

  // ---- Bethe node term and G1 = b q + (1 - sum b q) [first argmin]
  float part = 0.0f;
  for (int i = tid; i < R; i += BP_THREADS) {
    const float off = s.offset[i];
    float node_en = off, sum_bq = 0.0f, q[NROT];
    for (int a = 0; a < NROT; ++a) {
      const float pa = s.prob[i * NROT + a], ba = b[i * NROT + a];
      q[a] = pa / (BP_EPS + pa);
      if (valid[i * NROT + a]) {
        node_en += ba * logf((BP_EPS + ba) / (BP_EPS + pa));
        sum_bq += ba * q[a];
      }
    }
    part += node_en;
    bool taken = false;
    for (int a = 0; a < NROT; ++a) {
      float g = 0.0f;
      if (valid[i * NROT + a]) {
        const bool is_min = !taken && e1[i * NROT + a] <= off;
        taken |= is_min;
        g = b[i * NROT + a] * q[a] + (is_min ? 1.0f - sum_bq : 0.0f);
      }
      G1[((long)r * R + i) * NROT + a] = g;
    }
  }

  // ---- Bethe edge term over adjacent i < j; G overwrites P in place
  for (int e = tid; e < s.n_edges; e += BP_THREADS) {
    const int i = edges[e] / R, j = edges[e] % R;
    if (i > j) continue;
    float* Pij = P + ((long)i * R + j) * NPAIR;
    float* Pji = P + ((long)j * R + i) * NPAIR;
    const float* eij = cur + ((long)i * R + j) * NROT;
    const float* eji = cur + ((long)j * R + i) * NROT;
    float bc1[NROT], bc2[NROT], mr[NPAIR], norm = 0.0f;
    for (int a = 0; a < NROT; ++a) {
      bc1[a] = b[i * NROT + a] / (BP_EPS + eij[a]);
      bc2[a] = b[j * NROT + a] / (BP_EPS + eji[a]);
    }
    for (int a = 0; a < NROT; ++a)
      for (int c = 0; c < NROT; ++c) {
        mr[a * NROT + c] = Pij[a * NROT + c] * bc1[a] * bc2[c];
        norm += mr[a * NROT + c];
      }
    const float rn = 1.0f / fmaxf(norm, BP_EPS);
    for (int a = 0; a < NROT; ++a)
      for (int c = 0; c < NROT; ++c) {
        float g = 0.0f;
        if (valid[i * NROT + a] && valid[j * NROT + c]) {
          const float mm = mr[a * NROT + c] * rn;
          const float pbb = Pij[a * NROT + c] * b[i * NROT + a] * b[j * NROT + c];
          part += mm * logf((BP_EPS + mm) / (BP_EPS + pbb));
          g = mm * pbb / (BP_EPS + pbb);
        }
        Pij[a * NROT + c] = g;
        Pji[c * NROT + a] = g;
      }
  }
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
    int warm, float damping, int max_iter, float tol, int chunk, float* F,
    float* G1, float* dE, float* nb, float* eb, float* dev, int* iters,
    float* pbuf, float* ebuf, int* edges, void* stream_ptr) {
  if (R > MAX_RES || R < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  bp_kernel<<<n_rep, BP_THREADS, 0, stream>>>(
      E1, Epair, slot_beads, bead_slot, valid, nb0, eb0, R, n_bead, n2p,
      m_slot, warm, damping, max_iter, tol, chunk, F, G1, dE, nb, eb, dev,
      iters, pbuf, ebuf, edges);
  return (int)cudaGetLastError();
}
