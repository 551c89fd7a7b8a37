// The block-wide rotamer BP solve shared by K2 (bp_bethe_pairs.cu) and K6
// (bp_bethe_planes.cu): one block of BP_THREADS threads solves one
// replica's problem.  The schedule follows `_bp_solve`
// (upside_md_tpu/nodes/rotamer.py:60-140), the Bethe energy and its
// envelope gradients `bethe_free_energy` (:142).  Block reductions run in a
// fixed order.
//
// The pair factors P are read through a layout: P[(i*R + j)*sp + (a*6 +
// b)*sab] is factor (a, b) of the ordered residue pair (i, j).  K2 keeps
// them pair-major (sp = 36, sab = 1), K6 as 36 planes (sp = 1, sab = R*R).
#pragma once
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

struct PairLayout {
  int sp, sab;   // strides of the residue pair and of the (a, b) factor
  __device__ __forceinline__ long at(int i, int j, int R, int ab) const {
    return ((long)i * R + j) * sp + (long)ab * sab;
  }
};

__device__ __forceinline__ bool is_adj(const BPSmem& s, int i, int j) {
  return (s.adj[i * ADJ_WORDS + (j >> 5)] >> (j & 31)) & 1u;
}

// fixed-order tree reduction over the block (op: 0 = sum, 1 = max)
__device__ inline float block_reduce(BPSmem& s, float v, int op) {
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

// node potentials: offset = min valid E1, prob = exp(offset - E1)
__device__ inline void node_potentials(BPSmem& s, const float* e1,
                                       const unsigned char* valid, int R) {
  for (int i = threadIdx.x; i < R; i += BP_THREADS) {
    float off = INFINITY;
    for (int a = 0; a < NROT; ++a)
      if (valid[i * NROT + a]) off = fminf(off, e1[i * NROT + a]);
    s.offset[i] = off;
    for (int a = 0; a < NROT; ++a)
      s.prob[i * NROT + a] = valid[i * NROT + a] ? expf(off - e1[i * NROT + a])
                                                 : 0.0f;
  }
}

// eb_dst[i,j,:] = normalised sum_b P[i,j,:,b] V[j,i,b] over adjacent
// directed edges, V[j,i,b] = nbv[j,b] / (EPS + eb_src[j,i,b])
__device__ inline void edge_update(const BPSmem& s, const float* nbv,
                                   const float* P, PairLayout L,
                                   const float* src, float* dst,
                                   const int* edges,
                                   const unsigned char* valid, int R) {
  for (int e = threadIdx.x; e < s.n_edges; e += BP_THREADS) {
    const int i = edges[e] / R, j = edges[e] % R;
    float V[NROT];
    const float* sji = src + ((long)j * R + i) * NROT;
    for (int b = 0; b < NROT; ++b) V[b] = nbv[j * NROT + b] / (BP_EPS + sji[b]);
    const float* Pij = P + L.at(i, j, R, 0);
    float m[NROT], norm = 0.0f;
    for (int a = 0; a < NROT; ++a) {
      float acc = 0.0f;
      for (int b = 0; b < NROT; ++b)
        acc += Pij[(long)(a * NROT + b) * L.sab] * V[b];
      m[a] = valid[i * NROT + a] ? acc : 0.0f;
      norm += m[a];
    }
    const float rn = 1.0f / fmaxf(norm, BP_EPS);
    float* dij = dst + ((long)i * R + j) * NROT;
    for (int a = 0; a < NROT; ++a) dij[a] = m[a] * rn;
  }
}

// log-space node update with max-centring, then the damped mix
__device__ inline void node_update(BPSmem& s, const float* eb, int R,
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

// compact list of adjacent directed edges (i*R + j), row-major order
__device__ inline void build_edges(BPSmem& s, int* edges, int R) {
  const int tid = threadIdx.x;
  const long RR = (long)R * R;
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

// Start (cold: one undamped sweep from the priors; warm: the given
// messages and max-normalised beliefs of this replica), then damped sweeps
// with a convergence check every `chunk` sweeps.  Returns the buffer that
// holds the final messages; the final beliefs are in s.nb.
__device__ inline float* bp_solve(BPSmem& s, const float* P, PairLayout L,
                                  const int* edges,
                                  const unsigned char* valid, int R,
                                  const float* nb0, const float* eb0,
                                  float* ebA, float* ebB, float damping,
                                  int max_iter, float tol, int chunk,
                                  int& it, float& dev) {
  const int tid = threadIdx.x;
  float* cur = ebA;
  float* nxt = ebB;
  if (nb0 != nullptr) {
    for (int e = tid; e < s.n_edges; e += BP_THREADS) {
      const long base = (long)edges[e] * NROT;
      for (int a = 0; a < NROT; ++a) cur[base + a] = eb0[base + a];
    }
    for (int i = tid; i < R; i += BP_THREADS) {
      float mx = 0.0f;
      for (int a = 0; a < NROT; ++a)
        mx = a == 0 ? nb0[(long)i * NROT] : fmaxf(mx, nb0[(long)i * NROT + a]);
      const float rmx = 1.0f / fmaxf(mx, BP_EPS);
      for (int a = 0; a < NROT; ++a)
        s.nb[i * NROT + a] = nb0[(long)i * NROT + a] * rmx;
    }
    __syncthreads();
  } else {
    for (int e = tid; e < s.n_edges; e += BP_THREADS) {
      const long base = (long)edges[e] * NROT;
      for (int a = 0; a < NROT; ++a) nxt[base + a] = 1.0f;
    }
    __syncthreads();
    edge_update(s, s.prob, P, L, nxt, cur, edges, valid, R);
    for (int i = tid; i < R; i += BP_THREADS) {
      float mx = s.prob[i * NROT];
      for (int a = 1; a < NROT; ++a) mx = fmaxf(mx, s.prob[i * NROT + a]);
      const float rmx = 1.0f / fmaxf(mx, BP_EPS);
      for (int a = 0; a < NROT; ++a)
        s.nb[i * NROT + a] = s.prob[i * NROT + a] * rmx;
    }
    __syncthreads();
  }

  it = 0;
  dev = INFINITY;
  while (it < max_iter && dev > tol) {
    for (int c = 0; c < chunk; ++c) {
      for (int t = tid; t < R * NROT; t += BP_THREADS) s.nb_prev[t] = s.nb[t];
      edge_update(s, s.nb, P, L, cur, nxt, edges, valid, R);
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
  return cur;
}

// Outputs of the solve: sum-normalised beliefs b (left in s.nb_prev and
// written to nb_out), messages (identity on non-edges), deviation, sweeps.
__device__ inline void bp_outputs(BPSmem& s, const float* cur, int R,
                                  float* nb_out, float* eb_out,
                                  float* dev_out, int* iters_out, int it,
                                  float dev) {
  const int tid = threadIdx.x;
  float* b = s.nb_prev;
  for (int i = tid; i < R; i += BP_THREADS) {
    float tot = 0.0f;
    for (int a = 0; a < NROT; ++a) tot += s.nb[i * NROT + a];
    const float rt = 1.0f / fmaxf(tot, BP_EPS);
    for (int a = 0; a < NROT; ++a) {
      b[i * NROT + a] = s.nb[i * NROT + a] * rt;
      nb_out[(long)i * NROT + a] = b[i * NROT + a];
    }
  }
  const long RR = (long)R * R;
  for (long t = tid; t < RR * NROT; t += BP_THREADS) {
    const int i = (int)(t / ((long)R * NROT)), j = (int)((t / NROT) % R);
    eb_out[t] = (i != j && is_adj(s, i, j)) ? cur[t] : 1.0f;
  }
  if (tid == 0) {
    *dev_out = dev;
    *iters_out = it;
  }
  __syncthreads();
}

// Bethe node term (this thread's share) and G1 = b q + (1 - sum b q)
// [first argmin], written to g1 (R, 6)
__device__ inline float bethe_nodes(const BPSmem& s, const float* e1,
                                    const unsigned char* valid, int R,
                                    float* g1) {
  const float* b = s.nb_prev;
  float part = 0.0f;
  for (int i = threadIdx.x; i < R; i += BP_THREADS) {
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
      g1[(long)i * NROT + a] = g;
    }
  }
  return part;
}

// Bethe edge term over adjacent i < j (this thread's share), with
// dF/dE2[i,j,a,c] = m pbb / (EPS + pbb) written to G at (i, j) in layout
// GL, and, when `mirror`, also to (j, i) transposed.  G may alias P: each
// entry is read before it is written.
__device__ inline float bethe_edges(const BPSmem& s, const float* P,
                                    PairLayout L, const float* cur,
                                    const int* edges,
                                    const unsigned char* valid, int R,
                                    float* G, PairLayout GL, bool mirror) {
  const float* b = s.nb_prev;
  float part = 0.0f;
  for (int e = threadIdx.x; e < s.n_edges; e += BP_THREADS) {
    const int i = edges[e] / R, j = edges[e] % R;
    if (i > j) continue;
    const float* Pij = P + L.at(i, j, R, 0);
    float* Gij = G + GL.at(i, j, R, 0);
    float* Gji = G + GL.at(j, i, R, 0);
    const float* eij = cur + ((long)i * R + j) * NROT;
    const float* eji = cur + ((long)j * R + i) * NROT;
    float bc1[NROT], bc2[NROT], mr[NPAIR], norm = 0.0f;
    for (int a = 0; a < NROT; ++a) {
      bc1[a] = b[i * NROT + a] / (BP_EPS + eij[a]);
      bc2[a] = b[j * NROT + a] / (BP_EPS + eji[a]);
    }
    for (int a = 0; a < NROT; ++a)
      for (int c = 0; c < NROT; ++c) {
        mr[a * NROT + c] = Pij[(long)(a * NROT + c) * L.sab] * bc1[a] * bc2[c];
        norm += mr[a * NROT + c];
      }
    const float rn = 1.0f / fmaxf(norm, BP_EPS);
    for (int a = 0; a < NROT; ++a)
      for (int c = 0; c < NROT; ++c) {
        float g = 0.0f;
        if (valid[i * NROT + a] && valid[j * NROT + c]) {
          const float mm = mr[a * NROT + c] * rn;
          const float pbb = Pij[(long)(a * NROT + c) * L.sab] * b[i * NROT + a]
                            * b[j * NROT + c];
          part += mm * logf((BP_EPS + mm) / (BP_EPS + pbb));
          g = mm * pbb / (BP_EPS + pbb);
        }
        Gij[(long)(a * NROT + c) * GL.sab] = g;
        if (mirror) Gji[(long)(c * NROT + a) * GL.sab] = g;
      }
  }
  return part;
}
