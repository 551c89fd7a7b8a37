// table_cotangent: the cotangent of a pair-spline table, each bead pair's
// (M,) share summed over the replicas in a fixed order.
//
// Replaces no Pallas kernel.  The JAX package computes `_table_cotangent`
// (upside_md_tpu/ops/pallas_quadspline.py:753) in XLA, outside any kernel.
// The port's plain version (`ops/fused_pair.table_cotangent_plain`) loops
// over the replicas in chunks of 8, and each chunk materialises every
// pair's window weights, table row and products, ~130 floats a pair: at
// 1,024 replicas of ubiquitin 128 chunks of ~20 ops on 40-150 MB tensors
// a call.  Here the same function is one pass over the replicas, every
// intermediate in registers or shared memory; `sum_by_type` then sums the
// pairs by type as before, outside the kernel.
//
// For each pair (i, j) in the static mask and each replica b, as the plain
// version: the geometry of `pair_geometry` (fused_pair.cuh, the plain
// `_geometry`'s rounding), s = dist / dx, and where s < kcut the pair's
// cotangent g[b, i, j] is read (selected, never multiplied: NaN or Inf in
// a dead slot is never read), the window weights of cos1, cos2 (unclamped)
// and s (clamped: the 1/6, 4/6, 1/6 end stencils), a1, a2 and narrow from
// the pair's table row, and the four blocks [g a2 narrow wa1, g a1 narrow
// wa2, g wd, g a1 a2 wd] added at their windows' knots.
//
// What bounds it on an H100: about 150 float operations a live pair and
// replica and 27 a masked pair and replica (its geometry and the cutoff
// test), and the bytes: g where a pair is live (at most B n1 n2 floats),
// the sites (B (n1 + n2) 6 floats) and the (M, n1, n2) sums.  At 1,024
// ubiquitin replicas the operations bound it, at 0.02-0.04 ms a band.
//
// Design.  A thread owns a pair: the 32 lanes of a warp take neighbouring
// columns j of one row i, so each replica's row of g is one coalesced
// read, the column sites (which the wrapper transposes to (B, 6, n2)) too,
// and the row site one broadcast.  A window touches 4 consecutive knots
// at a run-time index, so the thread's M sums live in shared memory, one
// column a thread (element m of thread t at m * THREADS + t: no bank
// conflicts), not in registers, which a run-time index would spill; the
// table entries it reads (ang1, ang2, narrow) come from the pair's table
// row through the read-only cache.  The kernel is a template on the
// family (KA, K) of `ops/pairs.quadspline_family`, so the sizes are
// compile-time; the wrapper picks the instance from the table's last
// dimension.  Fixed order, no atomics: a thread sums its replicas in index
// order, in one pass, so the result is the same bit for bit on every run.
#include <cstdint>

#include <cuda_runtime.h>

#include "fused_pair.cuh"

namespace {

constexpr int TC_COLS = 32;                  // columns of a block: a warp
constexpr int TC_ROWS = 2;                   // rows of a block: a warp each
constexpr int TC_THREADS = TC_COLS * TC_ROWS;

// `bspline_window_weights` at x: the first of the 4 knots the window
// touches (the interval clipped to [1, n - 3], as `_window`) and their
// weights, extrapolated past the ends
__device__ __forceinline__ int window(float x, int n, float w[4]) {
  const float fi = fminf(fmaxf(floorf(x), 1.0f), (float)(n - 3));
  const float t = x - fi, s = 1.0f - t;
  const float t2 = t * t, t3 = t2 * t;
  w[0] = s * s * s * (1.0f / 6.0f);
  w[1] = (3.0f * t3 - 6.0f * t2 + 4.0f) * (1.0f / 6.0f);
  w[2] = (-3.0f * t3 + 3.0f * t2 + 3.0f * t + 1.0f) * (1.0f / 6.0f);
  w[3] = t3 * (1.0f / 6.0f);
  return (int)fi - 1;
}

// the element m of this thread's column of a shared array
#define AT(p, m) (p)[(m) * TC_THREADS]

// a site's 6 components, x component-major (.., 6, n): stride n
__device__ __forceinline__ void load_site(const float* __restrict__ x,
                                          int64_t n, float v[6]) {
#pragma unroll
  for (int q = 0; q < 6; ++q) v[q] = x[q * n];
}

// out (M, n1, n2): each pair's table cotangent summed over the replicas;
// t1 (n1,), t2 (n2,) types, table (n_t1, n_t2, M), x1 (B, 6, n1), x2 (B,
// 6, n2) the sites, mask (n1, n2), g (B, n1, n2) at strides (g_rep, g_row,
// 1)
template <int KA, int K>
__global__ void __launch_bounds__(TC_THREADS) table_cotangent_kernel(
    const float* __restrict__ table, const int64_t* __restrict__ t1,
    const int64_t* __restrict__ t2, const float* __restrict__ x1,
    const float* __restrict__ x2, const unsigned char* __restrict__ mask,
    const float* __restrict__ g, int B, int n1, int n2, int n_t2,
    int64_t g_rep, int64_t g_row, float inv_dx, float inv_dth, float kcut,
    float* __restrict__ out) {
  constexpr int M = 2 * KA + 2 * K;
  constexpr int NARROW = 2 * KA + K;    // narrow's first entry in a row
  __shared__ float acc_s[M * TC_THREADS];
  const int tid = threadIdx.y * TC_COLS + threadIdx.x;
  const int j = blockIdx.x * TC_COLS + threadIdx.x;
  const int i = blockIdx.y * TC_ROWS + threadIdx.y;
  if (i >= n1 || j >= n2) return;
  const int64_t plane = (int64_t)n1 * n2;
  float* o = out + (int64_t)i * n2 + j;
  if (!mask[(int64_t)i * n2 + j]) {
    for (int m = 0; m < M; ++m) o[m * plane] = 0.0f;
    return;
  }
  float* acc = acc_s + tid;
  const float* __restrict__ tab = table + (t1[i] * n_t2 + t2[j]) * M;
  for (int m = 0; m < M; ++m) AT(acc, m) = 0.0f;

  const float* x1i = x1 + i;
  const float* x2j = x2 + j;
  float a[6], c[6];
  if (B > 0) {
    load_site(x1i, n1, a);
    load_site(x2j, n2, c);
  }
#pragma unroll 1
  for (int b = 0; b < B; ++b) {
    // the next replica's sites are read while this one's are used
    const int bn = min(b + 1, B - 1);
    float an[6], cn[6];
    load_site(x1i + (int64_t)bn * 6 * n1, n1, an);
    load_site(x2j + (int64_t)bn * 6 * n2, n2, cn);
    const PairGeom geo = pair_geometry(a, c);
    const float s = __fmul_rn(geo.dist, inv_dx);
    if (s < kcut) {
      const float gm = g[b * g_rep + i * g_row + j];
      float w1[4], w2[4], wd[4];
      const int s1 = window(
          __fadd_rn(__fmul_rn(__fadd_rn(geo.cos1, 1.0f), inv_dth), 1.0f),
          KA, w1);
      const int s2 = KA + window(
          __fadd_rn(__fmul_rn(__fadd_rn(geo.cos2, 1.0f), inv_dth), 1.0f),
          KA, w2);
      const int sd = window(s, K, wd);
      if (s <= 1.0f) {               // the clamped ends' stencils
        wd[0] = 1.0f / 6.0f; wd[1] = 4.0f / 6.0f; wd[2] = 1.0f / 6.0f;
        wd[3] = 0.0f;
      } else if (s >= K - 2.0f) {
        wd[0] = 0.0f; wd[1] = 1.0f / 6.0f; wd[2] = 4.0f / 6.0f;
        wd[3] = 1.0f / 6.0f;
      }
      float a1 = 0.0f, a2 = 0.0f, narrow = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a1 += w1[q] * __ldg(tab + s1 + q);
        a2 += w2[q] * __ldg(tab + s2 + q);
        narrow += wd[q] * __ldg(tab + NARROW + sd + q);
      }
      const float c1 = gm * a2 * narrow, c2 = gm * a1 * narrow;
      const float c4 = gm * a1 * a2;
      // the four windows' 16 sums (disjoint knots) read together, then
      // written together
      float v[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = AT(acc, s1 + q);
        v[4 + q] = AT(acc, s2 + q);
        v[8 + q] = AT(acc, 2 * KA + sd + q);
        v[12 + q] = AT(acc, 2 * KA + K + sd + q);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] += c1 * w1[q];
        v[4 + q] += c2 * w2[q];
        v[8 + q] += gm * wd[q];
        v[12 + q] += c4 * wd[q];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        AT(acc, s1 + q) = v[q];
        AT(acc, s2 + q) = v[4 + q];
        AT(acc, 2 * KA + sd + q) = v[8 + q];
        AT(acc, 2 * KA + K + sd + q) = v[12 + q];
      }
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) { a[q] = an[q]; c[q] = cn[q]; }
  }
  for (int m = 0; m < M; ++m) o[m * plane] = AT(acc, m);
}

#undef AT

}  // namespace

// out (M, n1, n2), M = 2 ka + 2 k: each pair's table cotangent summed over
// the B replicas.  (ka, k) must be a family of `quadspline_family`; kcut =
// k - 2 - 1e-6; the types are int64, the mask one byte a pair (bool or
// uint8).
extern "C" int table_cotangent(
    const float* table, const int64_t* t1, const int64_t* t2,
    const float* x1, const float* x2, const unsigned char* mask,
    const float* g, int B, int n1, int n2, int n_t2, int g_rep, int g_row,
    int ka, int k, float inv_dx, float inv_dth, float kcut, float* out,
    void* stream_ptr) {
  if (n1 <= 0 || n2 <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const dim3 grid((n2 + TC_COLS - 1) / TC_COLS, (n1 + TC_ROWS - 1) / TC_ROWS);
#define TC_FAMILY(KA, K)                                                    \
  if (ka == KA && k == K) {                                                 \
    table_cotangent_kernel<KA, K>                                           \
        <<<grid, dim3(TC_COLS, TC_ROWS), 0, stream>>>(                      \
            table, t1, t2, x1, x2, mask, g, B, n1, n2, n_t2, g_rep, g_row,  \
            inv_dx, inv_dth, kcut, out);                                    \
  } else
  TC_FAMILY(8, 9) TC_FAMILY(8, 7) TC_FAMILY(15, 16) TC_FAMILY(15, 12)
  TC_FAMILY(8, 12) { return (int)cudaErrorInvalidValue; }
#undef TC_FAMILY
  return (int)cudaGetLastError();
}
