// nlist_spline: the directional pair spline on a fixed-K neighbour list,
// forward and backward.
//
// Replaces no Pallas kernel.  The JAX package evaluates the spline on its
// neighbour lists in XLA (`quadspline_coverage_nl`, upside_md_tpu/ops/
// pairs.py:82-121): past 1,024 beads (the rotamer grid) or columns (the
// two coverages) each row keeps its K nearest in-cutoff columns, and the
// pair value wide(r) + ang1(cos1) ang2(cos2) narrow(r) is taken at those
// slots only.  The port's plain version (`ops/pairs.
// quadspline_coverage_nl_plain`) gathers a (B, n1, K, m) block of the
// table, builds dense (B, n1, K, n_knot) window weights for the four
// segments and leaves the backward to autograd: at GFP's shapes and 64
// replicas up to 1.3 GB a list (the rotamer grid's table block) and ~1,700
// launches an evaluation for the three lists.  Here the forward and the
// backward are one launch each; the list's build (`neighbor_list`:
// distances and `topk`) stays in PyTorch.
//
// Both read each slot's mask, then, for a slot in the mask only, its
// column index, the column's site (position, unit direction) and its
// pair's cubic coefficients (`fused_pair.poly_coefficients`, memoised on
// the table as K4 and K5 read them), and evaluate the pair as K5 does:
// `pair_geometry`, the exact test s = dist / dx < kcut (k - 2 - 1e-6), and
// Horner on four coefficients a segment (`spline_terms`, fused_pair.cuh).
// Nothing is read of a slot off the mask, so a dead slot's index need not
// be a column at all; the cotangent of a slot is read only where the mask
// and the cutoff both hold: selected, never multiplied, so NaN or Inf in a
// dead slot is never read.
//
// What bounds it on an H100: the bytes of the list, ~13 a slot forward
// (index, mask, value) and ~37 backward (index, mask, cotangent, and the
// slot's 6 column cotangents written where the mask holds), against ~80
// (forward) and ~150 (backward) float operations a live pair; the sites
// and the coefficient table are small enough to stay in L2.  The
// benchmark's `nlist_roofline` holds the lists to K4's and K5's bound for
// the same live pairs (mdbench/roofline.py `quadspline_s`), which counts
// the dense grid K5 writes and not the list.
//
// Design.  A warp owns a row (b, i) of the list: lane l takes the slots l,
// l + 32, ... in turn, so a warp's reads of the index, mask and cotangent
// and its writes are coalesced; the row's site and type are read once.
// The backward sums each lane's row cotangents over its slots in slot
// order and then across the warp with a fixed shuffle tree (`warp_sum`),
// and writes each slot's column cotangent (B, n1, K, 6); the wrapper sums
// those into the columns in a fixed order with `gather_rows_bwd`
// (csrc/gather_rows.cu).  No float atomics: the results are bitwise
// repeatable.  The kernels are templates on the family (KA, K) of
// `ops/pairs.quadspline_family`, so the segment sizes and the coefficient
// row's width are compile-time; the entry points pick the instance.  The
// rotamer call passes one bead set as both x1 and x2: both are only read.
#include <cstdint>

#include <cuda_runtime.h>

#include "fused_pair.cuh"

namespace {

constexpr int NL_WARPS = 4;      // rows of a block: a warp each

// A warp's row: its site and the first coefficient of its row type.
struct NlRow {
  int64_t row;                   // b * n1 + i
  const float* x2;               // the row's replica's column sites
  const float* coef;             // coef[t1[i]]
  float xr[6];
};

template <int NCOEF>
__device__ __forceinline__ bool load_row(const float* __restrict__ x1,
                                         const float* __restrict__ x2,
                                         const int* __restrict__ t1,
                                         const float* __restrict__ coef,
                                         int B, int n1, int n2, int n_t2,
                                         NlRow& r) {
  r.row = (int64_t)blockIdx.x * NL_WARPS + threadIdx.y;
  if (r.row >= (int64_t)B * n1) return false;
  const int64_t b = r.row / n1;
  const int i = (int)(r.row - b * n1);
  r.x2 = x2 + b * n2 * 6;
  r.coef = coef + (int64_t)t1[i] * n_t2 * NCOEF;
#pragma unroll
  for (int q = 0; q < 6; ++q) r.xr[q] = x1[r.row * 6 + q];
  return true;
}

// Slot `slot` of row r: false unless the mask holds and the pair lies
// inside the cutoff; then its column site xc, geometry and spline terms.
template <int KA, int K, int NCOEF>
__device__ __forceinline__ bool live_slot(
    const NlRow& r, int64_t slot, const int64_t* __restrict__ idx,
    const unsigned char* __restrict__ mask, const int* __restrict__ t2,
    float inv_dx, float kcut, float xc[6], PairGeom& g, SplineTerms& t) {
  if (!mask[slot]) return false;
  const int64_t j = idx[slot];
#pragma unroll
  for (int q = 0; q < 6; ++q) xc[q] = r.x2[j * 6 + q];
  g = pair_geometry(r.xr, xc);
  const float sd = __fmul_rn(g.dist, inv_dx);
  if (!(sd < kcut)) return false;
  t = spline_terms(r.coef + (int64_t)t2[j] * NCOEF, g, KA, K, sd);
  return true;
}

// out (B, n1, width): each slot's value, 0 where the mask is off or the
// pair is outside the cutoff.
template <int KA, int K>
__global__ void __launch_bounds__(32 * NL_WARPS) nlist_spline_fwd_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const int64_t* __restrict__ idx, const unsigned char* __restrict__ mask,
    const int* __restrict__ t1, const int* __restrict__ t2,
    const float* __restrict__ coef, int B, int n1, int n2, int width,
    int n_t2, float inv_dx, float kcut, float* __restrict__ out) {
  constexpr int NCOEF = 8 * (KA - 3) + 8 * (K - 3);
  NlRow r;
  if (!load_row<NCOEF>(x1, x2, t1, coef, B, n1, n2, n_t2, r)) return;
  for (int s = threadIdx.x; s < width; s += 32) {
    const int64_t slot = r.row * width + s;
    float xc[6];
    PairGeom g;
    SplineTerms t;
    out[slot] = live_slot<KA, K, NCOEF>(r, slot, idx, mask, t2, inv_dx,
                                        kcut, xc, g, t)
                    ? t.wide + t.a1 * t.a2 * t.nar
                    : 0.0f;
  }
}

// From the slots' cotangent g (B, n1, width): d1 (B, n1, 6), each row's
// position and direction cotangent summed over its slots, and dslot (B,
// n1, width, 6), each slot's column cotangent, written where the mask
// holds (0 outside the cutoff) and left unwritten where it does not.
template <int KA, int K>
__global__ void __launch_bounds__(32 * NL_WARPS) nlist_spline_bwd_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2,
    const int64_t* __restrict__ idx, const unsigned char* __restrict__ mask,
    const int* __restrict__ t1, const int* __restrict__ t2,
    const float* __restrict__ coef, const float* __restrict__ gs, int B,
    int n1, int n2, int width, int n_t2, float inv_dx, float kcut,
    float* __restrict__ d1, float* __restrict__ dslot) {
  constexpr int NCOEF = 8 * (KA - 3) + 8 * (K - 3);
  NlRow r;
  if (!load_row<NCOEF>(x1, x2, t1, coef, B, n1, n2, n_t2, r)) return;
  float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = threadIdx.x; s < width; s += 32) {
    const int64_t slot = r.row * width + s;
    float xc[6], rc[6], cc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    PairGeom g;
    SplineTerms t;
    if (live_slot<KA, K, NCOEF>(r, slot, idx, mask, t2, inv_dx, kcut, xc,
                                g, t)) {
      spline_cotangents(t, g, r.xr, xc, gs[slot], inv_dx, KA, rc, cc);
#pragma unroll
      for (int q = 0; q < 6; ++q) acc[q] += rc[q];
    }
    if (mask[slot]) {
#pragma unroll
      for (int q = 0; q < 6; ++q) dslot[slot * 6 + q] = cc[q];
    }
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) acc[q] = warp_sum(acc[q]);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 6; ++q) d1[r.row * 6 + q] = acc[q];
  }
}

}  // namespace

// The families of `ops/pairs.quadspline_family`: (ka, k) picks the
// instance; any other pair is refused.
#define NL_FAMILIES(F) F(8, 9) F(8, 7) F(15, 16) F(15, 12) F(8, 12)

static dim3 nl_grid(int B, int n1) {
  return dim3((unsigned)(((int64_t)B * n1 + NL_WARPS - 1) / NL_WARPS));
}

// x1 (B, n1, 6), x2 (B, n2, 6) the row and column sites; idx (B, n1,
// width) int64 column indices, read where mask (B, n1, width, one byte a
// slot) holds; t1 (n1,), t2 (n2,) int32 types; coef (n_t1, n_t2, ncoef)
// the pairs' cubic coefficients; out (B, n1, width).
extern "C" int nlist_spline_fwd(
    const float* x1, const float* x2, const int64_t* idx,
    const unsigned char* mask, const int* t1, const int* t2,
    const float* coef, int B, int n1, int n2, int width, int n_t2, int ka,
    int k, float inv_dx, float kcut, float* out, void* stream_ptr) {
  if (B <= 0 || n1 <= 0 || width <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
#define NL_FWD(KA, K)                                                       \
  if (ka == KA && k == K) {                                                 \
    nlist_spline_fwd_kernel<KA, K>                                          \
        <<<nl_grid(B, n1), dim3(32, NL_WARPS), 0, stream>>>(                \
            x1, x2, idx, mask, t1, t2, coef, B, n1, n2, width, n_t2,        \
            inv_dx, kcut, out);                                             \
  } else
  NL_FAMILIES(NL_FWD) { return (int)cudaErrorInvalidValue; }
#undef NL_FWD
  return (int)cudaGetLastError();
}

// The backward from g (B, n1, width): d1 (B, n1, 6) and dslot (B, n1,
// width, 6), the latter written only where the mask holds.
extern "C" int nlist_spline_bwd(
    const float* x1, const float* x2, const int64_t* idx,
    const unsigned char* mask, const int* t1, const int* t2,
    const float* coef, const float* g, int B, int n1, int n2, int width,
    int n_t2, int ka, int k, float inv_dx, float kcut, float* d1,
    float* dslot, void* stream_ptr) {
  if (B <= 0 || n1 <= 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
#define NL_BWD(KA, K)                                                       \
  if (ka == KA && k == K) {                                                 \
    nlist_spline_bwd_kernel<KA, K>                                          \
        <<<nl_grid(B, n1), dim3(32, NL_WARPS), 0, stream>>>(                \
            x1, x2, idx, mask, t1, t2, coef, g, B, n1, n2, width, n_t2,     \
            inv_dx, kcut, d1, dslot);                                       \
  } else
  NL_FAMILIES(NL_BWD) { return (int)cudaErrorInvalidValue; }
#undef NL_BWD
  return (int)cudaGetLastError();
}
