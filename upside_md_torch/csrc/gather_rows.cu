// gather_rows_bwd: the backward of the neighbour lists' row gather, each
// row's cotangent summed in a fixed order.
//
// Replaces no TPU kernel.  The JAX package gathers a neighbour list's rows
// in XLA (upside_md_tpu/ops/pairs.py:82-121, `pos2[idx]`), and XLA on the
// TPU sums the gather's cotangent in the same order on every run.  The
// port's gather (`ops/pairs.gather_rows`: rotamer grid and both coverages
// past 1,024 beads or columns, `radial` past 1,024 probes) read its rows
// with `index_select`, whose CUDA backward is an `index_add` with float
// atomics: forces that varied from call to call.  Here the wrapper sorts
// the slots' row keys (b * n + row; slots off the list's mask get the drop
// key n_rows) with PyTorch's stable integer sort and finds each row's
// segment of the sorted order (`starts`, n_rows + 1 offsets); this kernel
// sums each row's segment in that order, which is increasing slot index:
// the same additions in the same order on every run, no atomics.
//
// One thread an (output row, channel): out[r, c] = sum of g[order[s], c]
// over s in [starts[r], starts[r + 1]), left to right from 0.  What bounds
// it on an H100 is the bytes: every kept slot's cotangent row (w floats)
// and its sorted index are read once, each output written once, one add
// per value read.  A segment holds the rows that listed row r, at most a
// few hundred, so a thread's loop is short; neighbouring threads read
// neighbouring channels of one slot.
#include <cstdint>

#include <cuda_runtime.h>

__global__ void gather_rows_bwd_kernel(const float* __restrict__ g,
                                       const int64_t* __restrict__ order,
                                       const int64_t* __restrict__ starts,
                                       int n_rows, int w,
                                       float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)n_rows * w) return;
  const int64_t r = t / w;
  const int c = (int)(t - r * w);
  const int64_t end = starts[r + 1];
  float acc = 0.0f;
  for (int64_t s = starts[r]; s < end; ++s)
    acc = __fadd_rn(acc, g[order[s] * w + c]);
  out[t] = acc;
}

// g (m, w) the slots' cotangents, order (m,) the slots sorted by row key,
// starts (n_rows + 1,) each row's first entry of `order`; out (n_rows, w).
extern "C" int gather_rows_bwd(const float* g, const int64_t* order,
                               const int64_t* starts, int n_rows, int w,
                               float* out, void* stream_ptr) {
  if (n_rows <= 0 || w <= 0) return 0;
  const int64_t n = (int64_t)n_rows * w;
  const int threads = 256;
  gather_rows_bwd_kernel<<<(unsigned)((n + threads - 1) / threads), threads,
                           0, (cudaStream_t)stream_ptr>>>(g, order, starts,
                                                          n_rows, w, out);
  return (int)cudaGetLastError();
}
