// The histogram's chunk loop and its record reader: the code K1/K1'
// (histogram.cu), K8 (split_step.cu) and K1'' (level_histogram.cu) share,
// so their sums cannot drift apart.
//
// hist_rows builds one partial, hist[B, 3] = (sum g*m, sum h*m, sum m) over
// the `nrows` (<= kChunk) rows row0, row0+1, ... of a reader: the block
// stages the rows' bins and masked stats in shared memory (each input read
// from device memory once per feature), then each thread owns bins tid,
// tid+blockDim, ... and walks the staged rows in row order, adding the rows
// whose bin is its own.  Reads of a staged row are broadcasts, so there are
// no bank conflicts.  hist_chunk is hist_rows over rows [chunk*kChunk,
// chunk*kChunk + kChunk) of `cap` rows, written to the (chunk, feature)
// partial.  reduce_chunks sums one cell of the partials in chunk order.
// The order of every sum depends only on the rows, never on the grid or
// the block size: the plain versions (ops/histogram.py) sum in the same
// order, bitwise.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbm {

constexpr int kChunk = 2048;  // rows staged per (chunk, feature) partial

// Columns [begin, begin+cap) of the [W, ld] int32 record, k bins per word,
// grad/hess/mask bit patterns in rows wb, wb+1, wb+2.
struct RecordRows {
  const int* rec;
  int64_t ld;
  int64_t begin;
  int k;
  int shift;
  unsigned bmask;
  int wb;
  __device__ int bin(int f, int64_t r) const {
    const unsigned w = (unsigned)rec[(int64_t)(f / k) * ld + begin + r];
    return (int)((w >> ((f % k) * shift)) & bmask);
  }
  __device__ float word(int row, int64_t r) const {
    return __int_as_float(rec[(int64_t)row * ld + begin + r]);
  }
  __device__ float g(int64_t r) const { return word(wb, r); }
  __device__ float h(int64_t r) const { return word(wb + 1, r); }
  __device__ float m(int64_t r) const { return word(wb + 2, r); }
};

// out: one [num_bins, 3] partial; every thread of the block must call it.
template <typename StageT, typename Rows>
__device__ inline void hist_rows(const Rows& rows, int64_t row0, int nrows,
                                 int f, int num_bins,
                                 float* __restrict__ out) {
  __shared__ StageT s_bin[kChunk];
  __shared__ float s_g[kChunk];
  __shared__ float s_h[kChunk];
  __shared__ float s_m[kChunk];

  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const float m = rows.m(row0 + r);
    s_bin[r] = (StageT)rows.bin(f, row0 + r);
    s_g[r] = rows.g(row0 + r) * m;
    s_h[r] = rows.h(row0 + r) * m;
    s_m[r] = m;
  }
  __syncthreads();

  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
    float g = 0.f, h = 0.f, c = 0.f;
    for (int r = 0; r < nrows; ++r) {
      if ((int)s_bin[r] == b) {
        g += s_g[r];
        h += s_h[r];
        c += s_m[r];
      }
    }
    out[b * 3 + 0] = g;
    out[b * 3 + 1] = h;
    out[b * 3 + 2] = c;
  }
  __syncthreads();  // the staged rows are read before a next chunk
}

// partial: [nchunks, F, num_bins, 3]; every thread of the block must call
// it.
template <typename StageT, typename Rows>
__device__ inline void hist_chunk(const Rows& rows, int64_t cap, int chunk,
                                  int f, int F, int num_bins,
                                  float* __restrict__ partial) {
  const int64_t row0 = (int64_t)chunk * kChunk;
  const int nrows = (cap - row0 < kChunk) ? (int)(cap - row0) : kChunk;
  hist_rows<StageT>(rows, row0, nrows, f, num_bins,
                    partial + (((int64_t)chunk * F + f) * num_bins) * 3);
}

// Cell i of the histogram: the sum of its nchunks partials in chunk order.
__device__ __forceinline__ float reduce_chunks(const float* partial,
                                               int nchunks, int64_t per_chunk,
                                               int64_t i) {
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += partial[(int64_t)c * per_chunk + i];
  return s;
}

}  // namespace lgbm
