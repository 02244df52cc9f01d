// Kernel 1: masked single-row-set histogram, hist[F, B, 3] = (sum g*m,
// sum h*m, sum m) over `cap` rows of feature-major bins.
//
// Replaces the TPU kernel lightgbm_tpu/ops/pallas_histogram.py
// _hist_kernel_v1 (pallas_call at :193) as reached through
// histogram_single_leaf (:309): the leaf-wise learner's root histogram and
// its smaller-child histogram per split.  The TPU kernel builds one-hot
// [C, B] tiles and accumulates stats^T @ onehot on the MXU, with features
// padded to FGROUP=8 and bins to 128 lanes; none of that layout is carried
// over, only the contract.
//
// Bound on the H100: memory.  The function must read F*cap bytes of bins
// (u8; 2x for u16) plus 12*cap bytes of grad/hess/mask and write F*B*12
// bytes.  At the root of the bench shape (F=28, cap=1M) that is ~40 MB,
// ~12 us at 3.35 TB/s.  Operations are ~3 adds per (row, feature), far
// below any compute bound.
//
// Design (a simple, deterministic first version; it is not near the bound):
//  * pass 1: grid (row chunks, F).  A block stages its chunk's bins and the
//    masked stats (g*m, h*m, m) in shared memory, so each byte of input is
//    read from device memory once per feature.  Each thread owns bins
//    tid, tid+blockDim, ... and walks the staged rows in row order,
//    adding the rows whose bin is its own.  Reads of one staged row are
//    broadcasts (every lane reads the same address), so there are no bank
//    conflicts.  The per-chunk partial histogram is written to scratch.
//  * pass 2: one thread per (feature, bin, stat) sums the chunk partials in
//    chunk order.
//  No atomics: the summation order is fixed, so two launches on the same
//  inputs give bitwise-equal output.  The cost is O(cap * B) compares per
//  feature in pass 1 (each thread scans every row), which is what a later
//  PR should remove.
//
// Both kernels run on the caller's stream and allocate nothing; the
// PyTorch wrapper (ops/cuda_histogram.py) allocates the output and the
// [nchunks, F, B, 3] scratch.  Each C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 2048;   // rows staged per block
constexpr int kThreads = 256;  // threads per block in pass 1

template <typename BinT>
__global__ void hist_partial_kernel(const BinT* __restrict__ bins,  // [F, cap]
                                    const float* __restrict__ grad,
                                    const float* __restrict__ hess,
                                    const float* __restrict__ mask,
                                    int64_t cap, int num_bins,
                                    float* __restrict__ partial) {  // [nch, F, B, 3]
  __shared__ BinT s_bin[kChunk];
  __shared__ float s_g[kChunk];
  __shared__ float s_h[kChunk];
  __shared__ float s_m[kChunk];

  const int chunk = blockIdx.x;
  const int f = blockIdx.y;
  const int F = gridDim.y;
  const int64_t row0 = (int64_t)chunk * kChunk;
  const int rows = (cap - row0 < kChunk) ? (int)(cap - row0) : kChunk;

  const BinT* brow = bins + (int64_t)f * cap + row0;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float m = mask[row0 + r];
    s_bin[r] = brow[r];
    s_g[r] = grad[row0 + r] * m;
    s_h[r] = hess[row0 + r] * m;
    s_m[r] = m;
  }
  __syncthreads();

  float* out = partial + (((int64_t)chunk * F + f) * num_bins) * 3;
  for (int b = threadIdx.x; b < num_bins; b += blockDim.x) {
    float g = 0.f, h = 0.f, c = 0.f;
    for (int r = 0; r < rows; ++r) {
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
}

__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   int nchunks, int64_t per_chunk,
                                   float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_chunk) return;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += partial[(int64_t)c * per_chunk + i];
  out[i] = s;
}

template <typename BinT>
int launch(const void* bins, const float* grad, const float* hess,
           const float* mask, int F, int64_t cap, int num_bins,
           float* partial, float* out, cudaStream_t stream) {
  const int nchunks = (int)((cap + kChunk - 1) / kChunk);
  if (nchunks > 0 && F > 0) {
    dim3 grid(nchunks, F);
    hist_partial_kernel<BinT><<<grid, kThreads, 0, stream>>>(
        static_cast<const BinT*>(bins), grad, hess, mask, cap, num_bins,
        partial);
  }
  const int64_t per_chunk = (int64_t)F * num_bins * 3;
  if (per_chunk > 0) {
    const int threads = 256;
    const int blocks = (int)((per_chunk + threads - 1) / threads);
    hist_reduce_kernel<<<blocks, threads, 0, stream>>>(partial, nchunks,
                                                       per_chunk, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows staged per pass-1 block: the wrapper sizes the scratch as
// [ceil(cap / chunk_rows), F, num_bins, 3] floats.
int lgbm_hist_chunk_rows() { return kChunk; }

// bin_bytes: 1 (uint8 bins) or 2 (uint16 bins).  All pointers are device
// pointers; `stream` is a cudaStream_t.
int lgbm_hist_single_leaf(const void* bins, int bin_bytes, const float* grad,
                          const float* hess, const float* mask, int F,
                          int64_t cap, int num_bins, float* partial,
                          float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return launch<uint8_t>(bins, grad, hess, mask, F, cap, num_bins, partial,
                           out, s);
  if (bin_bytes == 2)
    return launch<uint16_t>(bins, grad, hess, mask, F, cap, num_bins, partial,
                            out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
