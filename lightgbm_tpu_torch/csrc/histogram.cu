// Kernel 1: masked single-row-set histogram, hist[F, B, 3] = (sum g*m,
// sum h*m, sum m) over `cap` rows of feature-major bins; and kernel 1',
// the same sums over a window of the packed record.
//
// K1 replaces the TPU kernel lightgbm_tpu/ops/pallas_histogram.py
// _hist_kernel_v1 (pallas_call at :193) as reached through
// histogram_single_leaf (:309): the order route's root histogram and its
// smaller-child histogram per split.  K1' replaces the same pallas_call as
// reached through histogram_single_leaf_raw (:366) on an unpacked record
// window (learners/serial.py:879-889): the record route's root and
// smaller-child histograms.  The TPU kernel builds one-hot [C, B] tiles and
// accumulates stats^T @ onehot on the MXU, with features padded to FGROUP=8
// and bins to 128 lanes; none of that layout is carried over, only the
// contract.
//
// Bound on the H100: memory.  K1 must read F*cap bytes of bins (u8; 2x for
// u16) plus 12*cap bytes of grad/hess/mask and write F*B*12 bytes.  At the
// root of the bench shape (F=28, cap=1M) that is ~40 MB, ~12 us at 3.35
// TB/s.  K1' reads the window's Wb packed words and three stat words per
// row instead, (Wb+3)*4 = 40 bytes a row at the bench shape: the same 40 MB
// at the root.  Operations are ~3 adds per (row, feature), far below any
// compute bound.
//
// Design (a simple, deterministic first version; it is not near the bound):
//  * pass 1: grid (row chunks, F); each block builds one (chunk, feature)
//    partial with hist_chunk (hist_chunk.cuh, shared with K8), which
//    stages the chunk's rows in shared memory and has each thread walk
//    them in row order for its own bins.  The partial goes to scratch.
//  * pass 2: one thread per (feature, bin, stat) sums the chunk partials in
//    chunk order (reduce_chunks).
//  The two kernels differ only in the row reader (a template argument):
//  K1 reads a feature-major bin matrix and three float rows, K1' unpacks
//  the bin from its record word and takes the float bit patterns straight
//  from the window (RecordRows; no [F, cap] unpack in device memory).  The
//  summation order is the same, so K1' on a window equals K1 on the
//  unpacked rows, bitwise.
//  No atomics: the summation order is fixed, so two launches on the same
//  inputs give bitwise-equal output.  The cost is O(cap * B) compares per
//  feature in pass 1 (each thread scans every row), which is what a later
//  PR should remove.
//
// The kernels run on the caller's stream and allocate nothing; the
// PyTorch wrapper (ops/cuda_histogram.py) allocates the output and the
// [nchunks, F, B, 3] scratch.  Each C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_chunk.cuh"

namespace {

using namespace lgbm;

constexpr int kThreads = 256;  // threads per block in pass 1

// The rows of kernel 1: feature-major bins [F, cap] and three float rows.
template <typename BinT>
struct MatrixRows {
  const BinT* bins;
  const float* grad;
  const float* hess;
  const float* mask;
  int64_t cap;
  __device__ int bin(int f, int64_t r) const {
    return (int)bins[(int64_t)f * cap + r];
  }
  __device__ float g(int64_t r) const { return grad[r]; }
  __device__ float h(int64_t r) const { return hess[r]; }
  __device__ float m(int64_t r) const { return mask[r]; }
};

template <typename Rows, typename StageT>
__global__ void hist_partial_kernel(Rows rows, int64_t cap, int num_bins,
                                    float* __restrict__ partial) {
  // partial: [nchunks, F, B, 3]
  hist_chunk<StageT>(rows, cap, blockIdx.x, blockIdx.y, gridDim.y, num_bins,
                     partial);
}

__global__ void hist_reduce_kernel(const float* __restrict__ partial,
                                   int nchunks, int64_t per_chunk,
                                   float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_chunk) return;
  out[i] = reduce_chunks(partial, nchunks, per_chunk, i);
}

template <typename StageT, typename Rows>
int launch(const Rows& rows, int F, int64_t cap, int num_bins, float* partial,
           float* out, cudaStream_t stream) {
  const int nchunks = (int)((cap + kChunk - 1) / kChunk);
  if (nchunks > 0 && F > 0) {
    dim3 grid(nchunks, F);
    hist_partial_kernel<Rows, StageT><<<grid, kThreads, 0, stream>>>(
        rows, cap, num_bins, partial);
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
  if (bin_bytes == 1) {
    const MatrixRows<uint8_t> rows{static_cast<const uint8_t*>(bins), grad,
                                   hess, mask, cap};
    return launch<uint8_t>(rows, F, cap, num_bins, partial, out, s);
  }
  if (bin_bytes == 2) {
    const MatrixRows<uint16_t> rows{static_cast<const uint16_t*>(bins), grad,
                                    hess, mask, cap};
    return launch<uint16_t>(rows, F, cap, num_bins, partial, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Kernel 1' over columns [begin, begin+cnt) of the [W, ld] int32 record
// (k = 4 or 2 bins per word, F features in the first ceil(F/k) rows).
int lgbm_hist_record_window(const int* rec, int64_t ld, int64_t begin,
                            int64_t cnt, int F, int k, int num_bins,
                            float* partial, float* out, void* stream) {
  if (k != 2 && k != 4) return (int)cudaErrorInvalidValue;
  const int shift = 32 / k;
  const RecordRows rows{rec, ld, begin, k, shift, (1u << shift) - 1u,
                        (F + k - 1) / k};
  return launch<uint16_t>(rows, F, cnt, num_bins, partial, out,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
