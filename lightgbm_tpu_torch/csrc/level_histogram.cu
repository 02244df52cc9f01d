// Kernel 1'': the level histogram, hist[L, F, B, 3] = (sum g*m, sum h*m,
// sum m) for every leaf of a level at once; and kernel 2, the same function
// built one feature group at a time.
//
// K1'' replaces the TPU kernel lightgbm_tpu/ops/pallas_histogram.py
// _hist_kernel_v1 (pallas_call at :193) as reached through
// histogram_by_leaf_sorted (:233, via make_sorted_hist_fn :421): every
// depthwise level, hybrid growth's first phase and its resume pass
// (learners/serial.py:619-631).  K2 replaces _hist_kernel_bsub (pallas_call
// at :220), the variant LGBM_TPU_HIST_KERNEL=bsub selects for the same
// histogram and for the single-leaf one.  The TPU kernels build one-hot
// tiles over leaf-sorted rows padded to whole chunks per leaf, and keep
// each leaf's output block resident in VMEM across its consecutive chunks
// (a sequential grid); none of that layout is carried over, only the
// contract and the leaf-sorted chunking.
//
// Bound on the H100: memory.  A level must read F*n bin bytes (u8; 2x for
// u16), 12*n bytes of grad/hess/mask and 4*n bytes of leaf ids, and write
// L*F*B*12 bytes.  At the bench shape (n=1M, F=28, 255 bins, 255 leaves)
// that is 28 + 12 + 4 + 21.8 = 66 MB, ~0.020 ms at 3.35 TB/s.  Operations
// are ~3 adds per (row, feature), far below any compute bound.
//
// Design (simple and deterministic first; it is not near the bound):
//  * prep, in PyTorch on the device (ops/histogram.level_layout): a stable
//    sort of the leaf ids gives the sorted row order; each leaf's rows are
//    cut into chunks of kChunk rows, at least one per leaf, so every chunk
//    belongs to one leaf and an empty leaf's chunk sums to zero.  The chunk
//    table holds each chunk's first sorted position and row count, and the
//    leaves' first chunks; its capacity is ceil(n/kChunk) + L chunks, so
//    nothing is read back to the host (the unused tail chunks hold no rows).
//  * K1'' pass 1: grid (chunks, F); each block builds one (chunk, feature)
//    partial with hist_rows (hist_chunk.cuh, shared with K1, K1' and K8)
//    through a reader that gathers rows through the sorted order.
//  * K2 pass 1: grid (ceil(F/16), chunks); one block stages the chunk's
//    masked stats once and the bins of 16 features (dynamic shared memory:
//    2048 rows x 16 u16 bins + three float rows is 90 KB), then each thread
//    owns (feature, bin) cells and walks the staged rows in row order.  It
//    reads each row's stats once per 16 features instead of once per
//    feature, and sums every cell in the same order as K1'': the two are
//    bitwise equal.
//  * pass 2 (both): one thread per (leaf, feature, bin, stat) sums that
//    leaf's partials in chunk order (reduce_chunks).
//  No atomics: every sum's order depends only on the rows, so launches are
//  bitwise repeatable and the plain version (ops/histogram.py
//  histogram_by_leaf_sorted_plain) equals both bitwise.  With one leaf the
//  sorted order is the identity and the chunks are K1's, so K2 with one
//  leaf (lgbm_hist_single_leaf_bsub) equals K1 bitwise.  The cost, as in
//  K1, is O(rows * B) compares per feature in pass 1.
//
// The kernels run on the caller's stream and allocate nothing; the
// PyTorch wrapper (ops/cuda_histogram.py) allocates the output and the
// [chunks, F, B, 3] scratch.  Each C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_chunk.cuh"

namespace {

using namespace lgbm;

constexpr int kThreads = 256;       // threads per K1'' pass-1 block
constexpr int kGroup = 16;          // features per K2 block (FGROUP_BSUB)
constexpr int kGroupThreads = 512;  // threads per K2 pass-1 block

// Feature-major bins [F, n] and three float rows, read in sorted order:
// sorted position r is row order[r] (the identity when order is null).
template <typename BinT>
struct SortedRows {
  const BinT* bins;
  const float* grad;
  const float* hess;
  const float* mask;
  const int64_t* order;
  int64_t n;
  __device__ int64_t row(int64_t r) const { return order ? order[r] : r; }
  __device__ int bin(int f, int64_t r) const {
    return (int)bins[(int64_t)f * n + row(r)];
  }
  __device__ float g(int64_t r) const { return grad[row(r)]; }
  __device__ float h(int64_t r) const { return hess[row(r)]; }
  __device__ float m(int64_t r) const { return mask[row(r)]; }
};

// Chunk c's first sorted position and row count, from the table; without
// one, the single-leaf layout (rows [c*kChunk, c*kChunk + kChunk) of n).
struct Chunks {
  const int64_t* row0;
  const int64_t* rows;
  int64_t n;
  __device__ void get(int c, int64_t* r0, int* nr) const {
    if (row0 != nullptr) {
      *r0 = row0[c];
      *nr = (int)rows[c];
    } else {
      *r0 = (int64_t)c * kChunk;
      *nr = (n - *r0 < kChunk) ? (int)(n - *r0) : kChunk;
    }
  }
};

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
    level_partial_kernel(SortedRows<BinT> rows, Chunks chunks, int num_bins,
                         float* __restrict__ partial) {
  // partial: [nchunks, F, B, 3]
  const int c = blockIdx.x, f = blockIdx.y, F = gridDim.y;
  int64_t row0;
  int nrows;
  chunks.get(c, &row0, &nrows);
  hist_rows<BinT>(rows, row0, nrows, f, num_bins,
                  partial + (((int64_t)c * F + f) * num_bins) * 3);
}

template <typename BinT>
__global__ void __launch_bounds__(kGroupThreads)
    bsub_partial_kernel(SortedRows<BinT> rows, Chunks chunks, int F,
                        int num_bins, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_g = reinterpret_cast<float*>(smem);
  float* s_h = s_g + kChunk;
  float* s_m = s_h + kChunk;
  BinT* s_bin = reinterpret_cast<BinT*>(s_m + kChunk);  // [kGroup, kChunk]

  const int f0 = blockIdx.x * kGroup;
  const int nf = (F - f0 < kGroup) ? F - f0 : kGroup;
  const int c = blockIdx.y;
  int64_t row0;
  int nrows;
  chunks.get(c, &row0, &nrows);

  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const float m = rows.m(row0 + r);
    s_g[r] = rows.g(row0 + r) * m;
    s_h[r] = rows.h(row0 + r) * m;
    s_m[r] = m;
  }
  for (int fl = 0; fl < nf; ++fl)
    for (int r = threadIdx.x; r < nrows; r += blockDim.x)
      s_bin[fl * kChunk + r] = (BinT)rows.bin(f0 + fl, row0 + r);
  __syncthreads();

  for (int cell = threadIdx.x; cell < nf * num_bins; cell += blockDim.x) {
    const int fl = cell / num_bins, b = cell % num_bins;
    const BinT* sb = s_bin + fl * kChunk;
    float g = 0.f, h = 0.f, cnt = 0.f;
    for (int r = 0; r < nrows; ++r) {
      if ((int)sb[r] == b) {
        g += s_g[r];
        h += s_h[r];
        cnt += s_m[r];
      }
    }
    float* out = partial + (((int64_t)c * F + f0 + fl) * num_bins + b) * 3;
    out[0] = g;
    out[1] = h;
    out[2] = cnt;
  }
}

// Cell i of leaf l: its chunks chunk_start[l] .. chunk_start[l+1]-1 (all
// nchunks for the single-leaf layout, chunk_start null) in chunk order.
__global__ void level_reduce_kernel(const float* __restrict__ partial,
                                    const int64_t* __restrict__ chunk_start,
                                    int nchunks, int L, int64_t per_chunk,
                                    float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)L * per_chunk) return;
  const int l = (int)(i / per_chunk);
  const int64_t c0 = chunk_start ? chunk_start[l] : 0;
  const int64_t c1 = chunk_start ? chunk_start[l + 1] : nchunks;
  out[i] = reduce_chunks(partial + c0 * per_chunk, (int)(c1 - c0), per_chunk,
                         i - (int64_t)l * per_chunk);
}

template <typename BinT>
int launch(const SortedRows<BinT>& rows, const Chunks& chunks,
           const int64_t* chunk_start, int F, int nchunks, int L,
           int num_bins, int variant, float* partial, float* out,
           cudaStream_t s) {
  if (nchunks > 0 && F > 0) {
    if (variant == 0) {
      if (F > 65535) return (int)cudaErrorInvalidValue;
      level_partial_kernel<BinT><<<dim3(nchunks, F), kThreads, 0, s>>>(
          rows, chunks, num_bins, partial);
    } else {
      if (nchunks > 65535) return (int)cudaErrorInvalidValue;
      const int smem = kChunk * (3 * (int)sizeof(float)
                                 + kGroup * (int)sizeof(BinT));
      const cudaError_t e = cudaFuncSetAttribute(
          bsub_partial_kernel<BinT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      bsub_partial_kernel<BinT>
          <<<dim3((F + kGroup - 1) / kGroup, nchunks), kGroupThreads, smem,
             s>>>(rows, chunks, F, num_bins, partial);
    }
  }
  const int64_t per_chunk = (int64_t)F * num_bins * 3;
  const int64_t total = per_chunk * L;
  if (total > 0) {
    const int threads = 256;
    level_reduce_kernel<<<(int)((total + threads - 1) / threads), threads, 0,
                          s>>>(partial, chunk_start, nchunks, L, per_chunk,
                               out);
  }
  return (int)cudaGetLastError();
}

template <typename BinT>
int dispatch(const void* bins, const float* grad, const float* hess,
             const float* mask, const int64_t* order, int64_t n, int F,
             const int64_t* chunk_row0, const int64_t* chunk_rows,
             const int64_t* chunk_start, int nchunks, int L, int num_bins,
             int variant, float* partial, float* out, void* stream) {
  const SortedRows<BinT> rows{static_cast<const BinT*>(bins), grad, hess,
                              mask, order, n};
  const Chunks chunks{chunk_row0, chunk_rows, n};
  return launch<BinT>(rows, chunks, chunk_start, F, nchunks, L, num_bins,
                      variant, partial, out,
                      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// Rows per chunk and features per K2 block: the wrapper checks them against
// ops/histogram.py CHUNK_ROWS and ops/cuda_histogram.py BSUB_GROUP.
int lgbm_level_hist_chunk_rows() { return kChunk; }
int lgbm_level_hist_group() { return kGroup; }

// The level histogram of L leaves: K1'' (variant 0) or K2 (variant 1).
// bins [F, n] (bin_bytes 1: uint8, 2: uint16), grad/hess/mask [n] float32,
// order [n] int64 (sorted position -> row), chunk_row0/chunk_rows
// [nchunks] int64, chunk_start [L+1] int64; partial [nchunks, F, B, 3] and
// out [L, F, B, 3] float32.  All pointers are device pointers; `stream` is
// a cudaStream_t.
int lgbm_level_hist(const void* bins, int bin_bytes, const float* grad,
                    const float* hess, const float* mask,
                    const int64_t* order, int64_t n, int F,
                    const int64_t* chunk_row0, const int64_t* chunk_rows,
                    const int64_t* chunk_start, int nchunks, int L,
                    int num_bins, int variant, float* partial, float* out,
                    void* stream) {
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  if (order == nullptr || chunk_row0 == nullptr || chunk_rows == nullptr
      || chunk_start == nullptr)
    return (int)cudaErrorInvalidValue;
  if (bin_bytes == 1)
    return dispatch<uint8_t>(bins, grad, hess, mask, order, n, F, chunk_row0,
                             chunk_rows, chunk_start, nchunks, L, num_bins,
                             variant, partial, out, stream);
  if (bin_bytes == 2)
    return dispatch<uint16_t>(bins, grad, hess, mask, order, n, F,
                              chunk_row0, chunk_rows, chunk_start, nchunks, L,
                              num_bins, variant, partial, out, stream);
  return (int)cudaErrorInvalidValue;
}

// K2 over one row set (the leaf-wise single-leaf histogram under bsub):
// the rows in their own order, chunks of kChunk, partial
// [ceil(cap/kChunk), F, B, 3] and out [F, B, 3].
int lgbm_hist_single_leaf_bsub(const void* bins, int bin_bytes,
                               const float* grad, const float* hess,
                               const float* mask, int F, int64_t cap,
                               int num_bins, float* partial, float* out,
                               void* stream) {
  const int nchunks = (int)((cap + kChunk - 1) / kChunk);
  if (bin_bytes == 1)
    return dispatch<uint8_t>(bins, grad, hess, mask, nullptr, cap, F, nullptr,
                             nullptr, nullptr, nchunks, 1, num_bins, 1,
                             partial, out, stream);
  if (bin_bytes == 2)
    return dispatch<uint16_t>(bins, grad, hess, mask, nullptr, cap, F,
                              nullptr, nullptr, nullptr, nchunks, 1, num_bins,
                              1, partial, out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
