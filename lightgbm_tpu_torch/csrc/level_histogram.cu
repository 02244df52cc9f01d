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
// Design:
//  * prep: a stable sort of the leaf ids (torch.sort, in the wrapper) gives
//    the sorted row order; each leaf's rows are cut into chunks of kChunk
//    rows, at least one per leaf, so every chunk belongs to one leaf and an
//    empty leaf's chunk sums to zero.  The chunk table holds each chunk's
//    first sorted position and row count, and the leaves' first rows and
//    chunks; its capacity is ceil(n/kChunk) + L chunks, so nothing is read
//    back to the host (the unused tail chunks hold no rows).  One block
//    (layout_kernel) builds the table from the sorted ids by binary search
//    and a scan, in one launch where ops/histogram.level_layout, its plain
//    version, takes some twenty small PyTorch ops.
//  * pass 1 (both): grid (chunks, feature groups); a block stages its
//    chunk's masked stats once, gathered through the sorted order, and the
//    bins of its group, then builds each feature's (chunk, feature) partial
//    with hist_sorted (sorted_partial_kernel in hist_chunk.cuh, also the
//    pass 1 of K1 and K1'): a stable sort of the chunk's rows by
//    bin in shared memory (warp-private counts, rows ranked within a warp
//    by ballots over the bin's bits, a scan, the stats scattered into bin
//    order), then one thread per bin sums its run in row order.  That is a
//    few steps a row instead of the B compares a row of a walk per bin,
//    and no atomics.  The two variants differ only in their group: K1''
//    takes 4 features and 256 threads a block (kLevelGroup; 94 KB of
//    shared memory with u8 bins, two blocks to an SM), so a level has 7x
//    as many blocks as chunks at F = 28; K2 keeps the JAX package's 16
//    features (kGroup, FGROUP_BSUB) with 512 threads, and reads each row's
//    stats once per 16 features instead of once per 4, in a quarter of the
//    blocks.  tools/level_hist_variants.py times the other sizes.  Each
//    sums every cell in the same order, so the two are bitwise equal.
//  * pass 2 (both): one thread per (leaf, feature, bin, stat) sums that
//    leaf's partials in chunk order (reduce_chunks).
//  No atomics: every sum's order depends only on the rows, so launches are
//  bitwise repeatable and the plain version (ops/histogram.py
//  histogram_by_leaf_sorted_plain) equals both bitwise: per (chunk,
//  feature, bin) the bin's rows in row order from 0, then a leaf's chunk
//  partials in chunk order.  With one leaf the sorted order is the
//  identity and the chunks are K1's, so K2 with one leaf
//  (lgbm_hist_single_leaf_bsub) equals K1 bitwise.  The least pass 1 can
//  move is what its gathers through the sorted order touch: a 32-byte
//  sector per (row, feature) for the bins and per (row, group) for each of
//  the three stats (PERF.md has how far it runs from that).
//
// K1''-f64 (lgbm_level_hist_f64) is K1'' for hist_dtype=float64: the same
// sort, chunk table and pass 1 over the same float32 rows, with double
// sums (hist_chunk.cuh: each bin's run adds the exact products (double)g
// * (double)m in row order; the partials, pass 2 and the output double).
// It replaces no pallas_call: under float64 the JAX package runs no Pallas
// kernel and builds every level with jnp segment_sum
// (lightgbm_tpu/ops/histogram.py:49 histogram_by_leaf: depthwise levels,
// hybrid's level phase and its resume pass).  Its plain version is
// ops/histogram.py histogram_by_leaf_sorted_plain with acc_dtype=float64,
// bitwise.  Bound: K1'''s bytes in, L*F*B*24 out (43.7 MB at the bench
// level of 255 leaves).  There is no float64 K2: the JAX package never
// reaches its bsub kernel under float64.
//
// The kernels run on the caller's stream and allocate nothing; the
// PyTorch wrapper (ops/cuda_histogram.py) allocates the output and the
// [chunks, F, B, 3] scratch.  Each C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_chunk.cuh"

namespace {

using namespace lgbm;

constexpr int kLevelGroup = 4;      // features per K1'' block
constexpr int kLevelThreads = 256;  // threads per K1'' block
constexpr int kGroup = 16;          // features per K2 block (FGROUP_BSUB)
constexpr int kGroupThreads = 512;  // threads per K2 block

constexpr int kLayoutThreads = 1024;

// The chunk table of ops/histogram.level_layout from the sorted leaf ids
// sl[n]: row_start[l] (the first position of a leaf >= l, l = 0..L),
// chunk_start[l] (leaf l's first chunk; [L] the chunks in use) and, per
// chunk c < cap, row0[c], rows[c] and leaf[c] (L for the unused tail, whose
// row0 and rows are 0).  One block of kLayoutThreads.
template <typename IdT>
__global__ void __launch_bounds__(kLayoutThreads)
    layout_kernel(const IdT* __restrict__ sl, int64_t n, int L, int cap,
                  int64_t* row_start, int64_t* chunk_start,
                  int64_t* __restrict__ row0, int64_t* __restrict__ rows,
                  int64_t* __restrict__ leaf) {
  __shared__ int64_t s_warp[kLayoutThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int l = tid; l <= L; l += kLayoutThreads) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if ((int64_t)sl[mid] < l) lo = mid + 1; else hi = mid;
    }
    row_start[l] = lo;
  }
  __syncthreads();
  int64_t carry = 0;  // chunk_start: a scan of max(ceil(rows / kChunk), 1)
  for (int base = 0; base <= L; base += kLayoutThreads) {
    const int l = base + tid;
    int64_t v = 0;
    if (l < L) {
      const int64_t cnt = row_start[l + 1] - row_start[l];
      v = cnt > kChunk ? (cnt + kChunk - 1) / kChunk : 1;
    }
    int64_t x = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int64_t w = s_warp[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    if (l <= L) chunk_start[l] = carry + x - v + (warp ? s_warp[warp - 1] : 0);
    carry += s_warp[kLayoutThreads / 32 - 1];
    __syncthreads();
  }
  for (int c = tid; c < cap; c += kLayoutThreads) {
    int lo = 0, hi = L + 1;  // the first l with chunk_start[l] > c
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (chunk_start[mid] <= c) lo = mid + 1; else hi = mid;
    }
    const int l = lo - 1;
    leaf[c] = l;
    row0[c] = 0;
    rows[c] = 0;
    if (l < L) {
      const int64_t k = (c - chunk_start[l]) * kChunk;
      const int64_t left = row_start[l + 1] - row_start[l] - k;
      row0[c] = row_start[l] + k;
      rows[c] = left < 0 ? 0 : (left > kChunk ? kChunk : left);
    }
  }
}

// Cell i of leaf l: its chunks chunk_start[l] .. chunk_start[l+1]-1 (all
// nchunks for the single-leaf layout, chunk_start null) in chunk order.
template <typename Acc>
__global__ void level_reduce_kernel(const Acc* __restrict__ partial,
                                    const int64_t* __restrict__ chunk_start,
                                    int nchunks, int L, int64_t per_chunk,
                                    Acc* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)L * per_chunk) return;
  const int l = (int)(i / per_chunk);
  const int64_t c0 = chunk_start ? chunk_start[l] : 0;
  const int64_t c1 = chunk_start ? chunk_start[l + 1] : nchunks;
  out[i] = reduce_chunks(partial + c0 * per_chunk, (int)(c1 - c0), per_chunk,
                         i - (int64_t)l * per_chunk);
}

template <typename BinT, typename Acc>
int launch(const SortedRows<BinT>& rows, const Chunks& chunks,
           const int64_t* chunk_start, int F, int nchunks, int L,
           int num_bins, int variant, Acc* partial, Acc* out,
           cudaStream_t s) {
  if (nchunks > 0 && F > 0) {
    int e;
    if (variant == 0)
      e = launch_sorted_partial<BinT, kLevelGroup, kLevelThreads>(
          rows, chunks, F, nchunks, num_bins, partial, s);
    else if constexpr (sizeof(Acc) == sizeof(float))
      e = launch_sorted_partial<BinT, kGroup, kGroupThreads>(
          rows, chunks, F, nchunks, num_bins, partial, s);
    else
      e = (int)cudaErrorInvalidValue;  // no float64 K2
    if (e != 0) return e;
  }
  const int64_t per_chunk = (int64_t)F * num_bins * 3;
  const int64_t total = per_chunk * L;
  if (total > 0) {
    const int threads = 256;
    level_reduce_kernel<Acc><<<(int)((total + threads - 1) / threads),
                               threads, 0, s>>>(partial, chunk_start, nchunks,
                                                L, per_chunk, out);
  }
  return (int)cudaGetLastError();
}

template <typename BinT, typename Acc>
int dispatch(const void* bins, const float* grad, const float* hess,
             const float* mask, const int64_t* order, int64_t n, int F,
             const int64_t* chunk_row0, const int64_t* chunk_rows,
             const int64_t* chunk_start, int nchunks, int L, int num_bins,
             int variant, Acc* partial, Acc* out, void* stream) {
  const SortedRows<BinT> rows{static_cast<const BinT*>(bins), grad, hess,
                              mask, order, n};
  const Chunks chunks{chunk_row0, chunk_rows, n};
  return launch<BinT>(rows, chunks, chunk_start, F, nchunks, L, num_bins,
                      variant, partial, out,
                      static_cast<cudaStream_t>(stream));
}

template <typename IdT>
int launch_layout(const void* sorted_leaf, int64_t n, int L, int cap,
                  int64_t* table, cudaStream_t s) {
  int64_t* row_start = table;
  int64_t* chunk_start = row_start + (L + 1);
  int64_t* row0 = chunk_start + (L + 1);
  layout_kernel<IdT><<<1, kLayoutThreads, 0, s>>>(
      static_cast<const IdT*>(sorted_leaf), n, L, cap, row_start,
      chunk_start, row0, row0 + cap, row0 + 2 * (int64_t)cap);
  return (int)cudaGetLastError();
}

template <typename Acc>
int level_hist(const void* bins, int bin_bytes, const float* grad,
               const float* hess, const float* mask, const int64_t* order,
               const void* sorted_leaf, int id_bytes, int64_t n, int F, int L,
               int num_bins, int variant, int64_t* table, Acc* partial,
               Acc* out, void* stream) {
  if (order == nullptr || sorted_leaf == nullptr || table == nullptr
      || L < 1)
    return (int)cudaErrorInvalidValue;
  const int cap = (int)((n + kChunk - 1) / kChunk) + L;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = id_bytes == 4
                    ? launch_layout<int32_t>(sorted_leaf, n, L, cap, table, s)
                : id_bytes == 8
                    ? launch_layout<int64_t>(sorted_leaf, n, L, cap, table, s)
                    : (int)cudaErrorInvalidValue;
  if (e != 0) return e;
  const int64_t* chunk_start = table + (L + 1);
  const int64_t* row0 = chunk_start + (L + 1);
  if (bin_bytes == 1)
    return dispatch<uint8_t>(bins, grad, hess, mask, order, n, F, row0,
                             row0 + cap, chunk_start, cap, L, num_bins,
                             variant, partial, out, stream);
  if (bin_bytes == 2)
    return dispatch<uint16_t>(bins, grad, hess, mask, order, n, F, row0,
                              row0 + cap, chunk_start, cap, L, num_bins,
                              variant, partial, out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Rows per chunk and features per K2 block: the wrapper checks them against
// ops/histogram.py CHUNK_ROWS and ops/cuda_histogram.py BSUB_GROUP.
int lgbm_level_hist_chunk_rows() { return kChunk; }
int lgbm_level_hist_group() { return kGroup; }

// The level histogram of L leaves: K1'' (variant 0) or K2 (variant 1).
// bins [F, n] (bin_bytes 1: uint8, 2: uint16), grad/hess/mask [n] float32,
// order [n] int64 (sorted position -> row) and sorted_leaf [n] (id_bytes 4:
// int32, 8: int64) from a stable sort of the leaf ids; table
// [2 (L+1) + 3 cap] int64 scratch for the chunk table, cap = ceil(n/kChunk)
// + L (row_start [L+1], chunk_start [L+1], chunk_row0, chunk_rows and
// chunk_leaf [cap]: ops/histogram.level_layout's arrays); partial
// [cap, F, B, 3] and out [L, F, B, 3] float32.  All pointers are device
// pointers; `stream` is a cudaStream_t.
int lgbm_level_hist(const void* bins, int bin_bytes, const float* grad,
                    const float* hess, const float* mask,
                    const int64_t* order, const void* sorted_leaf,
                    int id_bytes, int64_t n, int F, int L, int num_bins,
                    int variant, int64_t* table, float* partial, float* out,
                    void* stream) {
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  return level_hist(bins, bin_bytes, grad, hess, mask, order, sorted_leaf,
                    id_bytes, n, F, L, num_bins, variant, table, partial, out,
                    stream);
}

// K1''-f64: lgbm_level_hist's K1'' (variant 0) with double partial
// [cap, F, B, 3] and out [L, F, B, 3].
int lgbm_level_hist_f64(const void* bins, int bin_bytes, const float* grad,
                        const float* hess, const float* mask,
                        const int64_t* order, const void* sorted_leaf,
                        int id_bytes, int64_t n, int F, int L, int num_bins,
                        int64_t* table, double* partial, double* out,
                        void* stream) {
  return level_hist(bins, bin_bytes, grad, hess, mask, order, sorted_leaf,
                    id_bytes, n, F, L, num_bins, 0, table, partial, out,
                    stream);
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
