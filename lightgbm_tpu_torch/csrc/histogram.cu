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
// Design: two passes and no atomics.
//  * pass 1: grid (row chunks of kChunk rows, features).  Block (c, f)
//    stages chunk c's masked stats and its bins of feature f in shared
//    memory, then builds the (chunk, feature) partial with hist_sorted: a
//    stable sort of the chunk's rows by bin in shared memory, then one
//    thread per bin adds its run in row order.  That is a few steps a row
//    where the per-bin walk of the first version (each thread scanning
//    every staged row for its own bins) took B compares a row.  The kernel is sorted_partial_kernel (hist_chunk.cuh),
//    the pass 1 of K1'' and K2 too, at one feature and 512 threads a block
//    (kSingleGroup x kSingleThreads, kWindowGroup x kWindowThreads): most
//    of a tree's launches are on a few chunks, where one feature a block
//    gives the grid F blocks a chunk; there it is 3x faster than 4
//    features a block, and at the 1M-row root 12-25 % slower than 4-8
//    (tools/single_hist_variants.py times 1-8 features a block at 2,048 to
//    1M rows).  K1 runs it over MatrixRows, which stages the bins in place
//    an aligned 4-byte word a load; K1' over WindowRows, which loads a
//    row's record word once and unpacks the block's bin from it (u8 bins
//    k = 4 to a word, u16 bins k = 2), and takes the stats' bit patterns
//    from the record.
//  * pass 2: one thread per (feature, bin, stat) sums the chunk partials in
//    chunk order; it loads kReduceBatch partials before it adds them, so a
//    thread keeps that many loads in flight over its dependent adds.
//  Every sum has the first version's order: each bin's rows in row order
//  from 0.f within a chunk, then the partials in chunk order.  So two
//  launches are bitwise equal, the plain versions (ops/histogram.py) equal
//  the kernels bitwise, K1' on a window equals K1 on the unpacked rows, and
//  K2 with one leaf (level_histogram.cu) equals K1.
//  Cost on an NVIDIA H100 80GB HBM3 (700 W), chip_smoke.py phases 2 and 4:
//  at the 1M-row root (F = 28, 255 u8 bins) K1 takes 0.48 ms (device:
//  pass 1 0.40, pass 2 0.027) and K1' 0.51 ms, against 2.5 ms for one
//  index_add_ of the same sums and 3.7 ms for the per-bin walk; that is
//  2.4-2.5 % of the 0.012 ms byte bound.  A 2,048-row set takes 0.0077 ms
//  of device time (0.039 before), so the call's host side sets its time.
//
// K1-f64 (lgbm_hist_single_leaf_f64) is K1 for hist_dtype=float64: the
// same float32 rows with double sums of the exact products (double)g *
// (double)m.  It replaces no pallas_call: under float64 the JAX package
// runs no Pallas kernel and sums with jnp segment_sum
// (lightgbm_tpu/ops/histogram.py:29 histogram_feature_major, the order
// route's root and smaller-child histograms, learners/serial.py:252-264).
// index_add_ on the card is unordered float atomics, which the port's
// determinism rule excludes, hence a kernel.  Its plain version is
// ops/histogram.py histogram_feature_major with acc_dtype=float64,
// bitwise.  Bound: K1's bytes in, F*B*24 out (the rows stay float32).
// Design: two pass-1 kernels that sum in one order (hist_chunk.cuh),
// picked by the set's size.  From kWalkMinChunks chunks (131,072 rows) up,
// walk_partial_kernel: no sort; block (f, g) is 8 warps, each walking one
// 2048-row chunk of group g in row order and adding each bin's lanes in
// lane order to its own shared-memory accumulator; the block adds its
// chunks in chunk order and writes one group partial, and the grid runs
// the features of a group next to each other, so L2 serves a chunk's
// stats to all F of them; pass 2 (hist_reduce_kernel<double>) adds the
// group partials in group order.  A smaller set keeps K1's bin sort
// (sorted_partial_kernel<..., double>, a partial a chunk: one warp's walk
// of a chunk is 64 dependent steps, 4-5x the sort's time at 2,048-16,384
// rows), and chunk_groups_reduce_kernel adds its partials in the same
// two-level order.  Scratch at the root of 17,825,792 rows x 28 x 255
// bins: 187 MB of group partials (one partial a chunk before, 1.49 GB).

// The kernels run on the caller's stream and allocate nothing; the
// PyTorch wrapper (ops/cuda_histogram.py) allocates the output and the
// [nchunks, F, B, 3] scratch (K1-f64 on the walk: [ngroups, F, B, 3]).
// Each C entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_chunk.cuh"

namespace {

using namespace lgbm;

constexpr int kSingleGroup = 1;      // features per K1 block
constexpr int kSingleThreads = 512;  // threads per K1 block
constexpr int kWindowGroup = 1;      // features per K1' block (one field)
constexpr int kWindowThreads = 512;  // threads per K1' block
constexpr int kReduceBatch = 16;     // partials a pass-2 thread loads at once
// K1-f64 walks a set of this many chunks or more, and sorts a smaller one
// (tools/single_hist_variants.py --f64 times both across row counts)
constexpr int kWalkMinChunks = 64;
constexpr int kReduceThreads = 256;

// Cell i of [F, B, 3]: reduce_chunks' sum, (0 + p_0) + p_1 + ..., in Acc,
// with the loads of kReduceBatch partials issued before their adds.
template <typename Acc>
__global__ void __launch_bounds__(kReduceThreads)
    hist_reduce_kernel(const Acc* __restrict__ partial, int nchunks,
                       int64_t per_chunk, Acc* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_chunk) return;
  const Acc* p = partial + i;
  Acc s = Acc(0);
  int c = 0;
  for (; c + kReduceBatch <= nchunks; c += kReduceBatch) {
    Acc v[kReduceBatch];
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j)
      v[j] = __ldg(p + (int64_t)(c + j) * per_chunk);
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j) s += v[j];
  }
  for (; c < nchunks; ++c) s += __ldg(p + (int64_t)c * per_chunk);
  out[i] = s;
}

// Both passes over the single-leaf chunks of `cap` rows: partial
// [ceil(cap / kChunk), F, B, 3] scratch, out [F, B, 3].  cap = 0 launches
// no pass 1 and pass 2 writes zeros.
template <typename BinT, int G, int kThreads, typename Rows>
int launch(const Rows& rows, int F, int64_t cap, int num_bins,
           float* partial, float* out, cudaStream_t s) {
  const int nchunks = (int)((cap + kChunk - 1) / kChunk);
  if (nchunks > 0 && F > 0) {
    const int e = launch_sorted_partial<BinT, G, kThreads>(
        rows, Chunks{nullptr, nullptr, cap}, F, nchunks, num_bins, partial,
        s);
    if (e != 0) return e;
  }
  const int64_t per_chunk = (int64_t)F * num_bins * 3;
  if (per_chunk > 0) {
    const int blocks = (int)((per_chunk + kReduceThreads - 1)
                             / kReduceThreads);
    hist_reduce_kernel<float><<<blocks, kReduceThreads, 0, s>>>(
        partial, nchunks, per_chunk, out);
  }
  return (int)cudaGetLastError();
}

template <typename BinT>
int single_leaf(const void* bins, const float* grad, const float* hess,
                const float* mask, int F, int64_t cap, int num_bins,
                float* partial, float* out, cudaStream_t s) {
  const MatrixRows<BinT> rows{static_cast<const BinT*>(bins), grad, hess,
                              mask, cap};
  return launch<BinT, kSingleGroup, kSingleThreads>(rows, F, cap, num_bins,
                                                    partial, out, s);
}

// Pass 2 of K1-f64 below kWalkMinChunks chunks: cell i's chunk partials
// in the walk's two-level order, each group of kGroupChunks chunks from 0
// in chunk order, then the groups from 0 in group order, with kReduceBatch
// loads issued before their adds (a missing chunk adds +0.0, and a missing
// group's sum +0.0, which leave a sum from 0 unchanged).
template <typename Acc>
__global__ void __launch_bounds__(kReduceThreads)
    chunk_groups_reduce_kernel(const Acc* __restrict__ partial, int nchunks,
                               int64_t per_chunk, Acc* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_chunk) return;
  const Acc* p = partial + i;
  static_assert(kReduceBatch % kGroupChunks == 0, "whole groups a batch");
  Acc s = Acc(0);
  for (int c0 = 0; c0 < nchunks; c0 += kReduceBatch) {
    Acc v[kReduceBatch];
#pragma unroll
    for (int j = 0; j < kReduceBatch; ++j)
      v[j] = c0 + j < nchunks ? __ldg(p + (int64_t)(c0 + j) * per_chunk)
                              : Acc(0);
#pragma unroll
    for (int g = 0; g < kReduceBatch; g += kGroupChunks) {
      Acc t = Acc(0);
#pragma unroll
      for (int j = 0; j < kGroupChunks; ++j) t += v[g + j];
      s += t;
    }
  }
  out[i] = s;
}

// K1-f64's passes over `cap` rows, whose order is the same either way:
// below kWalkMinChunks chunks K1's bin sort (a partial a chunk, scratch
// [nchunks, F, B, 3]) and the two-level pass 2; from there the walk in
// groups of kGroupChunks chunks (scratch [ceil(cap / (kGroupChunks *
// kChunk)), F, B, 3]) and the groups summed in group order.  cap = 0
// launches no pass 1 and pass 2 writes zeros.
template <typename BinT>
int single_leaf_f64(const void* bins, const float* grad, const float* hess,
                    const float* mask, int F, int64_t cap, int num_bins,
                    double* partial, double* out, cudaStream_t s) {
  const int nchunks = (int)((cap + kChunk - 1) / kChunk);
  const int64_t per_chunk = (int64_t)F * num_bins * 3;
  const int blocks = (int)((per_chunk + kReduceThreads - 1) / kReduceThreads);
  if (nchunks < kWalkMinChunks) {
    const MatrixRows<BinT> rows{static_cast<const BinT*>(bins), grad, hess,
                                mask, cap};
    if (nchunks > 0 && F > 0) {
      const int e = launch_sorted_partial<BinT, kSingleGroup, kSingleThreads>(
          rows, Chunks{nullptr, nullptr, cap}, F, nchunks, num_bins, partial,
          s);
      if (e != 0) return e;
    }
    if (per_chunk > 0)
      chunk_groups_reduce_kernel<double><<<blocks, kReduceThreads, 0, s>>>(
          partial, nchunks, per_chunk, out);
    return (int)cudaGetLastError();
  }
  const WalkMatrix<BinT> rows{static_cast<const BinT*>(bins), cap, grad,
                              hess, mask};
  const int ngroups = (nchunks + kGroupChunks - 1) / kGroupChunks;
  if (F > 0) {
    const WalkGroups groups{nullptr, nullptr, nullptr, nullptr, cap,
                            ngroups};
    const int e = launch_walk(rows, groups, F, ngroups, num_bins, partial,
                              out, s);
    if (e != 0) return e;
    if (ngroups > 1)  // one group wrote out itself
      hist_reduce_kernel<double><<<blocks, kReduceThreads, 0, s>>>(
          partial, ngroups, per_chunk, out);
  }
  return (int)cudaGetLastError();
}

template <typename BinT>
int record_window(const int* rec, int64_t ld, int64_t begin, int64_t cnt,
                  int F, int num_bins, float* partial, float* out,
                  cudaStream_t s) {
  constexpr int k = WindowRows<BinT>::kPack;
  const WindowRows<BinT> rows{rec, ld, begin, (F + k - 1) / k};
  return launch<BinT, kWindowGroup, kWindowThreads>(rows, F, cnt, num_bins,
                                                    partial, out, s);
}

}  // namespace

extern "C" {

// Rows staged per pass-1 block: the wrapper sizes the scratch as
// [ceil(cap / chunk_rows), F, num_bins, 3] floats; K1-f64's from
// walk_min_chunks chunks up a partial a group of group_chunks chunks,
// [ceil(cap / (chunk_rows * group_chunks)), F, num_bins, 3] doubles.
int lgbm_hist_chunk_rows() { return kChunk; }
int lgbm_hist_group_chunks() { return kGroupChunks; }
int lgbm_hist_walk_min_chunks() { return kWalkMinChunks; }

// bin_bytes: 1 (uint8 bins) or 2 (uint16 bins).  All pointers are device
// pointers; `stream` is a cudaStream_t.
int lgbm_hist_single_leaf(const void* bins, int bin_bytes, const float* grad,
                          const float* hess, const float* mask, int F,
                          int64_t cap, int num_bins, float* partial,
                          float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return single_leaf<uint8_t>(bins, grad, hess, mask, F, cap, num_bins,
                                partial, out, s);
  if (bin_bytes == 2)
    return single_leaf<uint16_t>(bins, grad, hess, mask, F, cap, num_bins,
                                 partial, out, s);
  return (int)cudaErrorInvalidValue;
}

// K1-f64: lgbm_hist_single_leaf's rows and arguments with double partial
// [ceil(cap / chunk_rows), F, num_bins, 3] below walk_min_chunks chunks,
// else [ceil(cap / (chunk_rows * group_chunks)), F, num_bins, 3], and out
// [F, num_bins, 3].
int lgbm_hist_single_leaf_f64(const void* bins, int bin_bytes,
                              const float* grad, const float* hess,
                              const float* mask, int F, int64_t cap,
                              int num_bins, double* partial, double* out,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return single_leaf_f64<uint8_t>(bins, grad, hess, mask, F, cap,
                                    num_bins, partial, out, s);
  if (bin_bytes == 2)
    return single_leaf_f64<uint16_t>(bins, grad, hess, mask, F, cap,
                                     num_bins, partial, out, s);
  return (int)cudaErrorInvalidValue;
}

// Kernel 1' over columns [begin, begin+cnt) of the [W, ld] int32 record
// (k = 4 u8 or 2 u16 bins per word, F features in the first ceil(F/k)
// rows, the stats in the three rows after them).
int lgbm_hist_record_window(const int* rec, int64_t ld, int64_t begin,
                            int64_t cnt, int F, int k, int num_bins,
                            float* partial, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 4)
    return record_window<uint8_t>(rec, ld, begin, cnt, F, num_bins, partial,
                                  out, s);
  if (k == 2)
    return record_window<uint16_t>(rec, ld, begin, cnt, F, num_bins, partial,
                                   out, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
