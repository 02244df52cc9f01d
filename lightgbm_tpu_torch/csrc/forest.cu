// Kernels F1 and F3: the forest's lane functions.  A forest grows B
// independent trees (lanes) over one shared [F, n] bin matrix, each lane
// with its own gradients, mask, feature sample and constraints
// (learners/forest.py); one step splits every live lane's best leaf.
//
// F1 replaces the lane histogram of the JAX package's batched grower,
// lightgbm_tpu/learners/forest.py:123 _batched_hist (a vmap of one
// segment_sum per feature; no pallas_call): for every lane b with
// target[b] >= 0 the histogram hist[b][F, B, 3] = (sum g*m, sum h*m, sum m)
// over the rows r with leaf_id[b, r] == target[b]; a lane with target -1
// is idle and gets zeros.  The sums are kernel 1's (histogram.cu) over the
// lane's rows taken in ascending row order: blocks of kChunk rows, each
// bin's rows in row order from 0.f within a block (hist_sorted,
// hist_chunk.cuh), then the block partials in block order from 0.f.  The
// order route keeps each leaf's rows in ascending row order (its stable
// partition), so F1's lane histogram is bitwise the order route's K1
// histogram of the same leaf, block boundaries included; that is what
// makes a lane's tree bitwise the tree grown alone.
//
// F3 replaces the lane searches of the same grower, forest.py:112-121
// _search2_lanes / _search_root (vmaps of find_best_split_leaves /
// find_best_split; no pallas_call): both children's best split for every
// lane, each lane under its own feature mask (meta [B, F, 4]) and scalars
// (scal [B, 12]: can, lsg, lsh, lc, rsg, rsh, rc, min_data, min_hess, l1,
// l2, min_gain), into K3's [2, 16] rows a lane.  Each (lane, child,
// feature) is scanned by one warp with scan_feature_warp and each (lane,
// child) winner written by winner_row (search_step.cuh), the code of K3,
// so a lane's rows are bitwise K3's rows on the same histograms.
//
// Bound on the H100.  F1: memory.  It must read the lanes' leaf ids (4 B
// a row a lane), and for every member row its F bins and three stats, and
// write B*F*num_bins*12 bytes.  F3: memory and latency, like K3: it reads
// 2*B*F*num_bins*12 bytes and writes 128 B a lane; each (lane, child,
// feature) is a dependent chain of adds and two divisions a bin.
//
// Design.  F1 is one C call of five launches, no atomics:
//  * count: block (tile, lane) counts its kChunk rows' members;
//  * scan: one block turns the counts into each tile's exclusive offset
//    within its lane and each lane's first chunk (lane b's rows take
//    ceil(rows_b / kChunk) chunks, back to back);
//  * scatter: block (tile, lane) writes its members' row ids, in row
//    order (a block-wide exclusive scan of the per-thread counts), to
//    the lane's sorted positions: the lane's rows in ascending order;
//  * pass 1: block (chunk, feature) finds the lane that owns the chunk
//    (binary search of the lane starts) and builds the chunk's partial
//    with hist_sorted over SortedRows, the lane's gradient rows gathered
//    through the sorted row ids (K1'''s pass 1, K1's sums);
//  * pass 2: thread (cell, lane) adds the lane's chunk partials in chunk
//    order from 0.f, K1's pass 2.
// The chunk capacity (the scratch) is given by the wrapper from a bound
// on any lane's rows; a lane whose chunks would not fit gets NaN, never a
// wrong finite histogram.  F3 is two launches: the (lane, child,
// feature) scans into a [B, 2, F, kPerFeature] scratch, then one warp a
// (lane, child) picks the largest gain, the smallest feature among equal
// gains (K3's pick), and writes the row.
// The kernels run on the caller's stream and allocate nothing: the
// wrapper (ops/cuda_forest.py) allocates outputs and scratch.  Each C
// entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hist_chunk.cuh"
#include "search_step.cuh"

namespace {

using namespace lgbm;

constexpr int kTileThreads = 256;                  // count / scatter blocks
constexpr int kRowsPer = kChunk / kTileThreads;    // rows a thread walks
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kScanThreads = 1024;                 // the scan's one block
constexpr int kHistThreads = 512;                  // pass-1 blocks
constexpr int kReduceThreads = 256;                // pass-2 blocks
constexpr int kReduceBatch = 16;  // partials a pass-2 thread loads at once
constexpr int kWarps = 4;         // F3: warps a scan block
constexpr unsigned kAll = 0xffffffffu;

// Exclusive prefix of v over the block's threads (kTileThreads); every
// thread must call it.  *total receives the block's sum.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kTileWarps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kTileWarps) s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[kTileWarps - 1];
  return x - v + (warp ? s_warp[warp - 1] : 0);
}

// Member flags of thread's rows r0 .. r0+kRowsPer-1 of lane b (bit j).
__device__ __forceinline__ unsigned member_bits(const int* leaf_id, int tgt,
                                                int64_t n, int b,
                                                int64_t r0) {
  unsigned bits = 0;
  if (tgt < 0) return 0;
  const int* row = leaf_id + (int64_t)b * n;
#pragma unroll
  for (int j = 0; j < kRowsPer; ++j) {
    const int64_t r = r0 + j;
    if (r < n && row[r] == tgt) bits |= 1u << j;
  }
  return bits;
}

__global__ void __launch_bounds__(kTileThreads)
    count_kernel(const int* __restrict__ leaf_id,
                 const int* __restrict__ target, int64_t n, int ntiles,
                 int* __restrict__ tile_cnt) {
  __shared__ int s_warp[kTileWarps];
  const int t = blockIdx.x, b = blockIdx.y;
  const int64_t r0 = (int64_t)t * kChunk + threadIdx.x * kRowsPer;
  const int c = __popc(member_bits(leaf_id, target[b], n, b, r0));
  int total;
  block_exclusive_scan(c, s_warp, &total);
  if (threadIdx.x == 0) tile_cnt[(int64_t)b * ntiles + t] = total;
}

// One block: tile_off[b, t] = members of lane b in tiles before t,
// lane_rows[b] = lane b's members, chunk_start[b] = the lane's first chunk
// (chunk_start[B] = every lane's chunks).
__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int* __restrict__ tile_cnt, int B, int ntiles,
                int* __restrict__ tile_off, int* __restrict__ lane_rows,
                int* __restrict__ chunk_start) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += kScanThreads / 32) {
    int carry = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const int v = t < ntiles ? tile_cnt[(int64_t)b * ntiles + t] : 0;
      int x = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, x, o);
        if (lane >= o) x += y;
      }
      if (t < ntiles) tile_off[(int64_t)b * ntiles + t] = carry + x - v;
      carry += __shfl_sync(kAll, x, 31);
    }
    if (lane == 0) lane_rows[b] = carry;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int b = 0; b < B; ++b) {
      chunk_start[b] = s;
      s += (lane_rows[b] + kChunk - 1) / kChunk;
    }
    chunk_start[B] = s;
  }
}

__global__ void __launch_bounds__(kTileThreads)
    scatter_kernel(const int* __restrict__ leaf_id,
                   const int* __restrict__ target, int64_t n, int ntiles,
                   const int* __restrict__ tile_off,
                   const int* __restrict__ chunk_start, int64_t cap_rows,
                   int64_t* __restrict__ order) {
  __shared__ int s_warp[kTileWarps];
  const int t = blockIdx.x, b = blockIdx.y;
  const int64_t r0 = (int64_t)t * kChunk + threadIdx.x * kRowsPer;
  unsigned bits = member_bits(leaf_id, target[b], n, b, r0);
  int total;
  const int before = block_exclusive_scan(__popc(bits), s_warp, &total);
  int64_t pos = (int64_t)chunk_start[b] * kChunk
                + tile_off[(int64_t)b * ntiles + t] + before;
  while (bits) {
    const int j = __ffs(bits) - 1;
    bits &= bits - 1;
    if (pos < cap_rows) order[pos] = r0 + j;
    ++pos;
  }
}

// Pass 1: block (c, f) builds chunk c's partial of feature f, the chunk
// belonging to the lane whose chunk range holds c.
template <typename BinT>
__global__ void __launch_bounds__(kHistThreads)
    lane_partial_kernel(const BinT* __restrict__ bins,
                        const float* __restrict__ grad,
                        const float* __restrict__ hess,
                        const float* __restrict__ mask, int64_t n,
                        const int64_t* __restrict__ order,
                        const int* __restrict__ lane_rows,
                        const int* __restrict__ chunk_start, int B, int F,
                        int num_bins, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, f = blockIdx.y;
  if (c >= chunk_start[B]) return;  // block-uniform: past every lane
  int lo = 0, hi = B;  // the largest b with chunk_start[b] <= c
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_start[mid] <= c) lo = mid; else hi = mid;
  }
  const int b = lo;
  const int k = c - chunk_start[b];
  const int left = lane_rows[b] - k * kChunk;
  const int nrows = left < kChunk ? left : kChunk;
  const int64_t off = (int64_t)b * n;
  const SortedRows<BinT> rows{bins, grad + off, hess + off, mask + off,
                              order, n};
  hist_sorted<BinT, 1, kHistThreads>(
      rows, (int64_t)c * kChunk, nrows, f, 1, num_bins,
      partial + ((int64_t)c * F + f) * num_bins * 3, smem);
}

// Pass 2: cell i of lane b, its chunk partials in chunk order from 0.f
// (K1's pass 2); zeros for an idle lane, NaN for a lane past the capacity.
__global__ void __launch_bounds__(kReduceThreads)
    lane_reduce_kernel(const float* __restrict__ partial,
                       const int* __restrict__ chunk_start,
                       const int* __restrict__ target, int cap_chunks,
                       int64_t per_chunk, float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= per_chunk) return;
  float s = 0.f;
  const int c0 = chunk_start[b], c1 = chunk_start[b + 1];
  if (target[b] < 0) {
    s = 0.f;
  } else if (c1 > cap_chunks) {
    s = NAN;
  } else {
    const float* p = partial + i;
    int c = c0;
    for (; c + kReduceBatch <= c1; c += kReduceBatch) {
      float v[kReduceBatch];
#pragma unroll
      for (int j = 0; j < kReduceBatch; ++j)
        v[j] = __ldg(p + (int64_t)(c + j) * per_chunk);
#pragma unroll
      for (int j = 0; j < kReduceBatch; ++j) s += v[j];
    }
    for (; c < c1; ++c) s += __ldg(p + (int64_t)c * per_chunk);
  }
  out[(int64_t)b * per_chunk + i] = s;
}

template <typename BinT>
int forest_hist(const void* bins_v, const float* grad, const float* hess,
                const float* mask, const int* leaf_id, const int* target,
                int B, int64_t n, int F, int num_bins, int cap_chunks,
                int* work, int64_t* order, float* partial, float* out,
                cudaStream_t s) {
  const BinT* bins = static_cast<const BinT*>(bins_v);
  const int ntiles = (int)((n + kChunk - 1) / kChunk);
  int* tile_cnt = work;
  int* tile_off = tile_cnt + (int64_t)B * ntiles;
  int* lane_rows = tile_off + (int64_t)B * ntiles;
  int* chunk_start = lane_rows + B;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  if (ntiles > 0) {
    count_kernel<<<dim3(ntiles, B), kTileThreads, 0, s>>>(leaf_id, target, n,
                                                          ntiles, tile_cnt);
  }
  scan_kernel<<<1, kScanThreads, 0, s>>>(tile_cnt, B, ntiles, tile_off,
                                         lane_rows, chunk_start);
  if (ntiles > 0) {
    scatter_kernel<<<dim3(ntiles, B), kTileThreads, 0, s>>>(
        leaf_id, target, n, ntiles, tile_off, chunk_start,
        (int64_t)cap_chunks * kChunk, order);
  }
  if (cap_chunks > 0 && F > 0) {
    if (F > 65535) return (int)cudaErrorInvalidValue;
    const int smem = hist_sorted_smem<BinT, 1>();
    const cudaError_t e = cudaFuncSetAttribute(
        lane_partial_kernel<BinT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    lane_partial_kernel<BinT><<<dim3(cap_chunks, F), kHistThreads, smem, s>>>(
        bins, grad, hess, mask, n, order, lane_rows, chunk_start, B, F,
        num_bins, partial);
  }
  const int64_t per_chunk = (int64_t)F * num_bins * 3;
  if (per_chunk > 0) {
    const int blocks = (int)((per_chunk + kReduceThreads - 1)
                             / kReduceThreads);
    lane_reduce_kernel<<<dim3(blocks, B), kReduceThreads, 0, s>>>(
        partial, chunk_start, target, cap_chunks, per_chunk, out);
  }
  return (int)cudaGetLastError();
}

// A lane's 12 scalars (can, lsg, lsh, lc, rsg, rsh, rc, min_data,
// min_hess, l1, l2, min_gain) as K3's ScalT: `can` for both children.
__device__ __forceinline__ Scal lane_scal(const float* v) {
  Scal p;
  p.can[0] = v[0]; p.sg[0] = v[1]; p.sh[0] = v[2]; p.cnt[0] = v[3];
  p.can[1] = v[0]; p.sg[1] = v[4]; p.sh[1] = v[5]; p.cnt[1] = v[6];
  p.min_data = v[7]; p.min_hess = v[8];
  p.l1 = v[9]; p.l2 = v[10]; p.min_gain = v[11];
  return p;
}

// F3's scans: warp i of block row a scans (child i / F, feature i % F) of
// lane a into best [a, i, kPerFeature].
__global__ void __launch_bounds__(kWarps * 32)
    lane_scan_kernel(const float* __restrict__ h_left,
                     const float* __restrict__ h_right,
                     const int* __restrict__ meta,
                     const float* __restrict__ scal, int F, int nb,
                     float* __restrict__ best) {
  const int a = blockIdx.y;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= 2 * F) return;  // warp-uniform
  const Scal p = lane_scal(scal + (int64_t)a * 12);
  const int c = i / F;
  const int64_t cells = (int64_t)F * nb * 3;
  const float* hist = (c ? h_right : h_left) + a * cells;
  scan_feature_warp(hist, meta + (int64_t)a * F * 4, i - c * F, nb, c, p,
                    best + ((int64_t)a * 2 * F + i) * kPerFeature);
}

// F3's pick: warp c of block a takes child c's winner over the features
// (each lane its features in ascending order with a strict ">", then the
// butterfly: the largest gain, the smallest feature among equal gains)
// and lane 0 writes the [16] row.
__global__ void __launch_bounds__(64)
    lane_pick_kernel(const float* __restrict__ h_left,
                     const float* __restrict__ h_right,
                     const int* __restrict__ meta,
                     const float* __restrict__ scal, int F, int nb,
                     const float* __restrict__ best,
                     float* __restrict__ out) {
  const int a = blockIdx.x, c = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* bc = best + ((int64_t)a * 2 + c) * F * kPerFeature;
  float g = -INFINITY;
  int fb = -1;
  for (int f = lane; f < F; f += 32) {
    const float v = bc[(int64_t)f * kPerFeature];
    if (v > g) {
      g = v;
      fb = f;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(kAll, g, o);
    const int of = __shfl_xor_sync(kAll, fb, o);
    if (og > g || (og == g && of < fb)) {
      g = og;
      fb = of;
    }
  }
  if (lane == 0) {
    const Scal p = lane_scal(scal + (int64_t)a * 12);
    const int64_t cells = (int64_t)F * nb * 3;
    const float* hist = (c ? h_right : h_left) + a * cells;
    winner_row(hist, bc + (int64_t)(fb >= 0 ? fb : 0) * kPerFeature, fb,
               meta + (int64_t)a * F * 4, F, nb, c, p,
               out + ((int64_t)a * 2 + c) * 16);
  }
}

}  // namespace

extern "C" {

// Rows a chunk holds (ops/histogram.py CHUNK_ROWS).
int lgbm_forest_chunk_rows() { return kChunk; }

// F1.  bins [F, n] (bin_bytes 1: uint8, 2: uint16); grad/hess/mask and
// leaf_id [B, n]; target [B] (-1: idle lane); work: 2 * B * ceil(n /
// chunk_rows) + 2 * B + 1 ints; order: cap_chunks * chunk_rows int64;
// partial: [cap_chunks, F, num_bins, 3] floats; out [B, F, num_bins, 3].
// cap_chunks must be at least the sum over lanes of ceil(rows / chunk_rows)
// (a lane past it gets NaN).  All pointers are device pointers; `stream`
// is a cudaStream_t.
int lgbm_forest_hist(const void* bins, int bin_bytes, const float* grad,
                     const float* hess, const float* mask, const int* leaf_id,
                     const int* target, int B, int64_t n, int F, int num_bins,
                     int cap_chunks, int* work, int64_t* order,
                     float* partial, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1)
    return forest_hist<uint8_t>(bins, grad, hess, mask, leaf_id, target, B,
                                n, F, num_bins, cap_chunks, work, order,
                                partial, out, s);
  if (bin_bytes == 2)
    return forest_hist<uint16_t>(bins, grad, hess, mask, leaf_id, target, B,
                                 n, F, num_bins, cap_chunks, work, order,
                                 partial, out, s);
  return (int)cudaErrorInvalidValue;
}

// F3.  h_left/h_right [A, F, nb, 3]; meta [A, F, 4] int32; scal [A, 12];
// best: A * 2 * F * kPerFeature (8) floats of scratch; out [A, 2, 16].
int lgbm_forest_search(const float* h_left, const float* h_right,
                       const int* meta, const float* scal, int A, int F,
                       int nb, float* best, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (A <= 0) return 0;
  if (A > 65535) return (int)cudaErrorInvalidValue;
  if (F > 0) {
    const int blocks = (2 * F + kWarps - 1) / kWarps;
    lane_scan_kernel<<<dim3(blocks, A), kWarps * 32, 0, s>>>(
        h_left, h_right, meta, scal, F, nb, best);
  }
  lane_pick_kernel<<<A, 64, 0, s>>>(h_left, h_right, meta, scal, F, nb, best,
                                    out);
  return (int)cudaGetLastError();
}

}  // extern "C"
