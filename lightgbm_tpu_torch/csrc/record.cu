// Kernels 6 and 7: the record route's partition of one leaf's window; and
// kernel 9, the write-back of a window into the record.
//
// The record is [W, ld] int32, row-major (ops/record.py): Wb words of packed
// bins, then grad, hess and mask bit patterns, the row id and the leaf id
// (row W-1).  A split stably partitions the parent's window
// [begin, begin+pcnt): the left-going columns first, then the right-going
// ones, each in their old order, and the child ids go into the leaf-id row.
// The leaf-id row is only stamped, never carried, so the run buffer comp
// holds the other R = W-1 rows.
//
// K6 `compact` replaces the TPU kernel lightgbm_tpu/ops/record.py
// _compact_kernel_prefix / _compact_kernel (pallas_calls at :1205 / :1217,
// reached through partition_window :1153), with the go flags computed in the
// kernel from the split feature's packed word as _tile_go (:214) does.  One
// block per tile of kTile columns runs compact_tile (compact_tile.cuh,
// shared with K8): one thread per column decides go, a block-wide scan
// gives its stable position among the tile's lefts or rights, and it copies
// its column's R words to comp[t] ([R, 2*kTile]); thread 0 writes the
// tile's counts.  Lanes past a run's count are not written.
//
// K7 `place` replaces the TPU kernel lightgbm_tpu/ops/record.py _place_kernel
// (pallas_call at :977, reached through place_runs :914; the TPU record route
// calls it from partition_window, :1229-1237).  One block per tile: lane l <
// cl[t] copies comp[t][:, l] to column begin + loff[t] + l of the record, lane
// l < cr[t] copies comp[t][:, kTile + l] to begin + nleft + roff[t] + l, and
// each writes its child's id into the leaf-id row.  The TPU kernel lets a
// later tile overwrite an earlier tile's garbage tail because its grid runs
// in order (record.py:52-55); CUDA blocks run in any order, so each block
// writes exactly its valid columns and nothing else.  K7 reads only comp,
// never the record window it writes, so the in-place write is safe.  nleft =
// loff[nt-1] + cl[nt-1] is read on the device, so no host read sits between
// the two launches.
//
// Bound on the H100: memory.  K6 must read the window's R rows and write as
// many to comp, 2*R*4*pcnt bytes; K7 must read comp's R rows and write all W
// rows of the window, (R+W)*4*pcnt bytes.  At the root split of the bench
// shape (W=12, 1M rows) that is 88 MB (0.0263 ms at 3.35 TB/s) and 92 MB
// (0.0275 ms).  No arithmetic to speak of.  This first design moves each
// column word by word (4-byte accesses, coalesced across the threads of a
// tile).
//
// K9 `write` replaces the TPU kernel lightgbm_tpu/ops/record.py
// _write_window_kernel (:575; pallas_call at :655, reached through
// write_window :618): rec[:, begin:begin+cap] = out_win in place.  The TPU
// kernel walks the window in TILE-column blocks and rotates each block by
// begin % TILE so that its aligned output blocks can alias the record
// (record.py:575-660); on the card a column offset costs nothing, so K9
// is a 2-D copy, grid (column blocks, W), in which each thread writes
// kWriteVecs 16-byte-aligned int4s of a destination row, all its loads
// issued before its stores, neighbouring threads on neighbouring int4s; the
// row's first 0-3 words up to a 16-byte boundary (the head) and its last
// 0-3 words (the tail) are written one word a thread by the first block of
// the row.  The source row is read with int4 loads where it has the
// destination's alignment, and otherwise with four 4-byte loads an int4
// (coalesced across the warp all the same).  Loads and stores are plain
// cached ones: a caller's next kernel may read the written window from
// L2.  The wrapper places begin first as the TPU interpret path's
// dynamic_update_slice does (negative from the end, clamped to [0,
// n-cap]).  No learner calls it (as in the JAX package;
// tools/tpu_parity_check.py does).  Bound: memory, 2*W*cap*4 bytes (96 MB
// for a 1M-column window at W=12, 0.0287 ms at 3.35 TB/s); on an NVIDIA
// H100 80GB HBM3 (700 W) K9 takes ~0.030 ms of device time there and one
// copy_ of the same slice ~0.037 (chip_smoke.py phase 12).
//
// The kernels run on the caller's stream and allocate nothing; the wrapper
// (ops/cuda_record.py) allocates comp, the counts and the offsets.  Each C
// entry returns cudaGetLastError().  The grid of K9 takes W <= 65535 rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact_tile.cuh"

namespace {

using namespace lgbm;

__global__ void __launch_bounds__(kTile)
    compact_kernel(const int* __restrict__ rec, int64_t ld, int W,
                   int64_t begin, int64_t pcnt, SplitRule rule,
                   int* __restrict__ comp,     // [nt, W-1, 2*kTile]
                   int* __restrict__ counts) {  // [2, nt]: cl, cr
  compact_tile(rec, ld, W, begin, pcnt, rule, blockIdx.x, gridDim.x, comp,
               counts);
}

__global__ void __launch_bounds__(kTile)
    place_kernel(const int* __restrict__ comp, const int* __restrict__ counts,
                 const int* __restrict__ offs,  // [2, nt]: loff, roff
                 int* __restrict__ rec, int64_t ld, int W, int64_t begin,
                 int left_leaf, int right_leaf) {
  const int nt = gridDim.x;
  const int t = blockIdx.x;
  const int l = threadIdx.x;
  const int lrow = W - 1;  // the leaf-id row; comp holds the rows above it
  const int* tile = comp + (int64_t)t * lrow * 2 * kTile;
  const int64_t nleft = (int64_t)offs[nt - 1] + counts[nt - 1];
  if (l < counts[t]) {
    const int64_t dst = begin + offs[t] + l;
    for (int w = 0; w < lrow; ++w)
      rec[(int64_t)w * ld + dst] = tile[(int64_t)w * 2 * kTile + l];
    rec[(int64_t)lrow * ld + dst] = left_leaf;
  }
  if (l < counts[nt + t]) {
    const int64_t dst = begin + nleft + offs[nt + t] + l;
    for (int w = 0; w < lrow; ++w)
      rec[(int64_t)w * ld + dst] = tile[(int64_t)w * 2 * kTile + kTile + l];
    rec[(int64_t)lrow * ld + dst] = right_leaf;
  }
}

constexpr int kWriteThreads = 256;
constexpr int kWriteVecs = 4;  // int4s a thread moves (all loads first)

// Words before the first 16-byte boundary at or after p (0-3), at most
// cap.
__device__ inline int64_t head_words(const int* p, int64_t cap) {
  const int64_t h = (int64_t)((16 - ((uintptr_t)p & 15)) & 15) / 4;
  return h < cap ? h : cap;
}

__global__ void __launch_bounds__(kWriteThreads)
    write_kernel(const int* __restrict__ out_win, int64_t cap,
                 int* __restrict__ rec, int64_t ld, int64_t begin) {
  const int64_t w = blockIdx.y;
  int* dst = rec + w * ld + begin;
  const int* src = out_win + w * cap;
  const int64_t head = head_words(dst, cap);
  const int64_t nvec = (cap - head) / 4;
  const bool aligned = ((uintptr_t)(src + head) & 15) == 0;
  const int64_t v0 =
      (int64_t)blockIdx.x * kWriteThreads * kWriteVecs + threadIdx.x;
  int4 x[kWriteVecs];
#pragma unroll
  for (int k = 0; k < kWriteVecs; ++k) {
    const int64_t v = v0 + k * kWriteThreads;
    if (v < nvec) {
      const int* s = src + head + 4 * v;
      if (aligned) {
        x[k] = *reinterpret_cast<const int4*>(s);
      } else {
        x[k].x = s[0];
        x[k].y = s[1];
        x[k].z = s[2];
        x[k].w = s[3];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kWriteVecs; ++k) {
    const int64_t v = v0 + k * kWriteThreads;
    if (v < nvec) *reinterpret_cast<int4*>(dst + head + 4 * v) = x[k];
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {  // the head and the tail
    const bool at_head = threadIdx.x < 4;
    const int64_t i = at_head ? threadIdx.x : head + 4 * nvec + threadIdx.x - 4;
    if (i < (at_head ? head : cap)) dst[i] = src[i];
  }
}

}  // namespace

extern "C" {

// Columns per tile: comp is [ceil(pcnt / tile), W - 1, 2 * tile] int32.
int lgbm_record_tile() { return kTile; }

// go = (bin == thr) if is_cat else (bin <= thr), bin = (word >> fshift) &
// fmask of record row `fword`.  All pointers are device pointers; `stream`
// is a cudaStream_t.
int lgbm_record_compact(const int* rec, int64_t ld, int W, int64_t begin,
                        int64_t pcnt, int fword, int fshift, unsigned fmask,
                        int thr, int is_cat, int* comp, int* counts,
                        void* stream) {
  const int64_t nt = (pcnt + kTile - 1) / kTile;
  if (nt > 0)
    compact_kernel<<<(unsigned)nt, kTile, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        rec, ld, W, begin, pcnt, SplitRule{fword, fshift, fmask, thr, is_cat},
        comp, counts);
  return (int)cudaGetLastError();
}

int lgbm_record_place(const int* comp, const int* counts, const int* offs,
                      int64_t nt, int* rec, int64_t ld, int W, int64_t begin,
                      int left_leaf, int right_leaf, void* stream) {
  if (nt > 0)
    place_kernel<<<(unsigned)nt, kTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        comp, counts, offs, rec, ld, W, begin, left_leaf, right_leaf);
  return (int)cudaGetLastError();
}

// rec[:, begin:begin+cap] = out_win ([W, cap], row-major) for the [W, ld]
// record; the caller has placed begin in [0, ld-cap].
int lgbm_record_write(const int* out_win, int64_t cap, int W, int* rec,
                      int64_t ld, int64_t begin, void* stream) {
  const int64_t vecs = cap / 4;  // int4s a row's body holds, at most
  constexpr int64_t per_block = kWriteThreads * kWriteVecs;
  const int64_t blocks = vecs > 0 ? (vecs + per_block - 1) / per_block : 1;
  if (cap > 0 && W > 0)
    write_kernel<<<dim3((unsigned)blocks, (unsigned)W), kWriteThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(out_win, cap, rec, ld,
                                                        begin);
  return (int)cudaGetLastError();
}

}  // extern "C"
