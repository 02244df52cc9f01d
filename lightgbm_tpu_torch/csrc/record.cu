// Kernels 6 and 7: the record route's partition of one leaf's window; and
// kernel 9, the write-back of a window into the record.
//
// The record is [W, ld] int32, row-major (ops/record.py): Wb words of packed
// bins, then grad, hess and mask bit patterns, the row id and the leaf id
// (row W-1).  A split stably partitions the parent's window
// [begin, begin+pcnt): the left-going columns first, then the right-going
// ones, each in their old order, and the child ids go into the leaf-id row.
// The leaf-id row is only stamped, never carried, so the run buffer comp
// ([nt, R, 2*kTile], R = W-1) holds the other rows.  ld is the record's
// length n, any value, so each row of a window starts at its own 16-byte
// alignment.
//
// Bound on the H100: memory.  K6 must read the window's R rows and write as
// many to comp, 2*R*4*pcnt bytes; K7 must read comp's R rows and write all W
// rows of the window, (R+W)*4*pcnt bytes.  At the root split of the bench
// shape (W=12, 1M rows) that is 88 MB (0.0263 ms at 3.35 TB/s) and 92 MB
// (0.0275 ms).  No arithmetic to speak of.  Most launches are small (the
// median window is ~16,700 columns, ~1.5 MB), where the in-block chain of
// dependent steps and the launch itself set the time, not the bytes.
//
// K6 `compact` replaces the TPU kernel lightgbm_tpu/ops/record.py
// _compact_kernel_prefix / _compact_kernel (pallas_calls at :1205 / :1217,
// reached through partition_window :1153), with the go flags computed in the
// kernel from the split feature's packed word as _tile_go (:214) does.  A
// block of kTile threads takes a contiguous group of tiles of kTile columns,
// with as many blocks as fit on the card at once (kCompactWaves times that);
// when the tiles are fewer (a small window, or few tiles of a wide record),
// the rows are split over blocks too (grid.y, at least kSliceRows rows a
// block), each block deciding its tile's columns itself.  A block walks its
// tiles' rows in units of at most kStageRows rows.  Each unit's columns go to
// shared memory with cp.async, 16 bytes a copy over each row's 16-byte-
// aligned body and 4 over its 0-3-word head and tail, staged at the row's own
// alignment so every 16-byte copy is aligned at both ends; two buffers in
// turn, so the next unit's loads (the next tile's included) are in flight
// while one is written, and shared memory does not grow with W.  While a
// tile's first loads fly, each thread reads its column's split word, decides
// go, and a block-wide ballot scan gives the column's position in the tile's
// left or right run; the source column of every run lane goes into a shared
// index.  Then each thread gathers 4 lanes of a run from the staged rows and
// writes them to comp with one 16-byte store: lanes [0, cl) and [kTile,
// kTile+cr) of each row, rounded up to 4 (the lanes past a run's count are
// unspecified), never whole halves.  Thread 0 writes the tile's counts.  K8
// (split_step.cu) keeps its own one-column-a-thread compaction
// (compact_tile.cuh), whose output is the same.
//
// K7 `place` replaces the TPU kernel lightgbm_tpu/ops/record.py _place_kernel
// (pallas_call at :977, reached through place_runs :914; the TPU record route
// calls it from partition_window, :1229-1237).  It takes K6's or K8's comp
// and counts as they are, and computes the run offsets itself, so no other
// launch sits between the compaction and the placement: the grid is at most
// kPlaceBlocksPerSM blocks an SM, and block b owns the contiguous group of
// tiles [b*g, b*g+g) (with the rows split over blocks, grid.y, as in K6 when
// the groups are fewer).  Each block reduces, from counts, the lefts and the
// rights of the tiles before its group and all lefts (nleft: at most 2*nt
// ints a block, read from L2), and scans its group's counts, so its lefts go
// to one contiguous range [begin + Lbase, ...) and its rights to another
// [begin + nleft + Rbase, ...).  Block 0 writes nleft to a one-int output.
// Then one warp per (row, run) of the group writes the run's columns of that
// row with 16-byte stores: each lane loads the run's int4s it needs (lanes of
// comp start 16-byte aligned; all of a warp's loads before its stores,
// kPlaceBatch (row, run)s at once), shifts them to the destination's
// alignment with a shuffle from its neighbour, and stores the destination's
// aligned int4s, the 0-3 words at either end of the run one word at a time.
// The leaf-id row is stamped with 16-byte stores over the group's two ranges.
// The TPU kernel lets a later tile overwrite an earlier tile's garbage tail
// because its grid runs in order (record.py:52-55); CUDA blocks run in any
// order, so each block writes exactly its valid columns and nothing else: K7
// writes exactly [begin, begin+pcnt).  K7 reads only comp and counts, never
// the record window it writes, so the in-place write is safe.
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
// (ops/cuda_record.py) allocates comp, the counts and nleft.  Each C entry
// returns cudaGetLastError().  The grid of K9 takes W <= 65535 rows.

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact_tile.cuh"

namespace {

using namespace lgbm;

constexpr unsigned kFull = 0xffffffffu;

// Words p lies past the 16-byte boundary at or before it (0-3).
__device__ inline int mis4(const int* p) {
  return (int)(((uintptr_t)p >> 2) & 3);
}

__device__ inline void cp_async16(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ inline void cp_async4(int* smem, const int* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This block's rows of a slice of `slice` rows out of R: [y0, y0 + rows).
// The count goes through an empty asm, so the compiler treats it as an
// opaque value: nvcc for sm_90a was seen to fold the nested minimum of
// the bound (min(R, y0 + slice) inside a loop's min(.., r0 + 16)) into a
// wrong trip count, and the loops then ran past the block's rows.
__device__ inline int slice_rows(int R, int y0, int slice) {
  int rows = R - y0 < slice ? R - y0 : slice;
  asm volatile("" : "+r"(rows));
  return rows;
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- K6
constexpr int kStageRows = 16;  // record rows a staging buffer holds
// words a staged row takes: column j of a row whose window starts a words
// past a 16-byte boundary sits at word a + j, so its int4s stay aligned
constexpr int kStageStride = kTile + 4;
// The grid: the blocks that fit on the card at once, times kCompactWaves,
// each compacting a contiguous group of tiles; a window of fewer tiles
// splits its rows over blocks instead (grid.y, at least kSliceRows rows a
// block).
constexpr int kCompactWaves = 8;
constexpr int kSliceRows = 4;
constexpr int kSliceBlocksPerSM = 1;  // the row split's target

// Issue the cp.asyncs that stage rows [r0, r1) of the tile (columns [0,
// len) from src, a row every ld words) into buf.
__device__ inline void stage_rows(const int* __restrict__ src, int64_t ld,
                                  int r0, int r1, int len, int* buf) {
  const int per_row = (len + 6) >> 2;  // int4s a row's columns can touch
  const int total = (r1 - r0) * per_row;
  for (int u = threadIdx.x; u < total; u += kTile) {
    const int rl = u / per_row, q = u - rl * per_row;
    const int* row = src + (int64_t)(r0 + rl) * ld;
    const int a = mis4(row);
    const int lo = max(4 * q, a), hi = min(4 * q + 4, a + len);
    int* s = buf + rl * kStageStride;
    if (hi - lo == 4) {
      cp_async16(s + lo, row + (lo - a));
    } else {
      for (int w = lo; w < hi; ++w) cp_async4(s + w, row + (w - a));
    }
  }
}

// Write the staged rows [r0, r1) of the tile's runs to comp_t ([R,
// 2*kTile]): 4 lanes a thread, one 16-byte store; idx[l] / idx[kTile + l]
// hold the source column of left / right lane l.
__device__ inline void write_runs(const int* __restrict__ src, int64_t ld,
                                  int r0, int r1, const int* buf,
                                  const int* idx, int cl, int cr,
                                  int* __restrict__ comp_t) {
  const int nl = (cl + 3) >> 2;
  const int per_row = nl + ((cr + 3) >> 2);
  const int total = (r1 - r0) * per_row;
  for (int u = threadIdx.x; u < total; u += kTile) {
    const int rl = u / per_row, v = u - rl * per_row;
    const int* s =
        buf + rl * kStageStride + mis4(src + (int64_t)(r0 + rl) * ld);
    const bool right = v >= nl;
    const int p = 4 * (right ? v - nl : v);  // the int4's first lane
    const int n = right ? cr : cl;
    const int4 ix =
        *reinterpret_cast<const int4*>(idx + (right ? kTile : 0) + p);
    int4 o;
    o.x = s[ix.x];  // p < n: the int4 holds at least one lane of the run
    o.y = p + 1 < n ? s[ix.y] : 0;
    o.z = p + 2 < n ? s[ix.z] : 0;
    o.w = p + 3 < n ? s[ix.w] : 0;
    *reinterpret_cast<int4*>(comp_t + (int64_t)(r0 + rl) * 2 * kTile +
                             (right ? kTile : 0) + p) = o;
  }
}

// A block walks its tiles' rows in units of at most kStageRows rows (a
// tile's rows [y0, y0+rows) are `chunks` units); unit q is staged into
// buffer q & 1 two units ahead of its write, so the next unit's loads, the
// next tile's included, are in flight while one is written.
__global__ void __launch_bounds__(kTile, 4)
    compact_kernel(const int* __restrict__ rec, int64_t ld, int W,
                   int64_t begin, int64_t pcnt, SplitRule rule, int64_t nt,
                   int64_t group,               // tiles a block
                   int slice,                   // rows a block (grid.y)
                   int* __restrict__ comp,     // [nt, W-1, 2*kTile]
                   int* __restrict__ counts) {  // [2, nt]: cl, cr
  extern __shared__ int4 s_stage4[];  // one or two [kStageRows, stride]
  int* const stage = reinterpret_cast<int*>(s_stage4);
  __shared__ __align__(16) int s_idx[2][kTile];
  __shared__ int s_warp[2][kTileWarps];
  const int R = W - 1;
  const int y0 = blockIdx.y * slice;  // this block's rows [y0, y0+rows)
  const int rows = slice_rows(R, y0, slice);
  const int chunks = (rows + kStageRows - 1) / kStageRows;
  const int64_t t0 = (int64_t)blockIdx.x * group;
  const int units = (int)(nt - t0 < group ? nt - t0 : group) * chunks;
  // a buffer's words: the host sizes shared memory by slice
  const int buf_words =
      (slice < kStageRows ? slice : kStageRows) * kStageStride;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // unit q: its tile's first column, columns, and rows [r0, r1)
  auto unit = [&](int q, int64_t& c0, int& len, int& r0, int& r1) {
    const int i = q / chunks;
    c0 = (t0 + i) * kTile;
    len = pcnt - c0 < kTile ? (int)(pcnt - c0) : kTile;
    r0 = y0 + (q - i * chunks) * kStageRows;
    r1 = min(y0 + rows, r0 + kStageRows);
  };
  auto stage_unit = [&](int q) {
    int64_t c0;
    int len, r0, r1;
    unit(q, c0, len, r0, r1);
    stage_rows(rec + begin + c0, ld, r0, r1, len, stage + (q & 1) * buf_words);
  };
  // every row's loads first: the first two units go out at once
  stage_unit(0);
  cp_async_commit();
  if (units > 1) stage_unit(1);
  cp_async_commit();
  int cl = 0, cr = 0;
  for (int q = 0; q < units; ++q) {
    int64_t c0;
    int len, r0, r1;
    unit(q, c0, len, r0, r1);
    const int64_t t = c0 / kTile;
    if (r0 == y0) {  // a new tile: decide its columns while loads fly
      const bool valid = tid < len;
      const bool go = valid && rule.go(rec, ld, begin + c0 + tid);
      const bool right = valid && !go;
      const unsigned bl = __ballot_sync(kFull, go);
      const unsigned br = __ballot_sync(kFull, right);
      if (lane == 0) {
        s_warp[0][warp] = __popc(bl);
        s_warp[1][warp] = __popc(br);
      }
      __syncthreads();
      int lbase = 0, rbase = 0;
      cl = cr = 0;
      for (int i = 0; i < kTileWarps; ++i) {
        if (i < warp) {
          lbase += s_warp[0][i];
          rbase += s_warp[1][i];
        }
        cl += s_warp[0][i];
        cr += s_warp[1][i];
      }
      if (tid == 0 && blockIdx.y == 0) {
        counts[t] = cl;
        counts[nt + t] = cr;
      }
      const unsigned below = (1u << lane) - 1u;
      if (go) s_idx[0][lbase + __popc(bl & below)] = tid;
      if (right) s_idx[1][rbase + __popc(br & below)] = tid;
    }
    cp_async_wait<1>();  // this thread's copies of unit q have landed
    __syncthreads();     // everyone's, and s_idx
    write_runs(rec + begin + c0, ld, r0, r1, stage + (q & 1) * buf_words,
               &s_idx[0][0], cl, cr, comp + t * R * 2 * kTile);
    __syncthreads();  // the buffer, s_idx and s_warp are read before reuse
    if (q + 2 < units) stage_unit(q + 2);
    cp_async_commit();
  }
}

// ---------------------------------------------------------------- K7
constexpr int kPlaceThreads = 256;
constexpr int kPlaceWarps = kPlaceThreads / 32;
constexpr int kPlaceBlocksPerSM = 2;  // the grid: at most this many an SM
constexpr int kPlaceBatch = 1;        // (row, run)s a warp has in flight

__device__ inline int4 shfl_up1(int4 a) {
  return make_int4(
      __shfl_up_sync(kFull, a.x, 1), __shfl_up_sync(kFull, a.y, 1),
      __shfl_up_sync(kFull, a.z, 1), __shfl_up_sync(kFull, a.w, 1));
}

__device__ inline int4 shfl_from(int4 a, int src) {
  return make_int4(
      __shfl_sync(kFull, a.x, src), __shfl_sync(kFull, a.y, src),
      __shfl_sync(kFull, a.z, src), __shfl_sync(kFull, a.w, src));
}

// Lanes [4v-m, 4v-m+4) of a run from x = its lanes [4v-4, 4v) and y =
// [4v, 4v+4).
__device__ inline int4 funnel(int4 x, int4 y, int m) {
  switch (m) {
    case 0:
      return y;
    case 1:
      return make_int4(x.w, y.x, y.y, y.z);
    case 2:
      return make_int4(x.z, x.w, y.x, y.y);
    default:
      return make_int4(x.y, x.z, x.w, y.x);
  }
}

// o to the 16-byte-aligned d: one store when positions p0..p0+3 all lie in
// [0, n), else the words that do, one at a time.
__device__ inline void store_part(int* d, int4 o, int p0, int n) {
  if (p0 >= 0 && p0 + 4 <= n) {
    *reinterpret_cast<int4*>(d) = o;
    return;
  }
  if (p0 >= 0 && p0 < n) d[0] = o.x;
  if (p0 + 1 >= 0 && p0 + 1 < n) d[1] = o.y;
  if (p0 + 2 >= 0 && p0 + 2 < n) d[2] = o.z;
  if (p0 + 3 >= 0 && p0 + 3 < n) d[3] = o.w;
}

__global__ void __launch_bounds__(kPlaceThreads)
    place_kernel(const int* __restrict__ comp,    // [nt, W-1, 2*kTile]
                 const int* __restrict__ counts,  // [2, nt]: cl, cr
                 int64_t nt, int64_t group, int slice,
                 int* __restrict__ rec,
                 int64_t ld, int W, int64_t begin, int left_leaf,
                 int right_leaf, int* __restrict__ nleft_out) {
  // s_off[side][i]: where tile i's run starts in the group's range, and
  // s_off[side][ng] its length
  __shared__ int s_off[2][kPlaceThreads + 1];
  __shared__ int s_scan[2][kPlaceWarps];
  __shared__ long long s_red[3][kPlaceWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t0 = (int64_t)blockIdx.x * group;
  const int ng = (int)(nt - t0 < group ? nt - t0 : group);
  // the lefts and rights of the tiles before the group, and all lefts
  long long lb = 0, rb = 0, lt = 0;
  for (int64_t i = tid; i < nt; i += kPlaceThreads) {
    const int l = counts[i];
    lt += l;
    if (i < t0) {
      lb += l;
      rb += counts[nt + i];
    }
  }
  // the group's runs: an inclusive scan over its ng <= kPlaceThreads tiles
  int il = tid < ng ? counts[t0 + tid] : 0;
  int ir = tid < ng ? counts[nt + t0 + tid] : 0;
  for (int o = 1; o < 32; o <<= 1) {
    const int ul = __shfl_up_sync(kFull, il, o);
    const int ur = __shfl_up_sync(kFull, ir, o);
    if (lane >= o) {
      il += ul;
      ir += ur;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lb += __shfl_down_sync(kFull, lb, o);
    rb += __shfl_down_sync(kFull, rb, o);
    lt += __shfl_down_sync(kFull, lt, o);
  }
  if (lane == 31) {
    s_scan[0][warp] = il;
    s_scan[1][warp] = ir;
  }
  if (lane == 0) {
    s_red[0][warp] = lb;
    s_red[1][warp] = rb;
    s_red[2][warp] = lt;
  }
  __syncthreads();
  lb = rb = lt = 0;
  for (int i = 0; i < kPlaceWarps; ++i) {
    if (i < warp) {
      il += s_scan[0][i];
      ir += s_scan[1][i];
    }
    lb += s_red[0][i];
    rb += s_red[1][i];
    lt += s_red[2][i];
  }
  s_off[0][tid + 1] = il;
  s_off[1][tid + 1] = ir;
  if (tid == 0) {
    s_off[0][0] = s_off[1][0] = 0;
    if (blockIdx.x == 0 && blockIdx.y == 0) *nleft_out = (int)lt;
  }
  __syncthreads();
  const int R = W - 1;
  const int y0 = blockIdx.y * slice;  // this block's rows [y0, y0+rows)
  const int rows = slice_rows(R, y0, slice);
  const int64_t lbeg = begin + lb, rbeg = begin + lt + rb;
  // one warp per (row w, side, tile i) of the group, kPlaceBatch at once
  const int items = rows * 2 * ng;
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int k0 = warp; k0 < items; k0 += kPlaceWarps * kPlaceBatch) {
    int4 y[kPlaceBatch][4];
    int n[kPlaceBatch], m[kPlaceBatch];
    int* d[kPlaceBatch];
#pragma unroll
    for (int b = 0; b < kPlaceBatch; ++b) {
      const int k = k0 + b * kPlaceWarps;
      const int4* s = nullptr;
      n[b] = m[b] = 0;
      d[b] = nullptr;
      if (k < items) {
        const int w = y0 + k / (2 * ng), rem = k - (w - y0) * 2 * ng;
        const int side = rem >= ng, i = rem - side * ng;
        n[b] = s_off[side][i + 1] - s_off[side][i];
        int* dst =
            rec + (int64_t)w * ld + (side ? rbeg : lbeg) + s_off[side][i];
        m[b] = mis4(dst);
        d[b] = dst - m[b];
        s = reinterpret_cast<const int4*>(
            comp + ((t0 + i) * R + w) * 2 * kTile + side * kTile);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int v = 32 * j + lane;
        y[b][j] = 4 * v < n[b] ? s[v] : zero;
      }
    }
#pragma unroll
    for (int b = 0; b < kPlaceBatch; ++b) {
      if (k0 + b * kPlaceWarps >= items) break;  // the same for the warp
#pragma unroll
      for (int j = 0; j <= 4; ++j) {
        const int4 yj = j < 4 ? y[b][j] : zero;
        int4 x = zero;
        if (m[b] != 0) {  // the same for the warp
          x = shfl_up1(yj);
          const int4 prev = shfl_from(j > 0 ? y[b][j - 1] : zero, 31);
          if (lane == 0) x = prev;
        }
        const int v = 32 * j + lane;
        const int p0 = 4 * v - m[b];
        if (p0 < n[b])
          store_part(d[b] + 4 * v, funnel(x, yj, m[b]), p0, n[b]);
      }
    }
  }
  // the leaf-id row over the group's two ranges, by the first row slice
  if (blockIdx.y != 0) return;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int n = s_off[side][ng];
    int* dst = rec + (int64_t)R * ld + (side ? rbeg : lbeg);
    const int m = mis4(dst);
    const int id = side ? right_leaf : left_leaf;
    const int4 o = make_int4(id, id, id, id);
    for (int v = tid; 4 * v - m < n; v += kPlaceThreads)
      store_part(dst - m + 4 * v, o, 4 * v - m, n);
  }
}

constexpr int kMaxDevices = 64;

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev >= 0 && dev < kMaxDevices ? dev : 0;
}

// The current device's SMs (read once a device).
int sm_count() {
  static int sms[kMaxDevices];
  const int dev = current_device();
  if (sms[dev] <= 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 1;
  }
  return sms[dev];
}

// Tiles a block of K7 places, for nt tiles on the current device.
int64_t place_group(int64_t nt) {
  const int64_t cap = (int64_t)kPlaceBlocksPerSM * sm_count();
  const int64_t g = (nt + cap - 1) / cap;
  return g < 1 ? 1 : (g < kPlaceThreads ? g : kPlaceThreads);
}

// Rows a block takes when `blocks` blocks cover the tiles and the grid
// should hold `target` blocks: all R when they do, else R split into
// slices of at least kSliceRows rows.
int row_slice(int R, int64_t blocks, int64_t target) {
  if (blocks >= target) return R;
  const int64_t most = (R + kSliceRows - 1) / kSliceRows;  // slices
  int64_t want = (target + blocks - 1) / blocks;
  if (want > most) want = most;
  return (int)((R + want - 1) / want);
}

struct CompactGrid {
  dim3 grid;
  int64_t group;  // tiles a block
  int slice;      // rows a block
  size_t smem;    // dynamic shared memory
};

// K6's grid: as many blocks as fit on the card at once (times
// kCompactWaves), each a contiguous group of tiles, or the rows split over
// blocks when the tiles are fewer.
CompactGrid compact_grid(int64_t nt, int R) {
  const auto smem_of = [](int64_t group, int slice) {
    const int rows = slice < kStageRows ? slice : kStageRows;
    const int bufs = (group > 1 || slice > kStageRows) ? 2 : 1;
    return (size_t)bufs * rows * kStageStride * sizeof(int);
  };
  // resident blocks an SM with both buffers, by device and rows a unit;
  // the kernel is opted in once a device to the most it may take (two
  // full buffers and its static arrays pass the 48 KB default)
  static int resident[kMaxDevices][kStageRows + 1];
  const int dev = current_device();
  const int unit_rows = R < kStageRows ? R : kStageRows;
  int& per_sm = resident[dev][unit_rows];
  if (per_sm <= 0) {
    cudaFuncSetAttribute(compact_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem_of(2, kStageRows));
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, compact_kernel, kTile, smem_of(2, R)) != cudaSuccess ||
        per_sm <= 0) {
      cudaGetLastError();  // the query's own error; one block an SM then
      per_sm = 1;
    }
  }
  const int64_t target = (int64_t)kCompactWaves * per_sm * sm_count();
  CompactGrid g;
  g.group = (nt + target - 1) / target;
  const int64_t blocks = (nt + g.group - 1) / g.group;
  g.slice = row_slice(R, blocks, (int64_t)kSliceBlocksPerSM * sm_count());
  g.grid = dim3((unsigned)blocks, (unsigned)((R + g.slice - 1) / g.slice));
  g.smem = smem_of(g.group, g.slice);
  return g;
}

// ---------------------------------------------------------------- K9
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
  if (nt > 0) {
    // (compact_grid opts the kernel in to its shared memory)
    const CompactGrid g = compact_grid(nt, W - 1);
    compact_kernel<<<g.grid, kTile, g.smem,
                     static_cast<cudaStream_t>(stream)>>>(
        rec, ld, W, begin, pcnt, SplitRule{fword, fshift, fmask, thr, is_cat},
        nt, g.group, g.slice, comp, counts);
  }
  return (int)cudaGetLastError();
}

// The grids of the compact and place kernels for a window of nt tiles
// and W rows: out = {K6 tiles a block, K6 blocks, K6 rows a block, K7
// tiles a block, K7 blocks, K7 rows a block}.
int lgbm_record_grids(int64_t nt, int W, int64_t* out) {
  if (nt <= 0) return 1;
  const int R = W - 1;
  const CompactGrid g = compact_grid(nt, R);
  out[0] = g.group;
  out[1] = g.grid.x;
  out[2] = g.slice;
  out[3] = place_group(nt);
  out[4] = (nt + out[3] - 1) / out[3];
  out[5] = row_slice(R, out[4], (int64_t)kPlaceBlocksPerSM * sm_count());
  return (int)cudaGetLastError();
}

// The runs of comp back into [begin, begin+pcnt) of the record, nleft to
// nleft_out (one int).
int lgbm_record_place(const int* comp, const int* counts, int64_t nt,
                      int* rec, int64_t ld, int W, int64_t begin,
                      int left_leaf, int right_leaf, int* nleft_out,
                      void* stream) {
  if (nt > 0) {
    const int R = W - 1;
    const int64_t g = place_group(nt), blocks = (nt + g - 1) / g;
    const int slice =
        row_slice(R, blocks, (int64_t)kPlaceBlocksPerSM * sm_count());
    const dim3 grid((unsigned)blocks, (unsigned)((R + slice - 1) / slice));
    place_kernel<<<grid, kPlaceThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        comp, counts, nt, g, slice, rec, ld, W, begin, left_leaf, right_leaf,
        nleft_out);
  }
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
