// Kernels F1 and F3: the forest's lane functions, one forest step.  A forest
// grows B independent trees (lanes) over one shared [F, n] bin matrix
// (learners/forest.py), each lane with its own gradients, mask, feature sample
// and constraints; one step splits one leaf of every live lane.
//
// F1 replaces the lane histogram of the JAX package's batched grower,
// lightgbm_tpu/learners/forest.py:123 _batched_hist (a vmap of one segment_sum
// per feature; no pallas_call), and in its step form the partition before it
// (the masked leaf-map update and the smaller child's pick,
// forest.py:252-279).  Root form: for every lane a the histogram hist[a][F,
// nb, 3] = (sum g*m, sum h*m, sum m) over the rows r with leaf_id[a, r] == 0
// (the lane's root set; a lane with none gets zeros).  Step form, for A active lanes given by the host (lane b, parent leaf bl, feature,
// threshold, categorical flag, parent count, new leaf): the rows of leaf bl
// that fail `bin <= thr` (numerical) or `bin == thr` (categorical) take the
// new leaf in the map, in place, and each lane's smaller child (left where 2 *
// nleft <= pcnt, ties to the left, as learners/serial.py picks it) gets its
// histogram.  The sums are kernel 1's (histogram.cu) over the lane's rows in
// ascending row order: chunks of kChunk rows from the lane's first member,
// each bin's rows in row order from 0.f within a chunk (the values K1's
// hist_sorted adds, hist_chunk.cuh), then the chunk partials in chunk order
// from 0.f (reduce_chunks).  The order route keeps each leaf's rows in
// ascending row order (its stable partition), so a lane's histogram is bitwise
// the order route's K1 histogram of the same leaf, chunk boundaries included,
// and a lane's tree is bitwise the tree grown alone.
//
// F3 replaces the lane searches of the same grower, forest.py:112-121
// _search2_lanes / _search_root (vmaps of find_best_split_leaves /
// find_best_split; no pallas_call), and in its step form the subtraction and
// the buffer writes around them (forest.py:280-318): both children's best
// split for every lane under the lane's own feature mask (meta [B, F, 4]) and
// scalars (can, lsg, lsh, lc, rsg, rsh, rc, min_data, min_hess, l1, l2,
// min_gain), into K3's [2, 16] rows a lane.  Root form: the lane's root
// histogram (its buffer row 0) searched as both children, as the grower
// searches a root.  Step form: the larger child is
// parent - smaller (elementwise f32, PyTorch's subtraction), both children are
// written into the lane's [L, F, nb, 3] buffer rows bl (left) and new leaf
// (right), both searched, and F1's left count goes into slot 11 of the lane's
// first row.  Each (lane, feature) is scanned by one warp with
// scan_feature_warp and each (lane, child) winner written by winner_row
// (search_step.cuh), the code of K3, so a lane's rows are bitwise K3's rows on
// the same histograms.
//
// Bound on the H100: memory.  F1 reads the lanes' leaf ids (4 B a row a
// lane); the step form also reads the split feature's bin of each member of
// the parent (1 or 2 B) and writes the leaf id of each member that goes right
// (4 B).  Then for every member row of the chosen child it reads its F bins
// and three stats, and it writes A * F * nb * 12 bytes.  F3's step form reads
// the parent's and the smaller child's rows and writes both children's, 4 *
// A * F * nb * 12 bytes (the root form reads A * F * nb * 12), and writes 128
// B a lane; each (lane, child, feature) is a dependent chain of adds and two
// divisions a bin.  At the forest's shapes (a few lanes of a few thousand
// rows) both are far from those bounds: launches and the host bound them, so
// the design counts launches and host work first.
//
// Design.  F1 is one C call of three launches (two where the rows fit one
// tile), no float atomics, and no allocation: the wrapper (ops/cuda_forest.py
// ForestStep) sizes the scratch once a round from the largest root: every lane
// at the steps' bound (a smaller child holds at most half the root's rows),
// the root form over as many lanes a call as fit at the root's; the call's
// capacity is a fixed number of chunks a lane, and a lane whose rows would not
// fit gets NaN, never a wrong finite histogram.
//  * count (grid tiles x lanes): block (t, a) walks its kChunk rows of lane
//    a's map, 8 a thread (two 16-byte loads); in the step form it partitions
//    them (reads the split feature's bin of each member, writes new_leaf
//    where the row goes right) and keeps each thread's left and right member
//    bits (a 16-bit word a thread) and the tile's two counts.  The last block
//    of each lane, found by a fenced atomic ticket (search.cu's; a lane of
//    one tile needs none), sums the lane's tile counts, picks the side (the
//    root form: the members), and scans the side's tile counts into each
//    tile's offset.  Where the rows fit one tile (n <= kChunk, the forest's
//    usual size) that block is the lane's only one and scatters its rows
//    itself, below, and the call is two launches;
//  * scatter (grid tiles x lanes): block (0, 0) first lays the lanes' chunks
//    out back to back (chunk_start, a block-wide scan over the lanes); block
//    (t, a) writes the row ids of the chosen side's members of its tile (a
//    block-wide exclusive scan of the threads' bit counts), ascending, into
//    the lane's own region of the int32 order scratch, and beside each its g,
//    h and mask: the lane's rows in ascending order, their stats compacted,
//    so the histogram reads each lane's [B, n] stats once and not once a
//    feature (a sparse leaf's gathers from [B, n] rows that do not fit in L2
//    cost most of the time at 64 lanes x 1M rows);
//  * histogram (a persistent grid, SMs x blocks an SM): its warps walk the
//    (chunk, feature) items that exist, chunk_start[A] * F of them, never the
//    capacity, one item a warp.  The warp walks its chunk's rows 32 at a time
//    in row order (walk_chunk, hist_chunk.cuh, K1-f64's walk, here in float:
//    the lanes of equal bin found with __match_any_sync, the lowest adding
//    its row and then the others' in lane order to the warp's [R, 3]
//    accumulator in shared memory), so each bin's rows are added in row order
//    from 0.f, K1's partial bitwise, with no sort, no count table and no
//    block barrier; the compacted stats are read in order and the bins
//    gathered through the row ids.  A block of 512 threads a (chunk, feature)
//    and K1's shared-memory bin sort (88 KB, two blocks an SM) keep two
//    chunks in flight on an SM; a warp a walk keeps tens.  A lane of one
//    chunk writes the histogram itself (0.f + p is p: no sum of a chunk is
//    -0).  With more chunks the warp writes the chunk's partial and takes a
//    (lane, feature) ticket, and the block whose warp takes the last adds the
//    pair's partials in chunk order from 0.f (K1's pass 2, reduce_chunks) and
//    resets the ticket; a lane's items run chunks innermost, so the pairs'
//    ends fall on different blocks.  Empty lanes write zeros, a lane past
//    its capacity NaN.
// F3 is one launch in either form, grid ceil(2F / 4) blocks a lane of four
// warps, a warp a (child, feature) pair; both forms read the lanes' scalars
// from the step's uploaded values and take the work's tickets.  In the step form the two warps of
// feature f sit in one block: the right child's warp reads f's cells of the
// parent and of the smaller child (kStepLoads a lane before it stores any) and
// writes the right child's row; a block barrier; then the left child's warp
// reads them again and writes the left child over the parent's row, each cell
// by the lane that read it.  Each warp then __syncwarp()s and scans its own
// child's row, so both children's scans run side by side (K4 scans them in
// turn in one warp), the left child overwrites the parent in place with no
// ordering between blocks, and no cell is read after another warp wrote it.
// Each warp writes its pair's best to a scratch; the last block of the lane (a
// per-lane ticket) picks both children's winners, the largest gain and the
// smallest feature among equal gains (K3's pick), and writes the rows. Every
// launch runs on the caller's stream; the step's values come in one
// host-to-device copy on that stream (lgbm_forest_split, which first checks
// them on the host and refuses a step out of range).  The histogram kernel's
// shared-memory attribute is set once a process and device
// (lgbm_forest_prepare), never on a call.  Each C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hist_chunk.cuh"
#include "search_step.cuh"

namespace {

using namespace lgbm;

constexpr int kTileThreads = 256;                // count / scatter blocks
constexpr int kRowsPer = kChunk / kTileThreads;  // rows a thread walks
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kHistWarps = 8;  // histogram blocks: a walk a warp
constexpr int kHistThreads = kHistWarps * 32;
constexpr int kWarps = 4;          // F3: warps a block
constexpr int kSearchThreads = kWarps * 32;
constexpr int kStepLoads = 8;  // F3 step: cells a lane loads before storing
constexpr int kPickLoads = 8;  // F3 pick: bests a thread loads at once
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

static_assert(kRowsPer == 8, "a thread's member bits are one byte a side");

// A step's values a lane, as the host uploads them (ints; the 12 search
// scalars as float bits from kSpScal).
constexpr int kStepInts = 20;
enum { kSpLane, kSpLeaf, kSpFeat, kSpThr, kSpCat, kSpPcnt, kSpNew,
       kSpScal = 8 };
// F1's results a lane: the chosen side's rows, the left count, the side
// (0 left), its leaf, its chunks (1 for an empty or a refused lane) and
// whether it is past the capacity.
constexpr int kInfoInts = 8;
enum { kInRows, kInLeft, kInSide, kInTarget, kInChunks, kInOver };

// The work buffer of a forest (ints, zeroed once: the tickets must start
// at 0, and every kernel leaves them at 0).
struct Work {
  int* info;         // [B, kInfoInts]
  int* chunk_start;  // [B + 1]
  int* lane_ticket;  // [B]
  int* search_ticket;  // [B]
  int* feat_ticket;  // [B, F]
  int* tile_cnt;     // [B, ntiles, 2]: left, right
  int* tile_off;     // [B, ntiles]
  uint16_t* bits;    // [B, ntiles, kTileThreads]: left | right << 8
};

// Carves `base` (may be null) into *w (may be null); returns the ints.
inline int64_t work_ints(int B, int ntiles, int F, Work* w, int* base) {
  const int64_t k[7] = {(int64_t)B * kInfoInts, B + 1, B, B,
                        (int64_t)B * F, (int64_t)B * ntiles * 2,
                        (int64_t)B * ntiles};
  int* at[7];
  int64_t used = 0;
  for (int i = 0; i < 7; ++i) {
    at[i] = base ? base + used : nullptr;
    used += k[i];
  }
  if (w) {
    *w = Work{at[0], at[1], at[2], at[3], at[4], at[5], at[6],
              reinterpret_cast<uint16_t*>(base ? base + used : nullptr)};
  }
  return used + (int64_t)B * ntiles * kTileThreads / 2;  // the bits
}

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

// The block's sums of (x, y) (kTileThreads threads, every one calls),
// returned to every thread.
__device__ void block_sum2(int* x, int* y, int (*s)[kTileWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int a = __reduce_add_sync(kAll, *x), b = __reduce_add_sync(kAll, *y);
  __syncthreads();  // s may still be read from an earlier call
  if (lane == 0) {
    s[0][warp] = a;
    s[1][warp] = b;
  }
  __syncthreads();
  int sa = 0, sb = 0;
  for (int w = 0; w < kTileWarps; ++w) {
    sa += s[0][w];
    sb += s[1][w];
  }
  *x = sa;
  *y = sb;
}

// The thread's chosen members (bits b of its kRowsPer rows from row r0 of
// lane `lane`), ascending across the block, from position dst0 of the
// slot's region: row ids into `order`, g, h and mask beside them in
// `stats` ([3, A, cap_rows], cap_all = A * cap_rows).  Every thread of the
// block must call it.
__device__ void scatter_rows(unsigned b, int r0, int64_t dst0,
                             int64_t cap_all, const float* grad,
                             const float* hess, const float* mask,
                             int64_t off, int* order, float* stats,
                             int* s_warp) {
  int total;
  const int before = block_exclusive_scan(__popc(b), s_warp, &total);
  int* dst = order + dst0 + before;
  float* sg = stats + dst0 + before;
  while (b) {
    const int j = __ffs(b) - 1;
    b &= b - 1;
    const int r = r0 + j;
    *dst++ = r;
    sg[0] = grad[off + r];
    sg[cap_all] = hess[off + r];
    sg[2 * cap_all] = mask[off + r];
    ++sg;
  }
}

// Launch 1: count, partition (step form) and, in each lane's last block,
// the lane's side and offsets.  Block (t, a).
template <typename BinT>
__global__ void __launch_bounds__(kTileThreads)
    count_kernel(const BinT* __restrict__ bins, int* __restrict__ leaf_id,
                 int64_t n, int ntiles, const int* __restrict__ step,
                 int64_t cap_rows, Work w,
                 const float* __restrict__ grad,
                 const float* __restrict__ hess,
                 const float* __restrict__ mask, int* __restrict__ order,
                 float* __restrict__ stats) {
  __shared__ int s_sum[2][kTileWarps];
  __shared__ int s_warp[kTileWarps];
  __shared__ int s_last;
  const int t = blockIdx.x, a = blockIdx.y, tid = threadIdx.x;
  const int* sp = step ? step + (int64_t)a * kStepInts : nullptr;
  const int lane = sp ? sp[kSpLane] : a;
  const int leaf = sp ? sp[kSpLeaf] : 0;  // the root form: leaf 0
  const int64_t r0 = (int64_t)t * kChunk + tid * kRowsPer;
  unsigned lb = 0, rb = 0;
  int* row = leaf_id + (int64_t)lane * n;
  int id[kRowsPer];  // the thread's 8 rows' leaves (-1 past n)
  if ((n & 3) == 0 && r0 + kRowsPer <= n) {  // 16-byte aligned
    const int4 u = *reinterpret_cast<const int4*>(row + r0);
    const int4 v = *reinterpret_cast<const int4*>(row + r0 + 4);
    id[0] = u.x; id[1] = u.y; id[2] = u.z; id[3] = u.w;
    id[4] = v.x; id[5] = v.y; id[6] = v.z; id[7] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRowsPer; ++j) id[j] = r0 + j < n ? row[r0 + j] : -1;
  }
  if (sp == nullptr) {
#pragma unroll
    for (int j = 0; j < kRowsPer; ++j)
      if (id[j] == leaf) lb |= 1u << j;
  } else {
    const BinT* fb = bins + (int64_t)sp[kSpFeat] * n;
    const int thr = sp[kSpThr], cat = sp[kSpCat], nl = sp[kSpNew];
#pragma unroll
    for (int j = 0; j < kRowsPer; ++j) {
      const int64_t r = r0 + j;
      if (id[j] == leaf) {
        const int v = (int)fb[r];
        if (cat ? v == thr : v <= thr) {
          lb |= 1u << j;
        } else {
          rb |= 1u << j;
          row[r] = nl;
        }
      }
    }
  }
  int* tc = w.tile_cnt + (int64_t)a * ntiles * 2;
  w.bits[((int64_t)a * ntiles + t) * kTileThreads + tid] =
      (uint16_t)(lb | (rb << 8));
  int cl = __popc(lb), cr = __popc(rb);
  block_sum2(&cl, &cr, s_sum);
  if (tid == 0) {
    tc[2 * t] = cl;
    tc[2 * t + 1] = cr;
    if (ntiles > 1) {
      __threadfence();  // the counts before the ticket
      s_last = atomicAdd(w.lane_ticket + a, 1) == ntiles - 1;
    }
  }
  int nlft = cl, nrgt = cr;  // one tile: the lane's totals
  if (ntiles > 1) {
    __syncthreads();
    if (!s_last) return;
    // the lane's last block: every tile of the lane is counted
    __threadfence();
    nlft = nrgt = 0;
    for (int i = tid; i < ntiles; i += kTileThreads) {
      nlft += __ldcg(tc + 2 * i);
      nrgt += __ldcg(tc + 2 * i + 1);
    }
    block_sum2(&nlft, &nrgt, s_sum);
  }
  const int side = (sp && 2 * (int64_t)nlft > (int64_t)sp[kSpPcnt]) ? 1 : 0;
  int carry = 0;
  for (int t0 = 0; t0 < ntiles; t0 += kTileThreads) {
    const int i = t0 + tid;
    const int v = i < ntiles ? __ldcg(tc + 2 * i + side) : 0;
    int total;
    __syncthreads();  // s_warp of the previous pass is read
    const int before = block_exclusive_scan(v, s_warp, &total);
    if (i < ntiles) w.tile_off[(int64_t)a * ntiles + i] = carry + before;
    carry += total;
  }
  const bool over = (int64_t)carry > cap_rows;
  if (tid == 0) {
    int* info = w.info + (int64_t)a * kInfoInts;
    info[kInRows] = carry;
    info[kInLeft] = nlft;
    info[kInSide] = side;
    info[kInTarget] = side ? sp[kSpNew] : leaf;
    info[kInChunks] = (carry == 0 || over) ? 1 : (carry + kChunk - 1) / kChunk;
    info[kInOver] = over;
    w.lane_ticket[a] = 0;  // every block of the lane has taken its ticket
  }
  if (ntiles == 1) {  // the lane's only block scatters: no second launch
    if (tid == 0) {     // one chunk a lane, laid out back to back
      w.chunk_start[a] = a;
      if (a == 0) w.chunk_start[gridDim.y] = gridDim.y;
    }
    __syncthreads();  // s_warp of the scan above is read
    if (!over)
      scatter_rows(side ? rb : lb, (int)r0, (int64_t)a * cap_rows,
                   (int64_t)gridDim.y * cap_rows, grad, hess, mask,
                   (int64_t)lane * n, order, stats, s_warp);
  }
}

// Launch 2: block (t, a) writes the row ids of the chosen side's members
// of tile t, ascending, at the lane's offsets.
__global__ void __launch_bounds__(kTileThreads)
    scatter_kernel(const float* __restrict__ grad,
                   const float* __restrict__ hess,
                   const float* __restrict__ mask, int64_t n,
                   const int* __restrict__ step, int ntiles,
                   int64_t cap_rows, Work w, int* __restrict__ order,
                   float* __restrict__ stats) {
  __shared__ int s_warp[kTileWarps];
  const int t = blockIdx.x, a = blockIdx.y;
  if (t == 0 && a == 0) {  // every lane's chunks, laid out back to back
    const int A = gridDim.y;
    int carry = 0;
    for (int b0 = 0; b0 < A; b0 += kTileThreads) {
      const int b = b0 + threadIdx.x;
      const int v = b < A ? w.info[(int64_t)b * kInfoInts + kInChunks] : 0;
      int total;
      __syncthreads();  // s_warp of the previous pass is read
      const int before = block_exclusive_scan(v, s_warp, &total);
      if (b < A) w.chunk_start[b] = carry + before;
      carry += total;
    }
    if (threadIdx.x == 0) w.chunk_start[A] = carry;
    __syncthreads();
  }
  const int* info = w.info + (int64_t)a * kInfoInts;
  const int side = info[kInSide];
  const int64_t at = (int64_t)a * ntiles + t;
  if (info[kInOver] || w.tile_cnt[2 * at + side] == 0) return;  // uniform
  const unsigned b =
      (w.bits[at * kTileThreads + threadIdx.x] >> (8 * side)) & 0xffu;
  const int lane = step ? step[(int64_t)a * kStepInts + kSpLane] : a;
  scatter_rows(b, t * kChunk + threadIdx.x * kRowsPer,
               (int64_t)a * cap_rows + w.tile_off[at],
               (int64_t)gridDim.y * cap_rows, grad, hess, mask,
               (int64_t)lane * n, order, stats, s_warp);
}

// A lane's chosen rows for walk_chunk (hist_chunk.cuh): the bins of row
// order[p] from the feature-major [F, n] matrix, and the g, h and mask of
// sorted position p, compacted by the scatter; the walk adds the float
// products g * m and h * m, K1's staged values.
template <typename BinT>
struct LaneWalk {
  using Stat = float;
  const BinT* bins;
  int64_t n;
  const float* g;
  const float* h;
  const float* m;
  const int* order;
  __device__ int64_t row(int64_t p) const { return order[p]; }
};

// Dynamic shared memory of the histogram block: each warp's [R, 3]
// accumulator and its [3, 32] staging.
constexpr int hist_smem(int R) {
  return kHistWarps * (R * 3 + 96) * (int)sizeof(float);
}

// Launch 3: the persistent grid's warps walk items i, kHistWarps
// consecutive items a block at a time; R bins a pass.  Lane a's items
// start at F * chunk_start[a] and run (feature f, chunk k), chunks
// innermost, so the ends of the (lane, feature) pairs fall on different
// blocks.  A pair of more than one chunk is summed, once its last chunk
// is in, by the whole block whose warp walked that chunk.
template <typename BinT>
__global__ void __launch_bounds__(kHistThreads)
    lane_hist_kernel(const BinT* __restrict__ bins, int64_t n, int F,
                     int num_bins, int R, int A,
                     const int* __restrict__ order,
                     const float* __restrict__ stats, int64_t cap_rows,
                     int cap_chunks, Work w, float* __restrict__ partial,
                     float* __restrict__ out, int64_t out_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_pair[kHistWarps];
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  float* acc = reinterpret_cast<float*>(smem) + warp * (R * 3 + 96);
  float* st = acc + R * 3;
  const int64_t per_f = (int64_t)num_bins * 3, per_chunk = F * per_f;
  const int64_t all = (int64_t)A * cap_rows;
  const int64_t items = (int64_t)w.chunk_start[A] * F;
  const int64_t stride = (int64_t)gridDim.x * kHistWarps;
  for (int64_t i0 = (int64_t)blockIdx.x * kHistWarps; i0 < items;
       i0 += stride) {  // block-uniform
    const int64_t i = i0 + warp;
    int pair = -1;
    if (i < items) {  // warp-uniform
      int lo = 0, hi = A;  // the largest a with F * chunk_start[a] <= i
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if ((int64_t)w.chunk_start[mid] * F <= i) lo = mid; else hi = mid;
      }
      const int a = lo;
      const int* info = w.info + (int64_t)a * kInfoInts;
      const int rows = info[kInRows], nck = info[kInChunks];
      const int64_t j = i - (int64_t)w.chunk_start[a] * F;
      const int f = (int)(j / nck), k = (int)(j - (int64_t)f * nck);
      float* o = out + a * out_stride + f * per_f;
      if (info[kInOver] || rows == 0) {
        const float v = info[kInOver] ? NAN : 0.f;
        for (int64_t q = ln; q < per_f; q += 32) o[q] = v;
      } else {
        const int64_t off = (int64_t)a * cap_rows;
        const LaneWalk<BinT> lw{bins, n, stats + off, stats + all + off,
                                stats + 2 * all + off, order + off};
        const int left = rows - k * kChunk;
        const int cr = left < kChunk ? left : kChunk;
        // one chunk: the histogram itself (0.f + p is p)
        float* dst = nck == 1 ? o
                              : partial + ((int64_t)(a * cap_chunks + k) * F
                                           + f) * per_f;
        for (int b0 = 0; b0 < num_bins; b0 += R) {
          const int nb = num_bins - b0 < R ? num_bins - b0 : R;
          for (int q = ln; q < nb * 3; q += 32) acc[q] = 0.f;
          __syncwarp();
          walk_chunk(lw, (int64_t)k * kChunk, cr, f, b0, nb, acc, st);
          for (int q = ln; q < nb * 3; q += 32) dst[b0 * 3 + q] = acc[q];
          __syncwarp();
        }
        if (nck > 1) {
          __threadfence();  // this partial before the pair's ticket
          __syncwarp();
          int last = 0;
          if (ln == 0)
            last = atomicAdd(w.feat_ticket + (int64_t)a * F + f, 1)
                   == nck - 1;
          if (__shfl_sync(kAll, last, 0)) pair = a * F + f;
        }
      }
    }
    if (ln == 0) s_pair[warp] = pair;
    __syncthreads();
    for (int v = 0; v < kHistWarps; ++v) {  // K1's pass 2, by the block
      const int pr = s_pair[v];
      if (pr < 0) continue;  // block-uniform
      __threadfence();
      const int a = pr / F, f = pr - a * F;
      const int nck = w.info[(int64_t)a * kInfoInts + kInChunks];
      const float* p = partial + ((int64_t)a * cap_chunks * F + f) * per_f;
      float* o = out + a * out_stride + f * per_f;
      for (int64_t j = tid; j < per_f; j += kHistThreads)
        o[j] = reduce_chunks(p, nck, per_chunk, j);
      if (tid == 0) w.feat_ticket[pr] = 0;
    }
    __syncthreads();
  }
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

// (g, f) beats (bg, bf): the larger gain, the smaller feature among equal
// gains.  A feature with no valid split carries (-inf, -1), never wins.
__device__ __forceinline__ bool beats(float g, int f, float bg, int bf) {
  return g > bg || (g == bg && f < bf);
}

// After each warp of the block has written its pairs' bests (best [2, F,
// kPerFeature] of the lane): the last of the lane's gridDim.x blocks
// picks both children's winners into out [2, 16], with nleft (>= 0) in
// slot 11 of the first row.  Every thread of every block must call it.
__device__ void lane_finish(const float* const hist[2], const int* meta,
                            int F, int nb, const Scal& p, const float* best,
                            int* ticket, float* out, int nleft) {
  __shared__ int s_last;
  __shared__ float s_gain[2][kWarps];
  __shared__ int s_feat[2][kWarps];
  __threadfence();  // this block's bests and rows, before its ticket
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  if (threadIdx.x == 0) *ticket = 0;  // every block has taken its ticket
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < 2; ++c) {
    const float* bc = best + (int64_t)c * F * kPerFeature;
    float g = -INFINITY;
    int fb = -1;
    for (int f0 = threadIdx.x; f0 < F; f0 += kSearchThreads * kPickLoads) {
      float v[kPickLoads];
#pragma unroll
      for (int j = 0; j < kPickLoads; ++j) {
        const int f = f0 + j * kSearchThreads;
        v[j] = f < F ? __ldcg(bc + (int64_t)f * kPerFeature) : -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < kPickLoads; ++j) {
        if (v[j] > g) {
          g = v[j];
          fb = f0 + j * kSearchThreads;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float og = __shfl_xor_sync(kAll, g, o);
      const int of = __shfl_xor_sync(kAll, fb, o);
      if (beats(og, of, g, fb)) {
        g = og;
        fb = of;
      }
    }
    if (lane == 0) {
      s_gain[c][warp] = g;
      s_feat[c][warp] = fb;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const int c = threadIdx.x;
    float g = -INFINITY;
    int fb = -1;
    for (int k = 0; k < kWarps; ++k) {
      if (beats(s_gain[c][k], s_feat[c][k], g, fb)) {
        g = s_gain[c][k];
        fb = s_feat[c][k];
      }
    }
    winner_row(hist[c],
               best + ((int64_t)c * F + (fb >= 0 ? fb : 0)) * kPerFeature,
               fb, meta, F, nb, c, p, out + c * 16);
    if (c == 0 && nleft >= 0) out[11] = (float)nleft;
  }
}

// F3's root form: warp i of block row a scans (child i / F, feature i % F)
// of lane a, whose [F, nb, 3] histogram (at h + a * hs) is both children;
// its 12 scalars are the step buffer's.
__global__ void __launch_bounds__(kSearchThreads)
    lane_search_kernel(const float* __restrict__ h, int64_t hs,
                       const int* __restrict__ meta,
                       const int* __restrict__ step, int F, int nb,
                       float* __restrict__ best, int* tickets,
                       float* __restrict__ out) {
  const int a = blockIdx.y;
  const Scal p = lane_scal(
      reinterpret_cast<const float*>(step + (int64_t)a * kStepInts + kSpScal));
  const float* const hist[2] = {h + a * hs, h + a * hs};
  const int* ma = meta + (int64_t)a * F * 4;
  float* ba = best + (int64_t)a * 2 * F * kPerFeature;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i < 2 * F) {  // warp-uniform
    const int c = i / F;
    scan_feature_warp(hist[c], ma, i - c * F, nb, c, p,
                      ba + (int64_t)i * kPerFeature);
  }
  lane_finish(hist, ma, F, nb, p, ba, tickets + a, out + a * 32, -1);
}

// F3's step form: warps 2j and 2j + 1 of block (x, a) are the left and
// right child of feature 2x + j of active lane a; buf [B, L, F, nb, 3]
// (the lanes' leaf rows), small [A, F, nb, 3] (F1's output).  The right
// child's warp writes its row, then (after the block barrier) the left
// child's warp writes over the parent's; then each scans its own row.
__global__ void __launch_bounds__(kSearchThreads)
    lane_step_kernel(float* buf, int L, const float* __restrict__ small,
                     const int* __restrict__ meta,
                     const int* __restrict__ step, const int* info, int F,
                     int nb, float* __restrict__ best, int* tickets,
                     float* __restrict__ out) {
  const int a = blockIdx.y;
  const int* sp = step + (int64_t)a * kStepInts;
  const int lane = sp[kSpLane];
  const Scal p = lane_scal(reinterpret_cast<const float*>(sp + kSpScal));
  const int64_t cells = (int64_t)F * nb * 3;
  float* const rows[2] = {buf + ((int64_t)lane * L + sp[kSpLeaf]) * cells,
                          buf + ((int64_t)lane * L + sp[kSpNew]) * cells};
  const float* sm = small + a * cells;
  const int* ia = info + (int64_t)a * kInfoInts;
  const bool small_is_left = ia[kInSide] == 0;
  const int* ma = meta + (int64_t)lane * F * 4;
  float* ba = best + (int64_t)a * 2 * F * kPerFeature;
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int f = blockIdx.x * (kWarps / 2) + (warp >> 1), c = warp & 1;
  const int nc = nb * 3;
  const int64_t base = (int64_t)f * nc;
  const bool takes_small = (c == 0) == small_is_left;
  for (int phase = 1; phase >= 0; --phase) {  // the right child first
    if (f < F && c == phase) {  // warp-uniform
      for (int i0 = ln; i0 < nc; i0 += 32 * kStepLoads) {
        float pv[kStepLoads], sv[kStepLoads];
#pragma unroll
        for (int j = 0; j < kStepLoads; ++j) {
          const int i = i0 + 32 * j;
          pv[j] = i < nc ? rows[0][base + i] : 0.f;
          sv[j] = i < nc ? sm[base + i] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kStepLoads; ++j) {
          const int i = i0 + 32 * j;
          if (i < nc)
            rows[c][base + i] = takes_small ? sv[j] : __fsub_rn(pv[j], sv[j]);
        }
      }
    }
    if (phase) __syncthreads();  // the parent's cells are read
  }
  __syncwarp();
  if (f < F)
    scan_feature_warp(rows[c], ma, f, nb, c, p,
                      ba + ((int64_t)c * F + f) * kPerFeature);
  const float* const hist[2] = {rows[0], rows[1]};
  lane_finish(hist, ma, F, nb, p, ba, tickets + a, out + a * 32,
              ia[kInLeft]);
}

// The host's step values are in range: lanes ascending in [0, B), leaves
// below the new leaf, the new leaf (one for every lane) in [1, L) (L > 0),
// features in [0, F), parent counts in [0, n], flags 0 or 1.
bool step_in_range(const int* s, int A, int B, int L, int F, int64_t n) {
  const int nl = s[kSpNew];
  if (nl < 1 || (L > 0 && nl >= L)) return false;
  int prev = -1;
  for (int a = 0; a < A; ++a) {
    const int* r = s + (int64_t)a * kStepInts;
    if (r[kSpLane] <= prev || r[kSpLane] >= B || r[kSpLeaf] < 0
        || r[kSpLeaf] >= nl || r[kSpNew] != nl || r[kSpFeat] < 0
        || r[kSpFeat] >= F || r[kSpPcnt] < 0 || r[kSpPcnt] > n
        || (r[kSpCat] != 0 && r[kSpCat] != 1))
      return false;
    prev = r[kSpLane];
  }
  return true;
}

// The histogram kernel's shared-memory ceiling, once a process and
// device; returns its grid for R-bin accumulators (blocks an SM x SMs) or
// minus a CUDA error.
template <typename BinT>
int prepare(int dev, int R) {
  static bool set[kMaxDevices] = {false};
  if (dev < 0 || dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
  cudaError_t e = cudaSuccess;
  if (!set[dev]) {
    e = cudaFuncSetAttribute(lane_hist_kernel<BinT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             hist_smem(kWalkBins));
    if (e != cudaSuccess) return -(int)e;
    set[dev] = true;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lane_hist_kernel<BinT>, kHistThreads, hist_smem(R));
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -(int)e;
  return (per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
}

template <typename BinT>
int forest_hist(const void* bins_v, const float* grad, const float* hess,
                const float* mask, int* leaf_id, int64_t n, int F,
                int num_bins, int A, int B, const int* step,
                int cap_chunks, int grid, int* work,
                int* order, float* stats, float* partial, float* out,
                int64_t out_stride, cudaStream_t s) {
  const BinT* bins = static_cast<const BinT*>(bins_v);
  const int ntiles = (int)((n + kChunk - 1) / kChunk);
  if (A <= 0) return 0;
  if (A > B || A > 65535 || ntiles <= 0 || grid <= 0)
    return (int)cudaErrorInvalidValue;
  Work w;
  work_ints(B, ntiles, F, &w, work);
  const int64_t cap_rows = (int64_t)cap_chunks * kChunk;
  count_kernel<BinT><<<dim3(ntiles, A), kTileThreads, 0, s>>>(
      bins, leaf_id, n, ntiles, step, cap_rows, w, grad, hess, mask, order,
      stats);
  if (ntiles > 1)
    scatter_kernel<<<dim3(ntiles, A), kTileThreads, 0, s>>>(
        grad, hess, mask, n, step, ntiles, cap_rows, w, order, stats);
  const int R = num_bins < kWalkBins ? num_bins : kWalkBins;
  if (F > 0)
    lane_hist_kernel<BinT><<<grid, kHistThreads, hist_smem(R), s>>>(
        bins, n, F, num_bins, R, A, order, stats, cap_rows, cap_chunks, w,
        partial, out, out_stride);
  return (int)cudaGetLastError();
}

int forest_hist_any(const void* bins, int bin_bytes, const float* grad,
                    const float* hess, const float* mask, int* leaf_id,
                    int64_t n, int F, int num_bins, int A, int B,
                    const int* step, int cap_chunks, int grid, int* work,
                    int* order, float* stats, float* partial, float* out,
                    int64_t out_stride, cudaStream_t s) {
  if (bin_bytes == 1)
    return forest_hist<uint8_t>(bins, grad, hess, mask, leaf_id, n, F,
                                num_bins, A, B, step, cap_chunks, grid,
                                work, order, stats, partial, out, out_stride,
                                s);
  if (bin_bytes == 2)
    return forest_hist<uint16_t>(bins, grad, hess, mask, leaf_id, n, F,
                                 num_bins, A, B, step, cap_chunks, grid,
                                 work, order, stats, partial, out, out_stride,
                                 s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Rows a chunk holds (ops/histogram.py CHUNK_ROWS).
int lgbm_forest_chunk_rows() { return kChunk; }

// Ints a step uploads a lane (ops/cuda_forest.py STEP_INTS) and F1's
// results a lane (INFO_INTS, the first B * INFO_INTS ints of the work).
int lgbm_forest_step_ints() { return kStepInts; }
int lgbm_forest_info_ints() { return kInfoInts; }

// Ints of the work buffer for B lanes of n rows and F features (zeroed
// once by the caller).
int64_t lgbm_forest_work_ints(int B, int64_t n, int F) {
  return work_ints(B, (int)((n + kChunk - 1) / kChunk), F, nullptr, nullptr);
}

// `bytes` from the (pinned) host to the device on the stream.
int lgbm_forest_upload(void* dst, const void* src, int64_t bytes,
                       void* stream) {
  return (int)cudaMemcpyAsync(dst, src, (size_t)bytes,
                              cudaMemcpyHostToDevice,
                              static_cast<cudaStream_t>(stream));
}

// The histogram kernel's shared-memory ceiling for bins of bin_bytes
// bytes, set once a process and device (the current one); returns the
// histogram launch's grid for num_bins bins (blocks an SM x SMs), or
// minus a CUDA error.  Once a round (ForestStep), never a call.
int lgbm_forest_prepare(int bin_bytes, int num_bins) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (num_bins < 1) return -(int)cudaErrorInvalidValue;
  const int R = num_bins < kWalkBins ? num_bins : kWalkBins;
  if (bin_bytes == 1) return prepare<uint8_t>(dev, R);
  if (bin_bytes == 2) return prepare<uint16_t>(dev, R);
  return -(int)cudaErrorInvalidValue;
}

// F1's root form: leaf 0 of lanes 0 .. A - 1 (rows 0 .. A - 1 of the
// [B, n] tensors, B the work's lanes).  bins [F, n] (bin_bytes 1: uint8,
// 2: uint16); grad/hess/mask and leaf_id [B, n]; work:
// lgbm_forest_work_ints(B, n, F) ints; order: B *
// cap_chunks * chunk_rows ints; stats: 3 * B * cap_chunks * chunk_rows
// floats; partial: [B * cap_chunks, F, num_bins, 3] floats (read only
// where a lane has more than one chunk); out: lane a's
// [F, num_bins, 3] at out + a * out_stride; grid from
// lgbm_forest_prepare.  All pointers are device pointers; `stream` is a
// cudaStream_t.
int lgbm_forest_hist(const void* bins, int bin_bytes, const float* grad,
                     const float* hess, const float* mask, int* leaf_id,
                     int64_t n, int F, int num_bins, int A, int B,
                     int cap_chunks, int grid, int* work, int* order,
                     float* stats, float* partial, float* out,
                     int64_t out_stride, void* stream) {
  return forest_hist_any(bins, bin_bytes, grad, hess, mask, leaf_id, n, F,
                         num_bins, A, B, nullptr, cap_chunks, grid,
                         work, order, stats, partial, out, out_stride,
                         static_cast<cudaStream_t>(stream));
}

// F1's step form: checks the step's A * kStepInts ints in the host
// (pinned) `step_host` (-1, and nothing launched, when a value is out of
// range; L > 0 bounds the new leaf), copies them to the device `step_dev`
// on the stream, then partitions leaf_id in place and writes each active
// lane's smaller child's [F, num_bins, 3] at out + a * out_stride and its
// results in the work's first A * kInfoInts ints.  The rest as
// lgbm_forest_hist.
int lgbm_forest_split(const void* bins, int bin_bytes, const float* grad,
                      const float* hess, const float* mask, int* leaf_id,
                      int64_t n, int F, int num_bins, int A, int B, int L,
                      const int* step_host, int* step_dev, int cap_chunks,
                      int grid, int* work, int* order, float* stats,
                      float* partial, float* out, int64_t out_stride,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (A <= 0 || A > B) return (int)cudaErrorInvalidValue;
  if (!step_in_range(step_host, A, B, L, F, n)) return -1;
  const cudaError_t e = cudaMemcpyAsync(
      step_dev, step_host, sizeof(int) * (size_t)A * kStepInts,
      cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return (int)e;
  return forest_hist_any(bins, bin_bytes, grad, hess, mask, leaf_id, n, F,
                         num_bins, A, B, step_dev, cap_chunks, grid,
                         work, order, stats, partial, out, out_stride, s);
}

// F3's root form for B lanes: lane a's [F, nb, 3] histogram at h + a *
// hs (floats) searched as both children under meta [B, F, 4] int32 and
// its 12 scalars in step_dev (the step's uploaded values, kStepInts a
// lane); work: F1's (B lanes of n rows: its tickets); best: B * 2 * F *
// kPerFeature (8) floats of scratch; out [B, 2, 16].
int lgbm_forest_search(const float* h, int64_t hs, const int* meta,
                       const int* step_dev, int* work, int B, int64_t n,
                       int F, int nb, float* best, float* out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  Work w;
  work_ints(B, (int)((n + kChunk - 1) / kChunk), F, &w, work);
  const int blocks = F > 0 ? (2 * F + kWarps - 1) / kWarps : 1;
  lane_search_kernel<<<dim3(blocks, B), kSearchThreads, 0, s>>>(
      h, hs, meta, step_dev, F, nb, best, w.search_ticket, out);
  return (int)cudaGetLastError();
}

// F3's step form after lgbm_forest_split: buf [B, L, F, nb, 3] (the
// lanes' leaf rows), small: F1's out ([A, F, nb, 3]), meta [B, F, 4],
// step_dev the step's uploaded values, work F1's (B lanes of n rows);
// best and out as lgbm_forest_search.
int lgbm_forest_search_step(float* buf, int L, const float* small,
                            const int* meta, const int* step_dev, int* work,
                            int A, int B, int64_t n, int F, int nb,
                            float* best, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (A <= 0) return 0;
  if (A > B || A > 65535) return (int)cudaErrorInvalidValue;
  Work w;
  work_ints(B, (int)((n + kChunk - 1) / kChunk), F, &w, work);
  const int blocks = F > 0 ? (2 * F + kWarps - 1) / kWarps : 1;
  lane_step_kernel<<<dim3(blocks, A), kSearchThreads, 0, s>>>(
      buf, L, small, meta, step_dev, w.info, F, nb, best, w.search_ticket,
      out);
  return (int)cudaGetLastError();
}

}  // extern "C"
