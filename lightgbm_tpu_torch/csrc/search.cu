// Kernel 3: best split of both children of a split, one launch; kernel 4,
// the same search fused with the histogram-buffer update; and kernel 5, the
// pooled form of kernel 4.
//
// K3 replaces the TPU kernel lightgbm_tpu/ops/pallas_search.py
// _search2_kernel (pallas_call at :264, reached through search2_pallas
// :220, per-child body _child_search :85-172).  Same contract: the two
// children's [F, B, 3] f32 histograms, their totals, `can`, per-feature
// (feature_mask, num_bins, is_categorical) and the five constraints in;
// the [2, 16] f32 rows of pallas_search._unpack out:
//   (gain, feature, threshold, lg, lh, lc, rg, rh, rc, left_out, right_out,
//    0, 0, 0, 0, 0).
// K4 replaces the TPU kernel pallas_search.py _fused_kernel (pallas_call at
// :409, reached through search2_update_pallas :360): from the [L, F, B, 3]
// buffer's parent row and the smaller child's histogram it forms the larger
// child as parent - small (elementwise f32), routes the two to left and
// right by small_is_left, writes them to rows `parent` (left) and
// `new_leaf` (right) in place, and searches both with K3's device
// functions, so the two searches cannot drift apart.
// K5 replaces the TPU kernel pallas_search.py _search2_kernel_raw
// (pallas_call at :455, reached through search2_pallas_raw :423, body
// :200-216): K3's two-child search on the TPU's padded raw layout [2, Fp,
// 4, Bp], which only the pooled leaf-wise route reaches
// (learners/serial.py:444-456 with 0 < hist_pool < num_leaves).  On the
// port's [F, B, 3] layout a search-only K5 would be K3 under another name
// (K3 already reads two rows in place), so K5 takes in the XLA work the TPU
// route puts around its search: the subtraction parent - small, the routing
// by small_is_left and the two slot writes (serial.py:986-1008).  It is K4
// over a histogram pool [P, F, B, 3]: the left child goes to slot s1 and
// the right to slot s2, and the parent comes from a pool slot (resident;
// then s1 is that slot and the left child overwrites it in place) or from
// a separate [F, B, 3] tensor (an evicted parent, recomputed).
// The search, its semantics and its float order, and the buffer update
// live in search_step.cuh, shared with K8 (split_step.cu).
//
// Bound on the H100: memory.  K3 reads 2*F*B*12 bytes (171,360 B at F=28,
// B=255: 0.051 us at 3.35 TB/s; 12.3 MB at F=2000, B=256: 3.7 us) and
// writes 128; K4 and K5 read two rows and write two: 4*F*B*12 bytes
// (342,720 B at F=28, B=255, 0.102 us; 24.6 MB at F=2000, B=256, 7.3 us).
// The ~30 flops a (child, feature, bin) are far below the f32 peak.  What
// sets the time is latency: one (child, feature)'s dependent chain of
// adds, two divisions a bin and the argmax, then the winner.
//
// Design: one warp per (child, feature) over as many blocks as the
// features need (kWarps warps a block; K3's grid ceil(2F / kWarps), K4's
// and K5's ceil(F / kWarps)), each scanning with scan_feature_warp
// (search_step.cuh), which K8 shares.  K4 and K5: the warp that owns
// feature f does f's whole step: it reads f's cells of the parent and of
// the smaller child (kStepLoads a lane before it stores any), writes both
// children's cells for f, __syncwarp()s, and scans both children of f.
// The cells of f are read and written by that warp alone, each cell by
// one lane that reads it before it writes it, so the left child may
// overwrite the parent in place (K4 always, K5 with the parent resident)
// with no ordering between blocks: no grid barrier and no cooperative
// launch.  The TPU kernel orders the same in-place update with two
// sequential grid steps and a VMEM stash (pallas_search.py:302-356).
// The winner, in the same launch: each warp writes its pair's best
// (kPerFeature floats) to a global scratch [2, F, kPerFeature]; each
// block then __threadfence()s and takes a ticket from an atomicAdd
// counter, and the last block to finish resets the counter to 0 (so the
// next launch on the stream starts clean) and picks both children's
// winners: a parallel argmax over the features, the largest gain and the
// smallest feature among equal gains, which only compares, so any
// reduction order gives the serial pick's answer; winner_row writes the
// rows.  With the third key, the largest threshold within a feature
// (scan_feature_warp), this is the three-key lexicographic argmax of the
// plain version (ops/split.py), and the rows are bitwise its rows.
// The kernels run on the caller's stream and allocate nothing: the
// wrapper (ops/cuda_search.py) allocates the scratch and the counter once
// per device (zeroed, grown with F) and passes them to every launch; so
// one stream at a time may search on a device.  No shared-memory table
// bounds F: a large F fails only where memory runs out.  Each C entry
// returns cudaGetLastError().
// Why CUDA and not Triton: the scan reproduces a fixed serial float order
// with lane shuffles and a warp-uniform carry across segments, and the
// winner needs a fenced last-block ticket; neither fits Triton's block
// model, where the order of a scan or a reduction is the compiler's.
//
// K3-f64 is the two-child search for hist_dtype=float64 in double
// (double histograms, totals, constraints and [2, 16] rows), in two forms:
// the root form lgbm_search2_f64 (K3's contract) and the step form
// lgbm_search2_update_f64 / lgbm_search2_pool_f64 (K4's and K5's contract:
// large = parent - small by __dsub_rn, both children written in place,
// both searched), which replaces the float64 routes' PyTorch subtraction,
// two row copies and search with one launch.  It replaces no pallas_call:
// search2_pallas refuses float64 (pallas_search.py:235-238) and the JAX
// package subtracts and searches with jnp (lightgbm_tpu/ops/split.py:69
// find_best_split, :171 find_best_split_leaves, learners/serial.py:
// 457-468) on the order route, the pooled route and hybrid's resume.  Its
// plain versions are ops/split.py search2_rows / search2_update /
// search2_pool on float64 tensors, bitwise.  Bound: the root form reads
// 2*F*B*24 bytes (342,720 B at F = 28, B = 255: 0.10 us at 3.35 TB/s),
// the step form reads and writes 4*F*B*24 (685,440 B, 0.20 us); the work
// is ~45 double operations a (child, feature, bin), two of them
// divisions, ~0.64M at F = 28 (0.02 us at 34 TFLOP/s): like K3 it is
// bound by latency, a dependent chain of adds a (child, feature), then
// the pick.
// Design below the size switch (ops/cuda_search.search64_config: B <= 256
// and F at most the switch): the whole call is one thread-block cluster
// (search2_cluster_kernel) of C <= 8 blocks of W <= 7 warps, a warp a
// (child, feature) pair in turn.  A warp loads its pair's cells with
// coalesced loads, all in flight at once, into shared memory (a row of
// kRowPad doubles a block of 16 bins, so the lanes that own blocks hit
// distinct banks); in the step form the larger child's warp writes both
// children's cells to the buffer and its child to shared memory from the
// same registers, so nothing is read twice.  The serial adds of
// blocked_cumsum stay in the lane that owns each block of 16 and leave
// their prefixes and offsets in shared memory; then all 32 lanes take
// the bins for the gains (two IEEE divisions each) and the validity, and
// a butterfly picks (gain, bin); the divisions are skipped where the
// counts or hessians already rule a bin out.  Each warp keeps its best of
// each child in shared memory, each block writes its best of each child
// into block 0's shared memory (distributed shared memory), and block 0
// picks the winners after one cluster barrier: no global scratch, fence,
// ticket or L2 round trip.  Its shared memory is static
// (47,784 bytes), as a dynamic array would change the shared memory of
// the float32 kernels of this file.  Above the switch (wide F, or B >
// 256, whose cells do not fit) the ticketed grid: search2_kernel<double>
// and search2_step_kernel<double>, K3's and K4/K5's code in double
// (search_step.cuh with T = double).  Both branches add in one order and
// compute one argmax, so the switch changes no bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "search_step.cuh"

namespace {

using namespace lgbm;

constexpr int kWarps = 4;  // warps a block: one (child, feature) each
constexpr int kThreads = kWarps * 32;
constexpr int kStepLoads = 8;  // cells a lane loads before it stores
constexpr int kPickLoads = 8;  // bests a thread loads before it compares
constexpr unsigned kAll = 0xffffffffu;

// Blocks for `warps` warps (at least one, so the winner is written).
int grid_for(int warps) {
  const int g = (warps + kWarps - 1) / kWarps;
  return g > 0 ? g : 1;
}

// (g, f) beats (bg, bf): the larger gain, the smaller feature among equal
// gains.  A feature with no valid split carries (-inf, -1) and never wins.
template <typename T>
__device__ __forceinline__ bool beats(T g, int f, T bg, int bf) {
  return g > bg || (g == bg && f < bf);
}

// After each warp of the block has written its pairs' bests: the last
// block of the grid to get here picks both children's winners into out
// [2, 16].  hist[c] is child c's [F, B, 3] row.  Every thread of every
// block must call it.
template <typename T>
__device__ void finish_search(const T* const hist[2], const int* meta, int F,
                              int B, const ScalT<T>& p, const T* best,
                              int* ticket, T* out) {
  __shared__ int s_last;
  __shared__ T s_gain[2][kWarps];
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
    const T* bc = best + (int64_t)c * F * kPerFeature;
    T g = -INFINITY;
    int fb = -1;
    // each thread walks its features in ascending order with a strict ">"
    for (int f0 = threadIdx.x; f0 < F; f0 += kThreads * kPickLoads) {
      T v[kPickLoads];
#pragma unroll
      for (int j = 0; j < kPickLoads; ++j) {
        const int f = f0 + j * kThreads;
        v[j] = f < F ? __ldcg(bc + (int64_t)f * kPerFeature) : -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < kPickLoads; ++j) {
        if (v[j] > g) {
          g = v[j];
          fb = f0 + j * kThreads;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const T og = __shfl_xor_sync(kAll, g, o);
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
    T g = -INFINITY;
    int fb = -1;
    for (int w = 0; w < kWarps; ++w) {
      if (beats(s_gain[c][w], s_feat[c][w], g, fb)) {
        g = s_gain[c][w];
        fb = s_feat[c][w];
      }
    }
    winner_row(hist[c],
               best + ((int64_t)c * F + (fb >= 0 ? fb : 0)) * kPerFeature,
               fb, meta, F, B, c, p, out + c * 16);
  }
}

// Kernel 3 (T = float) and K3-f64 (T = double): warp i of the grid scans
// (child i / F, feature i % F).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    search2_kernel(const T* __restrict__ hist_l,  // [F, B, 3]
                   const T* __restrict__ hist_r,
                   const int* __restrict__ meta,  // [F, 4]
                   int F, int B, ScalT<T> p,
                   T* __restrict__ best,  // [2, F, kPerFeature]
                   int* ticket, T* __restrict__ out) {  // [2, 16]
  const T* const hist[2] = {hist_l, hist_r};
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i < 2 * F) {
    const int c = i / F;
    scan_feature_warp(hist[c], meta, i - c * F, B, c, p,
                      best + (int64_t)i * kPerFeature);
  }
  finish_search(hist, meta, F, B, p, best, ticket, out);
}

// Kernels 4 and 5: warp f of the grid does feature f's step over a buffer
// of [F, B, 3] rows (K4: the [L, F, B, 3] leaf buffer, the children in
// rows `parent` and `new_leaf`; K5: the [P, F, B, 3] pool, the children
// in slots s1 and s2).  `parent` points at the parent's values: row s1
// itself (K4, and K5 with the parent resident) or a separate row (K5 with
// the parent rebuilt); s2 is neither.  Lane l owns f's cells l, l+32, ...:
// it loads kStepLoads of them from the parent and the smaller child, then
// stores both children there (store_children), so each cell is read
// before it is written and by its owner only.  __syncwarp() makes the
// warp's finished cells visible to its lanes, which then scan both
// children of f.
// T = float is K4/K5; T = double is K3-f64's step form above the size
// switch (lgbm_search2_pool_f64 with cluster = 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    search2_step_kernel(T* buf, const T* __restrict__ small,
                        const T* parent, int s1, int s2,
                        int small_is_left, const int* __restrict__ meta,
                        int F, int B, ScalT<T> p,
                        T* __restrict__ best,  // [2, F, kPerFeature]
                        int* ticket, T* __restrict__ out) {  // [2, 16]
  const int64_t cells = (int64_t)F * B * 3;
  T* const rows[2] = {buf + (int64_t)s1 * cells, buf + (int64_t)s2 * cells};
  const int f = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (f < F) {
    const int lane = threadIdx.x & 31, n = B * 3;
    const int64_t base = (int64_t)f * n;
    for (int i0 = lane; i0 < n; i0 += 32 * kStepLoads) {
      T pv[kStepLoads], sv[kStepLoads];
#pragma unroll
      for (int j = 0; j < kStepLoads; ++j) {
        const int i = i0 + 32 * j;
        pv[j] = i < n ? parent[base + i] : T(0);
        sv[j] = i < n ? small[base + i] : T(0);
      }
#pragma unroll
      for (int j = 0; j < kStepLoads; ++j) {
        const int i = i0 + 32 * j;
        if (i < n) store_children(rows, base + i, pv[j], sv[j], small_is_left);
      }
    }
    __syncwarp();
    for (int c = 0; c < 2; ++c)
      scan_feature_warp(rows[c], meta, f, B, c, p,
                        best + ((int64_t)c * F + f) * kPerFeature);
  }
  const T* const hist[2] = {rows[0], rows[1]};
  finish_search(hist, meta, F, B, p, best, ticket, out);
}

// ---------------------------------------------------------------------
// K3-f64 below the size switch: the whole call in one thread-block
// cluster (hist_dtype=float64 only; T = double).  See the design note at
// the top of the file.

constexpr int kRowPad = kScanBlock * 3 + 3;  // a block's cells, then E_q
constexpr int kClusterBins = kScanBlock * kScanBlock;  // 16 blocks of 16
constexpr int kClusterWarps = 7;  // most warps a block
constexpr int kMaxCluster = 8;    // most blocks a (portable) cluster
constexpr int kClusterLoads = 24;  // cells a lane loads before it stores

// Cell i (= bin t * 3 + channel k) of a feature in a warp's scratch:
// reversed bin j = B-1-t, block j / 16, place j % 16.  A block's row is
// kRowPad (51) doubles, its 48 cells then its offset E_q: lane q's row
// starts 102 words after lane q-1's, so pass 1's 16 lanes hit 32 banks.
__device__ __forceinline__ int smem_cell(int i, int B) {
  const int t = i / 3, k = i - 3 * t, j = B - 1 - t;
  return (j >> 4) * kRowPad + (j & (kScanBlock - 1)) * 3 + k;
}

// Child c's best split on one feature from its cells x (the warp's
// scratch, loaded and __syncwarp()ed), by one warp (every lane calls):
// lane 0 gets (gain, bin, lg, lh, lc, rg, rh, rc) in res, gain -inf and
// bin -1 when no bin is valid.  scan_feature_warp's floats, in its order,
// for B <= 256 (one segment of at most 16 blocks):
//  * a numerical feature: lane q sums block q of the reversed bins in
//    order from 0 (pass 1), each within-block prefix replacing its cell,
//    and keeps its block's offset E_q (the totals of blocks 0..q-1 summed
//    in order from 0) after the block's cells.  A categorical feature
//    needs no tails;
//  * then all 32 lanes take bins j = lane, lane + 32, ...: the exclusive
//    tail of bin j is the prefix before it plus E_q, or, at a block's
//    first place, the last prefix of the block before plus its offset (0
//    in block 0); then the stats, both gains (the two divisions) and the
//    validity, each lane keeping its best with a strict ">" from high bin
//    to low;
//  * the butterfly over (gain, bin) keeps the largest gain and among
//    equal gains the largest bin, whichever lane holds which bin.
template <typename T>
__device__ inline void scan_cells_warp(T* x, int B, bool fmask, int nb,
                                       bool iscat, const ScalT<T>& p, int c,
                                       T* res) {
  constexpr int kE = kScanBlock * 3;  // E_q's place in block q's row
  const int lane = threadIdx.x & 31;
  const int n1 = (B + kScanBlock - 1) / kScanBlock;
  const bool blocked0 = B > kScanBlock;
  const bool can = p.can[c] > T(0);
  const T sg = p.sg[c], sh = p.sh[c], cnt = p.cnt[c];
  const T min_gain_shift = add_rn(leaf_gain(sg, sh, p.l1, p.l2), p.min_gain);
  if (!iscat) {
    const int q = lane;
    const int len = q < n1 ? min(kScanBlock, B - q * kScanBlock) : 0;
    T* const xb = x + q * kRowPad;
    T Tq[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int i = 0; i < kScanBlock; ++i) {
      if (i < len) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          Tq[k] = add_rn(Tq[k], xb[i * 3 + k]);
          xb[i * 3 + k] = Tq[k];
        }
      }
    }
    if (blocked0) {  // E_q = T_0 + ... + T_{q-1} from 0
      T Eq[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int r = 0; r < kScanBlock - 1; ++r) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const T v = __shfl_sync(kAll, Tq[k], r);
          if (r < lane) Eq[k] = add_rn(Eq[k], v);
        }
      }
      if (q < n1) {
        for (int k = 0; k < 3; ++k) xb[kE + k] = Eq[k];
      }
    }
    __syncwarp();
  }
  T best = -INFINITY;
  int best_bin = -1;
  T st[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 1  // one bin at a time: 2 or 4 at once measured slower
  for (int j = lane; j < B; j += 32) {
    const int q = j >> 4, i = j & (kScanBlock - 1), t = B - 1 - j;
    const T* const xc = x + q * kRowPad + i * 3;
    T lg, lh, lc, rg, rh, rc;
    if (iscat) {
      const T hg = xc[0], hh = xc[1], hc = xc[2];
      lg = hg; lh = hh; lc = hc;
      rg = sub_rn(sg, hg); rh = sub_rn(sh, hh); rc = sub_rn(cnt, hc);
    } else {
      T tail[3] = {T(0), T(0), T(0)};
      if (i || q) {  // the prefix before j, and its block's row for E
        const T* const prev = i ? xc - 3 : xc - kRowPad + kE - 3;
        const T* const row = i ? xc - i * 3 : xc - kRowPad;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          tail[k] = blocked0 ? add_rn(prev[k], row[kE + k]) : prev[k];
      }
      const T th_eps = add_rn(tail[1], epsilon_of(T(0)));
      rg = tail[0]; rh = th_eps; rc = tail[2];
      lg = sub_rn(sg, tail[0]); lh = sub_rn(sh, th_eps);
      lc = sub_rn(cnt, tail[2]);
    }
    const bool in_range = fmask && (iscat ? (t < nb) : (t < nb - 1));
    // the gain (two divisions) only where the rest of the validity holds
    if (in_range && can && lc >= p.min_data && rc >= p.min_data &&
        lh >= p.min_hess && rh >= p.min_hess) {
      const T gain = add_rn(leaf_gain(lg, lh, p.l1, p.l2),
                            leaf_gain(rg, rh, p.l1, p.l2));
      if (gain >= min_gain_shift && gain > best) {
        best = gain;
        best_bin = t;
        st[0] = lg; st[1] = lh; st[2] = lc;
        st[3] = rg; st[4] = rh; st[5] = rc;
      }
    }
  }
  T g = best;
  int b = best_bin;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T og = __shfl_xor_sync(kAll, g, o);
    const int ob = __shfl_xor_sync(kAll, b, o);
    if (og > g || (og == g && ob > b)) {
      g = og;
      b = ob;
    }
  }
  const unsigned own = __ballot_sync(kAll, b >= 0 && best_bin == b);
  const int src = own ? __ffs(own) - 1 : 0;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T v = __shfl_sync(kAll, st[k], src);
    if (lane == 0) res[2 + k] = own ? v : T(0);
  }
  if (lane == 0) {
    res[0] = g;
    res[1] = (T)b;
  }
}

// winner_row from values: the winner's best sb [kPerFeature] (fbest >= 0)
// and child c's cells h0 at (feature 0, bin B-1) for the no-split row.
template <typename T>
__device__ inline void winner_row_of(const T* sb, int fbest, const T* h0,
                                     const int* meta, int F, int c,
                                     const ScalT<T>& p, T* out) {
  const T sg = p.sg[c], sh = p.sh[c], cnt = p.cnt[c];
  const T eps = epsilon_of(T(0));
  T row[16];
  for (int k = 0; k < 16; ++k) row[k] = T(0);
  T st[6];
  if (fbest >= 0) {
    row[0] = sub_rn(sb[0], leaf_gain(sg, sh, p.l1, p.l2));
    row[1] = (T)fbest;
    row[2] = sb[1];
    for (int k = 0; k < 6; ++k) st[k] = sb[2 + k];
  } else {
    row[0] = -INFINITY;
    row[1] = T(-1);
    row[2] = T(0);
    if (F > 0 && meta[2] > 0) {
      st[0] = h0[0]; st[1] = h0[1]; st[2] = h0[2];
      st[3] = sub_rn(sg, h0[0]); st[4] = sub_rn(sh, h0[1]);
      st[5] = sub_rn(cnt, h0[2]);
    } else {
      st[0] = sg; st[1] = sub_rn(sh, eps); st[2] = cnt;
      st[3] = T(0); st[4] = eps; st[5] = T(0);
    }
  }
  for (int k = 0; k < 6; ++k) row[3 + k] = st[k];
  row[9] = leaf_out(st[0], st[1], p.l1, p.l2);
  row[10] = leaf_out(st[3], st[4], p.l1, p.l2);
  for (int k = 0; k < 16; ++k) out[k] = row[k];
}

// The lanes' best (g, f) by beats, every lane left with it and with the
// `src` of the lane that held it.
template <typename T>
__device__ __forceinline__ void argmax_lanes(T& g, int& f, int& src) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T og = __shfl_xor_sync(kAll, g, o);
    const int of = __shfl_xor_sync(kAll, f, o);
    const int os = __shfl_xor_sync(kAll, src, o);
    if (beats(og, of, g, f)) {
      g = og;
      f = of;
      src = os;
    }
  }
}

// K3-f64 (root form: hist_l, hist_r given, buf null) and its step form
// (buf the [L, F, B, 3] buffer or [P, F, B, 3] pool, the children to rows
// s1 and s2 from `small` and `parent`), in one cluster of C blocks of W
// warps.  Warp g of the cluster (block rank * W + warp) takes the pairs
// (child, feature) = g, g + C*W, ... of the 2F (child c = pair / F), in
// ascending order.  It stages the pair's cells in its scratch with
// coalesced loads; in the step form the warp of the LARGER child's pair
// reads the parent's and the smaller child's cells, writes both children
// to the buffer (store_children's routing, each cell read before it is
// written, by one lane) and stages parent - small, while the smaller
// child's warp stages `small` only: only that one warp reads a parent
// cell, so the left child may overwrite the parent in place.  It scans
// (scan_cells_warp) and keeps, per child, the first feature of the
// largest gain in its record.  Then each block's warps 0 and 1 (warp 0
// alone for both when W = 1) take the block's best of child 0 and child 1
// over its warps and write it into block 0's shared memory (distributed
// shared memory: every block arrived at a cluster barrier when it
// started and waits on it before that write), with the cells at (feature
// 0, bin B-1) the no-split row needs; after one cluster.sync() block 0
// picks each child's winner over the blocks from its own shared memory
// (the largest gain, then the smallest feature: the order-free argmax of
// finish_search) and writes the rows.
template <typename T>
__global__ void __launch_bounds__(kClusterWarps * 32)
    search2_cluster_kernel(const T* __restrict__ hist_l,
                           const T* __restrict__ hist_r, T* buf,
                           const T* __restrict__ small, const T* parent,
                           int s1, int s2, int small_is_left,
                           const int* __restrict__ meta, int F, int B,
                           ScalT<T> p, T* __restrict__ out) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int rank = (int)cluster.block_rank();
  const int G = (int)cluster.num_blocks() * W;
  // static shared memory (47,784 bytes): a dynamic array would move the
  // float kernels' shared memory in this file
  __shared__ T s_x[kClusterWarps][kScanBlock * kRowPad];  // warp scratch
  __shared__ T s_rec[kClusterWarps * 2 * kPerFeature];  // [W][2][8]
  __shared__ T s_h0[6];                                 // [2][3]
  __shared__ int s_feat[kClusterWarps * 2];             // [W][2]
  __shared__ T s_top[kMaxCluster * 2 * kPerFeature];  // block 0: [C][2][8]
  __shared__ int s_top_feat[kMaxCluster * 2];         // block 0: [C][2]
  T* const x = s_x[warp];
  // every block of the cluster has started before one writes another's
  // shared memory: arrive now, wait before the first such write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  if (lane < 2) {
    s_rec[(warp * 2 + lane) * kPerFeature] = -INFINITY;
    s_feat[warp * 2 + lane] = -1;
  }
  const int n = B * 3;
  const int64_t cells = (int64_t)F * n;
  const int large = small_is_left ? 1 : 0;
  T* rows[2] = {nullptr, nullptr};
  if (buf) {
    rows[0] = buf + (int64_t)s1 * cells;
    rows[1] = buf + (int64_t)s2 * cells;
  }
  for (int pair = rank * W + warp; pair < 2 * F; pair += G) {
    const int c = pair >= F, f = pair - c * F;
    const int64_t base = (int64_t)f * n;
    __syncwarp();  // the previous pair's reads of x are done
    if (buf && c == large) {
      for (int i0 = lane; i0 < n; i0 += 32 * kClusterLoads) {
        T pv[kClusterLoads], sv[kClusterLoads];
#pragma unroll
        for (int j = 0; j < kClusterLoads; ++j) {
          const int i = i0 + 32 * j;
          pv[j] = i < n ? parent[base + i] : T(0);
          sv[j] = i < n ? small[base + i] : T(0);
        }
#pragma unroll
        for (int j = 0; j < kClusterLoads; ++j) {
          const int i = i0 + 32 * j;
          if (i < n) {
            store_children(rows, base + i, pv[j], sv[j], small_is_left);
            x[smem_cell(i, B)] = sub_rn(pv[j], sv[j]);
          }
        }
      }
    } else {
      const T* const src = (buf ? small : (c ? hist_r : hist_l)) + base;
      for (int i0 = lane; i0 < n; i0 += 32 * kClusterLoads) {
        T v[kClusterLoads];
#pragma unroll
        for (int j = 0; j < kClusterLoads; ++j) {
          const int i = i0 + 32 * j;
          v[j] = i < n ? src[i] : T(0);
        }
#pragma unroll
        for (int j = 0; j < kClusterLoads; ++j) {
          const int i = i0 + 32 * j;
          if (i < n) x[smem_cell(i, B)] = v[j];
        }
      }
    }
    __syncwarp();
    if (f == 0 && lane == 0) {  // bin B-1, before pass 1 overwrites it
      for (int k = 0; k < 3; ++k) s_h0[c * 3 + k] = x[k];
    }
    const int* const mf = meta + f * 4;
    T res[kPerFeature];
    scan_cells_warp(x, B, mf[0] > 0, mf[1], mf[2] > 0, p, c, res);
    T* const rec = s_rec + (warp * 2 + c) * kPerFeature;
    if (lane == 0 && res[0] > rec[0]) {  // features ascend: the first wins
      for (int k = 0; k < kPerFeature; ++k) rec[k] = res[k];
      s_feat[warp * 2 + c] = f;
    }
  }
  // each block's best of each child over its warps, pushed to block 0
  __syncthreads();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int c = warp; c < 2; c += W) {
    T g = -INFINITY;
    int fb = -1, src = 0;
    if (lane < W) {
      g = s_rec[(lane * 2 + c) * kPerFeature];
      fb = s_feat[lane * 2 + c];
      src = lane;
    }
    argmax_lanes(g, fb, src);
    T* const top = cluster.map_shared_rank(s_top, 0) +
                   (rank * 2 + c) * kPerFeature;
    if (lane < kPerFeature) top[lane] = s_rec[(src * 2 + c) * kPerFeature +
                                              lane];
    if (lane == 0) cluster.map_shared_rank(s_top_feat, 0)[rank * 2 + c] = fb;
    // the cells at (feature 0, bin B-1), from the block that scanned them
    if (F > 0 && lane < 3 && rank == (c * F) % G / W)
      cluster.map_shared_rank(s_h0, 0)[c * 3 + lane] = s_h0[c * 3 + lane];
  }
  cluster.sync();  // every push done; block 0 picks from its own memory
  if (rank != 0) return;
  const int C = (int)cluster.num_blocks();
  for (int c = warp; c < 2; c += W) {
    T g = -INFINITY;
    int fb = -1, src = 0;
    if (lane < C) {
      g = s_top[(lane * 2 + c) * kPerFeature];
      fb = s_top_feat[lane * 2 + c];
      src = lane;
    }
    argmax_lanes(g, fb, src);
    if (lane == 0)
      winner_row_of(s_top + (src * 2 + c) * kPerFeature, fb, s_h0 + c * 3,
                    meta, F, c, p, out + c * 16);
  }
}

// One cluster of `cluster` blocks of `warps` warps (1-8 and 1-7, B <=
// kClusterBins).
int cluster_launch(const double* hist_l, const double* hist_r, double* buf,
                   const double* small, const double* parent, int s1, int s2,
                   int small_is_left, const int* meta, int F, int B,
                   const ScalT<double>& p, int cluster, int warps,
                   double* out, cudaStream_t stream) {
  if (B < 1 || B > kClusterBins || cluster < 1 || cluster > kMaxCluster ||
      warps < 1 || warps > kClusterWarps)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(warps * 32);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, search2_cluster_kernel<double>, hist_l, hist_r, buf, small,
      parent, s1, s2, small_is_left, meta, F, B, p, out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The 12 host values (can, lsg, lsh, lc, rsg, rsh, rc, min_data, min_hess,
// l1, l2, min_gain) as the kernels' constants.
ScalT<double> scal_of(const double* s) {
  return make_scal(s[0], s[1], s[2], s[3], s[0], s[4], s[5], s[6], s[7],
                   s[8], s[9], s[10], s[11]);
}

}  // namespace

extern "C" {

// best holds at least 2 * F * kPerFeature floats and ticket one int that
// is 0 between launches (every launch leaves it 0).  All pointers are
// device pointers; `stream` is a cudaStream_t.
int lgbm_search2(const float* hist_l, const float* hist_r, const int* meta,
                 int F, int B, float can_l, float lsg, float lsh, float lc,
                 float can_r, float rsg, float rsh, float rc, float min_data,
                 float min_hess, float l1, float l2, float min_gain,
                 float* best, int* ticket, float* out, void* stream) {
  const Scal p = make_scal(can_l, lsg, lsh, lc, can_r, rsg, rsh, rc, min_data,
                           min_hess, l1, l2, min_gain);
  search2_kernel<float><<<grid_for(2 * F), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      hist_l, hist_r, meta, F, B, p, best, ticket, out);
  return (int)cudaGetLastError();
}

// K3-f64's root form: lgbm_search2 over double histograms; `scal` holds
// the 12 values of scal_of in host memory, out [2, 16] double.  cluster >
// 0 launches one cluster of `cluster` blocks of `warps` warps (B <= 256);
// cluster = 0 the ticketed grid, with best (at least 2 * F * kPerFeature
// doubles) and ticket as for lgbm_search2.
int lgbm_search2_f64(const double* hist_l, const double* hist_r,
                     const int* meta, int F, int B, const double* scal,
                     int cluster, int warps, double* best, int* ticket,
                     double* out, void* stream) {
  const ScalT<double> p = scal_of(scal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0)
    return cluster_launch(hist_l, hist_r, nullptr, nullptr, nullptr, 0, 0,
                          0, meta, F, B, p, cluster, warps, out, st);
  search2_kernel<double><<<grid_for(2 * F), kThreads, 0, st>>>(
      hist_l, hist_r, meta, F, B, p, best, ticket, out);
  return (int)cudaGetLastError();
}

// K3-f64's step form over a pool [P, F, B, 3] (lgbm_search2_pool's
// contract in double: large = parent - small by __dsub_rn); scal, cluster,
// warps, best and ticket as for lgbm_search2_f64.
int lgbm_search2_pool_f64(double* pool, const double* small,
                          const double* parent, int s1, int s2,
                          int small_is_left, const int* meta, int F, int B,
                          const double* scal, int cluster, int warps,
                          double* best, int* ticket, double* out,
                          void* stream) {
  const ScalT<double> p = scal_of(scal);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0)
    return cluster_launch(nullptr, nullptr, pool, small, parent, s1, s2,
                          small_is_left, meta, F, B, p, cluster, warps, out,
                          st);
  search2_step_kernel<double><<<grid_for(F), kThreads, 0, st>>>(
      pool, small, parent, s1, s2, small_is_left, meta, F, B, p, best,
      ticket, out);
  return (int)cudaGetLastError();
}

// K3-f64's step form over the leaf buffer hists [L, F, B, 3]
// (lgbm_search2_update's contract in double).
int lgbm_search2_update_f64(double* hists, const double* small, int parent,
                            int new_leaf, int small_is_left, const int* meta,
                            int F, int B, const double* scal, int cluster,
                            int warps, double* best, int* ticket, double* out,
                            void* stream) {
  return lgbm_search2_pool_f64(hists, small,
                               hists + (int64_t)parent * F * B * 3, parent,
                               new_leaf, small_is_left, meta, F, B, scal,
                               cluster, warps, best, ticket, out, stream);
}

// pool [P, F, B, 3]: slots s1 and s2 become the left and right children
// (small and parent - small, routed by small_is_left); `parent` points at
// the parent's [F, B, 3] values, a pool slot (then s1) or a separate row.
// best and ticket as for lgbm_search2.
int lgbm_search2_pool(float* pool, const float* small, const float* parent,
                      int s1, int s2, int small_is_left, const int* meta,
                      int F, int B, float can, float lsg, float lsh, float lc,
                      float rsg, float rsh, float rc, float min_data,
                      float min_hess, float l1, float l2, float min_gain,
                      float* best, int* ticket, float* out, void* stream) {
  const Scal p = make_scal(can, lsg, lsh, lc, can, rsg, rsh, rc, min_data,
                           min_hess, l1, l2, min_gain);
  search2_step_kernel<float><<<grid_for(F), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      pool, small, parent, s1, s2, small_is_left, meta, F, B, p, best,
      ticket, out);
  return (int)cudaGetLastError();
}

// hists [L, F, B, 3]: rows `parent` and `new_leaf` become the left and
// right children (small and parent - small, routed by small_is_left).
int lgbm_search2_update(float* hists, const float* small, int parent,
                        int new_leaf, int small_is_left, const int* meta,
                        int F, int B, float can, float lsg, float lsh,
                        float lc, float rsg, float rsh, float rc,
                        float min_data, float min_hess, float l1, float l2,
                        float min_gain, float* best, int* ticket, float* out,
                        void* stream) {
  return lgbm_search2_pool(hists, small,
                           hists + (int64_t)parent * F * B * 3, parent,
                           new_leaf, small_is_left, meta, F, B, can, lsg, lsh,
                           lc, rsg, rsh, rc, min_data, min_hess, l1, l2,
                           min_gain, best, ticket, out, stream);
}

}  // extern "C"
