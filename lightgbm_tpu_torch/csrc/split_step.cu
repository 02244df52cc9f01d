// Kernel 8: the whole split step of the mega route in one launch: the go
// flags, the stable compaction of the parent's window, the left child's
// histogram, the subtraction, both buffer rows and both children's
// searches.
//
// K8 replaces the TPU kernel lightgbm_tpu/ops/record.py _split_step_kernel
// (:683; pallas_call at :1112, reached through split_step_window :994 with
// return_comp=True, from learners/serial.py:774-816).  Same contract: over
// the parent's window [begin, begin+pcnt) of the [W, ld] int32 record
// (ops/record.py) each column's go flag comes from the split feature's
// packed word (_tile_go :214); the window's columns are compacted per tile
// into comp [nt, W-1, 2*kTile] with counts [2, nt] = (cl, cr), K6's layout
// (K7 then places them, as on the record route); left = the histogram of
// the window with each column's mask multiplied by its go flag
// (_hist_tile_body :463-504: stats g*m*go, h*m*go, m*go); right =
// hists[parent] - left, elementwise in float32; hists[parent] <- left,
// hists[new_leaf] <- right; and out [2, 16] = both children's searches, the
// layout of K3/K4, with the left count written into out[0][11] (the TPU
// kernel leaves slots 11-15 zero) so one copy to the host carries both.
// The record is only read.  Not carried over: the TPU's [P, Fp, 4, Bp]
// histogram layout and the bin-0 totals it writes into padded features, the
// aliased record pass-through (direct_read) and the do_split mask.
//
// Bound on the H100: memory.  K8 must read the window's W-1 rows above the
// leaf id and write them to comp, read the parent row and write two rows:
// 2*(W-1)*4*pcnt + 3*F*B*12 bytes.  At the bench root split (W=12, 1M
// columns, F=28, B=255) that is 88.26 MB, 0.0263 ms at 3.35 TB/s.  The
// histogram's ~3 adds per (column, feature) are far below the f32 peak.
// What sets its time is not the bytes: at the root, building 489 x 28
// chunk partials (phase A); on the small windows most splits have, the
// dependent chains of the barriers and of each feature's 255-bin scan.
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), so that
// every block of the grid is resident and a grid-wide barrier is safe; the
// grid is the card's resident capacity for this kernel (two 512-thread
// blocks an SM: __launch_bounds__(kThreads, 2), ~88-90 KB of dynamic
// shared memory a block), or the phase-A work if that is smaller (a
// one-tile window takes one tile item and F histogram items).  Blocks
// stride over the work of each phase; a hand-written barrier (grid_sync:
// __threadfence, an integer ticket and a generation word) separates the
// phases.
//  * A: each item is either one tile of the compaction (compact_tile, K6's
//    code) or one (2048-column chunk, group of kGroup features) partial of
//    the left histogram: hist_sorted (hist_chunk.cuh, K1's pass 1), a
//    stable sort of the chunk's columns by bin in shared memory and one
//    thread per bin adding its run in column order, over LeftWindowRows,
//    which stages the record window with each column's mask times its go
//    flag.  The chunks start at `begin`, as K1' chunks do on any window.
//    Bins are staged as u8 when num_bins <= 256 and as u16 above (two
//    instantiations).
//  * B: each thread owns cells of the [F, B, 3] rows: it sums the cell's
//    partials in chunk order (reduce_chunks, K1' pass 2's order, 16 loads
//    in flight), reads the parent there and writes both children
//    (write_children, K4's code).  One owner per cell, so the in-place
//    update is safe as in K4.
//  * C: one warp per (child, feature), the 2F warps spread over the grid
//    (warp w of block b takes pair b + w * grid), scans the child's row
//    (scan_feature_warp, search_step.cuh: the plain version's floats)
//    and writes the pair's best to global scratch [2, F, kPerFeature]
//    (the front of the spent partials).
//  * D: block 0 sums the tile counts (integers, exact in any order) into
//    the left count and picks both children's winners over the features
//    (pick_winner, search_step.cuh).
// Every float sum is cut by column chunks that depend only on begin and
// pcnt and is reduced in chunk order, never by the grid size or by which
// block finishes first, and there are no float atomics: two launches give
// bitwise-equal output, and the plain version (ops/record.py split_step)
// reproduces it bitwise.  The partial scratch is [nchunks, F, B, 3] floats
// (42 MB at the 1M-column root), at least 2 * F * kPerFeature.  Why a
// hand-written barrier and not cooperative_groups' grid.sync(): fifteen
// lines whose memory order is visible here, with no dependence on how a
// toolkit implements grid.sync (older ones needed relocatable device code).
// Why CUDA and not Triton: grid-wide phases, a ballot scan and sort, and
// the three-key lexicographic argmax K4 already has in CUDA.
// Cost on an NVIDIA H100 80GB HBM3 (700 W), chip_smoke.py phase 7 and
// tools/split_step_phases.py: 0.73 ms a call at the 1M-column root (0.64
// of device time, 0.57 of it phase A; the per-bin walk and the one-block
// search it replaced took 3.8), 0.07 ms a call at 400 columns (0.022 of
// device time, 0.014 of it phases C and D; 0.16 before).  Registers are
// capped at 64 by the two blocks an SM; the warp scan spills ~80 bytes.
//
// The kernel runs on the caller's stream and allocates nothing: the
// wrapper (ops/cuda_split_step.py) allocates comp, counts, the partials,
// the output and the two-word barrier (zero at the first launch; each
// barrier leaves its ticket at zero again).  The C entry returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "compact_tile.cuh"
#include "hist_chunk.cuh"
#include "search_step.cuh"

namespace {

using namespace lgbm;

constexpr int kThreads = kTile;  // one thread per column of a tile
constexpr int kGroup = 1;        // features a phase-A histogram item
constexpr int kWarps = kThreads / 32;

// The record window [begin, begin+pcnt) for hist_sorted with the mask
// restricted to the left child: s_g = g * (m * go), s_h = h * (m * go),
// s_m = m * go, the products _hist_tile_body forms (mw = mrow * govf).
// Each thread loads a column's stats, its split-feature word and the
// group's words (k bins a word) before it stores any of them.
template <typename BinT>
struct LeftWindowRows {
  const int* rec;
  int64_t ld;
  int64_t begin;
  int wb;  // the grad row; hess and mask follow
  int k;
  int shift;
  unsigned bmask;
  SplitRule rule;
  template <int G, int kStage>
  __device__ void stage(int64_t row0, int nrows, int f0, int nf, float* s_g,
                        float* s_h, float* s_m, BinT* s_bin) const {
    constexpr int kPer = kChunk / kStage;  // columns a thread stages
    constexpr int kW = G / 2 + 1;  // words G features span at k >= 2
    const int tid = threadIdx.x;
    const int w0 = f0 / k, nw = (f0 + nf - 1) / k - w0 + 1;
    const int* col = rec + begin + row0;
    float g[kPer], h[kPer], m[kPer];
    unsigned gw[kPer], w[kPer][kW];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = tid + i * kStage;
      if (r < nrows) {
        m[i] = __int_as_float(col[(int64_t)(wb + 2) * ld + r]);
        g[i] = __int_as_float(col[(int64_t)wb * ld + r]);
        h[i] = __int_as_float(col[(int64_t)(wb + 1) * ld + r]);
        gw[i] = (unsigned)col[(int64_t)rule.fword * ld + r];
#pragma unroll
        for (int j = 0; j < kW; ++j)
          w[i][j] = j < nw ? (unsigned)col[(int64_t)(w0 + j) * ld + r] : 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = tid + i * kStage;
      if (r < nrows) {
        const float mg = m[i] * (rule.go_word(gw[i]) ? 1.f : 0.f);
        s_g[r] = g[i] * mg;
        s_h[r] = h[i] * mg;
        s_m[r] = mg;
#pragma unroll
        for (int fl = 0; fl < G; ++fl) {
          if (fl < nf) {
            const int f = f0 + fl;
            unsigned word = 0u;
#pragma unroll
            for (int j = 0; j < kW; ++j)
              if (j == f / k - w0) word = w[i][j];
            s_bin[fl * kChunk + r] =
                (BinT)((word >> ((f % k) * shift)) & bmask);
          }
        }
      }
    }
  }
};

// Grid-wide barrier of a cooperative launch.  bar[0] counts the blocks
// that arrived, bar[1] is the generation: the last block to arrive resets
// the count and bumps the generation, the others wait for the bump.  The
// fences order every thread's writes before the arrival and the reads
// after the departure.
__device__ void grid_sync(int* bar) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile int* gen = bar + 1;
    const int g = *gen;
    if (atomicAdd(bar, 1) == (int)gridDim.x - 1) {
      atomicExch(bar, 0);
      __threadfence();
      atomicAdd(bar + 1, 1);
    } else {
      while (*gen == g) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

struct StepArgs {
  const int* rec;
  int64_t ld;
  int W;
  int64_t begin;
  int64_t pcnt;
  SplitRule rule;
  int k;          // bins a record word
  int F;
  int B;
  float* hists;  // [L, F, B, 3]
  int parent;
  int new_leaf;
  const int* meta;  // [F, 4]
  Scal p;
  int* comp;        // [nt, W-1, 2*kTile]
  int* counts;      // [2, nt]
  float* partial;   // [nchunks, F, B, 3], then the bests [2, F, kPerFeature]
  int* bar;         // [2]
  float* out;       // [2, 16]
};

template <typename BinT>
__global__ void __launch_bounds__(kThreads, 2)
    split_step_kernel(StepArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];  // hist_sorted's
  __shared__ int s_nleft[kWarps];
  const int64_t nt = (a.pcnt + kTile - 1) / kTile;
  const int nchunks = (int)((a.pcnt + kChunk - 1) / kChunk);
  const int groups = (a.F + kGroup - 1) / kGroup;
  const int64_t items = nt + (int64_t)nchunks * groups;
  const int shift = 32 / a.k;

  // ---- A: compaction tiles, then (chunk, group) partials
  const LeftWindowRows<BinT> left{a.rec, a.ld, a.begin, (a.F + a.k - 1) / a.k,
                                  a.k, shift, (1u << shift) - 1u, a.rule};
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
    if (it < nt) {
      compact_tile(a.rec, a.ld, a.W, a.begin, a.pcnt, a.rule, it, nt, a.comp,
                   a.counts);
    } else {
      const int64_t h = it - nt;
      const int c = (int)(h / groups), f0 = (int)(h % groups) * kGroup;
      const int64_t row0 = (int64_t)c * kChunk;
      const int nrows =
          (a.pcnt - row0 < kChunk) ? (int)(a.pcnt - row0) : kChunk;
      hist_sorted<BinT, kGroup, kThreads>(
          left, row0, nrows, f0, min(kGroup, a.F - f0), a.B,
          a.partial + (((int64_t)c * a.F + f0) * a.B) * 3, smem);
    }
  }
  grid_sync(a.bar);

  // ---- B: the left child's cells, the subtraction, both rows in place
  const int64_t cells = (int64_t)a.F * a.B * 3;
  float* const rows[2] = {a.hists + (int64_t)a.parent * cells,
                          a.hists + (int64_t)a.new_leaf * cells};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += stride)
    write_children(rows[0], rows, i,
                   reduce_chunks(a.partial, nchunks, cells, i), 1);
  grid_sync(a.bar);

  // ---- C: one warp per (child, feature), over the whole grid
  float* const best = a.partial;  // [2, F, kPerFeature]
  const int warp = threadIdx.x >> 5;
  for (int i = blockIdx.x + warp * gridDim.x; i < 2 * a.F;
       i += gridDim.x * kWarps) {
    const int c = i / a.F, f = i % a.F;
    scan_feature_warp(rows[c], a.meta, f, a.B, c, a.p, best + i * kPerFeature);
  }
  grid_sync(a.bar);

  // ---- D: the left count and both winners, in block 0
  if (blockIdx.x != 0) return;
  int v = 0;
  for (int64_t t = threadIdx.x; t < nt; t += blockDim.x) v += a.counts[t];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) s_nleft[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x < 2) {
    const int c = threadIdx.x;
    pick_winner(rows[c], best + c * a.F * kPerFeature, a.meta, a.F, a.B, c,
                a.p, a.out + c * 16);
  }
  if (threadIdx.x == 0) {  // after its own pick_winner wrote out[0..15]
    int nleft = 0;
    for (int w = 0; w < kWarps; ++w) nleft += s_nleft[w];
    a.out[11] = (float)nleft;
  }
}

// The kernel for num_bins bins (u8 staging up to 256 bins, u16 above),
// its dynamic shared memory and its slot in the grid cache.
struct Inst {
  const void* fn;
  int smem;
  int slot;
};

Inst instance(int num_bins) {
  if (num_bins <= 256)
    return {(const void*)split_step_kernel<uint8_t>,
            hist_sorted_smem<uint8_t, kGroup>(), 0};
  return {(const void*)split_step_kernel<uint16_t>,
          hist_sorted_smem<uint16_t, kGroup>(), 1};
}

}  // namespace

extern "C" {

// The grid a launch over pcnt columns takes (blocks), or -1 on an error.
// The card's resident capacity for each instantiation is looked up once
// per device and kept (the split loop launches per split).
int lgbm_split_step_grid(int64_t pcnt, int F, int num_bins) {
  constexpr int kMaxDevices = 64;
  static int cap_blocks[2][kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return -1;
  const Inst in = instance(num_bins);
  int& cap = cap_blocks[in.slot][dev];
  if (cap == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(in.fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             in.smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, in.fn, kThreads, in.smem) != cudaSuccess)
      return -1;
    if (per_sm == 0) return -1;
    cap = per_sm * sms;
  }
  const int64_t nt = (pcnt + kTile - 1) / kTile;
  const int64_t items =
      nt + ((pcnt + kChunk - 1) / kChunk) * ((F + kGroup - 1) / kGroup);
  const int64_t grid = items < cap ? items : cap;
  return (int)(grid > 0 ? grid : 1);
}

// One split step over window [begin, begin+pcnt) of the [W, ld] record (k
// bins per word, F features in its first ceil(F/k) rows), split on feature
// f at bin threshold thr.  hists [L, F, num_bins, 3]: row `parent` holds
// the parent and becomes the left child, row `new_leaf` the right.
// partial holds max(ceil(pcnt / kChunk) * F * num_bins * 3,
// 2 * F * kPerFeature) floats.  All pointers are device pointers; `stream`
// is a cudaStream_t.
int lgbm_split_step(const int* rec, int64_t ld, int W, int64_t begin,
                    int64_t pcnt, int F, int k, int num_bins, int f, int thr,
                    int is_cat, float* hists, int parent, int new_leaf,
                    const int* meta, float can, float lsg, float lsh,
                    float lc, float rsg, float rsh, float rc, float min_data,
                    float min_hess, float l1, float l2, float min_gain,
                    int* comp, int* counts, float* partial, int* bar,
                    float* out, void* stream) {
  if (k != 2 && k != 4) return (int)cudaErrorInvalidValue;
  const int grid = lgbm_split_step_grid(pcnt, F, num_bins);
  if (grid < 0) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  const int shift = 32 / k;
  StepArgs a;
  a.rec = rec;
  a.ld = ld;
  a.W = W;
  a.begin = begin;
  a.pcnt = pcnt;
  a.rule = SplitRule{f / k, (f % k) * shift, (1u << shift) - 1u, thr, is_cat};
  a.k = k;
  a.F = F;
  a.B = num_bins;
  a.hists = hists;
  a.parent = parent;
  a.new_leaf = new_leaf;
  a.meta = meta;
  a.p = make_scal(can, lsg, lsh, lc, can, rsg, rsh, rc, min_data, min_hess,
                  l1, l2, min_gain);
  a.comp = comp;
  a.counts = counts;
  a.partial = partial;
  a.bar = bar;
  a.out = out;
  void* args[] = {&a};
  const Inst in = instance(num_bins);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      in.fn, dim3(grid), dim3(kThreads), args, in.smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
