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
//
// Design: one cooperative launch (cudaLaunchCooperativeKernel), so that
// every block of the grid is resident and a grid-wide barrier is safe; the
// grid is the card's resident capacity for this kernel, or the phase-A
// work if that is smaller (a one-tile window takes one tile item and F
// histogram items).  Blocks stride over the work of each phase; a
// hand-written barrier (grid_sync: __threadfence, an integer ticket and a
// generation word) separates the phases.
//  * A: each item is either one tile of the compaction (compact_tile, K6's
//    code) or one (2048-column chunk, feature) partial of the left
//    histogram (hist_chunk: K8's chunk loop is hist_rows, a walk of the
//    staged columns once per bin, over a reader whose mask is m*go; it
//    adds each bin's columns in the order K1' does, which sorts them by
//    bin with hist_sorted).  The chunks start at `begin`, as K1' chunks do
//    on any window.
//  * B: each thread owns cells of the [F, B, 3] rows: it sums the cell's
//    partials in chunk order (reduce_chunks, K1' pass 2's order), reads the
//    parent there and writes both children (write_children, K4's code).
//    One owner per cell, so the in-place update is safe as in K4.
//  * C: block 0 sums the tile counts (integers, exact in any order) into
//    the left count and runs both searches (search_children, K4's code).
// Every float sum is cut by column chunks that depend only on begin and
// pcnt and is reduced in chunk order, never by the grid size or by which
// block finishes first, and there are no float atomics: two launches give
// bitwise-equal output, and the plain version (ops/record.py split_step)
// reproduces it bitwise.  The partial scratch is [nchunks, F, B, 3] floats
// (42 MB at the 1M-column root).  Why a hand-written barrier and not
// cooperative_groups' grid.sync(): fifteen lines whose memory order is
// visible here, with no dependence on how a toolkit implements grid.sync
// (older ones needed relocatable device code).
// Why CUDA and not Triton: grid-wide phases, a ballot scan and the
// three-key lexicographic argmax K4 already has in CUDA.
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

// The record reader with the mask restricted to the left child: m * go,
// the product _hist_tile_body forms (mw = mrow * govf).
struct LeftRows {
  RecordRows r;
  SplitRule rule;
  __device__ int bin(int f, int64_t i) const { return r.bin(f, i); }
  __device__ float g(int64_t i) const { return r.g(i); }
  __device__ float h(int64_t i) const { return r.h(i); }
  __device__ float m(int64_t i) const {
    return r.m(i) * (rule.go(r.rec, r.ld, r.begin + i) ? 1.f : 0.f);
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
  RecordRows rows;  // the window's reader (begin included)
  int F;
  int B;
  float* hists;  // [L, F, B, 3]
  int parent;
  int new_leaf;
  const int* meta;  // [F, 4]
  Scal p;
  int* comp;        // [nt, W-1, 2*kTile]
  int* counts;      // [2, nt]
  float* partial;   // [nchunks, F, B, 3]
  int* bar;         // [2]
  float* out;       // [2, 16]
};

__global__ void __launch_bounds__(kThreads) split_step_kernel(StepArgs a) {
  extern __shared__ float s_best[];  // [2, F, kPerFeature]
  __shared__ int s_nleft[kThreads / 32];
  const int64_t nt = (a.pcnt + kTile - 1) / kTile;
  const int nchunks = (int)((a.pcnt + kChunk - 1) / kChunk);
  const int64_t items = nt + (int64_t)nchunks * a.F;

  // ---- A: compaction tiles, then (chunk, feature) partials
  const LeftRows left{a.rows, a.rule};
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
    if (it < nt) {
      compact_tile(a.rec, a.ld, a.W, a.begin, a.pcnt, a.rule, it, nt, a.comp,
                   a.counts);
    } else {
      const int64_t h = it - nt;
      hist_chunk<uint16_t>(left, a.pcnt, (int)(h / a.F), (int)(h % a.F),
                           a.F, a.B, a.partial);
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

  // ---- C: the left count and both searches, in block 0
  if (blockIdx.x != 0) return;
  int v = 0;
  for (int64_t t = threadIdx.x; t < nt; t += blockDim.x) v += a.counts[t];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) s_nleft[threadIdx.x >> 5] = v;
  __syncthreads();
  search_children(rows, a.meta, a.F, a.B, a.p, s_best, a.out);
  if (threadIdx.x == 0) {  // after its own pick_winner wrote out[0..15]
    int nleft = 0;
    for (int w = 0; w < kThreads / 32; ++w) nleft += s_nleft[w];
    a.out[11] = (float)nleft;
  }
}

size_t search_smem(int F) {
  return (size_t)2 * F * kPerFeature * sizeof(float);
}

}  // namespace

extern "C" {

// Largest F the kernel takes: both children's per-feature bests live in
// shared memory beside the histogram's staged rows.
int lgbm_split_step_max_features() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, split_step_kernel) != cudaSuccess)
    return 0;
  return (int)((optin - (int)attr.sharedSizeBytes) / search_smem(1));
}

// The grid a launch over pcnt columns takes (blocks), or -1 on an error.
// The card's resident capacity for the kernel is looked up once per device
// and shared-memory size and kept (the split loop launches per split).
int lgbm_split_step_grid(int64_t pcnt, int F) {
  constexpr int kMaxDevices = 64;
  static int cap_smem[kMaxDevices], cap_blocks[kMaxDevices];
  int dev = 0;
  const size_t smem = search_smem(F);
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return -1;
  if (cap_blocks[dev] == 0 || cap_smem[dev] != (int)smem) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaFuncSetAttribute(split_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, split_step_kernel, kThreads, smem) != cudaSuccess)
      return -1;
    cap_smem[dev] = (int)smem;
    cap_blocks[dev] = per_sm * sms;
  }
  const int64_t nt = (pcnt + kTile - 1) / kTile;
  const int64_t items = nt + ((pcnt + kChunk - 1) / kChunk) * F;
  const int64_t grid = items < cap_blocks[dev] ? items : cap_blocks[dev];
  return (int)(grid > 0 ? grid : 1);
}

// One split step over window [begin, begin+pcnt) of the [W, ld] record (k
// bins per word, F features in its first ceil(F/k) rows), split on feature
// f at bin threshold thr.  hists [L, F, num_bins, 3]: row `parent` holds
// the parent and becomes the left child, row `new_leaf` the right.  All
// pointers are device pointers; `stream` is a cudaStream_t.
int lgbm_split_step(const int* rec, int64_t ld, int W, int64_t begin,
                    int64_t pcnt, int F, int k, int num_bins, int f, int thr,
                    int is_cat, float* hists, int parent, int new_leaf,
                    const int* meta, float can, float lsg, float lsh,
                    float lc, float rsg, float rsh, float rc, float min_data,
                    float min_hess, float l1, float l2, float min_gain,
                    int* comp, int* counts, float* partial, int* bar,
                    float* out, void* stream) {
  if (k != 2 && k != 4) return (int)cudaErrorInvalidValue;
  const int grid = lgbm_split_step_grid(pcnt, F);
  if (grid < 0) return (int)cudaGetLastError();
  const int shift = 32 / k;
  const unsigned bmask = (1u << shift) - 1u;
  StepArgs a;
  a.rec = rec;
  a.ld = ld;
  a.W = W;
  a.begin = begin;
  a.pcnt = pcnt;
  a.rule = SplitRule{f / k, (f % k) * shift, bmask, thr, is_cat};
  a.rows = RecordRows{rec, ld, begin, k, shift, bmask, (F + k - 1) / k};
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
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)split_step_kernel, dim3(grid), dim3(kThreads), args,
      search_smem(F), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
