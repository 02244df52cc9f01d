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
// K3-f64 (lgbm_search2_f64) is K3 for hist_dtype=float64: the same grid,
// warp scan, gains and pick over [F, B, 3] double histograms, with double
// totals and constraints, a double scratch [2, F, kPerFeature] and double
// [2, 16] rows (search_step.cuh with T = double).  It replaces no
// pallas_call: search2_pallas refuses float64 (pallas_search.py:235-238)
// and the JAX package searches with jnp (lightgbm_tpu/ops/split.py:69
// find_best_split, :171 find_best_split_leaves, learners/serial.py:
// 457-468) on the order route, the pooled route and hybrid's resume.  Its
// plain version is ops/split.py search2_rows on float64 histograms,
// bitwise.  Bound: 2*F*B*24 bytes read (342,720 B at F = 28, B = 255:
// 0.10 us at 3.35 TB/s); like K3 it is bound by latency.

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
__global__ void __launch_bounds__(kThreads)
    search2_step_kernel(float* buf, const float* __restrict__ small,
                        const float* parent, int s1, int s2,
                        int small_is_left, const int* __restrict__ meta,
                        int F, int B, Scal p,
                        float* __restrict__ best,  // [2, F, kPerFeature]
                        int* ticket, float* __restrict__ out) {  // [2, 16]
  const int64_t cells = (int64_t)F * B * 3;
  float* const rows[2] = {buf + (int64_t)s1 * cells,
                          buf + (int64_t)s2 * cells};
  const int f = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (f < F) {
    const int lane = threadIdx.x & 31, n = B * 3;
    const int64_t base = (int64_t)f * n;
    for (int i0 = lane; i0 < n; i0 += 32 * kStepLoads) {
      float pv[kStepLoads], sv[kStepLoads];
#pragma unroll
      for (int j = 0; j < kStepLoads; ++j) {
        const int i = i0 + 32 * j;
        pv[j] = i < n ? parent[base + i] : 0.f;
        sv[j] = i < n ? small[base + i] : 0.f;
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
  const float* const hist[2] = {rows[0], rows[1]};
  finish_search(hist, meta, F, B, p, best, ticket, out);
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

// K3-f64: lgbm_search2 over double histograms, totals and constraints;
// best holds at least 2 * F * kPerFeature doubles, out [2, 16] double.
int lgbm_search2_f64(const double* hist_l, const double* hist_r,
                     const int* meta, int F, int B, double can_l, double lsg,
                     double lsh, double lc, double can_r, double rsg,
                     double rsh, double rc, double min_data, double min_hess,
                     double l1, double l2, double min_gain, double* best,
                     int* ticket, double* out, void* stream) {
  const ScalT<double> p = make_scal(can_l, lsg, lsh, lc, can_r, rsg, rsh, rc,
                                    min_data, min_hess, l1, l2, min_gain);
  search2_kernel<double><<<grid_for(2 * F), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      hist_l, hist_r, meta, F, B, p, best, ticket, out);
  return (int)cudaGetLastError();
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
  search2_step_kernel<<<grid_for(F), kThreads, 0,
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
