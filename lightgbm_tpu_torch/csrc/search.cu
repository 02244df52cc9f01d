// Kernel 3: best split of both children of a split, one launch; and
// kernel 4, the same search fused with the histogram-buffer update.
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
// The search, its semantics and its float order, and the buffer update
// live in search_step.cuh, shared with K8 (split_step.cu).
//
// Bound on the H100: K3 moves 2*F*B*12 bytes in (~170 KB at F=28,
// B=255) and 128 bytes out: ~0.05 us at 3.35 TB/s.  K4 reads two rows and
// writes two: 4*F*B*12 bytes (~343 KB), ~0.1 us.  Both are launch- and
// latency-bound, not bandwidth-bound: their time (~0.13 ms a launch at
// F=28, B=255 on an H100, chip_smoke.py) is the dependent chain of one
// thread's 255-bin scan per feature.
//
// K3 design: one block per child; thread t scans features t, t+blockDim,
// ... (search_step.cuh scan_feature), then one thread picks the winner.
// K4 design: ONE block for the whole step.  The left child overwrites the
// parent row that the subtraction reads, and the search must see both
// finished rows; the TPU kernel orders this with two sequential grid steps
// and a VMEM stash (pallas_search.py:302-356), but CUDA blocks run in no
// order.  Inside one block the thread that owns a cell reads parent and
// small there and then writes both children's values, and __syncthreads()
// orders the writes before the scans.  One block instead of two launches
// (update, then K3) keeps the step at one launch; the scans use 2*F threads
// of the block, as K3's two blocks use F each, so the search costs what K3
// costs.
// Why CUDA and not Triton: the winner is a lexicographic three-key argmax
// over a 2-D tile, awkward in Triton's block model and simple here.
// The kernels run on the caller's stream and allocate nothing.  Each C
// entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "search_step.cuh"

namespace {

using namespace lgbm;

constexpr int kThreads = 128;        // kernel 3, per child
constexpr int kUpdateThreads = 256;  // kernel 4

// Kernel 3: one block per child.
__global__ void search2_kernel(const float* __restrict__ hist_l,  // [F, B, 3]
                               const float* __restrict__ hist_r,
                               const int* __restrict__ meta,  // [F, 4]
                               int F, int B, Scal p,
                               float* __restrict__ out) {  // [2, 16]
  extern __shared__ float s_best[];  // [F, kPerFeature]
  const int c = blockIdx.x;
  const float* hist = (c == 0) ? hist_l : hist_r;
  for (int f = threadIdx.x; f < F; f += blockDim.x)
    scan_feature(hist, meta, f, B, c, p, s_best + f * kPerFeature);
  __syncthreads();
  if (threadIdx.x == 0) pick_winner(hist, s_best, meta, F, B, c, p,
                                    out + c * 16);
}

// Kernel 4: one block for the whole split step.  Each thread owns cells
// (f, b, s) of the [F, B, 3] rows: it reads parent[i] and small[i], then
// writes both children's values for i, so no cell is read after another
// thread has written it even though the left child overwrites the parent
// row in place.  __syncthreads() then makes the finished rows visible to
// the whole block, and its threads scan the (child, feature) pairs with
// kernel 3's device functions.
__global__ void search2_update_kernel(float* hists,  // [L, F, B, 3]
                                      const float* __restrict__ small,
                                      int parent, int new_leaf,
                                      int small_is_left,
                                      const int* __restrict__ meta, int F,
                                      int B, Scal p,
                                      float* __restrict__ out) {  // [2, 16]
  extern __shared__ float s_best[];  // [2, F, kPerFeature]
  const int64_t cells = (int64_t)F * B * 3;
  float* const rows[2] = {hists + (int64_t)parent * cells,
                          hists + (int64_t)new_leaf * cells};
  for (int64_t i = threadIdx.x; i < cells; i += blockDim.x)
    write_children(rows, i, small[i], small_is_left);
  __syncthreads();
  search_children(rows, meta, F, B, p, s_best, out);
}

}  // namespace

extern "C" {

// Largest F kernel 3 takes (its per-feature bests live in shared memory);
// kernel 4 keeps both children's, so it takes half as many.
int lgbm_search2_max_features() {
  return (48 * 1024) / (kPerFeature * (int)sizeof(float));
}

int lgbm_search2(const float* hist_l, const float* hist_r, const int* meta,
                 int F, int B, float can_l, float lsg, float lsh, float lc,
                 float can_r, float rsg, float rsh, float rc, float min_data,
                 float min_hess, float l1, float l2, float min_gain,
                 float* out, void* stream) {
  const Scal p = make_scal(can_l, lsg, lsh, lc, can_r, rsg, rsh, rc, min_data,
                           min_hess, l1, l2, min_gain);
  const size_t smem = (size_t)F * kPerFeature * sizeof(float);
  search2_kernel<<<2, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      hist_l, hist_r, meta, F, B, p, out);
  return (int)cudaGetLastError();
}

// hists [L, F, B, 3]: rows `parent` and `new_leaf` become the left and
// right children (small and parent - small, routed by small_is_left).
int lgbm_search2_update(float* hists, const float* small, int parent,
                        int new_leaf, int small_is_left, const int* meta,
                        int F, int B, float can, float lsg, float lsh,
                        float lc, float rsg, float rsh, float rc,
                        float min_data, float min_hess, float l1, float l2,
                        float min_gain, float* out, void* stream) {
  const Scal p = make_scal(can, lsg, lsh, lc, can, rsg, rsh, rc, min_data,
                           min_hess, l1, l2, min_gain);
  const size_t smem = (size_t)2 * F * kPerFeature * sizeof(float);
  search2_update_kernel<<<1, kUpdateThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      hists, small, parent, new_leaf, small_is_left, meta, F, B, p, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
