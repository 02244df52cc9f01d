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
// Bound on the H100: K3 moves 2*F*B*12 bytes in (~170 KB at F=28,
// B=255) and 128 bytes out: ~0.05 us at 3.35 TB/s.  K4 and K5 read two
// rows and write two: 4*F*B*12 bytes (342,720 B at F=28, B=255, 0.102 us;
// 24.6 MB at F=2000, B=256, 7.3 us).  All three are latency-bound, not
// bandwidth-bound: their time (~0.13-0.19 ms a launch at F=28, B=255 on an
// H100, chip_smoke.py) is the dependent chain of one thread's 255-bin scan
// per feature, and at F=2000 one block's walk over 1.5M cells besides.
//
// K3 design: one block per child; thread t scans features t, t+blockDim,
// ... (search_step.cuh scan_feature), then one thread picks the winner.
// K4 and K5 design: one kernel (search2_step_kernel, two C entries), ONE
// block for the whole step.  The left child may overwrite the parent row
// that the subtraction reads, and the search must see both finished rows;
// the TPU kernel orders this with two sequential grid steps and a VMEM
// stash (pallas_search.py:302-356), but CUDA blocks run in no order.
// Inside one block the thread that owns a cell reads parent and small there
// and then writes both children's values, and __syncthreads() orders the
// writes before the scans.  One block instead of two launches (update,
// then K3) keeps the step at one launch; the scans use 2*F threads of the
// block, as K3's two blocks use F each, so the search costs what K3 costs.
// Per-feature bests live in dynamic shared memory, F*32 bytes per child:
// above the default 48 KB a launch first raises the kernel's limit to what
// it needs (up to the card's opt-in maximum, 227 KB a block on the H100),
// so K3 takes F <= 7264 and K4/K5 F <= 3632 there
// (lgbm_search2_max_features).
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
constexpr int kUpdateThreads = 256;  // kernels 4 and 5
constexpr size_t kDefaultSmem = 48 * 1024;

// A launch with more than the default 48 KB of dynamic shared memory needs
// the kernel's opt-in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

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

// Kernels 4 and 5: one block for the whole split step, over a buffer of
// [F, B, 3] rows (K4: the [L, F, B, 3] leaf buffer, the children in rows
// `parent` and `new_leaf`; K5: the [P, F, B, 3] pool, the children in
// slots s1 and s2).  `parent` points at the parent's values: row s1 itself
// (K4, and K5 with the parent resident) or a separate row (K5 with the
// parent rebuilt); s2 is neither.  Each thread owns cells (f, b, s): it
// reads parent[i] and small[i], then writes both children's values for i,
// so no cell is read after another thread has written it even though the
// left child may overwrite the parent in place.  __syncthreads() then
// makes the finished rows visible to the whole block, and its threads
// scan the (child, feature) pairs with kernel 3's device functions.
__global__ void search2_step_kernel(float* buf,
                                    const float* __restrict__ small,
                                    const float* parent, int s1, int s2,
                                    int small_is_left,
                                    const int* __restrict__ meta, int F,
                                    int B, Scal p,
                                    float* __restrict__ out) {  // [2, 16]
  extern __shared__ float s_best[];  // [2, F, kPerFeature]
  const int64_t cells = (int64_t)F * B * 3;
  float* const rows[2] = {buf + (int64_t)s1 * cells,
                          buf + (int64_t)s2 * cells};
  for (int64_t i = threadIdx.x; i < cells; i += blockDim.x)
    write_children(parent, rows, i, small[i], small_is_left);
  __syncthreads();
  search_children(rows, meta, F, B, p, s_best, out);
}

}  // namespace

extern "C" {

// Largest F kernel 3 takes on the current device (its per-feature bests
// live in dynamic shared memory, up to the card's opt-in maximum per
// block); kernels 4 and 5 keep both children's, so they take half as many.
// 0 if the device cannot be queried.
int lgbm_search2_max_features() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return optin / (kPerFeature * (int)sizeof(float));
}

int lgbm_search2(const float* hist_l, const float* hist_r, const int* meta,
                 int F, int B, float can_l, float lsg, float lsh, float lc,
                 float can_r, float rsg, float rsh, float rc, float min_data,
                 float min_hess, float l1, float l2, float min_gain,
                 float* out, void* stream) {
  const Scal p = make_scal(can_l, lsg, lsh, lc, can_r, rsg, rsh, rc, min_data,
                           min_hess, l1, l2, min_gain);
  const size_t smem = (size_t)F * kPerFeature * sizeof(float);
  const cudaError_t err = allow_smem(search2_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  search2_kernel<<<2, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      hist_l, hist_r, meta, F, B, p, out);
  return (int)cudaGetLastError();
}

// pool [P, F, B, 3]: slots s1 and s2 become the left and right children
// (small and parent - small, routed by small_is_left); `parent` points at
// the parent's [F, B, 3] values, a pool slot (then s1) or a separate row.
int lgbm_search2_pool(float* pool, const float* small, const float* parent,
                      int s1, int s2, int small_is_left, const int* meta,
                      int F, int B, float can, float lsg, float lsh, float lc,
                      float rsg, float rsh, float rc, float min_data,
                      float min_hess, float l1, float l2, float min_gain,
                      float* out, void* stream) {
  const Scal p = make_scal(can, lsg, lsh, lc, can, rsg, rsh, rc, min_data,
                           min_hess, l1, l2, min_gain);
  const size_t smem = (size_t)2 * F * kPerFeature * sizeof(float);
  const cudaError_t err = allow_smem(search2_step_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  search2_step_kernel<<<1, kUpdateThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      pool, small, parent, s1, s2, small_is_left, meta, F, B, p, out);
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
  return lgbm_search2_pool(hists, small,
                           hists + (int64_t)parent * F * B * 3, parent,
                           new_leaf, small_is_left, meta, F, B, can, lsg, lsh,
                           lc, rsg, rsh, rc, min_data, min_hess, l1, l2,
                           min_gain, out, stream);
}

}  // extern "C"
