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
// Semantics held exactly:
//  * in range: numerical bin < nb-1, categorical bin < nb, and the
//    feature is in the feature_mask;
//  * right side of a numerical threshold t = exclusive suffix sum over
//    bins > t, with K_EPSILON added to the hessian suffix only; left =
//    leaf totals - right.  Categorical: left = the bin itself;
//  * valid = in range, both counts >= min_data, both hessians >=
//    min_hess, gain >= gain_shift + min_gain, and `can`;
//  * winner: the largest gain; among equal gains the largest threshold
//    within a feature, then the smallest feature;
//  * nothing valid: gain -inf, feature -1, threshold 0, and the six
//    stats taken at (feature 0, bin B-1), as the plain version
//    (ops/split.py) takes them;
//  * leaf output = -sign(g) * max(|g| - l1, 0) / (h + l2).
// Built with -fmad=false so no multiply-add is contracted and the f32
// arithmetic is the plain version's.
//
// Bound on the H100: K3 moves 2*F*B*12 bytes in (~170 KB at F=28,
// B=255) and 128 bytes out: ~0.05 us at 3.35 TB/s.  K4 reads two rows and
// writes two: 4*F*B*12 bytes (~343 KB), ~0.1 us.  Both are launch- and
// latency-bound, not bandwidth-bound: their time (~0.13 ms a launch at
// F=28, B=255 on an H100, chip_smoke.py) is the dependent chain of one
// thread's 255-bin scan per feature.
//
// K3 design: one block per child.  Thread t scans features t, t+blockDim,
// ... each from the highest bin down, carrying the suffix sums (summed in
// the plain version's blocked order, BlockedScan3, so both give the same
// floats) and keeping the best (gain, bin) with a strict ">" - a
// high-to-low scan with strict improvement keeps the LARGEST bin among
// equal gains, like the reference's own scan (feature_histogram.hpp:
// 129,154).  Per-feature bests go to shared memory; one thread then walks
// the features in ascending order with a strict ">", which keeps the
// SMALLEST feature among equal gains.
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
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEpsilon = 1e-15f;
constexpr int kThreads = 128;        // kernel 3, per child
constexpr int kUpdateThreads = 256;  // kernel 4
constexpr int kPerFeature = 8;  // gain, bin, lg, lh, lc, rg, rh, rc

constexpr int kScanBlock = 16;
constexpr int kMaxLevels = 5;  // 16^5 bins > any uint16 bin count

// Inclusive prefix sums of a stream of (g, h, c) triples, taken in the
// order of ops/split.py blocked_cumsum (the JAX package's jnp.cumsum
// order on the CPU): sequential within blocks of 16; block totals scanned
// the same way, one level up, while a level has more than 16 entries;
// each block offset by the exclusive prefix of the totals.  push() takes
// the next element and returns its inclusive prefix.
struct BlockedScan3 {
  int nlev;
  int n[kMaxLevels];
  int cnt[kMaxLevels];
  float w[kMaxLevels][3];  // running sum inside the open block
  float e[kMaxLevels][3];  // exclusive prefix of the open block

  __device__ void init(int len) {
    nlev = 1;
    n[0] = len;
    while (n[nlev - 1] > kScanBlock && nlev < kMaxLevels) {
      n[nlev] = (n[nlev - 1] + kScanBlock - 1) / kScanBlock;
      ++nlev;
    }
    for (int l = 0; l < kMaxLevels; ++l) {
      cnt[l] = 0;
      for (int c = 0; c < 3; ++c) w[l][c] = e[l][c] = 0.f;
    }
  }

  __device__ void push(const float in[3], float out[3]) {
    float v[3] = {in[0], in[1], in[2]};
    for (int l = 0; l < nlev; ++l) {
      const bool seq = n[l] <= kScanBlock;
      float p[3];
      for (int c = 0; c < 3; ++c) {
        w[l][c] = __fadd_rn(w[l][c], v[c]);
        p[c] = seq ? w[l][c] : __fadd_rn(w[l][c], e[l][c]);
      }
      for (int c = 0; c < 3; ++c) {
        if (l == 0) out[c] = p[c];
        else e[l - 1][c] = p[c];  // offset of level l-1's next block
      }
      if (seq) return;
      ++cnt[l];
      if (cnt[l] % kScanBlock != 0 && cnt[l] != n[l]) return;
      for (int c = 0; c < 3; ++c) {  // block closed: its total goes up
        v[c] = w[l][c];
        w[l][c] = 0.f;
      }
    }
  }
};

struct Scal {
  float can[2], sg[2], sh[2], cnt[2];
  float min_data, min_hess, l1, l2, min_gain;
};

Scal make_scal(float can_l, float lsg, float lsh, float lc, float can_r,
               float rsg, float rsh, float rc, float min_data, float min_hess,
               float l1, float l2, float min_gain) {
  Scal p;
  p.can[0] = can_l; p.sg[0] = lsg; p.sh[0] = lsh; p.cnt[0] = lc;
  p.can[1] = can_r; p.sg[1] = rsg; p.sh[1] = rsh; p.cnt[1] = rc;
  p.min_data = min_data; p.min_hess = min_hess;
  p.l1 = l1; p.l2 = l2; p.min_gain = min_gain;
  return p;
}

__device__ __forceinline__ float leaf_gain(float g, float h, float l1,
                                           float l2) {
  const float reg = fmaxf(fabsf(g) - l1, 0.f);
  return __fdiv_rn(__fmul_rn(reg, reg), __fadd_rn(h, l2));
}

__device__ __forceinline__ float leaf_out(float g, float h, float l1,
                                          float l2) {
  const float reg = fmaxf(fabsf(g) - l1, 0.f);
  const float sgn = (g > 0.f) ? 1.f : ((g < 0.f) ? -1.f : 0.f);
  return __fdiv_rn(-sgn * reg, __fadd_rn(h, l2));
}

// One feature's scan of one child: the best (gain, bin) over its bins and
// the six stats there, into sb[0..7] = (gain, bin, lg, lh, lc, rg, rh, rc).
// `hist` is the child's [F, B, 3] row.  It is not __restrict__: kernel 4
// writes the row earlier in the same launch.
__device__ void scan_feature(const float* hist, const int* meta, int f, int B,
                             int c, const Scal& p, float* sb) {
  const bool can = p.can[c] > 0.f;
  const float sg = p.sg[c], sh = p.sh[c], cnt = p.cnt[c];
  const float min_gain_shift =
      __fadd_rn(leaf_gain(sg, sh, p.l1, p.l2), p.min_gain);
  const bool fmask = meta[f * 4 + 0] > 0;
  const int nb = meta[f * 4 + 1];
  const bool iscat = meta[f * 4 + 2] > 0;
  const float* hf = hist + (int64_t)f * B * 3;
  float best = -INFINITY;
  int best_bin = -1;
  float st[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float tail[3] = {0.f, 0.f, 0.f};  // sums over bins > t
  BlockedScan3 scan;
  scan.init(B);
  for (int t = B - 1; t >= 0; --t) {
    const float hg = hf[t * 3 + 0], hh = hf[t * 3 + 1], hc = hf[t * 3 + 2];
    const float tg = tail[0], th = tail[1], tc = tail[2];
    float lg, lh, lc, rg, rh, rc;
    if (iscat) {
      lg = hg; lh = hh; lc = hc;
      rg = __fsub_rn(sg, hg); rh = __fsub_rn(sh, hh);
      rc = __fsub_rn(cnt, hc);
    } else {
      const float th_eps = __fadd_rn(th, kEpsilon);
      rg = tg; rh = th_eps; rc = tc;
      lg = __fsub_rn(sg, tg); lh = __fsub_rn(sh, th_eps);
      lc = __fsub_rn(cnt, tc);
    }
    const bool in_range = fmask && (iscat ? (t < nb) : (t < nb - 1));
    const float gain = __fadd_rn(leaf_gain(lg, lh, p.l1, p.l2),
                                 leaf_gain(rg, rh, p.l1, p.l2));
    const bool valid = in_range && can && lc >= p.min_data &&
                       rc >= p.min_data && lh >= p.min_hess &&
                       rh >= p.min_hess && gain >= min_gain_shift;
    if (valid && gain > best) {
      best = gain;
      best_bin = t;
      st[0] = lg; st[1] = lh; st[2] = lc;
      st[3] = rg; st[4] = rh; st[5] = rc;
    }
    const float cur[3] = {hg, hh, hc};
    scan.push(cur, tail);
  }
  sb[0] = best;
  sb[1] = (float)best_bin;
  for (int k = 0; k < 6; ++k) sb[2 + k] = st[k];
}

// The winner over the F per-feature bests `s_best` [F, kPerFeature] of
// child c: the largest gain, the smallest feature among equal gains.
// Writes the child's [16] result row.
__device__ void pick_winner(const float* hist, const float* s_best,
                            const int* meta, int F, int B, int c,
                            const Scal& p, float* out) {
  const float sg = p.sg[c], sh = p.sh[c], cnt = p.cnt[c];
  float best = -INFINITY;
  int fbest = -1;
  for (int f = 0; f < F; ++f) {
    if (s_best[f * kPerFeature] > best) {
      best = s_best[f * kPerFeature];
      fbest = f;
    }
  }
  float row[16];
  for (int k = 0; k < 16; ++k) row[k] = 0.f;
  float st[6];
  if (fbest >= 0) {
    const float* sb = s_best + fbest * kPerFeature;
    row[0] = __fsub_rn(best, leaf_gain(sg, sh, p.l1, p.l2));
    row[1] = (float)fbest;
    row[2] = sb[1];
    for (int k = 0; k < 6; ++k) st[k] = sb[2 + k];
  } else {
    // no valid split: stats at (feature 0, bin B-1) like the plain version
    row[0] = -INFINITY;
    row[1] = -1.f;
    row[2] = 0.f;
    const float* h0 = hist + (int64_t)(B - 1) * 3;
    if (F > 0 && meta[2] > 0) {
      st[0] = h0[0]; st[1] = h0[1]; st[2] = h0[2];
      st[3] = __fsub_rn(sg, h0[0]); st[4] = __fsub_rn(sh, h0[1]);
      st[5] = __fsub_rn(cnt, h0[2]);
    } else {
      st[0] = sg; st[1] = __fsub_rn(sh, kEpsilon); st[2] = cnt;
      st[3] = 0.f; st[4] = kEpsilon; st[5] = 0.f;
    }
  }
  for (int k = 0; k < 6; ++k) row[3 + k] = st[k];
  row[9] = leaf_out(st[0], st[1], p.l1, p.l2);
  row[10] = leaf_out(st[3], st[4], p.l1, p.l2);
  for (int k = 0; k < 16; ++k) out[k] = row[k];
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
  float* rows[2] = {hists + (int64_t)parent * cells,
                    hists + (int64_t)new_leaf * cells};
  for (int64_t i = threadIdx.x; i < cells; i += blockDim.x) {
    const float s = small[i];
    const float large = __fsub_rn(rows[0][i], s);
    rows[0][i] = small_is_left ? s : large;
    rows[1][i] = small_is_left ? large : s;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * F; i += blockDim.x) {
    const int c = i / F, f = i % F;
    scan_feature(rows[c], meta, f, B, c, p, s_best + i * kPerFeature);
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    const int c = threadIdx.x;
    pick_winner(rows[c], s_best + c * F * kPerFeature, meta, F, B, c, p,
                out + c * 16);
  }
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
