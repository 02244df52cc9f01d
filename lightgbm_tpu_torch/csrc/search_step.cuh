// The two-child split search and the buffer update of a split step: the
// code K3/K4/K5 (search.cu) and K8 (split_step.cu) share, so the searches
// cannot drift apart.
//
// Semantics held exactly (pallas_search.py _child_search :85-172):
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
// The [2, 16] result rows are pallas_search._unpack's: (gain, feature,
// threshold, lg, lh, lc, rg, rh, rc, left_out, right_out, 0, 0, 0, 0, 0).
// Sources including this are built with -fmad=false, so no multiply-add
// is contracted and the f32 arithmetic is the plain version's.
//
// One (child, feature) is scanned by one warp (scan_feature_warp): the
// exclusive suffix sums over bins > t, from the highest bin down, are
// summed in the plain version's blocked order (blocked_cumsum), add for
// add, so both give the same floats, and the best (gain, bin) is kept with
// a strict ">" from high bin to low: the LARGEST bin among equal gains,
// like the reference's own scan (feature_histogram.hpp:129,154).  Each
// pair's best (kPerFeature floats) goes to global scratch; the winner over
// the features is the largest gain and, among equal gains, the SMALLEST
// feature (pick_winner, one thread, in K8; the last block's parallel
// argmax in K3/K4/K5), and winner_row writes its [16] result row.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lgbm {

constexpr float kEpsilon = 1e-15f;
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

inline Scal make_scal(float can_l, float lsg, float lsh, float lc,
                      float can_r, float rsg, float rsh, float rc,
                      float min_data, float min_hess, float l1, float l2,
                      float min_gain) {
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

// One feature's scan of one child, by one warp (every lane must call it;
// lane 0 writes sb): the best (gain, bin) over the feature's bins and the
// six stats there, into sb[0..7] = (gain, bin, lg, lh, lc, rg, rh, rc);
// gain -inf and bin -1 when no bin is valid.  `hist` is the child's
// [F, B, 3] row.  The reversed bin stream x[j] = hist[B-1-j] is cut into
// blocked_cumsum's blocks of 16, lane q owning block q of each 32-block
// segment:
//  * pass 1: each lane sums its block in order from 0.f (the block total
//    T_q, level 0's within-block adds);
//  * the block's offset E_q, the inclusive prefix of the totals up to
//    block q-1 in blocked_cumsum's order: with at most 16 blocks, each
//    lane adds T_0, T_1, ..., T_{q-1} to 0.f in order (broadcasts);
//    with more, the 16-lane halves are level 1's blocks of totals, each
//    lane sums its half's totals up to its own in order, the half's offset
//    comes from BlockedScan3 over level 1's block totals (the levels above,
//    warp-uniform, pushed in order), and E_q is lane q-1's sum plus that
//    offset (carried across segments);
//  * pass 2: each lane walks its block in order again, the exclusive tail
//    of element i being (within-block sum of 0..i-1) + E_q, and of its
//    first element the last prefix of the block before (lane q-1's, or
//    the previous segment's); every add is blocked_cumsum's, so the tails,
//    gains and stats are the plain version's floats bitwise;
//  * each lane keeps its best with a strict ">" from high bin to low, then
//    a butterfly argmax over the lanes takes the largest gain and among
//    equal gains the largest bin, which is what one high-to-low walk with
//    a strict ">" keeps.  Invalid and NaN gains never win.
// `hist` is read with plain loads, not __restrict__: K4, K5 and K8 write
// the row earlier in the same launch.  B <= 16 takes no block offsets,
// B > 256 the level-1 halves, B > 512 (32 blocks of 16) several segments,
// B > 4096 BlockedScan3's levels above.
__device__ inline void scan_feature_warp(const float* hist, const int* meta,
                                         int f, int B, int c, const Scal& p,
                                         float* sb) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool can = p.can[c] > 0.f;
  const float sg = p.sg[c], sh = p.sh[c], cnt = p.cnt[c];
  const float min_gain_shift =
      __fadd_rn(leaf_gain(sg, sh, p.l1, p.l2), p.min_gain);
  const bool fmask = meta[f * 4 + 0] > 0;
  const int nb = meta[f * 4 + 1];
  const bool iscat = meta[f * 4 + 2] > 0;
  const float* hf = hist + (int64_t)f * B * 3;
  const int n1 = (B + kScanBlock - 1) / kScanBlock;  // level-0 blocks
  const bool blocked0 = B > kScanBlock;   // level 0 offsets its blocks
  const bool blocked1 = n1 > kScanBlock;  // so does level 1
  BlockedScan3 upper;  // the levels above level 1 (B > 256)
  if (blocked1) upper.init((n1 + kScanBlock - 1) / kScanBlock);
  float e2[3] = {0.f, 0.f, 0.f};  // offset of the next level-1 block
  float e1[3] = {0.f, 0.f, 0.f};  // E of the next segment's first block
  float tin0[3] = {0.f, 0.f, 0.f};  // tail entering the next segment
  float best = -INFINITY;
  int best_bin = -1;
  float st[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int q0 = 0; q0 < n1; q0 += 32) {
    const int q = q0 + lane;
    const int j0 = q * kScanBlock;
    const int len = q < n1 ? min(kScanBlock, B - j0) : 0;
    float T[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kScanBlock; ++i) {
      if (i < len) {
        const float* x = hf + (int64_t)(B - 1 - j0 - i) * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k) T[k] = __fadd_rn(T[k], x[k]);
      }
    }
    float E[3] = {0.f, 0.f, 0.f};
    if (blocked0 && !blocked1) {  // one segment of <= 16 blocks
      for (int r = 0; r + 1 < n1; ++r) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float v = __shfl_sync(kAll, T[k], r);
          if (r < lane) E[k] = __fadd_rn(E[k], v);
        }
      }
    } else if (blocked1) {
      const int half = lane >> 4, lh = lane & 15;
      float w1[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float v = __shfl_sync(kAll, T[k], half * 16 + i);
          if (i <= lh) w1[k] = __fadd_rn(w1[k], v);
        }
      }
      // each half's total is the sum at its last block
      const int last0 = min(15, n1 - 1 - q0);
      const int last1 = min(15, n1 - 1 - q0 - 16);
      float off0[3], off1[3];  // the two halves' offsets
      float t1[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        off0[k] = e2[k];
        t1[k] = __shfl_sync(kAll, w1[k], last0);
      }
      upper.push(t1, off1);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        t1[k] = __shfl_sync(kAll, w1[k], 16 + max(last1, 0));
        e2[k] = off1[k];
      }
      if (last1 >= 0) upper.push(t1, e2);
      float incl1[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        incl1[k] = __fadd_rn(w1[k], half ? off1[k] : off0[k]);
        const float prev = __shfl_up_sync(kAll, incl1[k], 1);
        E[k] = lane ? prev : e1[k];
        e1[k] = __shfl_sync(kAll, incl1[k], 31);
      }
    }
    // the last prefix of each block, handed to the next block's first
    // element
    float tin[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float lastp = blocked0 ? __fadd_rn(T[k], E[k]) : T[k];
      const float prev = __shfl_up_sync(kAll, lastp, 1);
      tin[k] = lane ? prev : tin0[k];
      tin0[k] = __shfl_sync(kAll, lastp, 31);
    }
    float w[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kScanBlock; ++i) {
      if (i < len) {
        const int t = B - 1 - j0 - i;
        float tail[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          tail[k] = i == 0 ? tin[k] : (blocked0 ? __fadd_rn(w[k], E[k])
                                                : w[k]);
        const float hg = hf[t * 3 + 0], hh = hf[t * 3 + 1],
                    hc = hf[t * 3 + 2];
        float lg, lh, lc, rg, rh, rc;
        if (iscat) {
          lg = hg; lh = hh; lc = hc;
          rg = __fsub_rn(sg, hg); rh = __fsub_rn(sh, hh);
          rc = __fsub_rn(cnt, hc);
        } else {
          const float th_eps = __fadd_rn(tail[1], kEpsilon);
          rg = tail[0]; rh = th_eps; rc = tail[2];
          lg = __fsub_rn(sg, tail[0]); lh = __fsub_rn(sh, th_eps);
          lc = __fsub_rn(cnt, tail[2]);
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
        w[0] = __fadd_rn(w[0], hg);
        w[1] = __fadd_rn(w[1], hh);
        w[2] = __fadd_rn(w[2], hc);
      }
    }
  }
  float g = best;
  int b = best_bin;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float og = __shfl_xor_sync(kAll, g, o);
    const int ob = __shfl_xor_sync(kAll, b, o);
    if (og > g || (og == g && ob > b)) {
      g = og;
      b = ob;
    }
  }
  const unsigned own = __ballot_sync(kAll, b >= 0 && best_bin == b);
  const int src = own ? __ffs(own) - 1 : 0;
  float out[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float v = __shfl_sync(kAll, st[k], src);
    out[k] = own ? v : 0.f;
  }
  if (lane == 0) {
    sb[0] = g;
    sb[1] = (float)b;
    for (int k = 0; k < 6; ++k) sb[2 + k] = out[k];
  }
}

// Child c's [16] result row, won by feature fbest with its per-feature
// best sb [kPerFeature], or fbest = -1 when no feature has a valid split
// (then sb is not read).  Loads go through L2 only (__ldcg): the bests and
// the child's row may have been written by other blocks of the launch.
__device__ inline void winner_row(const float* hist, const float* sb,
                                  int fbest, const int* meta, int F, int B,
                                  int c, const Scal& p, float* out) {
  const float sg = p.sg[c], sh = p.sh[c], cnt = p.cnt[c];
  float row[16];
  for (int k = 0; k < 16; ++k) row[k] = 0.f;
  float st[6];
  if (fbest >= 0) {
    row[0] = __fsub_rn(__ldcg(sb), leaf_gain(sg, sh, p.l1, p.l2));
    row[1] = (float)fbest;
    row[2] = __ldcg(sb + 1);
    for (int k = 0; k < 6; ++k) st[k] = __ldcg(sb + 2 + k);
  } else {
    // no valid split: stats at (feature 0, bin B-1) like the plain version
    row[0] = -INFINITY;
    row[1] = -1.f;
    row[2] = 0.f;
    const float* h0 = hist + (int64_t)(B - 1) * 3;
    if (F > 0 && meta[2] > 0) {
      const float h[3] = {__ldcg(h0), __ldcg(h0 + 1), __ldcg(h0 + 2)};
      st[0] = h[0]; st[1] = h[1]; st[2] = h[2];
      st[3] = __fsub_rn(sg, h[0]); st[4] = __fsub_rn(sh, h[1]);
      st[5] = __fsub_rn(cnt, h[2]);
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

// The winner over the F per-feature bests `s_best` [F, kPerFeature] of
// child c, by one thread: the largest gain, the smallest feature among
// equal gains.  Writes the child's [16] result row.
__device__ inline void pick_winner(const float* hist, const float* s_best,
                                   const int* meta, int F, int B, int c,
                                   const Scal& p, float* out) {
  float best = -INFINITY;
  int fbest = -1;
  for (int f = 0; f < F; ++f) {
    if (s_best[f * kPerFeature] > best) {
      best = s_best[f * kPerFeature];
      fbest = f;
    }
  }
  winner_row(hist, s_best + (fbest >= 0 ? fbest : 0) * kPerFeature, fbest,
             meta, F, B, c, p, out);
}

// Cell i of a split's buffer rows, given the parent's and the smaller
// child's values there: the left child goes to rows[0] and the right to
// rows[1], the larger one being parent - small (elementwise f32).
__device__ __forceinline__ void store_children(float* const rows[2],
                                               int64_t i, float parent,
                                               float small,
                                               int small_is_left) {
  const float large = __fsub_rn(parent, small);
  rows[0][i] = small_is_left ? small : large;
  rows[1][i] = small_is_left ? large : small;
}

// store_children with the parent read at cell i.  `parent` may be rows[0]
// (the left child overwrites the parent in place): the thread that calls
// it for cell i reads the parent there and then writes both children, so
// no cell is read after another thread has written it.
__device__ __forceinline__ void write_children(const float* parent,
                                               float* const rows[2],
                                               int64_t i, float small,
                                               int small_is_left) {
  store_children(rows, i, parent[i], small, small_is_left);
}

}  // namespace lgbm
