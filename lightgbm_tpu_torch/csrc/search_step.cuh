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
//
// The search is templated on its float type T: T = float is K3/K4/K5/K8's
// code; T = double is K3-f64 (search.cu, hist_dtype=float64), the same
// scan, gains and pick with every add, subtraction, product and division
// in double (the __d*_rn forms of the __f*_rn intrinsics) and the double
// kEpsilon 1e-15, as the plain version (ops/split.py) and the JAX package
// compute in float64.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lgbm {

constexpr float kEpsilon = 1e-15f;
constexpr int kPerFeature = 8;  // gain, bin, lg, lh, lc, rg, rh, rc

// The search's arithmetic in its float type, correctly rounded.
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }
__device__ __forceinline__ float max_of(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_of(double a, double b) {
  return fmax(a, b);
}
// K_EPSILON in T: 1e-15f, or the double 1e-15 of the float64 search
__device__ __forceinline__ float epsilon_of(float) { return kEpsilon; }
__device__ __forceinline__ double epsilon_of(double) { return 1e-15; }
// -0 in T, from its bits: the plain version's -sign(0) (ops/split.py
// leaf_output), which a literal's negation need not keep
__device__ __forceinline__ float neg_zero(float) {
  return __int_as_float(0x80000000);
}
__device__ __forceinline__ double neg_zero(double) {
  return __longlong_as_double(0x8000000000000000LL);
}

constexpr int kScanBlock = 16;
constexpr int kMaxLevels = 5;  // 16^5 bins > any uint16 bin count

// Inclusive prefix sums of a stream of (g, h, c) triples, taken in the
// order of ops/split.py blocked_cumsum (the JAX package's jnp.cumsum
// order on the CPU): sequential within blocks of 16; block totals scanned
// the same way, one level up, while a level has more than 16 entries;
// each block offset by the exclusive prefix of the totals.  push() takes
// the next element and returns its inclusive prefix.
template <typename T>
struct BlockedScan3 {
  int nlev;
  int n[kMaxLevels];
  int cnt[kMaxLevels];
  T w[kMaxLevels][3];  // running sum inside the open block
  T e[kMaxLevels][3];  // exclusive prefix of the open block

  __device__ void init(int len) {
    nlev = 1;
    n[0] = len;
    while (n[nlev - 1] > kScanBlock && nlev < kMaxLevels) {
      n[nlev] = (n[nlev - 1] + kScanBlock - 1) / kScanBlock;
      ++nlev;
    }
    for (int l = 0; l < kMaxLevels; ++l) {
      cnt[l] = 0;
      for (int c = 0; c < 3; ++c) w[l][c] = e[l][c] = T(0);
    }
  }

  __device__ void push(const T in[3], T out[3]) {
    T v[3] = {in[0], in[1], in[2]};
    for (int l = 0; l < nlev; ++l) {
      const bool seq = n[l] <= kScanBlock;
      T p[3];
      for (int c = 0; c < 3; ++c) {
        w[l][c] = add_rn(w[l][c], v[c]);
        p[c] = seq ? w[l][c] : add_rn(w[l][c], e[l][c]);
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
        w[l][c] = T(0);
      }
    }
  }
};

template <typename T>
struct ScalT {
  T can[2], sg[2], sh[2], cnt[2];
  T min_data, min_hess, l1, l2, min_gain;
};
using Scal = ScalT<float>;

template <typename T>
inline ScalT<T> make_scal(T can_l, T lsg, T lsh, T lc, T can_r, T rsg, T rsh,
                          T rc, T min_data, T min_hess, T l1, T l2,
                          T min_gain) {
  ScalT<T> p;
  p.can[0] = can_l; p.sg[0] = lsg; p.sh[0] = lsh; p.cnt[0] = lc;
  p.can[1] = can_r; p.sg[1] = rsg; p.sh[1] = rsh; p.cnt[1] = rc;
  p.min_data = min_data; p.min_hess = min_hess;
  p.l1 = l1; p.l2 = l2; p.min_gain = min_gain;
  return p;
}

template <typename T>
__device__ __forceinline__ T leaf_gain(T g, T h, T l1, T l2) {
  const T reg = max_of(abs_of(g) - l1, T(0));
  return div_rn(mul_rn(reg, reg), add_rn(h, l2));
}

// -sign(g) * reg / (h + l2) as the plain version computes it: -sign(g)
// is -1, 1 or -0 (g = 0), so a zero gradient gives -0, as there
template <typename T>
__device__ __forceinline__ T leaf_out(T g, T h, T l1, T l2) {
  const T reg = max_of(abs_of(g) - l1, T(0));
  const T neg_sgn = (g > T(0)) ? T(-1) : ((g < T(0)) ? T(1) : neg_zero(g));
  return div_rn(mul_rn(neg_sgn, reg), add_rn(h, l2));
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
template <typename T>
__device__ inline void scan_feature_warp(const T* hist, const int* meta,
                                         int f, int B, int c,
                                         const ScalT<T>& p, T* sb) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool can = p.can[c] > T(0);
  const T sg = p.sg[c], sh = p.sh[c], cnt = p.cnt[c];
  const T min_gain_shift = add_rn(leaf_gain(sg, sh, p.l1, p.l2), p.min_gain);
  const bool fmask = meta[f * 4 + 0] > 0;
  const int nb = meta[f * 4 + 1];
  const bool iscat = meta[f * 4 + 2] > 0;
  const T* hf = hist + (int64_t)f * B * 3;
  const int n1 = (B + kScanBlock - 1) / kScanBlock;  // level-0 blocks
  const bool blocked0 = B > kScanBlock;   // level 0 offsets its blocks
  const bool blocked1 = n1 > kScanBlock;  // so does level 1
  BlockedScan3<T> upper;  // the levels above level 1 (B > 256)
  if (blocked1) upper.init((n1 + kScanBlock - 1) / kScanBlock);
  T e2[3] = {T(0), T(0), T(0)};  // offset of the next level-1 block
  T e1[3] = {T(0), T(0), T(0)};  // E of the next segment's first block
  T tin0[3] = {T(0), T(0), T(0)};  // tail entering the next segment
  T best = -INFINITY;
  int best_bin = -1;
  T st[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int q0 = 0; q0 < n1; q0 += 32) {
    const int q = q0 + lane;
    const int j0 = q * kScanBlock;
    const int len = q < n1 ? min(kScanBlock, B - j0) : 0;
    T Tq[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int i = 0; i < kScanBlock; ++i) {
      if (i < len) {
        const T* x = hf + (int64_t)(B - 1 - j0 - i) * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k) Tq[k] = add_rn(Tq[k], x[k]);
      }
    }
    T E[3] = {T(0), T(0), T(0)};
    if (blocked0 && !blocked1) {  // one segment of <= 16 blocks
      for (int r = 0; r + 1 < n1; ++r) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const T v = __shfl_sync(kAll, Tq[k], r);
          if (r < lane) E[k] = add_rn(E[k], v);
        }
      }
    } else if (blocked1) {
      const int half = lane >> 4, lh = lane & 15;
      T w1[3] = {T(0), T(0), T(0)};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const T v = __shfl_sync(kAll, Tq[k], half * 16 + i);
          if (i <= lh) w1[k] = add_rn(w1[k], v);
        }
      }
      // each half's total is the sum at its last block
      const int last0 = min(15, n1 - 1 - q0);
      const int last1 = min(15, n1 - 1 - q0 - 16);
      T off0[3], off1[3];  // the two halves' offsets
      T t1[3];
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
      T incl1[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        incl1[k] = add_rn(w1[k], half ? off1[k] : off0[k]);
        const T prev = __shfl_up_sync(kAll, incl1[k], 1);
        E[k] = lane ? prev : e1[k];
        e1[k] = __shfl_sync(kAll, incl1[k], 31);
      }
    }
    // the last prefix of each block, handed to the next block's first
    // element
    T tin[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const T lastp = blocked0 ? add_rn(Tq[k], E[k]) : Tq[k];
      const T prev = __shfl_up_sync(kAll, lastp, 1);
      tin[k] = lane ? prev : tin0[k];
      tin0[k] = __shfl_sync(kAll, lastp, 31);
    }
    T w[3] = {T(0), T(0), T(0)};
#pragma unroll
    for (int i = 0; i < kScanBlock; ++i) {
      if (i < len) {
        const int t = B - 1 - j0 - i;
        T tail[3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          tail[k] = i == 0 ? tin[k] : (blocked0 ? add_rn(w[k], E[k])
                                                : w[k]);
        const T hg = hf[t * 3 + 0], hh = hf[t * 3 + 1], hc = hf[t * 3 + 2];
        T lg, lh, lc, rg, rh, rc;
        if (iscat) {
          lg = hg; lh = hh; lc = hc;
          rg = sub_rn(sg, hg); rh = sub_rn(sh, hh);
          rc = sub_rn(cnt, hc);
        } else {
          const T th_eps = add_rn(tail[1], epsilon_of(T(0)));
          rg = tail[0]; rh = th_eps; rc = tail[2];
          lg = sub_rn(sg, tail[0]); lh = sub_rn(sh, th_eps);
          lc = sub_rn(cnt, tail[2]);
        }
        const bool in_range = fmask && (iscat ? (t < nb) : (t < nb - 1));
        const T gain = add_rn(leaf_gain(lg, lh, p.l1, p.l2),
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
        w[0] = add_rn(w[0], hg);
        w[1] = add_rn(w[1], hh);
        w[2] = add_rn(w[2], hc);
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
  T out[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const T v = __shfl_sync(kAll, st[k], src);
    out[k] = own ? v : T(0);
  }
  if (lane == 0) {
    sb[0] = g;
    sb[1] = (T)b;
    for (int k = 0; k < 6; ++k) sb[2 + k] = out[k];
  }
}

// Child c's [16] result row, won by feature fbest with its per-feature
// best sb [kPerFeature], or fbest = -1 when no feature has a valid split
// (then sb is not read).  Loads go through L2 only (__ldcg): the bests and
// the child's row may have been written by other blocks of the launch.
template <typename T>
__device__ inline void winner_row(const T* hist, const T* sb, int fbest,
                                  const int* meta, int F, int B, int c,
                                  const ScalT<T>& p, T* out) {
  const T sg = p.sg[c], sh = p.sh[c], cnt = p.cnt[c];
  const T eps = epsilon_of(T(0));
  T row[16];
  for (int k = 0; k < 16; ++k) row[k] = T(0);
  T st[6];
  if (fbest >= 0) {
    row[0] = sub_rn(__ldcg(sb), leaf_gain(sg, sh, p.l1, p.l2));
    row[1] = (T)fbest;
    row[2] = __ldcg(sb + 1);
    for (int k = 0; k < 6; ++k) st[k] = __ldcg(sb + 2 + k);
  } else {
    // no valid split: stats at (feature 0, bin B-1) like the plain version
    row[0] = -INFINITY;
    row[1] = T(-1);
    row[2] = T(0);
    const T* h0 = hist + (int64_t)(B - 1) * 3;
    if (F > 0 && meta[2] > 0) {
      const T h[3] = {__ldcg(h0), __ldcg(h0 + 1), __ldcg(h0 + 2)};
      st[0] = h[0]; st[1] = h[1]; st[2] = h[2];
      st[3] = sub_rn(sg, h[0]); st[4] = sub_rn(sh, h[1]);
      st[5] = sub_rn(cnt, h[2]);
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

// The winner over the F per-feature bests `s_best` [F, kPerFeature] of
// child c, by one thread: the largest gain, the smallest feature among
// equal gains.  Writes the child's [16] result row.  (K8 only: float.)
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

// store_children in double: the float64 step form (K3-f64's
// lgbm_search2_update_f64 / lgbm_search2_pool_f64), large = parent - small
// by __dsub_rn.
__device__ __forceinline__ void store_children(double* const rows[2],
                                               int64_t i, double parent,
                                               double small,
                                               int small_is_left) {
  const double large = __dsub_rn(parent, small);
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
