// Kernel S1: the level histogram of a sparse dataset from its binned CSR
// entries, hist[L, F, B, 3] = (sum g*m, sum h*m, sum m) per (leaf, feature,
// bin).
//
// Replaces lightgbm_tpu/ops/sparse_hist.py:45 sparse_histogram_by_leaf, a
// jnp segment_sum over the stored entries plus a per-(leaf, feature)
// remainder at each feature's default bin (no pl.pallas_call: on the card a
// segment sum would be an atomic scatter, whose float order changes from
// run to run).  S1 uses no float atomics; every sum has a fixed order, the
// order of its plain version (ops/sparse_hist.py
// sparse_histogram_by_leaf_plain), so the two agree bitwise.  One C entry
// launches, on the current stream:
//
//  * s1_stored_kernel, one block per segment of one feature's entries (the
//    entries regrouped by feature at dataset construction, rows
//    ascending; ops/sparse_hist.segment_table): the block zeroes its
//    destination (the output's [L, B, 3] cells of the feature when it has
//    one segment, else its slab), then takes its entries a chunk at a
//    time, orders each chunk's entries by key leaf(row)*B + bin, stably,
//    in shared memory (counting-sort passes), and
//    one thread a run of equal keys adds the run's stats to its cell one
//    by one, in row order.  Chunks follow one another after a barrier, so
//    each cell is the segment's entries summed in row order from 0.  A
//    segment holds 4,096 entries for 2-16 bins, up to 65,536 for 256
//    (ops/sparse_hist.segment_entries): short segments cut a cell's serial
//    chain where few keys exist (one-hot data near the root), long ones
//    the slabs' memory where many do;
//  * s1_fold_kernel: for a feature of several segments, each cell is its
//    slabs added in segment order from 0;
//  * s1_leaf_partial_kernel / s1_leaf_total_kernel: each leaf's total, the
//    rows of each 2048-row chunk in row order, the chunk sums in chunk
//    order;
//  * s1_remainder_kernel, one thread per (leaf, feature): the stored sum
//    (bins in order from 0), then cell[default bin] += total - stored.
//
// Bound: bytes.  Each input is read once: the nnz entries (row i32 and the
// bin), leaf_id, g, h and mask of n rows; the output is written once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_chunk.cuh"

namespace {

constexpr int kThreads = 256;      // s1_stored_kernel's block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;       // entries ordered at a time
constexpr int kKeys = 1536;        // ints of the count table (46 KB in all)
constexpr int kDigitBits = 8;      // a pass's digit where L*B > kKeys
constexpr int kRowChunk = 2048;    // rows per leaf-total chunk (ROW_CHUNK)
constexpr int kLeafThreads = 256;  // s1_leaf_partial_kernel's block

// The stored sums of one segment.  A chunk of kChunk entries at a time is
// ordered by key leaf*B + bin, stably, in shared memory by counting-sort
// passes: one pass over every key where the count table holds the L*B
// keys (one-hot data: L*B <= 2L), else one pass a kDigitBits digit,
// least significant first.  In a pass S warps own contiguous parts of
// the chunk and walk them 32 entries at a time in row order;
// __match_any_sync gives each lane the lanes of equal digit, a lane's
// rank is the number of those below it, and the lowest adds their number
// to its warp's row of an [S, digits] count table (no atomics: every rank
// follows from the order).  The table's scan (hist_chunk.cuh scan_table)
// gives each digit's run and each warp's offset in it, and the keys and
// stats move there.  Then one thread a run of equal keys adds the run's
// stats to its cell one by one, in row order.
template <typename BinT>
__global__ void __launch_bounds__(kThreads)
s1_stored_kernel(const int32_t* __restrict__ crow,
                 const BinT* __restrict__ cbin,
                 const int64_t* __restrict__ seg_feat,
                 const int64_t* __restrict__ seg_begin,
                 const int64_t* __restrict__ seg_end,
                 const int64_t* __restrict__ seg_slot,
                 const int32_t* __restrict__ leaf_id,
                 const float* __restrict__ g, const float* __restrict__ h,
                 const float* __restrict__ m, int L, int F, int B,
                 float* __restrict__ out, float* __restrict__ slabs) {
  // copy c of the keys is keys[c * kChunk ...], of the stats st[c * 3 *
  // kChunk ...] (g, h, m rows): a pass reads one copy, writes the other
  __shared__ int keys[2 * kChunk];
  __shared__ float st[6 * kChunk];
  __shared__ int cnt[kKeys], incl[kKeys], s_warp[32];
  __shared__ uint16_t s_rank[kChunk];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t s = blockIdx.x;
  const int64_t f = seg_feat[s], slot = seg_slot[s];
  const int64_t begin = seg_begin[s], end = seg_end[s];
  float* dst;
  int64_t lstride;
  if (slot < 0) {
    dst = out + f * (int64_t)B * 3;
    lstride = (int64_t)F * B * 3;
  } else {
    dst = slabs + slot * (int64_t)L * B * 3;
    lstride = (int64_t)B * 3;
  }
  const int R = L * B;
  for (int i = tid; i < R; i += kThreads) {
    float* c = dst + (i / B) * lstride + (i % B) * 3;
    c[0] = 0.f;
    c[1] = 0.f;
    c[2] = 0.f;
  }
  const bool one = R <= kKeys;
  const int nd = one ? R : 1 << kDigitBits;  // digits a pass
  const int S = max(1, min(kWarps, kKeys / nd));
  const int passes =
      one ? 1 : (32 - __clz(R - 1) + kDigitBits - 1) / kDigitBits;
  for (int64_t base = begin; base < end; base += kChunk) {
    const int cnt_e = (int)min((int64_t)kChunk, end - base);
    for (int k = tid; k < cnt_e; k += kThreads) {
      const int64_t r = crow[base + k];
      const float mr = m[r];
      keys[k] = leaf_id[r] * B + (int)cbin[base + k];
      st[k] = g[r] * mr;
      st[kChunk + k] = h[r] * mr;
      st[2 * kChunk + k] = mr;
    }
    int cur = 0;  // the copy holding the keys in their current order
    const int part = (cnt_e + 32 * S - 1) / (32 * S) * 32;  // a warp's
    for (int p = 0; p < passes; ++p) {
      const int shift = p * kDigitBits;
      const int* src_k = keys + cur * kChunk;
      const float* src_s = st + cur * 3 * kChunk;
      int* dst_k = keys + (1 - cur) * kChunk;
      float* dst_s = st + (1 - cur) * 3 * kChunk;
      for (int i = tid; i < S * nd; i += kThreads) cnt[i] = 0;
      __syncthreads();
      if (warp < S) {
        int* wcnt = cnt + warp * nd;
        const int r1 = min((warp + 1) * part, cnt_e);
        for (int b0 = warp * part; b0 < r1; b0 += 32) {
          const int r = b0 + lane;
          const int d = r >= r1 ? nd  // nd: no entry
                        : one ? src_k[r] : (src_k[r] >> shift) & (nd - 1);
          const unsigned peers = __match_any_sync(0xffffffffu, d);
          const int leader = __ffs(peers) - 1;
          int before = 0;
          if (d < nd && lane == leader) {
            before = wcnt[d];
            wcnt[d] = before + __popc(peers);
          }
          before = __shfl_sync(0xffffffffu, before, leader);
          if (d < nd)
            s_rank[r] = (uint16_t)(before
                                   + __popc(peers & ((1u << lane) - 1u)));
          __syncwarp();
        }
      }
      __syncthreads();
      lgbm::scan_table<kThreads>(cnt, S, nd, nd, incl, s_warp);
      __syncthreads();
      for (int r = tid; r < cnt_e; r += kThreads) {
        const int key = src_k[r];
        const int d = one ? key : (key >> shift) & (nd - 1);
        const int at = (d ? incl[d - 1] : 0) + cnt[(r / part) * nd + d]
                       + s_rank[r];
        if (!one) dst_k[at] = key;  // one pass: the walk reads the scan
        dst_s[at] = src_s[r];
        dst_s[kChunk + at] = src_s[kChunk + r];
        dst_s[2 * kChunk + at] = src_s[2 * kChunk + r];
      }
      __syncthreads();
      cur = 1 - cur;
    }
    // each key's run [lo, hi): from the one pass's scan (a thread a key),
    // else from the sorted keys (a thread a run's first entry); its bounds
    // known before the walk, whose loads then run ahead of the adds
    const int* sk = keys + cur * kChunk;
    const float* ss = st + cur * 3 * kChunk;
    for (int t = tid; t < (one ? R : cnt_e); t += kThreads) {
      int key = t, lo, hi;
      if (one) {
        lo = t ? incl[t - 1] : 0;
        hi = incl[t];
      } else {
        key = sk[t];
        if (t && sk[t - 1] == key) continue;
        lo = t;
        for (hi = t + 1; hi < cnt_e && sk[hi] == key;) ++hi;
      }
      if (hi == lo) continue;
      float* c = dst + (int64_t)(key / B) * lstride + (key % B) * 3;
      float a0 = c[0], a1 = c[1], a2 = c[2];
      for (int q = lo; q < hi; ++q) {
        a0 = a0 + ss[q];
        a1 = a1 + ss[kChunk + q];
        a2 = a2 + ss[2 * kChunk + q];
      }
      c[0] = a0;
      c[1] = a1;
      c[2] = a2;
    }
    __syncthreads();
  }
}

// One thread per (feature of several segments, leaf, bin, channel).
__global__ void s1_fold_kernel(const int64_t* __restrict__ fold_feat,
                               const int64_t* __restrict__ fold_slot,
                               const int64_t* __restrict__ fold_nseg,
                               int nfold, int L, int F, int B,
                               const float* __restrict__ slabs,
                               float* __restrict__ out) {
  const int64_t per = (int64_t)L * B * 3;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)nfold * per) return;
  const int64_t j = i / per, cell = i % per;  // cell = (l*B + b)*3 + c
  const int64_t l = cell / ((int64_t)B * 3), rest = cell % ((int64_t)B * 3);
  const float* src = slabs + fold_slot[j] * per + cell;
  float acc = 0.f;
  for (int64_t t = 0; t < fold_nseg[j]; ++t) acc = acc + src[t * per];
  out[(l * F + fold_feat[j]) * B * 3 + rest] = acc;
}

// Block c: the per-leaf sums of rows [c*kRowChunk, (c+1)*kRowChunk).
__global__ void __launch_bounds__(kLeafThreads)
s1_leaf_partial_kernel(const int32_t* __restrict__ leaf_id,
                       const float* __restrict__ g,
                       const float* __restrict__ h,
                       const float* __restrict__ m, int64_t n, int L,
                       float* __restrict__ part) {
  __shared__ int s_leaf[kRowChunk];
  __shared__ float s_g[kRowChunk], s_h[kRowChunk], s_m[kRowChunk];
  const int64_t row0 = (int64_t)blockIdx.x * kRowChunk;
  const int cnt = (int)min((int64_t)kRowChunk, n - row0);
  for (int k = threadIdx.x; k < cnt; k += kLeafThreads) {
    const float mr = m[row0 + k];
    s_leaf[k] = leaf_id[row0 + k];
    s_g[k] = g[row0 + k] * mr;
    s_h[k] = h[row0 + k] * mr;
    s_m[k] = mr;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += kLeafThreads) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < cnt; ++k) {
      if (s_leaf[k] == l) {
        a0 = a0 + s_g[k];
        a1 = a1 + s_h[k];
        a2 = a2 + s_m[k];
      }
    }
    float* p = part + ((int64_t)blockIdx.x * L + l) * 3;
    p[0] = a0;
    p[1] = a1;
    p[2] = a2;
  }
}

// One thread per (leaf, channel): the chunk sums in chunk order from 0.
__global__ void s1_leaf_total_kernel(const float* __restrict__ part,
                                     int nchunks, int L,
                                     float* __restrict__ tot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L * 3) return;
  float acc = 0.f;
  for (int c = 0; c < nchunks; ++c) acc = acc + part[(int64_t)c * L * 3 + i];
  tot[i] = acc;
}

// One thread per (leaf, feature).
__global__ void s1_remainder_kernel(const float* __restrict__ tot,
                                    const int32_t* __restrict__ default_bins,
                                    int L, int F, int B,
                                    float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)L * F) return;
  const int64_t l = i / F;
  float* cell = out + i * B * 3;  // out[l, f, :, :]
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int b = 0; b < B; ++b) {
    s0 = s0 + cell[b * 3];
    s1 = s1 + cell[b * 3 + 1];
    s2 = s2 + cell[b * 3 + 2];
  }
  float* d = cell + default_bins[i % F] * 3;
  d[0] = d[0] + (tot[l * 3] - s0);
  d[1] = d[1] + (tot[l * 3 + 1] - s1);
  d[2] = d[2] + (tot[l * 3 + 2] - s2);
}

template <typename BinT>
int launch_stored(const void* crow, const void* cbin, const void* seg_feat,
                  const void* seg_begin, const void* seg_end,
                  const void* seg_slot, int64_t nseg, const void* leaf_id,
                  const float* g, const float* h, const float* m, int L,
                  int F, int B, float* out, float* slabs,
                  cudaStream_t stream) {
  s1_stored_kernel<BinT><<<(unsigned)nseg, kThreads, 0, stream>>>(
      (const int32_t*)crow, (const BinT*)cbin, (const int64_t*)seg_feat,
      (const int64_t*)seg_begin, (const int64_t*)seg_end,
      (const int64_t*)seg_slot, (const int32_t*)leaf_id, g, h, m, L, F, B,
      out, slabs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The whole level histogram: out [L, F, B, 3]; scratch: slabs [num_slots,
// L, B, 3], part [ceil(n / 2048), L, 3], tot [L, 3].  Returns the first
// launch error, 0 when every launch was accepted.
int lgbm_sparse_hist(const void* crow, const void* cbin, int bin_bytes,
                     const void* seg_feat, const void* seg_begin,
                     const void* seg_end, const void* seg_slot, int64_t nseg,
                     const void* fold_feat, const void* fold_slot,
                     const void* fold_nseg, int nfold,
                     const void* default_bins, const void* leaf_id,
                     const void* g, const void* h, const void* m, int64_t n,
                     int L, int F, int B, void* slabs, void* part, void* tot,
                     void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const float *gf = (const float*)g, *hf = (const float*)h,
              *mf = (const float*)m;
  float* o = (float*)out;
  int code = bin_bytes == 1
                 ? launch_stored<uint8_t>(crow, cbin, seg_feat, seg_begin,
                                          seg_end, seg_slot, nseg, leaf_id, gf,
                                          hf, mf, L, F, B, o, (float*)slabs,
                                          stream)
                 : launch_stored<uint16_t>(crow, cbin, seg_feat, seg_begin,
                                           seg_end, seg_slot, nseg, leaf_id,
                                           gf, hf, mf, L, F, B, o,
                                           (float*)slabs, stream);
  if (code) return code;
  if (nfold > 0) {
    const int64_t total = (int64_t)nfold * L * B * 3;
    s1_fold_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
        (const int64_t*)fold_feat, (const int64_t*)fold_slot,
        (const int64_t*)fold_nseg, nfold, L, F, B, (const float*)slabs, o);
    if ((code = (int)cudaGetLastError())) return code;
  }
  const int nchunks = (int)((n + kRowChunk - 1) / kRowChunk);
  if (nchunks > 0) {
    s1_leaf_partial_kernel<<<nchunks, kLeafThreads, 0, stream>>>(
        (const int32_t*)leaf_id, gf, hf, mf, n, L, (float*)part);
    if ((code = (int)cudaGetLastError())) return code;
  }
  s1_leaf_total_kernel<<<(L * 3 + 255) / 256, 256, 0, stream>>>(
      (const float*)part, nchunks, L, (float*)tot);
  if ((code = (int)cudaGetLastError())) return code;
  const int64_t lf = (int64_t)L * F;
  s1_remainder_kernel<<<(unsigned)((lf + 255) / 256), 256, 0, stream>>>(
      (const float*)tot, (const int32_t*)default_bins, L, F, B, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
