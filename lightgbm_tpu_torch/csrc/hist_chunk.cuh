// The histogram's chunk code, shared by the histogram kernels so that their
// sums cannot drift apart.  Every kernel cuts its rows into chunks of kChunk
// rows, builds one (chunk, feature) partial hist[B, 3] = (sum g*m, sum h*m,
// sum m) per chunk with each bin's rows added in row order from 0.f, and
// sums a cell's partials in chunk order (reduce_chunks).  The order of every
// sum depends only on the rows, never on the grid or the block size: the
// plain versions (ops/histogram.py) sum in the same order, bitwise.
//
// hist_sorted builds the partials of a group of G features.  The reader
// stages the chunk's masked stats once for the group and the group's bins
// (Rows::stage; every thread issues all its loads before it stores any),
// then, feature by feature, the block sorts the rows by bin, stably, in
// shared memory:
//  * rank: S warps own contiguous row segments and walk them 32 rows at a
//    time in row order.  Ballots, one per bit of the bin, give each lane
//    the lanes of equal bin among the 32 (the mask __match_any_sync would
//    give, built as CUB's radix rank builds it); a row's rank is the number
//    of those below its lane, and the lowest of them adds their number to
//    the warp's own row of an [S, R] int count table.  No atomics and no
//    shared cursor: every rank follows from the row order alone;
//  * scan: each bin's column becomes its warps' exclusive prefix, then an
//    inclusive scan over bins gives each bin's run; a row's slot is its
//    bin's start + its warp's prefix + its rank, and its three stats are
//    written there;
//  * sum: one thread per bin adds its run, which holds the bin's rows in
//    row order, from 0.f: each bin's rows in row order, the order of the
//    plain versions.  A bin that holds most of a chunk puts up to kChunk
//    additions on one thread.
// The table holds kTable ints: S = clamp(kTable / B, 1, warps) segments
// and R = min(B, kTable / S) bins a pass, so B > kTable runs ceil(B / R)
// passes over bin ranges with one segment.  An empty chunk writes zeros.
//
// sorted_partial_kernel is pass 1 of K1, K1' (histogram.cu), K1'' and K2
// (level_histogram.cu): block (c, g) builds chunk c's partials of features
// G*g .. G*g+G-1 with hist_sorted over one of three readers:
//  * SortedRows: feature-major bins [F, n] and three float rows, gathered
//    through a sorted order (K1'', K2; the identity for K2 over one leaf);
//  * MatrixRows: the same rows read in place (K1): each thread stages an
//    aligned 4-byte word of bins a load (4 u8 or 2 u16 bins), not one bin;
//  * WindowRows: a window of the packed record (K1'), whose G features are
//    whole record words or a part of one: each thread loads a row's word
//    once and unpacks the group's bins, and the stats come as bit patterns
//    from the record.
// Chunks gives each chunk's rows: a level's chunk table, or the single-leaf
// layout [c*kChunk, c*kChunk + kChunk).
//
// K8 (split_step.cu) calls hist_sorted inside its cooperative launch, one
// (chunk, group) item at a time, over a reader of its own (LeftWindowRows:
// the record window with each column's mask times its go flag), on the
// single-leaf layout from the window's begin.
//
// The float64 variants (hist_dtype=float64: K1-f64 in histogram.cu, K1''-f64
// in level_histogram.cu) sum the same float32 rows, staged unmasked, in
// double: each bin's rows in row order from 0.0, adding the exact products
// (double)g * (double)m, (double)h * (double)m and (double)m, in two
// levels: a chunk's partial, then groups of up to kGroupChunks consecutive
// chunks of a set (a leaf, for K1''-f64) from 0.0 in chunk order, then a
// set's groups from 0.0 in group order.  At most kGroupChunks chunks
// (16,384 rows) a set that is the float32 kernels' chunk order; above it
// the float64 sums change in their last bits.  Two pass-1 kernels keep it:
//  * hist_sorted with Acc = double (K1-f64 below kWalkMinChunks chunks,
//    histogram.cu): the bin sort above, each bin's run summed in double,
//    a partial a chunk, and the groups formed in pass 2;
//  * walk_partial_kernel, below (K1-f64 from kWalkMinChunks chunks,
//    K1''-f64): block (f, g) builds group g's partial of feature f.  Each
//    warp walks one chunk's rows 32 at a time in row order (kWalkAhead
//    batches loaded ahead); the lanes of equal bin are found with
//    __match_any_sync, and the lowest of them adds its own row, then the
//    others' in lane order, to the warp's own [R, 3] accumulator in
//    shared memory: no sort, no count table and no block barrier inside
//    the walk.  The block then adds its chunks' accumulators in chunk
//    order from 0.0 and writes one group partial, or the output itself
//    when the group is its leaf's only one; pass 2 adds a set's group
//    partials in group order.  R = min(B, kWalkBins) bins a pass: more
//    bins walk the chunk once per bin range.  The scratch is
//    ceil(rows / (kGroupChunks * kChunk)) group partials, an eighth of
//    one a chunk.
// The plain versions (ops/histogram.py, acc_dtype=float64, GROUP_CHUNKS)
// sum in the same two-level order, so they agree bitwise.  Acc = float
// instantiates exactly the float32 code.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbm {

constexpr int kChunk = 2048;  // rows staged per (chunk, feature) partial

constexpr int kTable = 4096;  // ints in hist_sorted's count table

// Dynamic shared memory of hist_sorted over G features of BinT bins.
template <typename BinT, int G>
constexpr int hist_sorted_smem() {
  return kChunk * (6 * (int)sizeof(float) + (int)sizeof(uint16_t)
                   + G * (int)sizeof(BinT))
         + (2 * kTable + 32) * (int)sizeof(int);
}

// Bins [0, nb) of the [S, stride] table `cnt`: each bin's column becomes
// its segments' exclusive prefix and incl[b] the rows of bins 0..b.  Every
// thread of the block must call it.
template <int kThreads>
__device__ inline void scan_table(int* cnt, int S, int stride, int nb,
                                  int* incl, int* s_warp) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (nb + kThreads - 1) / kThreads;
  const int lo = min(tid * per, nb), hi = min(lo + per, nb);
  int sum = 0;
  for (int b = lo; b < hi; ++b) {
    int run = 0;
    for (int w = 0; w < S; ++w) {
      const int c = cnt[w * stride + b];
      cnt[w * stride + b] = run;
      run += c;
    }
    incl[b] = run;
    sum += run;
  }
  int x = sum;  // inclusive scan of the threads' sums
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < kWarps ? s_warp[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < kWarps) s_warp[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (warp ? s_warp[warp - 1] : 0);
  for (int b = lo; b < hi; ++b) {
    run += incl[b];
    incl[b] = run;
  }
}

// The staging of hist_sorted: s_g/s_h/s_m[r] = the masked stats of
// position row0+r (kRaw: g and h unmasked, for the float64 sums) and
// s_bin[fl * kChunk + r] = its bin of feature f0+fl (fl < nf), r < nrows;
// every load of a thread is issued before its stores.  Gathered: position
// p is row rows.row(p).
template <typename BinT, int G, int kThreads, bool kRaw, typename Rows>
__device__ inline void stage_gathered(const Rows& rows, int64_t row0,
                                      int nrows, int f0, int nf, float* s_g,
                                      float* s_h, float* s_m, BinT* s_bin) {
  constexpr int kPer = kChunk / kThreads;  // rows a thread stages
  const int tid = threadIdx.x;
  int64_t row[kPer];
  float g[kPer], h[kPer], m[kPer];
  int bin[kPer][G];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = tid + k * kThreads;
    row[k] = r < nrows ? rows.row(row0 + r) : 0;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if (tid + k * kThreads < nrows) {
      m[k] = rows.m(row[k]);
      g[k] = rows.g(row[k]);
      h[k] = rows.h(row[k]);
#pragma unroll
      for (int fl = 0; fl < G; ++fl)
        bin[k][fl] = fl < nf ? rows.bin(f0 + fl, row[k]) : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = tid + k * kThreads;
    if (r < nrows) {
      if constexpr (kRaw) {
        s_g[r] = g[k];
        s_h[r] = h[k];
      } else {
        s_g[r] = g[k] * m[k];
        s_h[r] = h[k] * m[k];
      }
      s_m[r] = m[k];
#pragma unroll
      for (int fl = 0; fl < G; ++fl)
        if (fl < nf) s_bin[fl * kChunk + r] = (BinT)bin[k][fl];
    }
  }
}

// The same for rows row0 .. row0+nrows-1 of feature-major bins [F, n]
// read in place: the stats a float a load, the bins an aligned 4-byte word
// (kPack bins) a load, 2-9 % faster in K1 than a bin a load
// (tools/single_hist_variants.py, byte_stage).  A feature's first and last
// words may hold bins of the rows around the chunk, which are not staged.
template <typename BinT, int G, int kThreads, bool kRaw>
__device__ inline void stage_contiguous(const BinT* bins, const float* grad,
                                        const float* hess, const float* mask,
                                        int64_t n, int64_t row0, int nrows,
                                        int f0, int nf, float* s_g,
                                        float* s_h, float* s_m,
                                        BinT* s_bin) {
  constexpr int kPer = kChunk / kThreads;
  constexpr int kPack = 4 / (int)sizeof(BinT);  // bins a word
  constexpr int kBits = 8 * (int)sizeof(BinT);
  // a feature's chunk spans at most kChunk / kPack + 1 words
  constexpr int kWords = (kChunk / kPack + kThreads) / kThreads;
  const int tid = threadIdx.x;
  float g[kPer], h[kPer], m[kPer];
  unsigned w[G][kWords];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = tid + k * kThreads;
    if (r < nrows) {
      m[k] = mask[row0 + r];
      g[k] = grad[row0 + r];
      h[k] = hess[row0 + r];
    }
  }
#pragma unroll
  for (int fl = 0; fl < G; ++fl) {
    if (fl < nf) {
      const uintptr_t a = (uintptr_t)(bins + (int64_t)(f0 + fl) * n + row0);
      const unsigned* base =
          reinterpret_cast<const unsigned*>(a & ~(uintptr_t)3);
      const int nw = ((int)(a & 3) + nrows * (int)sizeof(BinT) + 3) >> 2;
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int wi = tid + i * kThreads;
        w[fl][i] = wi < nw ? base[wi] : 0u;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = tid + k * kThreads;
    if (r < nrows) {
      if constexpr (kRaw) {
        s_g[r] = g[k];
        s_h[r] = h[k];
      } else {
        s_g[r] = g[k] * m[k];
        s_h[r] = h[k] * m[k];
      }
      s_m[r] = m[k];
    }
  }
#pragma unroll
  for (int fl = 0; fl < G; ++fl) {
    if (fl < nf) {
      // bins of the word before the chunk's first row
      const int lead = (int)(((uintptr_t)(bins + (int64_t)(f0 + fl) * n
                                          + row0) & 3) / sizeof(BinT));
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        const int e = (tid + i * kThreads) * kPack - lead;
#pragma unroll
        for (int j = 0; j < kPack; ++j)
          if (e + j >= 0 && e + j < nrows)
            s_bin[fl * kChunk + e + j] = (BinT)(w[fl][i] >> (j * kBits));
      }
    }
  }
}

// Feature-major bins [F, n] and three float rows; sorted position p is row
// order[p] (the identity when order is null).
template <typename BinT>
struct SortedRows {
  const BinT* bins;
  const float* grad;
  const float* hess;
  const float* mask;
  const int64_t* order;
  int64_t n;
  __device__ int64_t row(int64_t p) const { return order ? order[p] : p; }
  __device__ int bin(int f, int64_t row) const {
    return (int)bins[(int64_t)f * n + row];
  }
  __device__ float g(int64_t row) const { return grad[row]; }
  __device__ float h(int64_t row) const { return hess[row]; }
  __device__ float m(int64_t row) const { return mask[row]; }
  template <int G, int kThreads, bool kRaw = false>
  __device__ void stage(int64_t row0, int nrows, int f0, int nf, float* s_g,
                        float* s_h, float* s_m, BinT* s_bin) const {
    stage_gathered<BinT, G, kThreads, kRaw>(*this, row0, nrows, f0, nf, s_g,
                                            s_h, s_m, s_bin);
  }
};

// Feature-major bins [F, n] and three float rows, read in place (K1).
template <typename BinT>
struct MatrixRows {
  const BinT* bins;
  const float* grad;
  const float* hess;
  const float* mask;
  int64_t n;
  template <int G, int kThreads, bool kRaw = false>
  __device__ void stage(int64_t row0, int nrows, int f0, int nf, float* s_g,
                        float* s_h, float* s_m, BinT* s_bin) const {
    stage_contiguous<BinT, G, kThreads, kRaw>(bins, grad, hess, mask, n,
                                              row0, nrows, f0, nf, s_g, s_h,
                                              s_m, s_bin);
  }
};

// Columns [begin, begin+cap) of the [W, ld] int32 record (ops/record.py),
// kPack = 4 / sizeof(BinT) bins a word (4 for u8 bins, 2 for u16), the
// features in words 0 .. wb-1 and the grad/hess/mask bit patterns in rows
// wb, wb+1, wb+2.  A group's G features are whole words or a part of one
// (G a multiple or a divisor of kPack, f0 a multiple of G), so a thread
// loads each word of a row once and unpacks the group's bins from it; a
// last word's unused fields are not staged.
template <typename BinT>
struct WindowRows {
  static constexpr int kPack = 4 / (int)sizeof(BinT);
  const int* rec;
  int64_t ld;
  int64_t begin;
  int wb;
  template <int G, int kThreads>
  __device__ void stage(int64_t row0, int nrows, int f0, int nf, float* s_g,
                        float* s_h, float* s_m, BinT* s_bin) const {
    static_assert(G % kPack == 0 || kPack % G == 0,
                  "a group must be whole record words or a part of one");
    constexpr int kPer = kChunk / kThreads;
    constexpr int kW = (G + kPack - 1) / kPack;  // words a row holds for it
    constexpr int kBits = 8 * (int)sizeof(BinT);
    const int tid = threadIdx.x;
    // the group's first word and its first field there (0 for whole words)
    const int w0 = f0 / kPack, i0 = kW == 1 ? f0 % kPack : 0;
    const int nw = (i0 + nf + kPack - 1) / kPack;
    const int* col = rec + begin + row0;
    float g[kPer], h[kPer], m[kPer];
    unsigned w[kPer][kW];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = tid + k * kThreads;
      if (r < nrows) {
        m[k] = __int_as_float(col[(int64_t)(wb + 2) * ld + r]);
        g[k] = __int_as_float(col[(int64_t)wb * ld + r]);
        h[k] = __int_as_float(col[(int64_t)(wb + 1) * ld + r]);
#pragma unroll
        for (int j = 0; j < kW; ++j)
          w[k][j] = j < nw ? (unsigned)col[(int64_t)(w0 + j) * ld + r] : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = tid + k * kThreads;
      if (r < nrows) {
        s_g[r] = g[k] * m[k];
        s_h[r] = h[k] * m[k];
        s_m[r] = m[k];
#pragma unroll
        for (int fl = 0; fl < G; ++fl) {
          const int at = i0 + fl;  // field of the group's words
          if (fl < nf)
            s_bin[fl * kChunk + r] = (BinT)(w[k][kW == 1 ? 0 : at / kPack]
                                            >> ((at % kPack) * kBits));
        }
      }
    }
  }
};

// out: the [nf, num_bins, 3] partials of features f0 .. f0+nf-1 (nf <= G)
// over sorted positions row0 .. row0+nrows-1 (nrows <= kChunk); `smem`
// holds hist_sorted_smem<BinT, G>() bytes; blockDim.x == kThreads.  Rows
// stages the rows (Rows::stage<G, kThreads>: s_g, s_h, s_m the masked
// stats and s_bin [G, kChunk] the bins, in row order).  Acc = double sums
// in float64 from unmasked staged stats (Rows::stage<G, kThreads, true>).
// Every thread of the block must call it.
template <typename BinT, int G, int kThreads, typename Rows, typename Acc>
__device__ inline void hist_sorted(const Rows& rows, int64_t row0,
                                   int nrows, int f0, int nf, int num_bins,
                                   Acc* __restrict__ out,
                                   unsigned char* smem) {
  constexpr bool kF64 = sizeof(Acc) == sizeof(double);
  constexpr int kWarps = kThreads / 32;
  static_assert(kChunk % kThreads == 0, "kThreads must divide kChunk");
  float* s_g = reinterpret_cast<float*>(smem);  // staged, in row order
  float* s_h = s_g + kChunk;
  float* s_m = s_h + kChunk;
  float* o_g = s_m + kChunk;  // sorted by bin
  float* o_h = o_g + kChunk;
  float* o_m = o_h + kChunk;
  int* cnt = reinterpret_cast<int*>(o_m + kChunk);  // [S, R]
  int* incl = cnt + kTable;                         // [R]
  int* s_warp = incl + kTable;                      // [32]
  uint16_t* s_rank = reinterpret_cast<uint16_t*>(s_warp + 32);  // [kChunk]
  BinT* s_bin = reinterpret_cast<BinT*>(s_rank + kChunk);       // [G, kChunk]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (nrows == 0) {
    for (int i = tid; i < nf * num_bins * 3; i += kThreads) out[i] = Acc(0);
    return;
  }
  const int S = max(1, min(kWarps, kTable / num_bins));
  const int R = min(num_bins, kTable / S);
  const int seg = (nrows + 32 * S - 1) / (32 * S) * 32;  // rows a segment

  if constexpr (kF64)
    rows.template stage<G, kThreads, true>(row0, nrows, f0, nf, s_g, s_h,
                                           s_m, s_bin);
  else
    rows.template stage<G, kThreads>(row0, nrows, f0, nf, s_g, s_h, s_m,
                                     s_bin);
  for (int i = tid; i < S * R; i += kThreads) cnt[i] = 0;
  __syncthreads();

  for (int fl = 0; fl < nf; ++fl) {
    const BinT* sb = s_bin + fl * kChunk;
    for (int b0 = 0; b0 < num_bins; b0 += R) {
      const int nb = min(R, num_bins - b0);
      const int bits = 32 - __clz(nb);  // key nb: a row outside the pass
      if (warp < S) {  // rank: segment `warp`, 32 rows at a time
        int* wcnt = cnt + warp * R;
        const int r1 = min((warp + 1) * seg, nrows);
        for (int base = warp * seg; base < r1; base += 32) {
          const int r = base + lane;
          int key = nb;
          if (r < r1) {
            const int b = (int)sb[r] - b0;
            if (b >= 0 && b < nb) key = b;
          }
          unsigned peers = 0xffffffffu;
          for (int i = 0; i < bits; ++i) {
            const int bit = (key >> i) & 1;
            const unsigned vote = __ballot_sync(0xffffffffu, bit);
            peers &= bit ? vote : ~vote;
          }
          const int leader = __ffs(peers) - 1;
          int before = 0;
          if (key < nb && lane == leader) {
            before = wcnt[key];
            wcnt[key] = before + __popc(peers);
          }
          before = __shfl_sync(0xffffffffu, before, leader);
          if (key < nb)
            s_rank[r] = (uint16_t)(before
                                   + __popc(peers & ((1u << lane) - 1u)));
          __syncwarp();  // this batch's counts before the next one reads
        }
      }
      __syncthreads();
      scan_table<kThreads>(cnt, S, R, nb, incl, s_warp);
      __syncthreads();
      for (int r = tid; r < nrows; r += kThreads) {  // scatter
        const int b = (int)sb[r] - b0;
        if (b >= 0 && b < nb) {
          const int slot = (b ? incl[b - 1] : 0) + cnt[(r / seg) * R + b]
                           + s_rank[r];
          o_g[slot] = s_g[r];
          o_h[slot] = s_h[r];
          o_m[slot] = s_m[r];
        }
      }
      __syncthreads();
      for (int b = tid; b < nb; b += kThreads) {  // sum each bin's run
        const int i1 = incl[b];
        Acc g = Acc(0), h = Acc(0), c = Acc(0);
        for (int i = b ? incl[b - 1] : 0; i < i1; ++i) {
          if constexpr (kF64) {  // exact products, summed in double
            const double m = o_m[i];
            g += (double)o_g[i] * m;
            h += (double)o_h[i] * m;
            c += m;
          } else {
            g += o_g[i];
            h += o_h[i];
            c += o_m[i];
          }
        }
        Acc* o = out + ((int64_t)fl * num_bins + b0 + b) * 3;
        o[0] = g;
        o[1] = h;
        o[2] = c;
      }
      for (int i = tid; i < S * R; i += kThreads) cnt[i] = 0;
      __syncthreads();
    }
  }
}

constexpr int kReduceLoads = 16;  // partials reduce_chunks loads at once

// Cell i of the histogram: the sum of its nchunks partials in chunk order,
// (0 + p_0) + p_1 + ..., in Acc (float, or double for the float64
// variants), with kReduceLoads loads issued before their adds.  The loads
// go through L2 only (__ldcg): K8 reads partials that other blocks wrote
// earlier in the same launch (after a grid barrier), where the read-only
// path (__ldg) is not coherent.
template <typename Acc>
__device__ __forceinline__ Acc reduce_chunks(const Acc* partial, int nchunks,
                                             int64_t per_chunk, int64_t i) {
  const Acc* p = partial + i;
  Acc s = Acc(0);
  int c = 0;
  for (; c + kReduceLoads <= nchunks; c += kReduceLoads) {
    Acc v[kReduceLoads];
#pragma unroll
    for (int j = 0; j < kReduceLoads; ++j)
      v[j] = __ldcg(p + (int64_t)(c + j) * per_chunk);
#pragma unroll
    for (int j = 0; j < kReduceLoads; ++j) s += v[j];
  }
  for (; c < nchunks; ++c) s += __ldcg(p + (int64_t)c * per_chunk);
  return s;
}

// Chunk c's first sorted position and row count, from a level's chunk
// table; without one, the single-leaf layout (rows [c*kChunk, c*kChunk +
// kChunk) of n).
struct Chunks {
  const int64_t* row0;
  const int64_t* rows;
  int64_t n;
  __device__ void get(int c, int64_t* r0, int* nr) const {
    if (row0 != nullptr) {
      *r0 = row0[c];
      *nr = (int)rows[c];
    } else {
      *r0 = (int64_t)c * kChunk;
      *nr = (n - *r0 < kChunk) ? (int)(n - *r0) : kChunk;
    }
  }
};

// Pass 1 of K1, K1', K1'' and K2 (Acc = float) and of K1-f64 below
// kWalkMinChunks chunks (Acc = double, histogram.cu): block (c, g) writes
// the partials [c, G*g .. G*g+G-1, B, 3] of [nchunks, F, B, 3].
template <typename BinT, int G, int kThreads, typename Rows, typename Acc>
__global__ void __launch_bounds__(kThreads)
    sorted_partial_kernel(Rows rows, Chunks chunks, int F, int num_bins,
                          Acc* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x, f0 = blockIdx.y * G;
  const int nf = (F - f0 < G) ? F - f0 : G;
  int64_t row0;
  int nrows;
  chunks.get(c, &row0, &nrows);
  hist_sorted<BinT, G, kThreads>(
      rows, row0, nrows, f0, nf, num_bins,
      partial + ((int64_t)c * F + f0) * num_bins * 3, smem);
}

// Launches pass 1 over `nchunks` chunks (> 0) of F features (> 0) on `s`;
// returns 0 or a CUDA error.
template <typename BinT, int G, int kThreads, typename Rows, typename Acc>
inline int launch_sorted_partial(const Rows& rows, const Chunks& chunks, int F,
                          int nchunks, int num_bins, Acc* partial,
                          cudaStream_t s) {
  const int groups = (F + G - 1) / G;
  if (groups > 65535) return (int)cudaErrorInvalidValue;
  const int smem = hist_sorted_smem<BinT, G>();
  const cudaError_t e = cudaFuncSetAttribute(
      sorted_partial_kernel<BinT, G, kThreads, Rows, Acc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  sorted_partial_kernel<BinT, G, kThreads, Rows, Acc>
      <<<dim3(nchunks, groups), kThreads, smem, s>>>(rows, chunks, F,
                                                     num_bins, partial);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The float64 pass 1 (K1-f64, K1''-f64): ordered warp walks, a group of
// chunks a block (the header comment above).

constexpr int kGroupChunks = 8;    // chunks a group partial sums (K)
constexpr int kWalkThreads = 32 * kGroupChunks;  // one warp a chunk
constexpr int kWalkBins = 1024;    // bins a warp's accumulator holds
constexpr int kWalkAhead = 4;      // batches a lane loads ahead (float stats)

// Dynamic shared memory of a walk block over R bins a pass: each warp's
// [R, 3] accumulator and its [3, 32] batch of products.
template <typename Acc>
constexpr int walk_smem(int R) {
  return kGroupChunks * (R * 3 + 3 * 32) * (int)sizeof(Acc);
}

// The rows of a walk.  WalkMatrix (K1-f64): feature-major bins [F, n]
// and float32 g, h, m of row p, read in place, whose products the walk
// takes.  WalkSorted (K1''-f64): the bins of row order[p] and, at sorted
// position p, the products g*m, h*m, m themselves (sorted_products_kernel
// in level_histogram.cu gathers them once for every feature).
template <typename BinT>
struct WalkMatrix {
  using Stat = float;
  const BinT* bins;
  int64_t n;
  const float* g;
  const float* h;
  const float* m;
  __device__ int64_t row(int64_t p) const { return p; }
};

template <typename BinT>
struct WalkSorted {
  using Stat = double;
  const BinT* bins;
  int64_t n;
  const double* g;
  const double* h;
  const double* m;
  const int64_t* order;
  __device__ int64_t row(int64_t p) const { return order[p]; }
};

// The groups of a walk: group g is sorted positions [row0, row0 + rows),
// rows <= kGroupChunks * kChunk, of leaf `leaf`.  From a level's group
// table (ops/histogram.level_layout; group_start [L+1] each leaf's first
// group) or, without one, the single-leaf layout of n rows (ngroups groups
// of leaf 0).  A leaf of one group takes its partial as its output.
struct WalkGroups {
  const int64_t* row0;
  const int64_t* rows;
  const int64_t* leaf;
  const int64_t* group_start;
  int64_t n;
  int ngroups;
  __device__ void get(int g, int64_t* r0, int* nr) const {
    constexpr int64_t kSpan = (int64_t)kGroupChunks * kChunk;
    if (row0 != nullptr) {
      *r0 = row0[g];
      *nr = (int)rows[g];
    } else {
      *r0 = (int64_t)g * kSpan;
      *nr = (int)(n - *r0 < kSpan ? n - *r0 : kSpan);
    }
  }
  // (the group's leaf, whether it is the leaf's only group) of a group
  // that holds rows
  __device__ void dest(int g, int64_t* l, bool* only) const {
    if (row0 != nullptr) {
      *l = leaf[g];
      *only = group_start[*l + 1] - group_start[*l] == 1;
    } else {
      *l = 0;
      *only = ngroups == 1;
    }
  }
};

// The lanes of the warp whose key equals this lane's (key in [-1, nb)).
__device__ __forceinline__ unsigned walk_peers(int key) {
  return __match_any_sync(0xffffffffu, key);
}

// Lane `lane`'s row of batch j of a chunk of cr rows from sorted position
// c0: its bin of feature f (-1 past the chunk) and stats.
template <typename Rows, typename Stat>
__device__ __forceinline__ void walk_fetch(const Rows& rows, int64_t c0,
                                           int cr, int f, int j, int lane,
                                           int* bin, Stat* g, Stat* h,
                                           Stat* m) {
  const int r = j * 32 + lane;
  if (r < cr) {
    const int64_t p = c0 + r;
    *bin = (int)rows.bins[(int64_t)f * rows.n + rows.row(p)];
    *g = rows.g[p];
    *h = rows.h[p];
    *m = rows.m[p];
  } else {
    *bin = -1;
    *g = *h = *m = Stat(0);
  }
}

// One warp: bins [b0, b0+nb) of feature f over the chunk of cr rows from
// sorted position c0, added to acc [nb, 3] (zeroed by the caller): each
// batch of 32 rows in row order; the lowest lane of each bin adds its own
// row, then the others' from `st` (the warp's [3, 32] staging, written by
// those lanes) in lane order, four loads at a time (a missing one adds
// +0.0, which leaves a sum from 0 unchanged: such a sum is never -0.0).
// A lane loads its rows kAhead batches ahead.  With Acc = float (F1,
// forest.cu) the products are float32's, K1's staged g * m and h * m, and
// a bin's sum from 0.f is K1's partial bitwise.
template <typename Rows, typename Acc>
__device__ inline void walk_chunk(const Rows& rows, int64_t c0, int cr,
                                  int f, int b0, int nb,
                                  Acc* __restrict__ acc, Acc* st) {
  using Stat = typename Rows::Stat;
  constexpr int kAhead = kWalkAhead * 4 / (int)sizeof(Stat);
  const int lane = threadIdx.x & 31;
  const int nbatch = (cr + 31) / 32;
  int kb[kAhead];
  Stat kg[kAhead], kh[kAhead], km[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a)
    walk_fetch(rows, c0, cr, f, a, lane, &kb[a], &kg[a], &kh[a], &km[a]);
  for (int j0 = 0; j0 < nbatch; j0 += kAhead) {
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (j0 + a >= nbatch) break;  // the same for every lane
      const int b = kb[a] - b0;
      const int key = b >= 0 && b < nb ? b : -1;
      Acc vg, vh, vm;
      if constexpr (sizeof(Stat) == sizeof(float)) {  // exact in double
        vg = (Acc)kg[a] * (Acc)km[a];
        vh = (Acc)kh[a] * (Acc)km[a];
        vm = (Acc)km[a];
      } else {
        vg = kg[a];
        vh = kh[a];
        vm = km[a];
      }
      walk_fetch(rows, c0, cr, f, j0 + a + kAhead, lane, &kb[a], &kg[a],
                 &kh[a], &km[a]);
      const unsigned peers = walk_peers(key);
      const int leader = __ffs(peers) - 1;
      if (key >= 0 && lane != leader) {
        st[lane] = vg;
        st[32 + lane] = vh;
        st[64 + lane] = vm;
      }
      __syncwarp();
      if (key >= 0 && lane == leader) {
        Acc* a3 = acc + key * 3;
        Acc sg = a3[0] + vg, sh = a3[1] + vh, sm = a3[2] + vm;
        for (unsigned p = peers & (peers - 1); p != 0;) {
          int i[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            i[k] = p ? __ffs(p) - 1 : -1;
            p &= p - 1;
          }
          Acc xg[4], xh[4], xm[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            xg[k] = i[k] >= 0 ? st[i[k]] : Acc(0);
            xh[k] = i[k] >= 0 ? st[32 + i[k]] : Acc(0);
            xm[k] = i[k] >= 0 ? st[64 + i[k]] : Acc(0);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            sg += xg[k];
            sh += xh[k];
            sm += xm[k];
          }
        }
        a3[0] = sg;
        a3[1] = sh;
        a3[2] = sm;
      }
      __syncwarp();  // the adds before the next batch's staging
    }
  }
}

// Pass 1 of K1-f64 and K1''-f64: block (f, g) writes group g's [B, 3]
// partial of feature f (row g of [ngroups, F, B, 3] `partial`, or its
// leaf's row of [L, F, B, 3] `out` when the group is the leaf's only one):
// warp w walks the group's chunk w into its own accumulator, then the
// block adds the chunks' accumulators in chunk order from 0.  A group of
// no rows (an empty leaf's, the table's unused tail) writes nothing.  R
// bins a pass (R <= kWalkBins).
template <typename Rows, typename Acc>
__global__ void __launch_bounds__(kWalkThreads)
    walk_partial_kernel(Rows rows, WalkGroups groups, int F,
                        int num_bins, int R, Acc* __restrict__ partial,
                        Acc* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int f = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  int64_t row0;
  int nrows;
  groups.get(g, &row0, &nrows);
  if (nrows == 0) return;
  int64_t leaf;
  bool only;
  groups.dest(g, &leaf, &only);
  Acc* dst = (only ? out + leaf * F * (int64_t)num_bins * 3
                   : partial + (int64_t)g * F * num_bins * 3)
             + (int64_t)f * num_bins * 3;
  Acc* acc = reinterpret_cast<Acc*>(smem);  // [kGroupChunks, R, 3]
  Acc* mine = acc + warp * R * 3;
  Acc* st = acc + kGroupChunks * R * 3 + warp * 96;
  const int nch = (nrows + kChunk - 1) / kChunk;
  const int cr = warp < nch ? min(kChunk, nrows - warp * kChunk) : 0;
  for (int b0 = 0; b0 < num_bins; b0 += R) {
    const int nb = min(R, num_bins - b0);
    for (int i = tid & 31; i < nb * 3; i += 32) mine[i] = Acc(0);
    __syncwarp();
    if (cr > 0)
      walk_chunk(rows, row0 + (int64_t)warp * kChunk, cr, f, b0, nb, mine,
                 st);
    __syncthreads();
    for (int i = tid; i < nb * 3; i += kWalkThreads) {
      Acc s = Acc(0);
      for (int w = 0; w < nch; ++w) s += acc[w * R * 3 + i];
      dst[b0 * 3 + i] = s;
    }
    __syncthreads();
  }
}

// Launches the walk over `ngroups` groups (> 0) of F features (> 0) on `s`;
// returns 0 or a CUDA error.
template <typename Rows, typename Acc>
inline int launch_walk(const Rows& rows, const WalkGroups& groups, int F,
                       int ngroups, int num_bins, Acc* partial, Acc* out,
                       cudaStream_t s) {
  if (ngroups > 65535) return (int)cudaErrorInvalidValue;
  const int R = num_bins < kWalkBins ? num_bins : kWalkBins;
  const int smem = walk_smem<Acc>(R);
  const cudaError_t e = cudaFuncSetAttribute(
      walk_partial_kernel<Rows, Acc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  walk_partial_kernel<Rows, Acc>
      <<<dim3(F, ngroups), kWalkThreads, smem, s>>>(rows, groups, F,
                                                    num_bins, R, partial, out);
  return (int)cudaGetLastError();
}

}  // namespace lgbm
