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
// in level_histogram.cu) are the same code with Acc = double: the rows are
// staged as float32, as in K1, but unmasked (Rows::stage<G, kThreads,
// true>), so shared memory and row bytes are K1's; each bin's run adds
// (double)g * (double)m, (double)h * (double)m and (double)m in row order
// from 0.0 (every product of two floats is exact in double), and the
// partials, their chunk-order sum and the output are double.  The plain
// versions (ops/histogram.py, acc_dtype=float64) widen the row stats before
// the product and sum in the same order, so they agree bitwise.  Acc =
// float instantiates exactly the float32 code.

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

// Pass 1 of K1, K1', K1'' and K2 (Acc = float) and of K1-f64 and K1''-f64
// (Acc = double): block (c, g) writes the partials [c, G*g .. G*g+G-1, B,
// 3] of [nchunks, F, B, 3].
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

}  // namespace lgbm
