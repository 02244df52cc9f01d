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
//  * s1_rows_kernel, one block per 2048-row chunk: each row's 16-byte
//    record (leaf, g*m, h*m, m), so that an entry gathers one aligned
//    record and not four scattered words, and the chunk's per-leaf sums,
//    rows in order;
//  * s1_leaf_total_kernel: each leaf's total, the chunk sums in chunk
//    order;
//  * s1_stored_kernel, one block per (segment, leaf tile): a segment is a
//    fixed cut of one feature's entries (regrouped by feature at dataset
//    construction, rows ascending; ops/sparse_hist.segment_table), a leaf
//    tile the leaves whose [Lt, B, 3] cells fit in shared memory
//    (ops/cuda_sparse_hist.leaf_tiles: every leaf at once up to 16 x 255
//    bins, two tiles at 128 x 255).  The block zeroes its cells in shared
//    memory and adds every entry of the segment whose row lies in the tile,
//    each cell's entries in row order (below).  A feature of one segment
//    then takes its remainder in the same block: per (leaf, channel) the
//    stored sum, bins in order from 0, and cell[default bin] += total -
//    stored; the block writes its cells to the output once, coalesced.  A
//    segment of a feature of several writes its cells to its slab;
//  * s1_fold_kernel, one block per (feature of several segments, leaf
//    tile): each cell is its slabs added in segment order from 0, then the
//    remainder as above, and one coalesced write.
//
// Order inside s1_stored_kernel, without float atomics or a sort by key:
// each of the block's 256 threads owns the cells of the keys whose (leaf +
// bin) mod 256 is its index.  The entries come kChunk at a time, each
// warp loading a contiguous slice into registers (the rows of chunk c + 2
// and the records of chunk c + 1 are in flight while chunk c is worked).
// A warp ranks its slice by owner, 32 entries a step in row order (a
// ballot a bit of the owner gives each lane the lanes of its owner; the
// lowest adds their number to the warp's row of a [W, 256] count table);
// each thread scans its owner's column and the block scans the owners, and
// every entry moves to its owner's bucket in shared memory, stably: a
// bucket holds its entries in row order.  Each thread then walks its own
// bucket: a bucket of one key (one-hot data, where an owner's keys differ
// in the leaf) in registers by a loop of loads and adds alone, as one run
// from the cell's value; else entry by entry into the cells.  Only the
// owner ever touches a cell, so each cell is the segment's entries of that
// key summed in row order from 0.
//
// Bound: bytes.  Each input is read once: the nnz entries (row i32 and the
// bin), leaf_id, g, h and mask of n rows; the output is written once.  The
// cells never leave shared memory before their one write, the only other
// device traffic is the record (16 bytes a row), an entry's gather of it
// (one 32-byte sector, mostly from L2) and, for features of several
// segments, their slabs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // s1_stored / s1_fold blocks
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 1024;                  // entries bucketed at a time
constexpr int kSlice = kChunk / kWarps;       // a warp's entries a chunk
constexpr int kSteps = kSlice / 32;           // a lane's entries a chunk
constexpr int kDigitBits = 9;                 // an owner, 0..kThreads
constexpr int kRun = 4;                       // a run's entries a round
constexpr int kRowChunk = 2048;               // rows per leaf-total chunk
constexpr int kLeafThreads = 256;             // s1_rows_kernel's block
constexpr int kMaxSmem = 232448;              // a block's most (227 KB)
static_assert(kSteps * 32 * kWarps == kChunk, "chunk split");
static_assert((kThreads & (kThreads - 1)) == 0, "owners: a power of two");
static_assert((1 << kDigitBits) > kThreads, "owner bits");

// Dynamic shared memory of a tile of Lt leaves x B bins: the cells (padded
// to 16 bytes), the bucketed chunk (a key and three stats an entry), the
// [W, kThreads] count table and W warp totals.  ops/cuda_sparse_hist.py
// tile_smem is the same sum.
__host__ __device__ inline int cells_floats(int Lt, int B) {
  return (Lt * B * 3 + 3) & ~3;
}
inline int64_t tile_smem(int Lt, int B) {
  return (int64_t)cells_floats(Lt, B) * 4 + (int64_t)kChunk * 16
         + (kWarps * kThreads + kWarps) * 4;
}

// Per (leaf, channel) of the tile: the stored sum s (bins from 0), then
// cell[default bin] += total - s; then the tile's cells go to out[l0 + l,
// f] once, coalesced.  Every thread of the block calls it.
__device__ inline void finish_tile(float* cell, int nl, int l0, int B, int F,
                                   int64_t f, const float* __restrict__ tot,
                                   int dbin, float* __restrict__ out) {
  const int B3 = B * 3;
  for (int i = threadIdx.x; i < nl * 3; i += blockDim.x) {
    const int l = i / 3, c = i - 3 * l;
    const float* row = cell + l * B3 + c;
    float s = 0.f;
#pragma unroll 8
    for (int b = 0; b < B; ++b) s = s + row[3 * b];
    float* d = cell + l * B3 + dbin * 3 + c;
    *d = *d + (tot[(l0 + l) * 3 + c] - s);
  }
  __syncthreads();
  for (int l = threadIdx.x >> 5; l < nl; l += blockDim.x >> 5) {
    float* dst = out + ((int64_t)(l0 + l) * F + f) * B3;
    for (int j = threadIdx.x & 31; j < B3; j += 32) dst[j] = cell[l * B3 + j];
  }
}

// Block c: rows [c*kRowChunk, (c+1)*kRowChunk): their records and the
// per-leaf sums of the chunk, rows in order.
__global__ void __launch_bounds__(kLeafThreads)
s1_rows_kernel(const int32_t* __restrict__ leaf_id,
               const float* __restrict__ g, const float* __restrict__ h,
               const float* __restrict__ m, int64_t n, int L,
               float4* __restrict__ rec, float* __restrict__ part) {
  __shared__ int s_leaf[kRowChunk];
  __shared__ float s_g[kRowChunk], s_h[kRowChunk], s_m[kRowChunk];
  const int64_t row0 = (int64_t)blockIdx.x * kRowChunk;
  const int cnt = (int)min((int64_t)kRowChunk, n - row0);
  for (int k = threadIdx.x; k < cnt; k += kLeafThreads) {
    const float mr = m[row0 + k];
    const int lf = leaf_id[row0 + k];
    const float gm = g[row0 + k] * mr, hm = h[row0 + k] * mr;
    s_leaf[k] = lf;
    s_g[k] = gm;
    s_h[k] = hm;
    s_m[k] = mr;
    rec[row0 + k] = make_float4(__int_as_float(lf), gm, hm, mr);
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += kLeafThreads) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;  // another leaf's row adds 0.f
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const bool in = s_leaf[k] == l;
      a0 = a0 + (in ? s_g[k] : 0.f);
      a1 = a1 + (in ? s_h[k] : 0.f);
      a2 = a2 + (in ? s_m[k] : 0.f);
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

// The lanes of the warp whose v has the same low kDigitBits bits as this
// lane's: one ballot a bit (the mask __match_any_sync gives, built as
// hist_chunk.cuh and CUB's radix rank build it).
__device__ inline unsigned peers_of(int v) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int i = 0; i < kDigitBits; ++i) {
    const int bit = (v >> i) & 1;
    const unsigned vote = __ballot_sync(0xffffffffu, bit);
    peers &= bit ? vote : ~vote;
  }
  return peers;
}

// Block b: segment b / T, leaf tile b % T (leaves [t*Lt, t*Lt + nl)).
template <typename BinT>
__global__ void __launch_bounds__(kThreads)
s1_stored_kernel(const int32_t* __restrict__ crow,
                 const BinT* __restrict__ cbin,
                 const int64_t* __restrict__ seg_feat,
                 const int64_t* __restrict__ seg_begin,
                 const int64_t* __restrict__ seg_end,
                 const int64_t* __restrict__ seg_slot,
                 const float4* __restrict__ rec,
                 const float* __restrict__ tot,
                 const int32_t* __restrict__ default_bins, int L, int F,
                 int B, int Lt, int T, float* __restrict__ out,
                 float* __restrict__ slabs) {
  extern __shared__ float4 smem4[];
  float* cell = (float*)smem4;
  // the bucketed chunk: an entry's (key, g*m, h*m, m bits)
  int4* bent = (int4*)(cell + cells_floats(Lt, B));
  int* cnt = (int*)(bent + kChunk);      // [W, kThreads]: counts, offsets
  int* wsum = cnt + kWarps * kThreads;   // the scan's warp totals
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t s = blockIdx.x / T;
  const int l0 = (int)(blockIdx.x % T) * Lt, nl = min(Lt, L - l0);
  const int64_t f = seg_feat[s], slot = seg_slot[s];
  const int64_t begin = seg_begin[s], end = seg_end[s];
  const int ncell = nl * B * 3;
  for (int i = tid; i < ncell; i += kThreads) cell[i] = 0.f;

  // A lane's entries of a chunk: the rows and bins of chunk c + 2 and the
  // records of chunk c + 1 are in flight while chunk c is bucketed and
  // walked.
  int32_t r[kSteps];
  int bn[kSteps], bq[kSteps];
  float4 q[kSteps];
  auto load_rows = [&](int64_t base) {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t e = base + warp * kSlice + j * 32 + lane;
      r[j] = e < end ? crow[e] : -1;
      bn[j] = e < end ? (int)cbin[e] : 0;
    }
  };
  auto load_recs = [&]() {
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      q[j] = r[j] >= 0 ? rec[r[j]]
                       : make_float4(__int_as_float(-1), 0.f, 0.f, 0.f);
      bq[j] = bn[j];
    }
  };
  load_rows(begin);
  load_recs();
  load_rows(begin + kChunk);
  int* wcnt = cnt + warp * kThreads;
  for (int64_t base = begin; base < end; base += kChunk) {
    // key (-1: none) and owner (kThreads: none) of the lane's entries
    int key[kSteps], own[kSteps], rk[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int lf = __float_as_int(q[j].x) - l0;
      const bool in = (unsigned)lf < (unsigned)nl;
      key[j] = in ? lf * B + bq[j] : -1;
      own[j] = in ? (lf + bq[j]) & (kThreads - 1) : kThreads;
    }
    // rank: the entry's place among its warp's entries of the same owner
#pragma unroll
    for (int i = lane; i < kThreads; i += 32) wcnt[i] = 0;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const unsigned peers = peers_of(own[j]);
      const int leader = __ffs(peers) - 1;
      int before = 0;
      if (lane == leader && own[j] < kThreads) {
        before = wcnt[own[j]];
        wcnt[own[j]] = before + __popc(peers);
      }
      rk[j] = __shfl_sync(0xffffffffu, before, leader)
              + __popc(peers & ((1u << lane) - 1u));
      __syncwarp();
    }
    __syncthreads();
    // scan: thread d's bucket is [lo, lo + n); cnt[w][d] becomes lo + the
    // entries of d in the slices of warps before w
    int lo, n = 0;
    {
      int cw[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) cw[w] = cnt[w * kThreads + tid];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int x = cw[w];
        cw[w] = n;
        n += x;
      }
      int incl = n;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      lo = incl - n;
      for (int w = 0; w < warp; ++w) lo += wsum[w];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) cnt[w * kThreads + tid] = lo + cw[w];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (own[j] < kThreads) {
        const int p = wcnt[own[j]] + rk[j];
        bent[p] = make_int4(key[j], __float_as_int(q[j].y),
                            __float_as_int(q[j].z), __float_as_int(q[j].w));
      }
    }
    load_recs();
    load_rows(base + 2 * kChunk);
    __syncthreads();
    // walk: the thread's bucket in row order.  First as one run, summed in
    // registers from the first key's cell by a loop of loads and adds alone
    // (no store, no branch on a key), kept when every key is the first
    // (one-hot data: an owner's keys differ in the leaf, and each leaf
    // stores one bin); else entry by entry into the cells, two a step.
    const int4* mine = bent + lo;
    const int k0 = n ? mine[0].x : 0;
    float* c = cell + k0 * 3;
    float a0 = c[0], a1 = c[1], a2 = c[2];
    // the run's sum stands only if every key is k0 (a second key among
    // the first two: no run)
    bool one = n < 2 || mine[1].x == k0;
    if (one) {
      const float4* run = (const float4*)mine;
      int t = 0;
      for (; t + kRun <= n; t += kRun) {  // kRun loads, then their adds
        float4 v[kRun];
#pragma unroll
        for (int u = 0; u < kRun; ++u) v[u] = run[t + u];
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          one &= __float_as_int(v[u].x) == k0;
          a0 = a0 + v[u].y;
          a1 = a1 + v[u].z;
          a2 = a2 + v[u].w;
        }
      }
      for (; t < n; ++t) {
        const float4 v = run[t];
        one &= __float_as_int(v.x) == k0;
        a0 = a0 + v.y;
        a1 = a1 + v.z;
        a2 = a2 + v.w;
      }
    }
    if (one) {
      if (n) {
        c[0] = a0;
        c[1] = a1;
        c[2] = a2;
      }
    } else {
      // two entries a step, both cells read before either is written; a
      // second entry of the first's key adds to the first's new value
      for (int t = 0; t < n; t += 2) {
        const int4 e = mine[t];
        const int4 d = mine[min(t + 1, n - 1)];
        const bool two = t + 1 < n, same = d.x == e.x;
        float* ce = cell + e.x * 3;
        float* cd = cell + d.x * 3;
        const float x0 = ce[0] + __int_as_float(e.y);
        const float x1 = ce[1] + __int_as_float(e.z);
        const float x2 = ce[2] + __int_as_float(e.w);
        const float y0 = (same ? x0 : cd[0]) + __int_as_float(d.y);
        const float y1 = (same ? x1 : cd[1]) + __int_as_float(d.z);
        const float y2 = (same ? x2 : cd[2]) + __int_as_float(d.w);
        ce[0] = x0;
        ce[1] = x1;
        ce[2] = x2;
        if (two) {
          cd[0] = y0;
          cd[1] = y1;
          cd[2] = y2;
        }
      }
    }
  }
  __syncthreads();
  if (slot >= 0) {
    float* dst = slabs + (slot * L + l0) * (int64_t)B * 3;
    for (int i = tid; i < ncell; i += kThreads) dst[i] = cell[i];
  } else {
    finish_tile(cell, nl, l0, B, F, f, tot, default_bins[f], out);
  }
}

// Block b: feature fold_feat[b / T] of several segments, leaf tile b % T.
__global__ void __launch_bounds__(kThreads)
s1_fold_kernel(const int64_t* __restrict__ fold_feat,
               const int64_t* __restrict__ fold_slot,
               const int64_t* __restrict__ fold_nseg,
               const float* __restrict__ slabs,
               const float* __restrict__ tot,
               const int32_t* __restrict__ default_bins, int L, int F, int B,
               int Lt, int T, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* cell = (float*)smem4;
  const int64_t j = blockIdx.x / T;
  const int l0 = (int)(blockIdx.x % T) * Lt, nl = min(Lt, L - l0);
  const int64_t per = (int64_t)L * B * 3, f = fold_feat[j], nseg = fold_nseg[j];
  const float* src = slabs + fold_slot[j] * per + (int64_t)l0 * B * 3;
  for (int i = threadIdx.x; i < nl * B * 3; i += kThreads) {
    float acc = 0.f;
    for (int64_t t = 0; t < nseg; ++t) acc = acc + src[t * per + i];
    cell[i] = acc;
  }
  __syncthreads();
  finish_tile(cell, nl, l0, B, F, f, tot, default_bins[f], out);
}

template <typename BinT>
int launch_stored(const void* crow, const void* cbin, const void* seg_feat,
                  const void* seg_begin, const void* seg_end,
                  const void* seg_slot, int64_t nseg, const float4* rec,
                  const float* tot, const int32_t* default_bins, int L,
                  int F, int B, int Lt, int T, int smem, float* out,
                  float* slabs, cudaStream_t stream) {
  cudaFuncSetAttribute(s1_stored_kernel<BinT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  s1_stored_kernel<BinT><<<(unsigned)(nseg * T), kThreads, smem, stream>>>(
      (const int32_t*)crow, (const BinT*)cbin, (const int64_t*)seg_feat,
      (const int64_t*)seg_begin, (const int64_t*)seg_end,
      (const int64_t*)seg_slot, rec, tot, default_bins, L, F, B, Lt, T, out,
      slabs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The whole level histogram: out [L, F, B, 3], leaves in tiles of Lt;
// scratch: rec [n, 4], slabs [num_slots, L, B, 3], part [ceil(n / 2048),
// L, 3], tot [L, 3].  Returns the first launch error, 0 when every launch
// was accepted (cudaErrorInvalidValue when a tile does not fit).
int lgbm_sparse_hist(const void* crow, const void* cbin, int bin_bytes,
                     const void* seg_feat, const void* seg_begin,
                     const void* seg_end, const void* seg_slot, int64_t nseg,
                     const void* fold_feat, const void* fold_slot,
                     const void* fold_nseg, int nfold,
                     const void* default_bins, const void* leaf_id,
                     const void* g, const void* h, const void* m, int64_t n,
                     int L, int F, int B, int Lt, void* rec, void* slabs,
                     void* part, void* tot, void* out, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (Lt < 1 || tile_smem(Lt, B) > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int T = (L + Lt - 1) / Lt, smem = (int)tile_smem(Lt, B);
  const int nchunks = (int)((n + kRowChunk - 1) / kRowChunk);
  int code;
  if (nchunks > 0) {
    s1_rows_kernel<<<nchunks, kLeafThreads, 0, stream>>>(
        (const int32_t*)leaf_id, (const float*)g, (const float*)h,
        (const float*)m, n, L, (float4*)rec, (float*)part);
    if ((code = (int)cudaGetLastError())) return code;
  }
  s1_leaf_total_kernel<<<(L * 3 + 255) / 256, 256, 0, stream>>>(
      (const float*)part, nchunks, L, (float*)tot);
  if ((code = (int)cudaGetLastError())) return code;
  if (nseg == 0) return 0;
  const float4* r4 = (const float4*)rec;
  const float* t = (const float*)tot;
  const int32_t* db = (const int32_t*)default_bins;
  float* o = (float*)out;
  code = bin_bytes == 1
             ? launch_stored<uint8_t>(crow, cbin, seg_feat, seg_begin,
                                      seg_end, seg_slot, nseg, r4, t, db, L,
                                      F, B, Lt, T, smem, o, (float*)slabs,
                                      stream)
             : launch_stored<uint16_t>(crow, cbin, seg_feat, seg_begin,
                                       seg_end, seg_slot, nseg, r4, t, db, L,
                                       F, B, Lt, T, smem, o, (float*)slabs,
                                       stream);
  if (code || nfold == 0) return code;
  const int fsmem = cells_floats(Lt, B) * 4;
  cudaFuncSetAttribute(s1_fold_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, fsmem);
  s1_fold_kernel<<<(unsigned)((int64_t)nfold * T), kThreads, fsmem,
                   stream>>>((const int64_t*)fold_feat,
                             (const int64_t*)fold_slot,
                             (const int64_t*)fold_nseg, (const float*)slabs,
                             t, db, L, F, B, Lt, T, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
