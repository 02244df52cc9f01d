// Kernel P2: the binned ensemble walk of training, for every score update
// that walks trees over binned rows: the new tree's walk over each valid
// set, the valid-set replay of add_valid_dataset, rollback_one_iter, the
// init model's replay in merge_from, and DART's drop, renormalisation and
// valid-set adjustment.
//
// It has no pl.pallas_call counterpart.  The JAX package walks binned rows
// in plain jnp (lightgbm_tpu/models/tree.py predict_binned, :114, and
// ensemble_sum_binned, :211: a while_loop over levels, one tree at a
// time) and adds each tree's output to the scores as a separate eager op
// (`s.at[c].add(scale * predict_binned(tree, X))`).
//
// The table (models/tree.py BinnedTrees): the used internal nodes of the
// listed trees one after the other, each one 16-byte record
// {split_feature | categorical << 31, threshold_bin, left, right} read with
// one load a visit; global child pointers (an internal child is its row, a
// leaf ~j with j its row in leaf_value); on the device beside it each
// tree's root, first record and first leaf.  Routing is Tree::GetLeaf's in
// bin space (tree.cpp:98-122): a numerical node sends bin <= threshold_bin
// left, a categorical node bin == threshold_bin.  Listed tree t belongs to
// class (c0 + t) % K; one scale serves the whole call.  Both are kernel
// arguments, so a call uploads nothing.
//
// The adds of each (class, row) score are the sequential walk's, in list
// order:
//   - update mode: s = s + f32(scale) * leaf_t(row), the product and the
//     sum each rounded to float32 (no contraction: built with -fmad=false,
//     and the intrinsics say so), the JAX package's eager ops exactly;
//   - replay mode: add_valid_dataset's order (JAX gbdt.py:478-489): tree
//     i*K + k's leaf into a chunk sum that starts from zero every
//     chunk_iters iterations, each chunk sum added in order to the score.
// So the scores equal the plain version's (models/tree.py binned_update_ /
// binned_replay_) bitwise.
//
// What bounds it on the H100.  Bytes: each score read and written once
// (8 bytes a (class, row)) and the bins read once (n*F, or 2*n*F):
// 36 MB at 1M x 28 uint8 bins, 0.0107 ms at 3.35 TB/s; 7.2 MB, 0.0021 ms,
// at 200k valid rows.  No walk reaches that.  A walk is a dependent chain
// (the record, then the row's bin at the record's feature, then the next
// record), 11.7 visits on average in a 255-leaf tree of the bench model
// but far more for a few rows, and a warp steps until its deepest lane
// is done: over the training rows one tree took 0.0233 ms with the rows
// sorted by their leaf (a warp's lanes on one path) against 0.0314
// unsorted, and 0.0163 with the walks cut out (tools/p2_variants.py).
// Neither the records' bytes (8-byte records were no faster in a trial
// whose code was not kept) nor where they live (shared memory or L1)
// moved it.  So the design
// (ops/cuda_predict_binned.py p2_config picks the configuration by shape;
// tools/p2_variants.py times the others):
//   - a block takes a tile of R rows and loads their [F, R] bins into
//     shared memory once, each feature's R bins with 16-byte copies, so
//     every bin a walk reads is a shared-memory load, not an L2 round trip
//     to a sector of [F, n] that the warp's other lanes do not share.  A
//     feature's row in the tile is padded so that lanes on the same word
//     column at different features fall on different banks.  A tile that
//     does not fit in 48 KB is cut to fewer rows; below MIN_TILED_ROWS the
//     same kernels read the bins from global memory (the wide
//     configuration, chosen by shape);
//   - at R = 256 (the training and valid rows) each thread walks its
//     row's listed trees one after the other (p2_rows_kernel): the card is
//     full of independent rows.  Handing a warp's rows to its lanes from a
//     queue, so that a lane takes a new row when its own is done and the
//     warp does not wait on its deepest lane, was slower in a trial whose
//     code was not kept: the queue's bookkeeping a step costs more than
//     the divergence;
//   - below R = 256 the block walks (tree slot j, row r) pairs, S = 256 / R
//     trees of the list at once, so a call of many trees over few rows is
//     one tree deep a thread; each walk leaves its leaf value in shared
//     memory and, after one barrier, the thread that owns (class, row)
//     adds the group's values in list order (double buffered: one barrier
//     a group; p2_slots_kernel).  Where p2_config picks it, it beats one
//     row a thread 1.35-6.8x (3,000 and 30,000 rows x 30 and 100 trees,
//     tools/p2_variants.py);
//   - a tile of 256 rows stages the records and leaf values of as many
//     whole trees as fit in `stage` records: a list that fits at once
//     comes in with the tile's and the scores' cp.async copies (one wait,
//     one barrier; their round trips in series were slower in a trial
//     whose code was not kept), a
//     longer one set by set between two barriers; smaller tiles read them
//     through L1;
//   - each (class, row) score is read once into shared memory and written
//     once, and only for the classes the list touches.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 48 * 1024;  // no opt-in attribute needed
constexpr int kMinBlocks = 8;  // blocks an SM: at most 32 registers a thread
// The stages p2_rows_kernel runs: 3 (the default) is the kernel.  The
// macro exists only for the stage times PERF.md reports: the build of
// ops/_build.py never sets it; tools/p2_variants.py builds copies cut
// after the scores' read and write (-DP2_STAGES=1) or the tile's load (2).
#ifndef P2_STAGES
#define P2_STAGES 3
#endif

struct Args {
  const int4* node;         // [nodes] records
  const float* leaf_value;  // [leaves]
  const int* root;          // [T] the first record, or ~leaf for a stump
  const int* node_offset;   // [T + 1] tree t's first record
  const int* leaf_offset;   // [T + 1] tree t's first leaf
  const void* bins;         // [F, n] uint8 / uint16
  int64_t n;
  int F;
  int K;
  int T;
  int c0;  // listed tree t is class (c0 + t) % K
  float scale;
  int max_steps;     // the most internal nodes of one listed tree
  int chunk_iters;   // replay mode
  int rows_log2;     // R = 1 << rows_log2 rows a tile
  int n_iter;        // replay mode: T / K iterations
  int stride;        // bytes of a feature's row in the tile (16-byte multiple)
  int stage;         // records a block stages (0: none; a multiple of 4)
  int stage_leaves;  // leaf values a block stages: stage + 4, a multiple of 4
  int vec;           // a tile's rows load with 16-byte loads
  float* scores;     // [K, n], updated in place
};

// The bytes of one feature's row of a tile of R bins of `bin_bytes`: a
// 16-byte multiple, widened by 32 * bin_bytes bytes when it is a multiple
// of 128, so that feature f + 1 starts 8 * bin_bytes banks after feature f
// (ops/cuda_predict_binned.py tile_stride is the same rule).
int tile_stride(int rows, int bin_bytes) {
  int b = (rows * bin_bytes + 15) / 16 * 16;
  if (b % 128 == 0) b += 32 * bin_bytes;
  return b;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// This thread's cp.async copies issued so far, landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// Tree t's leaf value v into the (class, row) score s and its chunk sum
// p: the sequential walk's adds.  `ends` (replay mode): t's iteration
// closes a chunk, or is the last.
template <bool kReplay>
__device__ __forceinline__ void add(float& s, float& p, float v, bool ends,
                                    float scale) {
  if (kReplay) {
    p = __fadd_rn(p, v);
    if (ends) {
      s = __fadd_rn(s, p);
      p = 0.0f;
    }
  } else {
    s = __fadd_rn(s, __fmul_rn(scale, v));
  }
}

// The bin of feature f of one row: in the tile (a feature's row `stride`
// bytes on from tcol) or in global memory (a feature's row n bins on from
// gcol).
template <typename Bin, bool kTiled>
__device__ __forceinline__ int bin_of(int f, const unsigned char* tcol,
                                      const Bin* gcol, const Args& a) {
  if constexpr (kTiled) {
    return *reinterpret_cast<const Bin*>(tcol + f * a.stride);
  } else {
    return __ldg(gcol + static_cast<int64_t>(f) * a.n);
  }
}

// One visit: the record of node nd (staged: global rows nbase.. at
// nodes[0..] in shared memory; else read through L1) routes the row to
// a child.
template <typename Bin, bool kTiled, bool kStaged>
__device__ __forceinline__ int visit(int nd, const int4* nodes, int nbase,
                                     const unsigned char* tcol,
                                     const Bin* gcol, const Args& a) {
  int4 rec;
  if constexpr (kStaged) {
    rec = nodes[nd - nbase];
  } else {
    rec = __ldg(nodes + nd);
  }
  const int b = bin_of<Bin, kTiled>(rec.x & 0x7fffffff, tcol, gcol, a);
  const bool left = rec.x < 0 ? b == rec.y : b <= rec.y;
  return left ? rec.z : rec.w;
}

// Whether class k's score is touched: its first listed tree, (k - c0)
// mod K, is in the list.
__device__ __forceinline__ bool touched(int k, const Args& a) {
  const int d = k - a.c0;
  return (d < 0 ? d + a.K : d) < a.T;
}

// The scores of the classes the list touches into shared memory, [K, R]
// from row row0 (thread q % 256 reads (class, row) (q >> lg, q & (R-1))).
template <bool kReplay>
__device__ __forceinline__ void load_scores(float* acc, float* part,
                                            int64_t row0, int nr, int lg,
                                            int tid, const Args& a) {
  for (int q = tid; q < (a.K << lg); q += kThreads) {
    const int k = q >> lg, rr = q & ((1 << lg) - 1);
    if (rr < nr && touched(k, a)) {
      acc[q] = a.scores[static_cast<int64_t>(k) * a.n + row0 + rr];
      if (kReplay) part[q] = 0.0f;
    }
  }
}

__device__ __forceinline__ void store_scores(const float* acc, int64_t row0,
                                             int nr, int lg, int tid,
                                             const Args& a) {
  for (int q = tid; q < (a.K << lg); q += kThreads) {
    const int k = q >> lg, rr = q & ((1 << lg) - 1);
    if (rr < nr && touched(k, a)) {
      a.scores[static_cast<int64_t>(k) * a.n + row0 + rr] = acc[q];
    }
  }
}

// R = 256 rows a tile, one a thread: thread tid walks row tid's listed
// trees one after the other and adds each leaf value in list order into
// its scores in shared memory (the class, iteration and chunk position
// counted along, no division a tree).  A staged list is walked set by set
// (records and leaf values between two barriers).
template <typename Bin, bool kReplay, bool kTiled, bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    p2_rows_kernel(Args a) {
  extern __shared__ int4 smem_raw[];  // 16-byte aligned
  constexpr int lg = 8;  // R = kThreads
  const int tid = threadIdx.x, K = a.K;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) << lg;
  const int nr = static_cast<int>(a.n - row0 < kThreads ? a.n - row0
                                                         : kThreads);
  const bool active = tid < nr;
  // shared: the staged records and leaf values, the tile of bins, the
  // scores and the chunk sums
  int4* recs = smem_raw;
  float* lvs = reinterpret_cast<float*>(recs + a.stage);
  unsigned char* tile = reinterpret_cast<unsigned char*>(lvs + a.stage_leaves);
  float* acc = reinterpret_cast<float*>(tile + (kTiled ? a.F * a.stride : 0));
  float* part = acc + (K << lg);
  const Bin* gbins = static_cast<const Bin*>(a.bins) + row0;
  // thread tid owns row tid's scores (q & 255 == tid) from here to the
  // end.  The scores, the tile and (a list that fits the stage at once) the
  // records and leaf values come in as cp.async copies, all in flight
  // together, then one wait and one barrier.
  const bool full = nr == kThreads && a.vec;
  for (int k = 0; k < K; ++k) {
    if (active && touched(k, a)) {
      cp_async4(acc + (k << lg) + tid,
                a.scores + static_cast<int64_t>(k) * a.n + row0 + tid);
      if (kReplay) part[(k << lg) + tid] = 0.0f;
    }
  }
  if (kTiled && P2_STAGES >= 2) {
    if (full) {  // a feature's 256 bins: 16 (uint16: 32) 16-byte copies
      const int lgp = sizeof(Bin) == 2 ? 5 : 4;
      for (int e = tid; e < (a.F << lgp); e += kThreads) {
        const int f = e >> lgp, c = e & ((1 << lgp) - 1);
        cp_async16(tile + f * a.stride + c * 16,
                   reinterpret_cast<const uint4*>(
                       gbins + static_cast<int64_t>(f) * a.n) + c);
      }
    } else if (active) {
      for (int f = 0; f < a.F; ++f) {
        reinterpret_cast<Bin*>(tile + f * a.stride)[tid] =
            __ldg(gbins + static_cast<int64_t>(f) * a.n + tid);
      }
    }
  }
  // a list whose records and leaves fit the stage: staged once, here
  const bool one_set = kStaged && __ldg(a.node_offset + a.T) <= a.stage &&
                       __ldg(a.leaf_offset + a.T) <= a.stage_leaves;
  if (one_set) {
    for (int e = tid; e < __ldg(a.node_offset + a.T); e += kThreads) {
      cp_async16(recs + e, a.node + e);
    }
    for (int e = tid; e < __ldg(a.leaf_offset + a.T); e += kThreads) {
      cp_async4(lvs + e, a.leaf_value + e);
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const unsigned char* tcol = tile + tid * static_cast<int>(sizeof(Bin));
  const Bin* gcol = gbins + (active ? tid : 0);
  int cls = a.c0, it = 0, pos = 0;  // listed tree t's class, iteration and
                                    // iterations into its chunk
  for (int s0 = 0; s0 < (P2_STAGES >= 3 ? a.T : 0);) {
    int s1 = a.T, nbase = 0, lbase = 0;
    if (kStaged && !one_set) {  // trees [s0, s1) whose records and leaves
                                // fit the stage
      nbase = __ldg(a.node_offset + s0);
      lbase = __ldg(a.leaf_offset + s0);
      s1 = s0 + 1;
      while (s1 < a.T && __ldg(a.node_offset + s1 + 1) - nbase <= a.stage &&
             __ldg(a.leaf_offset + s1 + 1) - lbase <= a.stage_leaves) {
        ++s1;
      }
      const int cnt = __ldg(a.node_offset + s1) - nbase;
      const int lcnt = __ldg(a.leaf_offset + s1) - lbase;
      __syncthreads();  // the last set's walks are done
      for (int e = tid; e < cnt; e += kThreads) {
        cp_async16(recs + e, a.node + nbase + e);
      }
      for (int e = tid; e < lcnt; e += kThreads) {
        cp_async4(lvs + e, a.leaf_value + lbase + e);
      }
      cp_async_wait_all();
      __syncthreads();
    }
    const int4* nodes = kStaged ? recs : a.node;
    for (int t = s0; t < s1; ++t) {
      if (active) {
        int nd = __ldg(a.root + t);
        for (int d = 0; d < a.max_steps && nd >= 0; ++d) {
          nd = visit<Bin, kTiled, kStaged>(nd, nodes, nbase, tcol, gcol, a);
        }
        const int leaf = nd < 0 ? ~nd : lbase;
        const float v =
            kStaged ? lvs[leaf - lbase] : __ldg(a.leaf_value + leaf);
        const int q = (cls << lg) + tid;
        add<kReplay>(acc[q], part[q], v,
                     pos + 1 == a.chunk_iters || it + 1 == a.n_iter,
                     a.scale);
      }
      if (++cls == K) {
        cls = 0;
        ++it;
        if (++pos == a.chunk_iters) pos = 0;
      }
    }
    s0 = s1;
  }
  store_scores(acc, row0, nr, lg, tid, a);
}

// R < 256 rows a block (one tile each), S = 256 / R listed trees at once:
// thread (slot j, row r) walks tree g0 + j of the group for row r and
// leaves its leaf value in shared memory; after one barrier the thread
// that owns (class, row) adds the group's values of its class in list
// order (two buffers: one barrier a group).
template <typename Bin, bool kReplay, bool kTiled>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    p2_slots_kernel(Args a) {
  extern __shared__ int4 smem_raw[];  // 16-byte aligned
  const int lg = a.rows_log2, R = 1 << lg, S = kThreads >> lg;
  const int tid = threadIdx.x, r = tid & (R - 1), j = tid >> lg;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) << lg;
  const int nr = static_cast<int>(a.n - row0 < R ? a.n - row0 : R);
  const bool active = r < nr;
  const int K = a.K, RK = R * K;
  // shared: the tile of bins, the scores (and chunk sums), the group's
  // leaf values
  unsigned char* tile = reinterpret_cast<unsigned char*>(smem_raw);
  float* acc = reinterpret_cast<float*>(tile + (kTiled ? a.F * a.stride : 0));
  float* part = acc + RK;
  float* vals = part + (kReplay ? RK : 0);  // [2][kThreads]
  const Bin* gbins = static_cast<const Bin*>(a.bins) + row0;
  // thread q % 256 owns (class, row) (q >> lg, q & (R - 1)) to the end
  load_scores<kReplay>(acc, part, row0, nr, lg, tid, a);
  if (kTiled) {
    if (active) {  // S features at a time, one bin a thread
      for (int f = j; f < a.F; f += S) {
        reinterpret_cast<Bin*>(tile + f * a.stride)[r] =
            __ldg(gbins + static_cast<int64_t>(f) * a.n + r);
      }
    }
    __syncthreads();
  }
  const unsigned char* tcol = tile + r * static_cast<int>(sizeof(Bin));
  const Bin* gcol = gbins + (active ? r : 0);
  int buf = 0;
  for (int g0 = 0; g0 < a.T; g0 += S) {
    const int g1 = min(g0 + S, a.T), t = g0 + j;
    float v = 0.0f;
    if (active && t < g1) {
      int nd = __ldg(a.root + t);
      for (int d = 0; d < a.max_steps && nd >= 0; ++d) {
        nd = visit<Bin, kTiled, false>(nd, a.node, 0, tcol, gcol, a);
      }
      v = __ldg(a.leaf_value + (nd < 0 ? ~nd : 0));
    }
    float* vb = vals + buf * kThreads;
    vb[tid] = v;  // slot j, row r: vb[j * R + r]
    __syncthreads();
    for (int q = tid; q < RK; q += kThreads) {
      const int k = q >> lg, rr = q & (R - 1);
      if (rr >= nr) continue;
      float sc = acc[q], p = kReplay ? part[q] : 0.0f;
      const int d = (k - a.c0 - g0) % K;
      for (int t2 = g0 + (d < 0 ? d + K : d); t2 < g1; t2 += K) {
        const int i = t2 / K;
        add<kReplay>(sc, p, vb[((t2 - g0) << lg) + rr],
                     (i + 1) % a.chunk_iters == 0 || i + 1 == a.n_iter,
                     a.scale);
      }
      acc[q] = sc;
      if (kReplay) part[q] = p;
    }
    buf ^= 1;
  }
  store_scores(acc, row0, nr, lg, tid, a);
}

int64_t smem_bytes(const Args& a, bool replay, bool tiled) {
  const int R = 1 << a.rows_log2;
  int64_t b = tiled ? static_cast<int64_t>(a.F) * a.stride : 0;
  if (R == kThreads) {
    return b + 16LL * a.stage + 4LL * a.stage_leaves +
           4LL * R * a.K * (replay ? 2 : 1);
  }
  return b + 4LL * R * a.K * (replay ? 2 : 1) + 4LL * 2 * kThreads;
}

template <typename Bin, bool kReplay>
void launch_mode(const Args& a, bool tiled, int smem, cudaStream_t s) {
  const unsigned grid =
      static_cast<unsigned>((a.n + (1 << a.rows_log2) - 1) >> a.rows_log2);
  if ((1 << a.rows_log2) == kThreads) {
    if (a.stage > 0) {
      p2_rows_kernel<Bin, kReplay, true, true><<<grid, kThreads, smem, s>>>(a);
    } else if (tiled) {
      p2_rows_kernel<Bin, kReplay, true, false>
          <<<grid, kThreads, smem, s>>>(a);
    } else {
      p2_rows_kernel<Bin, kReplay, false, false>
          <<<grid, kThreads, smem, s>>>(a);
    }
  } else if (tiled) {
    p2_slots_kernel<Bin, kReplay, true><<<grid, kThreads, smem, s>>>(a);
  } else {
    p2_slots_kernel<Bin, kReplay, false><<<grid, kThreads, smem, s>>>(a);
  }
}

template <typename Bin>
void launch_bins(const Args& a, bool replay, bool tiled, int smem,
                 cudaStream_t s) {
  if (replay) {
    launch_mode<Bin, true>(a, tiled, smem, s);
  } else {
    launch_mode<Bin, false>(a, tiled, smem, s);
  }
}

}  // namespace

extern "C" {

// The listed trees' walks over [F, n] bins of `bin_bytes` bytes (1: uint8,
// 2: uint16) into the [K, n] f32 scores, in place.  Listed tree t is class
// (c0 + t) % K.  Update mode (replay 0) adds f32(scale) * leaf_t to its
// class's score for each listed tree in order; replay mode (replay 1; c0
// 0, T a multiple of K) sums tree i*K + k's leaves in chunks of
// `chunk_iters` iterations from zero and adds each chunk sum in order.
// The configuration: R = `rows` rows a tile (a power of two up to 256; 256:
// one row a thread, its trees in turn; below, S = 256 / R tree slots),
// the bins tiled in shared memory when `tiled`, `stage` records (and
// stage + 4 leaf values) staged in shared memory (0: read through L1;
// needs `tiled`, rows 256, a multiple of 4 and every listed tree within
// `stage` records: max_steps <= stage).  All
// pointers are device pointers; `stream` is a cudaStream_t.  Returns
// cudaGetLastError() after the launch (0: launched), or
// cudaErrorInvalidValue for arguments or a configuration it does not take.
int lgbm_p2_walk(const int* node, const float* leaf_value, const int* root,
                 const int* node_offset, const int* leaf_offset,
                 const void* bins, int bin_bytes, int64_t n, int F, int K,
                 int T, int c0, float scale, int max_steps, int replay,
                 int chunk_iters, int rows, int tiled, int stage,
                 float* scores, void* stream) {
  if (K < 1 || T < 0 || c0 < 0 || c0 >= K || max_steps < 0 || F < 1 ||
      (bin_bytes != 1 && bin_bytes != 2) ||
      (replay && (chunk_iters < 1 || T % K != 0 || c0 != 0)) || rows < 1 ||
      rows > kThreads || (rows & (rows - 1)) != 0 || stage < 0 ||
      (stage > 0 && (!tiled || rows != kThreads || stage % 4 != 0 ||
                     max_steps > stage))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || T == 0) return static_cast<int>(cudaGetLastError());
  const int stride = tiled ? tile_stride(rows, bin_bytes) : 0;
  const bool vec = reinterpret_cast<uintptr_t>(bins) % 16 == 0 &&
                   (n * bin_bytes) % 16 == 0 && (rows * bin_bytes) % 16 == 0;
  int lg = 0;
  while ((1 << lg) < rows) ++lg;
  Args a{reinterpret_cast<const int4*>(node), leaf_value, root, node_offset,
         leaf_offset, bins, n, F, K, T, c0, scale, max_steps,
         replay ? chunk_iters : 1, lg, replay ? T / K : T, stride, stage,
         stage > 0 ? (stage + 4) & ~3 : 0, vec ? 1 : 0, scores};
  const int64_t smem = smem_bytes(a, replay != 0, tiled != 0);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1) {
    launch_bins<uint8_t>(a, replay != 0, tiled != 0, static_cast<int>(smem),
                         s);
  } else {
    launch_bins<uint16_t>(a, replay != 0, tiled != 0,
                          static_cast<int>(smem), s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
