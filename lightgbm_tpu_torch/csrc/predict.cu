// Kernel P1: ensemble prediction on raw features, for Booster.predict,
// pred_leaf and every serving dispatch.
//
// It has no pl.pallas_call counterpart.  The JAX package predicts in plain
// jnp: off the TPU with a stacked-tree walk (lightgbm_tpu/models/tree.py
// ensemble_sum_raw / ensemble_leaves_raw, :192-228, under
// GBDT._raw_scores' iteration chunks, models/gbdt.py:1045-1088), on the TPU
// with path-incidence products (ops/predict_matmul.py:153), three dense
// products a tree because indexed gathers are slow on its matrix unit.  On
// the card a gather from a node table that stays in L1/L2 is cheap, so P1
// walks.
//
// The ensemble is one flat node table (models/tree.py PackedTrees): the
// used internal nodes of every tree one after the other, each one 16-byte
// record {split_feature | categorical << 31, the threshold's f32 bits,
// left, right} read with one load a visit; global child pointers (an
// internal child is its row, a leaf ~j with j its row in leaf_value);
// root[t] the first node of tree t or ~leaf for a one-leaf tree.  Routing
// is Tree::Predict's (tree.h:116-122): a numerical node sends v <= thr left
// (NaN and +inf go right), a categorical node sends f32_to_i32_xla(v) ==
// f32_to_i32_xla(thr) left.
//
// Sum mode writes [K, n] f32 raw scores: tree t = i*K + k adds to class k,
// in tree order, into a chunk sum that starts from zero every chunk_iters
// iterations; the chunk sums are added in order into the total.  That is
// the JAX package's float order, so the sums equal the plain version's
// (models/tree.py ensemble_sum_raw) bitwise: each tree's output is an exact
// leaf value and only the order of the additions matters (no FMA to
// contract: the file is built with -fmad=false like the others).  Leaves
// mode writes [T, n] int32 leaf indices (local to each tree).
//
// What bounds it on the H100.  Bytes: X once (n*F*4), the node records
// once and the output once: at 1M rows x 28 features and 100 trees of 255
// leaves, 112 MB + 0.4 MB + 4 MB, 0.035 ms at 3.35 TB/s.  No walk reaches
// that: its floor is the visit rate.  Each visit is a dependent chain (the
// node's record, then the row's value at its feature, then the next node),
// 1.17e9 visits at 1M rows (mean depth 11.7), and a row's answer needs all
// of its trees' visits.  At 1M rows the card is full of independent walks
// and the rate of the records' gathers sets the time (5.3e11 visits/s,
// about 2.3 a cycle an SM); at serving's sizes the card is almost empty
// and one row's chain does.  So the design cuts the chain and the loads a
// visit (ops/cuda_predict.py p1_config picks the configuration by shape;
// tools/p1_variants.py times the others):
//   - a block takes a tile of R rows and walks (row, tree) pairs, S = 256/R
//     trees of a group at once (thread = (tree slot j, row r), lanes on
//     neighbouring rows of one tree, so a warp's first visits share their
//     records).  At serving's sizes R is small and S covers the whole
//     model: a row's chain is one tree's depth, not ~1,170 visits.  At 1M
//     rows R = 256 and S = 1: each thread walks its row's trees in turn,
//     and the card is full of independent rows;
//   - with S > 1, each walk leaves its leaf value in shared memory; after a
//     barrier the one thread that owns (row, class) adds the group's
//     values in tree order into its running chunk sum and total (double
//     buffered: one barrier a group).  The adds are the sequential walk's
//     adds in its order, so the sums stay bitwise;
//   - one 16-byte record a visit (one load) instead of five loads from
//     five arrays;
//   - the tile of X lives in shared memory (read once, coalesced; row
//     stride odd, so lanes on neighbouring rows hit other banks) when it
//     fits in 48 KB; wider inputs (phase 18 holds F = 5,000) read X from
//     global memory: the same kernel in its second configuration, chosen
//     by shape, not a fallback;
//   - a tile of 256 rows stages the records of a few whole trees at a time
//     in shared memory (`stage` records, between two barriers), so its
//     gathers hit shared memory instead of L1; 25 % faster than reading
//     them through L1 at 1M rows.  Smaller tiles read them through L1:
//     staging there costs more than it saves.
// Leaves mode walks the same pairs and writes each leaf index at once (no
// sums, no barrier after the tile).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemLimit = 48 * 1024;  // no opt-in attribute needed

// float -> int32 as XLA converts (NaN -> 0, saturating at both ends,
// truncation toward zero): the JAX walk's astype(jnp.int32).  Spelled out:
// a C cast of a NaN or out-of-range float is undefined.
__device__ __forceinline__ int f32_to_i32_xla(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x < -2147483648.0f) return -2147483647 - 1;
  return __float2int_rz(x);
}

struct Args {
  const int4* node;  // [nodes] records
  const int* node_offset;  // [T + 1]: tree t's records start at [t]
  const float* leaf_value;
  const int* root;
  const int* leaf_offset;
  const float* X;  // [n, F] row-major
  int64_t n;
  int F;
  int depth;  // the deepest path, in internal nodes: a bound on the steps
  int n_trees;
  int K;
  int n_iter;
  int chunk_iters;
  int rows;    // R: rows a block; slots S = kThreads / R
  int stride;  // a row's floats in the shared tile (odd)
  int stage;   // records a block stages in shared memory (0: none)
  float* sums;  // [K, n]
  int* leaves;  // [n_trees, n]
};

// The global leaf row (~node) of the tree whose root is `start`, for the
// row whose values start at `xr` (shared tile or global X).  Staged, the
// records of global rows base.. are at recs[0..].
template <bool kTiled, bool kStaged>
__device__ __forceinline__ int walk(const int4* __restrict__ recs, int base,
                                    const float* xr, int start, int depth) {
  int nd = start;
  for (int d = 0; d < depth && nd >= 0; ++d) {
    const int4 rec = kStaged ? recs[nd - base] : __ldg(recs + nd);
    const int f = rec.x & 0x7fffffff;
    const float v = kTiled ? xr[f] : __ldg(xr + f);
    const float thr = __int_as_float(rec.y);
    const bool left = rec.x < 0 ? f32_to_i32_xla(v) == f32_to_i32_xla(thr)
                                : v <= thr;
    nd = left ? rec.z : rec.w;
  }
  return ~nd;
}

// Tree t's value (iteration i = t / K) into its class's chunk sum `p` and
// total `tot`: the sequential walk's adds.  The first chunk's 0 + part ==
// part (part is never -0.0: it starts from +0.0).
__device__ __forceinline__ void accumulate(float& p, float& tot, float v,
                                           int i, const Args& a) {
  p = p + v;
  if ((i + 1) % a.chunk_iters == 0 || i + 1 == a.n_iter) {
    tot = tot + p;
    p = 0.0f;
  }
}

template <bool kTiled, bool kLeaves, bool kStaged>
__global__ void __launch_bounds__(kThreads) p1_kernel(Args a) {
  extern __shared__ int4 smem_raw[];  // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int R = a.rows, S = kThreads / R, tid = threadIdx.x;
  const int r = tid % R, j = tid / R;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * R;
  const int nr = static_cast<int>(a.n - row0 < R ? a.n - row0 : R);
  const bool active = r < nr;
  // shared: the staged records (16-byte aligned first), the tile of X,
  // then the sums' scratch
  int4* recs = smem_raw;
  float* xs = smem + 4 * a.stage;  // [R, stride] when tiled
  float* scratch = xs + (kTiled ? R * a.stride : 0);
  if (kTiled) {
    const float* src = a.X + row0 * a.F;
    const int cells = nr * a.F;
    for (int e = tid; e < cells; e += kThreads) {
      const int rr = e / a.F;
      xs[rr * a.stride + (e - rr * a.F)] = __ldg(src + e);
    }
  }
  const float* xr =
      kTiled ? xs + r * a.stride : a.X + (row0 + (active ? r : 0)) * a.F;

  // sums: part[q], total[q] for q = k * R + r, each owned by thread q % 256
  // (the walker of row r when S == 1), so no barrier guards them
  const int RK = kLeaves ? 0 : R * a.K;
  float* part = scratch;
  float* total = scratch + RK;
  float* vals = scratch + 2 * RK;  // [2][kThreads] when S > 1
  for (int q = tid; q < RK; q += kThreads) {
    part[q] = 0.0f;
    total[q] = 0.0f;
  }
  if (kTiled) __syncthreads();

  int buf = 0;
  // trees [g0, g1), one a slot, from the records at recs (staged: global
  // rows from base)
  auto group = [&](int g0, int g1, const int4* nodes, int base) {
    const int t = g0 + j;
    const bool walks = active && t < g1;
    int leaf = 0;
    if (walks) {
      leaf = walk<kTiled, kStaged>(nodes, base, xr, __ldg(a.root + t),
                                   a.depth);
    }
    if (kLeaves) {
      if (walks) {
        a.leaves[static_cast<int64_t>(t) * a.n + row0 + r] =
            leaf - __ldg(a.leaf_offset + t);
      }
      return;
    }
    const float v = walks ? __ldg(a.leaf_value + leaf) : 0.0f;
    if (S == 1) {
      if (walks) {
        const int q = (t % a.K) * R + r;
        float p = part[q], tot = total[q];
        accumulate(p, tot, v, t / a.K, a);
        part[q] = p;
        total[q] = tot;
      }
      return;
    }
    float* vb = vals + buf * kThreads;
    vb[tid] = v;  // slot j, row r: vb[j * R + r]
    __syncthreads();
    for (int q = tid; q < RK; q += kThreads) {
      const int k = q / R, rr = q - k * R;
      if (rr >= nr) continue;
      float p = part[q], tot = total[q];
      // the group's trees of class k, in tree order
      for (int t2 = g0 + ((k - g0 % a.K) + a.K) % a.K; t2 < g1; t2 += a.K) {
        accumulate(p, tot, vb[(t2 - g0) * R + rr], t2 / a.K, a);
      }
      part[q] = p;
      total[q] = tot;
    }
    buf ^= 1;
  };

  if (kStaged) {
    // trees [s0, s1) whose records fit in a.stage, staged one set at a time
    for (int s0 = 0; s0 < a.n_trees;) {
      const int base = __ldg(a.node_offset + s0);
      int s1 = s0 + 1;
      while (s1 < a.n_trees &&
             __ldg(a.node_offset + s1 + 1) - base <= a.stage) {
        ++s1;
      }
      const int cnt = __ldg(a.node_offset + s1) - base;
      __syncthreads();  // the last set's walks are done
      for (int e = tid; e < cnt; e += kThreads) {
        recs[e] = __ldg(a.node + base + e);
      }
      __syncthreads();
      for (int g0 = s0; g0 < s1; g0 += S) {
        group(g0, min(g0 + S, s1), recs, base);
      }
      s0 = s1;
    }
  } else {
    for (int g0 = 0; g0 < a.n_trees; g0 += S) {
      group(g0, min(g0 + S, a.n_trees), a.node, 0);
    }
  }
  for (int q = tid; q < RK; q += kThreads) {
    const int k = q / R, rr = q - k * R;
    if (rr < nr) a.sums[static_cast<int64_t>(k) * a.n + row0 + rr] = total[q];
  }
}

int smem_bytes(const Args& a, bool tiled, bool leaves) {
  const int S = kThreads / a.rows;
  int64_t b = 4LL * a.stage;
  if (tiled) b += static_cast<int64_t>(a.rows) * a.stride;
  if (!leaves) b += 2LL * a.rows * a.K + (S > 1 ? 2 * kThreads : 0);
  return b * 4 > kSmemLimit ? -1 : static_cast<int>(b * 4);
}

int launch(Args a, bool tiled, bool leaves, void* stream) {
  if (a.rows < 1 || a.rows > kThreads || kThreads % a.rows != 0 ||
      a.stage < 0 || (a.stage > 0 && !tiled)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.stride = a.F | 1;
  const int smem = smem_bytes(a, tiled, leaves);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>((a.n + a.rows - 1) / a.rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = a.stage > 0;
  if (staged && leaves) {
    p1_kernel<true, true, true><<<grid, kThreads, smem, s>>>(a);
  } else if (staged) {
    p1_kernel<true, false, true><<<grid, kThreads, smem, s>>>(a);
  } else if (tiled && leaves) {
    p1_kernel<true, true, false><<<grid, kThreads, smem, s>>>(a);
  } else if (tiled) {
    p1_kernel<true, false, false><<<grid, kThreads, smem, s>>>(a);
  } else if (leaves) {
    p1_kernel<false, true, false><<<grid, kThreads, smem, s>>>(a);
  } else {
    p1_kernel<false, false, false><<<grid, kThreads, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Sum mode: out [K, n] f32 from the first n_iter*K trees of the table, R =
// `rows` rows a block (a divisor of 256), X tiled in shared memory when
// `tiled`, `stage` records a block staged in shared memory (0: read
// through L1; needs `tiled` and every tree within `stage` records).  All
// pointers are device pointers; `stream` is a cudaStream_t.  Returns
// cudaGetLastError() after the launch (0: launched), or
// cudaErrorInvalidValue for a configuration that does not fit.
int lgbm_p1_sum(const int* node, const int* node_offset,
                const float* leaf_value, const int* root, int depth,
                const float* X, int64_t n, int F, int K, int n_iter,
                int chunk_iters, int rows, int tiled, int stage, float* out,
                void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  Args a{reinterpret_cast<const int4*>(node), node_offset, leaf_value, root,
         nullptr, X, n, F, depth, n_iter * K, K, n_iter, chunk_iters, rows,
         0, stage, out, nullptr};
  return launch(a, tiled != 0, false, stream);
}

// Leaves mode: out [T, n] int32 from the first T trees of the table.
int lgbm_p1_leaves(const int* node, const int* node_offset, const int* root,
                   const int* leaf_offset, int depth, const float* X,
                   int64_t n, int F, int T, int rows, int tiled, int stage,
                   int* out, void* stream) {
  if (n <= 0 || T <= 0) return (int)cudaGetLastError();
  Args a{reinterpret_cast<const int4*>(node), node_offset, nullptr, root,
         leaf_offset, X, n, F, depth, T, 1, T, 1, rows, 0, stage, nullptr,
         out};
  return launch(a, tiled != 0, true, stream);
}

}  // extern "C"
