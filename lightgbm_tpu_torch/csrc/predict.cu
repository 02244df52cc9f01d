// Kernel P1: ensemble prediction on raw features, for Booster.predict and
// every serving dispatch.
//
// It has no pl.pallas_call counterpart.  The JAX package predicts in plain
// jnp: off the TPU with a stacked-tree walk (lightgbm_tpu/models/tree.py
// ensemble_sum_raw / ensemble_leaves_raw, :192-228, under
// GBDT._raw_scores' iteration chunks, models/gbdt.py:1045-1088), on the TPU
// with path-incidence products (ops/predict_matmul.py:153), three dense
// products a tree because indexed gathers are slow on its matrix unit.  On
// the card a gather from a node table that stays in L2 is cheap, so P1
// walks.
//
// The ensemble is one flat node table (models/tree.py PackedTrees): the
// used internal nodes of every tree one after the other, global child
// pointers (an internal child is its row, a leaf ~j with j its row in
// leaf_value), root[t] the first node of tree t or ~leaf for a one-leaf
// tree.  Routing is Tree::Predict's (tree.h:116-122): a numerical node
// sends v <= thr left (NaN and +inf go right), a categorical node sends
// f32_to_i32_xla(v) == f32_to_i32_xla(thr) left.
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
// Bound on the H100: memory.  P1 must read X once (n*F*4 bytes), the node
// table once and write its output once (K*n*4, or T*n*4 in leaves mode):
// at 1M rows x 28 features and 100 trees of 255 leaves, 112 MB + 0.5 MB +
// 4 MB, 0.035 ms at 3.35 TB/s.  The comparisons, n*T*depth, are far below
// the f32 rate.  This first design is simple and right, not near that
// bound: one thread a row walks every tree in order, so each step is a
// chain of dependent loads (the node's feature, then the row's value, then
// the child) that the node table's L1/L2 residency (0.5 MB for the bench
// model) keeps short.  Staging trees in shared memory, a warp per block of
// rows, or narrower thresholds are later work (ROADMAP queue H).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// float -> int32 as XLA converts (NaN -> 0, saturating at both ends,
// truncation toward zero): the JAX walk's astype(jnp.int32).  Spelled out:
// a C cast of a NaN or out-of-range float is undefined.
__device__ __forceinline__ int f32_to_i32_xla(float x) {
  if (x != x) return 0;
  if (x >= 2147483648.0f) return 2147483647;
  if (x < -2147483648.0f) return -2147483647 - 1;
  return __float2int_rz(x);
}

struct Forest {
  const int* feat;
  const float* thr;
  const unsigned char* dtype;
  const int* left;
  const int* right;
  const float* leaf_value;
  const int* root;
  int depth;  // the deepest path, in internal nodes: a bound on the steps
};

// The global leaf row of tree t for the row at `row`.
__device__ __forceinline__ int walk(const Forest& f, const float* row,
                                    int t) {
  int node = __ldg(f.root + t);
  for (int d = 0; d < f.depth && node >= 0; ++d) {
    const float v = __ldg(row + __ldg(f.feat + node));
    const float thr = __ldg(f.thr + node);
    const bool left = __ldg(f.dtype + node) == 1
                          ? f32_to_i32_xla(v) == f32_to_i32_xla(thr)
                          : v <= thr;
    node = left ? __ldg(f.left + node) : __ldg(f.right + node);
  }
  return ~node;
}

__global__ void __launch_bounds__(kThreads)
    sum_kernel(Forest f, const float* __restrict__ X, int64_t n, int F,
               int K, int n_iter, int chunk_iters, float* __restrict__ out) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (r >= n) return;
  const float* row = X + r * F;
  for (int k = 0; k < K; ++k) {
    float total = 0.0f;
    float part = 0.0f;
    for (int i = 0; i < n_iter; ++i) {
      part = part + __ldg(f.leaf_value + walk(f, row, i * K + k));
      if ((i + 1) % chunk_iters == 0 || i + 1 == n_iter) {
        // the first chunk: 0 + part == part (part is never -0.0)
        total = total + part;
        part = 0.0f;
      }
    }
    out[k * n + r] = total;
  }
}

__global__ void __launch_bounds__(kThreads)
    leaves_kernel(Forest f, const int* __restrict__ leaf_offset,
                  const float* __restrict__ X, int64_t n, int F, int T,
                  int* __restrict__ out) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (r >= n) return;
  const float* row = X + r * F;
  for (int t = 0; t < T; ++t) {
    out[t * n + r] = walk(f, row, t) - __ldg(leaf_offset + t);
  }
}

unsigned blocks(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// Sum mode: out [K, n] f32 from the first n_iter*K trees of the table.
// All pointers are device pointers; `stream` is a cudaStream_t.  Returns
// cudaGetLastError() after the launch (0: launched).
int lgbm_predict_sum(const int* feat, const float* thr,
                     const unsigned char* dtype, const int* left,
                     const int* right, const float* leaf_value,
                     const int* root, int depth, const float* X, int64_t n,
                     int F, int K, int n_iter, int chunk_iters, float* out,
                     void* stream) {
  if (n > 0) {
    const Forest f{feat, thr, dtype, left, right, leaf_value, root, depth};
    sum_kernel<<<blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        f, X, n, F, K, n_iter, chunk_iters, out);
  }
  return (int)cudaGetLastError();
}

// Leaves mode: out [T, n] int32 from the first T trees of the table.
int lgbm_predict_leaves(const int* feat, const float* thr,
                        const unsigned char* dtype, const int* left,
                        const int* right, const int* root,
                        const int* leaf_offset, int depth, const float* X,
                        int64_t n, int F, int T, int* out, void* stream) {
  if (n > 0 && T > 0) {
    const Forest f{feat, thr, dtype, left, right, nullptr, root, depth};
    leaves_kernel<<<blocks(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(f, leaf_offset, X, n,
                                                         F, T, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
