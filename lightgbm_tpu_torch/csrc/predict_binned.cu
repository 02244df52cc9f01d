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
// (`s.at[c].add(scale * predict_binned(tree, X))`).  The port's walk
// before this kernel (models/tree.py _walk) ran eight small launches and a
// host sync a level, up to num_leaves - 1 levels a tree, over an int32
// copy of the bins.
//
// The table (models/tree.py BinnedTrees): the used internal nodes of the
// listed trees one after the other, each one 16-byte record
// {split_feature | categorical << 31, threshold_bin, left, right} read with
// one load a visit; global child pointers (an internal child is its row, a
// leaf ~j with j its row in leaf_value).  `meta[t]` is {root, class, the
// scale's f32 bits, 0} of the t-th listed tree.  Routing is Tree::GetLeaf's
// in bin space (tree.cpp:98-122): a numerical node sends bin <=
// threshold_bin left, a categorical node bin == threshold_bin.
//
// One thread owns one (class, row) score.  It walks the listed trees of
// its class in list order, each to its leaf with a loop on the device
// (bounded by the largest tree's internal nodes, never a host-known
// depth), and applies each add in order:
//   - update mode: s = s + f32(scale_t) * leaf_t(row), the product and the
//     sum each rounded to float32 (no contraction: built with -fmad=false,
//     and the intrinsics say so), the JAX package's eager ops exactly;
//   - replay mode: add_valid_dataset's order (JAX gbdt.py:478-489): tree
//     i*K + k's leaf into a chunk sum that starts from zero every
//     chunk_iters iterations, each chunk sum added in order to the score.
// So the scores equal the plain version's (models/tree.py binned_update_ /
// binned_replay_) bitwise.
//
// Bins are read in their stored dtype, feature-major [F, n] (uint8, or
// uint16: the template's Bin), so no wider copy of the matrix is made.
//
// What bounds it on the H100.  Bytes: each score read and written once
// (8 bytes a (class, row)) and the bins read once (n*F, or 2*n*F):
// 36 MB at 1M x 28 uint8 bins, 0.0107 ms at 3.35 TB/s; 7.2 MB, 0.0021 ms,
// at 200k valid rows.  A walk reads only the bins on its path (~depth of
// the F bytes of a row), from 32-byte sectors shared by the warp's
// neighbouring rows at the root and scattered below it, and each visit is
// a dependent chain (the record, then the row's bin, then the next
// record), so a simple kernel stays latency-bound above that floor.  The
// design keeps it simple: a thread a (class, row), 256 threads a block,
// the records and meta through the read-only cache.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const int4* node;        // [nodes] records
  const float* leaf_value; // [leaves]
  const int4* meta;        // [T] {root, class, scale bits, 0}
  const void* bins;        // [F, n] uint8 / uint16
  int64_t n;
  int K;
  int T;
  int max_steps;   // the most internal nodes of one listed tree
  int chunk_iters; // replay mode
  float* scores;   // [K, n], updated in place
};

template <typename Bin, bool kReplay>
__global__ void __launch_bounds__(kThreads) p2_kernel(Args a) {
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= a.n * a.K) return;
  const int c = static_cast<int>(q / a.n);
  const int64_t row = q - c * a.n;
  const Bin* __restrict__ bins = static_cast<const Bin*>(a.bins) + row;
  float s = a.scores[q];
  float part = 0.0f;
  for (int t = 0; t < a.T; ++t) {
    const int4 m = __ldg(a.meta + t);
    if (m.y != c) continue;
    int nd = m.x;
    for (int d = 0; d < a.max_steps && nd >= 0; ++d) {
      const int4 rec = __ldg(a.node + nd);
      const int f = rec.x & 0x7fffffff;
      const int b = static_cast<int>(__ldg(bins + static_cast<int64_t>(f) * a.n));
      const bool left = rec.x < 0 ? b == rec.y : b <= rec.y;
      nd = left ? rec.z : rec.w;
    }
    const float v = __ldg(a.leaf_value + ~nd);
    if (kReplay) {
      part = __fadd_rn(part, v);
      const int i = t / a.K;
      if ((i + 1) % a.chunk_iters == 0 || t + a.K >= a.T) {
        s = __fadd_rn(s, part);
        part = 0.0f;
      }
    } else {
      s = __fadd_rn(s, __fmul_rn(__int_as_float(m.z), v));
    }
  }
  a.scores[q] = s;
}

template <typename Bin>
void launch_bins(const Args& a, bool replay, unsigned grid, cudaStream_t s) {
  if (replay) {
    p2_kernel<Bin, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    p2_kernel<Bin, false><<<grid, kThreads, 0, s>>>(a);
  }
}

}  // namespace

extern "C" {

// The listed trees' walks over [F, n] bins of `bin_bytes` bytes (1: uint8,
// 2: uint16) into the [K, n] f32 scores, in place: update mode (replay 0)
// adds f32(scale_t) * leaf_t to class meta[t].y's score for each listed
// tree in order; replay mode (replay 1) sums tree i*K + k's leaves in
// chunks of `chunk_iters` iterations from zero and adds each chunk sum in
// order (T a multiple of K, meta[t].y == t % K).  All pointers are device
// pointers; `stream` is a cudaStream_t.  Returns cudaGetLastError() after
// the launch (0: launched), or cudaErrorInvalidValue for arguments it does
// not take.
int lgbm_p2_walk(const int* node, const float* leaf_value, const int* meta,
                 const void* bins, int bin_bytes, int64_t n, int K, int T,
                 int max_steps, int replay, int chunk_iters, float* scores,
                 void* stream) {
  if (K < 1 || T < 0 || max_steps < 0 || (bin_bytes != 1 && bin_bytes != 2) ||
      (replay && (chunk_iters < 1 || T % K != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || T == 0) return static_cast<int>(cudaGetLastError());
  Args a{reinterpret_cast<const int4*>(node), leaf_value,
         reinterpret_cast<const int4*>(meta), bins, n, K, T, max_steps,
         chunk_iters, scores};
  const int64_t cells = n * K;
  const unsigned grid = static_cast<unsigned>((cells + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bin_bytes == 1) {
    launch_bins<uint8_t>(a, replay != 0, grid, s);
  } else {
    launch_bins<uint16_t>(a, replay != 0, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
