// One tile of the record partition's compaction as K8 (split_step.cu)
// runs it inside its cooperative launch; the helper is K8's alone.  K6
// (record.cu) writes the same comp and counts with a design of its own
// (rows staged in shared memory, 16-byte stores) and shares only kTile and
// SplitRule with it, so chip_smoke.py holds both K6's and K8's comp against
// the plain compact_tiles.
//
// A split sends column j of the parent's window [begin, begin+pcnt) left
// when its bin of the split feature is <= thr (== thr for a categorical
// split), the bin read from the feature's packed word as _tile_go
// (lightgbm_tpu/ops/record.py:214) reads it.  compact_tile compacts tile t
// (kTile columns, one thread each, blockDim.x == kTile) stably: a
// block-wide exclusive scan (warp ballots + popcounts, then the warp
// totals) gives each column its position among the tile's lefts or
// rights; the column's R = W-1 words above the leaf id go to lane `pos`
// (left) or kTile + `pos` (right) of comp[t] ([R, 2*kTile]), and thread 0
// writes the tile's counts to counts[t] (left) and counts[nt + t] (right).
// Lanes past a run's count are not written.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbm {

constexpr int kTile = 512;  // columns per tile = threads per block
constexpr int kTileWarps = kTile / 32;

// The split decision on one column of the [W, ld] int32 record.
struct SplitRule {
  int fword;       // record row of the split feature's word
  int fshift;      // its bit offset in the word
  unsigned fmask;  // its bit mask after the shift
  int thr;
  int is_cat;
  // from the split feature's packed word w of the column
  __device__ bool go_word(unsigned w) const {
    const int fv = (int)((w >> fshift) & fmask);
    return is_cat ? (fv == thr) : (fv <= thr);
  }
  __device__ bool go(const int* rec, int64_t ld, int64_t col) const {
    return go_word((unsigned)rec[(int64_t)fword * ld + col]);
  }
};

// Tile t of nt over the window; every thread of the block must call it.
__device__ inline void compact_tile(const int* __restrict__ rec, int64_t ld,
                                    int W, int64_t begin, int64_t pcnt,
                                    const SplitRule& rule, int64_t t,
                                    int64_t nt, int* __restrict__ comp,
                                    int* __restrict__ counts) {
  __shared__ int s_warp[2][kTileWarps];
  const int tid = threadIdx.x;
  const int64_t j = t * kTile + tid;  // column within the window
  const bool valid = j < pcnt;
  const bool go = valid && rule.go(rec, ld, begin + j);
  const bool right = valid && !go;
  const unsigned bl = __ballot_sync(0xffffffffu, go);
  const unsigned br = __ballot_sync(0xffffffffu, right);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    s_warp[0][warp] = __popc(bl);
    s_warp[1][warp] = __popc(br);
  }
  __syncthreads();
  int lbase = 0, rbase = 0, ltot = 0, rtot = 0;
  for (int i = 0; i < kTileWarps; ++i) {
    if (i < warp) {
      lbase += s_warp[0][i];
      rbase += s_warp[1][i];
    }
    ltot += s_warp[0][i];
    rtot += s_warp[1][i];
  }
  if (tid == 0) {
    counts[t] = ltot;
    counts[nt + t] = rtot;
  }
  __syncthreads();  // s_warp is read before a next tile of the block
  if (!valid) return;
  const unsigned below = (1u << lane) - 1u;
  const int dest = go ? lbase + __popc(bl & below)
                      : kTile + rbase + __popc(br & below);
  const int R = W - 1;  // every row but the leaf id
  int* out = comp + t * R * 2 * kTile + dest;
  const int* src = rec + begin + j;
  for (int w = 0; w < R; ++w)
    out[(int64_t)w * 2 * kTile] = src[(int64_t)w * ld];
}

}  // namespace lgbm
