// ring_fold.cuh — what the ring fold's two kernel files share
// (ring_fold.cu, SIMT; ring_fold_sm90.cu, tensor cores): where the held
// block sits, the masked score, and the rule that skips a tile pair.
#pragma once

#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr float kNeg = -1e30f;  // the reference's masked score

// where the held block sits
struct Pos {
  int q_off, k_off, causal;
  float scale;
};

// Every query of the tile pair (local rows q0 .. q0 + tile - 1 of Cq)
// before every key from k0: all -1e30.  Such a pair is skipped unless
// some row of the block is degenerate.
__device__ __forceinline__ bool all_masked(const Pos& pos, int q0, int Cq,
                                           int k0, int tile) {
  const int q_last = pos.q_off + min(q0 + tile - 1, Cq - 1);
  return pos.causal && q_last < pos.k_off + k0;
}

// exp(-1e30 - x) is not 0: a row that has seen no key (x = m' or lse at
// about -1e30), whose masked scores the reference weighs by 1.
__device__ __forceinline__ bool degenerate(float x) {
  return expf(__fsub_rn(kNeg, x)) != 0.0f;
}

}  // namespace
