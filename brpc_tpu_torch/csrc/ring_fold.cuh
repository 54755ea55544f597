// ring_fold.cuh — what the ring fold's kernel files share
// (ring_fold_sm90.cu and ring_fold_hd8.cu, tensor cores; ring_fold_f32.cu
// and ring_fold_f32_hd8.cu, CUDA cores): where the held block sits, the
// masked score, and the rules that skip a tile pair.
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

// Local row `row` sees no key of the block: causal, and its position is
// before the first key's.
__device__ __forceinline__ bool sees_no_key(const Pos& pos, int row) {
  return pos.causal && pos.q_off + row < pos.k_off;
}

// The skip rule decided before a loop, from positions and the row's m
// (the forward) or lse (the backward): the row has seen no key (x
// degenerate) and sees none of this block, so its masked scores weigh 1
// and no tile pair may be skipped.  A row that sees a key of the block
// has a finite score, so its m' and lse leave -1e30: this is the rule
// read after a first pass (a two-pass forward's), decided without it.
__device__ __forceinline__ bool unseen_degenerate(const Pos& pos, int row,
                                                  float x) {
  return sees_no_key(pos, row) && degenerate(x);
}

}  // namespace
