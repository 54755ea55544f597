// f32_tile.cuh — what the f32 kernels on the CUDA cores share
// (causal_attention_f32.cu: the causal forward, dq and dk/dv;
// ring_fold_f32.cu: the ring fold's forward, dq and dk/dv; at hd 8
// ring_fold_f32_hd8.cu's forward, dq and dk/dv and ring_fold_hd8.cu's
// cp.async rings):
// the padded-row geometry of a staged tile, the cp.async copies that fill
// it, the row reductions, the per-column row statistics of the
// transposed (dk/dv) tiles, the two register-tile products, rows against
// rows over hd (scores) and a staged [64][64] weight tile times 64 rows
// of hd (weights_v), and the hd-8 kernels' rows of 8 floats (f32_row).
//
// Geometry.  A block is 128 threads (4 warps); a tile is 64 query or key
// rows.  Thread t (ra = t / 8, cb = t % 8) owns rows ra + 16 i (i < 4):
// columns cb + 8 j (j < 8) of each [64][64] product, and hd / 8 columns
// of each [64][hd] accumulator in groups of four (two at hd 16), group g
// at 4 cb + 32 g.  The dk/dv kernels take the products transposed: rows
// are keys, columns queries, so a thread needs lse and D of its 8 query
// columns, staged beside the query tile (load_stats, col_lse).  A row's
// eight owners are eight lanes of one warp, which reduce its max and sum
// with three xor-shuffles.  Each depth step
// of a score product reads one float4 of each of the thread's 4 A rows
// and 8 B rows (32 FMAs a step of 4 deep, 12 reads); each 4 keys of a
// weights product read one float4 of weights for each of 4 rows and the
// thread's columns of 4 V rows.
//
// Shared memory: Q, K, V (and dO) tiles in rows padded to hd + 4 floats
// (4 banks apart, so every float4 read of 4 or 8 consecutive rows is
// conflict-free), weights (p, dS) in rows of 72 floats (8 banks apart:
// the scalar stores of a warp's 4 rows x 8 columns and the float4 reads
// of its 4 rows are conflict-free).  Copies are cp.async, 16 bytes a
// thread a copy, so every row's base must be a 16-byte multiple (the
// wrappers copy any other view); rows past the tensor are zero-filled (a
// src-size of 0), so a masked weight of 0 never meets stale memory.
// cp.async and not TMA: TMA writes dense rows, whose float4 reads of
// consecutive rows conflict unless a swizzle is undone at every read of
// the FMA loop; padded rows need neither that nor a tensor map encoded
// per launch.  The dq kernels stage dS over the V tile of the stage they
// are on once every thread has read V, so a V stage of theirs holds
// either (kDqVStage).
#pragma once

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a query or key tile
constexpr int kThreads = 128;    // ra in [0, 16) by cb in [0, 8)
constexpr int kLdP = kTile + 8;  // f32 row stride of staged weights

template <int HD>
struct Stage {
  static constexpr int kLd = HD + 4;  // f32 row stride of Q, K, V, dO
  static constexpr int kFloats = kTile * kLd;
  static constexpr int kCols = HD / 8;             // o columns a thread
  static constexpr int kGroup = kCols < 4 ? kCols : 4;  // a vector
};

// floats of one dq V stage: a V tile, or the dS tile staged over it
template <int HD>
constexpr int kDqVStage = Stage<HD>::kFloats > kTile * kLdP
                              ? Stage<HD>::kFloats
                              : kTile * kLdP;

template <int HD>
constexpr int dq_smem_bytes() {  // Q, dO, two stages of K and of V / dS
  return (4 * Stage<HD>::kFloats + 2 * kDqVStage<HD>) * (int)sizeof(float);
}

// sqrt(HD) a power of two: x / sqrt(HD) is exactly x * (1 / sqrt(HD))
template <int HD>
constexpr bool kPow2 = HD == 16 || HD == 64;

// Element strides of one [B, S, H, hd] tensor (the last dim is 1).
struct Strides {
  long long b, s, h;
};

// The strides of q, k, v (and dO), in that order.
struct Layout {
  Strides t[4];
};

// A Layout from a C entry's (b, s, h) strides of n tensors.
inline Layout layout_of(const long long* strides, int n) {
  Layout lay{};
  for (int i = 0; i < n; ++i) {
    lay.t[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  return lay;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global src into shared dst; zeros where !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes from global src into shared dst; zeros where !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of head (b, h) into the padded tile at dst;
// rows at or past S zero-filled.  NT: the block's threads, which share
// the copies.
template <int HD, int NT = kThreads>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          const Strides& st, int b, int h,
                                          int row0, int S) {
  constexpr int kChunks = HD / 4;  // 16-byte copies a row
  const float* base = src + b * st.b + h * st.h;
  const uint32_t d = smem_u32(dst);
  for (int e = threadIdx.x; e < kTile * kChunks; e += NT) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    const int row = row0 + r;
    const bool valid = row < S;
    cp_async16(d + (r * Stage<HD>::kLd + 4 * c) * 4,
               valid ? base + (long long)row * st.s + 4 * c : src, valid);
  }
}

// The row statistics of query rows [q0, q0 + 64) of one (b, h): lse[q0 +
// r] into sL[r] and D[q0 + r] into sD[r] (lse and D point at the head's
// row 0), 4-byte copies in the same group as the tile's (any alignment);
// rows at or past C zero-filled, which col_lse reads as +inf.
static_assert(kThreads == 2 * kTile, "one thread a statistic");
__device__ __forceinline__ void load_stats(float* sL, float* sD,
                                           const float* lse,
                                           const float* delta, int q0,
                                           int C) {
  const int r = threadIdx.x % kTile;
  const bool valid = q0 + r < C;
  const float* src = threadIdx.x < kTile ? lse : delta;
  float* dst = threadIdx.x < kTile ? sL : sD;
  cp_async4(smem_u32(dst + r), valid ? src + q0 + r : src, valid);
}

// lse of query column c of the staged tile: +inf past C, so that p =
// exp(s - lse) = 0 there.
__device__ __forceinline__ float col_lse(const float* sL, int q0, int C,
                                         int c) {
  return q0 + c < C ? sL[c] : INFINITY;
}

// x / y rounded to nearest, given inv = __frcp_rn(y): the product with
// the rounded reciprocal and one FMA correction (Markstein), correctly
// rounded when x, y and x / y are normal (as decode_attention.cu).
__device__ __forceinline__ float div_rn(float x, float y, float inv) {
  const float q = x * inv;
  return fmaf(fmaf(-q, y, x), inv, q);
}

__device__ __forceinline__ float max8(float x) {  // over a row's 8 lanes
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// The thread's accumulator columns of one row of a padded tile: kCols
// floats, vector g at column kGroup (cb + 8 g).
template <int HD>
__device__ __forceinline__ void cols_of(float (&x)[Stage<HD>::kCols],
                                        const float* row, int cb) {
  using G = Stage<HD>;
#pragma unroll
  for (int g = 0; g < G::kCols / G::kGroup; ++g) {
    const float* p = row + G::kGroup * (cb + 8 * g);
    if constexpr (G::kGroup == 4) {
      const float4 t = *reinterpret_cast<const float4*>(p);
      x[4 * g] = t.x;
      x[4 * g + 1] = t.y;
      x[4 * g + 2] = t.z;
      x[4 * g + 3] = t.w;
    } else {
      const float2 t = *reinterpret_cast<const float2*>(p);
      x[2 * g] = t.x;
      x[2 * g + 1] = t.y;
    }
  }
}

// s[i][j] = sum_x A[ra + 16 i][x] B[cb + 8 j][x], over x in order: two
// padded tiles, rows against rows (q.k, dO.v).  kUnroll depth steps are
// unrolled (each holds 48 operand registers): 1 where two hd-128
// accumulators leave no room for two.
template <int HD, int kUnroll = 2>
__device__ __forceinline__ void scores(float (&s)[4][8], const float* sQ,
                                       const float* sK, int ra, int cb) {
  constexpr int kLd = Stage<HD>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[i][j] = 0.0f;
    }
  }
#pragma unroll(kUnroll)
  for (int x = 0; x < HD; x += 4) {
    float4 a[4];
    float4 c[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(sQ + (ra + 16 * i) * kLd + x);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      c[j] = *reinterpret_cast<const float4*>(sK + (cb + 8 * j) * kLd + x);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
        s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
        s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
        s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
      }
    }
  }
}

// acc[i][c] += sum_t sP[ra + 16 i][t] V[t][column c], over the 64 keys t
// in order: staged weights (stride kLdP) times a padded tile (p.v, dS.k).
template <int HD>
__device__ __forceinline__ void weights_v(float (&acc)[4][Stage<HD>::kCols],
                                          const float* sP, const float* sV,
                                          int ra, int cb) {
  using G = Stage<HD>;
#pragma unroll 2
  for (int t = 0; t < kTile; t += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = *reinterpret_cast<const float4*>(sP + (ra + 16 * i) * kLdP + t);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float vv[G::kCols];
      cols_of<HD>(vv, sV + (t + u) * G::kLd, cb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = u == 0 ? p[i].x : u == 1 ? p[i].y
                                        : u == 2 ? p[i].z
                                                 : p[i].w;
#pragma unroll
        for (int c = 0; c < G::kCols; ++c) {
          acc[i][c] = fmaf(w, vv[c], acc[i][c]);
        }
      }
    }
  }
}

// The 8 values of a row of 8 floats at src (16-byte aligned, in shared or
// device memory): the hd-8 kernels' rows.
__device__ __forceinline__ void f32_row(float (&f)[8], const float* src) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  f[0] = a.x;
  f[1] = a.y;
  f[2] = a.z;
  f[3] = a.w;
  f[4] = b.x;
  f[5] = b.y;
  f[6] = b.z;
  f[7] = b.w;
}

// Stores the thread's columns of one accumulator row to dst (a row of a
// contiguous f32 tensor, 16-byte aligned).
template <int HD>
__device__ __forceinline__ void store_cols(float* dst,
                                           const float (&x)[Stage<HD>::kCols],
                                           int cb) {
  using G = Stage<HD>;
#pragma unroll
  for (int g = 0; g < G::kCols / G::kGroup; ++g) {
    float* p = dst + G::kGroup * (cb + 8 * g);
    if constexpr (G::kGroup == 4) {
      *reinterpret_cast<float4*>(p) =
          make_float4(x[4 * g], x[4 * g + 1], x[4 * g + 2], x[4 * g + 3]);
    } else {
      *reinterpret_cast<float2*>(p) = make_float2(x[2 * g], x[2 * g + 1]);
    }
  }
}

// dst[c] += x[c] over the thread's columns of one accumulator row, each
// add rounded once: the fold's carried state, updated in place through
// scalar accesses (it need not be 16-byte aligned).
template <int HD>
__device__ __forceinline__ void add_cols(float* dst,
                                         const float (&x)[Stage<HD>::kCols],
                                         int cb) {
  using G = Stage<HD>;
#pragma unroll
  for (int g = 0; g < G::kCols / G::kGroup; ++g) {
#pragma unroll
    for (int e = 0; e < G::kGroup; ++e) {
      const int c = G::kGroup * (cb + 8 * g) + e;
      dst[c] = __fadd_rn(dst[c], x[G::kGroup * g + e]);
    }
  }
}

}  // namespace
