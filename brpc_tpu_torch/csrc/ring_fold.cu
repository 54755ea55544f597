// ring_fold.cu — the ring-attention fold: one held K/V block folded into
// the online-softmax state of the local queries, and its backward.
//
// Counterpart: the fold of brpc_tpu/parallel/ring_attention.py:56-71
// (`_ring_body`, run once per ring step; its backward is jax.grad of
// the same lines) and Ulysses' local attention `_dense_local` (:125-133),
// which the port runs as one fold at offsets 0/0.  The JAX package wrote
// them in jnp and left them to XLA; there is no Pallas kernel.  Layout:
//   q, dO [B, Cq, H, hd] and k, v [B, Ck, H, hd] in the working type T
//   (bf16 or f32), read through their (b, s, h) strides, the last dim
//   contiguous
//   m, l, lse, D [B, H, Cq] f32; o, dq [B, H, Cq, hd] f32; dk, dv
//   [B, H, Ck, hd] f32 (contiguous accumulators, updated in place)
//   q_off, k_off: the global positions of the first query and key
//
// Numerics kept from the reference (each op rounded as the jnp op is):
//   s  = f32(T(q . k)) * scale        the product in T (JAX's einsum
//                                      returns the working type), scaled
//                                      in f32; -1e30 where q_off + i <
//                                      k_off + j (causal)
//   m' = max(m, rowmax s)   p = exp(s - m')   a = exp(m - m')
//   l' = l a + sum_j p      o' = o a + p . f32(v)   (an f32 product)
//   backward, per block, from lse = m + log l and D = sum dO . o/l:
//   P  = exp(s - lse)       dP = f32(dO) . f32(v)
//   dS = T(P (dP - D) scale)          the cotangent of the T product is T
//   dq += dS . k    dk += dS^T . q    dv += P^T . f32(dO)   (f32 sums)
// The __f*_rn intrinsics keep each of those ops its own rounding (no
// FMA contraction across them), as the plain PyTorch version rounds.
//
// Bound on an H100 (B=8, C=1024, H=8, hd=64, causal diagonal block, one
// fold; chip_smoke.py's fold_bounds).  A product over the causal half is
// 4.3 GFLOP: q.k, dO.v and the dS products, products of bf16 values,
// take 4.35 us each on the tensor cores (989 TFLOP/s); p.v and P^T.dO,
// f32 products in the reference, 64.2 us each at the CUDA cores' 67
// TFLOP/s.  Each input is read once, the f32 state and accumulators read
// and written: 59.8 MB for the forward, 67.6 MB for dq, 101.2 MB for
// dk/dv (17.8, 20.2, 30.2 us at 3.35 TB/s).  So the forward's least time
// is 68.5 us, dq's 20.2 us, dk/dv's 77.2 us.  In f32 every product runs
// at the CUDA cores' rate.
// The kernels of this file are the simple first ones: SIMT f32 FMAs for
// every product, scores computed twice in the forward, so they run far
// from that bound.  Every bf16 launch at hd 16, 64 and 128 (forward, dq
// and dk/dv) goes to the tensor-core kernels of ring_fold_sm90.cu, and
// every f32 launch at those head dims to the CUDA-core kernels of
// ring_fold_f32.cu; at hd 8 (the reference tests' own head dim) every
// bf16 launch goes to the tensor-core kernels of ring_fold_hd8.cu and the
// f32 dk/dv to the CUDA-core kernel of ring_fold_f32_hd8.cu.  This file's
// kernels are the f32 forward and dq at hd 8 alone; its C entries
// dispatch.
//
// Design (the SIMT kernels; ring_fold_f32_hd8.cu's note says why its
// dk/dv left it):
//  - A tile is 64 query rows or 64 key rows.  A block is 256 threads in a
//    16 x 16 grid; thread (ty, tx) owns rows ty + 16 i (i < 4) and columns
//    tx + 16 j of every tile product; a row's 16 owners are one half-warp
//    and reduce with four xor-shuffles.  Tiles are staged in shared
//    memory as f32 rows of max(hd, 16) + 1 floats (hd 8 is padded with
//    zeros), rows past the block as zeros.
//  - fwd, one block per (query tile, h, b): pass 1 the row max,
//    pass 2 p, its row sum and p . V; then the (m, l, o) update, once
//    per block as the reference's fold.
//    dq, per query tile: dP, dS and dq += dS . K over the key tiles.
//    No atomics: every output element has one owner, so two runs give
//    the same bits.
//  - Causality: a tile pair with every query before every key is all
//    -1e30, whose p = exp(-1e30 - m') is 0 for every row that saw a key
//    before; such pairs are skipped unless some row of the block has
//    not (then its p is 1, as in the reference, and nothing is skipped).
//    The wrapper skips a wholly future block without a launch.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "ring_fold.cuh"

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kLdP = kTile + 1;

struct Strides {
  long long b, s, h;
};
// q, k, v, dO
struct Layout {
  Strides t[4];
};

template <int HD>
struct Dims {
  static constexpr int kW = HD < 16 ? 16 : HD;  // staged row width
  static constexpr int kLd = kW + 1;
  static constexpr int kNJ = kW / 16;
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}

// x rounded to the working type and back.
template <typename T>
__device__ __forceinline__ float round_t(float x);
template <>
__device__ __forceinline__ float round_t<float>(float x) {
  return x;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// Rows [row0, row0 + 64) of head (b, h) into an f32 tile [64][kLd]; rows
// at or past `rows` and columns at or past HD are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          const Strides& st, int b, int h,
                                          int row0, int rows) {
  constexpr int kW = Dims<HD>::kW;
  constexpr int kLd = Dims<HD>::kLd;
  const T* base = src + b * st.b + h * st.h;
  for (int e = threadIdx.x; e < kTile * kW; e += kThreads) {
    const int r = e / kW;
    const int c = e % kW;
    const int row = row0 + r;
    dst[r * kLd + c] = row < rows && c < HD
                           ? to_f<T>(base[(long long)row * st.s + c])
                           : 0.0f;
  }
}

// acc[i][j] += sum_{x < K} A(ty + 16 i, x) * B(x, tx + 16 j), with
// A(r, x) = a[r * AR + x * AX] and B(x, c) = b[x * BX + c * BC] in shared
// memory; the sum runs over x in order, in f32.
template <int NJ, int K, int AR, int AX, int BX, int BC>
__device__ __forceinline__ void tile_mma(float (&acc)[4][NJ], const float* a,
                                         const float* b, int tx, int ty) {
#pragma unroll 8
  for (int x = 0; x < K; ++x) {
    float av[4];
    float bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * AR + x * AX];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      bv[j] = b[x * BX + (tx + 16 * j) * BC];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
  }
}

// Row-by-column products over hd of two staged tiles: out[i][j] =
// sum_x A[ty + 16 i][x] B[tx + 16 j][x].
template <int HD>
__device__ __forceinline__ void dots(float (&out)[4][4], const float* sA,
                                     const float* sB, int tx, int ty) {
  constexpr int kLd = Dims<HD>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[i][j] = 0.0f;
    }
  }
  tile_mma<4, HD, kLd, 1, 1, kLd>(out, sA, sB, tx, ty);
}

// The reference's scores of local query rows q0 + ty + 16 i against local
// keys k0 + tx + 16 j: -1e30 where masked, -INFINITY past the block's
// keys (no key at all: out of every max and sum).
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* sQ,
                                       const float* sK, int q0, int k0,
                                       int Ck, const Pos& pos, int tx,
                                       int ty) {
  dots<HD>(s, sQ, sK, tx, ty);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      const int row = q0 + ty + 16 * i;
      if (key >= Ck) {
        s[i][j] = -INFINITY;
      } else if (pos.causal && pos.q_off + row < pos.k_off + key) {
        s[i][j] = kNeg;
      } else {
        s[i][j] = __fmul_rn(round_t<T>(s[i][j]), pos.scale);
      }
    }
  }
}

template <int HD>
constexpr int fwd_smem() {
  return (3 * kTile * Dims<HD>::kLd + kTile * kLdP) * (int)sizeof(float);
}
template <int HD>
constexpr int dq_smem() {
  return (4 * kTile * Dims<HD>::kLd + kTile * kLdP) * (int)sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    ring_fold_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, float* __restrict__ m,
                         float* __restrict__ l, float* __restrict__ o,
                         Layout lay, int Cq, int Ck, int H, Pos pos) {
  constexpr int kLd = Dims<HD>::kLd;
  constexpr int NJ = Dims<HD>::kNJ;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sP = sV + kTile * kLd;
  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kTile;
  const int n_kt = (Ck + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;

  load_tile<T, HD>(sQ, q, lay.t[0], b, h, q0, Cq);
  float m_old[4];
  float m_new[4];
  bool valid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    valid[i] = row < Cq;
    m_old[i] = valid[i] ? m[bh + row] : kNeg;
    m_new[i] = -INFINITY;
  }
  // pass 1: the block's row max
  for (int kt = 0;
       kt < n_kt && !all_masked(pos, q0, Cq, kt * kTile, kTile); ++kt) {
    __syncthreads();
    load_tile<T, HD>(sK, k, lay.t[1], b, h, kt * kTile, Ck);
    __syncthreads();
    float s[4][4];
    scores<T, HD>(s, sQ, sK, q0, kt * kTile, Ck, pos, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mx =
          fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      m_new[i] = fmaxf(m_new[i], half_warp_max(mx));
    }
  }
  int degen = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_new[i] = fmaxf(m_old[i], m_new[i]);
    degen |= valid[i] && degenerate(m_new[i]);
  }
  degen = __syncthreads_or(degen);
  // pass 2: p, its row sum and p . V
  float sum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[i][j] = 0.0f;
    }
  }
  for (int kt = 0;
       kt < n_kt && (degen || !all_masked(pos, q0, Cq, kt * kTile, kTile));
       ++kt) {
    __syncthreads();
    load_tile<T, HD>(sK, k, lay.t[1], b, h, kt * kTile, Ck);
    load_tile<T, HD>(sV, v, lay.t[2], b, h, kt * kTile, Ck);
    __syncthreads();
    float s[4][4];
    scores<T, HD>(s, sQ, sK, q0, kt * kTile, Ck, pos, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(__fsub_rn(s[i][j], m_new[i]));
        sum[i] += p;
        sP[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
      }
    }
    __syncthreads();
    tile_mma<NJ, kTile, kLdP, 1, kLd, 1>(acc, sP, sV, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float total = half_warp_sum(sum[i]);
    if (!valid[i]) {
      continue;
    }
    const int row = q0 + ty + 16 * i;
    const float alpha = expf(__fsub_rn(m_old[i], m_new[i]));
    if (tx == 0) {
      m[bh + row] = m_new[i];
      l[bh + row] = __fadd_rn(__fmul_rn(l[bh + row], alpha), total);
    }
    float* orow = o + (bh + row) * HD;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < HD) {
        orow[c] = __fadd_rn(__fmul_rn(orow[c], alpha), acc[i][j]);
      }
    }
  }
}

// P and dS of a tile pair (rows: queries, columns: keys); L and D per row.
template <typename T, int HD>
__device__ __forceinline__ void p_and_ds(float (&p)[4][4], float (&ds)[4][4],
                                         const float* sQ, const float* sK,
                                         const float* sDO, const float* sV,
                                         int q0, int k0, int Ck,
                                         const Pos& pos, const float* L,
                                         const float* D, int tx, int ty) {
  float s[4][4];
  float w[4][4];
  scores<T, HD>(s, sQ, sK, q0, k0, Ck, pos, tx, ty);
  dots<HD>(w, sDO, sV, tx, ty);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[i][j] = expf(__fsub_rn(s[i][j], L[i]));
      ds[i][j] = round_t<T>(__fmul_rn(
          __fmul_rn(p[i][j], __fsub_rn(w[i][j], D[i])), pos.scale));
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    ring_fold_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Layout lay, int Cq, int Ck,
                        int H, Pos pos) {
  constexpr int kLd = Dims<HD>::kLd;
  constexpr int NJ = Dims<HD>::kNJ;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kTile * kLd;
  float* sK = sDO + kTile * kLd;
  float* sV = sK + kTile * kLd;
  float* sDS = sV + kTile * kLd;
  const int qt = (int)gridDim.x - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int q0 = qt * kTile;
  const int n_kt = (Ck + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;

  load_tile<T, HD>(sQ, q, lay.t[0], b, h, q0, Cq);
  load_tile<T, HD>(sDO, dout, lay.t[3], b, h, q0, Cq);
  float L[4];  // +inf past the block: p = 0 there
  float D[4];
  int degen = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    L[i] = row < Cq ? lse[bh + row] : INFINITY;
    D[i] = row < Cq ? delta[bh + row] : 0.0f;
    degen |= row < Cq && degenerate(L[i]);
  }
  degen = __syncthreads_or(degen);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc[i][j] = 0.0f;
    }
  }
  for (int kt = 0;
       kt < n_kt && (degen || !all_masked(pos, q0, Cq, kt * kTile, kTile));
       ++kt) {
    __syncthreads();
    load_tile<T, HD>(sK, k, lay.t[1], b, h, kt * kTile, Ck);
    load_tile<T, HD>(sV, v, lay.t[2], b, h, kt * kTile, Ck);
    __syncthreads();
    float p[4][4];
    float ds[4][4];
    p_and_ds<T, HD>(p, ds, sQ, sK, sDO, sV, q0, kt * kTile, Ck, pos, L, D,
                    tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sDS[(ty + 16 * i) * kLdP + tx + 16 * j] = ds[i][j];
      }
    }
    __syncthreads();
    tile_mma<NJ, kTile, kLdP, 1, kLd, 1>(acc, sDS, sK, tx, ty);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < Cq) {
      float* dst = dq + (bh + row) * HD;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = tx + 16 * j;
        if (c < HD) {
          dst[c] = __fadd_rn(dst[c], acc[i][j]);
        }
      }
    }
  }
}

// Dynamic shared memory above 48 KB needs the opt-in once per kernel.
template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

Layout layout_of(const long long* strides, int n) {
  Layout lay{};
  for (int i = 0; i < n; ++i) {
    lay.t[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  return lay;
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, float* m, float* l,
        float* o, const Layout& lay, int B, int Cq, int Ck, int H,
        const Pos& pos, cudaStream_t st) {
  static const int attr =
      allow_smem(ring_fold_fwd_kernel<T, HD>, fwd_smem<HD>());
  if (attr != 0) {
    return attr;
  }
  const dim3 grid((Cq + kTile - 1) / kTile, H, B);
  ring_fold_fwd_kernel<T, HD><<<grid, kThreads, fwd_smem<HD>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, m, l, o, lay, Cq, Ck, H, pos);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq,
           const Layout& lay, int B, int Cq, int Ck, int H, const Pos& pos,
           cudaStream_t st) {
  static const int attr =
      allow_smem(ring_fold_dq_kernel<T, HD>, dq_smem<HD>());
  if (attr != 0) {
    return attr;
  }
  const dim3 grid((Cq + kTile - 1) / kTile, H, B);
  ring_fold_dq_kernel<T, HD><<<grid, kThreads, dq_smem<HD>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dq,
      lay, Cq, Ck, H, pos);
  return (int)cudaGetLastError();
}

bool valid_shape(int B, int Cq, int Ck, int H) {
  return B > 0 && Cq > 0 && Ck > 0 && H > 0 && H <= 65535 && B <= 65535;
}

}  // namespace

// The tensor-core kernels (ring_fold_sm90.cu), for bf16 at hd 16, 64, 128.
extern "C" int trpc_ring_fold_fwd_sm90(const void* q, const void* k,
                                       const void* v, void* m, void* l,
                                       void* o, const long long* strides,
                                       int B, int Cq, int Ck, int H, int hd,
                                       int q_off, int k_off, int causal,
                                       float scale, void* stream);
extern "C" int trpc_ring_fold_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int Cq, int Ck, int H, int hd, int q_off, int k_off, int causal,
    float scale, void* stream);
extern "C" int trpc_ring_fold_bwd_dkdv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int Cq, int Ck, int H, int hd,
    int q_off, int k_off, int causal, float scale, void* stream);
// The CUDA-core kernels (ring_fold_f32.cu), for f32 at hd 16, 64, 128.
extern "C" int trpc_ring_fold_fwd_f32(const void* q, const void* k,
                                      const void* v, void* m, void* l,
                                      void* o, const long long* strides,
                                      int B, int Cq, int Ck, int H, int hd,
                                      int q_off, int k_off, int causal,
                                      float scale, void* stream);
extern "C" int trpc_ring_fold_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int Cq, int Ck, int H, int hd, int q_off, int k_off, int causal,
    float scale, void* stream);
extern "C" int trpc_ring_fold_bwd_dkdv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int Cq, int Ck, int H, int hd,
    int q_off, int k_off, int causal, float scale, void* stream);
// The kernels at hd 8: on the tensor cores (ring_fold_hd8.cu) for bf16,
// and the CUDA-core dk/dv (ring_fold_f32_hd8.cu) for f32.
extern "C" int trpc_ring_fold_fwd_hd8(const void* q, const void* k,
                                      const void* v, void* m, void* l,
                                      void* o, const long long* strides,
                                      int B, int Cq, int Ck, int H,
                                      int q_off, int k_off, int causal,
                                      float scale, void* stream);
extern "C" int trpc_ring_fold_bwd_dq_hd8(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int Cq, int Ck, int H, int q_off, int k_off, int causal,
    float scale, void* stream);
extern "C" int trpc_ring_fold_bwd_dkdv_hd8(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int Cq, int Ck, int H, int q_off,
    int k_off, int causal, float scale, void* stream);
extern "C" int trpc_ring_fold_bwd_dkdv_f32_hd8(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int Cq, int Ck, int H, int q_off,
    int k_off, int causal, float scale, void* stream);

// The C entries.  dtype: 0 = bf16, 1 = f32; hd: 8, 16, 64 or 128.
// strides: (b, s, h) element strides of q, k, v (and dO for the
// backward), in that order; the last dim of each is contiguous.  m, l,
// lse, delta are contiguous [B, H, Cq] f32; o and dq contiguous
// [B, H, Cq, hd] f32, dk and dv [B, H, Ck, hd] f32, all updated in place.
// Each returns cudaGetLastError() after its launch (0 on success); the
// launch is asynchronous on `stream`.  Each takes bf16 at hd 16, 64 and
// 128 to the tensor-core kernels, whose q, k, v and dO views must be
// 16-byte aligned in base and strides (TMA's rule; the wrapper copies
// any other); where the driver refuses the tensor map of input i (0 q,
// 1 k, 2 v, 3 dO) they return -(1000 (i + 1) + its CUresult).  Each
// takes f32 at those head dims to the CUDA-core kernels, whose 16-byte
// cp.async copies need the same alignment of q, k, v (and dO); so do the
// kernels at hd 8 other than the SIMT ones (the bf16 forward, dq and
// dk/dv: one cp.async a row; the f32 dk/dv: 16-byte copies and loads).

static bool wide_hd(int hd) { return hd == 16 || hd == 64 || hd == 128; }

static bool tensor_cores(int dtype, int hd) {
  return dtype == 0 && wide_hd(hd);
}

// return the SIMT FN<float, 8>(...): every other case the kernels take
// went to ring_fold_sm90.cu, ring_fold_f32.cu or ring_fold_hd8.cu
#define TRPC_RF_F32(FN, ...)          \
  if (hd == 8 && dtype == 1) {        \
    return FN<float, 8>(__VA_ARGS__); \
  }                                   \
  return (int)cudaErrorInvalidValue;

extern "C" int trpc_ring_fold_fwd(const void* q, const void* k,
                                  const void* v, void* m, void* l, void* o,
                                  const long long* strides, int B, int Cq,
                                  int Ck, int H, int hd, int dtype,
                                  int q_off, int k_off, int causal,
                                  float scale, void* stream) {
  if (!valid_shape(B, Cq, Ck, H)) {
    return (int)cudaErrorInvalidValue;
  }
  if (tensor_cores(dtype, hd)) {
    return trpc_ring_fold_fwd_sm90(q, k, v, m, l, o, strides, B, Cq, Ck, H,
                                   hd, q_off, k_off, causal, scale, stream);
  }
  if (dtype == 1 && wide_hd(hd)) {
    return trpc_ring_fold_fwd_f32(q, k, v, m, l, o, strides, B, Cq, Ck, H,
                                  hd, q_off, k_off, causal, scale, stream);
  }
  if (dtype == 0 && hd == 8) {
    return trpc_ring_fold_fwd_hd8(q, k, v, m, l, o, strides, B, Cq, Ck, H,
                                  q_off, k_off, causal, scale, stream);
  }
  const Layout lay = layout_of(strides, 3);
  const Pos pos{q_off, k_off, causal, scale};
  cudaStream_t st = (cudaStream_t)stream;
  TRPC_RF_F32(fwd, q, k, v, (float*)m, (float*)l, (float*)o, lay, B, Cq, Ck,
              H, pos, st);
}

extern "C" int trpc_ring_fold_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, const long long* strides,
                                     int B, int Cq, int Ck, int H, int hd,
                                     int dtype, int q_off, int k_off,
                                     int causal, float scale, void* stream) {
  if (!valid_shape(B, Cq, Ck, H)) {
    return (int)cudaErrorInvalidValue;
  }
  if (tensor_cores(dtype, hd)) {
    return trpc_ring_fold_bwd_dq_sm90(q, k, v, dout, lse, delta, dq, strides,
                                      B, Cq, Ck, H, hd, q_off, k_off, causal,
                                      scale, stream);
  }
  if (dtype == 1 && wide_hd(hd)) {
    return trpc_ring_fold_bwd_dq_f32(q, k, v, dout, lse, delta, dq, strides,
                                     B, Cq, Ck, H, hd, q_off, k_off, causal,
                                     scale, stream);
  }
  if (dtype == 0 && hd == 8) {
    return trpc_ring_fold_bwd_dq_hd8(q, k, v, dout, lse, delta, dq, strides,
                                     B, Cq, Ck, H, q_off, k_off, causal,
                                     scale, stream);
  }
  const Layout lay = layout_of(strides, 4);
  const Pos pos{q_off, k_off, causal, scale};
  cudaStream_t st = (cudaStream_t)stream;
  TRPC_RF_F32(bwd_dq, q, k, v, dout, (const float*)lse, (const float*)delta,
              (float*)dq, lay, B, Cq, Ck, H, pos, st);
}

extern "C" int trpc_ring_fold_bwd_dkdv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const long long* strides, int B,
                                       int Cq, int Ck, int H, int hd,
                                       int dtype, int q_off, int k_off,
                                       int causal, float scale,
                                       void* stream) {
  if (!valid_shape(B, Cq, Ck, H)) {
    return (int)cudaErrorInvalidValue;
  }
  if (tensor_cores(dtype, hd)) {
    return trpc_ring_fold_bwd_dkdv_sm90(q, k, v, dout, lse, delta, dk, dv,
                                        strides, B, Cq, Ck, H, hd, q_off,
                                        k_off, causal, scale, stream);
  }
  if (dtype == 1 && wide_hd(hd)) {
    return trpc_ring_fold_bwd_dkdv_f32(q, k, v, dout, lse, delta, dk, dv,
                                       strides, B, Cq, Ck, H, hd, q_off,
                                       k_off, causal, scale, stream);
  }
  if (dtype == 0 && hd == 8) {
    return trpc_ring_fold_bwd_dkdv_hd8(q, k, v, dout, lse, delta, dk, dv,
                                       strides, B, Cq, Ck, H, q_off, k_off,
                                       causal, scale, stream);
  }
  if (dtype == 1 && hd == 8) {
    return trpc_ring_fold_bwd_dkdv_f32_hd8(q, k, v, dout, lse, delta, dk, dv,
                                           strides, B, Cq, Ck, H, q_off,
                                           k_off, causal, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}
