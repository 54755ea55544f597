// causal_attention.cu — causal self-attention over a whole sequence,
// forward and backward, for training and prefill.
//
// Counterpart: the gather branch of brpc_tpu/models/transformer.py:197-203
// (`_attention`, which training differentiates with jax.grad) and the
// same lines of prefill, brpc_tpu/models/decode.py:126-131.  The JAX
// package wrote them in jnp and left them to XLA; there is no Pallas
// kernel.  Same function, same layout:
//   q, k, v, o [B, S, H, hd] (the `bshk` layout of the projections' einsums,
//   read through their strides; the last dim must be contiguous)
//   lse, delta [B, H, S] f32 (written for, and read by, the backward)
//
// Numerics kept from the reference (working type T = bf16 or f32):
//   s    = f32(T(q . k)) / sqrt(hd)     the product is rounded to T, the
//                                       division runs in f32 (JAX promotes
//                                       the T scores against the numpy
//                                       scalar np.sqrt(hd))
//   p    = exp(s - m) / l               f32 softmax over keys t <= s
//   o    = T(sum_t T(p) v)              weights rounded to T before the
//                                       product, so the forward is two
//                                       passes: (m, l), then weights . V
//   backward (jax.grad / autograd of those ops):
//   dW   = T(dO . v)                    the product's cotangent in T
//   D    = sum_t p dW                   f32, exactly as the reference (not
//                                       the rowsum(dO * o) stand-in)
//   dS   = T(p (dW - D) / sqrt(hd))     softmax backward in f32, rounded to
//                                       T by the cast's transpose
//   dq   = T(sum_t dS k)   dk = T(sum_s dS q)   dv = T(sum_s T(p) dO)
// With T = f32 every T() is the identity.  The backward recomputes p from
// lse = m + log(l), so its p may differ from the forward's in the last
// f32 bits.
//
// Which kernel runs: every bf16 kernel (forward, dq, dk/dv) runs on the
// tensor cores (causal_attention_sm90.cu: wgmma, TMA), and the f32
// forward and dq are causal_attention_f32.cu's CUDA-core kernels (one
// pass; dq's two passes over register tiles); the C entries below
// dispatch them there.  This file keeps the f32 dk/dv kernel (TF32
// tensor cores keep 10 mantissa bits, too few for the f32 checks), so
// its T is f32 in every launch; it reads the f32 forward's lse = m +
// log l and the D the f32 dq kernel writes.
//
// Bound on an H100: operations.  At B=8, S=1024, H=8, hd=64 in bf16 the
// forward moves 34 MB (10 us at 3.35 TB/s) and does 8.6 GFLOP (8.7 us at
// 989 TFLOP/s of bf16 tensor cores); the backward moves 67 MB and does
// 21.5 GFLOP.  The dk/dv kernel of this file is the simple first one:
// SIMT f32 FMAs, no tensor cores, so it runs far from that bound (f32
// outside the tensor cores peaks at 67 TFLOP/s).
//
// Design of this file's kernel:
//  - A tile is 64 query rows or 64 key rows.  A block is 256 threads in a
//    16 x 16 grid; thread (ty, tx) owns rows ty + 16 i (i < 4) and
//    columns tx + 16 j of every tile product.
//  - Tiles are staged in shared memory as f32 with padded rows (one float
//    of pad), which keeps every operand read of the products below free
//    of bank conflicts; rows at or past S are staged as zeros.
//  - dkdv, one block per (key tile, h, b): over query tiles kt..end, p
//    and dS (with the D written by the dq kernel, which runs first),
//    then dv += T(p)^T dO, dk += dS^T q.
//  - Causality: tile pairs above the diagonal are never visited; inside
//    the diagonal tile the -1e30 mask of the reference becomes p = 0.
//    Every visited row has key 0, so (m, l) is never empty.
//
// ptxas -v for each instantiation is printed on chip_smoke.py's card line.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a query or key tile
constexpr int kThreads = 256;    // a 16 x 16 grid of threads
constexpr int kLdP = kTile + 1;  // padded row of a [64][64] tile

// Element strides of one [B, S, H, hd] tensor (the last dim is 1).
struct Strides {
  long long b, s, h;
};
// q, k, v, dO
struct Layout {
  Strides t[4];
};

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}

// x rounded to the working type and back.
template <typename T>
__device__ __forceinline__ float round_t(float x) {
  return to_f<T>(from_f<T>(x));
}

// x / y rounded to nearest, given inv = __frcp_rn(y): the product with
// the rounded reciprocal and one FMA correction (Markstein), correctly
// rounded when x, y and x / y are normal (as decode_attention.cu).
__device__ __forceinline__ float div_rn(float x, float y, float inv) {
  const float q = x * inv;
  return fmaf(fmaf(-q, y, x), inv, q);
}

// Rows [row0, row0 + 64) of head (b, h) into an f32 tile [64][HD + 1];
// rows at or past S are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          const Strides& st, int b, int h,
                                          int row0, int S) {
  const T* base = src + b * st.b + h * st.h;
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD;
    const int c = e % HD;
    const int row = row0 + r;
    dst[r * (HD + 1) + c] =
        row < S ? to_f<T>(base[(long long)row * st.s + c]) : 0.0f;
  }
}

// acc[i][j] += sum_{x < K} A(ty + 16 i, x) * B(x, tx + 16 j), with
// A(r, x) = a[r * AR + x * AX] and B(x, c) = b[x * BX + c * BC] in shared
// memory.  The sum runs over x in order, in f32.
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

// The reference's scaled scores of query rows q0 + ty + 16 i against key
// rows k0 + tx + 16 j, -INFINITY above the diagonal.
template <typename T, int HD>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* sQ,
                                       const float* sK, int q0, int k0,
                                       float sqrt_hd, float inv, int tx,
                                       int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.0f;
    }
  }
  tile_mma<4, HD, HD + 1, 1, 1, HD + 1>(s, sQ, sK, tx, ty);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool keep = k0 + tx + 16 * j <= q0 + ty + 16 * i;
      s[i][j] = keep ? div_rn(round_t<T>(s[i][j]), sqrt_hd, inv) : -INFINITY;
    }
  }
}

// dW = T(dO . v) for the tile pair: rows of sDO against rows of sV.
template <typename T, int HD>
__device__ __forceinline__ void dw_tile(float (&w)[4][4], const float* sDO,
                                        const float* sV, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[i][j] = 0.0f;
    }
  }
  tile_mma<4, HD, HD + 1, 1, 1, HD + 1>(w, sDO, sV, tx, ty);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[i][j] = round_t<T>(w[i][j]);
    }
  }
}

// Writes a [64][HD] accumulator as rows row0 + ty + 16 i (< S) of a
// contiguous [B, S, H, HD] tensor.
template <typename T, int HD>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[4][HD / 16],
                                           int b, int h, int row0, int S,
                                           int H, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row < S) {
      T* dst = out + (((long long)b * S + row) * H + h) * HD;
#pragma unroll
      for (int j = 0; j < HD / 16; ++j) {
        dst[tx + 16 * j] = from_f<T>(acc[i][j]);
      }
    }
  }
}

template <int HD>
constexpr int dkdv_smem() {
  return (4 * kTile * (HD + 1) + 2 * kTile * kLdP + 2 * kTile) *
         (int)sizeof(float);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    causal_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, Layout lay, int S, int H,
                float sqrt_hd) {
  constexpr int kLd = HD + 1;
  constexpr int NJ = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * kLd;
  float* sQ = sV + kTile * kLd;
  float* sDO = sQ + kTile * kLd;
  float* sP = sDO + kTile * kLd;
  float* sDS = sP + kTile * kLdP;
  float* sL = sDS + kTile * kLdP;
  float* sD = sL + kTile;
  const int kt = blockIdx.x;  // the first key tiles see the most queries
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = kt * kTile;
  const int n_tiles = (S + kTile - 1) / kTile;
  const float inv = __frcp_rn(sqrt_hd);
  const long long bh = ((long long)b * H + h) * S;

  load_tile<T, HD>(sK, k, lay.t[1], b, h, k0, S);
  load_tile<T, HD>(sV, v, lay.t[2], b, h, k0, S);
  float acc_k[4][NJ];
  float acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      acc_k[i][j] = 0.0f;
      acc_v[i][j] = 0.0f;
    }
  }
  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, HD>(sQ, q, lay.t[0], b, h, q0, S);
    load_tile<T, HD>(sDO, dout, lay.t[3], b, h, q0, S);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      sL[threadIdx.x] = row < S ? lse[bh + row] : INFINITY;  // p = 0
      sD[threadIdx.x] = row < S ? delta[bh + row] : 0.0f;
    }
    __syncthreads();
    // rows: queries ty + 16 i; columns: keys tx + 16 j
    float s[4][4];
    float w[4][4];
    scores<T, HD>(s, sQ, sK, q0, k0, sqrt_hd, inv, tx, ty);
    dw_tile<T, HD>(w, sDO, sV, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - sL[r]);
        const float ds = p * (w[i][j] - sD[r]);
        sP[r * kLdP + tx + 16 * j] = round_t<T>(p);
        sDS[r * kLdP + tx + 16 * j] = round_t<T>(div_rn(ds, sqrt_hd, inv));
      }
    }
    __syncthreads();
    // dv[t] += sum_s T(p)[s][t] dO[s];  dk[t] += sum_s dS[s][t] q[s]
    tile_mma<NJ, kTile, 1, kLdP, kLd, 1>(acc_v, sP, sDO, tx, ty);
    tile_mma<NJ, kTile, 1, kLdP, kLd, 1>(acc_k, sDS, sQ, tx, ty);
  }
  store_rows<T, HD>(dk, acc_k, b, h, k0, S, H, tx, ty);
  store_rows<T, HD>(dv, acc_v, b, h, k0, S, H, tx, ty);
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
int bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dk, void* dv,
             const Layout& lay, int B, int S, int H, float sqrt_hd,
             cudaStream_t st) {
  static const int attr =
      allow_smem(causal_dkdv_kernel<T, HD>, dkdv_smem<HD>());
  if (attr != 0) {
    return attr;
  }
  const dim3 grid((S + kTile - 1) / kTile, H, B);
  causal_dkdv_kernel<T, HD><<<grid, kThreads, dkdv_smem<HD>(), st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, lay, S, H, sqrt_hd);
  return (int)cudaGetLastError();
}

bool valid_shape(int B, int S, int H) {
  return B > 0 && S > 0 && H > 0 && H <= 65535 && B <= 65535;
}

}  // namespace

// The f32 forward and dq (causal_attention_f32.cu): register tiles on the
// CUDA cores, a cp.async ring.
extern "C" int trpc_causal_attention_fwd_f32(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse,
                                             const long long* strides, int B,
                                             int S, int H, int hd,
                                             float sqrt_hd, void* stream);
extern "C" int trpc_causal_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* dq, void* delta, const long long* strides, int B,
    int S, int H, int hd, float sqrt_hd, void* stream);
// The tensor-core kernels (causal_attention_sm90.cu), for bf16.
extern "C" int trpc_causal_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, int B, int S, int H, int hd, float sqrt_hd,
    void* stream);
extern "C" int trpc_causal_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* dq, void* delta, const long long* strides, int B,
    int S, int H, int hd, float sqrt_hd, void* stream);
extern "C" int trpc_causal_attention_bwd_dkdv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int S, int H, int hd, float sqrt_hd,
    void* stream);

// The C entries.  dtype: 0 = bf16, 1 = f32; hd: 16, 64 or 128.  strides:
// (b, s, h) element strides of q, k, v (and dO for the backward), in that
// order; the last dim of each is contiguous.  Outputs (o, dq, dk, dv) are
// contiguous [B, S, H, hd]; lse and delta contiguous [B, H, S] f32.
// Each returns cudaGetLastError() after its launch (0 on success); the
// launch is asynchronous on `stream`.  Each takes bf16 to the
// tensor-core kernels, whose q, k, v and dO views must be 16-byte
// aligned in base and strides (TMA's rule; the wrapper copies any other);
// where the driver refuses the tensor map of input i (0 q, 1 k, 2 v,
// 3 dO) they return -(1000 (i + 1) + its CUresult).  The f32 forward and
// dq copy with 16-byte cp.async, under the same rule.

// return FN<T, hd>(...) for the head dims the kernels take
#define TRPC_CA_HD(T, FN, ...)                  \
  switch (hd) {                                 \
    case 16: return FN<T, 16>(__VA_ARGS__);     \
    case 64: return FN<T, 64>(__VA_ARGS__);     \
    case 128: return FN<T, 128>(__VA_ARGS__);   \
  }

extern "C" int trpc_causal_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         const long long* strides, int B,
                                         int S, int H, int hd, int dtype,
                                         float sqrt_hd, void* stream) {
  if (!valid_shape(B, S, H)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return trpc_causal_attention_fwd_sm90(q, k, v, o, lse, strides, B, S, H,
                                          hd, sqrt_hd, stream);
  }
  if (dtype == 1) {
    return trpc_causal_attention_fwd_f32(q, k, v, o, lse, strides, B, S, H,
                                         hd, sqrt_hd, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int trpc_causal_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* dq, void* delta, const long long* strides, int B,
    int S, int H, int hd, int dtype, float sqrt_hd, void* stream) {
  if (!valid_shape(B, S, H)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return trpc_causal_attention_bwd_dq_sm90(q, k, v, dout, lse, dq, delta,
                                             strides, B, S, H, hd, sqrt_hd,
                                             stream);
  }
  if (dtype == 1) {
    return trpc_causal_attention_bwd_dq_f32(q, k, v, dout, lse, dq, delta,
                                            strides, B, S, H, hd, sqrt_hd,
                                            stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int trpc_causal_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int S, int H, int hd, int dtype,
    float sqrt_hd, void* stream) {
  if (!valid_shape(B, S, H)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return trpc_causal_attention_bwd_dkdv_sm90(q, k, v, dout, lse, delta, dk,
                                               dv, strides, B, S, H, hd,
                                               sqrt_hd, stream);
  }
  const Layout lay = layout_of(strides, 4);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1) {
    TRPC_CA_HD(float, bwd_dkdv, q, k, v, dout, (const float*)lse,
               (const float*)delta, dk, dv, lay, B, S, H, sqrt_hd, st);
  }
  return (int)cudaErrorInvalidValue;
}
