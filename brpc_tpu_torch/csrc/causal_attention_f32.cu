// causal_attention_f32.cu — the f32 forward of causal attention on the
// CUDA cores: one pass over the keys, register tiles fed by 16-byte
// shared-memory reads, a two-stage cp.async ring for K and V.
//
// Counterpart: the f32 forward of csrc/causal_attention.cu's function
// (the gather branch of brpc_tpu/models/transformer.py:197-203 and
// prefill, brpc_tpu/models/decode.py:126-131), which every f32 forward
// and f32 prefill launches through trpc_causal_attention_fwd; the f32
// dq and dk/dv kernels there read its lse unchanged.  Layout:
//   q, k, v [B, S, H, hd] f32, read through their (b, s, h) strides (the
//   last dim contiguous; base and strides 16-byte multiples, which the
//   wrapper ensures by copying any other view)
//   o [B, S, H, hd] f32 contiguous; lse [B, H, S] f32 = m + log l
// Function, with T = f32 (every rounding to the working type is the
// identity):
//   s = f32(q . k) / sqrt(hd), -inf above the diagonal
//   o = softmax(s) . v
// In f32 the weights are not rounded before their product, so nothing
// forces the two passes the bf16 kernels make: one pass keeps the online
// (m, l) and rescales the accumulator, o_acc = o_acc exp(m_old - m) +
// exp(s - m) . v, and divides by l once at the end.  On the CPU that
// order stays as close to the plain softmax-then-product as the plain
// version is to exact arithmetic (tests/test_torch_causal_attention.py,
// the one-pass f32 legs at S = 1024).  The division by sqrt(hd) stays
// exact: a multiplication by 1 / sqrt(hd) where that is a power of two
// (hd 16, 64), a correctly rounded division otherwise.
//
// Bound on an H100 (B=8, S=1024, H=8, hd=64): operations.  The two
// products over the causal half are 8.6 GFLOP, 128.3 us at the CUDA
// cores' 67 TFLOP/s (TF32 keeps 10 mantissa bits, too few for the f32
// tolerance, and a bf16 split summed by wgmma did not hold f32 either:
// PERF.md, Findings); its 67 MB of traffic take 20 us.  Besides the
// products, each score costs one exponential.
//
// Design:
//  - One block of 128 threads (4 warps) per (64-row query tile, h, b),
//    the longest query tiles first; key tiles 0..qt in order, only the
//    diagonal tile masked.
//  - Register tiles.  Thread t (ra = t / 8, cb = t % 8) owns rows
//    ra + 16 i (i < 4) of the tile: columns cb + 8 j (j < 8) of each
//    [64][64] score tile, and hd / 8 columns of o in groups of four
//    (two at hd 16), group g at 4 cb + 32 g.  A row's eight owners are
//    eight lanes of one warp, which reduce its max and sum with three
//    xor-shuffles.  Each depth step of q.k reads one float4 of each of
//    the thread's 4 Q rows and 8 K rows (4 x 8 outputs, 32 FMAs a step
//    of 4 deep, 12 reads); each 4 keys of p.v read one float4 of p for
//    each of 4 rows and the thread's columns of 4 V rows.
//  - Shared memory holds Q, two stages of K and V in rows padded to
//    hd + 4 floats (4 banks apart, so every read of 4 or 8 consecutive
//    rows is conflict-free) and p in rows of 72 floats (8 banks apart:
//    the scalar stores of a warp's 4 rows x 8 columns and the float4
//    reads of its 4 rows are conflict-free); 103 KB at hd 64, two blocks
//    an SM.
//  - Copies: cp.async, 16 bytes a thread a copy (hd / 2 copies a thread
//    a tile), one commit group per K/V tile: tile i + 1 lands while tile
//    i is computed.  cp.async and not TMA: TMA writes dense rows, whose
//    float4 reads of consecutive rows conflict unless a swizzle is undone
//    at every read of the FMA loop, and it would need a tensor map
//    encoded per launch; padded rows need neither.  Rows at or past S
//    are zero-filled (a src-size of 0), so a masked p of 0 never meets
//    stale memory.
//  - No atomics: each block writes its own rows.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a query or key tile
constexpr int kThreads = 128;    // ra in [0, 16) by cb in [0, 8)
constexpr int kLdP = kTile + 8;  // f32 row stride of the staged p

template <int HD>
struct Stage {
  static constexpr int kLd = HD + 4;  // f32 row stride of Q, K and V
  static constexpr int kFloats = kTile * kLd;
  static constexpr int kCols = HD / 8;             // o columns a thread
  static constexpr int kGroup = kCols < 4 ? kCols : 4;  // a vector
};

// sqrt(HD) a power of two: x / sqrt(HD) is exactly x * (1 / sqrt(HD))
template <int HD>
constexpr bool kPow2 = HD == 16 || HD == 64;

template <int HD>
constexpr int smem_bytes() {  // Q, two stages of K and of V, p
  return (5 * Stage<HD>::kFloats + kTile * kLdP) * (int)sizeof(float);
}

struct Strides {
  long long b, s, h;
};
struct Layout {  // q, k, v
  Strides t[3];
};

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [row0, row0 + 64) of head (b, h) into the padded tile at dst;
// rows at or past S zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          const Strides& st, int b, int h,
                                          int row0, int S) {
  constexpr int kChunks = HD / 4;  // 16-byte copies a row
  const float* base = src + b * st.b + h * st.h;
  const uint32_t d = smem_u32(dst);
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e / kChunks;
    const int c = e % kChunks;
    const int row = row0 + r;
    const bool valid = row < S;
    cp_async16(d + (r * Stage<HD>::kLd + 4 * c) * 4,
               valid ? base + (long long)row * st.s + 4 * c : src, valid);
  }
}

// x / y rounded to nearest, given inv = __frcp_rn(y) (Markstein; as
// causal_attention.cu).
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

// The thread's o columns of one row of a padded tile (or of o): kCols
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

// s[i][j] = sum_x Q[ra + 16 i][x] K[cb + 8 j][x], over x in order.
template <int HD>
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
#pragma unroll 2
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
// in order.
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

// o and lse for one query tile, in one pass over key tiles 0..qt; K and
// V tile i lands in stage i % 2 while tile i - 1 is computed.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    causal_fwd_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, Layout lay, int S, int H,
                          float sqrt_hd) {
  using G = Stage<HD>;
  constexpr int NC = G::kCols;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sK = sQ + G::kFloats;      // two stages
  float* sV = sK + 2 * G::kFloats;  // two stages
  float* sP = sV + 2 * G::kFloats;  // [64][kLdP]
  // blocks start in index order, x fastest: every (h, b) of the longest
  // query tiles first
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int ra = threadIdx.x >> 3;
  const int cb = threadIdx.x & 7;
  const int q0 = qt * kTile;
  const float inv = __frcp_rn(sqrt_hd);

  load_tile<HD>(sQ, q, lay.t[0], b, h, q0, S);
  load_tile<HD>(sK, k, lay.t[1], b, h, 0, S);
  load_tile<HD>(sV, v, lay.t[2], b, h, 0, S);
  cp_async_commit();
  float m[4];
  float l[4];
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[i][c] = 0.0f;
    }
  }
  for (int kt = 0; kt <= qt; ++kt) {
    cp_async_wait_all();
    // tile kt is in place for every thread, and every thread is done
    // with tile kt - 1's stage and with sP
    __syncthreads();
    if (kt < qt) {
      const int st = (kt + 1) & 1;
      load_tile<HD>(sK + st * G::kFloats, k, lay.t[1], b, h,
                    (kt + 1) * kTile, S);
      load_tile<HD>(sV + st * G::kFloats, v, lay.t[2], b, h,
                    (kt + 1) * kTile, S);
      cp_async_commit();
    }
    const int st = kt & 1;
    float s[4][8];
    scores<HD>(s, sQ, sK + st * G::kFloats, ra, cb);
    const bool diagonal = kt == qt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x =
            kPow2<HD> ? s[i][j] * inv : div_rn(s[i][j], sqrt_hd, inv);
        s[i][j] = diagonal && cb + 8 * j > ra + 16 * i ? -INFINITY : x;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], max8(mx));  // finite: key 0 is seen
      const float corr = expf(m[i] - mn);       // 0 at the first tile
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        sum += s[i][j];
        sP[(ra + 16 * i) * kLdP + cb + 8 * j] = s[i][j];
      }
      l[i] = l[i] * corr + sum8(sum);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c] *= corr;
      }
    }
    __syncthreads();  // sP in place
    weights_v<HD>(acc, sP, sV + st * G::kFloats, ra, cb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + 16 * i;
    if (row >= S) {
      continue;
    }
    float* dst = o + (((long long)b * S + row) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < NC / G::kGroup; ++g) {
      float x[4];
#pragma unroll
      for (int e = 0; e < G::kGroup; ++e) {
        x[e] = __fdiv_rn(acc[i][G::kGroup * g + e], l[i]);
      }
      float* p = dst + G::kGroup * (cb + 8 * g);
      if constexpr (G::kGroup == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
      } else {
        *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
      }
    }
    if (cb == 0) {
      lse[((long long)b * H + h) * S + row] = m[i] + logf(l[i]);
    }
  }
}

template <int HD>
int fwd(const float* q, const float* k, const float* v, float* o,
        float* lse, const Layout& lay, int B, int S, int H, float sqrt_hd,
        cudaStream_t stream) {
  const int tiles = (S + kTile - 1) / kTile;
  if ((long long)B * H > 0x7fffffffLL || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int bytes = smem_bytes<HD>();
  static const int attr = (int)cudaFuncSetAttribute(
      causal_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != 0) {
    return attr;
  }
  causal_fwd_f32_kernel<HD><<<dim3(B * H, tiles), kThreads, bytes,
                              stream>>>(q, k, v, o, lse, lay, S, H, sqrt_hd);
  return (int)cudaGetLastError();
}

}  // namespace

// Called by trpc_causal_attention_fwd (causal_attention.cu) for f32, with
// its arguments less the dtype; hd 16, 64 or 128.
extern "C" int trpc_causal_attention_fwd_f32(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse,
                                             const long long* strides, int B,
                                             int S, int H, int hd,
                                             float sqrt_hd, void* stream) {
  Layout lay{};
  for (int i = 0; i < 3; ++i) {
    lay.t[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  }
  const float* args[3] = {(const float*)q, (const float*)k, (const float*)v};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return fwd<16>(args[0], args[1], args[2], (float*)o, (float*)lse, lay,
                     B, S, H, sqrt_hd, st);
    case 64:
      return fwd<64>(args[0], args[1], args[2], (float*)o, (float*)lse, lay,
                     B, S, H, sqrt_hd, st);
    case 128:
      return fwd<128>(args[0], args[1], args[2], (float*)o, (float*)lse, lay,
                      B, S, H, sqrt_hd, st);
  }
  return (int)cudaErrorInvalidValue;
}
