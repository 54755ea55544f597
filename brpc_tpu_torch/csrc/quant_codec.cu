// quant_codec.cu — the int8 codec pass of the quantized merge:
// dequantize(quantize(x)) in per-row groups of 256 values.
//
// Counterpart: brpc_tpu/parallel/quantize.py:fake_quant_int8, which
// MeshParallelChannel(codec="int8") runs on each worker's shard before the
// merge (brpc_tpu/parallel/channels.py:679-680); jnp on the TPU, no Pallas
// kernel.  Same function as the plain version
// (brpc_tpu_torch/ops/quant_codec.py:fake_quant_int8_plain), bit for bit:
//   x [rows, n] contiguous, f32 or bf16; groups are ceil(n / 256) runs of
//   each row (NOT of the flattened tensor), the last one masked with 0s;
//   v     = |x| < FLT_MIN ? 0 : x                (flush-to-zero, explicit:
//                                                 nvcc keeps denormals)
//   scale = max|v| / 127, then flushed the same way
//   q     = scale > 0 ? clamp(rint(v / scale), -127, 127) : 0
//   out   = q * scale
// Division is IEEE (__fdiv_rn), rint rounds half to even, and max and
// clamp keep a NaN as PyTorch's amax and clamp do.  In bf16 each operation
// is computed in f32 and rounded to bf16 (__float2bfloat16_rn) after the
// division by 127, after v / scale and after q * scale, as PyTorch
// computes a bf16 op.
//
// Bound on an H100: memory.  Each value is read once and written once
// (2 * rows * n * sizeof(T) bytes over 3.35 TB/s) against about six
// operations a value, far below the card's operations per byte.
//
// Design: one warp per (row, group).  Lane l holds the group's values
// 8l..8l+7 in registers (two float4 loads in f32, one 16-byte load in
// bf16, where the row is 16-byte aligned and the lane's 8 values are in
// the row; element loads at the masked tail), the group's absmax comes
// from five xor-shuffles, and each lane writes its 8 outputs the way it
// read them.  Blocks of 8 warps walk the (row, group) pairs in a grid-
// stride loop, so the tensor is read and written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 256;               // values per scale group
constexpr int kPerLane = kGroup / 32;     // 8
constexpr int kWarps = 8;                 // warps per block
constexpr long long kMaxBlocks = 1 << 20;

// Round an f32 result to T's precision, as PyTorch stores a T op's result.
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < FLT_MIN ? 0.0f : v;
}

// max that keeps a NaN (fmaxf drops it; torch.amax keeps it)
__device__ __forceinline__ float nanmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  float4 a = reinterpret_cast<const float4*>(p)[0];
  float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fake_quant_int8_kernel(const T* __restrict__ x, T* __restrict__ out,
                       long long rows, long long n, long long groups,
                       bool vec) {
  const int lane = threadIdx.x & 31;
  const long long total = rows * groups;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       w < total; w += stride) {           // uniform in the warp
    const long long row = w / groups;
    const long long first = (w - row * groups) * kGroup + lane * kPerLane;
    const T* src = x + row * n + first;
    T* dst = out + row * n + first;
    const bool whole = vec && first + kPerLane <= n;
    float v[kPerLane];
    if (whole) {
      load8(src, v);
    } else {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        v[k] = first + k < n ? to_f(src[k]) : 0.0f;
      }
    }
    float m = 0.0f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      v[k] = flush(v[k]);
      m = nanmax(m, fabsf(v[k]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    const float scale = flush(rnd<T>(__fdiv_rn(m, 127.0f)));
    const bool live = scale > 0.0f;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      float q = 0.0f;
      if (live) {
        q = rintf(rnd<T>(__fdiv_rn(v[k], scale)));
        q = q > 127.0f ? 127.0f : (q < -127.0f ? -127.0f : q);
      }
      v[k] = rnd<T>(__fmul_rn(q, scale));
    }
    if (whole) {
      store8(dst, v);
    } else {
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        if (first + k < n) put(dst + k, v[k]);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
int launch(const void* x, void* out, long long rows, long long n,
           cudaStream_t st) {
  const long long groups = (n + kGroup - 1) / kGroup;
  long long blocks = (rows * groups + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // 16-byte loads need every row to start 16-byte aligned
  const bool vec = aligned16(x) && aligned16(out) &&
                   (n * (long long)sizeof(T)) % 16 == 0;
  fake_quant_int8_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<T*>(out), rows, n, groups, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 bf16, 1 f32.  Returns a cudaError_t (0: launched).
extern "C" int trpc_fake_quant_int8(const void* x, void* out, long long rows,
                                    long long n, int dtype, void* stream) {
  if (rows <= 0 || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch<__nv_bfloat16>(x, out, rows, n, st);
  }
  if (dtype == 1) {
    return launch<float>(x, out, rows, n, st);
  }
  return (int)cudaErrorInvalidValue;
}
