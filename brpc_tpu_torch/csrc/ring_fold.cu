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
// Every bf16 launch at hd 16, 64 and 128 (forward, dq and dk/dv) goes to
// the tensor-core kernels of ring_fold_sm90.cu, and every f32 launch at
// those head dims to the CUDA-core kernels of ring_fold_f32.cu; at hd 8
// (the reference tests' own head dim) every bf16 launch goes to the
// tensor-core kernels of ring_fold_hd8.cu and every f32 launch to the
// CUDA-core kernels of ring_fold_f32_hd8.cu.  This file holds the C
// entries alone, which dispatch by dtype and head dim; the wrapper skips
// a wholly future block without a launch.
#include <cuda_runtime.h>

static bool valid_shape(int B, int Cq, int Ck, int H) {
  return B > 0 && Cq > 0 && Ck > 0 && H > 0 && H <= 65535 && B <= 65535;
}

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
// on the CUDA cores (ring_fold_f32_hd8.cu) for f32.
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
extern "C" int trpc_ring_fold_fwd_f32_hd8(const void* q, const void* k,
                                          const void* v, void* m, void* l,
                                          void* o, const long long* strides,
                                          int B, int Cq, int Ck, int H,
                                          int q_off, int k_off, int causal,
                                          float scale, void* stream);
extern "C" int trpc_ring_fold_bwd_dq_f32_hd8(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int Cq, int Ck, int H, int q_off, int k_off, int causal,
    float scale, void* stream);
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
// kernels at hd 8 (bf16: one cp.async a row; f32: 16-byte copies and
// loads).  Any other dtype or head dim returns cudaErrorInvalidValue.

static bool wide_hd(int hd) { return hd == 16 || hd == 64 || hd == 128; }

static bool tensor_cores(int dtype, int hd) {
  return dtype == 0 && wide_hd(hd);
}

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
  if (dtype == 1 && hd == 8) {
    return trpc_ring_fold_fwd_f32_hd8(q, k, v, m, l, o, strides, B, Cq, Ck,
                                      H, q_off, k_off, causal, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
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
  if (dtype == 1 && hd == 8) {
    return trpc_ring_fold_bwd_dq_f32_hd8(q, k, v, dout, lse, delta, dq,
                                         strides, B, Cq, Ck, H, q_off, k_off,
                                         causal, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
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
