// causal_attention.cu — causal self-attention over a whole sequence,
// forward and backward, for training and prefill: the C entries, which
// choose the kernel by dtype.
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
// tensor cores (causal_attention_sm90.cu: wgmma, TMA), every f32 kernel
// on the CUDA cores (causal_attention_f32.cu: register tiles, cp.async;
// TF32 tensor cores keep 10 mantissa bits, too few for the f32 checks).
// Bounds and designs: those files' notes.

#include <cuda_runtime.h>

namespace {

bool valid_shape(int B, int S, int H) {
  return B > 0 && S > 0 && H > 0 && H <= 65535 && B <= 65535;
}

}  // namespace

// The f32 kernels (causal_attention_f32.cu): register tiles on the CUDA
// cores, cp.async copies.
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
extern "C" int trpc_causal_attention_bwd_dkdv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int S, int H, int hd, float sqrt_hd,
    void* stream);
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
// 3 dO) they return -(1000 (i + 1) + its CUresult).  The f32 kernels
// copy with 16-byte cp.async, under the same rule.

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
  if (dtype == 1) {
    return trpc_causal_attention_bwd_dkdv_f32(q, k, v, dout, lse, delta, dk,
                                              dv, strides, B, S, H, hd,
                                              sqrt_hd, stream);
  }
  return (int)cudaErrorInvalidValue;
}
