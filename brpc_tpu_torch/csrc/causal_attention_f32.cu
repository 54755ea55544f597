// causal_attention_f32.cu — causal attention in f32 on the CUDA cores:
// the forward in one pass over the keys, the backward's dq (with the row
// sums D that dk/dv reads) and dk/dv; register tiles fed by 16-byte
// shared-memory reads, cp.async copies (the machinery of f32_tile.cuh).
//
// Counterpart: the f32 launches of csrc/causal_attention.cu's function
// (the gather branch of brpc_tpu/models/transformer.py:197-203, its
// jax.grad, and prefill, brpc_tpu/models/decode.py:126-131), which every
// f32 launch of trpc_causal_attention_fwd, _bwd_dq and _bwd_dkdv reaches.
// Layout:
//   q, k, v, dO [B, S, H, hd] f32, read through their (b, s, h) strides
//   (the last dim contiguous; base and strides 16-byte multiples, which
//   the wrapper ensures by copying any other view)
//   o, dq, dk, dv [B, S, H, hd] f32 contiguous; lse, D [B, H, S] f32
// Function, with T = f32 (every rounding to the working type is the
// identity):
//   s  = f32(q . k) / sqrt(hd), -inf above the diagonal
//   o  = softmax(s) . v         lse = m + log l
//   p  = exp(s - lse)   dW = dO . v   D = sum_t p dW (exactly as the
//   reference's jax.grad of its softmax; not the rowsum(dO * o) stand-in)
//   dS = p (dW - D) / sqrt(hd)    dq = sum_t dS k
//   dk = sum_s dS q               dv = sum_s p dO
// where dq normalises the row's p by its sum l = sum_t p (w = p / l, D =
// sum_t w dW, dS from w), as the reference's softmax weights sum to 1:
// p from a rounded lse sums to 1 only within lse's rounding (about 1e-6
// at a wide range of q and k), and taken as it is that error enters
// every dS as -(l - 1) D p, where D is large (v x 8: dq read 2.5-2.7x
// the plain version's error against f64 at hd 16 on an H100).  l and
// sum_t p dW are summed with their rounding errors carried (Kahan): a
// lane's plain sum rounds S / 8 times at D's magnitude, and that left dq
// 2.2x the plain version's error at S = 1024, hd 16 (both on the CPU in
// the kernel's order, tests/test_torch_causal_attention.py).
// In f32 the weights are not rounded before their product, so nothing
// forces the two passes the bf16 kernels make: one pass keeps the online
// (m, l) and rescales the accumulator, o_acc = o_acc exp(m_old - m) +
// exp(s - m) . v, and divides by l once at the end.  On the CPU that
// order stays as close to the plain softmax-then-product as the plain
// version is to exact arithmetic (tests/test_torch_causal_attention.py,
// the one-pass f32 legs at S = 1024).  dq keeps the SIMT kernel's order
// of work per tile: D summed over a row's key tiles first, then dS.
// dk/dv computes each score, p and dS as the row-major kernels do (the
// same bits) and sums dk and dv over the queries in order, straight into
// the accumulator, as the SIMT kernel it replaced did: the same bits as
// it.  The division by sqrt(hd) stays exact: a multiplication by
// 1 / sqrt(hd) where that is a power of two (hd 16, 64), a correctly
// rounded division otherwise.
//
// Bound on an H100 (B=8, S=1024, H=8, hd=64): operations.  The forward's
// two products over the causal half are 8.6 GFLOP, 128.3 us at the CUDA
// cores' 67 TFLOP/s (TF32 keeps 10 mantissa bits, too few for the f32
// tolerance, and a bf16 split summed by wgmma did not hold f32 either:
// PERF.md, Findings); its 67 MB of traffic take 20 us.  dq's function
// needs three products (q.k, dO.v, dS.k: 192.5 us); taking D exactly
// from p and dW before any dS costs the kernel a second pass over q.k
// and dO.v, five products, 321 us at that rate.  dk/dv's four products
// (q.k, dO.v, p.dO, dS.q: 17.2 GFLOP) take 256.7 us at that rate.
// Besides the products, each score costs one exponential a pass.
//
// Design:
//  - One block of 128 threads (4 warps) per (64-row query tile, h, b)
//    (dk/dv: per 64-row key tile), the longest tiles first; the forward
//    and dq visit key tiles 0..qt in order, dk/dv query tiles kt..end,
//    only the diagonal tile masked.  Each thread owns 4 rows
//    (f32_tile.cuh): a 4 x 8 register tile of each score tile, hd / 8
//    accumulator columns.
//  - Forward: Q resident, K and V through the ring, p staged at stride
//    72 for p . V; Q, two stages of K and V, p: 103 KB at hd 64, two
//    blocks an SM.
//  - dq: Q and dO resident; K and V through the ring over key tiles
//    0..qt twice, one ring for both passes (pass 2's tile 0 lands during
//    pass 1's last tile).  Pass 1: the thread's tiles of dW = dO.V and
//    s = Q.K, p = exp(s - lse), l += p and D += p dW in registers
//    (compensated), summed over the row's 8 lanes at the end, D divided
//    by l; nothing staged.  Pass 2: dW and s again, w = p / l (a product with 1 / l),
//    dS in registers, staged at stride 72 into the current V stage once
//    every thread has read V for its dW (a barrier; V is dead then), and
//    dq_acc += dS . K.  A V stage is max(64 (hd + 4), 64 x 72) floats,
//    so Q, dO, two stages of K and V are 104 KB at hd 64: two blocks an
//    SM, as the forward.
//  - dk/dv: transposed tiles, rows keys and columns queries.  K and V
//    resident; per query tile one stage of Q and dO and its lse and D
//    (load_stats), then S^T = K . Q^T (scores: fmaf commutes and the
//    depth order is the forward's, so each score is its bit), P^T staged
//    at stride 72, dW^T = V . dO^T, dS^T from the thread's own staged p,
//    staged beside it; dv += P^T . dO and dk += dS^T . Q (weights_v).
//    Only one 4 x 8 tile is live beside the two accumulators, which
//    keeps hd 128 clear of a spill.  K, V, Q, dO, P^T, dS^T: 104.5 KB at
//    hd 64, two blocks an SM: the other block computes while one waits
//    for its query tile (one block an SM at hd 128).  A two-stage
//    cp.async ring of Q and dO fits only one block an SM at hd 64, and
//    ran 0.70 ms against this layout's 0.57 on an H100 (PERF.md,
//    Findings).
//  - No atomics: each block writes its own rows, so two runs give the
//    same bits.
//
// ptxas -v for each instantiation is printed on chip_smoke.py's card line.
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "f32_tile.cuh"

namespace {

template <int HD>
constexpr int smem_bytes() {  // Q, two stages of K and of V, p
  return (5 * Stage<HD>::kFloats + kTile * kLdP) * (int)sizeof(float);
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
    float x[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      x[c] = __fdiv_rn(acc[i][c], l[i]);
    }
    store_cols<HD>(o + (((long long)b * S + row) * H + h) * HD, x, cb);
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

// One step of dq's key-tile ring: step n of 2 nt (tile n % nt, pass
// n / nt) is in place in stage n % 2 once every thread has waited and
// met the barrier, which also frees stage (n + 1) % 2 for step n + 1's
// copies.  Then the thread's dW = dO . V and p = exp(s - L) of the tile.
template <int HD>
__device__ __forceinline__ void dq_step(
    float (&w)[4][8], float (&p)[4][8], int n, int nt, int qt, float* sQ,
    float* sDO, float* sK, float* sV, const float* k, const float* v,
    const Layout& lay, int b, int h, int S, const float (&L)[4], int ra,
    int cb, float sqrt_hd, float inv) {
  using G = Stage<HD>;
  cp_async_wait_all();
  __syncthreads();
  if (n + 1 < 2 * nt) {
    const int next = (n + 1) % nt;
    const int st = (n + 1) & 1;
    load_tile<HD>(sK + st * G::kFloats, k, lay.t[1], b, h, next * kTile, S);
    load_tile<HD>(sV + st * kDqVStage<HD>, v, lay.t[2], b, h, next * kTile,
                  S);
    cp_async_commit();
  }
  const int st = n & 1;
  scores<HD>(w, sDO, sV + st * kDqVStage<HD>, ra, cb);
  scores<HD>(p, sQ, sK + st * G::kFloats, ra, cb);
  const bool diagonal = n % nt == qt;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x =
          kPow2<HD> ? p[i][j] * inv : div_rn(p[i][j], sqrt_hd, inv);
      // -inf above the diagonal, and L = +inf past S: p = 0 there
      p[i][j] = expf(__fsub_rn(
          diagonal && cb + 8 * j > ra + 16 * i ? -INFINITY : x, L[i]));
    }
  }
}

// sum += x, the rounding error of the add kept in c and taken off the
// next term (Kahan): the true sum is sum - c.  A lane of dq's pass 1 sums
// up to S / 8 terms at the row sum's magnitude.
__device__ __forceinline__ void kahan_add(float& sum, float& c, float x) {
  const float y = __fsub_rn(x, c);
  const float t = __fadd_rn(sum, y);
  c = __fsub_rn(__fsub_rn(t, sum), y);
  sum = t;
}

// dq and D for one query tile: pass 1 D = sum_t p dW over key tiles
// 0..qt, pass 2 dS and dq = sum_t dS k over the same tiles.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    causal_dq_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ dq, float* __restrict__ delta,
                         Layout lay, int S, int H, float sqrt_hd) {
  using G = Stage<HD>;
  constexpr int NC = G::kCols;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sDO = sQ + G::kFloats;
  float* sK = sDO + G::kFloats;     // two stages
  float* sV = sK + 2 * G::kFloats;  // two stages; dS over V in pass 2
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;  // longest first
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int ra = threadIdx.x >> 3;
  const int cb = threadIdx.x & 7;
  const int q0 = qt * kTile;
  const int nt = qt + 1;
  const float inv = __frcp_rn(sqrt_hd);
  const long long bh = ((long long)b * H + h) * S;

  load_tile<HD>(sQ, q, lay.t[0], b, h, q0, S);
  load_tile<HD>(sDO, dout, lay.t[3], b, h, q0, S);
  load_tile<HD>(sK, k, lay.t[1], b, h, 0, S);
  load_tile<HD>(sV, v, lay.t[2], b, h, 0, S);
  cp_async_commit();
  float L[4];  // +inf past S: p = 0 there
  float D[4];
  float l[4];
  float cD[4];  // the rounding errors the sums carry (kahan_add)
  float cl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + 16 * i;
    L[i] = row < S ? lse[bh + row] : INFINITY;
    D[i] = l[i] = cD[i] = cl[i] = 0.0f;
  }
  // pass 1: l = sum_t p and sum_t p dW
  for (int n = 0; n < nt; ++n) {
    float w[4][8];
    float p[4][8];
    dq_step<HD>(w, p, n, nt, qt, sQ, sDO, sK, sV, k, v, lay, b, h, S, L, ra,
                cb, sqrt_hd, inv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kahan_add(D[i], cD[i], __fmul_rn(p[i][j], w[i][j]));
        kahan_add(l[i], cl[i], p[i][j]);
      }
    }
  }
  // D = sum_t w dW, and l becomes 1 / l, which turns p into w (rows past
  // S, where l = 0, are never stored)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = __fsub_rn(sum8(l[i]), sum8(cl[i]));
    D[i] = __fdiv_rn(__fsub_rn(sum8(D[i]), sum8(cD[i])), l[i]);
    l[i] = __frcp_rn(l[i]);
  }
  // pass 2: dS, then dq = sum_t dS k
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[i][c] = 0.0f;
    }
  }
  for (int n = nt; n < 2 * nt; ++n) {
    float w[4][8];
    float p[4][8];
    dq_step<HD>(w, p, n, nt, qt, sQ, sDO, sK, sV, k, v, lay, b, h, S, L, ra,
                cb, sqrt_hd, inv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float ds = p[i][j] * l[i] * (w[i][j] - D[i]);
        p[i][j] = kPow2<HD> ? ds * inv : div_rn(ds, sqrt_hd, inv);
      }
    }
    const int st = n & 1;
    float* sDS = sV + st * kDqVStage<HD>;  // [64][kLdP] over the V tile
    __syncthreads();  // every thread has read V for its dW
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sDS[(ra + 16 * i) * kLdP + cb + 8 * j] = p[i][j];
      }
    }
    __syncthreads();  // dS in place
    weights_v<HD>(acc, sDS, sK + st * G::kFloats, ra, cb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + 16 * i;
    if (row >= S) {
      continue;
    }
    store_cols<HD>(dq + (((long long)b * S + row) * H + h) * HD, acc[i], cb);
    if (cb == 0) {
      delta[bh + row] = D[i];
    }
  }
}

template <int HD>
constexpr int dkdv_smem_bytes() {  // K, V, Q, dO, P^T, dS^T, lse, D
  return (4 * Stage<HD>::kFloats + 2 * kTile * kLdP + 2 * kTile) *
         (int)sizeof(float);
}

// dk and dv for one key tile, over query tiles kt..end on transposed
// tiles: rows keys ra + 16 i, columns queries cb + 8 j.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    causal_dkdv_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           Layout lay, int S, int H, float sqrt_hd) {
  using G = Stage<HD>;
  constexpr int NC = G::kCols;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + G::kFloats;
  float* sQ = sV + G::kFloats;
  float* sDO = sQ + G::kFloats;
  float* sPT = sDO + G::kFloats;     // [64][kLdP]: P^T, rows keys
  float* sDST = sPT + kTile * kLdP;  // [64][kLdP]: dS^T
  float* sL = sDST + kTile * kLdP;   // [64]: lse of the query tile
  float* sD = sL + kTile;            // [64]: D of the query tile
  // blocks start in index order, x fastest: every (h, b) of key tile 0,
  // which visits every query tile, first
  const int kt = (int)blockIdx.y;
  const int n_qt = (int)gridDim.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int ra = threadIdx.x >> 3;
  const int cb = threadIdx.x & 7;
  const int k0 = kt * kTile;
  const float inv = __frcp_rn(sqrt_hd);
  const long long bh = ((long long)b * H + h) * S;

  // K and V resident; committed with the first query tile's copies
  load_tile<HD>(sK, k, lay.t[1], b, h, k0, S);
  load_tile<HD>(sV, v, lay.t[2], b, h, k0, S);
  float acc_k[4][NC];
  float acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc_k[i][c] = 0.0f;
      acc_v[i][c] = 0.0f;
    }
  }
  for (int qt = kt; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every thread is done with the last query tile
    load_tile<HD>(sQ, q, lay.t[0], b, h, q0, S);
    load_tile<HD>(sDO, dout, lay.t[3], b, h, q0, S);
    load_stats(sL, sD, lse + bh, delta + bh, q0, S);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the query tile in place for every thread
    const bool diagonal = qt == kt;
    float t[4][8];
    scores<HD>(t, sK, sQ, ra, cb);  // S^T = K . Q^T, the scores' bits
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cb + 8 * j;
        const float x =
            kPow2<HD> ? t[i][j] * inv : div_rn(t[i][j], sqrt_hd, inv);
        // a key t sees the queries s >= t; lse = +inf past S: p = 0
        sPT[(ra + 16 * i) * kLdP + c] =
            diagonal && ra + 16 * i > c
                ? 0.0f
                : expf(__fsub_rn(x, col_lse(sL, q0, S, c)));
      }
    }
    // a compiler fence: p is read back from shared memory below, not
    // kept in 32 registers across the next product
    asm volatile("" ::: "memory");
    scores<HD>(t, sV, sDO, ra, cb);  // dW^T = V . dO^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at = (ra + 16 * i) * kLdP + cb + 8 * j;
        const float ds = sPT[at] * (t[i][j] - sD[cb + 8 * j]);  // its own p
        sDST[at] = kPow2<HD> ? ds * inv : div_rn(ds, sqrt_hd, inv);
      }
    }
    __syncthreads();  // P^T and dS^T in place
    // dv += P^T . dO, dk += dS^T . Q, summed over the queries in order
    weights_v<HD>(acc_v, sPT, sDO, ra, cb);
    weights_v<HD>(acc_k, sDST, sQ, ra, cb);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ra + 16 * i;
    if (key < S) {
      const long long at = (((long long)b * S + key) * H + h) * HD;
      store_cols<HD>(dk + at, acc_k[i], cb);
      store_cols<HD>(dv + at, acc_v[i], cb);
    }
  }
}

template <int HD>
int bwd_dkdv(const float* q, const float* k, const float* v,
             const float* dout, const float* lse, const float* delta,
             float* dk, float* dv, const Layout& lay, int B, int S, int H,
             float sqrt_hd, cudaStream_t stream) {
  const int tiles = (S + kTile - 1) / kTile;
  if ((long long)B * H > 0x7fffffffLL || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int bytes = dkdv_smem_bytes<HD>();
  static const int attr = (int)cudaFuncSetAttribute(
      causal_dkdv_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != 0) {
    return attr;
  }
  causal_dkdv_f32_kernel<HD><<<dim3(B * H, tiles), kThreads, bytes,
                               stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                         lay, S, H, sqrt_hd);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_dq(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, float* dq, float* delta, const Layout& lay,
           int B, int S, int H, float sqrt_hd, cudaStream_t stream) {
  const int tiles = (S + kTile - 1) / kTile;
  if ((long long)B * H > 0x7fffffffLL || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int bytes = dq_smem_bytes<HD>();
  static const int attr = (int)cudaFuncSetAttribute(
      causal_dq_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != 0) {
    return attr;
  }
  causal_dq_f32_kernel<HD><<<dim3(B * H, tiles), kThreads, bytes, stream>>>(
      q, k, v, dout, lse, dq, delta, lay, S, H, sqrt_hd);
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
  const Layout lay = layout_of(strides, 3);
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

// Called by trpc_causal_attention_bwd_dq (causal_attention.cu) for f32,
// with its arguments less the dtype; hd 16, 64 or 128.
extern "C" int trpc_causal_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* dq, void* delta, const long long* strides, int B,
    int S, int H, int hd, float sqrt_hd, void* stream) {
  const Layout lay = layout_of(strides, 4);
  const float* args[4] = {(const float*)q, (const float*)k, (const float*)v,
                          (const float*)dout};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return bwd_dq<16>(args[0], args[1], args[2], args[3],
                        (const float*)lse, (float*)dq, (float*)delta, lay, B,
                        S, H, sqrt_hd, st);
    case 64:
      return bwd_dq<64>(args[0], args[1], args[2], args[3],
                        (const float*)lse, (float*)dq, (float*)delta, lay, B,
                        S, H, sqrt_hd, st);
    case 128:
      return bwd_dq<128>(args[0], args[1], args[2], args[3],
                         (const float*)lse, (float*)dq, (float*)delta, lay, B,
                         S, H, sqrt_hd, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Called by trpc_causal_attention_bwd_dkdv (causal_attention.cu) for f32,
// with its arguments less the dtype; hd 16, 64 or 128.
extern "C" int trpc_causal_attention_bwd_dkdv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int S, int H, int hd, float sqrt_hd,
    void* stream) {
  const Layout lay = layout_of(strides, 4);
  const float* args[4] = {(const float*)q, (const float*)k, (const float*)v,
                          (const float*)dout};
  const float* stats[2] = {(const float*)lse, (const float*)delta};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return bwd_dkdv<16>(args[0], args[1], args[2], args[3], stats[0],
                          stats[1], (float*)dk, (float*)dv, lay, B, S, H,
                          sqrt_hd, st);
    case 64:
      return bwd_dkdv<64>(args[0], args[1], args[2], args[3], stats[0],
                          stats[1], (float*)dk, (float*)dv, lay, B, S, H,
                          sqrt_hd, st);
    case 128:
      return bwd_dkdv<128>(args[0], args[1], args[2], args[3], stats[0],
                           stats[1], (float*)dk, (float*)dv, lay, B, S, H,
                           sqrt_hd, st);
  }
  return (int)cudaErrorInvalidValue;
}
