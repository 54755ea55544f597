// causal_attention_sm90.cu — the bf16 kernels of causal attention on
// Hopper's tensor cores (forward, dq, dk/dv): wgmma for every product,
// TMA for every tile.
//
// Counterpart: the same function as csrc/causal_attention.cu (the gather
// branch of brpc_tpu/models/transformer.py:197-203 and its jax.grad;
// prefill, brpc_tpu/models/decode.py:126-131), which keeps the f32
// kernels and dispatches every bf16 launch here:
//   q, k, v, dO [B, S, H, hd] bf16, read through their (b, s, h) strides
//   o, dq, dk, dv [B, S, H, hd] bf16 contiguous; lse, D [B, H, S] f32
// with every rounding of the reference in the same place (the list at
// the top of causal_attention.cu): s = f32(T(q . k)) / sqrt(hd), the
// forward's weights T(p) = T(exp(s - m) / l) after a first pass for
// (m, l), dW = T(dO . v), D = sum_t p dW taken exactly in a first pass
// of dq, dS = T(p (dW - D) / sqrt(hd)), dv = T(sum_s T(p) dO) and
// dk = T(sum_s dS q) from p = exp(s - lse) and dq's D.
//
// Bound on an H100: the forward's least time is its bytes, 34 MB at
// B=8, S=1024, H=8, hd=64 (10 us at 3.35 TB/s; its 8.6 GFLOP of the
// causal half's products take 8.7 us at 989 TFLOP/s); dq's is its 12.9
// GFLOP (13 us), dk/dv's its 17.2 GFLOP (17 us).  The kernels do three
// (forward), five (dq) and four (dk/dv) products per causal tile pair,
// the passes' recomputation included, and around them, per score and
// pass, a rounding, a division and an exponential on the CUDA cores: at
// hd 64 that elementwise work, not the tensor cores, is what holds them
// back (times in PERF.md).
//
// Design:
//  - One warpgroup (128 threads) per (64-row tile, h, b): a query tile
//    for the forward and dq, whose longest tiles start first, over every
//    (h, b); a key tile for dk/dv, whose first tiles (which see the most
//    query tiles) start first.  Thread t of warp w holds rows
//    r0 = 16 w + t / 4 and r0 + 8 and columns 8 j + 2 (t % 4) + {0, 1} of
//    every 64-row product (wgmma's accumulator layout), so a row's max,
//    sum and D reduce over the four threads of a quad with two
//    xor-shuffles.
//  - The block's own tiles are loaded once (Q, and dO for dq; K and V for
//    dk/dv).  The other side's tiles of 64 rows stream through a
//    two-stage ring (K and V; Q and dO for dk/dv): TMA
//    (cp.async.bulk.tensor, 4-D maps over (hd, s, h, b) built on the host
//    at each launch) completes on a stage's mbarrier while the warpgroup
//    computes on the other stage; thread 0 issues the next load after a
//    block barrier that retires the stage it refills.  Rows at or past S
//    arrive as zeros (TMA's out-of-bounds fill); the transaction count is
//    always the whole box.
//  - Tiles stay bf16 in shared memory in the swizzle that both TMA and
//    the wgmma descriptors name: 128-byte at hd 64, two 64-column
//    128-byte atoms at hd 128, 32-byte at hd 16.  Q plus two stages of K
//    and V is 40 KB at hd 64; dk/dv's K, V and two stages of Q and dO 48
//    KB.
//  - S = Q.K^T and dW = dO.V^T: wgmma m64n64k16 with both operands
//    K-major in shared memory.  O += T(P).V and dq += dS.K: wgmma
//    m64n{hd}k16 with A from registers (the S accumulator's fragment,
//    rounded and packed as bf16x2: the accumulator layout of two 8-column
//    groups is the A fragment of one 16-deep step) and B the V or K tile
//    read MN-major (the transpose bit), so P and dS never touch shared
//    memory.
//  - dk/dv takes the same products with the operands swapped, S^T =
//    K.Q^T and dW^T = V.dO^T, whose rows are keys and columns queries:
//    T(P)^T and dS^T are then the A fragments of dv += T(P)^T.dO and
//    dk += dS^T.Q, with B the dO or Q tile read MN-major, so no fragment
//    is transposed and nothing is staged.  The row statistics become
//    per column: each ring stage carries its query tile's 64 lse and 64
//    D, which the warpgroup loads beside the TMA (a bulk copy would need
//    S * 4 to be a multiple of 16); past S lse = +inf and D = 0 (p = 0).
//    The diagonal tile keeps key row <= query column, the transpose of
//    the forward's mask.  Four products and one elementwise pass per
//    tile pair.
//  - The elementwise work is kept short: bf16 rounding by one packed
//    conversion per pair; where sqrt(hd) is a power of two (hd 16, 64)
//    the exact division by it is folded into the max and into one FMA
//    that forms s - m rounded once, as the plain version rounds it; the
//    exponential is expf, as in the plain version.
//  - No atomics: blocks write disjoint rows, so the kernels are
//    deterministic.
// The tile, TMA and wgmma helpers are sm90_tile.cuh's.
#include "sm90_tile.cuh"

#include <math.h>

namespace {

// sqrt(HD) a power of two: x / sqrt(HD) is exactly x * (1 / sqrt(HD))
template <int HD>
constexpr bool kPow2 = HD == 16 || HD == 64;

// --- elementwise ------------------------------------------------------

// x / y rounded to nearest, given inv = __frcp_rn(y) (Markstein; as
// causal_attention.cu and decode_attention.cu).
__device__ __forceinline__ float div_rn(float x, float y, float inv) {
  const float q = x * inv;
  return fmaf(fmaf(-q, y, x), inv, q);
}

// x / sqrt(HD), correctly rounded.
template <int HD>
__device__ __forceinline__ float div_sqrt_hd(float x, float sqrt_hd,
                                             float inv) {
  if constexpr (kPow2<HD>) {
    return x * inv;
  } else {
    return div_rn(x, sqrt_hd, inv);
  }
}

// exp(s - y) for a score s held as x in score units (s = x unit
// exactly; see scale_scores): the FMA rounds s - y once, as the plain
// version's subtraction does, then expf (exp(-inf) = 0).
__device__ __forceinline__ float exp_shifted(float x, float y, float unit) {
  return expf(fmaf(x, unit, -y));
}

// The reference's scaled scores from the raw products, in score units:
// rounded to bf16, then divided by sqrt(HD) in f32 where sqrt(HD) is no
// power of two (unit 1); where it is one, the division is exact and is
// left to the consumers (unit 1 / sqrt(HD): the max, the exponentials'
// FMA and lse scale by it exactly).  -INFINITY above the diagonal in the
// diagonal tile: where the key lies after the query, which is column >
// row for S = Q.K^T and row > column for the transposed S^T = K.Q^T
// (kTransposed).  Element e of column group j of a [64][64] accumulator
// lies in row r0 + 8 (e / 2) and column c0 + 8 j + e % 2.
template <int HD, bool kTransposed, bool kDiagonal>
__device__ __forceinline__ void scale_scores_in(float (&s)[32], int r0,
                                                int c0, float sqrt_hd,
                                                float inv) {
  round_bf16(s);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x =
          kPow2<HD> ? s[4 * j + e] : div_rn(s[4 * j + e], sqrt_hd, inv);
      const int row = r0 + 8 * (e >> 1);
      const int col = c0 + 8 * j + (e & 1);
      const bool keep = !kDiagonal || (kTransposed ? row <= col : col <= row);
      s[4 * j + e] = keep ? x : -INFINITY;
    }
  }
}

template <int HD, bool kTransposed = false>
__device__ __forceinline__ void scale_scores(float (&s)[32], bool diagonal,
                                             int r0, int c0, float sqrt_hd,
                                             float inv) {
  if (diagonal) {  // the same for the whole block
    scale_scores_in<HD, kTransposed, true>(s, r0, c0, sqrt_hd, inv);
  } else {
    scale_scores_in<HD, kTransposed, false>(s, r0, c0, sqrt_hd, inv);
  }
}

// Rows row0 + r0 and row0 + r0 + 8 (< S) of a [64][HD] accumulator into a
// contiguous [B, S, H, HD] bf16 tensor.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out,
                                           const float (&acc)[HD / 2], int b,
                                           int h, int row0, int r0, int c0,
                                           int S, int H) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r0 + 8 * r;
    if (row < S) {
      bf16* dst = out + (((long long)b * S + row) * H + h) * HD + c0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int HD>
constexpr int fwd_smem() {  // Q, two stages of K and V, three mbarriers
  return 5 * Geo<HD>::kTileBytes + 3 * 8 + kAlign;
}
template <int HD>
constexpr int dq_smem() {  // Q, dO, two stages of K and V, three mbarriers
  return 6 * Geo<HD>::kTileBytes + 3 * 8 + kAlign;
}
// K, V, two stages of Q and dO, three mbarriers (in 32 bytes), then two
// stages of the query tile's 64 lse and 64 D
constexpr int kStats = 2 * kTile;  // floats of one stage
template <int HD>
constexpr int dkdv_smem() {
  return 6 * Geo<HD>::kTileBytes + 32 + 2 * kStats * 4 + kAlign;
}

// --- the kernels ------------------------------------------------------

// o and lse for one query tile: pass 1 the online row max and sum over
// key tiles 0..qt (K only), pass 2 T(p) . V (K and V).  Load i of the
// ring (2 (qt + 1) in all) fills stage i % 2.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    causal_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, float* __restrict__ lse, int S,
                    int H, float sqrt_hd) {
  constexpr int T = Geo<HD>::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = align_up(smem_u32(smem_raw));
  const uint32_t bar = sQ + 5 * T;  // full[0], full[1], then Q's
  // blocks start in index order, x fastest: every (h, b) of the longest
  // query tiles first
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int c0 = (tid & 3) * 2;
  const int q0 = qt * kTile;
  const int n = qt + 1;

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto issue = [&](int i) {  // thread 0: load i into stage i % 2
    const int st = i & 1;
    const bool second = i >= n;
    const int k0 = (second ? i - n : i) * kTile;
    mbar_expect_tx(bar + 8 * st, (second ? 2 : 1) * T);
    load_tile<HD>(sQ + (1 + st) * T, mk, bar + 8 * st, k0, h, b);
    if (second) {
      load_tile<HD>(sQ + (3 + st) * T, mv, bar + 8 * st, k0, h, b);
    }
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    mbar_init(bar + 16, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar + 16, T);
    load_tile<HD>(sQ, &tq, bar + 16, q0, h, b);
    issue(0);
  }
  const float inv = __frcp_rn(sqrt_hd);
  const float unit = kPow2<HD> ? inv : 1.0f;  // of the scores
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.0f, 0.0f};
  mbar_wait(bar + 16, 0);
  // pass 1: the online row max and sum
  for (int i = 0; i < n; ++i) {
    __syncthreads();  // iteration i - 1 is done with stage (i + 1) % 2
    if (tid == 0) {
      issue(i + 1);  // i + 1 < 2 n
    }
    mbar_wait(bar + 8 * (i & 1), (i >> 1) & 1);
    float s[32];
    reg_fence(s);
    wg_fence();
    issue_ss<HD>(s, sQ, sQ + (1 + (i & 1)) * T);
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    scale_scores<HD>(s, i == qt, r0, c0, sqrt_hd, inv);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      }
      const float mn = fmaxf(m[r], quad_max(mx));
      const float ml = mn * unit;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sum += exp_shifted(s[4 * j + 2 * r], ml, unit);
        sum += exp_shifted(s[4 * j + 2 * r + 1], ml, unit);
      }
      l[r] = l[r] * exp_shifted(m[r], ml, unit) + quad_sum(sum);
      m[r] = mn;
    }
  }
  // pass 2: o = sum_t T(p) v
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  const float ml[2] = {m[0] * unit, m[1] * unit};
  float acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) {
    acc[x] = 0.0f;
  }
  for (int i = n; i < 2 * n; ++i) {
    __syncthreads();
    if (tid == 0 && i + 1 < 2 * n) {
      issue(i + 1);
    }
    mbar_wait(bar + 8 * (i & 1), (i >> 1) & 1);
    float s[32];
    reg_fence(s);
    wg_fence();
    issue_ss<HD>(s, sQ, sQ + (1 + (i & 1)) * T);
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    scale_scores<HD>(s, i - n == qt, r0, c0, sqrt_hd, inv);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      s[x] = div_rn(exp_shifted(s[x], ml[r], unit), l[r], rl[r]);
    }
    uint32_t a[4][4];
    pack_a(a, s);
    product_rs<HD>(acc, a, sQ + (3 + (i & 1)) * T);
  }
  store_rows<HD>(o, acc, b, h, q0, r0, c0, S, H);
  if ((tid & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + 8 * r;
      if (row < S) {
        lse[((long long)b * H + h) * S + row] = m[r] * unit + logf(l[r]);
      }
    }
  }
}

// dq and D for one query tile: pass 1 D = sum_t p dW over key tiles
// 0..qt, pass 2 dS and dq = sum_t dS k; both passes load K and V.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    causal_dq_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, bf16* __restrict__ dq,
                   float* __restrict__ delta, int S, int H, float sqrt_hd) {
  constexpr int T = Geo<HD>::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = align_up(smem_u32(smem_raw));
  const uint32_t sDO = sQ + T;
  const uint32_t bar = sQ + 6 * T;  // full[0], full[1], then Q's and dO's
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;  // longest first
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int c0 = (tid & 3) * 2;
  const int q0 = qt * kTile;
  const int n = qt + 1;
  const long long bh = ((long long)b * H + h) * S;

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto issue = [&](int i) {  // thread 0: K and V tile i % n into stage i % 2
    const int st = i & 1;
    const int k0 = (i < n ? i : i - n) * kTile;
    mbar_expect_tx(bar + 8 * st, 2 * T);
    load_tile<HD>(sQ + (2 + st) * T, mk, bar + 8 * st, k0, h, b);
    load_tile<HD>(sQ + (4 + st) * T, mv, bar + 8 * st, k0, h, b);
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    mbar_init(bar + 16, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar + 16, 2 * T);
    load_tile<HD>(sQ, &tq, bar + 16, q0, h, b);
    load_tile<HD>(sDO, &tdo, bar + 16, q0, h, b);
    issue(0);
  }
  const float inv = __frcp_rn(sqrt_hd);
  const float unit = kPow2<HD> ? inv : 1.0f;  // see fwd
  float L[2];  // lse; +inf past S: p = 0 there
  float D[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    L[r] = row < S ? lse[bh + row] : INFINITY;
  }
  mbar_wait(bar + 16, 0);
  // pass 1: D = sum_t p dW, per tile and then over the tiles
  for (int i = 0; i < n; ++i) {
    __syncthreads();
    if (tid == 0) {
      issue(i + 1);
    }
    mbar_wait(bar + 8 * (i & 1), (i >> 1) & 1);
    float s[32];
    float w[32];
    reg_fence(s);
    reg_fence(w);
    wg_fence();
    issue_ss<HD>(s, sQ, sQ + (2 + (i & 1)) * T);
    issue_ss<HD>(w, sDO, sQ + (4 + (i & 1)) * T);
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    reg_fence(w);
    scale_scores<HD>(s, i == qt, r0, c0, sqrt_hd, inv);
    round_bf16(w);
    float part[2] = {0.0f, 0.0f};
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      part[r] = fmaf(exp_shifted(s[x], L[r], unit), w[x], part[r]);
    }
    D[0] += part[0];
    D[1] += part[1];
  }
  D[0] = quad_sum(D[0]);
  D[1] = quad_sum(D[1]);
  // pass 2: dS = T(p (dW - D) / sqrt(hd)), dq = sum_t dS k
  float acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) {
    acc[x] = 0.0f;
  }
  for (int i = n; i < 2 * n; ++i) {
    __syncthreads();
    if (tid == 0 && i + 1 < 2 * n) {
      issue(i + 1);
    }
    mbar_wait(bar + 8 * (i & 1), (i >> 1) & 1);
    const uint32_t sK = sQ + (2 + (i & 1)) * T;
    float s[32];
    float w[32];
    reg_fence(s);
    reg_fence(w);
    wg_fence();
    issue_ss<HD>(s, sQ, sK);
    issue_ss<HD>(w, sDO, sQ + (4 + (i & 1)) * T);
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    reg_fence(w);
    scale_scores<HD>(s, i - n == qt, r0, c0, sqrt_hd, inv);
    round_bf16(w);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      const float p = exp_shifted(s[x], L[r], unit);
      s[x] = div_sqrt_hd<HD>(p * (w[x] - D[r]), sqrt_hd, inv);
    }
    uint32_t a[4][4];
    pack_a(a, s);
    product_rs<HD>(acc, a, sK);
  }
  store_rows<HD>(dq, acc, b, h, q0, r0, c0, S, H);
  if ((tid & 3) == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + 8 * r;
      if (row < S) {
        delta[bh + row] = D[r];
      }
    }
  }
}

// dk and dv for one key tile kt, in one pass over query tiles kt.. (load
// i of the ring fills stage i % 2 with query tile kt + i's Q and dO,
// beside which the warpgroup stages that tile's lse and D).  The scores
// are taken transposed, S^T = K.Q^T and dW^T = V.dO^T: rows are keys and
// columns queries, so T(P)^T and dS^T, packed, are the A fragments of
// dv += T(P)^T.dO and dk += dS^T.Q.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    causal_dkdv_sm90(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int H, float sqrt_hd) {
  constexpr int T = Geo<HD>::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = align_up(raw);
  const uint32_t sV = sK + T;
  const uint32_t bar = sK + 6 * T;  // full[0], full[1], then K's and V's
  // stage st: the query tile's lse (+inf past S: p = 0) and D (0 past S)
  float* stats = reinterpret_cast<float*>(smem_raw + (bar + 32 - raw));
  // blocks start in index order, x fastest: every (h, b) of the first key
  // tiles, which see the most query tiles, first
  const int kt = blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int c0 = (tid & 3) * 2;
  const int k0 = kt * kTile;
  const int n = (int)gridDim.y - kt;
  const long long bh = ((long long)b * H + h) * S;

  const CUtensorMap* mq = &tq;
  const CUtensorMap* mdo = &tdo;
  auto issue = [&](int i) {  // thread 0: Q and dO tile kt + i into stage i % 2
    const int st = i & 1;
    const int q0 = (kt + i) * kTile;
    mbar_expect_tx(bar + 8 * st, 2 * T);
    load_tile<HD>(sK + (2 + st) * T, mq, bar + 8 * st, q0, h, b);
    load_tile<HD>(sK + (4 + st) * T, mdo, bar + 8 * st, q0, h, b);
  };
  // thread t's share of query tile kt + i's statistics: lse of row t
  // (t < 64), else D of row t - 64
  auto stat = [&](int i) {
    const int row = (kt + i) * kTile + (tid & (kTile - 1));
    if (tid < kTile) {
      return row < S ? lse[bh + row] : INFINITY;
    }
    return row < S ? delta[bh + row] : 0.0f;
  };
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 8, 1);
    mbar_init(bar + 16, 1);
    mbar_init_fence();
  }
  stats[tid] = stat(0);
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar + 16, 2 * T);
    load_tile<HD>(sK, &tk, bar + 16, k0, h, b);
    load_tile<HD>(sV, &tv, bar + 16, k0, h, b);
    issue(0);
  }
  const float inv = __frcp_rn(sqrt_hd);
  const float unit = kPow2<HD> ? inv : 1.0f;  // see fwd
  float acc_k[HD / 2];
  float acc_v[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) {
    acc_k[x] = 0.0f;
    acc_v[x] = 0.0f;
  }
  mbar_wait(bar + 16, 0);
  for (int i = 0; i < n; ++i) {
    // iteration i - 1 is done with stage (i + 1) % 2; tile i's statistics
    // are in place
    __syncthreads();
    if (tid == 0 && i + 1 < n) {
      issue(i + 1);
    }
    const float next = i + 1 < n ? stat(i + 1) : 0.0f;  // stored below
    mbar_wait(bar + 8 * (i & 1), (i >> 1) & 1);
    const uint32_t sQ = sK + (2 + (i & 1)) * T;
    const uint32_t sDO = sK + (4 + (i & 1)) * T;
    float s[32];
    float w[32];
    reg_fence(s);
    reg_fence(w);
    wg_fence();
    issue_ss<HD>(s, sK, sQ);
    issue_ss<HD>(w, sV, sDO);
    wg_commit();
    wg_wait_all();
    reg_fence(s);
    reg_fence(w);
    scale_scores<HD, true>(s, i == 0, r0, c0, sqrt_hd, inv);
    round_bf16(w);
    // column c0 + 8 j + e % 2 is a query: its lse and D
    const float* L = stats + kStats * (i & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(L + c0 + 8 * j);
      const float2 d =
          *reinterpret_cast<const float2*>(L + kTile + c0 + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const float p = exp_shifted(s[x], e & 1 ? l.y : l.x, unit);
        w[x] = div_sqrt_hd<HD>(p * (w[x] - (e & 1 ? d.y : d.x)), sqrt_hd,
                               inv);
        s[x] = p;
      }
    }
    uint32_t ap[4][4];
    uint32_t ads[4][4];
    pack_a(ap, s);
    pack_a(ads, w);
    reg_fence(acc_v);
    reg_fence(acc_k);
    wg_fence();
    issue_rs<HD>(acc_v, ap, sDO);
    issue_rs<HD>(acc_k, ads, sQ);
    wg_commit();
    wg_wait_all();
    reg_fence(acc_v);
    reg_fence(acc_k);
    if (i + 1 < n) {
      stats[kStats * ((i + 1) & 1) + tid] = next;
    }
  }
  store_rows<HD>(dk, acc_k, b, h, k0, r0, c0, S, H);
  store_rows<HD>(dv, acc_v, b, h, k0, r0, c0, S, H);
}

// --- host -------------------------------------------------------------

template <int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const long long* st, int B, int S, int H, float sqrt_hd,
        cudaStream_t stream) {
  if ((long long)B * H > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap m[3];
  const int e = tensor_maps<HD, 3>(m, {q, k, v}, st, B, {S, S, S}, H);
  if (e != 0) {
    return e;
  }
  constexpr int bytes = fwd_smem<HD>();
  static const int attr = allow_smem(causal_fwd_sm90<HD>, bytes);
  if (attr != 0) {
    return attr;
  }
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  causal_fwd_sm90<HD><<<grid, kThreads, bytes, stream>>>(
      m[0], m[1], m[2], (bf16*)o, lse, S, H, sqrt_hd);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, void* dq, float* delta, const long long* st,
           int B, int S, int H, float sqrt_hd, cudaStream_t stream) {
  if ((long long)B * H > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap m[4];
  const int e =
      tensor_maps<HD, 4>(m, {q, k, v, dout}, st, B, {S, S, S, S}, H);
  if (e != 0) {
    return e;
  }
  constexpr int bytes = dq_smem<HD>();
  static const int attr = allow_smem(causal_dq_sm90<HD>, bytes);
  if (attr != 0) {
    return attr;
  }
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  causal_dq_sm90<HD><<<grid, kThreads, bytes, stream>>>(
      m[0], m[1], m[2], m[3], lse, (bf16*)dq, delta, S, H, sqrt_hd);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, void* dk, void* dv,
             const long long* st, int B, int S, int H, float sqrt_hd,
             cudaStream_t stream) {
  if ((long long)B * H > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap m[4];
  const int e =
      tensor_maps<HD, 4>(m, {q, k, v, dout}, st, B, {S, S, S, S}, H);
  if (e != 0) {
    return e;
  }
  constexpr int bytes = dkdv_smem<HD>();
  static const int attr = allow_smem(causal_dkdv_sm90<HD>, bytes);
  if (attr != 0) {
    return attr;
  }
  const dim3 grid(B * H, (S + kTile - 1) / kTile);
  causal_dkdv_sm90<HD><<<grid, kThreads, bytes, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, (bf16*)dk, (bf16*)dv, S, H,
      sqrt_hd);
  return (int)cudaGetLastError();
}

}  // namespace

// Called by the C entries of causal_attention.cu for bf16 (same
// arguments, without the dtype); hd 16, 64 or 128.
#define TRPC_SM90_DISPATCH(FN, ...)                      \
  switch (hd) {                                          \
    case 16: return FN<16>(__VA_ARGS__);                 \
    case 64: return FN<64>(__VA_ARGS__);                 \
    case 128: return FN<128>(__VA_ARGS__);               \
  }                                                      \
  return (int)cudaErrorInvalidValue

extern "C" int trpc_causal_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const long long* strides, int B, int S, int H, int hd, float sqrt_hd,
    void* stream) {
  TRPC_SM90_DISPATCH(fwd, q, k, v, o, (float*)lse, strides, B, S, H, sqrt_hd,
                     (cudaStream_t)stream);
}

extern "C" int trpc_causal_attention_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, void* dq, void* delta, const long long* strides, int B,
    int S, int H, int hd, float sqrt_hd, void* stream) {
  TRPC_SM90_DISPATCH(bwd_dq, q, k, v, dout, (const float*)lse, dq,
                     (float*)delta, strides, B, S, H, sqrt_hd,
                     (cudaStream_t)stream);
}

extern "C" int trpc_causal_attention_bwd_dkdv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int S, int H, int hd, float sqrt_hd,
    void* stream) {
  TRPC_SM90_DISPATCH(bwd_dkdv, q, k, v, dout, (const float*)lse,
                     (const float*)delta, dk, dv, strides, B, S, H, sqrt_hd,
                     (cudaStream_t)stream);
}
