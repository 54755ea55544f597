// ring_fold_sm90.cu — the bf16 ring fold's forward, dq and dk/dv on
// Hopper: wgmma for the products of bf16 values, f32 FMAs on the CUDA
// cores for p's f32 products, TMA for every tile.
//
// Counterpart: the same function as csrc/ring_fold.cu (the fold of
// brpc_tpu/parallel/ring_attention.py:56-71, its jax.grad, and
// `_dense_local` :125-133), whose C entries send every bf16 launch at
// head dims 16, 64 and 128 here (and the f32 forward there to
// ring_fold_f32.cu).  Layout and
// roundings are that file's:
//   q, dO [B, Cq, H, hd] and k, v [B, Ck, H, hd] bf16, read through their
//   (b, s, h) strides; m, l, lse, D [B, H, Cq] f32; o, dq [B, H, Cq, hd]
//   f32; dk, dv [B, H, Ck, hd] f32 (contiguous, updated in place)
//   s  = f32(bf16(q . k)) * scale, -1e30 where q_off + i < k_off + j
//   m' = max(m, rowmax s)   p = exp(s - m')   a = exp(m - m')
//   l' = l a + sum_j p      o' = o a + p . f32(v)
//   P = exp(s - lse)   dP = f32(dO) . f32(v)   dS = bf16(P (dP - D) scale)
//   dq += dS . k       dk += dS^T . q     dv += P^T . f32(dO)
//
// The f32 products of p.  p . f32(v) and P^T . f32(dO) are products of an
// f32 p with bf16 values, f32 in the reference.  They run as f32 FMAs on
// the CUDA cores: p goes through shared memory (transposed, f32) and each
// thread sums 4 rows by HD/8 columns of the product over the tile's 64
// keys, reading the bf16 V or dO tile in TMA's swizzle.  The tensor cores
// cannot hold that sum to f32: split into three bf16 parts (hi = bf16(x),
// mid = bf16(x - hi), lo = bf16(x - hi - mid) of x = p 2^32, an exact
// split, ops/ring_fold.py's split_bf16x3), p's products are exact, but
// wgmma truncates as it aligns and adds them, and on an H100 o left the
// f32 tolerance 5x over 1024 keys in one accumulator and 1.6x with each
// 64-key tile's sum promoted to an IEEE add (PERF.md, Findings).
// q . k, dO . v (its products of bf16 values are exact; dP is rounded
// nowhere else), dS . k and dS^T . q are single bf16 wgmmas.
//
// Bound on an H100 (B=8, C=1024, H=8, hd=64, one causal diagonal block;
// chip_smoke.py's fold_bounds): operations.  A product over the causal
// half is 4.3 GFLOP, 4.35 us at the tensor cores' 989 TFLOP/s in bf16 and
// 64.2 us at the CUDA cores' 67 TFLOP/s in f32: the forward's q.k and
// p.v take 68.5 us (its 59.8 MB of traffic, the f32 state read and
// written, 17.8 us); dk/dv's three bf16 products and P^T.dO 77.2 us
// (101.2 MB: 30.2 us); dq's three bf16 products 13.1 us, so its bytes
// bound it (67.6 MB, the f32 dq read and written among them: 20.2 us).
// Per score, besides the products, the kernels do
// a rounding and an exponential, and the forward takes its scores twice
// (a max pass, then the p pass), as the reference's fold takes the
// block's max before any p.
//
// Design (the tile, TMA and wgmma helpers are sm90_tile.cuh's):
//  - fwd: one warpgroup per (64-row query tile, h, b), the longest tiles
//    first.  Q is loaded once; K (pass 1) then K and V (pass 2) stream
//    through a two-stage TMA ring.  Pass 1 takes the block's row max over
//    the key tiles not wholly masked; pass 2 p, its row sum and p . V
//    over the same tiles (every tile if a row of the block has seen no
//    key: the reference weighs its masked scores by exp(0) = 1).  Then
//    (m, l, o) are read, updated once and written, as the reference folds
//    once per block; no rescaling inside the block.
//  - dq: one warpgroup per (64-row query tile, h, b), the longest tiles
//    first; Q and dO loaded once, the tile's 64 lse and 64 D in
//    registers, K and V streaming through the ring over the key tiles
//    the forward visits.  S = Q.K^T and dP = dO.V^T are two wgmmas with
//    both operands K-major; dS is rounded and packed as bf16x2 straight
//    into the A fragment of dq += dS.K, whose B is the K tile read
//    MN-major, so dS never touches shared memory.  The block's dq sums
//    in wgmma's accumulator over the key tiles and is added to the
//    carried dq once (one IEEE add an element), as the reference adds
//    the block's product.  Three products and one exponential a score,
//    nothing recomputed.
//  - dk/dv: one warpgroup per (64-row key tile, h, b); K and V loaded
//    once, Q and dO streaming with each tile's 64 lse and 64 D beside
//    them.  The products are taken transposed, S^T = K.Q^T and dP^T =
//    V.dO^T (rows keys, columns queries), so dS^T is the A fragment of
//    dk += dS^T.Q with no transpose; dv += P^T.dO runs on the CUDA cores
//    while that wgmma is in flight.
//  - Masks by global position: a tile pair whose first query is at or
//    past its last key skips the per-element test; keys past Ck are -inf
//    (p = 0); rows past a block arrive as TMA's zeros.
//  - No atomics: each block owns its rows, so two runs give the same bits.
#include "ring_fold.cuh"
#include "sm90_tile.cuh"

#include <math.h>

namespace {

constexpr int kLdP = kTile + 4;  // f32 row stride of the staged p

// A tile pair that needs the per-element masks: it straddles the causal
// diagonal, or its keys run past Ck.
__device__ __forceinline__ bool edge_pair(const Pos& pos, int q0, int k0,
                                          int Ck) {
  return (pos.causal && pos.q_off + q0 < pos.k_off + k0 + kTile - 1) ||
         k0 + kTile > Ck;
}

// The reference's scores from the raw products of a [64][64] tile pair:
// bf16(s) * scale; with kEdge, -inf at keys past Ck and -1e30 where the
// query lies before the key.  Rows start at rbase, columns at cbase
// (local indices); kT: the rows are keys and the columns queries.
template <bool kT, bool kEdge>
__device__ __forceinline__ void fold_scores_in(float (&s)[32], int r0, int c0,
                                               int rbase, int cbase, int Ck,
                                               const Pos& pos) {
  round_bf16(s);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * j + e;
      const float v = __fmul_rn(s[x], pos.scale);
      if constexpr (kEdge) {
        const int row = rbase + r0 + 8 * (e >> 1);
        const int col = cbase + c0 + 8 * j + (e & 1);
        const int qi = kT ? col : row;
        const int kj = kT ? row : col;
        s[x] = kj >= Ck ? -INFINITY
                        : (pos.causal && pos.q_off + qi < pos.k_off + kj
                               ? kNeg
                               : v);
      } else {
        s[x] = v;
      }
    }
  }
}

template <bool kT>
__device__ __forceinline__ void fold_scores(float (&s)[32], bool edge, int r0,
                                            int c0, int rbase, int cbase,
                                            int Ck, const Pos& pos) {
  if (edge) {  // the same for the whole block
    fold_scores_in<kT, true>(s, r0, c0, rbase, cbase, Ck, pos);
  } else {
    fold_scores_in<kT, false>(s, r0, c0, rbase, cbase, Ck, pos);
  }
}

__device__ __forceinline__ float low_half(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float high_half(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// Holds fragments in registers at this point: wgmma reads its register A
// operands until wgmma.wait_group retires it, so a fragment in flight
// while the threads compute is pinned before the issue and after the
// wait.
__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      asm volatile("" : "+r"(a[kk][t])::"memory");
    }
  }
}

// The [64][64] accumulator x (rows r0, r0 + 8, columns c0 + 8 j + e % 2)
// into shared memory transposed, sP[column][row], f32: the reduction
// index of the p product first.  kLdP = 68: a warp's stores hit 32 banks.
__device__ __forceinline__ void stage_transposed(float* sP,
                                                 const float (&x)[32], int r0,
                                                 int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sP[(c0 + 8 * j + (e & 1)) * kLdP + r0 + 8 * (e >> 1)] = x[4 * j + e];
    }
  }
}

// Byte offset of 16-byte chunk `chunk` of row `row` in one swizzle atom,
// as TMA placed it: 128-byte swizzle (hd 64, 128), chunk ^= row % 8;
// 32-byte swizzle (hd 16, rows of 32 bytes), chunk ^= (row / 4) % 2.
template <int HD>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  if constexpr (HD < 64) {
    return row * 32 + ((chunk ^ ((row >> 2) & 1)) << 4);
  } else {
    return row * 128 + ((chunk ^ (row & 7)) << 4);
  }
}

// Columns [HD/8 cb, HD/8 cb + HD/8) of row `row` of a [64][HD] bf16 tile
// in shared memory, as f32.
template <int HD>
__device__ __forceinline__ void tile_cols(float (&v)[HD / 8],
                                          const uint8_t* tile, int row,
                                          int cb) {
  if constexpr (HD == 16) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(
        tile + swizzled<HD>(row, cb >> 2) + 4 * (cb & 3));
    v[0] = low_half(w);
    v[1] = high_half(w);
  } else {
#pragma unroll
    for (int h = 0; h < HD / 64; ++h) {  // one 16-byte chunk a 64 columns
      const int col = (HD / 8) * cb + 8 * h;
      const uint4 w = *reinterpret_cast<const uint4*>(
          tile + (col / 64) * Geo<HD>::kAtomBytes +
          swizzled<HD>(row, (col % 64) / 8));
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        v[8 * h + 2 * x] = low_half(u[x]);
        v[8 * h + 2 * x + 1] = high_half(u[x]);
      }
    }
  }
}

// acc[i][c] += sum_k sP[k][4 ra + i] tile[k][HD/8 cb + c] over the 64
// rows k of the tile, in order, as f32 FMAs (thread ra = t / 8,
// cb = t % 8 owns rows 4 ra .. 4 ra + 3 and HD/8 columns of the product).
template <int HD>
__device__ __forceinline__ void product_f32(float (&acc)[4][HD / 8],
                                            const float* sP,
                                            const uint8_t* tile, int ra,
                                            int cb) {
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    const float4 p = *reinterpret_cast<const float4*>(sP + k * kLdP + 4 * ra);
    float v[HD / 8];
    tile_cols<HD>(v, tile, k, cb);
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      acc[0][c] = fmaf(p.x, v[c], acc[0][c]);
      acc[1][c] = fmaf(p.y, v[c], acc[1][c]);
      acc[2][c] = fmaf(p.z, v[c], acc[2][c]);
      acc[3][c] = fmaf(p.w, v[c], acc[3][c]);
    }
  }
}

// s = the raw [64][64] product A . B^T over HD columns; waits for it.
template <int HD>
__device__ __forceinline__ void product_ss(float (&s)[32], uint32_t a,
                                           uint32_t b) {
  reg_fence(s);
  wg_fence();
  issue_ss<HD>(s, a, b);
  wg_commit();
  wg_wait_all();
  reg_fence(s);
}

// Q, two stages of K and V, three mbarriers (in 32 bytes), the staged p
// and the rows' exp(m - m')
template <int HD>
constexpr int fwd_smem() {
  return 5 * Geo<HD>::kTileBytes + 32 + (kTile * kLdP + kTile) * 4 + kAlign;
}
// Q, dO, two stages of K and V, three mbarriers (in 32 bytes)
template <int HD>
constexpr int dq_smem() {
  return 6 * Geo<HD>::kTileBytes + 32 + kAlign;
}
// K, V, two stages of Q and dO, three mbarriers (in 32 bytes), two
// stages of the query tile's 64 lse and 64 D, the staged P^T
constexpr int kStats = 2 * kTile;  // floats of one stage
template <int HD>
constexpr int dkdv_smem() {
  return 6 * Geo<HD>::kTileBytes + 32 + (2 * kStats + kTile * kLdP) * 4 +
         kAlign;
}

// --- the kernels ------------------------------------------------------

// One query tile's fold of the block.  Load i of the ring fills stage
// i % 2: loads [0, n1) are pass 1's K tiles, loads [n1, n1 + n2) pass 2's
// K and V tiles; n2 (n1, or every key tile) is known after pass 1, and
// n2 >= n1, so pass 1 may always fetch one load ahead.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    ring_fold_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              float* __restrict__ m, float* __restrict__ l,
                              float* __restrict__ o, int Cq, int Ck, int H,
                              Pos pos) {
  constexpr int T = Geo<HD>::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = align_up(raw);
  const uint32_t bar = sQ + 5 * T;  // full[0], full[1], then Q's
  float* sP = reinterpret_cast<float*>(smem_raw + (bar + 32 - raw));
  float* sAlpha = sP + kTile * kLdP;  // each row's exp(m - m')
  // blocks start in index order, x fastest: every (h, b) of the longest
  // query tiles first
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int c0 = (tid & 3) * 2;
  const int ra = tid >> 3;  // p . V: rows 4 ra.., columns HD/8 cb..
  const int cb = tid & 7;
  const int q0 = qt * kTile;
  const int n_kt = (Ck + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;
  int n1 = 0;  // the key tiles not wholly masked: a prefix
  while (n1 < n_kt && !all_masked(pos, q0, Cq, n1 * kTile, kTile)) {
    ++n1;
  }

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto issue = [&](int i) {  // thread 0: load i into stage i % 2
    const int st = i & 1;
    const bool second = i >= n1;
    const int k0 = (second ? i - n1 : i) * kTile;
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
    if (n1 > 0) {
      issue(0);
    }
  }
  float m_old[2];
  float m_new[2] = {-INFINITY, -INFINITY};
  bool valid[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    valid[r] = row < Cq;
    m_old[r] = valid[r] ? m[bh + row] : kNeg;
  }
  mbar_wait(bar + 16, 0);
  // pass 1: the block's row max
  for (int i = 0; i < n1; ++i) {
    __syncthreads();  // iteration i - 1 is done with stage (i + 1) % 2
    if (tid == 0) {
      issue(i + 1);  // i + 1 <= n1 < n1 + n2
    }
    mbar_wait(bar + 8 * (i & 1), (i >> 1) & 1);
    float s[32];
    product_ss<HD>(s, sQ, sQ + (1 + (i & 1)) * T);
    fold_scores<false>(s, edge_pair(pos, q0, i * kTile, Ck), r0, c0, q0,
                       i * kTile, Ck, pos);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      }
      m_new[r] = fmaxf(m_new[r], quad_max(mx));
    }
  }
  int degen = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = fmaxf(m_old[r], m_new[r]);
    degen |= valid[r] && degenerate(m_new[r]);
    if ((tid & 3) == 0) {
      sAlpha[r0 + 8 * r] = expf(__fsub_rn(m_old[r], m_new[r]));
    }
  }
  degen = __syncthreads_or(degen);  // and sAlpha is in place
  const int n = n1 + (degen ? n_kt : n1);  // loads in all
  if (tid == 0 && n1 == 0 && n > 0) {
    issue(0);
  }
  // pass 2: p, its row sum and p . V
  float sum[2] = {0.0f, 0.0f};
  float acc[4][HD / 8] = {};
  for (int i = n1; i < n; ++i) {
    __syncthreads();  // and the last tile's p . V is done with sP
    if (tid == 0 && i + 1 < n) {
      issue(i + 1);
    }
    mbar_wait(bar + 8 * (i & 1), (i >> 1) & 1);
    const int k0 = (i - n1) * kTile;
    float s[32];
    product_ss<HD>(s, sQ, sQ + (1 + (i & 1)) * T);
    fold_scores<false>(s, edge_pair(pos, q0, k0, Ck), r0, c0, q0, k0, Ck,
                       pos);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const float p = expf(__fsub_rn(s[x], m_new[(x >> 1) & 1]));
      sum[(x >> 1) & 1] += p;
      s[x] = p;
    }
    stage_transposed(sP, s, r0, c0);  // sP[key][row]
    __syncthreads();
    product_f32<HD>(acc, sP, smem_raw + (sQ + (3 + (i & 1)) * T - raw), ra,
                    cb);
    fence_proxy_async();  // the threads read V: before TMA refills it
  }
  // the fold: (m, l, o) read, updated once and written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = quad_sum(sum[r]);
    const int row = q0 + r0 + 8 * r;
    if (valid[r] && (tid & 3) == 0) {
      m[bh + row] = m_new[r];
      l[bh + row] = __fadd_rn(__fmul_rn(l[bh + row], sAlpha[r0 + 8 * r]),
                              total);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ra + i;
    if (row >= Cq) {
      continue;
    }
    const float alpha = sAlpha[4 * ra + i];
    float* dst = o + (bh + row) * HD + (HD / 8) * cb;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      dst[c] = __fadd_rn(__fmul_rn(dst[c], alpha), acc[i][c]);
    }
  }
}

// dk and dv of one key tile over the query tiles that see it (every one
// if a row of the block has seen no key).  Load i of the ring fills stage
// i % 2 with query tile first + i's Q and dO, beside which the warpgroup
// stages that tile's lse and D.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    ring_fold_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int Cq, int Ck, int H, Pos pos) {
  constexpr int T = Geo<HD>::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = align_up(raw);
  const uint32_t sV = sK + T;
  const uint32_t bar = sK + 6 * T;  // full[0], full[1], then K's and V's
  // stage st: the query tile's lse (+inf past Cq: p = 0) and D (0 there)
  float* stats = reinterpret_cast<float*>(smem_raw + (bar + 32 - raw));
  float* sP = stats + 2 * kStats;  // P^T staged as sP[query][key]
  // blocks start in index order, x fastest: every (h, b) of the first key
  // tiles, which the most query tiles see, first
  const int kt = blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int c0 = (tid & 3) * 2;
  const int ra = tid >> 3;  // P^T . dO: keys 4 ra.., columns HD/8 cb..
  const int cb = tid & 7;
  const int k0 = kt * kTile;
  const int n_qt = (Cq + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;

  int degen = 0;
  for (int r = tid; r < Cq; r += kThreads) {
    degen |= degenerate(lse[bh + r]);
  }
  degen = __syncthreads_or(degen);
  int first = 0;  // the query tiles wholly before the key tile: a prefix
  while (!degen && first < n_qt &&
         all_masked(pos, first * kTile, Cq, k0, kTile)) {
    ++first;
  }
  const int n = n_qt - first;
  if (n == 0) {  // no query sees a key of the tile: dk, dv unchanged
    return;
  }

  const CUtensorMap* mq = &tq;
  const CUtensorMap* mdo = &tdo;
  auto issue = [&](int i) {  // thread 0: tile first + i into stage i % 2
    const int st = i & 1;
    const int q0 = (first + i) * kTile;
    mbar_expect_tx(bar + 8 * st, 2 * T);
    load_tile<HD>(sK + (2 + st) * T, mq, bar + 8 * st, q0, h, b);
    load_tile<HD>(sK + (4 + st) * T, mdo, bar + 8 * st, q0, h, b);
  };
  // thread t's share of query tile first + i's statistics: lse of row t
  // (t < 64), else D of row t - 64
  auto stat = [&](int i) {
    const int row = (first + i) * kTile + (tid & (kTile - 1));
    if (tid < kTile) {
      return row < Cq ? lse[bh + row] : INFINITY;
    }
    return row < Cq ? delta[bh + row] : 0.0f;
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
  float acc_k[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) {
    acc_k[x] = 0.0f;
  }
  float acc_v[4][HD / 8] = {};
  mbar_wait(bar + 16, 0);
  for (int i = 0; i < n; ++i) {
    // iteration i - 1 is done with stage (i + 1) % 2 and with sP; tile
    // i's statistics are in place
    __syncthreads();
    if (tid == 0 && i + 1 < n) {
      issue(i + 1);
    }
    const float next = i + 1 < n ? stat(i + 1) : 0.0f;  // stored below
    mbar_wait(bar + 8 * (i & 1), (i >> 1) & 1);
    const uint32_t sQ = sK + (2 + (i & 1)) * T;
    const uint32_t sDO = sK + (4 + (i & 1)) * T;
    const int q0 = (first + i) * kTile;
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
    fold_scores<true>(s, edge_pair(pos, q0, k0, Ck), r0, c0, k0, q0, Ck,
                      pos);
    // column c0 + 8 j + e % 2 is a query: its lse and D
    const float* L = stats + kStats * (i & 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 lj = *reinterpret_cast<const float2*>(L + c0 + 8 * j);
      const float2 dj =
          *reinterpret_cast<const float2*>(L + kTile + c0 + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e;
        const float p = expf(__fsub_rn(s[x], e & 1 ? lj.y : lj.x));
        w[x] = __fmul_rn(__fmul_rn(p, __fsub_rn(w[x], e & 1 ? dj.y : dj.x)),
                         pos.scale);
        s[x] = p;
      }
    }
    uint32_t ads[4][4];
    pack_a(ads, w);  // dS^T, rounded to bf16 as the reference rounds dS
    stage_transposed(sP, s, r0, c0);
    pin(ads);
    reg_fence(acc_k);
    wg_fence();
    issue_rs<HD>(acc_k, ads, sQ);
    wg_commit();
    __syncthreads();  // sP in place; dk's product runs on meanwhile
    product_f32<HD>(acc_v, sP, smem_raw + (sDO - raw), ra, cb);
    fence_proxy_async();  // the threads read dO: before TMA refills it
    wg_wait_all();
    reg_fence(acc_k);
    pin(ads);
    if (i + 1 < n) {
      stats[kStats * ((i + 1) & 1) + tid] = next;
    }
  }
  const long long bhk = ((long long)b * H + h) * Ck;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + 8 * r;
    if (key >= Ck) {
      continue;
    }
    float* dst = dk + (bhk + key) * HD + c0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      float2 x = *reinterpret_cast<float2*>(dst + 8 * j);
      x.x = __fadd_rn(x.x, acc_k[4 * j + 2 * r]);
      x.y = __fadd_rn(x.y, acc_k[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(dst + 8 * j) = x;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ra + i;
    if (key >= Ck) {
      continue;
    }
    float* dst = dv + (bhk + key) * HD + (HD / 8) * cb;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      dst[c] = __fadd_rn(dst[c], acc_v[i][c]);
    }
  }
}

// dq of one query tile over the key tiles the fold visits: the tiles not
// wholly masked, or every tile if a row of the query tile has seen no
// key.  Q and dO are loaded once; load i of the ring fills stage i % 2
// with key tile i's K and V.  S, dP and dq += dS.K are all wgmmas: dS,
// rounded to bf16, is packed straight into the A fragment, so nothing
// is staged in shared memory.  The block's sum is added to the carried
// dq once, as the reference adds the block's product.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    ring_fold_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int Cq, int Ck, int H,
                             Pos pos) {
  constexpr int T = Geo<HD>::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = align_up(smem_u32(smem_raw));
  const uint32_t sDO = sQ + T;
  const uint32_t bar = sQ + 6 * T;  // full[0], full[1], then Q's and dO's
  // blocks start in index order, x fastest: every (h, b) of the longest
  // query tiles first
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int c0 = (tid & 3) * 2;
  const int q0 = qt * kTile;
  const int n_kt = (Ck + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;

  float L[2];  // lse, +inf past Cq: P = 0 there
  float D[2];
  int degen = 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    L[r] = row < Cq ? lse[bh + row] : INFINITY;
    D[r] = row < Cq ? delta[bh + row] : 0.0f;
    degen |= row < Cq && degenerate(L[r]);
  }
  degen = __syncthreads_or(degen);
  int n = 0;  // the key tiles not wholly masked: a prefix
  while (n < n_kt && (degen || !all_masked(pos, q0, Cq, n * kTile, kTile))) {
    ++n;
  }
  if (n == 0) {  // no row of the tile sees a key of the block: dq unchanged
    return;
  }

  const CUtensorMap* mk = &tk;
  const CUtensorMap* mv = &tv;
  auto issue = [&](int i) {  // thread 0: key tile i into stage i % 2
    const int st = i & 1;
    mbar_expect_tx(bar + 8 * st, 2 * T);
    load_tile<HD>(sQ + (2 + st) * T, mk, bar + 8 * st, i * kTile, h, b);
    load_tile<HD>(sQ + (4 + st) * T, mv, bar + 8 * st, i * kTile, h, b);
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
  float acc[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) {
    acc[x] = 0.0f;
  }
  mbar_wait(bar + 16, 0);
  for (int i = 0; i < n; ++i) {
    __syncthreads();  // iteration i - 1 is done with stage (i + 1) % 2
    if (tid == 0 && i + 1 < n) {
      issue(i + 1);
    }
    mbar_wait(bar + 8 * (i & 1), (i >> 1) & 1);
    const uint32_t sK = sQ + (2 + (i & 1)) * T;
    const int k0 = i * kTile;
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
    fold_scores<false>(s, edge_pair(pos, q0, k0, Ck), r0, c0, q0, k0, Ck,
                       pos);
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int r = (x >> 1) & 1;
      const float p = expf(__fsub_rn(s[x], L[r]));
      w[x] = __fmul_rn(__fmul_rn(p, __fsub_rn(w[x], D[r])), pos.scale);
    }
    uint32_t ads[4][4];
    pack_a(ads, w);  // dS, rounded to bf16 as the reference rounds it
    product_rs<HD>(acc, ads, sK);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= Cq) {
      continue;
    }
    float* dst = dq + (bh + row) * HD + c0;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      float2 x = *reinterpret_cast<float2*>(dst + 8 * j);
      x.x = __fadd_rn(x.x, acc[4 * j + 2 * r]);
      x.y = __fadd_rn(x.y, acc[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(dst + 8 * j) = x;
    }
  }
}

// --- host -------------------------------------------------------------

// grid.x = B H blocks, grid.y one per 64-row tile
bool grid_fits(int B, int H, int tiles) {
  return (long long)B * H <= 0x7fffffffLL && tiles <= 65535;
}

template <int HD>
int fwd(const void* q, const void* k, const void* v, float* m, float* l,
        float* o, const long long* st, int B, int Cq, int Ck, int H,
        const Pos& pos, cudaStream_t stream) {
  const int tiles = (Cq + kTile - 1) / kTile;
  if (!grid_fits(B, H, tiles)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap maps[3];
  const int e = tensor_maps<HD, 3>(maps, {q, k, v}, st, B, {Cq, Ck, Ck}, H);
  if (e != 0) {
    return e;
  }
  constexpr int bytes = fwd_smem<HD>();
  static const int attr = allow_smem(ring_fold_fwd_sm90_kernel<HD>, bytes);
  if (attr != 0) {
    return attr;
  }
  ring_fold_fwd_sm90_kernel<HD><<<dim3(B * H, tiles), kThreads, bytes,
                                  stream>>>(maps[0], maps[1], maps[2], m, l,
                                            o, Cq, Ck, H, pos);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq,
           const long long* st, int B, int Cq, int Ck, int H, const Pos& pos,
           cudaStream_t stream) {
  const int tiles = (Cq + kTile - 1) / kTile;
  if (!grid_fits(B, H, tiles)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap maps[4];
  const int e = tensor_maps<HD, 4>(maps, {q, k, v, dout}, st, B,
                                   {Cq, Ck, Ck, Cq}, H);
  if (e != 0) {
    return e;
  }
  constexpr int bytes = dq_smem<HD>();
  static const int attr = allow_smem(ring_fold_dq_sm90_kernel<HD>, bytes);
  if (attr != 0) {
    return attr;
  }
  ring_fold_dq_sm90_kernel<HD><<<dim3(B * H, tiles), kThreads, bytes,
                                 stream>>>(maps[0], maps[1], maps[2],
                                           maps[3], lse, delta, dq, Cq, Ck,
                                           H, pos);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, float* dk, float* dv,
             const long long* st, int B, int Cq, int Ck, int H,
             const Pos& pos, cudaStream_t stream) {
  const int tiles = (Ck + kTile - 1) / kTile;
  if (!grid_fits(B, H, tiles)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap maps[4];
  const int e = tensor_maps<HD, 4>(maps, {q, k, v, dout}, st, B,
                                   {Cq, Ck, Ck, Cq}, H);
  if (e != 0) {
    return e;
  }
  constexpr int bytes = dkdv_smem<HD>();
  static const int attr = allow_smem(ring_fold_dkdv_sm90_kernel<HD>, bytes);
  if (attr != 0) {
    return attr;
  }
  ring_fold_dkdv_sm90_kernel<HD><<<dim3(B * H, tiles), kThreads, bytes,
                                   stream>>>(maps[0], maps[1], maps[2],
                                             maps[3], lse, delta, dk, dv, Cq,
                                             Ck, H, pos);
  return (int)cudaGetLastError();
}

}  // namespace

// Called by the C entries of ring_fold.cu for bf16 at hd 16, 64 or 128
// (their arguments, without the dtype).  q, k, v and dO must be 16-byte
// aligned in base and strides (TMA's rule; the wrapper copies any other
// view); where the driver refuses the tensor map of input i (0 q, 1 k,
// 2 v, 3 dO) they return -(1000 (i + 1) + its CUresult).
#define TRPC_RF_SM90(FN, ...)             \
  switch (hd) {                           \
    case 16: return FN<16>(__VA_ARGS__);  \
    case 64: return FN<64>(__VA_ARGS__);  \
    case 128: return FN<128>(__VA_ARGS__); \
  }                                       \
  return (int)cudaErrorInvalidValue

extern "C" int trpc_ring_fold_fwd_sm90(const void* q, const void* k,
                                       const void* v, void* m, void* l,
                                       void* o, const long long* strides,
                                       int B, int Cq, int Ck, int H, int hd,
                                       int q_off, int k_off, int causal,
                                       float scale, void* stream) {
  const Pos pos{q_off, k_off, causal, scale};
  TRPC_RF_SM90(fwd, q, k, v, (float*)m, (float*)l, (float*)o, strides, B,
               Cq, Ck, H, pos, (cudaStream_t)stream);
}

extern "C" int trpc_ring_fold_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int Cq, int Ck, int H, int hd, int q_off, int k_off, int causal,
    float scale, void* stream) {
  const Pos pos{q_off, k_off, causal, scale};
  TRPC_RF_SM90(bwd_dq, q, k, v, dout, (const float*)lse, (const float*)delta,
               (float*)dq, strides, B, Cq, Ck, H, pos, (cudaStream_t)stream);
}

extern "C" int trpc_ring_fold_bwd_dkdv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int Cq, int Ck, int H, int hd,
    int q_off, int k_off, int causal, float scale, void* stream) {
  const Pos pos{q_off, k_off, causal, scale};
  TRPC_RF_SM90(bwd_dkdv, q, k, v, dout, (const float*)lse,
               (const float*)delta, (float*)dk, (float*)dv, strides, B, Cq,
               Ck, H, pos, (cudaStream_t)stream);
}
