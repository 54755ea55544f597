// ring_fold_f32.cu — the ring fold's forward, dq and dk/dv in f32 on
// the CUDA cores: register tiles fed by 16-byte shared-memory reads and
// cp.async copies (the machinery of f32_tile.cuh); the forward and dq in
// one pass over the held block's keys through a two-stage ring for K and
// V, dk/dv on transposed tiles.
//
// Counterpart: the fold of brpc_tpu/parallel/ring_attention.py:56-71 in
// f32 and its jax.grad (and Ulysses' `_dense_local`, :125-133, one fold
// at offsets 0/0), which ring_fold.cu's trpc_ring_fold_fwd,
// trpc_ring_fold_bwd_dq and trpc_ring_fold_bwd_dkdv send here for f32 at
// hd 16, 64 and 128.  Layout and function are that file's:
//   q, dO [B, Cq, H, hd], k, v [B, Ck, H, hd] f32, read through their
//   (b, s, h) strides (the last dim contiguous; base and strides 16-byte
//   multiples, which the wrapper ensures by copying any other view)
//   m, l, lse, D [B, H, Cq] f32, o, dq [B, H, Cq, hd] f32 (o
//   unnormalised), dk, dv [B, H, Ck, hd] f32, contiguous; m, l, o, dq,
//   dk, dv updated in place
//   s  = q . k * scale (f32 product, __fmul_rn), -1e30 where q_off + i <
//        k_off + j (causal), -inf past Ck (no key: out of every max, sum)
//   m' = max(m, rowmax s)   p = exp(s - m')   a = exp(m - m')
//   l' = l a + sum_j p      o' = o a + p . v
//   P  = exp(s - lse)   dP = dO . v   dS = P (dP - D) scale
//   dq += dS . k        dk += dS^T . q      dv += P^T . dO
// In f32 the reference rounds no weight before p . v, so nothing forces
// the SIMT kernel's two passes (the block's row max, then p): one pass
// keeps a running max m_t from m, and per key tile
//   m_t = max(m_run, tile row max)   c = exp(m_run - m_t)
//   l_acc = l_acc c + sum exp(s - m_t)    acc = acc c + exp(s - m_t) . V
// (the tile's exp(s - m_t) . V summed apart and then added to acc: 64
// adds a tile at the tile sum's magnitude and one at acc's), then writes
// m' = m_t, l' = l a + l_acc, o' = o a + acc once, with a = exp(m - m')
// the reference's own (m' is the same max).  l and o are read there,
// not at the start: the update keeps the reference's form o a + (p . v).
// Wherever no tile after the first raises a row's max, every
// exp(s - m_t) is the reference's p bit for bit; elsewhere only the
// roundings of the rescaled partial sums differ (tests/
// test_torch_ring_fold.py holds the order on the CPU at C = 1024).
//
// Skip rule.  A tile pair with every query before every key is all
// -1e30, whose p is 0 for a row that has seen a key, so it is skipped;
// but a row that has seen no key (m about -1e30) and sees none of this
// block keeps m' = -1e30 and weighs its masked scores by exp(0) = 1, so
// then every tile is visited.  The SIMT kernel decides that after its
// first pass (m' degenerate); in one pass it is decided before the loop
// from positions: row r is such a row iff m[r] is degenerate and, under
// causal, q_off + r < k_off.  A row that sees a key has a finite score,
// so its m' leaves -1e30: the two rules agree (a CPU leg checks it).
// With m_run started at m, such a row keeps m_t = -1e30 and p = 1 on its
// masked scores, as the reference.
//
// dq takes D from its caller (D = sum dO . o / l of the folded state),
// so it needs one pass and three products (q.k, dO.v, dS.k), not the
// causal f32 dq's two.  It computes each score, dW, P and dS as the SIMT
// kernel did (the same __f*_rn roundings; scores sums over hd in the
// same order, and fmaf commutes), sums dq over the visited keys in order
// straight into the accumulator, as tile_mma did, and adds the block's
// sum to the carried dq once: the SIMT kernel's bits.  Its skip rule is
// the SIMT kernel's: every key tile when some row of the query tile has
// a degenerate lse, else the tiles up to the first wholly masked one.
//
// dk/dv computes each score, P and dS as the SIMT kernel did (the same
// __f*_rn roundings; fmaf commutes and the depth order is the same, so
// S^T = K . Q^T holds the scores' bits), sums dk and dv over the visited
// queries in order straight into the accumulator, as it did, and adds
// the block's sums to the carried dk, dv once: the SIMT kernel's bits.
// Its skip rule is the SIMT kernel's: every query tile when some row's
// lse is degenerate (a row that has seen no key weighs its masked scores
// by 1), else only the tiles not wholly before the key tile.
//
// Bound on an H100 (B=8, C=1024, H=8, hd=64, one causal diagonal block):
// operations.  q.k and p.v over the causal half are 8.6 GFLOP, 128.3 us
// at the CUDA cores' 67 TFLOP/s (TF32 keeps 10 mantissa bits, too few
// for the f32 tolerance; PERF.md, Findings); its 59.8 MB of traffic (the
// state read and written among it) take 17.8 us.  dk/dv's four products
// (q.k, dO.v, P^T.dO, dS^T.q) are 17.2 GFLOP, 256.7 us; its 101.2 MB
// take 30.2 us.  dq's three products are 12.9 GFLOP, 192.5 us; its 67.6
// MB take 20.2 us.
//
// Design (the geometry, copies and products of f32_tile.cuh):
//  - Forward: one block of 128 threads per (64-row query tile, h, b), the
//    longest query tiles first; each thread owns 4 rows: a 4 x 8 register
//    tile of each score tile, hd / 8 columns of acc.  Q resident; K and V
//    tiles through the two-stage cp.async ring, tile i + 1 landing while
//    tile i is computed; p staged at stride 72 for p . V.  Q, two stages
//    of K and V, p: 103 KB at hd 64, two blocks an SM.
//  - dq: the forward's grid and ring, less p: Q and dO resident, lse and
//    D in registers (lse = +inf past Cq); per key tile dW = dO . V and s
//    = Q . K as two 4 x 8 tiles, P and dS in registers, dS staged at
//    stride 72 over the tile's V stage once every thread has read V (a
//    barrier), then acc += dS . K (weights_v).  A V stage is max(64 (hd
//    + 4), 64 x 72) floats: Q, dO, two stages of K and V are 104 KB at
//    hd 64, two blocks an SM.
//  - dk/dv: one block of 128 threads per (64-row key tile, h, b), key
//    tile 0 (which the most query tiles see) first; transposed tiles,
//    rows keys and columns queries.  K and V resident; per query tile one
//    stage of Q and dO and its lse and D (load_stats), S^T = K . Q^T,
//    P^T staged at stride 72, dP^T = V . dO^T, dS^T from the thread's
//    own staged P, staged beside it; dv += P^T . dO, dk += dS^T . Q
//    (weights_v).  One 4 x 8 tile live beside the two accumulators (no
//    spill at hd 128).  K, V, Q, dO, P^T, dS^T: 104.5 KB at hd 64, two
//    blocks an SM, so one block computes while the other waits for its
//    query tile (one block an SM at hd 128).
//  - No atomics: each block updates its own rows of the state.
#include <cuda_runtime.h>

#include <math.h>

#include "f32_tile.cuh"
#include "ring_fold.cuh"

namespace {

template <int HD>
constexpr int fwd_smem_bytes() {  // Q, two stages of K and of V, p
  return (5 * Stage<HD>::kFloats + kTile * kLdP) * (int)sizeof(float);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    ring_fold_fwd_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ m, float* __restrict__ l,
                             float* __restrict__ o, Layout lay, int Cq,
                             int Ck, int H, Pos pos) {
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
  const int n_kt = (Ck + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;

  float m_run[4];
  int degen = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + 16 * i;
    const bool valid = row < Cq;
    m_run[i] = valid ? m[bh + row] : kNeg;
    degen |= valid && unseen_degenerate(pos, row, m_run[i]);
  }
  degen = __syncthreads_or(degen);
  // the key tiles visited: masked tiles come last (their keys are the
  // latest), so a prefix
  int n_vis = 0;
  while (n_vis < n_kt &&
         (degen || !all_masked(pos, q0, Cq, n_vis * kTile, kTile))) {
    ++n_vis;
  }
  if (n_vis == 0) {
    return;  // m' = m, a = 1, p = 0: the state stays as it is
  }

  load_tile<HD>(sQ, q, lay.t[0], b, h, q0, Cq);
  load_tile<HD>(sK, k, lay.t[1], b, h, 0, Ck);
  load_tile<HD>(sV, v, lay.t[2], b, h, 0, Ck);
  cp_async_commit();
  float l_acc[4];
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l_acc[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[i][c] = 0.0f;
    }
  }
  for (int kt = 0; kt < n_vis; ++kt) {
    cp_async_wait_all();
    // tile kt is in place for every thread, and every thread is done
    // with tile kt - 1's stage and with sP
    __syncthreads();
    if (kt + 1 < n_vis) {
      const int st = (kt + 1) & 1;
      load_tile<HD>(sK + st * G::kFloats, k, lay.t[1], b, h,
                    (kt + 1) * kTile, Ck);
      load_tile<HD>(sV + st * G::kFloats, v, lay.t[2], b, h,
                    (kt + 1) * kTile, Ck);
      cp_async_commit();
    }
    const int st = kt & 1;
    const int k0 = kt * kTile;
    float s[4][8];
    scores<HD>(s, sQ, sK + st * G::kFloats, ra, cb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ra + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + cb + 8 * j;
        if (key >= Ck) {
          s[i][j] = -INFINITY;
        } else if (pos.causal && pos.q_off + row < pos.k_off + key) {
          s[i][j] = kNeg;
        } else {
          s[i][j] = __fmul_rn(s[i][j], pos.scale);
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float mt = fmaxf(m_run[i], max8(mx));
      const float corr = expf(__fsub_rn(m_run[i], mt));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], mt));
        sum += s[i][j];
        sP[(ra + 16 * i) * kLdP + cb + 8 * j] = s[i][j];
      }
      l_acc[i] = __fadd_rn(__fmul_rn(l_acc[i], corr), sum8(sum));
      m_run[i] = mt;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c] = __fmul_rn(acc[i][c], corr);
      }
    }
    __syncthreads();  // sP in place
    // the tile's p . V summed apart, then added: 64 adds a tile at the
    // tile sum's magnitude and one at acc's, not every add at acc's (on
    // an H100 over 1000 keys the state stays within 0.80 of
    // RING_TOL["f32"] of the fold in f64, where the plain version's f32
    // GEMM, which sums straight, lies up to 1.20x from it;
    // causal_attention_ab.py)
    float part[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        part[i][c] = 0.0f;
      }
    }
    weights_v<HD>(part, sP, sV + st * G::kFloats, ra, cb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c] = __fadd_rn(acc[i][c], part[i][c]);
      }
    }
  }
  // a = exp(m - m'), from m as it was: every owner of a row reads it
  // before its first owner writes m'
  float alpha[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + 16 * i;
    alpha[i] = row < Cq ? expf(__fsub_rn(m[bh + row], m_run[i])) : 0.0f;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + 16 * i;
    if (row >= Cq) {
      continue;
    }
    if (cb == 0) {
      m[bh + row] = m_run[i];
      l[bh + row] = __fadd_rn(__fmul_rn(l[bh + row], alpha[i]), l_acc[i]);
    }
    // scalar accesses: o need not be 16-byte aligned
    float* orow = o + (bh + row) * HD;
#pragma unroll
    for (int g = 0; g < NC / G::kGroup; ++g) {
#pragma unroll
      for (int e = 0; e < G::kGroup; ++e) {
        const int c = G::kGroup * (cb + 8 * g) + e;
        orow[c] = __fadd_rn(__fmul_rn(orow[c], alpha[i]),
                            acc[i][G::kGroup * g + e]);
      }
    }
  }
}

template <int HD>
int fwd(const float* q, const float* k, const float* v, float* m, float* l,
        float* o, const Layout& lay, int B, int Cq, int Ck, int H,
        const Pos& pos, cudaStream_t stream) {
  const int tiles = (Cq + kTile - 1) / kTile;
  if ((long long)B * H > 0x7fffffffLL || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int bytes = fwd_smem_bytes<HD>();
  static const int attr = (int)cudaFuncSetAttribute(
      ring_fold_fwd_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != 0) {
    return attr;
  }
  ring_fold_fwd_f32_kernel<HD><<<dim3(B * H, tiles), kThreads, bytes,
                                 stream>>>(q, k, v, m, l, o, lay, Cq, Ck, H,
                                           pos);
  return (int)cudaGetLastError();
}

// dq += the block's dS . K for one query tile, in one pass over the key
// tiles it visits (every one if a row of the tile has seen no key, else
// up to the first wholly masked tile); K and V tile n + 1 land in stage
// (n + 1) % 2 while tile n is computed, and dS is staged over tile n's V.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    ring_fold_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, Layout lay, int Cq,
                            int Ck, int H, Pos pos) {
  using G = Stage<HD>;
  constexpr int NC = G::kCols;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sDO = sQ + G::kFloats;
  float* sK = sDO + G::kFloats;     // two stages
  float* sV = sK + 2 * G::kFloats;  // two stages; dS over V
  // blocks start in index order, x fastest: every (h, b) of the longest
  // query tiles first
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int ra = threadIdx.x >> 3;
  const int cb = threadIdx.x & 7;
  const int q0 = qt * kTile;
  const int n_kt = (Ck + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;

  float L[4];  // +inf past Cq: p = 0 there
  float D[4];
  int degen = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + 16 * i;
    L[i] = row < Cq ? lse[bh + row] : INFINITY;
    D[i] = row < Cq ? delta[bh + row] : 0.0f;
    degen |= row < Cq && degenerate(L[i]);
  }
  degen = __syncthreads_or(degen);
  // the key tiles visited: masked tiles come last (their keys are the
  // latest), so a prefix
  int n_vis = 0;
  while (n_vis < n_kt &&
         (degen || !all_masked(pos, q0, Cq, n_vis * kTile, kTile))) {
    ++n_vis;
  }
  if (n_vis > 0) {
    load_tile<HD>(sQ, q, lay.t[0], b, h, q0, Cq);
    load_tile<HD>(sDO, dout, lay.t[3], b, h, q0, Cq);
    load_tile<HD>(sK, k, lay.t[1], b, h, 0, Ck);
    load_tile<HD>(sV, v, lay.t[2], b, h, 0, Ck);
    cp_async_commit();
  }
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[i][c] = 0.0f;
    }
  }
  for (int kt = 0; kt < n_vis; ++kt) {
    cp_async_wait_all();
    // tile kt is in place for every thread, and every thread is done
    // with tile kt - 1's stage (its K and the dS over its V)
    __syncthreads();
    if (kt + 1 < n_vis) {
      const int st = (kt + 1) & 1;
      load_tile<HD>(sK + st * G::kFloats, k, lay.t[1], b, h,
                    (kt + 1) * kTile, Ck);
      load_tile<HD>(sV + st * kDqVStage<HD>, v, lay.t[2], b, h,
                    (kt + 1) * kTile, Ck);
      cp_async_commit();
    }
    const int st = kt & 1;
    const int k0 = kt * kTile;
    float* sVS = sV + st * kDqVStage<HD>;  // V, then dS [64][kLdP] over it
    float w[4][8];
    float s[4][8];
    scores<HD>(w, sDO, sVS, ra, cb);                  // dW = dO . V
    scores<HD>(s, sQ, sK + st * G::kFloats, ra, cb);  // s = Q . K
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ra + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + cb + 8 * j;
        float x;
        if (key >= Ck) {
          x = -INFINITY;  // no key: p = 0, even where L is about -1e30
        } else if (pos.causal && pos.q_off + row < pos.k_off + key) {
          x = kNeg;
        } else {
          x = __fmul_rn(s[i][j], pos.scale);
        }
        const float p = expf(__fsub_rn(x, L[i]));
        s[i][j] = __fmul_rn(__fmul_rn(p, __fsub_rn(w[i][j], D[i])),
                            pos.scale);
      }
    }
    __syncthreads();  // every thread has read V for its dW
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sVS[(ra + 16 * i) * kLdP + cb + 8 * j] = s[i][j];
      }
    }
    __syncthreads();  // dS in place
    // dq += dS . K, summed over the keys in order straight into acc
    weights_v<HD>(acc, sVS, sK + st * G::kFloats, ra, cb);
  }
  // the block's sum added to the carried dq once (a 0 where no key tile
  // was visited, as the SIMT kernel adds it)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ra + 16 * i;
    if (row < Cq) {
      add_cols<HD>(dq + (bh + row) * HD, acc[i], cb);
    }
  }
}

template <int HD>
int bwd_dq(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dq, const Layout& lay,
           int B, int Cq, int Ck, int H, const Pos& pos,
           cudaStream_t stream) {
  const int tiles = (Cq + kTile - 1) / kTile;
  if ((long long)B * H > 0x7fffffffLL || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int bytes = dq_smem_bytes<HD>();
  static const int attr = (int)cudaFuncSetAttribute(
      ring_fold_dq_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != 0) {
    return attr;
  }
  ring_fold_dq_f32_kernel<HD><<<dim3(B * H, tiles), kThreads, bytes,
                                stream>>>(q, k, v, dout, lse, delta, dq, lay,
                                          Cq, Ck, H, pos);
  return (int)cudaGetLastError();
}

// depth steps of dk/dv's score products unrolled: at hd 128 two would
// spill (ptxas: 8 bytes at 255 registers)
template <int HD>
constexpr int kDkdvUnroll = HD == 128 ? 1 : 2;

template <int HD>
constexpr int dkdv_smem_bytes() {  // K, V, Q, dO, P^T, dS^T, lse, D
  return (4 * Stage<HD>::kFloats + 2 * kTile * kLdP + 2 * kTile) *
         (int)sizeof(float);
}

// dk and dv += the block's sums for one key tile, over the query tiles
// that see it (every one if a row of the block has seen no key), on
// transposed tiles: rows keys ra + 16 i, columns queries cb + 8 j.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    ring_fold_dkdv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Layout lay, int Cq, int Ck, int H, Pos pos) {
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
  // which the most query tiles see, first
  const int kt = (int)blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int ra = threadIdx.x >> 3;
  const int cb = threadIdx.x & 7;
  const int k0 = kt * kTile;
  const int n_qt = (Cq + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;

  int degen = 0;
  for (int r = threadIdx.x; r < Cq; r += kThreads) {
    degen |= degenerate(lse[bh + r]);
  }
  degen = __syncthreads_or(degen);
  // the query tiles visited: masked tiles come first (their queries are
  // the earliest), so a suffix
  int qt0 = 0;
  while (!degen && qt0 < n_qt &&
         all_masked(pos, qt0 * kTile, Cq, k0, kTile)) {
    ++qt0;
  }
  if (qt0 == n_qt) {
    return;  // every P and dS of the key tile is 0: dk, dv stay
  }

  // K and V resident; committed with the first query tile's copies
  load_tile<HD>(sK, k, lay.t[1], b, h, k0, Ck);
  load_tile<HD>(sV, v, lay.t[2], b, h, k0, Ck);
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
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // every thread is done with the last query tile
    load_tile<HD>(sQ, q, lay.t[0], b, h, q0, Cq);
    load_tile<HD>(sDO, dout, lay.t[3], b, h, q0, Cq);
    load_stats(sL, sD, lse + bh, delta + bh, q0, Cq);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the query tile in place for every thread
    float t[4][8];
    scores<HD, kDkdvUnroll<HD>>(t, sK, sQ, ra, cb);  // S^T = K . Q^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ra + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cb + 8 * j;
        float s;
        if (key >= Ck) {
          s = -INFINITY;  // no key: p = 0 (the row is never stored)
        } else if (pos.causal && pos.q_off + q0 + c < pos.k_off + key) {
          s = kNeg;
        } else {
          s = __fmul_rn(t[i][j], pos.scale);
        }
        // lse = +inf past Cq: p = 0
        sPT[(ra + 16 * i) * kLdP + c] =
            expf(__fsub_rn(s, col_lse(sL, q0, Cq, c)));
      }
    }
    // a compiler fence: p is read back from shared memory below, not
    // kept in 32 registers across the next product
    asm volatile("" ::: "memory");
    scores<HD, kDkdvUnroll<HD>>(t, sV, sDO, ra, cb);  // dP^T = V . dO^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at = (ra + 16 * i) * kLdP + cb + 8 * j;
        sDST[at] = __fmul_rn(                        // its own p
            __fmul_rn(sPT[at], __fsub_rn(t[i][j], sD[cb + 8 * j])),
            pos.scale);
      }
    }
    __syncthreads();  // P^T and dS^T in place
    // dv += P^T . dO, dk += dS^T . Q, summed over the queries in order
    weights_v<HD>(acc_v, sPT, sDO, ra, cb);
    weights_v<HD>(acc_k, sDST, sQ, ra, cb);
  }
  // the block's sums added to the carried state once
  const long long bhk = ((long long)b * H + h) * Ck;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ra + 16 * i;
    if (key < Ck) {
      add_cols<HD>(dk + (bhk + key) * HD, acc_k[i], cb);
      add_cols<HD>(dv + (bhk + key) * HD, acc_v[i], cb);
    }
  }
}

template <int HD>
int bwd_dkdv(const float* q, const float* k, const float* v,
             const float* dout, const float* lse, const float* delta,
             float* dk, float* dv, const Layout& lay, int B, int Cq, int Ck,
             int H, const Pos& pos, cudaStream_t stream) {
  const int tiles = (Ck + kTile - 1) / kTile;
  if ((long long)B * H > 0x7fffffffLL || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  constexpr int bytes = dkdv_smem_bytes<HD>();
  static const int attr = (int)cudaFuncSetAttribute(
      ring_fold_dkdv_f32_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != 0) {
    return attr;
  }
  ring_fold_dkdv_f32_kernel<HD><<<dim3(B * H, tiles), kThreads, bytes,
                                  stream>>>(q, k, v, dout, lse, delta, dk, dv,
                                            lay, Cq, Ck, H, pos);
  return (int)cudaGetLastError();
}

}  // namespace

// Called by trpc_ring_fold_fwd (ring_fold.cu) for f32 at hd 16, 64 or
// 128, with its arguments less the dtype; the shape already checked.
extern "C" int trpc_ring_fold_fwd_f32(const void* q, const void* k,
                                      const void* v, void* m, void* l,
                                      void* o, const long long* strides,
                                      int B, int Cq, int Ck, int H, int hd,
                                      int q_off, int k_off, int causal,
                                      float scale, void* stream) {
  const Layout lay = layout_of(strides, 3);
  const Pos pos{q_off, k_off, causal, scale};
  const float* args[3] = {(const float*)q, (const float*)k, (const float*)v};
  float* state[3] = {(float*)m, (float*)l, (float*)o};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return fwd<16>(args[0], args[1], args[2], state[0], state[1], state[2],
                     lay, B, Cq, Ck, H, pos, st);
    case 64:
      return fwd<64>(args[0], args[1], args[2], state[0], state[1], state[2],
                     lay, B, Cq, Ck, H, pos, st);
    case 128:
      return fwd<128>(args[0], args[1], args[2], state[0], state[1],
                      state[2], lay, B, Cq, Ck, H, pos, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Called by trpc_ring_fold_bwd_dq (ring_fold.cu) for f32 at hd 16, 64 or
// 128, with its arguments less the dtype; the shape already checked.
extern "C" int trpc_ring_fold_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int Cq, int Ck, int H, int hd, int q_off, int k_off, int causal,
    float scale, void* stream) {
  const Layout lay = layout_of(strides, 4);
  const Pos pos{q_off, k_off, causal, scale};
  const float* args[6] = {(const float*)q,    (const float*)k,
                          (const float*)v,    (const float*)dout,
                          (const float*)lse, (const float*)delta};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return bwd_dq<16>(args[0], args[1], args[2], args[3], args[4], args[5],
                        (float*)dq, lay, B, Cq, Ck, H, pos, st);
    case 64:
      return bwd_dq<64>(args[0], args[1], args[2], args[3], args[4], args[5],
                        (float*)dq, lay, B, Cq, Ck, H, pos, st);
    case 128:
      return bwd_dq<128>(args[0], args[1], args[2], args[3], args[4],
                         args[5], (float*)dq, lay, B, Cq, Ck, H, pos, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Called by trpc_ring_fold_bwd_dkdv (ring_fold.cu) for f32 at hd 16, 64 or
// 128, with its arguments less the dtype; the shape already checked.
extern "C" int trpc_ring_fold_bwd_dkdv_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int Cq, int Ck, int H, int hd,
    int q_off, int k_off, int causal, float scale, void* stream) {
  const Layout lay = layout_of(strides, 4);
  const Pos pos{q_off, k_off, causal, scale};
  const float* args[6] = {(const float*)q,    (const float*)k,
                          (const float*)v,    (const float*)dout,
                          (const float*)lse, (const float*)delta};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return bwd_dkdv<16>(args[0], args[1], args[2], args[3], args[4],
                          args[5], (float*)dk, (float*)dv, lay, B, Cq, Ck, H,
                          pos, st);
    case 64:
      return bwd_dkdv<64>(args[0], args[1], args[2], args[3], args[4],
                          args[5], (float*)dk, (float*)dv, lay, B, Cq, Ck, H,
                          pos, st);
    case 128:
      return bwd_dkdv<128>(args[0], args[1], args[2], args[3], args[4],
                           args[5], (float*)dk, (float*)dv, lay, B, Cq, Ck,
                           H, pos, st);
  }
  return (int)cudaErrorInvalidValue;
}
