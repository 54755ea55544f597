// ring_fold_f32_hd8.cu — the ring fold in f32 at head dim 8 on the CUDA
// cores: the forward, dq and dk/dv, each with the rows a thread owns in
// registers, the other side's rows of 8 floats through a two-stage
// cp.async ring, every product an f32 FMA from registers.
//
// Counterpart: the fold of brpc_tpu/parallel/ring_attention.py:56-71
// (and Ulysses' `_dense_local`, :125-133, one fold at offsets 0/0) and
// its jax.grad, at the reference tests' head dim, which ring_fold.cu's
// trpc_ring_fold_fwd, trpc_ring_fold_bwd_dq and trpc_ring_fold_bwd_dkdv
// send here for f32 at hd 8.  Layout and function are that file's:
//   q, dO [B, Cq, H, 8], k, v [B, Ck, H, 8] f32, read through their (b,
//   s, h) strides (the last dim contiguous; base and strides 16-byte
//   multiples, which the wrapper ensures by copying any other view)
//   m, l, lse, D [B, H, Cq] f32; o, dq [B, H, Cq, 8] and dk, dv [B, H,
//   Ck, 8] f32, contiguous; m, l, o, dq, dk, dv updated in place
//   s  = q . k * scale (f32 product, __fmul_rn), -1e30 where q_off + i <
//        k_off + j (causal), -inf past Ck (no key: out of every max, sum)
//   m' = max(m, rowmax s)   p = exp(s - m')   a = exp(m - m')
//   l' = l a + sum_j p      o' = o a + p . v
//   P  = exp(s - lse)   dP = dO . v   dS = P (dP - D) scale
//   dq += dS . k        dk += dS^T . q      dv += P^T . dO
// each op rounded as the jnp op is (the __f*_rn intrinsics: no FMA
// contraction across them).
//
// Bound on an H100 (B=8, C=1024, H=64, hd=8: chip_smoke.py's RING_HD8,
// one causal diagonal block; fold_bounds): operations, at the CUDA
// cores' 67 TFLOP/s (TF32 keeps too few bits for the f32 tolerance).
// 268.7 M scores are visible.  The forward's two products (q.k, p.v) are
// 8.6 GFLOP, 128.3 us, its 92.3 MB 27.6 us; dq's three (q.k, dO.v, dS.k)
// 12.9 GFLOP, 192.5 us, its 104.9 MB 31.3 us; dk/dv's four (q.k, dO.v,
// dS^T.q, P^T.dO) 17.2 GFLOP, 256.7 us, its 104.9 MB 31.3 us.
//
// Why not the SIMT kernels' design (they were in ring_fold.cu), nor the
// hd-16/64/128 f32 kernels' (ring_fold_f32.cu) at HD = 8: a row is 8
// floats, too shallow for either.  The SIMT kernels padded it to 16 (half
// their lanes computed zeros), computed the forward's scores twice (the
// row max, then p) and sent P and dS through shared memory, so their
// products were bound by shared-memory reads; f32_tile.cuh's weights_v at
// HD = 8 gives a thread one column of the accumulator, the same bound.
// Here each score's products come from registers, against K and V rows
// read once for every row the thread owns:
//
// Forward (ring_fold_fwd_f32_hd8_kernel).  One block of 256 threads per
// (64-row query tile, h, b), the longest query tiles first; thread (ra,
// cb) = (t / 8, t % 8) owns query rows ra + 32 i (i < 2) and keys cb + 8
// j (j < 8) of each key tile (f32_tile.cuh's geometry at two rows a
// thread).  Its 2 rows of Q (16 floats), their running max, its part of
// the row sums and of the 8-wide accumulators stay in registers; K and V
// tiles land through three stages of cp.async (rows 12 floats apart: the
// 8 rows a warp reads at once fall in distinct banks), the first issued
// before the skip rule is read.  Per key tile, for each of its 8 keys:
// one K row read (two float4), 2 scores as 8-deep FMA sums; the tile's
// row max over the row's 8 owners (three xor-shuffles); then, as
// ring_fold_f32.cu's one pass,
//   m_t = max(m_run, tile max)   c = exp(m_run - m_t)
//   l_own = l_own c + sum_j exp(s - m_t)   acc = acc c + part, with
//   part = exp(s - m_t) . v, 8 FMAs a score against the V row just read,
// each owner over its own keys in order, p never leaving registers, each
// tile's part summed apart and then added.  The row sum's adds are
// TwoSums whose rounding errors are carried beside it (l_err, rescaled
// with it): plain f32 sums of C / 8 terms a owner and a tree of 8 left l
// past WIDE_ERR_RATIO times the plain version's error from the fold in
// f64 on some inputs (the plain version's pairwise sum barely rounds;
// tests/test_torch_ring_fold.py holds the order to f64).  At the
// end the 8 owners' acc are summed by three xor-shuffles and their l by
// a tree of TwoSums, and m' = m_t, l' = l a + l_acc, o' = o a + acc are
// written once, with the reference's own a = exp(m - m') (m read by
// every owner of the row before its first owner writes m').  In f32 the
// reference rounds nothing before p . v, so one pass is allowed; its sums
// round otherwise than the two-pass SIMT kernel's, so it is held to the
// plain version and to the fold in f64.  Skip rule: ring_fold.cuh's
// unseen_degenerate, decided before the loop: a query tile with a row
// whose m is degenerate and which sees no key of the block visits every
// key tile (that row keeps m_t = -1e30 and weighs its masked scores by 1,
// as the reference); else the key tiles up to the first wholly masked
// one.  A tile pair at neither the causal diagonal nor the end of the
// keys skips the mask's compares.  About 36 issue slots a score (16 FMAs,
// the scale, the max, exp's 8, the sum, a share of the rescale, the part's
// add and the TwoSums, two shared reads).  __launch_bounds__ caps it at
// 128 registers for two blocks (16 warps) an SM: uncapped, ptxas took 168
// and one block ran far slower; four rows a thread at 12 warps ran no
// faster.  On an H100 neither more stages, nor dropping the barrier, the
// shuffles or the exponentials (timing hacks) moved it by much, and a
// full non-causal block runs about as efficiently as the causal one: what
// holds it near half the issue rate is not measured (PERF.md, Findings).
//
// dq (ring_fold_dq_f32_hd8_kernel).  One block of 64 threads per (64-row
// query tile, h, b), the longest first; thread t owns query row q0 + t:
// its Q and dO rows, lse, D and the 8-wide dq accumulator in registers.
// The key tiles land through a two-stage cp.async ring, the first issued
// before the skip rule is read; every thread reads each key's K and V
// rows (one broadcast a float4: all lanes read the same row) and computes
// s and dP as 8-deep FMA sums, P and dS in registers, then dq += dS . k,
// 8 FMAs against the K row it just read.  A row's keys
// never leave its thread, so dq is summed over the visited keys in order
// straight into the accumulator and added to the carried dq once (a 0
// where no key tile was visited), with the SIMT kernel's depth order for
// s and dP and its __f*_rn roundings of P and dS: the SIMT kernel's bits.
// Its skip rule is the SIMT kernel's: every key tile when some row of the
// query tile has a degenerate lse, else the tiles up to the first wholly
// masked one.  About 41 issue slots a score (24 FMAs, the scale, two
// subtractions, two multiplications, exp's 8, four shared reads); 80
// registers, so 12 blocks (24 warps) an SM.
//
// dk/dv (ring_fold_dkdv_f32_hd8_kernel):
//  - One block of 128 threads per (64-key tile, h, b), key tile 0 (which
//    the most query tiles see) first.  Thread (ra, cb), f32_tile.cuh's
//    geometry on transposed tiles, owns key rows ra + 16 i (i < 4) and
//    query columns cb + 8 j (j < 8) of each query tile.  Its 4 rows of K
//    and of V are loaded once into registers (64 floats).
//  - Per query tile and column j it reads one Q row and one dO row (four
//    float4) and lse and D of that query, then for each of its keys: S^T
//    and dP^T as 8-deep FMA sums, P^T and dS^T in registers, dk += dS^T .
//    q and dv += P^T . dO, 8 FMAs each, from the same two rows: 32 FMAs a
//    score, 128 for every four float4 read, no staging of P or dS, one
//    barrier a tile.
//  - Q, dO and their lse and D land through two stages of cp.async (16
//    bytes a copy; lse and D 4), tile i + 1 while tile i is computed.  A
//    tile pair at neither the causal diagonal nor the end of the queries
//    skips the mask's compares.
//  - Each thread sums its own queries' terms straight into its
//    accumulators (32 of dk, 32 of dv), in order; the 8 owners of a key
//    row (8 lanes of one warp) add their sums with three xor-shuffles
//    once per block, and the total is added to the carried dk, dv once.
//    A sum of C / 8 terms then a tree of 8, not the SIMT kernel's sum of
//    C in order.  Each query tile's part summed apart (as the bf16 hd-8
//    dk/dv does) would take 64 more registers beside the 128 of K, V and
//    the accumulators.  At 210 registers two blocks fit an SM; on an H100
//    a register cap to three (which spills), the column loop unrolled 1
//    or 8 times, and 2 keys a thread in blocks of 256 (16 warps an SM)
//    were none faster than this by more than two builds of one source
//    differ (PERF.md, Findings): occupancy is not what holds it back.
//  - S^T, P^T and dS^T are the SIMT kernel's bits (the same depth order
//    and roundings; fmaf commutes).  Its skip rule is the SIMT kernel's,
//    reading lse only of the rows that see no key of the block (as
//    ring_fold_hd8.cu's dk/dv): every query tile when such a row has a
//    degenerate lse, else the tiles not wholly before the key tile.
//
// No atomics in any of the three: one owner per output element, the same
// bits on a repeat.
#include <cuda_runtime.h>

#include <math.h>

#include "f32_tile.cuh"
#include "ring_fold.cuh"

namespace {

using Hd8 = Stage<8>;  // rows of 8 floats, 12 apart

// The 8 floats of row `row` of one (b, h) of an f32 [B, S, H, 8] tensor
// (16-byte aligned), from device memory; zeros at or past S.
__device__ __forceinline__ void load_row8(float (&x)[8], const float* base,
                                          const Strides& st, int row, int S) {
  if (row < S) {
    f32_row(x, base + (long long)row * st.s);
    return;
  }
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    x[d] = 0.0f;
  }
}

// sum_x a[x] b[x] over x in order, as the SIMT kernel's tile_mma
__device__ __forceinline__ float dot8(const float (&a)[8],
                                      const float (&b)[8]) {
  float s = 0.0f;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    s = fmaf(a[x], b[x], s);
  }
  return s;
}

// x[c] of a register row, without indexing it by c
__device__ __forceinline__ float pick(const float (&x)[8], int c) {
  float r = x[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    r = c == i ? x[i] : r;
  }
  return r;
}

// s + e = a + b exactly, s = a + b rounded (Knuth's TwoSum; the
// __f*_rn intrinsics keep the compiler from folding it away)
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
  return s;
}

// The sum over a row's 8 owners (8 lanes of one warp) of hi + lo, the
// tree of sum8 with each add's rounding error carried in lo (every lane
// gets the same bits: TwoSum's error is exact whatever the order)
__device__ __forceinline__ float sum8_compensated(float hi, float lo) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    const float ohi = __shfl_xor_sync(0xffffffffu, hi, off);
    const float olo = __shfl_xor_sync(0xffffffffu, lo, off);
    float e;
    hi = two_sum(hi, ohi, e);
    lo = __fadd_rn(__fadd_rn(lo, olo), e);
  }
  return __fadd_rn(hi, lo);
}

// The visited key tiles of query tile q0: masked tiles come last (their
// keys are the latest), so a prefix; every tile where `degen`.
__device__ __forceinline__ int visited_key_tiles(const Pos& pos, int q0,
                                                 int Cq, int Ck, int degen) {
  const int n_kt = (Ck + kTile - 1) / kTile;
  int n = 0;
  while (n < n_kt && (degen || !all_masked(pos, q0, Cq, n * kTile, kTile))) {
    ++n;
  }
  return n;
}

// Key tile k0 against query tile q0 holds a masked or a missing key: the
// tile pair straddles the causal diagonal or the end of the keys.
__device__ __forceinline__ bool key_edge(const Pos& pos, int q0, int k0,
                                         int Ck) {
  return k0 + kTile > Ck ||
         (pos.causal && pos.q_off + q0 < pos.k_off + k0 + kTile - 1);
}

// The reference's score of local query `row` against local key `key`
// from the product s: -inf past Ck, -1e30 where masked, else s * scale;
// `edge` false where neither can happen (no compare).
__device__ __forceinline__ float fold_score(float s, bool edge, int row,
                                            int key, int Ck,
                                            const Pos& pos) {
  if (edge && key >= Ck) {
    return -INFINITY;
  }
  if (edge && pos.causal && pos.q_off + row < pos.k_off + key) {
    return kNeg;
  }
  return __fmul_rn(s, pos.scale);
}

// cp.async groups: wait until at most N of the latest are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The forward's geometry: kFwdRows query rows a thread (ra + kFwdStep i),
// 8 owners a row, so 8 kTile / kFwdRows threads a block; K and V tiles
// through kFwdStages stages (two left ptxas a 12-byte spill at the
// 128-register cap of two blocks an SM)
constexpr int kFwdRows = 2;
constexpr int kFwdStep = kTile / kFwdRows;
constexpr int kFwdThreads = 8 * kFwdStep;
constexpr int kFwdStages = 3;

__global__ void __launch_bounds__(kFwdThreads, 2)
    ring_fold_fwd_f32_hd8_kernel(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ m, float* __restrict__ l,
                                 float* __restrict__ o, Layout lay, int Cq,
                                 int Ck, int H, Pos pos) {
  constexpr int R = kFwdRows;
  constexpr int S = kFwdStages;
  __shared__ __align__(16) float sK[S][Hd8::kFloats];
  __shared__ __align__(16) float sV[S][Hd8::kFloats];
  // blocks start in index order, x fastest: every (h, b) of the longest
  // query tiles first
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int ra = threadIdx.x >> 3;
  const int cb = threadIdx.x & 7;
  const int q0 = qt * kTile;
  const long long bh = ((long long)b * H + h) * Cq;
  const int n_kt = (Ck + kTile - 1) / kTile;

  // the first tiles' copies go out before the skip rule is read
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n_kt) {
      load_tile<8, kFwdThreads>(sK[t], k, lay.t[1], b, h, t * kTile, Ck);
      load_tile<8, kFwdThreads>(sV[t], v, lay.t[2], b, h, t * kTile, Ck);
    }
    cp_async_commit();
  }
  // the thread's rows of Q (zeros past Cq: those rows are never written)
  float qr[R][8];
  const float* qb = q + b * lay.t[0].b + h * lay.t[0].h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    load_row8(qr[i], qb, lay.t[0], q0 + ra + kFwdStep * i, Cq);
  }
  float m_run[R];
  int degen = 0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ra + kFwdStep * i;
    const bool valid = row < Cq;
    m_run[i] = valid ? m[bh + row] : kNeg;
    degen |= valid && unseen_degenerate(pos, row, m_run[i]);
  }
  degen = __syncthreads_or(degen);
  const int n_vis = visited_key_tiles(pos, q0, Cq, Ck, degen);
  if (n_vis == 0) {
    cp_async_wait_all();
    return;  // m' = m, a = 1, p = 0: the state stays as it is
  }
  float l_own[R];  // the owner's part of the row sum, and its rounding
  float l_err[R];  // errors
  float acc[R][8];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    l_own[i] = 0.0f;
    l_err[i] = 0.0f;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      acc[i][d] = 0.0f;
    }
  }
  for (int kt = 0; kt < n_vis; ++kt) {
    cp_async_wait_group<S - 2>();
    // tile kt is in place for every thread, and every thread is done
    // with tile kt - 1's stage
    __syncthreads();
    const int nt = kt + S - 1;
    if (nt < n_vis) {
      load_tile<8, kFwdThreads>(sK[nt % S], k, lay.t[1], b, h, nt * kTile,
                                Ck);
      load_tile<8, kFwdThreads>(sV[nt % S], v, lay.t[2], b, h, nt * kTile,
                                Ck);
    }
    cp_async_commit();
    const int st = kt % S;
    const int k0 = kt * kTile;
    const bool edge = key_edge(pos, q0, k0, Ck);
    float s[R][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float kv[8];
      f32_row(kv, sK[st] + (cb + 8 * j) * Hd8::kLd);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        s[i][j] = dot8(qr[i], kv);
      }
    }
    float corr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ra + kFwdStep * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = fold_score(s[i][j], edge, row, k0 + cb + 8 * j, Ck, pos);
        mx = fmaxf(mx, s[i][j]);
      }
      const float mt = fmaxf(m_run[i], max8(mx));
      corr[i] = expf(__fsub_rn(m_run[i], mt));
      m_run[i] = mt;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], mt));
        sum = __fadd_rn(sum, s[i][j]);
      }
      float e;
      l_own[i] = two_sum(__fmul_rn(l_own[i], corr[i]), sum, e);
      l_err[i] = __fadd_rn(__fmul_rn(l_err[i], corr[i]), e);
    }
    // the tile's p . V over the thread's keys in order, from registers,
    // summed apart and then added: 8 adds at the tile sum's magnitude and
    // one at acc's, not every add at acc's
    float part[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        part[i][d] = 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float vv[8];
      f32_row(vv, sV[st] + (cb + 8 * j) * Hd8::kLd);
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          part[i][d] = fmaf(s[i][j], vv[d], part[i][d]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        acc[i][d] = __fadd_rn(__fmul_rn(acc[i][d], corr[i]), part[i][d]);
      }
    }
  }
  cp_async_wait_all();  // no copy left in flight at the exit
  // a = exp(m - m'), from m as it was: every owner of a row (8 lanes of
  // one warp) reads it before its first owner writes m'
  float alpha[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ra + kFwdStep * i;
    alpha[i] = row < Cq ? expf(__fsub_rn(m[bh + row], m_run[i])) : 0.0f;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    // the row's 8 owners add their parts; lane cb updates dimension cb
    // of o (scalar accesses: o need not be 16-byte aligned)
    const float total = sum8_compensated(l_own[i], l_err[i]);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      acc[i][d] = sum8(acc[i][d]);
    }
    const int row = q0 + ra + kFwdStep * i;
    if (row >= Cq) {
      continue;
    }
    if (cb == 0) {
      m[bh + row] = m_run[i];
      l[bh + row] = __fadd_rn(__fmul_rn(l[bh + row], alpha[i]), total);
    }
    float* oc = o + (bh + row) * 8 + cb;
    *oc = __fadd_rn(__fmul_rn(*oc, alpha[i]), pick(acc[i], cb));
  }
}

// dq: 64 threads a block, one query row each; K and V tiles through
// kDqStages stages
constexpr int kDqThreads = kTile;
constexpr int kDqStages = 2;

__global__ void __launch_bounds__(kDqThreads)
    ring_fold_dq_f32_hd8_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const float* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                float* __restrict__ dq, Layout lay, int Cq,
                                int Ck, int H, Pos pos) {
  constexpr int S = kDqStages;
  __shared__ __align__(16) float sK[S][Hd8::kFloats];
  __shared__ __align__(16) float sV[S][Hd8::kFloats];
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int q0 = qt * kTile;
  const int row = q0 + (int)threadIdx.x;
  const bool valid = row < Cq;
  const long long bh = ((long long)b * H + h) * Cq;
  const int n_kt = (Ck + kTile - 1) / kTile;

  // the first tiles' copies go out before the skip rule is read
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n_kt) {
      load_tile<8, kDqThreads>(sK[t], k, lay.t[1], b, h, t * kTile, Ck);
      load_tile<8, kDqThreads>(sV[t], v, lay.t[2], b, h, t * kTile, Ck);
    }
    cp_async_commit();
  }
  float qr[8];
  float dr[8];
  load_row8(qr, q + b * lay.t[0].b + h * lay.t[0].h, lay.t[0], row, Cq);
  load_row8(dr, dout + b * lay.t[3].b + h * lay.t[3].h, lay.t[3], row, Cq);
  const float L = valid ? lse[bh + row] : INFINITY;  // +inf: p = 0
  const float D = valid ? delta[bh + row] : 0.0f;
  const int degen = __syncthreads_or(valid && degenerate(L));
  const int n_vis = visited_key_tiles(pos, q0, Cq, Ck, degen);
  float acc[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    acc[d] = 0.0f;
  }
  for (int kt = 0; kt < n_vis; ++kt) {
    cp_async_wait_group<S - 2>();
    __syncthreads();
    const int nt = kt + S - 1;
    if (nt < n_vis) {
      load_tile<8, kDqThreads>(sK[nt % S], k, lay.t[1], b, h, nt * kTile,
                               Ck);
      load_tile<8, kDqThreads>(sV[nt % S], v, lay.t[2], b, h, nt * kTile,
                               Ck);
    }
    cp_async_commit();
    const float* sk = sK[kt % S];
    const float* sv = sV[kt % S];
    const int k0 = kt * kTile;
    const bool edge = key_edge(pos, q0, k0, Ck);
    // every key of the tile in order (rows past Ck are zeros, their
    // score -inf, so their dS is 0, as the SIMT kernel's); unrolled 2
    // (4 left ptxas an 8-byte spill at 80 registers)
#pragma unroll 2
    for (int x = 0; x < kTile; ++x) {
      float kv[8];
      float vv[8];
      f32_row(kv, sk + x * Hd8::kLd);
      f32_row(vv, sv + x * Hd8::kLd);
      const float s = fold_score(dot8(qr, kv), edge, row, k0 + x, Ck, pos);
      const float w = dot8(dr, vv);  // dP = dO . V
      const float p = expf(__fsub_rn(s, L));
      const float ds = __fmul_rn(__fmul_rn(p, __fsub_rn(w, D)), pos.scale);
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        acc[d] = fmaf(ds, kv[d], acc[d]);
      }
    }
  }
  cp_async_wait_all();  // no copy left in flight at the exit
  // the block's sum added to the carried dq once (a 0 where no key tile
  // was visited, as the SIMT kernel adds it; scalar accesses)
  if (valid) {
    float* dst = dq + (bh + row) * 8;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      dst[d] = __fadd_rn(dst[d], acc[d]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_fold_dkdv_f32_hd8_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  float* __restrict__ dk,
                                  float* __restrict__ dv, Layout lay, int Cq,
                                  int Ck, int H, Pos pos) {
  __shared__ __align__(16) float sQ[2][Hd8::kFloats];
  __shared__ __align__(16) float sDO[2][Hd8::kFloats];
  __shared__ __align__(16) float sL[2][kTile];
  __shared__ __align__(16) float sD[2][kTile];
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

  // only rows that see no key of the block can be degenerate
  int degen = 0;
  for (int row = threadIdx.x; row < Cq && sees_no_key(pos, row);
       row += kThreads) {
    degen |= degenerate(lse[bh + row]);
  }
  degen = __syncthreads_or(degen);
  // the query tiles visited: masked tiles come first (their queries are
  // the earliest), so a suffix
  int qt0 = 0;
  while (!degen && qt0 < n_qt && all_masked(pos, qt0 * kTile, Cq, k0, kTile)) {
    ++qt0;
  }
  if (qt0 == n_qt) {
    return;  // every P and dS of the key tile is 0: dk, dv stay
  }

  load_tile<8>(sQ[0], q, lay.t[0], b, h, qt0 * kTile, Cq);
  load_tile<8>(sDO[0], dout, lay.t[3], b, h, qt0 * kTile, Cq);
  load_stats(sL[0], sD[0], lse + bh, delta + bh, qt0 * kTile, Cq);
  cp_async_commit();
  // the thread's keys k0 + ra + 16 i of K and V (zeros past Ck: those
  // rows are never written)
  float kr[4][8];
  float vr[4][8];
  const float* kb = k + b * lay.t[1].b + h * lay.t[1].h;
  const float* vb = v + b * lay.t[2].b + h * lay.t[2].h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    load_row8(kr[i], kb, lay.t[1], k0 + ra + 16 * i, Ck);
    load_row8(vr[i], vb, lay.t[2], k0 + ra + 16 * i, Ck);
  }

  float acc_k[4][8];
  float acc_v[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      acc_k[i][d] = 0.0f;
      acc_v[i][d] = 0.0f;
    }
  }
  for (int qt = qt0; qt < n_qt; ++qt) {
    cp_async_wait_all();
    // tile qt is in place for every thread, and every thread is done
    // with tile qt - 1's stage
    __syncthreads();
    if (qt + 1 < n_qt) {
      const int nx = (qt + 1 - qt0) & 1;
      load_tile<8>(sQ[nx], q, lay.t[0], b, h, (qt + 1) * kTile, Cq);
      load_tile<8>(sDO[nx], dout, lay.t[3], b, h, (qt + 1) * kTile, Cq);
      load_stats(sL[nx], sD[nx], lse + bh, delta + bh, (qt + 1) * kTile,
                 Cq);
      cp_async_commit();
    }
    const int st = (qt - qt0) & 1;
    const int q0 = qt * kTile;
    // past Cq (lse +inf there) or at the causal diagonal
    const bool edge =
        q0 + kTile > Cq ||
        (pos.causal && pos.q_off + q0 < pos.k_off + k0 + kTile - 1);
#pragma unroll 2
    for (int j = 0; j < 8; ++j) {
      const int c = cb + 8 * j;
      float qv[8];
      float ov[8];
      f32_row(qv, sQ[st] + c * Hd8::kLd);
      f32_row(ov, sDO[st] + c * Hd8::kLd);
      const float L = edge ? col_lse(sL[st], q0, Cq, c) : sL[st][c];
      const float D = sD[st][c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = dot8(kr[i], qv);  // S^T = K . Q^T
        const float w = dot8(vr[i], ov);  // dP^T = V . dO^T
        float x;
        if (edge && pos.causal &&
            pos.q_off + q0 + c < pos.k_off + k0 + ra + 16 * i) {
          x = kNeg;
        } else {
          x = __fmul_rn(s, pos.scale);
        }
        const float p = expf(__fsub_rn(x, L));
        const float ds =
            __fmul_rn(__fmul_rn(p, __fsub_rn(w, D)), pos.scale);
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          acc_k[i][d] = fmaf(ds, qv[d], acc_k[i][d]);
          acc_v[i][d] = fmaf(p, ov[d], acc_v[i][d]);
        }
      }
    }
  }
  // the 8 owners of each key row sum their parts; lane cb adds dimension
  // cb of the total to the carried dk, dv once (scalar accesses: they
  // need not be 16-byte aligned)
  const long long bhk = ((long long)b * H + h) * Ck;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      acc_k[i][d] = sum8(acc_k[i][d]);
      acc_v[i][d] = sum8(acc_v[i][d]);
    }
    const int key = k0 + ra + 16 * i;
    if (key < Ck) {
      float* dkr = dk + (bhk + key) * 8 + cb;
      float* dvr = dv + (bhk + key) * 8 + cb;
      *dkr = __fadd_rn(*dkr, pick(acc_k[i], cb));
      *dvr = __fadd_rn(*dvr, pick(acc_v[i], cb));
    }
  }
}

}  // namespace

// The C entries, called by ring_fold.cu's trpc_ring_fold_fwd,
// trpc_ring_fold_bwd_dq and trpc_ring_fold_bwd_dkdv for f32 at hd 8, with
// their arguments less hd and the dtype; the shape already checked.
extern "C" int trpc_ring_fold_fwd_f32_hd8(const void* q, const void* k,
                                          const void* v, void* m, void* l,
                                          void* o, const long long* strides,
                                          int B, int Cq, int Ck, int H,
                                          int q_off, int k_off, int causal,
                                          float scale, void* stream) {
  const int tiles = (Cq + kTile - 1) / kTile;
  if ((long long)B * H > 0x7fffffffLL || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  ring_fold_fwd_f32_hd8_kernel<<<dim3(B * H, tiles), kFwdThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)m,
      (float*)l, (float*)o, layout_of(strides, 3), Cq, Ck, H,
      Pos{q_off, k_off, causal, scale});
  return (int)cudaGetLastError();
}

extern "C" int trpc_ring_fold_bwd_dq_f32_hd8(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int Cq, int Ck, int H, int q_off, int k_off, int causal,
    float scale, void* stream) {
  const int tiles = (Cq + kTile - 1) / kTile;
  if ((long long)B * H > 0x7fffffffLL || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  ring_fold_dq_f32_hd8_kernel<<<dim3(B * H, tiles), kDqThreads, 0,
                                (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq,
      layout_of(strides, 4), Cq, Ck, H, Pos{q_off, k_off, causal, scale});
  return (int)cudaGetLastError();
}

extern "C" int trpc_ring_fold_bwd_dkdv_f32_hd8(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int Cq, int Ck, int H, int q_off,
    int k_off, int causal, float scale, void* stream) {
  const int tiles = (Ck + kTile - 1) / kTile;
  if ((long long)B * H > 0x7fffffffLL || tiles > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  ring_fold_dkdv_f32_hd8_kernel<<<dim3(B * H, tiles), kThreads, 0,
                                  (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv,
      layout_of(strides, 4), Cq, Ck, H, Pos{q_off, k_off, causal, scale});
  return (int)cudaGetLastError();
}
