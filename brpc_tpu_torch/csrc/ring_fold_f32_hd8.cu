// ring_fold_f32_hd8.cu — the ring fold's dk/dv in f32 at head dim 8 on
// the CUDA cores: each thread's keys of K and V in registers, the query
// tiles through a two-stage cp.async ring, every product an f32 FMA from
// registers.
//
// Counterpart: the dk/dv half of jax.grad of the fold of
// brpc_tpu/parallel/ring_attention.py:56-71 at the reference tests' head
// dim, which ring_fold.cu's trpc_ring_fold_bwd_dkdv sends here for f32 at
// hd 8.  Layout and function are that file's:
//   q, dO [B, Cq, H, 8], k, v [B, Ck, H, 8] f32, read through their (b,
//   s, h) strides (the last dim contiguous; base and strides 16-byte
//   multiples, which the wrapper ensures by copying any other view)
//   lse, D [B, H, Cq] f32; dk, dv [B, H, Ck, 8] f32, contiguous, updated
//   in place
//   s  = q . k * scale (f32 product, __fmul_rn), -1e30 where q_off + i <
//        k_off + j (causal)
//   P  = exp(s - lse)   dP = dO . v   dS = P (dP - D) scale
//   dk += dS^T . q      dv += P^T . dO
// each op rounded as the jnp op is (the __f*_rn intrinsics: no FMA
// contraction across them).
//
// Bound on an H100 (B=8, C=1024, H=64, hd=8: chip_smoke.py's RING_HD8,
// one causal diagonal block; fold_bounds): operations.  268.7 M scores
// are visible; the four products (q.k, dO.v, dS^T.q, P^T.dO) are 17.2
// GFLOP, 256.7 us at the CUDA cores' 67 TFLOP/s (TF32 keeps too few
// bits for the f32 tolerance); the 104.9 MB it moves take 31.3 us.
//
// Why not the SIMT kernel's design (ring_fold.cu), nor the hd-16/64/128
// f32 kernel's (ring_fold_f32.cu) at HD = 8: a row is 8 floats, too
// shallow for either.  The SIMT kernel pads it to 16 (half its lanes
// compute zeros) and sends P and dS through shared memory; f32_tile.cuh's
// weights_v at HD = 8 gives a thread one column of the accumulator, so
// each 4 keys of a weight product read 4 float4 of weights and 4 scalars
// of V for 16 FMAs, bound by shared-memory reads.  Here every score's
// four products come from registers:
//  - One block of 128 threads per (64-key tile, h, b), key tile 0 (which
//    the most query tiles see) first.  Thread (ra, cb) = (t / 8, t % 8),
//    f32_tile.cuh's geometry on transposed tiles, owns key rows ra + 16 i
//    (i < 4) and query columns cb + 8 j (j < 8) of each query tile.  Its
//    4 rows of K and of V are loaded once into registers (64 floats).
//  - Per query tile and column j it reads one Q row and one dO row (four
//    float4, rows 12 floats apart, so the 8 rows a warp reads at once
//    fall in distinct banks) and lse and D of that query, then for each
//    of its keys: S^T and dP^T as 8-deep FMA sums, P^T and dS^T in
//    registers, dk += dS^T . q and dv += P^T . dO, 8 FMAs each, from the
//    same two rows: 32 FMAs a score, 128 for every four float4 read, no
//    staging of P or dS, one barrier a tile.
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
//  - No atomics: one owner per output element, the same bits on a
//    repeat.
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

// Called by trpc_ring_fold_bwd_dkdv (ring_fold.cu) for f32 at hd 8, with
// its arguments less hd and the dtype; the shape already checked.
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
