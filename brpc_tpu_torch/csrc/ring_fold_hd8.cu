// ring_fold_hd8.cu — the ring fold's forward, dq and dk/dv in bf16 at
// head dim 8 on the tensor cores (mma.sync), with p's f32 products as f32
// FMAs from registers.
//
// Counterpart: the fold of brpc_tpu/parallel/ring_attention.py:56-71 at
// the reference tests' head dim, and its jax.grad, which ring_fold.cu's
// trpc_ring_fold_fwd, trpc_ring_fold_bwd_dq and trpc_ring_fold_bwd_dkdv
// send here for bf16 at hd 8 (f32 at hd 8 goes to ring_fold_f32_hd8.cu).
// Layout and function are ring_fold.cu's:
//   q, dO [B, Cq, H, 8], k, v [B, Ck, H, 8] bf16, read through their
//   (b, s, h) strides (the last dim contiguous; base and strides 16-byte
//   multiples, which the wrapper ensures by copying any other view)
//   m, l, lse, D [B, H, Cq] f32, o, dq [B, H, Cq, 8] f32 (o
//   unnormalised), dk, dv [B, H, Ck, 8] f32, contiguous; m, l, o, dq,
//   dk, dv updated in place
//   s  = f32(bf16(q . k)) * scale, -1e30 where q_off + i < k_off + j
//        (causal), -inf past Ck (no key: out of every max and sum)
//   m' = max(m, rowmax s)   p = exp(s - m')   a = exp(m - m')
//   l' = l a + sum_j p      o' = o a + p . f32(v)   (an f32 product)
//   P  = exp(s - lse)   dP = f32(dO) . f32(v)   dS = bf16(P (dP - D) scale)
//   dq += dS . k   dk += dS^T . q   dv += P^T . f32(dO)    (f32 sums)
// each op rounded as the jnp op is (the __f*_rn intrinsics: no FMA
// contraction across them).
//
// Bound on an H100 (B=8, C=1024, H=64, hd=8: chip_smoke.py's RING_HD8,
// one causal diagonal block; fold_bounds).  268.7 M scores are visible.
// q.k, dO.v, dS.k and dS^T.q, products of bf16 values, are 4.3 GFLOP
// each, 4.35 us on the tensor cores; p.v and P^T.dO, f32 products, 64.2
// us each at the CUDA cores' 67 TFLOP/s; one exponential a visible
// score, 64.3 us on the SFUs (16 an SM a clock).  The forward moves 67.1
// MB (20.0 us at 3.35 TB/s), dq 71.3 MB (21.3 us), dk/dv 104.9 MB (31.3
// us).  So the forward's least time is 68.5 us and dk/dv's 77.2 us, both
// the CUDA cores' f32 products; dq has no f32 product, and its least
// time is its exponentials', 64.3 us.
//
// Why not the SIMT kernels' design: at hd 8 a row of q, k or v is 16
// bytes, far too little depth for the 16 x 16 thread grid's staged f32
// tiles (half of its product lanes computed zero padding, p and dS made
// a round trip through shared memory, and the forward computed q . k
// twice).  Here a warp owns 16 rows, and hd 8 is exactly one k-step of
// mma.sync.m16n8k8 (wgmma's bf16 k-step is 16, which would pad q . k):
//  - q . k (and dO . v^T, k . q^T, v . dO^T) with mma.sync m16n8k8: the
//    fragments of the warp's own 16 rows are loaded once, from device
//    memory; a key (or query) tile's 8 B fragments with two ldmatrix.x4.
//    The products of bf16 values are exact, and their f32 sum of 8 is
//    rounded to bf16 as the reference rounds the T product.
//  - The scores stay in the accumulator layout: thread (g, t) = (lane /
//    4, lane % 4) holds rows g and g + 8 at columns 8 j + 2 t + {0, 1}
//    (j < 8) of a 64-column tile.  p (P^T) is formed there, and its f32
//    products read, for each column the thread holds, one row of v (dO)
//    staged as f32 in shared memory, 8 FMAs for each of its two rows: no
//    staging of p, no lane on padding, no conversion in the FMA loop.  A
//    row's 4 owners are a quad, whose partial sums meet with two
//    xor-shuffles once per block.  dS (dS^T) is formed there too, and
//    two adjacent n8 accumulator tiles of it, rounded to bf16, are the A
//    fragment of m16n8k16, so its product with k (q) runs on the tensor
//    cores with no shared-memory round trip, the B fragments by
//    ldmatrix.trans from the staged bf16 tile.
//  - Two stages in shared memory, tile i + 1 landing while tile i is
//    computed: K (Q; and lse, D) by cp.async, one 16-byte copy a row; V
//    (dO) loaded into registers a tile ahead and stored as f32 rows (dO
//    also as bf16, for its B fragments) after the tile's work, so no
//    second barrier a tile.  A tile pair that masks no score (not at the
//    causal diagonal, not past the block's end) skips the mask's
//    compares.
//
// Forward (ring_fold_fwd_hd8_kernel): one block of 4 warps per (64-row
// query tile, h, b), the longest query tiles first.  One pass, as the f32
// forward (ring_fold_f32.cu): per key tile m_t = max(m_run, tile row max)
// (a quad max), c = exp(m_run - m_t), the thread's partials l = l c +
// sum exp(s - m_t) and o = o c + exp(s - m_t) . v over its own columns,
// each tile's sums taken apart and then added (in the CPU model, on exact
// scores over 1024 keys, that halves o's distance to the fold in f64);
// at the end the quad sums them and writes m' = m_t, l' = l a + l_acc,
// o' = o a + acc once, a = exp(m - m').  Wherever no tile after the first
// raises a row's max, every exp(s - m_t) is the reference's p bit for
// bit.  The skip rule is decided before the loop (unseen_degenerate).
//
// dq (ring_fold_dq_hd8_kernel): the forward's grid and warps, over the
// key tiles through the ring, K and V both staged as bf16 rows by
// cp.async (nothing needs V as f32 here): S = Q . K^T and dP = dO . V^T
// with m16n8k8 from the warp's Q and dO fragments, P = exp(S - lse) and
// dS in f32 in registers (lse and D per row, lse = +inf past Cq), then
// dq += dS . K on m16n8k16 (K's B fragments by ldmatrix.trans), summed
// in the accumulator over the visited tiles and added to the carried dq
// once.  No product of it is an f32 one: its loop is the exponentials,
// the f32 ops around them and three mma a 16 x 16 chunk.  Its skip rule
// is the SIMT kernel's: every key tile when some row of the query tile
// has a degenerate lse, else the tiles up to the first wholly masked one.
//
// dk/dv (ring_fold_dkdv_hd8_kernel): one block of 4 warps per (64-key
// tile, h, b), key tile 0 (which the most query tiles see) first, a warp
// per 16 keys, over the query tiles through the ring: S^T = K . Q^T and
// dP^T = V . dO^T with m16n8k8, P^T = exp(S^T - lse) and dS^T in f32 in
// registers; dk += dS^T . Q on m16n8k16 as dq's dS . K; dv += P^T .
// f32(dO) as f32 FMAs, each query tile's part summed apart and then
// added, the quad's partials summed once at the end.  The skip rule
// needs the degenerate flag only of rows that see no key of the block
// (sees_no_key: none on a diagonal or past block), so only those rows'
// lse are read for it, not the whole row.
//
// One owner per output element and no atomics: two runs give the same
// bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "f32_tile.cuh"
#include "ring_fold.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// D = A B + D: A 16 x 8 bf16 (two registers), B 8 x 8 (one), D 16 x 8 f32
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// D = A B + D: A 16 x 16 bf16 (four registers), B 16 x 8 (two), D f32
__device__ __forceinline__ void mma_k16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices: lane l gives the address of row l % 8 of
// matrix l / 8 and gets r[i] = row l / 4, columns 2 (l % 4) and 2 (l % 4)
// + 1 of matrix i (with .trans: column l / 4, rows 2 (l % 4) and + 1).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The 8 B fragments (8-row tiles j) of a staged 64-row tile: one per
// ldmatrix matrix, rows 8 j .. 8 j + 7.
__device__ __forceinline__ void b_frags(uint32_t (&r)[8], const uint4* tile,
                                        int lane) {
  ldsm_x4(r, smem_u32(tile + lane));
  ldsm_x4(r + 4, smem_u32(tile + 32 + lane));
}

// Columns 2 t, 2 t + 1 of local row `row` of one (b, h) of a bf16
// [B, S, H, 8] tensor: the A fragment's register of that row; 0 past S.
__device__ __forceinline__ uint32_t a_word(const bf16* base,
                                           const Strides& st, int row, int S,
                                           int t) {
  return row < S ? *reinterpret_cast<const uint32_t*>(
                       base + (long long)row * st.s + 2 * t)
                 : 0u;
}

// Row r of a 64-row tile (rows row0.. of one (b, h)) into dst[r], one
// 16-byte cp.async; zeros at or past S.
__device__ __forceinline__ void copy_row(uint4* dst, const bf16* base,
                                         const Strides& st, int row0, int S,
                                         int r) {
  const int row = row0 + r;
  const bool ok = row < S;
  cp_async16(smem_u32(dst + r), ok ? base + (long long)row * st.s : base,
             ok);
}

// One bf16 row of 8 values (16 bytes) of one (b, h) of a [B, S, H, 8]
// tensor, from device memory into registers; zeros at or past S.
__device__ __forceinline__ uint4 load_row(const bf16* base, const Strides& st,
                                          int row, int S) {
  return row < S ? *reinterpret_cast<const uint4*>(base +
                                                   (long long)row * st.s)
                 : make_uint4(0u, 0u, 0u, 0u);
}

// A bf16 row as 8 f32 values into dst (a row of kLdF floats, 16-byte
// aligned): the exact conversion, once per tile, so the FMA loops read
// f32 and convert nothing.
__device__ __forceinline__ void store_f32_row(float* dst, const uint4& u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float f[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

// f32 rows of v (dO) are staged 12 floats apart: the 16-byte reads of the
// 4 rows 2 t + c a quad set reads at once (48 bytes x 2 t apart) fall in
// distinct banks.
constexpr int kLdF = 12;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The bf16 product, scaled in f32: the reference's score where nothing
// masks it.
__device__ __forceinline__ float scaled(float acc, const Pos& pos) {
  return __fmul_rn(__bfloat162float(__float2bfloat16_rn(acc)), pos.scale);
}

// The reference's score from the accumulator at a tile pair's edge: -1e30
// where masked, -inf past the block's keys.
__device__ __forceinline__ float score(float acc, int row, int key, int Ck,
                                       const Pos& pos) {
  if (key >= Ck) {
    return -INFINITY;
  }
  if (pos.causal && pos.q_off + row < pos.k_off + key) {
    return kNeg;
  }
  return scaled(acc, pos);
}

// Whether the tile pair (query rows q0.., keys k0..) may mask a score:
// some query before some key (causal), or keys past the block's end.
__device__ __forceinline__ bool at_edge(const Pos& pos, int q0, int k0,
                                        int Ck) {
  return k0 + kTile > Ck ||
         (pos.causal && pos.q_off + q0 < pos.k_off + k0 + kTile - 1);
}

// x[2 t], x[2 t + 1] of a register row, without indexing it by t.
__device__ __forceinline__ float2 pair_of(const float (&x)[8], int t) {
  float2 r = make_float2(x[0], x[1]);
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (t == i) {
      r = make_float2(x[2 * i], x[2 * i + 1]);
    }
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
    ring_fold_fwd_hd8_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             float* __restrict__ m, float* __restrict__ l,
                             float* __restrict__ o, Layout lay, int Cq,
                             int Ck, int H, Pos pos) {
  __shared__ __align__(16) uint4 sK[2][kTile];
  __shared__ __align__(16) float sV[2][kTile * kLdF];
  // every (h, b) of the longest query tiles first
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kTile;
  const int r0 = q0 + 16 * (threadIdx.x >> 5) + g;  // rows r0, r0 + 8
  const int n_kt = (Ck + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;

  float m_old[2];
  int degen = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    m_old[i] = row < Cq ? m[bh + row] : kNeg;
    degen |= row < Cq && unseen_degenerate(pos, row, m_old[i]);
  }
  degen = __syncthreads_or(degen);
  // the key tiles visited: masked tiles come last, so a prefix
  int n_vis = 0;
  while (n_vis < n_kt &&
         (degen || !all_masked(pos, q0, Cq, n_vis * kTile, kTile))) {
    ++n_vis;
  }
  if (n_vis == 0) {
    return;  // m' = m, a = 1, p = 0: the state stays as it is
  }

  // threads 0-63 copy a row of K with cp.async; 64-127 load a row of V
  // into registers a tile ahead and stage it as f32 after the tile's
  // work
  const int r = threadIdx.x % kTile;
  const bool copies_k = threadIdx.x < kTile;
  const bf16* kb = k + b * lay.t[1].b + h * lay.t[1].h;
  const bf16* vb = v + b * lay.t[2].b + h * lay.t[2].h;
  if (copies_k) {
    copy_row(sK[0], kb, lay.t[1], 0, Ck, r);
  } else {
    store_f32_row(&sV[0][r * kLdF], load_row(vb, lay.t[2], r, Ck));
  }
  cp_async_commit();
  const bf16* qb = q + b * lay.t[0].b + h * lay.t[0].h;
  const uint32_t qa0 = a_word(qb, lay.t[0], r0, Cq, t);
  const uint32_t qa1 = a_word(qb, lay.t[0], r0 + 8, Cq, t);

  float m_run[2] = {m_old[0], m_old[1]};
  float l_acc[2] = {0.0f, 0.0f};
  float acc[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      acc[i][d] = 0.0f;
    }
  }
  for (int kt = 0; kt < n_vis; ++kt) {
    cp_async_wait_all();
    // tile kt is in place for every thread, and every thread is done
    // with tile kt - 1's stage
    __syncthreads();
    const bool more = kt + 1 < n_vis;
    uint4 v_next = make_uint4(0u, 0u, 0u, 0u);
    if (more) {
      if (copies_k) {
        copy_row(sK[(kt + 1) & 1], kb, lay.t[1], (kt + 1) * kTile, Ck, r);
      } else {
        v_next = load_row(vb, lay.t[2], (kt + 1) * kTile + r, Ck);
      }
      cp_async_commit();
    }
    const int st = kt & 1;
    const int k0 = kt * kTile;
    uint32_t kf[8];
    b_frags(kf, sK[st], lane);
    // s[j][2 i + c]: row r0 + 8 i, key k0 + 8 j + 2 t + c
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
      mma_k8(s[j], qa0, qa1, kf[j]);
    }
    if (at_edge(pos, q0, k0, Ck)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = score(s[j][e], r0 + 8 * (e >> 1),
                          k0 + 8 * j + 2 * t + (e & 1), Ck, pos);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = scaled(s[j][e], pos);
        }
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float tile_sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float mt = fmaxf(m_run[i], quad_max(mx[i]));
      const float corr = expf(__fsub_rn(m_run[i], mt));
      m_run[i] = mt;
      l_acc[i] = __fmul_rn(l_acc[i], corr);
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        acc[i][d] = __fmul_rn(acc[i][d], corr);
      }
    }
    // the tile's p . v over the thread's 16 keys summed apart, then
    // added: 16 roundings a tile at the tile sum's magnitude and one at
    // acc's, not all 16 at acc's
    float part[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        part[i][d] = 0.0f;
      }
    }
    const float* vs = sV[st];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p0 = expf(__fsub_rn(s[j][c], m_run[0]));
        const float p1 = expf(__fsub_rn(s[j][2 + c], m_run[1]));
        tile_sum[0] += p0;
        tile_sum[1] += p1;
        float vf[8];
        f32_row(vf, vs + (8 * j + 2 * t + c) * kLdF);
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          part[0][d] = fmaf(p0, vf[d], part[0][d]);
          part[1][d] = fmaf(p1, vf[d], part[1][d]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_acc[i] = __fadd_rn(l_acc[i], tile_sum[i]);
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        acc[i][d] = __fadd_rn(acc[i][d], part[i][d]);
      }
    }
    if (more && !copies_k) {  // the stage of tile kt - 1: every thread
      store_f32_row(&sV[(kt + 1) & 1][r * kLdF], v_next);  // is past it
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_acc[i] = quad_sum(l_acc[i]);
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      acc[i][d] = quad_sum(acc[i][d]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= Cq) {
      continue;
    }
    const float alpha = expf(__fsub_rn(m_old[i], m_run[i]));
    if (t == 0) {
      m[bh + row] = m_run[i];
      l[bh + row] = __fadd_rn(__fmul_rn(l[bh + row], alpha), l_acc[i]);
    }
    // scalar accesses: o need not be 8-byte aligned
    float* orow = o + (bh + row) * 8 + 2 * t;
    const float2 a = pair_of(acc[i], t);
    orow[0] = __fadd_rn(__fmul_rn(orow[0], alpha), a.x);
    orow[1] = __fadd_rn(__fmul_rn(orow[1], alpha), a.y);
  }
}

// The 8 B fragments of m16n8k16 (k: 16 rows of a staged 64-row tile, n:
// its 8 columns) of the tile's four 16-row chunks: chunk c's in r[2 c],
// r[2 c + 1] (ldmatrix.trans: column g, rows 2 t and 2 t + 1).
__device__ __forceinline__ void bt_frags(uint32_t (&r)[8], const uint4* tile,
                                         int lane) {
  ldsm_x4_trans(r, smem_u32(tile + lane));
  ldsm_x4_trans(r + 4, smem_u32(tile + 32 + lane));
}

// Two adjacent n8 accumulator tiles (j even, odd) of an f32 16 x 64 tile
// rounded to bf16: the A fragment of m16n8k16 over their 16 columns.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], int j,
                                       const float (&x)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  a[2 * (j & 1)] = *reinterpret_cast<const uint32_t*>(&lo);
  a[2 * (j & 1) + 1] = *reinterpret_cast<const uint32_t*>(&hi);
}

__global__ void __launch_bounds__(kThreads)
    ring_fold_dq_hd8_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, Layout lay, int Cq,
                            int Ck, int H, Pos pos) {
  __shared__ __align__(16) uint4 sK[2][kTile];
  __shared__ __align__(16) uint4 sV[2][kTile];
  // every (h, b) of the longest query tiles first
  const int qt = (int)gridDim.y - 1 - (int)blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = qt * kTile;
  const int r0 = q0 + 16 * (threadIdx.x >> 5) + g;  // rows r0, r0 + 8
  const int n_kt = (Ck + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;

  float L[2];  // +inf past Cq: p = 0 there
  float D[2];
  int degen = 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    L[i] = row < Cq ? lse[bh + row] : INFINITY;
    D[i] = row < Cq ? delta[bh + row] : 0.0f;
    degen |= row < Cq && degenerate(L[i]);
  }
  degen = __syncthreads_or(degen);
  // the key tiles visited: masked tiles come last, so a prefix
  int n_vis = 0;
  while (n_vis < n_kt &&
         (degen || !all_masked(pos, q0, Cq, n_vis * kTile, kTile))) {
    ++n_vis;
  }
  if (n_vis == 0) {
    return;  // every P and dS of the query tile is 0: dq stays
  }

  // threads 0-63 copy a row of K, 64-127 a row of V, with cp.async
  const int r = threadIdx.x % kTile;
  const bool copies_k = threadIdx.x < kTile;
  // a select, not an index: lay.t[runtime] would copy lay to local memory
  const Strides cs = copies_k ? lay.t[1] : lay.t[2];
  const bf16* cb = (copies_k ? k : v) + b * cs.b + h * cs.h;
  copy_row(copies_k ? sK[0] : sV[0], cb, cs, 0, Ck, r);
  cp_async_commit();
  const bf16* qb = q + b * lay.t[0].b + h * lay.t[0].h;
  const bf16* ob = dout + b * lay.t[3].b + h * lay.t[3].h;
  const uint32_t qa0 = a_word(qb, lay.t[0], r0, Cq, t);
  const uint32_t qa1 = a_word(qb, lay.t[0], r0 + 8, Cq, t);
  const uint32_t oa0 = a_word(ob, lay.t[3], r0, Cq, t);
  const uint32_t oa1 = a_word(ob, lay.t[3], r0 + 8, Cq, t);

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // rows r0 (+ 8), dims 2 t..
  for (int kt = 0; kt < n_vis; ++kt) {
    cp_async_wait_all();
    // tile kt is in place for every thread, and every thread is done
    // with tile kt - 1's stage
    __syncthreads();
    if (kt + 1 < n_vis) {
      copy_row(copies_k ? sK[(kt + 1) & 1] : sV[(kt + 1) & 1], cb, cs,
               (kt + 1) * kTile, Ck, r);
      cp_async_commit();
    }
    const int st = kt & 1;
    const int k0 = kt * kTile;
    uint32_t kf[8];
    uint32_t vf[8];
    b_frags(kf, sK[st], lane);
    b_frags(vf, sV[st], lane);
    const bool edge = at_edge(pos, q0, k0, Ck);
    uint32_t dsa[4][4];  // dS as the A fragments of 4 k16 key chunks
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // s[2 i + c], w[2 i + c]: row r0 + 8 i, key k0 + 8 j + 2 t + c
      float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_k8(s, qa0, qa1, kf[j]);
      mma_k8(w, oa0, oa1, vf[j]);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x =
            edge ? score(s[e], r0 + 8 * (e >> 1),
                         k0 + 8 * j + 2 * t + (e & 1), Ck, pos)
                 : scaled(s[e], pos);
        const float p = expf(__fsub_rn(x, L[e >> 1]));
        ds[e] = __fmul_rn(__fmul_rn(p, __fsub_rn(w[e], D[e >> 1])),
                          pos.scale);
      }
      pack_a(dsa[j >> 1], j, ds);
    }
    // dq += dS . K: B fragments of 16 keys by 8 dims, transposed
    uint32_t ktf[8];
    bt_frags(ktf, sK[st], lane);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_k16(acc, dsa[kk], ktf[2 * kk], ktf[2 * kk + 1]);
    }
  }
  // the block's sum added to the carried dq once; scalar accesses: dq
  // need not be 8-byte aligned
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row < Cq) {
      float* dst = dq + (bh + row) * 8 + 2 * t;
      dst[0] = __fadd_rn(dst[0], acc[2 * i]);
      dst[1] = __fadd_rn(dst[1], acc[2 * i + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_fold_dkdv_hd8_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Layout lay, int Cq, int Ck, int H, Pos pos) {
  __shared__ __align__(16) uint4 sQ[2][kTile];
  __shared__ __align__(16) uint4 sDO[2][kTile];
  __shared__ __align__(16) float sDOf[2][kTile * kLdF];
  __shared__ __align__(16) float sL[2][kTile];
  __shared__ __align__(16) float sD[2][kTile];
  const int kt = blockIdx.y;
  const int h = (int)blockIdx.x % H;
  const int b = (int)blockIdx.x / H;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = kt * kTile;
  const int key0 = k0 + 16 * (threadIdx.x >> 5) + g;  // keys key0, key0 + 8
  const int n_qt = (Cq + kTile - 1) / kTile;
  const long long bh = ((long long)b * H + h) * Cq;
  const long long bhk = ((long long)b * H + h) * Ck;

  // only rows that see no key of the block can be degenerate
  int degen = 0;
  for (int row = threadIdx.x; row < Cq && sees_no_key(pos, row);
       row += kThreads) {
    degen |= degenerate(lse[bh + row]);
  }
  degen = __syncthreads_or(degen);
  // the query tiles visited: masked tiles come first, so a suffix
  int qt0 = 0;
  while (!degen && qt0 < n_qt && all_masked(pos, qt0 * kTile, Cq, k0, kTile)) {
    ++qt0;
  }
  if (qt0 == n_qt) {
    return;  // no query sees these keys: dk, dv stay as they are
  }

  // threads 0-63 copy a row of Q with cp.async; 64-127 load a row of dO
  // into registers a tile ahead and stage it twice after the tile's
  // work, as bf16 (the B fragments of dP^T) and as f32 (dv's FMAs)
  const int r = threadIdx.x % kTile;
  const bool copies_q = threadIdx.x < kTile;
  const bf16* qb = q + b * lay.t[0].b + h * lay.t[0].h;
  const bf16* ob = dout + b * lay.t[3].b + h * lay.t[3].h;
  if (copies_q) {
    copy_row(sQ[0], qb, lay.t[0], qt0 * kTile, Cq, r);
  } else {
    const uint4 row = load_row(ob, lay.t[3], qt0 * kTile + r, Cq);
    sDO[0][r] = row;
    store_f32_row(&sDOf[0][r * kLdF], row);
  }
  load_stats(sL[0], sD[0], lse + bh, delta + bh, qt0 * kTile, Cq);
  cp_async_commit();
  const bf16* kb = k + b * lay.t[1].b + h * lay.t[1].h;
  const bf16* vb = v + b * lay.t[2].b + h * lay.t[2].h;
  const uint32_t ka0 = a_word(kb, lay.t[1], key0, Ck, t);
  const uint32_t ka1 = a_word(kb, lay.t[1], key0 + 8, Ck, t);
  const uint32_t va0 = a_word(vb, lay.t[2], key0, Ck, t);
  const uint32_t va1 = a_word(vb, lay.t[2], key0 + 8, Ck, t);

  float dk_acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // keys key0 (+ 8), dims 2 t..
  float dv_acc[2][8];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      dv_acc[i][d] = 0.0f;
    }
  }
  for (int qt = qt0; qt < n_qt; ++qt) {
    cp_async_wait_all();
    __syncthreads();
    const bool more = qt + 1 < n_qt;
    const int nx = (qt + 1 - qt0) & 1;
    uint4 do_next = make_uint4(0u, 0u, 0u, 0u);
    if (more) {
      if (copies_q) {
        copy_row(sQ[nx], qb, lay.t[0], (qt + 1) * kTile, Cq, r);
      } else {
        do_next = load_row(ob, lay.t[3], (qt + 1) * kTile + r, Cq);
      }
      load_stats(sL[nx], sD[nx], lse + bh, delta + bh, (qt + 1) * kTile, Cq);
      cp_async_commit();
    }
    const int st = (qt - qt0) & 1;
    const int q0 = qt * kTile;
    uint32_t qf[8];
    uint32_t of[8];
    b_frags(qf, sQ[st], lane);
    b_frags(of, sDO[st], lane);
    // p[j][2 i + c]: key key0 + 8 i, query q0 + 8 j + 2 t + c
    float p[8][4];
    uint32_t dsa[4][4];  // dS^T as the A fragments of 4 k16 query chunks
    // (keys past Ck need no mask: their rows are never written)
    const bool edge = q0 + kTile > Cq ||
                      (pos.causal && pos.q_off + q0 < pos.k_off + k0 +
                                                          kTile - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.0f;
      mma_k8(p[j], ka0, ka1, qf[j]);
      mma_k8(w, va0, va1, of[j]);
      const int qc = 8 * j + 2 * t;
      const float2 L2 = *reinterpret_cast<const float2*>(&sL[st][qc]);
      const float2 D2 = *reinterpret_cast<const float2*>(&sD[st][qc]);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int query = q0 + qc + (e & 1);
        float L = (e & 1) ? L2.y : L2.x;
        float x;
        if (edge) {
          L = query < Cq ? L : INFINITY;  // p = 0 past Cq
          x = score(p[j][e], query, key0 + 8 * (e >> 1), Ck, pos);
        } else {
          x = scaled(p[j][e], pos);
        }
        const float D = (e & 1) ? D2.y : D2.x;
        p[j][e] = expf(__fsub_rn(x, L));
        ds[e] = __fmul_rn(__fmul_rn(p[j][e], __fsub_rn(w[e], D)), pos.scale);
      }
      pack_a(dsa[j >> 1], j, ds);
    }
    // dk += dS^T . Q: B fragments of 16 queries by 8 dims, transposed
    uint32_t qtf[8];
    bt_frags(qtf, sQ[st], lane);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_k16(dk_acc, dsa[kk], qtf[2 * kk], qtf[2 * kk + 1]);
    }
    // dv += P^T . f32(dO), f32 FMAs over the thread's 16 query columns,
    // the tile's part summed apart and then added, as the forward's p . v
    float part[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        part[i][d] = 0.0f;
      }
    }
    const float* dos = sDOf[st];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float df[8];
        f32_row(df, dos + (8 * j + 2 * t + c) * kLdF);
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          part[0][d] = fmaf(p[j][c], df[d], part[0][d]);
          part[1][d] = fmaf(p[j][2 + c], df[d], part[1][d]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        dv_acc[i][d] = __fadd_rn(dv_acc[i][d], part[i][d]);
      }
    }
    if (more && !copies_q) {  // the stage of tile qt - 1: every thread is
      sDO[nx][r] = do_next;   // past it
      store_f32_row(&sDOf[nx][r * kLdF], do_next);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      dv_acc[i][d] = quad_sum(dv_acc[i][d]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Ck) {
      continue;
    }
    float* dkr = dk + (bhk + key) * 8 + 2 * t;
    float* dvr = dv + (bhk + key) * 8 + 2 * t;
    const float2 a = pair_of(dv_acc[i], t);
    dkr[0] = __fadd_rn(dkr[0], dk_acc[2 * i]);
    dkr[1] = __fadd_rn(dkr[1], dk_acc[2 * i + 1]);
    dvr[0] = __fadd_rn(dvr[0], a.x);
    dvr[1] = __fadd_rn(dvr[1], a.y);
  }
}

}  // namespace

// The C entries, called by ring_fold.cu's for bf16 at hd 8 (their
// arguments, less hd and dtype).
extern "C" int trpc_ring_fold_fwd_hd8(const void* q, const void* k,
                                      const void* v, void* m, void* l,
                                      void* o, const long long* strides,
                                      int B, int Cq, int Ck, int H,
                                      int q_off, int k_off, int causal,
                                      float scale, void* stream) {
  const dim3 grid(B * H, (Cq + kTile - 1) / kTile);
  ring_fold_fwd_hd8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (float*)m, (float*)l,
      (float*)o, layout_of(strides, 3), Cq, Ck, H,
      Pos{q_off, k_off, causal, scale});
  return (int)cudaGetLastError();
}

extern "C" int trpc_ring_fold_bwd_dq_hd8(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    int B, int Cq, int Ck, int H, int q_off, int k_off, int causal,
    float scale, void* stream) {
  const dim3 grid(B * H, (Cq + kTile - 1) / kTile);
  ring_fold_dq_hd8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (float*)dq,
      layout_of(strides, 4), Cq, Ck, H, Pos{q_off, k_off, causal, scale});
  return (int)cudaGetLastError();
}

extern "C" int trpc_ring_fold_bwd_dkdv_hd8(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, int B, int Cq, int Ck, int H, int q_off,
    int k_off, int causal, float scale, void* stream) {
  const dim3 grid(B * H, (Ck + kTile - 1) / kTile);
  ring_fold_dkdv_hd8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv,
      layout_of(strides, 4), Cq, Ck, H, Pos{q_off, k_off, causal, scale});
  return (int)cudaGetLastError();
}
