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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // rows of a query or key tile
constexpr int kThreads = 128;  // one warpgroup

// A [64][HD] bf16 tile in shared memory: kAtoms swizzle atoms of
// [64][kCols], each row kRowBytes long.
template <int HD>
struct Geo {
  static constexpr int kCols = HD < 64 ? HD : 64;
  static constexpr int kAtoms = HD / kCols;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kAtomBytes = kTile * kRowBytes;
  static constexpr int kTileBytes = kAtoms * kAtomBytes;
  // wgmma's layout code: 1 = 128-byte swizzle, 3 = 32-byte swizzle
  static constexpr uint32_t kSwizzle = HD < 64 ? 3 : 1;
  // eight rows: one period of the swizzle
  static constexpr uint32_t kGroupBytes = 8 * kRowBytes;
  // sqrt(HD) a power of two: x / sqrt(HD) is exactly x * (1 / sqrt(HD))
  static constexpr bool kPow2 = HD == 16 || HD == 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// --- mbarrier and TMA -------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Rows [row, row + 64) of head (b, h) into the tile at dst, one box per
// swizzle atom.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int row, int h,
                                          int b) {
  using G = Geo<HD>;
#pragma unroll
  for (int a = 0; a < G::kAtoms; ++a) {
    tma_load(dst + a * G::kAtomBytes, map, bar, a * G::kCols, row, h, b);
  }
}

// --- wgmma ------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("" : "+f"(d[i])::"memory");
  }
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets, swizzle code (bits 0-13, 16-29, 32-45 in 16-byte units;
// bits 62-63).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFFu) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFFu) << 32 | (uint64_t)swizzle << 62;
}

// A 64-row tile as a K-major operand (its HD columns are the reduction):
// step kk covers columns [16 kk, 16 kk + 16), 32 bytes into a row of
// its atom.  Eight-row groups lie kGroupBytes apart.
template <int HD>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  using G = Geo<HD>;
  const uint32_t byte = kk * 32;
  return gmma_desc(
      tile + (byte / G::kRowBytes) * G::kAtomBytes + byte % G::kRowBytes, 16,
      G::kGroupBytes, G::kSwizzle);
}

// A 64-row tile as the MN-major B of a product that reduces over its
// rows (keys): step kk covers rows [16 kk, 16 kk + 16); the HD columns
// are N, one swizzle atom of kCols after another (the leading offset),
// eight-row groups kGroupBytes apart (the stride offset).
template <int HD>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  using G = Geo<HD>;
  return gmma_desc(tile + kk * 16 * G::kRowBytes, G::kAtomBytes,
                   G::kGroupBytes, G::kSwizzle);
}


// d (+)= A . B, m64n64k16, A and B from shared memory, both K-major;
// accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A . B, m64n16k16, A from registers (four bf16x2 a thread),
// B from shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n64k16, A from registers (four bf16x2 a thread),
// B from shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A . B, m64n128k16, A from registers (four bf16x2 a thread),
// B from shared memory MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (HD == 16) {
    wgmma_rs_n16(d, a, db);
  } else if constexpr (HD == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

// Issue d = A . B^T over the HD columns of two 64-row tiles (no commit).
template <int HD>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wgmma_ss_n64(d, kmajor<HD>(a, kk), kmajor<HD>(b, kk), kk > 0);
  }
}

// Issue acc += A . tile over the tile's 64 rows, A the packed fragments
// of a [64][64] product (no fence, no commit).
template <int HD>
__device__ __forceinline__ void issue_rs(float (&acc)[HD / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t tile) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<HD>(acc, a[kk], mnmajor<HD>(tile, kk));
  }
}

// acc += A . tile (issue_rs); waits for the result.
template <int HD>
__device__ __forceinline__ void product_rs(float (&acc)[HD / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t tile) {
  reg_fence(acc);
  wg_fence();
  issue_rs<HD>(acc, a, tile);
  wg_commit();
  wg_wait_all();
  reg_fence(acc);
}

// --- elementwise ------------------------------------------------------

// Every element of a [64][64] accumulator rounded to bf16 (to nearest,
// ties to even) and back: one conversion packs a pair, two integer
// operations unpack it.
__device__ __forceinline__ void round_bf16(float (&x)[32]) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x[i], x[i + 1]);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
    x[i] = __uint_as_float(u << 16);
    x[i + 1] = __uint_as_float(u & 0xFFFF0000u);
  }
}

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
  if constexpr (Geo<HD>::kPow2) {
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
          Geo<HD>::kPow2 ? s[4 * j + e] : div_rn(s[4 * j + e], sqrt_hd, inv);
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments of a [64][64] accumulator, rounded to bf16: step kk
// (keys [16 kk, 16 kk + 16)) is column groups 2 kk and 2 kk + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      a[kk][t] = pack_bf16x2(s[8 * kk + 2 * t], s[8 * kk + 2 * t + 1]);
    }
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

// The dynamic shared memory is used from a 1024-byte boundary (the
// 128-byte swizzle's period); every launch asks for kAlign bytes more.
constexpr int kAlign = 1024;
__device__ __forceinline__ uint32_t align_up(uint32_t addr) {
  return (addr + kAlign - 1) & ~(uint32_t)(kAlign - 1);
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
  const float unit = Geo<HD>::kPow2 ? inv : 1.0f;  // of the scores
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
  const float unit = Geo<HD>::kPow2 ? inv : 1.0f;  // see fwd
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
  const float unit = Geo<HD>::kPow2 ? inv : 1.0f;  // see fwd
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime (the
// library links only cudart).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The 4-D map of a [B, S, H, HD] bf16 tensor with element strides
// st = (b, s, h): dims (HD, S, H, B) innermost first, boxes of one
// swizzle atom by 64 rows, zeros past S.  A size-1 dim's stride is never
// used (its coordinate is 0), so it is given a valid one.
template <int HD>
int tensor_map(CUtensorMap* map, const void* base, const long long* st,
               int B, int S, int H) {
  using G = Geo<HD>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) {
    return (int)CUDA_ERROR_NOT_FOUND;
  }
  auto bytes = [](long long stride, int size) {
    return (cuuint64_t)((size > 1 ? stride : HD) * 2);
  };
  const cuuint64_t dims[4] = {HD, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(st[1], S), bytes(st[2], H),
                                 bytes(st[0], B)};
  const cuuint32_t box[4] = {G::kCols, kTile, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      HD < 64 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return (int)r;
}

// The maps of inputs [0, N) (q, k, v, dO): 0, or the negative code
// -(1000 (i + 1) + CUresult) of the first map the driver refuses.
template <int HD, int N>
int tensor_maps(CUtensorMap (&maps)[N], const void* const (&bases)[N],
                const long long* st, int B, int S, int H) {
  // The driver encodes only with a context current on the calling thread
  // (autograd runs the backward on a thread of its own): a runtime call
  // that needs one makes the device's primary context current.
  thread_local const cudaError_t ready = cudaFree(nullptr);
  if (ready != cudaSuccess) {
    return (int)ready;
  }
  for (int i = 0; i < N; ++i) {
    const int r = tensor_map<HD>(&maps[i], bases[i], st + 3 * i, B, S, H);
    if (r != 0) {
      return -(1000 * (i + 1) + r);
    }
  }
  return 0;
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int fwd(const void* q, const void* k, const void* v, void* o, float* lse,
        const long long* st, int B, int S, int H, float sqrt_hd,
        cudaStream_t stream) {
  if ((long long)B * H > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap m[3];
  const int e = tensor_maps<HD, 3>(m, {q, k, v}, st, B, S, H);
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
  const int e = tensor_maps<HD, 4>(m, {q, k, v, dout}, st, B, S, H);
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
  const int e = tensor_maps<HD, 4>(m, {q, k, v, dout}, st, B, S, H);
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
