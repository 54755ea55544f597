// sm90_tile.cuh — what the tensor-core kernels share
// (causal_attention_sm90.cu, ring_fold_sm90.cu): [64][HD] bf16 tiles in
// shared memory, their TMA loads and mbarriers, the wgmma products over
// them, the packing of an accumulator into the A fragments of the next
// product, and the host's tensor maps.  Each kernel file includes it
// into an anonymous namespace of its own.
//
// The layout every kernel assumes: one warpgroup (128 threads) per
// 64-row tile; thread t of warp w holds rows r0 = 16 w + t / 4 and r0 + 8
// and columns 8 j + 2 (t % 4) + {0, 1} of a 64-row product (wgmma's
// accumulator layout); a tile is one or two swizzle atoms of [64][kCols]
// bf16 in the swizzle both TMA and the descriptors name (128-byte at hd
// 64, two 64-column atoms at hd 128, 32-byte at hd 16).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Orders this thread's generic accesses to shared memory before later
// async-proxy ones (a TMA load into a stage the threads wrote or read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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

// The dynamic shared memory is used from a 1024-byte boundary (the
// 128-byte swizzle's period); every launch asks for kAlign bytes more.
constexpr int kAlign = 1024;
__device__ __forceinline__ uint32_t align_up(uint32_t addr) {
  return (addr + kAlign - 1) & ~(uint32_t)(kAlign - 1);
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

// The maps of inputs [0, N) (q, k, v, dO), input i of rows[i] rows: 0,
// or the negative code -(1000 (i + 1) + CUresult) of the first map the
// driver refuses.
template <int HD, int N>
int tensor_maps(CUtensorMap (&maps)[N], const void* const (&bases)[N],
                const long long* st, int B, const int (&rows)[N], int H) {
  // The driver encodes only with a context current on the calling thread
  // (autograd runs the backward on a thread of its own): a runtime call
  // that needs one makes the device's primary context current.
  thread_local const cudaError_t ready = cudaFree(nullptr);
  if (ready != cudaSuccess) {
    return (int)ready;
  }
  for (int i = 0; i < N; ++i) {
    const int r =
        tensor_map<HD>(&maps[i], bases[i], st + 3 * i, B, rows[i], H);
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

}  // namespace
