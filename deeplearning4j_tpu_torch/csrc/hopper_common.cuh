// The Hopper (sm_90a) primitives shared by the bf16 / f16 attention cores,
// attention_fwd_core.cuh (B1, B3) and attention_bwd_core.cuh (B2, B4, B5),
// and by the LSTM's cluster route (lstm.cu: the wgmma fence / commit /
// wait, the mbarrier helpers):
//
// - mbarriers (init, arrive, arrive with an expected byte count, parity
//   wait) and the 3-d TMA tile load that completes on one;
// - 64-row tiles as TMA leaves them: 64 x 64 boxes of 16-bit values, rows
//   of 128 bytes with the 128-byte swizzle, a second 64-column half 8 KB
//   further (tile_offset), and the shared-memory matrix descriptor that
//   addresses them (sw128_desc);
// - wgmma.m64n64k16 with f32 accumulators in the m16n8 C layout per warp:
//   S-type (A and B from shared memory, both K-major) and R-type (A from
//   registers in the m16n8k16 A layout, B MN-major), the fence / commit /
//   wait around them, and the two products every core is built from:
//   mma_abt (C = A B^T of two K-major 64-row tiles) and mma_pb (C += P B,
//   P from registers, B a 64-row tile read MN-major);
// - pack_a: an f32 C-layout tile rounded to the input type as the A
//   operands of mma_pb, which is how a tile of scores computed as a C
//   operand becomes the A operand of the next product without leaving
//   registers;
// - store_rows: a warp's 16 accumulator rows written to global memory in
//   the input type, staged through shared memory to 16-byte stores;
// - the host's tensor-map encoding of a [bh, t, d] 16-bit tensor.

#pragma once

#include <cuda.h>

#include "attention_common.cuh"

namespace dl4j {

constexpr int kTileRows = 64;                    // rows of a TMA tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNeg2 = kNeg * kLog2e;           // kNeg in log2 units

// Two floats as one 32-bit pair of T, x in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle, 8-row groups 1024
// bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the warp's committed wgmma groups are pending
// (groups complete in order).
template <int N = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins registers' order against the wgmma fence / wait: an accumulator is
// read only after the wait that completes its product, and an A operand
// stays allocated until then.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// wgmma.m64n64k16 with f32 accumulators d (the m16n8 C layout per warp):
// S-type (A and B from shared memory, both K-major) and R-type (A from
// registers in the m16n8k16 A layout, B MN-major from shared memory).
// scale_d = 0 overwrites d instead of adding to it.
#define DL4J_ACC32(d)                                                     \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),             \
      "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),         \
      "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),         \
      "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),         \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),         \
      "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),         \
      "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),         \
      "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define DL4J_D32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}, "
#define DL4J_WGMMA_N64(TY)                                                \
  __device__ __forceinline__ void wgmma_ss_##TY(                          \
      float (&d)[8][4], uint64_t da, uint64_t db, int scale_d) {          \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"             \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY \
                 " " DL4J_D32 "%32, %33, p, 1, 1, 0, 0;\n}\n"             \
                 : DL4J_ACC32(d)                                          \
                 : "l"(da), "l"(db), "r"(scale_d));                       \
  }                                                                       \
  __device__ __forceinline__ void wgmma_rs_##TY(                          \
      float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,              \
      int scale_d) {                                                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"             \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." #TY "." #TY \
                 " " DL4J_D32 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
                 : DL4J_ACC32(d)                                          \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),   \
                   "r"(scale_d));                                         \
  }
DL4J_WGMMA_N64(bf16)
DL4J_WGMMA_N64(f16)
#undef DL4J_WGMMA_N64
#undef DL4J_D32
#undef DL4J_ACC32

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    wgmma_ss_bf16(d, da, db, scale_d);
  else
    wgmma_ss_f16(d, da, db, scale_d);
}

template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    wgmma_rs_bf16(d, a, db, scale_d);
  else
    wgmma_rs_f16(d, a, db, scale_d);
}

// Byte offset of 16-byte chunk c of row r in a 64-row TMA tile: the
// 64-column halves are 64 x 128 bytes apart, and the 128-byte swizzle XORs
// the chunk with r % 8.
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (uint32_t)((c >> 3) * 64 * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// C = A B^T (issued, not committed) for two 64-row K-major tiles sa and sb
// over DMAX columns: DMAX / 16 k16 steps; C's rows are sa's, its columns
// sb's.
template <typename T, int DMAX>
__device__ __forceinline__ void mma_abt(float (&c)[8][4], uint32_t sa,
                                        uint32_t sb) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    wgmma_ss<T>(c, sw128_desc(sa + (kk >> 2) * 64 * 128 + (kk & 3) * 32),
                sw128_desc(sb + (kk >> 2) * kTileRows * 128 + (kk & 3) * 32),
                kk > 0);
}

// C += P B (issued, not committed): 4 k16 steps over the 64 rows of tile
// sb (read MN-major), P from registers (pack_a), one n64 chain per
// 64-column half.
template <typename T, int NH>
__device__ __forceinline__ void mma_pb(float (&c)[NH][8][4],
                                       const uint32_t (&pa)[4][4],
                                       uint32_t sb) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
      wgmma_rs<T>(c[hh], pa[kc],
                  sw128_desc(sb + hh * kTileRows * 128 + kc * 16 * 128), 1);
}

// An f32 C-layout tile (a warp's 16 rows x 64 columns) in the input type
// as the A operands of the four k16 steps of mma_pb: k16 step kc takes n8
// column blocks 2 kc and 2 kc + 1.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t (&pa)[4][4],
                                       const float (&s)[8][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    pa[kc][0] = pack2<T>(s[2 * kc][0], s[2 * kc][1]);
    pa[kc][1] = pack2<T>(s[2 * kc][2], s[2 * kc][3]);
    pa[kc][2] = pack2<T>(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    pa[kc][3] = pack2<T>(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[kc][e])::"memory");
  }
}

// A warp's 16 accumulator rows (acc in the m16n8 C layout, row hr * 8 + g
// scaled by mul[hr]) as rows row0 .. row0 + 15 of out ([*, d] of T; rows
// at or past t are not written), staged through the warp's own rows
// 16 warp .. 16 warp + 15 of the 64-row tile at stage (which no other warp
// reads, and which no wgmma still reads) to 16-byte stores.
template <typename T, int DMAX>
__device__ __forceinline__ void store_rows(const float (&acc)[DMAX / 8][4],
                                           const float (&mul)[2], T* out,
                                           uint32_t stage, int row0, int t,
                                           int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int rl0 = 16 * (threadIdx.x >> 5);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int i = 0; i < DMAX / 8; ++i) {
      const uint32_t pv = pack2<T>(acc[i][2 * hr] * mul[hr],
                                   acc[i][2 * hr + 1] * mul[hr]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       stage + tile_offset(rl0 + g + 8 * hr, i) + tig * 4),
                   "r"(pv)
                   : "memory");
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (DMAX / 8); i += 32) {
    const int r = i / (DMAX / 8), c = i % (DMAX / 8), row = row0 + r;
    if (row < t && c < d / 8) {
      uint4 val;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                   : "r"(stage + tile_offset(rl0 + r, c)));
      *reinterpret_cast<uint4*>(out + (size_t)row * d + c * 8) = val;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime at first
// use, so the library links without -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &res) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) != cudaSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A [bh, t, d] 16-bit tensor as 64 x 64 boxes with the 128-byte swizzle;
// boxes past t or d are zero-filled.
template <typename T>
bool encode_map(CUtensorMap* map, const void* ptr, int bh, int t, int d) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kTileRows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map,
             std::is_same<T, __nv_bfloat16>::value
                 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
             3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace dl4j
