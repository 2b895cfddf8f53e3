// The bf16 / f16 attention forward shared by B1 (shortseq_attention.cu)
// and B3 (flash_forward.cu): o = softmax(scale * q k^T, masked) v and
// lse = m + log l per query row, for [BH, T, D] inputs (D a multiple of 8
// up to 128) and an optional [B, T] f32 key mask.
//
// One CTA owns 64 query rows of one b*h: a consumer warpgroup (4 warps of
// 16 rows) and a producer warp, over 64-key tiles of K and V. The query
// tiles of one b*h are neighbours in the grid, so K and V come from HBM
// once and from L2 after, and the diagonal-heavy (last) tiles start first.
//
// - The producer's elected lane loads Q once and every K and V tile into
//   a 2-deep shared-memory ring with TMA (one 64 x 64 box per 64 columns,
//   128-byte swizzle, zero fill past T and past D), completing "full"
//   mbarriers; it refills a stage when the consumer warps have arrived on
//   its "empty" mbarrier. The tensor maps are encoded on the host per
//   launch and passed as __grid_constant__ parameters.
// - S = Q K^T is one wgmma.m64n64k16 chain per tile, both operands read
//   from shared memory through swizzled descriptors; its f32 accumulators
//   stay in registers, in the m16n8 C layout per warp.
// - Scale (folded with log2 e), the causal compare and the key-mask bits
//   (one ballot per 32 keys) are applied in registers, and only on tiles
//   that need them; the online softmax keeps m and l per row in registers
//   (row max and sum over the 4 lanes of a quad, shfl_xor 1, 2).
// - P is rounded to the input type in registers and is the A operand of
//   O += P V (wgmma with A from registers, V MN-major from shared memory);
//   the O accumulator stays in registers and is rescaled there.
// - Epilogue: o = acc / max(l, 1e-20) in the input type, staged through
//   the Q tile and written with 16-byte stores; lse as [BH, T] f32, the
//   layout the backward kernels read.
//
// The two products run one after the other with the softmax between them,
// so a warpgroup's tensor cores idle during its softmax; the other CTAs on
// the SM fill that time. At D 64 the launch bounds hold a thread to 96
// registers so that 4 CTAs fit an SM (at 120 registers, 3 fit and T 512
// ran ~9% slower). Two consumer warpgroups per CTA, a 3- or 4-deep ring,
// and issuing the next tile's S before this tile's softmax all measured
// slower (PERF.md).
//
// Masking is the reference's: a causal-future or masked key's logit is
// REPLACED by -1e30 (kNeg), so a fully masked row averages its keys
// instead of producing NaN. Keys a row's 64-row group does not reach (its
// causal horizon, and T) are not part of the row at all: such a fully
// masked row averages the keys up to the end of its 64-row group, the same
// horizon the backward kernels recompute p over. lse of a fully masked
// row is exactly kNeg + log l = kNeg, as the backward expects.

#pragma once

#include <cuda.h>

#include "attention_common.cuh"

namespace dl4j {

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* kmask;   // [bh / h, t] or null
  void* o;
  float* lse;           // [bh, t]
  int h, t, d, causal;
  float scale;
};

constexpr int kFwdKeys = 64;                     // keys per K / V tile
constexpr int kStages = 2;                       // depth of the K / V ring
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

// Scale, mask and fold one 64-key tile of raw scores s (a warp's 16 rows
// in the m16n8 C layout: s[i][e] is row g + 8 (e / 2), key 8 i + 2 tig +
// e % 2) into the row's running max m and sum l (log2 units); s becomes p
// (f32), and alpha the factor by which the row's O accumulator must be
// rescaled. Rows are qw + g (+ 8); keys j0 + jl; keys at or past kend_w
// are not part of the row; km0 / km1 are the key-mask entries of keys
// j0 + lane and j0 + 32 + lane (1 without a mask).
template <int NKT>
__device__ __forceinline__ void tile_softmax(float (&s)[NKT][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int j0, int kend_w, int qw,
                                             int causal, float km0, float km1,
                                             float sc2) {
  constexpr int KT = NKT * 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  // key-mask bits of the tile's 64 keys, one ballot per 32; a tile whose
  // keys are all real takes the unmasked path unless it crosses the
  // causal diagonal or the horizon
  const uint32_t bits0 = __ballot_sync(0xffffffffu, km0 > 0.f);
  const uint32_t bits1 = __ballot_sync(0xffffffffu, km1 > 0.f);
  if (j0 + KT <= kend_w && (!causal || j0 + KT - 1 <= qw) &&
      (bits0 & bits1) == 0xffffffffu) {
#pragma unroll
    for (int i = 0; i < NKT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] *= sc2;
  } else {
    // key jl of the tile: past the horizon (jl >= lim) it is not part of
    // the row; causal-future (jl > vis) or masked it gets kNeg
    const int lim = kend_w - j0, r0 = qw + g - j0;
    const int vis0 = causal ? r0 : KT, vis1 = causal ? r0 + 8 : KT;
    const uint32_t kb0 = bits0 >> (2 * tig), kb1 = bits1 >> (2 * tig);
#pragma unroll
    for (int i = 0; i < NKT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = i * 8 + 2 * tig + (e & 1);
        const uint32_t kb = i < NKT / 2 ? kb0 : kb1;
        const bool real = (kb >> ((i * 8 + (e & 1)) & 31)) & 1u;
        const bool keep = real && jl <= (e >> 1 ? vis1 : vis0);
        s[i][e] = jl >= lim ? -INFINITY : keep ? s[i][e] * sc2 : kNeg2;
      }
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = m[hr];
#pragma unroll
    for (int i = 0; i < NKT; ++i)
      mx = fmaxf(mx, fmaxf(s[i][2 * hr], s[i][2 * hr + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    alpha[hr] = fast_exp2(m[hr] - mx);
    m[hr] = mx;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NKT; ++i) {
      s[i][2 * hr] = fast_exp2(s[i][2 * hr] - mx);
      s[i][2 * hr + 1] = fast_exp2(s[i][2 * hr + 1] - mx);
      sum += s[i][2 * hr] + s[i][2 * hr + 1];
    }
    l[hr] = l[hr] * alpha[hr] + sum;
  }
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

// Pins the accumulator registers' order against the wgmma fence / wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
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

// The epilogue of a warp's 16 rows (rows row0 + g, + 8; local rows
// 16 warp + g, + 8 of the Q tile at sq): lse = m + log l per row (exactly
// kNeg for a fully masked row), and o = acc / l in the input type, staged
// through the warp's own Q rows (no other warp reads them, and the
// warpgroup's wgmma reads have completed) to 16-byte stores.
template <typename T, int DMAX>
__device__ __forceinline__ void finish_rows(const float (&acc)[DMAX / 8][4],
                                            const float (&m)[2],
                                            const float (&l)[2], float* lse,
                                            T* o, uint32_t sq, int row0,
                                            int t, int d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int rl0 = 16 * (threadIdx.x >> 5);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, kMinL);
    const int row = row0 + g + 8 * hr;
    if (tig == 0 && row < t)
      lse[row] = (m[hr] == kNeg2 ? kNeg : m[hr] * kLn2) + logf(lt);
    const float inv = 1.f / lt;
#pragma unroll
    for (int i = 0; i < DMAX / 8; ++i) {
      const uint32_t pv = pack2<T>(acc[i][2 * hr] * inv,
                                   acc[i][2 * hr + 1] * inv);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                       sq + tile_offset(rl0 + g + 8 * hr, i) + tig * 4),
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
                   : "r"(sq + tile_offset(rl0 + r, c)));
      *reinterpret_cast<uint4*>(o + (size_t)row * d + c * 8) = val;
    }
  }
}

template <int DMAX>
constexpr size_t fwd_smem_bytes() {
  // alignment slack, Q, the K and V rings, the mbarriers
  return 1024 + (size_t)64 * DMAX * 2 +
         2 * (size_t)kStages * kFwdKeys * DMAX * 2 + 8 * (1 + 4 * kStages);
}

// S = Q K^T of one tile: DMAX / 16 wgmma k16 steps over the warpgroup's Q
// tile (sq) and the K tile (sk), both K-major.
template <typename T, int DMAX>
__device__ __forceinline__ void start_scores(float (&s)[8][4], uint32_t sq,
                                             uint32_t sk) {
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    wgmma_ss<T>(s, sw128_desc(sq + (kk >> 2) * 64 * 128 + (kk & 3) * 32),
                sw128_desc(sk + (kk >> 2) * kFwdKeys * 128 + (kk & 3) * 32),
                kk > 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// O += P V of one tile: 4 k16 steps, P from registers, V (sv) MN-major,
// one n64 chain per 64-column half.
template <typename T, int NH>
__device__ __forceinline__ void start_pv(float (&acc)[NH][8][4],
                                         const uint32_t (&pa)[4][4],
                                         uint32_t sv) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
      wgmma_rs<T>(acc[hh], pa[kc],
                  sw128_desc(sv + hh * kFwdKeys * 128 + kc * 16 * 128), 1);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// p (C layout, f32) in the input type as the A operands of the four k16
// steps of P V: k16 step kc takes n8 key tiles 2 kc and 2 kc + 1.
template <typename T, int NKT>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4],
                                       const float (&s)[NKT][4]) {
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

template <typename T, int DMAX>
__global__ void __launch_bounds__(160, DMAX == 64 ? 4 : 1)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const FwdArgs a) {
  constexpr int KT = kFwdKeys, NH = DMAX / 64, NKT = KT / 8;
  constexpr uint32_t kQBytes = 64 * DMAX * 2, kTileBytes = KT * DMAX * 2;
  extern __shared__ __align__(1024) uint8_t fwd_smem[];
  const uint32_t sq =
      (static_cast<uint32_t>(__cvta_generic_to_shared(fwd_smem)) + 1023u) &
      ~1023u;
  const uint32_t sk = sq + kQBytes, sv = sk + kStages * kTileBytes;
  const uint32_t q_full = sv + kStages * kTileBytes;
  auto k_full = [q_full](int st) { return q_full + 8 + 8 * st; };
  auto v_full = [q_full](int st) { return q_full + 8 + 8 * (kStages + st); };
  auto k_empty = [q_full](int st) {
    return q_full + 8 + 8 * (2 * kStages + st);
  };
  auto v_empty = [q_full](int st) {
    return q_full + 8 + 8 * (3 * kStages + st);
  };

  const int t = a.t, d = a.d;
  // heaviest (most key tiles) query tiles of a b*h first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64, bh = blockIdx.y;
  // the causal horizon of the tile's 64 rows: later key tiles are skipped
  const int kend = a.causal ? min(t, q0 + 64) : t;
  const int ntiles = (kend + KT - 1) / KT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 4);
      mbar_init(v_empty(st), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {   // producer
    if (lane == 0) {
      mbar_expect_tx(q_full, kQBytes);
      for (int hh = 0; hh < NH; ++hh)
        tma_load_3d(sq + hh * 64 * 128, &tq, hh * 64, q0, bh, q_full);
      for (int n = 0; n < ntiles; ++n) {
        const int st = n % kStages;
        const uint32_t ph = (n / kStages) & 1;
        if (n >= kStages) mbar_wait(k_empty(st), ph ^ 1);
        mbar_expect_tx(k_full(st), kTileBytes);
        for (int hh = 0; hh < NH; ++hh)
          tma_load_3d(sk + st * kTileBytes + hh * KT * 128, &tk, hh * 64,
                      n * KT, bh, k_full(st));
        if (n >= kStages) mbar_wait(v_empty(st), ph ^ 1);
        mbar_expect_tx(v_full(st), kTileBytes);
        for (int hh = 0; hh < NH; ++hh)
          tma_load_3d(sv + st * kTileBytes + hh * KT * 128, &tv, hh * 64,
                      n * KT, bh, v_full(st));
      }
    }
    return;
  }

  // consumers: warp `warp` of the warpgroup owns rows qw .. qw + 15
  const int qw = q0 + 16 * warp;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;
  const float sc2 = a.scale * kLog2e;
  auto release = [lane](uint32_t bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float acc[NH][8][4], s[NKT][4], m[2] = {kNeg2, kNeg2}, l[2] = {0.f, 0.f},
                                  alpha[2];
  uint32_t pa[4][4];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      acc[hh][i][0] = acc[hh][i][1] = acc[hh][i][2] = acc[hh][i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < NKT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
  mbar_wait(q_full, 0);

  for (int n = 0; n < ntiles; ++n) {
    const int st = n % kStages, j0 = n * KT;
    const uint32_t ph = (n / kStages) & 1;
    // the tile's key-mask entries, requested before the waits
    float km0 = 1.f, km1 = 1.f;
    if (km != nullptr) {
      km0 = j0 + lane < t ? km[j0 + lane] : 0.f;
      km1 = j0 + 32 + lane < t ? km[j0 + 32 + lane] : 0.f;
    }
    // probe: wait
    mbar_wait(k_full(st), ph);
    // probe: scores
    wgmma_fence();
    start_scores<T, DMAX>(s, sq, sk + st * kTileBytes);
    wgmma_wait();
    fence_regs(s);
    release(k_empty(st));
    // probe: softmax
    tile_softmax<NKT>(s, m, l, alpha, j0, kend, qw, a.causal, km0, km1,
                      sc2);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[hh][i][0] *= alpha[0];
        acc[hh][i][1] *= alpha[0];
        acc[hh][i][2] *= alpha[1];
        acc[hh][i][3] *= alpha[1];
      }
      fence_regs(acc[hh]);
    }
    pack_p<T>(pa, s);
    // probe: wait
    mbar_wait(v_full(st), ph);
    // probe: pv
    wgmma_fence();
    start_pv<T, NH>(acc, pa, sv + st * kTileBytes);
    wgmma_wait();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);
    release(v_empty(st));
    // probe: end
  }

  // probe: epilogue
  float o[NH * 8][4];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[hh * 8 + i][e] = acc[hh][i][e];
  finish_rows<T, DMAX>(o, m, l, a.lse + (size_t)bh * t,
                       static_cast<T*>(a.o) + (size_t)bh * t * d, sq, qw, t,
                       d);
  // probe: done
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
  const cuuint32_t box[3] = {64, (cuuint32_t)kFwdKeys, 1};
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


template <typename T, int DMAX>
cudaError_t launch_fwd(const FwdArgs& a, int bh, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_map<T>(&tq, a.q, bh, a.t, a.d) ||
      !encode_map<T>(&tk, a.k, bh, a.t, a.d) ||
      !encode_map<T>(&tv, a.v, bh, a.t, a.d))
    return cudaErrorInvalidValue;
  auto kern = attention_fwd_kernel<T, DMAX>;
  constexpr size_t smem = fwd_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.t + 63) / 64, bh);
  kern<<<grid, 160, smem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

// The bf16 / f16 forward at head-dim bucket 64 or 128 (columns past d are
// zero-filled).
template <typename T>
cudaError_t dispatch_fwd(const FwdArgs& a, int bh, cudaStream_t stream) {
  if (a.d <= 64) return launch_fwd<T, 64>(a, bh, stream);
  return launch_fwd<T, 128>(a, bh, stream);
}

}  // namespace dl4j
