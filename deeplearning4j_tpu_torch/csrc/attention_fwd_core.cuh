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
//
// attention_bias_fwd_kernel is the same CTA with an additive f32 logit
// bias (BiasArgs: SwinV2's continuous position bias plus its shift mask,
// one [t, t] block a (window, head)): logits scale * q . k + bias. Each
// thread reads its 2 x 32 bias entries of a tile from global memory
// (from L2: one block serves every image of the batch) as 8-byte pairs,
// issued before it waits for the tile's K. The unbiased kernel is the
// same code with that step compiled out.

#pragma once

#include "hopper_common.cuh"

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

constexpr int kFwdKeys = kTileRows;              // keys per K / V tile
constexpr int kStages = 2;                       // depth of the K / V ring

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
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, kMinL);
    const int row = row0 + g + 8 * hr;
    if (tig == 0 && row < t)
      lse[row] = (m[hr] == kNeg2 ? kNeg : m[hr] * kLn2) + logf(lt);
    inv[hr] = 1.f / lt;
  }
  store_rows<T, DMAX>(acc, inv, o, sq, row0, t, d);
}

template <int DMAX>
constexpr size_t fwd_smem_bytes() {
  // alignment slack, Q, the K and V rings, the mbarriers
  return 1024 + (size_t)64 * DMAX * 2 +
         2 * (size_t)kStages * kFwdKeys * DMAX * 2 + 8 * (1 + 4 * kStages);
}

// One 64-key tile of a warp's bias rows qw + g, + 8 (rows past t and keys
// past t read 0), in the C layout of s and in log2 units.
template <int NKT>
__device__ __forceinline__ void load_bias_tile(float (&bb)[NKT][4],
                                               const float* blk, int t,
                                               int qw, int j0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int i = 0; i < NKT; ++i) {
      const float2 v = bias_pair(blk, t, qw + g + 8 * hr, j0 + 8 * i + 2 * tig);
      bb[i][2 * hr] = v.x;
      bb[i][2 * hr + 1] = v.y;
    }
}

// The forward of one CTA. BIAS: logits scale * q . k + bias (BiasArgs),
// the bias tile read from global memory (L2) into registers while the
// tile's K waits, and added before tile_softmax, which then scales by 1.
template <typename T, int DMAX, bool BIAS>
__device__ __forceinline__ void fwd_cta(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const FwdArgs& a, const BiasArgs& b) {
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
        tma_load_3d(sq + hh * 64 * 128, tq, hh * 64, q0, bh, q_full);
      for (int n = 0; n < ntiles; ++n) {
        const int st = n % kStages;
        const uint32_t ph = (n / kStages) & 1;
        if (n >= kStages) mbar_wait(k_empty(st), ph ^ 1);
        mbar_expect_tx(k_full(st), kTileBytes);
        for (int hh = 0; hh < NH; ++hh)
          tma_load_3d(sk + st * kTileBytes + hh * KT * 128, tk, hh * 64,
                      n * KT, bh, k_full(st));
        if (n >= kStages) mbar_wait(v_empty(st), ph ^ 1);
        mbar_expect_tx(v_full(st), kTileBytes);
        for (int hh = 0; hh < NH; ++hh)
          tma_load_3d(sv + st * kTileBytes + hh * KT * 128, tv, hh * 64,
                      n * KT, bh, v_full(st));
      }
    }
    return;
  }

  // consumers: warp `warp` of the warpgroup owns rows qw .. qw + 15
  const int qw = q0 + 16 * warp;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;
  const float sc2 = a.scale * kLog2e;
  const float* blk = BIAS ? b.bias + bias_block(bh, a.h, t, b.np) : nullptr;
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
    float bb[BIAS ? NKT : 1][4];
    if constexpr (BIAS) load_bias_tile<NKT>(bb, blk, t, qw, j0);
    // probe: wait
    mbar_wait(k_full(st), ph);
    // probe: scores
    wgmma_fence();
    mma_abt<T, DMAX>(s, sq, sk + st * kTileBytes);
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);
    release(k_empty(st));
    // probe: softmax
    if constexpr (BIAS) {
#pragma unroll
      for (int i = 0; i < NKT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = fmaf(s[i][e], sc2, bb[i][e]);
    }
    tile_softmax<NKT>(s, m, l, alpha, j0, kend, qw, a.causal, km0, km1,
                      BIAS ? 1.f : sc2);
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
    pack_a<T>(pa, s);
    // probe: wait
    mbar_wait(v_full(st), ph);
    // probe: pv
    wgmma_fence();
    mma_pb<T, NH>(acc, pa, sv + st * kTileBytes);
    wgmma_commit();
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

template <typename T, int DMAX>
__global__ void __launch_bounds__(160, DMAX == 64 ? 4 : 1)
    attention_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const FwdArgs a) {
  fwd_cta<T, DMAX, false>(&tq, &tk, &tv, a, BiasArgs{});
}

// The biased instance (its own name, so a trace tells it apart): the bias
// tile's 32 registers a thread leave room for 3 CTAs an SM at D 64.
template <typename T, int DMAX>
__global__ void __launch_bounds__(160, DMAX == 64 ? 3 : 1)
    attention_bias_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const FwdArgs a, const BiasArgs b) {
  fwd_cta<T, DMAX, true>(&tq, &tk, &tv, a, b);
}

template <typename T, int DMAX, bool BIAS>
cudaError_t launch_fwd(const FwdArgs& a, const BiasArgs& b, int bh,
                       cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!encode_map<T>(&tq, a.q, bh, a.t, a.d) ||
      !encode_map<T>(&tk, a.k, bh, a.t, a.d) ||
      !encode_map<T>(&tv, a.v, bh, a.t, a.d))
    return cudaErrorInvalidValue;
  constexpr size_t smem = fwd_smem_bytes<DMAX>();
  const dim3 grid((a.t + 63) / 64, bh);
  cudaError_t err;
  if constexpr (BIAS) {
    auto kern = attention_bias_fwd_kernel<T, DMAX>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, 160, smem, stream>>>(tq, tk, tv, a, b);
  } else {
    auto kern = attention_fwd_kernel<T, DMAX>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, 160, smem, stream>>>(tq, tk, tv, a);
  }
  return cudaGetLastError();
}

// The bf16 / f16 forward at head-dim bucket 64 or 128 (columns past d are
// zero-filled).
template <typename T>
cudaError_t dispatch_fwd(const FwdArgs& a, int bh, cudaStream_t stream) {
  if (a.d <= 64) return launch_fwd<T, 64, false>(a, BiasArgs{}, bh, stream);
  return launch_fwd<T, 128, false>(a, BiasArgs{}, bh, stream);
}

// The biased forward, the same buckets.
template <typename T>
cudaError_t dispatch_bias_fwd(const FwdArgs& a, const BiasArgs& b, int bh,
                              cudaStream_t stream) {
  if (a.d <= 64) return launch_fwd<T, 64, true>(a, b, bh, stream);
  return launch_fwd<T, 128, true>(a, b, bh, stream);
}

}  // namespace dl4j
