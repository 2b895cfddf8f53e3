// The bf16 / f16 attention backward shared by B2 (shortseq_attention_bwd.cu,
// both roles in one grid), B4 (flash_backward.cu, the dq role) and B5
// (flash_backward.cu, the dkv role), for
// [BH, T, D] inputs (D a multiple of 8 up to 128), an optional [B, T] f32
// key mask, and the forward's lse and delta = rowsum(dO . O) as [BH, T]
// f32:
//   p  = exp(s - lse), s = scale * q . k with causal-future and masked
//        logits REPLACED by -1e30 (the forward's masking)
//   dv = p^T . dO      ds = p * (dO . v^T - delta) * scale
//   dq = ds . k        dk = ds^T . q
// p and ds are rounded to the input type before their products, as the TPU
// kernels round them.
//
// A CTA is one consumer warpgroup (4 warps of 16 rows) and a producer warp,
// and takes one of two roles over 64 x 64 tile pairs:
//
// - dkv: one 64-key tile of one b*h. The producer loads K and V once with
//   TMA, then fills a 2-deep ring of (Q, dO) tiles for the query tiles from
//   the causal diagonal to T, each stage with its 64 queries' lse (in log2
//   units) and delta, which the producer's lanes store beside the TMA
//   copies (+inf and 0 past T, so p and ds vanish there). Per query tile
//   the consumer issues S^T = K Q^T and dP^T = V dO^T (wgmma, both
//   operands K-major in shared memory), forms P^T in registers (lse indexed
//   by column) while dP^T runs, then dS^T = P^T (dP^T - delta) scale, and
//   issues dV += P^T dO and dK += dS^T Q with P^T and dS^T packed in
//   registers as the A operands (dO and Q read MN-major). dK and dV stay
//   in f32 registers and are written once.
// - dq (B2's second walk, and B4 alone): one 64-query tile; Q, dO
//   (resident), lse and delta (in registers) stay, and a ring of (K, V)
//   tiles runs up to the diagonal: S = Q K^T and dP = dO V^T (wgmma from
//   shared memory), dS in registers, dQ += dS K (K read MN-major).
//
// No S, dP, p or ds tile is written to shared memory; every layout change
// is the forward's (a C-layout tile packed as an A operand, a row-major
// tile read MN-major). The ring runs on mbarriers: the only block-wide
// barriers are the one after their initialisation and one among the
// consumer warps before the epilogue. Each gradient element is summed by
// one CTA in a fixed order (no atomics), so two calls give the same bits;
// B2 pays for that with a second recomputation of s and p in its dq CTAs.
// Within a b*h the heaviest walks start first: B2 interleaves its roles
// (dkv of key tile x, then dq of query tile tiles - 1 - x), and B4's block
// x takes query tile tiles - 1 - x.
//
// Masking matches the forward's 64-row horizon: tiles are 64 keys by 64
// queries, so a fully masked query row (lse exactly kNeg, mapped to exactly
// kNeg2) gets p = exp2(kNeg2 - kNeg2) = 1 on the keys up to the end of its
// 64-row group and is not visited past it. Keys at or past T are zero-filled
// by TMA; the dq role gives them p = 0, and the dkv role never writes their
// rows.
//
// Registers: at D 64 a dkv consumer holds dK, dV, S^T and dP^T (4 x 32 f32
// a thread), which become the packed P^T and dS^T (2 x 16) before the last
// two products: 164 registers and no spills, 2 CTAs an SM. D 128 doubles
// dK and dV (226 registers) and runs one CTA an SM. Measured and dropped
// (PERF.md): issuing dV before the dS^T pass, to run under it (P^T live
// beside dS^T: a 16-byte spill, ~20% slower); issuing the next tile's S^T
// and dP^T before this tile's dV and dK complete (~25% slower); a 3-deep
// ring (no faster). The dq role alone (B4) takes 168 registers at D 64
// and 197 at D 128, no spills; asking for 3 CTAs an SM at D 64 spilled 24
// bytes and was no faster.
//
// attention_bias_bwd_kernel is B2's grid with an additive f32 logit bias
// (BiasArgs, as the biased forward): both roles add the bias tile, read
// from L2 into registers before the tile's wait (the dkv role reads it
// transposed, one 4-byte entry at a time), to the recomputed logits.
// dbias, which every image of the batch adds into the same [t, t] block
// of its (window, head), comes from attention_bias_dbias_kernel below,
// one CTA a tile of a block summing its images in order: f32 atomics from
// B2's dq role into one block ran 3-5x slower than the whole of B2
// (PERF.md), and a per-image dbias is never written.

#pragma once

#include "attention_bwd_common.cuh"
#include "hopper_common.cuh"

namespace dl4j {

constexpr int kBwdStages = 2;       // depth of the streamed-tile ring
constexpr int kBwdThreads = 160;    // a consumer warpgroup and a producer warp

// The roles a grid runs: dkv alone (B5), dq alone (B4), or both (B2).
enum BwdRoles { kRolesDkv, kRolesDq, kRolesBoth };

// lse in log2 units. A fully masked row's lse is kNeg (up to rounding) and
// maps to exactly kNeg2, so that its replaced logits give p = 1 exactly.
__device__ __forceinline__ float lse_log2(float x) {
  return x <= 0.5f * kNeg ? kNeg2 : x * kLog2e;
}

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// Named barrier 1 among the 128 consumer threads.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// A CTA's shared memory (either role): two resident 64-row tiles, the
// ring's stages of two streamed tiles each, each stage's row terms (lse in
// log2 units and delta of its 64 queries, dkv role), the mbarriers.
template <int DMAX>
struct BwdSmem {
  static constexpr uint32_t kTile = 64 * DMAX * 2;
  uint32_t base;   // 1024-byte aligned (the 128-byte swizzle's period)
  __device__ uint32_t res(int i) const { return base + i * kTile; }
  __device__ uint32_t ring(int st, int i) const {
    return base + (2 + 2 * st + i) * kTile;
  }
  __device__ uint32_t rows(int st) const {
    return base + (2 + 2 * kBwdStages) * kTile + st * 512;
  }
  __device__ uint32_t res_full() const { return rows(kBwdStages); }
  __device__ uint32_t full(int st) const { return res_full() + 8 + 8 * st; }
  __device__ uint32_t empty(int st) const {
    return res_full() + 8 + 8 * (kBwdStages + st);
  }
};

template <int DMAX>
constexpr size_t bwd_core_smem() {
  return 1024 + (size_t)(2 + 2 * kBwdStages) * BwdSmem<DMAX>::kTile +
         kBwdStages * 512 + 8 * (1 + 2 * kBwdStages);
}

// Loads the 64-row tile at row `row` of head bh into `dst` (one box per
// 64 columns).
template <int DMAX>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          int row, int bh, uint32_t bar) {
#pragma unroll
  for (int hh = 0; hh < DMAX / 64; ++hh)
    tma_load_3d(dst + hh * 64 * 128, map, hh * 64, row, bh, bar);
}

// ---- dkv role: key tile j0, query tiles qt0 .. qt0 + ntiles - 1 ----

template <int DMAX>
__device__ __forceinline__ void dkv_producer(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const BwdArgs& a, const BwdSmem<DMAX>& sm,
    int bh, int j0, int qt0, int ntiles) {
  const int lane = threadIdx.x & 31, t = a.t;
  if (lane == 0) {
    mbar_expect_tx(sm.res_full(), 2 * BwdSmem<DMAX>::kTile);
    load_tile<DMAX>(sm.res(0), tk, j0, bh, sm.res_full());
    load_tile<DMAX>(sm.res(1), tv, j0, bh, sm.res_full());
  }
  const float* lse = a.lse + (size_t)bh * t;
  const float* delta = a.delta + (size_t)bh * t;
  for (int n = 0; n < ntiles; ++n) {
    const int st = n % kBwdStages, q0 = (qt0 + n) * 64, r = q0 + 2 * lane;
    const uint32_t ph = (n / kBwdStages) & 1;
    // this lane's two queries' row terms, read before the wait
    const float l0 = r < t ? lse_log2(lse[r]) : INFINITY;
    const float l1 = r + 1 < t ? lse_log2(lse[r + 1]) : INFINITY;
    const float d0 = r < t ? delta[r] : 0.f;
    const float d1 = r + 1 < t ? delta[r + 1] : 0.f;
    if (n >= kBwdStages) mbar_wait(sm.empty(st), ph ^ 1);
    sts_f2(sm.rows(st) + 8 * lane, l0, l1);
    sts_f2(sm.rows(st) + 256 + 8 * lane, d0, d1);
    // 32 arrivals (lane 0's with the expected bytes) after the stores
    if (lane == 0) {
      mbar_expect_tx(sm.full(st), 2 * BwdSmem<DMAX>::kTile);
      load_tile<DMAX>(sm.ring(st, 0), tq, q0, bh, sm.full(st));
      load_tile<DMAX>(sm.ring(st, 1), tdo, q0, bh, sm.full(st));
    } else {
      mbar_arrive(sm.full(st));
    }
  }
}

template <typename T, int DMAX, bool BIAS>
__device__ __forceinline__ void dkv_consumer(const BwdArgs& a,
                                             const BiasArgs& b,
                                             const BwdSmem<DMAX>& sm, int bh,
                                             int j0, int qt0, int ntiles) {
  constexpr int NH = DMAX / 64;
  // probe: begin
  const int t = a.t, d = a.d, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int kr = 16 * warp + g;   // the thread's key rows kr, kr + 8
  // a masked key's logits are all replaced; keys past T are never written
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;
  bool dead[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int j = j0 + kr + 8 * hr;
    dead[hr] = j >= t || (km != nullptr && km[j] <= 0.f);
  }
  const float sc2 = a.scale * kLog2e;
  const float* blk = BIAS ? b.bias + bias_block(bh, a.h, t, b.np) : nullptr;
  float dk[NH][8][4], dv[NH][8][4], s[8][4], dp[8][4];
  uint32_t pa[4][4], da[4][4];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[hh][i][e] = dv[hh][i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
  mbar_wait(sm.res_full(), 0);

  for (int n = 0; n < ntiles; ++n) {
    const int st = n % kBwdStages, q0 = (qt0 + n) * 64;
    const uint32_t ph = (n / kBwdStages) & 1;
    const uint32_t sq = sm.ring(st, 0), sdo = sm.ring(st, 1);
    const uint32_t rows = sm.rows(st);
    // the tile's bias, transposed as S^T is (key kr + 8 (e / 2), query
    // q0 + 8 i + 2 tig + e % 2), requested before the wait
    float bb[BIAS ? 8 : 1][4];
    if constexpr (BIAS) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = q0 + 8 * i + 2 * tig + (e & 1);
          const int kc = j0 + kr + 8 * (e >> 1);
          bb[i][e] = qr < t && kc < t
                         ? __ldg(blk + (size_t)qr * t + kc) * kLog2e
                         : 0.f;
        }
    }
    // probe: wait
    mbar_wait(sm.full(st), ph);
    // probe: s
    wgmma_fence();
    mma_abt<T, DMAX>(s, sm.res(0), sq);     // S^T = K Q^T
    wgmma_commit();
    mma_abt<T, DMAX>(dp, sm.res(1), sdo);   // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    // probe: p
    // entry (i, e) is key kr + 8 (e / 2), query q0 + 8 i + 2 tig + e % 2
    if (!(dead[0] || dead[1] || (a.causal && q0 == j0))) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 l = lds_f2(rows + 4 * (8 * i + 2 * tig));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[i][e] * sc2;
          if constexpr (BIAS) x += bb[i][e];
          s[i][e] = fast_exp2(x - (e & 1 ? l.y : l.x));
        }
      }
    } else {
      const bool diag = a.causal && q0 == j0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 l = lds_f2(rows + 4 * (8 * i + 2 * tig));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * i + 2 * tig + (e & 1);
          const bool keep =
              !dead[e >> 1] && !(diag && kr + 8 * (e >> 1) > c);
          float x = s[i][e] * sc2;
          if constexpr (BIAS) x += bb[i][e];
          s[i][e] = fast_exp2((keep ? x : kNeg2) - (e & 1 ? l.y : l.x));
        }
      }
    }
    // probe: dp
    wgmma_wait<0>();
    fence_regs(dp);
    // probe: ds
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float2 dl = lds_f2(rows + 256 + 4 * (8 * i + 2 * tig));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[i][e] = s[i][e] * (dp[i][e] - (e & 1 ? dl.y : dl.x)) * a.scale;
    }
    pack_a<T>(pa, s);
    pack_a<T>(da, dp);
    wgmma_fence();
    mma_pb<T, NH>(dv, pa, sdo);             // dV += P^T dO
    mma_pb<T, NH>(dk, da, sq);              // dK += dS^T Q
    wgmma_commit();
    // probe: grads
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      fence_regs(dv[hh]);
      fence_regs(dk[hh]);
    }
    fence_regs(pa);
    fence_regs(da);
    // probe: release
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(st));
  }

  // probe: epilogue
  consumer_sync();   // every warp's products are done with the ring
  const float one[2] = {1.f, 1.f};
  const size_t base = (size_t)bh * t * d;
  float o[NH * 8][4];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[hh * 8 + i][e] = dk[hh][i][e];
  store_rows<T, DMAX>(o, one, static_cast<T*>(a.dk) + base, sm.ring(0, 0),
                      j0 + 16 * warp, t, d);
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[hh * 8 + i][e] = dv[hh][i][e];
  store_rows<T, DMAX>(o, one, static_cast<T*>(a.dv) + base, sm.ring(0, 1),
                      j0 + 16 * warp, t, d);
  // probe: done dkv
}

// ---- dq role: query tile q0, key tiles 0 .. ntiles - 1 ----

template <int DMAX>
__device__ __forceinline__ void dq_producer(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tdo, const BwdSmem<DMAX>& sm, int bh, int q0,
    int ntiles) {
  if ((threadIdx.x & 31) != 0) return;
  mbar_expect_tx(sm.res_full(), 2 * BwdSmem<DMAX>::kTile);
  load_tile<DMAX>(sm.res(0), tq, q0, bh, sm.res_full());
  load_tile<DMAX>(sm.res(1), tdo, q0, bh, sm.res_full());
  for (int n = 0; n < ntiles; ++n) {
    const int st = n % kBwdStages;
    const uint32_t ph = (n / kBwdStages) & 1;
    if (n >= kBwdStages) mbar_wait(sm.empty(st), ph ^ 1);
    mbar_expect_tx(sm.full(st), 2 * BwdSmem<DMAX>::kTile);
    load_tile<DMAX>(sm.ring(st, 0), tk, n * 64, bh, sm.full(st));
    load_tile<DMAX>(sm.ring(st, 1), tv, n * 64, bh, sm.full(st));
  }
}

template <typename T, int DMAX, bool BIAS>
__device__ __forceinline__ void dq_consumer(const BwdArgs& a,
                                            const BiasArgs& b,
                                            const BwdSmem<DMAX>& sm, int bh,
                                            int q0, int ntiles) {
  constexpr int NH = DMAX / 64;
  // probe: begin
  const int t = a.t, d = a.d, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int qw = q0 + 16 * warp;   // the thread's rows qw + g, + 8
  // rows past T get p = 0
  float lse2[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = qw + g + 8 * hr;
    lse2[hr] = row < t ? lse_log2(a.lse[(size_t)bh * t + row]) : INFINITY;
    dl[hr] = row < t ? a.delta[(size_t)bh * t + row] : 0.f;
  }
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;
  const float sc2 = a.scale * kLog2e;
  const size_t boff = BIAS ? bias_block(bh, a.h, t, b.np) : 0;
  float dq[NH][8][4], s[8][4], dp[8][4];
  uint32_t da[4][4];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[hh][i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
  mbar_wait(sm.res_full(), 0);

  for (int n = 0; n < ntiles; ++n) {
    const int st = n % kBwdStages, j0 = n * 64;
    const uint32_t ph = (n / kBwdStages) & 1;
    const uint32_t sk = sm.ring(st, 0), sv = sm.ring(st, 1);
    // probe: wait
    // the tile's key-mask entries, requested before the wait
    float km0 = 1.f, km1 = 1.f;
    if (km != nullptr) {
      km0 = j0 + lane < t ? km[j0 + lane] : 0.f;
      km1 = j0 + 32 + lane < t ? km[j0 + 32 + lane] : 0.f;
    }
    float bb[BIAS ? 8 : 1][4];
    if constexpr (BIAS) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 v = bias_pair(b.bias + boff, t, qw + g + 8 * hr,
                                     j0 + 8 * i + 2 * tig);
          bb[i][2 * hr] = v.x;
          bb[i][2 * hr + 1] = v.y;
        }
    }
    mbar_wait(sm.full(st), ph);
    // probe: s
    wgmma_fence();
    mma_abt<T, DMAX>(s, sm.res(0), sk);     // S = Q K^T
    wgmma_commit();
    mma_abt<T, DMAX>(dp, sm.res(1), sv);    // dP = dO V^T
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);
    // probe: p
    // entry (i, e) is query qw + g + 8 (e / 2), key j0 + 8 i + 2 tig + e % 2
    const uint32_t bits0 = __ballot_sync(0xffffffffu, km0 > 0.f);
    const uint32_t bits1 = __ballot_sync(0xffffffffu, km1 > 0.f);
    if (j0 + 64 <= t && (!a.causal || j0 + 63 <= qw) &&
        (bits0 & bits1) == 0xffffffffu) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[i][e] * sc2;
          if constexpr (BIAS) x += bb[i][e];
          s[i][e] = fast_exp2(x - lse2[e >> 1]);
        }
    } else {
      // key jl of the tile: past T (jl >= lim) it is not part of the row;
      // causal-future (jl > vis) or masked it gets kNeg2
      const int lim = t - j0, r0 = qw + g - j0;
      const int vis0 = a.causal ? r0 : 64, vis1 = a.causal ? r0 + 8 : 64;
      const uint32_t kb0 = bits0 >> (2 * tig), kb1 = bits1 >> (2 * tig);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = i * 8 + 2 * tig + (e & 1);
          const uint32_t kb = i < 4 ? kb0 : kb1;
          const bool real = (kb >> ((i * 8 + (e & 1)) & 31)) & 1u;
          const bool keep = real && jl <= (e >> 1 ? vis1 : vis0);
          float y = s[i][e] * sc2;
          if constexpr (BIAS) y += bb[i][e];
          const float x = jl >= lim ? -INFINITY : keep ? y : kNeg2;
          s[i][e] = fast_exp2(x - lse2[e >> 1]);
        }
      }
    }
    // probe: dp
    wgmma_wait<0>();
    fence_regs(dp);
    // probe: ds
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[i][e] = s[i][e] * (dp[i][e] - dl[e >> 1]) * a.scale;
    pack_a<T>(da, dp);
    wgmma_fence();
    mma_pb<T, NH>(dq, da, sk);              // dQ += dS K
    wgmma_commit();
    // probe: grads
    wgmma_wait<0>();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(dq[hh]);
    fence_regs(da);
    // probe: release
    __syncwarp();
    if (lane == 0) mbar_arrive(sm.empty(st));
  }

  // probe: epilogue
  consumer_sync();   // every warp's products are done with Q
  const float one[2] = {1.f, 1.f};
  float o[NH * 8][4];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[hh * 8 + i][e] = dq[hh][i][e];
  store_rows<T, DMAX>(o, one, static_cast<T*>(a.dq) + (size_t)bh * t * d,
                      sm.res(0), qw, t, d);
  // probe: done dq
}

// One grid of 64-row tiles per b*h (blockIdx.y). kRolesBoth: x = 2 i is
// the dkv role of key tile i and x = 2 i + 1 the dq role of query tile
// tiles - 1 - i (the longest walks of both roles first); kRolesDkv: x is
// the dkv role of key tile x; kRolesDq: x is the dq role of query tile
// tiles - 1 - x.
template <typename T, int DMAX, int ROLES, bool BIAS>
__device__ __forceinline__ void bwd_cta(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const CUtensorMap* tdo,
                                        const BwdArgs& a, const BiasArgs& b) {
  extern __shared__ __align__(1024) uint8_t bwd_smem[];
  const BwdSmem<DMAX> sm{
      (static_cast<uint32_t>(__cvta_generic_to_shared(bwd_smem)) + 1023u) &
      ~1023u};
  const int tiles = num_tiles(a.t), bh = blockIdx.y;
  const bool dq_role =
      ROLES == kRolesDq || (ROLES == kRolesBoth && (blockIdx.x & 1));
  const int x = ROLES == kRolesBoth ? blockIdx.x >> 1 : blockIdx.x;
  const int tile = dq_role ? tiles - 1 - x : x;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    mbar_init(sm.res_full(), 1);
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(sm.full(st), dq_role ? 1 : 32);
      mbar_init(sm.empty(st), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (dq_role) {
    const int ntiles = a.causal ? tile + 1 : tiles;
    if (warp == 4)
      dq_producer<DMAX>(tq, tk, tv, tdo, sm, bh, tile * 64, ntiles);
    else
      dq_consumer<T, DMAX, BIAS>(a, b, sm, bh, tile * 64, ntiles);
  } else {
    const int qt0 = a.causal ? tile : 0;
    if (warp == 4)
      dkv_producer<DMAX>(tq, tk, tv, tdo, a, sm, bh, tile * 64, qt0,
                         tiles - qt0);
    else
      dkv_consumer<T, DMAX, BIAS>(a, b, sm, bh, tile * 64, qt0,
                                  tiles - qt0);
  }
}

template <typename T, int DMAX, int ROLES>
__global__ void __launch_bounds__(kBwdThreads, DMAX == 64 ? 2 : 1)
    attention_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const BwdArgs a) {
  bwd_cta<T, DMAX, ROLES, false>(&tq, &tk, &tv, &tdo, a, BiasArgs{});
}

// The biased instance, both roles (B2's grid), under its own name.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kBwdThreads, DMAX == 64 ? 2 : 1)
    attention_bias_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const BwdArgs a, const BiasArgs b) {
  bwd_cta<T, DMAX, kRolesBoth, true>(&tq, &tk, &tv, &tdo, a, b);
}

template <typename T, int DMAX, int ROLES, bool BIAS>
cudaError_t launch_bwd_core(const BwdArgs& a, const BiasArgs& b, int bh,
                            cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map<T>(&tq, a.q, bh, a.t, a.d) ||
      !encode_map<T>(&tk, a.k, bh, a.t, a.d) ||
      !encode_map<T>(&tv, a.v, bh, a.t, a.d) ||
      !encode_map<T>(&tdo, a.dout, bh, a.t, a.d))
    return cudaErrorInvalidValue;
  constexpr size_t smem = bwd_core_smem<DMAX>();
  const dim3 grid((ROLES == kRolesBoth ? 2 : 1) * num_tiles(a.t), bh);
  cudaError_t err;
  if constexpr (BIAS) {
    auto kern = attention_bias_bwd_kernel<T, DMAX>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kBwdThreads, smem, stream>>>(tq, tk, tv, tdo, a, b);
  } else {
    auto kern = attention_bwd_kernel<T, DMAX, ROLES>;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, kBwdThreads, smem, stream>>>(tq, tk, tv, tdo, a);
  }
  return cudaGetLastError();
}

// The bf16 / f16 backward at head-dim bucket 64 or 128 (columns past d are
// zero-filled): both roles (B2), the dq role alone (B4) or the dkv role
// alone (B5).
template <typename T, int ROLES>
cudaError_t dispatch_bwd_core(const BwdArgs& a, int bh, cudaStream_t stream) {
  if (a.d <= 64)
    return launch_bwd_core<T, 64, ROLES, false>(a, BiasArgs{}, bh, stream);
  return launch_bwd_core<T, 128, ROLES, false>(a, BiasArgs{}, bh, stream);
}

// ---- dbias: one (block, query tile, key tile) over a group of images ----
//
// dbias[g, p, head] = sum over the images i of group g (i = g, g + ng, ...)
// of p (dP - delta) on the rows bh = (i np + p) h + head: a CTA owns one
// 64 x 64 tile of one (p, head) block, and its consumer warpgroup
// recomputes S = Q K^T and dP = dO V^T (wgmma) an image and sums
// p (dP - delta) in f32 registers, in image order, then stores the tile
// once; the producer streams each image's Q, dO, K and V tiles (TMA) and
// its 64 queries' row terms through a 2-deep ring. No atomics: the sums
// are the same bits every call. The bias tile is read once a CTA. Keys
// and rows past t give p = 0 and are not stored.
template <int DMAX>
constexpr size_t dbias_smem_bytes() {
  return 1024 + (size_t)kBwdStages * 4 * 64 * DMAX * 2 + kBwdStages * 512 +
         8 * 2 * kBwdStages;
}

__device__ __forceinline__ float lds_f1(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kBwdThreads, 2)
    attention_bias_dbias_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const BwdArgs a, const BiasArgs b,
                                int images) {
  constexpr uint32_t kTile = 64 * DMAX * 2;
  extern __shared__ __align__(1024) uint8_t db_smem[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(db_smem)) + 1023u) &
      ~1023u;
  // stage st: tiles Q, dO, K, V, then its row terms (lse in log2 units,
  // delta; 64 each), then the full and empty mbarriers
  auto tile = [base](int st, int i) { return base + (4 * st + i) * kTile; };
  const uint32_t rows0 = base + 4 * kBwdStages * kTile;
  auto rows = [rows0](int st) { return rows0 + st * 512; };
  const uint32_t bars = rows0 + kBwdStages * 512;
  auto full = [bars](int st) { return bars + 8 * st; };
  auto empty = [bars](int st) { return bars + 8 * (kBwdStages + st); };

  const int t = a.t, tiles = num_tiles(t);
  const int q0 = (blockIdx.x / tiles) * 64, j0 = (blockIdx.x % tiles) * 64;
  const int blk = blockIdx.y, p = blk / a.h, head = blk % a.h;
  const int ng = gridDim.z, gz = blockIdx.z;
  const int mine = (images - gz + ng - 1) / ng;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(full(st), 32);
      mbar_init(empty(st), 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {   // producer
    for (int n = 0; n < mine; ++n) {
      const int bh = ((gz + n * ng) * b.np + p) * a.h + head;
      const int st = n % kBwdStages, r = q0 + 2 * lane;
      const uint32_t ph = (n / kBwdStages) & 1;
      const float* lse = a.lse + (size_t)bh * t;
      const float* delta = a.delta + (size_t)bh * t;
      const float l0 = r < t ? lse_log2(lse[r]) : INFINITY;
      const float l1 = r + 1 < t ? lse_log2(lse[r + 1]) : INFINITY;
      const float d0 = r < t ? delta[r] : 0.f;
      const float d1 = r + 1 < t ? delta[r + 1] : 0.f;
      if (n >= kBwdStages) mbar_wait(empty(st), ph ^ 1);
      sts_f2(rows(st) + 8 * lane, l0, l1);
      sts_f2(rows(st) + 256 + 8 * lane, d0, d1);
      if (lane == 0) {
        mbar_expect_tx(full(st), 4 * kTile);
        load_tile<DMAX>(tile(st, 0), &tq, q0, bh, full(st));
        load_tile<DMAX>(tile(st, 1), &tdo, q0, bh, full(st));
        load_tile<DMAX>(tile(st, 2), &tk, j0, bh, full(st));
        load_tile<DMAX>(tile(st, 3), &tv, j0, bh, full(st));
      } else {
        mbar_arrive(full(st));
      }
    }
    return;
  }

  // consumers: entry (i, e) is query qw + g + 8 (e / 2), key
  // j0 + 8 i + 2 tig + e % 2
  const int g = lane >> 2, tig = lane & 3, rl = 16 * warp + g;
  const float sc2 = a.scale * kLog2e;
  float bb[8][4], acc[8][4], s[8][4], dp[8][4];
  const float* bblk = b.bias + (size_t)blk * t * t;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = j0 + 8 * i + 2 * tig;
      const float2 v = bias_pair(bblk, t, q0 + rl + 8 * hr, j);
      // keys past t are not part of any row
      bb[i][2 * hr] = j < t ? v.x : -INFINITY;
      bb[i][2 * hr + 1] = j + 1 < t ? v.y : -INFINITY;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = s[i][e] = dp[i][e] = 0.f;
  for (int n = 0; n < mine; ++n) {
    const int st = n % kBwdStages;
    const uint32_t ph = (n / kBwdStages) & 1;
    mbar_wait(full(st), ph);
    wgmma_fence();
    mma_abt<T, DMAX>(s, tile(st, 0), tile(st, 2));    // S = Q K^T
    wgmma_commit();
    mma_abt<T, DMAX>(dp, tile(st, 1), tile(st, 3));   // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    float lse2[2], dl[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      lse2[hr] = lds_f1(rows(st) + 4 * (rl + 8 * hr));
      dl[hr] = lds_f1(rows(st) + 256 + 4 * (rl + 8 * hr));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(st));
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr =
            fast_exp2(fmaf(s[i][e], sc2, bb[i][e]) - lse2[e >> 1]);
        acc[i][e] = fmaf(pr, dp[i][e] - dl[e >> 1], acc[i][e]);
      }
  }

  float* out = b.dbias + ((size_t)gz * gridDim.y + blk) * t * t;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + rl + 8 * hr;
    if (r >= t) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int j = j0 + 8 * i + 2 * tig;
      float* at = out + (size_t)r * t + j;
      if ((t & 1) == 0 && j + 1 < t) {
        *reinterpret_cast<float2*>(at) =
            make_float2(acc[i][2 * hr], acc[i][2 * hr + 1]);
      } else {
        if (j < t) at[0] = acc[i][2 * hr];
        if (j + 1 < t) at[1] = acc[i][2 * hr + 1];
      }
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch_dbias(const BwdArgs& a, const BiasArgs& b, int bh, int ng,
                         cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_map<T>(&tq, a.q, bh, a.t, a.d) ||
      !encode_map<T>(&tk, a.k, bh, a.t, a.d) ||
      !encode_map<T>(&tv, a.v, bh, a.t, a.d) ||
      !encode_map<T>(&tdo, a.dout, bh, a.t, a.d))
    return cudaErrorInvalidValue;
  auto kern = attention_bias_dbias_kernel<T, DMAX>;
  constexpr size_t smem = dbias_smem_bytes<DMAX>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = num_tiles(a.t);
  const dim3 grid(tiles * tiles, b.np * a.h, ng);
  kern<<<grid, kBwdThreads, smem, stream>>>(tq, tk, tv, tdo, a, b,
                                            bh / (b.np * a.h));
  return cudaGetLastError();
}

// The biased backward, the same buckets: dq, dk and dv from B2's grid with
// the bias (both roles), then dbias's ng partial sums from the dbias
// kernel.
template <typename T>
cudaError_t dispatch_bias_bwd_core(const BwdArgs& a, const BiasArgs& b,
                                   int bh, int ng, cudaStream_t stream) {
  cudaError_t err = a.d <= 64
      ? launch_bwd_core<T, 64, kRolesBoth, true>(a, b, bh, stream)
      : launch_bwd_core<T, 128, kRolesBoth, true>(a, b, bh, stream);
  if (err != cudaSuccess) return err;
  return a.d <= 64 ? launch_dbias<T, 64>(a, b, bh, ng, stream)
                   : launch_dbias<T, 128>(a, b, bh, ng, stream);
}

}  // namespace dl4j
