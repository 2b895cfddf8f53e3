// Batch-norm training forward and backward for Hopper (sm_90a): the
// batchnorm_train and batchnorm_add_act_train kernels.
//
// Replaces the JAX package's fused batch-norm helpers in its
// kernels/batchnorm.py: bn_train_fused (:44; forward _bn_fwd_impl :63,
// backward _bn_bwd :85) and bn_add_act_train_fused (:120; forward :131,
// backward :153), the jnp custom VJPs behind the batchnorm_train and
// batchnorm_add_act_train helper seams, and the ReLU a BN layer applies
// to the helper's output (nn/conf/layers/convolution.py:278-290 there).
// Activations are x [M, C] with C contiguous (NHWC with M = N*H*W), f32
// or bf16; gamma and beta f32 or bf16 (dgamma / dbeta are written in
// their dtype); the shift hint and every statistic are f32.
//
// Variants (one kernel each, Variant below). Forward, y = x * scale +
// shift then (+ res) (ReLU): plain (an identity BN), relu (a BN layer's own
// ReLU), res (the identity tail), res_relu (the ReLU tail). Backward: plain
// (an identity BN, and the identity tail, whose residual gradient is dy),
// relu (dy masked where the BN output is not positive: the mask is
// recomputed from x with the forward's rounded scale and shift by the
// same rounded operations, so it equals y > 0 bit for bit and y is never
// read), res_relu (dy masked by the saved tail output y > 0; the masked dy
// is written as the residual's gradient).
//
// Arithmetic, rounded where the JAX function rounds:
//   forward: per channel the f32 sums of d = x - s and d^2 (s the shift
//   hint, the running mean, so the one-pass variance is conditioned);
//   mean = s + m1, var = max(m2 - m1^2, 0), rstd; scale = gamma * rstd and
//   shift = beta - mean * scale rounded to x's dtype; y = x * scale +
//   shift (+ res) (ReLU), each operation rounded to x's dtype.
//   backward: per channel sum(dy) and sum(dy * xhat), xhat = (x - mean) *
//   rstd from x; k = gamma * rstd, c1 = dbeta / M, c2 = dgamma / M rounded
//   to x's dtype; dx = k * ((dy - c1) - xhat * c2).
//
// What bounds it on H100: bytes. A few operations per element against 2-4
// bytes, far below the ~295 operations per byte where the tensor cores
// would matter; the least time is every input read once and every output
// written once at 3.35 TB/s (forward x (+ res) and y; backward dy, x (+ y),
// dx (+ dres)).
//
// Design: ONE persistent cooperative launch a direction. The grid is the
// co-resident CTAs (occupancy x SMs), kThreads threads each; phases
// separated by grid.sync():
//   (a) CTA b owns rows [b M / G, (b + 1) M / G) and walks them in tiles of
//       whole rows. A tile of one tensor is one contiguous byte range, so
//       one TMA 1-D bulk copy (cp.async.bulk, completing on an mbarrier)
//       brings it into a ring of stages in shared memory. A thread owns one
//       16-byte channel vector and one row group, so its channels and their
//       coefficients stay in registers and no index needs a modulo. It
//       sums its rows in f32; the CTA adds its row groups in a fixed order
//       into one f32 partial per channel, stored contiguously.
//   (b) CTA j owns channels [j C / G, (j + 1) C / G): lane l of warp w sums
//       channel l's partials of CTAs w, w + 16, ... in f64 (coalesced
//       loads), then warp 0 adds the 16 warps' sums in order and writes
//       the statistics and the rounded coefficients.
//   (c) every CTA walks its tiles again, last first, and writes y (or dx,
//       dres) from registers in 16-byte stores. In bf16 the rounded
//       elementwise operations are bf16x2 instructions (mul / add / sub
//       .rn, max.NaN), which give the plain version's bits (see vmul) with
//       no conversion to f32 and back (which bounded the pass by
//       instruction issue). The coefficients reach the threads through
//       shared memory (see phase (c)).
// Resident slabs: where a CTA's whole slab of the tensors phase (c) reads
// fits the ring (a stage per tile), phase (a) leaves it in shared memory
// and phase (c) reads it from there, so HBM moves the bound's bytes.
// Elsewhere the ring streams; phase (c) starts with the tiles phase (a)
// left in the ring and walks backwards, so the rows read most recently,
// still in the 50 MB L2, come first.
// No floating-point atomics: the grid, the tiles and every order of
// summation are fixed by (M, C, dtype, variant) on a card, so two runs
// agree bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_common.cuh"

namespace dl4j_bn {

namespace cg = cooperative_groups;
using dl4j::mbar_expect_tx;
using dl4j::mbar_init;
using dl4j::mbar_wait;

// build-time knobs, for tools/bn_probe.py's variants
#ifndef DL4J_BN_THREADS
#define DL4J_BN_THREADS 512
#endif
#ifndef DL4J_BN_TILE_BYTES
#define DL4J_BN_TILE_BYTES 16384
#endif

constexpr int kF32 = 0;
constexpr int kBF16 = 2;
constexpr int kThreads = DL4J_BN_THREADS;
constexpr int kWarps = kThreads / 32;
// one tensor's share of a ring stage, aimed for
constexpr long long kTileBytes = DL4J_BN_TILE_BYTES;
constexpr int kMaxStages = 32;
constexpr int kBarBytes = kMaxStages * 8;

enum Variant {
  kFwd = 0,
  kFwdRelu = 1,
  kFwdRes = 2,
  kFwdResRelu = 3,
  kBwd = 4,
  kBwdRelu = 5,
  kBwdResRelu = 6,
  kVariants = 7
};

// tensors a ring stage holds (those phase (c) reads), and the first of
// them that phase (a) reads: forward x (, res); backward dy, x (, y)
__host__ __device__ constexpr int slots_of(int v) {
  return v == kFwdRes || v == kFwdResRelu ? 2
         : v == kBwdResRelu               ? 3
         : v >= kBwd                      ? 2
                                          : 1;
}
__host__ __device__ constexpr int a_slots_of(int v) {
  return v < kBwd ? 1 : slots_of(v);
}

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// A 16-byte vector as 4 words: 4 f32, or 8 bf16 as 4 bf16x2 pairs (the
// lower channel in the low half).
struct Words {
  uint32_t w[4];
};

__device__ __forceinline__ Words ld_words(const void* p) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  return {{r.x, r.y, r.z, r.w}};
}
__device__ __forceinline__ void st_words(void* p, const Words& v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
}

// the vector's channels as floats
template <typename T>
__device__ __forceinline__ void to_floats(const Words& v,
                                          float (&o)[Vec<T>::N]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kIsBf16<T>) {
      o[2 * i] = __uint_as_float(v.w[i] << 16);
      o[2 * i + 1] = __uint_as_float(v.w[i] & 0xffff0000u);
    } else {
      o[i] = __uint_as_float(v.w[i]);
    }
  }
}

// floats as a vector of T, rounded to nearest even
template <typename T>
__device__ __forceinline__ Words from_floats(const float (&f)[Vec<T>::N]) {
  Words v;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kIsBf16<T>)
      asm("cvt.rn.bf16x2.f32 %0, %1, %2;"
          : "=r"(v.w[i])
          : "f"(f[2 * i + 1]), "f"(f[2 * i]));
    else
      v.w[i] = __float_as_uint(f[i]);
  }
  return v;
}

// One word's elementwise a * b, a + b, a - b and max(a, 0) in T, each
// rounded to nearest even once. A product of two bf16 values is exact in
// f32, and a sum is exact unless the exponents differ by more than 16, when
// it rounds to the larger operand either way; so one bf16x2 instruction
// gives the f32 operation rounded to bf16 (what the plain version
// computes) with no conversion. The explicit .rn keeps nvcc from
// contracting a multiply and an add into one fma. The ReLU propagates NaN,
// as jnp.maximum does.
template <typename T>
__device__ __forceinline__ uint32_t vmul(uint32_t a, uint32_t b) {
  if constexpr (kIsBf16<T>) {
    uint32_t d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  } else {
    return __float_as_uint(__fmul_rn(__uint_as_float(a), __uint_as_float(b)));
  }
}
template <typename T>
__device__ __forceinline__ uint32_t vadd(uint32_t a, uint32_t b) {
  if constexpr (kIsBf16<T>) {
    uint32_t d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  } else {
    return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
  }
}
template <typename T>
__device__ __forceinline__ uint32_t vsub(uint32_t a, uint32_t b) {
  if constexpr (kIsBf16<T>) {
    uint32_t d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  } else {
    return __float_as_uint(__fsub_rn(__uint_as_float(a), __uint_as_float(b)));
  }
}
template <typename T>
__device__ __forceinline__ uint32_t vrelu(uint32_t a) {
  if constexpr (kIsBf16<T>) {
    uint32_t d;
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(0u));
    return d;
  } else {
    const float f = __uint_as_float(a);
    return f < 0.f ? 0u : a;
  }
}
// a word's lanes kept where `v`'s are > 0 (NaN is not), zeroed elsewhere
template <typename T>
__device__ __forceinline__ uint32_t keep_positive(uint32_t a, uint32_t v) {
  if constexpr (kIsBf16<T>) {
    const uint32_t lo = __uint_as_float(v << 16) > 0.f ? 0x0000ffffu : 0u;
    const uint32_t hi = __uint_as_float(v & 0xffff0000u) > 0.f ? 0xffff0000u
                                                                : 0u;
    return a & (lo | hi);
  } else {
    return __uint_as_float(v) > 0.f ? a : 0u;
  }
}

// v rounded to T's precision (round to nearest even), as a float
template <typename T> __device__ __forceinline__ float rnd(float v) {
  if constexpr (kIsBf16<T>)
    return __bfloat162float(__float2bfloat16(v));
  else
    return v;
}

// a per-channel parameter of gamma's dtype (bf16 when `bf16`)
__device__ __forceinline__ float param(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}
__device__ __forceinline__ void store_param(void* p, int bf16, int i,
                                            float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// `bytes` from global src to shared dst, completing on mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

struct Args {
  // the ring's tensors in slot order: forward x, res; backward dy, x, y
  const void* in[3];
  const void* gamma;
  const void* beta;
  const float* shift;  // forward: the shift hint [c]
  const float* mean;   // backward: the forward's statistics [c]
  const float* rstd;
  float* stats;        // forward: mean, var, rstd [3, c]
  void* out0;          // forward y; backward dx
  void* dres;          // backward res_relu: the masked dy
  void* dgb;           // backward: dgamma, dbeta [2, c] in gamma's dtype
  float* partial;      // [G, 2, c]
  float* coef;         // [2, c]
  long long m;
  int c, gbf16, stages, tile_rows;
  float eps;
};

// The CTA's f32 sums of one quantity over its row groups into out[j] for
// channel j, in a fixed order: with c < kThreads each of the kThreads / c
// threads of a channel adds a strided share of the row groups (part holds
// the shares), then thread j adds the shares in order; a wider row has few
// row groups, and thread j adds them all.
template <int V>
__device__ __forceinline__ void cta_sum(float* red, float* part,
                                        const float (&v)[V], float* out,
                                        int c, int c0, int rg, int rgs,
                                        bool active) {
  const int tid = threadIdx.x;
  if (active) {
#pragma unroll
    for (int i = 0; i < V; ++i) red[rg * c + c0 + i] = v[i];
  }
  __syncthreads();
  if (c >= kThreads) {
    for (int j = tid; j < c; j += kThreads) {
      float acc = 0.f;
      for (int r = 0; r < rgs; ++r) acc = __fadd_rn(acc, red[r * c + j]);
      out[j] = acc;
    }
  } else {
    const int shares = kThreads / c, j = tid % c, p = tid / c;
    if (p < shares) {
      float acc = 0.f;
      for (int r = p; r < rgs; r += shares)
        acc = __fadd_rn(acc, red[r * c + j]);
      part[p * c + j] = acc;
    }
    __syncthreads();
    if (tid < c) {
      float acc = 0.f;
      for (int q = 0; q < shares; ++q) acc = __fadd_rn(acc, part[q * c + tid]);
      out[tid] = acc;
    }
  }
  __syncthreads();
}

template <typename T, int VAR>
__device__ __forceinline__ void run(const Args& a) {
  constexpr int V = Vec<T>::N;
  constexpr bool BWD = VAR >= kBwd;
  constexpr bool RES = VAR == kFwdRes || VAR == kFwdResRelu;
  constexpr bool RELU = VAR == kFwdRelu || VAR == kFwdResRelu;
  constexpr bool XMASK = VAR == kBwdRelu;
  constexpr bool YMASK = VAR == kBwdResRelu;
  constexpr int NC = slots_of(VAR), NA = a_slots_of(VAR);
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();

  const int c = a.c, lanes = c / V, rgs = kThreads / lanes;
  const int tid = threadIdx.x, rg = tid / lanes, c0 = (tid % lanes) * V;
  const bool active = rg < rgs;
  const long long G = gridDim.x, b = blockIdx.x;
  const long long row0 = a.m * b / G;
  const long long rows = a.m * (b + 1) / G - row0;
  const int tr = a.tile_rows, stages = a.stages;
  const int ntiles = (int)((rows + tr - 1) / tr);
  const uint32_t row_bytes = (uint32_t)c * sizeof(T);
  const uint32_t slot_bytes = (uint32_t)tr * row_bytes;
  const uint32_t stage_bytes = slot_bytes * NC;
  float* red = reinterpret_cast<float*>(smem + kBarBytes);
  float* part = red + kThreads * V;
  unsigned char* ring =
      smem + kBarBytes + kThreads * (V + 1) * sizeof(float);
  const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // probe: start

  auto tile_n = [&](int i) {
    const long long n = rows - (long long)i * tr;
    return (int)(n < tr ? n : tr);
  };
  // thread 0: tile i's rows of slots [k0, k1) into stage i % stages
  auto issue = [&](int i, int k0, int k1) {
    const int s = i % stages;
    const uint32_t bytes = (uint32_t)tile_n(i) * row_bytes;
    const long long off = (row0 + (long long)i * tr) * row_bytes;
    mbar_expect_tx(bars + 8 * s, bytes * (k1 - k0));
    for (int k = k0; k < k1; ++k)
      bulk_load(ring_s + s * stage_bytes + k * slot_bytes,
                static_cast<const char*>(a.in[k]) + off, bytes, bars + 8 * s);
  };
  uint32_t parity = 0;  // bit s: the phase of stage s's next wait
  auto wait_stage = [&](int s) {
    mbar_wait(bars + 8 * s, (parity >> s) & 1u);
    parity ^= 1u << s;
  };
  // the thread's vector of row r of slot k in stage s
  auto vec_at = [&](int s, int k, int r) {
    return ld_words(ring + s * stage_bytes + k * slot_bytes +
                    ((size_t)r * c + c0) * sizeof(T));
  };

  // the thread's per-channel constants: forward the shift hint; backward
  // the statistics, k = gamma * rstd (f32 and rounded to T: it is also the
  // forward's rounded scale) and, for the recomputed mask, the forward's
  // rounded shift
  float ctr[V], rs[V], kf[V];
  Words kw, shw;
  {
    float sh[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if constexpr (!BWD) {
        ctr[v] = a.shift[c0 + v];
      } else {
        ctr[v] = a.mean[c0 + v];
        rs[v] = a.rstd[c0 + v];
        const float scale =
            __fmul_rn(param(a.gamma, a.gbf16, c0 + v), rs[v]);
        kf[v] = rnd<T>(scale);
        sh[v] = XMASK ? rnd<T>(__fsub_rn(param(a.beta, a.gbf16, c0 + v),
                                         __fmul_rn(ctr[v], scale)))
                      : 0.f;
      }
    }
    if constexpr (BWD) {
      kw = from_floats<T>(kf);
      shw = from_floats<T>(sh);
    }
  }
  // dy of stage s's row r, masked where the BN output is not positive:
  // the saved tail output y (YMASK), or y = x * scale + shift recomputed
  // with the forward's operations (XMASK)
  auto masked_dy = [&](int s, int r, const Words& x) {
    Words g = vec_at(s, 0, r);
    if constexpr (YMASK) {
      const Words y = vec_at(s, 2, r);
#pragma unroll
      for (int i = 0; i < 4; ++i) g.w[i] = keep_positive<T>(g.w[i], y.w[i]);
    } else if constexpr (XMASK) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        g.w[i] = keep_positive<T>(
            g.w[i], vadd<T>(vmul<T>(x.w[i], kw.w[i]), shw.w[i]));
    }
    return g;
  };

  // ---- (a) per-channel sums of the CTA's rows
  if (tid == 0)
    for (int i = 0; i < ntiles && i < stages; ++i) issue(i, 0, NA);
  float s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % stages, n = tile_n(i);
    wait_stage(s);
    if (active) {
#pragma unroll 2
      for (int r = rg; r < n; r += rgs) {
        if constexpr (!BWD) {
          float xv[V];
          to_floats<T>(vec_at(s, 0, r), xv);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float d = __fsub_rn(xv[v], ctr[v]);
            s1[v] = __fadd_rn(s1[v], d);
            s2[v] = __fadd_rn(s2[v], __fmul_rn(d, d));
          }
        } else {
          const Words x = vec_at(s, 1, r);
          float gv[V], xv[V];
          to_floats<T>(masked_dy(s, r, x), gv);
          to_floats<T>(x, xv);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float xhat = __fmul_rn(__fsub_rn(xv[v], ctr[v]), rs[v]);
            s1[v] = __fadd_rn(s1[v], gv[v]);
            s2[v] = __fadd_rn(s2[v], __fmul_rn(gv[v], xhat));
          }
        }
      }
    }
    if (i + stages < ntiles) {
      __syncthreads();
      if (tid == 0) issue(i + stages, 0, NA);
    }
  }
  // probe: stats
  float* mine = a.partial + 2 * c * b;
  cta_sum<V>(red, part, s1, mine, c, c0, rg, rgs, active);
  cta_sum<V>(red, part, s2, mine + c, c, c0, rg, rgs, active);
  // probe: partials
  grid.sync();
  // probe: sync1

  // ---- (b) the CTA's channels, 32 at a time: lane j of warp w sums
  // channel lo + j over CTAs w, w + kWarps, ... in f64, each load a
  // coalesced slice of the partials; lane j of warp 0 then adds the warps'
  // sums in warp order and writes the statistics and the coefficients
  {
    double* red64 = reinterpret_cast<double*>(red);  // [2][kWarps][32]
    const int w = tid / 32, lane = tid % 32;
    const int lo = (int)(c * b / G), hi = (int)(c * (b + 1) / G);
    for (int base = lo; base < hi; base += 32) {
      const int ch = base + lane;
      double q0 = 0.0, q1 = 0.0;
      if (ch < hi) {
#pragma unroll 8
        for (long long g = w; g < G; g += kWarps) {
          q0 += (double)__ldcg(a.partial + 2 * c * g + ch);
          q1 += (double)__ldcg(a.partial + 2 * c * g + c + ch);
        }
      }
      red64[w * 32 + lane] = q0;
      red64[(kWarps + w) * 32 + lane] = q1;
      __syncthreads();
      if (w == 0 && ch < hi) {
        q0 = q1 = 0.0;
        for (int i = 0; i < kWarps; ++i) {
          q0 += red64[i * 32 + lane];
          q1 += red64[(kWarps + i) * 32 + lane];
        }
        const float n = (float)a.m;
        if constexpr (!BWD) {
          const float m1 = __fdiv_rn((float)q0, n);
          const float m2 = __fdiv_rn((float)q1, n);
          const float mean = __fadd_rn(a.shift[ch], m1);
          const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m1, m1)), 0.f);
          const float r = rsqrtf(__fadd_rn(var, a.eps));
          const float scale = __fmul_rn(param(a.gamma, a.gbf16, ch), r);
          const float shift =
              __fsub_rn(param(a.beta, a.gbf16, ch), __fmul_rn(mean, scale));
          a.stats[ch] = mean;
          a.stats[c + ch] = var;
          a.stats[2 * c + ch] = r;
          a.coef[ch] = rnd<T>(scale);
          a.coef[c + ch] = rnd<T>(shift);
        } else {
          const float db = (float)q0, dg = (float)q1;
          store_param(a.dgb, a.gbf16, ch, dg);
          store_param(a.dgb, a.gbf16, c + ch, db);
          a.coef[ch] = rnd<T>(__fdiv_rn(db, n));
          a.coef[c + ch] = rnd<T>(__fdiv_rn(dg, n));
        }
      }
      __syncthreads();
    }
  }
  // probe: finalize
  grid.sync();
  // probe: sync2

  // ---- (c) the elementwise pass, last tile first. Forward: scale and
  // shift as vectors of T; backward: c1 as a vector of T (dy - c1 is
  // rounded to T) and c2 in f32.
  // The coefficients come through shared memory, loaded once a CTA with
  // coalesced loads (both halves at once where they fit): every thread
  // reading its own from L2 sent 132 x 512 requests to the same few lines.
  Words caw, cbw;
  float cb[V];
  {
    float ca[V];
    const int n = 2 * c <= kThreads * V ? 2 * c : c;
    for (int half = 0; half < 2 * c; half += n) {
      for (int j = tid; j < n; j += kThreads)
        red[j] = __ldcg(a.coef + half + j);
      __syncthreads();
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (half == 0) ca[v] = red[c0 + v];
        if (half + n > c) cb[v] = red[c + c0 + v - half];
      }
      __syncthreads();
    }
    caw = from_floats<T>(ca);
    cbw = from_floats<T>(cb);
  }
  // the tiles phase (a) left in the ring lack only what phase (a) skipped
  if constexpr (NC > NA) {
    if (tid == 0)
      for (int j = 0; j < ntiles && j < stages; ++j)
        issue(ntiles - 1 - j, NA, NC);
  }
  for (int j = 0; j < ntiles; ++j) {
    const int i = ntiles - 1 - j, s = i % stages, n = tile_n(i);
    if (j >= stages || NC > NA) wait_stage(s);
    if (active) {
      const long long grow = row0 + (long long)i * tr;
#pragma unroll 2
      for (int r = rg; r < n; r += rgs) {
        const long long goff = ((grow + r) * c + c0) * (long long)sizeof(T);
        Words o;
        if constexpr (!BWD) {
          o = vec_at(s, 0, r);
          const Words rv = RES ? vec_at(s, 1, r) : o;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            uint32_t t = vadd<T>(vmul<T>(o.w[k], caw.w[k]), cbw.w[k]);
            if constexpr (RES) t = vadd<T>(t, rv.w[k]);
            if constexpr (RELU) t = vrelu<T>(t);
            o.w[k] = t;
          }
        } else {
          const Words x = vec_at(s, 1, r);
          const Words g = masked_dy(s, r, x);
          if constexpr (YMASK)
            st_words(static_cast<char*>(a.dres) + goff, g);
          Words t1w;
#pragma unroll
          for (int k = 0; k < 4; ++k) t1w.w[k] = vsub<T>(g.w[k], caw.w[k]);
          float xv[V], t1[V], dx[V];
          to_floats<T>(x, xv);
          to_floats<T>(t1w, t1);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float xhat = __fmul_rn(__fsub_rn(xv[v], ctr[v]), rs[v]);
            dx[v] = __fmul_rn(kf[v], __fsub_rn(t1[v], __fmul_rn(xhat, cb[v])));
          }
          o = from_floats<T>(dx);
        }
        st_words(static_cast<char*>(a.out0) + goff, o);
      }
    }
    if (i - stages >= 0) {
      __syncthreads();
      if (tid == 0) issue(i - stages, 0, NC);
    }
  }
  // probe: apply
}

template <typename T, int VAR>
__global__ void __launch_bounds__(kThreads, 1) bn_fwd_kernel(Args a) {
  run<T, VAR>(a);
}

template <typename T, int VAR>
__global__ void __launch_bounds__(kThreads, 1) bn_bwd_kernel(Args a) {
  run<T, VAR>(a);
}

template <typename T>
const void* kernel_of(int v) {
  switch (v) {
    case kFwd: return (const void*)bn_fwd_kernel<T, kFwd>;
    case kFwdRelu: return (const void*)bn_fwd_kernel<T, kFwdRelu>;
    case kFwdRes: return (const void*)bn_fwd_kernel<T, kFwdRes>;
    case kFwdResRelu: return (const void*)bn_fwd_kernel<T, kFwdResRelu>;
    case kBwd: return (const void*)bn_bwd_kernel<T, kBwd>;
    case kBwdRelu: return (const void*)bn_bwd_kernel<T, kBwdRelu>;
    case kBwdResRelu: return (const void*)bn_bwd_kernel<T, kBwdResRelu>;
    default: return nullptr;
  }
}

inline const void* kernel_for(int dtype, int v) {
  return dtype == kBF16 ? kernel_of<__nv_bfloat16>(v) : kernel_of<float>(v);
}

inline int vec_of(int dtype) { return dtype == kBF16 ? 8 : 4; }

// the shared memory before the ring: mbarriers, the row-group sums and
// their shares
inline long long fixed_smem(int dtype) {
  return kBarBytes + (long long)kThreads * (vec_of(dtype) + 1) * sizeof(float);
}

enum PlanField {
  kGrid = 0, kSmem, kStages, kTileRows, kResident, kScratch, kPerSm, kSms,
  kPlanFields
};

cudaError_t launch(int dtype, int v, const Args& a, const long long* plan,
                   cudaStream_t st) {
  Args args = a;
  void* params[] = {&args};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      kernel_for(dtype, v), dim3((unsigned)plan[kGrid]), dim3(kThreads),
      params, (size_t)plan[kSmem], st);
  // a refused launch also sets the thread's last error: clear it, so that
  // the next launch's cudaGetLastError() does not report it again
  if (e != cudaSuccess) {
    cudaGetLastError();
    return e;
  }
  return cudaGetLastError();
}

}  // namespace dl4j_bn

// The launch plan of `variant` (0 forward, 1 forward relu, 2 forward res,
// 3 forward res relu, 4 backward, 5 backward relu, 6 backward res relu)
// over [m, c] in `dtype` (0 f32, 2 bf16) on the current device: out[0] the
// grid (co-resident CTAs), out[1] dynamic shared memory bytes, out[2] ring
// stages, out[3] rows a tile, out[4] 1 when each CTA's slab is resident in
// the ring, out[5] the f32 scratch the launch needs ([grid, 2, c] partials
// and [2, c] coefficients), out[6] CTAs an SM, out[7] SMs. Takes c a
// multiple of the 16-byte vector and at most kThreads vectors. Returns a
// cudaError_t.
extern "C" int batchnorm_plan(long long m, int c, int dtype, int variant,
                              long long* out) {
  using namespace dl4j_bn;
  if ((dtype != kF32 && dtype != kBF16) || variant < 0 ||
      variant >= kVariants || m < 1 || c < 1)
    return (int)cudaErrorInvalidValue;
  const int vec = vec_of(dtype);
  if (c % vec || c / vec > kThreads) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, max_smem = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&max_smem,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const void* kern = kernel_for(dtype, variant);
  // the opt-in ceiling, so that no plan lowers it below what another
  // shape's cached plan launches with
  if ((e = cudaFuncSetAttribute(kern,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                max_smem)) != cudaSuccess)
    return (int)e;
  const long long fixed = fixed_smem(dtype), budget = max_smem - fixed;
  const long long slots = slots_of(variant);
  const long long row_bytes = (long long)c * (16 / vec);
  const long long rows_max = (m + sms - 1) / sms;
  long long tr = kTileBytes / row_bytes;
  if (tr < 1) tr = 1;
  const long long ntiles = (rows_max + tr - 1) / tr;
  const long long even = (rows_max + ntiles - 1) / ntiles;
  long long stages, resident;
  if (ntiles <= kMaxStages && ntiles * even * row_bytes * slots <= budget) {
    stages = ntiles;
    tr = even;
    resident = 1;
  } else {
    stages = budget / (tr * row_bytes * slots);
    if (stages > kMaxStages) stages = kMaxStages;
    resident = 0;
    if (stages < 2) return (int)cudaErrorInvalidValue;
  }
  const long long smem = fixed + stages * tr * row_bytes * slots;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, (size_t)smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long grid = (long long)per_sm * sms;
  const long long vals[kPlanFields] = {grid,     smem,
                                       stages,   tr,
                                       resident, 2LL * c * grid + 2LL * c,
                                       per_sm,   sms};
  for (int i = 0; i < kPlanFields; ++i) out[i] = vals[i];
  return 0;
}

// Forward on x [m, c] (dtype 0 f32, 2 bf16): y like x and stats [3, c]
// f32 (mean, var, rstd). res (like x) is given for variants 2 and 3 and
// null otherwise; gamma, beta [c] in gdtype (0 f32, 2 bf16); shift [c]
// f32; scratch: plan[5] f32. One cooperative launch on `stream`, no
// synchronisation. Returns a cudaError_t.
extern "C" int batchnorm_fwd(const void* x, const void* res,
                             const void* gamma, const void* beta,
                             const float* shift, void* y, float* stats,
                             float* scratch, const long long* plan,
                             long long m, int c, int dtype, int gdtype,
                             int variant, float eps, void* stream) {
  using namespace dl4j_bn;
  const bool has_res = variant == kFwdRes || variant == kFwdResRelu;
  if (variant < kFwd || variant > kFwdResRelu || has_res != (res != nullptr) ||
      (dtype != kF32 && dtype != kBF16) || (gdtype != kF32 && gdtype != kBF16))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.in[0] = x;
  a.in[1] = res;
  a.gamma = gamma;
  a.beta = beta;
  a.shift = shift;
  a.stats = stats;
  a.out0 = y;
  a.partial = scratch;
  a.coef = scratch + 2LL * c * plan[kGrid];
  a.m = m;
  a.c = c;
  a.gbf16 = gdtype == kBF16;
  a.stages = (int)plan[kStages];
  a.tile_rows = (int)plan[kTileRows];
  a.eps = eps;
  return (int)launch(dtype, variant, a, plan,
                     static_cast<cudaStream_t>(stream));
}

// Backward: dx like x, dgb [2, c] (dgamma, dbeta) in gdtype, and for
// variant 6 the masked dy into dres (like x; y, the tail's output, then
// required). mean, rstd [c] f32 from the forward; beta is read by variant
// 5 (the mask recomputed from x). Returns a cudaError_t.
extern "C" int batchnorm_bwd(const void* dy, const void* x, const void* y,
                             const void* gamma, const void* beta,
                             const float* mean, const float* rstd, void* dx,
                             void* dres, void* dgb, float* scratch,
                             const long long* plan, long long m, int c,
                             int dtype, int gdtype, int variant,
                             void* stream) {
  using namespace dl4j_bn;
  if (variant < kBwd || variant > kBwdResRelu ||
      (dtype != kF32 && dtype != kBF16) || (gdtype != kF32 && gdtype != kBF16) ||
      (variant == kBwdRelu && beta == nullptr) ||
      (variant == kBwdResRelu && (y == nullptr || dres == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.in[0] = dy;
  a.in[1] = x;
  a.in[2] = y;
  a.gamma = gamma;
  a.beta = beta;
  a.mean = mean;
  a.rstd = rstd;
  a.out0 = dx;
  a.dres = dres;
  a.dgb = dgb;
  a.partial = scratch;
  a.coef = scratch + 2LL * c * plan[kGrid];
  a.m = m;
  a.c = c;
  a.gbf16 = gdtype == kBF16;
  a.stages = (int)plan[kStages];
  a.tile_rows = (int)plan[kTileRows];
  return (int)launch(dtype, variant, a, plan,
                     static_cast<cudaStream_t>(stream));
}

// ---- the general route: any C >= 1, f32 / f16 / bf16, any alignment ----
//
// The fused kernel above takes C in whole 16-byte vectors, one vector a
// thread of one CTA (C at most 512 vectors), f32 or bf16, on 16-byte
// aligned rows. Every other batch norm the JAX package computes (an RGB
// input's C = 3, LeNet's 20 and 50 channels, C above 4096 bf16 / 2048 f32,
// f16 activations or parameters) takes this route: three plain launches a
// direction, one element a thread, with the fused kernel's arithmetic and
// its determinism (fixed grid, fixed summation orders, no atomics):
//   stats:    CTA (bx, by) sums its row chunk [bx M / GX, (bx+1) M / GX) of
//             channels [by L, by L + L), L = min(C, 32): thread (rg, l)
//             adds rows rg, rg + 256 / L, ... of channel by L + l in f32,
//             then thread l adds the row groups in order into the CTA's
//             partial [bx, 2, C];
//   finalize: one thread a channel adds the GX partials in order in f64
//             and writes the statistics (forward), dgamma / dbeta
//             (backward) and the coefficients rounded to x's dtype;
//   apply:    one element a thread (grid-stride), y (or dx, dres) with
//             the fused kernel's rounded operations in f32.
// Bound by bytes like the fused kernel; it reads x (dy) twice from device
// memory or L2 and its loads are not vectorised, so it is slower; it exists
// so that the card computes every shape the reference computes.
namespace dl4j_bn_gen {

constexpr int kF32 = 0, kF16 = 1, kBF16 = 2;
constexpr int kGenThreads = 256;
using dl4j_bn::kFwd;
using dl4j_bn::kFwdRelu;
using dl4j_bn::kFwdRes;
using dl4j_bn::kFwdResRelu;
using dl4j_bn::kBwd;
using dl4j_bn::kBwdRelu;
using dl4j_bn::kBwdResRelu;

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __half* p, long long i) {
  return __half2float(p[i]);
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
template <typename T> __device__ __forceinline__ T to(float v);
template <> __device__ __forceinline__ float to<float>(float v) { return v; }
template <> __device__ __forceinline__ __half to<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 to<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T's precision, as a float
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__half>(float v) {
  return __half2float(__float2half_rn(v));
}
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a per-channel parameter in its own dtype (gd: 0 f32, 1 f16, 2 bf16)
__device__ __forceinline__ float param(const void* p, int gd, long long i) {
  return gd == kF32 ? static_cast<const float*>(p)[i]
         : gd == kF16 ? __half2float(static_cast<const __half*>(p)[i])
                      : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}
__device__ __forceinline__ void store_param(void* p, int gd, long long i,
                                            float v) {
  if (gd == kF32)
    static_cast<float*>(p)[i] = v;
  else if (gd == kF16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

struct GenArgs {
  const void* x;      // forward x; backward x
  const void* dy;     // backward dy
  const void* res;    // forward res (variants 2, 3)
  const void* y;      // backward res_relu: the tail's output
  const void* gamma;
  const void* beta;
  const float* shift;  // forward: the shift hint [c]
  const float* mean;   // backward: the forward's statistics [c]
  const float* rstd;
  float* stats;        // forward: mean, var, rstd [3, c]
  void* out0;          // forward y; backward dx
  void* dres;          // backward res_relu: the masked dy
  void* dgb;           // backward: dgamma, dbeta [2, c] in gamma's dtype
  float* partial;      // [gx, 2, c]
  float* coef;         // [2, c]
  long long m;
  int c, gx, gd, var;
  float eps;
};

// dy of element i, masked where the BN output is not positive: by the
// tail's saved output (res_relu) or by y = x * scale + shift recomputed
// with the forward's rounded operations (relu)
template <typename T>
__device__ __forceinline__ float masked_dy(const GenArgs& a, long long i,
                                           float x, float kT, float shT) {
  const float g = ld(static_cast<const T*>(a.dy), i);
  if (a.var == kBwdResRelu)
    return ld(static_cast<const T*>(a.y), i) > 0.f ? g : 0.f;
  if (a.var == kBwdRelu)
    return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, kT)), shT)) > 0.f ? g : 0.f;
  return g;
}

template <typename T>
__global__ void __launch_bounds__(kGenThreads) bn_gen_stats(GenArgs a) {
  __shared__ float red[2][kGenThreads];
  const int c = a.c, lanes = c < 32 ? c : 32, rgs = kGenThreads / lanes;
  const int tid = threadIdx.x, l = tid % lanes, rg = tid / lanes;
  const int ch = blockIdx.y * lanes + l;
  const bool active = rg < rgs && ch < c;
  const long long r0 = a.m * blockIdx.x / a.gx;
  const long long r1 = a.m * (blockIdx.x + 1) / a.gx;
  const bool bwd = a.var >= kBwd;
  float ctr = 0.f, rs = 0.f, kT = 0.f, shT = 0.f;
  if (active) {
    if (!bwd) {
      ctr = a.shift[ch];
    } else {
      ctr = a.mean[ch];
      rs = a.rstd[ch];
      const float scale = __fmul_rn(param(a.gamma, a.gd, ch), rs);
      kT = rnd<T>(scale);
      if (a.var == kBwdRelu)
        shT = rnd<T>(__fsub_rn(param(a.beta, a.gd, ch), __fmul_rn(ctr, scale)));
    }
  }
  float s1 = 0.f, s2 = 0.f;
  if (active) {
    for (long long r = r0 + rg; r < r1; r += rgs) {
      const long long i = r * c + ch;
      const float x = ld(static_cast<const T*>(a.x), i);
      if (!bwd) {
        const float d = __fsub_rn(x, ctr);
        s1 = __fadd_rn(s1, d);
        s2 = __fadd_rn(s2, __fmul_rn(d, d));
      } else {
        const float g = masked_dy<T>(a, i, x, kT, shT);
        const float xhat = __fmul_rn(__fsub_rn(x, ctr), rs);
        s1 = __fadd_rn(s1, g);
        s2 = __fadd_rn(s2, __fmul_rn(g, xhat));
      }
    }
  }
  red[0][tid] = s1;
  red[1][tid] = s2;
  __syncthreads();
  if (tid < lanes && ch < c) {
    float q0 = 0.f, q1 = 0.f;
    for (int g = 0; g < rgs; ++g) {
      q0 = __fadd_rn(q0, red[0][g * lanes + tid]);
      q1 = __fadd_rn(q1, red[1][g * lanes + tid]);
    }
    float* mine = a.partial + 2LL * c * blockIdx.x;
    mine[ch] = q0;
    mine[c + ch] = q1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kGenThreads) bn_gen_finalize(GenArgs a) {
  const int c = a.c;
  const long long ch = (long long)blockIdx.x * kGenThreads + threadIdx.x;
  if (ch >= c) return;
  double q0 = 0.0, q1 = 0.0;
  for (int g = 0; g < a.gx; ++g) {
    q0 += (double)a.partial[2LL * c * g + ch];
    q1 += (double)a.partial[2LL * c * g + c + ch];
  }
  const float n = (float)a.m;
  if (a.var < kBwd) {
    const float m1 = __fdiv_rn((float)q0, n);
    const float m2 = __fdiv_rn((float)q1, n);
    const float mean = __fadd_rn(a.shift[ch], m1);
    const float var = fmaxf(__fsub_rn(m2, __fmul_rn(m1, m1)), 0.f);
    const float r = rsqrtf(__fadd_rn(var, a.eps));
    const float scale = __fmul_rn(param(a.gamma, a.gd, ch), r);
    const float shift =
        __fsub_rn(param(a.beta, a.gd, ch), __fmul_rn(mean, scale));
    a.stats[ch] = mean;
    a.stats[c + ch] = var;
    a.stats[2LL * c + ch] = r;
    a.coef[ch] = rnd<T>(scale);
    a.coef[c + ch] = rnd<T>(shift);
  } else {
    const float db = (float)q0, dg = (float)q1;
    store_param(a.dgb, a.gd, ch, dg);
    store_param(a.dgb, a.gd, c + ch, db);
    a.coef[ch] = rnd<T>(__fdiv_rn(db, n));
    a.coef[c + ch] = rnd<T>(__fdiv_rn(dg, n));
  }
}

template <typename T>
__global__ void __launch_bounds__(kGenThreads) bn_gen_apply(GenArgs a) {
  const long long total = a.m * a.c;
  const long long stride = (long long)gridDim.x * kGenThreads;
  const bool bwd = a.var >= kBwd;
  const bool res = a.var == kFwdRes || a.var == kFwdResRelu;
  const bool relu = a.var == kFwdRelu || a.var == kFwdResRelu;
  for (long long i = (long long)blockIdx.x * kGenThreads + threadIdx.x;
       i < total; i += stride) {
    const int ch = (int)(i % a.c);
    const float x = ld(static_cast<const T*>(a.x), i);
    const float ca = __ldg(a.coef + ch), cb = __ldg(a.coef + a.c + ch);
    float o;
    if (!bwd) {
      o = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(x, ca)), cb));
      if (res) o = rnd<T>(__fadd_rn(o, ld(static_cast<const T*>(a.res), i)));
      if (relu) o = o < 0.f ? 0.f : o;   // NaN stays NaN, as jnp.maximum
    } else {
      const float mean = __ldg(a.mean + ch), rs = __ldg(a.rstd + ch);
      const float scale = __fmul_rn(param(a.gamma, a.gd, ch), rs);
      const float kT = rnd<T>(scale);
      const float shT =
          a.var == kBwdRelu
              ? rnd<T>(__fsub_rn(param(a.beta, a.gd, ch), __fmul_rn(mean, scale)))
              : 0.f;
      const float g = masked_dy<T>(a, i, x, kT, shT);
      if (a.var == kBwdResRelu) static_cast<T*>(a.dres)[i] = to<T>(g);
      const float t1 = rnd<T>(__fsub_rn(g, ca));
      const float xhat = __fmul_rn(__fsub_rn(x, mean), rs);
      o = __fmul_rn(kT, __fsub_rn(t1, __fmul_rn(xhat, cb)));
    }
    static_cast<T*>(a.out0)[i] = to<T>(o);
  }
}

template <typename T>
cudaError_t run(const GenArgs& a, cudaStream_t st) {
  const int lanes = a.c < 32 ? a.c : 32;
  const dim3 sgrid((unsigned)a.gx, (unsigned)((a.c + lanes - 1) / lanes));
  bn_gen_stats<T><<<sgrid, kGenThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  bn_gen_finalize<T><<<(a.c + kGenThreads - 1) / kGenThreads, kGenThreads, 0,
                       st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  int dev = 0, sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  const long long total = a.m * a.c;
  long long blocks = (total + kGenThreads - 1) / kGenThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  bn_gen_apply<T><<<(unsigned)blocks, kGenThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// One phase of the general route alone, for batch norm across shards:
// 0 the statistics partials, 1 the finalize, 2 the elementwise pass.
template <typename T>
cudaError_t run_phase(const GenArgs& a, int phase, cudaStream_t st) {
  if (phase == 0) {
    const int lanes = a.c < 32 ? a.c : 32;
    const dim3 sgrid((unsigned)a.gx, (unsigned)((a.c + lanes - 1) / lanes));
    bn_gen_stats<T><<<sgrid, kGenThreads, 0, st>>>(a);
  } else if (phase == 1) {
    bn_gen_finalize<T><<<(a.c + kGenThreads - 1) / kGenThreads, kGenThreads,
                         0, st>>>(a);
  } else {
    int dev = 0, sms = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return e;
    const long long total = a.m * a.c;
    long long blocks = (total + kGenThreads - 1) / kGenThreads;
    if (blocks > 8LL * sms) blocks = 8LL * sms;
    bn_gen_apply<T><<<(unsigned)blocks, kGenThreads, 0, st>>>(a);
  }
  return cudaGetLastError();
}

cudaError_t dispatch(int dtype, const GenArgs& a, cudaStream_t st,
                     int phase = -1) {
  switch (dtype) {
    case kF32: return phase < 0 ? run<float>(a, st)
                                : run_phase<float>(a, phase, st);
    case kF16: return phase < 0 ? run<__half>(a, st)
                                : run_phase<__half>(a, phase, st);
    case kBF16: return phase < 0 ? run<__nv_bfloat16>(a, st)
                                 : run_phase<__nv_bfloat16>(a, phase, st);
    default: return cudaErrorInvalidValue;
  }
}

inline bool dtype_ok(int d) { return d == kF32 || d == kF16 || d == kBF16; }

}  // namespace dl4j_bn_gen

// The general route's forward on x [m, c] (any c >= 1; dtype 0 f32, 1 f16,
// 2 bf16; any alignment): y like x, stats [3, c] f32, res for variants 2
// and 3, gamma / beta [c] in gdtype (0, 1 or 2), shift [c] f32; scratch
// (2 gx + 2) c f32, gx >= 1 the row chunks of the statistics pass. Three
// launches on `stream`, no synchronisation. Returns a cudaError_t.
extern "C" int batchnorm_gen_fwd(const void* x, const void* res,
                                 const void* gamma, const void* beta,
                                 const float* shift, void* y, float* stats,
                                 float* scratch, long long m, int c, int gx,
                                 int dtype, int gdtype, int variant,
                                 float eps, void* stream) {
  using namespace dl4j_bn_gen;
  const bool has_res = variant == kFwdRes || variant == kFwdResRelu;
  if (variant < kFwd || variant > kFwdResRelu || has_res != (res != nullptr) ||
      !dtype_ok(dtype) || !dtype_ok(gdtype) || m < 1 || c < 1 || gx < 1 ||
      gx > 65535)
    return (int)cudaErrorInvalidValue;
  GenArgs a = {};
  a.x = x;
  a.res = res;
  a.gamma = gamma;
  a.beta = beta;
  a.shift = shift;
  a.stats = stats;
  a.out0 = y;
  a.partial = scratch;
  a.coef = scratch + 2LL * c * gx;
  a.m = m;
  a.c = c;
  a.gx = gx;
  a.gd = gdtype;
  a.var = variant;
  a.eps = eps;
  return (int)dispatch(dtype, a, static_cast<cudaStream_t>(stream));
}

// The general route's backward: dx like x, dgb [2, c] (dgamma, dbeta) in
// gdtype, for variant 6 the masked dy into dres (y then required), beta
// read by variant 5; scratch as for the forward. Returns a cudaError_t.
extern "C" int batchnorm_gen_bwd(const void* dy, const void* x, const void* y,
                                 const void* gamma, const void* beta,
                                 const float* mean, const float* rstd,
                                 void* dx, void* dres, void* dgb,
                                 float* scratch, long long m, int c, int gx,
                                 int dtype, int gdtype, int variant,
                                 void* stream) {
  using namespace dl4j_bn_gen;
  if (variant < kBwd || variant > kBwdResRelu || !dtype_ok(dtype) ||
      !dtype_ok(gdtype) || m < 1 || c < 1 || gx < 1 || gx > 65535 ||
      (variant == kBwdRelu && beta == nullptr) ||
      (variant == kBwdResRelu && (y == nullptr || dres == nullptr)))
    return (int)cudaErrorInvalidValue;
  GenArgs a = {};
  a.x = x;
  a.dy = dy;
  a.y = y;
  a.gamma = gamma;
  a.beta = beta;
  a.mean = mean;
  a.rstd = rstd;
  a.out0 = dx;
  a.dres = dres;
  a.dgb = dgb;
  a.partial = scratch;
  a.coef = scratch + 2LL * c * gx;
  a.m = m;
  a.c = c;
  a.gx = gx;
  a.gd = gdtype;
  a.var = variant;
  return (int)dispatch(dtype, a, static_cast<cudaStream_t>(stream));
}

// Batch norm across shards: the general route's three phases as separate
// entry points, so one controller can run the statistics on every shard,
// finalize once over all the shards' partials and apply on every shard.
// Variants as above (0-3 forward, 4-6 backward).
//
// Statistics partials of one shard's rows into partial [gx, 2, c] f32:
// forward, sum(x - center) and sum((x - center)^2) about center = the
// shared shift hint; backward, sum(g) and sum(g * xhat) with g the
// (masked) dy and xhat = (x - center) * rstd about center = the global
// mean (y for variant 6, beta for variant 5, as in batchnorm_gen_bwd).
extern "C" int batchnorm_xs_stats(const void* x, const void* dy,
                                  const void* y, const void* gamma,
                                  const void* beta, const float* center,
                                  const float* rstd, float* partial,
                                  long long m, int c, int gx, int dtype,
                                  int gdtype, int variant, void* stream) {
  using namespace dl4j_bn_gen;
  const bool bwd = variant >= kBwd;
  if (variant < kFwd || variant > kBwdResRelu || !dtype_ok(dtype) ||
      !dtype_ok(gdtype) || m < 1 || c < 1 || gx < 1 || gx > 65535 ||
      center == nullptr || partial == nullptr ||
      (bwd && (dy == nullptr || rstd == nullptr || gamma == nullptr)) ||
      (variant == kBwdRelu && beta == nullptr) ||
      (variant == kBwdResRelu && y == nullptr))
    return (int)cudaErrorInvalidValue;
  GenArgs a = {};
  a.x = x;
  a.dy = dy;
  a.y = y;
  a.gamma = gamma;
  a.beta = beta;
  a.shift = center;
  a.mean = center;
  a.rstd = rstd;
  a.partial = partial;
  a.m = m;
  a.c = c;
  a.gx = gx;
  a.gd = gdtype;
  a.var = variant;
  return (int)dispatch(dtype, a, static_cast<cudaStream_t>(stream), 0);
}

// The finalize over every shard's partials, concatenated in shard order
// into partial [g, 2, c] (summed in that order, in f64), m the rows of
// all the shards. Forward: stats [3, c] (mean, var, rstd) and coef [2, c]
// (scale, shift rounded to the activations' dtype). Backward: dgb [2, c]
// (dgamma, dbeta in gdtype) and coef [2, c] (sum(g) / m, sum(g * xhat) /
// m rounded to the activations' dtype).
extern "C" int batchnorm_xs_finalize(const float* partial, long long m,
                                     int c, int g, const void* gamma,
                                     const void* beta, const float* shift,
                                     float* stats, void* dgb, float* coef,
                                     int dtype, int gdtype, int variant,
                                     float eps, void* stream) {
  using namespace dl4j_bn_gen;
  const bool bwd = variant >= kBwd;
  if (variant < kFwd || variant > kBwdResRelu || !dtype_ok(dtype) ||
      !dtype_ok(gdtype) || m < 1 || c < 1 || g < 1 || partial == nullptr ||
      coef == nullptr ||
      (!bwd && (gamma == nullptr || beta == nullptr || shift == nullptr ||
                stats == nullptr)) ||
      (bwd && dgb == nullptr))
    return (int)cudaErrorInvalidValue;
  GenArgs a = {};
  a.gamma = gamma;
  a.beta = beta;
  a.shift = shift;
  a.stats = stats;
  a.dgb = dgb;
  a.partial = const_cast<float*>(partial);
  a.coef = coef;
  a.m = m;
  a.c = c;
  a.gx = g;
  a.gd = gdtype;
  a.var = variant;
  a.eps = eps;
  return (int)dispatch(dtype, a, static_cast<cudaStream_t>(stream), 1);
}

// The elementwise pass on one shard's rows with the global coefficients:
// forward, out = y from x (+ res, variants 2 and 3); backward, out = dx
// from dy, x, gamma, the global mean and rstd (and dres, the masked dy,
// for variant 6).
extern "C" int batchnorm_xs_apply(const void* x, const void* res,
                                  const void* dy, const void* y,
                                  const void* gamma, const void* beta,
                                  const float* mean, const float* rstd,
                                  const float* coef, void* out, void* dres,
                                  long long m, int c, int dtype, int gdtype,
                                  int variant, void* stream) {
  using namespace dl4j_bn_gen;
  const bool bwd = variant >= kBwd;
  const bool has_res = variant == kFwdRes || variant == kFwdResRelu;
  if (variant < kFwd || variant > kBwdResRelu || !dtype_ok(dtype) ||
      !dtype_ok(gdtype) || m < 1 || c < 1 || coef == nullptr ||
      out == nullptr || has_res != (res != nullptr) ||
      (bwd && (dy == nullptr || mean == nullptr || rstd == nullptr ||
               gamma == nullptr)) ||
      (variant == kBwdRelu && beta == nullptr) ||
      (variant == kBwdResRelu && (y == nullptr || dres == nullptr)))
    return (int)cudaErrorInvalidValue;
  GenArgs a = {};
  a.x = x;
  a.res = res;
  a.dy = dy;
  a.y = y;
  a.gamma = gamma;
  a.beta = beta;
  a.mean = mean;
  a.rstd = rstd;
  a.coef = const_cast<float*>(coef);
  a.out0 = out;
  a.dres = dres;
  a.m = m;
  a.c = c;
  a.gd = gdtype;
  a.var = variant;
  return (int)dispatch(dtype, a, static_cast<cudaStream_t>(stream), 2);
}
