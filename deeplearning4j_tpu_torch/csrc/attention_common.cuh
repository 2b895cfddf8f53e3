// Device helpers shared by the attention kernels.
//
// The CUDA-core (f32 arithmetic) forward variants (shortseq_fwd_f32_kernel,
// flash_fwd_f32_kernel) and backwards (attention_bwd_common.cuh: B2, B4,
// B5) use what remains here: f32 inputs at every head dim, and every dtype
// at 128 < D <= 256 (the DMAX = 256 instance, on 32-row tiles). The bf16 /
// f16 kernels up to D 128 have their own register-resident cores,
// attention_fwd_core.cuh and attention_bwd_core.cuh, and take only the
// constants and conversions.
//
// - Constants: kNeg (the finite mask value), kMinL (the clamp of l),
//   kThreads / kQRows (256-thread CTAs of 64 query rows), DType codes.
// - CUDA-core (f32) helpers: stage_rows (rows of any dtype staged as f32
//   with an odd row stride d + 1, so 16 lanes reading one column of 16
//   rows hit 16 banks), score_tile, pv_tile and write_rows on a 16 x 16
//   thread grid (tx over keys or output columns, ty over query rows; RA =
//   rows / 16 query rows a thread: 4 on 64-row tiles, 2 on 32-row ones),
//   causal_end, warp_max / warp_sum.
//
// Scores, softmax statistics and output accumulators are f32 in all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace dl4j {

// The reference's mask value: masked logits are REPLACED by this finite
// number (never -inf), so a fully masked row averages uniformly instead of
// producing NaN.
constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kQRows = 64;        // query rows per CTA
constexpr float kMinL = 1e-20f;   // softmax denominator clamp

enum DType { kF32 = 0, kF16 = 1, kBF16 = 2 };

// The widest head dim a whole-row kernel takes (wider heads split the
// output's columns: attention_wide.cuh): 128 < D <= kMaxD runs the DMAX = 256
// instance of the CUDA-core kernels on kWideRows-row tiles (64 rows of
// 256 columns would not fit the shared memory of the backward, nor the
// shortseq forward's score block at T 512, nor the dk / dv accumulators
// in a thread's 255 registers).
constexpr int kMaxD = 256;
constexpr int kWideRows = 32;

// The key a tile of query rows starting at q0 reaches (exclusive): its
// 64-row group's causal horizon, so a tile of 32 rows averages a fully
// masked row over the same keys as a 64-row tile does.
__device__ __forceinline__ int causal_end(int t, int q0, int causal) {
  return causal ? min(t, q0 / kQRows * kQRows + kQRows) : t;
}

// The biased kernels' extra operands (attention_bias_fwd_kernel,
// attention_bias_bwd_kernel, attention_bias_dbias_kernel): an additive f32
// logit bias [np, h, t, t], whose (p, head) block batch row bh reads at
// p = (bh / h) mod np, and in the backward its gradient dbias, written by
// the dbias kernel as [ng, np, h, t, t] partial sums over ng groups of the
// batch rows that share a block (the caller sums them).
struct BiasArgs {
  const float* bias;
  float* dbias;
  int np;
};

// Offset of batch row bh's [t, t] block in a BiasArgs tensor.
__device__ __forceinline__ size_t bias_block(int bh, int h, int t, int np) {
  return ((size_t)((bh / h) % np) * h + bh % h) * (size_t)t * t;
}

// Bias entries (r, j) and (r, j + 1) of a [t, t] block in log2 units, 0
// past t (one 8-byte load where t is even, so the pair is aligned).
__device__ __forceinline__ float2 bias_pair(const float* blk, int t, int r,
                                            int j) {
  float2 v = make_float2(0.f, 0.f);
  if (r < t) {
    const float* p = blk + (size_t)r * t + j;
    if ((t & 1) == 0 && j + 1 < t) {
      v = __ldg(reinterpret_cast<const float2*>(p));
    } else {
      if (j < t) v.x = __ldg(p);
      if (j + 1 < t) v.y = __ldg(p + 1);
    }
  }
  constexpr float kL2e = 1.4426950408889634f;
  return make_float2(v.x * kL2e, v.y * kL2e);
}

// The element type T of a kernel whose first parameter is const T*.
template <typename F>
struct KernelArg;
template <typename T, typename... Rest>
struct KernelArg<void (*)(const T*, Rest...)> {
  using type = T;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- CUDA-core (f32) variant ----

// Copy rows [0, nrows) of a row-major [*, d] tensor into shared memory as
// f32 with row stride ds; rows [nrows, cap_rows) are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int nrows,
                                           int cap_rows, int d, int ds) {
  for (int i = threadIdx.x; i < cap_rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    dst[r * ds + c] = r < nrows ? to_f32(src[(size_t)r * d + c]) : 0.f;
  }
}

// sc[r * ss + jl] = scale * (q_r . k_jl), for the 16 RA staged query rows
// and the nk staged keys jl < nk of a tile starting at absolute key j0,
// with the reference's masking: a key in the causal future of query
// q0 + r, or one whose key-mask entry is 0, gets kNeg. Each thread
// computes an RA x KB register tile (rows ty + 16a, keys tx + 16b),
// reading each staged element once per RA (or KB) multiply-adds.
template <int KB, int RA = 4>
__device__ __forceinline__ void score_tile(float* sc, int ss, const float* qs,
                                           const float* ks, int ds, int d,
                                           int nk, int q0, int j0, int causal,
                                           const float* km, float scale) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[RA][KB];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < KB; ++b) acc[a][b] = 0.f;
  for (int c = 0; c < d; ++c) {
    float qa[RA], kb[KB];
#pragma unroll
    for (int a = 0; a < RA; ++a) qa[a] = qs[(ty + 16 * a) * ds + c];
#pragma unroll
    for (int b = 0; b < KB; ++b) kb[b] = ks[(tx + 16 * b) * ds + c];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < KB; ++b) acc[a][b] = fmaf(qa[a], kb[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < KB; ++b) {
      const int jl = tx + 16 * b;
      if (jl < nk) {
        const int j = j0 + jl;
        const bool keep = (!causal || j <= q0 + r) &&
                          (km == nullptr || km[j] > 0.f);
        sc[r * ss + jl] = keep ? acc[a][b] * scale : kNeg;
      }
    }
  }
}

// acc[a][c] += sum_{jl < nk} p[ty + 16a][jl] * v[jl][tx + 16c] over one
// staged value tile (probabilities p in sc with row stride ss).
template <int DC, int RA>
__device__ __forceinline__ void pv_tile(float (&acc)[RA][DC], const float* sc,
                                        int ss, const float* vs, int ds, int d,
                                        int nk) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int jl = 0; jl < nk; ++jl) {
    float pa[RA], vb[DC];
#pragma unroll
    for (int a = 0; a < RA; ++a) pa[a] = sc[(ty + 16 * a) * ss + jl];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      vb[c] = col < d ? vs[jl * ds + col] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(pa[a], vb[c], acc[a][c]);
  }
}

// o[row] = acc / l for the CTA's real query rows (r < nq).
template <typename T, int DC, int RA>
__device__ __forceinline__ void write_rows(T* o, const float (&acc)[RA][DC],
                                           const float* row_l, int nq, int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + 16 * a;
    if (r >= nq) continue;
    const float l = row_l[r];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) o[(size_t)r * d + col] = from_f32<T>(acc[a][c] / l);
    }
  }
}

}  // namespace dl4j
