// Device helpers shared by the attention kernels.
//
// The f32 forward variants (shortseq_fwd_f32_kernel, flash_fwd_f32_kernel)
// and the f32 backwards (attention_bwd_common.cuh: B2, B4, B5) use what
// remains here; the bf16 / f16 kernels have their own register-resident
// cores, attention_fwd_core.cuh and attention_bwd_core.cuh, and take only
// the constants and conversions.
//
// - Constants: kNeg (the finite mask value), kMinL (the clamp of l),
//   kThreads / kQRows (256-thread CTAs of 64 query rows), DType codes.
// - CUDA-core (f32) helpers: stage_rows (f32 rows with an odd row stride
//   d + 1, so 16 lanes reading one column of 16 rows hit 16 banks),
//   score_tile, pv_tile and write_rows on a 16 x 16 thread grid (tx over
//   keys or output columns, ty over query rows), warp_max / warp_sum.
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

// sc[r * ss + jl] = scale * (q_r . k_jl), for the 64 staged query rows and
// the nk staged keys jl < nk of a tile starting at absolute key j0, with
// the reference's masking: a key in the causal future of query q0 + r, or
// one whose key-mask entry is 0, gets kNeg. Each thread computes a 4 x KB
// register tile (rows ty + 16a, keys tx + 16b), reading each staged
// element once per 4 (or KB) multiply-adds.
template <int KB>
__device__ __forceinline__ void score_tile(float* sc, int ss, const float* qs,
                                           const float* ks, int ds, int d,
                                           int nk, int q0, int j0, int causal,
                                           const float* km, float scale) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][KB];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < KB; ++b) acc[a][b] = 0.f;
  for (int c = 0; c < d; ++c) {
    float qa[4], kb[KB];
#pragma unroll
    for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * ds + c];
#pragma unroll
    for (int b = 0; b < KB; ++b) kb[b] = ks[(tx + 16 * b) * ds + c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < KB; ++b) acc[a][b] = fmaf(qa[a], kb[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
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
template <int DC>
__device__ __forceinline__ void pv_tile(float (&acc)[4][DC], const float* sc,
                                        int ss, const float* vs, int ds, int d,
                                        int nk) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int jl = 0; jl < nk; ++jl) {
    float pa[4], vb[DC];
#pragma unroll
    for (int a = 0; a < 4; ++a) pa[a] = sc[(ty + 16 * a) * ss + jl];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      vb[c] = col < d ? vs[jl * ds + col] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(pa[a], vb[c], acc[a][c]);
  }
}

// o[row] = acc / l for the CTA's real query rows (r < nq).
template <typename T, int DC>
__device__ __forceinline__ void write_rows(T* o, const float (&acc)[4][DC],
                                           const float* row_l, int nq, int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
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
