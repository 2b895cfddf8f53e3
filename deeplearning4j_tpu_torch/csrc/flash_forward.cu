// FlashAttention-2 style attention forward (B3) for Hopper (sm_90a).
//
// Replaces the TPU kernel _fwd_kernel
// (deeplearning4j_tpu/kernels/pallas_attention.py:67, called by
// _flash_fwd_impl :219). On the TPU the grid's innermost "arbitrary"
// dimension walks k blocks in order and carries the streaming softmax
// (m, l, acc) in VMEM scratch from one grid step to the next. Hopper CTAs
// run in parallel in no order, so the carry lives inside one CTA instead:
// bf16 / f16 inputs run attention_fwd_core.cuh, one CTA per 64 query
// rows of one b*h looping over 64-key tiles, with m, l and the output
// accumulator in registers and K / V through a TMA ring. Key tiles wholly
// in the causal future are never visited. A ragged T (577) is masked
// inside the kernel: TMA zero-fills the last tiles and no host-side
// padding exists.
//
// Masking is the reference's: masked logits are replaced by the finite
// -1e30, m starts at -1e30 and l at 0, and l is clamped at 1e-20 at the
// end, so a fully masked row yields a finite uniform average (over the
// keys up to the end of its 64-row group) instead of NaN.
//
// What bounds it on H100: at (B=4, H=12, T=2048, D=64, bf16) the function
// moves ~50 MB (~15 us at 3.35 TB/s) and needs ~26 GFLOP after the causal
// skip (~26 us at 989 TF/s), so the data sheet calls it compute-bound. The
// design keeps both products on wgmma with no shared-memory round trip of
// scores or accumulators, and no block-wide barrier in the loop (the ring
// runs on mbarriers); its limit is the register softmax between the two
// products (PERF.md). f32 inputs keep the CUDA-core algorithm below
// (the tensor cores would round them to TF32), with m and l in shared
// memory and the accumulator in registers; so do head dims 128 < D <= 256
// in every dtype (its DMAX = 256 instance on 32-row tiles). Wider heads
// split the output's columns over the grid (attention_wide.cuh).

#include "attention_fwd_core.cuh"
#include "attention_wide.cuh"

namespace dl4j {
namespace {

constexpr int kKeys = 64;        // keys per K/V tile (f32)

// The same algorithm on the CUDA cores, f32 arithmetic: f32 inputs on
// 64-row query tiles, and every dtype at 128 < D <= 256 (DMAX 256) on
// 32-row tiles, its inputs staged as f32.
template <typename T, int DMAX, int ROWS>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ kmask, T* __restrict__ o,
                         float* __restrict__ lse, int h, int t, int d,
                         int causal, float scale) {
  constexpr int KB = kKeys / 16, DC = DMAX / 16, SS = kKeys + 1;
  constexpr int RA = ROWS / 16;
  extern __shared__ __align__(128) float smem[];
  const int bh = blockIdx.y, q0 = blockIdx.x * ROWS;
  const int nq = min(ROWS, t - q0);
  const int kend = causal_end(t, q0, causal);
  const int ds = d + 1;
  float* qs = smem;                       // [ROWS][ds] query rows
  float* kv = qs + ROWS * ds;             // [64][ds] K tile, then V tile
  float* sc = kv + kKeys * ds;            // [ROWS][SS] tile scores → p
  float* row_m = sc + ROWS * SS;          // [ROWS] running max
  float* row_l = row_m + ROWS;            // [ROWS] running denominator
  float* row_a = row_l + ROWS;            // [ROWS] this tile's rescale factor
  const size_t base = (size_t)bh * t * d;
  const float* km = kmask ? kmask + (size_t)(bh / h) * t : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x < ROWS) {
    row_m[threadIdx.x] = kNeg;
    row_l[threadIdx.x] = 0.f;
  }
  stage_rows(qs, q + base + (size_t)q0 * d, nq, ROWS, d, ds);
  float acc[RA][DC] = {};
  for (int j0 = 0; j0 < kend; j0 += kKeys) {
    const int nk = min(kKeys, kend - j0);
    __syncthreads();
    stage_rows(kv, k + base + (size_t)j0 * d, nk, nk, d, ds);
    __syncthreads();
    score_tile<KB, RA>(sc, SS, qs, kv, ds, d, nk, q0, j0, causal, km,
                       scale);
    __syncthreads();
    // online softmax update, one warp per row (rows past nq hold zero
    // queries: finite, never written out)
    for (int r = warp; r < ROWS; r += kThreads / 32) {
      float* row = sc + r * SS;
      float mt = -INFINITY;
      for (int j = lane; j < nk; j += 32) mt = fmaxf(mt, row[j]);
      mt = warp_max(mt);
      const float mp = row_m[r];
      const float mn = fmaxf(mp, mt);
      float s = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(row[j] - mn);
        row[j] = p;
        s += p;
      }
      s = warp_sum(s);
      if (lane == 0) {
        const float alpha = expf(mp - mn);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + s;
        row_m[r] = mn;
      }
    }
    stage_rows(kv, v + base + (size_t)j0 * d, nk, nk, d, ds);
    __syncthreads();
    const int ty = threadIdx.x >> 4;
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const float alpha = row_a[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
    pv_tile<DC>(acc, sc, SS, kv, ds, d, nk);
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    const int r = threadIdx.x;
    const float l = fmaxf(row_l[r], kMinL);
    row_l[r] = l;
    lse[(size_t)bh * t + q0 + r] = row_m[r] + logf(l);
  }
  __syncthreads();
  write_rows<T, DC>(o + base + (size_t)q0 * d, acc, row_l, nq, d);
}

template <typename Kern>
cudaError_t launch(Kern kern, size_t smem, int rows, const void* q,
                   const void* k,
                   const void* v, const void* kmask, void* o, void* lse,
                   int bh, int h, int t, int d, int causal, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using T = typename KernelArg<Kern>::type;
  const dim3 grid((t + rows - 1) / rows, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kmask),
      static_cast<T*>(o), static_cast<float*>(lse), h, t, d, causal, scale);
  return cudaGetLastError();
}

size_t f32_smem(int d, int rows) {
  return sizeof(float) * ((size_t)rows * (d + 1) + (size_t)kKeys * (d + 1) +
                          (size_t)rows * (kKeys + 1) + 3 * (size_t)rows);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* kmask, void* o, void* lse, int bh, int h,
                     int t, int d, int causal, float scale,
                     cudaStream_t stream) {
#define DL4J_ARGS q, k, v, kmask, o, lse, bh, h, t, d, causal, scale, stream
  if (d > kMaxD)   // every dtype: the output's columns split over the grid
    return launch_wide_fwd<T>(DL4J_ARGS);
  if (d > 128)   // every dtype
    return launch(flash_fwd_f32_kernel<T, kMaxD, kWideRows>,
                  f32_smem(d, kWideRows), kWideRows, DL4J_ARGS);
  if constexpr (std::is_same<T, float>::value) {
    const size_t smem = f32_smem(d, kQRows);
    if (d <= 32)
      return launch(flash_fwd_f32_kernel<T, 32, kQRows>, smem, kQRows,
                    DL4J_ARGS);
    if (d <= 64)
      return launch(flash_fwd_f32_kernel<T, 64, kQRows>, smem, kQRows,
                    DL4J_ARGS);
    return launch(flash_fwd_f32_kernel<T, 128, kQRows>, smem, kQRows,
                  DL4J_ARGS);
  } else {
    const FwdArgs a{q, k, v, static_cast<const float*>(kmask), o,
                    static_cast<float*>(lse), h, t, d, causal, scale};
    return dispatch_fwd<T>(a, bh, stream);
  }
#undef DL4J_ARGS
}

}  // namespace
}  // namespace dl4j

// q, k, v, o: [bh, t, d] row-major in `dtype` (0 f32, 1 f16, 2 bf16),
// 16-byte aligned; kmask: [bh / h, t] f32 (1 real / 0 masked) or null;
// lse: [bh, t] f32. Requires t >= 1, d % 8 == 0 (128 < d <= 256: the
// CUDA-core kernel's DMAX = 256 instance; above: attention_wide.cuh).
// Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* kmask, void* o,
                                   void* lse, int bh, int h, int t, int d,
                                   int causal, int dtype, float scale,
                                   void* stream) {
  using namespace dl4j;
  if (t < 1 || d < 8 || d % 8 != 0 || bh < 1 || bh > 65535 ||
      h < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)dispatch<float>(q, k, v, kmask, o, lse, bh, h, t, d, causal,
                                  scale, s);
    case kF16:
      return (int)dispatch<__half>(q, k, v, kmask, o, lse, bh, h, t, d,
                                   causal, scale, s);
    case kBF16:
      return (int)dispatch<__nv_bfloat16>(q, k, v, kmask, o, lse, bh, h, t, d,
                                          causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
