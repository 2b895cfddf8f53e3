// FlashAttention-2 style attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel _fwd_kernel
// (deeplearning4j_tpu/kernels/pallas_attention.py:67, called by
// _flash_fwd_impl :219). On the TPU the grid's innermost "arbitrary" dimension walks k
// blocks in order and carries the streaming softmax (m, l, acc) in VMEM
// scratch from one grid step to the next. Hopper CTAs run in parallel in no
// order, so the carry lives inside one CTA instead: one CTA per
// (b*h, 64-query-row tile) loops over 64-key tiles of K and V staged in
// shared memory, keeping m and l per row in shared memory and the output
// accumulator in f32 registers. Key tiles wholly in the causal future of
// the query tile are never visited. A ragged T (T = 577) is masked inside
// the kernel: the last tiles are partial and no host-side padding exists.
//
// Masking is the reference's: masked logits are replaced by the finite
// -1e30, m starts at -1e30 and l at 0, and l is clamped at 1e-20 at the
// end, so a fully masked row yields a finite uniform average (over the
// tiles this kernel visited) instead of NaN.
//
// What bounds it on H100: at (B=4, H=12, T=2048, D=64, bf16) the function
// moves ~50 MB (~15 us at 3.35 TB/s) and needs ~26 GFLOP after the causal
// skip (~26 us at 989 TF/s), so the data sheet calls it compute-bound. For
// bf16/f16 both products run on the tensor cores (WMMA mma.sync, f32
// accumulation; p rounded to the input type for p . v, as the TPU kernel
// does). Each 64-key tile's scores round-trip through shared memory for
// the masking and the online-softmax update, and the f32 output
// accumulator lives in shared memory so each tile can rescale its rows by
// exp(m_old - m_new) (WMMA hides which thread holds which row). f32 inputs
// run the same algorithm on the CUDA cores, with the accumulator in
// registers. Register-resident accumulators (raw mma.sync or wgmma, whose
// layouts are known), TMA-fed K/V rings and warp specialisation are the
// next steps.

#include "attention_common.cuh"

namespace dl4j {
namespace {

constexpr int kKeys = 64;        // keys per K/V tile
constexpr int kTcSS = kKeys + 4; // tensor-core score row stride (floats)

// bf16 / f16: both products on the tensor cores.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ kmask, T* __restrict__ o,
                        float* __restrict__ lse, int h, int t, int d,
                        int causal, float scale) {
  constexpr int FPW = DMAX / 32 > 0 ? DMAX / 32 : 1;   // output blocks/warp
  extern __shared__ __align__(128) float smem[];
  const int bh = blockIdx.y, q0 = blockIdx.x * kQRows;
  const int nq = min(kQRows, t - q0);
  // the causal horizon of the tile's last row: later key tiles are skipped
  const int kend = causal ? min(t, q0 + kQRows) : t;
  const int dpad = round_up16(d), ld = dpad + 8;
  T* qs = reinterpret_cast<T*>(smem);     // [64][ld] query rows
  T* kv = qs + kQRows * ld;               // [64][ld] K tile, then V tile
  float* sc = reinterpret_cast<float*>(kv + kKeys * ld);   // [64][kTcSS]
  T* pr = reinterpret_cast<T*>(sc);       // p in place: row stride 2*kTcSS
  float* os = sc + kQRows * kTcSS;        // [64][dpad] output accumulator
  float* row_m = os + kQRows * dpad;      // [64] running max
  float* row_l = row_m + kQRows;          // [64] running denominator
  float* row_a = row_l + kQRows;          // [64] this tile's rescale
  const size_t base = (size_t)bh * t * d;
  const float* km = kmask ? kmask + (size_t)(bh / h) * t : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = warp & 3, half = warp >> 2;

  for (int i = threadIdx.x; i < kQRows * dpad; i += kThreads) os[i] = 0.f;
  if (threadIdx.x < kQRows) {
    row_m[threadIdx.x] = kNeg;
    row_l[threadIdx.x] = 0.f;
  }
  stage_tile(qs, q + base + (size_t)q0 * d, nq, kQRows, d, dpad, ld);
  __syncthreads();
  FragA<T> qa[DMAX / 16];
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    if (kk < dpad / 16)
      nvcuda::wmma::load_matrix_sync(qa[kk], qs + rb * 16 * ld + kk * 16, ld);

  for (int j0 = 0; j0 < kend; j0 += kKeys) {
    const int nk = min(kKeys, kend - j0), nkp = round_up16(nk);
    __syncthreads();
    stage_tile(kv, k + base + (size_t)j0 * d, nk, nkp, d, dpad, ld);
    __syncthreads();
    tc_scores<T, DMAX>(sc, kTcSS, 0, qa, kv, ld, dpad, nkp, rb, half);
    __syncthreads();
    // online softmax update, one warp per row: 2 keys per lane; p
    // overwrites its own score row in the input type (zero past nk). A
    // lane's key-mask bits are the same for every row: read them once.
    bool real[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int jl = lane + 32 * i;
      real[i] = jl < nk && (km == nullptr || km[j0 + jl] > 0.f);
    }
    for (int r = warp; r < kQRows; r += kThreads / 32) {
      const float* row = sc + r * kTcSS;
      float sv[2];
      float mt = -INFINITY;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int jl = lane + 32 * i, j = j0 + jl;
        sv[i] = kNeg;
        if (jl < nk) {
          const bool keep = real[i] && (!causal || j <= q0 + r);
          sv[i] = keep ? row[jl] * scale : kNeg;
          mt = fmaxf(mt, sv[i]);
        }
      }
      mt = warp_max(mt);
      const float mp = row_m[r];
      const float mn = fmaxf(mp, mt);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sv[i] = lane + 32 * i < nk ? __expf(sv[i] - mn) : 0.f;
        s += sv[i];
      }
      s = warp_sum(s);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int jl = lane + 32 * i;
        if (jl < nkp) pr[r * 2 * kTcSS + jl] = from_f32<T>(sv[i]);
      }
      if (lane == 0) {
        const float alpha = __expf(mp - mn);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + s;
        row_m[r] = mn;
      }
    }
    stage_tile(kv, v + base + (size_t)j0 * d, nk, nkp, d, dpad, ld);
    __syncthreads();
    for (int i = threadIdx.x; i < kQRows * dpad; i += kThreads)
      os[i] *= row_a[i / dpad];
    __syncthreads();
    FragC acc[FPW];
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      const int cb = half + 2 * f;
      if (cb < dpad / 16)
        nvcuda::wmma::load_matrix_sync(acc[f], os + rb * 16 * dpad + cb * 16,
                                       dpad, nvcuda::wmma::mem_row_major);
    }
    tc_pv<T, FPW>(acc, pr, 2 * kTcSS, 0, kv, ld, dpad, nkp, rb, half);
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      const int cb = half + 2 * f;
      if (cb < dpad / 16)
        nvcuda::wmma::store_matrix_sync(os + rb * 16 * dpad + cb * 16, acc[f],
                                        dpad, nvcuda::wmma::mem_row_major);
    }
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    const int r = threadIdx.x;
    const float l = fmaxf(row_l[r], kMinL);
    row_l[r] = l;
    lse[(size_t)bh * t + q0 + r] = row_m[r] + logf(l);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    o[base + (size_t)(q0 + r) * d + c] = from_f32<T>(os[r * dpad + c] /
                                                     row_l[r]);
  }
}

// f32: the same algorithm on the CUDA cores.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ kmask,
                         float* __restrict__ o, float* __restrict__ lse, int h,
                         int t, int d, int causal, float scale) {
  constexpr int KB = kKeys / 16, DC = DMAX / 16, SS = kKeys + 1;
  extern __shared__ __align__(128) float smem[];
  const int bh = blockIdx.y, q0 = blockIdx.x * kQRows;
  const int nq = min(kQRows, t - q0);
  const int kend = causal ? min(t, q0 + kQRows) : t;
  const int ds = d + 1;
  float* qs = smem;                       // [64][ds] query rows
  float* kv = qs + kQRows * ds;           // [64][ds] K tile, then V tile
  float* sc = kv + kKeys * ds;            // [64][SS] tile scores → p
  float* row_m = sc + kQRows * SS;        // [64] running max
  float* row_l = row_m + kQRows;          // [64] running denominator
  float* row_a = row_l + kQRows;          // [64] this tile's rescale factor
  const size_t base = (size_t)bh * t * d;
  const float* km = kmask ? kmask + (size_t)(bh / h) * t : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x < kQRows) {
    row_m[threadIdx.x] = kNeg;
    row_l[threadIdx.x] = 0.f;
  }
  stage_rows(qs, q + base + (size_t)q0 * d, nq, kQRows, d, ds);
  float acc[4][DC] = {};
  for (int j0 = 0; j0 < kend; j0 += kKeys) {
    const int nk = min(kKeys, kend - j0);
    __syncthreads();
    stage_rows(kv, k + base + (size_t)j0 * d, nk, nk, d, ds);
    __syncthreads();
    score_tile<KB>(sc, SS, qs, kv, ds, d, nk, q0, j0, causal, km, scale);
    __syncthreads();
    // online softmax update, one warp per row (rows past nq hold zero
    // queries: finite, never written out)
    for (int r = warp; r < kQRows; r += kThreads / 32) {
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
    for (int a = 0; a < 4; ++a) {
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
  write_rows<float, DC>(o + base + (size_t)q0 * d, acc, row_l, nq, d);
}

template <typename Kern>
cudaError_t launch(Kern kern, size_t smem, const void* q, const void* k,
                   const void* v, const void* kmask, void* o, void* lse,
                   int bh, int h, int t, int d, int causal, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  using T = typename KernelArg<Kern>::type;
  const dim3 grid((t + kQRows - 1) / kQRows, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kmask),
      static_cast<T*>(o), static_cast<float*>(lse), h, t, d, causal, scale);
  return cudaGetLastError();
}

size_t f32_smem(int d) {
  return sizeof(float) * (2 * (size_t)kQRows * (d + 1) +
                          (size_t)kQRows * (kKeys + 1) + 3 * kQRows);
}

size_t tc_smem(int d, size_t elem) {
  const size_t dpad = round_up16(d);
  return elem * (size_t)(kQRows + kKeys) * (dpad + 8) +
         sizeof(float) * ((size_t)kQRows * (kTcSS + dpad) + 3 * kQRows);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* kmask, void* o, void* lse, int bh, int h,
                     int t, int d, int causal, float scale,
                     cudaStream_t stream) {
#define DL4J_ARGS q, k, v, kmask, o, lse, bh, h, t, d, causal, scale, stream
  if constexpr (std::is_same<T, float>::value) {
    if (d <= 32)
      return launch(flash_fwd_f32_kernel<32>, f32_smem(d), DL4J_ARGS);
    if (d <= 64)
      return launch(flash_fwd_f32_kernel<64>, f32_smem(d), DL4J_ARGS);
    return launch(flash_fwd_f32_kernel<128>, f32_smem(d), DL4J_ARGS);
  } else {
    const size_t smem = tc_smem(d, sizeof(T));
    if (d <= 32)
      return launch(flash_fwd_tc_kernel<T, 32>, smem, DL4J_ARGS);
    if (d <= 64)
      return launch(flash_fwd_tc_kernel<T, 64>, smem, DL4J_ARGS);
    return launch(flash_fwd_tc_kernel<T, 128>, smem, DL4J_ARGS);
  }
#undef DL4J_ARGS
}

}  // namespace
}  // namespace dl4j

// q, k, v, o: [bh, t, d] row-major in `dtype` (0 f32, 1 f16, 2 bf16),
// 16-byte aligned; kmask: [bh / h, t] f32 (1 real / 0 masked) or null;
// lse: [bh, t] f32. Requires t >= 1, d % 8 == 0, d <= 128.
// Returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* kmask, void* o,
                                   void* lse, int bh, int h, int t, int d,
                                   int causal, int dtype, float scale,
                                   void* stream) {
  using namespace dl4j;
  if (t < 1 || d < 8 || d > 128 || d % 8 != 0 || bh < 1 || bh > 65535 ||
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
