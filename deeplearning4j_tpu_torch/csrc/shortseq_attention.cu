// Short-sequence causal attention forward (B1) for Hopper (sm_90a).
//
// Replaces the TPU kernel _short_fwd_kernel
// (deeplearning4j_tpu/kernels/pallas_shortseq.py:127, called by
// _short_fwd_impl :233), which holds one whole [T, T] logits tile per head
// in VMEM and runs a plain, non-streaming softmax. A Hopper SM has 227 KB
// of shared memory and a register file, not tens of MB of VMEM, so the
// whole-row softmax is not carried over: bf16 / f16 inputs run the online
// form of attention_fwd_core.cuh (a TMA ring of K / V tiles, scores,
// softmax and output in registers, both products on wgmma), which
// computes the same function up to rounding. At T = 512 its CTAs of 64
// query rows give 8 per b*h, so the grid fills the card at the flagship's
// B*H; the query tiles of one b*h are grid neighbours (K and V come from
// HBM once and from L2 after), diagonal-heavy tiles first. B3 launches
// the same core: no tile size or ring depth measured better for T <= 512
// alone (PERF.md).
//
// What bounds it on H100: at the flagship prefill (B=32, H=12, T=512, D=64,
// bf16) the function moves ~101 MB (q, k, v, o once each) and needs
// ~13 GFLOP after the causal skip: ~30 us at 3.35 TB/s against ~13 us at
// 989 TF/s, so the data sheet calls it memory-bound. The design reads each
// K / V tile once per 64 query rows from L2, keeps every score on chip,
// and overlaps the next tile's copy with the current tile's products.
//
// f32 inputs keep the CUDA-core algorithm below (the tensor cores would
// round them to TF32): a [64, kend] f32 score block in shared memory, a
// plain max / exp / sum per row, then o = p . v, 4-8 multiply-adds per
// staged element read.

#include "attention_fwd_core.cuh"

namespace dl4j {
namespace {


// f32: the same algorithm on the CUDA cores.
template <int DMAX>
struct F32Tiles {
  static constexpr int kKeys = DMAX <= 64 ? 128 : 64;   // keys per K/V tile
};

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
    shortseq_fwd_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ kmask,
                            float* __restrict__ o, float* __restrict__ lse,
                            int h, int t, int d, int causal, float scale) {
  constexpr int KT = F32Tiles<DMAX>::kKeys;
  constexpr int KB = KT / 16, DC = DMAX / 16;
  extern __shared__ __align__(128) float smem[];
  const int bh = blockIdx.y, q0 = blockIdx.x * kQRows;
  const int nq = min(kQRows, t - q0);
  const int kend = causal ? min(t, q0 + kQRows) : t;
  const int ds = d + 1, ss = kend + 1;
  float* qs = smem;                       // [64][ds] query rows
  float* kv = qs + kQRows * ds;           // [KT][ds] K tile, then V tile
  float* sc = kv + KT * ds;               // [64][ss] scores → probabilities
  float* row_l = sc + kQRows * ss;        // [64] softmax denominators
  const size_t base = (size_t)bh * t * d;
  const float* km = kmask ? kmask + (size_t)(bh / h) * t : nullptr;

  stage_rows(qs, q + base + (size_t)q0 * d, nq, kQRows, d, ds);
  for (int j0 = 0; j0 < kend; j0 += KT) {
    const int nk = min(KT, kend - j0);
    __syncthreads();
    stage_rows(kv, k + base + (size_t)j0 * d, nk, nk, d, ds);
    __syncthreads();
    score_tile<KB>(sc + j0, ss, qs, kv, ds, d, nk, q0, j0, causal, km, scale);
  }
  __syncthreads();

  // plain (non-streaming) softmax, one warp per row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < nq; r += kThreads / 32) {
    float* row = sc + r * ss;
    float m = -INFINITY;
    for (int j = lane; j < kend; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float s = 0.f;
    for (int j = lane; j < kend; j += 32) {
      const float p = expf(row[j] - m);
      row[j] = p;
      s += p;
    }
    s = warp_sum(s);
    const float l = fmaxf(s, kMinL);
    if (lane == 0) {
      row_l[r] = l;
      lse[(size_t)bh * t + q0 + r] = m + logf(l);
    }
  }

  float acc[4][DC] = {};
  for (int j0 = 0; j0 < kend; j0 += KT) {
    const int nk = min(KT, kend - j0);
    __syncthreads();
    stage_rows(kv, v + base + (size_t)j0 * d, nk, nk, d, ds);
    __syncthreads();
    pv_tile<DC>(acc, sc + j0, ss, kv, ds, d, nk);
  }
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

template <int DMAX>
size_t f32_smem(int t, int d) {
  return sizeof(float) * ((size_t)kQRows * (d + 1) +
                          (size_t)F32Tiles<DMAX>::kKeys * (d + 1) +
                          (size_t)kQRows * (t + 1) + kQRows);
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* kmask, void* o, void* lse, int bh, int h,
                     int t, int d, int causal, float scale,
                     cudaStream_t stream) {
#define DL4J_ARGS q, k, v, kmask, o, lse, bh, h, t, d, causal, scale, stream
  if constexpr (std::is_same<T, float>::value) {
    if (d <= 32)
      return launch(shortseq_fwd_f32_kernel<32>, f32_smem<32>(t, d),
                    DL4J_ARGS);
    if (d <= 64)
      return launch(shortseq_fwd_f32_kernel<64>, f32_smem<64>(t, d),
                    DL4J_ARGS);
    return launch(shortseq_fwd_f32_kernel<128>, f32_smem<128>(t, d),
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
// lse: [bh, t] f32. Requires 1 <= t <= 512, d % 8 == 0, d <= 128.
// Returns cudaGetLastError().
extern "C" int shortseq_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* kmask,
                                      void* o, void* lse, int bh, int h, int t,
                                      int d, int causal, int dtype,
                                      float scale, void* stream) {
  using namespace dl4j;
  if (t < 1 || t > 512 || d < 8 || d > 128 || d % 8 != 0 || bh < 1 ||
      bh > 65535 || h < 1)
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
