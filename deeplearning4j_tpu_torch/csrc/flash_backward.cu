// Flash attention backward for Hopper (sm_90a): the dq and dkv kernels.
//
// Replace the TPU kernels _dq_kernel and _dkv_kernel
// (deeplearning4j_tpu/kernels/pallas_attention.py:114 and :153, driven by
// _flash_bwd_impl :260). On the TPU each keeps its accumulator in VMEM
// scratch across the grid's innermost "arbitrary" dimension, which walks
// the other operand's blocks in order. Hopper CTAs run in parallel in no
// order, so each kernel's accumulation runs inside one CTA instead:
//
// - flash_attention_bwd_dq: one CTA per (b*h, 64-query tile) loops over
//   64-key tiles up to the causal diagonal, dq accumulated on chip.
// - flash_attention_bwd_dkv: one CTA per (b*h, 64-key tile) loops over
//   64-query tiles from the diagonal to T, dk and dv accumulated on chip.
//
// Both recompute p from the saved lse and take delta = rowsum(dO . O) from
// the caller, who may pass the global row term (the sequence-parallel ring
// backward does). The tile-pair arithmetic is shared with the
// short-sequence backward (attention_bwd_common.cuh).
//
// What bounds them on H100: at (B=4, H=12, T=2048, D=64, bf16, causal)
// the dq kernel needs ~6 * D FLOP per visible query-key pair (~39 us at
// 989 TF/s) against ~25 MB of q, k, v, dO and dq (~8 us at 3.35 TB/s),
// and the dkv kernel ~8 * D per pair (~52 us) against ~38 MB: both are
// compute-bound by the data sheet. This first version runs every product
// through WMMA with the s / dP tiles and the 16-bit p / ds tiles
// round-tripping through shared memory; register-resident tiles (raw
// mma.sync or wgmma with known layouts) and TMA-fed operand rings are the
// next steps.

#include "attention_bwd_common.cuh"

namespace dl4j {
namespace {

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bwd_dq<T, DMAX>(a, blockIdx.y, blockIdx.x * kQRows, smem);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bwd_dkv<T, DMAX>(a, blockIdx.y, blockIdx.x * kKeyTile, smem);
}

template <typename T>
cudaError_t run(bool dq, const BwdArgs& a, int bh, cudaStream_t s) {
  const dim3 grid(num_tiles(a.t), bh);
  const size_t smem = bwd_smem<T>(a.d);
  if (a.d <= 32)
    return dq ? launch_bwd(flash_dq_kernel<T, 32>, grid, smem, a, s)
              : launch_bwd(flash_dkv_kernel<T, 32>, grid, smem, a, s);
  if (a.d <= 64)
    return dq ? launch_bwd(flash_dq_kernel<T, 64>, grid, smem, a, s)
              : launch_bwd(flash_dkv_kernel<T, 64>, grid, smem, a, s);
  return dq ? launch_bwd(flash_dq_kernel<T, 128>, grid, smem, a, s)
            : launch_bwd(flash_dkv_kernel<T, 128>, grid, smem, a, s);
}

int entry(bool dq, const void* q, const void* k, const void* v,
          const void* kmask, const void* dout, const void* lse,
          const void* delta, void* dqp, void* dkp, void* dvp, int bh, int h,
          int t, int d, int causal, int dtype, float scale, void* stream) {
  if (!bwd_shape_ok(bh, h, t, d) || (dq ? dqp == nullptr
                                        : dkp == nullptr || dvp == nullptr))
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, static_cast<const float*>(kmask), dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dqp, dkp, dvp, h, t, d,
                  causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)run<float>(dq, a, bh, s);
    case kF16:
      return (int)run<__half>(dq, a, bh, s);
    case kBF16:
      return (int)run<__nv_bfloat16>(dq, a, bh, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace dl4j

// q, k, v, dout: [bh, t, d] row-major in `dtype` (0 f32, 1 f16, 2 bf16),
// 16-byte aligned; kmask: [bh / h, t] f32 (1 real / 0 masked) or null;
// lse, delta: [bh, t] f32. dq (or dk and dv): [bh, t, d] in `dtype`; the
// outputs an entry does not write may be null. Requires t >= 1,
// d % 8 == 0, d <= 128. Return cudaGetLastError().
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* kmask,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, void* dk,
                                      void* dv, int bh, int h, int t, int d,
                                      int causal, int dtype, float scale,
                                      void* stream) {
  return dl4j::entry(true, q, k, v, kmask, dout, lse, delta, dq, dk, dv, bh,
                     h, t, d, causal, dtype, scale, stream);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* kmask,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dq, void* dk,
                                       void* dv, int bh, int h, int t, int d,
                                       int causal, int dtype, float scale,
                                       void* stream) {
  return dl4j::entry(false, q, k, v, kmask, dout, lse, delta, dq, dk, dv, bh,
                     h, t, d, causal, dtype, scale, stream);
}
