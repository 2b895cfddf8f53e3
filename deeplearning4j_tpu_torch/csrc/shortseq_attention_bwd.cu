// Short-sequence attention backward (B2) for Hopper (sm_90a): dq, dk and
// dv from one launch.
//
// Replaces the TPU kernel _short_bwd_kernel
// (deeplearning4j_tpu/kernels/pallas_shortseq.py:160, driven by
// _short_bwd_impl :277), which recomputes s and p once per head from the
// saved lse, with the whole [T, T] tile in VMEM, and writes all three
// gradients from one kernel. A Hopper CTA has at most 227 KB of shared
// memory, so the head is cut into 64 x 64 tile pairs, and dq, which every
// key tile contributes to, needs either a reduction across CTAs or a
// second walk over the key tiles. This kernel takes the second walk: its
// grid holds, for each b*h, one CTA per 64-key tile that walks the query
// tiles from the causal diagonal to T and accumulates dk and dv on chip,
// and one CTA per 64-query tile that walks the key tiles up to the
// diagonal and accumulates dq on chip. Each gradient element is summed by
// one CTA in a fixed order, so the result is the same on every run (f32
// atomics into a dq buffer would save the second recomputation of s and p,
// but their order, and so dq's bits, would change run to run, and they
// would need a [B*H, T, D] f32 buffer and a cast pass).
//
// What bounds it on H100: at the flagship train step (B=32, H=12, T=512,
// D=64, bf16, causal) the function moves ~176 MB (q, k, v, dO, dq, dk, dv
// once each, plus lse and delta: ~53 us at 3.35 TB/s) and needs ~10 * D
// FLOP per visible query-key pair (~33 us at 989 TF/s; the second walk
// makes it 14 * D, ~46 us), so the data sheet calls it memory-bound. bf16
// / f16 inputs run attention_bwd_core.cuh: K / V or Q / dO tiles through a
// TMA ring, all four products of a tile pair on wgmma, and S, dP, p and ds
// in registers only, so each CTA reads its operands once from L2 and
// writes its gradient once. Its dkv and dq CTAs are interleaved in the
// grid, the longest walks of a b*h first. f32 inputs keep the CUDA-core
// kernel of attention_bwd_common.cuh (the tensor cores would round them
// to TF32), and so do head dims 128 < D <= 256 in every dtype (its
// DMAX = 256 instance on 32-row tiles, inputs staged as f32).

#include "attention_bwd_core.cuh"
#include "attention_wide.cuh"

namespace dl4j {
namespace {

// CUDA-core: blockIdx.x < tiles is the dkv role for key tile blockIdx.x;
// otherwise the dq role for query tile blockIdx.x - tiles.
template <typename T, int DMAX, int ROWS>
__global__ void __launch_bounds__(kThreads)
    shortseq_bwd_f32_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles = num_tiles(a.t, ROWS);
  if ((int)blockIdx.x < tiles)
    bwd_dkv_f32<T, DMAX, ROWS>(a, blockIdx.y, blockIdx.x * ROWS, smem);
  else
    bwd_dq_f32<T, DMAX, ROWS>(a, blockIdx.y, (blockIdx.x - tiles) * ROWS,
                              smem);
}

template <typename T>
cudaError_t run(const BwdArgs& a, int bh, cudaStream_t s) {
  if (a.d > kMaxD) {   // every dtype: both roles, columns split
    const cudaError_t err = launch_wide_bwd<T>(false, a, bh, s);
    return err != cudaSuccess ? err : launch_wide_bwd<T>(true, a, bh, s);
  }
  if constexpr (!std::is_same<T, float>::value) {
    if (a.d <= 128) return dispatch_bwd_core<T, kRolesBoth>(a, bh, s);
  }
  const int rows = a.d > 128 ? kWideRows : kQRows;
  const dim3 grid(2 * num_tiles(a.t, rows), bh);
  const size_t smem = bwd_smem(a.d, rows);
  if (a.d > 128)   // every dtype
    return launch_bwd(shortseq_bwd_f32_kernel<T, kMaxD, kWideRows>, grid,
                      smem, a, s);
  if constexpr (std::is_same<T, float>::value) {
    if (a.d <= 32)
      return launch_bwd(shortseq_bwd_f32_kernel<T, 32, kQRows>, grid, smem,
                        a, s);
    if (a.d <= 64)
      return launch_bwd(shortseq_bwd_f32_kernel<T, 64, kQRows>, grid, smem,
                        a, s);
    return launch_bwd(shortseq_bwd_f32_kernel<T, 128, kQRows>, grid, smem, a,
                      s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace dl4j

// q, k, v, dout, dq, dk, dv: [bh, t, d] row-major in `dtype` (0 f32, 1 f16,
// 2 bf16), 16-byte aligned; kmask: [bh / h, t] f32 (1 real / 0 masked) or
// null; lse, delta: [bh, t] f32. Requires 1 <= t <= 512, d % 8 == 0
// (128 < d <= 256: the CUDA-core kernel's DMAX = 256 instance; above:
// attention_wide.cuh's two roles, one launch each).
// Returns cudaGetLastError().
extern "C" int shortseq_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* kmask,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, void* dk,
                                      void* dv, int bh, int h, int t, int d,
                                      int causal, int dtype, float scale,
                                      void* stream) {
  using namespace dl4j;
  if (!bwd_shape_ok(bh, h, t, d) || t > 512 || !dq || !dk || !dv)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, static_cast<const float*>(kmask), dout,
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, dk, dv, h, t, d,
                  causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)run<float>(a, bh, s);
    case kF16:
      return (int)run<__half>(a, bh, s);
    case kBF16:
      return (int)run<__nv_bfloat16>(a, bh, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The biased backward: dq, dk, dv as above from the biased forward's lse
// (attention_bias_bwd_kernel, both roles), then dbias as ng partial sums
// [ng, np, h, t, t] f32 of p (dO . v^T - delta) over the batch rows of
// each block (attention_bias_dbias_kernel; group g sums images g, g + ng,
// ...; the caller sums the groups). Rows are (image, p, head) with head
// fastest: bh a multiple of np * h. No key mask, not causal; bf16 / f16
// only, d <= 128. Every output is the same bits every call.
// Returns cudaGetLastError().
extern "C" int shortseq_attention_bias_bwd(
    const void* q, const void* k, const void* v, const void* bias,
    const void* dout, const void* lse, const void* delta, void* dq,
    void* dk, void* dv, void* dbias, int bh, int h, int t, int d, int np,
    int ng, int dtype, float scale, void* stream) {
  using namespace dl4j;
  if (!bwd_shape_ok(bh, h, t, d) || t > 512 || d > 128 || np < 1 ||
      bh % (np * h) != 0 || ng < 1 || ng > bh / (np * h) || ng > 65535 ||
      !bias || !dbias || !dq || !dk || !dv)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, nullptr, dout, static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, dk, dv, h, t, d, 0,
                  scale};
  const BiasArgs b{static_cast<const float*>(bias),
                   static_cast<float*>(dbias), np};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF16:
      return (int)dispatch_bias_bwd_core<__half>(a, b, bh, ng, s);
    case kBF16:
      return (int)dispatch_bias_bwd_core<__nv_bfloat16>(a, b, bh, ng, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
