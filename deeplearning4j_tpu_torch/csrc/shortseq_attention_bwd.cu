// Short-sequence attention backward for Hopper (sm_90a): dq, dk and dv
// from one launch.
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
// tiles from the causal diagonal down and accumulates dk and dv on chip,
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
// FLOP per visible query-key pair (~33 us at 989 TF/s), so the data sheet
// calls it memory-bound. The tile arithmetic (attention_bwd_common.cuh)
// runs every product through WMMA; s and p are computed twice per tile
// pair (once by each role), and every tile round-trips through shared
// memory. Register-resident tiles and TMA staging are the next steps.

#include "attention_bwd_common.cuh"

namespace dl4j {
namespace {

// blockIdx.x < tiles: the dkv role for key tile blockIdx.x; otherwise the
// dq role for query tile blockIdx.x - tiles.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    shortseq_bwd_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tiles = num_tiles(a.t);
  if ((int)blockIdx.x < tiles)
    bwd_dkv<T, DMAX>(a, blockIdx.y, blockIdx.x * kKeyTile, smem);
  else
    bwd_dq<T, DMAX>(a, blockIdx.y, (blockIdx.x - tiles) * kQRows, smem);
}

template <typename T>
cudaError_t run(const BwdArgs& a, int bh, cudaStream_t s) {
  const dim3 grid(2 * num_tiles(a.t), bh);
  const size_t smem = bwd_smem<T>(a.d);
  if (a.d <= 32) return launch_bwd(shortseq_bwd_kernel<T, 32>, grid, smem, a, s);
  if (a.d <= 64) return launch_bwd(shortseq_bwd_kernel<T, 64>, grid, smem, a, s);
  return launch_bwd(shortseq_bwd_kernel<T, 128>, grid, smem, a, s);
}

}  // namespace
}  // namespace dl4j

// q, k, v, dout, dq, dk, dv: [bh, t, d] row-major in `dtype` (0 f32, 1 f16,
// 2 bf16), 16-byte aligned; kmask: [bh / h, t] f32 (1 real / 0 masked) or
// null; lse, delta: [bh, t] f32. Requires 1 <= t <= 512, d % 8 == 0,
// d <= 128. Returns cudaGetLastError().
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
