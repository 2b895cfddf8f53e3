// Short-sequence causal attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel _short_fwd_kernel
// (deeplearning4j_tpu/kernels/pallas_shortseq.py:127, called by
// _short_fwd_impl :233), which holds one whole [T, T] logits tile per head in VMEM and runs
// a plain, non-streaming softmax. The TPU grid walks heads in order with
// tens of MB of VMEM; a Hopper CTA has at most 227 KB of shared memory and
// 132 SMs run CTAs in parallel, so the work is cut into one CTA per
// (b*h, 64-query-row tile) and the [T, T] tile becomes that CTA's
// [64, kend] f32 score block (kend = the keys the tile can see: its causal
// horizon, or T).
//
// Per CTA: stage the 64 query rows; stream K through shared memory in key
// tiles and write every score (scaled, masked with the finite -1e30) into
// the score block; one plain max / exp / sum per row (l clamped at 1e-20,
// lse = m + log l); stream V in key tiles and accumulate o = p . v in f32
// registers; write o in the input type and lse as [B*H, T] f32.
//
// What bounds it on H100: at the flagship prefill (B=32, H=12, T=512, D=64,
// bf16) the function moves ~101 MB (q, k, v, o once each) and needs
// ~13 GFLOP after the causal skip: ~30 us at 3.35 TB/s against ~13 us at
// 989 TF/s, so the data sheet calls it memory-bound. For bf16/f16 the two
// products run on the tensor cores (WMMA mma.sync, f32 accumulation; p is
// rounded to the input type for p . v, as the TPU kernel does); the
// scores round-trip through the shared-memory score block, where the
// masking and the softmax happen. K and V are staged in 128-key tiles and
// read from HBM once per query tile (8x at T=512; the re-reads hit the
// 50 MB L2). f32 inputs run the same algorithm on the CUDA cores, 4-8
// multiply-adds per staged element read. The [64, T] f32 score block
// (132 KB at T=512) allows one CTA per SM at T=512, and the measurements
// point to that as the limit: the kernel's time does not drop with the
// causal skip, and the flash kernel (64 x 64 score tiles) is faster at
// T=512 (PERF.md). Register-resident scores (raw mma.sync or wgmma) and
// TMA staging are the next steps.

#include "attention_common.cuh"

namespace dl4j {
namespace {

constexpr int kTcKeys = 128;             // keys per staged tile (16-bit)

// bf16 / f16: both products on the tensor cores.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    shortseq_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ kmask, T* __restrict__ o,
                           float* __restrict__ lse, int h, int t, int d,
                           int causal, float scale) {
  constexpr int FPW = DMAX / 32 > 0 ? DMAX / 32 : 1;   // output blocks/warp
  constexpr int MAXJ = 512 / 32;                        // scores per lane
  extern __shared__ __align__(128) float smem[];
  const int bh = blockIdx.y, q0 = blockIdx.x * kQRows;
  const int nq = min(kQRows, t - q0);
  const int kend = causal ? min(t, q0 + kQRows) : t;
  const int kpad = round_up16(kend), dpad = round_up16(d);
  const int ld = dpad + 8;                // staged row stride (elements)
  const int ss = kpad + 4;                // score row stride (floats)
  T* qs = reinterpret_cast<T*>(smem);     // [64][ld] query rows
  T* kv = qs + kQRows * ld;               // [128][ld] K tile, V tile, o
  float* sc = reinterpret_cast<float*>(kv + kTcKeys * ld);  // [64][ss]
  T* pr = reinterpret_cast<T*>(sc);       // p in place: row stride 2 * ss
  float* row_l = sc + kQRows * ss;        // [64] softmax denominators
  const size_t base = (size_t)bh * t * d;
  const float* km = kmask ? kmask + (size_t)(bh / h) * t : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = warp & 3, half = warp >> 2;

  stage_tile(qs, q + base + (size_t)q0 * d, nq, kQRows, d, dpad, ld);
  __syncthreads();
  FragA<T> qa[DMAX / 16];
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk)
    if (kk < dpad / 16)
      nvcuda::wmma::load_matrix_sync(qa[kk], qs + rb * 16 * ld + kk * 16, ld);
  for (int j0 = 0; j0 < kend; j0 += kTcKeys) {
    const int nk = min(kTcKeys, kend - j0), nkp = round_up16(nk);
    __syncthreads();
    stage_tile(kv, k + base + (size_t)j0 * d, nk, nkp, d, dpad, ld);
    __syncthreads();
    tc_scores<T, DMAX>(sc, ss, j0, qa, kv, ld, dpad, nkp, rb, half);
  }
  __syncthreads();

  // scale, mask and a plain softmax, one warp per row; p overwrites its
  // own score row in the input type (all of a lane's reads land in
  // registers before any write), zero past kend up to the 16-key padding.
  // Lane l handles keys l + 32i; whether each is a real key (j < kend and
  // unmasked) is the same for every row, so it is read once into bits.
  unsigned real = 0;
#pragma unroll
  for (int i = 0; i < MAXJ; ++i) {
    const int j = lane + 32 * i;
    if (j < kend && (km == nullptr || km[j] > 0.f)) real |= 1u << i;
  }
  for (int r = warp; r < kQRows; r += kThreads / 32) {
    const float* row = sc + r * ss;
    float sv[MAXJ];
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < MAXJ; ++i) {
      const int j = lane + 32 * i;
      sv[i] = kNeg;
      if (j < kend) {
        const bool keep = ((real >> i) & 1u) && (!causal || j <= q0 + r);
        sv[i] = keep ? row[j] * scale : kNeg;
        m = fmaxf(m, sv[i]);
      }
    }
    m = warp_max(m);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < MAXJ; ++i) {
      const int j = lane + 32 * i;
      sv[i] = j < kend ? __expf(sv[i] - m) : 0.f;
      s += sv[i];
    }
    s = warp_sum(s);
    const float l = fmaxf(s, kMinL);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < MAXJ; ++i) {
      const int j = lane + 32 * i;
      if (j < kpad) pr[r * 2 * ss + j] = from_f32<T>(r < nq ? sv[i] : 0.f);
    }
    if (lane == 0 && r < nq) {
      row_l[r] = l;
      lse[(size_t)bh * t + q0 + r] = m + logf(l);
    }
  }

  FragC acc[FPW];
#pragma unroll
  for (int f = 0; f < FPW; ++f) nvcuda::wmma::fill_fragment(acc[f], 0.f);
  for (int j0 = 0; j0 < kend; j0 += kTcKeys) {
    const int nk = min(kTcKeys, kend - j0), nkp = round_up16(nk);
    __syncthreads();
    stage_tile(kv, v + base + (size_t)j0 * d, nk, nkp, d, dpad, ld);
    __syncthreads();
    tc_pv<T, FPW>(acc, pr, 2 * ss, j0, kv, ld, dpad, nkp, rb, half);
  }
  __syncthreads();
  float* os = reinterpret_cast<float*>(kv);   // [64][dpad] f32 output
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const int cb = half + 2 * f;
    if (cb < dpad / 16)
      nvcuda::wmma::store_matrix_sync(os + rb * 16 * dpad + cb * 16, acc[f],
                                      dpad, nvcuda::wmma::mem_row_major);
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

size_t tc_smem(int t, int d, size_t elem) {
  const size_t ld = round_up16(d) + 8;
  return elem * (kQRows + kTcKeys) * ld +
         sizeof(float) * ((size_t)kQRows * (round_up16(t) + 4) + kQRows);
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
    const size_t smem = tc_smem(t, d, sizeof(T));
    if (d <= 32)
      return launch(shortseq_fwd_tc_kernel<T, 32>, smem, DL4J_ARGS);
    if (d <= 64)
      return launch(shortseq_fwd_tc_kernel<T, 64>, smem, DL4J_ARGS);
    return launch(shortseq_fwd_tc_kernel<T, 128>, smem, DL4J_ARGS);
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
