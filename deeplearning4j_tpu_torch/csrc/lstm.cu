// LSTM recurrence forward for Hopper (sm_90a): kernel B6.
//
// Replaces the TPU kernel _make_kernel (deeplearning4j_tpu/kernels/lstm.py:42,
// driven by _pallas_forward :88). Given the input projection
// xw = x @ W + b (computed outside, as there), it runs the sequential part
// of an LSTM layer over all T steps in one launch:
//
//   pre = xw[t] + h_{t-1} @ R                         gate blocks [i, f, g, o]
//   (peepholes) pre_i += c_{t-1} * pi, pre_f += c_{t-1} * pf
//   i, f = sigmoid; g = tanh; c = f * c_{t-1} + i * g
//   (peepholes) pre_o += c * po;  o = sigmoid;  h = o * tanh(c)
//   (mask m)    h = m * h + (1 - m) * h_{t-1},  c = m * c + (1 - m) * c_{t-1}
//
// Products accumulate in f32; h and c are rounded to the input dtype at
// every step, as the TPU kernel keeps them in scratch of the input dtype.
//
// The TPU grid is (T,), run in order on one core with h and c in VMEM for
// the whole sequence. Hopper CTAs run in parallel, so the counterpart is ONE
// persistent cooperative launch over all T steps. CTA b owns hidden units
// [b*u, (b+1)*u): the four gate columns of R for those units stay in its
// shared memory (as f32) for all T steps, its c stays in shared memory, and
// the gate math is local to it. Each step every CTA reads the whole h_{t-1}
// (from y[t-1], or h0; [N, H] stays in L2) through shared memory in chunks
// of 64·u columns, each staged with 16-byte loads that all issue before the
// first store (one L2 round trip a chunk); it computes its [N, 4u] slice
// of pre on the CUDA cores, writes its units of y[t], and meets the others
// at grid.sync(). h_{t-1} is read from y[t-1] (never overwritten in place)
// with L1-bypassing loads, since other CTAs wrote it during this launch.
//
// What bounds it on H100: at the char-RNN shape (T 128, N 64, H 512, bf16)
// the recurrent products are 2*T*N*H*4H = 17.2 GFLOP (17 us at the 989
// TF/s bf16 tensor rate) against ~44 MB of xw, y and R (13 us at 3.35 TB/s),
// but T dependent steps each pay a grid-wide barrier and a read of h_{t-1}
// from L2, a latency floor no data-sheet figure shows. This version runs
// the products on the CUDA cores in f32 (67 TF/s: ~0.26 ms of FMA at that
// shape); tensor-core products and keeping h_{t-1} in distributed shared
// memory of a cluster are the next steps. The f32 R slices limit H to what
// fits the card's shared memory (H = 1024 fits; 2048 is refused).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace dl4j_lstm {
namespace {

constexpr int kThreads = 256;
// h_{t-1} is staged through shared memory kStageFloats at a time: a pass's
// rows × 64·units columns (64 KB of f32)
constexpr int kStageFloats = 16384;
constexpr int kMaxUnits = 64;           // hidden units per CTA, at most
enum { kF32 = 0, kBF16 = 2 };

struct Args {
  const void* xw;       // [T, N, 4H] at strides (xw_st, xw_sn, 1)
  const void* r;        // [H, 4H]
  const void* h0;       // [N, H]
  const void* c0;       // [N, H]
  const void* pi;       // [H] or null (then pf, po are null too)
  const void* pf;
  const void* po;
  const float* mask;    // [T, N] or null
  void* y;              // [T, N, H] at strides (y_st, y_sn, 1)
  void* ht;             // [N, H]
  void* ct;             // [N, H]
  long long xw_st, xw_sn, y_st, y_sn;
  int t_len, n, h, units;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// L2-only loads: h_{t-1} was written by other CTAs during this launch.
__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_cg(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __bfloat162float(__ushort_as_bfloat16(bits));
}
__device__ __forceinline__ void load_raw(const float* p, float& r) {
  r = ld_cg(p);
}
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, float& r) {
  r = ld_cg(p);
}
template <typename T>
__device__ __forceinline__ void load_raw(const T* p, uint4& r) {
  r = __ldcg(reinterpret_cast<const uint4*>(p));
}

// a staged vector as f32: one value, four f32 or eight bf16
__device__ __forceinline__ void unpack(float r, float* out, const void*) {
  out[0] = r;
}
__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       const float*) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(const uint4& r, float* out,
                                       const __nv_bfloat16*) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // element 2i is word i's low half
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// rows of the batch handled per pass: one (row, unit) pair per thread
__host__ __device__ inline int rows_per_pass(int units) {
  return kThreads / units;
}

// columns of h_{t-1} staged per chunk (64 · units), and the padded row
// stride of the staging buffer (conflict-free float4 reads)
__host__ __device__ inline int chunk_cols(int units) {
  return kStageFloats / rows_per_pass(units);
}

__host__ __device__ inline int padded_h(int h) { return (h + 3) / 4 * 4; }

__host__ __device__ inline size_t smem_bytes(int n, int h, int units) {
  return (size_t)padded_h(h) * units * sizeof(float4) +          // R slice
         (size_t)rows_per_pass(units) * (chunk_cols(units) + 4) *
             sizeof(float) +                                     // h chunk
         (size_t)n * units * sizeof(float);                      // c
}

// Stage columns [k0, k0 + cols) of rows [r0, r0 + nrows) of h_{t-1} into
// h_s as f32, zero past H, VEC elements per load (16 bytes, or 1 when the
// rows are not 16-byte aligned). Every thread issues all its loads before
// its first store, so a chunk costs about one L2 round trip.
template <typename T, int VEC>
__device__ __forceinline__ void stage_h(const T* hp, long long hp_sn, int H,
                                        int r0, int nrows, int k0, int cols,
                                        float* h_s, int hstride) {
  constexpr int kPer = kStageFloats / VEC / kThreads;
  using Raw = typename std::conditional<VEC == 1, float, uint4>::type;
  const int per_row = cols / VEC;
  const int total = nrows * per_row;
  Raw raw[kPer] = {};
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    const int k = k0 + idx % per_row * VEC;
    if (idx < total && k < H)
      load_raw(hp + (size_t)(r0 + idx / per_row) * hp_sn + k, raw[q]);
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    if (idx >= total) continue;
    float v[VEC];
    unpack(raw[q], v, hp);
    float* dst = h_s + (idx / per_row) * hstride + idx % per_row * VEC;
    if constexpr (VEC == 1) {
      dst[0] = v[0];
    } else {
#pragma unroll
      for (int i = 0; i < VEC; i += 4)
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) lstm_fwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.h, N = a.n, u = a.units;
  const int hpad = padded_h(H);
  const int rows = rows_per_pass(u);
  const int cols = chunk_cols(u), hstride = cols + 4;
  float4* r_s = reinterpret_cast<float4*>(smem);           // [hpad][u]
  float* h_s = reinterpret_cast<float*>(r_s + (size_t)hpad * u);
  float* c_s = h_s + rows * hstride;                        // [N][u]
  const T* xw = static_cast<const T*>(a.xw);
  const T* R = static_cast<const T*>(a.r);
  const T* h0 = static_cast<const T*>(a.h0);
  const T* c0 = static_cast<const T*>(a.c0);
  T* y = static_cast<T*>(a.y);
  const int unit0 = blockIdx.x * u;

  // this CTA's columns of R, the four gates of a unit side by side
  for (int idx = threadIdx.x; idx < hpad * u; idx += kThreads) {
    const int k = idx / u, unit = unit0 + idx % u;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < H && unit < H) {
      const T* row = R + (size_t)k * 4 * H + unit;
      w = make_float4(to_f(row[0]), to_f(row[H]), to_f(row[2 * H]),
                      to_f(row[3 * H]));
    }
    r_s[idx] = w;
  }
  for (int idx = threadIdx.x; idx < N * u; idx += kThreads) {
    const int unit = unit0 + idx % u;
    c_s[idx] = unit < H ? to_f(c0[(size_t)(idx / u) * H + unit]) : 0.f;
  }
  const int j = threadIdx.x % u;
  const int unit = unit0 + j;
  const int lrow = threadIdx.x / u;
  const bool peep = a.pi != nullptr;
  float wpi = 0.f, wpf = 0.f, wpo = 0.f;
  if (peep && unit < H) {
    wpi = to_f(static_cast<const T*>(a.pi)[unit]);
    wpf = to_f(static_cast<const T*>(a.pf)[unit]);
    wpo = to_f(static_cast<const T*>(a.po)[unit]);
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();

  for (int t = 0; t < a.t_len; ++t) {
    const T* hp = t == 0 ? h0 : y + (size_t)(t - 1) * a.y_st;
    const long long hp_sn = t == 0 ? H : a.y_sn;
    T* yt = y + (size_t)t * a.y_st;
    const T* xwt = xw + (size_t)t * a.xw_st;
    for (int r0 = 0; r0 < N; r0 += rows) {
      const int nrows = min(rows, N - r0);
      const int n = r0 + lrow;
      const bool active = lrow < nrows && unit < H;
      // this step's inputs of the thread's gates, requested before the
      // products so that their latency overlaps them
      float x_i = 0.f, x_f = 0.f, x_g = 0.f, x_o = 0.f, m = 1.f,
            h_prev = 0.f;
      if (active) {
        const T* xr = xwt + (size_t)n * a.xw_sn + unit;
        x_i = to_f(xr[0]);
        x_f = to_f(xr[H]);
        x_g = to_f(xr[2 * H]);
        x_o = to_f(xr[3 * H]);
        if (a.mask != nullptr) {
          m = a.mask[(size_t)t * N + n];
          h_prev = ld_cg(hp + (size_t)n * hp_sn + unit);
        }
      }
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k0 = 0; k0 < H; k0 += cols) {
        stage_h<T, VEC>(hp, hp_sn, H, r0, nrows, k0, cols, h_s, hstride);
        __syncthreads();
        // columns past H are zero in h_s and r_s; skip whole groups of 4
        const int kend = min(cols, (H - k0 + 3) / 4 * 4);
        if (active) {
          const float* hrow = h_s + lrow * hstride;
          const float4* rcol = r_s + (size_t)k0 * u + j;
#pragma unroll 8
          for (int kk = 0; kk < kend; kk += 4) {
            const float4 hv = *reinterpret_cast<const float4*>(hrow + kk);
            const float hs[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 w = rcol[(size_t)(kk + q) * u];
              acc.x = fmaf(hs[q], w.x, acc.x);
              acc.y = fmaf(hs[q], w.y, acc.y);
              acc.z = fmaf(hs[q], w.z, acc.z);
              acc.w = fmaf(hs[q], w.w, acc.w);
            }
          }
        }
        __syncthreads();
      }
      if (active) {
        const float c_prev = c_s[n * u + j];
        float pre_i = acc.x + x_i;
        float pre_f = acc.y + x_f;
        const float pre_g = acc.z + x_g;
        float pre_o = acc.w + x_o;
        if (peep) {
          pre_i += c_prev * wpi;
          pre_f += c_prev * wpf;
        }
        const float ig = sigmoid(pre_i), fg = sigmoid(pre_f);
        const float gg = tanhf(pre_g);
        float c = fg * c_prev + ig * gg;
        if (peep) pre_o += c * wpo;
        float hv = sigmoid(pre_o) * tanhf(c);
        if (a.mask != nullptr) {
          hv = m * hv + (1.f - m) * h_prev;
          c = m * c + (1.f - m) * c_prev;
        }
        const T h_out = from_f<T>(hv);
        const T c_out = from_f<T>(c);
        yt[(size_t)n * a.y_sn + unit] = h_out;
        c_s[n * u + j] = to_f(c_out);
        if (t == a.t_len - 1) {
          static_cast<T*>(a.ht)[(size_t)n * H + unit] = h_out;
          static_cast<T*>(a.ct)[(size_t)n * H + unit] = c_out;
        }
      }
    }
    if (t + 1 < a.t_len) grid.sync();
  }
}

struct Plan {
  int units, ctas, per_sm, sms;
  size_t smem;
};

// elements of T in one 16-byte staging load
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// The smallest power-of-two units per CTA that gives at most one CTA per
// SM, raised until the grid's shared memory fits and every CTA can be
// co-resident (a cooperative launch requires it).
template <typename T, int VEC>
cudaError_t plan(int n, int h, Plan* p) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int sms = 0, max_smem = 0, coop = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&max_smem,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  // the opt-in ceiling once, so that no plan (lstm_plan included) lowers
  // it below what another shape's cached plan launches with
  if ((e = cudaFuncSetAttribute(lstm_fwd_kernel<T, VEC>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                max_smem)) != cudaSuccess)
    return e;
  int units = 1;
  while (units < kMaxUnits && (h + units - 1) / units > sms) units *= 2;
  for (; units <= kMaxUnits; units *= 2) {
    const size_t smem = smem_bytes(n, h, units);
    if (smem > (size_t)max_smem) continue;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, lstm_fwd_kernel<T, VEC>, kThreads, smem)) !=
        cudaSuccess)
      return e;
    const int ctas = (h + units - 1) / units;
    if (per_sm > 0 && ctas <= per_sm * sms) {
      *p = Plan{units, ctas, per_sm, sms, smem};
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

// plan is a handful of CUDA attribute queries; rnn_time_step launches at
// one shape many times, so the last plan per kernel is kept.
template <typename T, int VEC>
cudaError_t cached_plan(int n, int h, Plan* p) {
  static std::mutex mu;
  static int last_dev = -1, last_n = 0, last_h = 0;
  static Plan last;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  if (dev != last_dev || n != last_n || h != last_h) {
    if ((e = plan<T, VEC>(n, h, &last)) != cudaSuccess) return e;
    last_dev = dev;
    last_n = n;
    last_h = h;
  }
  *p = last;
  return cudaSuccess;
}

template <typename T, int VEC>
cudaError_t launch(Args a, cudaStream_t s) {
  Plan p;
  cudaError_t e = cached_plan<T, VEC>(a.n, a.h, &p);
  if (e != cudaSuccess) return e;
  a.units = p.units;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)lstm_fwd_kernel<T, VEC>,
                                  dim3(p.ctas), dim3(kThreads), params,
                                  p.smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// 16-byte staging loads when every row of h0 and y starts 16-byte aligned
template <typename T>
cudaError_t run(const Args& a, cudaStream_t s) {
  constexpr int v = kVec<T>;
  const bool aligned = a.h % v == 0 && a.y_st % v == 0 && a.y_sn % v == 0 &&
                       reinterpret_cast<uintptr_t>(a.h0) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  return aligned ? launch<T, v>(a, s) : launch<T, 1>(a, s);
}

// the plan of the kernel an aligned [N, H] launch takes
template <typename T>
cudaError_t plan_for(int n, int h, Plan* p) {
  return h % kVec<T> == 0 ? plan<T, kVec<T>>(n, h, p) : plan<T, 1>(n, h, p);
}

}  // namespace
}  // namespace dl4j_lstm

// The launch plan for [N, H] in `dtype` (0 f32, 2 bf16), rows aligned:
// out[0] hidden units per CTA, out[1] CTAs, out[2] dynamic shared memory
// bytes, out[3] co-resident CTAs per SM, out[4] SMs. Returns a cudaError_t
// (cudaErrorCooperativeLaunchTooLarge when no grid can be co-resident).
extern "C" int lstm_plan(int n, int h, int dtype, long long* out) {
  using namespace dl4j_lstm;
  if (n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e;
  switch (dtype) {
    case kF32:
      e = plan_for<float>(n, h, &p);
      break;
    case kBF16:
      e = plan_for<__nv_bfloat16>(n, h, &p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  out[0] = p.units;
  out[1] = p.ctas;
  out[2] = (long long)p.smem;
  out[3] = p.per_sm;
  out[4] = p.sms;
  return 0;
}

// xw: [T, N, 4H] at element strides (xw_st, xw_sn, 1); r: [H, 4H]
// contiguous; h0, c0: [N, H] contiguous; pi, pf, po: [H] or all null;
// mask: [T, N] f32 contiguous or null; y: [T, N, H] at strides (y_st,
// y_sn, 1); ht, ct: [N, H] contiguous. All tensors but the mask in `dtype`
// (0 f32, 2 bf16). One cooperative launch on `stream`, no synchronisation.
// Returns cudaGetLastError() (or the planning / launch error).
extern "C" int lstm_recurrence_fwd(const void* xw, const void* r,
                                   const void* h0, const void* c0,
                                   const void* pi, const void* pf,
                                   const void* po, const void* mask, void* y,
                                   void* ht, void* ct, long long xw_st,
                                   long long xw_sn, long long y_st,
                                   long long y_sn, int t, int n, int h,
                                   int dtype, void* stream) {
  using namespace dl4j_lstm;
  if (t < 1 || n < 1 || h < 1 || (pi == nullptr) != (pf == nullptr) ||
      (pi == nullptr) != (po == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{xw, r, h0, c0, pi, pf, po, static_cast<const float*>(mask),
               y, ht, ct, xw_st, xw_sn, y_st, y_sn, t, n, h, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)run<float>(a, s);
    case kBF16:
      return (int)run<__nv_bfloat16>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
