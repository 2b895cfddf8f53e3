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
// the whole sequence. On Hopper the T steps stay inside one launch, and
// two routes take them (lstm_plan picks one from the dtype, the shape and
// the card's occupancy, and reports it; neither is a fallback of the
// other):
//
// - cluster (bf16, H a multiple of 8 up to 512): rows of the batch are
//   independent, so the batch is cut into slices of NB rows (8, 16 or 32),
//   one thread-block cluster of ceil(H / 32) CTAs per slice, and clusters
//   never wait for each other. CTA r of a cluster owns hidden units
//   [32 r, 32 r + 32): their 128 gate columns of R stay in its shared
//   memory in bf16 for all T steps (128 KB, H zero-padded to 512),
//   ordered so that a thread's wgmma accumulator rows are the four gates
//   of one unit. Each step computes pre^T [128 x NB] = R_slice^T
//   [128 x 512] . h_{t-1}^T [512 x NB] on wgmma (A and B from shared
//   memory), does the gate math in registers (c and h_{t-1} of the
//   thread's (unit, row) pairs never leave them; the next step's xw is
//   requested during the products), and each warp pushes its 16-byte
//   column of the [NB x 32] slice of h_t into the other h buffer of every
//   CTA of the cluster with st.async, whose bytes complete on the
//   receiver's mbarrier. A CTA starts its next step when its own buffer
//   is full: no grid or cluster barrier, no L2 round trip for h_{t-1}.
//   The double buffer needs no "empty" signal: a CTA pushes h_t only after
//   its step-t products, which needed every CTA's h_{t-1}, which each
//   pushed after its own step t-1 read the buffer h_t is written into.
// - cooperative (f32, and bf16 shapes the cluster does not take): ONE
//   persistent cooperative launch. CTA b owns hidden units [b*u, (b+1)*u):
//   the four gate columns of R for those units stay in its shared memory
//   (as f32) for all T steps, its c stays in shared memory, and the gate
//   math is local to it. Each step every CTA reads the whole h_{t-1} (from
//   y[t-1], or h0; [N, H] stays in L2) through shared memory in chunks of
//   64·u columns, each staged with 16-byte loads that all issue before the
//   first store (one L2 round trip a chunk); it computes its [N, 4u] slice
//   of pre on the CUDA cores (f32 products: the tensor cores would round
//   f32 to TF32), writes its units of y[t], and meets the others at
//   grid.sync(). h_{t-1} is read from y[t-1] (never overwritten in place)
//   with L1-bypassing loads, since other CTAs wrote it during this launch.
//
// What bounds it on H100: at the char-RNN shape (T 128, N 64, H 512, bf16)
// the recurrent products are 2*T*N*H*4H = 17.2 GFLOP (17 us at the 989
// TF/s bf16 tensor rate) against ~44 MB of xw, y and R (13 us at 3.35
// TB/s), but T dependent steps each pay the exchange of h_{t-1}, a
// latency floor no data-sheet figure shows. On the cluster route a step
// is the products (each reads the CTA's 128 KB R slice from shared
// memory, the largest phase), the gate math, the push and the wait for
// the cluster's slices (PERF.md, tools/lstm_probe.py). The cooperative
// route's f32 R slices limit H to what fits the card's shared memory
// (H = 1024 fits; 2048 is refused).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_common.cuh"

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

// ---- the cluster route: bf16, H a multiple of 8 up to 512 ----

constexpr int kClusterThreads = 128;   // one warpgroup
constexpr int kClusterUnits = 32;      // hidden units a CTA: 128 gate rows
constexpr int kMaxCluster = 16;        // CTAs a cluster (non-portable size)
// The products' depth, H zero-padded: a fixed depth keeps the k loop
// unrolled, which lets the wgmma chain issue without waits (over a depth
// known only at run time ptxas serialised the chain, warning C7520).
constexpr int kClusterK = kMaxCluster * kClusterUnits;

// A CTA's shared memory: the R slice as the A operand (two 64-row blocks,
// MN-major, kClusterK rows of 128 bytes each, the 128-byte swizzle), two
// h buffers as the B operand (NB rows, K-major, in 32-column panels of
// NB x 64 bytes with the 64-byte swizzle, so that CTA r's slice of h is
// panel r, contiguous), two stagings of the CTA's slice of h_t (one
// panel each), then the two h buffers' mbarriers; 1 KB for the 1024-byte
// alignment of the swizzles.
__host__ __device__ constexpr size_t cluster_smem_bytes(int nb) {
  return 1024 + 2 * kClusterK * 128 + 2 * (size_t)nb * kClusterK * 2 +
         2 * (size_t)nb * kClusterUnits * 2 + 16;
}

// Byte offset of the 8 values from k (a multiple of 8) of row n in an h
// buffer: panel k / 32, the 16-byte chunk (k / 8) % 4 XORed with
// (n / 2) % 4 (the 64-byte swizzle).
template <int NB>
__device__ __forceinline__ uint32_t h_off(int n, int k) {
  return (uint32_t)((k >> 5) * (NB * 64) + n * 64 +
                    ((((k >> 3) & 3) ^ ((n >> 1) & 3)) << 4));
}

// Shared-memory matrix descriptor, 64-byte swizzle, 8-row groups 512
// bytes apart.
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

// Byte offset of element m of row k in a 128-byte-swizzled region of
// 128-byte rows (the 16-byte chunk m / 8 XORed with k % 8).
__device__ __forceinline__ uint32_t sw_off(int k, int m) {
  return (uint32_t)(k * 128 + ((((m >> 3) ^ (k & 7))) << 4) + (m & 7) * 2);
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void sts16(uint32_t addr, unsigned short v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// addr (this CTA's shared memory) in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_to(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// Writes by the generic proxy made visible to the async proxy (wgmma's
// operand reads).
__device__ __forceinline__ void fence_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Predicated read-only loads that leave `v` as it was when `pred` is
// false; the value is not touched until it is used, so the load's latency
// hides behind what comes before that.
__device__ __forceinline__ void ldg_u16(unsigned short& v, const void* p,
                                        bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p ld.global.nc.u16 %0, "
      "[%1];\n}\n"
      : "+h"(v)
      : "l"(p), "r"((int)pred));
}
__device__ __forceinline__ void ldg_f32(float& v, const void* p, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p ld.global.nc.f32 %0, "
      "[%1];\n}\n"
      : "+f"(v)
      : "l"(p), "r"((int)pred));
}

// A bulk copy of `bytes` from this CTA's shared memory `src` into a
// peer's `dst`, completing its bytes on the peer's mbarrier `bar` (dst and
// bar in the cluster window).
__device__ __forceinline__ void copy_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Wait for phase `parity` of mbarrier `bar`, acquiring what the cluster's
// CTAs released to it.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// sigmoid and tanh from the fast exp2 / reciprocal units (a few ulp of
// f32, far below h's and c's bf16 rounding).
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}


// wgmma.m64nNBk16, bf16 in, f32 accumulators d (the m16n8 C layout per
// warp: n8 block i, rows g and g + 8): A MN-major and B K-major, both
// from shared memory. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tn(float (&d)[1][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tn(float (&d)[2][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "l"(da), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void wgmma_tn(float (&d)[4][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One cluster per slice of NB batch rows; CTA `rank` of it owns hidden
// units [32 rank, 32 rank + 32). Row m of A block b (m = 16 w + 8 s + e,
// w < 4, s < 2, e < 8) is gate 2 b + s of unit 8 w + e, so warp w's thread
// with lane group g holds in its accumulators all four gates of unit
// 8 w + g: block 0 rows g / g + 8 (i / f), block 1 rows g / g + 8 (g / o),
// for the batch columns 8 i + 2 tig + q of n8 block i.
template <int NB>
__global__ void __launch_bounds__(kClusterThreads, 1)
    lstm_cluster_kernel(Args a, int csize) {
  constexpr int NI = NB / 8;
  // probe: begin
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t a_s =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) &
      ~1023u;
  constexpr int hp = kClusterK;
  const int H = a.h, N = a.n, T = a.t_len;
  const uint32_t hb0 = a_s + 2 * hp * 128;
  const uint32_t hbytes = (uint32_t)NB * hp * 2;
  const uint32_t stage0 = hb0 + 2 * hbytes;
  constexpr uint32_t kPanel = NB * kClusterUnits * 2;   // a CTA's slice
  // full[b]: h buffer b holds the cluster's whole h_{t-1}
  const uint32_t full0 = stage0 + 2 * kPanel;
  const int rank = (int)cluster_rank();
  const int unit0 = rank * kClusterUnits;
  const int n0 = (blockIdx.x / csize) * NB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  using bf = __nv_bfloat16;
  const bf* R = static_cast<const bf*>(a.r);
  const bf* h0 = static_cast<const bf*>(a.h0);
  const bf* c0 = static_cast<const bf*>(a.c0);
  const bf* xw = static_cast<const bf*>(a.xw);
  bf* y = static_cast<bf*>(a.y);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // R slice: for each k, gate q and group w, units unit0 + 8 w .. + 7 of
  // gate q's columns are one 16-byte chunk of A row m = 16 w + 8 (q % 2) +
  // e, block q / 2 (zero past H)
  for (int idx = tid; idx < hp * 16; idx += kClusterThreads) {
    const int k = idx >> 4, q = (idx >> 2) & 3, w = idx & 3;
    const int u0 = unit0 + 8 * w;
    const uint4 v =
        k < H && u0 < H
            ? __ldg(reinterpret_cast<const uint4*>(R + (size_t)k * 4 * H +
                                                   q * H + u0))
            : zero;
    sts128(a_s + (q >> 1) * hp * 128 + sw_off(k, 16 * w + 8 * (q & 1)), v);
  }
  // h buffer 0 holds h0 of the slice's rows, buffer 1 zeros; columns past
  // H and rows past N stay zero in both
  for (int idx = tid; idx < NB * (hp / 8); idx += kClusterThreads) {
    const int n = idx / (hp / 8), k = (idx - n * (hp / 8)) * 8;
    const uint4 v =
        n0 + n < N && k < H
            ? __ldg(reinterpret_cast<const uint4*>(h0 + (size_t)(n0 + n) * H +
                                                   k))
            : zero;
    sts128(hb0 + h_off<NB>(n, k), v);
    sts128(hb0 + hbytes + h_off<NB>(n, k), zero);
  }

  // the thread's unit and its (unit, row) pairs' carried state
  const int j = 8 * warp + g, unit = unit0 + j;
  const bool unit_ok = unit < H;
  const bool peep = a.pi != nullptr;
  float wpi = 0.f, wpf = 0.f, wpo = 0.f;
  if (peep && unit_ok) {
    wpi = to_f(static_cast<const bf*>(a.pi)[unit]);
    wpf = to_f(static_cast<const bf*>(a.pf)[unit]);
    wpo = to_f(static_cast<const bf*>(a.po)[unit]);
  }
  float c[NI][2], hprev[NI][2], m[NI][2], mn[NI][2];
  unsigned short x[NI][2][4], xn[NI][2][4];   // xw as bf16 bits
  bool ok[NI][2];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + 8 * i + 2 * tig + q;
      ok[i][q] = unit_ok && n < N;
      c[i][q] = ok[i][q] ? to_f(c0[(size_t)n * H + unit]) : 0.f;
      hprev[i][q] = ok[i][q] ? to_f(h0[(size_t)n * H + unit]) : 0.f;
    }
  // step t's xw (bits) and mask values of the thread's pairs (0 / 1
  // outside), requested now and read a step later
  auto load_step = [&](int t, unsigned short (&xv)[NI][2][4],
                       float (&mv)[NI][2]) {
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = n0 + 8 * i + 2 * tig + q;
        const bf* xr = xw + (size_t)t * a.xw_st + (size_t)n * a.xw_sn + unit;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          xv[i][q][gate] = 0;
          ldg_u16(xv[i][q][gate], xr + gate * H, ok[i][q]);
        }
        mv[i][q] = 1.f;
        ldg_f32(mv[i][q], a.mask + (size_t)t * N + n,
                a.mask != nullptr && ok[i][q]);
      }
  };
  load_step(0, x, m);

  if (tid == 0) {
    dl4j::mbar_init(full0, 1);
    dl4j::mbar_init(full0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster has started and filled its buffers before
  // any pushes into them
  fence_async_cta();
  cluster_arrive();
  cluster_wait();

  for (int t = 0; t < T; ++t) {
    // probe: wait
    // h_{t-1} has arrived from every CTA (buffer t % 2's ((t - 1) / 2)-th
    // fill); the proxy fence orders it before wgmma's reads
    if (t > 0) {
      mbar_wait_cluster(full0 + 8 * (t & 1), ((t - 1) >> 1) & 1);
      fence_async_cta();
    }
    // probe: products
    const uint32_t hcur = hb0 + (t & 1) * hbytes;
    float acc[2][NI][4] = {};
    dl4j::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < hp / 16; ++kk) {
      const uint64_t db =
          sw64_desc(hcur + (kk >> 1) * (NB * 64) + (kk & 1) * 32);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wgmma_tn(acc[b], dl4j::sw128_desc(a_s + b * hp * 128 + kk * 2048),
                 db, kk > 0);
    }
    dl4j::wgmma_commit();
    // the next step's inputs, while the products run
    if (t + 1 < T) load_step(t + 1, xn, mn);
    dl4j::wgmma_wait<0>();
    dl4j::fence_regs(acc[0]);
    dl4j::fence_regs(acc[1]);

    // probe: gates
    // the slice of h_t is staged as it lands in the peers' buffers (this
    // step's staging is reread by the copies only until the peers have
    // it, which they have before any CTA reaches step t + 2)
    const uint32_t stage = stage0 + (t & 1) * kPanel;
    unsigned short hbits[NI][2], cbits[NI][2];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float cp = c[i][q];
        const auto xf = [&](int gate) {
          return __bfloat162float(__ushort_as_bfloat16(x[i][q][gate]));
        };
        float pre_i = acc[0][i][q] + xf(0);
        float pre_f = acc[0][i][2 + q] + xf(1);
        const float pre_g = acc[1][i][q] + xf(2);
        float pre_o = acc[1][i][2 + q] + xf(3);
        if (peep) {
          pre_i += cp * wpi;
          pre_f += cp * wpf;
        }
        const float ig = sigmoid_fast(pre_i), fg = sigmoid_fast(pre_f);
        const float gg = tanh_fast(pre_g);
        float cn = fg * cp + ig * gg;
        if (peep) pre_o += cn * wpo;
        float hn = sigmoid_fast(pre_o) * tanh_fast(cn);
        const float mm = m[i][q];
        hn = mm * hn + (1.f - mm) * hprev[i][q];
        cn = mm * cn + (1.f - mm) * cp;
        const bf h_out = __float2bfloat16_rn(hn);
        const bf c_out = __float2bfloat16_rn(cn);
        hprev[i][q] = __bfloat162float(h_out);
        c[i][q] = __bfloat162float(c_out);
        hbits[i][q] = ok[i][q] ? __bfloat16_as_ushort(h_out) : 0;
        cbits[i][q] = __bfloat16_as_ushort(c_out);
        const int nl = 8 * i + 2 * tig + q;
        sts16(stage + nl * 64 + (((j >> 3) ^ ((nl >> 1) & 3)) << 4) +
                  (j & 7) * 2,
              hbits[i][q]);
      }
    // y[t] (and hT, cT after the last step) of the thread's pairs
    auto store_outputs = [&]() {
      bf* yt = y + (size_t)t * a.y_st;
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (!ok[i][q]) continue;
          const int n = n0 + 8 * i + 2 * tig + q;
          const bf h_out = __ushort_as_bfloat16(hbits[i][q]);
          yt[(size_t)n * a.y_sn + unit] = h_out;
          if (t == T - 1) {
            static_cast<bf*>(a.ht)[(size_t)n * H + unit] = h_out;
            static_cast<bf*>(a.ct)[(size_t)n * H + unit] =
                __ushort_as_bfloat16(cbits[i][q]);
          }
        }
    };
    if (t + 1 == T) {
      store_outputs();
      break;
    }
    // push the slice of h_t (one panel, NB x 64 bytes) into the other h
    // buffer of every CTA of the cluster, this one included: thread p
    // copies it to CTA p with one bulk copy, whose bytes complete on that
    // CTA's full barrier of the buffer, which its thread 0 arms for the
    // whole cluster's slices
    // probe: exchange
    fence_async_cta();      // the staging's stores, before the copies read it
    __syncthreads();
    {
      const uint32_t full = full0 + 8 * ((t + 1) & 1);
      if (tid == 0) dl4j::mbar_expect_tx(full, csize * kPanel);
      if (tid < csize)
        copy_to_peer(map_to(hb0 + ((t + 1) & 1) * hbytes + rank * kPanel,
                            tid),
                     stage, kPanel, map_to(full, tid));
    }
    store_outputs();
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        m[i][q] = mn[i][q];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) x[i][q][gate] = xn[i][q][gate];
      }
  }
  // no CTA leaves while a copy may still read its staging: every copy has
  // landed once every CTA has passed its last wait
  cluster_arrive();
  cluster_wait();
  // probe: done
}

// A launch plan. route 0: cooperative (units hidden units a CTA, ctas
// CTAs, per_sm co-resident CTAs an SM); route 1: cluster (cluster CTAs a
// cluster of 32 units each, nb batch rows a cluster, ctas CTAs in all,
// per_sm the clusters the card can hold at once).
struct Plan {
  int route, units, ctas, per_sm, sms, cluster, nb;
  size_t smem;
};

enum Route { kCooperative = 0, kCluster = 1 };

cudaError_t device_limits(int* sms, int* max_smem) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  return cudaDeviceGetAttribute(max_smem,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The smallest power-of-two units per CTA that gives at most one CTA per
// SM, raised until the grid's shared memory fits and every CTA can be
// co-resident (a cooperative launch requires it).
template <typename T, int VEC>
cudaError_t cooperative_plan(int n, int h, Plan* p) {
  int dev = 0, sms = 0, max_smem = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (e = device_limits(&sms, &max_smem)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                  dev)) != cudaSuccess)
    return e;
  if (!coop) return cudaErrorNotSupported;
  // the opt-in ceiling once, so that no plan lowers it below what another
  // shape's cached plan launches with
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
      *p = Plan{kCooperative, units, ctas, per_sm, sms, 0, 0, smem};
      return cudaSuccess;
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;
}

cudaLaunchConfig_t cluster_config(int csize, int clusters, size_t smem,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize * clusters);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the NB kernel the card holds at once (0: none fits).
template <int NB>
cudaError_t active_clusters(int h, int max_smem, int* out) {
  *out = 0;
  const int csize = (h + kClusterUnits - 1) / kClusterUnits;
  const size_t smem = cluster_smem_bytes(NB);
  if (smem > (size_t)max_smem) return cudaSuccess;
  auto kern = lstm_cluster_kernel<NB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (e != cudaSuccess ||
      (e = cudaFuncSetAttribute(
           kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) !=
          cudaSuccess)
    return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(csize, 1, smem, &attr, 0);
  return cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

// The cluster route on or off (-DDL4J_LSTM_CLUSTER=0 runs bf16 on the
// cooperative route: tools/lstm_probe.py's in-call comparison).
#ifndef DL4J_LSTM_CLUSTER
#define DL4J_LSTM_CLUSTER 1
#endif

// The cluster route for [N, H] bf16 (16-byte aligned R and h0): the
// smallest NB in {8, 16, 32} whose ceil(N / NB) clusters the card holds at
// once, else the NB that needs the fewest waves of clusters. Returns
// cudaErrorNotSupported when the route does not take the shape.
cudaError_t cluster_plan(int n, int h, Plan* p) {
  if (h % 8 != 0 || h > kMaxCluster * kClusterUnits)
    return cudaErrorNotSupported;
  int sms = 0, max_smem = 0;
  cudaError_t e = device_limits(&sms, &max_smem);
  if (e != cudaSuccess) return e;
  const int nbs[3] = {8, 16, 32};
  int active[3];
  if ((e = active_clusters<8>(h, max_smem, &active[0])) != cudaSuccess ||
      (e = active_clusters<16>(h, max_smem, &active[1])) != cudaSuccess ||
      (e = active_clusters<32>(h, max_smem, &active[2])) != cudaSuccess)
    return e;
  int best = -1, best_waves = 0;
  for (int i = 0; i < 3; ++i) {
    if (active[i] < 1) continue;
    const int clusters = (n + nbs[i] - 1) / nbs[i];
    const int waves = (clusters + active[i] - 1) / active[i];
    if (best < 0 || waves < best_waves) {
      best = i;
      best_waves = waves;
    }
    if (waves == 1) break;
  }
  if (best < 0) return cudaErrorNotSupported;
  const int csize = (h + kClusterUnits - 1) / kClusterUnits;
  const int nb = nbs[best];
  *p = Plan{kCluster,     kClusterUnits,
            csize * ((n + nb - 1) / nb),
            active[best], sms,
            csize,        nb,
            cluster_smem_bytes(nb)};
  return cudaSuccess;
}

// elements of T in one 16-byte staging load
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// The route and plan of an [N, H] launch in T, from scratch: bf16 takes the
// cluster route where it takes the shape (R and h0 16-byte aligned), every
// other launch the cooperative one, with 16-byte staging loads when every
// row of h0 and y starts 16-byte aligned (`vec`).
template <typename T>
cudaError_t make_plan(int n, int h, bool aligned, bool vec, Plan* p) {
  if (std::is_same<T, __nv_bfloat16>::value && aligned && DL4J_LSTM_CLUSTER) {
    const cudaError_t e = cluster_plan(n, h, p);
    if (e != cudaErrorNotSupported) return e;
  }
  return vec ? cooperative_plan<T, kVec<T>>(n, h, p)
             : cooperative_plan<T, 1>(n, h, p);
}

// Planning is a handful of CUDA attribute and occupancy queries;
// rnn_time_step launches at one shape many times, so the last plan per
// element type is kept.
template <typename T>
cudaError_t cached_plan(int n, int h, bool aligned, bool vec, Plan* p) {
  static std::mutex mu;
  static int last_dev = -1, last_n = 0, last_h = 0, last_flags = 0;
  static Plan last;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int flags = (int)aligned | (int)vec << 1;
  std::lock_guard<std::mutex> lock(mu);
  if (dev != last_dev || n != last_n || h != last_h || flags != last_flags) {
    if ((e = make_plan<T>(n, h, aligned, vec, &last)) != cudaSuccess)
      return e;
    last_dev = dev;
    last_n = n;
    last_h = h;
    last_flags = flags;
  }
  *p = last;
  return cudaSuccess;
}

template <int NB>
cudaError_t launch_cluster(const Args& a, const Plan& p, cudaStream_t s) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(p.cluster, p.ctas / p.cluster, p.smem, &attr, s);
  cudaError_t e = cudaLaunchKernelEx(&cfg, lstm_cluster_kernel<NB>, a,
                                     p.cluster);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_cooperative(Args a, const Plan& p, cudaStream_t s) {
  a.units = p.units;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)lstm_fwd_kernel<T, VEC>, dim3(p.ctas), dim3(kThreads),
      params, p.smem, s);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const Args& a, cudaStream_t s, int* route) {
  constexpr int v = kVec<T>;
  const bool aligned = reinterpret_cast<uintptr_t>(a.r) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.h0) % 16 == 0;
  const bool vec = a.h % v == 0 && a.y_st % v == 0 && a.y_sn % v == 0 &&
                   reinterpret_cast<uintptr_t>(a.h0) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.y) % 16 == 0;
  Plan p;
  cudaError_t e = cached_plan<T>(a.n, a.h, aligned, vec, &p);
  if (e != cudaSuccess) return e;
  if (route != nullptr) *route = p.route;
  if (p.route == kCluster) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (p.nb == 8) return launch_cluster<8>(a, p, s);
      if (p.nb == 16) return launch_cluster<16>(a, p, s);
      return launch_cluster<32>(a, p, s);
    }
    return cudaErrorInvalidValue;
  }
  return vec ? launch_cooperative<T, v>(a, p, s)
             : launch_cooperative<T, 1>(a, p, s);
}

}  // namespace
}  // namespace dl4j_lstm

// The launch plan for [N, H] in `dtype` (0 f32, 2 bf16), tensors aligned:
// out[0] the route (0 cooperative, 1 cluster), out[1] hidden units per
// CTA, out[2] CTAs, out[3] dynamic shared memory bytes, out[4] co-resident
// CTAs per SM (cooperative) or clusters the card holds at once (cluster),
// out[5] SMs, out[6] CTAs per cluster (0: cooperative), out[7] batch rows
// per cluster. Returns a cudaError_t (cudaErrorCooperativeLaunchTooLarge
// when no route takes the shape).
extern "C" int lstm_plan(int n, int h, int dtype, long long* out) {
  using namespace dl4j_lstm;
  if (n < 1 || h < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e;
  switch (dtype) {
    case kF32:
      e = make_plan<float>(n, h, true, h % kVec<float> == 0, &p);
      break;
    case kBF16:
      e = make_plan<__nv_bfloat16>(n, h, true,
                                   h % kVec<__nv_bfloat16> == 0, &p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  const long long vals[8] = {p.route,  p.units,   p.ctas, (long long)p.smem,
                             p.per_sm, p.sms,     p.cluster, p.nb};
  for (int i = 0; i < 8; ++i) out[i] = vals[i];
  return 0;
}

// xw: [T, N, 4H] at element strides (xw_st, xw_sn, 1); r: [H, 4H]
// contiguous; h0, c0: [N, H] contiguous; pi, pf, po: [H] or all null;
// mask: [T, N] f32 contiguous or null; y: [T, N, H] at strides (y_st,
// y_sn, 1); ht, ct: [N, H] contiguous. All tensors but the mask in `dtype`
// (0 f32, 2 bf16). One launch on `stream`, no synchronisation; *route (if
// not null) is set to the route launched (0 cooperative, 1 cluster).
// Returns cudaGetLastError() (or the planning / launch error).
extern "C" int lstm_recurrence_fwd(const void* xw, const void* r,
                                   const void* h0, const void* c0,
                                   const void* pi, const void* pf,
                                   const void* po, const void* mask, void* y,
                                   void* ht, void* ct, long long xw_st,
                                   long long xw_sn, long long y_st,
                                   long long y_sn, int t, int n, int h,
                                   int dtype, void* stream, int* route) {
  using namespace dl4j_lstm;
  if (t < 1 || n < 1 || h < 1 || (pi == nullptr) != (pf == nullptr) ||
      (pi == nullptr) != (po == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a{xw, r, h0, c0, pi, pf, po, static_cast<const float*>(mask),
               y, ht, ct, xw_st, xw_sn, y_st, y_sn, t, n, h, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)run<float>(a, s, route);
    case kBF16:
      return (int)run<__nv_bfloat16>(a, s, route);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
