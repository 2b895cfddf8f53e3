// Attention at head dims above 256 (every dtype), for all five attention
// entries: B1's and B3's forwards (shortseq_attention.cu,
// flash_forward.cu), B2's backward (shortseq_attention_bwd.cu, which
// launches both roles) and B4's and B5's (flash_backward.cu).
//
// No CTA holds a whole row of q, k or v at such a D: the output's columns
// are split over the grid instead. A CTA owns kWSlice (128) columns of o
// (forward), of dq (dq role) or of dk and dv (dkv role) for one tile of
// kWRows (32) rows, and forms the full-D products it needs (q . k^T, and
// dO . v^T in the backward) by looping over D in kWChunk-column chunks
// staged through shared memory as f32. Each slice recomputes those scores:
// the work grows with D / 128, which is right and simple; speed is later
// work. lse is written once, by the slice-0 CTAs.
//
// The forward is the streaming (online) softmax over 32-key tiles up to
// the 64-row group's causal horizon (causal_end), like the other kernels;
// masked logits are replaced by kNeg, so a fully masked row averages the
// same keys. The backward recomputes p = exp(s - lse), with delta from the
// caller, on the same horizon: the dkv role walks the query tiles from the
// key tile's 64-row group on, the dq role the key tiles up to its horizon.
// Arithmetic is f32 throughout; outputs are rounded to their dtype once.

#pragma once

#include "attention_bwd_common.cuh"

namespace dl4j {

constexpr int kWRows = 32;    // query rows (and keys) of a tile
constexpr int kWChunk = 64;   // D columns staged per product pass
constexpr int kWSlice = 128;  // output columns a CTA owns
constexpr int kWCs = kWChunk + 1, kWSs = kWRows + 1, kWVs = kWSlice + 1;

__host__ __device__ __forceinline__ int wide_slices(int d) {
  return (d + kWSlice - 1) / kWSlice;
}

// Columns [c0, c0 + w) of rows [0, n) of a row-major [*, d] tensor into
// dst as f32 at row stride ds; rows [n, kWRows) are zero-filled.
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, const T* src, int n,
                                           int d, int c0, int w, int ds) {
  for (int i = threadIdx.x; i < kWRows * w; i += kThreads) {
    const int r = i / w, c = i - r * w;
    dst[r * ds + c] = r < n ? to_f32(src[(size_t)r * d + c0 + c]) : 0.f;
  }
}

// acc[i][j] = a_(ty + 16i) . b_(tx + 16j) over all d columns, for the
// kWRows rows of a (na real) and of b (nb real), staged chunk by chunk
// through as / bs. Starts and ends with a block barrier.
template <typename T>
__device__ __forceinline__ void wide_abt(float (&acc)[2][2], const T* a,
                                         int na, const T* b, int nb, int d,
                                         float* as, float* bs) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < d; c0 += kWChunk) {
    const int w = min(kWChunk, d - c0);
    __syncthreads();
    stage_cols(as, a, na, d, c0, w, kWCs);
    stage_cols(bs, b, nb, d, c0, w, kWCs);
    __syncthreads();
    for (int x = 0; x < w; ++x) {
      const float a0 = as[ty * kWCs + x], a1 = as[(ty + 16) * kWCs + x];
      const float b0 = bs[tx * kWCs + x], b1 = bs[(tx + 16) * kWCs + x];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
  }
  __syncthreads();
}

// out[r][s0 + col] = acc[i][c] * inv[r] for rows r = ty + 16i < n and the
// slice's sw columns (row stride d).
template <typename T>
__device__ __forceinline__ void wide_store(T* out, const float (&acc)[2][8],
                                           const float* inv, int n, int d,
                                           int s0, int sw) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    if (r >= n) continue;
    const float f = inv ? inv[r] : 1.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = tx + 16 * c;
      if (col < sw)
        out[(size_t)r * d + s0 + col] = from_f32<T>(acc[i][c] * f);
    }
  }
}

struct WideSmem {
  float *as, *bs, *s0, *s1, *x0, *x1, *r0, *r1, *r2;
  __device__ explicit WideSmem(unsigned char* raw) {
    as = reinterpret_cast<float*>(raw);
    bs = as + kWRows * kWCs;
    s0 = bs + kWRows * kWCs;
    s1 = s0 + kWRows * kWSs;
    x0 = s1 + kWRows * kWSs;
    x1 = x0 + kWRows * kWVs;
    r0 = x1 + kWRows * kWVs;
    r1 = r0 + kWRows;
    r2 = r1 + kWRows;
  }
};

inline size_t wide_smem() {
  return sizeof(float) * (2 * (size_t)kWRows * kWCs +
                          2 * (size_t)kWRows * kWSs +
                          2 * (size_t)kWRows * kWVs + 3 * (size_t)kWRows);
}

// blockIdx.x = tile * slices + slice, blockIdx.y = b*h.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_wide_fwd_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ kmask,
                              T* __restrict__ o, float* __restrict__ lse,
                              int h, int t, int d, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char raw[];
  WideSmem sm(raw);
  const int nsl = wide_slices(d), sl = blockIdx.x % nsl;
  const int bh = blockIdx.y, q0 = blockIdx.x / nsl * kWRows;
  const int nq = min(kWRows, t - q0), kend = causal_end(t, q0, causal);
  const int s0 = sl * kWSlice, sw = min(kWSlice, d - s0);
  const size_t base = (size_t)bh * t * d;
  const float* km = kmask ? kmask + (size_t)(bh / h) * t : nullptr;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* row_m = sm.r0;
  float* row_l = sm.r1;
  float* row_a = sm.r2;
  if (threadIdx.x < kWRows) {
    row_m[threadIdx.x] = -INFINITY;
    row_l[threadIdx.x] = 0.f;
  }
  float acc[2][8] = {};
  for (int j0 = 0; j0 < kend; j0 += kWRows) {
    const int nk = min(kWRows, kend - j0);
    float s[2][2];
    wide_abt(s, q + base + (size_t)q0 * d, nq, k + base + (size_t)j0 * d, nk,
             d, sm.as, sm.bs);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, jl = tx + 16 * j, key = j0 + jl;
        const bool keep = (!causal || key <= q0 + r) &&
                          (km == nullptr || km[key] > 0.f);
        sm.s0[r * kWSs + jl] =
            jl >= nk ? -INFINITY : keep ? s[i][j] * scale : kNeg;
      }
    stage_cols(sm.x0, v + base + (size_t)j0 * d, nk, d, s0, sw, kWVs);
    __syncthreads();
    // the streaming softmax, one warp a row, one lane a key
    for (int r = warp; r < kWRows; r += kThreads / 32) {
      const float x = sm.s0[r * kWSs + lane];
      const float mo = row_m[r], mn = fmaxf(mo, warp_max(x));
      const float p = lane < nk ? expf(x - mn) : 0.f;
      const float sum = warp_sum(p);
      sm.s0[r * kWSs + lane] = p;
      if (lane == 0) {
        const float alpha = expf(mo - mn);
        row_a[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = mn;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float alpha = row_a[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
    pv_tile<8, 2>(acc, sm.s0, kWSs, sm.x0, kWVs, sw, nk);
  }
  __syncthreads();
  if (threadIdx.x < kWRows) {
    const int r = threadIdx.x;
    const float l = fmaxf(row_l[r], kMinL);
    row_a[r] = 1.f / l;
    if (sl == 0 && r < nq) lse[(size_t)bh * t + q0 + r] = row_m[r] + logf(l);
  }
  __syncthreads();
  wide_store<T>(o + base + (size_t)q0 * d, acc, row_a, nq, d, s0, sw);
}

// p and ds of one tile pair from the raw products s = q . k and
// dp = dO . v for query row qr (of nq), key kj (of nk): 0 past either.
__device__ __forceinline__ void wide_p_ds(float s, float dp, int qr, int kj,
                                          int q0, int j0, int nq, int nk,
                                          int causal, const float* km,
                                          float lse, float delta, float scale,
                                          float& p, float& ds) {
  const int key = j0 + kj;
  const bool real = qr < nq && kj < nk;
  const bool keep = real && (!causal || key <= q0 + qr) &&
                    (km == nullptr || km[key] > 0.f);
  p = real ? expf((keep ? s * scale : kNeg) - lse) : 0.f;
  ds = p * (dp - delta) * scale;
}

// dq role: one 32-row query tile, one slice of dq's columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_wide_dq_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char raw[];
  WideSmem sm(raw);
  const int t = a.t, d = a.d, nsl = wide_slices(d), sl = blockIdx.x % nsl;
  const int bh = blockIdx.y, q0 = blockIdx.x / nsl * kWRows;
  const int nq = min(kWRows, t - q0), kend = causal_end(t, q0, a.causal);
  const int s0 = sl * kWSlice, sw = min(kWSlice, d - s0);
  const size_t base = (size_t)bh * t * d;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  stage_row_terms<kWRows>(sm.r0, sm.r1, a, bh, q0, nq);
  float dq[2][8] = {};
  for (int j0 = 0; j0 < kend; j0 += kWRows) {
    const int nk = min(kWRows, kend - j0);
    float s[2][2], dp[2][2];
    wide_abt(s, q + (size_t)q0 * d, nq, k + (size_t)j0 * d, nk, d, sm.as,
             sm.bs);
    wide_abt(dp, dout + (size_t)q0 * d, nq, v + (size_t)j0 * d, nk, d, sm.as,
             sm.bs);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = ty + 16 * i, jl = tx + 16 * j;
        float p, ds;
        wide_p_ds(s[i][j], dp[i][j], r, jl, q0, j0, nq, nk, a.causal, km,
                  sm.r0[r], sm.r1[r], a.scale, p, ds);
        sm.s0[r * kWSs + jl] = ds;
      }
    stage_cols(sm.x0, k + (size_t)j0 * d, nk, d, s0, sw, kWVs);
    __syncthreads();
    pv_tile<8, 2>(dq, sm.s0, kWSs, sm.x0, kWVs, sw, nk);
  }
  wide_store<T>(static_cast<T*>(a.dq) + base + (size_t)q0 * d, dq, nullptr,
                nq, d, s0, sw);
}

// dkv role: one 32-key tile, one slice of dk's and dv's columns; the
// products are formed transposed (rows are keys, columns queries).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_wide_dkv_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char raw[];
  WideSmem sm(raw);
  const int t = a.t, d = a.d, nsl = wide_slices(d), sl = blockIdx.x % nsl;
  const int bh = blockIdx.y, j0 = blockIdx.x / nsl * kWRows;
  const int nk = min(kWRows, t - j0);
  const int s0 = sl * kWSlice, sw = min(kWSlice, d - s0);
  const size_t base = (size_t)bh * t * d;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float dk[2][8] = {}, dv[2][8] = {};
  // from the first query tile whose causal horizon reaches this key tile
  for (int q0 = a.causal ? j0 / kQRows * kQRows : 0; q0 < t; q0 += kWRows) {
    const int nq = min(kWRows, t - q0);
    float st[2][2], dpt[2][2];
    wide_abt(st, k + (size_t)j0 * d, nk, q + (size_t)q0 * d, nq, d, sm.as,
             sm.bs);
    wide_abt(dpt, v + (size_t)j0 * d, nk, dout + (size_t)q0 * d, nq, d,
             sm.as, sm.bs);
    stage_row_terms<kWRows>(sm.r0, sm.r1, a, bh, q0, nq);
    stage_cols(sm.x0, dout + (size_t)q0 * d, nq, d, s0, sw, kWVs);
    stage_cols(sm.x1, q + (size_t)q0 * d, nq, d, s0, sw, kWVs);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = ty + 16 * i, qr = tx + 16 * j;
        float p, ds;
        wide_p_ds(st[i][j], dpt[i][j], qr, kj, q0, j0, nq, nk, a.causal, km,
                  sm.r0[qr], sm.r1[qr], a.scale, p, ds);
        sm.s0[kj * kWSs + qr] = p;
        sm.s1[kj * kWSs + qr] = ds;
      }
    __syncthreads();
    pv_tile<8, 2>(dv, sm.s0, kWSs, sm.x0, kWVs, sw, nq);
    pv_tile<8, 2>(dk, sm.s1, kWSs, sm.x1, kWVs, sw, nq);
  }
  wide_store<T>(static_cast<T*>(a.dk) + base + (size_t)j0 * d, dk, nullptr,
                nk, d, s0, sw);
  wide_store<T>(static_cast<T*>(a.dv) + base + (size_t)j0 * d, dv, nullptr,
                nk, d, s0, sw);
}

// ---- host side ----

template <typename T>
cudaError_t launch_wide_fwd(const void* q, const void* k, const void* v,
                            const void* kmask, void* o, void* lse, int bh,
                            int h, int t, int d, int causal, float scale,
                            cudaStream_t stream) {
  const size_t smem = wide_smem();
  cudaError_t err =
      cudaFuncSetAttribute(attention_wide_fwd_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_tiles(t, kWRows) * wide_slices(d), bh);
  attention_wide_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kmask),
      static_cast<T*>(o), static_cast<float*>(lse), h, t, d, causal, scale);
  return cudaGetLastError();
}

// The dq role (dq) or the dkv role (!dq) at D > 256.
template <typename T>
cudaError_t launch_wide_bwd(bool dq, const BwdArgs& a, int bh,
                            cudaStream_t stream) {
  const dim3 grid(num_tiles(a.t, kWRows) * wide_slices(a.d), bh);
  return launch_bwd(dq ? attention_wide_dq_kernel<T>
                       : attention_wide_dkv_kernel<T>,
                    grid, wide_smem(), a, stream);
}

}  // namespace dl4j
