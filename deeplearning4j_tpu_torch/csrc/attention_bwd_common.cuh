// Device code of the f32 attention-backward kernels, which keep the first
// tile design on the CUDA cores (the tensor cores would round f32 to
// TF32): B2's (shortseq_attention_bwd.cu) and B4's and B5's
// (flash_backward.cu). Every bf16 / f16 backward runs
// attention_bwd_core.cuh, which takes BwdArgs from here.
//
// The backward from the forward's saved lse and delta = rowsum(dO . O):
//   s  = scale * q . k, replaced by -1e30 where the key is in the causal
//        future or masked (the forward's masking, exactly)
//   p  = exp(s - lse)
//   dv = p^T . dO      ds = p * (dO . v^T - delta) * scale
//   dq = ds . k        dk = ds^T . q
//
// Work is cut into 64-query x 64-key tile pairs, and a CTA of 256 threads
// takes one of two roles:
//
// - dkv (bwd_dkv_f32): one 64-key tile of one b*h. K and V stay staged in
//   shared memory; the CTA walks the query tiles from the causal diagonal
//   to T, and dk, dv accumulate on chip and are written once.
// - dq (bwd_dq_f32): one 64-query tile. Q, dO, lse and delta stay staged;
//   the CTA walks the key tiles up to the causal diagonal, and dq
//   accumulates on chip and is written once.
//
// Each tile pair recomputes s (= Q K^T) and dO V^T into shared memory,
// turns them into p and ds in one elementwise pass (probs_and_grads), and
// feeds them to the role's products. Tiles wholly in the causal future are
// never visited; a ragged T and the key mask are handled by index (rows
// past T are zero-staged, and their p and ds are 0).

#pragma once

#include "attention_common.cuh"

namespace dl4j {

constexpr int kKeyTile = 64;          // keys per tile (queries: kQRows)
constexpr int kBwdF32SS = kKeyTile + 1;  // f32 tile row stride (CUDA cores)

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* kmask;   // [bh / h, t] or null
  const void* dout;
  const float* lse;     // [bh, t]
  const float* delta;   // [bh, t]
  void* dq;
  void* dk;
  void* dv;
  int h, t, d, causal;
  float scale;
};

__host__ __device__ __forceinline__ int num_tiles(int t) {
  return (t + kQRows - 1) / kQRows;
}

// Turn a tile pair's raw products in place into P (over S) and dS (over
// dP), row stride ss: S holds q . k and dP holds dO . v for query rows
// q0 + r and keys j0 + c. Rows r >= nq and keys c >= nk get p = ds = 0.
// One warp per row, each lane on its own two entries.
__device__ __forceinline__ void probs_and_grads(float* S, float* dP, int ss,
                                                const float* row_lse,
                                                const float* row_delta,
                                                int q0, int nq, int j0,
                                                int nk, int causal,
                                                const float* km,
                                                float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bool real[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int jl = lane + 32 * i;
    real[i] = jl < nk && (km == nullptr || km[j0 + jl] > 0.f);
  }
  for (int r = warp; r < kQRows; r += kThreads / 32) {
    const float l = row_lse[r], dl = row_delta[r];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int jl = lane + 32 * i;
      const bool keep = real[i] && (!causal || j0 + jl <= q0 + r);
      const float s = keep ? S[r * ss + jl] * scale : kNeg;
      const float p = r < nq && jl < nk ? expf(s - l) : 0.f;
      S[r * ss + jl] = p;
      dP[r * ss + jl] = p * (dP[r * ss + jl] - dl) * scale;
    }
  }
}

// Stage the lse and delta of query rows [q0, q0 + nq) (0 past nq).
__device__ __forceinline__ void stage_row_terms(float* row_lse,
                                                float* row_delta,
                                                const BwdArgs& a, int bh,
                                                int q0, int nq) {
  if (threadIdx.x < kQRows) {
    const int r = threadIdx.x;
    const size_t i = (size_t)bh * a.t + q0 + r;
    row_lse[r] = r < nq ? a.lse[i] : 0.f;
    row_delta[r] = r < nq ? a.delta[i] : 0.f;
  }
}

// ---- CUDA-core (f32) variant ----

// c[r][j] = a[r] . b[j] for 64 x 64 staged f32 rows (row stride ds); each
// thread computes a 4 x 4 register tile (rows ty + 16i, cols tx + 16j).
__device__ __forceinline__ void f32_abt(float* c, int ss, const float* a,
                                        const float* b, int ds, int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int x = 0; x < d; ++x) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = a[(ty + 16 * i) * ds + x];
      bv[i] = b[(tx + 16 * i) * ds + x];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[(ty + 16 * i) * ss + tx + 16 * j] = acc[i][j];
}

// acc[i][c] += sum_r p[r][ty + 16i] * x[r][tx + 16c] over the 64 rows of
// the tile (p transposed: its rows are queries, the result's keys).
template <int DC>
__device__ __forceinline__ void f32_acc_tn(float (&acc)[4][DC],
                                           const float* p, int ss,
                                           const float* x, int ds, int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int r = 0; r < kQRows; ++r) {
    float pa[4], xb[DC];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = p[r * ss + ty + 16 * i];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      xb[c] = col < d ? x[r * ds + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pa[i], xb[c], acc[i][c]);
  }
}

template <int DC>
__device__ __forceinline__ void f32_store_rows(float* out,
                                               const float (&acc)[4][DC],
                                               int n, int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) out[(size_t)r * d + col] = acc[i][c];
    }
  }
}

struct F32BwdSmem {
  float *x0, *x1, *y0, *y1, *s, *dp, *row_lse, *row_delta;
  __device__ F32BwdSmem(unsigned char* smem, int ds) {
    const int tile = kQRows * ds;
    x0 = reinterpret_cast<float*>(smem);
    x1 = x0 + tile;
    y0 = x1 + tile;
    y1 = y0 + tile;
    s = y1 + tile;
    dp = s + kQRows * kBwdF32SS;
    row_lse = dp + kQRows * kBwdF32SS;
    row_delta = row_lse + kQRows;
  }
};

inline size_t bwd_smem(int d) {
  return sizeof(float) * (4 * (size_t)kQRows * (d + 1) +
                          2 * (size_t)kQRows * kBwdF32SS + 2 * kQRows);
}

template <int DMAX>
__device__ __forceinline__ void bwd_dkv_f32(const BwdArgs& a, int bh, int j0,
                                            unsigned char* raw) {
  constexpr int DC = DMAX / 16;
  const int t = a.t, d = a.d, ds = d + 1;
  const int nk = min(kKeyTile, t - j0);
  F32BwdSmem sm(raw, ds);
  const size_t base = (size_t)bh * t * d;
  const float* q = static_cast<const float*>(a.q) + base;
  const float* dout = static_cast<const float*>(a.dout) + base;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;

  stage_rows(sm.x0, static_cast<const float*>(a.k) + base + (size_t)j0 * d,
             nk, kKeyTile, d, ds);
  stage_rows(sm.x1, static_cast<const float*>(a.v) + base + (size_t)j0 * d,
             nk, kKeyTile, d, ds);
  float dk[4][DC] = {}, dv[4][DC] = {};
  for (int q0 = a.causal ? j0 : 0; q0 < t; q0 += kQRows) {
    const int nq = min(kQRows, t - q0);
    __syncthreads();
    stage_rows(sm.y0, q + (size_t)q0 * d, nq, kQRows, d, ds);
    stage_rows(sm.y1, dout + (size_t)q0 * d, nq, kQRows, d, ds);
    stage_row_terms(sm.row_lse, sm.row_delta, a, bh, q0, nq);
    __syncthreads();
    f32_abt(sm.s, kBwdF32SS, sm.y0, sm.x0, ds, d);
    f32_abt(sm.dp, kBwdF32SS, sm.y1, sm.x1, ds, d);
    __syncthreads();
    probs_and_grads(sm.s, sm.dp, kBwdF32SS, sm.row_lse, sm.row_delta,
                           q0, nq, j0, nk, a.causal, km, a.scale);
    __syncthreads();
    f32_acc_tn<DC>(dv, sm.s, kBwdF32SS, sm.y1, ds, d);
    f32_acc_tn<DC>(dk, sm.dp, kBwdF32SS, sm.y0, ds, d);
  }
  f32_store_rows<DC>(static_cast<float*>(a.dk) + base + (size_t)j0 * d, dk,
                     nk, d);
  f32_store_rows<DC>(static_cast<float*>(a.dv) + base + (size_t)j0 * d, dv,
                     nk, d);
}

template <int DMAX>
__device__ __forceinline__ void bwd_dq_f32(const BwdArgs& a, int bh, int q0,
                                           unsigned char* raw) {
  constexpr int DC = DMAX / 16;
  const int t = a.t, d = a.d, ds = d + 1;
  const int nq = min(kQRows, t - q0);
  const int kend = a.causal ? min(t, q0 + kQRows) : t;
  F32BwdSmem sm(raw, ds);
  const size_t base = (size_t)bh * t * d;
  const float* k = static_cast<const float*>(a.k) + base;
  const float* v = static_cast<const float*>(a.v) + base;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;

  stage_rows(sm.x0, static_cast<const float*>(a.q) + base + (size_t)q0 * d,
             nq, kQRows, d, ds);
  stage_rows(sm.x1,
             static_cast<const float*>(a.dout) + base + (size_t)q0 * d, nq,
             kQRows, d, ds);
  stage_row_terms(sm.row_lse, sm.row_delta, a, bh, q0, nq);
  float dq[4][DC] = {};
  for (int j0 = 0; j0 < kend; j0 += kKeyTile) {
    const int nk = min(kKeyTile, kend - j0);
    __syncthreads();
    stage_rows(sm.y0, k + (size_t)j0 * d, nk, kKeyTile, d, ds);
    stage_rows(sm.y1, v + (size_t)j0 * d, nk, kKeyTile, d, ds);
    __syncthreads();
    f32_abt(sm.s, kBwdF32SS, sm.x0, sm.y0, ds, d);
    f32_abt(sm.dp, kBwdF32SS, sm.x1, sm.y1, ds, d);
    __syncthreads();
    probs_and_grads(sm.s, sm.dp, kBwdF32SS, sm.row_lse, sm.row_delta,
                           q0, nq, j0, nk, a.causal, km, a.scale);
    __syncthreads();
    pv_tile<DC>(dq, sm.dp, kBwdF32SS, sm.y0, ds, d, kKeyTile);
  }
  f32_store_rows<DC>(static_cast<float*>(a.dq) + base + (size_t)q0 * d, dq,
                     nq, d);
}

// ---- host side ----

template <typename Kern>
cudaError_t launch_bwd(Kern kern, dim3 grid, size_t smem, const BwdArgs& a,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

inline bool bwd_shape_ok(int bh, int h, int t, int d) {
  return t >= 1 && d >= 8 && d <= 128 && d % 8 == 0 && bh >= 1 &&
         bh <= 65535 && h >= 1;
}

}  // namespace dl4j
