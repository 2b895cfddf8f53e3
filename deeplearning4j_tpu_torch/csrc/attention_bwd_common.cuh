// Device code of the CUDA-core attention-backward kernels, which keep the
// first tile design with f32 arithmetic (the tensor cores would round f32
// to TF32): B2's (shortseq_attention_bwd.cu) and B4's and B5's
// (flash_backward.cu), for f32 inputs at every head dim and for every
// dtype at 128 < D <= 256 (the DMAX = 256 instance on 32-row tiles,
// inputs staged as f32 and gradients rounded to their dtype once). Every
// other bf16 / f16 backward runs attention_bwd_core.cuh, which takes
// BwdArgs from here.
//
// The backward from the forward's saved lse and delta = rowsum(dO . O):
//   s  = scale * q . k, replaced by -1e30 where the key is in the causal
//        future or masked (the forward's masking, exactly)
//   p  = exp(s - lse)
//   dv = p^T . dO      ds = p * (dO . v^T - delta) * scale
//   dq = ds . k        dk = ds^T . q
//
// Work is cut into ROWS-query x ROWS-key tile pairs (64, or 32 at DMAX
// 256), and a CTA of 256 threads takes one of two roles:
//
// - dkv (bwd_dkv_f32): one key tile of one b*h. K and V stay staged in
//   shared memory; the CTA walks the query tiles from the causal diagonal
//   to T, and dk, dv accumulate on chip and are written once.
// - dq (bwd_dq_f32): one query tile. Q, dO, lse and delta stay staged;
//   the CTA walks the key tiles up to its causal horizon (causal_end), and
//   dq accumulates on chip and is written once.
//
// Each tile pair recomputes s (= Q K^T) and dO V^T into shared memory,
// turns them into p and ds in one elementwise pass (probs_and_grads), and
// feeds them to the role's products. Tiles wholly in the causal future are
// never visited; a ragged T and the key mask are handled by index (rows
// past T are zero-staged, and their p and ds are 0).

#pragma once

#include "attention_common.cuh"

namespace dl4j {

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

__host__ __device__ __forceinline__ int num_tiles(int t, int rows = kQRows) {
  return (t + rows - 1) / rows;
}

// Turn a ROWS x ROWS tile pair's raw products in place into P (over S) and
// dS (over dP), row stride ss: S holds q . k and dP holds dO . v for query
// rows q0 + r and keys j0 + c. Rows r >= nq and keys c >= nk get
// p = ds = 0. One warp per row, each lane on its own ROWS / 32 entries.
template <int ROWS>
__device__ __forceinline__ void probs_and_grads(float* S, float* dP, int ss,
                                                const float* row_lse,
                                                const float* row_delta,
                                                int q0, int nq, int j0,
                                                int nk, int causal,
                                                const float* km,
                                                float scale) {
  constexpr int KL = ROWS / 32;   // keys a lane
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bool real[KL];
#pragma unroll
  for (int i = 0; i < KL; ++i) {
    const int jl = lane + 32 * i;
    real[i] = jl < nk && (km == nullptr || km[j0 + jl] > 0.f);
  }
  for (int r = warp; r < ROWS; r += kThreads / 32) {
    const float l = row_lse[r], dl = row_delta[r];
#pragma unroll
    for (int i = 0; i < KL; ++i) {
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
template <int ROWS>
__device__ __forceinline__ void stage_row_terms(float* row_lse,
                                                float* row_delta,
                                                const BwdArgs& a, int bh,
                                                int q0, int nq) {
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    const size_t i = (size_t)bh * a.t + q0 + r;
    row_lse[r] = r < nq ? a.lse[i] : 0.f;
    row_delta[r] = r < nq ? a.delta[i] : 0.f;
  }
}

// ---- CUDA-core (f32) variant ----

// c[r][j] = a[r] . b[j] for 16 RA x 16 RA staged f32 rows (row stride ds);
// each thread computes an RA x RA register tile (rows ty + 16i, cols
// tx + 16j).
template <int RA>
__device__ __forceinline__ void f32_abt(float* c, int ss, const float* a,
                                        const float* b, int ds, int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[RA][RA] = {};
  for (int x = 0; x < d; ++x) {
    float av[RA], bv[RA];
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      av[i] = a[(ty + 16 * i) * ds + x];
      bv[i] = b[(tx + 16 * i) * ds + x];
    }
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int j = 0; j < RA; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int j = 0; j < RA; ++j)
      c[(ty + 16 * i) * ss + tx + 16 * j] = acc[i][j];
}

// acc[i][c] += sum_r p[r][ty + 16i] * x[r][tx + 16c] over the 16 RA rows of
// the tile (p transposed: its rows are queries, the result's keys).
template <int DC, int RA>
__device__ __forceinline__ void f32_acc_tn(float (&acc)[RA][DC],
                                           const float* p, int ss,
                                           const float* x, int ds, int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int r = 0; r < 16 * RA; ++r) {
    float pa[RA], xb[DC];
#pragma unroll
    for (int i = 0; i < RA; ++i) pa[i] = p[r * ss + ty + 16 * i];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      xb[c] = col < d ? x[r * ds + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RA; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pa[i], xb[c], acc[i][c]);
  }
}

template <typename T, int DC, int RA>
__device__ __forceinline__ void f32_store_rows(T* out,
                                               const float (&acc)[RA][DC],
                                               int n, int d) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int r = ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) out[(size_t)r * d + col] = from_f32<T>(acc[i][c]);
    }
  }
}

// shared memory of a CTA on rows x rows tile pairs: four staged row tiles,
// S and dP at row stride rows + 1, and the rows' lse and delta
struct F32BwdSmem {
  float *x0, *x1, *y0, *y1, *s, *dp, *row_lse, *row_delta;
  __device__ F32BwdSmem(unsigned char* smem, int ds, int rows) {
    const int tile = rows * ds, ss = rows + 1;
    x0 = reinterpret_cast<float*>(smem);
    x1 = x0 + tile;
    y0 = x1 + tile;
    y1 = y0 + tile;
    s = y1 + tile;
    dp = s + rows * ss;
    row_lse = dp + rows * ss;
    row_delta = row_lse + rows;
  }
};

inline size_t bwd_smem(int d, int rows = kQRows) {
  return sizeof(float) * (4 * (size_t)rows * (d + 1) +
                          2 * (size_t)rows * (rows + 1) + 2 * (size_t)rows);
}

template <typename T, int DMAX, int ROWS>
__device__ __forceinline__ void bwd_dkv_f32(const BwdArgs& a, int bh, int j0,
                                            unsigned char* raw) {
  constexpr int DC = DMAX / 16, RA = ROWS / 16, SS = ROWS + 1;
  const int t = a.t, d = a.d, ds = d + 1;
  const int nk = min(ROWS, t - j0);
  F32BwdSmem sm(raw, ds, ROWS);
  const size_t base = (size_t)bh * t * d;
  const T* q = static_cast<const T*>(a.q) + base;
  const T* dout = static_cast<const T*>(a.dout) + base;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;

  stage_rows(sm.x0, static_cast<const T*>(a.k) + base + (size_t)j0 * d, nk,
             ROWS, d, ds);
  stage_rows(sm.x1, static_cast<const T*>(a.v) + base + (size_t)j0 * d, nk,
             ROWS, d, ds);
  float dk[RA][DC] = {}, dv[RA][DC] = {};
  // from the first query tile whose causal horizon reaches this key tile
  for (int q0 = a.causal ? j0 / kQRows * kQRows : 0; q0 < t; q0 += ROWS) {
    const int nq = min(ROWS, t - q0);
    __syncthreads();
    stage_rows(sm.y0, q + (size_t)q0 * d, nq, ROWS, d, ds);
    stage_rows(sm.y1, dout + (size_t)q0 * d, nq, ROWS, d, ds);
    stage_row_terms<ROWS>(sm.row_lse, sm.row_delta, a, bh, q0, nq);
    __syncthreads();
    f32_abt<RA>(sm.s, SS, sm.y0, sm.x0, ds, d);
    f32_abt<RA>(sm.dp, SS, sm.y1, sm.x1, ds, d);
    __syncthreads();
    probs_and_grads<ROWS>(sm.s, sm.dp, SS, sm.row_lse, sm.row_delta, q0, nq,
                          j0, nk, a.causal, km, a.scale);
    __syncthreads();
    f32_acc_tn<DC>(dv, sm.s, SS, sm.y1, ds, d);
    f32_acc_tn<DC>(dk, sm.dp, SS, sm.y0, ds, d);
  }
  f32_store_rows<T>(static_cast<T*>(a.dk) + base + (size_t)j0 * d, dk, nk,
                    d);
  f32_store_rows<T>(static_cast<T*>(a.dv) + base + (size_t)j0 * d, dv, nk,
                    d);
}

template <typename T, int DMAX, int ROWS>
__device__ __forceinline__ void bwd_dq_f32(const BwdArgs& a, int bh, int q0,
                                           unsigned char* raw) {
  constexpr int DC = DMAX / 16, RA = ROWS / 16, SS = ROWS + 1;
  const int t = a.t, d = a.d, ds = d + 1;
  const int nq = min(ROWS, t - q0);
  const int kend = causal_end(t, q0, a.causal);
  F32BwdSmem sm(raw, ds, ROWS);
  const size_t base = (size_t)bh * t * d;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;

  stage_rows(sm.x0, static_cast<const T*>(a.q) + base + (size_t)q0 * d, nq,
             ROWS, d, ds);
  stage_rows(sm.x1, static_cast<const T*>(a.dout) + base + (size_t)q0 * d,
             nq, ROWS, d, ds);
  stage_row_terms<ROWS>(sm.row_lse, sm.row_delta, a, bh, q0, nq);
  float dq[RA][DC] = {};
  for (int j0 = 0; j0 < kend; j0 += ROWS) {
    const int nk = min(ROWS, kend - j0);
    __syncthreads();
    stage_rows(sm.y0, k + (size_t)j0 * d, nk, ROWS, d, ds);
    stage_rows(sm.y1, v + (size_t)j0 * d, nk, ROWS, d, ds);
    __syncthreads();
    f32_abt<RA>(sm.s, SS, sm.x0, sm.y0, ds, d);
    f32_abt<RA>(sm.dp, SS, sm.x1, sm.y1, ds, d);
    __syncthreads();
    probs_and_grads<ROWS>(sm.s, sm.dp, SS, sm.row_lse, sm.row_delta, q0, nq,
                          j0, nk, a.causal, km, a.scale);
    __syncthreads();
    pv_tile<DC>(dq, sm.dp, SS, sm.y0, ds, d, ROWS);
  }
  f32_store_rows<T>(static_cast<T*>(a.dq) + base + (size_t)q0 * d, dq, nq,
                    d);
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
  return t >= 1 && d >= 8 && d % 8 == 0 && bh >= 1 &&
         bh <= 65535 && h >= 1;
}

}  // namespace dl4j
