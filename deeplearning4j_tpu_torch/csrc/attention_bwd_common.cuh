// Device code of the attention-backward kernels that keep PR 2's tile
// design: B4 (flash_backward.cu, flash_attention_bwd_dq) for every input
// type, and the f32 kernels of B2 and B5 (shortseq_attention_bwd.cu,
// flash_backward.cu). The bf16 / f16 B2 and B5 run attention_bwd_core.cuh,
// which takes BwdArgs from here.
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
//   to T, and dk, dv accumulate on chip (f32) and are written once.
// - dq (bwd_dq_*): one 64-query tile. Q, dO, lse and delta stay staged;
//   the CTA walks the key tiles up to the causal diagonal, and dq
//   accumulates on chip and is written once.
//
// Each tile pair recomputes s (= Q K^T) and dO V^T into shared memory,
// turns them into p and ds in one elementwise pass (probs_and_grads), and
// feeds them to the role's products. Tiles wholly in the causal future are
// never visited; a ragged T and the key mask are handled by index (rows
// past T are zero-staged, and their p and ds are 0).
//
// bf16 / f16 inputs (B4's bwd_dq_tc) run every product on the tensor cores
// (WMMA 16x16x16, f32 accumulation; p and ds are rounded to the input type
// before their products, as the TPU kernels round them). f32 inputs run
// the same algorithm on the CUDA cores (the tensor cores would round to
// TF32).

#pragma once

#include "attention_common.cuh"

namespace dl4j {

constexpr int kKeyTile = 64;          // keys per tile (queries: kQRows)
constexpr int kBwdTcSS = kKeyTile + 4;   // f32 tile row stride (WMMA)
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
// dP), both of type P with row stride ss * 4 / sizeof(P): S holds q . k
// and dP holds dO . v for query rows q0 + r and keys j0 + c. Rows r >= nq
// and keys c >= nk get p = ds = 0. One warp per row; every lane reads its
// two entries of both rows before any lane writes (a 16-bit row overlaps
// the first half of the f32 row it replaces).
template <typename P>
__device__ __forceinline__ void probs_and_grads(float* S, float* dP, int ss,
                                                const float* row_lse,
                                                const float* row_delta,
                                                int q0, int nq, int j0,
                                                int nk, int causal,
                                                const float* km,
                                                float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pld = ss * (int)(sizeof(float) / sizeof(P));
  P* ps = reinterpret_cast<P*>(S);
  P* dss = reinterpret_cast<P*>(dP);
  bool real[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int jl = lane + 32 * i;
    real[i] = jl < nk && (km == nullptr || km[j0 + jl] > 0.f);
  }
  for (int r = warp; r < kQRows; r += kThreads / 32) {
    const float l = row_lse[r], dl = row_delta[r];
    float pv[2], dv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int jl = lane + 32 * i;
      const bool keep = real[i] && (!causal || j0 + jl <= q0 + r);
      const float s = keep ? S[r * ss + jl] * scale : kNeg;
      float p = 0.f;
      if (r < nq && jl < nk) {
        if constexpr (std::is_same<P, float>::value)
          p = expf(s - l);
        else
          p = __expf(s - l);
      }
      pv[i] = p;
      dv[i] = p * (dP[r * ss + jl] - dl) * scale;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int jl = lane + 32 * i;
      ps[r * pld + jl] = from_f32<P>(pv[i]);
      dss[r * pld + jl] = from_f32<P>(dv[i]);
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

// ---- tensor-core (bf16 / f16) variant ----

// C[64][ss] (f32) = A[64][ld] . B[64][ld]^T over dpad columns; warp rb
// computes rows rb*16.. and column blocks half, half + 2.
template <typename T>
__device__ __forceinline__ void tc_abt(float* c, int ss, const T* a,
                                       const T* b, int ld, int dpad, int rb,
                                       int half) {
  for (int cb = half; cb < kKeyTile / 16; cb += 2) {
    FragC acc;
    nvcuda::wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < dpad / 16; ++kk) {
      FragA<T> fa;
      FragBT<T> fb;
      nvcuda::wmma::load_matrix_sync(fa, a + rb * 16 * ld + kk * 16, ld);
      nvcuda::wmma::load_matrix_sync(fb, b + cb * 16 * ld + kk * 16, ld);
      nvcuda::wmma::mma_sync(acc, fa, fb, acc);
    }
    nvcuda::wmma::store_matrix_sync(c + rb * 16 * ss + cb * 16, acc, ss,
                                    nvcuda::wmma::mem_row_major);
  }
}

// acc[f] += P . X for the warp's rows rb*16.. and column blocks
// half + 2f: P is the 64 x 64 16-bit tile p or ds (row stride pld); X is
// staged [64][ld].
template <typename T, int FPW>
__device__ __forceinline__ void tc_acc(FragC (&acc)[FPW], const T* p,
                                       int pld, const T* x, int ld,
                                       int dpad, int rb, int half) {
  for (int kk = 0; kk < kKeyTile / 16; ++kk) {
    FragA<T> fa;
    nvcuda::wmma::load_matrix_sync(fa, p + rb * 16 * pld + kk * 16, pld);
#pragma unroll
    for (int f = 0; f < FPW; ++f) {
      const int cb = half + 2 * f;
      if (cb < dpad / 16) {
        FragB<T> fb;
        nvcuda::wmma::load_matrix_sync(fb, x + kk * 16 * ld + cb * 16, ld);
        nvcuda::wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }
}

// Write the accumulated rows [0, n) of a [64, d] f32 result to out (type
// T) through the f32 staging block stage[64][dpad].
template <typename T, int FPW>
__device__ __forceinline__ void tc_store_rows(T* out, float* stage,
                                              const FragC (&acc)[FPW], int n,
                                              int d, int dpad, int rb,
                                              int half) {
#pragma unroll
  for (int f = 0; f < FPW; ++f) {
    const int cb = half + 2 * f;
    if (cb < dpad / 16)
      nvcuda::wmma::store_matrix_sync(stage + rb * 16 * dpad + cb * 16,
                                      acc[f], dpad,
                                      nvcuda::wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    out[(size_t)r * d + c] = from_f32<T>(stage[r * dpad + c]);
  }
  __syncthreads();
}

// Shared-memory carve-up of the dq role: two resident tiles (X0, X1), two
// streamed tiles (Y0, Y1), the S and dP tiles, and the row terms.
template <typename T>
struct TcBwdSmem {
  T *x0, *x1, *y0, *y1;
  float *s, *dp, *row_lse, *row_delta;
  __device__ TcBwdSmem(unsigned char* smem, int ld) {
    const size_t tile = (size_t)kQRows * ld;
    x0 = reinterpret_cast<T*>(smem);
    x1 = x0 + tile;
    y0 = x1 + tile;
    y1 = y0 + tile;
    s = reinterpret_cast<float*>(y1 + tile);
    dp = s + kQRows * kBwdTcSS;
    row_lse = dp + kQRows * kBwdTcSS;
    row_delta = row_lse + kQRows;
  }
};

inline size_t tc_bwd_smem(int d, size_t elem) {
  const size_t ld = round_up16(d) + 8;
  return elem * 4 * kQRows * ld +
         sizeof(float) * (2 * (size_t)kQRows * kBwdTcSS + 2 * kQRows);
}

// dq role: query tile q0 of head bh.
template <typename T, int DMAX>
__device__ __forceinline__ void bwd_dq_tc(const BwdArgs& a, int bh, int q0,
                                          unsigned char* raw) {
  constexpr int FPW = DMAX / 32 > 0 ? DMAX / 32 : 1;
  const int t = a.t, d = a.d, dpad = round_up16(d), ld = dpad + 8;
  const int nq = min(kQRows, t - q0);
  const int kend = a.causal ? min(t, q0 + kQRows) : t;
  TcBwdSmem<T> sm(raw, ld);
  const size_t base = (size_t)bh * t * d;
  const T* k = static_cast<const T*>(a.k) + base;
  const T* v = static_cast<const T*>(a.v) + base;
  const float* km = a.kmask ? a.kmask + (size_t)(bh / a.h) * t : nullptr;
  const int warp = threadIdx.x >> 5, rb = warp & 3, half = warp >> 2;

  stage_tile(sm.x0, static_cast<const T*>(a.q) + base + (size_t)q0 * d, nq,
             kQRows, d, dpad, ld);
  stage_tile(sm.x1, static_cast<const T*>(a.dout) + base + (size_t)q0 * d,
             nq, kQRows, d, dpad, ld);
  stage_row_terms(sm.row_lse, sm.row_delta, a, bh, q0, nq);
  FragC dq[FPW];
#pragma unroll
  for (int f = 0; f < FPW; ++f) nvcuda::wmma::fill_fragment(dq[f], 0.f);
  for (int j0 = 0; j0 < kend; j0 += kKeyTile) {
    const int nk = min(kKeyTile, kend - j0);
    __syncthreads();
    stage_tile(sm.y0, k + (size_t)j0 * d, nk, kKeyTile, d, dpad, ld);
    stage_tile(sm.y1, v + (size_t)j0 * d, nk, kKeyTile, d, dpad, ld);
    __syncthreads();
    tc_abt(sm.s, kBwdTcSS, sm.x0, sm.y0, ld, dpad, rb, half);
    tc_abt(sm.dp, kBwdTcSS, sm.x1, sm.y1, ld, dpad, rb, half);
    __syncthreads();
    probs_and_grads<T>(sm.s, sm.dp, kBwdTcSS, sm.row_lse, sm.row_delta, q0,
                       nq, j0, nk, a.causal, km, a.scale);
    __syncthreads();
    tc_acc<T, FPW>(dq, reinterpret_cast<const T*>(sm.dp), 2 * kBwdTcSS,
                   sm.y0, ld, dpad, rb, half);
  }
  __syncthreads();
  tc_store_rows<T, FPW>(static_cast<T*>(a.dq) + base + (size_t)q0 * d,
                        reinterpret_cast<float*>(sm.y0), dq, nq, d, dpad, rb,
                        half);
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

inline size_t f32_bwd_smem(int d) {
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
    probs_and_grads<float>(sm.s, sm.dp, kBwdF32SS, sm.row_lse, sm.row_delta,
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
    probs_and_grads<float>(sm.s, sm.dp, kBwdF32SS, sm.row_lse, sm.row_delta,
                           q0, nq, j0, nk, a.causal, km, a.scale);
    __syncthreads();
    pv_tile<DC>(dq, sm.dp, kBwdF32SS, sm.y0, ds, d, kKeyTile);
  }
  f32_store_rows<DC>(static_cast<float*>(a.dq) + base + (size_t)q0 * d, dq,
                     nq, d);
}

// B4's work for the CTA, by element type.
template <typename T, int DMAX>
__device__ __forceinline__ void bwd_dq(const BwdArgs& a, int bh, int q0,
                                       unsigned char* smem) {
  if constexpr (std::is_same<T, float>::value)
    bwd_dq_f32<DMAX>(a, bh, q0, smem);
  else
    bwd_dq_tc<T, DMAX>(a, bh, q0, smem);
}

// ---- host side ----

template <typename T>
size_t bwd_smem(int d) {
  if constexpr (std::is_same<T, float>::value)
    return f32_bwd_smem(d);
  else
    return tc_bwd_smem(d, sizeof(T));
}

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
