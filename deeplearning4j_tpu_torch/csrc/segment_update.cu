// Deterministic segment update of an embedding table, in place:
//   table[v, :] += lr * S_v / sqrt(max(W_v, 1)),
//   S_v = sum of updates[i, :] and W_v = sum of weights[i] over the i with
//   idx[i] == v (optionally each value rounded to bf16 first),
// for every row v that idx names; the other rows are unchanged.
//
// Replaces no TPU kernel: it is the JAX package's _segment_update
// (nlp/skipgram.py:150), which XLA runs as a bf16 one-hot matmul or an f32
// scatter-add, both deterministic on the TPU. On the card the library's
// sums are float atomics (index_add_: another order of summation each
// run) or a sorted accumulation that walks a row's duplicates one after
// another in one warp (index_put_ with accumulate: a Zipf-hot row such as
// the Huffman root, which every hierarchical-softmax pair updates, is then
// thousands of dependent steps long: 4.5 ms a call at the HS corpus scan's
// shape, 97% of its device time).
//
// Design: the wrapper sorts idx stably (sidx, perm). Pass 1 gives each
// warp a tile of TILE sorted positions; it walks them in order, summing
// [updates | weight] of perm[j] (lanes over the d + 1 columns) and writing
// the running sum of each run of equal keys at the run's last position in
// the tile, and records where each key's run starts and ends. Pass 2
// gives each warp one row: it adds the row's per-tile sums in tile order
// and applies the update in f32 in the JAX package's order (lr * S, then
// / sqrt(max(W, 1)), then + table). Every sum has a fixed order, so the
// result is the same on every run; a row whose entries fit one tile is
// summed in index order, as the CPU's serial index_add_ sums it. Bound by
// bytes: the updates read once, the named rows read and written once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;          // sorted positions a warp walks in pass 1
constexpr int COLS = 8;           // columns a lane carries (256 a warp)
constexpr int THREADS = 256;

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(THREADS)
segment_update_pass1(const long long* __restrict__ sidx,
                     const long long* __restrict__ perm,
                     const float* __restrict__ updates,
                     const float* __restrict__ weights,
                     float* __restrict__ partial, int* __restrict__ start,
                     int* __restrict__ end, long long n, long long rows,
                     int d, int bf16) {
  const long long tile = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  const long long t0 = tile * TILE;
  if (t0 >= n) return;
  const long long t1 = t0 + TILE < n ? t0 + TILE : n;
  for (long long j = t0 + lane; j < t1; j += 32) {
    const long long key = sidx[j];
    if (key < 0 || key >= rows) continue;     // out of range: never read
    if (j == 0 || sidx[j - 1] != key) start[key] = (int)j;
    if (j == n - 1 || sidx[j + 1] != key) end[key] = (int)(j + 1);
  }
  const int w = d + 1;
  for (int cb = 0; cb < w; cb += 32 * COLS) {
    float acc[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) acc[k] = 0.f;
    for (long long j = t0; j < t1; ++j) {
      const long long src = perm[j];
      const float* row = updates + src * (long long)d;
#pragma unroll
      for (int k = 0; k < COLS; ++k) {
        const int c = cb + lane + 32 * k;
        if (c < w) {
          float x = c < d ? row[c] : weights[src];
          if (bf16) x = to_bf16(x);
          acc[k] += x;
        }
      }
      if (j == t1 - 1 || sidx[j + 1] != sidx[j]) {
        float* dst = partial + j * (long long)w;
#pragma unroll
        for (int k = 0; k < COLS; ++k) {
          const int c = cb + lane + 32 * k;
          if (c < w) dst[c] = acc[k];
          acc[k] = 0.f;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
segment_update_pass2(const float* __restrict__ partial,
                     const int* __restrict__ start,
                     const int* __restrict__ end, float* __restrict__ table,
                     long long rows, int d, float lr) {
  const long long v = ((long long)blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (v >= rows) return;
  const long long s = start[v], e = end[v];
  if (s >= e) return;               // no entry: lr * 0 / 1 adds nothing
  const int w = d + 1;
  const long long k0 = s / TILE, k1 = (e - 1) / TILE;
  float cnt = 0.f;
  for (long long k = k0; k <= k1; ++k) {
    const long long last = ((k + 1) * TILE < e ? (k + 1) * TILE : e) - 1;
    cnt += partial[last * w + d];
  }
  const float denom = sqrtf(fmaxf(cnt, 1.f));
  float* dst = table + v * (long long)d;
  for (int c = lane; c < d; c += 32) {
    float acc = 0.f;
    for (long long k = k0; k <= k1; ++k) {
      const long long last = ((k + 1) * TILE < e ? (k + 1) * TILE : e) - 1;
      acc += partial[last * w + c];
    }
    dst[c] = dst[c] + (lr * acc) / denom;
  }
}

}  // namespace

// sidx / perm: int64 [n] (idx sorted stably and its permutation);
// updates: f32 [n, d] and weights f32 [n], contiguous; partial: f32
// [n, d + 1] scratch; bounds: int32 [2 * rows] scratch (starts, then
// ends); table: f32 [rows, d], updated in place; bf16: round each value
// to bf16 before summing. Returns the CUDA error of the launches (0 when
// they were accepted).
extern "C" int segment_update_f32(const void* sidx, const void* perm,
                                  const void* updates, const void* weights,
                                  void* partial, void* bounds, void* table,
                                  long long n, long long rows, int d,
                                  float lr, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0 || d <= 0 || n <= 0) return 0;
  int* start = (int*)bounds;
  int* end = start + rows;
  cudaError_t err = cudaMemsetAsync(bounds, 0, 2 * rows * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int warps = THREADS / 32;
  const long long tiles = (n + TILE - 1) / TILE;
  segment_update_pass1<<<(unsigned)((tiles + warps - 1) / warps), THREADS, 0,
                         st>>>((const long long*)sidx,
                               (const long long*)perm,
                               (const float*)updates, (const float*)weights,
                               (float*)partial, start, end, n, rows, d,
                               bf16);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  segment_update_pass2<<<(unsigned)((rows + warps - 1) / warps), THREADS, 0,
                         st>>>((const float*)partial, start, end,
                               (float*)table, rows, d, lr);
  return (int)cudaGetLastError();
}
