// Shared device helpers of the flash-attention kernels.
//
// Tiling shared by the three kernels: a block of 128 threads owns one
// 64-row tile and streams the other operand through shared memory in tiles
// of stream_rows<D>() rows: 64, or 32 at head_dim tile 256, where two 64-row
// f32 streamed tiles beside the block's own would pass the H100's 232,448 B
// of shared memory per block.  Each thread owns a 4 x (rows / 8) micro-tile
// of every 64 x rows score tile: rows tr*4 + i (tr = tid / 8, i < 4) and
// columns tc + 8*j (tc = tid % 8), so the 8 threads that share a row are 8
// neighbouring lanes of one warp and reduce a row with three xor-shuffles.
// Tiles are staged in f32 with a row stride of D + 1 floats, which puts the
// 4 rows a warp reads in one step on 4 different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ptflash {

constexpr int BR = 64;          // rows of the block's own tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;  // the JAX package's finite -inf

// Rows of each streamed tile at head_dim tile D.
template <int D> __host__ __device__ constexpr int stream_rows() { return D > 128 ? 32 : 64; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// Element (row, col) of head `hi` of batch row `bi` in a [b, s, h, d] tensor.
__device__ __forceinline__ size_t offset_of(int bi, int row, int hi, int col,
                                            int s, int h, int d) {
  return ((size_t)(bi * s + row) * h + hi) * d + col;
}

// Stage rows [row0, row0 + ROWS) of one head into dst[ROWS][D + 1] as f32;
// rows past the sequence and columns past d are zero.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int bi,
                                          int hi, int s, int h, int d) {
  for (int idx = threadIdx.x; idx < ROWS * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D, row = row0 + r;
    float val = 0.f;
    if (row < s && c < d) val = to_f32(src[offset_of(bi, row, hi, c, s, h, d)]);
    dst[r * (D + 1) + c] = val;
  }
}

// Segment ids of rows [row0, row0 + ROWS): 0 past the end, 1 everywhere
// when there are no segments (every pair then passes the segment test).
template <int ROWS>
__device__ __forceinline__ void load_seg(int* dst, const int* seg, int row0, int bi,
                                         int s) {
  for (int idx = threadIdx.x; idx < ROWS; idx += NTHREADS) {
    const int row = row0 + idx;
    dst[idx] = seg == nullptr ? 1 : (row < s ? seg[bi * s + row] : 0);
  }
}

// acc[i][j] = sum_k A[row_i][k] * B[col_j][k] over the 4 x NJ micro-tile.
template <int D, int NJ>
__device__ __forceinline__ void tile_dot(float (&acc)[4][NJ], const float* a,
                                         const float* b, int tr, int tc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    float av[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(tr * 4 + i) * (D + 1) + k];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[(tc + 8 * j) * (D + 1) + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// out[i][c] += sum_r P[row_i][r] * X[r][tc + 8c] for r < R: P a 64 x R tile
// (stride R + 1), X a staged R x D tile.
template <int D, int R>
__device__ __forceinline__ void tile_accumulate(float (&out)[4][D / 8], const float* p,
                                                const float* x, int tr, int tc) {
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(tr * 4 + i) * (R + 1) + r];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const float xv = x[r * (D + 1) + tc + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) out[i][c] = fmaf(pv[i], xv, out[i][c]);
    }
  }
}

// Sum / max over the 8 lanes that share a row.
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Round head_dim up to the instantiated tile width.
inline int tile_width(int d) { return d <= 32 ? 32 : (d <= 64 ? 64 : (d <= 128 ? 128 : 256)); }

}  // namespace ptflash
