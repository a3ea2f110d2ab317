// Flash-attention backward for Hopper (sm_90a), written by hand: dQ and dK/dV.
//
// Replaces: petastorm_tpu/ops/flash_attention.py::_bwd_dq_kernel (launched by
// _bwd_dq_call) and ::_bwd_dkv_kernel (launched by _bwd_dkv_call), with the
// K/V and Q chunk loops of _bwd around them.  Both recompute the softmax from
// the forward's saved log-sum-exp instead of storing probabilities:
//   p  = exp(s * scale - lse)   (0 where masked)
//   ds = p * (dO . V^T - delta) * scale,   delta = rowsum(dO * O)
//   dQ = ds . K          (per Q tile, looping over K tiles)
//   dV = p^T . dO, dK = ds^T . Q   (per K tile, looping over Q tiles)
// The split is the TPU kernels' own: each output tile is owned by exactly one
// block, so there are no atomics and the result is deterministic.
//
// Bound on the H100: at the ViT-S/16 training shapes (b=64, s=196, h=6, d=64,
// bf16; 9.6 MB per [b, s, h, d] tensor, 0.3 MB per lse/delta) dQ must read
// q, k, v, dO, lse, delta and write dq (~48 MB, ~14 us at 3.35 TB/s) for
// 5.7 GFLOP (~6 us at 989 TFLOP/s); dK/dV reads the same and writes dk and
// dv (~58 MB, ~17 us) for 7.6 GFLOP (~8 us): both memory-bound.  Design: the
// block's own tile and its fp32 accumulators stay on chip for the whole loop;
// the streamed tiles of one head (196 rows) are reused from L2 by the head's
// other blocks, so DRAM traffic stays near the minimum; the 64 x 64 p and ds
// tiles live only in registers and shared memory.  The math is fp32 FMA on
// the CUDA cores.  This is the route for what the tensor-core kernels
// (flash_bwd_dq_sm90.cu, flash_bwd_dkv_sm90.cu) do not take: fp32, fp16,
// head dims that are no multiple of 8 or above 128, and misaligned tensors.
// At head_dim tile 256 the streamed tiles are 32 rows (K/V for dQ, Q/dO for
// dK/dV): with 64 they would need 280,320 B (dQ) and ~297 KB (dK/dV) of
// shared memory, over the H100's 232,448 B per block; with 32, 206,208 B
// and 214,912 B.  Staging the streamed tiles in the input dtype instead would
// not help fp32, and each thread's two 4 x 32 accumulators (dK/dV) spill.
#include "flash_api.h"
#include "flash_common.cuh"

namespace ptflash {

// One block per (batch*head, 64-row Q tile): dq for those rows.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const int* __restrict__ seg, T* __restrict__ dq, int s, int h,
                    int d, float scale, int causal) {
  constexpr int BC = stream_rows<D>(), NJ = BC / 8, LDS = BC + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                   // 64 x (D+1)
  float* sdO = sQ + BR * (D + 1);     // 64 x (D+1)
  float* sK = sdO + BR * (D + 1);     // BC x (D+1)
  float* sV = sK + BC * (D + 1);      // BC x (D+1)
  float* sdS = sV + BC * (D + 1);     // 64 x LDS
  int* sSegQ = reinterpret_cast<int*>(sdS + BR * LDS);
  int* sSegK = sSegQ + BR;

  const int q0 = blockIdx.x * BR;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;

  load_tile<T, D, BR>(sQ, q, q0, bi, hi, s, h, d);
  load_tile<T, D, BR>(sdO, dout, q0, bi, hi, s, h, d);
  load_seg<BR>(sSegQ, seg, q0, bi, s);
  float row_lse[4], row_delta[4], acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    row_lse[i] = row < s ? lse[(size_t)bh * s + row] : 0.f;
    row_delta[i] = row < s ? delta[(size_t)bh * s + row] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(s, q0 + BR) : s;
  for (int k0 = 0; k0 < kv_end; k0 += BC) {
    __syncthreads();
    load_tile<T, D, BC>(sK, k, k0, bi, hi, s, h, d);
    load_tile<T, D, BC>(sV, v, k0, bi, hi, s, h, d);
    load_seg<BC>(sSegK, seg, k0, bi, s);
    __syncthreads();

    float sc[4][NJ], dp[4][NJ];
    tile_dot<D, NJ>(sc, sQ, sK, tr, tc);
    tile_dot<D, NJ>(dp, sdO, sV, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = tr * 4 + i, q_pos = q0 + qr, sq = sSegQ[qr];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kc = tc + 8 * j, k_pos = k0 + kc;
        // q_pos < s: padded query rows carry no lse; never exponentiate them.
        bool ok = k_pos < s && q_pos < s && sq == sSegK[kc] && sq != 0;
        if (causal) ok = ok && q_pos >= k_pos;
        const float p = ok ? expf(sc[i][j] * scale - row_lse[i]) : 0.f;
        sdS[qr * LDS + kc] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    }
    __syncthreads();
    tile_accumulate<D, BC>(acc, sdS, sK, tr, tc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= s) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = tc + 8 * c;
      if (col < d) dq[offset_of(bi, row, hi, col, s, h, d)] = from_f32<T>(acc[i][c]);
    }
  }
}

// One block per (batch*head, 64-row K tile): dk and dv for those rows, Q and
// dO streamed in BQ-row tiles.  The thread's micro-tile is transposed: its
// rows are keys, its columns queries.
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seg, T* __restrict__ dk, T* __restrict__ dv,
                     int s, int h, int d, float scale, int causal) {
  constexpr int BK = BR, BQ = stream_rows<D>(), NJ = BQ / 8, LDS = BQ + 1;
  extern __shared__ float smem[];
  float* sK = smem;                   // 64 x (D+1)
  float* sV = sK + BK * (D + 1);      // 64 x (D+1)
  float* sQ = sV + BK * (D + 1);      // BQ x (D+1)
  float* sdO = sQ + BQ * (D + 1);     // BQ x (D+1)
  float* sP = sdO + BQ * (D + 1);     // 64 x LDS, [key][query]
  float* sdS = sP + BK * LDS;         // 64 x LDS, [key][query]
  float* sLse = sdS + BK * LDS;       // BQ
  float* sDelta = sLse + BQ;          // BQ
  int* sSegQ = reinterpret_cast<int*>(sDelta + BQ);
  int* sSegK = sSegQ + BQ;

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;

  load_tile<T, D, BK>(sK, k, k0, bi, hi, s, h, d);
  load_tile<T, D, BK>(sV, v, k0, bi, hi, s, h, d);
  load_seg<BK>(sSegK, seg, k0, bi, s);
  float acc_dk[4][D / 8], acc_dv[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.f;

  // Causal: query tiles wholly above this key tile contribute nothing.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < s; q0 += BQ) {
    __syncthreads();
    load_tile<T, D, BQ>(sQ, q, q0, bi, hi, s, h, d);
    load_tile<T, D, BQ>(sdO, dout, q0, bi, hi, s, h, d);
    load_seg<BQ>(sSegQ, seg, q0, bi, s);
    for (int idx = tid; idx < BQ; idx += NTHREADS) {
      const int row = q0 + idx;
      sLse[idx] = row < s ? lse[(size_t)bh * s + row] : 0.f;
      sDelta[idx] = row < s ? delta[(size_t)bh * s + row] : 0.f;
    }
    __syncthreads();

    float st[4][NJ], dpt[4][NJ];
    tile_dot<D, NJ>(st, sK, sQ, tr, tc);
    tile_dot<D, NJ>(dpt, sV, sdO, tr, tc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = tr * 4 + i, k_pos = k0 + kr, sk = sSegK[kr];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int qc = tc + 8 * j, q_pos = q0 + qc, sq = sSegQ[qc];
        bool ok = k_pos < s && q_pos < s && sq == sk && sq != 0;
        if (causal) ok = ok && q_pos >= k_pos;
        const float p = ok ? expf(st[i][j] * scale - sLse[qc]) : 0.f;
        sP[kr * LDS + qc] = p;
        sdS[kr * LDS + qc] = p * (dpt[i][j] - sDelta[qc]) * scale;
      }
    }
    __syncthreads();
    tile_accumulate<D, BQ>(acc_dv, sP, sdO, tr, tc);
    tile_accumulate<D, BQ>(acc_dk, sdS, sQ, tr, tc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + tr * 4 + i;
    if (row >= s) continue;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = tc + 8 * c;
      if (col < d) {
        const size_t off = offset_of(bi, row, hi, col, s, h, d);
        dk[off] = from_f32<T>(acc_dk[i][c]);
        dv[off] = from_f32<T>(acc_dv[i][c]);
      }
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* seg, void* dq, int b, int s, int h, int d,
              float scale, int causal, cudaStream_t stream) {
  constexpr int BC = stream_rows<D>();
  const int smem = ((2 * BR + 2 * BC) * (D + 1) + BR * (BC + 1)) * sizeof(float) +
                   (BR + BC) * sizeof(int);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BR - 1) / BR, b * h);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, seg, static_cast<T*>(dq), s, h, d, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* seg, void* dk, void* dv, int b, int s, int h,
               int d, float scale, int causal, cudaStream_t stream) {
  constexpr int BQ = stream_rows<D>();
  const int smem = ((2 * BR + 2 * BQ) * (D + 1) + 2 * BR * (BQ + 1) + 2 * BQ) * sizeof(float) +
                   (BR + BQ) * sizeof(int);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BR - 1) / BR, b * h);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, seg, static_cast<T*>(dk), static_cast<T*>(dv),
      s, h, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, const int* seg, void* dq, int b, int s, int h, int d,
                float scale, int causal, cudaStream_t st) {
  switch (tile_width(d)) {
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d, scale, causal, st);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d, scale, causal, st);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d, scale, causal, st);
    default: return launch_dq<T, 256>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d, scale, causal, st);
  }
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                 const float* delta, const int* seg, void* dk, void* dv, int b, int s, int h,
                 int d, float scale, int causal, cudaStream_t st) {
  switch (tile_width(d)) {
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, seg, dk, dv, b, s, h, d, scale, causal, st);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, seg, dk, dv, b, s, h, d, scale, causal, st);
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, delta, seg, dk, dv, b, s, h, d, scale, causal, st);
    default: return launch_dkv<T, 256>(q, k, v, dout, lse, delta, seg, dk, dv, b, s, h, d, scale, causal, st);
  }
}

}  // namespace ptflash

extern "C" int pt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const float* lse, const float* delta, const int* seg, void* dq,
                               int b, int s, int h, int d, float scale, int causal, int dtype,
                               void* stream) {
  if (d < 1 || d > 256 || s < 1 || b < 1 || h < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ptflash::dispatch_dq<float>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d, scale,
                                       causal, st);
  if (dtype == 1)
    return ptflash::dispatch_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d,
                                               scale, causal, st);
  if (dtype == 2)
    return ptflash::dispatch_dq<__half>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d, scale,
                                        causal, st);
  return cudaErrorInvalidValue;
}

extern "C" int pt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const float* lse, const float* delta, const int* seg, void* dk,
                                void* dv, int b, int s, int h, int d, float scale, int causal,
                                int dtype, void* stream) {
  if (d < 1 || d > 256 || s < 1 || b < 1 || h < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ptflash::dispatch_dkv<float>(q, k, v, dout, lse, delta, seg, dk, dv, b, s, h, d,
                                        scale, causal, st);
  if (dtype == 1)
    return ptflash::dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, seg, dk, dv, b, s,
                                                h, d, scale, causal, st);
  if (dtype == 2)
    return ptflash::dispatch_dkv<__half>(q, k, v, dout, lse, delta, seg, dk, dv, b, s, h, d,
                                         scale, causal, st);
  return cudaErrorInvalidValue;
}
