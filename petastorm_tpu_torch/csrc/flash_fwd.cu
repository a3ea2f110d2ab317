// Flash-attention forward for Hopper (sm_90a), written by hand.
//
// Replaces: petastorm_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _fwd through pl.pallas_call), together with the K/V chunk fold around it
// (_fwd_chunked, _fold_normalized): this kernel streams K/V tiles through
// shared memory at any length, so there is nothing to fold.
//
// Computes, per head and query row, the online-softmax attention over all
// keys with fp32 running (max, denominator, output) accumulators, masking
// padded keys, optionally causal pairs, and optionally pairs whose segment
// ids differ or are 0.  Fully masked rows give o = 0 and lse = NEG_INF.
//
// Bound on the H100: at the ViT-S/16 training shapes (b=64, s=196, h=6, d=64,
// bf16) each of q, k, v and o is 9.6 MB, so the least traffic is ~39 MB
// (~11.5 us at 3.35 TB/s) against 3.8 GFLOP (~4 us at 989 TFLOP/s on the
// tensor cores): memory-bound.  Design: one block per (batch*head, 64-row Q
// tile) reads its Q tile once and each K/V tile once per Q tile (K/V of one
// head, 196 x 64, stays in L2 across the head's 4 Q tiles, so DRAM traffic is
// close to the minimum), writes o and lse once, and keeps the 64 x 64 score
// tile in registers and shared memory, never in device memory.  The math is
// fp32 FMA on the CUDA cores.  This is the route for what the tensor-core
// kernel (flash_fwd_sm90.cu) does not take: fp32, fp16, head dims that are
// no multiple of 8 or above 128 (up to 256, where K/V stream in 32-row
// tiles), and misaligned tensors.
#include "flash_api.h"
#include "flash_common.cuh"

namespace ptflash {

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 T* __restrict__ o, float* __restrict__ lse, int s, int h, int d,
                 float scale, int causal) {
  constexpr int BC = stream_rows<D>(), NJ = BC / 8, LDS = BC + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                   // 64 x (D+1)
  float* sK = sQ + BR * (D + 1);      // BC x (D+1)
  float* sV = sK + BC * (D + 1);      // BC x (D+1)
  float* sP = sV + BC * (D + 1);      // 64 x LDS
  int* sSegQ = reinterpret_cast<int*>(sP + BR * LDS);  // 64
  int* sSegK = sSegQ + BR;                              // BC

  const int q0 = blockIdx.x * BR;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int tid = threadIdx.x, tr = tid >> 3, tc = tid & 7;

  load_tile<T, D, BR>(sQ, q, q0, bi, hi, s, h, d);
  load_seg<BR>(sSegQ, seg, q0, bi, s);

  float m[4], l[4], acc[4][D / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  // Causal: key tiles past the query tile's last row contribute nothing.
  const int kv_end = causal ? min(s, q0 + BR) : s;
  for (int k0 = 0; k0 < kv_end; k0 += BC) {
    __syncthreads();  // the previous tile's readers are done with sK/sV/sP
    load_tile<T, D, BC>(sK, k, k0, bi, hi, s, h, d);
    load_tile<T, D, BC>(sV, v, k0, bi, hi, s, h, d);
    load_seg<BC>(sSegK, seg, k0, bi, s);
    __syncthreads();

    float sc[4][NJ];
    tile_dot<D, NJ>(sc, sQ, sK, tr, tc);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = tr * 4 + i, q_pos = q0 + qr, sq = sSegQ[qr];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kc = tc + 8 * j, k_pos = k0 + kc;
        bool ok = k_pos < s && sq == sSegK[kc] && sq != 0;
        if (causal) ok = ok && q_pos >= k_pos;
        sc[i][j] = ok ? sc[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = m[i] == NEG_INF ? 0.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float p = m_new == NEG_INF ? 0.f : expf(sc[i][j] - m_new);
        sP[qr * LDS + tc + 8 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    tile_accumulate<D, BC>(acc, sP, sV, tr, tc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + tr * 4 + i;
    if (row >= s) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = tc + 8 * c;
      if (col < d) o[offset_of(bi, row, hi, col, s, h, d)] = from_f32<T>(acc[i][c] * inv);
    }
    if (tc == 0) lse[(size_t)bh * s + row] = l[i] == 0.f ? NEG_INF : m[i] + logf(l[i]);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
               float* lse, int b, int s, int h, int d, float scale, int causal,
               cudaStream_t stream) {
  constexpr int BC = stream_rows<D>();
  const int smem = ((BR + 2 * BC) * (D + 1) + BR * (BC + 1)) * sizeof(float) +
                   (BR + BC) * sizeof(int);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + BR - 1) / BR, b * h);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg,
      static_cast<T*>(o), lse, s, h, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
int dispatch_fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
                 float* lse, int b, int s, int h, int d, float scale, int causal,
                 cudaStream_t stream) {
  switch (tile_width(d)) {
    case 32: return launch_fwd<T, 32>(q, k, v, seg, o, lse, b, s, h, d, scale, causal, stream);
    case 64: return launch_fwd<T, 64>(q, k, v, seg, o, lse, b, s, h, d, scale, causal, stream);
    case 128: return launch_fwd<T, 128>(q, k, v, seg, o, lse, b, s, h, d, scale, causal, stream);
    default: return launch_fwd<T, 256>(q, k, v, seg, o, lse, b, s, h, d, scale, causal, stream);
  }
}

}  // namespace ptflash

extern "C" int pt_flash_fwd(const void* q, const void* k, const void* v, const int* seg,
                            void* o, float* lse, int b, int s, int h, int d, float scale,
                            int causal, int dtype, void* stream) {
  if (d < 1 || d > 256 || s < 1 || b < 1 || h < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ptflash::dispatch_fwd<float>(q, k, v, seg, o, lse, b, s, h, d, scale, causal, st);
  if (dtype == 1)
    return ptflash::dispatch_fwd<__nv_bfloat16>(q, k, v, seg, o, lse, b, s, h, d, scale,
                                                causal, st);
  if (dtype == 2)
    return ptflash::dispatch_fwd<__half>(q, k, v, seg, o, lse, b, s, h, d, scale, causal, st);
  return cudaErrorInvalidValue;
}
