// Flash-attention forward on Hopper's tensor cores (sm_90a): wgmma fed by TMA.
//
// Replaces: petastorm_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _fwd through pl.pallas_call), with the K/V chunk fold around it, for bf16
// operands whose head_dim is a multiple of 8 up to 128.  fp32 operands and
// other head dims take flash_fwd.cu (CUDA cores).
//
// Computes, per head and query row, the online-softmax attention over all
// keys with f32 running (max, denominator, output), masking padded keys,
// optionally causal pairs, and optionally pairs whose segment ids differ or
// are 0.  Fully masked rows give o = 0 and lse = NEG_INF.
//
// Bound on the H100: at the ViT-S/16 training shapes (b=64, s=196, h=6,
// d=64, bf16) the least traffic is q, k, v, o and lse, ~39 MB (~11.6 us at
// 3.35 TB/s), against 5.7 GFLOP as done here (~6 us at 989 TFLOP/s): bound
// by bytes.  What bounds this kernel in practice is latency: a block's chain
// of waits (TMA, S, softmax, P.V) per K/V tile.
//
// Design: one block per (batch*head, 64-row Q tile), four per SM at d <= 64.
// One warp issues TMA loads (the Q tile once, K/V tiles through a 2-stage
// ring signalled by mbarriers) while a warpgroup computes, so the next
// tile's load overlaps the current tile's math.  Tiles stay bf16 in shared
// memory (42 KB at d=64).  S = Q.K^T is one wgmma chain with both operands
// in shared memory; the online softmax runs on the accumulator fragments in
// registers, in log2 units with one exp2 per score; P goes to O += P.V as
// the register A operand, V read MN-major in place.  P is split into bf16
// hi and lo parts (two products): rounding it once to bf16 would exceed the
// bf16 tolerance against the f32 plain version on short segments, and the
// kernel has tensor-core time to spare.  A ragged last K/V tile takes a
// 32- or 16-key product instead of 64.  O leaves by TMA store, lse by plain
// stores.
#include "flash_api.h"
#include "sm90_common.cuh"

namespace ptsm90 {

// Depth of the K/V ring.
constexpr int FWD_STAGES = 2;
// Blocks per SM the registers must allow at d <= 64: more resident blocks
// hide each block's chain of waits (load, S, softmax, P.V) behind the others.
template <int TW> __host__ __device__ constexpr int fwd_min_blocks() { return TW > 64 ? 1 : 4; }

template <int TW> __host__ __device__ constexpr int fwd_smem_bytes() {
  return 1024 + (1 + 2 * FWD_STAGES) * tile_bytes<TW>() + FWD_STAGES * ROWS * 4 +
         (1 + 2 * FWD_STAGES) * 8;
}

// One K/V tile of NK keys (64, or 32 / 16 for a ragged tail) folded into the
// running softmax (m, l) and output o of this thread's two query rows.
template <int TW, int NK>
__device__ __forceinline__ void fwd_tile(float (&o)[TW / 2], float (&m)[2], float (&l)[2],
                                         const uint8_t* sQ, const uint8_t* sK,
                                         const uint8_t* sV, const int* seg_k, bool full_mask,
                                         int k0, int s, int causal, const int (&q_pos)[2],
                                         const int (&seg_q)[2], float scale_log2) {
  const int quad = threadIdx.x % 4;
  float sc[NK / 2];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) sc[i] = 0.f;
  wgmma_fence();
  fence_operands(sc);
#pragma unroll
  for (int kk = 0; kk < TW / 16; ++kk)
    wgmma_ss<NK>(sc, desc_k_major<TW>(sQ, kk), desc_k_major<TW>(sK, kk));
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(sc);

  // Online softmax in log2 units (x = s * scale * log2 e, p = 2^(x - m)).
  // Masked scores become -inf, and only on the tiles that need masks: the
  // full test where segments or the causal diagonal are in play, the key
  // bound alone on a ragged tail.
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) sc[i] *= scale_log2;
  if (full_mask) {
#pragma unroll
    for (int i = 0; i < NK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * quad + e, k_pos = k0 + col;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bool ok = k_pos < s && seg_q[r] == seg_k[col] && seg_q[r] != 0;
          if (causal) ok = ok && q_pos[r] >= k_pos;
          if (!ok) sc[4 * i + 2 * r + e] = -INFINITY;
        }
      }
  } else if (k0 + NK > s) {
#pragma unroll
    for (int i = 0; i < NK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (k0 + 8 * i + 2 * quad + e >= s) sc[4 * i + e] = sc[4 * i + 2 + e] = -INFINITY;
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < NK / 8; ++i)
      mx = fmaxf(mx, fmaxf(sc[4 * i + 2 * r], sc[4 * i + 2 * r + 1]));
    const float m_new = fmaxf(m[r], quad_max(mx));
    // A row with nothing unmasked yet keeps o = l = 0: any finite m_use.
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = fast_exp2(m[r] - m_use[r]);
    m[r] = m_new;
    l[r] *= alpha;
#pragma unroll
    for (int i = 0; i < TW / 8; ++i) {
      o[4 * i + 2 * r] *= alpha;
      o[4 * i + 2 * r + 1] *= alpha;
    }
  }
#pragma unroll
  for (int i = 0; i < NK / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * i + 2 * r + e];
        x = fast_exp2(x - m_use[r]);
        l[r] += x;
      }

  // O += P.V with P from registers (hi and lo parts), V MN-major.
  uint32_t p_hi[NK / 16][4], p_lo[NK / 16][4];
  accumulator_to_a<NK>(sc, p_hi, p_lo);
  wgmma_fence();
  fence_operands(o);
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    wgmma_rs<TW>(o, p_hi[kk], desc_mn_major<TW>(sV, kk));
    wgmma_rs<TW>(o, p_lo[kk], desc_mn_major<TW>(sV, kk));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(o);
}

template <int TW>
__global__ void __launch_bounds__(WG + 32, fwd_min_blocks<TW>())
flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, const int* __restrict__ seg,
                      float* __restrict__ lse, int s, int h, float scale_log2, int causal) {
  constexpr int TILE = tile_bytes<TW>(), STAGES = FWD_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = aligned_smem(smem_raw);  // Q tile, then the O tile
  // Ring of K/V tiles: stage st holds K at sK(st), V at sK(st) + TILE.
  auto sK = [&](int st) { return sQ + (1 + 2 * st) * TILE; };
  int* sSegK = reinterpret_cast<int*>(sQ + (1 + 2 * STAGES) * TILE);  // [STAGES][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(sSegK + STAGES * ROWS);
  uint64_t *bar_q = bars, *full = bars + 1, *empty = bars + 1 + STAGES;

  const int q0 = blockIdx.x * ROWS;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int tid = threadIdx.x;
  // Causal: key tiles past the query tile's last row contribute nothing.
  const int kv_end = causal ? min(s, q0 + ROWS) : s;
  const int n_tiles = (kv_end + ROWS - 1) / ROWS;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 32);         // the loading warp's 32 lanes
      mbar_init(&empty[i], WG);       // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= WG) {
    // Loading warp: lane 0 issues the TMA loads, every lane stages the key
    // tile's segment ids.
    const int lane = tid - WG;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, TILE);
      tma_load_tile<TW>(sQ, &tm_q, bar_q, q0, hi, bi);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES, k0 = j * ROWS;
      if (j >= STAGES) mbar_wait(&empty[st], (j / STAGES - 1) & 1);
      for (int r = lane; r < ROWS; r += 32)
        sSegK[st * ROWS + r] = seg == nullptr ? 1 : (k0 + r < s ? seg[bi * s + k0 + r] : 0);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * TILE);
        tma_load_tile<TW>(sK(st), &tm_k, &full[st], k0, hi, bi);
        tma_load_tile<TW>(sK(st) + TILE, &tm_v, &full[st], k0, hi, bi);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // Consumer warpgroup: this thread's two rows of the Q tile.
  const int quad = tid % 4;
  int q_pos[2], seg_q[2];
  for (int r = 0; r < 2; ++r) {
    q_pos[r] = q0 + 16 * (tid / 32) + (tid % 32) / 4 + 8 * r;
    seg_q[r] = seg == nullptr ? 1 : (q_pos[r] < s ? seg[bi * s + q_pos[r]] : 0);
  }
  // Running max (scaled) and this thread's partial row sums.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[TW / 2];
#pragma unroll
  for (int i = 0; i < TW / 2; ++i) o[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES, k0 = j * ROWS;
    mbar_wait(&full[st], (j / STAGES) & 1);
    const bool full_mask = seg != nullptr || (causal && k0 + ROWS - 1 > q0);
    const int* seg_k = sSegK + st * ROWS;
    switch (tail_width(kv_end - k0)) {
      case 16:
        fwd_tile<TW, 16>(o, m, l, sQ, sK(st), sK(st) + TILE, seg_k, full_mask, k0, s, causal,
                         q_pos, seg_q, scale_log2);
        break;
      case 32:
        fwd_tile<TW, 32>(o, m, l, sQ, sK(st), sK(st) + TILE, seg_k, full_mask, k0, s, causal,
                         q_pos, seg_q, scale_log2);
        break;
      default:
        fwd_tile<TW, 64>(o, m, l, sQ, sK(st), sK(st) + TILE, seg_k, full_mask, k0, s, causal,
                         q_pos, seg_q, scale_log2);
    }
    mbar_arrive(&empty[st]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float total = quad_sum(l[r]);
    inv[r] = total == 0.f ? 0.f : 1.f / total;
    if (quad == 0 && q_pos[r] < s)
      lse[(size_t)bh * s + q_pos[r]] = total == 0.f ? NEG_INF : (m[r] + log2f(total)) * LN2;
  }
  // Every warp is past its last read of Q: the Q tile becomes the O tile.
  consumers_sync();
  accumulator_to_tile<TW>(sQ, o, inv[0], inv[1]);
  fence_proxy_async();
  consumers_sync();
  if (tid == 0) {
    tma_store_tile<TW>(&tm_o, sQ, q0, hi, bi);
    tma_store_drain();
  }
}

template <int TW>
int launch_fwd(const void* q, const void* k, const void* v, const int* seg, void* o,
               float* lse, int b, int s, int h, int d, float scale, int causal,
               cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (!make_tile_map<TW>(&tm_q, q, b, s, h, d) || !make_tile_map<TW>(&tm_k, k, b, s, h, d) ||
      !make_tile_map<TW>(&tm_v, v, b, s, h, d) || !make_tile_map<TW>(&tm_o, o, b, s, h, d))
    return cudaErrorInvalidValue;
  constexpr int smem = fwd_smem_bytes<TW>();
  auto kernel = flash_fwd_kernel_sm90<TW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + ROWS - 1) / ROWS, b * h);
  kernel<<<grid, WG + 32, smem, stream>>>(tm_q, tm_k, tm_v, tm_o, seg, lse, s, h,
                                           scale * LOG2E, causal);
  return cudaGetLastError();
}

}  // namespace ptsm90

extern "C" int pt_flash_fwd_sm90(const void* q, const void* k, const void* v, const int* seg,
                                 void* o, float* lse, int b, int s, int h, int d, float scale,
                                 int causal, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || s < 1 || b < 1 || h < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ptsm90::tile_width(d)) {
    case 16: return ptsm90::launch_fwd<16>(q, k, v, seg, o, lse, b, s, h, d, scale, causal, st);
    case 32: return ptsm90::launch_fwd<32>(q, k, v, seg, o, lse, b, s, h, d, scale, causal, st);
    case 64: return ptsm90::launch_fwd<64>(q, k, v, seg, o, lse, b, s, h, d, scale, causal, st);
    default: return ptsm90::launch_fwd<128>(q, k, v, seg, o, lse, b, s, h, d, scale, causal, st);
  }
}
