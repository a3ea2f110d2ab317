// Flash-attention dK/dV on Hopper's tensor cores (sm_90a): wgmma fed by TMA.
//
// Replaces: petastorm_tpu/ops/flash_attention.py::_bwd_dkv_kernel (launched
// by _bwd_dkv_call through pl.pallas_call), with the Q chunk loop of _bwd
// around it, for bf16 operands whose head_dim is a multiple of 8 up to 128.
// fp32 operands and other head dims take flash_bwd.cu (CUDA cores).
//
// Recomputes the softmax from the forward's log-sum-exp instead of storing
// probabilities.  For one 64-key tile, over all query tiles:
//   P^T  = exp(K.Q^T * scale - lse)   (0 where masked; a masked pair is
//                                      never exponentiated)
//   dS^T = P^T * (V.dO^T - delta) * scale,   delta = rowsum(dO * O)
//   dV  += P^T . dO,   dK += dS^T . Q
// Each dK/dV tile has exactly one writer block: no atomics, deterministic.
//
// Bound on the H100: at the ViT-S/16 training shapes (b=64, s=196, h=6,
// d=64, bf16) it must read q, k, v, dO, lse, delta and write dk, dv, ~58 MB
// (~17.4 us at 3.35 TB/s), for 11.3 GFLOP as done here (~11.5 us at
// 989 TFLOP/s): bound by bytes.  What bounds this kernel in practice is
// latency and registers: 168 a thread at d=64, so two blocks per SM.
//
// Design: one block per (batch*head, 64-key tile).  K and V come in once by
// TMA; one warp streams the Q and dO tiles through a 3-stage TMA ring (with
// the tile's lse, delta and segment ids, read before the ring wait and
// staged beside them) while a warpgroup computes.  S^T and dP^T are wgmma
// chains with both operands in shared memory, K-major along head_dim.  P^T
// and dS^T are formed on the accumulator fragments and go, as bf16 hi and lo
// parts in registers, to the dV and dK products, whose B operands (dO, Q)
// are read MN-major from the same tiles; dS^T is packed while the dV
// products run.  A ragged last Q tile takes a 32- or 16-query product.  dK
// and dV stay in f32 registers for the whole loop and leave by TMA store.
#include "flash_api.h"
#include "sm90_common.cuh"

namespace ptsm90 {

// Depth of the Q/dO ring.
constexpr int DKV_STAGES = 3;
// Blocks per SM the registers must allow at d <= 64: a second resident
// block's math runs while one waits on its loads or its products.
template <int TW> __host__ __device__ constexpr int dkv_min_blocks() { return TW > 64 ? 1 : 2; }

template <int TW> __host__ __device__ constexpr int dkv_smem_bytes() {
  return 1024 + (2 + 2 * DKV_STAGES) * tile_bytes<TW>() + 3 * DKV_STAGES * ROWS * 4 +
         (1 + 2 * DKV_STAGES) * 8;
}

// One Q/dO tile of NQ queries (64, or 32 / 16 for a ragged tail) added into
// this thread's rows of dK and dV.  lse (log2 units), delta and seg_q are the
// tile's staged statistics.
template <int TW, int NQ>
__device__ __forceinline__ void dkv_tile(float (&dk)[TW / 2], float (&dv)[TW / 2],
                                         const uint8_t* sK, const uint8_t* sV,
                                         const uint8_t* sQ, const uint8_t* sdO,
                                         const float* lse, const float* delta, const int* seg_q,
                                         bool full_mask, int k0, int q0, int s, int causal,
                                         const int (&k_pos)[2], const int (&seg_k)[2],
                                         float scale) {
  const int quad = threadIdx.x % 4;
  const float scale_log2 = scale * LOG2E;
  // S^T = K.Q^T and dP^T = V.dO^T: rows are keys, columns queries.
  float s_t[NQ / 2], dpt[NQ / 2];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) s_t[i] = dpt[i] = 0.f;
  wgmma_fence();
  fence_operands(s_t);
  fence_operands(dpt);
#pragma unroll
  for (int kk = 0; kk < TW / 16; ++kk)
    wgmma_ss<NQ>(s_t, desc_k_major<TW>(sK, kk), desc_k_major<TW>(sQ, kk));
#pragma unroll
  for (int kk = 0; kk < TW / 16; ++kk)
    wgmma_ss<NQ>(dpt, desc_k_major<TW>(sV, kk), desc_k_major<TW>(sdO, kk));
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(s_t);
  fence_operands(dpt);

  // P^T into s_t, dS^T into dpt; masks only on the tiles that need them:
  // the full test where segments or the causal diagonal are in play, the
  // bounds alone on a ragged tile.
  const bool ragged = k0 + ROWS > s || q0 + NQ > s;
#pragma unroll
  for (int i = 0; i < NQ / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * i + 2 * quad + e, q_pos = q0 + col;
      const float lse_q = lse[col], delta_q = delta[col];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bool ok = true;
        if (full_mask) {
          ok = q_pos < s && k_pos[r] < s && seg_q[col] == seg_k[r] && seg_q[col] != 0;
          if (causal) ok = ok && q_pos >= k_pos[r];
        } else if (ragged) {
          ok = q_pos < s && k_pos[r] < s;
        }
        const int idx = 4 * i + 2 * r + e;
        const float p = ok ? fast_exp2(fmaf(s_t[idx], scale_log2, -lse_q)) : 0.f;
        s_t[idx] = p;
        dpt[idx] = p * (dpt[idx] - delta_q) * scale;
      }
    }

  // dV += P^T.dO and dK += dS^T.Q: A from registers (hi and lo parts), B
  // MN-major from the ring's tiles.  dS^T is packed while the dV products
  // run.
  uint32_t p_hi[NQ / 16][4], p_lo[NQ / 16][4], ds_hi[NQ / 16][4], ds_lo[NQ / 16][4];
  accumulator_to_a<NQ>(s_t, p_hi, p_lo);
  wgmma_fence();
  fence_operands(dv);
#pragma unroll
  for (int kk = 0; kk < NQ / 16; ++kk) {
    wgmma_rs<TW>(dv, p_hi[kk], desc_mn_major<TW>(sdO, kk));
    wgmma_rs<TW>(dv, p_lo[kk], desc_mn_major<TW>(sdO, kk));
  }
  wgmma_commit();
  accumulator_to_a<NQ>(dpt, ds_hi, ds_lo);
  wgmma_fence();
  fence_operands(dk);
#pragma unroll
  for (int kk = 0; kk < NQ / 16; ++kk) {
    wgmma_rs<TW>(dk, ds_hi[kk], desc_mn_major<TW>(sQ, kk));
    wgmma_rs<TW>(dk, ds_lo[kk], desc_mn_major<TW>(sQ, kk));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(dv);
  fence_operands(dk);
}

template <int TW>
__global__ void __launch_bounds__(WG + 32, dkv_min_blocks<TW>())
flash_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dk,
                          const __grid_constant__ CUtensorMap tm_dv,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ seg, int s, int h, float scale,
                          int causal) {
  constexpr int TILE = tile_bytes<TW>(), STAGES = DKV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = aligned_smem(smem_raw);  // K tile, then the dK tile
  uint8_t* sV = sK + TILE;               // V tile, then the dV tile
  // Ring of Q/dO tiles: stage st holds Q at sQ(st), dO at sQ(st) + TILE.
  auto sQ = [&](int st) { return sK + (2 + 2 * st) * TILE; };
  // The ring's statistics, [STAGES][64] each: lse (log2 units), delta, seg.
  float* sLse = reinterpret_cast<float*>(sK + (2 + 2 * STAGES) * TILE);
  float* sDelta = sLse + STAGES * ROWS;
  int* sSegQ = reinterpret_cast<int*>(sDelta + STAGES * ROWS);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sSegQ + STAGES * ROWS);
  uint64_t *bar_kv = bars, *full = bars + 1, *empty = bars + 1 + STAGES;

  const int k0 = blockIdx.x * ROWS;
  const int bh = blockIdx.y, bi = bh / h, hi = bh % h;
  const int tid = threadIdx.x;
  // Causal: query tiles wholly above this key tile contribute nothing.
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = (s - q_begin + ROWS - 1) / ROWS;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 32);         // the loading warp's 32 lanes
      mbar_init(&empty[i], WG);       // every consumer thread
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= WG) {
    // Loading warp: lane 0 issues the TMA loads, every lane stages the
    // query tile's lse (in log2 units), delta and segment ids.
    const int lane = tid - WG;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * TILE);
      tma_load_tile<TW>(sK, &tm_k, bar_kv, k0, hi, bi);
      tma_load_tile<TW>(sV, &tm_v, bar_kv, k0, hi, bi);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES, q0 = q_begin + j * ROWS;
      // Read the tile's statistics before waiting for its stage, so their
      // latency overlaps the wait.
      float lse_r[2], delta_r[2];
      int seg_r[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q_pos = q0 + lane + 32 * i;
        const bool in = q_pos < s;
        lse_r[i] = in ? lse[(size_t)bh * s + q_pos] * LOG2E : 0.f;
        delta_r[i] = in ? delta[(size_t)bh * s + q_pos] : 0.f;
        seg_r[i] = seg == nullptr ? 1 : (in ? seg[bi * s + q_pos] : 0);
      }
      if (j >= STAGES) mbar_wait(&empty[st], (j / STAGES - 1) & 1);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sLse[st * ROWS + lane + 32 * i] = lse_r[i];
        sDelta[st * ROWS + lane + 32 * i] = delta_r[i];
        sSegQ[st * ROWS + lane + 32 * i] = seg_r[i];
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * TILE);
        tma_load_tile<TW>(sQ(st), &tm_q, &full[st], q0, hi, bi);
        tma_load_tile<TW>(sQ(st) + TILE, &tm_do, &full[st], q0, hi, bi);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // Consumer warpgroup: this thread's two rows (keys) of the K tile.
  int k_pos[2], seg_k[2];
  for (int r = 0; r < 2; ++r) {
    k_pos[r] = k0 + 16 * (tid / 32) + (tid % 32) / 4 + 8 * r;
    seg_k[r] = seg == nullptr ? 1 : (k_pos[r] < s ? seg[bi * s + k_pos[r]] : 0);
  }
  float dk[TW / 2], dv[TW / 2];
#pragma unroll
  for (int i = 0; i < TW / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES, q0 = q_begin + j * ROWS;
    mbar_wait(&full[st], (j / STAGES) & 1);
    const bool full_mask = seg != nullptr || (causal && q0 < k0 + ROWS - 1);
    const float *lse_t = sLse + st * ROWS, *delta_t = sDelta + st * ROWS;
    const int* seg_t = sSegQ + st * ROWS;
    switch (tail_width(s - q0)) {
      case 16:
        dkv_tile<TW, 16>(dk, dv, sK, sV, sQ(st), sQ(st) + TILE, lse_t, delta_t, seg_t, full_mask,
                         k0, q0, s, causal, k_pos, seg_k, scale);
        break;
      case 32:
        dkv_tile<TW, 32>(dk, dv, sK, sV, sQ(st), sQ(st) + TILE, lse_t, delta_t, seg_t, full_mask,
                         k0, q0, s, causal, k_pos, seg_k, scale);
        break;
      default:
        dkv_tile<TW, 64>(dk, dv, sK, sV, sQ(st), sQ(st) + TILE, lse_t, delta_t, seg_t, full_mask,
                         k0, q0, s, causal, k_pos, seg_k, scale);
    }
    mbar_arrive(&empty[st]);
  }

  // Every warp is past its last read of K and V: they become dK and dV.
  consumers_sync();
  accumulator_to_tile<TW>(sK, dk, 1.f, 1.f);
  accumulator_to_tile<TW>(sV, dv, 1.f, 1.f);
  fence_proxy_async();
  consumers_sync();
  if (tid == 0) {
    tma_store_tile<TW>(&tm_dk, sK, k0, hi, bi);
    tma_store_tile<TW>(&tm_dv, sV, k0, hi, bi);
    tma_store_drain();
  }
}

template <int TW>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, const int* seg, void* dk, void* dv, int b, int s, int h,
               int d, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  if (!make_tile_map<TW>(&tm_q, q, b, s, h, d) || !make_tile_map<TW>(&tm_k, k, b, s, h, d) ||
      !make_tile_map<TW>(&tm_v, v, b, s, h, d) || !make_tile_map<TW>(&tm_do, dout, b, s, h, d) ||
      !make_tile_map<TW>(&tm_dk, dk, b, s, h, d) || !make_tile_map<TW>(&tm_dv, dv, b, s, h, d))
    return cudaErrorInvalidValue;
  constexpr int smem = dkv_smem_bytes<TW>();
  auto kernel = flash_bwd_dkv_kernel_sm90<TW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + ROWS - 1) / ROWS, b * h);
  kernel<<<grid, WG + 32, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, lse, delta, seg,
                                           s, h, scale, causal);
  return cudaGetLastError();
}

}  // namespace ptsm90

extern "C" int pt_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                     const void* dout, const float* lse, const float* delta,
                                     const int* seg, void* dk, void* dv, int b, int s, int h,
                                     int d, float scale, int causal, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || s < 1 || b < 1 || h < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ptsm90::tile_width(d)) {
    case 16:
      return ptsm90::launch_dkv<16>(q, k, v, dout, lse, delta, seg, dk, dv, b, s, h, d, scale,
                                    causal, st);
    case 32:
      return ptsm90::launch_dkv<32>(q, k, v, dout, lse, delta, seg, dk, dv, b, s, h, d, scale,
                                    causal, st);
    case 64:
      return ptsm90::launch_dkv<64>(q, k, v, dout, lse, delta, seg, dk, dv, b, s, h, d, scale,
                                    causal, st);
    default:
      return ptsm90::launch_dkv<128>(q, k, v, dout, lse, delta, seg, dk, dv, b, s, h, d, scale,
                                     causal, st);
  }
}
