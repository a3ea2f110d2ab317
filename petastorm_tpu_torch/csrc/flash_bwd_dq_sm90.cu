// Flash-attention dQ on Hopper's tensor cores (sm_90a): wgmma fed by TMA.
//
// Replaces: petastorm_tpu/ops/flash_attention.py::_bwd_dq_kernel (launched by
// _bwd_dq_call through pl.pallas_call), with the K/V chunk loop of _bwd
// around it, for bf16 operands whose head_dim is a multiple of 8 up to 128.
// fp32 operands and other head dims take flash_bwd.cu (CUDA cores).
//
// Recomputes the softmax from the forward's log-sum-exp instead of storing
// probabilities.  For one 64-query tile, over all key tiles:
//   P  = exp(Q.K^T * scale - lse)    (0 where masked; a masked pair is
//                                     never exponentiated)
//   dS = P * (dO.V^T - delta) * scale,   delta = rowsum(dO * O)
//   dQ += dS . K
// Each dQ tile has exactly one writer block: no atomics, deterministic.
//
// Bound on the H100: at the ViT-S/16 training shapes (b=64, s=196, h=6,
// d=64, bf16) it must read q, k, v, dO, lse, delta and write dq, ~48.8 MB
// (~14.6 us at 3.35 TB/s), for 5.66 GFLOP as the function needs them
// (~5.7 us at 989 TFLOP/s): bound by bytes.  What bounds it in practice is
// latency: a block's chain of waits (TMA, S and dP, P and dS, dS.K) per K/V
// tile.
//
// Design: the forward's skeleton with dO beside Q.  One block per
// (batch*head, 64-row Q tile), three per SM at d <= 64.  One warp issues TMA
// loads (the Q and dO tiles once, K/V tiles through a 2-stage ring signalled
// by mbarriers, with each key tile's segment ids staged beside it) while a
// warpgroup computes.  S = Q.K^T and dP = dO.V^T are two wgmma chains in one
// commit group with all operands K-major in shared memory; P and dS are
// formed on the accumulator fragments (log2 units, one exp2 per score, masks
// only on the tiles that need them), and dS goes to dQ += dS.K as the
// register A operand, K read MN-major in place.  dS is split into bf16 hi
// and lo parts (two products): rounding it once to bf16 would exceed the
// bf16 tolerance against the f32 plain version on short causal or segment
// rows.  A ragged last K/V tile takes a 32- or 16-key product instead of 64.
// dQ stays in f32 registers for the whole loop and leaves by TMA store.
#include "flash_api.h"
#include "sm90_common.cuh"

namespace ptsm90 {

// Depth of the K/V ring.
constexpr int DQ_STAGES = 2;
// Blocks per SM the registers must allow at d <= 64: more resident blocks
// hide each block's chain of waits behind the others.
template <int TW> __host__ __device__ constexpr int dq_min_blocks() { return TW > 64 ? 1 : 3; }

template <int TW> __host__ __device__ constexpr int dq_smem_bytes() {
  return 1024 + (2 + 2 * DQ_STAGES) * tile_bytes<TW>() + DQ_STAGES * ROWS * 4 +
         (1 + 2 * DQ_STAGES) * 8;
}

// One K/V tile of NK keys (64, or 32 / 16 for a ragged tail) added into this
// thread's rows of dQ.  lse2 is the rows' lse in log2 units.
template <int TW, int NK>
__device__ __forceinline__ void dq_tile(float (&dq)[TW / 2], const uint8_t* sQ,
                                        const uint8_t* sdO, const uint8_t* sK,
                                        const uint8_t* sV, const int* seg_k, bool full_mask,
                                        int k0, int s, int causal, const int (&q_pos)[2],
                                        const int (&seg_q)[2], const float (&lse2)[2],
                                        const float (&delta)[2], float scale) {
  const int quad = threadIdx.x % 4;
  const float scale_log2 = scale * LOG2E;
  // S = Q.K^T and dP = dO.V^T: rows are queries, columns keys.
  float sc[NK / 2], dp[NK / 2];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) sc[i] = dp[i] = 0.f;
  wgmma_fence();
  fence_operands(sc);
  fence_operands(dp);
#pragma unroll
  for (int kk = 0; kk < TW / 16; ++kk)
    wgmma_ss<NK>(sc, desc_k_major<TW>(sQ, kk), desc_k_major<TW>(sK, kk));
#pragma unroll
  for (int kk = 0; kk < TW / 16; ++kk)
    wgmma_ss<NK>(dp, desc_k_major<TW>(sdO, kk), desc_k_major<TW>(sV, kk));
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(sc);
  fence_operands(dp);

  // dS into dp; masks only on the tiles that need them: the full test where
  // segments or the causal diagonal are in play, the key bound alone on a
  // ragged tail.
  const bool ragged = k0 + NK > s;
#pragma unroll
  for (int i = 0; i < NK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * i + 2 * quad + e, k_pos = k0 + col;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bool ok = true;
        if (full_mask) {
          ok = q_pos[r] < s && k_pos < s && seg_q[r] == seg_k[col] && seg_q[r] != 0;
          if (causal) ok = ok && q_pos[r] >= k_pos;
        } else if (ragged) {
          ok = k_pos < s;
        }
        const int idx = 4 * i + 2 * r + e;
        const float p = ok ? fast_exp2(fmaf(sc[idx], scale_log2, -lse2[r])) : 0.f;
        dp[idx] = p * (dp[idx] - delta[r]) * scale;
      }
    }

  // dQ += dS.K with dS from registers (hi and lo parts), K MN-major.
  uint32_t ds_hi[NK / 16][4], ds_lo[NK / 16][4];
  accumulator_to_a<NK>(dp, ds_hi, ds_lo);
  wgmma_fence();
  fence_operands(dq);
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    wgmma_rs<TW>(dq, ds_hi[kk], desc_mn_major<TW>(sK, kk));
    wgmma_rs<TW>(dq, ds_lo[kk], desc_mn_major<TW>(sK, kk));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(dq);
}

template <int TW>
__global__ void __launch_bounds__(WG + 32, dq_min_blocks<TW>())
flash_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_dq,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const int* __restrict__ seg, int s, int h, float scale, int causal) {
  constexpr int TILE = tile_bytes<TW>(), STAGES = DQ_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = aligned_smem(smem_raw);  // Q tile, then the dQ tile
  uint8_t* sdO = sQ + TILE;              // dO tile
  // Ring of K/V tiles: stage st holds K at sK(st), V at sK(st) + TILE.
  auto sK = [&](int st) { return sQ + (2 + 2 * st) * TILE; };
  int* sSegK = reinterpret_cast<int*>(sQ + (2 + 2 * STAGES) * TILE);  // [STAGES][64]
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
      mbar_arrive_expect_tx(bar_q, 2 * TILE);
      tma_load_tile<TW>(sQ, &tm_q, bar_q, q0, hi, bi);
      tma_load_tile<TW>(sdO, &tm_do, bar_q, q0, hi, bi);
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

  // Consumer warpgroup: this thread's two rows of the Q tile, with their
  // lse (log2 units) and delta read before the first wait, so their latency
  // overlaps the loads.  Rows past s take 0 for both (their dQ is not
  // stored).
  int q_pos[2], seg_q[2];
  float lse2[2], delta_q[2];
  for (int r = 0; r < 2; ++r) {
    q_pos[r] = q0 + 16 * (tid / 32) + (tid % 32) / 4 + 8 * r;
    const bool in = q_pos[r] < s;
    seg_q[r] = seg == nullptr ? 1 : (in ? seg[bi * s + q_pos[r]] : 0);
    lse2[r] = in ? lse[(size_t)bh * s + q_pos[r]] * LOG2E : 0.f;
    delta_q[r] = in ? delta[(size_t)bh * s + q_pos[r]] : 0.f;
  }
  float dq[TW / 2];
#pragma unroll
  for (int i = 0; i < TW / 2; ++i) dq[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES, k0 = j * ROWS;
    mbar_wait(&full[st], (j / STAGES) & 1);
    const bool full_mask = seg != nullptr || (causal && k0 + ROWS - 1 > q0);
    const int* seg_k = sSegK + st * ROWS;
    switch (tail_width(kv_end - k0)) {
      case 16:
        dq_tile<TW, 16>(dq, sQ, sdO, sK(st), sK(st) + TILE, seg_k, full_mask, k0, s, causal,
                        q_pos, seg_q, lse2, delta_q, scale);
        break;
      case 32:
        dq_tile<TW, 32>(dq, sQ, sdO, sK(st), sK(st) + TILE, seg_k, full_mask, k0, s, causal,
                        q_pos, seg_q, lse2, delta_q, scale);
        break;
      default:
        dq_tile<TW, 64>(dq, sQ, sdO, sK(st), sK(st) + TILE, seg_k, full_mask, k0, s, causal,
                        q_pos, seg_q, lse2, delta_q, scale);
    }
    mbar_arrive(&empty[st]);
  }

  // Every warp is past its last read of Q: the Q tile becomes the dQ tile.
  consumers_sync();
  accumulator_to_tile<TW>(sQ, dq, 1.f, 1.f);
  fence_proxy_async();
  consumers_sync();
  if (tid == 0) {
    tma_store_tile<TW>(&tm_dq, sQ, q0, hi, bi);
    tma_store_drain();
  }
}

template <int TW>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* delta, const int* seg, void* dq, int b, int s, int h, int d,
              float scale, int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if (!make_tile_map<TW>(&tm_q, q, b, s, h, d) || !make_tile_map<TW>(&tm_k, k, b, s, h, d) ||
      !make_tile_map<TW>(&tm_v, v, b, s, h, d) || !make_tile_map<TW>(&tm_do, dout, b, s, h, d) ||
      !make_tile_map<TW>(&tm_dq, dq, b, s, h, d))
    return cudaErrorInvalidValue;
  constexpr int smem = dq_smem_bytes<TW>();
  auto kernel = flash_bwd_dq_kernel_sm90<TW>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((s + ROWS - 1) / ROWS, b * h);
  kernel<<<grid, WG + 32, smem, stream>>>(tm_q, tm_k, tm_v, tm_do, tm_dq, lse, delta, seg, s, h,
                                           scale, causal);
  return cudaGetLastError();
}

}  // namespace ptsm90

extern "C" int pt_flash_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta,
                                    const int* seg, void* dq, int b, int s, int h, int d,
                                    float scale, int causal, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || s < 1 || b < 1 || h < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (ptsm90::tile_width(d)) {
    case 16:
      return ptsm90::launch_dq<16>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d, scale, causal,
                                   st);
    case 32:
      return ptsm90::launch_dq<32>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d, scale, causal,
                                   st);
    case 64:
      return ptsm90::launch_dq<64>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d, scale, causal,
                                   st);
    default:
      return ptsm90::launch_dq<128>(q, k, v, dout, lse, delta, seg, dq, b, s, h, d, scale,
                                    causal, st);
  }
}
