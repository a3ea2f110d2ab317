// Shared pieces of the tensor-core flash-attention kernels for Hopper
// (sm_90a): TMA tensor maps and loads/stores, mbarriers, wgmma descriptors
// and instructions, and the register-fragment helpers.
//
// Tiles.  Every operand tile is 64 rows of one head of a [b, s, h, d] bf16
// tensor, TW columns wide, where TW (the tile width) is head_dim rounded up
// to 16, 32, 64 or 128.  A TMA box of 1 x 64 x 1 x min(TW, 64) lands it in
// shared memory with the swizzle that matches its row width: rows of 32, 64
// or 128 bytes (32B, 64B or 128B swizzle).  At TW = 128 a tile is two such
// 64-column halves, 8 KB apart.  TMA zero-fills rows past s and columns past
// d, so no load needs a guard, and a TMA store writes only rows < s and
// columns < d.
//
// wgmma reads these tiles in two ways (descriptors below): K-major, with the
// reduction running along head_dim (S = Q.K^T), and MN-major, with the
// reduction running along the 64 rows (O += P.V, dV += P^T.dO).
//
// Fragments.  The f32 accumulator of an m64nN wgmma gives thread t of the
// warpgroup (warp w = t / 32, g = (t % 32) / 4, c = t % 4) the elements
//   d[4i + 2r + e]  at row 16w + g + 8r, column 8i + 2c + e   (r, e in {0,1})
// and a bf16 A operand in registers for one k16 step takes, in its four
// registers, exactly the pairs d[8k + 0..7] of a 64-column accumulator: an
// accumulator row is an A row, so P goes from one product to the next
// without leaving registers.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptsm90 {

constexpr int ROWS = 64;               // rows of every tile
constexpr int WG = 128;                // threads of a warpgroup
constexpr float NEG_INF = -1e30f;      // the JAX package's finite -inf
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Width of the tile that covers the last `rows` rows of a streamed operand:
// a ragged tail takes a narrower product.
__device__ __forceinline__ int tail_width(int rows) { return rows > 32 ? 64 : rows > 16 ? 32 : 16; }

// Tile width of a head_dim (a multiple of 8 up to 128).
inline int tile_width(int d) { return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128; }

// Bytes of one swizzled row (one 64-column half at TW = 128), of one tile.
template <int TW> __host__ __device__ constexpr int swizzle_bytes() { return TW >= 64 ? 128 : TW * 2; }
template <int TW> __host__ __device__ constexpr int tile_bytes() { return ROWS * TW * 2; }

// ---------------------------------------------------------------------------
// shared memory, barriers, proxies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive, and add `bytes` to the transfers the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A phase that has
// not completed after ~2^34 clocks (seconds) traps, so a lost transfer
// surfaces as a launch failure instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Barrier among the consumer warpgroup only (id 0 is __syncthreads').
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(WG) : "memory");
}

// Generic-proxy writes to shared memory, made visible to TMA (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Commit the issued TMA stores and wait until they have read shared memory.
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Load rows [row, row + 64) of head hi, batch bi into a tile (one box per
// 64-column half); the caller has armed `bar` for tile_bytes<TW>().
template <int TW>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst, const CUtensorMap* map,
                                              uint64_t* bar, int row, int hi, int bi) {
#pragma unroll
  for (int half = 0; half < (TW > 64 ? 2 : 1); ++half)
    tma_load_4d(dst + half * ROWS * 128, map, bar, half * 64, hi, row, bi);
}

template <int TW>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map, const uint8_t* src,
                                               int row, int hi, int bi) {
#pragma unroll
  for (int half = 0; half < (TW > 64 ? 2 : 1); ++half)
    tma_store_4d(map, src + half * ROWS * 128, half * 64, hi, row, bi);
}

// Byte offset of element (row, col) of a tile, swizzled as TMA lays it out.
template <int TW>
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  constexpr int SW = swizzle_bytes<TW>();
  constexpr uint32_t MASK = SW / 16 - 1;  // 7, 3, 1 for 128B, 64B, 32B
  const uint32_t b = (col / 64) * (ROWS * 128) + row * SW + (col % 64) * 2;
  return b ^ (((b >> 7) & MASK) << 4);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

template <int TW> __host__ __device__ constexpr uint64_t layout_code() {
  return swizzle_bytes<TW>() == 128 ? 1 : swizzle_bytes<TW>() == 64 ? 2 : 3;
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | layout << 62;
}

// K-major operand (64 rows, reduction along head_dim), k16 step `kk`: 32
// bytes further along the swizzled row, or into the second half at TW = 128.
template <int TW>
__device__ __forceinline__ uint64_t desc_k_major(const uint8_t* tile, int kk) {
  constexpr int SW = swizzle_bytes<TW>();
  const uint32_t addr = smem_u32(tile) + (kk * 32 / SW) * (ROWS * SW) + (kk * 32) % SW;
  return make_desc(addr, 16, 8 * SW, layout_code<TW>());
}

// MN-major operand (reduction along the 64 rows, N = head_dim), k16 step
// `kk`: 16 rows further on.  At TW = 128 the second 64-column half lies
// ROWS * 128 bytes on (the leading byte offset).
template <int TW>
__device__ __forceinline__ uint64_t desc_mn_major(const uint8_t* tile, int kk) {
  constexpr int SW = swizzle_bytes<TW>();
  const uint32_t addr = smem_u32(tile) + kk * 16 * SW;
  return make_desc(addr, ROWS * SW, 8 * SW, layout_code<TW>());
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin accumulator registers in program order around wgmma's issue and wait,
// so the compiler reads none of them while a product is in flight.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma instructions (operand lists written out: inline PTX needs them literal).

// D = A . B^T, both operands K-major in shared memory: m64nNk16, bf16 in, f32
// accumulate.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      " {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15},"
      " {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b) {
  if constexpr (N == 16) wgmma_ss_n16(d, desc_a, desc_b);
  else if constexpr (N == 32) wgmma_ss_n32(d, desc_a, desc_b);
  else wgmma_ss_n64(d, desc_a, desc_b);
}

// O += A . B for an m64 x TW accumulator, A (64 x 16, bf16) from registers,
// B an MN-major tile.
template <int TW>
__device__ __forceinline__ void wgmma_rs(float (&d)[TW / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (TW == 16) wgmma_rs_n16(d, a, desc_b);
  else if constexpr (TW == 32) wgmma_rs_n32(d, a, desc_b);
  else if constexpr (TW == 64) wgmma_rs_n64(d, a, desc_b);
  else wgmma_rs_n128(d, a, desc_b);
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) as bf16 pairs: hi = bf16(x, y), lo = bf16 of what hi missed, so
// that hi + lo carries x and y to ~16 bits (one product per part).
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 back = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - back.x, y - back.y));
}

// The A operands of the N / 16 k16 steps over an N-column f32 accumulator,
// split into hi and lo parts.
template <int N>
__device__ __forceinline__ void accumulator_to_a(const float (&d)[N / 2],
                                                 uint32_t (&hi)[N / 16][4],
                                                 uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16x2(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
}

// 2^x by the special-function unit, subnormal results flushed to 0 (they
// are below any weight that reaches a bf16 output).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max / sum over the 4 threads of a quad (the threads that share a row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Write an m64 x TW f32 accumulator into a tile as bf16 (for a TMA store).
template <int TW>
__device__ __forceinline__ void accumulator_to_tile(uint8_t* tile, const float (&d)[TW / 2],
                                                    float scale0, float scale1) {
  const int t = threadIdx.x % WG, row = 16 * (t / 32) + (t % 32) / 4, col = 2 * (t % 4);
#pragma unroll
  for (int i = 0; i < TW / 8; ++i) {
    *reinterpret_cast<__nv_bfloat162*>(tile + tile_offset<TW>(row, 8 * i + col)) =
        __floats2bfloat162_rn(d[4 * i] * scale0, d[4 * i + 1] * scale0);
    *reinterpret_cast<__nv_bfloat162*>(tile + tile_offset<TW>(row + 8, 8 * i + col)) =
        __floats2bfloat162_rn(d[4 * i + 2] * scale1, d[4 * i + 3] * scale1);
  }
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime, so the library
// needs no -lcuda.  Looked up once.
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a contiguous [b, s, h, d] bf16 tensor whose boxes are the
// 64-row tiles above (d a multiple of 8, base 16-byte aligned).
template <int TW>
static inline bool make_tile_map(CUtensorMap* map, const void* base, int b, int s, int h,
                                 int d) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)h * d * 2,
                                 (cuuint64_t)s * h * d * 2};
  const cuuint32_t box[4] = {TW > 64 ? 64u : (cuuint32_t)TW, 1, ROWS, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = swizzle_bytes<TW>() == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swizzle_bytes<TW>() == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Dynamic shared memory is aligned here to 1024 bytes, the period of the
// 128B swizzle, so descriptors need no base offset.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

}  // namespace ptsm90
