// C ABI of the flash-attention kernels (bound from Python with ctypes).
//
// Layouts (all row-major, contiguous):
//   q, k, v, o, dout, dq, dk, dv : [b, s, h, d]   in `dtype` (0 = f32, 1 = bf16,
//                                                  2 = f16)
//   lse, delta                   : [b * h, s]     f32
//   seg                          : [b, s]         int32, or NULL (no segments)
// `stream` is a cudaStream_t.  Every function launches one kernel on it, does
// not synchronise, and returns cudaGetLastError() (0 = launched).
//
// Two routes, chosen by the caller before launch:
//   pt_flash_fwd, pt_flash_bwd_dq, pt_flash_bwd_dkv   (flash_fwd.cu, flash_bwd.cu)
//       CUDA cores, f32, bf16 or f16, any head_dim d <= 256;
//   pt_flash_fwd_sm90, pt_flash_bwd_dq_sm90, pt_flash_bwd_dkv_sm90   (*_sm90.cu)
//       tensor cores (wgmma fed by TMA), bf16 only, d a multiple of 8 up to
//       128, q, k, v, o, dout, dq, dk and dv 16-byte aligned.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

int pt_flash_fwd(const void* q, const void* k, const void* v, const int* seg,
                 void* o, float* lse, int b, int s, int h, int d, float scale,
                 int causal, int dtype, void* stream);

int pt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, const int* seg, void* dq,
                    int b, int s, int h, int d, float scale, int causal, int dtype,
                    void* stream);

int pt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, const int* seg, void* dk,
                     void* dv, int b, int s, int h, int d, float scale, int causal,
                     int dtype, void* stream);

int pt_flash_fwd_sm90(const void* q, const void* k, const void* v, const int* seg, void* o,
                      float* lse, int b, int s, int h, int d, float scale, int causal,
                      void* stream);

int pt_flash_bwd_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, const int* seg, void* dq,
                         int b, int s, int h, int d, float scale, int causal, void* stream);

int pt_flash_bwd_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, const int* seg, void* dk,
                          void* dv, int b, int s, int h, int d, float scale, int causal,
                          void* stream);

#ifdef __cplusplus
}
#endif
