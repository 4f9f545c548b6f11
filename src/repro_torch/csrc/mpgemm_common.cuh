// Shared pieces of the mpGeMM kernels: the layout contracts of all four,
// the float conversions and stores, and the vector-LUT kernels' tile
// geometry and token-scale load. Each template keeps its own prologues,
// epilogues and launch plan in its own source (ternary_decode_gemm.cu,
// vlut_lookup_gemm.cu).
//
// Layout contract of the fused kernels:
//   packed  (M, KG) uint8, row-major, trit codes of one homogeneous-g segment
//   a       (N, KG*g) f32 or bf16, row stride `lda` elements, unit column
//           stride: the token-major activation the model produces, read in
//           place (no transpose, no padding)
//   a_scale (N,) f32, per-token max(|a|, 1e-6)/127 over the FULL K (all
//           segments), computed once outside the kernel
//   w_scale (M,) f32, or (1,) broadcast when ws_stride == 0
//   out     (N, M) f32 or bf16, row stride `ldo`
//   out[n, m] = (float(sum_k trit(W[m, k]) * q(a[n, k])) * w_scale[m]) * a_scale[n]
//
// Layout contract of the integer kernels (the unfused pipeline's middle pass):
//   packed  (M, KG) uint8, as above
//   a_r     (g, KG, N) int8, contiguous: pre-quantized and de-interleaved,
//           a_r[j, kg, n] = a_q[kg*g + j, n]
//   out     (M, N) int32, contiguous: out[m, n] = sum_k trit(W[m, k]) * a_q[k, n]
// Both kernels of a pair are one template: an int8 activation type selects
// the integer prologue and epilogue at compile time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace vlut {

constexpr int kThreads = 256;                  // threads per block
constexpr int kBN = 16;                        // tokens per block tile
constexpr int kTokLanes = 4;                   // threads sharing one row
constexpr int kTokPerThread = kBN / kTokLanes; // 4 consecutive tokens each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Per-token scales of this block's token tile into shared memory; tokens
// past N get 1 (their activations are quantized to 0 and never written).
__device__ __forceinline__ void load_token_scales(const float* a_scale, int N,
                                                  int n0, float* s_scale) {
  if (threadIdx.x < kBN) {
    const int n = n0 + threadIdx.x;
    s_scale[threadIdx.x] = n < N ? a_scale[n] : 1.f;
  }
}

}  // namespace vlut
