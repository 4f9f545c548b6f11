// Shared pieces of the mpGeMM kernels: the layout contracts, the tile
// geometry and the token-scale load of all four, and the decode kernels'
// prologues (the fused kernel's activation quantization, the integer
// kernel's int8 tile copy) and epilogues (scaled float store, raw int32
// store); the vector-LUT kernels keep their own in vlut_lookup_gemm.cu.
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
constexpr int kRowLanes = kThreads / kTokLanes;  // 64 rows per pass

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

// Prologue: quantize a[n0:n0+kBN, k0:k0+kk] to int8 in shared memory,
// token-minor (aq[k * kBN + n]), so one 32-bit load gives a thread its four
// tokens. Exactly the TPU kernel's quantizer: f32 cast FIRST, then a true
// IEEE division by the scale (never a reciprocal multiply; this file must
// not be compiled with --use_fast_math), rint = round half to even, clip to
// +-127. Features past the segment end and tokens past N read as 0.
template <typename TA>
__device__ __forceinline__ void quantize_tile(const TA* __restrict__ a,
                                              long long lda, int N, int n0,
                                              int kseg, int k0, int kk,
                                              const float* s_scale,
                                              int8_t* aq) {
  for (int i = threadIdx.x; i < kk * kBN; i += blockDim.x) {
    const int n = i / kk, k = i - n * kk;      // k fastest: coalesced reads
    int8_t q = 0;
    if (n0 + n < N && k0 + k < kseg) {
      const float v = to_f32(a[(long long)(n0 + n) * lda + k0 + k]);
      const float r = fminf(fmaxf(rintf(v / s_scale[n]), -127.f), 127.f);
      q = static_cast<int8_t>(r);
    }
    aq[k * kBN + n] = q;
  }
}

// Prologue of the integer kernels: copy a_r[:, kg0:kg0+bkg, n0:n0+kBN]
// into the same shared layout as quantize_tile, aq[k * kBN + n] with the
// tile-local feature k = kg * G + j (tokens fastest: coalesced reads).
// K-groups past nkg and tokens past N read as 0.
template <int G>
__device__ __forceinline__ void load_int8_tile(const int8_t* __restrict__ a_r,
                                               int KG, int N, int n0, int kg0,
                                               int nkg, int bkg, int8_t* aq) {
  for (int i = threadIdx.x; i < bkg * G * kBN; i += blockDim.x) {
    const int n = i % kBN, k = i / kBN;
    const int kg = k / G, j = k - kg * G;
    int8_t q = 0;
    if (kg < nkg && n0 + n < N) {
      q = a_r[((long long)j * KG + kg0 + kg) * N + n0 + n];
    }
    aq[k * kBN + n] = q;
  }
}

// Epilogue of the integer kernels: the raw int32 sums of one row and this
// thread's tokens into out (M, N).
__device__ __forceinline__ void write_row_int(int32_t* __restrict__ out, int m,
                                              int N, int n0, int tl,
                                              const int* acc) {
#pragma unroll
  for (int t = 0; t < kTokPerThread; ++t) {
    const int n = n0 + tl * kTokPerThread + t;
    if (n < N) out[(long long)m * N + n] = acc[t];
  }
}

// Epilogue for one row and this thread's tokens: (acc * w_scale) * a_scale
// in f32, then one rounding to the output type.
template <typename TO>
__device__ __forceinline__ void write_row(TO* __restrict__ out, long long ldo,
                                          int m, int N, int n0, int tl,
                                          const int* acc, float ws,
                                          const float* s_scale) {
#pragma unroll
  for (int t = 0; t < kTokPerThread; ++t) {
    const int nl = tl * kTokPerThread + t;
    if (n0 + nl < N) {
      store(out + (long long)(n0 + nl) * ldo + m,
            (static_cast<float>(acc[t]) * ws) * s_scale[nl]);
    }
  }
}

}  // namespace vlut

// The C entry of the fused decode kernel (the vector-LUT kernels' entries,
// which also take their launch plan, are in vlut_lookup_gemm.cu):
//   int <name>(packed, a, a_scale, w_scale, out, M, KG, N, g, lda, ldo,
//              ws_stride, a_bf16, out_bf16, stream)
// launches on `stream` and returns cudaGetLastError().
#define VLUT_ENTRY_ARGS                                                    \
  const void *packed, const void *a, const void *a_scale,                  \
      const void *w_scale, void *out, int M, int KG, int N, int g,         \
      long long lda, long long ldo, int ws_stride, int a_bf16, int out_bf16, \
      void *stream

// The C entry of the integer decode kernel:
//   int <name>(packed, a_r, out, M, KG, N, g, stream)
// launches on `stream` and returns cudaGetLastError().
#define VLUT_INT_ENTRY_ARGS                                               \
  const void *packed, const void *a_r, void *out, int M, int KG, int N,   \
      int g, void *stream
