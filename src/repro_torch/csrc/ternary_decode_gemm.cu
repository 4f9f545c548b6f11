// Ternary-decode mpGeMM for Hopper (sm_90a): the fused kernel and its
// integer twin, one template.
//
// Replaces two TPU kernels of src/repro/kernels/ternary_decode_gemm.py:
// - `ternary_decode_gemm_fused` (`_decode_gemm_fused_kernel` and its core
//   `_decode_block_int`): quantize the activations per token, decode each
//   packed code into g trits (c // 3^j) % 3 - 1, accumulate trit * int8
//   products in int32 over all of K, then apply w_scale * a_scale;
// - `ternary_decode_gemm` (`_decode_gemm_kernel`, the same core): the
//   unfused pipeline's middle pass, pre-quantized de-interleaved int8 a_r
//   (g, KG, N) in, the raw int32 (M, N) sums out.
//
// What bounds it on this card: at decode sizes (N = 1..16 tokens) the work
// is a GEMV over packed weights, ~0.2-0.4 bytes of weights per output MAC,
// so the floor is the bytes at 3.35 TB/s: the packed weights (M*KG) plus,
// for the integer kernel, the int8 activation (K*N) and the int32 output
// (4*M*N). The integer operations (2*M*N*K) matter only at prefill N; for
// the integer kernel at K < ~1,200 its 4-byte outputs keep even large N
// byte-bound.
//
// Design (right and simple first): one block owns a 64-row x 16-token
// output tile and loops over K itself (the TPU's sequential K grid axis and
// its VMEM int32 scratch become this loop and registers). Each K step stages
// a 64 x 32 tile of codes (coalesced along K) and the 16-token int8
// activation tile in shared memory -- quantized from the float input by the
// fused kernel, copied from a_r by the integer kernel -- and every thread
// decodes its row's codes in registers and does plain integer multiply-adds
// for 4 tokens. The fused kernel writes scaled rows coalesced along M into
// (N, M); the integer kernel writes raw int32 into (M, N). Ragged M, N and K
// edges are masked in the kernel; nothing is padded in device memory. wgmma,
// TMA and pipelining are left for later work.
#include "mpgemm_common.cuh"

namespace vlut {

constexpr int kDecodeBKG = 32;  // K-groups per step

// TA = int8_t: the integer kernel (a is a_r, out is int32 (M, N); the
// scales, lda and ldo are unused); TA = float or bf16: the fused kernel.
template <int G, typename TA, typename TO>
__global__ void __launch_bounds__(kThreads)
decode_gemm_kernel(const uint8_t* __restrict__ packed,
                   const TA* __restrict__ a,
                   const float* __restrict__ a_scale,
                   const float* __restrict__ w_scale, int ws_stride,
                   TO* __restrict__ out, int M, int KG, int N,
                   long long lda, long long ldo) {
  constexpr bool kInt = std::is_same<TA, int8_t>::value;
  constexpr int BM = kRowLanes;
  constexpr int BKG = kDecodeBKG;
  __shared__ __align__(16) int8_t aq[BKG * G * kBN];
  __shared__ uint8_t codes[BKG * BM];  // [kg][row]: conflict-free reads
  __shared__ float s_scale[kBN];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int row = threadIdx.x % BM;    // consecutive threads: consecutive m
  const int tl = threadIdx.x / BM;     // token lane: tokens tl*4 .. tl*4+3

  if constexpr (!kInt) load_token_scales(a_scale, N, n0, s_scale);
  int acc[kTokPerThread] = {0, 0, 0, 0};

  for (int kg0 = 0; kg0 < KG; kg0 += BKG) {
    const int nkg = min(BKG, KG - kg0);
    __syncthreads();  // previous step's smem reads are done (and s_scale set)
    for (int i = threadIdx.x; i < BM * BKG; i += blockDim.x) {
      const int r = i / BKG, kg = i - r * BKG;
      codes[kg * BM + r] = (m0 + r < M && kg < nkg)
                               ? packed[(long long)(m0 + r) * KG + kg0 + kg]
                               : 0;
    }
    if constexpr (kInt) {
      load_int8_tile<G>(a, KG, N, n0, kg0, nkg, BKG, aq);
    } else {
      quantize_tile(a, lda, N, n0, KG * G, kg0 * G, BKG * G, s_scale, aq);
    }
    __syncthreads();
    for (int kg = 0; kg < nkg; ++kg) {
      int c = codes[kg * BM + row];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int t = c % 3 - 1;  // trit j of the code
        c /= 3;
        const char4 q =
            *reinterpret_cast<const char4*>(aq + (kg * G + j) * kBN + tl * kTokPerThread);
        acc[0] += t * q.x;
        acc[1] += t * q.y;
        acc[2] += t * q.z;
        acc[3] += t * q.w;
      }
    }
  }
  const int m = m0 + row;
  if (m < M) {
    if constexpr (kInt) {
      write_row_int(out, m, N, n0, tl, acc);
    } else {
      write_row(out, ldo, m, N, n0, tl, acc, w_scale[(long long)m * ws_stride], s_scale);
    }
  }
}

inline dim3 decode_grid(int M, int N) {
  return dim3((M + kRowLanes - 1) / kRowLanes, (N + kBN - 1) / kBN);
}

template <int G, typename TA, typename TO>
void launch_decode(VLUT_ENTRY_ARGS) {
  decode_gemm_kernel<G, TA, TO><<<decode_grid(M, N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const TA*)a, (const float*)a_scale,
      (const float*)w_scale, ws_stride, (TO*)out, M, KG, N, lda, ldo);
}

template <int G>
void launch_decode_types(VLUT_ENTRY_ARGS) {
#define VLUT_ARGS packed, a, a_scale, w_scale, out, M, KG, N, g, lda, ldo, ws_stride, a_bf16, out_bf16, stream
  if (a_bf16) {
    if (out_bf16) launch_decode<G, __nv_bfloat16, __nv_bfloat16>(VLUT_ARGS);
    else launch_decode<G, __nv_bfloat16, float>(VLUT_ARGS);
  } else {
    if (out_bf16) launch_decode<G, float, __nv_bfloat16>(VLUT_ARGS);
    else launch_decode<G, float, float>(VLUT_ARGS);
  }
#undef VLUT_ARGS
}

template <int G>
void launch_decode_int(VLUT_INT_ENTRY_ARGS) {
  decode_gemm_kernel<G, int8_t, int32_t><<<decode_grid(M, N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int8_t*)a_r, nullptr, nullptr, 0,
      (int32_t*)out, M, KG, N, 0, N);
}

}  // namespace vlut

extern "C" int ternary_decode_gemm_fused(VLUT_ENTRY_ARGS) {
  if (M <= 0 || N <= 0 || KG <= 0) return (int)cudaErrorInvalidValue;
  if (g == 5) vlut::launch_decode_types<5>(packed, a, a_scale, w_scale, out, M, KG, N, g, lda, ldo, ws_stride, a_bf16, out_bf16, stream);
  else if (g == 4) vlut::launch_decode_types<4>(packed, a, a_scale, w_scale, out, M, KG, N, g, lda, ldo, ws_stride, a_bf16, out_bf16, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int ternary_decode_gemm(VLUT_INT_ENTRY_ARGS) {
  if (M <= 0 || N <= 0 || KG <= 0) return (int)cudaErrorInvalidValue;
  if (g == 5) vlut::launch_decode_int<5>(packed, a_r, out, M, KG, N, g, stream);
  else if (g == 4) vlut::launch_decode_int<4>(packed, a_r, out, M, KG, N, g, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
