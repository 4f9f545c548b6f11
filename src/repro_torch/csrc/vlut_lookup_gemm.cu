// Vector-LUT mpGeMM for Hopper (sm_90a), the paper's kernel: the fused
// kernel and its integer twin, one template.
//
// Replaces two TPU kernels of src/repro/kernels/vlut_lookup_gemm.py:
// - `vlut_lookup_gemm_fused` (`_vlut_fused_kernel` and its core
//   `_lut_block_int`): quantize the activations per token, build the
//   unified table T[kg][e][n] = sum_j S[e][j] * A_q[n][kg*g + j] over all
//   3^g trit patterns e, then let every packed code c = W[m, kg] fetch the
//   row T[kg][c][:] (one 1 -> N vector lookup) and accumulate it in int32;
//   the epilogue applies w_scale * a_scale;
// - `vlut_lookup_gemm` (`_vlut_kernel`, the same core): the unfused
//   pipeline's middle pass, pre-quantized de-interleaved int8 a_r
//   (g, KG, N) in, the raw int32 (M, N) sums out. The TPU kernel's
//   `lookup` choice ("onehot" or "serial") is two TPU lowerings of the
//   same row select with equal integers; here there is one, the gather.
//
// What bounds it on this card: the table build costs 3^g*g MACs per K-group
// and token, shared by the block's 128 rows, so it is operation-bound on
// CUDA cores at every N; the memory floor is far below: the packed weights
// (M*KG bytes) plus, for the integer kernel, the int8 activation (K*N) and
// the int32 output (4*M*N). The TPU version built T with an MXU contraction
// and replaced the gather by a one-hot matmul because the TPU has no
// cross-sublane gather; a shared-memory gather is native here, so this
// kernel does the literal lookup.
//
// Design (right and simple first): one block owns a 128-row x 16-token
// output tile and loops over K. Each K step stages a 16-token int8
// activation tile in shared memory (quantized from the float input by the
// fused kernel, copied from a_r by the integer kernel), builds T for 4
// (g=5) or 12 (g=4) K-groups by direct S.A (only for the tile's valid
// tokens), and stages the codes; each thread then gathers one 8-byte T row
// slice (4 tokens of int16) per code for two rows. |T| <= 5*127 = 635 fits
// int16; sums are int32 as on the TPU. The table is 31,104 bytes for either
// g, inside the 48 KB of static shared memory (the JAX default tile,
// bkg=32 x bn=128, would need ~2 MB). The fused kernel writes scaled rows
// into (N, M), the integer kernel raw int32 into (M, N). The paper's
// topological precompute (3^g - 1 adds per table) is left for later work.
#include "mpgemm_common.cuh"

namespace vlut {

constexpr int kLutRows = 2;                   // rows per thread
constexpr int kLutBM = kRowLanes * kLutRows;  // 128

template <int G> struct LutGeom;
template <> struct LutGeom<5> { static constexpr int E = 243, BKG = 4; };
template <> struct LutGeom<4> { static constexpr int E = 81, BKG = 12; };

// TA = int8_t: the integer kernel (a is a_r, out is int32 (M, N); the
// scales, lda and ldo are unused); TA = float or bf16: the fused kernel.
template <int G, typename TA, typename TO>
__global__ void __launch_bounds__(kThreads)
vlut_kernel(const uint8_t* __restrict__ packed, const TA* __restrict__ a,
            const float* __restrict__ a_scale,
            const float* __restrict__ w_scale, int ws_stride,
            TO* __restrict__ out, int M, int KG, int N, long long lda,
            long long ldo) {
  constexpr bool kInt = std::is_same<TA, int8_t>::value;
  constexpr int E = LutGeom<G>::E, BKG = LutGeom<G>::BKG, BM = kLutBM;
  __shared__ __align__(16) int16_t lut[BKG * E * kBN];  // [kg][e][n]
  __shared__ __align__(16) int8_t aq[BKG * G * kBN];
  __shared__ uint8_t codes[BKG * BM];                   // [kg][row]
  __shared__ float s_scale[kBN];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int row = threadIdx.x % kRowLanes;
  const int tl = threadIdx.x / kRowLanes;
  const int nv = min(kBN, N - n0);  // valid tokens in this tile

  if constexpr (!kInt) load_token_scales(a_scale, N, n0, s_scale);
  int acc[kLutRows][kTokPerThread] = {};

  for (int kg0 = 0; kg0 < KG; kg0 += BKG) {
    const int nkg = min(BKG, KG - kg0);
    __syncthreads();
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
    // table build: T[kg][e][n] = sum_j (trit_j(e)) * aq[kg*g + j][n];
    // entries of tokens past nv are never read into a written output
    for (int i = threadIdx.x; i < nkg * E * nv; i += blockDim.x) {
      const int n = i % nv, ke = i / nv;
      const int e = ke % E, kg = ke / E;
      const int8_t* col = aq + kg * G * kBN + n;
      int c = e, v = 0;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        v += (c % 3 - 1) * col[j * kBN];
        c /= 3;
      }
      lut[(kg * E + e) * kBN + n] = static_cast<int16_t>(v);
    }
    __syncthreads();
    for (int kg = 0; kg < nkg; ++kg) {
#pragma unroll
      for (int r = 0; r < kLutRows; ++r) {
        const int c = codes[kg * BM + r * kRowLanes + row];
        const short4 t = *reinterpret_cast<const short4*>(
            lut + (kg * E + c) * kBN + tl * kTokPerThread);
        acc[r][0] += t.x;
        acc[r][1] += t.y;
        acc[r][2] += t.z;
        acc[r][3] += t.w;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kLutRows; ++r) {
    const int m = m0 + r * kRowLanes + row;
    if (m < M) {
      if constexpr (kInt) {
        write_row_int(out, m, N, n0, tl, acc[r]);
      } else {
        write_row(out, ldo, m, N, n0, tl, acc[r], w_scale[(long long)m * ws_stride], s_scale);
      }
    }
  }
}

inline dim3 lut_grid(int M, int N) {
  return dim3((M + kLutBM - 1) / kLutBM, (N + kBN - 1) / kBN);
}

template <int G, typename TA, typename TO>
void launch_lut(VLUT_ENTRY_ARGS) {
  vlut_kernel<G, TA, TO><<<lut_grid(M, N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const TA*)a, (const float*)a_scale,
      (const float*)w_scale, ws_stride, (TO*)out, M, KG, N, lda, ldo);
}

template <int G>
void launch_lut_types(VLUT_ENTRY_ARGS) {
#define VLUT_ARGS packed, a, a_scale, w_scale, out, M, KG, N, g, lda, ldo, ws_stride, a_bf16, out_bf16, stream
  if (a_bf16) {
    if (out_bf16) launch_lut<G, __nv_bfloat16, __nv_bfloat16>(VLUT_ARGS);
    else launch_lut<G, __nv_bfloat16, float>(VLUT_ARGS);
  } else {
    if (out_bf16) launch_lut<G, float, __nv_bfloat16>(VLUT_ARGS);
    else launch_lut<G, float, float>(VLUT_ARGS);
  }
#undef VLUT_ARGS
}

template <int G>
void launch_lut_int(VLUT_INT_ENTRY_ARGS) {
  vlut_kernel<G, int8_t, int32_t><<<lut_grid(M, N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int8_t*)a_r, nullptr, nullptr, 0,
      (int32_t*)out, M, KG, N, 0, N);
}

}  // namespace vlut

extern "C" int vlut_lookup_gemm_fused(VLUT_ENTRY_ARGS) {
  if (M <= 0 || N <= 0 || KG <= 0) return (int)cudaErrorInvalidValue;
  if (g == 5) vlut::launch_lut_types<5>(packed, a, a_scale, w_scale, out, M, KG, N, g, lda, ldo, ws_stride, a_bf16, out_bf16, stream);
  else if (g == 4) vlut::launch_lut_types<4>(packed, a, a_scale, w_scale, out, M, KG, N, g, lda, ldo, ws_stride, a_bf16, out_bf16, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

extern "C" int vlut_lookup_gemm(VLUT_INT_ENTRY_ARGS) {
  if (M <= 0 || N <= 0 || KG <= 0) return (int)cudaErrorInvalidValue;
  if (g == 5) vlut::launch_lut_int<5>(packed, a_r, out, M, KG, N, g, stream);
  else if (g == 4) vlut::launch_lut_int<4>(packed, a_r, out, M, KG, N, g, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
