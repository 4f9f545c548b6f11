// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, `pallas_call` in `flash_attention`,
// body `_flash_kernel`): causal / windowed / softcapped GQA self-attention
// with an online softmax in f32, so the (Sq, Sk) score matrix never reaches
// device memory.
//
//   s = (q . k) * D^-0.5, then optionally tanh(s / softcap) * softcap
//   mask: q_pos < Sq & k_pos < Sk, causal k <= q, window q - k < window
//         (positions local, counted from 0); a masked score is the FINITE
//         -1e30, never -inf: a tile fully masked before a row's first valid
//         key leaves m = -1e30 and p = exp(0) = 1, and the first valid tile
//         wipes that through alpha = exp(-1e30 - m) = 0 (with -inf, NaN)
//   out = acc / max(l, 1e-30), cast to q's dtype
//   GQA: query head h reads KV head h / (H / KV), with no K/V replication.
//
// What bounds it on this card: at the training shape of smollm-360m
// (B 8, S 512, H 15, KV 5, D 64, causal, bf16) the function moves ~21 MB
// (Q, K, V read once, O written once: ~6 us at 3.35 TB/s) and does ~4 GFLOP
// (~4 us at the 989 TFLOP/s bf16 tensor-core peak), so the floor is bytes.
//
// Design (right and simple first): one block of 256 threads owns 64 query
// rows of one (b, h) and loops over 64-key tiles of K and V (the TPU's
// sequential KV grid axis and its VMEM scratch become this loop and
// registers). Q, K and V tiles are staged in shared memory as f32 (bf16 is
// widened on load); each thread computes a 4 x 4 block of scores with f32
// FMAs on the CUDA cores, the running max and sum of a row are reduced with
// warp shuffles over the 16 threads that share it, and p stays f32 in the
// p @ v product (each thread owns 4 rows x D/16 output columns). Tiles that
// the causal mask or the window masks whole for every row of the block are
// skipped. Ragged Sq, Sk and D edges are masked in the kernel; the wrapper
// pads nothing, and every tensor is read through its strides (the model's
// (B, S, H, D) layout needs no transpose). Any D <= 256. Tensor cores
// (wgmma), TMA and pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kBQ = 64;              // query rows per block
constexpr int kBK = 64;              // keys per tile
constexpr int kTX = 16;              // threads sharing one query row
constexpr int kTY = 16;
constexpr int kThreads = kTX * kTY;  // 256
constexpr int kRows = kBQ / kTY;     // 4 query rows per thread: ty + 16 i
constexpr int kCols = kBK / kTX;     // 4 keys per thread: tx + 16 j
constexpr int kLdP = kBK + 1;        // padded row stride of the p tile
constexpr float kNegInf = -1e30f;

struct Params {
  const void *q, *k, *v;
  void *o;
  int B, H, KV, Sq, Sk, D;
  long long sqb, sqh, sqs;  // element strides over (batch, head, position)
  long long skb, skh, sks;
  long long svb, svh, svs;
  long long sob, soh, sos;
  int causal, window;
  float scale, softcap;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Shared floats: Q [kBQ][D+1], K [kBK][D+1] (padded: conflict-free column
// reads), V [kBK][16*DPT] (zero past D), p [kBQ][kLdP].
inline size_t smem_bytes(int D, int dpt) {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (D + 1) + (size_t)kBK * kTX * dpt +
                          (size_t)kBQ * kLdP);
}

template <int DPT, typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int ldq = D + 1;
  constexpr int ldv = kTX * DPT;
  float* Qs = smem;
  float* Ks = Qs + kBQ * ldq;
  float* Vs = Ks + kBK * ldq;
  float* Ps = Vs + kBK * ldv;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;

  const T* q = (const T*)p.q + b * p.sqb + h * p.sqh;
  const T* k = (const T*)p.k + b * p.skb + kvh * p.skh;
  const T* v = (const T*)p.v + b * p.svb + kvh * p.svh;
  T* o = (T*)p.o + b * p.sob + h * p.soh;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    Qs[r * ldq + d] = q0 + r < p.Sq ? to_f32(q[(long long)(q0 + r) * p.sqs + d]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) acc[i][dd] = 0.f;
  }

  // key tiles that hold a valid key for at least one row of the block
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int kt_end = (p.Sk + kBK - 1) / kBK;
  if (p.causal) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (p.window && q0 - p.window + 1 > 0) kt_begin = (q0 - p.window + 1) / kBK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's reads are done (and Q is staged)
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const int c = i / D, d = i - c * D;
      Ks[c * ldq + d] = k0 + c < p.Sk ? to_f32(k[(long long)(k0 + c) * p.sks + d]) : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * ldv; i += kThreads) {
      const int c = i / ldv, d = i - c * ldv;
      Vs[i] = (k0 + c < p.Sk && d < D) ? to_f32(v[(long long)(k0 + c) * p.svs + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(ty + kTY * i) * ldq + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(tx + kTX * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + ty + kTY * i;
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + kTX * j;
        float x = s[i][j] * p.scale;
        if (p.softcap != 0.f) x = tanhf(x / p.softcap) * p.softcap;
        bool ok = qp < p.Sq && kp < p.Sk;
        if (p.causal) ok = ok && kp <= qp;
        if (p.window) ok = ok && qp - kp < p.window;
        s[i][j] = ok ? x : kNegInf;
        rmax = fmaxf(rmax, s[i][j]);
      }
      // the 16 threads of a row are lanes 0-15 or 16-31 of one warp
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[i], rmax);
      const float alpha = expf(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kp = k0 + tx + kTX * j;
        const float pj = kp < p.Sk ? expf(s[i][j] - m_new) : 0.f;  // no key past Sk
        Ps[(ty + kTY * i) * kLdP + tx + kTX * j] = pj;
        rsum += pj;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * alpha + rsum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) acc[i][dd] *= alpha;
    }
    __syncthreads();  // the p tile is complete

    const int nc = min(kBK, p.Sk - k0);
    for (int c = 0; c < nc; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = Ps[(ty + kTY * i) * kLdP + c];
#pragma unroll
      for (int dd = 0; dd < DPT; ++dd) {
        const float vv = Vs[c * ldv + tx + kTX * dd];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][dd] = fmaf(pv[i], vv, acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int qp = q0 + ty + kTY * i;
    if (qp >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DPT; ++dd) {
      const int d = tx + kTX * dd;
      if (d < D) store(o + (long long)qp * p.sos + d, acc[i][dd] / denom);
    }
  }
}

template <int DPT, typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p.D, DPT);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<DPT, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBQ - 1) / kBQ, p.H, p.B);
  flash_fwd_kernel<DPT, T><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<2, T>(p, stream);
  if (p.D <= 64) return launch<4, T>(p, stream);
  if (p.D <= 128) return launch<8, T>(p, stream);
  return launch<16, T>(p, stream);
}

}  // namespace flash

// q (B, H, Sq, D), k and v (B, KV, Sk, D), o (B, H, Sq, D), all of one dtype
// (f32, or bf16 when bf16 != 0), each with unit stride along D and the given
// element strides over (batch, head, position). Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int H, int KV, int Sq, int Sk, int D,
                                   long long sqb, long long sqh, long long sqs,
                                   long long skb, long long skh, long long sks,
                                   long long svb, long long svh, long long svs,
                                   long long sob, long long soh, long long sos,
                                   int causal, int window, float scale, float softcap,
                                   int bf16, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const flash::Params p{q, k, v, o, B, H, KV, Sq, Sk, D,
                        sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos,
                        causal, window, scale, softcap};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? flash::launch_d<__nv_bfloat16>(p, s) : flash::launch_d<float>(p, s));
}
