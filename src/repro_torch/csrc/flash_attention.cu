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
// Both floors are far below what the chain of dependent steps of one block
// (copy, QK^T, softmax, PV for each key tile) takes, so the design keeps
// every step short and overlapped: products on the tensor cores, tiles in
// bf16, the next tile's copy in flight during this tile's products, and
// enough blocks on an SM that one block's softmax hides another's products.
//
// Two kernels, chosen by an explicit rule by dtype and D in the C entry:
//
// 1. bf16 with D <= 128: the tensor-core kernel (`tc::flash_mma_kernel`),
//    after FlashAttention-2's forward.
//    - A block of 4 warps owns 64 query rows of one (b, h), 16 rows a warp.
//      The grid is (B * H, query tiles) with the query tile reversed, so the
//      heaviest causal tiles of every head start in the first wave.
//    - Q, K and V stay bf16 in shared memory. D is padded with zeros to DP,
//      the next of 16, 32, 64 and 128 (a multiple of 16, the mma depth).
//      Each [rows][DP] tile is XOR-swizzled in 16-byte chunks so that the 8
//      rows an ldmatrix reads fall on 8 distinct bank quads.
//    - K and V tiles of 32 keys are double-buffered with one barrier per
//      tile: after it, the copy of tile j+1 is issued (cp.async, 16 bytes a
//      thread, zero-filled past Sk and past D) and runs during the products
//      on tile j (commit / wait_group). cp.async is used only where the
//      host plan found every base pointer 16-byte aligned and every stride a
//      multiple of 8 elements (the model's transposed (B, S, H, D) views at
//      D 64 and 128); the entry checks the claim again. Otherwise (D 20) the
//      same tiles are filled by element loads.
//    - S = Q K^T runs as mma.sync m16n8k16 bf16 with f32 accumulators (a
//      bf16 x bf16 product is exact in f32: S differs from the plain
//      version only in the order of summation). Q's A fragments and K's B
//      fragments come from ldmatrix; Q is read again at every k16 step: at
//      DP <= 64 the kernel keeps to 128 registers a thread (4 blocks an SM),
//      and Q held in registers would spill there.
//    - The online softmax runs in registers: each thread holds 8 scores of
//      2 rows per tile; a row's max is reduced over the 4 lanes of its quad
//      (__shfl_xor_sync by 1 and 2), its sum at the end. The finite -1e30
//      mask is applied only on tiles that cross the causal diagonal, the
//      window's edge or Sk; keys past Sk get p = 0. alpha = exp(m_old -
//      m_new), with the scale folded into the exponent (ex2).
//    - P goes from the S accumulators to the A fragments of the P V mma in
//      registers (two n8 accumulator tiles are one k16 operand), rounded to
//      bf16; l is summed from the f32 p. V's B fragments come from ldmatrix
//      .trans. No P tile in shared memory.
//    - Key tiles that the causal mask or the window masks whole for every
//      row of the block are skipped.
//    - Epilogue: out = O * (1 / max(l, 1e-30)) as bf16 through the output's
//      strides; rows at or past Sq are not written.
//
// 2. f32 (any D <= 256), and bf16 with D in 129..256: the CUDA-core kernel
//    (`flash_fwd_kernel`), unchanged from the first port. On the tensor
//    cores f32 would run as TF32 (~3 decimal digits), outside the f32
//    tolerance; bf16 at D > 128 would need twice the accumulator registers
//    of the tensor-core kernel's layout. One block of 256 threads owns 64
//    query rows and loops over 64-key tiles staged in shared memory as f32;
//    each thread computes a 4 x 4 block of scores with f32 FMAs, the row max
//    and sum are reduced with warp shuffles over the 16 threads that share a
//    row, and p goes through shared memory to an f32 p @ v product. Ragged
//    Sq, Sk and D are masked; any strides with a unit stride along D are
//    read in place.
//
// Later work: wgmma and TMA with an mbarrier ring, warp specialisation, the
// G query heads of one KV head in one block, D > 128 on the tensor cores.
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

// The CUDA-core kernel's padded D (kTX * DPT) and shared bytes.
inline int fma_dp(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256; }
inline size_t fma_smem(int D) { return smem_bytes(D, fma_dp(D) / kTX); }

// ---------------------------------------------------------------------------
// The tensor-core kernel (bf16, D <= 128).
namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // query rows per block
constexpr int kBK = 32;            // keys per tile
constexpr int kStages = 2;         // K/V tiles in flight
constexpr int kMaxD = 128;

typedef __nv_bfloat16 bf16;

// D padded to the next of 16, 32, 64, 128
inline int pad_d(int D) { return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : 128; }

// Q [kBQ][DP], then kStages x (K [kBK][DP], V [kBK][DP]), all bf16
inline size_t smem_bytes(int dp) {
  return sizeof(bf16) * (size_t)dp * (kBQ + 2 * kStages * kBK);
}

// Byte offset of 16-byte chunk c (8 bf16 along D) of row r in a [rows][DP]
// tile. The chunk index is XORed with the row's place among the rows that
// share a 128-byte line, so an ldmatrix's 8 rows at one chunk column land on
// 8 distinct bank quads (and cp.async writes whole aligned chunks).
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int C = DP / 8;                  // chunks per row
  constexpr int X = C < 8 ? C : 8;           // chunk bits that are XORed
  constexpr int RPL = C < 8 ? 8 / C : 1;     // rows per 128-byte line
  return (r * C + (c ^ ((r / RPL) & (X - 1)))) * 16;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU (exact at 0: a fully masked row's p = 1 as in the reference)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [p0, p0 + ROWS) of a (position, D) matrix (position stride ss
// elements, unit stride along D) into a swizzled [ROWS][DP] tile: zeros past
// S and past D. Aligned: one cp.async of 16 bytes per chunk (the caller
// commits); else element loads and stores.
template <int DP, int ROWS>
__device__ __forceinline__ void stage(unsigned char* tile, const bf16* base, long long ss,
                                      int p0, int S, int D, bool aligned) {
  constexpr int C = DP / 8;
  if (aligned) {
    constexpr int N = (ROWS * C + kThreads - 1) / kThreads;   // chunks per thread
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int i = threadIdx.x + n * kThreads;
      if (ROWS * C % kThreads == 0 || i < ROWS * C) {
        const int r = i / C, c = i % C;
        const bool ok = p0 + r < S && c * 8 < D;
        const bf16* src = ok ? base + (long long)(p0 + r) * ss + c * 8 : base;
        cp_async16(smem_addr(tile + swz<DP>(r, c)), src, ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * DP; i += kThreads) {
      const int r = i / DP, d = i % DP;
      const bf16 x = (p0 + r < S && d < D) ? base[(long long)(p0 + r) * ss + d]
                                           : __float2bfloat16_rn(0.f);
      *reinterpret_cast<bf16*>(tile + swz<DP>(r, d / 8) + (d % 8) * 2) = x;
    }
  }
}

// One block: kWarps warps of 16 query rows each (kBQ rows of one (b, h)).
// At DP <= 64 the block keeps to 128 registers a thread, so that 4 blocks
// (16 warps) share an SM; Q is read from shared memory at every k16 step
// rather than kept in registers, which would spill at that budget.
template <int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 4 : 1) flash_mma_kernel(Params p, int aligned) {
  constexpr int NS = kBK / 8;      // n8 score tiles of a warp's 16 x kBK scores
  constexpr int ND = DP / 8;       // n8 output tiles of its 16 x DP outputs
  constexpr int KD = DP / 16;      // k16 steps over D
  constexpr int TILE = kBK * DP * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* KVs = smem + kBQ * DP * 2;   // stage st: K at 2*st*TILE, V after it

  const int qt = gridDim.y - 1 - blockIdx.y;   // heaviest causal tiles first
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qt * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  const bf16* q = (const bf16*)p.q + b * p.sqb + h * p.sqh;
  const bf16* k = (const bf16*)p.k + b * p.skb + kvh * p.skh;
  const bf16* v = (const bf16*)p.v + b * p.svb + kvh * p.svh;
  bf16* o = (bf16*)p.o + b * p.sob + h * p.soh;

  // key tiles that hold a valid key for at least one row of the block
  const int q_last = min(q0 + kBQ, p.Sq) - 1;
  int kt_end = (p.Sk + kBK - 1) / kBK;
  if (p.causal) kt_end = min(kt_end, q_last / kBK + 1);
  int kt_begin = 0;
  if (p.window && q0 - p.window + 1 > 0) kt_begin = (q0 - p.window + 1) / kBK;

  // prologue: Q and the first kStages - 1 key tiles, one commit group each
  stage<DP, kBQ>(Qs, q, p.sqs, q0, p.Sq, p.D, aligned);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (kt_begin + i < kt_end) {
      stage<DP, kBK>(KVs + 2 * i * TILE, k, p.sks, (kt_begin + i) * kBK, p.Sk, p.D, aligned);
      stage<DP, kBK>(KVs + (2 * i + 1) * TILE, v, p.svs, (kt_begin + i) * kBK, p.Sk, p.D, aligned);
    }
    cp_async_commit();
  }

  // Scores are kept in the raw q.k domain when there is no softcap (the max
  // commutes with the positive scale, which is folded into the exponent),
  // else in the softcapped domain; a masked score is -1e30 in either.
  const float to_log2 = (p.softcap != 0.f ? 1.f : p.scale) * 1.4426950408889634f;
  float m[2] = {kNegInf, kNegInf};   // rows g and g + 8 of the warp's 16
  float l[2] = {0.f, 0.f};           // this thread's part of the row sums
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int row0 = q0 + warp * 16 + g;   // query position of row g

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) % kStages;
    const int k0 = kt * kBK;
    cp_async_wait<kStages - 2>();   // tile kt (and, the first time, Q) has landed
    // one barrier per tile: tile kt is visible to every warp, and every warp
    // is done with tile kt - 1, whose buffer the copy below refills
    __syncthreads();
    if (kt + kStages - 1 < kt_end) {   // overlaps the products on the tiles before it
      unsigned char* nxt = KVs + 2 * ((st + kStages - 1) % kStages) * TILE;
      stage<DP, kBK>(nxt, k, p.sks, k0 + (kStages - 1) * kBK, p.Sk, p.D, aligned);
      stage<DP, kBK>(nxt + TILE, v, p.svs, k0 + (kStages - 1) * kBK, p.Sk, p.D, aligned);
    }
    cp_async_commit();
    const unsigned char* Ks = KVs + 2 * st * TILE;
    const unsigned char* Vs = Ks + TILE;

    // S = Q K^T: 16 x kBK per warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, smem_addr(Qs + swz<DP>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4))));
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_addr(Ks + swz<DP>(16 * jj + (lane & 7) + ((lane >> 4) << 3),
                                            2 * kk + ((lane >> 3) & 1))));
        mma(s[2 * jj], qa, bk[0], bk[1]);
        mma(s[2 * jj + 1], qa, bk[2], bk[3]);
      }
    }

    // softcap and mask; online softmax, row max over the quad's 4 lanes
    const bool edge = k0 + kBK > p.Sk || (p.causal && k0 + kBK - 1 > q0) ||
                      (p.window && q_last - k0 >= p.window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e];
        if (p.softcap != 0.f) x = tanhf(x * p.scale / p.softcap) * p.softcap;
        if (edge) {
          const int qp = row0 + (e >> 1) * 8, kp = k0 + 8 * n + 2 * t + (e & 1);
          bool ok = kp < p.Sk;
          if (p.causal) ok = ok && kp <= qp;
          if (p.window) ok = ok && qp - kp < p.window;
          x = ok ? x : kNegInf;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = ex2((m[i] - m_new) * to_log2);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe = ex2((s[n][e] - m[e >> 1]) * to_log2);
        if (edge && k0 + 8 * n + 2 * t + (e & 1) >= p.Sk) pe = 0.f;   // no key past Sk
        s[n][e] = pe;
        l[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P's A fragments straight from the S accumulators (two n8
    // tiles make one k16 operand), V's B fragments from ldmatrix .trans
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int jj = 0; jj < ND / 2; ++jj) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_addr(Vs + swz<DP>(16 * kk + (lane & 15), 2 * jj + (lane >> 4))));
        mma(acc[2 * jj], pa, bv[0], bv[1]);
        mma(acc[2 * jj + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: the row sums over the quad, out = acc / max(l, 1e-30) as bf16
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qp = row0 + 8 * i;
    if (qp >= p.Sq) continue;
    const float inv = __frcp_rn(fmaxf(li, 1e-30f));
    bf16* orow = o + (long long)qp * p.sos;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      const int d = 8 * j + 2 * t;
      const float x0 = acc[j][2 * i] * inv, x1 = acc[j][2 * i + 1] * inv;
      if (aligned) {
        if (d < p.D) *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (d < p.D) orow[d] = __float2bfloat16_rn(x0);
        if (d + 1 < p.D) orow[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const Params& p, int aligned, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  flash_mma_kernel<DP><<<grid, kThreads, smem, stream>>>(p, aligned);
  return cudaGetLastError();
}

inline cudaError_t launch_dp(const Params& p, int dp, int aligned, size_t smem, cudaStream_t s) {
  switch (dp) {
    case 16: return launch<16>(p, aligned, smem, s);
    case 32: return launch<32>(p, aligned, smem, s);
    case 64: return launch<64>(p, aligned, smem, s);
    default: return launch<128>(p, aligned, smem, s);
  }
}

// The cp.async claim, checked again: every base pointer 16-byte aligned,
// D and every stride a multiple of 8 elements.
inline bool copies_aligned(const Params& p) {
  const long long strides[] = {p.sqb, p.sqh, p.sqs, p.skb, p.skh, p.sks,
                               p.svb, p.svh, p.svs, p.sob, p.soh, p.sos};
  for (long long st : strides)
    if (st % 8) return false;
  const void* ptrs[] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if ((uintptr_t)ptr % 16) return false;
  return p.D % 8 == 0;
}

}  // namespace tc

}  // namespace flash

// q (B, H, Sq, D), k and v (B, KV, Sk, D), o (B, H, Sq, D), all of one dtype
// (f32, or bf16 when bf16 != 0), each with unit stride along D and the given
// element strides over (batch, head, position). The launch plan (bq, bk,
// dp, stages, aligned, smem) comes from `flash_plan` on the host; this entry
// picks the kernel by its rule (bf16 with D <= 128: tensor cores; else the
// CUDA cores), recomputes the plan's shared bytes and refuses a plan that
// disagrees. Returns a cudaError_t (cudaErrorInvalidValue for a refused
// plan).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int H, int KV, int Sq, int Sk, int D,
                                   long long sqb, long long sqh, long long sqs,
                                   long long skb, long long skh, long long sks,
                                   long long svb, long long svh, long long svs,
                                   long long sob, long long soh, long long sos,
                                   int causal, int window, float scale, float softcap,
                                   int bf16, int bq, int bk, int dp, int stages, int aligned,
                                   long long smem, void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV || Sq <= 0 || Sk <= 0 || D <= 0 || D > 256 ||
      H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const flash::Params p{q, k, v, o, B, H, KV, Sq, Sk, D,
                        sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos,
                        causal, window, scale, softcap};
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16 && D <= flash::tc::kMaxD) {
    namespace tc = flash::tc;
    if (bq != tc::kBQ || bk != tc::kBK || stages != tc::kStages || dp != tc::pad_d(D) ||
        smem < 0 || (size_t)smem != tc::smem_bytes(dp) || (aligned && !tc::copies_aligned(p)))
      return (int)cudaErrorInvalidValue;
    return (int)tc::launch_dp(p, dp, aligned, (size_t)smem, s);
  }
  if (bq != flash::kBQ || bk != flash::kBK || stages != 1 || aligned ||
      dp != flash::fma_dp(D) || smem < 0 || (size_t)smem != flash::fma_smem(D))
    return (int)cudaErrorInvalidValue;
  return (int)(bf16 ? flash::launch_d<__nv_bfloat16>(p, s) : flash::launch_d<float>(p, s));
}
