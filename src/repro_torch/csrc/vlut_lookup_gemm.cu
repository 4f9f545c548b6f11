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
// What bounds it on this card. The memory floor is tiny: the packed
// weights (M*KG bytes) plus, for the integer kernel, the int8 activation
// (K*N) and the int32 output (4*M*N) -- 0.02 ms per 224-launch forward of
// smollm-360m at N = 4. The work is a gather from shared memory (one 8-byte
// table row per code, row and 4 tokens) and a table build of depth g = 5
// (3^g*g multiply-adds per K-group and token); both run on the CUDA cores.
// Tensor cores would waste most of their depth on a depth-5 contraction and
// cannot gather, so the kernel uses none (no wgmma or mma), and a block's
// tiles are small and irregular (a K-slice of codes, a few tokens), so TMA
// and clusters buy nothing here. At decode N the work is so small once it
// is spread over the card that launch latency and the split-K combine
// bound a launch.
//
// Design.
// - A host-side plan (`lut_plan` in kernels/vlut_lookup_gemm.py) picks, per
//   (M, KG, N, g), the rows per block BM (a multiple of 128), the K-splits S
//   and the K-groups per shared-memory chunk, so that M-tiles x token tiles
//   x S fills the 132 SMs (one to two waves). Block (x, y, z) owns rows
//   [x*BM, x*BM + BM), tokens [y*16, y*16 + 16) and K-groups
//   [split_bound(z), split_bound(z + 1)) (z*KG/S, on a multiple of 4 where
//   KG allows it; the plan's tests hold these ranges to an exact cover).
// - The table is built ONCE per block and K-chunk into dynamic shared
//   memory, only for the tile's valid tokens, and then all of the block's
//   BM rows gather from it. It is chunk x TL x 3^g x 4 tokens int16
//   (|T| <= 5*127 fits int16): one 8-byte row per (K-group, token lane,
//   pattern), so a warp's 32 random codes spread over 16 bank pairs. The
//   build is two-level, after the paper's topological precompute: one
//   thread per (K-group, token lane, pattern of trit digits 0-2) takes that
//   partial sum once, then adds the few terms of each of the 3^(g-3)
//   patterns of the high digits, whose signs are compile-time constants.
// - Thread geometry: 256 threads = (256 / TL) row lanes x TL token lanes,
//   BM*TL/256 rows per thread, 4 consecutive tokens per token lane; TL = 1,
//   2 or 4 follows the tile's valid tokens, so at decode N no lane idles.
// - Each thread owns rows r*(256/TL) + lane (at most 8) and 4 tokens for
//   the block's whole K-slice, so its int32 sums stay in registers while a
//   K-slice too long for shared memory is walked in chunks.
// - The codes sit in shared memory as 32-bit words of 4 K-groups per row,
//   copied a word at a time where the row and chunk are word-aligned; one
//   word serves 4 gathers of a row.
// - S > 1: every block adds its int32 partial sums into an int32 workspace
//   (N, M) with atomicAdd. Integer addition is associative, so the result
//   is the same bits in any order. A per-tile arrival counter picks the
//   last block (__threadfence, then an atomic on the counter); it reads the
//   sums, writes the scaled (N, M) output (fused) or the int32 (M, N)
//   output (integer), and returns its workspace entries and counter to 0,
//   so the next launch finds them clean. One launch per BitLinear, no
//   memset. The wrapper owns the zeroed workspace; S = 1 never touches it.
// - The integer kernel reads a_r[j, kg0:kg1, :] as one contiguous run per j
//   when its token tile covers all N (else a run of the tile's tokens per
//   (j, kg)), in aligned 16-byte vectors, all runs in one pass. The fused
//   kernel quantizes each token's K run (f32 cast first, IEEE division,
//   round half to even, clip +-127: this file must not be built with
//   --use_fast_math).
// No cp.async: staging the next chunk during the gather is left for later.
#include "mpgemm_common.cuh"

namespace vlut {

constexpr int kMaxRowsPerThread = 8;          // BM * token lanes <= 8 * 256
constexpr int kLutBMUnit = 128;               // BM is a multiple of this
constexpr int kCombineBatch = 8;              // combine loads in flight per thread
constexpr int kLowE = 27;                     // patterns of trit digits 0-2
constexpr size_t kMaxSmem = 232448 - 1024;    // 227 KB less the static part

__host__ __device__ constexpr int pow3(int g) { return g == 0 ? 1 : 3 * pow3(g - 1); }

// Token lanes of a tile with nv valid tokens: 4 tokens per lane.
__host__ __device__ inline int lut_tok_lanes(int nv) { return nv <= 4 ? 1 : (nv <= 8 ? 2 : 4); }

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

// First K-group of split z of S: z*KG/S, rounded down to a multiple of 4
// when KG allows it (KG % 4 == 0 and S <= KG/4), so that the codes of a
// chunk start on a 32-bit word. `LutPlan.kgroups` computes the same.
__host__ __device__ inline int split_bound(int z, int KG, int S) {
  const int b = (int)((long long)z * KG / S);
  return (KG % 4 == 0 && 4 * S <= KG) ? b & ~3 : b;
}

// Dynamic shared memory of one block: the table [chunk][TL][3^g][4] int16,
// the int8 activations [chunk*g][bnt] and the codes [chunk/4][bm] as 32-bit
// words of 4 K-groups (chunk rounded up to 4). The plan
// in kernels/vlut_lookup_gemm.py computes the same sizes.
struct LutLayout {
  size_t aq, codes, total;
};
__host__ __device__ inline LutLayout lut_layout(int g, int bm, int chunk, int bnt) {
  LutLayout l;
  l.aq = round16((size_t)chunk * pow3(g) * bnt * 2);
  l.codes = l.aq + round16((size_t)chunk * g * bnt);
  l.total = l.codes + round16((size_t)bm * ((chunk + 3) & ~3));
  return l;
}

struct LutParams {
  const uint8_t* packed;
  const void* a;          // x (N, K) float (fused) or a_r (g, KG, N) int8
  const float* a_scale;   // fused only
  const float* w_scale;   // fused only
  void* out;              // (N, M) float (fused) or (M, N) int32
  int32_t* ws;            // (N, M) int32 zeros, S > 1 only
  int* counters;          // (M-tiles * token tiles,) zeros, S > 1 only
  int M, KG, N, ws_stride;
  long long lda, ldo;
  int bm, splits, chunk;
};

// Fused prologue: quantize a[n0:n0+nv, k0:k0+kk] to int8, token-minor
// (aq[k * bnt + n]); tokens from nv to bnt read as 0.
template <typename TA>
__device__ __forceinline__ void quantize_slice(const TA* __restrict__ a, long long lda,
                                               int n0, int nv, int k0, int kk, int bnt,
                                               const float* s_scale, int8_t* aq) {
  for (int i = threadIdx.x; i < kk * bnt; i += blockDim.x) {
    const int n = i / kk, k = i - n * kk;      // k fastest: coalesced reads
    int8_t q = 0;
    if (n < nv) {
      const float v = to_f32(a[(long long)(n0 + n) * lda + k0 + k]);
      q = static_cast<int8_t>(fminf(fmaxf(rintf(v / s_scale[n]), -127.f), 127.f));
    }
    aq[k * bnt + n] = q;
  }
}

// put(r, i, byte i of run r) for `runs` runs of `len` bytes starting at
// src(r), read as aligned 16-byte vectors, one per thread and window. A
// window may hold bytes beside the run, never beyond its 16-byte-aligned
// block of the allocation.
template <typename Src, typename Put>
__device__ __forceinline__ void copy_runs(int runs, int len, Src src, Put put) {
  const int nwin = len / 16 + 2;                // windows a run can touch
  for (int u = threadIdx.x; u < runs * nwin; u += blockDim.x) {
    const int r = u / nwin, w = u - r * nwin;
    const int8_t* s = src(r);
    const int off = (int)((uintptr_t)s & 15);
    const int lo = max(0, 16 * w - off), hi = min(len, 16 * w + 16 - off);
    if (lo >= hi) continue;
    const int4 v = *reinterpret_cast<const int4*>(s - off + 16 * w);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int i = 16 * w - off + t;
      if (i >= lo && i < hi) put(r, i, b[t]);
    }
  }
}

// Integer prologue: a_r[:, kg0:kg0+nkg, n0:n0+nv] into the same layout,
// aq[(kg*G + j) * bnt + n]; tokens from nv to bnt read as 0.
template <int G>
__device__ __forceinline__ void load_int8_slice(const int8_t* __restrict__ a_r, int KG, int N,
                                                int n0, int nv, int kg0, int nkg, int bnt,
                                                int8_t* aq) {
  if (nv == N) {
    // the tile covers every token: a_r[j, kg0:kg0+nkg, :] is one run of
    // nkg*N bytes per j
    copy_runs(
        G, nkg * N, [&](int j) { return a_r + ((long long)j * KG + kg0) * N; },
        [&](int j, int i, int8_t q) {
          const int kg = i / N;
          aq[(kg * G + j) * bnt + i - kg * N] = q;
        });
  } else {
    // one run of nv tokens per (kg, j)
    copy_runs(
        nkg * G, nv,
        [&](int k) {
          const int kg = k / G;
          return a_r + ((long long)(k - kg * G) * KG + kg0 + kg) * N + n0;
        },
        [&](int k, int i, int8_t q) { aq[k * bnt + i] = q; });
  }
  if (bnt > nv) {
    const int pad = bnt - nv;
    for (int i = threadIdx.x; i < nkg * G * pad; i += blockDim.x) {
      const int k = i / pad;
      aq[k * bnt + nv + i - k * pad] = 0;
    }
  }
}

// TA = int8_t: the integer kernel (a is a_r, out is int32 (M, N)); TA =
// float or bf16: the fused kernel (out is TO (N, M)).
template <int G, typename TA, typename TO>
__global__ void __launch_bounds__(kThreads) vlut_kernel(const LutParams p) {
  constexpr bool kInt = std::is_same<TA, int8_t>::value;
  constexpr int E = pow3(G);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_scale[kBN];
  __shared__ int s_last;

  const int m0 = blockIdx.x * p.bm, n0 = blockIdx.y * kBN;
  const int bmv = min(p.bm, p.M - m0);          // valid rows
  const int nv = min(kBN, p.N - n0);            // valid tokens
  const int tok_lanes = lut_tok_lanes(nv);
  const int lane_shift = tok_lanes == 1 ? 0 : (tok_lanes == 2 ? 1 : 2);
  const int bnt = 4 * tok_lanes;                // table row: tokens
  const int row_lanes = kThreads / tok_lanes;
  const int rpt = (bmv + row_lanes - 1) / row_lanes;   // rows per thread
  const int tl = threadIdx.x / row_lanes, rl = threadIdx.x % row_lanes;
  const int kg_lo = split_bound(blockIdx.z, p.KG, p.splits);
  const int kg_hi = split_bound(blockIdx.z + 1, p.KG, p.splits);
  const LutLayout lay = lut_layout(G, p.bm, p.chunk, bnt);
  int16_t* lut = reinterpret_cast<int16_t*>(smem);
  int8_t* aq = reinterpret_cast<int8_t*>(smem + lay.aq);
  uint32_t* codes = reinterpret_cast<uint32_t*>(smem + lay.codes);

  if constexpr (!kInt) load_token_scales(p.a_scale, p.N, n0, s_scale);
  // each thread owns rows r*row_lanes + rl and 4 tokens for the whole
  // K-slice: its sums stay in registers across chunks
  int acc[kMaxRowsPerThread][kTokPerThread] = {};

  for (int c0 = kg_lo; c0 < kg_hi; c0 += p.chunk) {
    const int nkc = min(p.chunk, kg_hi - c0);
    __syncthreads();                            // the last chunk's gather is done
    // codes of 4 K-groups per word: codes[kg/4][row] holds K-groups
    // 4*(kg/4)..+3 of the row, byte kg % 4
    if ((p.KG & 3) == 0 && (c0 & 3) == 0 && ((uintptr_t)p.packed & 3) == 0) {
      // word copies: a word never crosses the end of the row
      const int words = (nkc + 3) >> 2;
      for (int i = threadIdx.x; i < bmv * words; i += blockDim.x) {
        const int r = i / words, w = i - r * words;
        codes[w * p.bm + r] = *reinterpret_cast<const uint32_t*>(
            p.packed + (long long)(m0 + r) * p.KG + c0 + 4 * w);
      }
    } else {
      uint8_t* cb = reinterpret_cast<uint8_t*>(codes);
      for (int i = threadIdx.x; i < bmv * nkc; i += blockDim.x) {
        const int r = i / nkc, kg = i - r * nkc;
        cb[((kg >> 2) * p.bm + r) * 4 + (kg & 3)] = p.packed[(long long)(m0 + r) * p.KG + c0 + kg];
      }
    }
    if constexpr (kInt) {
      load_int8_slice<G>(static_cast<const int8_t*>(p.a), p.KG, p.N, n0, nv, c0, nkc, bnt, aq);
    } else {
      quantize_slice(static_cast<const TA*>(p.a), p.lda, n0, nv, c0 * G, nkc * G, bnt, s_scale, aq);
    }
    __syncthreads();
    // table build: T[kg][q][e][t] = sum_j (trit_j(e) - 1) * aq[kg*G + j][4q + t]
    // for token lane q. One item per (kg, q, low pattern el of digits 0-2):
    // the low partial sum once, then each high pattern eh (digits 3..G-1,
    // compile-time signs) adds its few terms: e = el + 27 * eh. el fastest
    // across threads: the aq reads broadcast, the 8-byte stores are
    // consecutive.
    for (int i = threadIdx.x; i < nkc * tok_lanes * kLowE; i += blockDim.x) {
      const int el = i % kLowE, kq = i / kLowE;
      const int q = kq & (tok_lanes - 1), kg = kq >> lane_shift;
      const int8_t* col = aq + kg * G * bnt + q * kTokPerThread;
      char4 x[G];
#pragma unroll
      for (int j = 0; j < G; ++j) x[j] = *reinterpret_cast<const char4*>(col + j * bnt);
      const int s0 = el % 3 - 1, s1 = el / 3 % 3 - 1, s2 = el / 9 - 1;
      const int l0 = s0 * x[0].x + s1 * x[1].x + s2 * x[2].x;
      const int l1 = s0 * x[0].y + s1 * x[1].y + s2 * x[2].y;
      const int l2 = s0 * x[0].z + s1 * x[1].z + s2 * x[2].z;
      const int l3 = s0 * x[0].w + s1 * x[1].w + s2 * x[2].w;
      short4* row = reinterpret_cast<short4*>(lut) + kq * E + el;
#pragma unroll
      for (int eh = 0; eh < E / kLowE; ++eh) {
        int v0 = l0, v1 = l1, v2 = l2, v3 = l3;
#pragma unroll
        for (int j = 3; j < G; ++j) {
          const int d = eh / pow3(j - 3) % 3 - 1;
          v0 += d * x[j].x;
          v1 += d * x[j].y;
          v2 += d * x[j].z;
          v3 += d * x[j].w;
        }
        row[kLowE * eh] = make_short4((short)v0, (short)v1, (short)v2, (short)v3);
      }
    }
    __syncthreads();
    // gather: all of the block's rows sweep the chunk's table. A table row
    // of one token lane is 8 bytes, so a warp's random codes spread over 16
    // bank pairs; one word of codes serves 4 K-groups of a row
    for (int kq = 0; kq < nkc; kq += 4) {
      uint32_t cw[kMaxRowsPerThread];
#pragma unroll
      for (int r = 0; r < kMaxRowsPerThread; ++r) {
        if (r < rpt) cw[r] = codes[(kq >> 2) * p.bm + min(r * row_lanes + rl, bmv - 1)];
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (kq + b >= nkc) break;
        const int16_t* lk = lut + ((kq + b) * tok_lanes + tl) * E * kTokPerThread;
#pragma unroll
        for (int r = 0; r < kMaxRowsPerThread; ++r) {
          if (r < rpt) {
            const int c = (cw[r] >> (8 * b)) & 0xff;
            const short4 t = *reinterpret_cast<const short4*>(lk + c * kTokPerThread);
            acc[r][0] += t.x;
            acc[r][1] += t.y;
            acc[r][2] += t.z;
            acc[r][3] += t.w;
          }
        }
      }
    }
  }

  // the sums: straight to the output (S = 1) or added into the workspace
#pragma unroll
  for (int r = 0; r < kMaxRowsPerThread; ++r) {
    const int row = r * row_lanes + rl;
    if (r >= rpt || row >= bmv) continue;
    const int m = m0 + row;
#pragma unroll
    for (int t = 0; t < kTokPerThread; ++t) {
      const int nl = tl * kTokPerThread + t;
      if (nl >= nv) break;
      if (p.splits > 1) {
        atomicAdd(p.ws + (long long)(n0 + nl) * p.M + m, acc[r][t]);
      } else if constexpr (kInt) {
        static_cast<int32_t*>(p.out)[(long long)m * p.N + n0 + nl] = acc[r][t];
      } else {
        store(static_cast<TO*>(p.out) + (long long)(n0 + nl) * p.ldo + m,
              (static_cast<float>(acc[r][t]) * p.w_scale[(long long)m * p.ws_stride]) * s_scale[nl]);
      }
    }
  }
  if (p.splits == 1) return;

  // split-K combine: the last block of this output tile to arrive writes it
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) s_last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // item i -> (token nl, row ml). Fused: rows fastest, so the workspace
  // reads and the (N, M) stores are both coalesced. Integer: runs of 8 rows
  // per token, tokens next, so the (N, M) reads and the (M, N) stores each
  // touch a few sectors per warp.
  const int total = kInt ? ((bmv + 7) & ~7) * nv : bmv * nv;
  auto locate = [&](int i, int& nl, int& ml) {
    if constexpr (kInt) {
      const int rest = i >> 3;
      nl = rest % nv;
      ml = (rest / nv) * 8 + (i & 7);
    } else {
      nl = i / bmv;
      ml = i - nl * bmv;
    }
    return i < total && ml < bmv;
  };
  for (int i0 = 0; i0 < total; i0 += kCombineBatch * kThreads) {
    int v[kCombineBatch];                       // all loads in flight first
#pragma unroll
    for (int b = 0; b < kCombineBatch; ++b) {
      int nl, ml;
      if (locate(i0 + b * kThreads + threadIdx.x, nl, ml)) {
        v[b] = __ldcg(p.ws + (long long)(n0 + nl) * p.M + m0 + ml);
      }
    }
#pragma unroll
    for (int b = 0; b < kCombineBatch; ++b) {
      int nl, ml;
      if (!locate(i0 + b * kThreads + threadIdx.x, nl, ml)) continue;
      const int m = m0 + ml;
      p.ws[(long long)(n0 + nl) * p.M + m] = 0;
      if constexpr (kInt) {
        static_cast<int32_t*>(p.out)[(long long)m * p.N + n0 + nl] = v[b];
      } else {
        store(static_cast<TO*>(p.out) + (long long)(n0 + nl) * p.ldo + m,
              (static_cast<float>(v[b]) * p.w_scale[(long long)m * p.ws_stride]) * s_scale[nl]);
      }
    }
  }
  if (threadIdx.x == 0) p.counters[tile] = 0;
}

// The plan's checks: the C entry refuses a plan whose shared memory it
// would size differently, so the host plan and the kernel cannot drift.
inline bool plan_ok(int M, int KG, int N, int g, int bm, int splits, int chunk,
                    long long smem, const void* ws, const void* counters) {
  if (M <= 0 || N <= 0 || KG <= 0 || (g != 4 && g != 5)) return false;
  if (bm <= 0 || bm % kLutBMUnit || splits < 1 || splits > KG || splits > 65535 || chunk < 1) return false;
  if ((N + kBN - 1) / kBN > 65535) return false;
  if (splits > 1 && (ws == nullptr || counters == nullptr)) return false;
  const int bnt = 4 * lut_tok_lanes(N < kBN ? N : kBN);
  if (bm * bnt > kMaxRowsPerThread * kThreads * 4) return false;
  const size_t want = lut_layout(g, bm, chunk, bnt).total;
  return smem >= 0 && (size_t)smem == want && want <= kMaxSmem;
}

template <int G, typename TA, typename TO>
cudaError_t launch_lut(const LutParams& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(vlut_kernel<G, TA, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.M + p.bm - 1) / p.bm, (p.N + kBN - 1) / kBN, p.splits);
  vlut_kernel<G, TA, TO><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_lut_types(const LutParams& p, size_t smem, int a_bf16, int out_bf16,
                             cudaStream_t stream) {
  if (a_bf16) {
    return out_bf16 ? launch_lut<G, __nv_bfloat16, __nv_bfloat16>(p, smem, stream)
                    : launch_lut<G, __nv_bfloat16, float>(p, smem, stream);
  }
  return out_bf16 ? launch_lut<G, float, __nv_bfloat16>(p, smem, stream)
                  : launch_lut<G, float, float>(p, smem, stream);
}

}  // namespace vlut

// The C entries of the vector-LUT kernels. Beside the mpGeMM contracts of
// mpgemm_common.cuh they take the launch plan (rows per block bm, K-splits,
// K-groups per chunk, dynamic shared bytes) and, for splits > 1, a zeroed
// int32 workspace of at least N*M entries and zeroed counters, one per
// (M-tile, token tile), both left zeroed again. Each launches on `stream`
// and returns a cudaError_t (cudaErrorInvalidValue for a plan it refuses).
#define VLUT_LUT_ENTRY_ARGS                                                        \
  const void *packed, const void *a, const void *a_scale, const void *w_scale,     \
      void *out, void *ws, void *counters, int M, int KG, int N, int g,            \
      long long lda, long long ldo, int ws_stride, int a_bf16, int out_bf16,       \
      int bm, int splits, int chunk, long long smem, void *stream
#define VLUT_LUT_INT_ENTRY_ARGS                                                    \
  const void *packed, const void *a_r, void *out, void *ws, void *counters,       \
      int M, int KG, int N, int g, int bm, int splits, int chunk, long long smem,  \
      void *stream

extern "C" int vlut_lookup_gemm_fused(VLUT_LUT_ENTRY_ARGS) {
  if (!vlut::plan_ok(M, KG, N, g, bm, splits, chunk, smem, ws, counters))
    return (int)cudaErrorInvalidValue;
  const vlut::LutParams p{(const uint8_t*)packed, a, (const float*)a_scale,
                          (const float*)w_scale, out, (int32_t*)ws, (int*)counters,
                          M, KG, N, ws_stride, lda, ldo, bm, splits, chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::launch_lut_types<5>(p, (size_t)smem, a_bf16, out_bf16, s)
                      : vlut::launch_lut_types<4>(p, (size_t)smem, a_bf16, out_bf16, s));
}

extern "C" int vlut_lookup_gemm(VLUT_LUT_INT_ENTRY_ARGS) {
  if (!vlut::plan_ok(M, KG, N, g, bm, splits, chunk, smem, ws, counters))
    return (int)cudaErrorInvalidValue;
  const vlut::LutParams p{(const uint8_t*)packed, a_r, nullptr, nullptr, out, (int32_t*)ws,
                          (int*)counters, M, KG, N, 0, 0, N, bm, splits, chunk};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::launch_lut<5, int8_t, int32_t>(p, (size_t)smem, s)
                      : vlut::launch_lut<4, int8_t, int32_t>(p, (size_t)smem, s));
}
