// Ternary-decode mpGeMM for Hopper (sm_90a): the fused kernel and its
// integer twin, one template, on the int8 tensor cores.
//
// Replaces two TPU kernels of src/repro/kernels/ternary_decode_gemm.py:
// - `ternary_decode_gemm_fused` (`_decode_gemm_fused_kernel` and its core
//   `_decode_block_int`): quantize the activations per token, decode each
//   packed code into g trits (c // 3^j) % 3 - 1, take one int8 matrix
//   product per trit (trit_j(W) . A_r[j] on the MXU) summed in int32 over
//   all of K, then apply w_scale * a_scale;
// - `ternary_decode_gemm` (`_decode_gemm_kernel`, the same core): the
//   unfused pipeline's middle pass, pre-quantized de-interleaved int8 a_r
//   (g, KG, N) in, the raw int32 (M, N) sums out.
//
// What bounds it on this card.
// - Decode N (1..16 tokens): a GEMV over packed weights. The floor is the
//   bytes at 3.35 TB/s (M*KG packed codes, plus the int8 activation and
//   the int32 output for the integer kernel), ~0.1 us per BitLinear of
//   smollm-360m, far below a launch's own latency (a few us). So what
//   bounds a launch is latency: how many SMs get work and how long one
//   block's chain of loads, barriers and the split-K combine takes.
// - Prefill N (64..256+): the int8 operations, 2*M*N*K, which only the
//   tensor cores run at their rate (1,979 TOPS dense).
//
// Design.
// - A host plan (`decode_plan` in kernels/ternary_decode_gemm.py) picks,
//   per (M, KG, N, g), the block tile (64 rows x 16 tokens with 4 warps at
//   decode N; 128 x 16 with 8 warps at prefill N, so that each quantized
//   activation tile feeds twice the rows), the K-splits S and the K-groups
//   per step (32 or 64). Where the tiles alone fill less than one wave of
//   132 SMs it splits K so that the grid fills one to two waves (at decode
//   N: every smollm-360m shape). Block (x, y, z) owns rows [x*BM, +BM),
//   tokens [y*BN, +BN) and K-groups [split_bound(z), split_bound(z + 1)).
// - The inner product is `mma.sync.m16n8k32` s8 x s8 -> s32, one product
//   per trit, as the TPU kernel's `_decode_block_int`: with A_j[m][kg] =
//   trit j of W[m, kg] and B_j[kg][n] = the activation of feature kg*g + j,
//   acc += sum_j A_j . B_j, K-groups as the k32 dimension, g products per
//   32-K-group step (nothing padded from 5 to 8). Warp w owns rows
//   [16w, 16w + 16) of the block and both n8 tiles; an n8 tile without a
//   valid token is skipped, and at N <= 4 half of the one left is empty.
// - Codes go from device memory straight into registers as 32-bit words
//   of 4 K-groups: a thread's A fragment of one trit is 4 K-groups of one
//   row. The k positions are permuted alike in A and B (the sum is
//   order-free): mma k = 4t + i is K-group 8t + i, k = 16 + 4t + i is
//   K-group 8t + 4 + i, so a thread reads two adjacent code words per row
//   and one 8-byte B word per n8 tile. A word is decoded by a 256-entry
//   table in shared memory (trits 0-3 of a code as int8 bytes) and a 4x4
//   byte transpose with __byte_perm (4 table loads, 8 permutes), trit 4 of
//   g = 5 by three byte-wise comparisons. Each code is decoded once and
//   used for both n8 tiles.
// - The activations sit in shared memory as [j][n][kg] int8 (row stride
//   `decode_row_bytes`, chosen so that a half-warp's 8-byte B loads hit 16
//   distinct bank pairs). The fused kernel quantizes x's valid tokens of
//   the step's K-slice into it (f32 cast first, IEEE division, round half
//   to even, clip +-127: this file must not be built with
//   --use_fast_math), one word per trit; the integer kernel transposes
//   a_r[j][kg][n] into it (4x4 byte blocks with __byte_perm where
//   aligned). B past the K-slice and past N is 0, so any code there
//   multiplies into 0; rows past M are never written. Nothing is padded
//   in device memory.
// - The next step's codes and (where aligned) raw activations are loaded
//   into registers before the current step's products, so their latency
//   overlaps them; one barrier pair per step.
// - Alignment: word loads of codes and 16-byte (f32) / 8-byte (bf16) /
//   word (a_r) loads of activations only where the plan's predicate says
//   every base pointer and row stride allows them (the C entry checks the
//   claim again); else byte and element loads.
// - S > 1: exact split-K in the same launch. Every block atomicAdds its
//   int32 partials into a zeroed int32 workspace laid out as the output
//   ((N, M) fused, (M, N) integer); a per-tile arrival counter picks the
//   last block, which writes the output and returns its workspace entries
//   and its counter to 0. One launch per BitLinear, no memset.
// - Sums are exact in int32 (|sum| <= 127*K). wgmma, TMA and cp.async
//   staging are left for later work.
#include "mpgemm_common.cuh"

namespace vlut {
namespace decode {

constexpr int kSub = 32;            // K-groups per mma (k32)
constexpr int kMaxStep = 64;        // K-groups per step, at most
constexpr int kTableSize = 256;     // every byte value: codes past 3^g too
constexpr int kCombineBatch = 8;    // combine loads in flight per thread
// The block tiles (BM, BN) the kernel has: rows BM = 16 per warp, tokens
// BN = 8 per n8 tile
constexpr int kTiles[][2] = {{64, 16}, {128, 16}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);
constexpr size_t kMaxSmem = 48 * 1024;

// Shared row of one (trit, token): the step's K-groups, padded so that
// the 8-byte B loads of a half-warp (tokens 0-3 x t 0-3) fall on 16
// distinct bank pairs: the row is 8 or 24 words modulo 32.
__host__ __device__ constexpr int decode_row_bytes(int kstep) {
  return kstep % 64 == 0 ? kstep + 32 : kstep;
}

__host__ __device__ constexpr size_t decode_smem_bytes(int g, int bn, int kstep) {
  return (size_t)g * bn * decode_row_bytes(kstep);
}

// First K-group of split z of S: z*KG/S rounded down to a multiple of 32
// where 32*S <= KG, else of 4 where KG % 4 == 0 and 4*S <= KG (so that
// word loads of codes stay aligned); split S ends at KG. `DecodePlan.kgroups`
// computes the same.
__host__ __device__ inline int split_bound(int z, int KG, int S) {
  if (z >= S) return KG;
  const int b = (int)((long long)z * KG / S);
  const int a = 32 * S <= KG ? 32 : ((KG % 4 == 0 && 4 * S <= KG) ? 4 : 1);
  return b - b % a;
}

struct Params {
  const uint8_t* packed;
  const void* a;          // x (N, K) float (fused) or a_r (g, KG, N) int8
  const float* a_scale;   // fused only
  const float* w_scale;   // fused only
  void* out;              // (N, M) float (fused) or (M, N) int32
  int32_t* ws;            // zeros laid out as out, S > 1 only
  int* counters;          // (M-tiles * token tiles,) zeros, S > 1 only
  int M, KG, N, ws_stride;
  long long lda, ldo;
  int splits, kstep, codes_aligned, acts_aligned;
};

__device__ __forceinline__ uint32_t prmt(uint32_t x, uint32_t y, uint32_t s) {
  return __byte_perm(x, y, s);
}

// 4x4 byte transpose: out[c] byte i = byte c of e[i].
__device__ __forceinline__ void transpose4(const uint32_t e[4], uint32_t out[4]) {
  const uint32_t t0 = prmt(e[0], e[1], 0x5140), t1 = prmt(e[0], e[1], 0x7362);
  const uint32_t t2 = prmt(e[2], e[3], 0x5140), t3 = prmt(e[2], e[3], 0x7362);
  out[0] = prmt(t0, t2, 0x5410);
  out[1] = prmt(t0, t2, 0x7632);
  out[2] = prmt(t1, t3, 0x5410);
  out[3] = prmt(t1, t3, 0x7632);
}

// The trit table: entry c holds trits 0-3 of code c, (c / 3^j) % 3 - 1,
// as int8 bytes 0-3 (all 256 codes, so any byte decodes as the plain
// version decodes it).
struct TritTable {
  uint32_t lo[kTableSize];
};

__device__ __forceinline__ void build_table(TritTable& t) {
  for (int c = threadIdx.x; c < kTableSize; c += blockDim.x) {
    uint32_t word = 0;
    int r = c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      word |= (uint32_t)(uint8_t)(int8_t)(r % 3 - 1) << (8 * j);
      r /= 3;
    }
    t.lo[c] = word;
  }
}

// A word of 4 codes (byte i = K-group i) -> G words, word j = the 4 codes'
// trit j as int8 bytes (byte i = K-group i): one A register per trit.
// Trits 0-3 come from the table and a 4x4 byte transpose; trit 4 (g = 5)
// from byte-wise comparisons: (c / 81) % 3 - 1 = -1 - [c >= 81] -
// [c >= 162] + 2 [c >= 243], each [.] a 0 / -1 byte of __vcmpgeu4.
template <int G>
__device__ __forceinline__ void decode_word(const TritTable& t, uint32_t w, uint32_t a[G]) {
  uint32_t lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lo[i] = t.lo[(w >> (8 * i)) & 0xff];
  uint32_t tr[4];
  transpose4(lo, tr);
#pragma unroll
  for (int j = 0; j < 4 && j < G; ++j) a[j] = tr[j];
  if constexpr (G == 5) {
    const uint32_t ge81 = __vcmpgeu4(w, 0x51515151u), ge162 = __vcmpgeu4(w, 0xa2a2a2a2u);
    const uint32_t ge243 = __vcmpgeu4(w, 0xf3f3f3f3u);
    a[4] = __vadd4(__vsub4(__vsub4(0xffffffffu, ge81), ge162), __vadd4(ge243, ge243));
  }
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 4 K-groups kg..kg+3 of row m as one word, byte i = K-group kg + i;
// 0 past M or KG (B is 0 there, so any code would do).
__device__ __forceinline__ uint32_t load_codes(const Params& p, int m, int kg) {
  if (m >= p.M || kg >= p.KG) return 0;
  const uint8_t* row = p.packed + (long long)m * p.KG;
  if (p.codes_aligned) return *reinterpret_cast<const uint32_t*>(row + kg);
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (kg + i < p.KG) w |= (uint32_t)row[kg + i] << (8 * i);
  }
  return w;
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

// The raw form of 4 consecutive activations as the prologue fetches them:
// 16 bytes of f32, 8 of bf16; for a_r, one word of 4 tokens.
template <typename TA> struct Raw4 { using T = float4; };
template <> struct Raw4<__nv_bfloat16> { using T = uint2; };
template <> struct Raw4<int8_t> { using T = uint32_t; };

__device__ __forceinline__ float4 to_f32x4(float4 v) { return v; }
__device__ __forceinline__ float4 to_f32x4(uint2 u) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi));
}

// One step of a block's K-slice: K-groups [kg0, kg0 + nk), nsub k32
// sub-steps (the staged width is nsub * 32 K-groups).
struct Step {
  int kg0, nk, nsub;
};

// The prologue: the step's activations into aq[j][n][kg] (feature kg*G + j
// of token n), for tokens [0, ntok) and K-groups [0, nsub*32); 0 outside
// the valid tokens and the step's K-groups.
// - Fused: one item per (token, 4 K-groups): its 4G features quantized
//   (f32 cast first, IEEE division, round half to even, clip +-127) and
//   stored as one word per trit.
// - Integer: one item per (trit, 4 K-groups, 4 tokens): 4 words of a_r
//   transposed with __byte_perm into 4 words of aq.
// Where the activations are aligned, `fetch` loads a step's items into
// registers a step ahead (its latency hides behind the current step's
// products) and `put` quantizes or transposes them into shared memory;
// elsewhere `put` loads element by element.
template <int G, int NW, int NT, typename TA>
struct Stager {
  static constexpr bool kInt = std::is_same<TA, int8_t>::value;
  static constexpr int kThreads = 32 * NW, BN = 8 * NT, kQuads = kMaxStep / 4;
  static constexpr int kItems = kInt ? G * kQuads * (BN / 4) : BN * kQuads;
  static constexpr int kPerThread = (kItems + kThreads - 1) / kThreads;
  static constexpr int kRaw = kInt ? 4 : G;
  typename Raw4<TA>::T raw[kPerThread][kRaw];

  // item i of a step -> (trit j, token n, K-group quad k4); ntok tokens
  __device__ __forceinline__ static int items(int ntok, const Step& st) {
    return (kInt ? G * (ntok / 4) : ntok) * st.nsub * (kSub / 4);
  }
  __device__ __forceinline__ static void locate(int i, int ntok, const Step& st, int& j, int& n,
                                                int& k4) {
    const int quads = st.nsub * (kSub / 4);
    if constexpr (kInt) {
      const int nq = ntok / 4, rest = i / nq;
      n = 4 * (i - rest * nq);
      k4 = rest % quads;
      j = rest / quads;
    } else {
      n = i / quads;
      k4 = i - n * quads;
      j = 0;
    }
  }

  __device__ __forceinline__ void fetch(const Params& p, int n0, int nv, int ntok, const Step& st) {
    if (!p.acts_aligned) return;
    const int total = items(ntok, st);
#pragma unroll
    for (int it = 0; it < kPerThread; ++it) {
      const int i = threadIdx.x + it * kThreads;
      int j, n, k4;
      locate(i, ntok, st, j, n, k4);
      if (i >= total || n >= nv || 4 * k4 >= st.nk) continue;
      if constexpr (kInt) {
        const int8_t* src = static_cast<const int8_t*>(p.a) +
                            ((long long)j * p.KG + st.kg0 + 4 * k4) * p.N + n0 + n;
#pragma unroll
        for (int r = 0; r < 4; ++r) raw[it][r] = *reinterpret_cast<const uint32_t*>(src + (long long)r * p.N);
      } else {
        const TA* src = static_cast<const TA*>(p.a) + (long long)(n0 + n) * p.lda +
                        (long long)(st.kg0 + 4 * k4) * G;
#pragma unroll
        for (int v = 0; v < G; ++v) raw[it][v] = *reinterpret_cast<const typename Raw4<TA>::T*>(src + 4 * v);
      }
    }
  }

  __device__ __forceinline__ void put(const Params& p, int n0, int nv, int ntok, const Step& st,
                                      int rs, const float* s_scale, int8_t* aq) const {
    if constexpr (kInt) {
      if (!p.acts_aligned) {                // bytes, tokens fastest
        const int8_t* a_r = static_cast<const int8_t*>(p.a);
        const int width = st.nsub * kSub;
        for (int i = threadIdx.x; i < G * width * ntok; i += blockDim.x) {
          const int n = i % ntok, rest = i / ntok;
          const int kg = rest % width, j = rest / width;
          int8_t q = 0;
          if (n < nv && kg < st.nk) q = a_r[((long long)j * p.KG + st.kg0 + kg) * p.N + n0 + n];
          aq[(j * BN + n) * rs + kg] = q;
        }
        return;
      }
    }
    const int total = items(ntok, st);
#pragma unroll
    for (int it = 0; it < kPerThread; ++it) {
      const int i = threadIdx.x + it * kThreads;
      if (i >= total) continue;
      int j, n, k4;
      locate(i, ntok, st, j, n, k4);
      const bool valid = n < nv && 4 * k4 < st.nk;
      if constexpr (kInt) {                 // aligned: N % 4 == 0, nk % 4 == 0
        uint32_t rows[4], cols[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) rows[r] = valid ? raw[it][r] : 0;
        transpose4(rows, cols);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          *reinterpret_cast<uint32_t*>(aq + (j * BN + n + c) * rs + 4 * k4) = cols[c];
        }
      } else {
        uint32_t w[G] = {};
        if (valid) {
          const float s = s_scale[n];
          if (p.acts_aligned) {             // nk % 4 == 0: the 4 K-groups are valid
#pragma unroll
            for (int v = 0; v < G; ++v) {
              const float4 f = to_f32x4(raw[it][v]);
              const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int kk = 4 * v + e;
                w[kk % G] |= (uint32_t)(uint8_t)quantize(fs[e], s) << (8 * (kk / G));
              }
            }
          } else {
            const TA* src = static_cast<const TA*>(p.a) + (long long)(n0 + n) * p.lda +
                            (long long)(st.kg0 + 4 * k4) * G;
#pragma unroll
            for (int kk = 0; kk < 4 * G; ++kk) {
              if (4 * k4 + kk / G < st.nk) {
                w[kk % G] |= (uint32_t)(uint8_t)quantize(to_f32(src[kk]), s) << (8 * (kk / G));
              }
            }
          }
        }
#pragma unroll
        for (int t = 0; t < G; ++t) *reinterpret_cast<uint32_t*>(aq + (t * BN + n) * rs + 4 * k4) = w[t];
      }
    }
  }
};

// TA = int8_t: the integer kernel (a is a_r, out is int32 (M, N)); TA =
// float or bf16: the fused kernel (out is TO (N, M)). NW warps of one m16
// tile each, NT n8 tiles per block.
template <int G, int NW, int NT, typename TA, typename TO>
__global__ void __launch_bounds__(32 * NW) decode_kernel(const Params p) {
  constexpr bool kInt = std::is_same<TA, int8_t>::value;
  constexpr int kThreads = 32 * NW, BM = 16 * NW, BN = 8 * NT;
  extern __shared__ __align__(16) int8_t aq[];
  __shared__ TritTable table;
  __shared__ float s_scale[BN];
  __shared__ int s_last;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int bmv = min(BM, p.M - m0), nv = min(BN, p.N - n0);
  const int nact = (nv + 7) / 8;                // n8 tiles with a valid token
  const int kg_lo = split_bound(blockIdx.z, p.KG, p.splits);
  const int kg_hi = split_bound(blockIdx.z + 1, p.KG, p.splits);
  const int rs = decode_row_bytes(p.kstep);

  build_table(table);
  if constexpr (!kInt) {
    for (int n = threadIdx.x; n < nv; n += blockDim.x) s_scale[n] = p.a_scale[n0 + n];
  }
  int acc[NT][4] = {};

  // codes of a step: rows gid and gid + 8 of the warp's m16 tile, K-groups
  // 8t..8t+3 and 8t+4..8t+7 of each k32 sub-step
  const int r0 = m0 + warp * 16 + gid;
  auto fetch_codes = [&](const Step& st, uint32_t (&cw)[kMaxStep / kSub][4]) {
#pragma unroll
    for (int s = 0; s < kMaxStep / kSub; ++s) {
      const int k = st.kg0 + s * kSub + 8 * tq;
      const bool live = s < st.nsub;
      cw[s][0] = live ? load_codes(p, r0, k) : 0;
      cw[s][1] = live ? load_codes(p, r0 + 8, k) : 0;
      cw[s][2] = live ? load_codes(p, r0, k + 4) : 0;
      cw[s][3] = live ? load_codes(p, r0 + 8, k + 4) : 0;
    }
  };
  auto step_at = [&](int kg0) {
    const int nk = min(p.kstep, kg_hi - kg0);
    return Step{kg0, nk, (nk + kSub - 1) / kSub};
  };

  // a step's codes and activations are fetched while the previous step's
  // products run
  Step st = step_at(kg_lo);
  uint32_t cw[kMaxStep / kSub][4];
  Stager<G, NW, NT, TA> stager;
  fetch_codes(st, cw);
  stager.fetch(p, n0, nv, 8 * nact, st);
  for (;;) {
    __syncthreads();                            // the last step's B reads are done
    stager.put(p, n0, nv, 8 * nact, st, rs, s_scale, aq);
    __syncthreads();
    uint32_t cur[kMaxStep / kSub][4];
#pragma unroll
    for (int s = 0; s < kMaxStep / kSub; ++s) {
#pragma unroll
      for (int r = 0; r < 4; ++r) cur[s][r] = cw[s][r];
    }
    const int nsub = st.nsub;
    const bool more = st.kg0 + p.kstep < kg_hi;
    if (more) {
      st = step_at(st.kg0 + p.kstep);
      fetch_codes(st, cw);
      stager.fetch(p, n0, nv, 8 * nact, st);
    }
#pragma unroll
    for (int s = 0; s < kMaxStep / kSub; ++s) {
      if (s >= nsub) break;
      // A registers: a[j] = {row gid lo, row gid+8 lo, row gid hi, row gid+8 hi}
      uint32_t a[G][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t tr[G];
        decode_word<G>(table, cur[s][r], tr);
#pragma unroll
        for (int j = 0; j < G; ++j) a[j][r] = tr[j];
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt >= nact) break;
          const uint2 b = *reinterpret_cast<const uint2*>(
              aq + (j * BN + nt * 8 + gid) * rs + s * kSub + 8 * tq);
          mma_s8(acc[nt], a[j], b.x, b.y);
        }
      }
    }
    if (!more) break;
  }

  // the sums: straight to the output (S = 1) or added into the workspace.
  // Accumulator c of n8 tile nt: row gid + 8*(c/2), token 2t + c%2.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ml = warp * 16 + gid + 8 * (c / 2);
      const int nl = nt * 8 + 2 * tq + c % 2;
      if (ml >= bmv || nl >= nv) continue;
      const int m = m0 + ml, n = n0 + nl;
      const int v = acc[nt][c];
      if (p.splits > 1) {
        atomicAdd(p.ws + (kInt ? (long long)m * p.N + n : (long long)n * p.M + m), v);
      } else if constexpr (kInt) {
        static_cast<int32_t*>(p.out)[(long long)m * p.N + n] = v;
      } else {
        store(static_cast<TO*>(p.out) + (long long)n * p.ldo + m,
              (static_cast<float>(v) * p.w_scale[(long long)m * p.ws_stride]) * s_scale[nl]);
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
  // item i -> (row ml, token nl), the output's fast axis fastest: rows for
  // (N, M), tokens for (M, N); the workspace has the output's layout
  const int total = bmv * nv;
  for (int i0 = 0; i0 < total; i0 += kCombineBatch * kThreads) {
    int v[kCombineBatch];                       // all loads in flight first
    long long idx[kCombineBatch];
#pragma unroll
    for (int b = 0; b < kCombineBatch; ++b) {
      const int i = i0 + b * kThreads + threadIdx.x;
      const int nl = kInt ? i % nv : i / bmv, ml = kInt ? i / nv : i % bmv;
      idx[b] = kInt ? (long long)(m0 + ml) * p.N + n0 + nl : (long long)(n0 + nl) * p.M + m0 + ml;
      if (i < total) v[b] = __ldcg(p.ws + idx[b]);
    }
#pragma unroll
    for (int b = 0; b < kCombineBatch; ++b) {
      const int i = i0 + b * kThreads + threadIdx.x;
      if (i >= total) continue;
      p.ws[idx[b]] = 0;
      if constexpr (kInt) {
        static_cast<int32_t*>(p.out)[idx[b]] = v[b];
      } else {
        const int nl = i / bmv, m = m0 + i % bmv;
        store(static_cast<TO*>(p.out) + (long long)(n0 + nl) * p.ldo + m,
              (static_cast<float>(v[b]) * p.w_scale[(long long)m * p.ws_stride]) * s_scale[nl]);
      }
    }
  }
  if (threadIdx.x == 0) p.counters[tile] = 0;
}

// The plan's checks: the C entry refuses a plan whose tiles it does not
// have, whose shared memory it would size differently, or whose alignment
// claim the pointers and strides do not bear out. a_bytes: the activation
// element size (1 for a_r), lda its row stride in elements (fused).
inline bool plan_ok(const Params& p, int g, int a_bytes, int bm, int bn, long long smem) {
  if (p.M <= 0 || p.N <= 0 || p.KG <= 0 || (g != 4 && g != 5)) return false;
  bool tile = false;
  for (int t = 0; t < kNumTiles; ++t) tile = tile || (bm == kTiles[t][0] && bn == kTiles[t][1]);
  if (!tile) return false;
  if (p.kstep != kSub && p.kstep != kMaxStep) return false;
  if (p.splits < 1 || p.splits > p.KG || p.splits > 65535 || (p.N + bn - 1) / bn > 65535) return false;
  if (p.KG % 4 == 0 && 4 * p.splits > p.KG) return false;   // split bounds on words
  if (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr)) return false;
  if (p.codes_aligned && (p.KG % 4 || (uintptr_t)p.packed % 4)) return false;
  if (p.acts_aligned) {
    if (p.KG % 4) return false;
    if (a_bytes == 1 ? (p.N % 4 || (uintptr_t)p.a % 4)
                     : (p.lda % 4 || (uintptr_t)p.a % (4 * a_bytes))) return false;
  }
  const size_t want = decode_smem_bytes(g, bn, p.kstep);
  return smem >= 0 && (size_t)smem == want && want <= kMaxSmem;
}

template <int G, int NW, int NT, typename TA, typename TO>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  constexpr int kThreads = 32 * NW, BM = 16 * NW, BN = 8 * NT;
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, p.splits);
  decode_kernel<G, NW, NT, TA, TO><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int G, typename TA, typename TO>
cudaError_t launch_tiles(const Params& p, int bm, int bn, size_t smem, cudaStream_t stream) {
  if (bm == kTiles[0][0] && bn == kTiles[0][1])
    return launch<G, kTiles[0][0] / 16, kTiles[0][1] / 8, TA, TO>(p, smem, stream);
  return launch<G, kTiles[1][0] / 16, kTiles[1][1] / 8, TA, TO>(p, smem, stream);
}

template <int G>
cudaError_t launch_types(const Params& p, int bm, int bn, size_t smem, int a_bf16, int out_bf16,
                         cudaStream_t stream) {
  if (a_bf16) {
    return out_bf16 ? launch_tiles<G, __nv_bfloat16, __nv_bfloat16>(p, bm, bn, smem, stream)
                    : launch_tiles<G, __nv_bfloat16, float>(p, bm, bn, smem, stream);
  }
  return out_bf16 ? launch_tiles<G, float, __nv_bfloat16>(p, bm, bn, smem, stream)
                  : launch_tiles<G, float, float>(p, bm, bn, smem, stream);
}

}  // namespace decode
}  // namespace vlut

// The C entries of the decode kernels. Beside the mpGeMM contracts of
// mpgemm_common.cuh they take the launch plan (rows bm and tokens bn of a
// block, K-splits, K-groups per step, the two alignment claims, dynamic
// shared bytes) and, for splits > 1, a zeroed int32 workspace of at least
// N*M entries and zeroed counters, one per (M-tile, token tile), both left
// zeroed again. Each launches on `stream` and returns a cudaError_t
// (cudaErrorInvalidValue for a plan it refuses).
extern "C" int ternary_decode_gemm_fused(
    const void* packed, const void* a, const void* a_scale, const void* w_scale, void* out,
    void* ws, void* counters, int M, int KG, int N, int g, long long lda, long long ldo,
    int ws_stride, int a_bf16, int out_bf16, int bm, int bn, int splits, int kstep,
    int codes_aligned, int acts_aligned, long long smem, void* stream) {
  const vlut::decode::Params p{(const uint8_t*)packed, a, (const float*)a_scale,
                               (const float*)w_scale, out, (int32_t*)ws, (int*)counters,
                               M, KG, N, ws_stride, lda, ldo, splits, kstep,
                               codes_aligned, acts_aligned};
  if (!vlut::decode::plan_ok(p, g, a_bf16 ? 2 : 4, bm, bn, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::decode::launch_types<5>(p, bm, bn, (size_t)smem, a_bf16, out_bf16, s)
                      : vlut::decode::launch_types<4>(p, bm, bn, (size_t)smem, a_bf16, out_bf16, s));
}

extern "C" int ternary_decode_gemm(
    const void* packed, const void* a_r, void* out, void* ws, void* counters, int M, int KG,
    int N, int g, int bm, int bn, int splits, int kstep, int codes_aligned, int acts_aligned,
    long long smem, void* stream) {
  const vlut::decode::Params p{(const uint8_t*)packed, a_r, nullptr, nullptr, out,
                               (int32_t*)ws, (int*)counters, M, KG, N, 0, 0, N, splits,
                               kstep, codes_aligned, acts_aligned};
  if (!vlut::decode::plan_ok(p, g, 1, bm, bn, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::decode::launch_tiles<5, int8_t, int32_t>(p, bm, bn, (size_t)smem, s)
                      : vlut::decode::launch_tiles<4, int8_t, int32_t>(p, bm, bn, (size_t)smem, s));
}
