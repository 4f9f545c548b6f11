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
// - A single launch is `decode_kernel` with E = 1 and zero expert strides.
// - Sums are exact in int32 (|sum| <= 127*K). wgmma and TMA are left for
//   later work.
//
// Grouped launches (`ternary_decode_gemm_fused_grouped`, and
// `ternary_decode_gemm_grouped` for the integer twin): E independent
// products of one shape in one launch. The TPU package reaches this kernel
// under `jax.vmap` over a Mixture-of-Experts layer's stacked expert weights
// (src/repro/models/common.py `linear_batched_apply`). They have their own
// kernel, `decode_grouped_kernel`, and plan (`grouped_decode_plan`).
// What bounds them at MoE shapes (llama4-scout: E 16, M 5120-8192, C 4-64
// rows an expert; deepseek-v3: E 256, M 2048-7168, C 16): the codes'
// bytes, E*M*KG, read once at 3.35 TB/s, bound them on paper. Through
// decode_kernel's 64-row tiles every block quantized (fused) or transposed
// (integer) its tokens' whole K-slice again, 32-128 times an activation a
// launch, and kept one 4 KB step of codes in flight.
// - A block of 16 warps owns (expert group, row chunk of BM rows, token
//   tile of 16, K-slice). It stages its token tile's K-slice once as
//   [j][n][kg] int8 (the fused kernel quantizes, the integer one
//   transposes a_r), then walks all BM rows (1024-3584 at deepseek: two
//   blocks an expert) against it: an activation is staged M/BM times a
//   launch (`stagings`).
// - Each warp owns slabs of 32 rows (slab w, w + 16, ... of the block: two
//   m16 tiles) and streams their codes, 128 K-groups a step, through its
//   own 4 KB slot by cp.async (16, 8 or 4 bytes by the operands'
//   alignment, else byte loads), each step's copy waited for at once: with
//   16 warps an SM, other warps decode while one waits.
//   Warps sync only themselves (__syncwarp), never the block, inside the
//   loop. Ring rows are 128 bytes with each row's 32-byte chunks XORed
//   with its row index mod 4, so a half-warp's 8-byte A reads hit 16
//   distinct bank pairs. Where the K-slice is a whole row shorter than 128
//   K-groups (the g=4 tails of 2-3 K-groups), a slot holds a slab's codes
//   as one contiguous run, read back unaligned.
// - The decode is decode_kernel's (4 table reads and 8 permutes a word, one
//   mma.sync.m16n8k32 s8 per trit), tile by tile, with the table in 64-bit
//   entries (trit 4 in the high word: 3 permutes a word instead of
//   byte-wise compares) and 16 copies interleaved so that each lane of a
//   half-warp reads its own bank pair.
// - A slab's sums go out through the warp's slot (its codes decoded),
//   in runs along the output's fast axis (tokens of (M, N), rows of
//   (N, M)): the g=4 tails write more output than they read codes.
// - Once staged, `__syncthreads_or` over the staged words says whether the
//   slice holds a nonzero activation. If not, every sum is 0 whatever the
//   codes: the block skips the code stream and writes the zero sums
//   through the same epilogue (S = 1) or arrives at its counter without
//   adding (S > 1). At a decode step >= 224 of deepseek's 256 experts hold
//   no real row.
// - The plan picks BM and the K-splits (S <= KG/128, splits on 128 K-groups)
//   so that the fewest blocks an expert, two row chunks at least (a decode
//   step's live experts then spread over twice the SMs), fill the grid's
//   last wave of one block an SM to 95% (rows before splits); a segment of
//   one step (the tails) runs `ex` experts a block in turn. Split-K
//   keeps decode_kernel's per-expert workspace and arrival counters, one
//   counter per (expert, row chunk, token tile), left zeroed after each
//   launch.
// - The quantizer of the fused kernel is decode_kernel's (IEEE division),
//   with a zero activation taken as 0 without dividing (`gquantize`): the
//   same int8 0, and on a decode step's rows, where most activations are
//   zero, a w1 launch is 1.7x faster (PERF.md section 6).
// What bounds the loop (tools/decode_probe.py on the card, numbers in
// PERF.md section 6): mostly the code stream, not the decode. At
// deepseek's w1 a launch runs at about 3x the codes' time at 3.35 TB/s;
// the copies and the loop alone take about 60% of it, and without its
// copies, decode or mma a launch still takes about 70%, 75% and 90%.
// Reading 128 bytes of each of 32 rows 1,432 bytes apart a step, the
// stream runs at about half the HBM rate. 64-K-group steps, 8 warps a
// block and other decodes (an arithmetic base-3 one, decode_kernel's
// 32-bit table in 32 lane copies) were slower; two 64-K-group slots a
// warp with the next one in flight were slower at w1 and a few percent
// faster fused at w2; an L2 prefetch hint moved a launch by 0-2%.
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
  int32_t* ws;            // zeros laid out as out (one per expert), S > 1 only
  int* counters;          // (E * M-tiles * token tiles,) zeros, S > 1 only
  int M, KG, N, ws_stride;
  long long lda, ldo;
  int splits, kstep, codes_aligned, acts_aligned;
  // grouped launch: E experts, each operand's stride between experts in
  // its elements (E = 1 and zero strides for a single product)
  int E;
  long long es_packed, es_a, es_a_scale, es_w_scale, es_out;
};

// The operands of expert e: each pointer moved by its expert stride (in
// elements of TA for the activations, TO for the output), the workspace
// by N*M entries and the counters by one expert's tiles.
template <typename TA, typename TO>
__device__ __forceinline__ Params expert_params(const Params& g, int e, int tiles) {
  Params p = g;
  p.packed += e * g.es_packed;
  p.a = static_cast<const TA*>(g.a) + e * g.es_a;
  p.a_scale += e * g.es_a_scale;
  p.w_scale += e * g.es_w_scale;
  p.out = static_cast<TO*>(g.out) + e * g.es_out;
  if (g.ws != nullptr) {
    p.ws += (long long)e * g.N * g.M;
    p.counters += (long long)e * tiles;
  }
  return p;
}

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
__global__ void __launch_bounds__(32 * NW) decode_kernel(const Params pg) {
  constexpr bool kInt = std::is_same<TA, int8_t>::value;
  constexpr int kThreads = 32 * NW, BM = 16 * NW, BN = 8 * NT;
  extern __shared__ __align__(16) int8_t aq[];
  __shared__ TritTable table;
  __shared__ float s_scale[BN];
  __shared__ int s_last;

  // blockIdx.z = expert * S + split
  const int expert = blockIdx.z / pg.splits, split = blockIdx.z - expert * pg.splits;
  const Params p = expert_params<TA, TO>(pg, expert, gridDim.x * gridDim.y);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tq = lane % 4;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int bmv = min(BM, p.M - m0), nv = min(BN, p.N - n0);
  const int nact = (nv + 7) / 8;                // n8 tiles with a valid token
  const int kg_lo = split_bound(split, p.KG, p.splits);
  const int kg_hi = split_bound(split + 1, p.KG, p.splits);
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
  if (p.splits < 1 || p.splits > p.KG || (p.N + bn - 1) / bn > 65535) return false;
  if (p.E < 1 || (long long)p.E * p.splits > 65535) return false;      // grid z
  if (p.es_packed < 0 || p.es_a < 0 || p.es_a_scale < 0 || p.es_w_scale < 0 || p.es_out < 0)
    return false;
  if (p.KG % 4 == 0 && 4 * p.splits > p.KG) return false;   // split bounds on words
  if (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr)) return false;
  if (p.codes_aligned && (p.KG % 4 || (uintptr_t)p.packed % 4 || p.es_packed % 4)) return false;
  if (p.acts_aligned) {
    if (p.KG % 4 || p.es_a % 4) return false;
    if (a_bytes == 1 ? (p.N % 4 || (uintptr_t)p.a % 4)
                     : (p.lda % 4 || (uintptr_t)p.a % (4 * a_bytes))) return false;
  }
  const size_t want = decode_smem_bytes(g, bn, p.kstep);
  return smem >= 0 && (size_t)smem == want && want <= kMaxSmem;
}

template <int G, int NW, int NT, typename TA, typename TO>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  constexpr int kThreads = 32 * NW, BM = 16 * NW, BN = 8 * NT;
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, p.E * p.splits);
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

// ---------------------------------------------------------------------------
// The grouped kernel (`ternary_decode_gemm_fused_grouped`,
// `ternary_decode_gemm_grouped`): the same function as E launches of
// decode_kernel, with its own geometry for Mixture-of-Experts shapes
// (design note at the head of this file).

constexpr int kGWarps = 16;                   // warps of a grouped block
constexpr int kGThreads = 32 * kGWarps;
constexpr int kGSlab = 32;                    // rows of a warp's slot
constexpr int kGTiles = kGSlab / 16;          // m16 tiles of a slab
constexpr int kGRows = kGSlab * kGWarps;      // a block's rows are a multiple of this
constexpr int kGStep = 128;                   // K-groups of a slot (a slab row's bytes)
constexpr int kGSlot = kGSlab * kGStep;       // shared bytes of a warp's slot
constexpr int kGBN = 16;                      // tokens of a token tile
constexpr int kGCopies = 16;                  // interleaved copies of the trit table
constexpr int kGCombineBatch = 4;             // split-K combine loads in flight a thread
constexpr size_t kGMaxSmem = 232448 - 1024;   // 227 KB less the static part

// First K-group of split z of S: z*KG/S rounded down to a multiple of
// kGStep (the plan keeps S <= KG/kGStep), so every step starts a
// whole number of steps from the row's start; split S ends at KG.
// `_gsplit_bound` computes the same.
__host__ __device__ inline int gsplit_bound(int z, int KG, int S) {
  return z >= S ? KG : (int)((long long)z * KG / S) & ~(kGStep - 1);
}

// Shared bytes of one staged (trit, token) row of a K-slice of nk
// K-groups: 32 more than a multiple of 64, so that a half-warp's 8-byte B
// reads (tokens 0-3 x t 0-3) fall on 16 distinct bank pairs.
__host__ __device__ constexpr int gslice_row_bytes(int nk) { return (nk + 63) / 64 * 64 + 32; }

// Dynamic shared memory of one grouped block: the trit table (256 64-bit
// entries x kGCopies), the staged activations [g][bn][gslice_row_bytes]
// and each warp's slot [kGWarps][kGSlab][kGStep].
// `grouped_decode_smem_bytes` in kernels/ternary_decode_gemm.py computes
// the same.
__host__ __device__ constexpr size_t gdecode_table_bytes() { return (size_t)kTableSize * 8 * kGCopies; }
__host__ __device__ constexpr size_t gdecode_ring_bytes() { return (size_t)kGWarps * kGSlot; }

// Byte c of row r of a slot: rows kGStep bytes apart, the 32-byte
// chunks of a row XORed with the row's place among those sharing a
// 128-byte bank window, so that a half-warp's 8-byte A reads (rows gid
// 0-3 x t 0-3, 32 bytes a row) fall on 16 distinct bank pairs.
__device__ __forceinline__ int slot_swizzle(int r) {
  return ((r / (128 / kGStep)) & (kGStep / 32 - 1)) << 5;
}
__device__ __forceinline__ int slot_at(int r, int c) { return r * kGStep + (c ^ slot_swizzle(r)); }
__host__ __device__ inline size_t gdecode_smem_bytes(int g, int bn, int nk) {
  return gdecode_table_bytes() + (size_t)g * bn * gslice_row_bytes(nk) + gdecode_ring_bytes();
}

struct GParams {
  Params p;               // operands, shape, splits, expert strides; acts_aligned: vector
                          // loads of the activations (kstep and codes_aligned unused)
  int bm;                 // rows of a block
  int ex;                 // experts of a block, in turn
  int bn;                 // staged token rows: 8 (N <= 8) or 16
  int rs;                 // shared bytes of one staged (trit, token) row
  int vw;                 // cp.async bytes of a code copy (16, 8, 4), 0: byte loads
  int packed_rows;        // S = 1 and KG < kGStep: a slot is one run of kGSlab rows
};

// `bytes` (<= V) of global memory to shared memory, asynchronously; the
// rest of the V-byte destination is zero-filled. Both addresses V-aligned.
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(V),
                 "r"(bytes)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// One warp's copy of `rows` rows of `len` (<= kGStep) bytes, row r from
// src + r*stride to row r of `slot` (slot_at): pieces of V bytes,
// consecutive lanes on consecutive pieces of a row.
template <int V>
__device__ __forceinline__ void warp_copy_rows(int rows, int len, const uint8_t* src,
                                               long long stride, int8_t* slot, int lane) {
  constexpr int kPer = kGStep / V;            // pieces of a full row
  for (int u = lane; u < rows * kPer; u += 32) {
    const int r = u / kPer, c = V * (u % kPer);
    if (c < len) cp_async<V>(slot + slot_at(r, c), src + r * stride + c, min(V, len - c));
  }
}

// One warp's copy of a contiguous run of `len` (<= kGSlot) bytes to the
// start of `slot`, in pieces of V bytes.
template <int V>
__device__ __forceinline__ void warp_copy_run(int len, const uint8_t* src, int8_t* slot, int lane) {
  for (int c = V * lane; c < len; c += 32 * V) cp_async<V>(slot + c, src + c, min(V, len - c));
}

// A slot's codes, by one warp: rows (or, `run`, one contiguous run of
// len bytes) by cp.async of vw bytes (every source vw-aligned), or by byte
// loads where vw is 0 (done when the warp next syncs).
__device__ __forceinline__ void warp_copy(int vw, bool run, int rows, int len, const uint8_t* src,
                                          long long stride, int8_t* slot, int lane) {
  if (run) {
    switch (vw) {
      case 16: warp_copy_run<16>(len, src, slot, lane); break;
      case 8: warp_copy_run<8>(len, src, slot, lane); break;
      case 4: warp_copy_run<4>(len, src, slot, lane); break;
      default:
        for (int c = lane; c < len; c += 32) slot[c] = (int8_t)src[c];
    }
    return;
  }
  switch (vw) {
    case 16: warp_copy_rows<16>(rows, len, src, stride, slot, lane); break;
    case 8: warp_copy_rows<8>(rows, len, src, stride, slot, lane); break;
    case 4: warp_copy_rows<4>(rows, len, src, stride, slot, lane); break;
    default:
      for (int u = lane; u < rows * kGStep; u += 32) {
        const int r = u / kGStep, c = u % kGStep;
        if (c < len) slot[slot_at(r, c)] = (int8_t)src[r * stride + c];
      }
  }
}

// The 64-bit trit table, kGCopies copies interleaved: entry c of copy k at
// uint2 index c * kGCopies + k; low word trits 0-3 of c as int8 bytes (as
// TritTable), high word's byte 0 trit 4, (c / 81) % 3 - 1.
__device__ __forceinline__ void build_table2(uint2* t) {
  for (int i = threadIdx.x; i < kTableSize * kGCopies; i += kGThreads) {
    const int c = i / kGCopies;
    uint32_t lo = 0;
    int r = c;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo |= (uint32_t)(uint8_t)(int8_t)(r % 3 - 1) << (8 * j);
      r /= 3;
    }
    t[i] = make_uint2(lo, (uint32_t)(uint8_t)(int8_t)(r % 3 - 1));
  }
}

// decode_word's result from the 64-bit table: `tk` points at this lane's
// copy. Trit 4's bytes come from byte 0 of the 4 entries' high words.
template <int G>
__device__ __forceinline__ void decode_word2(const uint2* tk, uint32_t w, uint32_t a[G]) {
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t c = (w >> (8 * i)) & 0xff;
    if constexpr (G == 5) {
      const uint2 e = tk[c * kGCopies];
      lo[i] = e.x;
      hi[i] = e.y;
    } else {
      lo[i] = reinterpret_cast<const uint32_t*>(tk + c * kGCopies)[0];
    }
  }
  uint32_t tr[4];
  transpose4(lo, tr);
#pragma unroll
  for (int j = 0; j < 4 && j < G; ++j) a[j] = tr[j];
  if constexpr (G == 5) a[4] = prmt(prmt(hi[0], hi[1], 0x0040), prmt(hi[2], hi[3], 0x0040), 0x5410);
}

// 8 bytes at any byte offset of shared memory, as two words.
__device__ __forceinline__ void load8(const int8_t* base, int off, uint32_t& lo, uint32_t& hi) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(base + (off & ~3));
  const uint32_t sh = 8 * (off & 3);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  lo = __funnelshift_r(w0, w1, sh);
  hi = __funnelshift_r(w1, w2, sh);
}

// quantize's result; a zero activation is 0 without the IEEE division,
// which is slow on a zero dividend.
__device__ __forceinline__ int8_t gquantize(float v, float s) {
  return v == 0.f ? (int8_t)0 : quantize(v, s);
}

// The fused prologue of one expert: x's tokens [n0, n0 + nv) over
// K-groups [kg_lo, kg_lo + nk) quantized into aq[j][n][kk] for tokens
// [0, ntok) and kk in [0, 32 * ceil(nk / 32)); 0 outside the valid tokens
// and K-groups. One item a thread per (token, 4 K-groups): 4G features,
// as G vectors where the activations are aligned and the 4 K-groups valid
// (bf16 rows all at once, f32 rows two vectors at a time: a thread of 16
// warps has 128 registers), else element by element; stored as one word
// per trit. Returns the OR of this thread's words.
template <int G, typename TA>
__device__ __forceinline__ uint32_t gstage_fused(const GParams& gp, const Params& p, int n0, int nv,
                                                 int kg_lo, int nk, int ntok, const float* s_scale,
                                                 int8_t* aq) {
  constexpr int VB = sizeof(TA) == 4 ? 2 : G;   // vectors loaded before they are quantized
  const int quads = (nk + 31) / 32 * 8, total = ntok * quads;
  uint32_t nz = 0;
  for (int i = threadIdx.x; i < total; i += kGThreads) {
    const int n = i / quads, q = i - n * quads;
    uint32_t w[G] = {};
    if (n < nv && 4 * q < nk) {
      const float s = s_scale[n];
      const TA* src = static_cast<const TA*>(p.a) + (long long)(n0 + n) * p.lda +
                      (long long)(kg_lo + 4 * q) * G;
      if (p.acts_aligned && 4 * q + 4 <= nk) {
#pragma unroll
        for (int v0 = 0; v0 < G; v0 += VB) {
          typename Raw4<TA>::T raw[VB];
#pragma unroll
          for (int v = 0; v < VB && v0 + v < G; ++v) {
            raw[v] = *reinterpret_cast<const typename Raw4<TA>::T*>(src + 4 * (v0 + v));
          }
#pragma unroll
          for (int v = 0; v < VB && v0 + v < G; ++v) {
            const float4 f = to_f32x4(raw[v]);
            const float fs[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kk = 4 * (v0 + v) + e;
              w[kk % G] |= (uint32_t)(uint8_t)gquantize(fs[e], s) << (8 * (kk / G));
            }
          }
          if constexpr (VB < G) asm volatile("" ::: "memory");   // the next loads wait
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4 * G; ++kk) {
          if (4 * q + kk / G < nk) {
            w[kk % G] |= (uint32_t)(uint8_t)gquantize(to_f32(src[kk]), s) << (8 * (kk / G));
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < G; ++t) {
      *reinterpret_cast<uint32_t*>(aq + (t * gp.bn + n) * gp.rs + 4 * q) = w[t];
      nz |= w[t];
    }
  }
  return nz;
}

// The integer prologue of one expert: a_r[j, kg_lo + kk, n0 + n] into
// aq[j][n][kk], as gstage_fused lays it out. Aligned (N % 4 == 0, KG % 4
// == 0): one item per (trit, 4 K-groups, 4 tokens), 4 words of a_r
// transposed with __byte_perm; else byte by byte, tokens fastest.
template <int G>
__device__ __forceinline__ uint32_t gstage_int(const GParams& gp, const Params& p, int n0, int nv,
                                               int kg_lo, int nk, int ntok, int8_t* aq) {
  const int8_t* a_r = static_cast<const int8_t*>(p.a);
  const int width = (nk + 31) / 32 * 32;
  uint32_t nz = 0;
  if (!p.acts_aligned) {
    for (int i = threadIdx.x; i < G * width * ntok; i += kGThreads) {
      const int n = i % ntok, rest = i / ntok;
      const int kk = rest % width, j = rest / width;
      int8_t q = 0;
      if (n < nv && kk < nk) q = a_r[((long long)j * p.KG + kg_lo + kk) * p.N + n0 + n];
      aq[(j * gp.bn + n) * gp.rs + kk] = q;
      nz |= (uint8_t)q;
    }
    return nz;
  }
  const int quads = width / 4, n4s = ntok / 4, total = G * quads * n4s;
  for (int i = threadIdx.x; i < total; i += kGThreads) {
    const int n4 = i % n4s, rest = i / n4s;
    const int q = rest % quads, j = rest / quads;
    const bool valid = 4 * n4 < nv && 4 * q < nk;
    const int8_t* src = a_r + ((long long)j * p.KG + kg_lo + 4 * q) * p.N + n0 + 4 * n4;
    uint32_t rows[4], cols[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) rows[r] = valid ? *reinterpret_cast<const uint32_t*>(src + (long long)r * p.N) : 0;
    transpose4(rows, cols);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<uint32_t*>(aq + (j * gp.bn + 4 * n4 + c) * gp.rs + 4 * q) = cols[c];
      nz |= cols[c];
    }
  }
  return nz;
}

// TA = int8_t: the integer kernel (a is a_r, out is int32 (M, N)); TA =
// float or bf16: the fused kernel (out is TO (N, M)). Block (x, y, z) owns
// rows [x*bm, +bm), tokens [y*16, +16) and split z % S of the experts
// [(z / S) * ex, +ex), one after another.
template <int G, typename TA, typename TO>
__global__ void __launch_bounds__(kGThreads, 1) decode_grouped_kernel(const GParams gp) {
  constexpr bool kInt = std::is_same<TA, int8_t>::value;
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ float s_scale[kGBN];
  __shared__ int s_last;

  const Params& pg = gp.p;
  // blockIdx.z = expert group * S + split
  const int eg = blockIdx.z / pg.splits, split = blockIdx.z - eg * pg.splits;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int r0 = blockIdx.x * gp.bm, rv = min(gp.bm, pg.M - r0);      // rows of this block
  const int n0 = blockIdx.y * kGBN, nv = min(kGBN, pg.N - n0);        // valid tokens
  const int nact = (nv + 7) / 8;                                     // n8 tiles with a valid token
  const int kg_lo = gsplit_bound(split, pg.KG, pg.splits);
  const int nk = gsplit_bound(split + 1, pg.KG, pg.splits) - kg_lo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tq = lane % 4;
  // this warp's slabs of 32 rows: slab warp, warp + kGWarps, ... of the block
  const int nslab = (rv + kGSlab - 1) / kGSlab;
  const int my_slabs = warp < nslab ? (nslab - warp + kGWarps - 1) / kGWarps : 0;
  const int nsteps = gp.packed_rows ? 1 : (nk + kGStep - 1) / kGStep;
  const int items = my_slabs * nsteps;
  const int swz = slot_swizzle(gid);          // slot_at's for rows gid and gid + 8 of a tile

  uint2* table = reinterpret_cast<uint2*>(smem);
  int8_t* aq = smem + gdecode_table_bytes();
  int8_t* slot = aq + (size_t)G * gp.bn * gp.rs + (size_t)warp * kGSlot;   // this warp's
  const uint2* tk = table + (lane & (kGCopies - 1));
  build_table2(table);

  for (int ei = 0; ei < gp.ex; ++ei) {
    const int expert = eg * gp.ex + ei;
    if (expert >= pg.E) break;
    const Params p = expert_params<TA, TO>(pg, expert, tiles);
    __syncthreads();                          // the last expert's reads are done
    if constexpr (!kInt) load_token_scales(p.a_scale, p.N, n0, s_scale);

    // this warp's item (slab t, step k) into its slot; the items run
    // slab by slab, each slab's steps in turn
    int ti = 0, ki = 0, it_issue = 0;
    auto issue = [&]() {
      if (it_issue < items) {
        const int m0 = (warp + ti * kGWarps) * kGSlab;        // first row in the block
        const int rows = min(kGSlab, rv - m0);
        const uint8_t* src = p.packed + (long long)(r0 + m0) * p.KG + kg_lo + ki * kGStep;
        warp_copy(gp.vw, gp.packed_rows, rows, gp.packed_rows ? rows * p.KG : min(kGStep, nk - ki * kGStep),
                  src, p.KG, slot, lane);
        if (++ki == nsteps) ki = 0, ++ti;
      }
      ++it_issue;
      cp_async_commit();
    };
    __syncthreads();                          // s_scale
    uint32_t nz;
    if constexpr (kInt) {
      nz = gstage_int<G>(gp, p, n0, nv, kg_lo, nk, 8 * nact, aq);
    } else {
      nz = gstage_fused<G, TA>(gp, p, n0, nv, kg_lo, nk, 8 * nact, s_scale, aq);
    }
    const bool skip = !__syncthreads_or(nz != 0);

    // the sums of slab t through `buf`, this warp's slot once decoded
    // ([32 rows][16 tokens] int32): then straight to the output (S = 1) or
    // added into the workspace, in runs along the output's fast axis
    // (tokens of (M, N), rows of (N, M)). Accumulator c of m16 tile h, n8
    // tile nt: row 16h + gid + 8*(c/2) of the slab, token 8nt + 2tq + c%2.
    auto epilogue = [&](int t, const int (&acc)[kGTiles][2][4], int* buf) {
      const int m0 = r0 + (warp + t * kGWarps) * kGSlab;    // the slab's first row
      const int rows = min(kGSlab, r0 + rv - m0);
#pragma unroll
      for (int h = 0; h < kGTiles; ++h) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            buf[(16 * h + gid + 8 * (c / 2)) * kGBN + nt * 8 + 2 * tq + c % 2] = acc[h][nt][c];
          }
        }
      }
      __syncwarp();
      if constexpr (kInt) {
        for (int r = lane / kGBN; r < rows; r += 32 / kGBN) {
          const int nl = lane % kGBN;
          if (nl >= nv) continue;
          const long long i = (long long)(m0 + r) * p.N + n0 + nl;
          if (p.splits > 1) {
            atomicAdd(p.ws + i, buf[r * kGBN + nl]);
          } else {
            static_cast<int32_t*>(p.out)[i] = buf[r * kGBN + nl];
          }
        }
      } else if (lane < rows) {
        const int m = m0 + lane;
        const float w = p.splits > 1 ? 0.f : p.w_scale[(long long)m * p.ws_stride];
        for (int nl = 0; nl < nv; ++nl) {
          const int v = buf[lane * kGBN + nl];
          if (p.splits > 1) {
            atomicAdd(p.ws + (long long)(n0 + nl) * p.M + m, v);
          } else {
            store(static_cast<TO*>(p.out) + (long long)(n0 + nl) * p.ldo + m,
                  (static_cast<float>(v) * w) * s_scale[nl]);
          }
        }
      }
      __syncwarp();                           // buf's reads are done before it is refilled
    };

    if (skip) {
      if (p.splits == 1) {
        const int zero[kGTiles][2][4] = {};
        for (int t = 0; t < my_slabs; ++t) epilogue(t, zero, reinterpret_cast<int*>(slot));
      }
    } else {
      int acc[kGTiles][2][4] = {};
      int tc = 0, kc = 0;
      for (int it = 0; it < items; ++it) {
        __syncwarp();                         // item it - 1's reads of the slot are done
        issue();                              // item it
        cp_async_wait_all();                  // item it has landed (this lane's copies)
        __syncwarp();                         // ... the warp's
        const int kk0 = kc * kGStep, nsub = min(kGStep / kSub, (nk - kk0 + 31) / 32);
#pragma unroll
        for (int s = 0; s < kGStep / kSub; ++s) {
          if (s >= nsub) break;
          // tile by tile: A words of m16 tile h {row gid K-groups 8t..8t+3,
          // row gid+8 the same, row gid 8t+4..8t+7, row gid+8 the same},
          // decoded, then one mma per trit and n8 tile
#pragma unroll
          for (int h = 0; h < kGTiles; ++h) {
            const int row = 16 * h + gid;
            uint32_t cur[4];
            if (gp.packed_rows) {
              load8(slot, row * p.KG + s * kSub + 8 * tq, cur[0], cur[2]);
              load8(slot, (row + 8) * p.KG + s * kSub + 8 * tq, cur[1], cur[3]);
            } else {
              const int col = (s * kSub) ^ swz;
              const uint2 lo = *reinterpret_cast<const uint2*>(slot + row * kGStep + col + 8 * tq);
              const uint2 hi = *reinterpret_cast<const uint2*>(slot + (row + 8) * kGStep + col + 8 * tq);
              cur[0] = lo.x, cur[1] = hi.x, cur[2] = lo.y, cur[3] = hi.y;
            }
            uint32_t a[G][4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              uint32_t tr[G];
              decode_word2<G>(tk, cur[r], tr);
#pragma unroll
              for (int j = 0; j < G; ++j) a[j][r] = tr[j];
            }
#pragma unroll
            for (int j = 0; j < G; ++j) {
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                if (nt >= nact) break;
                const uint2 b = *reinterpret_cast<const uint2*>(
                    aq + (j * gp.bn + nt * 8 + gid) * gp.rs + kk0 + s * kSub + 8 * tq);
                mma_s8(acc[h][nt], a[j], b.x, b.y);
              }
            }
          }
        }
        if (++kc == nsteps) {
          __syncwarp();                       // the slot's A reads are done
          epilogue(tc, acc, reinterpret_cast<int*>(slot));
#pragma unroll
          for (int h = 0; h < kGTiles; ++h) {
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[h][nt][c] = 0;
            }
          }
          kc = 0, ++tc;
        }
      }
    }
    if (p.splits == 1) continue;

    // split-K combine: the last block of this expert's output tile to
    // arrive writes it (as decode_kernel's); a skipped block adds nothing
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
    // kGCombineBatch loads in flight a thread, offsets within the expert's
    // workspace (at most N*M entries) in 32 bits: the loop's registers stay
    // within the 128 a thread of 16 warps has
    const int total = rv * nv;
    for (int i0 = 0; i0 < total; i0 += kGCombineBatch * kGThreads) {
      int v[kGCombineBatch], idx[kGCombineBatch];
#pragma unroll
      for (int b = 0; b < kGCombineBatch; ++b) {
        const int i = i0 + b * kGThreads + threadIdx.x;
        const int nl = kInt ? i % nv : i / rv, ml = kInt ? i / nv : i % rv;
        idx[b] = kInt ? (r0 + ml) * p.N + n0 + nl : (n0 + nl) * p.M + r0 + ml;
        if (i < total) v[b] = __ldcg(p.ws + idx[b]);
      }
#pragma unroll
      for (int b = 0; b < kGCombineBatch; ++b) {
        const int i = i0 + b * kGThreads + threadIdx.x;
        if (i >= total) continue;
        p.ws[idx[b]] = 0;
        if constexpr (kInt) {
          static_cast<int32_t*>(p.out)[idx[b]] = v[b];
        } else {
          const int nl = i / rv, m = r0 + i % rv;
          store(static_cast<TO*>(p.out) + (long long)(n0 + nl) * p.ldo + m,
                (static_cast<float>(v[b]) * p.w_scale[(long long)m * p.ws_stride]) * s_scale[nl]);
        }
      }
    }
    if (threadIdx.x == 0) p.counters[tile] = 0;
  }
}

// The longest K-slice of S splits.
inline int glongest_slice(int KG, int S) {
  int longest = 0;
  for (int z = 0; z < S; ++z) {
    const int len = gsplit_bound(z + 1, KG, S) - gsplit_bound(z, KG, S);
    longest = len > longest ? len : longest;
  }
  return longest;
}

// The widest cp.async (16, 8 or 4 bytes) that every copy can use: the base
// pointer and both strides (in bytes) multiples of it; 0: none.
inline int copy_width(const void* ptr, long long s1, long long s2) {
  for (int v = 16; v >= 4; v /= 2) {
    if ((uintptr_t)ptr % v == 0 && s1 % v == 0 && s2 % v == 0) return v;
  }
  return 0;
}

// The grouped plan's checks, as plan_ok's for the single one: the C entry
// refuses a plan whose geometry or shared memory it would size otherwise.
// Fills in what the kernel derives from the operands: the staged row
// bytes, the copy width and mode of the codes, the activations' vector
// claim (a_bytes: the activation element size, 1 for a_r).
inline bool gplan_ok(GParams& gp, int g, int a_bytes, long long smem) {
  Params& p = gp.p;
  if (p.M <= 0 || p.N <= 0 || p.KG <= 0 || (g != 4 && g != 5) || p.E < 1) return false;
  if (p.es_packed < 0 || p.es_a < 0 || p.es_a_scale < 0 || p.es_w_scale < 0 || p.es_out < 0)
    return false;
  if (gp.bm <= 0 || gp.bm % kGRows || p.splits < 1) return false;
  if (p.splits > (p.KG / kGStep > 1 ? p.KG / kGStep : 1)) return false;
  if (gp.ex < 1 || gp.ex > p.E) return false;
  if ((long long)((p.E + gp.ex - 1) / gp.ex) * p.splits > 65535) return false;   // grid z
  if ((p.N + kGBN - 1) / kGBN > 65535) return false;
  if (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr)) return false;
  if ((long long)p.N * p.M >= (1LL << 31)) return false;   // the combine's 32-bit offsets
  gp.bn = p.N <= 8 ? 8 : kGBN;
  const int longest = glongest_slice(p.KG, p.splits);
  gp.rs = gslice_row_bytes(longest);
  gp.packed_rows = p.splits == 1 && p.KG < kGStep;
  gp.vw = copy_width(p.packed, gp.packed_rows ? 0 : p.KG, p.es_packed);
  if (a_bytes == 1) {
    p.acts_aligned = p.KG % 4 == 0 && p.N % 4 == 0 && (uintptr_t)p.a % 4 == 0 && p.es_a % 4 == 0;
  } else {
    p.acts_aligned = p.KG % 4 == 0 && p.lda % 4 == 0 && p.es_a % 4 == 0 &&
                     (uintptr_t)p.a % (4 * a_bytes) == 0;
  }
  const size_t want = gdecode_smem_bytes(g, gp.bn, longest);
  return smem >= 0 && (size_t)smem == want && want <= kGMaxSmem;
}

template <int G, typename TA, typename TO>
cudaError_t launch_grouped(const GParams& gp, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(decode_grouped_kernel<G, TA, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const Params& p = gp.p;
  const dim3 grid((p.M + gp.bm - 1) / gp.bm, (p.N + kGBN - 1) / kGBN,
                  (p.E + gp.ex - 1) / gp.ex * p.splits);
  decode_grouped_kernel<G, TA, TO><<<grid, kGThreads, smem, stream>>>(gp);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_grouped_types(const GParams& gp, size_t smem, int a_bf16, int out_bf16,
                                 cudaStream_t stream) {
  if (a_bf16) {
    return out_bf16 ? launch_grouped<G, __nv_bfloat16, __nv_bfloat16>(gp, smem, stream)
                    : launch_grouped<G, __nv_bfloat16, float>(gp, smem, stream);
  }
  return out_bf16 ? launch_grouped<G, float, __nv_bfloat16>(gp, smem, stream)
                  : launch_grouped<G, float, float>(gp, smem, stream);
}

}  // namespace decode
}  // namespace vlut

// The fused entries' common body: check the plan, launch on `stream`.
static int decode_fused(const vlut::decode::Params& p, int g, int a_bf16, int out_bf16, int bm,
                        int bn, long long smem, void* stream) {
  if (!vlut::decode::plan_ok(p, g, a_bf16 ? 2 : 4, bm, bn, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::decode::launch_types<5>(p, bm, bn, (size_t)smem, a_bf16, out_bf16, s)
                      : vlut::decode::launch_types<4>(p, bm, bn, (size_t)smem, a_bf16, out_bf16, s));
}

// The C entries of the decode kernels. Beside the mpGeMM contracts of
// mpgemm_common.cuh they take the launch plan (rows bm and tokens bn of a
// block, K-splits, K-groups per step, the two alignment claims, dynamic
// shared bytes) and, for splits > 1, a zeroed int32 workspace of at least
// N*M entries (E*N*M grouped) and zeroed counters, one per (M-tile, token
// tile) (and expert), both left zeroed again. Each launches on `stream`
// and returns a cudaError_t (cudaErrorInvalidValue for a plan it refuses).
extern "C" int ternary_decode_gemm_fused(
    const void* packed, const void* a, const void* a_scale, const void* w_scale, void* out,
    void* ws, void* counters, int M, int KG, int N, int g, long long lda, long long ldo,
    int ws_stride, int a_bf16, int out_bf16, int bm, int bn, int splits, int kstep,
    int codes_aligned, int acts_aligned, long long smem, void* stream) {
  const vlut::decode::Params p{(const uint8_t*)packed, a, (const float*)a_scale,
                               (const float*)w_scale, out, (int32_t*)ws, (int*)counters,
                               M, KG, N, ws_stride, lda, ldo, splits, kstep,
                               codes_aligned, acts_aligned, 1, 0, 0, 0, 0, 0};
  return decode_fused(p, g, a_bf16, out_bf16, bm, bn, smem, stream);
}

// The grouped fused entry: E products of one shape in one launch, expert e
// reading packed + e*es_packed (M, KG), a + e*es_a (N rows of stride lda),
// a_scale + e*es_a_scale (N,), w_scale + e*es_w_scale and writing out +
// e*es_out (N rows of stride ldo); strides in elements. Its plan
// (`grouped_decode_plan`): rows a block bm, K-splits, experts a block ex,
// dynamic shared bytes.
extern "C" int ternary_decode_gemm_fused_grouped(
    const void* packed, const void* a, const void* a_scale, const void* w_scale, void* out,
    void* ws, void* counters, int M, int KG, int N, int g, long long lda, long long ldo,
    int ws_stride, int a_bf16, int out_bf16, int E, long long es_packed, long long es_a,
    long long es_a_scale, long long es_w_scale, long long es_out, int bm, int splits, int ex,
    long long smem, void* stream) {
  vlut::decode::GParams gp{{(const uint8_t*)packed, a, (const float*)a_scale,
                            (const float*)w_scale, out, (int32_t*)ws, (int*)counters, M, KG, N,
                            ws_stride, lda, ldo, splits, 0, 0, 0, E, es_packed, es_a, es_a_scale,
                            es_w_scale, es_out},
                           bm, ex, 0, 0, 0, 0};
  if (!vlut::decode::gplan_ok(gp, g, a_bf16 ? 2 : 4, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::decode::launch_grouped_types<5>(gp, (size_t)smem, a_bf16, out_bf16, s)
                      : vlut::decode::launch_grouped_types<4>(gp, (size_t)smem, a_bf16, out_bf16, s));
}

// The integer entries' common body: check the plan, launch on `stream`.
static int decode_int(const vlut::decode::Params& p, int g, int bm, int bn, long long smem,
                      void* stream) {
  if (!vlut::decode::plan_ok(p, g, 1, bm, bn, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::decode::launch_tiles<5, int8_t, int32_t>(p, bm, bn, (size_t)smem, s)
                      : vlut::decode::launch_tiles<4, int8_t, int32_t>(p, bm, bn, (size_t)smem, s));
}

extern "C" int ternary_decode_gemm(
    const void* packed, const void* a_r, void* out, void* ws, void* counters, int M, int KG,
    int N, int g, int bm, int bn, int splits, int kstep, int codes_aligned, int acts_aligned,
    long long smem, void* stream) {
  const vlut::decode::Params p{(const uint8_t*)packed, a_r, nullptr, nullptr, out,
                               (int32_t*)ws, (int*)counters, M, KG, N, 0, 0, N, splits,
                               kstep, codes_aligned, acts_aligned, 1, 0, 0, 0, 0, 0};
  return decode_int(p, g, bm, bn, smem, stream);
}

// The grouped integer entry: E products of one shape in one launch, expert
// e reading packed + e*es_packed (M, KG) and a_r + e*es_a (g, KG, N) and
// writing out + e*es_out (M, N); strides in elements; its plan as the
// fused entry's. The unfused pipeline's middle pass over a MoE layer's
// stacked experts.
extern "C" int ternary_decode_gemm_grouped(
    const void* packed, const void* a_r, void* out, void* ws, void* counters, int M, int KG,
    int N, int g, int E, long long es_packed, long long es_a, long long es_out, int bm,
    int splits, int ex, long long smem, void* stream) {
  vlut::decode::GParams gp{{(const uint8_t*)packed, a_r, nullptr, nullptr, out, (int32_t*)ws,
                            (int*)counters, M, KG, N, 0, 0, N, splits, 0, 0, 0, E, es_packed,
                            es_a, 0, 0, es_out},
                           bm, ex, 0, 0, 0, 0};
  if (!vlut::decode::gplan_ok(gp, g, 1, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::decode::launch_grouped<5, int8_t, int32_t>(gp, (size_t)smem, s)
                      : vlut::decode::launch_grouped<4, int8_t, int32_t>(gp, (size_t)smem, s));
}

// Blocks of the grouped decode kernel (integer when int_kernel, else fused
// with the given types) that fit on one SM with `smem` dynamic shared
// bytes, or -1 on a CUDA error: the occupancy the grouped plan assumes.
extern "C" int decode_grouped_blocks_per_sm(int g, int int_kernel, int a_bf16, int out_bf16,
                                            long long smem) {
#define VLUT_DECODE_GROUPED_FN(G)                                                               \
  (int_kernel ? (const void*)vlut::decode::decode_grouped_kernel<G, int8_t, int32_t>            \
   : a_bf16   ? (out_bf16 ? (const void*)vlut::decode::decode_grouped_kernel<G, __nv_bfloat16, __nv_bfloat16> \
                          : (const void*)vlut::decode::decode_grouped_kernel<G, __nv_bfloat16, float>)    \
              : (out_bf16 ? (const void*)vlut::decode::decode_grouped_kernel<G, float, __nv_bfloat16>     \
                          : (const void*)vlut::decode::decode_grouped_kernel<G, float, float>))
  const void* fn = g == 5 ? VLUT_DECODE_GROUPED_FN(5) : VLUT_DECODE_GROUPED_FN(4);
#undef VLUT_DECODE_GROUPED_FN
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, vlut::decode::kGThreads,
                                                    (size_t)smem) != cudaSuccess)
    return -1;
  return blocks;
}
