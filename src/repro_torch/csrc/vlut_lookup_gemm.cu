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
// - A single launch is `vlut_kernel` with E = 1 and zero strides.
//
// Grouped launches (`vlut_lookup_gemm_fused_grouped`, and
// `vlut_lookup_gemm_grouped` for the integer twin): E independent products
// of one shape in one launch. The TPU package reaches this kernel under
// `jax.vmap` over a Mixture-of-Experts layer's stacked expert weights
// (src/repro/models/common.py `linear_batched_apply`). They have their own
// kernel, `vlut_grouped_kernel`, and plan (`grouped_lut_plan`).
// What bounds them at MoE shapes (llama4-scout: E 16, M 5120-8192, C 4-64
// rows an expert; deepseek-v3: E 256, C 16) is shared memory, not HBM:
// the codes (E*M*KG bytes) stream once, but every code costs C/4 8-byte
// table reads, and a table of 3^g patterns x C tokens has to be built per
// K-group for every block that reads it. With vlut_kernel's 256-row tiles
// a table row was built about as often as it was read.
// - One table build serves 8 rows a thread at 512 threads: 1,024 rows at
//   C 16, 4,096 at C 4 (a 243-pattern table read 4-16 times a row). The
//   block loops over the expert's K-slice in chunks of 16 K-groups. A
//   larger row tile, not a thread-block cluster sharing one build: the
//   gather is the hot loop and must read the block's own shared memory (a
//   distributed-shared-memory read is far slower than a local one), so a
//   cluster could share only the build, at the price of copying the table
//   into every block; 128 registers a thread and 168 KB of shared memory
//   leave one 512-thread block an SM either way.
// - The sums run in 16-bit lanes, two tokens a 32-bit word: the table is
//   built in the same packed words (word = T[t0] + 65536*T[t1] mod 2^32,
//   linear, so signs need no care), one 32-bit add per two tokens, and the
//   lanes go into int32 sums every kGFlush chunks (48 K-groups x 5 x 128 <
//   2^15 keeps a lane in int16). Exact, like every integer order.
// - The table is [kg][code][token lane][4 tokens] and the token lanes of a
//   row are neighbouring threads, so one code's 32 bytes (C 16) are read
//   by 4 lanes at once: a half-warp's 16 reads fall in 4 random 32-byte
//   slots of a 128-byte line, not in 16 random 8-byte ones.
// - The next chunk's codes (and a_r, or the raw x rows for the fused
//   kernel) are in flight (cp.async, 16, 8 or 4 bytes by the operands'
//   alignment, else byte loads) while this chunk is quantized, built and
//   gathered.
// - The plan splits K (S <= KG/16, splits on 16 K-groups) until the grid
//   fills its last wave of one block an SM to 95%, and a one-chunk segment
//   (the g=4 tails of 2-3 K-groups) runs `ex` experts a block in turn
//   instead of E x M-tiles blocks of one tiny chunk each. Counters and the
//   split-K workspace are per expert, as in vlut_kernel.
// Timing probes on the card (a kernel without its gather, or without its
// build) put most of a launch at deepseek's shapes in the gather's
// shared-memory reads and a small share in the build; the rest is
// barriers, flushes and staging. Moving the codes to conflict-free bank
// slots barely changed the gather, so bank conflicts do not bound it.
// 16-byte table rows (8 tokens a lane, half the load instructions) gained
// little and spilled at 128 registers (PERF.md, section 6).
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
  int32_t* ws;            // (N, M) int32 zeros (one per expert), S > 1 only
  int* counters;          // (E * M-tiles * token tiles,) zeros, S > 1 only
  int M, KG, N, ws_stride;
  long long lda, ldo;
  int bm, splits, chunk;
  // grouped launch: E experts, each operand's stride between experts in
  // its elements (E = 1 and zero strides for a single product)
  int E;
  long long es_packed, es_a, es_a_scale, es_w_scale, es_out;
};

// The operands of expert e: each pointer moved by its expert stride (in
// elements of TA for the activations, TO for the output), the workspace
// by N*M entries and the counters by one expert's tiles.
template <typename TA, typename TO>
__device__ __forceinline__ LutParams expert_params(const LutParams& g, int e, int tiles) {
  LutParams p = g;
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
__global__ void __launch_bounds__(kThreads) vlut_kernel(const LutParams pg) {
  constexpr bool kInt = std::is_same<TA, int8_t>::value;
  constexpr int E = pow3(G);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_scale[kBN];
  __shared__ int s_last;

  // blockIdx.z = expert * S + split
  const int expert = blockIdx.z / pg.splits, split = blockIdx.z - expert * pg.splits;
  const LutParams p = expert_params<TA, TO>(pg, expert, gridDim.x * gridDim.y);

  const int m0 = blockIdx.x * p.bm, n0 = blockIdx.y * kBN;
  const int bmv = min(p.bm, p.M - m0);          // valid rows
  const int nv = min(kBN, p.N - n0);            // valid tokens
  const int tok_lanes = lut_tok_lanes(nv);
  const int lane_shift = tok_lanes == 1 ? 0 : (tok_lanes == 2 ? 1 : 2);
  const int bnt = 4 * tok_lanes;                // table row: tokens
  const int row_lanes = kThreads / tok_lanes;
  const int rpt = (bmv + row_lanes - 1) / row_lanes;   // rows per thread
  const int tl = threadIdx.x / row_lanes, rl = threadIdx.x % row_lanes;
  const int kg_lo = split_bound(split, p.KG, p.splits);
  const int kg_hi = split_bound(split + 1, p.KG, p.splits);
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
  if (bm <= 0 || bm % kLutBMUnit || splits < 1 || splits > KG || chunk < 1) return false;
  if (splits > 65535) return false;                                      // grid z
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
  const dim3 grid((p.M + p.bm - 1) / p.bm, (p.N + kBN - 1) / kBN, p.E * p.splits);
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

// ---------------------------------------------------------------------------
// The grouped kernel (`vlut_lookup_gemm_fused_grouped`,
// `vlut_lookup_gemm_grouped`): the same function as E launches of
// vlut_kernel, with its own geometry for Mixture-of-Experts shapes (design
// note at the head of this file).

constexpr int kGThreads = 512;                // threads of a grouped block
constexpr int kGChunk = 16;                   // K-groups staged and built at a time
constexpr int kGFlush = 3;                    // chunks summed in 16-bit lanes per flush

struct GLutParams {
  LutParams p;
  int ex;                                     // experts per block
  int vw_codes;                               // cp.async bytes of a code copy (16, 8, 4), 0: byte loads
  int vw_acts;                                // the same for the activations
};

// First K-group of split z of S: z*KG/S rounded down to a multiple of 16
// (the plan keeps S <= KG/16), so every chunk starts 16 K-groups from the
// row's start; split S ends at KG. `_group_split_bound` computes the same.
__host__ __device__ inline int gsplit_bound(int z, int KG, int S) {
  return z >= S ? KG : (int)((long long)z * KG / S) & ~(kGChunk - 1);
}

// Dynamic shared memory of one grouped block: the table [chunk][3^g][bnt]
// int16, two stages of codes [bm][16], two stages of activations (fused:
// [bnt][16*g] values of 4 bytes at most; integer: [g][16][bnt] int8) and
// the quantized int8 activations [16*g][bnt]. `grouped_smem_bytes` in
// kernels/vlut_lookup_gemm.py computes the same.
struct GLutLayout {
  size_t codes, codes_buf, stage, stage_row, stage_buf, aq, total;
};
__host__ __device__ inline GLutLayout glut_layout(int g, int bm, int chunk, int bnt) {
  GLutLayout l;
  l.codes = round16((size_t)chunk * pow3(g) * bnt * 2);
  l.codes_buf = (size_t)bm * kGChunk;
  l.stage = l.codes + 2 * l.codes_buf;
  l.stage_row = round16((size_t)kGChunk * g * 4);
  l.stage_buf = (size_t)bnt * l.stage_row;
  l.aq = l.stage + 2 * l.stage_buf;
  l.total = l.aq + round16((size_t)kGChunk * g * bnt);
  return l;
}

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

template <int V, typename Src, typename Dst>
__device__ __forceinline__ void copy_async(int runs, int len, Src src, Dst dst) {
  const int nb = (len + V - 1) / V;
  for (int u = threadIdx.x; u < runs * nb; u += kGThreads) {
    const int r = u / nb, b = u - r * nb;
    cp_async<V>(dst(r) + V * b, src(r) + V * b, min(V, len - V * b));
  }
}

// `runs` runs of `len` bytes, run r from src(r) to dst(r): cp.async copies
// of vw bytes (every source vw-aligned), or byte loads where vw is 0 (the
// copy is then done when the next barrier is passed).
template <typename Src, typename Dst>
__device__ __forceinline__ void stage_runs(int vw, int runs, int len, Src src, Dst dst) {
  switch (vw) {
    case 16: copy_async<16>(runs, len, src, dst); break;
    case 8: copy_async<8>(runs, len, src, dst); break;
    case 4: copy_async<4>(runs, len, src, dst); break;
    default:
      for (int u = threadIdx.x; u < runs * len; u += kGThreads) {
        const int r = u / len, i = u - r * len;
        dst(r)[i] = src(r)[i];
      }
  }
}

template <int G, typename TA, typename TO>
__global__ void __launch_bounds__(kGThreads, 1) vlut_grouped_kernel(const GLutParams gp) {
  constexpr bool kInt = std::is_same<TA, int8_t>::value;
  constexpr int E3 = pow3(G);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_scale[kBN];
  __shared__ int s_last;

  const LutParams& pg = gp.p;
  // blockIdx.z = expert group * S + split
  const int eg = blockIdx.z / pg.splits, split = blockIdx.z - eg * pg.splits;
  const int tiles = gridDim.x * gridDim.y;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int m0 = blockIdx.x * pg.bm, n0 = blockIdx.y * kBN;
  const int bmv = min(pg.bm, pg.M - m0);        // valid rows
  const int nv = min(kBN, pg.N - n0);           // valid tokens
  const int tok_lanes = lut_tok_lanes(nv);
  const int lane_shift = tok_lanes == 1 ? 0 : (tok_lanes == 2 ? 1 : 2);
  const int bnt = 4 * tok_lanes;                // this tile's table row: tokens
  const int row_lanes = kGThreads / tok_lanes;
  const int rpt = (bmv + row_lanes - 1) / row_lanes;   // rows per thread
  // token lanes fastest: the lanes of one row read one code's 8*TL
  // contiguous table bytes
  const int tl = threadIdx.x & (tok_lanes - 1), rl = threadIdx.x >> lane_shift;
  const int kg_lo = gsplit_bound(split, pg.KG, pg.splits);
  const int kg_hi = gsplit_bound(split + 1, pg.KG, pg.splits);
  const int nchunks = (kg_hi - kg_lo + kGChunk - 1) / kGChunk;
  const GLutLayout lay = glut_layout(G, pg.bm, pg.chunk, 4 * lut_tok_lanes(min(pg.N, kBN)));
  unsigned char* lut = smem;
  int8_t* aq = reinterpret_cast<int8_t*>(smem + lay.aq);
  const int code_bytes = 8 * tok_lanes;         // table bytes of one code
  const int kg_bytes = E3 * code_bytes;         // table bytes of one K-group

  // tokens nv..bnt of the staged a_r (integer) or of aq (fused) are never
  // written: zero them once
  for (int i = threadIdx.x; i < (int)(lay.total - lay.stage); i += kGThreads) smem[lay.stage + i] = 0;

  for (int ei = 0; ei < gp.ex; ++ei) {
    const int expert = eg * gp.ex + ei;
    if (expert >= pg.E) break;
    const LutParams p = expert_params<TA, TO>(pg, expert, tiles);
    __syncthreads();                            // the last expert's epilogue is done
    if constexpr (!kInt) load_token_scales(p.a_scale, p.N, n0, s_scale);

    // chunk i's codes and activations into stage i & 1 (then committed)
    auto stage = [&](int i) {
      const int c0 = kg_lo + i * kGChunk, nkc = min(kGChunk, kg_hi - c0), buf = i & 1;
      unsigned char* cdst = smem + lay.codes + buf * lay.codes_buf;
      stage_runs(
          gp.vw_codes, bmv, nkc, [&](int r) { return p.packed + (long long)(m0 + r) * p.KG + c0; },
          [&](int r) { return cdst + r * kGChunk; });
      unsigned char* adst = smem + lay.stage + buf * lay.stage_buf;
      if constexpr (kInt) {
        // a_r[j, c0 + kg, n0:n0+nv] -> [j][kg][bnt]
        const int8_t* a_r = static_cast<const int8_t*>(p.a);
        stage_runs(
            gp.vw_acts, G * nkc, nv,
            [&](int r) {
              const int j = r / nkc, kg = r - j * nkc;
              return reinterpret_cast<const unsigned char*>(a_r) +
                     ((long long)j * p.KG + c0 + kg) * p.N + n0;
            },
            [&](int r) {
              const int j = r / nkc, kg = r - j * nkc;
              return adst + (j * kGChunk + kg) * bnt;
            });
      } else {
        // each token's K run, raw: x[n0 + n, c0*G : (c0 + nkc)*G] -> row n
        const TA* x = static_cast<const TA*>(p.a);
        stage_runs(
            gp.vw_acts, nv, nkc * G * (int)sizeof(TA),
            [&](int n) {
              return reinterpret_cast<const unsigned char*>(x + (long long)(n0 + n) * p.lda + (long long)c0 * G);
            },
            [&](int n) { return adst + n * lay.stage_row; });
      }
      cp_async_commit();
    };

    int acc[kMaxRowsPerThread][kTokPerThread] = {};
    // 16-bit lanes, two tokens a word: the table's words add without
    // carries between the lanes as long as each lane's sum stays in int16
    // (|T| <= 5*128, kGFlush*kGChunk = 48 K-groups a flush)
    uint32_t pk[kMaxRowsPerThread][2] = {};

    if (nchunks > 0) stage(0);
    for (int i = 0; i < nchunks; ++i) {
      const int c0 = kg_lo + i * kGChunk, nkc = min(kGChunk, kg_hi - c0), buf = i & 1;
      cp_async_wait_all();
      __syncthreads();                          // chunk i has landed; chunk i - 1 is done
      if (i + 1 < nchunks) stage(i + 1);        // in flight during this chunk's work
      const unsigned char* st = smem + lay.stage + buf * lay.stage_buf;
      if constexpr (!kInt) {
        // quantize (f32 cast first, IEEE division, round half to even,
        // clip +-127) into aq[k * bnt + n]; tokens nv..bnt stay 0
        const TA* raw = reinterpret_cast<const TA*>(st);
        const int kk = nkc * G, rs = (int)(lay.stage_row / sizeof(TA));
        for (int u = threadIdx.x; u < kk * nv; u += kGThreads) {
          const int n = u / kk, k = u - n * kk;
          aq[k * bnt + n] = static_cast<int8_t>(
              fminf(fmaxf(rintf(to_f32(raw[n * rs + k]) / s_scale[n]), -127.f), 127.f));
        }
        __syncthreads();
      }
      // table build, as vlut_kernel's with two tokens per 32-bit word:
      // item (kg, low pattern el, token lane q), q fastest so that the
      // 8-byte stores of a warp are consecutive. Word = T[t0] + 65536 *
      // T[t1] mod 2^32, exact for any signs.
      for (int u = threadIdx.x; u < nkc * kLowE * tok_lanes; u += kGThreads) {
        const int q = u & (tok_lanes - 1), rest = u >> lane_shift;
        const int el = rest % kLowE, kg = rest / kLowE;
        uint32_t d0[G], d1[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const int8_t* col = kInt ? reinterpret_cast<const int8_t*>(st) + (j * kGChunk + kg) * bnt
                                   : aq + (kg * G + j) * bnt;
          const char4 x = *reinterpret_cast<const char4*>(col + q * kTokPerThread);
          d0[j] = (uint32_t)(int)x.x + ((uint32_t)(int)x.y << 16);
          d1[j] = (uint32_t)(int)x.z + ((uint32_t)(int)x.w << 16);
        }
        const uint32_t s0 = (uint32_t)(el % 3 - 1), s1 = (uint32_t)(el / 3 % 3 - 1),
                       s2 = (uint32_t)(el / 9 - 1);
        const uint32_t l0 = s0 * d0[0] + s1 * d0[1] + s2 * d0[2];
        const uint32_t l1 = s0 * d1[0] + s1 * d1[1] + s2 * d1[2];
        uint2* row = reinterpret_cast<uint2*>(lut + (size_t)kg * kg_bytes) + el * tok_lanes + q;
#pragma unroll
        for (int eh = 0; eh < E3 / kLowE; ++eh) {
          uint32_t v0 = l0, v1 = l1;
#pragma unroll
          for (int j = 3; j < G; ++j) {
            const int d = eh / pow3(j - 3) % 3 - 1;
            if (d > 0) {
              v0 += d0[j];
              v1 += d1[j];
            } else if (d < 0) {
              v0 -= d0[j];
              v1 -= d1[j];
            }
          }
          row[kLowE * eh * tok_lanes] = make_uint2(v0, v1);
        }
      }
      __syncthreads();
      // gather: a word of codes (4 K-groups) per row, then for each
      // K-group every row's 8-byte lookup, rows innermost (independent
      // loads and sums)
      const unsigned char* cb = smem + lay.codes + buf * lay.codes_buf;
      const unsigned char* tb = lut + tl * 8;
#pragma unroll
      for (int w = 0; w < kGChunk / 4; ++w) {
        if (4 * w >= nkc) break;
        uint32_t cw[kMaxRowsPerThread];
#pragma unroll
        for (int r = 0; r < kMaxRowsPerThread; ++r) {
          if (r < rpt) cw[r] = *reinterpret_cast<const uint32_t*>(
                           cb + min(r * row_lanes + rl, bmv - 1) * kGChunk + 4 * w);
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (4 * w + b >= nkc) break;
          const unsigned char* base = tb + (4 * w + b) * kg_bytes;
#pragma unroll
          for (int r = 0; r < kMaxRowsPerThread; ++r) {
            if (r < rpt) {
              const uint32_t c = __byte_perm(cw[r], 0, 0x4440 | b);
              const uint2 t = *reinterpret_cast<const uint2*>(base + c * code_bytes);
              pk[r][0] += t.x;
              pk[r][1] += t.y;
            }
          }
        }
      }
      if (i % kGFlush == kGFlush - 1 || i + 1 == nchunks) {
        // the 16-bit lanes into the int32 sums
#pragma unroll
        for (int r = 0; r < kMaxRowsPerThread; ++r) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lo = (int)(int16_t)(pk[r][h] & 0xffffu);
            acc[r][2 * h] += lo;
            acc[r][2 * h + 1] += (int)(pk[r][h] - (uint32_t)lo) >> 16;
            pk[r][h] = 0;
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
    if (p.splits == 1) continue;

    // split-K combine: the last block of this expert's output tile to
    // arrive writes it (as vlut_kernel's)
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
    __syncthreads();
    if (!s_last) continue;
    __threadfence();
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
    for (int i0 = 0; i0 < total; i0 += kCombineBatch * kGThreads) {
      int v[kCombineBatch];                     // all loads in flight first
#pragma unroll
      for (int b = 0; b < kCombineBatch; ++b) {
        int nl, ml;
        if (locate(i0 + b * kGThreads + threadIdx.x, nl, ml)) {
          v[b] = __ldcg(p.ws + (long long)(n0 + nl) * p.M + m0 + ml);
        }
      }
#pragma unroll
      for (int b = 0; b < kCombineBatch; ++b) {
        int nl, ml;
        if (!locate(i0 + b * kGThreads + threadIdx.x, nl, ml)) continue;
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
}

// The grouped plan's checks, as plan_ok's for the single one: the C entry
// refuses a plan whose geometry or shared memory it would size otherwise.
inline bool gplan_ok(const GLutParams& gp, int g, long long smem) {
  const LutParams& p = gp.p;
  if (p.M <= 0 || p.N <= 0 || p.KG <= 0 || (g != 4 && g != 5) || p.E < 1) return false;
  if (p.bm <= 0 || p.bm % kLutBMUnit || p.splits < 1) return false;
  if (p.splits > (p.KG / kGChunk > 1 ? p.KG / kGChunk : 1)) return false;
  if (p.chunk != (p.KG < kGChunk ? p.KG : kGChunk)) return false;
  if (gp.ex < 1 || gp.ex > p.E) return false;
  if ((long long)((p.E + gp.ex - 1) / gp.ex) * p.splits > 65535) return false;   // grid z
  if ((p.N + kBN - 1) / kBN > 65535) return false;
  if (p.splits > 1 && (p.ws == nullptr || p.counters == nullptr)) return false;
  const int bnt = 4 * lut_tok_lanes(p.N < kBN ? p.N : kBN);
  if (p.bm * bnt > kMaxRowsPerThread * kGThreads * 4) return false;
  const size_t want = glut_layout(g, p.bm, p.chunk, bnt).total;
  return smem >= 0 && (size_t)smem == want && want <= kMaxSmem;
}

// The widest cp.async (16, 8 or 4 bytes) that every copy of a run can use:
// the base pointer and both strides (in bytes) multiples of it; 0: none.
inline int copy_width(const void* ptr, long long s1, long long s2) {
  for (int v = 16; v >= 4; v /= 2) {
    if ((uintptr_t)ptr % v == 0 && s1 % v == 0 && s2 % v == 0) return v;
  }
  return 0;
}

template <int G, typename TA, typename TO>
cudaError_t launch_grouped(const GLutParams& gp, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(vlut_grouped_kernel<G, TA, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const LutParams& p = gp.p;
  const dim3 grid((p.M + p.bm - 1) / p.bm, (p.N + kBN - 1) / kBN,
                  (p.E + gp.ex - 1) / gp.ex * p.splits);
  vlut_grouped_kernel<G, TA, TO><<<grid, kGThreads, smem, stream>>>(gp);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_grouped_types(const GLutParams& gp, size_t smem, int a_bf16, int out_bf16,
                                 cudaStream_t stream) {
  if (a_bf16) {
    return out_bf16 ? launch_grouped<G, __nv_bfloat16, __nv_bfloat16>(gp, smem, stream)
                    : launch_grouped<G, __nv_bfloat16, float>(gp, smem, stream);
  }
  return out_bf16 ? launch_grouped<G, float, __nv_bfloat16>(gp, smem, stream)
                  : launch_grouped<G, float, float>(gp, smem, stream);
}

}  // namespace vlut

// The C entries of the vector-LUT kernels. Beside the mpGeMM contracts of
// mpgemm_common.cuh they take the launch plan (rows per block bm, K-splits,
// K-groups per chunk, dynamic shared bytes) and, for splits > 1, a zeroed
// int32 workspace of at least N*M entries (E*N*M grouped) and zeroed
// counters, one per (M-tile, token tile) (and expert), both left zeroed
// again. Each launches on `stream` and returns a cudaError_t
// (cudaErrorInvalidValue for a plan it refuses).
#define VLUT_LUT_ENTRY_ARGS                                                        \
  const void *packed, const void *a, const void *a_scale, const void *w_scale,     \
      void *out, void *ws, void *counters, int M, int KG, int N, int g,            \
      long long lda, long long ldo, int ws_stride, int a_bf16, int out_bf16,       \
      int bm, int splits, int chunk, long long smem, void *stream
#define VLUT_LUT_GROUPED_ENTRY_ARGS                                                \
  const void *packed, const void *a, const void *a_scale, const void *w_scale,     \
      void *out, void *ws, void *counters, int M, int KG, int N, int g,            \
      long long lda, long long ldo, int ws_stride, int a_bf16, int out_bf16,       \
      int E, long long es_packed, long long es_a, long long es_a_scale,            \
      long long es_w_scale, long long es_out, int bm, int splits, int chunk,       \
      int ex, long long smem, void *stream
#define VLUT_LUT_INT_ENTRY_ARGS                                                    \
  const void *packed, const void *a_r, void *out, void *ws, void *counters,       \
      int M, int KG, int N, int g, int bm, int splits, int chunk, long long smem,  \
      void *stream
#define VLUT_LUT_INT_GROUPED_ENTRY_ARGS                                            \
  const void *packed, const void *a_r, void *out, void *ws, void *counters,       \
      int M, int KG, int N, int g, int E, long long es_packed, long long es_a,     \
      long long es_out, int bm, int splits, int chunk, int ex, long long smem,     \
      void *stream

extern "C" int vlut_lookup_gemm_fused(VLUT_LUT_ENTRY_ARGS) {
  const vlut::LutParams p{(const uint8_t*)packed, a, (const float*)a_scale,
                          (const float*)w_scale, out, (int32_t*)ws, (int*)counters,
                          M, KG, N, ws_stride, lda, ldo, bm, splits, chunk, 1, 0, 0, 0, 0, 0};
  if (!vlut::plan_ok(M, KG, N, g, bm, splits, chunk, smem, ws, counters))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::launch_lut_types<5>(p, (size_t)smem, a_bf16, out_bf16, s)
                      : vlut::launch_lut_types<4>(p, (size_t)smem, a_bf16, out_bf16, s));
}

// The grouped fused entry: E products of one shape in one launch, expert e
// reading packed + e*es_packed (M, KG), a + e*es_a (N rows of stride lda),
// a_scale + e*es_a_scale (N,), w_scale + e*es_w_scale and writing out +
// e*es_out (N rows of stride ldo); strides in elements. Its plan is the
// grouped one (`grouped_lut_plan`: bm, splits, chunk, ex experts a block).
extern "C" int vlut_lookup_gemm_fused_grouped(VLUT_LUT_GROUPED_ENTRY_ARGS) {
  if (es_packed < 0 || es_a < 0 || es_a_scale < 0 || es_w_scale < 0 || es_out < 0)
    return (int)cudaErrorInvalidValue;
  const long long elem = a_bf16 ? 2 : 4;
  const vlut::GLutParams gp{
      {(const uint8_t*)packed, a, (const float*)a_scale, (const float*)w_scale, out,
       (int32_t*)ws, (int*)counters, M, KG, N, ws_stride, lda, ldo, bm, splits, chunk, E,
       es_packed, es_a, es_a_scale, es_w_scale, es_out},
      ex, vlut::copy_width(packed, KG, es_packed), vlut::copy_width(a, lda * elem, es_a * elem)};
  if (!vlut::gplan_ok(gp, g, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::launch_grouped_types<5>(gp, (size_t)smem, a_bf16, out_bf16, s)
                      : vlut::launch_grouped_types<4>(gp, (size_t)smem, a_bf16, out_bf16, s));
}

extern "C" int vlut_lookup_gemm(VLUT_LUT_INT_ENTRY_ARGS) {
  const vlut::LutParams p{(const uint8_t*)packed, a_r, nullptr, nullptr, out, (int32_t*)ws,
                          (int*)counters, M, KG, N, 0, 0, N, bm, splits, chunk, 1, 0, 0, 0, 0, 0};
  if (!vlut::plan_ok(M, KG, N, g, bm, splits, chunk, smem, ws, counters))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::launch_lut<5, int8_t, int32_t>(p, (size_t)smem, s)
                      : vlut::launch_lut<4, int8_t, int32_t>(p, (size_t)smem, s));
}

// The grouped integer entry: E products of one shape in one launch, expert
// e reading packed + e*es_packed (M, KG) and a_r + e*es_a (g, KG, N) and
// writing out + e*es_out (M, N); strides in elements. The unfused
// pipeline's middle pass over a MoE layer's stacked experts.
extern "C" int vlut_lookup_gemm_grouped(VLUT_LUT_INT_GROUPED_ENTRY_ARGS) {
  if (es_packed < 0 || es_a < 0 || es_out < 0) return (int)cudaErrorInvalidValue;
  const vlut::GLutParams gp{
      {(const uint8_t*)packed, a_r, nullptr, nullptr, out, (int32_t*)ws, (int*)counters, M, KG,
       N, 0, 0, N, bm, splits, chunk, E, es_packed, es_a, 0, 0, es_out},
      ex, vlut::copy_width(packed, KG, es_packed), vlut::copy_width(a_r, N, es_a)};
  if (!vlut::gplan_ok(gp, g, smem)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(g == 5 ? vlut::launch_grouped<5, int8_t, int32_t>(gp, (size_t)smem, s)
                      : vlut::launch_grouped<4, int8_t, int32_t>(gp, (size_t)smem, s));
}

// Blocks of the grouped kernel (integer when int_kernel, else fused with
// the given types) that fit on one SM with `smem` dynamic shared bytes,
// or -1 on a CUDA error: the occupancy the grouped plan assumes.
extern "C" int vlut_grouped_blocks_per_sm(int g, int int_kernel, int a_bf16, int out_bf16,
                                          long long smem) {
  const void* fn;
#define VLUT_GROUPED_FN(G)                                                                       \
  (int_kernel ? (const void*)vlut::vlut_grouped_kernel<G, int8_t, int32_t>                       \
   : a_bf16   ? (out_bf16 ? (const void*)vlut::vlut_grouped_kernel<G, __nv_bfloat16, __nv_bfloat16> \
                          : (const void*)vlut::vlut_grouped_kernel<G, __nv_bfloat16, float>)    \
              : (out_bf16 ? (const void*)vlut::vlut_grouped_kernel<G, float, __nv_bfloat16>     \
                          : (const void*)vlut::vlut_grouped_kernel<G, float, float>))
  fn = g == 5 ? VLUT_GROUPED_FN(5) : VLUT_GROUPED_FN(4);
#undef VLUT_GROUPED_FN
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, vlut::kGThreads, (size_t)smem) !=
      cudaSuccess)
    return -1;
  return blocks;
}
