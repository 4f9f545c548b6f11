#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. device: the card's name and power limit (nvidia-smi).
2. build: compile every CUDA kernel from `csrc/` (one nvcc per source, in
   parallel); each grouped vector-LUT and grouped decode instantiation's
   registers, spills (must be 0) and blocks an SM at the main path's
   largest shared bytes (the CUDA runtime's occupancy, at least the plan's
   one) are logged.
3. kernels: each fused mpGeMM kernel against its plain PyTorch version on
   the card, at the BitLinear shapes of smollm-360m (M, K) in {(960, 960),
   (320, 960), (2560, 960), (960, 2560)} plus a mixed g=5/g=4 shape
   (K = 964), N in {1, 4, 16, 64, 256} tokens, for f32->f32, bf16->bf16 and
   bf16->f32 (activation->output). Expected difference: exactly 0 (the
   integer core is exact in both, and the f32 epilogue is the same
   operations in the same order). Each fused kernel's split-K traps (both
   launch plans split K across blocks that meet in one shared int32
   workspace with arrival counters): ragged shapes (M 70 and 1000, N 17
   and 33, KG not divisible by the plan's splits, the g=4 segment of one
   K-group), the saturated sum 127*K at the main path's largest split of
   that kernel's plan, every case launched twice back to back with the
   others (bit-equal), and a CUDA graph of all of them replayed 3 times;
   expected difference exactly 0. Each shape's plans (vector-LUT: BM, S,
   chunk, blocks, shared bytes; decode: BM x BN, S, K-groups per step,
   alignment, blocks, shared bytes) and each instantiation's registers and
   spills (-Xptxas -v) are logged. Then the device time of one forward's 224
   launches at each N, beside the bound, the plain version's time and a
   bf16 `torch.matmul` against the dequantized weights (a yardstick only:
   the port never calls it).
4. serve: smollm-360m at full width in bf16 (random weights from a seeded
   generator on the card, packed by `pack_params`), an Engine with 4 slots
   and max_len 256 serving 8 greedy requests (prompts of 16-64 tokens, 16
   new tokens each), once with impl="decode" and once with impl="lookup".
   Checks: every request completes; each kernel was launched exactly 224
   times per forward (32 layers x 7 BitLinears) in its run and never in the
   other (nor any integer kernel), counted by the wrappers and, equal, by
   the kernel records of a device-only trace of the run (graph replays
   included: these are the kernels line's `launches`; every serving run of
   phases 5-21 holds its counts to such a trace too); both runs emit the
   same greedy tokens;
   the prefill logits of one prompt on the card agree with the same
   weights run on the CPU (plain path) within a stated bf16 tolerance.
5. unfused: the unfused pipeline (quantize into int8, de-interleave copy,
   integer kernel into int32 (M, N), dequant), on phase 4's model.
   (a) Each integer kernel (`ternary_decode_gemm`, `vlut_lookup_gemm`)
   against its plain version at the shapes and N of phase 3, plus the
   saturated case (all +1 weights, activations 127: every sum 127*K at
   K = 2560 and 960), and both integer kernels' split-K traps as in phase 3.
   Expected difference: exactly 0. (b) `vlut_mpgemm`
   fused against unfused, both impls: bit-identical on one segment, within
   1e-6 of the output's magnitude at K = 964. (c) Serving as in phase 4
   with `Engine(mpgemm_fusion="unfused")`, once per impl: that impl's
   integer kernel launched exactly 224 times per forward and no other
   mpGeMM kernel, every request completed, the greedy tokens of phase 4.
   (d) Device time per 224-launch forward at each N: each integer kernel
   beside its bound (bytes of packed weights, int8 activations and int32
   output vs int8 operations), its plain version, and `torch._int_mm` on
   the unpacked int8 weights where its shape rules hold (N > 16), else
   phase 3's bf16 `torch.matmul` (yardsticks only: the port never calls
   them); the whole fused and unfused pipelines through `ternary_matmul`
   (the paper's §3.3 fusion ablation), and the bytes fusion avoids. (e)
   The paper's comparison at (M, K) = (2560, 960), N in {1, 4, 16, 64,
   256}: `vlut_gemm` (Algorithm 1 in plain PyTorch), `scalar_lut_gemm`,
   `mad_gemm`, `mad_gemm_int8` and both pipelines of both kernels, each
   checked against `ref_mpgemm` (exact; `mad_gemm`, which skips activation
   quantization, within the JAX suite's rtol 0.1 / atol 0.15) and timed;
   the winner per N.
6. flash: the flash-attention kernel against its plain PyTorch version on
   the card (bf16 with D <= 128 runs the tensor-core kernel, f32 the
   CUDA-core one): smollm-360m's heads (H 15, KV 5, D 64) and odd ones (D
   20, 32, 128; H/KV 1 and 3), S in {1, 17, 256, 512, 2048}, causal or
   not, window 0 or 24, softcap 0 or 20, f32 and bf16, q/k/v read as
   transposed views of the model's (B, S, H, D) tensors. The tensor-core
   kernel's traps, each against the plain version: S 2048 causal with
   window 24 (key tiles skipped at both ends of a query tile's range), the
   contiguous (B, H, S, D) layout, two launches back to back with no sync
   between (and a repeat launch bit-equal to the first), and a CUDA graph
   of the training-shape launch replayed 3 times with new inputs copied in
   before each replay. Each kernel's registers, spills and shared memory
   (-Xptxas -v) are logged. Then the gradients of
   `flash_attention_trainable` against autograd through the plain version,
   and the device time at the training shape (B 8, S 512, causal, bf16)
   beside the bound, the plain version, the f32 kernel at the same shape
   and `scaled_dot_product_attention` (a yardstick only: the port never
   calls it).
7. train: smollm-360m at full width and depth in bf16 with
   attn_impl="flash" and per-layer remat, random weights from a seeded
   generator on the card, 30 QAT steps of B 8 x S 512 on the synthetic
   bigram data (AdamW, lr 3e-4, warmup 5, int8/bf16 moments) through
   `train.Trainer`. (At lr 3e-3 the full-width model's loss rises from the
   6th step on: Adam moves every element of the tied 49152 x 960 table by
   ~lr per step, 15% of its 0.02 init scale.) Checks: every loss finite, the last below the first;
   the flash kernel launched 64 times per step (32 layers x 2: remat runs
   each layer's forward again in backward) and no mpGeMM kernel; the
   checkpoint written at the last step resumes a second Trainer there with
   the same weights; the loss of one sequence on the card agrees with the
   CPU plain path on the same weights, before and after training. Then
   one step under torch.profiler, the device traced alone (device-busy
   share).

8. multi-token serving, run after phase 5 on phase 4's model and prompts
   (4 slots, max_len 256, 16 new tokens). (a) Both fused kernels against
   their plain versions at the five shapes of phase 3 with N in {20, 60}
   (4 slots x (k+1) for chain k 4, 4 x 15 nodes for tree (2, 2); ragged
   across the plans' token tiles), as in phase 3: expected difference
   exactly 0. (b) After a prefill of one prompt, `verify_step` over k+1 = 5
   tokens against 5 `decode_step` calls (logits within VERIFY_RTOL of the
   largest, idx equal), and a tree verify of (2, 2) against the sequential
   decode of each root-to-leaf path; each once more with a fault planted
   (causal mask, ancestor gate dropped) that must read above the bound.
   (c) Nine serving runs, greedy unless named, impl="decode" unless named:
   chunked prefill (chunk 64), chunked with token_budget 96, chain
   speculation k 4 with the n-gram drafter, with the self-drafting oracle
   ModelDrafter, adaptive K, tree (2, 2), chunked + chain, chain with impl="lookup", and the stochastic oracle at
   temperature 0.8. Each run's counts are zeroed just before it; it must
   launch its kernel exactly 224 times per forward (target and drafter
   forwards, counted through `lm_hidden`) and no other kernel, complete
   every request, and (greedy) emit phase 4's tokens, or leave them only
   at a near-tie (TIE_RTOL of the largest whole-prompt logit at the first
   divergent step, logged); the oracle must accept at least 0.9 of its
   drafts. Logged per run: decode tok/s and TTFT p50 on host clocks
   (ServeStats, whole run), tokens and nodes per step, acceptance, mean
   draft k, chunk steps, and the token counts N the mpGeMM launches saw.
   Then one chain and one tree step of 4 full slots under torch.profiler
   (device time by kernel, busy share; the device traced alone).
9. paged: the paged KV cache (`Engine(paged_kv=PagedKVConfig(...))`, page
   size 16) on phase 4's model, 4 slots and max_len 256, 16 new tokens,
   after phase 8. Every run's counts are zeroed just before it; it must
   launch its fused kernel exactly 224 times per forward and no other
   mpGeMM kernel, complete every request, and emit its reference's greedy
   tokens, or leave them only at a near-tie (TIE_RTOL, as phase 8: paged
   admission attends the prompt's K/V from the bf16 cache, as chunked
   prefill does). (a) Phase 4's prompts with impl="decode" and "lookup";
   reference: phase 4's tokens. (b) Chunk 64 with chain k 4 (n-gram), and
   tree (2, 2) (compaction through the block table); reference: phase 8's
   matching dense runs. (c) Prefix sharing: 8 requests of a common
   128-token system prompt (8 full pages) plus 8-32 unique tokens each,
   served dense and then paged; reference: the dense run's tokens; at
   least one request must hit the radix index, and the paged run's
   prefill tokens must equal the dense run's minus its prefix-hit tokens.
   Logged: TTFT p50 of both runs and the admission time of requests with
   and without a hit. (d) The offload tier: 1 slot, 17 pages (16
   allocatable) and a 64-page host tier, prompts p1, p2, p1 of 128 tokens:
   each request reserves 9 pages, so p2's admission pages p1's prefix out
   and the second p1 pages it back in; reference: the dense run's tokens;
   the pages paged out and in must equal what the host `Pager` decides
   for the same admissions and releases. (e) One paged decode step of 4
   full slots under torch.profiler beside phase 4's dense step: device ms,
   busy share, and the device time of the gathers (`aten::index`: the
   `page_view` reads) and the scatters (`aten::index_put_`).
10. moe: the MoE FFN on `llama4-scout-17b-a16e` at its published widths
   (d 5120, 40/8 heads, 16 experts top-1 + 1 shared, d_ff 8192, vocab
   202048, bf16), depth cut from 48 to 12 layers (the script's time limit:
   48 packed layers, ~25 GB, fit the card), random weights from a seeded
   generator on the card, built and packed layer by layer
   (`init_lm(packed=True)`: the dense bf16 weights of all 48 layers,
   ~211 GB, would not fit), after phase 9 (phase 4's model freed first).
   (a) Both grouped kernels (`ternary_decode_gemm_fused_grouped`,
   `vlut_lookup_gemm_fused_grouped`: 16 experts of one shape in one
   launch) at layer 0's expert weights (w1: M 8192, K 5120, all g=5; w2: M
   5120, K 8192 = 1636 g=5 + 3 g=4 groups, so both segments run), C in
   {4, 16, 64} rows per expert with a zero
   padding row (its output must be 0), bf16 (and f32 at C 16), against
   their plain versions and 16 single launches: expected difference 0;
   grouped split-K traps (odd E, M off the tiles, C 5 and 17) launched
   twice and replayed 3 times in a CUDA graph. (b) Device ms per grouped
   launch at C 4 and 16 beside the bound (bytes / 3.35 TB/s), 16 single
   launches, the plain version (eager) and a bf16 `torch.bmm` against the
   dequantized experts (a yardstick only). (c) Serving 8 greedy requests
   (prompts 16-64, 16 new tokens, 4 slots) with impl="decode" and
   "lookup" (identical tokens), then chunk 64 + chain k 4 (n-gram; the
   verify steps' grouped launches see C = 16): each run's counts zeroed
   just before it, 8 single and 4 grouped launches per layer per forward
   and no other mpGeMM kernel, every request completed; one prefill's
   logits through the kernels against the same prefill through their plain
   versions (MOE_LOGIT_RTOL). (d) One decode step of 4 full slots under
   torch.profiler, and layer 0's MoE FFN at 4 tokens timed whole and as
   its expert compute alone: the dispatch's device share of a step.
   Phase 10 (a) also holds the two grouped integer kernels
   (`ternary_decode_gemm_grouped`, `vlut_lookup_gemm_grouped`: the
   unfused pipeline's middle pass over the experts) at the same weights,
   C and padding rows (the rows quantized and de-interleaved as the
   pipeline does) against their plain versions and 16 single integer
   launches, and at the same split-K traps (launched twice, 3 graph
   replays): expected difference 0; and both grouped vector-LUT kernels at
   their plan's geometry traps (LUT_GEOMETRY_TRAPS: E x tiles just over a
   wave, several experts a block, M 70 and 1000, KG 1-77, C 1-64, g 4 and
   5), each at E and E - 1 experts, launched twice back to back and
   replayed 3 times in a CUDA graph, against their plain versions and E
   single launches (`geometry_traps`); the same for both grouped decode
   kernels at DECODE_GEOMETRY_TRAPS (16 experts: K split 2 and 8 ways with
   a zero K-slice beside nonzero ones, an all-zero expert). Phase 10 (b)
   also times the grouped integer kernels per linear beside 16 single
   launches and logs every grouped launch's plan (lookup: BM, K-splits,
   experts a block; decode: BM, K-splits, experts a block, stagings).
11. mla: the MLA mixer on `deepseek-v3-671b` at its published widths (d
   7168, 128 heads, q/kv latent ranks 1536/512, rope 64, 256 experts top-8
   + 1 shared, d_ff 2048 and 18432 dense, vocab 129280, bf16), depth cut
   from 61 to 8 layers (its 3 dense + 5 MoE; 61 layers, ~138 GB packed, do
   not fit the card, and the script's time limit allows 8), random
   weights from a seeded generator on the card, drawn and packed layer by
   layer, after phase 10 (its model freed first). (a) All four grouped
   kernels (fused and integer, both impls) at the first MoE layer's
   expert weights (E 256; w1 M 2048, K 7168 = 1432 g=5 + 2 g=4 groups; w2
   M 7168, K 2048 = 408 + 2), C 16, bf16, a zero padding row, against
   their plain versions (16 experts at a time): expected difference 0; the
   grouped vector-LUT geometry traps at 256 experts
   (LUT_GEOMETRY_TRAPS_E256) and the grouped decode ones
   (DECODE_GEOMETRY_TRAPS_E256: several experts a block, 133 experts just
   over a wave), as phase 10's.
   (b) Device ms per linear's grouped launches (their plans logged) and
   per layer's 6, beside the bound (bytes /
   3.35 TB/s), 256 single launches, the plain version (eager), a decode
   step's rows (32 real, the rest 0) and a bf16 `torch.bmm` yardstick.
   The batched unfused pipeline against the fused one on the same rows
   (one bf16 ulp: fused sums each segment in f32, unfused in int32). For
   both grouped decode kernels (`decode_levers`): each of the layer's 6
   launches timed apart, the layer on a decode step's rows beside the
   bound of the codes of the experts that hold a row, and the layer with
   each of DECODE_LEVERS changed alone, on both kinds of rows.
   (c) Serving 8 greedy requests (prompts 16-64, 16 new tokens, 4 slots):
   impl="decode" and "lookup" (identical tokens), unfused with both impls
   (identical tokens; where they leave the fused run's, the divergence is
   replayed under both pipelines and must be a near-tie or follow a MoE
   routing flip: a bf16 rounding can move a token across a router top-k
   boundary), chunk 64 + chain k 4, and paged (page 16)
   whole-prompt; each run's counts zeroed just before it and checked per
   forward (14 single launches a layer and 6 grouped a MoE layer; 2 more
   single a layer where the forward expands `wkv_b`: prefill and the
   chunk steps' resume reads), no other mpGeMM kernel, every request
   completed; one prefill's logits through the kernels against their
   plain versions, fused and unfused (MOE_LOGIT_RTOL). (d) One decode
   step of 4 full slots
   under torch.profiler: wall and device ms, busy share, the device ms
   of one layer's `wkv_b` unpack (to f32, every layer and step) and of
   the MoE dispatch.

12. ssm: the SSM mixer on `mamba2-1.3b` at its published widths and
   depth, no cut (48 layers, d 2048, d_inner 4096, 64 heads x 64, d_state
   128, chunk 64, vocab 50280, bf16, tied head), random weights drawn and
   packed layer by layer, after phase 11 (its model freed first). (a)
   Kernels #1-#4 against their plain versions at in_proj (M 8512, K 2048 =
   408 g=5 + 2 g=4 groups) and out_proj (M 2048, K 4096 = 816 + 4), N in
   {1, 4, 17, 61, 200}: expected difference 0; one forward's 192 launches
   timed at N 4 beside the bound, the plain versions and a bf16 matmul.
   (b) Serving 8 greedy requests (6 prompts of 16-64 tokens, two of
   150-250: more than one chunk, a padded last chunk; exact-length
   admission), 4 slots, 16 new tokens: fused decode, fused lookup
   (identical tokens) and unfused decode (identical, or leaving them where
   a replay under both pipelines shows a near-tie, or a gap inside
   the pipelines' difference, itself no larger than the fused pipeline's
   distance to an f32 copy of the model); one
   prefill's logits through the kernels against their plain versions,
   fused and unfused (MOE_LOGIT_RTOL). (c) prefill(n - 1) + decode_step
   against one prefill of n (SSM_DECODE_TOL), and the chunked scan at full
   width against the f64 recurrence (SSM_SCAN_TOL); the model's rounding
   sensitivity (fused and unfused, bf16 and an f32 copy, at 2, 8 and 48
   layers). (d) 4 launches a
   layer, 192 a forward, no other mpGeMM kernel, in every run. (e) One
   decode step of 4 full slots under torch.profiler; one SSM layer's own
   ops (conv, recurrence, gated norm) against its two BitLinears, beside
   the f32 state's and the codes' bytes; the f32 head alone. (f) decode
   tok/s and TTFT p50 of each run.
13. windowed: `gemma3-1b` at its published widths and depth, no cut (26
   layers, d 1152, 4 heads / 1 KV head of 256, d_ff 6912, vocab 262144,
   window 512 on 5 of every 6 layers, dual RoPE, q/k norms, embedding
   scale, tied head), after phase 12 (its model freed first). (a) Kernels
   #1-#4 at its five BitLinear shapes (g=4 segments of 3 and 1 K-groups,
   M 256 to 6912), as phase 12 (a), 364 launches a forward timed. (b)
   Serving as phase 12 (b) with max_len 1024 and two prompts of 600-700
   tokens (the ring of 512 wraps in prefill and in decode). (c) After the
   ring has wrapped, a decode step's logits against a cache-free forward
   of the same sequence (RING_RTOL); the rounding sensitivity as phase
   12's. (d) 14 launches a layer, 364 a
   forward; the decode-step profile, the tied f32 head's device ms on its
   own; tok/s and TTFT.
14. observability (`repro_torch.obs`) on phase 4's model, after phase 9
   and before the model is freed. Each mpGeMM call with an `Obs` installed
   records one `mpgemm_dispatch` span (the port runs eagerly) with one
   `tile` entry per kernel launch. (a) Phase 4's whole-prompt fused decode
   with `obs=Obs(...)`: phase 4's tokens exactly; the dispatch counter's
   sum equal to the fused kernel's launch count, 224 per forward; the
   prompt, generation and success counters equal to the run's ServeStats;
   8 TTFT and 8 TPOT observations; every per-step effective M in [1, 4].
   (b) Phase 8's chunk 64 + chain k 4 run with the same `Obs`: phase 8's
   tokens exactly; chunk and verify step spans; the draft and accept
   counters equal to ServeStats. (c) Phase 9's paged prefix-sharing run
   with obs on: phase 9's tokens; the page gauges and counters equal to
   the pager's; the prefix-hit counters equal to phase 9's. (d) The shared
   `Obs`'s metrics JSON and trace written to a temp dir and reloaded: the
   trace holds scheduler ticks, decode, chunk and verify steps and
   dispatch spans, none dropped; every dispatch span lies inside a step
   span, or inside a scheduler tick for a whole-prompt admission's
   prefill (8 x 224 of them). (e) A run with obs off, then (a)'s run with
   obs on, in (a)'s configuration: the host ms per decode step and decode
   tok/s of each, logged, not gated; and the hook alone on the
   host: one decode tick's 226 events (224 dispatch spans with their tile
   lookups, a step, a tick) recorded 200 times. (f) Per-launch device
   times of kernels #1-#4 at N 4, phase 3's forward timed shape by shape
   (the forward's 64, 64, 64 and 32 launches of each shape in one graph), fed to
   `record_kernel_sample`: each achieved-GB/s gauge equal to
   `mpgemm_cost` bytes / seconds and at most 1.05x the card's HBM rate.
   Phase 10 runs its plain-vs-kernel prefill with an `Obs` installed (g):
   one dispatch span per call (7 single and 3 grouped BitLinears a layer),
   and their tiles one per launch, equal to the launch counters (8 single
   + 4 grouped a layer: the w2 weights have two packed segments).
15. encdec: `whisper-medium` at its published widths and depth, no cut
   (24 encoder + 24 decoder layers, d 1024, 16 heads of 64, d_ff 4096,
   vocab 51865, bf16, tied head; the stub frontend's frames), random
   weights from a seeded generator on the card, packed by `pack_params`,
   after phase 13 (its model freed first). (a) Kernels #1-#4 against
   their plain versions at its three BitLinear shapes (M, K) (1024, 1024),
   (4096, 1024), (1024, 4096), each a g=5 and a g=4 segment, N in {1, 4,
   37, 1500, 6000} (6000: a 4-request encoder batch of 1500 frames):
   expected difference 0; each shape's plans logged; one decode step's 432
   launches timed at N 4 and one encoder forward's 336 at N 6000, beside
   the bound, the plain versions (at N 6000 on layer 0's 14 launches) and
   a bf16 matmul. (b) Serving through `launch.steps` (B 4, frames (4,
   1500, 1024), prompts of 8 tokens, 64 greedy tokens, max_len 448) with
   impl="decode" and "lookup": identical tokens; the impl's kernel
   launched exactly 336 (encoder) + 528 (decoder prefill: 11 BitLinears a
   layer, the cross-attention's wk and wv included) times in the prefill
   step and 432 a decode step, no other mpGeMM or flash launch; the
   encoder's and the decoder prefill's ms apart; encode + prefill logits
   of 1 x 64 frames on the card against the CPU plain path (the larger of
   LOGIT_RTOL and the model's own bf16-vs-f32 distance); after a prefill
   and 8 decode steps on the cached cross K/V, the logits against a
   cache-free encode + forward (ENCDEC_CACHE_RTOL); one decode step under
   torch.profiler. (c) Flash at whisper's training shapes (non-causal B 8
   S 112, causal S 448; H 16, D 64, bf16) against its plain version, its
   gradients against autograd through the plain version, timed beside the
   bound, the plain version and sdpa; then 10 QAT steps of B 8 x S 448
   (112 frames) with attn_impl="flash" and remat through `train.Trainer`
   (lr 3e-4, warmup 5): every loss finite, the last below the first; flash
   launched (24 + 24) x 2 = 96 times a step and no mpGeMM kernel; the
   checkpoint resumes a second Trainer with equal weights; one sequence's
   loss on the card against the CPU (TRAIN_LOSS_RTOL); one step profiled
   (the device traced alone). The phase's seconds are logged; rows under `encdec`.
16. dist, after phase 7: the distribution layer (`repro_torch.dist`,
   `launch.mesh`). (a) The "xla" mpGeMM impl (the JAX package's shardable
   path: codes decoded to trits, one f32 product per 512 K-groups, exact,
   summed in int32; no kernel of the port): int32 equal to
   `ternary_decode_gemm` (#3) and its plain version at smollm-360m's and
   whisper-medium's BitLinear shapes, every segment, N in {1, 4, 37, 1500,
   6000} (expected difference 0); timed beside #1 (fused) and #3 (the
   unfused pipeline) over one smollm forward's 224 BitLinears at N 4 and
   whisper's encoder's 168 BitLinears (336 kernel launches) at N 6000,
   whole pipelines (`ternary_matmul`) and integer cores; greedy serving of
   smollm-360m (seed 0, phase 4's weights and prompts) with impl="xla":
   phase 5's unfused tokens, and no kernel launched. (b) A world of one
   rank over NCCL on a free local port and `make_small_mesh(1, 1)`:
   `Trainer(mesh=...)` on smollm-360m at full width and depth, B 8 x S
   512, 3 steps from phase 7's seed and settings, against an unsharded
   `Trainer` of the same 3 steps: losses and final parameters bit-equal
   (every placement is Replicate at world 1), the flash kernel launched
   2 x 32 x 3 times inside the sharded steps and no mpGeMM kernel; the step
   ms and one profiled step's busy share (the device traced alone) beside
   phase 7's. The process group is destroyed at the end. Rows under `dist`.
17. autotune, after every other phase: the measured launch-plan choice
   (`kernels.autotune`). Phases 3-16 run on an empty plan cache under
   build/ with inline tuning off, so they launch the heuristic plans.
   (a) That cache was never written, and `launch_tiles` reports today's
   heuristic plan for smollm-360m's segments at N 4 and 64. (b) Into a
   fresh cache under build/, with an `Obs` installed: kernels #1-#4 at
   smollm-360m's 4 distinct segments at N 4 and 64 and at whisper-medium's
   encoder's 6 at N 6000, and the fused grouped pair at llama4-scout's 3
   expert segments at C 4 (62 problems): every candidate plan (at most 32,
   today's first; each legal under the kernels' C checks) launched and
   held bit-equal to the heuristic plan's output, the heuristic plan's
   output to the plain version on the same operands (the vector-LUT
   pair's at N 6000 to the decode pair's plain version: the same exact
   integers, a gather of ~1 s a call spared), then timed by CUDA-graph
   replay (each launch after a 50 MB L2 flush where the operands fit in
   it); the heuristic plan's and the winner's ms logged. (c) Every tuned
   key reread through `get_plan` with no timing (the trial counter stays
   put), and from a fresh `PlanCache` on the file: the same plans. (d)
   Phase 4's serving, both fused impls, on the same weights (seed 0) with
   the tuned cache, impl="decode" after a run with the empty one (the
   host's speed drifts over the script): phase 4's greedy tokens, 224
   launches a forward, decode tok/s logged. (e) whisper-medium's
   encoder's 336 launches at N 6000 under the tuned plans (each launch
   reporting its tuned plan), #1-#4, by graph replay beside phase 15's.
   (f) Each winner one `repro:mpgemm_kernel_seconds` sample of the
   installed `Obs`. The launch counters are restored at the end; rows
   under `autotune`.
18. steps, after phase 16 (and before 17): the step statistics
   (`roofline.hlo_stats`) of smollm-360m at published width and depth
   (seed 0, phase 4's weights). (a) Three steps traced on fake cuda
   tensors (`trace_step`): the decode step (4 slots, cache 256), the
   prefill step (one prompt at phase 4's bucket) and one QAT training step
   (B 8 x S 512, flash, phase 7's settings); each one's statistics, its
   launches by kernel and its trace seconds logged. (b) Each step run once
   for real (after a warm-up run): each kernel's traced launches equal its
   counter's delta, and the trace's dot FLOPs equal `FlopCounterMode`'s
   count of the real step's products, exactly. (c) The trace's argument +
   temp bytes against the card's arguments plus `max_memory_allocated` -
   the memory allocated before the step (after
   `reset_peak_memory_stats`), net of the split-K workspace's growth (the
   library's workspaces were allocated by the warm-up run): within
   `STEP_MEM_RTOL`. (d) Each step's bound, max(traffic / 3.35 TB/s, FLOPs
   / 989 TFLOP/s), beside its device ms (the profiler, the device alone;
   the training step's from phase 7's profile) and their ratio: no gate.
   (e) The operator hop's host cost: µs a call of #1 launched directly
   and through ``torch.ops.repro_torch.ternary_decode_gemm_fused`` (in
   turns, the same output), and phase 4's serving, impl="decode", both
   ways (the same tokens, 224 launches a forward), decode tok/s logged.
   Rows under `steps`.
19. lint, after phase 18 (and before 17, so the heuristic plans still
   hold), on phase 18's smollm-360m model and traces
   (`repro_torch.lint`). (a) The IR registry (`default_entries(full=True)`:
   the mpGeMM impls at M 1-256 and every `step_entries()` surface of the
   smoke engines) traced on fake cuda tensors: the passes I1-I4 report 0
   findings and each I5 hash equals the committed snapshot
   (`tests/torch_ir_snapshots/cuda/` where committed, else `cpu/`; the
   card's set is written under `chiprun_out/torch_ir_snapshots/` either
   way). (b) Phase 18's three full-width traces (decode, prefill, the QAT
   step) through I1-I4: 0 findings. (c) Every registry entry run on real
   cuda tensors (the smoke models from seed 0), once to warm up and once
   under ``torch.cuda.set_sync_debug_mode("error")``: no sync error, and
   each kernel's counter delta equals the trace's launches. (d)
   `CompileGuard(guard_entries(engine))` over an engine on phase 18's
   model (4 slots, chunk 64, chain k 4): armed after warm-up, 20 mixed
   steady-state ticks (chunked prefill, decode, chain speculation) grow
   nothing; one tick of an engine at a new chunk (a new N) grows the
   plans (the guard's positive control). (e) One full-width decode step
   under `enable_sanitizers()` (rank and dtype promotion raise,
   debug-NaNs): no error, the tokens of the step without it. Rows under
   `lint`.
20. hybrid, after phase 15 (its model freed first): `jamba-1.5-large-398b`
   at its published widths (d 8192, 64 heads / 8 KV heads of 128, SSM
   d_inner 16384 in 256 heads of 64 with d_state 16, 16 experts top-2 of
   d_ff 24576, dense d_ff 24576, vocab 65536, bf16, untied head), depth
   cut from 72 to one period of its 8-layer pattern (SSM layers 0-2 and
   4-7, attention layer 3; MoE FFNs on the odd layers, dense on the even:
   72 layers need 81.7 GB of packed weights), random weights drawn and
   packed layer by layer. (a) Kernels #1-#4 against their plain versions
   at layer 0's BitLinear shapes (SSM in_proj M 33056, out_proj K 16384,
   dense w1/w3 24576 x 8192, w2 K 24576) and layer 3's (attention: wq/wo
   8192 x 8192, wk/wv 1024 x 8192), N in {1, 4, 17, 61, 200}: expected
   difference 0; those layers' 18 launches timed at N 4. Both grouped
   pairs, fused and integer, at layer 1's experts (w1 E 16 x M 24576 x K
   8192, w2 E 16 x 8192 x 24576), C 8, 16 and 40 (the capacities of 4, 64
   and 250 tokens) with a zero padding row, against their plain versions
   and 16 single launches: expected difference 0; each launch timed at C 8
   beside its bound, 16 single launches, the plain version (eager), a decode
   step's 8 real rows and a bf16 `torch.bmm` yardstick. (b) and (d)
   Serving as phase 12 (b): fused decode, fused lookup (identical tokens)
   and unfused decode (identical, or leaving them at a near-tie, within
   the model's rounding sensitivity or after a routing flip), 60 single
   and 24 grouped launches a forward (equal to those reckoned from the
   config), no other mpGeMM kernel; one prefill's logits through the
   kernels against their plain versions (MOE_LOGIT_RTOL). (c) As phase 12
   (c), the MoE layers dropless, at 256 heads; the rounding sensitivity
   only where unfused leaves fused. (e) One decode step of 4 full slots
   under torch.profiler with the f32 head's device ms, one SSM layer's own
   ops against its BitLinears, one MoE layer's dispatch. Rows under
   `hybrid`.
21. dense, after phase 20: `internlm2-1.8b` (24 layers, d 2048, 16 / 8
   heads of 128, d_ff 8192, vocab 92544), `command-r-35b` (40 layers, d
   8192, 64 / 8 of 128, d_ff 22528, vocab 256000, tied head) and
   `chameleon-34b` (48 layers, d 8192, 64 / 8 of 128, d_ff 22016, vocab
   65536, q/k norms) at their published widths and depth, built and freed
   one at a time. Each: (a) kernels #1-#4 against their plain versions at
   layer 0's BitLinear shapes as phase 20 (a), the launch shapes checked
   earlier in the run skipped (chameleon's and command-r's attention
   shapes are jamba's), layer 0's 14 launches timed at N 4; (b) and (d)
   serving as phase 20, 336 / 560 / 672 launches a forward, the rounding
   sensitivity only where unfused leaves fused; (e) one decode-step
   profile with the f32 head's device ms and share (command-r's casts its
   256000 x 8192 tied table to f32 each step, as the JAX package does).
   Rows under `dense_archs`.
22. step graphs (`repro_torch.serve.graphs`): every engine of phases 4-21
   replays its per-tick steps (decode, the chunk step, verify, compact, a
   ModelDrafter's decode and verify) as CUDA graphs, captured once per
   shape after one eager call, the cache donated; phase 15's decode steps
   replay through a `StepGraphs` too. The profiles that read host ops'
   device time (phases 4, 9, 10, 11) and phase 14 (one dispatch span per
   call) run eagerly. Phase 22 holds graphed serving against eager
   serving on each model while it is loaded: smollm-360m after phase 14
   (whole-prompt decode, chunk 64, chain k 4, tree (2, 2), paged with
   chunk 64 and chain k 4), deepseek-v3 at phase 11's depth, mamba2
   (phase 12: the SSM state written back), gemma3 (phase 13: prompts past
   the window), whisper-medium's `launch.steps` decode (phase 15: the
   cross K/V) and command-r-35b (phase 21: d 8192). Each runs the same
   seeded requests eager, then graphed, greedy and at temperature 0.7
   (whisper: greedy), after warm-up requests: identical tokens, equal
   launches per tick as a device-only trace counts them (a marker kernel
   ends each tick; each run's wrapper counts must be the trace's), no
   capture after the warm-up, every input upload and replay under the
   sync debug mode's "error" (no host sync; a planted one is caught),
   device memory back to its baseline once the engine is dropped; decode
   tok/s, decode-step ms (both with the trace on) and (torch.profiler,
   one step of 4 full slots) wall, device and busy share, graphed and
   eager, logged in one table at the end beside the card's name and
   power limit. Rows under `graphs`.

Each log line starts with the seconds since the script began; each
phase's seconds are logged and kept under `phase_seconds`.

Output: a `kernels` JSON line and the card's line before the last line,
which is {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import gc
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12     # H100 SXM device memory rate
INT8_OPS_S = 1979e12      # H100 SXM dense int8 tensor-core peak
SHAPES = [(960, 960), (320, 960), (2560, 960), (960, 2560)]
MIXED_SHAPE = (960, 964)  # 192 g=5 groups + 1 g=4 group
TOKENS = (1, 4, 16, 64, 256)
DECODE_N = 4              # one decode step of the 4-slot engine
IMPLS = ("decode", "lookup")
KERNEL_META = {
    "ternary_decode_gemm_fused": dict(
        impl="decode", fusion="fused", source="src/repro_torch/csrc/ternary_decode_gemm.cu",
        replaces="src/repro/kernels/ternary_decode_gemm.py:176"),
    "vlut_lookup_gemm_fused": dict(
        impl="lookup", fusion="fused", source="src/repro_torch/csrc/vlut_lookup_gemm.cu",
        replaces="src/repro/kernels/vlut_lookup_gemm.py:222"),
    "ternary_decode_gemm": dict(
        impl="decode", fusion="unfused", source="src/repro_torch/csrc/ternary_decode_gemm.cu",
        replaces="src/repro/kernels/ternary_decode_gemm.py:129"),
    "vlut_lookup_gemm": dict(
        impl="lookup", fusion="unfused", source="src/repro_torch/csrc/vlut_lookup_gemm.cu",
        replaces="src/repro/kernels/vlut_lookup_gemm.py:171"),
}
#: the grouped launches of the same two TPU kernels, reached there under
#: jax.vmap over stacked expert weights (src/repro/models/common.py:58)
GROUPED_META = {
    "ternary_decode_gemm_fused_grouped": dict(
        impl="decode", source="src/repro_torch/csrc/ternary_decode_gemm.cu",
        replaces="src/repro/kernels/ternary_decode_gemm.py:176"),
    "vlut_lookup_gemm_fused_grouped": dict(
        impl="lookup", source="src/repro_torch/csrc/vlut_lookup_gemm.cu",
        replaces="src/repro/kernels/vlut_lookup_gemm.py:222"),
}
#: the grouped launches of the integer pair, reached under the same vmap
#: when a MoE layer runs the unfused pipeline
GROUPED_INT_META = {
    "ternary_decode_gemm_grouped": dict(
        impl="decode", source="src/repro_torch/csrc/ternary_decode_gemm.cu",
        replaces="src/repro/kernels/ternary_decode_gemm.py:129"),
    "vlut_lookup_gemm_grouped": dict(
        impl="lookup", source="src/repro_torch/csrc/vlut_lookup_gemm.cu",
        replaces="src/repro/kernels/vlut_lookup_gemm.py:171"),
}
# (g, (M, KG)) of the saturated integer checks: all +1 weights, activations
# 127, every sum 127*K (K = 2560 and 960)
SATURATED = ((5, (2560, 512)), (4, (960, 240)))
# The vector-LUT kernels' split-K traps, (M, KG, N, g): ragged M (70,
# 1000), N = 17 and 33, KG not divisible by the plan's splits, the K = 964
# weight's one-group g=4 segment, and smollm-360m's q at a decode step.
LUT_RAGGED = ((70, 13, 17, 5), (1000, 77, 33, 5), (1000, 191, 17, 4), (70, 1, 3, 4),
              (960, 192, 4, 5))
LUT_REPLAYS = 3           # CUDA-graph replays before the outputs are compared
FLASH_REPLAYS = 3         # CUDA-graph replays of the flash launch, each compared
# With two segments the fused pipeline sums one f32 partial per segment and
# the unfused one int32 before a single dequant: f32 rounding apart.
FUSION_RTOL = 1e-6
COMPARE_SHAPE = (2560, 960)   # the paper's comparison: smollm-360m's gate/up
# mad_gemm skips activation quantization: against ref_mpgemm it gets the
# JAX suite's bound (tests/test_vlut_core.py, test_mad_float_close)
MAD_TOL = {"rtol": 0.1, "atol": 0.15}
FLASH_META = dict(source="src/repro_torch/csrc/flash_attention.cu",
                  replaces="src/repro/kernels/flash_attention.py:106")
BF16_FLOPS_S = 989e12     # H100 SXM dense bf16 tensor-core peak
FLASH_HEADS = [(15, 5, 64), (3, 3, 20), (6, 2, 32), (3, 1, 128)]   # (H, KV, D)
FLASH_SEQS = (1, 17, 256, 512, 2048)
FLASH_TRAIN_SHAPE = (8, 512, 15, 5, 64)                           # (B, S, H, KV, D)
# The kernel (online softmax over 64-key tiles, FMA dot products) and its
# plain version (full softmax, einsum) differ only in summation order:
# f32 agrees to ~1e-6 of the output's scale (bound 2e-5); a bf16 output is
# one rounding of two nearly equal f32 values, so the two are at most one
# bf16 ulp apart (2^-7 of the largest output, or of 1 when smaller).
# Gradients: the autograd.Function's backward IS the plain VJP, so only
# run-to-run order in the library's products can differ.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
FLASH_GRAD_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 8, 512, 30, 3e-4
# Phase 8 (multi-token serving): the token counts N the verify and chunk
# steps give the mpGeMM kernels with 4 slots (4 x (k+1) = 20 for chain k 4,
# 4 x 15 = 60 for tree (2, 2)); ragged across the plans' 16-token tiles.
MT_TOKENS = (20, 60)
SPEC_K = 4
SPEC_TREE = (2, 2)
PREFILL_CHUNK = 64
TOKEN_BUDGET = 96
STOCHASTIC_TEMPERATURE = 0.8
# verify_step against sequential decode, both on the card: both attend the
# bf16 cache; the attention einsums and the head matmul run at other shapes
# (5 or 15 queries against 1), so float sums may go in another order. Bound
# on max |verify - sequential| relative to the largest sequential logit:
# sound runs read 1.83e-7 (chain) and 1.19e-6 (tree) on the H100, and the
# planted faults that check_verify runs (the causal mask or the tree's
# ancestor gate dropped) must read above it.
VERIFY_RTOL = 1e-4
# A greedy run may leave phase 4's tokens only at a near-tie: at the first
# divergent step the whole-prompt reference logits of the two tokens must
# lie within this fraction of the largest logit (a bf16 rounding of the
# largest logit is 2^-8 of it; a bookkeeping fault moves logits by far more).
TIE_RTOL = 1e-2
# the self-drafting oracle drafts with the target's own weights; the card's
# draft and verify forwards differ only at near-ties
ORACLE_MIN_ACCEPT = 0.9
# Phase 9 (paged KV cache): tokens per page, the shared system prompt of
# the prefix-sharing run (8 full pages), and the offload run's pool: 17
# pages (16 allocatable) against 9 per 128-token request, a 64-page host tier
PAGE_SIZE = 16
SYSTEM_PROMPT = 128
OFFLOAD_PAGES, OFFLOAD_HOST_PAGES, OFFLOAD_PROMPT = 17, 64, 128
CPU_SEQ = 256
# Phase 14 (observability): obs-off and obs-on serving runs, interleaved,
# for the cost of the layer (one pair: its ±15% host noise is recorded
# since PR 23), and the hook alone over OBS_HOOK_TICKS decode ticks'
# events. An achieved-GB/s gauge (the bytes a launch must move over
# its device time) above the card's HBM rate by more than timing noise
# would mean a wrong byte count or a wrong time.
OBS_COST_RUNS = 1
OBS_HOOK_TICKS = 200
OBS_GBPS_SLACK = 1.05
OBS_TRACE_NAMES = ("scheduler_tick", "engine_step/decode", "engine_step/chunk",
                   "engine_step/verify", "mpgemm_dispatch")

# Phase 10 (MoE): llama4-scout-17b-a16e at its published widths, depth cut
# from 48 to MOE_LAYERS: not the card (48 packed layers, ~25 GB, fit) but
# the script's time limit forces it (its host-bound serving runs take ~0.2
# s a layer each). Rows per expert C of the grouped launches: a decode step
# of 4 slots (4 tokens, top-1 of 16 experts: the capacity floor min(T, 16)
# = 4), a chain-4 verify step or a 64-token prefill (16), a larger batch
# (64).
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_LAYERS = 12
MOE_TOKENS = (4, 16, 64)
MOE_TIME_TOKENS = (4, 16)
# grouped split-K traps (E, M, KG, g, C): odd E, M off the tiles, C 5 and
# 17, KG not divisible by the splits, a one-K-group g=4 segment, and KG 300
# (the grouped decode plan splits K only on 128-K-group steps)
MOE_RAGGED = ((3, 70, 13, 5, 5), (5, 130, 77, 4, 17), (3, 1000, 191, 5, 5), (7, 70, 1, 4, 3),
              (3, 1000, 300, 5, 5))
# the grouped vector-LUT plan's geometry traps (E, M, KG, g, C): E x tiles
# just over a wave (133 and 134 tiles), one-chunk segments with several
# experts a block (140 experts of KG 2), M off the row tile (70, 1000), KG
# 1, 2, 3, 13 and 77, C 1, 5, 17 and 64, g 4 and 5; each launched at E and
# again at E - 1 experts (phase 10 (a))
LUT_GEOMETRY_TRAPS = (
    [(134, 1000, 64, 5, 16), (133, 70, 40, 4, 4), (140, 70, 2, 4, 1)]
    + [(3, m, kg, 4 + (i % 2), c)
       for i, (m, kg, c) in enumerate((m, kg, c) for m in (70, 1000) for kg in (1, 2, 3, 13, 77)
                                      for c in (1, 5, 17, 64))]
)
# the same at deepseek-v3's 256 experts (phase 11 (a)): several experts a
# block (KG 13), two token tiles (C 17), 255 experts, a wave of 129 tiles
# and one of 133 that splits K
LUT_GEOMETRY_TRAPS_E256 = ((256, 70, 13, 5, 16), (256, 1000, 77, 4, 17), (256, 2048, 40, 5, 16),
                           (129, 1000, 64, 5, 16), (133, 1000, 64, 4, 4))
# the grouped decode plan's geometry traps (E, M, KG, g, C), phase 10 (a)
# at 16 experts: K split 4 and 2 ways (a zero K-slice beside nonzero ones
# in expert 0), M 70 and 1000 off the 512-row unit, KG 1, 2, 3, 13 and 77
# (packed-row tails) and 300 and 520 (several steps), C 1, 4, 5, 17 and 64, g
# 4 and 5; expert 1 all zero; each launched at E and again at E - 1
DECODE_GEOMETRY_TRAPS = ((16, 70, 520, 5, 4), (16, 1000, 300, 5, 5), (16, 1000, 77, 4, 17),
                         (16, 1000, 13, 5, 64), (16, 70, 1, 4, 5), (16, 1000, 2, 4, 1),
                         (16, 70, 3, 5, 64))
# the same at deepseek-v3's 256 experts (phase 11 (a)): 2 and 8 experts a
# block (KG 1-40), two token tiles (C 17), and 133 experts of one block
# each just over a wave, which splits K (132 at E - 1: one full wave)
DECODE_GEOMETRY_TRAPS_E256 = ((256, 70, 13, 5, 16), (256, 1000, 77, 4, 17), (256, 2048, 40, 5, 16),
                              (256, 70, 2, 4, 1), (256, 1000, 1, 5, 64), (133, 1000, 300, 5, 16))
# one prefill through the kernels against the same prefill through their
# plain versions on the card: the kernels are bit-equal to the plain
# versions and every other op is the same call on the same device, so the
# logits should agree exactly; the bound on max |diff| relative to the
# largest logit leaves room only for a library's run-to-run sum order.
MOE_LOGIT_RTOL = 1e-4
# weights the plain grouped versions unpack at once (`experts_chunked`):
# their trits take ~16 bytes a weight in flight
PLAIN_CHUNK_WEIGHTS = 1 << 30
# Phase 11 (MLA): deepseek-v3-671b at its published widths, depth cut to
# its 3 dense layers and the first 5 of its 58 MoE layers: all 61 layers
# (~138 GB packed) do not fit the card, and the script's time limit allows
# no more than 8 (16, ~34 GB, fit the card). Every
# grouped launch of its runs has C = 16 rows per expert (the capacity
# floor min(T * 8, 16) binds up to 409 tokens a step); a decode step of 4
# tokens gives at most 4 x 8 = 32 of those 256 x 16 rows real tokens.
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = 8
MLA_TOKENS = 16
MLA_DECODE_ROWS = 32
# ops of the MoE dispatch whose device time phase 10's profile logs (the
# indexing ops also serve the attention cache)
MOE_DISPATCH_OPS = ("aten::sort", "aten::cumsum", "aten::one_hot", "aten::index_put_",
                    "aten::index", "aten::gather", "aten::repeat_interleave")
# Phases 12 (SSM: mamba2-1.3b), 13 (windowed GQA: gemma3-1b), 20 (hybrid
# SSM + attention + MoE: jamba-1.5-large-398b) and 21 (the other dense GQA
# archs), each at its published widths. Token counts of the kernels'
# checks: decode (1, 4) and exact-length prefill (17, 61, 200: no
# 16-multiple bucket). Serving: 6 prompts of 16-64 tokens and two long ones
# (150-250: more than one SSM chunk of 64 with a padded last chunk; gemma3:
# 600-700, past the window of 512, so the ring wraps in prefill and again
# in decode), in a cache of max_len tokens.
SSM_ARCH = "mamba2-1.3b"
WINDOW_ARCH = "gemma3-1b"
ODD_TOKENS = (1, 4, 17, 61, 200)
LONG_PROMPT = (150, 251)
NEW_MAX_LEN = 320
WINDOW_LONG_PROMPT, WINDOW_MAX_LEN = (600, 701), 1024
# Phase 20: jamba at its published widths, depth cut to one period of its
# 8-layer pattern (SSM layers 0-2 and 4-7, attention layer 3; MoE FFNs on
# the odd layers, dense on the even): 72 layers need 81.7 GB of packed
# weights, the card holds 80 GB. The single kernels are checked on layer 0
# (SSM, dense FFN) and layer 3 (attention); the grouped ones on layer 1's
# experts at the capacities (top-2 of 16, factor 1.25) of 4, 64 and 250
# tokens, C 8, 16 and 40, and timed at the decode step's (the plain
# vector-LUT gather of a layer takes ~3 s at C 40).
HYBRID_ARCH = "jamba-1.5-large-398b"
HYBRID_LAYERS = 8
HYBRID_CHECK_LAYERS = (0, 3)
HYBRID_MOE_LAYER = 1
HYBRID_CAPACITY_TOKENS = (4, 64, 250)
HYBRID_TIME_TOKENS = (DECODE_N,)
# Phase 21: the dense GQA archs not run in phase 13, each at its published
# widths and depth, built and freed one at a time.
DENSE_ARCHS = ("internlm2-1.8b", "command-r-35b", "chameleon-34b")
# tests/test_ssm.py's tolerances: prefill(n - 1) + decode_step against the
# last position of one prefill of n (rtol and atol on the logits), and the
# chunked scan against the sequential recurrence (rtol and atol)
SSM_DECODE_TOL = 2e-2
SSM_SCAN_TOL = 2e-3
SSM_SCAN_LEN = 200
# gemma3 after the ring has wrapped: a decode step reads the windowed
# layers' K/V from the bf16 ring, a cache-free forward computes them fresh
# (bf16 too) and attends in another sum order; bound on max |diff|
# relative to the largest logit, as LOGIT_RTOL's bf16 rounding argument
RING_RTOL = 0.05
# Phase 15: the encoder-decoder whisper-medium at its published widths and
# depth (24 + 24 layers). Token counts of the kernels' checks: decode (1, 4),
# a prefill of a few prompts (37), one request's encoder frames (1500:
# Whisper's 30 s window, n_audio_ctx) and a 4-request encoder batch (6000).
# Serving: 4 requests of 1500 frames and 8-token prompts, 64 greedy tokens
# (the prefill's and 63 decode steps'), in a cache of Whisper's n_text_ctx.
ENCDEC_ARCH = "whisper-medium"
ENCDEC_TOKENS = (1, 4, 37, 1500, 6000)
ENCDEC_SMALL_N = 37           # up to here every activation/output type pair is checked
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_NEW = 4, 1500, 8, 64
ENCDEC_MAX_LEN = 448
# launches of one forward: 2 per BitLinear (every whisper BitLinear has a
# g=5 and a g=4 segment); the encoder's 7 a layer; a decoder prefill's 11
# (self-attention 4, cross-attention 4: wk and wv on the encoder output,
# FFN 3); a decode step's 9 (the cached cross K/V skip wk and wv)
ENCDEC_LAUNCHES = {"encoder": 2 * 7 * 24, "prefill": 2 * 11 * 24, "decode": 2 * 9 * 24}
# the card against the CPU plain path: 1 request, 64 frames, the prompt
ENCDEC_CPU_FRAMES = 64
# cached cross K/V (bf16, as the fresh ones in this bf16 model) and self
# K/V read back from the cache vs a cache-free forward: attention sums in
# another order, as RING_RTOL's argument; bound relative to the largest logit
ENCDEC_CACHE_RTOL = 0.05
ENCDEC_CACHE_STEPS = 8
# training: B 8 x S 448 (n_text_ctx), frames S / 4 = 112; the card vs the
# CPU on one sequence of 64 tokens and 16 frames (TRAIN_LOSS_RTOL)
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_STEPS = 8, 448, 10
ENCDEC_CPU_SEQ = 64
# flash at whisper's training shapes: (B, S, H, KV, D, causal)
ENCDEC_FLASH = ((8, 112, 16, 16, 64, False), (8, 448, 16, 16, 64, True))
# Phase 16 (dist): the "xla" impl's token counts (phase 15's) and the world-1
# sharded trainer's steps
XLA_TOKENS = ENCDEC_TOKENS
# phase 17: the plan cache of phases 3-16 (never written: nothing tunes
# there) and the one phase 17 tunes into, both under build/
PLANS_DIR = ROOT / "build" / "chip_smoke_plans"
AUTOTUNE_TOKENS = (DECODE_N, 64)        # smollm-360m's segments are tuned at these N
AUTOTUNE_C = 4                          # llama4-scout's expert rows, tuned at C 4
DIST_STEPS = 3
# Phase 18 (the step statistics): the trace's argument + temp bytes against
# the card's peak over the real step, net of what a trace cannot see (the
# split-K workspace's growth; the library's workspaces are allocated by the
# warm-up run, before the measured one)
STEP_MEM_RTOL = 0.10
HOP_CALLS = 2000          # launches a route, timed on the host, of phase 18 (e)
# Phase 19 (lint): the steady-state guard's engine (phase 4's slots and
# cache, chunk 64, chain k 4), its steady ticks, and the control's chunk:
# 37, so that the control's N (4 x 37) is one no earlier phase plans
# (prefill buckets and chunks are multiples of 16; verify steps 20 and 60)
LINT_CHUNK, LINT_SPEC_K, LINT_TICKS, LINT_NEW_CHUNK = 64, 4, 20, 37
# Phase 22 (step graphs): each comparison's 4 slots serve 4 prompts of
# 16-64 tokens (gemma3: 600-700, past its window) GRAPH_NEW new tokens
# each, greedy and sampled at GRAPH_TEMPERATURE from the engine's seed,
# after 2 warm-up requests of GRAPH_WARM_LEN tokens (three chunks of 64,
# and one) and GRAPH_WARM_NEW new tokens (every step key's eager call and
# capture happen there); the
# whisper steps' GRAPH_ENCDEC_STEPS timed decode steps; the dense arch of
# phase 21 it runs on (d 8192)
GRAPH_NEW, GRAPH_TEMPERATURE, GRAPH_SEED = 8, 0.7, 22
GRAPH_WARM_LEN, GRAPH_WARM_NEW = (150, 40), 12
GRAPH_ENCDEC_STEPS = 16
GRAPH_DENSE_ARCH = "command-r-35b"
# bf16 model, 32 layers, QAT: the CPU and the card round bf16 intermediates
# after sums in another order, and an int8 activation code at a rounding
# boundary can move by one; the mean CE over 256 tokens moves far less than
# one logit. Bound on |card - cpu| relative to the CPU's loss.
TRAIN_LOSS_RTOL = 0.02
# bf16 model, 32 layers: the card and the CPU round bf16 intermediates
# (norms, attention, residual adds) after sums taken in different orders,
# and a one-ulp change can move an int8 activation code by one; the
# difference grows through the layers. Bound on |card - cpu| relative to
# the largest reference logit.
LOGIT_RTOL = 0.05


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, after the seconds since the script began."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, reps: int = 5) -> float:
    """Device time of the launches `fn` makes, with the host's launch
    overhead excluded: `fn` is captured once in a CUDA graph and the graph
    is replayed between two timing events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        graph.replay()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def eager_ms(torch, fn, reps: int = 3) -> float:
    """Time of `fn` run eagerly, between two events: the device's time plus
    whatever the host's launch overhead adds — what the serving path pays."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def bitlinear_weights(torch, model, gen) -> dict:
    """{(M, K): PackedWeight}: the model's first-layer weights for the
    main-path shapes, and a random mixed-segment weight for K = 964."""
    from repro_torch.core import pack_weight, ternary_quantize
    from repro_torch.models.common import PackedLinear

    lin0 = [m for m in model.layers[0].modules() if isinstance(m, PackedLinear)]
    weights = {}
    for lin in lin0:
        weights.setdefault((lin.pw.M, lin.pw.K), lin.pw)
    assert sorted(weights) == sorted(SHAPES), sorted(weights)
    w = torch.randn(MIXED_SHAPE, generator=gen, device="cuda")
    tw = ternary_quantize(w)
    weights[MIXED_SHAPE] = pack_weight(tw.values, tw.scale)
    assert weights[MIXED_SHAPE].k4 == 4
    return weights


def plan_row(p) -> dict:
    """A launch plan (`LutPlan`, `GroupedLutPlan`, `DecodePlan` or
    `GroupedDecodePlan`) as a JSON row."""
    row = {"shape": [p.m, p.kg, p.n, p.g], "splits": p.splits, "blocks": p.blocks,
           "smem": p.smem, "kg_divisible_by_splits": p.kg % p.splits == 0}
    for key in ("e", "ex", "bm", "bn", "chunk", "kstep", "codes_aligned", "acts_aligned",
                "stagings"):
        if hasattr(p, key):
            row[key] = getattr(p, key)
    return row


def kernel_registers(_build, tag: str) -> dict:
    """`-Xptxas -v` of each instantiation whose name holds `tag`: registers
    and spill bytes (stores + loads)."""
    out, entry = {}, None
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if tag in line else None
            if entry:
                out[entry] = {}
        elif entry and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[entry]["spill_bytes"] = nums[1] + nums[2]
        elif entry and "registers" in line:
            out[entry]["registers"] = int(line.split("Used ")[1].split()[0])
    return out


def splitk_traps(torch, name, kern, plain, cases) -> dict:
    """The split-K traps of a kernel, each against its plain version with
    an expected difference of exactly 0. cases: [(args, kwargs)]. (1) Every
    case launched twice, back to back with the other cases and no sync
    between (different shapes share the workspace and counters): both
    launches equal the plain version. (2) One CUDA graph of all cases
    replayed LUT_REPLAYS times (a workspace or counter left dirty would add
    into the next replay): the outputs equal the plain version."""
    wants = [plain(*a, **kw) for a, kw in cases]
    firsts = [kern(*a, **kw) for a, kw in cases]
    seconds = [kern(*a, **kw) for a, kw in cases]
    torch.cuda.synchronize()
    for (a, kw), want, first, second in zip(cases, wants, firsts, seconds):
        if not (torch.equal(first, want) and torch.equal(second, first)):
            raise AssertionError(f"{name}: repeat launches at {tuple(a[0].shape)} x "
                                 f"{tuple(a[1].shape)} differ from the plain version or each other")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [kern(*a, **kw) for a, kw in cases]
    for _ in range(LUT_REPLAYS):
        graph.replay()
    torch.cuda.synchronize()
    for (a, kw), want, out in zip(cases, wants, outs):
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: after {LUT_REPLAYS} graph replays the output at "
                                 f"{tuple(a[0].shape)} x {tuple(a[1].shape)} differs from the plain version")
    del graph
    return {"cases": len(cases), "repeat_launches": 2, "graph_replays": LUT_REPLAYS, "max_abs_err": 0}


def geometry_traps(torch, gen, traps, label: str, impl: str, reach=("ex", "splits")) -> dict:
    """The grouped kernels of `impl` ("lookup": vector-LUT, "decode":
    ternary-decode; fused, f32 and bf16, and integer) at their plan's
    geometry traps: each trap at E experts and again at E - 1 (the first
    E - 1 experts' operands), launched twice back to back with the other
    cases and in a CUDA graph replayed LUT_REPLAYS times (`splitk_traps`),
    all against the plain version, and the plain version against E single
    launches: expected difference 0. For the decode kernels expert 1 is
    all zero and, where the plan splits K, expert 0's first K-slice too
    (a split whose staged slice is zero beside one whose is not). Raises
    unless some plan reaches each of `reach` ("ex": several experts a
    block, "splits": split K)."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    plan = vlg.grouped_lut_plan if impl == "lookup" else tdg.grouped_decode_plan
    dev = torch.device("cuda")
    fused, ints = [], []
    for e, m, kg, g, c in traps:
        packed = torch.randint(0, 3 ** g, (e, m, kg), generator=gen, device=dev,
                               dtype=torch.int32).to(torch.uint8)
        x = torch.randn((e, c, kg * g), generator=gen, device=dev) * 3.0
        x[:, -1] = 0                               # a padding row of every expert
        w_scale = torch.rand((e, m), generator=gen, device=dev)
        a_r = torch.randint(-128, 128, (e, g, kg, c), generator=gen, device=dev,
                            dtype=torch.int32).to(torch.int8)
        a_r[..., -1] = 0                           # its padding token
        if impl == "decode":
            x[1:2], a_r[1:2] = 0, 0                # an expert with no real row
            p = plan(m, kg, c, g, e)
            if p.splits > 1:                       # a zero K-slice beside nonzero ones
                b = p.kgroups(1)[0]
                x[0, :, :b * g], a_r[0, :, :b] = 0, 0
        for ne in (e, e - 1) if e > 1 else (e,):
            for dt in (torch.float32, torch.bfloat16):
                xd = x[:ne].to(dt)
                fused.append(((packed[:ne], xd, act_scales(torch, xd), w_scale[:ne]),
                              dict(g=g, out_dtype=dt)))
            ints.append(((packed[:ne], a_r[:ne]), dict(g=g)))
    out = {"traps": len(traps), "plans": [plan_row(plan(m, kg, c, g, e)) for e, m, kg, g, c in traps]}
    mod = vlg if impl == "lookup" else tdg
    prefix = "vlut_lookup_gemm" if impl == "lookup" else "ternary_decode_gemm"
    for name, kern, plain, single, cases in (
            (f"{prefix}_fused_grouped", getattr(mod, f"{prefix}_fused_grouped"),
             getattr(mod, f"{prefix}_fused_plain"), getattr(mod, f"{prefix}_fused"), fused),
            (f"{prefix}_grouped", getattr(mod, f"{prefix}_grouped"),
             getattr(mod, f"{prefix}_plain"), getattr(mod, prefix), ints)):
        plain = experts_chunked(torch, plain)
        out[name] = splitk_traps(torch, name, kern, plain, cases)
        for a, kw in cases:
            want = plain(*a, **kw)
            each = torch.stack([single(*(t[i] for t in a), **kw) for i in range(a[0].shape[0])])
            pad = want[:, -1] if name.endswith("fused_grouped") else want[..., -1]
            if not torch.equal(each, want) or pad.any():
                raise AssertionError(f"{label}: {name} at {tuple(a[0].shape)} x {tuple(a[1].shape)}: "
                                     "single launches differ from the plain version, or a padding "
                                     "row's output is not 0")
        out[name]["single_launch_checks"] = len(cases)
    reached = {"ex": any(r["ex"] > 1 for r in out["plans"]),
               "splits": any(r["splits"] > 1 for r in out["plans"])}
    if not all(reached[k] for k in reach):
        raise AssertionError(f"{label}: the {impl} geometry traps reach {reached}, want {reach}")
    log(f"{label}: grouped {impl} geometry traps: {len(traps)} shapes at E and E - 1, "
        f"{len(fused)} fused and {len(ints)} integer cases, each launched twice back to back and "
        f"in a CUDA graph replayed {LUT_REPLAYS} times, against the plain version and E single "
        "launches: max |diff| 0; plans "
        + "; ".join(f"E {r['e']} {tuple(r['shape'])} bm {r['bm']} S {r['splits']} x{r['ex']} "
                    f"blocks {r['blocks']}" for r in out["plans"]))
    return out


# (E, M, KG, g) of the main path's grouped segments: llama4-scout's (w1/w3,
# w2's two) and deepseek-v3's (w1/w3's two, w2's g=5 one), at C 4, 16, 64
MAIN_GROUPED_SEGMENTS = ((16, 8192, 1024, 5), (16, 5120, 1636, 5), (16, 5120, 3, 4),
                         (256, 2048, 1432, 5), (256, 2048, 2, 4), (256, 7168, 408, 5))


def grouped_build(torch, _build, impl: str) -> dict:
    """Registers, spill bytes and blocks per SM (the CUDA runtime's
    occupancy at the largest shared bytes of the main path's grouped plans)
    of every grouped instantiation of `impl` ("lookup":
    `vlut_grouped_kernel`, "decode": `decode_grouped_kernel`); raises on a
    spill, or where fewer than the plan's blocks fit on an SM."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    mod, plan, tag, blocks = (
        (vlg, vlg.grouped_lut_plan, "vlut_grouped_kernel", _build.grouped_blocks_per_sm)
        if impl == "lookup" else
        (tdg, tdg.grouped_decode_plan, "decode_grouped_kernel", _build.decode_grouped_blocks_per_sm))
    regs = kernel_registers(_build, tag)
    smem = max(plan(m, kg, c, g, e).smem for e, m, kg, g in MAIN_GROUPED_SEGMENTS for c in (4, 16, 64))
    types = {"a": "int8", "i": "int32", "f": "float", "13__nv_bfloat16": "bf16"}
    for entry, r in regs.items():
        g = 5 if "ILi5E" in entry else 4
        names = re.findall(r"(13__nv_bfloat16|S\d*_|[aif])", entry.split(f"ILi{g}E", 1)[1])[:2]
        ta, to = (types.get(t, "bf16") for t in names)     # a substitution repeats bf16
        r["smem"] = smem
        r["blocks_per_sm"] = blocks(g, ta == "int8", ta == "bf16", to == "bf16", smem)
        log(f"build: grouped {impl} instantiation {entry} ({ta} -> {to}): {r.get('registers')} "
            f"registers, {r.get('spill_bytes')} spill bytes, {r['blocks_per_sm']} block(s) an SM "
            f"at {smem} shared bytes (the plan counts {mod.GROUP_BLOCKS_PER_SM})")
        if r.get("spill_bytes") or r["blocks_per_sm"] < mod.GROUP_BLOCKS_PER_SM:
            raise AssertionError(f"{entry}: spills or fits fewer blocks than the plan counts: {r}")
    if len(regs) != 10:
        raise AssertionError(f"expected 10 grouped {impl} instantiations, found {sorted(regs)}")
    return regs


def largest_split(plan) -> tuple:
    """(M, KG, N) of the main path's plan with the most K-splits (g=5), by
    `plan(M, KG, N, g)` (`lut_plan` or `decode_plan`)."""
    return max(((m, k // 5, n) for m, k in SHAPES for n in TOKENS),
               key=lambda s: plan(*s, 5).splits)


def decode_plan_for(tdg, m, kg, n, g):
    """The single decode plan the main path launches: contiguous operands,
    word loads where KG % 4 == 0."""
    return tdg.decode_plan(m, kg, n, g, codes_aligned=kg % 4 == 0, acts_aligned=kg % 4 == 0)


def fused_kernels() -> dict:
    """{name: (kernel wrapper, plain version)} of the two fused mpGeMM
    kernels."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    return {
        "ternary_decode_gemm_fused": (tdg.ternary_decode_gemm_fused, tdg.ternary_decode_gemm_fused_plain),
        "vlut_lookup_gemm_fused": (vlg.vlut_lookup_gemm_fused, vlg.vlut_lookup_gemm_fused_plain),
    }


def int_kernels() -> dict:
    """{name: (kernel wrapper, plain version)} of the two integer mpGeMM
    kernels."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    return {
        "ternary_decode_gemm": (tdg.ternary_decode_gemm, tdg.ternary_decode_gemm_plain),
        "vlut_lookup_gemm": (vlg.vlut_lookup_gemm, vlg.vlut_lookup_gemm_plain),
    }


def seen(memo, key) -> bool:
    """Whether `key` is in `memo` (None: nothing is), which it joins."""
    if memo is None:
        return False
    found = key in memo
    memo.add(key)
    return found


def fused_vs_plain(torch, kernels, weights, tokens, gen, combos=None, memo=None):
    """Each fused kernel against its plain version at every weight shape,
    token count N and activation/output type pair (f32/f32, bf16/bf16,
    bf16/f32, or `combos`). `memo`: a set of the launch shapes (M, KG, g,
    N, types) checked earlier in the run, skipped here, and this call's
    added to it. → ({name: max |diff|}, number of checks)."""
    from repro_torch.core import act_token_scale
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    combos = combos or ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                        (torch.bfloat16, torch.float32))
    max_err = {name: 0.0 for name in kernels}
    n_checks = 0
    for (m, k), pw in weights.items():
        for n in tokens:
            x32 = torch.randn((n, k), generator=gen, device=dev) * 3.0
            for in_dt, out_dt in combos:
                x = x32.to(in_dt)
                a_scale = act_token_scale(x.T).contiguous()
                for packed, lo, hi, g in ops._segments(pw):
                    if seen(memo, ("fused", m, packed.shape[1], g, n, str(in_dt), str(out_dt))):
                        continue
                    for name, (kern, plain) in kernels.items():
                        got = kern(packed, x[:, lo:hi], a_scale, pw.scale, g=g, out_dtype=out_dt)
                        want = plain(packed, x[:, lo:hi], a_scale, pw.scale, g=g, out_dtype=out_dt)
                        torch.cuda.synchronize()
                        assert got.shape == want.shape == (n, m) and got.dtype == out_dt
                        err = (got.float() - want.float()).abs().max().item()
                        max_err[name] = max(max_err[name], err)
                        n_checks += 1
    return max_err, n_checks


def check_kernels(torch, model, cfg):
    """Phase 3: kernels against their plain versions, then timing."""
    from repro_torch.core import act_token_scale
    from repro_torch.core.quantize import INV_Q_MAX
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg
    from repro_torch.models.common import PackedLinear

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    kernels = fused_kernels()
    weights = bitlinear_weights(torch, model, gen)

    max_err, n_checks = fused_vs_plain(torch, kernels, weights, TOKENS, gen)
    log(f"kernels: {n_checks} kernel-vs-plain checks, max |diff| {max_err}")
    for n in TOKENS:
        log(f"kernels: LUT plans at N={n}: " + "; ".join(
            f"{m}x{k}: BM {p.bm} S {p.splits} chunk {p.chunk} blocks {p.blocks} smem {p.smem}"
            for m, k in SHAPES for p in [vlg.lut_plan(m, k // 5, n, 5)]))
    for name, err in max_err.items():
        if err != 0.0:
            raise AssertionError(f"{name} differs from its plain version by {err} (expected 0)")

    for n in TOKENS:
        log(f"kernels: decode plans at N={n}: " + "; ".join(
            f"{m}x{k}: BM {p.bm} BN {p.bn} S {p.splits} step {p.kstep} blocks {p.blocks} "
            f"smem {p.smem}" for m, k in SHAPES for p in [decode_plan_for(tdg, m, k // 5, n, 5)]))

    # each fused kernel's split-K traps: ragged shapes, repeat and
    # back-to-back launches, graph replays, the saturated sum at the
    # largest split of its plan
    traps = {}
    for name, plan in (("vlut_lookup_gemm_fused", vlg.lut_plan),
                       ("ternary_decode_gemm_fused", lambda *s: decode_plan_for(tdg, *s))):
        kern, plain = kernels[name]
        cases = []
        for m, kg, n, g in LUT_RAGGED:
            packed = torch.randint(0, 3 ** g, (m, kg), generator=gen, device=dev,
                                   dtype=torch.int32).to(torch.uint8)
            x = torch.randn((n, kg * g), generator=gen, device=dev) * 3.0
            w_scale = torch.rand((m,), generator=gen, device=dev)
            for dt in ((torch.float32, torch.bfloat16) if (m, n) == (960, 4) else (torch.float32,)):
                cases.append(((packed, x.to(dt), act_token_scale(x.to(dt).T).contiguous(), w_scale),
                              dict(g=g, out_dtype=dt)))
        m, kg, n = largest_split(plan)
        sat = ((torch.full((m, kg), 3 ** 5 - 1, dtype=torch.uint8, device=dev),
                torch.ones((n, kg * 5), device=dev), torch.full((n,), 1.0, device=dev) * INV_Q_MAX,
                torch.ones((m,), device=dev)), dict(g=5, out_dtype=torch.float32))
        if not torch.equal(kern(*sat[0], **sat[1]), plain(*sat[0], **sat[1])):
            raise AssertionError(f"{name}: saturated sums differ from the plain version")
        t = splitk_traps(torch, name, kern, plain, cases + [sat])
        t["plans"] = [plan_row(plan(*shape)) for shape in LUT_RAGGED]
        t["saturated"] = {"shape": [m, kg, n], "splits": plan(m, kg, n, 5).splits, "sum": 127 * kg * 5}
        if all(row["kg_divisible_by_splits"] for row in t["plans"]):
            raise AssertionError(f"{name}: no trap shape has KG indivisible by its splits")
        log(f"kernels: {name} traps: {t['cases']} cases (ragged, saturated sums 127*K at the "
            f"largest split {t['saturated']}), each launched twice back to back and in a CUDA "
            f"graph replayed {LUT_REPLAYS} times: max |diff| 0")
        for row in t["plans"]:
            log(f"kernels: {name} plan (M, KG, N, g) = {tuple(row['shape'])}: "
                + ", ".join(f"{k} {v}" for k, v in row.items() if k not in ("shape",)))
        traps[name] = t

    # device time of one forward's 224 launches (all 32 layers' weights,
    # so the ~63 MB of packed weights stream from memory as in serving)
    lins = [m for m in model.modules() if isinstance(m, PackedLinear)]
    assert len(lins) == 7 * cfg.n_layers and all(lin.pw.k4 == 0 for lin in lins)  # g=5 only
    per_n = {}
    for n in TOKENS:
        per_n[n] = row = forward_launch_ms(torch, lins, n, gen)
        log(f"kernels: forward of 224 BitLinears at N={n}: bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), "
            + ", ".join(f"{nm} {row[nm]['ms']:.4f} ms (eager {row[nm]['eager_ms']:.4f}, "
                        f"plain {row[nm]['plain_ms']:.4f})" for nm in kernels)
            + f", bf16 matmul yardstick {row['library_ms']:.4f} ms")
    return max_err, per_n, weights, traps


#: device traces taken of one run before a disagreement with the wrappers
#: fails it
TRACE_ATTEMPTS = 3


class TraceMismatch(AssertionError):
    """A device trace whose kernel records are not the wrappers' counts."""


def trace_attempts(fn):
    """`fn` (a traced run: → its row) run again, up to TRACE_ATTEMPTS runs
    in all, while its device trace disagrees with the wrappers' counts
    (`TraceMismatch`). The profiler drops a record now and then (on the
    H100: a trace's last records, or one marker, in about one trace of
    fifty; `PERF.md`, PR 32): a launch counted and not made repeats on
    every run and still fails. Each disagreement is logged and kept under
    the row's "trace_mismatches"."""
    @functools.wraps(fn)
    def run(*a, **kw):
        seen = []
        while True:
            try:
                row = fn(*a, **kw)
            except TraceMismatch as e:
                seen.append(str(e))
                if len(seen) == TRACE_ATTEMPTS:
                    raise AssertionError(f"{fn.__name__}: {TRACE_ATTEMPTS} device traces of "
                                         "the run disagree with the wrappers: "
                                         + " | ".join(seen)) from e
                log(f"trace: {e} (run {len(seen)} of {TRACE_ATTEMPTS}; again)")
            else:
                row["trace_mismatches"] = seen
                return row
            gc.collect()        # the failed run's engine and step graphs
    return run


def drop_graphs(eng) -> None:
    """Free an engine's step graphs (and their pool) now: an engine whose
    methods the script wraps holds itself in a cycle, and a full-width
    model's graphs keep its f32 head's temporaries (command-r: 8.4 GB) in
    their pool until the collector runs."""
    eng.graphs.clear()


@trace_attempts
def serve(torch, model, cfg, impl: str, prompts, counters, fusion: str = "fused",
          traced: bool = True):
    """Phases 4 and 5, one impl and fusion: warm up, zero the counts, drive
    the main path under a `device_trace`, whose kernel records must be
    the wrappers' counts (`device_launches`; its rates are taken with the
    trace on). Phases 16-18 serve again with `traced` off (no trace,
    `device_launches` None)."""
    from repro_torch.serve import ContinuousBatchingScheduler, Engine, Request

    eng = Engine(model, cfg, max_slots=4, max_len=256, mpgemm_impl=impl,
                 mpgemm_fusion=fusion, device="cuda")
    warm = ContinuousBatchingScheduler(eng)
    warm.submit([Request(rid=-1, prompt=prompts[0][:16], max_new_tokens=2)])
    warm.run_to_completion()
    eng.reset_stats()
    spent = {"prefill": 0.0, "decode": 0.0}

    def timed(fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)   # add() and decode_once() end in a host sync
            spent[key] += time.perf_counter() - t0
            return out
        return wrapper

    eng.add = timed(eng.add, "prefill")
    eng.decode_once = timed(eng.decode_once, "decode")
    sched = ContinuousBatchingScheduler(eng)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
    for fn in counters.values():
        fn.launches = 0
    with device_trace(torch) if traced else contextlib.nullcontext() as prof:
        sched.submit(reqs)
        stats = sched.run_to_completion()
    launches = {name: fn.launches for name, fn in counters.items()}
    device_launches = None
    if traced:
        device_launches, _ = traced_launches(prof, counters)
        held_to_trace(f"{impl}/{fusion}", launches, device_launches)
    forwards = len(reqs) + stats.decode_steps
    drop_graphs(eng)
    if stats.completed != len(reqs) or any(len(r.generated) != 16 for r in reqs):
        raise AssertionError(f"{impl}/{fusion}: {stats.completed}/{len(reqs)} requests completed")
    return {
        "tokens": [list(map(int, r.generated)) for r in reqs],
        "launches": launches, "device_launches": device_launches, "forwards": forwards,
        "prefill_tokens": stats.prefill_tokens, "decode_tokens": stats.decode_tokens,
        "decode_steps": stats.decode_steps,
        "prefill_tok_s": stats.prefill_tokens / spent["prefill"],
        "decode_tok_s": stats.decode_tokens / spent["decode"],
        # ServeStats' rates: the same tokens over the whole run's wall time
        "run_prefill_tok_s": stats.prefill_tok_s, "run_decode_tok_s": stats.decode_tok_s,
        "ttft_p50_ms": sorted(stats.ttft_s)[len(stats.ttft_s) // 2] * 1e3,
        "wall_s": stats.wall_s,
    }


def check_unfused(torch, model, cfg, weights, prompts, counters, fused_runs, per_n) -> dict:
    """Phase 5: the unfused pipeline. (a) Each integer kernel against its
    plain version; (b) `vlut_mpgemm` fused against unfused; (c) serving
    through it; (d) the fusion ablation's device times per forward; (e) the
    paper's comparison of methods at (M, K) = COMPARE_SHAPE."""
    from repro_torch.core import (
        act_quant_tokens,
        mad_gemm,
        mad_gemm_int8,
        scalar_lut_gemm,
        vlut_gemm,
    )
    from repro_torch.kernels import ops, ref_mpgemm
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg
    from repro_torch.models.common import PackedLinear

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    kernels = int_kernels()

    # (a) kernels against their plain versions: exact integers, diff 0
    max_err, n_checks = int_vs_plain(torch, weights, TOKENS, gen)
    for g, (m, kg) in SATURATED:                 # all +1 weights, activations 127
        packed = torch.full((m, kg), 3 ** g - 1, dtype=torch.uint8, device=dev)
        a_r = torch.full((g, kg, 16), 127, dtype=torch.int8, device=dev)
        for name, (kern, plain) in kernels.items():
            out = kern(packed, a_r, g=g)
            max_err[name] = max(max_err[name], (out.long() - plain(packed, a_r, g=g).long())
                                .abs().max().item())
            n_checks += 1
            if not int(out.min()) == int(out.max()) == 127 * kg * g:
                raise AssertionError(f"{name}: saturated sums {int(out.min())}..{int(out.max())}, "
                                     f"expected {127 * kg * g}")
    log(f"unfused: {n_checks} kernel-vs-plain checks (incl. saturated sums 127*K), "
        f"max |diff| {max_err}")
    for name, err in max_err.items():
        if err != 0:
            raise AssertionError(f"{name} differs from its plain version by {err} (expected 0)")

    # each integer kernel's split-K traps, as phase 3's
    traps = {}
    for name, plan in (("vlut_lookup_gemm", vlg.lut_plan), ("ternary_decode_gemm", tdg.decode_plan)):
        kern, plain = kernels[name]
        cases = []
        for m, kg, n, g in LUT_RAGGED:
            cases.append(((torch.randint(0, 3 ** g, (m, kg), generator=gen, device=dev,
                                         dtype=torch.int32).to(torch.uint8),
                           torch.randint(-127, 128, (g, kg, n), generator=gen, device=dev,
                                         dtype=torch.int32).to(torch.int8)), dict(g=g)))
        m, kg, n = largest_split(plan)
        sat = ((torch.full((m, kg), 3 ** 5 - 1, dtype=torch.uint8, device=dev),
                torch.full((5, kg, n), 127, dtype=torch.int8, device=dev)), dict(g=5))
        out = kern(*sat[0], **sat[1])
        torch.cuda.synchronize()
        if not int(out.min()) == int(out.max()) == 127 * kg * 5:
            raise AssertionError(f"{name}: saturated sums {int(out.min())}..{int(out.max())} "
                                 f"at the largest split, expected {127 * kg * 5}")
        t = splitk_traps(torch, name, kern, plain, cases + [sat])
        t["saturated"] = {"shape": [m, kg, n], "splits": plan(m, kg, n, 5).splits,
                          "sum": 127 * kg * 5}
        log(f"unfused: {name} traps: {t['cases']} cases (ragged, saturated sums 127*K at the "
            f"largest split {t['saturated']}), each launched twice back to back and in a CUDA "
            f"graph replayed {LUT_REPLAYS} times: max |diff| 0")
        traps[name] = t

    # (b) vlut_mpgemm fused against unfused
    fu_err = {impl: 0.0 for impl in IMPLS}
    for (m, k), pw in weights.items():
        for n in TOKENS:
            a = torch.randn((k, n), generator=gen, device=dev) * 3.0
            for impl in IMPLS:
                fused = ops.vlut_mpgemm(pw, a, impl=impl)
                unfused = ops.vlut_mpgemm(pw, a, impl=impl, fusion="unfused")
                err = (fused - unfused).abs().max().item()
                bound = FUSION_RTOL * fused.abs().max().item() if pw.k4 and pw.k5 else 0.0
                if not err <= bound:
                    raise AssertionError(f"{impl}: fused and unfused differ by {err} > {bound} "
                                         f"at M {m} K {k} N {n}")
                fu_err[impl] = max(fu_err[impl], err)
    log(f"unfused: vlut_mpgemm fused vs unfused, bit-identical on one segment, max |diff| "
        f"{fu_err} (K = 964 bound: {FUSION_RTOL} of max |out|)")

    # (c) serving through the unfused pipeline
    runs = {}
    for name, meta in KERNEL_META.items():
        if meta["fusion"] != "unfused":
            continue
        impl = meta["impl"]
        r = serve(torch, model, cfg, impl, prompts, counters, fusion="unfused")
        want = {nm: (224 * r["forwards"] if nm == name else 0) for nm in counters}
        if r["launches"] != want:
            raise AssertionError(f"impl={impl} unfused: launches {r['launches']}, expected {want}")
        if r["tokens"] != fused_runs[impl]["tokens"]:
            raise AssertionError(f"impl={impl}: the unfused pipeline emitted other greedy tokens "
                                 "than the fused one")
        runs[impl] = r
        log(f"serve: impl={impl} fusion=unfused forwards={r['forwards']} launches={r['launches']} "
            f"prefill_tok_s={r['prefill_tok_s']:.1f} decode_tok_s={r['decode_tok_s']:.1f} "
            f"ttft_p50_ms={r['ttft_p50_ms']:.2f} wall_s={r['wall_s']:.3f} (tokens = fused run's)")

    # (d) device time of one forward's 224 BitLinears at each N
    lins = [m for m in model.modules() if isinstance(m, PackedLinear)]
    assert len(lins) == 7 * cfg.n_layers and all(lin.pw.k4 == 0 for lin in lins)  # g=5 only
    w_int8 = [lin.pw.unpack() for lin in lins]                       # (M, K) for torch._int_mm
    per_n_unfused = {}
    for n in TOKENS:
        xs = {k: torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
              for k in {lin.pw.K for lin in lins}}
        a_qs = {k: act_quant_tokens(x.T)[0] for k, x in xs.items()}    # (K, N) int8
        a_rs = {k: ops._deinterleave(q, 5) for k, q in a_qs.items()}
        shapes = [(lin.pw.M, lin.pw.K) for lin in lins]
        nbytes = sum(lin.packed5.numel() + k * n + 4 * m * n for lin, (m, k) in zip(lins, shapes))
        nops = sum(2 * m * n * k for m, k in shapes)
        row = {"bytes": nbytes, "int8_ops": nops,
               "bound_ms": max(nbytes / HBM_BYTES_S, nops / INT8_OPS_S) * 1e3,
               "bound_by": "bytes" if nbytes / HBM_BYTES_S >= nops / INT8_OPS_S else "operations",
               # gemm_bench.py's count: the int8 activation buffer, its
               # de-interleaved copy and the int32 output, each written once
               # and read once
               "bytes_avoided_by_fusion": sum(2 * k * n + 2 * k * n + 2 * 4 * m * n
                                              for m, k in shapes)}

        def run(fn, lins=lins, a_rs=a_rs):
            for lin in lins:
                fn(lin.packed5, a_rs[lin.pw.K], g=5)

        for name, (kern, plain) in kernels.items():
            row[name] = {"ms": device_ms(torch, lambda: run(kern)),
                         "plain_ms": device_ms(torch, lambda: run(plain), reps=1)}

        def pipeline(impl, fusion, lins=lins, xs=xs):
            for lin in lins:
                ops.ternary_matmul(lin.pw, xs[lin.pw.K], impl=impl, fusion=fusion)

        row["pipeline"] = {
            f"{fusion}_{impl}": {
                "ms": device_ms(torch, lambda: pipeline(impl, fusion)),
                "eager_ms": eager_ms(torch, lambda: pipeline(impl, fusion))}
            for impl in IMPLS for fusion in ("fused", "unfused")}
        if n > 16:   # torch._int_mm's shape rules: more than 16 rows, K and M multiples of 8
            qs = {k: q.T.contiguous() for k, q in a_qs.items()}       # (N, K)
            row["library"] = {"call": "torch._int_mm (int8 unpacked weights)", "ms": device_ms(
                torch, lambda: [torch._int_mm(qs[lin.pw.K], w.T) for lin, w in zip(lins, w_int8)])}
        else:
            row["library"] = {"call": "bf16 torch.matmul (phase 3)", "ms": per_n[n]["library_ms"]}
        per_n_unfused[n] = row
        pipe = row["pipeline"]
        log(f"unfused: forward of 224 BitLinears at N={n}: bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), "
            + ", ".join(f"{nm} {row[nm]['ms']:.4f} ms (plain {row[nm]['plain_ms']:.4f})"
                        for nm in kernels)
            + f", {row['library']['call']} {row['library']['ms']:.4f} ms; pipelines (device/eager ms): "
            + ", ".join(f"{key} {v['ms']:.4f}/{v['eager_ms']:.4f}" for key, v in pipe.items())
            + f"; fusion avoids {row['bytes_avoided_by_fusion'] / 1e6:.2f} MB")
    del w_int8

    # (e) the paper's comparison of methods at one BitLinear shape
    pw = weights[COMPARE_SHAPE]
    methods = {
        "vlut_gemm": lambda a: vlut_gemm(pw, a),
        "scalar_lut_gemm": lambda a: scalar_lut_gemm(pw, a),
        "mad_gemm": lambda a: mad_gemm(pw, a),
        "mad_gemm_int8": lambda a: mad_gemm_int8(pw, a),
    }
    for impl in IMPLS:
        for fusion in ("fused", "unfused"):
            methods[f"{fusion}_{impl}"] = (
                lambda a, impl=impl, fusion=fusion: ops.vlut_mpgemm(pw, a, impl=impl, fusion=fusion))
    compare = {}
    for n in TOKENS:
        a = torch.randn((COMPARE_SHAPE[1], n), generator=gen, device=dev) * 3.0
        want = ref_mpgemm(pw, a)
        row = {}
        for name, fn in methods.items():
            got = fn(a)
            torch.cuda.synchronize()
            err = (got - want).abs()
            if name == "mad_gemm":   # no activation quantization: the JAX suite's bound
                ok = bool((err <= MAD_TOL["atol"] + MAD_TOL["rtol"] * want.abs()).all())
            else:
                ok = torch.equal(got, want)
            if not ok:
                raise AssertionError(f"{name} at N={n} disagrees with ref_mpgemm "
                                     f"(max |diff| {err.max().item()})")
            row[name] = {"ms": device_ms(torch, lambda: fn(a)), "max_abs_err": err.max().item()}
        winner = min(row, key=lambda nm: row[nm]["ms"])
        compare[n] = {"methods": row, "winner": winner}
        log(f"compare: (M, K) = {COMPARE_SHAPE}, N={n}: "
            + ", ".join(f"{nm} {v['ms']:.4f}" for nm, v in row.items())
            + f" ms; winner {winner}")
    return {"max_abs_err": max_err, "checks": n_checks, "splitk_traps": traps,
            "fused_vs_unfused_max_abs_diff": fu_err,
            "serve": runs, "per_tokens": per_n_unfused, "compare": compare}


def device_time_by_kernel(averages, steps: int) -> list:
    """[(device ms per step, kernel name)], largest first: the device-side
    entries of a trace's `key_averages()` (CPU ops carry their kernels'
    time too). Each profile takes its averages once: on a training step's
    trace one pass costs ~10 s of host time."""
    def dev_us(ev):
        return getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0))

    return sorted(((dev_us(ev) / steps / 1e3, ev.key) for ev in averages
                   if str(ev.device_type).endswith("CUDA") and dev_us(ev) > 0), reverse=True)


def device_only():
    """The profiler's activities where only the kernels' device time is
    read: the device alone. Tracing the host's ops too costs each op its
    record (a step's wall time grows) and the trace's averages ~2.5x the
    host time (a training step's ~20 s against ~8)."""
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA]


#: the kernel `tick_marker` launches (ATen's `spin_kernel`)
MARKER_KERNEL = "spin_kernel"
#: tiny kernels `device_trace` launches before its start marker and after
#: its end marker
TRACE_FILLER = 1 << 12


def tick_marker(torch) -> None:
    """One empty kernel on the current stream: in a device trace it ends a
    tick (every kernel before it in stream order belongs to that tick or
    an earlier one)."""
    torch.cuda._sleep(0)


def trace_filler(torch) -> None:
    """TRACE_FILLER tiny kernels on the current stream."""
    one = torch.zeros(1, device="cuda")
    for _ in range(TRACE_FILLER):
        one.add_(1)


def cupti_flush() -> None:
    """Have CUPTI hand over every activity record it holds now, those of
    incomplete buffers included (`cuptiActivityFlushAll` with
    CUPTI_ACTIVITY_FLAG_FLUSH_FORCED), from the library the profiler
    loaded."""
    import ctypes

    with open("/proc/self/maps") as maps:
        path = next((ln.split()[-1] for ln in maps if "libcupti" in ln.rsplit("/", 1)[-1]), None)
    if path is None:
        raise RuntimeError("no libcupti in this process: the device trace cannot be flushed")
    rc = ctypes.CDLL(path).cuptiActivityFlushAll(ctypes.c_uint32(1))
    if rc:
        raise RuntimeError(f"cuptiActivityFlushAll returned {rc}")


@contextlib.contextmanager
def device_trace(torch):
    """A device-only `torch.profiler` trace of the body, bracketed by two
    `tick_marker`s (the start and end markers), with TRACE_FILLER tiny
    kernels before the start marker and after the end marker, and CUPTI's
    records flushed (`cupti_flush`) before the trace stops. The profiler
    keeps only the records that reach it before it stops, inside its
    window: one stopped right after its work loses its last records (on
    the H100: up to ~65,000, the last ~4 decode ticks' kernels of a
    serving run, even behind 32,768 tiny kernels), and one started right
    before it may lose its first. The fillers keep the body's records away
    from both edges, and `traced_launches` requires both markers, so a
    record lost inside them fails the run."""
    from torch.profiler import profile

    with profile(activities=device_only()) as prof:
        trace_filler(torch)
        tick_marker(torch)
        yield prof
        tick_marker(torch)
        trace_filler(torch)
        torch.cuda.synchronize()
        cupti_flush()


def traced_launches(prof, counters, ticks: int = 0) -> tuple:
    """The kernel launches of a `device_trace`, counted on the device:
    graph replays included, CUPTI records each kernel node. A record is a
    wrapper's when its name holds one of the wrapper's `cuda_kernels` and,
    exactly for the integer wrappers (`int_acts`), ``signed char`` among
    its template arguments. The records are taken in the device's order
    between the start and end markers, which must be there; with `ticks`,
    the run called `tick_marker` after each of its `ticks` ticks and they
    are also split at those markers. → ({wrapper name: records}, [records
    of any wrapper, per tick] or None)."""
    owner: dict = {}

    def owner_of(name):
        if name not in owner:
            owner[name] = next((nm for nm, fn in counters.items()
                                if ("signed char" in name) == fn.int_acts
                                and any(re.search(rf"\b{k}\b", name) for k in fn.cuda_kernels)),
                               MARKER_KERNEL if re.search(rf"\b{MARKER_KERNEL}\b", name) else None)
        return owner[name]

    records = []
    for e in prof.profiler.kineto_results.events():
        nm = owner_of(e.name())
        if nm is not None:
            records.append((e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000, nm))
    totals, segments, n = {nm: 0 for nm in counters}, [], 0
    for _, nm in sorted(records):
        if nm == MARKER_KERNEL:
            segments.append(n)
            n = 0
        else:
            totals[nm] += 1 if segments else 0
            n += 1
    # segments: before the start marker, each tick, after the last tick
    if len(segments) != ticks + 2 or n or segments[0] or (ticks and segments[-1]):
        raise TraceMismatch(
            f"the device trace holds {len(segments)} markers for its start, {ticks} ticks and "
            f"its end, {segments[0] if segments else 0} launches before the start, "
            f"{segments[-1] if ticks and segments else 0} between the last tick and the end and "
            f"{n} after the end (a record lost, or a launch outside a tick)")
    return totals, (segments[1:ticks + 1] if ticks else None)


def held_to_trace(label: str, wrapper: dict, traced: dict) -> None:
    """The wrappers' counts must be the kernel records a device trace saw."""
    if wrapper != traced:
        raise TraceMismatch(f"{label}: the wrappers counted {wrapper} launches, the device "
                            f"trace holds {traced}")


@contextlib.contextmanager
def syncs_raise(torch):
    """Every `StepGraphs.upload` (a step's inputs staged) and replay under
    the sync debug mode's "error": a host sync in either raises."""
    from repro_torch.serve.graphs import StepGraphs

    def guarded(fn):
        def run(*a, **kw):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        return run

    with planted(StepGraphs, "upload", guarded(StepGraphs.upload)), \
            planted(StepGraphs, "_replay", guarded(StepGraphs._replay)):
        yield


def op_device_ms(averages, steps: int, names=("aten::index", "aten::index_put_")) -> dict:
    """{op: [device ms per step, calls per step]} of the named CPU ops (the
    device time of the kernels each launched) in a trace's `key_averages()`;
    ops absent from the trace are left out."""
    out = {}
    for ev in averages:
        if ev.key in names:
            us = getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
            out[ev.key] = [us / steps / 1e3, ev.count / steps]
    return out


def profile_decode(torch, model, cfg, prompts, steps: int = 2, spec=None, paged=None,
                   op_names=("aten::index", "aten::index_put_"), cuda_graphs=True) -> dict:
    """Where a decode step's time goes: `torch.profiler` over `steps`
    batched decode steps of 4 full slots (impl="decode"; with `spec`, each
    step is draft, verify and accept; with `paged`, a PagedKVConfig, the
    cache is paged), replayed as CUDA graphs unless `cuda_graphs` is False
    (the warm-up steps make the eager call and the capture). Device time
    by kernel, the device's busy share of the wall time, the wall time per
    step, and the device time of the `op_names` (with none, the profiler
    traces the device only; a replay runs no host op to attribute its
    kernels to, so only eager steps give them)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import Engine, Request

    eng = Engine(model, cfg, max_slots=4, max_len=256, mpgemm_impl="decode", spec=spec,
                 paged_kv=paged, device="cuda", cuda_graphs=cuda_graphs)
    per_step = 1 + (spec.k if spec is not None else 0)     # the most a step emits
    for i, p in enumerate(prompts[:4]):
        assert eng.add(Request(rid=i, prompt=p, max_new_tokens=per_step * (steps + 2) + 2))
    eng.decode_once()
    eng.decode_once()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if op_names else device_only()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.decode_once()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    drop_graphs(eng)

    averages = prof.key_averages()
    by_name = device_time_by_kernel(averages, steps)
    device_ms = sum(ms for ms, _ in by_name)
    return {"wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if device_ms else None,
            "top_kernels_ms_per_step": [[name[:90], ms] for ms, name in by_name[:8]],
            "op_device_ms_per_step": op_device_ms(averages, steps, op_names)}


def clone_cache(cache: list) -> list:
    return [{k: v.clone() for k, v in layer.items()} for layer in cache]


@contextlib.contextmanager
def planted(module, name: str, fn):
    """module.name = fn for the duration of one call: a planted fault, a
    stub, or the kernels' plain versions in their place."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, orig)


def check_verify(torch, model, cfg, prompt, continuation) -> dict:
    """Phase 8 (b): after a prefill of one prompt, `verify_step` over k+1
    tokens against k+1 `decode_step` calls (logits within VERIFY_RTOL, idx
    equal), and a tree verify of SPEC_TREE against the sequential decode of
    each root-to-leaf path. Each check also runs once with a fault planted
    (chain: the causal mask dropped, so a token sees the ones after it;
    tree: the ancestor gate dropped, so a node sees its siblings and their
    subtrees) and must then read above VERIFY_RTOL."""
    import numpy as np

    from repro_torch.models import attention, decode_step, init_cache, prefill, verify_step
    from repro_torch.spec import build_tree

    dev = torch.device("cuda")
    mask = attention._mask
    with torch.no_grad():
        logits, cache = prefill(model, torch.from_numpy(prompt[None]).to(dev),
                                init_cache(cfg, 1, 256, device=dev), cfg)
        t0 = int(logits[0].argmax())

        def sequential(toks):
            c, out = clone_cache(cache), []
            for t in toks:
                row, c = decode_step(model, torch.tensor([[t]], dtype=torch.int32, device=dev), c, cfg)
                out.append(row[0].float())
            return torch.stack(out), c

        def rel_err(got, want):
            return ((got.float() - want).abs().max() / want.abs().max()).item()

        chain = [t0] + [int(t) for t in continuation[:SPEC_K]]
        seq, seq_cache = sequential(chain)
        ver, ver_cache = verify_step(model, torch.tensor([chain], dtype=torch.int32, device=dev),
                                     clone_cache(cache), cfg)
        chain_err = rel_err(ver[0], seq)
        if not all(torch.equal(a["idx"], b["idx"]) for a, b in zip(seq_cache, ver_cache)):
            raise AssertionError("verify_step and sequential decode left different idx")
        with planted(attention, "_mask", lambda q, kv, causal, window: mask(q, kv, False, window)):
            bad, _ = verify_step(model, torch.tensor([chain], dtype=torch.int32, device=dev),
                                 clone_cache(cache), cfg)
        chain_fault = rel_err(bad[0], seq)
        tree = build_tree(SPEC_K, SPEC_TREE)
        toks = np.random.default_rng(3).integers(0, cfg.vocab, tree.n_nodes).astype(np.int32)
        toks[0] = t0
        paths = [(torch.from_numpy(path).long().to(dev),
                  sequential([int(toks[j]) for j in path])[0]) for path in tree.leaf_paths]

        def tree_verify():
            out, _ = verify_step(model, torch.from_numpy(toks[None]).to(dev), clone_cache(cache),
                                 cfg, tree=tree)
            return max(rel_err(out[0, cols], want) for cols, want in paths)

        tree_err = tree_verify()
        with planted(attention, "tree_step_gate", lambda *a: None):
            tree_fault = tree_verify()
    log(f"multi: verify_step over {len(chain)} tokens vs sequential decode: max |diff| "
        f"{chain_err:.2e} of the largest logit; tree {SPEC_TREE} ({tree.n_nodes} nodes, "
        f"{len(tree.leaf_paths)} paths) {tree_err:.2e} (bound {VERIFY_RTOL}); planted faults "
        f"read {chain_fault:.2e} (chain, causal mask dropped) and {tree_fault:.2e} (tree, "
        f"ancestor gate dropped)")
    for what, err in (("chain", chain_err), ("tree", tree_err)):
        if not err <= VERIFY_RTOL:
            raise AssertionError(f"{what} verify_step differs from sequential decode by {err} "
                                 f"> {VERIFY_RTOL} of the largest logit")
    for what, err in (("chain", chain_fault), ("tree", tree_fault)):
        if not err > VERIFY_RTOL:
            raise AssertionError(f"the {what} check does not see its planted fault: {err} <= "
                                 f"{VERIFY_RTOL} of the largest logit")
    return {"chain_rel_err": chain_err, "tree_rel_err": tree_err, "chain_tokens": len(chain),
            "tree_nodes": tree.n_nodes, "tree_paths": len(tree.leaf_paths), "rtol": VERIFY_RTOL,
            "planted_chain_no_causal_rel_err": chain_fault,
            "planted_tree_no_gate_rel_err": tree_fault}


def near_tie(torch, model, cfg, prompt, ref, got, max_len: int = 256) -> dict:
    """The first step where `got` leaves the reference tokens `ref`: the
    whole-prompt reference logits there (prefill, then decode of ref's
    earlier tokens, on the card; SSM layers admit at the exact length, as
    the engine does); raises unless the two tokens are within TIE_RTOL of
    the largest logit."""
    from repro_torch.models import decode_step, init_cache, prefill_into_slot

    dev = torch.device("cuda")
    t = next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b)
    exact = any(sp.mixer == "ssm" for sp in cfg.layer_specs())
    with torch.no_grad():
        row, cache, _ = prefill_into_slot(model, init_cache(cfg, 1, max_len, device=dev), 0,
                                          prompt, cfg, max_len=max_len, exact_len=exact)
        for tok in ref[:t]:
            row, cache = decode_step(model, torch.tensor([[tok]], dtype=torch.int32, device=dev),
                                     cache, cfg)
    row = row[0].float()
    gap = abs((row[ref[t]] - row[got[t]]).item())
    scale = row.abs().max().item()
    tie = {"step": t, "ref_token": ref[t], "token": got[t], "gap": gap, "max_abs_logit": scale}
    if gap > TIE_RTOL * scale:
        raise AssertionError(f"greedy divergence at step {t} is no near-tie: {tie}")
    return tie


def fusion_divergences(torch, model, cfg, cases, max_len: int = 256, f32: bool = False) -> list:
    """For each (prompt, ref, got) of `cases`, the first step where the
    unfused run's tokens `got` leave the fused run's `ref`, replayed on the
    card under both pipelines, all cases in one batch (each prompt
    prefilled into a slot of its own, B = 1, then decode steps of the rows'
    ref tokens; a row's logits are read at its step): each pipeline's
    logits there, and the MoE routing decisions (tokens whose top-k expert
    set differs) the two pipelines took apart on the row's way to it. The
    batch changes no row's numbers the divergence turns on: activations are
    quantized per token, attention is per row, and a decode step of at most
    16 rows is dropless in every MoE layer, as one row is. Fused sums each
    segment in f32, unfused in int32 before one dequant: a bf16 rounding
    apart, which can move a token across a top-k boundary of the router,
    and a routing flip moves the logits by far more than rounding. Raises
    unless each divergence is a near-tie (TIE_RTOL, the fused logits) or
    follows a routing flip. With `f32` (phases 12, 13, 20 and 21), the
    fused pipeline is replayed on an f32 copy of the model for the rows
    that are neither, and such a divergence is also accepted where the two
    pipelines' logits there differ by more than the gap between the two
    tokens but by no more than the fused pipeline's own bf16 rounding moves
    them (its distance to the f32 copy, or LOGIT_RTOL of the largest logit
    if that is larger): the swap is then within the model's rounding
    sensitivity, which a fault in either pipeline would far exceed. SSM
    layers admit at the exact length, as the engine does."""
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, init_cache, moe, prefill_into_slot

    dev = torch.device("cuda")
    steps = [next(i for i, (a, b) in enumerate(zip(got, ref)) if a != b) for _, ref, got in cases]
    exact = any(sp.mixer == "ssm" for sp in cfg.layer_specs())

    def replay(m, c, fusion, rows_of):
        """The logits of the cases `rows_of` (in that order, a row each) at
        their steps, under `fusion`, and the router's picks by call:
        [(("prefill", case) or ("decode", step), sorted picks)]."""
        rec, at, n = [], [None], len(rows_of)

        def top_k(scores, k, _orig=moe.top_k_indices):
            out = _orig(scores, k)
            rec.append((at[0], out.sort(-1).values))
            return out

        got_rows = [None] * n
        with torch.no_grad(), planted(moe, "top_k_indices", top_k), \
                ops.dispatch_override(impl="decode", fusion=fusion):
            cache = init_cache(c, n, max_len, device=dev)
            for j, i in enumerate(rows_of):
                at[0] = ("prefill", i)
                row, cache, _ = prefill_into_slot(m, cache, j, cases[i][0], c, max_len=max_len,
                                                  exact_len=exact)
                if steps[i] == 0:
                    got_rows[j] = row[0]
            for t in range(max(steps[i] for i in rows_of)):
                at[0] = ("decode", t)
                tok = torch.tensor([[cases[i][1][t]] for i in rows_of], dtype=torch.int32,
                                   device=dev)
                out, cache = decode_step(m, tok, cache, c)
                for j, i in enumerate(rows_of):
                    if steps[i] == t + 1:
                        got_rows[j] = out[j]
        return [r.float() for r in got_rows], rec

    if not cases:
        return []
    everyone = list(range(len(cases)))
    (fused, picks), (unfused, picks_u) = (replay(model, cfg, fusion, everyone)
                                          for fusion in ("fused", "unfused"))
    flips, routed = [0] * len(cases), [0] * len(cases)
    for (place, a), (_, b) in zip(picks, picks_u):
        differ = (a != b).any(-1)
        if place[0] == "prefill":
            flips[place[1]] += int(differ.sum())
            routed[place[1]] += int(a.shape[0])
        else:
            for i, st in enumerate(steps):
                if place[1] < st:
                    flips[i] += int(differ[i])
                    routed[i] += 1
    out = []
    for i, ((_, ref, got), t) in enumerate(zip(cases, steps)):
        gap = abs((fused[i][ref[t]] - fused[i][got[t]]).item())
        scale = fused[i].abs().max().item()
        out.append({"step": t, "ref_token": ref[t], "token": got[t], "gap": gap,
                    "gap_unfused": abs((unfused[i][ref[t]] - unfused[i][got[t]]).item()),
                    "max_abs_logit": scale, "near_tie": gap <= TIE_RTOL * scale,
                    "routing_flips": flips[i], "routed_tokens": routed[i],
                    "replay_rows": len(cases),
                    "logits_max_abs_diff": (fused[i] - unfused[i]).abs().max().item()})
    rest = [i for i, d in enumerate(out) if not d["near_tie"] and not d["routing_flips"]]
    if rest and f32:
        f32_model = copy.deepcopy(model).float()
        rows32, _ = replay(f32_model, cfg.with_(dtype="float32"), "fused", rest)
        del f32_model
        torch.cuda.empty_cache()
        for i, r in zip(rest, rows32):
            d = out[i]
            d["bf16_vs_f32_max_abs_diff"] = (fused[i] - r).abs().max().item()
            d["within_rounding"] = (d["gap"] <= d["logits_max_abs_diff"]
                                    <= max(d["bf16_vs_f32_max_abs_diff"],
                                           LOGIT_RTOL * d["max_abs_logit"]))
    for d in out:
        if not (d["near_tie"] or d["routing_flips"] or d.get("within_rounding")):
            raise AssertionError(f"greedy divergence at step {d['step']} is no near-tie, no "
                                 "routing flip precedes it" + (", and it is not within the "
                                 "model's rounding sensitivity" if f32 else "") + f": {d}")
    return out


def tie_check(torch, model, cfg, label, prompts, ref, got, ref_name="the reference",
              max_len: int = 256) -> list:
    """Each request's tokens `got` equal the reference tokens `ref`, or
    leave them only at a near-tie (`near_tie` raises otherwise); logs and
    returns the ties."""
    ties = [near_tie(torch, model, cfg, p, r, g, max_len)
            for p, r, g in zip(prompts, ref, got) if g != r]
    log(f"{label}: greedy tokens {f'equal {ref_name}' if not ties else f'leave {ref_name} at '}"
        + ", ".join(f"step {t['step']} (gap {t['gap']:.2e} of {t['max_abs_logit']:.3f})"
                    for t in ties))
    return ties


def single_kernel(impl: str, fusion: str = "fused") -> str:
    """The name of the single mpGeMM kernel an impl and fusion launch."""
    name = "vlut_lookup_gemm" if impl == "lookup" else "ternary_decode_gemm"
    return f"{name}_fused" if fusion == "fused" else name


def mla_expands(s: int, verify: bool, prefill_resume: bool) -> bool:
    """Whether a forward of S tokens over a cache runs its MLA layers'
    `wkv_b` BitLinear: the naive prefill and the chunked-prefill resume read
    expand the latents through it, the absorbed decode and verify unpack it
    instead (`models.mla.mla_apply`'s rule)."""
    return s > 1 and (prefill_resume or not verify)


def launches_per_forward(model, impl: str, fusion: str = "fused", expand: bool = True) -> dict:
    """{kernel: launches per forward} of `model`: one launch per packed
    segment of every BitLinear, the single kernel for a dense weight and
    the grouped one for stacked experts (smollm-360m: 224 single;
    llama4-scout: 8 single and 4 grouped per layer; deepseek-v3: 14 single
    and 6 grouped per MoE layer, 14 single per dense one, and with `expand`
    2 more single a layer for MLA's `wkv_b`)."""
    from repro_torch.models.common import PackedLinear

    single = single_kernel(impl, fusion)
    out = {single: 0, f"{single}_grouped": 0}
    for name, lin in model.named_modules():
        if isinstance(lin, PackedLinear) and (expand or not name.endswith("mixer.wkv_b")):
            segs = int(lin.packed5.shape[-1] > 0) + int(lin.packed4.shape[-1] > 0)
            out[f"{single}_grouped" if lin.packed5.ndim == 3 else single] += segs
    return {k: v for k, v in out.items() if v}


def reckoned_launches(cfg, impl: str, fusion: str = "fused") -> dict:
    """{kernel: launches per forward} reckoned from the config's layer
    specs alone, to hold `launches_per_forward`'s count on the model
    against: one launch per packed segment of each BitLinear (two where 5
    does not divide K, `pack_group_sizes`), the single kernel for a dense
    weight and the grouped one for a MoE layer's stacked experts; attention
    and SSM mixers, dense and MoE FFNs (phases 12, 13, 20 and 21)."""
    from repro_torch.core.packing import pack_group_sizes

    def segs(k: int) -> int:
        return sum(n > 0 for n in pack_group_sizes(k))

    single = single_kernel(impl, fusion)
    d, out = cfg.d_model, {single: 0, f"{single}_grouped": 0}
    for sp in cfg.layer_specs():
        if sp.mixer == "attn":
            out[single] += 3 * segs(d) + segs(cfg.n_heads * cfg.head_dim)
        elif sp.mixer == "ssm":
            out[single] += segs(d) + segs(cfg.ssm.d_inner)
        else:
            raise ValueError(f"no launch count reckoned for a {sp.mixer} mixer")
        if sp.ffn == "dense":
            out[single] += 2 * segs(d) + segs(sp.d_ff or cfg.d_ff)
        elif sp.ffn == "moe":
            mc = cfg.moe
            out[f"{single}_grouped"] += 2 * segs(d) + segs(mc.d_ff_expert)
            if mc.n_shared:
                out[single] += 2 * segs(d) + segs((mc.d_ff_shared or mc.d_ff_expert) * mc.n_shared)
    return {k: v for k, v in out.items() if v}


@trace_attempts
def serve_multi(torch, model, cfg, prompts, counters, name, *, impl="decode", fusion="fused",
                spec=None, temperature=0.0, slots=4, max_len=256, traced=False, **kw) -> dict:
    """Phases 8 (c), 9, 10 and 11: one serving run with its counts zeroed
    just before it. Every forward (target and drafter) is counted through
    `lm_hidden`, with the token count N = B x S its mpGeMM launches
    (`launches_per_forward`: 224 at smollm-360m's full depth; on MLA
    layers with or without `wkv_b`, by the forward's path) see. Each
    admission's wall time and prefix-hit tokens are recorded (whole-prompt
    admission ends in a host sync), and the host time spent in
    `decode_once` (it ends in one too): `decode_only_tok_s`, the rate
    phases 4 and 5 report. A step graph's capture runs no forward: the
    forwards it records are counted at each of its replays instead. With
    `traced`, the run is traced on the device alone (`device_trace`): its
    kernel records must be the wrappers' counts (`device_launches`, else
    None; the rates are then taken with the trace on). Traced: the runs
    whose counts the kernels line prints (phases 10 and 11) and the one
    whose drafter replays graphs of its own (phase 8's oracle chain);
    phases 4, 5 and 22 trace every step kind of the engine besides."""
    from repro_torch.models import decoder
    from repro_torch.serve import ContinuousBatchingScheduler, Engine, Request
    from repro_torch.serve.graphs import StepGraphs

    eng = Engine(model, cfg, max_slots=slots, max_len=max_len, mpgemm_impl=impl,
                 mpgemm_fusion=fusion, spec=spec, temperature=temperature, seed=7, device="cuda",
                 **kw)
    per_fwd = launches_per_forward(model, impl, fusion)
    absorbed = launches_per_forward(model, impl, fusion, expand=False)
    n_hist: dict = {}                       # N per launch → launches
    expanding = [0, 0]                      # forwards that expand wkv_b, that absorb it
    lm_hidden = decoder.lm_hidden
    admissions = []
    add = eng.add

    def tally(n, expands):
        expanding[0 if expands else 1] += 1
        n_hist[n] = n_hist.get(n, 0) + sum((per_fwd if expands else absorbed).values())

    recording, per_key = [None], {}         # the key being captured; key → its forwards

    def counted(model_, tokens, *a, **k):
        fwd = (tokens.numel(), mla_expands(tokens.shape[1], k.get("verify", False),
                                           k.get("prefill_resume", False)))
        if torch.cuda.is_current_stream_capturing():
            per_key.setdefault(recording[0], []).append(fwd)
        else:
            tally(*fwd)
        return lm_hidden(model_, tokens, *a, **k)

    record, replay = StepGraphs._record, StepGraphs._replay

    def recorded(self, key, *a):
        recording[0] = key
        return record(self, key, *a)

    def replayed(self, key, *a):
        out = replay(self, key, *a)
        for fwd in per_key.get(key, ()):
            tally(*fwd)
        return out

    def timed_add(req):
        hits, t0 = eng.prefix_hit_tokens, time.perf_counter()
        ok = add(req)
        if ok:
            admissions.append([(time.perf_counter() - t0) * 1e3, eng.prefix_hit_tokens - hits])
        return ok

    eng.add = timed_add
    decode_once, decode_s = eng.decode_once, [0.0]

    def timed_decode():
        t0 = time.perf_counter()
        out = decode_once()
        decode_s[0] += time.perf_counter() - t0
        return out

    eng.decode_once = timed_decode

    sched = ContinuousBatchingScheduler(eng)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=16) for i, p in enumerate(prompts)]
    for fn in counters.values():
        fn.launches = 0
    decoder.lm_hidden = counted
    try:
        with planted(StepGraphs, "_record", recorded), planted(StepGraphs, "_replay", replayed), \
                (device_trace(torch) if traced else contextlib.nullcontext()) as prof:
            sched.submit(reqs)
            stats = sched.run_to_completion()
    finally:
        decoder.lm_hidden = lm_hidden
        drop_graphs(eng)
    launches = {nm: fn.launches for nm, fn in counters.items()}
    device_launches = None
    if traced:
        device_launches, _ = traced_launches(prof, counters)
        held_to_trace(name, launches, device_launches)
    forwards = sum(expanding)
    target = stats.decode_steps + stats.chunk_steps + (0 if eng.prefill_chunk else len(reqs))
    kernel = single_kernel(impl, fusion)
    want = {nm: per_fwd.get(nm, 0) * expanding[0] + absorbed.get(nm, 0) * expanding[1]
            for nm in counters}
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")
    drafter_forwards = forwards - target
    if drafter_forwards < 0 or (drafter_forwards and not (spec and spec.drafter == "model")):
        raise AssertionError(f"{name}: {forwards} forwards counted, {target} target forwards")
    if stats.completed != len(reqs) or any(len(r.generated) != 16 for r in reqs):
        raise AssertionError(f"{name}: {stats.completed}/{len(reqs)} requests completed")
    if not all(0 <= t < cfg.vocab for r in reqs for t in r.generated):
        raise AssertionError(f"{name}: a token outside the vocabulary")
    row = {
        "impl": impl, "fusion": fusion, "spec": None if spec is None else {
            "k": spec.k, "drafter": spec.drafter, "adaptive_k": spec.adaptive_k,
            "tree": spec.tree, "stochastic": spec.stochastic},
        "temperature": temperature, "slots": slots,
        **{k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
           for k, v in kw.items() if k != "obs"},
        "tokens": [list(map(int, r.generated)) for r in reqs],
        "launches": launches, "device_launches": device_launches, "forwards": forwards,
        "target_forwards": target,
        "launches_per_forward": {"expanding": per_fwd, "absorbing": absorbed,
                                 "forwards": {"expanding": expanding[0], "absorbing": expanding[1]}},
        "drafter_forwards": drafter_forwards,
        "mpgemm_tokens_per_launch": {str(n): c for n, c in sorted(n_hist.items())},
        "decode_tok_s": stats.decode_tok_s, "prefill_tok_s": stats.prefill_tok_s,
        "decode_only_tok_s": stats.decode_tokens / decode_s[0] if decode_s[0] else None,
        "decode_ms_per_step": decode_s[0] * 1e3 / stats.decode_steps if stats.decode_steps else None,
        "ttft_p50_ms": sorted(stats.ttft_s)[len(stats.ttft_s) // 2] * 1e3, "wall_s": stats.wall_s,
        "decode_tokens": stats.decode_tokens, "decode_steps": stats.decode_steps,
        "chunk_steps": stats.chunk_steps, "spec_steps": stats.spec_steps,
        "tokens_per_step": stats.decode_tokens_per_step, "nodes_per_step": stats.nodes_per_step,
        "drafted_tokens": stats.drafted_tokens, "accepted_tokens": stats.accepted_tokens,
        "completed": stats.completed,
        "acceptance": stats.acceptance_rate, "mean_draft_k": stats.mean_draft_k,
        "skip_rate": stats.skip_rate,
        "prefill_tokens": stats.prefill_tokens, "prefix_hit_tokens": stats.prefix_hit_tokens,
        "prefix_hit_requests": stats.prefix_hit_requests,
        "admission_ms_and_hit_tokens": admissions,
    }
    if eng.pager is not None:
        row["pager"] = {f: getattr(eng.pager, f) for f in (
            "total_pages", "free_pages", "shared_pages", "offloaded_pages", "pages_paged_out",
            "pages_paged_in", "pages_dropped")}
    log(f"multi: {name}: forwards {forwards} (drafter {drafter_forwards}), launches "
        f"{launches[kernel]} of {kernel}, N per launch {row['mpgemm_tokens_per_launch']}, "
        f"decode_tok_s {row['decode_tok_s']:.1f}, ttft_p50_ms {row['ttft_p50_ms']:.1f}, "
        f"tok/step {row['tokens_per_step']:.2f}, nodes/step {row['nodes_per_step']:.2f}, "
        f"acceptance {row['acceptance']:.3f}, mean k {row['mean_draft_k']:.2f}, "
        f"chunk steps {row['chunk_steps']}, wall {row['wall_s']:.1f} s")
    return row


def check_multi_token(torch, model, cfg, weights, prompts, counters, ref_tokens) -> tuple:
    """Phase 8: multi-token serving on phase 4's model and prompts. (a) Both
    fused kernels against their plain versions at N in MT_TOKENS; (b)
    verify_step against sequential decode; (c) chunked prefill, token
    budget, chain / oracle / adaptive / tree speculation, chunked + chain,
    chain with impl="lookup", and one stochastic run, each checked for
    launches, completion and (greedy) phase 4's tokens under the near-tie
    rule. → (results, {run: greedy tokens})."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg
    from repro_torch.spec import SpecConfig

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(8)
    max_err, n_checks = fused_vs_plain(torch, fused_kernels(), weights, MT_TOKENS, gen)
    log(f"multi: {n_checks} kernel-vs-plain checks at N {MT_TOKENS}, max |diff| {max_err}")
    for n in MT_TOKENS:
        log(f"multi: plans at N={n}: " + "; ".join(
            f"{m}x{k}: decode BM {d.bm} BN {d.bn} S {d.splits} blocks {d.blocks}, "
            f"LUT BM {lp.bm} S {lp.splits} blocks {lp.blocks}" for m, k in SHAPES
            for d, lp in [(decode_plan_for(tdg, m, k // 5, n, 5), vlg.lut_plan(m, k // 5, n, 5))]))
    for name, err in max_err.items():
        if err != 0.0:
            raise AssertionError(f"{name} differs from its plain version by {err} at N {MT_TOKENS}")
    verify = check_verify(torch, model, cfg, prompts[0], ref_tokens[0][1:])

    oracle = dict(drafter="model", draft_params=model, draft_cfg=cfg)
    runs = {
        "chunk": dict(prefill_chunk=PREFILL_CHUNK),
        "chunk_budget": dict(prefill_chunk=PREFILL_CHUNK, token_budget=TOKEN_BUDGET),
        "chain_ngram": dict(spec=SpecConfig(k=SPEC_K)),
        "chain_oracle": dict(spec=SpecConfig(k=SPEC_K, **oracle), traced=True),
        "adaptive_ngram": dict(spec=SpecConfig(k=SPEC_K, adaptive_k=True)),
        "tree_ngram": dict(spec=SpecConfig(k=SPEC_K, tree=SPEC_TREE)),
        "chunk_chain_ngram": dict(prefill_chunk=PREFILL_CHUNK, spec=SpecConfig(k=SPEC_K)),
        "chain_ngram_lookup": dict(impl="lookup", spec=SpecConfig(k=SPEC_K)),
        "stochastic_oracle": dict(temperature=STOCHASTIC_TEMPERATURE,
                                  spec=SpecConfig(k=SPEC_K, stochastic=True, **oracle)),
    }
    out = {}
    for name, kw in runs.items():
        row = serve_multi(torch, model, cfg, prompts, counters, name, **kw)
        if not row["temperature"]:
            row["near_ties"] = tie_check(torch, model, cfg, f"multi: {name}", prompts,
                                         ref_tokens, row["tokens"], "phase 4")
        out[name] = row
    if out["chain_oracle"]["acceptance"] < ORACLE_MIN_ACCEPT:
        raise AssertionError(f"the oracle drafter accepted {out['chain_oracle']['acceptance']} "
                             f"< {ORACLE_MIN_ACCEPT}")
    profiles = {}
    for name in ("chain_ngram", "tree_ngram"):
        prof = profile_decode(torch, model, cfg, prompts, spec=runs[name]["spec"], op_names=())
        profiles[name] = prof
        log(f"multi: profile of a {name} step (4 slots): wall {prof['wall_ms_per_step']:.3f} ms, "
            f"device busy {prof['device_ms_per_step']:.3f} ms"
            + (f" ({100 * prof['device_busy_share']:.1f}%)" if prof["device_busy_share"] else
               " (the profiler saw no device time: not measured)"))
        for kname, ms in prof["top_kernels_ms_per_step"][:4]:
            log(f"multi:   {ms:8.4f} ms  {kname}")
    log(f"multi: phase 8 took {time.perf_counter() - t0:.1f} s")
    return {"kernels_max_abs_err": max_err, "kernel_checks": n_checks, "tokens": MT_TOKENS,
            "verify": verify, "tie_rtol": TIE_RTOL, "oracle_min_accept": ORACLE_MIN_ACCEPT,
            "step_profiles": profiles,
            "runs": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in out.items()},
            "seconds": time.perf_counter() - t0}, {k: v["tokens"] for k, v in out.items()}


def check_paged(torch, model, cfg, prompts, counters, ref_tokens, multi_tokens,
                dense_prof) -> dict:
    """Phase 9: the paged KV cache on phase 4's model. (a) phase 4's prompts
    with both impls, (b) chunked chain and tree speculation, (c) prefix
    sharing against the dense engine, (d) the offload tier against the
    host pager's decisions, (e) one paged decode step under the profiler.
    → (results, {"prefix_paged": (c)'s greedy tokens})."""
    import numpy as np

    from repro_torch.serve import PagedKVConfig, Pager
    from repro_torch.spec import SpecConfig

    t0 = time.perf_counter()
    paged = PagedKVConfig(page_size=PAGE_SIZE)
    out = {"page_size": PAGE_SIZE, "runs": {}}

    def run(name, run_prompts, ref, **kw):
        row = serve_multi(torch, model, cfg, run_prompts, counters, name, **kw)
        if ref is not None:
            row["near_ties"] = tie_check(torch, model, cfg, f"paged: {name}", run_prompts, ref,
                                         row["tokens"])
        out["runs"][name] = {k: v for k, v in row.items() if k != "tokens"}
        return row

    # (a) phase 4's prompts, both impls; (b) phase 8's chunked chain and tree
    for impl in IMPLS:
        run(f"whole_{impl}", prompts, ref_tokens, impl=impl, paged_kv=paged)
    run("chunk_chain_ngram", prompts, multi_tokens["chunk_chain_ngram"], paged_kv=paged,
        prefill_chunk=PREFILL_CHUNK, spec=SpecConfig(k=SPEC_K))
    run("tree_ngram", prompts, multi_tokens["tree_ngram"], paged_kv=paged,
        spec=SpecConfig(k=SPEC_K, tree=SPEC_TREE))

    # (c) prefix sharing: a common system prompt of 8 full pages
    rng = np.random.default_rng(9)
    shared = prefix_prompts(cfg, rng)
    dense = run("prefix_dense", shared, None)
    hit = run("prefix_paged", shared, dense["tokens"], paged_kv=paged)
    if hit["prefix_hit_requests"] < 1:
        raise AssertionError("prefix sharing: no request hit the radix index")
    if hit["prefill_tokens"] != dense["prefill_tokens"] - hit["prefix_hit_tokens"]:
        raise AssertionError(f"prefix sharing: prefill tokens {hit['prefill_tokens']} != "
                             f"{dense['prefill_tokens']} - {hit['prefix_hit_tokens']}")
    adm = {kind: [ms for ms, h in hit["admission_ms_and_hit_tokens"] if (h > 0) == kind]
           for kind in (True, False)}
    out["prefix"] = {
        "ttft_p50_ms": {"dense": dense["ttft_p50_ms"], "paged": hit["ttft_p50_ms"]},
        "prefill_tokens": {"dense": dense["prefill_tokens"], "paged": hit["prefill_tokens"]},
        "prefix_hit_tokens": hit["prefix_hit_tokens"],
        "prefix_hit_requests": hit["prefix_hit_requests"],
        "admission_ms_mean": {"hit": sum(adm[True]) / max(len(adm[True]), 1),
                              "miss": sum(adm[False]) / max(len(adm[False]), 1)},
        "dense_admission_ms_mean": sum(ms for ms, _ in dense["admission_ms_and_hit_tokens"])
        / len(dense["admission_ms_and_hit_tokens"])}
    log(f"paged: prefix sharing: {hit['prefix_hit_requests']} of {len(shared)} requests hit, "
        f"{hit['prefix_hit_tokens']} prompt tokens not prefilled (prefill tokens "
        f"{hit['prefill_tokens']} vs dense {dense['prefill_tokens']}); TTFT p50 paged "
        f"{hit['ttft_p50_ms']:.1f} ms vs dense {dense['ttft_p50_ms']:.1f} ms; admission "
        f"{out['prefix']['admission_ms_mean']['hit']:.1f} ms with a hit, "
        f"{out['prefix']['admission_ms_mean']['miss']:.1f} ms without (dense "
        f"{out['prefix']['dense_admission_ms_mean']:.1f} ms)")

    # (d) the offload tier, against the host pager's decisions
    p1, p2 = (rng.integers(0, cfg.vocab, size=OFFLOAD_PROMPT).astype(np.int32) for _ in range(2))
    offload = PagedKVConfig(page_size=PAGE_SIZE, n_pages=OFFLOAD_PAGES,
                            host_offload_pages=OFFLOAD_HOST_PAGES)
    host = Pager(offload, max_slots=1, max_len=256, n_pages=OFFLOAD_PAGES,
                 page_out=lambda page: page, page_in=lambda page, data: None)
    for p in (p1, p2, p1):
        host.admit(0, p, len(p) + 16 - 1)
        host.release(0, p)
    dense1 = run("offload_dense", [p1, p2, p1], None, slots=1)
    tier = run("offload_paged", [p1, p2, p1], dense1["tokens"], slots=1, paged_kv=offload)
    want = {"pages_paged_out": host.pages_paged_out, "pages_paged_in": host.pages_paged_in,
            "prefix_hit_tokens": host.prefix_hit_tokens}
    got = {k: tier["pager"].get(k, tier.get(k)) for k in want}
    if got != want or not (want["pages_paged_out"] and want["pages_paged_in"]):
        raise AssertionError(f"offload tier: engine {got}, host pager {want}")
    out["offload"] = {"engine": got, "host_pager": want}
    log(f"paged: offload tier: {got['pages_paged_out']} pages out, {got['pages_paged_in']} in, "
        f"{got['prefix_hit_tokens']} prefix-hit tokens (the host pager: {want})")

    # (e) one paged decode step of 4 full slots beside phase 4's dense step
    prof = profile_decode(torch, model, cfg, prompts, paged=paged, cuda_graphs=False)
    out["decode_profile"] = prof
    for label, pr in (("dense", dense_prof), ("paged", prof)):
        ops = pr["op_device_ms_per_step"]
        log(f"paged: {label} decode step (4 slots): wall {pr['wall_ms_per_step']:.3f} ms, device "
            f"{pr['device_ms_per_step']:.3f} ms"
            + (f" ({100 * pr['device_busy_share']:.1f}%)" if pr["device_busy_share"] else
               " (the profiler saw no device time: not measured)")
            + ", " + ", ".join(f"{op} {ms:.4f} ms in {n:.0f} calls" for op, (ms, n) in ops.items()))
    out["seconds"] = time.perf_counter() - t0
    log(f"paged: phase 9 took {out['seconds']:.1f} s")
    return out, {"prefix_paged": hit["tokens"]}


def prefix_prompts(cfg, rng) -> list:
    """Phase 9 (c)'s prompts (and phase 14 (c)'s): a common system prompt
    of 8 full pages plus 8-32 unique tokens each, 8 requests."""
    import numpy as np

    system = rng.integers(0, cfg.vocab, size=SYSTEM_PROMPT).astype(np.int32)
    return [np.concatenate([system, rng.integers(0, cfg.vocab, size=int(rng.integers(8, 33)))
                            .astype(np.int32)]) for _ in range(8)]



def counter_total(o, name: str) -> float:
    """A counter of an `Obs`'s registry summed over its label sets."""
    return sum(m.value for m in o.registry.all() if m.name == name)


def dispatch_nesting(events) -> dict:
    """Where each `mpgemm_dispatch` span of a trace lies: inside an engine
    step span, else inside a scheduler tick, else outside both (steps do
    not overlap one another, nor ticks). → counts."""
    import bisect

    def spans(pred):
        iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if pred(e["name"]))
        return [a for a, _ in iv], [b for _, b in iv]

    def inside(starts_ends, e) -> bool:
        starts, ends = starts_ends
        i = bisect.bisect_right(starts, e["ts"]) - 1
        return i >= 0 and e["ts"] + e["dur"] <= ends[i] + 1e-3      # µs
    steps = spans(lambda n: n.startswith("engine_step/"))
    ticks = spans(lambda n: n == "scheduler_tick")
    out = {"step": 0, "tick": 0, "outside": 0}
    for e in events:
        if e["name"] == "mpgemm_dispatch":
            out["step" if inside(steps, e) else "tick" if inside(ticks, e) else "outside"] += 1
    return out


def obs_kernel_gauges(torch, model, gen) -> dict:
    """Phase 14 (f): per-launch device time of kernels #1-#4 at N 4 at each
    of smollm-360m's 4 BitLinear shapes (phase 3's forward, timed shape by
    shape: the forward's launches of one shape in one graph), fed to
    `Obs.record_kernel_sample` (the kernel's name as its impl label); each
    achieved-GB/s gauge must equal `mpgemm_cost` bytes / seconds and stay
    within OBS_GBPS_SLACK of the card's HBM rate."""
    from repro_torch.core import act_quant_tokens, act_token_scale
    from repro_torch.kernels import ops
    from repro_torch.models.common import PackedLinear
    from repro_torch.obs import Obs, ObsConfig
    from repro_torch.roofline import mpgemm_cost

    o = Obs(ObsConfig())
    n, g = DECODE_N, 5
    lins = [m.pw for m in model.modules() if isinstance(m, PackedLinear)]
    rows = {}
    for m, k in SHAPES:
        group = [pw for pw in lins if (pw.M, pw.K) == (m, k)]
        x = torch.randn((n, k), generator=gen, device=gen.device).to(torch.bfloat16)
        a_scale = act_token_scale(x.T).contiguous()
        a_r = ops._deinterleave(act_quant_tokens(x.T)[0], g)
        for name, (kern, _) in {**fused_kernels(), **int_kernels()}.items():
            fused = name.endswith("_fused")

            def run(kern=kern, fused=fused):
                for pw in group:
                    if fused:
                        kern(pw.packed5, x, a_scale, pw.scale, g=g, out_dtype=torch.bfloat16)
                    else:
                        kern(pw.packed5, a_r, g=g)
            seconds = device_ms(torch, run) / len(group) / 1e3
            o.record_kernel_sample(g=g, impl=name, m=m, kg=k // g, n=n, fused=fused,
                                   seconds=seconds)
            labels = {"impl": name, "g": str(g), "shape": f"{m}x{k}", "m_tokens": str(n)}
            gbps = o.registry.find("repro:mpgemm_achieved_gbps", labels).value
            want = mpgemm_cost(m, k, n, g, fused=fused)[1] / seconds / 1e9
            if gbps != want or gbps * 1e9 > OBS_GBPS_SLACK * HBM_BYTES_S:
                raise AssertionError(f"obs: {name} at {m}x{k}: gauge {gbps} GB/s, mpgemm_cost "
                                     f"gives {want}, card {HBM_BYTES_S / 1e9} GB/s")
            rows.setdefault(name, {})[f"{m}x{k}"] = {
                "launches": len(group), "us_per_launch": seconds * 1e6, "gbps": gbps,
                "gflops": o.registry.find("repro:mpgemm_achieved_gflops", labels).value}
    for name, per_shape in rows.items():
        forward = sum(r["us_per_launch"] * r["launches"] for r in per_shape.values()) / 1e3
        log(f"obs: (f) {name} at N={n}: " + ", ".join(
            f"{shape} {r['us_per_launch']:.2f} us/launch, {r['gbps']:.1f} GB/s"
            for shape, r in per_shape.items()) + f"; the 4 shapes' launches {forward:.4f} ms")
    return rows


def check_obs(torch, model, cfg, prompts, counters, ref_tokens, multi_tokens, paged,
              paged_tokens) -> dict:
    """Phase 14: observability on phase 4's model, (a)-(f) of the module
    docstring. Every failure raises."""
    import statistics
    import tempfile

    import numpy as np

    from repro_torch import obs as obs_mod
    from repro_torch.kernels import ops
    from repro_torch.models.common import PackedLinear
    from repro_torch.serve import PagedKVConfig
    from repro_torch.spec import SpecConfig

    t0 = time.perf_counter()
    kernel = "ternary_decode_gemm_fused"
    per_fwd = launches_per_forward(model, "decode")[kernel]          # 224
    dispatch = "repro:mpgemm_dispatch_total"
    tmp = tempfile.TemporaryDirectory()
    exports = {"metrics_out": str(pathlib.Path(tmp.name) / "metrics.json"),
               "trace_out": str(pathlib.Path(tmp.name) / "trace.json")}
    out = {"cost_runs": {"off": [], "on": []}}

    # eager steps: the checks count one dispatch span per mpGeMM call, and a
    # replayed step graph records its spans at capture only
    def observed_run(name, run_prompts, o, **kw):
        try:
            return serve_multi(torch, model, cfg, run_prompts, counters, name, obs=o,
                               cuda_graphs=False, **kw)
        finally:
            obs_mod.install(None)

    # (a) and (e): whole-prompt fused decode, obs off and on in turns
    shared, a_launches = None, 0
    for i in range(OBS_COST_RUNS):
        for mode in ("off", "on"):
            o = obs_mod.Obs(obs_mod.ObsConfig(**exports)) if mode == "on" else None
            row = observed_run(f"obs {mode} {i}", prompts, o)
            if row["tokens"] != ref_tokens:
                raise AssertionError(f"obs {mode} {i}: tokens differ from phase 4's")
            out["cost_runs"][mode].append({k: row[k] for k in (
                "decode_ms_per_step", "decode_only_tok_s", "decode_tok_s", "ttft_p50_ms",
                "wall_s")})
            if o is None:
                continue
            spans = sum(e["name"] == "mpgemm_dispatch" for e in o.tracer.events)
            counted = {"dispatch_total": counter_total(o, dispatch), "dispatch_spans": spans,
                       "launches": row["launches"][kernel],
                       "per_forward_x_forwards": per_fwd * row["forwards"]}
            if len(set(counted.values())) != 1:
                raise AssertionError(f"obs on {i}: dispatches and launches differ: {counted}")
            mirrors = {"prompt": (o.c_prompt_tok.value, row["prefill_tokens"]),
                       "generation": (o.c_gen_tok.value, row["decode_tokens"]),
                       "success": (o.c_completed.value, row["completed"])}
            if any(a != b for a, b in mirrors.values()):
                raise AssertionError(f"obs on {i}: counters against ServeStats {mirrors}")
            eff = list(o.s_eff_m.samples)
            if not (o.h_ttft.count == o.h_tpot.count == len(prompts)) or not eff or \
                    not all(1 <= m <= 4 for m in eff):
                raise AssertionError(f"obs on {i}: {o.h_ttft.count} TTFT, {o.h_tpot.count} TPOT, "
                                     f"effective M {sorted(set(eff))}")
            out["a"] = {**counted, "counters": {k: a for k, (a, _) in mirrors.items()},
                        "ttft": o.h_ttft.count, "tpot": o.h_tpot.count,
                        "effective_m": sorted(set(eff)), "decode_steps": len(eff)}
            shared, a_launches = o, row["launches"][kernel]
    log(f"obs: (a) 3 runs with obs on: phase 4's tokens; {out['a']}")

    # (b) phase 8's chunk 64 + chain k 4 run, into the same Obs
    row = observed_run("obs chunk_chain_ngram", prompts, shared, prefill_chunk=PREFILL_CHUNK,
                       spec=SpecConfig(k=SPEC_K))
    kinds = {n: sum(e["name"] == n for e in shared.tracer.events) for n in OBS_TRACE_NAMES}
    got = {"chunk_spans": kinds["engine_step/chunk"], "verify_spans": kinds["engine_step/verify"],
           "drafted": shared.c_drafted.value, "accepted": shared.c_accepted.value,
           "dispatch_total": counter_total(shared, dispatch)}
    want = {"chunk_spans": row["chunk_steps"], "verify_spans": row["spec_steps"],
            "drafted": row["drafted_tokens"], "accepted": row["accepted_tokens"],
            "dispatch_total": a_launches + row["launches"][kernel]}
    if row["tokens"] != multi_tokens["chunk_chain_ngram"] or got != want or \
            not (got["chunk_spans"] and got["verify_spans"]):
        raise AssertionError(f"obs (b): tokens equal phase 8's: "
                             f"{row['tokens'] == multi_tokens['chunk_chain_ngram']}; {got} != {want}")
    out["b"] = got
    log(f"obs: (b) chunk 64 + chain k 4: phase 8's tokens; {got}")

    # (c) phase 9's paged prefix-sharing run
    o = obs_mod.Obs(obs_mod.ObsConfig())
    row = observed_run("obs prefix_paged", prefix_prompts(cfg, np.random.default_rng(9)), o,
                       paged_kv=PagedKVConfig(page_size=PAGE_SIZE))
    pager = row["pager"]
    pairs = {"total_pages": o.g_pages_total, "free_pages": o.g_pages_free,
             "shared_pages": o.g_pages_shared, "offloaded_pages": o.g_pages_offloaded,
             "pages_paged_out": o.c_pages_out, "pages_paged_in": o.c_pages_in,
             "pages_dropped": o.c_pages_dropped}
    got = {k: m.value for k, m in pairs.items()}
    got.update(prefix_hit_tokens=o.c_prefix_hit_tok.value,
               prefix_hit_requests=o.c_prefix_hit_req.value)
    want = {**{k: pager[k] for k in pairs},
            "prefix_hit_tokens": paged["prefix"]["prefix_hit_tokens"],
            "prefix_hit_requests": paged["prefix"]["prefix_hit_requests"]}
    if row["tokens"] != paged_tokens["prefix_paged"] or got != want:
        raise AssertionError(f"obs (c): tokens equal phase 9's: "
                             f"{row['tokens'] == paged_tokens['prefix_paged']}; {got} != {want}")
    out["c"] = got
    log(f"obs: (c) paged prefix sharing: phase 9's tokens; gauges and counters {got}")

    # (d) the exports, reloaded
    written = shared.finalize()
    metrics = json.loads(pathlib.Path(exports["metrics_out"]).read_text())
    trace = json.loads(pathlib.Path(exports["trace_out"]).read_text())
    tmp.cleanup()
    events = trace["traceEvents"]
    names = {n: sum(e["name"] == n for e in events) for n in OBS_TRACE_NAMES}
    nesting = dispatch_nesting(events)
    if (sorted(written) != sorted(exports.values())
            or metrics != json.loads(json.dumps(shared.registry.to_json()))
            or len(events) != len(shared.tracer.events) or trace["otherData"]["dropped_events"]
            or not all(names.values()) or nesting["outside"]
            or nesting["tick"] != per_fwd * len(prompts)):
        raise AssertionError(f"obs (d): exports {written}, trace names {names}, dropped "
                             f"{trace['otherData']['dropped_events']}, dispatch spans {nesting}")
    out["d"] = {"trace_events": len(events), "names": names, "dispatch_nesting": nesting,
                "metrics": len(metrics["metrics"])}
    log(f"obs: (d) metrics JSON ({len(metrics['metrics'])} metrics) and trace ({len(events)} "
        f"events, none dropped) reloaded; {names}; dispatch spans inside a step "
        f"{nesting['step']}, inside an admission's tick {nesting['tick']}")

    # (e) the cost of obs on: medians of the interleaved runs, not gated
    med = {mode: {k: statistics.median(r[k] for r in runs) for k in runs[0]}
           for mode, runs in out["cost_runs"].items()}
    out["e"] = {"median": med,
                "host_ms_per_decode_step_on_minus_off": med["on"]["decode_ms_per_step"]
                - med["off"]["decode_ms_per_step"]}
    log(f"obs: (e) median of {OBS_COST_RUNS} runs, off vs on: host ms per decode step "
        f"{med['off']['decode_ms_per_step']:.3f} vs {med['on']['decode_ms_per_step']:.3f} "
        f"({out['e']['host_ms_per_decode_step_on_minus_off']:+.3f}); decode tok/s (decode_once) "
        f"{med['off']['decode_only_tok_s']:.2f} vs {med['on']['decode_only_tok_s']:.2f}; decode "
        f"tok/s (whole run) {med['off']['decode_tok_s']:.2f} vs {med['on']['decode_tok_s']:.2f}")

    # (e) the hook alone on the host: one decode tick's events, 224 dispatch
    # spans with their tile lookups, a step and a tick, into a fresh Obs
    pws = [m.pw for m in model.modules() if isinstance(m, PackedLinear)]
    probe = obs_mod.Obs(obs_mod.ObsConfig())

    def tick_events():
        t = probe.now()
        for pw in pws:
            with probe.mpgemm_span(DECODE_N, pw.K, pw.M, "decode", "fused",
                                   tiles=ops.launch_tiles(pw, DECODE_N, "decode")):
                pass
        probe.step_event("decode", t, m_real=DECODE_N, m_padded=DECODE_N)
        probe.tracer.complete("scheduler_tick", t)
    tick_events()
    t1 = time.perf_counter()
    for _ in range(OBS_HOOK_TICKS):
        tick_events()
    hook_ms = (time.perf_counter() - t1) * 1e3 / OBS_HOOK_TICKS
    out["e"]["hook_ms_per_decode_tick"] = hook_ms
    out["e"]["hook_us_per_event"] = hook_ms * 1e3 / (len(pws) + 2)
    log(f"obs: (e) the hook alone: {hook_ms:.3f} ms per decode tick's {len(pws) + 2} events "
        f"({out['e']['hook_us_per_event']:.2f} us an event), "
        f"{100 * hook_ms / med['off']['decode_ms_per_step']:.2f}% of the median obs-off step")

    # (f) the kernel gauges
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(14)
    out["f"] = obs_kernel_gauges(torch, model, gen)
    out["seconds"] = time.perf_counter() - t0
    log(f"obs: phase 14 took {out['seconds']:.1f} s")
    return out


def grouped_kernels() -> dict:
    """{name: (grouped kernel wrapper, plain version, single kernel)}."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    return {
        "ternary_decode_gemm_fused_grouped": (tdg.ternary_decode_gemm_fused_grouped,
                                              tdg.ternary_decode_gemm_fused_plain,
                                              tdg.ternary_decode_gemm_fused),
        "vlut_lookup_gemm_fused_grouped": (vlg.vlut_lookup_gemm_fused_grouped,
                                           vlg.vlut_lookup_gemm_fused_plain,
                                           vlg.vlut_lookup_gemm_fused),
    }


def grouped_int_kernels() -> dict:
    """{name: (grouped integer kernel wrapper, plain version, single
    integer kernel)}."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    return {
        "ternary_decode_gemm_grouped": (tdg.ternary_decode_gemm_grouped,
                                        tdg.ternary_decode_gemm_plain, tdg.ternary_decode_gemm),
        "vlut_lookup_gemm_grouped": (vlg.vlut_lookup_gemm_grouped, vlg.vlut_lookup_gemm_plain,
                                     vlg.vlut_lookup_gemm),
    }


def grouped_int_launches(torch, pw, x):
    """The grouped integer launches of one stacked expert linear, as
    `ternary_matmul_batched(fusion="unfused")` makes them: the rows
    quantized once, each segment de-interleaved into (E, g, KG, C):
    [(packed, a_r, g)], one per segment."""
    from repro_torch.core import act_quant_tokens
    from repro_torch.kernels import ops

    e, c, k = x.shape
    a_q, _ = act_quant_tokens(x.reshape(e * c, k).T)
    return [(packed, ops._deinterleave(a_q[lo:hi], g, e), g) for packed, lo, hi, g in ops._segments(pw)]


def int_launch_bytes(launches) -> int:
    """Bytes the grouped integer launches must move: codes, int8 a_r, the
    int32 output."""
    return sum(pk.numel() + ar.numel() + 4 * pk.shape[0] * pk.shape[1] * ar.shape[-1]
               for pk, ar, g in launches)


def experts_chunked(torch, fn, experts: int = 16):
    """`fn` (a plain version over stacked operands, the codes first) applied
    to at most `experts` experts at a time, and no more than
    PLAIN_CHUNK_WEIGHTS weights, and concatenated: the same function on
    the same inputs, without 256 experts' dense f32 weights at once (nor 16
    of jamba's, whose unpacked trits take ~40 GB)."""
    def run(*args, **kw):
        e, codes = args[0].shape[0], args[0][0].numel()
        step = max(1, min(experts, PLAIN_CHUNK_WEIGHTS // (5 * codes)))
        return torch.cat([fn(*(a[i:i + step] for a in args), **kw) for i in range(0, e, step)])
    return run


def grouped_launches(torch, pw, x):
    """The grouped launches of one stacked expert linear, as
    `ternary_matmul_batched` makes them: [(packed, x slice, a_scale,
    w_scale, g, out dtype)], one per segment."""
    from repro_torch.kernels import ops

    a_scale = act_scales(torch, x)
    segs = ops._segments(pw)
    seg_dt = x.dtype if len(segs) == 1 else torch.float32
    return [(packed, x[..., lo:hi], a_scale, pw.scale, g, seg_dt) for packed, lo, hi, g in segs]


def launch_bytes(torch, launches) -> int:
    """Bytes the grouped launches must move, each input read once and each
    output written once: codes, activations, both scales, the output."""
    return sum(pk.numel() + xs.numel() * xs.element_size() + sc.numel() * 4 + ws.numel() * 4
               + xs.shape[0] * xs.shape[1] * pk.shape[1] * torch.empty((), dtype=odt).element_size()
               for pk, xs, sc, ws, g, odt in launches)


def moe_kernel_checks(torch, model, cfg, gen, layer: int = 0, caps=MOE_TOKENS,
                      time_caps=MOE_TIME_TOKENS, traps: bool = True, label: str = "moe") -> dict:
    """Phases 10 and 20 (a) and (b): both grouped kernels, fused and
    integer, at one MoE layer's expert shapes (llama4-scout's layer 0: E
    16, w1 M 8192, K 5120 all g=5; w2 M 5120, K 8192 = 1636 g=5 + 3 g=4
    groups; jamba's layer 1: w1 M 24576, K 8192; w2 M 8192, K 24576) at C
    in `caps` rows per expert against their plain versions and against E
    launches of the single kernel, expected difference 0; with `traps`
    (phase 10), the split-K and geometry traps, which do not depend on the
    model; then at C in `time_caps` device times per grouped launch beside
    the bound, E single launches, the plain version, a decode step's rows
    (DECODE_N x top-k real, the rest 0) and a bf16 `torch.bmm` against the
    dequantized expert weights (a yardstick only: the port never calls it)."""
    dev = torch.device("cuda")
    kernels = grouped_kernels()
    ffn = model.layers[layer].ffn
    lins = {"w1": ffn.experts.w1.pw, "w3": ffn.experts.w3.pw, "w2": ffn.experts.w2.pw}
    e = lins["w1"].packed5.shape[0]
    max_err = {name: 0.0 for name in kernels}
    n_checks = 0
    for lname in ("w1", "w2"):
        pw = lins[lname]
        for c in caps:
            x32 = torch.randn((e, c, pw.K), generator=gen, device=dev) * 3.0
            x32[:, -1] = 0                         # a padding row of every expert
            for dt in ((torch.bfloat16, torch.float32) if c == 16 else (torch.bfloat16,)):
                for packed, xs, a_scale, w_scale, g, out_dt in grouped_launches(torch, pw, x32.to(dt)):
                    for name, (kern, plain, single) in kernels.items():
                        got = kern(packed, xs, a_scale, w_scale, g=g, out_dtype=out_dt)
                        want = experts_chunked(torch, plain)(packed, xs, a_scale, w_scale, g=g,
                                                             out_dtype=out_dt)
                        each = torch.stack([single(packed[i], xs[i], a_scale[i], w_scale[i], g=g,
                                                   out_dtype=out_dt) for i in range(e)])
                        torch.cuda.synchronize()
                        assert got.shape == (e, c, pw.M) and got.dtype == out_dt
                        if got[:, -1].any():
                            raise AssertionError(f"{name}: a padding row's output is not 0")
                        err = max((got.float() - want.float()).abs().max().item(),
                                  (got.float() - each.float()).abs().max().item())
                        max_err[name] = max(max_err[name], err)
                        n_checks += 1
    # the grouped integer kernels (the unfused pipeline's middle pass) on
    # the same weights and rows, quantized and de-interleaved as the
    # pipeline does
    int_kernels = grouped_int_kernels()
    max_err.update({name: 0.0 for name in int_kernels})
    for lname in ("w1", "w2"):
        pw = lins[lname]
        for c in caps:
            x = (torch.randn((e, c, pw.K), generator=gen, device=dev) * 3.0).to(torch.bfloat16)
            x[:, -1] = 0                           # a padding row of every expert
            for packed, a_r, g in grouped_int_launches(torch, pw, x):
                for name, (kern, plain, single) in int_kernels.items():
                    got = kern(packed, a_r, g=g)
                    want = experts_chunked(torch, plain)(packed, a_r, g=g)
                    each = torch.stack([single(packed[i], a_r[i], g=g) for i in range(e)])
                    torch.cuda.synchronize()
                    assert got.shape == (e, pw.M, c) and got.dtype == torch.int32
                    if got[..., -1].any():
                        raise AssertionError(f"{name}: a padding row's output is not 0")
                    err = max((got.long() - want.long()).abs().max().item(),
                              (got.long() - each.long()).abs().max().item())
                    max_err[name] = max(max_err[name], float(err))
                    n_checks += 1
    log(f"{label}: {n_checks} grouped-kernel checks, fused and integer (against the plain version "
        f"and {e} single launches) at {cfg.name}'s layer {layer} expert shapes (w1 M {lins['w1'].M}, "
        f"K {lins['w1'].K}; w2 M {lins['w2'].M}, K {lins['w2'].K}), C {tuple(caps)}: max |diff| "
        f"{max_err}")
    for name, err in max_err.items():
        if err != 0.0:
            raise AssertionError(f"{label}: {name} differs from its plain version or single launches "
                                 f"by {err}")
    out = {"layer": layer, "experts": e, "rows_per_expert": list(caps), "max_abs_err": max_err,
           "checks": n_checks}
    if traps:
        out.update(grouped_traps(torch, gen, kernels))
    out["per_tokens"] = grouped_times(torch, lins, cfg, gen, time_caps, label)
    return out


def grouped_traps(torch, gen, kernels) -> dict:
    """Phase 10 (a): the grouped kernels' split-K traps (MOE_RAGGED) and
    geometry traps (LUT_GEOMETRY_TRAPS, DECODE_GEOMETRY_TRAPS), fused and
    integer, each against its plain version; they depend on no model."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    dev = torch.device("cuda")
    plans = {"decode": lambda e, m, kg, g, c: tdg.grouped_decode_plan(m, kg, c, g, e),
             "lookup": lambda e, m, kg, g, c: vlg.grouped_lut_plan(m, kg, c, g, e)}
    int_kernels = grouped_int_kernels()
    traps = {}
    for name, (kern, plain, _) in kernels.items():
        cases = []
        for ne, m, kg, g, c in MOE_RAGGED:
            packed = torch.randint(0, 3 ** g, (ne, m, kg), generator=gen, device=dev,
                                   dtype=torch.int32).to(torch.uint8)
            x = torch.randn((ne, c, kg * g), generator=gen, device=dev) * 3.0
            w_scale = torch.rand((ne, m), generator=gen, device=dev)
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                a_scale = act_scales(torch, xd)
                cases.append(((packed, xd, a_scale, w_scale), dict(g=g, out_dtype=dt)))
        traps[name] = splitk_traps(torch, name, kern, plain, cases)
    for name, (kern, plain, _) in int_kernels.items():
        cases = []
        for ne, m, kg, g, c in MOE_RAGGED:
            packed = torch.randint(0, 3 ** g, (ne, m, kg), generator=gen, device=dev,
                                   dtype=torch.int32).to(torch.uint8)
            a_r = torch.randint(-127, 128, (ne, g, kg, c), generator=gen, device=dev,
                                dtype=torch.int32).to(torch.int8)
            cases.append(((packed, a_r), dict(g=g)))
        traps[name] = splitk_traps(torch, name, kern, plain, cases)
    for name in traps:
        impl = "decode" if name.startswith("ternary") else "lookup"
        traps[name]["plans"] = [plan_row(plans[impl](*shape)) for shape in MOE_RAGGED]
        if all(row["splits"] == 1 for row in traps[name]["plans"]):
            raise AssertionError(f"{name}: no grouped trap splits K")
        log(f"moe: {name} traps: {traps[name]['cases']} cases, each launched twice back to "
            f"back and in a CUDA graph replayed {LUT_REPLAYS} times: max |diff| 0; plans "
            + "; ".join(f"{tuple(r['shape'])} E {r['e']} S {r['splits']} blocks {r['blocks']}"
                        for r in traps[name]["plans"]))
    return {"splitk_traps": traps,
            "lut_geometry_traps": geometry_traps(torch, gen, LUT_GEOMETRY_TRAPS, "moe", "lookup"),
            "decode_geometry_traps": geometry_traps(torch, gen, DECODE_GEOMETRY_TRAPS, "moe",
                                                    "decode", reach=("splits",))}


def grouped_times(torch, lins, cfg, gen, caps, label: str) -> dict:
    """Phases 10 and 20 (b): at each C in `caps`, the device ms of each
    grouped launch of the stacked expert linears `lins` (w1, w3, w2),
    beside its bound, E single launches, the plain version, a decode step's
    rows (DECODE_N x top-k real, the rest 0), the grouped integer kernels
    and a bf16 `torch.bmm` yardstick; then one MoE layer's grouped launches
    (the kernels line's unit). The plain versions run eagerly (a graph's
    pool would hold each launch's unpacked trits, ~40 GB at jamba's w1),
    and the yardsticks come last: at jamba's shapes the dequantized experts
    (19 GB) and those trits do not fit the card together. → {C: row}."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    dev, kernels = torch.device("cuda"), grouped_kernels()
    e = lins["w1"].packed5.shape[0]
    real = min(e, DECODE_N * cfg.moe.top_k)
    per_c, xs_by_c = {}, {}
    torch.cuda.empty_cache()
    for c in caps:
        xs = xs_by_c[c] = {k: (torch.randn((e, c, k), generator=gen, device=dev)).to(torch.bfloat16)
                           for k in {pw.K for pw in lins.values()}}
        row = {}
        layer_launches = []
        for ln, pw in lins.items():
            launches = grouped_launches(torch, pw, xs[pw.K])
            layer_launches += launches
            if ln == "w3":
                continue
            # the decode step's pattern: one row of DECODE_N x top-k experts, the rest 0
            zero_rows = torch.zeros_like(xs[pw.K])
            zero_rows[:real, 0] = xs[pw.K][:real, 0]
            zero_launches = grouped_launches(torch, pw, zero_rows)
            nbytes = launch_bytes(torch, launches)
            entry = {"launches": len(launches), "bytes": nbytes,
                     "bound_ms": nbytes / HBM_BYTES_S * 1e3}
            for name, (kern, plain, single) in kernels.items():
                def grouped(fn=kern, launches=launches):
                    for pk, xsl, sc, ws, g, odt in launches:
                        fn(pk, xsl, sc, ws, g=g, out_dtype=odt)

                def singles(fn=single, launches=launches):
                    for pk, xsl, sc, ws, g, odt in launches:
                        for i in range(e):
                            fn(pk[i], xsl[i], sc[i], ws[i], g=g, out_dtype=odt)

                entry[name] = {"ms": device_ms(torch, grouped),
                               "singles_ms": device_ms(torch, singles),
                               "plain_ms": eager_ms(torch, lambda p=experts_chunked(torch, plain),
                                                    l=launches: grouped(p, l), reps=1),
                               "zero_rows_ms": device_ms(torch, lambda: grouped(kern, zero_launches))}
            # the grouped integer kernels on the same rows, as the unfused
            # pipeline launches them
            int_ls = grouped_int_launches(torch, pw, xs[pw.K])
            for name, (kern, _, single) in grouped_int_kernels().items():
                entry[name] = {"ms": device_ms(torch, lambda k=kern: call_launches("int", k, int_ls)),
                               "singles_ms": device_ms(torch, lambda k=single: single_launches(
                                   "int", k, int_ls))}
            entry["plans"] = {
                "lookup": [plan_row(vlg.grouped_lut_plan(pk.shape[1], pk.shape[2], c, g, e))
                           for pk, _, _, _, g, _ in launches],
                "decode": [plan_row(tdg.grouped_decode_plan(pk.shape[1], pk.shape[2], c, g, e))
                           for pk, _, _, _, g, _ in launches]}
            row[ln] = entry
        # one MoE layer's grouped launches (the kernels line's unit)
        nbytes = launch_bytes(torch, layer_launches)
        nops = sum(2 * e * c * pk.shape[1] * xsl.shape[-1] for pk, xsl, *_ in layer_launches)
        layer = {"launches": len(layer_launches), "bytes": nbytes, "int8_ops": nops,
                 "bound_ms": max(nbytes / HBM_BYTES_S, nops / INT8_OPS_S) * 1e3,
                 "bound_by": "bytes" if nbytes / HBM_BYTES_S >= nops / INT8_OPS_S else "operations"}
        for name, (kern, plain, _) in kernels.items():
            def run(fn, launches=layer_launches):
                for pk, xsl, sc, ws, g, odt in launches:
                    fn(pk, xsl, sc, ws, g=g, out_dtype=odt)

            layer[name] = {"ms": device_ms(torch, lambda: run(kern)),
                           "plain_ms": eager_ms(torch, lambda: run(experts_chunked(torch, plain)),
                                                reps=1)}
        row["layer"] = layer
        per_c[c] = row
    torch.cuda.empty_cache()
    deq = {ln: dequantized(torch, pw, experts=4) for ln, pw in lins.items()}   # (E, K, M) bf16
    for c, row in per_c.items():
        xs = xs_by_c[c]
        for ln in ("w1", "w2"):
            entry, pw = row[ln], lins[ln]
            entry["bmm_ms"] = device_ms(torch, lambda: torch.bmm(xs[pw.K], deq[ln]))
            log(f"{label}: {ln} (E {e}, M {pw.M}, K {pw.K}, {entry['launches']} launch(es)) at C={c}: "
                f"bound {entry['bound_ms']:.4f} ms (bytes), "
                + ", ".join(f"{nm} {entry[nm]['ms']:.4f} ms ({e} single launches "
                            f"{entry[nm]['singles_ms']:.4f}, plain {entry[nm]['plain_ms']:.4f}, "
                            f"on zero rows but {real} {entry[nm]['zero_rows_ms']:.4f})"
                            for nm in kernels)
                + ", " + ", ".join(f"{nm} {entry[nm]['ms']:.4f} ms ({e} single launches "
                                   f"{entry[nm]['singles_ms']:.4f})" for nm in grouped_int_kernels())
                + f", bf16 bmm yardstick {entry['bmm_ms']:.4f} ms; lookup plans "
                + "; ".join(f"bm {r['bm']} S {r['splits']} x{r['ex']} c{r['chunk']} blocks {r['blocks']}"
                            for r in entry["plans"]["lookup"])
                + "; decode plans " + "; ".join(
                    f"bm {r['bm']} S {r['splits']} x{r['ex']} blocks {r['blocks']} stagings {r['stagings']}"
                    for r in entry["plans"]["decode"]))
        layer = row["layer"]
        layer["library_ms"] = device_ms(torch, lambda: [torch.bmm(xs[lins[ln].K], deq[ln])
                                                        for ln in lins])
        log(f"{label}: one layer's {layer['launches']} grouped launches at C={c}: bound "
            f"{layer['bound_ms']:.4f} ms ({layer['bound_by']}), "
            + ", ".join(f"{nm} {layer[nm]['ms']:.4f} ms (plain {layer[nm]['plain_ms']:.4f})"
                        for nm in kernels)
            + f", bf16 bmm yardstick {layer['library_ms']:.4f} ms")
    del deq
    return per_c


def act_scales(torch, x):
    """Per-(expert, row) activation scales of a stacked (E, C, K) x."""
    from repro_torch.core import act_token_scale

    e, c, k = x.shape
    return act_token_scale(x.reshape(e * c, k).T).reshape(e, c).contiguous()


@contextlib.contextmanager
def plain_mpgemm(torch):
    """Route both pipelines through the kernels' plain versions (on CUDA
    tensors too) for the duration of one call; the grouped ones 16 experts
    at a time (`experts_chunked`)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    plain = {"decode": tdg.ternary_decode_gemm_fused_plain, "lookup": vlg.vlut_lookup_gemm_fused_plain}
    plain_int = {"decode": tdg.ternary_decode_gemm_plain, "lookup": vlg.vlut_lookup_gemm_plain}
    with planted(ops, "_KERNELS", plain), planted(ops, "_INT_KERNELS", plain_int), \
            planted(ops, "_GROUPED_KERNELS", {k: experts_chunked(torch, fn) for k, fn in plain.items()}), \
            planted(ops, "_INT_GROUPED_KERNELS",
                    {k: experts_chunked(torch, fn) for k, fn in plain_int.items()}):
        yield


def moe_dispatch_ms(torch, model, cfg, tokens: int, layer: int = 0) -> dict:
    """Device ms (CUDA-graph replay) of a MoE layer's FFN on `tokens`
    tokens: whole; its dispatch alone (router, top-k, positions, scatter,
    gather back, combine), with the expert linears and the shared expert
    stubbed out by zeros of their output shapes; and its expert compute
    alone (the grouped expert linears with their SwiGLU, and the shared
    expert where the layer has one) on random rows, and on rows zero but
    for row 0 of tokens × top-k experts: the layer's own pattern at a
    decode step (the other rows padding)."""
    import torch.nn.functional as F

    from repro_torch.models import moe
    from repro_torch.models.common import linear_batched_apply

    ffn, dev = model.layers[layer].ffn, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    dt = model.embed.table.dtype
    e, cap, d = cfg.moe.n_experts, moe.capacity(tokens, cfg), cfg.d_model
    x = torch.randn((tokens, 1, d), generator=gen, device=dev).to(dt)
    buf = torch.randn((e, cap, d), generator=gen, device=dev).to(dt)
    sparse = torch.zeros_like(buf)
    real = min(e, tokens * cfg.moe.top_k)
    sparse[:real, 0] = buf[:real, 0]

    def experts(b):
        h = F.silu(linear_batched_apply(ffn.experts.w1, b)) * linear_batched_apply(ffn.experts.w3, b)
        linear_batched_apply(ffn.experts.w2, h)
        if ffn.shared is not None:
            moe.dense_ffn_apply(ffn.shared, x.reshape(tokens, -1))

    def zeros_linear(p, xb, mode="serve"):
        return xb.new_zeros((*xb.shape[:-1], p.pw.M))

    def zeros_ffn(p, xt, mode="serve"):
        return torch.zeros_like(xt)

    whole = device_ms(torch, lambda: moe.moe_apply(ffn, x, cfg))
    with planted(moe, "linear_batched_apply", zeros_linear), planted(moe, "dense_ffn_apply", zeros_ffn):
        dispatch = device_ms(torch, lambda: moe.moe_apply(ffn, x, cfg))
    return {"tokens": tokens, "layer": layer, "rows_per_expert": cap, "real_rows": real,
            "layer_ms": whole, "dispatch_ms": dispatch,
            "expert_compute_ms": device_ms(torch, lambda: experts(buf)),
            "expert_compute_zero_rows_ms": device_ms(torch, lambda: experts(sparse))}


def packed_model_bytes(model) -> dict:
    """Device bytes of a model built with `init_lm(packed=True)`: packed
    codes and scales, embedding, untied head (0 where tied), the rest."""
    out = {
        "packed_bitlinears": sum(b.numel() * b.element_size() for b in model.layers.buffers()),
        "embed": model.embed.table.numel() * model.embed.table.element_size(),
        "head": 0 if model.head is None else model.head.w.numel() * model.head.w.element_size(),
        "other": sum(q.numel() * q.element_size() for q in model.layers.parameters())
                 + model.final_norm.scale.numel() * 4,
    }
    out["total"] = sum(out.values())
    return out


def check_moe(torch, counters) -> dict:
    """Phase 10: the MoE FFN on llama4-scout-17b-a16e at its published
    widths, depth cut to MOE_LAYERS (bf16, random weights from a seeded
    generator, packed layer by layer): (a)-(b) `moe_kernel_checks`; (c)
    serving 8 greedy requests (prompts 16-64, 16 new tokens, 4 slots) with
    impl="decode" and "lookup" (same tokens), then chunk 64 + chain k 4,
    each with 8
    single and 4 grouped launches per layer per forward and no other
    mpGeMM kernel, every request completed; one prefill's logits through
    the kernels against the same prefill through their plain versions;
    (d) one decode step of 4 full slots under torch.profiler, and the MoE
    dispatch's device time (`moe_dispatch_ms`)."""
    import numpy as np

    from repro_torch import obs as obs_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, init_lm, prefill
    from repro_torch.models.moe import capacity
    from repro_torch.spec import SpecConfig

    t0 = time.perf_counter()
    full = get_config(MOE_ARCH)
    cfg = full.with_(n_layers=MOE_LAYERS, layers=full.layers[:MOE_LAYERS])
    torch.cuda.reset_peak_memory_stats()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0), packed=True)
    torch.cuda.synchronize()
    model_bytes = packed_model_bytes(model)
    out = {"arch": cfg.name, "layers": cfg.n_layers,
           "reduced": {"n_layers": [full.n_layers, cfg.n_layers]}, "d_model": cfg.d_model,
           "experts": cfg.moe.n_experts, "model_bytes": model_bytes,
           "build_s": time.perf_counter() - t0,
           "build_peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"moe: {cfg.name} {cfg.dtype}, {cfg.n_layers} of {full.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.moe.n_experts} experts d_ff {cfg.moe.d_ff_expert}, vocab {cfg.vocab}: built and "
        f"packed layer by layer in {out['build_s']:.1f} s (peak {out['build_peak_bytes'] / 2**30:.2f} "
        f"GiB); bytes {model_bytes}")
    gen = torch.Generator(device="cuda").manual_seed(2)
    out["kernels"] = moe_kernel_checks(torch, model, cfg, gen)

    # (c) serving
    for impl in IMPLS:
        per_fwd = launches_per_forward(model, impl)
        single = "vlut_lookup_gemm_fused" if impl == "lookup" else "ternary_decode_gemm_fused"
        if per_fwd != {single: 8 * cfg.n_layers, f"{single}_grouped": 4 * cfg.n_layers}:
            raise AssertionError(f"launches per forward {per_fwd}: expected 8 single and 4 "
                                 "grouped per layer")
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(16, 65))).astype(np.int32)
               for _ in range(8)]
    runs = {}
    for impl in IMPLS:
        runs[impl] = serve_multi(torch, model, cfg, prompts, counters, f"moe {impl}", impl=impl,
                                 traced=True)
    if runs["decode"]["tokens"] != runs["lookup"]["tokens"]:
        raise AssertionError("moe: impl=decode and impl=lookup emitted different greedy tokens")
    runs["chunked_chain"] = serve_multi(torch, model, cfg, prompts, counters, "moe chunked chain",
                                        spec=SpecConfig(k=SPEC_K), prefill_chunk=PREFILL_CHUNK)
    caps = {int(n): capacity(int(n), cfg) for n in runs["chunked_chain"]["mpgemm_tokens_per_launch"]}
    runs["chunked_chain"]["rows_per_expert"] = caps
    if 16 not in caps.values():
        raise AssertionError(f"moe: the chunked chain run's grouped launches never saw C = 16: {caps}")
    same = sum(a == b for a, b in zip(runs["chunked_chain"]["tokens"], runs["decode"]["tokens"]))
    log(f"moe: chunked chain rows per expert by step tokens {caps}; {same}/8 requests emit the "
        "whole-prompt run's tokens (padding rows take capacity in a chunk step, as in JAX)")
    out["serve"] = {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in runs.items()}
    out["serve"]["chunked_chain"]["same_tokens_as_whole_prompt"] = same

    # the kernels' prefill runs with an Obs installed: phase 14 (g)
    tok = torch.from_numpy(prompts[0][None, :]).cuda()
    observed = obs_mod.Obs(obs_mod.ObsConfig())
    for fn in counters.values():
        fn.launches = 0
    obs_mod.install(observed)
    try:
        with ops.dispatch_override(impl="decode"):
            got, _ = prefill(model, tok, init_cache(cfg, 1, 256, device="cuda"), cfg)
    finally:
        obs_mod.install(None)
    out["obs_dispatch"] = moe_dispatch_spans(model, cfg, observed, counters, tok.shape[1])
    with ops.dispatch_override(impl="decode"), plain_mpgemm(torch):
        want, _ = prefill(model, tok, init_cache(cfg, 1, 256, device="cuda"), cfg)
    got, want = got.float(), want.float()
    if got.shape != (1, cfg.vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"moe: bad logits, shape {tuple(got.shape)}")
    diff, scale = (got - want).abs().max().item(), want.abs().max().item()
    out["logits_kernels_vs_plain"] = {"max_abs_diff": diff, "max_abs_logit": scale,
                                      "argmax": [int(got.argmax()), int(want.argmax())]}
    log(f"moe: prefill logits through the kernels vs their plain versions: max |diff| {diff}, "
        f"max |logit| {scale:.4f}, argmax {int(got.argmax())} vs {int(want.argmax())}")
    if diff > MOE_LOGIT_RTOL * scale:
        raise AssertionError(f"moe: logits differ by {diff} > {MOE_LOGIT_RTOL} * {scale}")

    # (d) one decode step of 4 full slots, and the MoE dispatch's share of it
    prof = profile_decode(torch, model, cfg, prompts, op_names=MOE_DISPATCH_OPS,
                          cuda_graphs=False)
    prof["moe_layer"] = moe_dispatch_ms(torch, model, cfg, tokens=4)
    prof["moe_dispatch_ms_per_step"] = prof["moe_layer"]["dispatch_ms"] * cfg.n_layers
    prof["moe_dispatch_share"] = (prof["moe_dispatch_ms_per_step"] / prof["device_ms_per_step"]
                                  if prof["device_ms_per_step"] else None)
    out["decode_profile"] = prof
    log(f"moe: decode step (4 slots) wall {prof['wall_ms_per_step']:.3f} ms, device busy "
        f"{prof['device_ms_per_step']:.3f} ms"
        + (f" ({100 * prof['device_busy_share']:.1f}%)" if prof["device_busy_share"] else
           " (the profiler saw no device time: not measured)")
        + f"; one MoE layer at 4 tokens {prof['moe_layer']['layer_ms']:.4f} ms: its dispatch "
        f"alone {prof['moe_layer']['dispatch_ms']:.4f} ms, its expert compute alone "
        f"{prof['moe_layer']['expert_compute_ms']:.4f} ms on random rows, "
        f"{prof['moe_layer']['expert_compute_zero_rows_ms']:.4f} ms on the layer's zero rows; "
        f"dispatch x {cfg.n_layers} "
        f"layers {prof['moe_dispatch_ms_per_step']:.3f} ms a step"
        + (f" ({100 * prof['moe_dispatch_share']:.1f}% of device time)"
           if prof["moe_dispatch_share"] is not None else ""))
    for name, ms in prof["top_kernels_ms_per_step"]:
        log(f"moe:   {ms:8.4f} ms  {name}")
    for name, (ms, calls) in prof["op_device_ms_per_step"].items():
        log(f"moe:   op {name}: {ms:.4f} ms device, {calls:.1f} calls per step")
    out["seconds"] = time.perf_counter() - t0
    log(f"moe: phase 10 took {out['seconds']:.1f} s")
    del model
    torch.cuda.empty_cache()
    return out


def moe_dispatch_spans(model, cfg, observed, counters, tokens: int) -> dict:
    """Phase 14 (g): one llama4-scout prefill forward of `tokens` tokens
    with `observed` installed. One dispatch span per BitLinear call (7
    single and 3 grouped a layer, the grouped ones with the rows per expert
    as M), and one tile per kernel launch: their sum equals the launch
    counters (8 single and 4 grouped a layer)."""
    from repro_torch.models.common import PackedLinear
    from repro_torch.models.moe import capacity

    launched = {nm: fn.launches for nm, fn in counters.items() if fn.launches}
    per_fwd = launches_per_forward(model, "decode")
    spans = [e["args"] for e in observed.tracer.events if e["name"] == "mpgemm_dispatch"]
    grouped = [s for s in spans if s["tile"] and s["tile"][0].startswith("e")]
    lins = [m for m in model.modules() if isinstance(m, PackedLinear)]
    got = {"spans": len(spans),
           "dispatch_total": counter_total(observed, "repro:mpgemm_dispatch_total"),
           "grouped_spans": len(grouped),
           "single_tiles": sum(len(s["tile"]) for s in spans) - sum(len(s["tile"]) for s in grouped),
           "grouped_tiles": sum(len(s["tile"]) for s in grouped),
           "grouped_m": sorted({s["m"] for s in grouped})}
    want = {"spans": len(lins), "dispatch_total": len(lins),
            "grouped_spans": sum(m.packed5.ndim == 3 for m in lins),
            "single_tiles": per_fwd["ternary_decode_gemm_fused"],
            "grouped_tiles": per_fwd["ternary_decode_gemm_fused_grouped"],
            "grouped_m": [capacity(tokens, cfg)]}
    if got != want or launched != per_fwd:
        raise AssertionError(f"moe: dispatch spans {got}, expected {want}; launches {launched}, "
                             f"expected {per_fwd}")
    log(f"moe: (g) one prefill with obs on: {got['spans']} dispatch spans ({got['grouped_spans']} "
        f"grouped, M = {got['grouped_m'][0]} rows per expert) carry {got['single_tiles']} + "
        f"{got['grouped_tiles']} launch tiles = the launch counters {launched}")
    return {**got, "launches": launched}


def call_launches(kind: str, fn, launches) -> None:
    """Run `fn` (a grouped kernel or its plain version) over grouped
    launches: fused (packed, x, a_scale, w_scale, g, out dtype) or integer
    (packed, a_r, g)."""
    for launch in launches:
        if kind == "fused":
            pk, xs, sc, ws, g, odt = launch
            fn(pk, xs, sc, ws, g=g, out_dtype=odt)
        else:
            pk, ar, g = launch
            fn(pk, ar, g=g)


def single_launches(kind: str, fn, launches) -> None:
    """The same products as E launches of the single kernel `fn` each."""
    for launch in launches:
        for i in range(launch[0].shape[0]):
            if kind == "fused":
                pk, xs, sc, ws, g, odt = launch
                fn(pk[i], xs[i], sc[i], ws[i], g=g, out_dtype=odt)
            else:
                pk, ar, g = launch
                fn(pk[i], ar[i], g=g)


def dequantized(torch, pw, experts: int = 32):
    """(E, K, M) bf16 dense expert weights of a stacked PackedWeight, built
    `experts` at a time: the bf16 `torch.bmm` yardstick's operand."""
    from repro_torch.core.packing import PackedWeight

    e = pw.packed5.shape[0]
    out = torch.empty((e, pw.K, pw.M), dtype=torch.bfloat16, device="cuda")
    for i in range(0, e, experts):
        part = PackedWeight(pw.packed5[i:i + experts], pw.packed4[i:i + experts],
                            pw.scale[i:i + experts], pw.K)
        out[i:i + experts] = (part.unpack().to(torch.bfloat16)
                              * part.scale[..., None].to(torch.bfloat16)).transpose(1, 2)
    return out


def mla_kernel_checks(torch, model, cfg, gen) -> dict:
    """Phase 11 (a) and (b): the four grouped kernels (fused and integer,
    decode and lookup) at the first MoE layer's expert weights (256
    experts; w1: M 2048, K 7168 = 1432 g=5 + 2 g=4 groups; w2: M 7168,
    K 2048 = 408 + 2), C = MLA_TOKENS rows per expert with a zero padding
    row, bf16, against their plain versions (16 experts at a time),
    expected difference 0; then the device ms per linear's launches and
    per layer's 6, beside the bound, 256 single launches, the plain
    version (eager: 256 experts' plain version does not fit one graph), a
    decode step's rows (MLA_DECODE_ROWS real, the rest 0) and a bf16
    `torch.bmm` against the dequantized experts (a yardstick only). Also
    the batched unfused pipeline against the fused one on the same rows,
    and the grouped vector-LUT plan's geometry traps at 256 experts."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    dev = torch.device("cuda")
    layer = next(i for i, sp in enumerate(cfg.layer_specs()) if sp.ffn == "moe")
    ffn = model.layers[layer].ffn
    lins = {"w1": ffn.experts.w1.pw, "w3": ffn.experts.w3.pw, "w2": ffn.experts.w2.pw}
    e, c = lins["w1"].packed5.shape[0], MLA_TOKENS
    kinds = {"fused": (grouped_kernels(), grouped_launches),
             "int": (grouped_int_kernels(), grouped_int_launches)}
    xs = {}
    for k in {pw.K for pw in lins.values()}:
        x = (torch.randn((e, c, k), generator=gen, device=dev) * 3.0).to(torch.bfloat16)
        x[:, -1] = 0                               # a padding row of every expert
        xs[k] = x
    launches = {(kind, ln): make(torch, pw, xs[pw.K]) for kind, (_, make) in kinds.items()
                for ln, pw in lins.items()}

    # (a) against the plain versions
    max_err = {}
    for kind, (kernels, _) in kinds.items():
        for name, (kern, plain, _) in kernels.items():
            err = 0.0
            for ln in ("w1", "w2"):
                for launch in launches[(kind, ln)]:
                    args = launch[:4] if kind == "fused" else launch[:2]
                    kw = dict(g=launch[4], out_dtype=launch[5]) if kind == "fused" else dict(g=launch[2])
                    got = kern(*args, **kw)
                    want = experts_chunked(torch, plain)(*args, **kw)
                    torch.cuda.synchronize()
                    pad = got[:, -1] if kind == "fused" else got[..., -1]
                    if pad.any():
                        raise AssertionError(f"mla: {name}: a padding row's output is not 0")
                    err = max(err, (got.double() - want.double()).abs().max().item())
            max_err[name] = err
    log(f"mla: the four grouped kernels at layer {layer}'s experts (E {e}, C {c}, bf16) "
        f"against their plain versions: max |diff| {max_err}")
    for name, err in max_err.items():
        if err != 0.0:
            raise AssertionError(f"mla: {name} differs from its plain version by {err}")
    # the batched pipelines: unfused (one quantize, de-interleave and
    # dequant over the 256 experts) against fused, each through its grouped
    # kernels; bf16 outputs one rounding of f32 values 1e-7 apart: at most
    # one bf16 ulp (2^-8 of a value, bounded by 2^-7 of the largest)
    fusion_err = {}
    for ln in ("w1", "w2"):
        outs = {(impl, fusion): ops.ternary_matmul_batched(lins[ln], xs[lins[ln].K], impl=impl,
                                                           fusion=fusion)
                for impl in IMPLS for fusion in ("fused", "unfused")}
        if not torch.equal(outs[("decode", "unfused")], outs[("lookup", "unfused")]):
            raise AssertionError(f"mla: {ln}: the unfused pipeline differs between impls")
        ref = outs[("decode", "fused")].float()
        fusion_err[ln] = (outs[("decode", "unfused")].float() - ref).abs().max().item() / ref.abs().max().item()
        if fusion_err[ln] > 2.0 ** -7:
            raise AssertionError(f"mla: {ln}: unfused differs from fused by {fusion_err[ln]} of "
                                 "the largest output")
    log(f"mla: ternary_matmul_batched unfused vs fused at E {e}, C {c}: max |diff| / max |out| "
        f"{fusion_err} (bound 2^-7); unfused equal between impls")
    geometry = geometry_traps(torch, gen, LUT_GEOMETRY_TRAPS_E256, "mla", "lookup")
    decode_geometry = geometry_traps(torch, gen, DECODE_GEOMETRY_TRAPS_E256, "mla", "decode")

    # (b) device times
    deq = {ln: dequantized(torch, lins[ln]) for ln in ("w1", "w2")}
    rows = {}
    for ln in ("w1", "w2"):
        pw = lins[ln]
        sparse = torch.zeros_like(xs[pw.K])
        sparse[:MLA_DECODE_ROWS, 0] = xs[pw.K][:MLA_DECODE_ROWS, 0]
        entry = {"launches": len(launches[("fused", ln)]),
                 "bmm_ms": device_ms(torch, lambda: torch.bmm(xs[pw.K], deq[ln]))}
        for kind, (kernels, make) in kinds.items():
            ls = launches[(kind, ln)]
            nbytes = launch_bytes(torch, ls) if kind == "fused" else int_launch_bytes(ls)
            entry[f"{kind}_bytes"] = nbytes
            entry[f"{kind}_bound_ms"] = nbytes / HBM_BYTES_S * 1e3
            zero_ls = make(torch, pw, sparse)
            for name, (kern, plain, single) in kernels.items():
                entry[name] = {
                    "ms": device_ms(torch, lambda: call_launches(kind, kern, ls)),
                    "singles_ms": device_ms(torch, lambda: single_launches(kind, single, ls)),
                    "plain_ms": eager_ms(torch, lambda: call_launches(
                        kind, experts_chunked(torch, plain), ls), reps=1),
                    "zero_rows_ms": device_ms(torch, lambda: call_launches(kind, kern, zero_ls)),
                }
        entry["plans"] = {
            "lookup": [plan_row(vlg.grouped_lut_plan(pk.shape[1], pk.shape[2], c, g, e))
                       for pk, _, _, _, g, _ in launches[("fused", ln)]],
            "decode": [plan_row(tdg.grouped_decode_plan(pk.shape[1], pk.shape[2], c, g, e))
                       for pk, _, _, _, g, _ in launches[("fused", ln)]]}
        rows[ln] = entry
        log(f"mla: {ln} lookup plans: " + "; ".join(
            f"bm {r['bm']} S {r['splits']} x{r['ex']} c{r['chunk']} blocks {r['blocks']}"
            for r in entry["plans"]["lookup"]) + "; decode plans: " + "; ".join(
            f"bm {r['bm']} S {r['splits']} x{r['ex']} blocks {r['blocks']} stagings {r['stagings']}"
            for r in entry["plans"]["decode"]))
        log(f"mla: {ln} (E {e}, M {pw.M}, K {pw.K}, {entry['launches']} launches) at C={c}: bound "
            f"{entry['fused_bound_ms']:.4f} ms fused, {entry['int_bound_ms']:.4f} integer (bytes); "
            + ", ".join(f"{nm} {entry[nm]['ms']:.4f} ms ({e} single launches "
                        f"{entry[nm]['singles_ms']:.4f}, plain {entry[nm]['plain_ms']:.2f}, on a "
                        f"decode step's {MLA_DECODE_ROWS} rows {entry[nm]['zero_rows_ms']:.4f})"
                        for kernels, _ in kinds.values() for nm in kernels)
            + f"; bf16 bmm yardstick {entry['bmm_ms']:.4f} ms")
    # one MoE layer's 6 grouped launches of each kind (the kernels line's unit)
    library_ms = device_ms(torch, lambda: [torch.bmm(xs[lins[ln].K], deq["w2" if ln == "w2" else "w1"])
                                           for ln in lins])
    layer_row = {}
    for kind, (kernels, _) in kinds.items():
        ls = [launch for ln in lins for launch in launches[(kind, ln)]]
        nbytes = launch_bytes(torch, ls) if kind == "fused" else int_launch_bytes(ls)
        nops = sum(2 * e * c * launch[0].shape[1] * launch[0].shape[2] * launch[-1 if kind == "int" else 4]
                   for launch in ls)
        row = {"launches": len(ls), "bytes": nbytes, "int8_ops": nops,
               "bound_ms": max(nbytes / HBM_BYTES_S, nops / INT8_OPS_S) * 1e3,
               "bound_by": "bytes" if nbytes / HBM_BYTES_S >= nops / INT8_OPS_S else "operations",
               "library_ms": library_ms}
        for name, (kern, plain, _) in kernels.items():
            row[name] = {"ms": device_ms(torch, lambda: call_launches(kind, kern, ls)),
                         "plain_ms": eager_ms(torch, lambda: call_launches(
                             kind, experts_chunked(torch, plain), ls), reps=1)}
        layer_row[kind] = row
        log(f"mla: one layer's {len(ls)} grouped {kind} launches at C={c}: bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
            + ", ".join(f"{nm} {row[nm]['ms']:.4f} ms (plain {row[nm]['plain_ms']:.2f})"
                        for nm in kernels)
            + f", bf16 bmm yardstick (3 bmm) {library_ms:.4f} ms")
    del deq
    levers = decode_levers(torch, lins, xs, launches, kinds)
    return {"layer": layer, "experts": e, "rows_per_expert": c, "max_abs_err": max_err,
            "unfused_vs_fused_rel": fusion_err, "lut_geometry_traps": geometry,
            "decode_geometry_traps": decode_geometry,
            "per_linear": rows, "per_layer": layer_row, "decode_levers": levers}


# The grouped decode kernels' levers, each changed alone (phase 11 (b)):
# name -> (what the change restores or tries, the plan change, whether it
# applies to a segment of KG K-groups). `grouped_decode_plan` takes them
# all.
DECODE_LEVERS = {
    "stage_once": ("a block per 512 rows, each restaging its slice",
                   dict(bm=512), lambda kg: kg > 128),
    "tails": ("the g=4 tails as one expert and 512 rows a block", dict(bm=512, ex=1),
              lambda kg: kg <= 128),
}


def decode_levers(torch, lins, xs, launches, kinds) -> dict:
    """Phase 11 (b) for the two grouped decode kernels at one deepseek MoE
    layer's 6 launches (C 16): each launch timed apart, the layer on random
    rows and on a decode step's rows (MLA_DECODE_ROWS real, the rest 0)
    beside the bound of the codes of the experts that hold a row, and the
    layer with each of DECODE_LEVERS taken back alone (a changed plan
    through the same C entries), on both kinds of rows."""
    from repro_torch.kernels import _build, _splitk
    from repro_torch.kernels import ternary_decode_gemm as tdg

    dev = torch.device("cuda")
    sparse = {}
    for k, x in xs.items():
        z = torch.zeros_like(x)
        z[:MLA_DECODE_ROWS, 0] = x[:MLA_DECODE_ROWS, 0]
        sparse[k] = z
    out = {"decode_rows": MLA_DECODE_ROWS}
    for kind, (_, make) in kinds.items():
        rows = {"random": [launch for ln in lins for launch in launches[(kind, ln)]],
                "decode": [launch for ln, pw in lins.items() for launch in make(torch, pw, sparse[pw.K])]}

        def prepared(ls, change=None):
            """[(launch fn)] for the layer's launches under their plans, each
            changed by `change` where it applies."""
            calls = []
            for launch in ls:
                pk = launch[0]
                e, m, kg = pk.shape
                g = launch[4] if kind == "fused" else launch[2]
                c = launch[1].shape[1] if kind == "fused" else launch[1].shape[-1]
                plan = tdg.grouped_decode_plan(m, kg, c, g, e)
                if change is not None and change[1](kg):
                    plan = dataclasses.replace(plan, **change[0])
                ws, cnt = _splitk.launch_args(plan, dev)
                if kind == "fused":
                    _, x, sc, w, _, odt = launch
                    o = torch.empty((e, c, m), dtype=odt, device=dev)
                    calls.append(lambda pk=pk, x=x, sc=sc, w=w, o=o, p=plan, ws=ws, cnt=cnt, g=g:
                                 _build.launch_decode_grouped(pk, x, sc, w, g, o, p, ws, cnt))
                else:
                    _, a_r, _ = launch
                    o = torch.empty((e, m, c), dtype=torch.int32, device=dev)
                    calls.append(lambda pk=pk, a_r=a_r, o=o, p=plan, ws=ws, cnt=cnt, g=g:
                                 _build.launch_decode_int_grouped(pk, a_r, g, o, p, ws, cnt))
            return calls

        def layer_ms(calls):
            return device_ms(torch, lambda: [f() for f in calls])

        base = {r: prepared(ls) for r, ls in rows.items()}
        row = {"launch_ms": [device_ms(torch, f) for f in base["random"]],
               "layer_ms": {r: layer_ms(calls) for r, calls in base.items()},
               "stagings": [tdg.grouped_decode_plan(*l[0].shape[1:], MLA_TOKENS, l[4 if kind == "fused" else 2],
                                                    l[0].shape[0]).stagings for l in rows["random"]],
               "levers": {}}
        # the experts holding a real row are the first MLA_DECODE_ROWS
        nbytes = sum(l[0][:MLA_DECODE_ROWS].numel() for l in rows["decode"])
        row["active_codes_bytes"] = nbytes
        row["active_bound_ms"] = nbytes / HBM_BYTES_S * 1e3
        for name, (what, change, applies) in DECODE_LEVERS.items():
            row["levers"][name] = {"restores": what, **{
                r: layer_ms(prepared(ls, (change, applies))) for r, ls in rows.items()}}
        out[kind] = row
        log(f"mla: grouped decode {kind}, one layer's 6 launches (E 256, C 16): "
            + ", ".join(f"{t:.4f}" for t in row["launch_ms"]) + f" ms apart (stagings {row['stagings']}); "
            f"the layer {row['layer_ms']['random']:.4f} ms on random rows, "
            f"{row['layer_ms']['decode']:.4f} on a decode step's {MLA_DECODE_ROWS} rows (the codes of the "
            f"experts that hold one: bound {row['active_bound_ms']:.4f} ms); levers taken back, "
            "random / decode rows: "
            + "; ".join(f"{nm} ({lv['restores']}) {lv['random']:.4f} / {lv['decode']:.4f}"
                        for nm, lv in row["levers"].items()))
    return out


def mla_wkv_b_unpack_ms(torch, model, cfg) -> dict:
    """Device ms (CUDA-graph replay) of one layer's `_wkv_b_dense`: the
    absorbed decode unpacks wkv_b to f32 in every layer at every step."""
    from repro_torch.models.mla import _wkv_b_dense

    mixer = model.layers[0].mixer
    ms = device_ms(torch, lambda: _wkv_b_dense(mixer, cfg, torch.float32))
    ql, kvl, nope, rp, vd = (cfg.mla.q_lora_rank, cfg.mla.kv_lora_rank, cfg.mla.qk_nope_dim,
                             cfg.mla.qk_rope_dim, cfg.mla.v_dim)
    return {"layer_ms": ms, "step_ms": ms * cfg.n_layers,
            "f32_bytes": 4 * kvl * cfg.n_heads * (nope + vd)}


def check_mla(torch, counters, graph_rows) -> dict:
    """Phase 11: the MLA mixer and deepseek-v3-671b at its published widths,
    depth cut to MLA_LAYERS (bf16, random weights from a seeded generator,
    drawn and packed layer by layer): (a)-(b) `mla_kernel_checks`; (c)
    serving 8 greedy requests (prompts 16-64, 16 new tokens, 4 slots) with
    impl="decode" and "lookup" (same tokens), unfused with both impls (same
    tokens; each divergence from the fused run a near-tie or after a
    routing flip, `fusion_divergences`), chunk 64 + chain k 4, and paged
    (page 16) whole-prompt, each with its launches counted per forward path
    and no other mpGeMM kernel, every request completed; one prefill's
    logits through the kernels against their plain versions, fused and
    unfused; (d) one decode step
    of 4 full slots under torch.profiler, the wkv_b unpack's and the MoE
    dispatch's device time."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, init_lm, prefill
    from repro_torch.models.moe import capacity
    from repro_torch.serve import PagedKVConfig
    from repro_torch.spec import SpecConfig

    t0 = time.perf_counter()
    full = get_config(MLA_ARCH)
    cfg = full.with_(n_layers=MLA_LAYERS, layers=full.layers[:MLA_LAYERS])
    specs = cfg.layer_specs()
    n_moe = sum(sp.ffn == "moe" for sp in specs)
    torch.cuda.reset_peak_memory_stats()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0), packed=True)
    torch.cuda.synchronize()
    model_bytes = packed_model_bytes(model)
    out = {"arch": cfg.name, "layers": cfg.n_layers, "dense_layers": cfg.n_layers - n_moe,
           "moe_layers": n_moe, "reduced": {"n_layers": [full.n_layers, cfg.n_layers]},
           "d_model": cfg.d_model, "experts": cfg.moe.n_experts, "model_bytes": model_bytes,
           "build_s": time.perf_counter() - t0,
           "build_peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"mla: {cfg.name} {cfg.dtype}, {cfg.n_layers} of {full.n_layers} layers ({cfg.n_layers - n_moe} "
        f"dense, {n_moe} MoE), d {cfg.d_model}, {cfg.n_heads} heads, MLA {cfg.mla}, "
        f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} d_ff {cfg.moe.d_ff_expert}, vocab "
        f"{cfg.vocab}: built and packed layer by layer in {out['build_s']:.1f} s (peak "
        f"{out['build_peak_bytes'] / 2**30:.2f} GiB); bytes {model_bytes}")
    gen = torch.Generator(device="cuda").manual_seed(4)
    out["kernels"] = mla_kernel_checks(torch, model, cfg, gen)

    # (c) serving
    for impl in IMPLS:
        for fusion in ("fused", "unfused"):
            single = single_kernel(impl, fusion)
            want = {single: 16 * cfg.n_layers, f"{single}_grouped": 6 * n_moe}
            got = launches_per_forward(model, impl, fusion)
            absorbed = launches_per_forward(model, impl, fusion, expand=False)
            if got != want or absorbed != {**want, single: 14 * cfg.n_layers}:
                raise AssertionError(f"mla: launches per forward {got} / {absorbed}: expected 16 / 14 "
                                     "single a layer and 6 grouped a MoE layer")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(16, 65))).astype(np.int32)
               for _ in range(8)]
    runs = {}
    for impl in IMPLS:
        runs[impl] = serve_multi(torch, model, cfg, prompts, counters, f"mla {impl}", impl=impl)
    if runs["decode"]["tokens"] != runs["lookup"]["tokens"]:
        raise AssertionError("mla: impl=decode and impl=lookup emitted different greedy tokens")
    for impl in IMPLS:
        runs[f"unfused_{impl}"] = serve_multi(torch, model, cfg, prompts, counters,
                                              f"mla unfused {impl}", impl=impl, fusion="unfused",
                                              traced=True)
    if runs["unfused_decode"]["tokens"] != runs["unfused_lookup"]["tokens"]:
        raise AssertionError("mla: unfused impl=decode and impl=lookup emitted different tokens")
    # fused sums each segment in f32, unfused in int32: they part at a
    # near-tie or after a routing flip (`fusion_divergences` raises otherwise)
    divs = fusion_divergences(torch, model, cfg, [
        (p, r, g) for p, r, g in zip(prompts, runs["decode"]["tokens"],
                                     runs["unfused_decode"]["tokens"]) if r != g])
    runs["unfused_decode"]["divergences"] = divs
    log(f"mla: unfused tokens equal between impls; {len(divs)}/8 requests leave the fused run's "
        "tokens: " + ", ".join(
            f"step {d['step']} (gap {d['gap']:.2e} of {d['max_abs_logit']:.3f}, "
            f"{d['routing_flips']} of {d['routed_tokens']} routed tokens flipped before it)"
            for d in divs))
    runs["chunked_chain"] = serve_multi(torch, model, cfg, prompts, counters, "mla chunked chain",
                                        spec=SpecConfig(k=SPEC_K), prefill_chunk=PREFILL_CHUNK)
    runs["paged"] = serve_multi(torch, model, cfg, prompts, counters, "mla paged",
                                paged_kv=PagedKVConfig(page_size=PAGE_SIZE))
    for name in ("chunked_chain", "paged"):
        row = runs[name]
        row["rows_per_expert"] = {int(n): capacity(int(n), cfg) for n in row["mpgemm_tokens_per_launch"]}
        row["same_tokens_as_whole_prompt"] = sum(
            a == b for a, b in zip(row["tokens"], runs["decode"]["tokens"]))
        log(f"mla: {name}: rows per expert by step tokens {row['rows_per_expert']}; "
            f"{row['same_tokens_as_whole_prompt']}/8 requests emit the whole-prompt run's tokens "
            "(padding rows take capacity in a wide step, as in JAX)")
    out["serve"] = {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in runs.items()}

    tok = torch.from_numpy(prompts[0][None, :]).cuda()
    with ops.dispatch_override(impl="decode"):
        got, _ = prefill(model, tok, init_cache(cfg, 1, 256, device="cuda"), cfg)
        with plain_mpgemm(torch):
            want, _ = prefill(model, tok, init_cache(cfg, 1, 256, device="cuda"), cfg)
    got, want = got.float(), want.float()
    if got.shape != (1, cfg.vocab) or not torch.isfinite(got).all():
        raise AssertionError(f"mla: bad logits, shape {tuple(got.shape)}")
    diff, scale = (got - want).abs().max().item(), want.abs().max().item()
    out["logits_kernels_vs_plain"] = {"max_abs_diff": diff, "max_abs_logit": scale,
                                      "argmax": [int(got.argmax()), int(want.argmax())]}
    log(f"mla: prefill logits through the kernels vs their plain versions: max |diff| {diff}, "
        f"max |logit| {scale:.4f}, argmax {int(got.argmax())} vs {int(want.argmax())}")
    if diff > MOE_LOGIT_RTOL * scale:
        raise AssertionError(f"mla: logits differ by {diff} > {MOE_LOGIT_RTOL} * {scale}")
    with ops.dispatch_override(impl="decode", fusion="unfused"):
        got, _ = prefill(model, tok, init_cache(cfg, 1, 256, device="cuda"), cfg)
        with plain_mpgemm(torch):
            want, _ = prefill(model, tok, init_cache(cfg, 1, 256, device="cuda"), cfg)
    got, want = got.float(), want.float()
    diff, scale = (got - want).abs().max().item(), want.abs().max().item()
    out["unfused_logits_kernels_vs_plain"] = {"max_abs_diff": diff, "max_abs_logit": scale}
    log(f"mla: unfused prefill logits through the integer kernels vs their plain versions: "
        f"max |diff| {diff}, max |logit| {scale:.4f}")
    if not torch.isfinite(got).all() or diff > MOE_LOGIT_RTOL * scale:
        raise AssertionError(f"mla: unfused logits differ by {diff} > {MOE_LOGIT_RTOL} * {scale}")

    # (d) one decode step of 4 full slots: the wkv_b unpack's and the MoE
    # dispatch's share of it
    prof = profile_decode(torch, model, cfg, prompts, op_names=MOE_DISPATCH_OPS,
                          cuda_graphs=False)
    prof["wkv_b_unpack"] = mla_wkv_b_unpack_ms(torch, model, cfg)
    prof["moe_layer"] = moe_dispatch_ms(torch, model, cfg, tokens=4, layer=out["kernels"]["layer"])
    prof["moe_dispatch_ms_per_step"] = prof["moe_layer"]["dispatch_ms"] * n_moe
    for key, ms in (("wkv_b_unpack_share", prof["wkv_b_unpack"]["step_ms"]),
                    ("moe_dispatch_share", prof["moe_dispatch_ms_per_step"])):
        prof[key] = ms / prof["device_ms_per_step"] if prof["device_ms_per_step"] else None
    out["decode_profile"] = prof
    ml = prof["moe_layer"]
    log(f"mla: decode step (4 slots) wall {prof['wall_ms_per_step']:.3f} ms, device busy "
        f"{prof['device_ms_per_step']:.3f} ms"
        + (f" ({100 * prof['device_busy_share']:.1f}%)" if prof["device_busy_share"] else
           " (the profiler saw no device time: not measured)")
        + f"; wkv_b unpack {prof['wkv_b_unpack']['layer_ms']:.4f} ms a layer, "
        f"{prof['wkv_b_unpack']['step_ms']:.3f} ms a step"
        + (f" ({100 * prof['wkv_b_unpack_share']:.1f}% of device time)"
           if prof["wkv_b_unpack_share"] is not None else "")
        + f"; one MoE layer at 4 tokens {ml['layer_ms']:.4f} ms: its dispatch alone "
        f"{ml['dispatch_ms']:.4f} ms, its expert compute alone {ml['expert_compute_ms']:.4f} ms on "
        f"random rows, {ml['expert_compute_zero_rows_ms']:.4f} ms on the layer's own rows "
        f"({ml['real_rows']} of {cfg.moe.n_experts} x {ml['rows_per_expert']} real); dispatch x "
        f"{n_moe} layers {prof['moe_dispatch_ms_per_step']:.3f} ms a step"
        + (f" ({100 * prof['moe_dispatch_share']:.1f}% of device time)"
           if prof["moe_dispatch_share"] is not None else ""))
    for name, ms in prof["top_kernels_ms_per_step"]:
        log(f"mla:   {ms:8.4f} ms  {name}")
    for name, (ms, calls) in prof["op_device_ms_per_step"].items():
        log(f"mla:   op {name}: {ms:.4f} ms device, {calls:.1f} calls per step")
    out["seconds"] = time.perf_counter() - t0
    log(f"mla: phase 11 took {out['seconds']:.1f} s")
    # phase 22 while the model is loaded: graphed against eager serving
    graph_rows["deepseek-v3 decode"] = graph_compare(torch, model, cfg, counters,
                                                     "deepseek-v3 decode",
                                                     *graph_prompts(cfg, 22))
    del model
    torch.cuda.empty_cache()
    return out


def layer_weights(layer) -> dict:
    """{(M, K): PackedWeight} of one layer's BitLinears."""
    out = {}
    for lin in packed_linears(layer):
        out.setdefault((lin.pw.M, lin.pw.K), lin.pw)
    return out


def int_vs_plain(torch, weights, tokens, gen, memo=None):
    """Each integer kernel against its plain version at every weight's
    segments and token count N (the activations quantized and
    de-interleaved as the unfused pipeline does); phases 5, 12, 13, 15, 20
    and 21. `memo`: a set of the launch shapes (M, KG, g, N) checked
    earlier in the run, skipped here, and this call's added to it.
    → ({name: max |diff|}, number of checks)."""
    from repro_torch.core import act_quant_tokens
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    kernels = int_kernels()
    max_err, n_checks = {name: 0 for name in kernels}, 0
    for (m, k), pw in weights.items():
        for n in tokens:
            a_q, _ = act_quant_tokens(torch.randn((k, n), generator=gen, device=dev) * 3.0)
            for packed, lo, hi, g in ops._segments(pw):
                if seen(memo, ("int", m, packed.shape[1], g, n)):
                    continue
                a_r = ops._deinterleave(a_q[lo:hi], g)
                for name, (kern, plain) in kernels.items():
                    got, want = kern(packed, a_r, g=g), plain(packed, a_r, g=g)
                    torch.cuda.synchronize()
                    assert got.dtype == want.dtype == torch.int32 and got.shape == want.shape == (m, n)
                    max_err[name] = max(max_err[name], (got.long() - want.long()).abs().max().item())
                    n_checks += 1
    return max_err, n_checks


def packed_linears(module) -> list:
    """The PackedLinear modules of `module`, in order."""
    from repro_torch.models.common import PackedLinear

    return [m for m in module.modules() if isinstance(m, PackedLinear)]


def forward_launch_ms(torch, lins, n: int, gen, plain_lins=None, yardsticks: bool = True) -> dict:
    """Device ms of one forward's mpGeMM launches at N tokens (the
    BitLinears `lins`, each packed segment one launch: the codes stream
    from memory as in serving), for both fused kernels (CUDA-graph replay,
    and eager between events), beside the bound (bytes / HBM rate or int8
    ops / peak), their plain versions and a bf16 `torch.matmul` against
    the dequantized weights (a yardstick only). A two-segment linear writes
    f32 partials, as `ops._mpgemm_tokens` does. `plain_lins` (default
    `lins`): the linears whose launches the plain versions are timed on
    (phase 15 times them on one layer at N 6000: the plain vector-LUT
    gather takes ~1 s a linear there). `yardsticks=False`: the kernels'
    graph replays alone (phase 17 (e)). Phases 3, 12, 13, 15 and 17."""
    from repro_torch.core import act_token_scale
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    plain_lins = lins if plain_lins is None else plain_lins
    xs = {k: torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
          for k in {lin.pw.K for lin in lins}}
    sc = {k: act_token_scale(x.T).contiguous() for k, x in xs.items()}

    def launches_of(linears):
        out = []
        for lin in linears:
            segs = ops._segments(lin.pw)
            out_dt = torch.bfloat16 if len(segs) == 1 else torch.float32
            for packed, lo, hi, g in segs:
                out.append((packed, xs[lin.pw.K][:, lo:hi], sc[lin.pw.K], lin.scale, g, out_dt))
        return out

    launches, plain_launches = launches_of(lins), launches_of(plain_lins)
    nbytes = sum(p.numel() + w.numel() * 4 + x.numel() * 2 + a.numel() * 4
                 + n * p.shape[0] * (2 if dt == torch.bfloat16 else 4)
                 for p, x, a, w, _, dt in launches)
    nops = sum(2 * n * p.shape[0] * x.shape[1] for p, x, _, _, _, _ in launches)
    row = {"n": n, "launches": len(launches), "bytes": nbytes, "int8_ops": nops,
           "bound_ms": max(nbytes / HBM_BYTES_S, nops / INT8_OPS_S) * 1e3,
           "bound_by": "bytes" if nbytes / HBM_BYTES_S >= nops / INT8_OPS_S else "operations",
           "plain_launches": len(plain_launches)}

    def run(fn, todo=launches):
        for p, x, a, w, g, dt in todo:
            fn(p, x, a, w, g=g, out_dtype=dt)

    for name, (kern, plain) in fused_kernels().items():
        row[name] = {"ms": device_ms(torch, lambda kern=kern: run(kern))}
        if yardsticks:
            row[name]["eager_ms"] = eager_ms(torch, lambda kern=kern: run(kern))
            row[name]["plain_ms"] = device_ms(
                torch, lambda plain=plain: run(plain, plain_launches), reps=1)
    if not yardsticks:
        return row
    dense = [(xs[lin.pw.K], lin.pw.unpack().to(torch.bfloat16)
              .mul_(lin.scale[:, None].to(torch.bfloat16)).T.contiguous()) for lin in lins]
    row["library_ms"] = device_ms(torch, lambda: [x @ d for x, d in dense])
    del dense
    return row


def int_forward_launch_ms(torch, lins, n: int, gen, plain_lins=None,
                          yardsticks: bool = True) -> dict:
    """`forward_launch_ms` for the two integer kernels (#3, #4): each packed
    segment's launch on its int8 activations, quantized and de-interleaved
    as the unfused pipeline does, beside the bound (codes, int8
    activations and int32 output vs int8 ops), the plain versions (on
    `plain_lins`' launches) and `torch._int_mm` on the unpacked int8
    weights where its shape rules hold (N > 16; a yardstick only);
    `yardsticks=False`: the kernels alone. Phases 15 and 17."""
    from repro_torch.core import act_quant_tokens
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    plain_lins = lins if plain_lins is None else plain_lins
    a_qs = {k: act_quant_tokens(torch.randn((k, n), generator=gen, device=dev) * 3.0)[0]
            for k in {lin.pw.K for lin in lins}}                      # (K, N) int8

    def launches_of(linears):
        return [(packed, ops._deinterleave(a_qs[lin.pw.K][lo:hi], g), g)
                for lin in linears for packed, lo, hi, g in ops._segments(lin.pw)]

    launches, plain_launches = launches_of(lins), launches_of(plain_lins)
    nbytes = sum(p.numel() + a.numel() + 4 * p.shape[0] * n for p, a, _ in launches)
    nops = sum(2 * p.shape[0] * n * a.shape[0] * a.shape[1] for p, a, _ in launches)
    row = {"n": n, "launches": len(launches), "bytes": nbytes, "int8_ops": nops,
           "bound_ms": max(nbytes / HBM_BYTES_S, nops / INT8_OPS_S) * 1e3,
           "bound_by": "bytes" if nbytes / HBM_BYTES_S >= nops / INT8_OPS_S else "operations",
           "plain_launches": len(plain_launches)}

    def run(fn, todo=launches):
        for p, a, g in todo:
            fn(p, a, g=g)

    for name, (kern, plain) in int_kernels().items():
        row[name] = {"ms": device_ms(torch, lambda kern=kern: run(kern))}
        if yardsticks:
            row[name]["plain_ms"] = device_ms(
                torch, lambda plain=plain: run(plain, plain_launches), reps=1)
    row["library_ms"] = None
    if n > 16 and yardsticks:   # torch._int_mm's shape rules: more than 16 rows, K and M multiples of 8
        qs = {k: q.T.contiguous() for k, q in a_qs.items()}           # (N, K)
        w_int8 = [(qs[lin.pw.K], lin.pw.unpack().T) for lin in lins]
        row["library_ms"] = device_ms(torch, lambda: [torch._int_mm(q, w) for q, w in w_int8])
        del w_int8
    return row


def head_ms(torch, model, cfg, slots: int = 4) -> dict:
    """Device ms of the f32 logits head on one decode step's hidden states
    (tied: the embedding table cast to f32 and multiplied), beside the
    bytes of its table."""
    from repro_torch.models.decoder import _head_matmul

    h = torch.randn((slots, 1, cfg.d_model), device="cuda").to(torch.bfloat16)
    table = model.head.w if model.head is not None else model.embed.table
    return {"ms": device_ms(torch, lambda: _head_matmul(model, h, cfg)),
            "table_bytes": table.numel() * table.element_size(), "tied": model.head is None}


def new_arch_model(torch, arch: str, n_layers: int | None = None):
    """An architecture at its published widths and depth (or its first
    `n_layers` layers), random weights from a seeded generator on the card,
    drawn and packed layer by layer. → (cfg, model, facts)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    t0 = time.perf_counter()
    full = get_config(arch)
    cfg = full if n_layers is None else full.with_(n_layers=n_layers, layers=full.layers[:n_layers])
    # an engine holds itself in a cycle (its wrapped `add`, `decode_once`):
    # the models of earlier phases stay alive until the collector runs
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_lm(cfg, torch.Generator(device="cuda").manual_seed(0), packed=True)
    torch.cuda.synchronize()
    out = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
           "model_bytes": packed_model_bytes(model), "build_s": time.perf_counter() - t0,
           "build_peak_bytes": torch.cuda.max_memory_allocated()}
    if cfg.n_layers != full.n_layers:
        out["reduced"] = {"n_layers": [full.n_layers, cfg.n_layers]}
    log(f"{arch}: {cfg.dtype}, {cfg.n_layers} of {full.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab}: built and packed layer by layer in {out['build_s']:.1f} s (peak "
        f"{out['build_peak_bytes'] / 2**30:.2f} GiB); bytes {out['model_bytes']}")
    return cfg, model, out


def single_linears(modules) -> list:
    """The PackedLinear modules of `modules` with one dense weight each (a
    MoE layer's stacked experts left out), in order."""
    return [lin for mod in modules for lin in packed_linears(mod) if lin.pw.packed5.ndim == 2]


def new_arch_kernels(torch, model, label: str, layers=(0,), memo=None, timed_layers=None) -> dict:
    """Phases 12, 13, 20 and 21 (a): kernels #1-#4 against their plain
    versions at the BitLinear shapes of `layers` (dense weights), N in
    ODD_TOKENS (fused: f32, bf16 and bf16 -> f32), expected difference 0,
    skipping the launch shapes `memo` holds (checked earlier in the run);
    then the launches of one forward (or of `timed_layers` alone: at d 8192
    a whole forward's bf16 yardstick does not fit the card beside the
    model) timed at N = DECODE_N (`forward_launch_ms`)."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(12)
    weights = {}
    for lin in single_linears(model.layers[i] for i in layers):
        weights.setdefault((lin.pw.M, lin.pw.K), lin.pw)
    fused_err, n_fused = fused_vs_plain(torch, fused_kernels(), weights, ODD_TOKENS, gen, memo=memo)
    int_err, n_int = int_vs_plain(torch, weights, ODD_TOKENS, gen, memo=memo)
    err = {**fused_err, **int_err}
    segs = {f"{m}x{k}": [[int(p.shape[1]), g] for p, _, _, g in ops._segments(pw)]
            for (m, k), pw in weights.items()}
    log(f"{label}: {n_fused + n_int} kernel-vs-plain checks at (M, K) {sorted(weights)} of "
        f"layers {tuple(layers)} (segments [KG, g]: {segs}), N {ODD_TOKENS}, the launch shapes "
        f"not checked earlier in the run: max |diff| {err}")
    for name, e in err.items():
        if e != 0:
            raise AssertionError(f"{label}: {name} differs from its plain version by {e} (expected 0)")
    timed = single_linears([model] if timed_layers is None else
                           [model.layers[i] for i in timed_layers])
    row = forward_launch_ms(torch, timed, DECODE_N, gen)
    row["layers"] = None if timed_layers is None else list(timed_layers)
    what = "one forward's" if timed_layers is None else f"layers {tuple(timed_layers)}:"
    log(f"{label}: {what} {row['launches']} launches at N={DECODE_N}: bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
        + ", ".join(f"{nm} {row[nm]['ms']:.4f} ms (plain {row[nm]['plain_ms']:.4f})"
                    for nm in fused_kernels())
        + f", bf16 matmul yardstick {row['library_ms']:.4f} ms")
    return {"max_abs_err": err, "checks": n_fused + n_int, "shapes": sorted(weights),
            "segments": segs, "forward_ms": row}


def windowed(cfg) -> bool:
    return any(sp.window for sp in cfg.layer_specs())


def new_arch_prompts(cfg, seed: int) -> list:
    """8 prompts: 6 of 16-64 tokens and, second and sixth, two long ones
    (LONG_PROMPT; past the window where the architecture has one)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = [int(rng.integers(16, 65)) for _ in range(8)]
    long = WINDOW_LONG_PROMPT if windowed(cfg) else LONG_PROMPT
    lens[1], lens[5] = (int(rng.integers(*long)) for _ in range(2))
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lens]


def new_arch_serving(torch, model, cfg, counters, label: str, seed: int) -> tuple:
    """Phases 12, 13, 20 and 21 (b), (d), (f): 8 greedy requests (6 prompts
    of 16-64 tokens, two long ones), 4 slots, 16 new tokens each, through
    fused decode, fused lookup and unfused decode, each run's counts zeroed
    just before it and checked per forward (the model's launches equal to
    those reckoned from its config, `reckoned_launches`; no other mpGeMM
    kernel); decode and lookup emit the same tokens, unfused the same or
    leaves them where the pipelines' rounding or a routing flip explains
    it (`fusion_divergences`); one prefill's logits (the longest prompt)
    through the kernels against their plain versions, fused and unfused,
    and fused against unfused. → (rows, prompts)."""
    from repro_torch.kernels import ops
    from repro_torch.models import init_cache, prefill

    max_len = WINDOW_MAX_LEN if windowed(cfg) else NEW_MAX_LEN
    prompts = new_arch_prompts(cfg, seed)
    for impl, fusion in (("decode", "fused"), ("lookup", "fused"), ("decode", "unfused")):
        got, want = launches_per_forward(model, impl, fusion), reckoned_launches(cfg, impl, fusion)
        if got != want:
            raise AssertionError(f"{label}: launches per forward {got}, reckoned from the config "
                                 f"{want}")
    log(f"{label}: launches per forward {launches_per_forward(model, 'decode')}, as reckoned from "
        "the config")
    runs = {}
    for name, impl, fusion in (("decode", "decode", "fused"), ("lookup", "lookup", "fused"),
                               ("unfused", "decode", "unfused")):
        runs[name] = serve_multi(torch, model, cfg, prompts, counters, f"{label} {name}",
                                 impl=impl, fusion=fusion, max_len=max_len)
    if runs["decode"]["tokens"] != runs["lookup"]["tokens"]:
        raise AssertionError(f"{label}: impl=decode and impl=lookup emitted different greedy tokens")
    # unfused leaves fused only at a near-tie, after a routing flip or where
    # the model's rounding sensitivity explains it (`fusion_divergences`
    # raises otherwise)
    pairs = [(p, r, g) for p, r, g in zip(prompts, runs["decode"]["tokens"],
                                          runs["unfused"]["tokens"]) if g != r]
    divs = fusion_divergences(torch, model, cfg, pairs, max_len, f32=True)
    log(f"{label} unfused: greedy tokens "
        + ("equal the fused run's" if not divs else
           f"leave the fused run's in {len(divs)}/8 requests at: " + ", ".join(
               f"step {d['step']} (gap {d['gap']:.2e} of {d['max_abs_logit']:.3f}"
               + (", a near-tie" if d["near_tie"] else "")
               + f"; pipelines' logits {d['logits_max_abs_diff']:.2e} apart"
               + (f", fused bf16 {d['bf16_vs_f32_max_abs_diff']:.2e} from its f32 copy"
                  if "bf16_vs_f32_max_abs_diff" in d else "")
               + f"; {d['routing_flips']} of {d['routed_tokens']} routed tokens flipped "
               "before it)" for d in divs)))
    out = {"prompt_lens": [len(p) for p in prompts], "max_len": max_len,
           "serve": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in runs.items()},
           "unfused_divergences": divs}
    for k, r in runs.items():
        log(f"{label}: {k}: decode_tok_s {r['decode_tok_s']:.1f} (decode_once alone "
            f"{r['decode_only_tok_s']:.1f}), ttft_p50_ms {r['ttft_p50_ms']:.1f}, "
            f"prefill_tok_s {r['prefill_tok_s']:.1f}, N per launch {r['mpgemm_tokens_per_launch']}")

    tok = torch.from_numpy(max(prompts, key=len)[None, :]).cuda()
    out["logits_kernels_vs_plain"] = {}
    rows = {}
    for fusion in ("fused", "unfused"):
        with torch.no_grad(), ops.dispatch_override(impl="decode", fusion=fusion):
            got, _ = prefill(model, tok, init_cache(cfg, 1, max_len, device="cuda"), cfg)
            with plain_mpgemm(torch):
                want, _ = prefill(model, tok, init_cache(cfg, 1, max_len, device="cuda"), cfg)
        got, want = got.float(), want.float()
        if got.shape != (1, cfg.vocab) or not torch.isfinite(got).all():
            raise AssertionError(f"{label}: bad logits, shape {tuple(got.shape)}")
        diff, scale = (got - want).abs().max().item(), want.abs().max().item()
        out["logits_kernels_vs_plain"][fusion] = {"tokens": int(tok.shape[1]),
                                                  "max_abs_diff": diff, "max_abs_logit": scale}
        log(f"{label}: prefill logits ({tok.shape[1]} tokens, {fusion}) through the kernels vs "
            f"their plain versions: max |diff| {diff}, max |logit| {scale:.4f}")
        if diff > MOE_LOGIT_RTOL * scale:
            raise AssertionError(f"{label}: logits differ by {diff} > {MOE_LOGIT_RTOL} * {scale}")
        rows[fusion] = got
    drift = (rows["fused"] - rows["unfused"]).abs().max().item()
    out["logits_fused_vs_unfused"] = {"max_abs_diff": drift,
                                      "max_abs_logit": rows["fused"].abs().max().item()}
    log(f"{label}: prefill logits fused vs unfused: max |diff| {drift:.5f} of "
        f"{out['logits_fused_vs_unfused']['max_abs_logit']:.4f}")
    return out, prompts


def rounding_sensitivity(torch, model, cfg, prompt, label: str) -> dict:
    """How far the model moves its logits under rounding alone: one
    prefill's logits of the first 2, 8 and all layers (the same weights, the head
    on top) through the fused and the unfused pipeline, in bf16 and on an
    f32 copy. Fused and unfused differ only in the two-segment sums (f32
    partials against one int32 sum): a few f32 ulp, which each int8
    activation code at a rounding boundary turns into a step. Each
    distance is relative to the f32 fused logits' largest entry."""
    from repro_torch.kernels import ops
    from repro_torch.models import LM, init_cache, prefill

    f32_model, c32 = copy.deepcopy(model).float(), cfg.with_(dtype="float32")
    tok = torch.from_numpy(prompt[None, :]).cuda()
    out = {}
    for depth in sorted({d for d in (2, 8) if d < cfg.n_layers} | {cfg.n_layers}):
        rows = {}
        for kind, m, c in (("bf16", model, cfg), ("f32", f32_model, c32)):
            cut = c.with_(n_layers=depth, layers=c.layers[:depth])
            shallow = LM(m.embed, list(m.layers)[:depth], m.final_norm, m.head)
            for fusion in ("fused", "unfused"):
                with torch.no_grad(), ops.dispatch_override(impl="decode", fusion=fusion):
                    lg, _ = prefill(shallow, tok, init_cache(cut, 1, len(prompt), device="cuda"), cut)
                rows[f"{kind}_{fusion}"] = lg[0].float()
        scale = rows["f32_fused"].abs().max().item()

        def dist(a, b, rows=rows, scale=scale):
            return (rows[a] - rows[b]).abs().max().item() / scale

        out[depth] = {"max_abs_logit": scale,
                      "f32_fused_vs_unfused": dist("f32_fused", "f32_unfused"),
                      "bf16_fused_vs_unfused": dist("bf16_fused", "bf16_unfused"),
                      "bf16_fused_vs_f32_fused": dist("bf16_fused", "f32_fused")}
        log(f"{label}: rounding sensitivity at {depth} layers (of max |logit| {scale:.3f}): "
            + ", ".join(f"{k} {v:.2e}" for k, v in out[depth].items() if k != "max_abs_logit"))
    del f32_model
    torch.cuda.empty_cache()
    return out


def new_arch_profile(torch, model, cfg, prompts, label: str) -> dict:
    """Phases 12 and 13 (e): one decode step of 4 full slots under
    torch.profiler (wall and device ms, busy share, device ms by kernel),
    and the f32 head's device ms on its own (`head_ms`)."""
    prof = profile_decode(torch, model, cfg, [p for p in prompts if len(p) <= 64], op_names=())
    prof["head"] = head_ms(torch, model, cfg)
    dev_ms = prof["device_ms_per_step"]
    prof["head"]["share"] = prof["head"]["ms"] / dev_ms if dev_ms else None
    log(f"{label}: decode step (4 slots) wall {prof['wall_ms_per_step']:.3f} ms, device busy "
        f"{dev_ms:.3f} ms"
        + (f" ({100 * prof['device_busy_share']:.1f}%)" if prof["device_busy_share"] else
           " (the profiler saw no device time: not measured)")
        + f"; f32 head alone {prof['head']['ms']:.4f} ms (table {prof['head']['table_bytes']} "
        f"bytes, tied {prof['head']['tied']})")
    for name, ms in prof["top_kernels_ms_per_step"]:
        log(f"{label}:   {ms:8.4f} ms  {name}")
    return prof


def ssm_layer_ms(torch, model, cfg, slots: int = 4) -> dict:
    """Device ms (CUDA-graph replay) of layer 0's SSM mixer at one decode
    step of `slots` slots: whole; its own plain-PyTorch ops alone (conv,
    softplus, the recurrence, the skip term, the gated norm) with in_proj
    and out_proj stubbed by zeros of their output shapes; its two
    BitLinears alone. Beside them the bytes each must move: the f32 state
    read and written, and the packed codes."""
    from repro_torch.models import ssm
    from repro_torch.models.common import linear_apply

    mixer, dev, sc = model.layers[0].mixer, torch.device("cuda"), cfg.ssm
    cache = ssm.ssm_cache_init(cfg, None, slots, 1, torch.bfloat16, dev)
    cache["state"].normal_()
    gen = torch.Generator(device=dev).manual_seed(5)
    u = torch.randn((slots, 1, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    y = torch.randn((slots, 1, sc.d_inner), generator=gen, device=dev).to(torch.bfloat16)

    def apply():
        ssm.ssm_apply(mixer, u, cfg=cfg, spec=None, mode="serve", cache=cache)

    def zeros_linear(p, x, mode="serve"):
        return x.new_zeros((*x.shape[:-1], p.pw.M))

    whole = device_ms(torch, apply)
    with planted(ssm, "linear_apply", zeros_linear):
        own = device_ms(torch, apply)
    linears = device_ms(torch, lambda: (linear_apply(mixer.in_proj, u),
                                        linear_apply(mixer.out_proj, y)))
    state = cache["state"].numel() * 4
    codes = sum(b.numel() * b.element_size() for b in mixer.buffers())
    return {"slots": slots, "layer_ms": whole, "own_ops_ms": own, "linears_ms": linears,
            "state_bytes_read_and_written": 2 * state, "codes_bytes": codes,
            "state_bound_ms": 2 * state / HBM_BYTES_S * 1e3,
            "codes_bound_ms": codes / HBM_BYTES_S * 1e3}


def ssm_consistency(torch, model, cfg, prompt, label: str = "ssm") -> dict:
    """Phases 12 and 20 (c): prefill(n - 1) + decode_step against the last
    position of one prefill of n (SSM_DECODE_TOL, rtol and atol), MoE
    layers dropless (capacity n: a token the n-token prefill drops at
    capacity 1.25 would part the two for no fault of the SSM); and the
    chunked scan at full width (B 1, S SSM_SCAN_LEN over chunks of 64 with
    a padded last chunk, layer 0's A = -exp(A_log), dt = softplus(dt_bias +
    noise), so the masked decays overflow) against the sequential
    recurrence in f64 on the card (SSM_SCAN_TOL, rtol and atol)."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models.ssm import _ssd_chunked

    dev, n, sc = torch.device("cuda"), len(prompt), cfg.ssm
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    tok = torch.from_numpy(prompt[None, :]).to(dev)
    with torch.no_grad():
        want, _ = prefill(model, tok, init_cache(cfg, 1, n, device=dev), cfg)
        _, cache = prefill(model, tok[:, :-1], init_cache(cfg, 1, n, device=dev), cfg)
        got, _ = decode_step(model, tok[:, -1:], cache, cfg)
    got, want = got.float(), want.float()
    excess = ((got - want).abs() - SSM_DECODE_TOL * (1 + want.abs())).max().item()
    out = {"decode": {"tokens": n, "max_abs_diff": (got - want).abs().max().item(),
                      "max_abs_logit": want.abs().max().item(), "rtol_atol": SSM_DECODE_TOL,
                      "argmax": [int(got.argmax()), int(want.argmax())]}}
    log(f"{label}: prefill({n - 1}) + decode_step vs prefill({n}): max |diff| "
        f"{out['decode']['max_abs_diff']:.5f} of max |logit| {out['decode']['max_abs_logit']:.4f} "
        f"(rtol = atol = {SSM_DECODE_TOL}), argmax {out['decode']['argmax']}")
    if excess > 0:
        raise AssertionError(f"{label}: decode after prefill leaves the one-pass prefill: "
                             f"{out['decode']}")

    gen = torch.Generator(device=dev).manual_seed(6)
    mixer, s, h, p_, ns = model.layers[0].mixer, SSM_SCAN_LEN, sc.n_heads, sc.head_dim, sc.d_state
    a = -torch.exp(mixer.A_log)
    v = mixer.dt_bias + 0.5 * torch.randn((1, s, h), generator=gen, device=dev)
    dt = torch.logaddexp(v, torch.zeros_like(v))
    x = torch.randn((1, s, h, p_), generator=gen, device=dev)
    b_mat, c_mat = (torch.randn((1, s, h, ns), generator=gen, device=dev) / ns ** 0.5
                    for _ in range(2))
    h0 = torch.randn((1, h, p_, ns), generator=gen, device=dev)
    with torch.no_grad():
        y, hf = _ssd_chunked(x, dt, a, b_mat, c_mat, sc.chunk, h0)
        st = h0.double()
        ref = torch.empty((1, s, h, p_), dtype=torch.float64, device=dev)
        for t in range(s):
            da = torch.exp(dt[:, t].double() * a.double())
            st = st * da[:, :, None, None] + torch.einsum(
                "bhn,bhp,bh->bhpn", b_mat[:, t].double(), x[:, t].double(), dt[:, t].double())
            ref[:, t] = torch.einsum("bhn,bhpn->bhp", c_mat[:, t].double(), st)
    gaps = [((got.double() - want).abs() - SSM_SCAN_TOL * (1 + want.abs())).max().item()
            for got, want in ((y, ref), (hf, st))]
    max_decay = float((dt[0, :sc.chunk] * -a).sum(0).max())
    out["scan"] = {"seq": s, "chunk": sc.chunk, "finite": bool(torch.isfinite(y).all()),
                   "y_max_abs_diff": (y.double() - ref).abs().max().item(),
                   "y_max_abs": ref.abs().max().item(),
                   "state_max_abs_diff": (hf.double() - st).abs().max().item(),
                   "state_max_abs": st.abs().max().item(), "rtol_atol": SSM_SCAN_TOL,
                   "first_chunk_max_decay_exponent": max_decay}
    log(f"{label}: chunked scan (S {s}, chunk {sc.chunk}, H {h}, P {p_}, N {ns}; the first chunk's "
        f"largest summed decay exponent {max_decay:.1f}) vs the f64 recurrence: y max |diff| "
        f"{out['scan']['y_max_abs_diff']:.2e} of {out['scan']['y_max_abs']:.3f}, state max |diff| "
        f"{out['scan']['state_max_abs_diff']:.2e} of {out['scan']['state_max_abs']:.3f} "
        f"(rtol = atol = {SSM_SCAN_TOL})")
    if not out["scan"]["finite"] or max(gaps) > 0:
        raise AssertionError(f"{label}: the chunked scan leaves the recurrence: {out['scan']}")
    return out


def ssm_share(torch, model, cfg, prof: dict, label: str) -> None:
    """Phases 12 and 20 (e): `ssm_layer_ms` on layer 0, into the decode
    profile `prof`, and the SSM layers' own ops' share of its device time."""
    prof["ssm_layer"] = layer = ssm_layer_ms(torch, model, cfg)
    n_ssm = sum(sp.mixer == "ssm" for sp in cfg.layer_specs())
    dev_ms = prof["device_ms_per_step"]
    prof["ssm_own_ops_ms_per_step"] = layer["own_ops_ms"] * n_ssm
    prof["ssm_own_ops_share"] = prof["ssm_own_ops_ms_per_step"] / dev_ms if dev_ms else None
    log(f"{label}: one SSM layer at 4 slots {layer['layer_ms']:.4f} ms: its own ops (conv, "
        f"recurrence, gated norm) {layer['own_ops_ms']:.4f} ms (f32 state {layer['state_bytes_read_and_written']} "
        f"bytes read and written, bound {layer['state_bound_ms']:.4f} ms), its two BitLinears "
        f"{layer['linears_ms']:.4f} ms (codes {layer['codes_bytes']} bytes, bound "
        f"{layer['codes_bound_ms']:.4f} ms); own ops x {n_ssm} SSM layers "
        f"{prof['ssm_own_ops_ms_per_step']:.3f} ms a step"
        + (f" ({100 * prof['ssm_own_ops_share']:.1f}% of device time)"
           if prof["ssm_own_ops_share"] is not None else ""))


def check_ssm(torch, counters, memo, graph_rows) -> dict:
    """Phase 12: the SSM mixer on mamba2-1.3b at its published widths and
    depth (48 layers, d 2048, d_inner 4096, 64 heads x 64, d_state 128,
    chunk 64, vocab 50280, bf16, tied head): (a) `new_arch_kernels` at
    in_proj (M 8512, K 2048) and out_proj (M 2048, K 4096); (b) and (d)
    `new_arch_serving` (exact-length prefill, 4 launches a layer, 192 a
    forward); (c) `ssm_consistency`; (e) `new_arch_profile` and
    `ssm_share`; (f) tok/s and TTFT p50 in the serving rows."""
    t0 = time.perf_counter()
    cfg, model, out = new_arch_model(torch, SSM_ARCH)
    out["kernels"] = new_arch_kernels(torch, model, "ssm", memo=memo)
    serving, prompts = new_arch_serving(torch, model, cfg, counters, "ssm", seed=12)
    out.update(serving)
    out["rounding_sensitivity"] = rounding_sensitivity(torch, model, cfg, prompts[0], "ssm")
    out["consistency"] = ssm_consistency(torch, model, cfg, max(prompts, key=len))
    out["decode_profile"] = new_arch_profile(torch, model, cfg, prompts, "ssm")
    ssm_share(torch, model, cfg, out["decode_profile"], "ssm")
    out["seconds"] = time.perf_counter() - t0
    log(f"ssm: phase 12 took {out['seconds']:.1f} s")
    graph_rows["mamba2 decode"] = graph_compare(torch, model, cfg, counters, "mamba2 decode",
                                                *graph_prompts(cfg, 22), max_len=NEW_MAX_LEN)
    del model
    torch.cuda.empty_cache()
    return out


def ring_check(torch, model, cfg, prompt, steps: int = 16) -> dict:
    """Phase 13 (c): one long prompt (past the window) prefilled into a
    1-slot cache and `steps` greedy decode steps, so the windowed layers'
    ring wraps in prefill and in decode; the last step's logits against a
    cache-free forward of the same sequence (RING_RTOL of the largest
    logit)."""
    from repro_torch.models import decode_step, init_cache, lm_hidden, lm_logits, prefill_into_slot

    dev, max_len = torch.device("cuda"), WINDOW_MAX_LEN
    seq = [int(t) for t in prompt]
    with torch.no_grad():
        row, cache, _ = prefill_into_slot(model, init_cache(cfg, 1, max_len, device=dev), 0,
                                          prompt, cfg, max_len=max_len)
        for _ in range(steps):
            seq.append(int(row[0].argmax()))
            row, cache = decode_step(model, torch.tensor([[seq[-1]]], dtype=torch.int32,
                                                         device=dev), cache, cfg)
        h, _, _ = lm_hidden(model, torch.tensor([seq], dtype=torch.int32, device=dev), cfg,
                            mode="serve")
        want = lm_logits(model, h[:, -1:], cfg)[:, 0].float()
    got = row.float()
    window = max(sp.window for sp in cfg.layer_specs())
    out = {"tokens": len(seq), "window": window, "max_abs_diff": (got - want).abs().max().item(),
           "max_abs_logit": want.abs().max().item(), "rtol": RING_RTOL,
           "argmax": [int(got.argmax()), int(want.argmax())]}
    log(f"gemma3: after {len(prompt)} prompt tokens and {steps} decode steps (window {window}: "
        f"the ring wrapped in prefill and in decode), decode logits vs a cache-free forward: "
        f"max |diff| {out['max_abs_diff']:.5f} of max |logit| {out['max_abs_logit']:.4f} "
        f"(bound {RING_RTOL} of it), argmax {out['argmax']}")
    if len(prompt) <= window or out["max_abs_diff"] > RING_RTOL * out["max_abs_logit"]:
        raise AssertionError(f"gemma3: ring-cache decode leaves the cache-free forward: {out}")
    return out


def check_windowed(torch, counters, memo, graph_rows) -> dict:
    """Phase 13: gemma3-1b at its published widths and depth (26 layers, d
    1152, 4 heads / 1 KV head of 256, d_ff 6912, vocab 262144, window 512 on
    5 of every 6 layers, dual RoPE, q/k norms, embedding scale, tied head):
    (a) `new_arch_kernels` at its five BitLinear shapes; (b) and (d)
    `new_arch_serving` (14 launches a layer, 364 a forward; prompts past
    the window); (c) `ring_check`; (d) `new_arch_profile`, with the tied
    f32 head's device ms on its own."""
    t0 = time.perf_counter()
    cfg, model, out = new_arch_model(torch, WINDOW_ARCH)
    out["kernels"] = new_arch_kernels(torch, model, "gemma3", memo=memo)
    serving, prompts = new_arch_serving(torch, model, cfg, counters, "gemma3", seed=13)
    out.update(serving)
    out["rounding_sensitivity"] = rounding_sensitivity(torch, model, cfg, prompts[0], "gemma3")
    out["ring"] = ring_check(torch, model, cfg, max(prompts, key=len))
    out["decode_profile"] = new_arch_profile(torch, model, cfg, prompts, "gemma3")
    out["seconds"] = time.perf_counter() - t0
    log(f"gemma3: phase 13 took {out['seconds']:.1f} s")
    # prompts past the window: the ring wraps in the prefill and in decode
    graph_rows["gemma3 decode"] = graph_compare(
        torch, model, cfg, counters, "gemma3 decode",
        *graph_prompts(cfg, 22, lens=WINDOW_LONG_PROMPT), max_len=WINDOW_MAX_LEN)
    del model
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phases 20 and 21: the hybrid jamba and the other dense GQA architectures
# --------------------------------------------------------------------------
def check_hybrid(torch, counters, memo) -> dict:
    """Phase 20: jamba-1.5-large-398b at its published widths (d 8192, 64
    heads / 8 KV heads of 128, SSM d_inner 16384 in 256 heads of 64 with
    d_state 16, 16 experts top-2 of d_ff 24576, dense d_ff 24576, vocab
    65536, bf16, untied head), depth cut to one period of its pattern
    (HYBRID_LAYERS): (a) `new_arch_kernels` at layer 0 (SSM in_proj M
    33056, out_proj K 16384, dense FFN) and layer 3 (attention), their
    launches timed; `moe_kernel_checks` at layer 1's experts, C at
    HYBRID_CAPACITY_TOKENS, timed at HYBRID_TIME_TOKENS; (b) and (d)
    `new_arch_serving` (exact-length prefill; 60 single and 24 grouped
    launches a forward); (c) `ssm_consistency` at 256 heads, and the
    rounding sensitivity where unfused leaves fused; (e)
    `new_arch_profile`, `ssm_share` and one MoE layer's dispatch
    (`moe_dispatch_ms`)."""
    from repro_torch.models.moe import capacity

    t0 = time.perf_counter()
    cfg, model, out = new_arch_model(torch, HYBRID_ARCH, n_layers=HYBRID_LAYERS)
    out["kernels"] = new_arch_kernels(torch, model, "jamba", layers=HYBRID_CHECK_LAYERS, memo=memo,
                                      timed_layers=HYBRID_CHECK_LAYERS)
    out["grouped"] = moe_kernel_checks(
        torch, model, cfg, torch.Generator(device="cuda").manual_seed(20), layer=HYBRID_MOE_LAYER,
        caps=[capacity(t, cfg) for t in HYBRID_CAPACITY_TOKENS],
        time_caps=[capacity(t, cfg) for t in HYBRID_TIME_TOKENS], traps=False, label="jamba")
    serving, prompts = new_arch_serving(torch, model, cfg, counters, "jamba", seed=20)
    for row in serving["serve"].values():
        row["rows_per_expert"] = {int(n): capacity(int(n), cfg) for n in row["mpgemm_tokens_per_launch"]}
    out.update(serving)
    if out["unfused_divergences"]:
        out["rounding_sensitivity"] = rounding_sensitivity(torch, model, cfg, prompts[0], "jamba")
    out["consistency"] = ssm_consistency(torch, model, cfg, max(prompts, key=len), "jamba")
    prof = new_arch_profile(torch, model, cfg, prompts, "jamba")
    ssm_share(torch, model, cfg, prof, "jamba")
    n_moe = sum(sp.ffn == "moe" for sp in cfg.layer_specs())
    prof["moe_layer"] = ml = moe_dispatch_ms(torch, model, cfg, tokens=DECODE_N, layer=HYBRID_MOE_LAYER)
    prof["moe_dispatch_ms_per_step"] = ml["dispatch_ms"] * n_moe
    prof["moe_dispatch_share"] = (prof["moe_dispatch_ms_per_step"] / prof["device_ms_per_step"]
                                  if prof["device_ms_per_step"] else None)
    log(f"jamba: one MoE layer at {DECODE_N} tokens {ml['layer_ms']:.4f} ms: its dispatch alone "
        f"{ml['dispatch_ms']:.4f} ms, its expert compute alone {ml['expert_compute_ms']:.4f} ms on "
        f"random rows, {ml['expert_compute_zero_rows_ms']:.4f} ms on the layer's own rows "
        f"({ml['real_rows']} of {cfg.moe.n_experts} x {ml['rows_per_expert']} real); dispatch x "
        f"{n_moe} layers {prof['moe_dispatch_ms_per_step']:.3f} ms a step"
        + (f" ({100 * prof['moe_dispatch_share']:.1f}% of device time)"
           if prof["moe_dispatch_share"] is not None else ""))
    out["decode_profile"] = prof
    out["seconds"] = time.perf_counter() - t0
    log(f"jamba: phase 20 took {out['seconds']:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def check_dense_archs(torch, counters, memo, graph_rows) -> dict:
    """Phase 21: internlm2-1.8b (24 layers, d 2048, 16 heads / 8 KV of 128,
    d_ff 8192, vocab 92544), command-r-35b (40 layers, d 8192, 64 / 8 of
    128, d_ff 22528, vocab 256000, tied head) and chameleon-34b (48 layers,
    d 8192, 64 / 8 of 128, d_ff 22016, vocab 65536, q/k norms), each at its
    published widths and depth, built and freed one at a time: (a)
    `new_arch_kernels` at layer 0's shapes (those checked earlier in the
    run skipped), layer 0's launches timed; (b) and (d) `new_arch_serving`
    (14 launches a layer: 336, 560 and 672 a forward), and the rounding
    sensitivity where unfused leaves fused; (e) `new_arch_profile`, with
    the f32 head's device ms (command-r's casts its 256000 x 8192 table
    each step) and share. → {arch: rows}."""
    out = {}
    for i, arch in enumerate(DENSE_ARCHS):
        t0 = time.perf_counter()
        cfg, model, row = new_arch_model(torch, arch)
        row["kernels"] = new_arch_kernels(torch, model, arch, memo=memo, timed_layers=(0,))
        serving, prompts = new_arch_serving(torch, model, cfg, counters, arch, seed=21 + i)
        row.update(serving)
        if row["unfused_divergences"]:
            row["rounding_sensitivity"] = rounding_sensitivity(torch, model, cfg, prompts[0], arch)
        row["decode_profile"] = new_arch_profile(torch, model, cfg, prompts, arch)
        if arch == GRAPH_DENSE_ARCH:
            graph_rows[f"{arch} decode"] = graph_compare(torch, model, cfg, counters,
                                                         f"{arch} decode",
                                                         *graph_prompts(cfg, 22))
        row["seconds"] = time.perf_counter() - t0
        log(f"{arch}: {row['seconds']:.1f} s")
        out[arch] = row
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 15: the encoder-decoder (whisper-medium)
# --------------------------------------------------------------------------
def encdec_model(torch):
    """whisper-medium at its published widths and depth, random weights
    from a seeded generator on the card, packed by `pack_params`.
    → (cfg, model, facts)."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec_init, pack_params

    t0 = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    torch.cuda.reset_peak_memory_stats()
    model = pack_params(encdec_init(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    torch.cuda.synchronize()
    n_packed = len(packed_linears(model))
    out = {"arch": cfg.name, "enc_layers": cfg.enc_layers, "dec_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab, "packed_linears": n_packed,
           "model_bytes": {"decoder": packed_model_bytes(model.decoder),
                           "encoder": sum(t.numel() * t.element_size() for t in
                                          (*model.encoder.buffers(), *model.encoder.parameters()))},
           "build_s": time.perf_counter() - t0,
           "build_peak_bytes": torch.cuda.max_memory_allocated()}
    if n_packed != 7 * cfg.enc_layers + 11 * cfg.n_layers:
        raise AssertionError(f"whisper: {n_packed} packed linears")
    log(f"whisper: {cfg.dtype}, {cfg.enc_layers} + {cfg.n_layers} layers, d {cfg.d_model}, "
        f"vocab {cfg.vocab}: built and packed in {out['build_s']:.1f} s (peak "
        f"{out['build_peak_bytes'] / 2**30:.2f} GiB); bytes {out['model_bytes']}")
    return cfg, model, out


def encdec_kernels(torch, model, cfg) -> dict:
    """Phase 15 (a): kernels #1-#4 against their plain versions at the
    three BitLinear shapes (M, K) (1024, 1024), (4096, 1024), (1024, 4096),
    each two segments, N in ENCDEC_TOKENS (fused: every activation/output
    type pair up to N 37, the main path's bf16 -> f32 above), expected
    difference 0, each shape's plans logged; one decode step's launches
    timed at N 4 (the decoder's 9 BitLinears a layer) and one encoder
    forward's at N 6000 (7 a layer; the plain versions on layer 0's)."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(15)
    weights = layer_weights(model.encoder.layers[0])
    d, f = cfg.d_model, cfg.d_ff
    if sorted(weights) != sorted({(d, d), (f, d), (d, f)}):
        raise AssertionError(f"whisper: BitLinear shapes {sorted(weights)}")
    small = tuple(n for n in ENCDEC_TOKENS if n <= ENCDEC_SMALL_N)
    large = tuple(n for n in ENCDEC_TOKENS if n > ENCDEC_SMALL_N)
    kernels = fused_kernels()
    err_s, n_s = fused_vs_plain(torch, kernels, weights, small, gen)
    err_l, n_l = fused_vs_plain(torch, kernels, weights, large, gen,
                                combos=((torch.bfloat16, torch.float32),))
    int_err, n_int = int_vs_plain(torch, weights, ENCDEC_TOKENS, gen)
    err = {**{k: max(err_s[k], err_l[k]) for k in kernels}, **int_err}
    segs = {f"{m}x{k}": [[int(p.shape[1]), g] for p, _, _, g in ops._segments(pw)]
            for (m, k), pw in weights.items()}
    log(f"whisper: {n_s + n_l + n_int} kernel-vs-plain checks at (M, K) {sorted(weights)} "
        f"(segments [KG, g]: {segs}), N {ENCDEC_TOKENS}: max |diff| {err}")
    for name, e in err.items():
        if e != 0:
            raise AssertionError(f"whisper: {name} differs from its plain version by {e} "
                                 "(expected 0)")
    plans = {}
    for n in ENCDEC_TOKENS:
        plans[n] = rows = []
        for (m, k), pw in sorted(weights.items()):
            for packed, _, _, g in ops._segments(pw):
                kg = int(packed.shape[1])
                rows.append({"lut": plan_row(vlg.lut_plan(m, kg, n, g)),
                             "decode": plan_row(decode_plan_for(tdg, m, kg, n, g))})
        log(f"whisper: plans at N={n}: " + "; ".join(
            f"{r['lut']['shape']}: LUT BM {r['lut']['bm']} S {r['lut']['splits']} chunk "
            f"{r['lut']['chunk']} blocks {r['lut']['blocks']} smem {r['lut']['smem']} | decode "
            f"BM {r['decode']['bm']} BN {r['decode']['bn']} S {r['decode']['splits']} step "
            f"{r['decode']['kstep']} blocks {r['decode']['blocks']} smem {r['decode']['smem']}"
            for r in rows))
    dec_lins = [lin for layer in model.decoder.layers
                for lin in packed_linears(layer) if lin not in (layer.cross.wk, layer.cross.wv)]
    enc_lins = packed_linears(model.encoder)
    timed, timed_int = {}, {}
    for label, lins, n, plain_lins in (("decode_step", dec_lins, DECODE_N, None),
                                       ("encoder", enc_lins, ENCDEC_BATCH * ENCDEC_FRAMES,
                                        packed_linears(model.encoder.layers[0]))):
        timed[label] = row = forward_launch_ms(torch, lins, n, gen, plain_lins)
        log(f"whisper: {label}'s {row['launches']} launches at N={n}: bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
            + ", ".join(f"{nm} {row[nm]['ms']:.4f} ms (eager {row[nm]['eager_ms']:.4f}, plain "
                        f"{row[nm]['plain_ms']:.4f} on {row['plain_launches']} launches)"
                        for nm in kernels)
            + f", bf16 matmul yardstick {row['library_ms']:.4f} ms")
        timed_int[label] = row = int_forward_launch_ms(torch, lins, n, gen, plain_lins)
        log(f"whisper: {label}'s {row['launches']} integer launches at N={n}: bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
            + ", ".join(f"{nm} {row[nm]['ms']:.4f} ms (plain {row[nm]['plain_ms']:.4f} on "
                        f"{row['plain_launches']} launches)" for nm in int_kernels())
            + (f", torch._int_mm yardstick {row['library_ms']:.4f} ms"
               if row["library_ms"] is not None else ""))
    expected = {"decode_step": ENCDEC_LAUNCHES["decode"], "encoder": ENCDEC_LAUNCHES["encoder"]}
    if any(t[k]["launches"] != n for t in (timed, timed_int) for k, n in expected.items()):
        raise AssertionError(f"whisper: timed launches {timed}, {timed_int}")
    return {"max_abs_err": err, "checks": n_s + n_l + n_int, "segments": segs,
            "plans": plans, "forward_ms": timed, "int_forward_ms": timed_int}


def encdec_inputs(torch, cfg, batch: int, frames: int, seed: int):
    """Frames (batch, frames, d_model) bf16 from a seeded generator on the
    card, and prompts (batch, ENCDEC_PROMPT) from a numpy seed."""
    import numpy as np

    gen = torch.Generator(device="cuda").manual_seed(seed)
    fr = torch.randn((batch, frames, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (batch, ENCDEC_PROMPT))
    return fr, torch.from_numpy(tok.astype(np.int32)).cuda()


@trace_attempts
def encdec_serve(torch, model, cfg, impl, frames, prompts, counters) -> dict:
    """Phase 15 (b), one impl: greedy serving through `launch.steps` (one
    prefill step, ENCDEC_NEW - 1 decode steps), warmed up first; the counts
    zeroed just before the prefill step, read after it and at the end:
    exactly ENCDEC_LAUNCHES of the impl's kernel a forward, no other
    mpGeMM or flash launch, and the counts those of a `device_trace` of
    the run (its times are taken with the trace on)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache
    from repro_torch.serve.graphs import StepGraphs

    # the decode steps replay as a CUDA graph: the warm-up's makes the eager
    # call, the first measured one the capture
    pre, dec = make_prefill_step(cfg), make_decode_step(cfg, graphs=StepGraphs("cuda"))
    b, s_enc = frames.shape[:2]
    batch = {"tokens": prompts, "frames": frames}
    name = single_kernel(impl)
    with ops.dispatch_override(impl=impl, fusion="fused"):
        nt, cache = pre(model, init_cache(cfg, b, ENCDEC_MAX_LEN, enc_len=s_enc, device="cuda"),
                        batch)
        dec(model, cache, nt[:, None])
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        with device_trace(torch) as prof:
            t0 = time.perf_counter()
            nt, cache = pre(model, init_cache(cfg, b, ENCDEC_MAX_LEN, enc_len=s_enc,
                                              device="cuda"), batch)
            toks = [nt]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            after_prefill = {nm: fn.launches for nm, fn in counters.items()}
            for _ in range(ENCDEC_NEW - 1):
                nt, cache = dec(model, cache, nt[:, None])
                toks.append(nt)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    launches = {nm: fn.launches for nm, fn in counters.items()}
    device_launches, _ = traced_launches(prof, counters)
    held_to_trace(f"whisper {impl}", launches, device_launches)
    steps = ENCDEC_NEW - 1
    want_pre = ENCDEC_LAUNCHES["encoder"] + ENCDEC_LAUNCHES["prefill"]
    want = {nm: (want_pre + steps * ENCDEC_LAUNCHES["decode"] if nm == name else 0)
            for nm in counters}
    if after_prefill[name] != want_pre or launches != want:
        raise AssertionError(f"whisper {impl}: launches after the prefill step "
                             f"{after_prefill[name]} (expected {want_pre}), at the end "
                             f"{launches} (expected {want})")
    tokens = torch.stack(toks, 1).cpu()
    if tokens.shape != (b, ENCDEC_NEW) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"whisper {impl}: bad tokens {tokens.shape}")
    return {"tokens": tokens.tolist(), "launches": launches, "device_launches": device_launches,
            "launches_after_prefill": after_prefill[name],
            "prefill_step_ms": (t1 - t0) * 1e3, "decode_s": t2 - t1,
            "decode_tok_s": b * steps / (t2 - t1), "decode_step_ms": (t2 - t1) * 1e3 / steps}


def encdec_prefill_logits(torch, model, cfg, frames, prompts):
    """encode + the decoder's prefill: last-position f32 logits (B, V)."""
    from repro_torch.models import encode, init_cache, prefill

    with torch.no_grad():
        enc = encode(model, frames, cfg, mode="serve")
        cache = init_cache(cfg, frames.shape[0], ENCDEC_MAX_LEN, enc_len=frames.shape[1],
                           device=frames.device)
        logits, _ = prefill(model.decoder, prompts, cache, cfg, enc_out=enc)
    return logits.float()


def encdec_card_vs_cpu(torch, model, cfg) -> dict:
    """Phase 15 (b): one request of ENCDEC_CPU_FRAMES frames and the
    prompt, encode + prefill logits on the card against the same weights
    on the CPU (plain path). Bound: LOGIT_RTOL of the largest logit, or
    the model's own bf16-vs-f32 distance on the card (an f32 copy of the
    same packed weights) where that is larger, the rule of phases 12-13:
    at 48 layers of random weights a bf16 rounding moves int8 activation
    codes, and the card and the CPU round in other sum orders."""
    frames, prompts = encdec_inputs(torch, cfg, 1, ENCDEC_CPU_FRAMES, seed=151)
    card = encdec_prefill_logits(torch, model, cfg, frames, prompts)
    f32_model = copy.deepcopy(model).float()
    card32 = encdec_prefill_logits(torch, f32_model, cfg.with_(dtype="float32"), frames, prompts)
    del f32_model
    t0 = time.perf_counter()
    cpu_model = copy.deepcopy(model).to("cpu")
    cpu = encdec_prefill_logits(torch, cpu_model, cfg, frames.cpu(), prompts.cpu())
    cpu_s = time.perf_counter() - t0
    del cpu_model
    torch.cuda.empty_cache()
    card = card.cpu()
    if card.shape != (1, cfg.vocab) or not torch.isfinite(card).all():
        raise AssertionError(f"whisper: bad logits, shape {tuple(card.shape)}")
    scale = cpu.abs().max().item()
    out = {"max_abs_diff": (card - cpu).abs().max().item(), "max_abs_logit": scale,
           "bf16_vs_f32_max_abs_diff": (card - card32.cpu()).abs().max().item(),
           "argmax": [int(card.argmax()), int(cpu.argmax())], "cpu_seconds": cpu_s}
    out["bound"] = max(LOGIT_RTOL * scale, out["bf16_vs_f32_max_abs_diff"])
    log(f"whisper: card vs cpu encode + prefill logits (1 x {ENCDEC_CPU_FRAMES} frames, "
        f"{ENCDEC_PROMPT} tokens): max |diff| {out['max_abs_diff']:.5f} of max |logit| "
        f"{scale:.4f} (bound {out['bound']:.5f}: the larger of {LOGIT_RTOL} of it and the "
        f"model's bf16-vs-f32 distance {out['bf16_vs_f32_max_abs_diff']:.5f}), argmax "
        f"{out['argmax']}, cpu {cpu_s:.1f} s")
    if not out["max_abs_diff"] <= out["bound"]:
        raise AssertionError(f"whisper: card and cpu logits differ: {out}")
    return out


def encdec_cache_check(torch, model, cfg, frames, prompts) -> dict:
    """Phase 15 (b): one request (its 1500 frames), a prefill step and
    ENCDEC_CACHE_STEPS greedy decode steps reading the cached cross K/V;
    the last step's logits against `encode` + `lm_hidden` of the whole
    sequence with no cache (ENCDEC_CACHE_RTOL of the largest logit)."""
    from repro_torch.models import decode_step, encode, init_cache, lm_hidden, lm_logits, prefill

    with torch.no_grad():
        enc = encode(model, frames, cfg, mode="serve")
        cache = init_cache(cfg, 1, ENCDEC_MAX_LEN, enc_len=frames.shape[1], device="cuda")
        row, cache = prefill(model.decoder, prompts, cache, cfg, enc_out=enc)
        seq = prompts[0].tolist()
        for _ in range(ENCDEC_CACHE_STEPS):
            seq.append(int(row[0].argmax()))
            row, cache = decode_step(model.decoder, torch.tensor([[seq[-1]]], dtype=torch.int32,
                                                                 device="cuda"), cache, cfg)
        h, _, _ = lm_hidden(model.decoder, torch.tensor([seq], dtype=torch.int32, device="cuda"),
                            cfg, mode="serve", enc_out=enc)
        want = lm_logits(model.decoder, h[:, -1:], cfg)[:, 0].float()
    got = row.float()
    out = {"tokens": len(seq), "max_abs_diff": (got - want).abs().max().item(),
           "max_abs_logit": want.abs().max().item(), "rtol": ENCDEC_CACHE_RTOL,
           "argmax": [int(got.argmax()), int(want.argmax())]}
    log(f"whisper: after a prefill of {len(prompts[0])} tokens and {ENCDEC_CACHE_STEPS} decode "
        f"steps on the cached cross K/V ({frames.shape[1]} frames), decode logits vs a "
        f"cache-free encode + forward: max |diff| {out['max_abs_diff']:.5f} of max |logit| "
        f"{out['max_abs_logit']:.4f} (bound {ENCDEC_CACHE_RTOL} of it), argmax {out['argmax']}")
    if out["max_abs_diff"] > ENCDEC_CACHE_RTOL * out["max_abs_logit"]:
        raise AssertionError(f"whisper: cached decode leaves the cache-free forward: {out}")
    return out


def encdec_serving(torch, model, cfg, counters) -> dict:
    """Phase 15 (b): serving with both impls (identical tokens), the
    encoder's and the decoder prefill's device time apart, the card against
    the CPU, the cross-attention cache, one decode step profiled."""
    from torch.profiler import profile

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import encode, init_cache, prefill

    frames, prompts = encdec_inputs(torch, cfg, ENCDEC_BATCH, ENCDEC_FRAMES, seed=15)
    runs = {impl: encdec_serve(torch, model, cfg, impl, frames, prompts, counters)
            for impl in IMPLS}
    for impl, r in runs.items():
        log(f"whisper {impl}: B {ENCDEC_BATCH} x {ENCDEC_FRAMES} frames, prompts of "
            f"{ENCDEC_PROMPT}, {ENCDEC_NEW} greedy tokens: prefill step {r['prefill_step_ms']:.1f} "
            f"ms, decode {r['decode_tok_s']:.1f} tok/s ({r['decode_step_ms']:.2f} ms a step), "
            f"launches {r['launches_after_prefill']} after the prefill step, "
            f"{r['launches'][single_kernel(impl)]} in all")
    if runs["decode"]["tokens"] != runs["lookup"]["tokens"]:
        raise AssertionError("whisper: impl=decode and impl=lookup emitted different greedy tokens")
    out = {"serve": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in runs.items()}}

    # the prefill step's two halves apart, each eager between events
    parts = {}
    with torch.no_grad(), ops.dispatch_override(impl="decode"):
        enc = encode(model, frames, cfg, mode="serve")
        parts["encoder_ms"] = eager_ms(torch, lambda: encode(model, frames, cfg, mode="serve"),
                                       reps=1)
        parts["decoder_prefill_ms"] = eager_ms(torch, lambda: prefill(
            model.decoder, prompts, init_cache(cfg, ENCDEC_BATCH, ENCDEC_MAX_LEN,
                                               enc_len=ENCDEC_FRAMES, device="cuda"),
            cfg, enc_out=enc), reps=1)
    out["prefill_parts"] = parts
    log(f"whisper: prefill halves (impl decode, eager): encoder {parts['encoder_ms']:.1f} ms, "
        f"decoder prefill (its cross K/V included) {parts['decoder_prefill_ms']:.1f} ms")

    out["card_vs_cpu"] = encdec_card_vs_cpu(torch, model, cfg)
    out["cache"] = encdec_cache_check(torch, model, cfg, frames[:1], prompts[:1])

    # one decode step of the 4 requests under the profiler
    pre, dec = make_prefill_step(cfg), make_decode_step(cfg)
    with ops.dispatch_override(impl="decode"):
        nt, cache = pre(model, init_cache(cfg, ENCDEC_BATCH, ENCDEC_MAX_LEN,
                                          enc_len=ENCDEC_FRAMES, device="cuda"),
                        {"tokens": prompts, "frames": frames})
        nt, cache = dec(model, cache, nt[:, None])
        torch.cuda.synchronize()
        with profile(activities=device_only()) as prof:
            t0 = time.perf_counter()
            dec(model, cache, nt[:, None])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_time_by_kernel(prof.key_averages(), 1)
    dev_ms = sum(ms for ms, _ in by_name)
    out["decode_profile"] = {"wall_ms": wall_ms, "device_ms": dev_ms,
                             "device_busy_share": dev_ms / wall_ms if dev_ms else None,
                             "top_kernels_ms": [[nm[:90], ms] for ms, nm in by_name[:8]]}
    log(f"whisper: decode step ({ENCDEC_BATCH} requests) wall {wall_ms:.3f} ms, device busy "
        f"{dev_ms:.3f} ms"
        + (f" ({100 * dev_ms / wall_ms:.1f}%)" if dev_ms else
           " (the profiler saw no device time: not measured)"))
    for nm, ms in out["decode_profile"]["top_kernels_ms"]:
        log(f"whisper:   {ms:8.4f} ms  {nm}")
    return out


def encdec_flash(torch) -> dict:
    """Phase 15 (c), before training: the flash kernel at whisper's
    training shapes (ENCDEC_FLASH: the encoder's non-causal S 112, the
    decoder's causal S 448; bf16, H 16 of D 64) against its plain version
    (FLASH_TOL), its gradients through `flash_attention_trainable` against
    autograd through the plain version (FLASH_GRAD_TOL), and its device
    time beside the bound, the plain version and `scaled_dot_product_attention`
    (a yardstick only)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(152)
    rows = []
    for b, s, h, kv, d, causal in ENCDEC_FLASH:
        q, k, v = flash_inputs(torch, b, s, h, kv, d, torch.bfloat16, gen)
        got = fa.flash_attention(q, k, v, causal=causal)
        want = fa.flash_attention_plain(q, k, v, causal=causal)
        err = (got.float() - want.float()).abs().max().item()
        bound = FLASH_TOL["bfloat16"] * max(1.0, want.float().abs().max().item())
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
        g_kern = torch.autograd.grad(fa.flash_attention_trainable(qg, kg, vg, causal, 0, 0.0),
                                     (qg, kg, vg), dout)
        g_plain = torch.autograd.grad(fa.flash_attention_plain(qg, kg, vg, causal=causal),
                                      (qg, kg, vg), dout)
        grad_err = max((a.float() - c.float()).abs().max().item() for a, c in zip(g_kern, g_plain))
        grad_bound = FLASH_GRAD_TOL["bfloat16"] * max(
            1.0, max(c.float().abs().max().item() for c in g_plain))
        if not (err <= bound and grad_err <= grad_bound):
            raise AssertionError(f"whisper flash B{b} S{s} causal={causal}: |diff| {err} (bound "
                                 f"{bound}), gradients {grad_err} (bound {grad_bound})")
        pairs = s * (s + 1) // 2 if causal else s * s
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        flops = 4 * b * h * d * pairs
        t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        row = {"shape": dict(B=b, S=s, H=h, KV=kv, D=d, causal=causal, dtype="bfloat16"),
               "max_abs_err": err, "grad_max_abs_err": grad_err, "bytes": nbytes, "flops": flops,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "plan": repr(fa.plan_for(q, k, v, torch.empty_like(q), causal=causal, window=0)),
               "ms": device_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal), reps=20),
               "plain_ms": device_ms(torch, lambda: fa.flash_attention_plain(q, k, v,
                                                                             causal=causal)),
               "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                   qc, kc, vc, is_causal=causal), reps=20)}
        rows.append(row)
        log(f"whisper flash: B{b} S{s} H{h}/KV{kv} D{d} causal={causal} bf16: |diff| {err:.3g}, "
            f"gradients |diff| {grad_err:.3g}; kernel {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), plain {row['plain_ms']:.4f} ms, sdpa "
            f"yardstick {row['library_ms']:.4f} ms; plan {row['plan']}")
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


def encdec_cpu_loss(torch, model, cfg, batch, frames) -> dict:
    """The loss of one sequence (row 0: its first ENCDEC_CPU_SEQ tokens and
    ENCDEC_CPU_SEQ / 4 frames) on the card against the same weights on the
    CPU (plain path), no gradients (TRAIN_LOSS_RTOL)."""
    from repro_torch.models import encdec_loss

    n_frames = ENCDEC_CPU_SEQ // cfg.enc_frame_ratio
    tok, lab = batch["tokens"][:1, :ENCDEC_CPU_SEQ], batch["labels"][:1, :ENCDEC_CPU_SEQ]
    fr = frames[:1, :n_frames]
    with torch.no_grad():
        card = encdec_loss(model, fr.cuda(), tok.cuda(), lab.cuda(), cfg)[0].item()
        t0 = time.perf_counter()
        cpu_model = copy.deepcopy(model).to("cpu")
        cpu = encdec_loss(cpu_model, fr.cpu(), tok.cpu(), lab.cpu(), cfg)[0].item()
        cpu_s = time.perf_counter() - t0
    del cpu_model
    if not (math.isfinite(card) and abs(card - cpu) <= TRAIN_LOSS_RTOL * abs(cpu)):
        raise AssertionError(f"whisper: card loss {card} and cpu loss {cpu} differ by more than "
                             f"{TRAIN_LOSS_RTOL} relative")
    return {"card": card, "cpu": cpu, "cpu_seconds": cpu_s}


def encdec_train(torch, counters) -> dict:
    """Phase 15 (c): ENCDEC_TRAIN_STEPS QAT steps of whisper-medium at full
    width and depth through `train.Trainer` (attn_impl="flash", remat, B 8
    x S 448 with the stub frontend's 112 frames, lr 3e-4, warmup 5): every
    loss finite, the last below the first; flash launched (24 + 24) x 2
    times a step (remat runs each layer's forward again) and no mpGeMM
    kernel; the checkpoint resumes a second Trainer with equal weights; the
    card against the CPU on one sequence; one step's busy share."""
    from torch.profiler import profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.trainer import _stub_frames

    cfg = get_config(ENCDEC_ARCH).with_(attn_impl="flash")
    ckpt_dir = ROOT / "build" / "chip_smoke_encdec_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    b, s, steps = ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, ENCDEC_TRAIN_STEPS
    tc = TrainConfig(total_steps=steps, checkpoint_every=steps // 2, log_every=1,
                     checkpoint_dir=str(ckpt_dir), keep_checkpoints=1, seed=0)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=steps)
    dc = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
    tr = Trainer(cfg, opt, tc, dc, device="cuda")
    n_params = sum(p.numel() for p in tr.model.parameters())
    frames = _stub_frames(cfg, b, s, tc.seed)
    log(f"whisper train: {cfg.dtype} attn_impl={cfg.attn_impl} remat={cfg.remat}, "
        f"{cfg.enc_layers} + {cfg.n_layers} layers, {n_params / 1e6:.1f}M parameters, B {b} x S "
        f"{s} ({tuple(frames.shape)} frames), lr {TRAIN_LR}, {steps} steps")
    batch0 = {k: torch.from_numpy(x) for k, x in SyntheticLM(dc).batch_at(0).items()}
    before = encdec_cpu_loss(torch, tr.model, cfg, batch0, frames)
    log(f"whisper train: card vs cpu loss (1 x {ENCDEC_CPU_SEQ} tokens): {before['card']:.5f} "
        f"vs {before['cpu']:.5f} (cpu {before['cpu_seconds']:.1f} s)")

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rows = tr.run()
    wall = time.perf_counter() - t0
    launches = {nm: fn.launches for nm, fn in counters.items()}
    per_step = 2 * (cfg.enc_layers + cfg.n_layers)
    want = {nm: (per_step * steps if nm == "flash_attention" else 0) for nm in counters}
    losses = [r["loss"] for r in rows]
    step_s = [r["step_time_s"] for r in rows]
    if launches != want:
        raise AssertionError(f"whisper train: launches {launches}, expected {want}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"whisper train: losses not all finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"whisper train: last loss {losses[-1]} is not below the first "
                             f"{losses[0]}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    res = {"losses": losses, "step_time_s": step_s, "step_ms_median": steady * 1e3,
           "tokens_per_s": b * s / steady, "wall_s": wall, "launches": launches,
           "flash_launches_per_step": per_step,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "n_params": n_params,
           "card_vs_cpu_loss": before}
    log(f"whisper train: {steps} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{res['step_ms_median']:.1f} ms (median of steps 2-{steps}; step 1 "
        f"{step_s[0] * 1e3:.1f} ms), {res['tokens_per_s']:.0f} decoder tok/s, flash launches "
        f"{launches['flash_attention']} ({per_step} a step), peak {res['peak_mem_gb']:.1f} GB, "
        f"wall {wall:.1f} s (checkpoints included)")

    tr2 = Trainer(cfg, opt, tc, dc, device="cuda")
    same = all(torch.equal(p, q) for p, q in zip(tr.model.parameters(), tr2.model.parameters()))
    if tr2.step != steps or tr2.data.step != steps or not same:
        raise AssertionError(f"whisper train: resumed at step {tr2.step} (data {tr2.data.step}), "
                             f"weights equal: {same}")
    res["resumed_step"] = tr2.step
    log(f"whisper train: a second Trainer resumed at step {tr2.step} with equal weights")
    del tr2

    batch = {k: torch.from_numpy(x).cuda() for k, x in SyntheticLM(dc).batch_at(steps).items()}
    batch["frames"] = frames.cuda()
    torch.cuda.synchronize()
    with profile(activities=device_only()) as prof:
        t0 = time.perf_counter()
        tr._step(tr.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = device_time_by_kernel(prof.key_averages(), 1)
    dev_ms = sum(ms for ms, _ in by_name)
    res["profile"] = {"wall_ms": wall_ms, "device_ms": dev_ms,
                      "device_busy_share": dev_ms / wall_ms if dev_ms else None,
                      "top_kernels_ms": [[nm[:90], ms] for ms, nm in by_name[:8]]}
    log(f"whisper train: one step under the profiler: wall {wall_ms:.1f} ms, device busy "
        f"{dev_ms:.1f} ms"
        + (f" ({100 * dev_ms / wall_ms:.1f}%)" if dev_ms else
           " (the profiler saw no device time: not measured)"))
    for nm, ms in res["profile"]["top_kernels_ms"]:
        log(f"whisper train:   {ms:8.3f} ms  {nm}")
    del tr
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return res


def check_encdec(torch, counters, graph_rows) -> dict:
    """Phase 15: whisper-medium at its published widths and depth (24
    encoder + 24 decoder layers, d 1024, 16 heads of 64, d_ff 4096, vocab
    51865, bf16, tied head): (a) `encdec_kernels`; (b) `encdec_serving`;
    (c) `encdec_flash`, then `encdec_train`."""
    t0 = time.perf_counter()
    cfg, model, out = encdec_model(torch)
    out["kernels"] = encdec_kernels(torch, model, cfg)
    out.update(encdec_serving(torch, model, cfg, counters))
    graph_rows["whisper decode"] = check_graphs_encdec(torch, model, cfg, counters)
    del model
    torch.cuda.empty_cache()
    out["flash"] = encdec_flash(torch)
    out["train"] = encdec_train(torch, counters)
    out["seconds"] = time.perf_counter() - t0
    log(f"whisper: phase 15 took {out['seconds']:.1f} s")
    return out


def flash_inputs(torch, b, s, h, kv, d, dtype, gen, contiguous=False):
    """q (B, H, S, D), k, v (B, KV, S, D): transposed views of (B, S, ., D)
    tensors, as the model passes them (or contiguous (B, ., S, D) ones)."""
    if contiguous:
        return tuple(torch.randn((b, n, s, d), generator=gen, device="cuda").to(dtype)
                     for n in (h, kv, kv))
    return tuple(torch.randn((b, s, n, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
                 for n in (h, kv, kv))


def flash_registers(_build) -> dict:
    """`-Xptxas -v` of each flash kernel instantiation: registers, spill
    bytes (stores + loads) and static shared memory."""
    out, entry = {}, None
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "flash" in line else None
            if entry:
                out[entry] = {}
        elif entry and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[entry]["spill_bytes"] = nums[1] + nums[2]
        elif entry and "registers" in line:
            out[entry]["registers"] = int(line.split("Used ")[1].split()[0])
            out[entry]["smem_static"] = int(line.split(" bytes smem")[0].split()[-1]) \
                if "bytes smem" in line else 0
    return out


def flash_check(torch, fa, got, q, k, v, what, **kw) -> float:
    """|got - plain| within FLASH_TOL of the plain version; returns the error."""
    want = fa.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    dt = str(q.dtype).removeprefix("torch.")
    assert got.shape == want.shape and got.dtype == q.dtype and got.stride() == q.stride()
    err = (got.float() - want.float()).abs().max().item()
    bound = FLASH_TOL[dt] * max(1.0, want.float().abs().max().item())
    if not err <= bound:
        raise AssertionError(f"flash ({what}) differs from its plain version by {err} > {bound} "
                             f"at q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} {kw}")
    return err


def flash_traps(torch, fa, gen) -> dict:
    """The tensor-core kernel's traps (phase 6), each against the plain
    version within FLASH_TOL."""
    errs = {}
    # S 2048, causal, window 24: a middle query tile walks key tiles that
    # start after 0 and end before the last
    q, k, v = flash_inputs(torch, 1, 2048, 15, 5, 64, torch.bfloat16, gen)
    kw = dict(causal=True, window=24, softcap=0.0)
    out = fa.flash_attention(q, k, v, **kw)
    plan = fa.plan_for(q, k, v, out, causal=True, window=24)
    kts = plan.key_tiles(plan.grid[1] // 2)
    assert plan.kernel == "mma" and plan.aligned and 0 < kts.start and kts.stop < 2048 // plan.bk
    errs["s2048_window24"] = flash_check(torch, fa, out, q, k, v, "S 2048 window 24", **kw)
    # the contiguous (B, H, S, D) layout, aligned (D 64) and not (D 20)
    for h, kv, d, s in ((15, 5, 64, 512), (3, 3, 20, 17), (3, 1, 128, 256)):
        q, k, v = flash_inputs(torch, 2, s, h, kv, d, torch.bfloat16, gen, contiguous=True)
        for causal, window in ((True, 0), (False, 24)):
            kw = dict(causal=causal, window=window, softcap=0.0)
            errs[f"contiguous_d{d}_s{s}_{causal}_{window}"] = flash_check(
                torch, fa, fa.flash_attention(q, k, v, **kw), q, k, v, "contiguous", **kw)
    # two launches back to back, no sync between; a repeat launch is bit-equal
    a = flash_inputs(torch, 8, 512, 15, 5, 64, torch.bfloat16, gen)
    c = flash_inputs(torch, 2, 17, 3, 3, 20, torch.bfloat16, gen)
    out_a = fa.flash_attention(*a, causal=True)
    out_c = fa.flash_attention(*c, causal=False, window=24, softcap=20.0)
    out_a2 = fa.flash_attention(*a, causal=True)
    errs["back_to_back_a"] = flash_check(torch, fa, out_a, *a, "back to back", causal=True)
    errs["back_to_back_c"] = flash_check(torch, fa, out_c, *c, "back to back", causal=False,
                                         window=24, softcap=20.0)
    if not torch.equal(out_a, out_a2):
        raise AssertionError("flash: a repeat launch differs from the first")
    # a CUDA graph of the training-shape launch, replayed with new inputs
    q, k, v = a
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.flash_attention(q, k, v, causal=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa.flash_attention(q, k, v, causal=True)
    for i in range(FLASH_REPLAYS):
        for t, new in zip((q, k, v), flash_inputs(torch, 8, 512, 15, 5, 64, torch.bfloat16, gen)):
            t.copy_(new)
        graph.replay()
        errs[f"graph_replay_{i}"] = flash_check(torch, fa, out, q, k, v, f"graph replay {i}",
                                                causal=True)
    del graph
    return errs


def check_flash(torch) -> dict:
    """Phase 6: the flash kernels against their plain version, the traps,
    the gradients, and the device time at the training shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2)
    max_err, n_checks = 0.0, 0
    for h, kv, d in FLASH_HEADS:
        for s in FLASH_SEQS:
            b = 1 if s >= 2048 else 2
            for dtype in (torch.float32, torch.bfloat16):
                dt = str(dtype).removeprefix("torch.")
                q, k, v = flash_inputs(torch, b, s, h, kv, d, dtype, gen)
                for causal in (True, False):
                    for window in (0, 24):
                        for softcap in (0.0, 20.0):
                            kw = dict(causal=causal, window=window, softcap=softcap)
                            got = fa.flash_attention(q, k, v, **kw)
                            want = fa.flash_attention_plain(q, k, v, **kw)
                            torch.cuda.synchronize()
                            assert got.shape == want.shape and got.dtype == dtype
                            err = (got.float() - want.float()).abs().max().item()
                            bound = FLASH_TOL[dt] * max(1.0, want.float().abs().max().item())
                            if not err <= bound:
                                raise AssertionError(
                                    f"flash differs from its plain version by {err} > {bound} at "
                                    f"B{b} S{s} H{h} KV{kv} D{d} {dtype} {kw}")
                            max_err = max(max_err, err)
                            n_checks += 1
    log(f"flash: {n_checks} kernel-vs-plain checks, max |diff| {max_err:.3g}")
    traps = flash_traps(torch, fa, gen)
    max_err = max(max_err, *traps.values())
    log(f"flash: {len(traps)} trap checks (S 2048 window 24, contiguous layout, back-to-back "
        f"launches, {FLASH_REPLAYS} graph replays with new inputs): max |diff| "
        f"{max(traps.values()):.3g}")

    # gradients of the autograd.Function against autograd through the plain version
    grad_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).removeprefix("torch.")
        q, k, v = (t.detach().requires_grad_() for t in
                   flash_inputs(torch, 2, 256, 15, 5, 64, dtype, gen))
        dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        for window, softcap in ((0, 0.0), (24, 20.0)):
            out = fa.flash_attention_trainable(q, k, v, True, window, softcap)
            g_kern = torch.autograd.grad(out, (q, k, v), dout)
            want = fa.flash_attention_plain(q, k, v, causal=True, window=window, softcap=softcap)
            g_plain = torch.autograd.grad(want, (q, k, v), dout)
            for a, c in zip(g_kern, g_plain):
                err = (a.float() - c.float()).abs().max().item()
                bound = FLASH_GRAD_TOL[dt] * max(1.0, c.float().abs().max().item())
                if not err <= bound:
                    raise AssertionError(f"flash gradient differs by {err} > {bound} ({dtype})")
                grad_err = max(grad_err, err)
    log(f"flash: gradients through flash_attention_trainable vs the plain VJP: max |diff| {grad_err:.3g}")

    # device time at the training shape
    b, s, h, kv, d = FLASH_TRAIN_SHAPE
    q, k, v = flash_inputs(torch, b, s, h, kv, d, torch.bfloat16, gen)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    flops = 4 * b * h * d * (s * (s + 1) // 2)          # QK^T and PV over the causal pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOPS_S
    row = {"shape": dict(B=b, S=s, H=h, KV=kv, D=d, causal=True, dtype="bfloat16"),
           "bytes": nbytes, "flops": flops, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    qf, kf, vf = (t.float() for t in (q, k, v))
    row["plan"] = repr(fa.plan_for(q, k, v, torch.empty_like(q), causal=True, window=0))
    row["ms"] = device_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), reps=20)
    row["plain_ms"] = device_ms(torch, lambda: fa.flash_attention_plain(q, k, v, causal=True))
    row["library_ms"] = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True), reps=20)
    row["f32_kernel_ms"] = device_ms(torch, lambda: fa.flash_attention(qf, kf, vf, causal=True),
                                     reps=20)
    row["ms_repeat"] = device_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True), reps=20)
    log(f"flash: B{b} S{s} H{h}/KV{kv} D{d} causal bf16: kernel {row['ms']:.4f} ms "
        f"(repeat {row['ms_repeat']:.4f}), bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), plain {row['plain_ms']:.4f} ms, "
        f"sdpa yardstick {row['library_ms']:.4f} ms, f32 (CUDA-core) kernel "
        f"{row['f32_kernel_ms']:.4f} ms; plan {row['plan']}")
    return {"checks": n_checks, "max_abs_err": max_err, "traps": traps,
            "grad_max_abs_err": grad_err, "time": row}


def cpu_loss_check(torch, model, cfg, batch) -> dict:
    """The loss of one sequence (row 0, first CPU_SEQ tokens) on the card
    against the same weights on the CPU (plain path), no gradients."""
    from repro_torch.models import lm_loss

    tok, lab = batch["tokens"][:1, :CPU_SEQ], batch["labels"][:1, :CPU_SEQ]
    with torch.no_grad():
        gpu = lm_loss(model, tok.cuda(), lab.cuda(), cfg)[0].item()
        t0 = time.perf_counter()
        cpu_model = copy.deepcopy(model).to("cpu")
        cpu = lm_loss(cpu_model, tok.cpu(), lab.cpu(), cfg)[0].item()
        cpu_s = time.perf_counter() - t0
    del cpu_model
    if not (math.isfinite(gpu) and abs(gpu - cpu) <= TRAIN_LOSS_RTOL * abs(cpu)):
        raise AssertionError(f"card loss {gpu} and cpu loss {cpu} differ by more than "
                             f"{TRAIN_LOSS_RTOL} relative")
    return {"card": gpu, "cpu": cpu, "cpu_seconds": cpu_s}


def train(torch, counters) -> dict:
    """Phase 7: QAT training of full-width smollm-360m through the flash
    kernel, checkpoint and resume, card vs CPU loss, one profiled step."""
    from torch.profiler import profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config("smollm-360m").with_(attn_impl="flash")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    b, s = TRAIN_BATCH, TRAIN_SEQ
    tc = TrainConfig(total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_STEPS // 2, log_every=1,
                     checkpoint_dir=str(ckpt_dir), keep_checkpoints=1, seed=0)
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS)
    dc = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
    tr = Trainer(cfg, opt, tc, dc, device="cuda")
    n_params = sum(p.numel() for p in tr.model.parameters())
    log(f"train: {cfg.name} {cfg.dtype} attn_impl={cfg.attn_impl} remat={cfg.remat}, "
        f"{cfg.n_layers} layers, {n_params / 1e6:.1f}M parameters, B {b} x S {s}, "
        f"lr {TRAIN_LR}, {TRAIN_STEPS} steps")
    batch0 = {k: torch.from_numpy(x) for k, x in SyntheticLM(dc).batch_at(0).items()}
    before = cpu_loss_check(torch, tr.model, cfg, batch0)
    log(f"train: card vs cpu loss before training (step-1 weights and batch, 1 x {CPU_SEQ} "
        f"tokens): {before['card']:.5f} vs {before['cpu']:.5f} (cpu {before['cpu_seconds']:.1f} s)")

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    log_rows = tr.run()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    losses = [r["loss"] for r in log_rows]
    step_s = [r["step_time_s"] for r in log_rows]
    want = {name: (2 * cfg.n_layers * TRAIN_STEPS if name == "flash_attention" else 0)
            for name in counters}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, expected {want}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses not all finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: last loss {losses[-1]} is not below the first {losses[0]}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    res = {"losses": losses, "step_time_s": step_s, "step_ms_median": steady * 1e3,
           "tokens_per_s": b * s / steady, "wall_s": wall, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "n_params": n_params,
           "loss_before": before}
    log(f"train: {TRAIN_STEPS} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; step "
        f"{res['step_ms_median']:.1f} ms (median of steps 2-{TRAIN_STEPS}; step 1 "
        f"{step_s[0] * 1e3:.1f} ms), {res['tokens_per_s']:.0f} tok/s, launches {launches}, "
        f"peak {res['peak_mem_gb']:.1f} GB, wall {wall:.1f} s (checkpoints included)")

    # checkpoint and resume
    tr2 = Trainer(cfg, opt, tc, dc, device="cuda")
    same = all(torch.equal(p, q) for p, q in zip(tr.model.parameters(), tr2.model.parameters()))
    if tr2.step != TRAIN_STEPS or tr2.data.step != TRAIN_STEPS or not same:
        raise AssertionError(f"train: resumed at step {tr2.step} (data {tr2.data.step}), "
                             f"weights equal: {same}")
    res["resumed_step"] = tr2.step
    log(f"train: a second Trainer resumed at step {tr2.step} with equal weights "
        f"({len(list(ckpt_dir.iterdir()))} checkpoint kept)")
    del tr2

    after = cpu_loss_check(torch, tr.model, cfg, batch0)
    res["loss_after"] = after
    log(f"train: card vs cpu loss after training: {after['card']:.5f} vs {after['cpu']:.5f}")

    # one step under the profiler
    batch = {k: torch.from_numpy(x).cuda() for k, x in SyntheticLM(dc).batch_at(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    with profile(activities=device_only()) as prof:
        t0 = time.perf_counter()
        tr._step(tr.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    by_name = device_time_by_kernel(averages, 1)
    dev_ms = sum(ms for ms, _ in by_name)
    n_kernels = sum(ev.count for ev in averages if str(ev.device_type).endswith("CUDA"))
    res["profile"] = {"wall_ms": wall_ms, "device_ms": dev_ms, "device_kernels": n_kernels,
                      "device_busy_share": dev_ms / wall_ms if dev_ms else None,
                      "top_kernels_ms": [[name[:90], ms] for ms, name in by_name[:10]]}
    log(f"profile: train step wall {wall_ms:.1f} ms, {n_kernels} device kernels, "
        f"device busy {dev_ms:.1f} ms"
        + (f" ({100 * dev_ms / wall_ms:.1f}%)" if dev_ms else
           " (the profiler saw no device time: not measured)"))
    for name, ms in res["profile"]["top_kernels_ms"]:
        log(f"profile:   {ms:8.3f} ms  {name}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return res


def xla_vs_kernel(torch, weights, gen) -> dict:
    """Phase 16 (a): the "xla" impl's integer core against #3 and its plain
    version at every segment of `weights` and N in XLA_TOKENS.
    → ({name: max |diff|}, number of checks)."""
    from repro_torch.core import act_quant_tokens
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_decode_gemm as tdg

    dev = torch.device("cuda")
    err, n_checks = {"ternary_decode_gemm": 0, "ternary_decode_gemm_plain": 0}, 0
    for (m, k), pw in weights.items():
        for n in XLA_TOKENS:
            a_q, _ = act_quant_tokens(torch.randn((k, n), generator=gen, device=dev) * 3.0)
            for packed, lo, hi, g in ops._segments(pw):
                got = ops._xla_streamed_decode(packed, a_q[lo:hi], g)
                a_r = ops._deinterleave(a_q[lo:hi], g)
                for name, fn in (("ternary_decode_gemm", tdg.ternary_decode_gemm),
                                 ("ternary_decode_gemm_plain", tdg.ternary_decode_gemm_plain)):
                    want = fn(packed, a_r, g=g)
                    torch.cuda.synchronize()
                    if got.dtype != torch.int32 or tuple(got.shape) != (m, n) or \
                            tuple(want.shape) != (m, n):
                        raise AssertionError(f"xla: {got.dtype} {tuple(got.shape)} at {(m, k, n)}")
                    err[name] = max(err[name], (got.long() - want.long()).abs().max().item())
                n_checks += 1
    return err, n_checks


def xla_forward_ms(torch, lins, n: int, gen) -> dict:
    """Phase 16 (a): device ms of one forward's BitLinears `lins` at N
    tokens through `ternary_matmul` with impl="xla" beside the fused
    pipeline (#1) and the unfused one (#3), and of the integer cores alone
    (the xla streamed decode against #3's launches) on the same int8
    activations."""
    from repro_torch.core import act_quant_tokens
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_decode_gemm as tdg

    dev = torch.device("cuda")
    xs = {k: torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
          for k in {lin.pw.K for lin in lins}}
    a_qs = {k: act_quant_tokens(x.T)[0] for k, x in xs.items()}
    segs = [(packed, a_qs[lin.pw.K][lo:hi], g)
            for lin in lins for packed, lo, hi, g in ops._segments(lin.pw)]
    a_rs = [(packed, ops._deinterleave(a, g), g) for packed, a, g in segs]

    def pipeline(impl, fusion):
        for lin in lins:
            ops.ternary_matmul(lin.pw, xs[lin.pw.K], impl=impl, fusion=fusion)

    row = {"n": n, "bitlinears": len(lins), "segments": len(segs), "pipeline": {
        name: device_ms(torch, lambda impl=impl, fusion=fusion: pipeline(impl, fusion))
        for name, impl, fusion in (("xla", "xla", "unfused"),
                                   ("ternary_decode_gemm_fused", "decode", "fused"),
                                   ("ternary_decode_gemm", "decode", "unfused"))}}
    row["int_core"] = {
        "xla": device_ms(torch, lambda: [ops._xla_streamed_decode(p, a, g) for p, a, g in segs]),
        "ternary_decode_gemm": device_ms(
            torch, lambda: [tdg.ternary_decode_gemm(p, a, g=g) for p, a, g in a_rs])}
    return row


def dist_train(torch, counters, trained) -> dict:
    """Phase 16 (b): `Trainer(mesh=...)` on a world of one rank over NCCL
    against the unsharded `Trainer`, the same DIST_STEPS steps."""
    import socket

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from torch.profiler import profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.dist.sharding import batch_shardings, distribute_tree, full_tensor
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, Trainer

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_small_mesh(1, 1)
        cfg = get_config("smollm-360m").with_(attn_impl="flash")
        b, s = TRAIN_BATCH, TRAIN_SEQ
        opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS)
        dc = DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
        runs = {}
        for name, m in (("unsharded", None), ("mesh", mesh)):
            ckpt_dir = ROOT / "build" / f"chip_smoke_dist_{name}"
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            tc = TrainConfig(total_steps=DIST_STEPS, checkpoint_every=10 * DIST_STEPS,
                             log_every=1, checkpoint_dir=str(ckpt_dir), keep_checkpoints=1,
                             seed=0)
            tr = Trainer(cfg, opt, tc, dc, device="cuda", mesh=m)
            for fn in counters.values():
                fn.launches = 0
            rows = tr.run()
            runs[name] = {"trainer": tr, "losses": [r["loss"] for r in rows],
                          "step_s": [r["step_time_s"] for r in rows],
                          "launches": {nm: fn.launches for nm, fn in counters.items()}}
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        sharded, plain = runs["mesh"]["trainer"], runs["unsharded"]["trainer"]
        params = sharded.state["params"]
        placements = {tuple(p.placements) if isinstance(p, DTensor) else None
                      for p in params.values()}
        if placements != {(Replicate(), Replicate())}:
            raise AssertionError(f"dist: placements {placements}")
        want = {nm: (2 * cfg.n_layers * DIST_STEPS if nm == "flash_attention" else 0)
                for nm in counters}
        if runs["mesh"]["launches"] != want:
            raise AssertionError(f"dist: launches {runs['mesh']['launches']}, expected {want}")
        if runs["mesh"]["losses"] != runs["unsharded"]["losses"]:
            raise AssertionError(f"dist: losses {runs['mesh']['losses']} vs "
                                 f"{runs['unsharded']['losses']}")
        if trained["losses"][:DIST_STEPS] != runs["unsharded"]["losses"]:
            raise AssertionError(f"dist: unsharded losses {runs['unsharded']['losses']} vs "
                                 f"phase 7's {trained['losses'][:DIST_STEPS]}")
        diff = max((full_tensor(p).float() - plain.state["params"][nm].float()).abs().max().item()
                   for nm, p in params.items())
        if diff != 0:
            raise AssertionError(f"dist: parameters after {DIST_STEPS} steps differ by {diff}")
        batch = {k: torch.from_numpy(x).cuda() for k, x in SyntheticLM(dc).batch_at(0).items()}
        batch = distribute_tree(batch, batch_shardings(batch, mesh, cfg))
        torch.cuda.synchronize()
        with profile(activities=device_only()) as prof:
            t0 = time.perf_counter()
            with sharded._step_ctx():
                sharded._step(sharded.state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev_ms = sum(ms for ms, _ in device_time_by_kernel(prof.key_averages(), 1))
        out = {"losses": runs["mesh"]["losses"], "param_max_abs_diff": diff,
               "launches": runs["mesh"]["launches"],
               "placements": [str(pl) for pl in next(iter(placements))],
               "step_ms": {nm: [t * 1e3 for t in r["step_s"]] for nm, r in runs.items()},
               "profile": {"wall_ms": wall_ms, "device_ms": dev_ms,
                           "device_busy_share": dev_ms / wall_ms if dev_ms else None}}
        log(f"dist: world 1 over NCCL, mesh {mesh}: {DIST_STEPS} sharded steps bit-equal to the "
            f"unsharded Trainer's (losses {out['losses']}, parameters max |diff| {diff}); "
            f"placements {out['placements']}; launches {out['launches']}")
        p7 = trained["profile"]
        log("dist: step ms (steps 1-{}) mesh {}, unsharded {}; phase 7's median {:.1f}; "
            "profiled step: mesh wall {:.1f} ms, device ".format(
                DIST_STEPS, " ".join(f"{t:.1f}" for t in out["step_ms"]["mesh"]),
                " ".join(f"{t:.1f}" for t in out["step_ms"]["unsharded"]),
                trained["step_ms_median"], wall_ms)
            + (f"{dev_ms:.1f} ms ({100 * dev_ms / wall_ms:.1f}% busy)" if dev_ms else
               "not measured (the profiler saw no device time)")
            + f"; phase 7 wall {p7['wall_ms']:.1f} ms, device {p7['device_ms']:.1f} ms")
        del runs, sharded, plain, params
        return out
    finally:
        dist.destroy_process_group()


def check_dist(torch, counters, unfused, trained) -> dict:
    """Phase 16: the "xla" impl on the card, then the world-1 sharded
    trainer."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import encoder_specs, init_lm, pack_params
    from repro_torch.models.blocks import block_init

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(16)
    cfg = get_config("smollm-360m")
    model = pack_params(init_lm(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    wcfg = get_config(ENCDEC_ARCH)
    wgen = torch.Generator(device="cuda").manual_seed(0)
    encoder = [pack_params(block_init(wcfg, spec, generator=wgen, device=torch.device("cuda")),
                           wcfg) for spec in encoder_specs(wcfg)]
    weights = {**layer_weights(model.layers[0]), **layer_weights(encoder[0])}
    err, n_checks = xla_vs_kernel(torch, weights, gen)
    log(f"dist: xla impl: {n_checks} checks at (M, K) {sorted(weights)}, N {XLA_TOKENS}: "
        f"max |diff| {err}")
    if any(e != 0 for e in err.values()):
        raise AssertionError(f"dist: the xla impl differs from #3 or its plain version: {err}")
    timed = {}
    for label, lins, n in (("smollm_forward", packed_linears(model), DECODE_N),
                           ("whisper_encoder", [lin for layer in encoder
                                                for lin in packed_linears(layer)],
                            ENCDEC_BATCH * ENCDEC_FRAMES)):
        timed[label] = row = xla_forward_ms(torch, lins, n, gen)
        log(f"dist: {label}'s {row['bitlinears']} BitLinears ({row['segments']} segments) at "
            f"N={n}: pipelines " + ", ".join(f"{k} {v:.4f} ms" for k, v in row["pipeline"].items())
            + "; integer cores " + ", ".join(f"{k} {v:.4f} ms" for k, v in row["int_core"].items()))
    if timed["smollm_forward"]["bitlinears"] != 224 or \
            timed["whisper_encoder"]["segments"] != ENCDEC_LAUNCHES["encoder"]:
        raise AssertionError(f"dist: timed {timed}")
    rng = np.random.default_rng(0)            # phase 4's prompts
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(16, 65))).astype(np.int32)
               for _ in range(8)]
    r = serve(torch, model, cfg, "xla", prompts, counters, fusion="unfused", traced=False)
    if r["tokens"] != unfused["serve"]["decode"]["tokens"]:
        raise AssertionError("dist: impl=xla emitted other greedy tokens than phase 5's unfused run")
    if any(r["launches"].values()):
        raise AssertionError(f"dist: impl=xla launched kernels: {r['launches']}")
    log(f"dist: serve impl=xla: phase 5's unfused tokens, no kernel launched; "
        f"prefill_tok_s={r['prefill_tok_s']:.1f} decode_tok_s={r['decode_tok_s']:.1f}")
    out = {"xla": {"max_abs_err": err, "checks": n_checks, "forward_ms": timed,
                   "serve": {k: v for k, v in r.items() if k != "tokens"}}}
    del model, encoder, weights
    torch.cuda.empty_cache()
    out["train"] = dist_train(torch, counters, trained)
    out["seconds"] = time.perf_counter() - t0
    log(f"dist: phase 16 took {out['seconds']:.1f} s")
    return out

def autotune_problems(torch) -> list:
    """Phase 17 (b)'s problems, (model, kernel family, fused, g, M, KG, N, E,
    output dtype): kernels #1-#4 at smollm-360m's distinct segments at N 4
    and 64 and at whisper-medium's encoder segments at N 6000, and the
    fused grouped pair at llama4-scout's expert segments at C 4; the
    output dtype the main path gives each (f32 partials where a weight has
    two segments)."""
    from repro_torch.configs import get_config
    from repro_torch.core.packing import pack_group_sizes

    def segments(k):
        return [(kg, g) for kg, g in zip(pack_group_sizes(k), (5, 4)) if kg]

    out = []
    wcfg = get_config(ENCDEC_ARCH)
    d, f = wcfg.d_model, wcfg.d_ff
    for label, shapes, tokens in (("smollm-360m", SHAPES, AUTOTUNE_TOKENS),
                                  (ENCDEC_ARCH, ((d, d), (f, d), (d, f)),
                                   (ENCDEC_BATCH * ENCDEC_FRAMES,))):
        for m, k in shapes:
            segs = segments(k)
            out_dt = torch.bfloat16 if len(segs) == 1 else torch.float32
            for kg, g in segs:
                for n in tokens:
                    for impl in IMPLS:
                        for fused in (True, False):
                            out.append((label, impl, fused, g, m, kg, n, None, out_dt))
    two_segments = {m for e, m, kg, g in MAIN_GROUPED_SEGMENTS[:3] if g == 4}
    for e, m, kg, g in MAIN_GROUPED_SEGMENTS[:3]:
        out_dt = torch.float32 if m in two_segments else torch.bfloat16
        for impl in IMPLS:
            out.append((MOE_ARCH, f"{impl}_grouped", True, g, m, kg, AUTOTUNE_C, e, out_dt))
    return out


def autotune_plain(kernel: str, fused: bool, n: int):
    """The plain version phase 17 holds a family's heuristic plan to: its
    own, except the vector-LUT pair's at whisper's N 6000, where its gather
    takes ~1 s a call: there the decode pair's (one f32 product of exact
    integers: the same integers, so the same outputs bit for bit)."""
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg

    own = kernel.startswith("lookup") and n <= 256
    if fused:
        return vlg.vlut_lookup_gemm_fused_plain if own else tdg.ternary_decode_gemm_fused_plain
    return vlg.vlut_lookup_gemm_plain if own else tdg.ternary_decode_gemm_plain


def check_autotune(torch, counters, prompts, ref_runs, encdec) -> dict:
    """Phase 17: the measured launch-plan choice (`kernels.autotune`), after
    every other phase. (a) The plan cache of phases 3-16 was never
    written, and every smollm-360m launch at N 4 and 64 reports today's
    heuristic plan. (b) Each of `autotune_problems` tuned into a fresh cache
    under build/: every candidate held bit-equal to the heuristic plan's
    output (inside `tune`), the heuristic plan's output to the plain
    version on the same operands, and the heuristic and winning plans' ms
    logged. (c) `get_plan` rereads every tuned key with no timing, and a
    fresh `PlanCache` on the file gives the same plans. (d) Phase 4's
    serving, both fused impls, on the same weights with the tuned cache
    (impl="decode" after a run with the empty cache): phase 4's greedy
    tokens, 224 launches a forward. (e) whisper-medium's
    encoder's 336 launches at N 6000 under the tuned plans, #1-#4, by graph
    replay beside phase 15's. (f) Each winner is a
    `repro:mpgemm_kernel_seconds` sample of the installed `Obs`. The launch
    counters are restored at the end."""
    from repro_torch import obs as obs_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels import autotune, ops
    from repro_torch.kernels import ternary_decode_gemm as tdg
    from repro_torch.kernels import vlut_lookup_gemm as vlg
    from repro_torch.models import init_lm, pack_params

    t_phase = time.perf_counter()
    saved = {name: fn.launches for name, fn in counters.items()}
    dev = torch.device("cuda")
    cfg = get_config("smollm-360m")
    model = pack_params(init_lm(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    weights = layer_weights(model.layers[0])

    # (a) the cold cache
    cold = autotune.default_cache()
    if pathlib.Path(cold.path).exists():
        raise AssertionError(f"autotune: phases 3-16 wrote the plan cache {cold.path}")
    for (m, k), pw in sorted(weights.items()):
        for n in AUTOTUNE_TOKENS:
            dp, lp = tdg.decode_plan(m, k // 5, n, 5), vlg.lut_plan(m, k // 5, n, 5)
            for impl, want in (("decode", [f"g5 {dp.bm}x{dp.bn} s{dp.splits} k{dp.kstep}"]),
                               ("lookup", [f"g5 bm{lp.bm} s{lp.splits} c{lp.chunk}"])):
                if ops.launch_tiles(pw, n, impl) != want:
                    raise AssertionError(f"autotune: cold plan of {impl} ({m}, {k}) N {n}: "
                                         f"{ops.launch_tiles(pw, n, impl)}, today's {want}")
    log(f"autotune: (a) cold cache {cold.path} never written; smollm's launches at N "
        f"{AUTOTUNE_TOKENS} report today's heuristic plans")

    # (b) tune, with an Obs installed for (f)
    tuned_path = PLANS_DIR / "plans.json"
    cache = autotune.reset_default_cache(str(tuned_path))
    observed = obs_mod.Obs(obs_mod.ObsConfig())
    obs_mod.install(observed)
    rows, winners = [], []
    t0 = time.perf_counter()
    for label, kernel, fused, g, m, kg, n, e, out_dt in autotune_problems(torch):
        bench = autotune.default_benchmark(kernel, g, m, kg, n, e=e, fused=fused, device=dev,
                                           dtype=torch.bfloat16, out_dtype=out_dt)
        kw = {"g": g, "out_dtype": out_dt} if fused else {"g": g}
        want = autotune_plain(kernel, fused, n)(*bench.inputs, **kw)
        if not torch.equal(bench.reference, want):
            raise AssertionError(f"autotune: {kernel} fused={fused} ({m}, {kg}, {n}, g{g}, E {e}): "
                                 "the heuristic plan's output differs from the plain version")
        del want
        res = autotune.tune(kernel, g, m, kg, n, e=e, fused=fused, device=dev, benchmark=bench)
        heur = autotune.heuristic(kernel, g, m, kg, n, e=e)
        (first, heur_s), *_ = res.trials
        if autotune.fields_of(kernel, first) != autotune.fields_of(kernel, heur):
            raise AssertionError(f"autotune: the heuristic plan {heur} was not timed first")
        row = {"model": label, "kernel": kernel, "fused": fused, "g": g, "m": m, "kg": kg,
               "n": n, "e": e, "out_dtype": str(out_dt).split(".")[-1],
               "candidates": len(res.trials), "heuristic": autotune.describe(heur),
               "heuristic_ms": heur_s * 1e3, "winner": autotune.describe(res.plan),
               "winner_ms": res.seconds * 1e3, "ratio": heur_s / res.seconds}
        rows.append(row)
        winners.append(res.seconds / (e or 1))
        log(f"autotune: (b) {label} {kernel} {'fused' if fused else 'integer'} g{g} M {m} KG {kg} "
            f"N {n}" + (f" E {e}" if e else "") + f": {row['candidates']} candidates, heuristic "
            f"{row['heuristic']} {row['heuristic_ms']:.4f} ms, winner {row['winner']} "
            f"{row['winner_ms']:.4f} ms ({row['ratio']:.3f}x)")
        del bench
    tune_s = time.perf_counter() - t0
    obs_mod.install(None)

    # (c) persistence: reread with no timing, and from a fresh instance
    trials = autotune.tune.trials
    fresh = autotune.PlanCache(str(tuned_path))
    for r, (_, kernel, fused, g, m, kg, n, e, _) in zip(rows, autotune_problems(torch)):
        for c in (cache, fresh):
            p = autotune.get_plan(kernel, g, m, kg, n, e=e, fused=fused, device=dev, cache=c,
                                  tune_if_missing=True)
            if autotune.describe(p) != r["winner"]:
                raise AssertionError(f"autotune: reread {autotune.describe(p)}, tuned {r['winner']}")
    if autotune.tune.trials != trials:
        raise AssertionError(f"autotune: rereading ran {autotune.tune.trials - trials} trials")
    log(f"autotune: (c) {len(rows)} tuned keys reread (this cache and a fresh one on "
        f"{tuned_path.relative_to(ROOT)}) with 0 trials")

    # (f) every winner a sample of the installed Obs (which keeps positive
    # seconds only: a winner at or below the flush's noise has none)
    samples = [v for mt in observed.registry.all() if mt.name == "repro:mpgemm_kernel_seconds"
               for v in mt.samples]
    if sorted(samples) != sorted(w for w in winners if w > 0):
        raise AssertionError(f"autotune: {len(samples)} kernel samples, {len(winners)} winners")
    log(f"autotune: (f) {len(samples)} repro:mpgemm_kernel_seconds samples, one per winner "
        f"({sum(w <= 0 for w in winners)} winners at or below 0 s)")

    # (d) phase 4's serving with the tuned cache, impl="decode" after a run
    # with the empty one: serving is host-bound and the host's speed drifts
    # over the script, so phase 4's rates are no yardstick here
    serving = {}
    for impl, runs in (("decode", (("heuristic", cold.path), ("tuned", str(tuned_path)))),
                       ("lookup", (("tuned", str(tuned_path)),))):
        name = single_kernel(impl)
        for plans, path in runs:
            autotune.reset_default_cache(path)
            r = serve(torch, model, cfg, impl, prompts, counters, traced=False)
            want = {nm: (224 * r["forwards"] if nm == name else 0) for nm in counters}
            if r["launches"] != want:
                raise AssertionError(f"autotune: impl={impl} ({plans} plans) launches "
                                     f"{r['launches']}, expected {want}")
            if r["tokens"] != ref_runs[impl]["tokens"]:
                raise AssertionError(f"autotune: impl={impl} with {plans} plans left phase 4's "
                                     "tokens")
            row = serving.setdefault(impl, {})[plans] = {k: v for k, v in r.items()
                                                         if k != "tokens"}
            row["tiles_n4"] = {f"{m}x{k}": ops.launch_tiles(pw, DECODE_N, impl)
                               for (m, k), pw in sorted(weights.items())}
            log(f"autotune: (d) impl={impl} {plans} plans: phase 4's tokens, launches "
                f"{r['launches'][name]} = 224 x {r['forwards']}; decode_tok_s "
                f"{r['decode_tok_s']:.1f}, prefill_tok_s {r['prefill_tok_s']:.1f} (phase 4 "
                f"{ref_runs[impl]['decode_tok_s']:.1f}, {ref_runs[impl]['prefill_tok_s']:.1f}); "
                f"plans at N 4 {row['tiles_n4']}")
    if pathlib.Path(cold.path).exists():
        raise AssertionError(f"autotune: serving with the empty cache wrote {cold.path}")
    del model, weights
    torch.cuda.empty_cache()

    # (e) whisper's encoder under the tuned plans
    _, wmodel, _ = encdec_model(torch)
    enc_lins = packed_linears(wmodel.encoder)
    n = ENCDEC_BATCH * ENCDEC_FRAMES
    winner = {(r["kernel"], r["fused"], r["m"], r["kg"], r["n"]): r["winner"] for r in rows}
    for lin in enc_lins:
        for impl in IMPLS:
            for fused in (True, False):
                want = [winner[impl, fused, lin.pw.M, packed.shape[1], n]
                        for packed, _, _, _ in ops._segments(lin.pw)]
                got = ops.launch_tiles(lin.pw, n, impl, fusion="fused" if fused else "unfused")
                if got != want:
                    raise AssertionError(f"autotune: encoder launch plans {got}, tuned {want}")
    gen = torch.Generator(device="cuda").manual_seed(15)
    enc = {**forward_launch_ms(torch, enc_lins, n, gen, yardsticks=False),
           **int_forward_launch_ms(torch, enc_lins, n, gen, yardsticks=False)}
    before = {**encdec["kernels"]["forward_ms"]["encoder"],
              **encdec["kernels"]["int_forward_ms"]["encoder"]}
    names = [*fused_kernels(), *int_kernels()]
    encoder = {nm: {"ms": enc[nm]["ms"], "phase15_ms": before[nm]["ms"]} for nm in names}
    encoder["launches"] = enc["launches"]
    if enc["launches"] != ENCDEC_LAUNCHES["encoder"]:
        raise AssertionError(f"autotune: whisper's encoder timed {enc['launches']} launches")
    log(f"autotune: (e) whisper's encoder, {enc['launches']} launches at N {n} under tuned plans: "
        + ", ".join(f"{nm} {encoder[nm]['ms']:.4f} ms (phase 15 {encoder[nm]['phase15_ms']:.4f})"
                    for nm in names))
    del wmodel, enc_lins
    torch.cuda.empty_cache()

    for name, fn in counters.items():
        fn.launches = saved[name]
    out = {"tuned": rows, "tune_s": tune_s, "cache": str(tuned_path.relative_to(ROOT)),
           "serve": serving, "encoder": encoder,
           "seconds": time.perf_counter() - t_phase}
    log(f"autotune: phase 17 took {out['seconds']:.1f} s (tuning {tune_s:.1f} s)")
    return out


def splitk_bytes(torch) -> int:
    from repro_torch.kernels import _splitk

    return sum(ws.numel() * ws.element_size() + cnt.numel() * cnt.element_size()
               for ws, cnt in _splitk._WORKSPACE.values())


def traced_vs_real(torch, name, step, fake_args, real_args, counters, traces,
                   device_ms_fn=None) -> dict:
    """Phase 18 (a)-(d) for one step: trace it on fake cuda tensors (kept in
    `traces` by name, for phase 19), run it once for real (after a warm-up
    run) under `FlopCounterMode`, and hold the trace's launches, dot FLOPs
    and argument + temp bytes against the counters, the flop counter and
    the card's peak."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS
    from repro_torch.roofline.hlo_stats import step_stats, storage_bytes, trace_step

    trace, _ = trace_step(step, *fake_args)
    traces[name] = trace
    st = step_stats(trace)
    step(*real_args)                                    # warm-up: the library's workspaces
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    args_real = storage_bytes(real_args)
    ws0 = splitk_bytes(torch)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        out = step(*real_args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    launches = {n: fn.launches for n, fn in counters.items()}
    want = {n: st.launches.get(n, 0) for n in counters}
    if launches != want:
        raise AssertionError(f"steps ({name}): the trace's launches {want} differ from the "
                             f"real step's {launches}")
    real_flops = fc.get_total_flops()
    if st.dot_flops != real_flops:
        raise AssertionError(f"steps ({name}): the trace's dot FLOPs {st.dot_flops} differ from "
                             f"FlopCounterMode's {real_flops}")
    mem = st.memory
    splitk = splitk_bytes(torch) - ws0
    measured = args_real + (peak - base) - splitk
    traced = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    rel = abs(traced - measured) / measured
    row = {"trace_s": trace.seconds, "ops": len(trace.ops), "stats": st.row(),
           "launches": launches, "dot_flops_real": real_flops,
           "memory": {"argument_traced": mem["argument_size_in_bytes"],
                      "argument_real": args_real, "temp_traced": mem["temp_size_in_bytes"],
                      "peak_minus_base": peak - base, "splitk_growth": splitk,
                      "traced": traced, "measured": measured, "rel_diff": rel}}
    log(f"steps ({name}): trace {trace.seconds:.2f} s, {len(trace.ops)} ops; launches "
        f"{ {k: v for k, v in launches.items() if v} } (= the trace's); dot FLOPs "
        f"{st.dot_flops:.6g} (= FlopCounterMode's), kernel FLOPs {st.kernel_flops:.6g}, "
        f"traffic {st.traffic_bytes / 1e9:.4f} GB, kernel bytes {st.kernel_bytes / 1e9:.4f} GB")
    log(f"steps ({name}): memory: argument {mem['argument_size_in_bytes'] / 1e6:.2f} MB "
        f"(real {args_real / 1e6:.2f}), temp {mem['temp_size_in_bytes'] / 1e6:.2f} MB against "
        f"the card's peak - base {(peak - base) / 1e6:.2f} MB (split-K workspace growth "
        f"{splitk / 1e6:.2f} MB subtracted); argument + temp {traced / 1e6:.2f} MB vs "
        f"{measured / 1e6:.2f} MB: {100 * rel:.2f}% apart")
    if rel > STEP_MEM_RTOL:
        raise AssertionError(f"steps ({name}): argument + temp {traced} B is {100 * rel:.1f}% "
                             f"from the card's {measured} B (bound {100 * STEP_MEM_RTOL:.0f}%)")
    t_bytes, t_ops = st.traffic_bytes / HBM_BW, st.flops / PEAK_FLOPS
    row["bound_ms"] = max(t_bytes, t_ops) * 1e3
    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if device_ms_fn is not None:
        row["device_ms"] = device_ms_fn()
        row["bound_ratio"] = row["device_ms"] / row["bound_ms"]
        log(f"steps ({name}): bound {row['bound_ms']:.4f} ms ({row['bound_by']}: traffic / "
            f"3.35 TB/s, FLOPs / 989 TFLOP/s) vs device {row['device_ms']:.4f} ms: "
            f"{row['bound_ratio']:.2f}x")
    return row


def profiled_device_ms(torch, fn) -> float:
    """Device busy ms of one call of `fn` (the profiler, the device alone)."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=device_only()) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ms for ms, _ in device_time_by_kernel(prof.key_averages(), 1))


def hop_cost(torch, model, cfg, prompts, counters) -> dict:
    """Phase 18 (e): the host's cost of the dispatcher's hop into the
    operator: µs a call of #1's wrapper (launching directly) and of the same
    checks then ``torch.ops.repro_torch.ternary_decode_gemm_fused`` (the
    operator's CUDA implementation: the same launch function), at N 4 on
    smollm's (960, 960) q projection, in turns; then phase 4's serving,
    impl="decode", directly and through the operator (same tokens)."""
    from repro_torch.core.quantize import act_token_scale
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_decode_gemm as tdg

    op = torch.ops.repro_torch.ternary_decode_gemm_fused
    pw = model.layers[0].mixer.wq.pw
    packed, x = pw.packed5, torch.randn((DECODE_N, pw.K), device="cuda").to(torch.bfloat16)
    a_scale = act_token_scale(x.T).contiguous()

    def through_op(packed, x, a_scale, w_scale, *, g, out_dtype=torch.float32, plan=None):
        tdg.check_fused_args(packed, x, a_scale, w_scale, g, out_dtype)
        return op(packed, x, a_scale, w_scale, g, out_dtype, None)

    def per_call_us(fn) -> float:
        fn(packed, x, a_scale, pw.scale, g=5, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOP_CALLS):
            fn(packed, x, a_scale, pw.scale, g=5, out_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / HOP_CALLS * 1e6

    direct = tdg.ternary_decode_gemm_fused
    same = torch.equal(direct(packed, x, a_scale, pw.scale, g=5, out_dtype=torch.bfloat16),
                       through_op(packed, x, a_scale, pw.scale, g=5, out_dtype=torch.bfloat16))
    if not same:
        raise AssertionError("steps (e): the operator's launch differs from the direct one")
    times = [per_call_us(direct), per_call_us(through_op), per_call_us(through_op),
             per_call_us(direct)]
    out = {"direct_us": (times[0] + times[3]) / 2, "operator_us": (times[1] + times[2]) / 2,
           "turns_us": times}
    out["hop_us"] = out["operator_us"] - out["direct_us"]
    runs = {"direct": serve(torch, model, cfg, "decode", prompts, counters, traced=False)}
    with planted(ops, "_KERNELS", {**ops._KERNELS, "decode": through_op}):
        runs["operator"] = serve(torch, model, cfg, "decode", prompts, counters, traced=False)
    if runs["operator"]["tokens"] != runs["direct"]["tokens"]:
        raise AssertionError("steps (e): serving through the operator changed the tokens")
    for route, r in runs.items():
        want = 224 * r["forwards"]
        if r["launches"]["ternary_decode_gemm_fused"] != want:
            raise AssertionError(f"steps (e): {route}: {r['launches']} launches, want {want}")
        out[f"{route}_decode_tok_s"] = r["decode_tok_s"]
    log(f"steps (e): #1 at N {DECODE_N}, {HOP_CALLS} calls a turn: direct "
        f"{out['direct_us']:.2f} µs a call, through the operator {out['operator_us']:.2f} "
        f"(turns {', '.join(f'{t:.2f}' for t in times)}): the hop {out['hop_us']:.2f} µs; "
        f"phase 4's serving decode tok/s direct {out['direct_decode_tok_s']:.1f}, through "
        f"the operator {out['operator_decode_tok_s']:.1f} (same tokens)")
    return out


def check_steps(torch, counters, prompts, trained) -> tuple:
    """Phase 18: the step statistics (`roofline.hlo_stats`) of smollm-360m
    at published width and depth, traced on fake cuda tensors and held
    against the same steps run on the card: (a)-(d) for the decode step (4
    slots, cache 256), the prefill step (one prompt at phase 4's bucket)
    and one QAT training step (B 8 x S 512, flash; its device ms is phase
    7's profile of the same step), then (e) the operator hop's host cost.
    → (rows, {"model", "cfg", "traces"}: the packed model and the three
    traces, for phase 19)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import (
        make_decode_step,
        make_prefill_step,
        make_train_step,
        meta_model,
    )
    from repro_torch.models import init_cache, init_lm, pack_params, prefill_bucket, stacked_shapes
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.roofline.hlo_stats import fake_module

    t0 = time.perf_counter()
    cfg = get_config("smollm-360m")
    cdt = getattr(torch, cfg.dtype)
    model = pack_params(init_lm(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    out, traces = {}, {}
    mode = FakeTensorMode()
    fmodel = fake_module(meta_model(cfg, packed=True), "cuda", mode)

    # the decode step: 4 slots, cache 256 (phase 4's engine)
    decode = make_decode_step(cfg)
    cache = init_cache(cfg, 4, 256, dtype=cdt, device="cuda")
    tok = torch.randint(0, cfg.vocab, (4, 1), dtype=torch.int32, device="cuda")
    with mode:
        fcache = init_cache(cfg, 4, 256, dtype=cdt, device="cuda")
        ftok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    out["decode"] = traced_vs_real(
        torch, "decode", decode, (fmodel, fcache, ftok), (model, cache, tok), counters, traces,
        lambda: profiled_device_ms(torch, lambda: decode(model, cache, tok)))

    # the prefill step: one prompt at phase 4's bucket
    s = prefill_bucket(len(prompts[0]), 256)
    prefill = make_prefill_step(cfg)
    pcache = init_cache(cfg, 1, 256, dtype=cdt, device="cuda")
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, s), dtype=torch.int32, device="cuda")}
    with mode:
        fpcache = init_cache(cfg, 1, 256, dtype=cdt, device="cuda")
        fbatch = {"tokens": torch.zeros((1, s), dtype=torch.int32, device="cuda")}
    out["prefill"] = traced_vs_real(
        torch, f"prefill S {s}", prefill, (fmodel, fpcache, fbatch), (model, pcache, batch),
        counters, traces, lambda: profiled_device_ms(torch, lambda: prefill(model, pcache, batch)))
    del fmodel, fcache, fpcache

    # one QAT training step, phase 7's settings
    tcfg = cfg.with_(attn_impl="flash")
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=5, total_steps=TRAIN_STEPS)
    train_step = make_train_step(tcfg, opt_cfg)
    tmodel = init_lm(tcfg, torch.Generator(device="cuda").manual_seed(0)).requires_grad_(True)
    params = dict(tmodel.named_parameters())
    state = {"params": params, "opt": adamw_init(params, opt_cfg, stacked_shapes(tmodel, tcfg))}
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    tbatch = {k: torch.from_numpy(v).cuda() for k, v in SyntheticLM(dc).batch_at(0).items()}
    ftmodel = fake_module(meta_model(tcfg), "cuda", mode).requires_grad_(True)
    with mode:
        fparams = dict(ftmodel.named_parameters())
        fstate = {"params": fparams,
                  "opt": adamw_init(fparams, opt_cfg, stacked_shapes(ftmodel, tcfg))}
        ftbatch = {k: torch.zeros(v.shape, dtype=v.dtype, device="cuda") for k, v in tbatch.items()}
    row = traced_vs_real(torch, f"train B {TRAIN_BATCH} x S {TRAIN_SEQ}", train_step,
                         (ftmodel, fstate, ftbatch), (tmodel, state, tbatch), counters, traces)
    row["device_ms"] = trained["profile"]["device_ms"]
    row["bound_ratio"] = row["device_ms"] / row["bound_ms"]
    log(f"steps (train): bound {row['bound_ms']:.4f} ms ({row['bound_by']}) vs phase 7's "
        f"profiled device {row['device_ms']:.4f} ms: {row['bound_ratio']:.2f}x")
    out["train"] = row
    del tmodel, state, params, ftmodel, fstate, fparams
    torch.cuda.empty_cache()

    out["hop"] = hop_cost(torch, model, cfg, prompts, counters)
    for fn in counters.values():
        fn.launches = 0
    out["seconds"] = time.perf_counter() - t0
    log(f"steps: phase 18 took {out['seconds']:.1f} s")
    return out, {"model": model, "cfg": cfg, "traces": traces}


def lint_registry(torch) -> tuple:
    """Phase 19 (a): the IR registry traced on fake cuda tensors, I1-I4 and
    the I5 hashes against the committed snapshots (cuda/ where committed,
    else cpu/); the card's snapshots written under chiprun_out. → (rows,
    entries)."""
    from repro_torch.lint import ir
    from repro_torch.lint.ir.snapshots import SNAPSHOT_ROOT, signature, write_snapshot

    t0 = time.perf_counter()
    entries = ir.default_entries(full=True, device="cuda")
    trace_s = time.perf_counter() - t0
    findings = ir.run_passes(entries, select={"I1", "I2", "I3", "I4"})
    cuda_dir = pathlib.Path(SNAPSHOT_ROOT) / "cuda"
    want_dir = cuda_dir if cuda_dir.is_dir() else pathlib.Path(SNAPSHOT_ROOT) / "cpu"
    out_root = ROOT / "chiprun_out" / "torch_ir_snapshots"
    differ = []
    for e in entries:
        write_snapshot(e, str(out_root))
        path = want_dir / (e.name.replace("/", "__") + ".json")
        want = json.loads(path.read_text())["hash"] if path.exists() else None
        if signature(e.trace)[0] != want:
            differ.append(e.name)
    rows = {"entries": len(entries), "trace_s": trace_s, "snapshots": str(want_dir.relative_to(ROOT)),
            "findings": [f.format() for f in findings], "hash_differs": differ,
            "ops": {e.name: len(e.trace.ops) for e in entries}}
    log(f"lint (a): {len(entries)} entries traced on fake cuda in {trace_s:.1f} s; I1-I4: "
        f"{len(findings)} finding(s); I5 against {rows['snapshots']}: {len(differ)} hash(es) "
        f"differ{(': ' + ', '.join(differ)) if differ else ''}")
    for f in findings:
        log(f"lint (a): {f.format()}")
    if findings:
        raise AssertionError(f"lint (a): the IR passes found {len(findings)} finding(s)")
    if differ:
        raise AssertionError(f"lint (a): {len(differ)} trace(s) differ from the committed "
                             f"snapshots (the card's set is under {out_root})")
    return rows, entries


def lint_real_entries(torch, counters, entries) -> dict:
    """Phase 19 (c): every registry entry run on real cuda tensors, once to
    warm up, then under the sync debug mode "error": no sync, and each
    kernel's launches equal the trace's."""
    from repro_torch.lint.ir import registry
    from repro_torch.roofline.hlo_stats import step_stats

    traced = {e.name: e for e in entries}
    launched: dict = {}
    rows = {}
    with registry.pinned_trace_env():
        cases = [(name, fn, args) for name, fn, args, _ in
                 registry.mpgemm_cases(full=True, device="cuda")]
        cases += [(name, fn, args) for name, _, fn, args, _ in
                  registry.engine_cases(full=True, device="cuda")]
        for name, fn, args in cases:
            fn(*args)                                   # warm-up: plans, workspaces, constants
            torch.cuda.synchronize()
            for f in counters.values():
                f.launches = 0
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            got = {n: f.launches for n, f in counters.items() if f.launches}
            want = step_stats(traced[name].trace).launches
            if got != want:
                raise AssertionError(f"lint (c): {name}: launches {got}, the trace's {want}")
            rows[name] = got
            for n, c in got.items():
                launched[n] = launched.get(n, 0) + c
    for f in counters.values():
        f.launches = 0
    log(f"lint (c): {len(cases)} entries run on the card under sync debug mode \"error\": no "
        f"sync; launches = the traces' in each; kernels launched {launched}")
    return {"entries": rows, "launched": launched}


def lint_guard(torch, model, cfg, prompts) -> dict:
    """Phase 19 (d): the steady-state guard over an engine on phase 18's
    model: armed after warm-up, `LINT_TICKS` mixed ticks grow nothing; one
    tick at a new N (an engine at another chunk) grows the plans."""
    import numpy as np

    from repro_torch.lint import CompileGuard, guard_entries
    from repro_torch.serve import Engine, Request
    from repro_torch.spec import SpecConfig

    rng = np.random.default_rng(19)
    long_prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(100, 200))).astype(np.int32)
                    for _ in range(16)]

    def engine(chunk):
        return Engine(model, cfg, max_slots=4, max_len=256, prefill_chunk=chunk,
                      spec=SpecConfig(k=LINT_SPEC_K, drafter="ngram"), device="cuda")

    eng = engine(LINT_CHUNK)
    queue = [Request(rid=i, prompt=p, max_new_tokens=12) for i, p in enumerate(long_prompts)]

    def tick():
        while queue and eng.add(queue[0]):
            queue.pop(0)
        kinds = (bool(eng.prefilling), bool(eng.active.any()))
        eng.step()
        return kinds

    guard = CompileGuard(guard_entries(eng))
    # warm up to the second tick with a chunk and a spec step: the first
    # makes each step's eager call, the second its graph capture
    warm, both = 0, 0
    while both < 2:
        warm += 1
        both += tick() == (True, True)
        if warm > 16:
            raise AssertionError("lint (d): no two warm-up ticks ran a chunk step and a spec step")
    torch.cuda.synchronize()
    base = guard.arm()
    kinds = [tick() for _ in range(LINT_TICKS)]
    torch.cuda.synchronize()
    grew = guard.new_compiles()
    guard.assert_steady(f"{LINT_TICKS} steady-state ticks")
    other = engine(LINT_NEW_CHUNK)
    other.add(Request(rid=99, prompt=long_prompts[0], max_new_tokens=4))
    other.step()
    torch.cuda.synchronize()
    control = guard.new_compiles()
    drop_graphs(eng)
    drop_graphs(other)
    if not control:
        raise AssertionError("lint (d): a tick at a new N grew nothing: the guard is blind")
    row = {"warmup_ticks": warm, "ticks": LINT_TICKS, "baseline": base, "steady_growth": grew,
           "tick_kinds": {"chunk": sum(k[0] for k in kinds), "decode_or_spec": sum(k[1] for k in kinds)},
           "control_growth": control}
    log(f"lint (d): guard armed after {warm} warm-up tick(s) at {base}; {LINT_TICKS} ticks "
        f"({row['tick_kinds']['chunk']} with a chunk step, {row['tick_kinds']['decode_or_spec']} "
        f"with a spec step) grew nothing; one tick at chunk {LINT_NEW_CHUNK} grew {control}")
    return row


def lint_sanitized_decode(torch, model, cfg) -> dict:
    """Phase 19 (e): one full-width decode step under the sanitizers gives
    the tokens of the same step without them."""
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.lint import enable_sanitizers, restore_sanitizers
    from repro_torch.models import init_cache

    cdt = getattr(torch, cfg.dtype)
    decode = make_decode_step(cfg)
    tok = torch.randint(0, cfg.vocab, (4, 1), dtype=torch.int32, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(19))
    plain, _ = decode(model, init_cache(cfg, 4, 256, dtype=cdt, device="cuda"), tok)
    cache = init_cache(cfg, 4, 256, dtype=cdt, device="cuda")
    t0 = time.perf_counter()
    prev = enable_sanitizers()
    try:
        sanitized, _ = decode(model, cache, tok)
    finally:
        restore_sanitizers(prev)
    seconds = time.perf_counter() - t0
    if not torch.equal(plain, sanitized):
        raise AssertionError(f"lint (e): sanitized tokens {sanitized.tolist()} differ from "
                             f"{plain.tolist()}")
    log(f"lint (e): a full-width decode step under the sanitizers ran clean in {seconds:.2f} s "
        f"(tokens {sanitized.tolist()}, equal to the step without them)")
    return {"seconds": seconds, "tokens": sanitized.tolist()}


def check_lint(torch, counters, prompts, steps_ctx) -> dict:
    """Phase 19: `repro_torch.lint` on the card, (a)-(e) (module docstring),
    on phase 18's model and traces."""
    from repro_torch.lint import ir

    t0 = time.perf_counter()
    out = {}
    out["registry"], entries = lint_registry(torch)
    steps = [ir.IREntry(name=f"steps/{n}", trace=t, kind="step", device="cuda")
             for n, t in steps_ctx["traces"].items()]
    findings = ir.run_passes(steps, select={"I1", "I2", "I3", "I4"})
    out["steps"] = {"entries": [e.name for e in steps], "ops": [len(e.trace.ops) for e in steps],
                    "findings": [f.format() for f in findings]}
    log(f"lint (b): phase 18's traces {out['steps']['entries']} ({out['steps']['ops']} ops) "
        f"through I1-I4: {len(findings)} finding(s)")
    if findings:
        raise AssertionError(f"lint (b): {[f.format() for f in findings]}")
    out["real"] = lint_real_entries(torch, counters, entries)
    out["guard"] = lint_guard(torch, steps_ctx["model"], steps_ctx["cfg"], prompts)
    out["sanitized"] = lint_sanitized_decode(torch, steps_ctx["model"], steps_ctx["cfg"])
    for fn in counters.values():
        fn.launches = 0
    out["seconds"] = time.perf_counter() - t0
    log(f"lint: phase 19 took {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# Phase 22: graphed serving held to eager serving
# --------------------------------------------------------------------------
def resident_bytes(torch) -> int:
    """Device bytes allocated once the collector has run, net of the split-K
    workspaces (current and retired: process-wide, grown by whichever step
    first needs more, and kept for the graphs captured on them)."""
    from repro_torch.kernels import _splitk

    gc.collect()
    torch.cuda.synchronize()
    pairs = list(_splitk._WORKSPACE.values()) + list(_splitk._RETIRED)
    return torch.cuda.memory_allocated() - sum(
        t.numel() * t.element_size() for pair in pairs for t in pair)


def capture_guard(graphs, names):
    """A `CompileGuard` over the captures alone of `names` (the plans may
    grow at an eager admission's new prompt length, which is no capture)."""
    from repro_torch.lint import CompileGuard, Probe

    return CompileGuard({f"capture.{n}": Probe(lambda n=n: graphs.captures[n]) for n in names})


def _graph_serve(torch, model, cfg, counters, prompts, warm, *, graphed, temperature, max_len,
                 **kw) -> dict:
    from repro_torch.serve import ContinuousBatchingScheduler, Engine, Request

    eng = Engine(model, cfg, max_slots=4, max_len=max_len, temperature=temperature,
                 seed=GRAPH_SEED, device="cuda", cuda_graphs=graphed, **kw)
    sched = ContinuousBatchingScheduler(eng)
    sched.submit([Request(rid=-1 - i, prompt=p, max_new_tokens=GRAPH_WARM_NEW)
                  for i, p in enumerate(warm)])
    sched.run_to_completion()
    warm_captures = dict(eng.graphs.captures)
    eng.reset_stats()
    guard = capture_guard(eng.graphs, eng.step_entries())
    guard.arm()
    ticks, decode_s = [], [0.0]
    decode_once = eng.decode_once

    def timed_decode():
        t0 = time.perf_counter()
        out = decode_once()     # ends in a host sync: the sampled tokens read back
        decode_s[0] += time.perf_counter() - t0
        return out

    eng.decode_once = timed_decode
    replays0 = sum(eng.graphs.replays.values())
    reqs = [Request(rid=i, prompt=p, max_new_tokens=GRAPH_NEW) for i, p in enumerate(prompts)]
    for fn in counters.values():
        fn.launches = 0
    sched = ContinuousBatchingScheduler(eng)
    tick = sched.tick

    def counted_tick():         # admissions, then one engine step
        before = sum(fn.launches for fn in counters.values())
        tick()
        ticks.append(sum(fn.launches for fn in counters.values()) - before)
        tick_marker(torch)

    sched.tick = counted_tick
    with syncs_raise(torch), device_trace(torch) if graphed else contextlib.nullcontext() as prof:
        sched.submit(reqs)
        stats = sched.run_to_completion()
    if stats.completed != len(reqs):
        raise AssertionError(f"{stats.completed}/{len(reqs)} requests completed")
    launches = {nm: fn.launches for nm, fn in counters.items()}
    device_launches = device_ticks = None
    if graphed:
        device_launches, device_ticks = traced_launches(prof, counters, ticks=len(ticks))
        held_to_trace("graphs", launches, device_launches)
        held_to_trace("graphs, per tick", ticks, device_ticks)
    return {"tokens": [list(map(int, r.generated)) for r in reqs],
            "launches": launches,
            "device_launches": device_launches, "device_tick_launches": device_ticks,
            "tick_launches": ticks, "captures_after_warmup": guard.new_compiles(),
            "warmup_captures": warm_captures,
            "replays": sum(eng.graphs.replays.values()) - replays0,
            "decode_tok_s": stats.decode_tokens / decode_s[0] if decode_s[0] else None,
            "decode_step_ms": decode_s[0] * 1e3 / stats.decode_steps if stats.decode_steps
            else None,
            "decode_steps": stats.decode_steps, "chunk_steps": stats.chunk_steps,
            "wall_s": stats.wall_s}


@trace_attempts
def graph_serve(torch, model, cfg, counters, prompts, warm, **kw) -> dict:
    """Phase 22, one serving run: warm-up requests (each step key's eager
    call and its capture), then `prompts` (4 slots, GRAPH_NEW new tokens
    each) with the counts zeroed, the captures guarded, every input upload
    and replay under the sync debug mode's "error" (`syncs_raise`), and
    the device traced alone with a marker after each scheduler tick
    (admissions and one engine step: the launches per tick counted on the
    device; the rates are taken with the trace on); then the engine dropped and the device memory read against its
    value before the engine was built."""
    base = resident_bytes(torch)
    row = _graph_serve(torch, model, cfg, counters, prompts, warm, **kw)
    row["memory_delta_bytes"] = resident_bytes(torch) - base
    return row


def graph_checks(label: str, eager: dict, graphed: dict) -> None:
    """The graphed run against the eager one: the same tokens; the same
    launches tick by tick, the graphed run's as its device trace counts
    them (`graph_serve` holds them to its wrappers' counts) and the eager
    run's as its wrappers count them, each a launch made on the host;
    replays that made no capture after the warm-up; the memory back to its
    baseline once each engine is dropped."""
    bad = []
    if graphed["tokens"] != eager["tokens"]:
        bad.append("tokens differ")
    if graphed["device_tick_launches"] != eager["tick_launches"] or \
            graphed["device_launches"] != eager["launches"]:
        bad.append(f"launches per tick {graphed['device_tick_launches']} graphed (device "
                   f"trace), {eager['tick_launches']} eager (wrappers)")
    if graphed["captures_after_warmup"] or not graphed["replays"] or eager["replays"]:
        bad.append(f"captures after warm-up {graphed['captures_after_warmup']}, replays "
                   f"{graphed['replays']} (eager {eager['replays']})")
    if graphed["memory_delta_bytes"] or eager["memory_delta_bytes"]:
        bad.append(f"device memory after the drop {graphed['memory_delta_bytes']} bytes "
                   f"(eager {eager['memory_delta_bytes']}) off its baseline")
    if bad:
        raise AssertionError(f"graphs {label}: " + "; ".join(bad))


def graph_compare(torch, model, cfg, counters, label: str, prompts, warm, *, max_len=256,
                  spec=None, paged_kv=None, prefill_chunk=0, profiled=True) -> dict:
    """Phase 22 for one model and mode: greedy and seeded GRAPH_TEMPERATURE
    serving, eager then graphed (`graph_serve`, `graph_checks`), and, where
    `profiled`, one decode step of 4 full slots profiled each way
    (`profile_decode`)."""
    kw = dict(max_len=max_len, spec=spec, paged_kv=paged_kv, prefill_chunk=prefill_chunk)
    out = {}
    for temp in (0.0, GRAPH_TEMPERATURE):
        runs = {mode: graph_serve(torch, model, cfg, counters, prompts, warm,
                                  graphed=mode == "graphed", temperature=temp, **kw)
                for mode in ("eager", "graphed")}
        graph_checks(f"{label} t={temp}", runs["eager"], runs["graphed"])
        out[f"t{temp}"] = {m: {k: v for k, v in r.items() if k != "tokens"}
                           for m, r in runs.items()}
    short = [p[:64] for p in prompts]
    for mode in ("eager", "graphed") if profiled else ():
        out[f"profile_{mode}"] = profile_decode(torch, model, cfg, short, spec=spec,
                                                paged=paged_kv, op_names=(),
                                                cuda_graphs=mode == "graphed")
    return graph_row(label, out)


def graph_row(label: str, out: dict) -> dict:
    """The summary of one phase-22 comparison, logged: tok/s, step wall
    and busy share graphed and eager."""
    g, e = out["t0.0"]["graphed"], out["t0.0"]["eager"]
    none = {"wall_ms_per_step": None, "device_ms_per_step": None, "device_busy_share": None}
    out["summary"] = {mode: {"decode_tok_s": r["decode_tok_s"], "decode_step_ms": r["decode_step_ms"],
                             "profiled_step_wall_ms": out.get(f"profile_{mode}", none)["wall_ms_per_step"],
                             "profiled_step_device_ms":
                                 out.get(f"profile_{mode}", none)["device_ms_per_step"],
                             "busy_share": out.get(f"profile_{mode}", none)["device_busy_share"]}
                      for mode, r in (("graphed", g), ("eager", e))}
    sm = out["summary"]

    def share(v):
        return "not measured" if v is None else f"{100 * v:.1f}%"

    def ms(v):
        return "not measured" if v is None else f"{v:.2f}"

    temps = "greedy" + (f" and t={GRAPH_TEMPERATURE}" if f"t{GRAPH_TEMPERATURE}" in out else "")
    log(f"graphs {label}: {temps} tokens equal eager; launches per tick equal on the device "
        f"({len(g['tick_launches'])} ticks, {sum(g['device_tick_launches'])} kernel records, "
        f"the wrappers' counts); {g['replays']} replays, no capture after warm-up "
        f"({g['warmup_captures']}), no host sync in an upload or replay, memory back to baseline; "
        f"decode {sm['graphed']['decode_tok_s']:.1f} vs {sm['eager']['decode_tok_s']:.1f} tok/s, "
        f"step {sm['graphed']['decode_step_ms']:.2f} vs {sm['eager']['decode_step_ms']:.2f} ms, "
        f"profiled step {ms(sm['graphed']['profiled_step_wall_ms'])} vs "
        f"{ms(sm['eager']['profiled_step_wall_ms'])} ms wall "
        f"({ms(sm['graphed']['profiled_step_device_ms'])} vs "
        f"{ms(sm['eager']['profiled_step_device_ms'])} ms device), busy "
        f"{share(sm['graphed']['busy_share'])} vs {share(sm['eager']['busy_share'])} "
        "(graphed vs eager)")
    return out


def graph_prompts(cfg, seed: int, lens=(16, 65)) -> tuple:
    """Phase 22's 4 prompts (lengths in `lens`) and 2 warm-up prompts
    (GRAPH_WARM_LEN: three chunks of 64, and one)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(*lens))).astype(np.int32)
               for _ in range(4)]
    warm = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in GRAPH_WARM_LEN]
    return prompts, warm


def check_graphs_smollm(torch, model, cfg, counters) -> dict:
    """Phase 22 on smollm-360m (phase 4's model): decode, chunk 64, chain k
    4, tree (2, 2), paged (page 16) with chunk 64 and chain k 4."""
    from repro_torch.serve import PagedKVConfig
    from repro_torch.serve.graphs import StepGraphs
    from repro_torch.spec import SpecConfig

    # positive control: a host sync planted in an upload fails the guard
    def synced(self, name, src):
        return torch.ones(1, device="cuda").item()

    with planted(StepGraphs, "upload", synced), syncs_raise(torch):
        try:
            StepGraphs("cuda").upload("x", None)
        except RuntimeError:
            log("graphs: a host sync planted in an upload raises under the guard")
        else:
            raise AssertionError("syncs_raise does not see a planted host sync")
    prompts, warm = graph_prompts(cfg, 22)
    modes = {"decode": {}, "chunked": dict(prefill_chunk=PREFILL_CHUNK),
             "chain": dict(spec=SpecConfig(k=SPEC_K)),
             "tree": dict(spec=SpecConfig(k=SPEC_K, tree=SPEC_TREE)),
             "paged": dict(paged_kv=PagedKVConfig(page_size=PAGE_SIZE),
                           prefill_chunk=PREFILL_CHUNK, spec=SpecConfig(k=SPEC_K))}
    # one decode step profiled each way: the decode mode's (the other modes'
    # profiles would repeat its step and cost ~4 s each)
    return {name: graph_compare(torch, model, cfg, counters, f"smollm {name}", prompts, warm,
                                profiled=name == "decode", **kw)
            for name, kw in modes.items()}


@trace_attempts
def _encdec_graph_run(torch, model, cfg, counters, frames, prompts, graphed: bool) -> dict:
    from torch.profiler import profile

    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import init_cache
    from repro_torch.serve.graphs import StepGraphs

    graphs = StepGraphs("cuda", enabled=graphed)
    pre, dec = make_prefill_step(cfg), make_decode_step(cfg, graphs=graphs)
    b, s_enc = frames.shape[:2]
    with ops.dispatch_override(impl="decode", fusion="fused"):
        nt, cache = pre(model, init_cache(cfg, b, ENCDEC_MAX_LEN, enc_len=s_enc, device="cuda"),
                        {"tokens": prompts, "frames": frames})
        toks = [nt]
        for _ in range(2):                      # the eager call, the capture
            nt, cache = dec(model, cache, nt[:, None])
            toks.append(nt)
        guard = capture_guard(graphs, ("decode",))
        guard.arm()
        ticks = []
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        with syncs_raise(torch), \
                device_trace(torch) if graphed else contextlib.nullcontext() as traced:
            t0 = time.perf_counter()
            for _ in range(GRAPH_ENCDEC_STEPS):
                before = sum(fn.launches for fn in counters.values())
                nt, cache = dec(model, cache, nt[:, None])
                ticks.append(sum(fn.launches for fn in counters.values()) - before)
                tick_marker(torch)
                toks.append(nt)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = {nm: fn.launches for nm, fn in counters.items()}
        device_launches = device_ticks = None
        if graphed:
            device_launches, device_ticks = traced_launches(traced, counters, ticks=len(ticks))
            held_to_trace("whisper graphs", launches, device_launches)
            held_to_trace("whisper graphs, per tick", ticks, device_ticks)
        with profile(activities=device_only()) as prof:
            t1 = time.perf_counter()
            for _ in range(2):
                nt, cache = dec(model, cache, nt[:, None])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3 / 2
    dev_ms = sum(ms for ms, _ in device_time_by_kernel(prof.key_averages(), 2))
    return {"tokens": torch.stack(toks, 1).tolist(), "tick_launches": ticks,
            "launches": launches,
            "device_launches": device_launches, "device_tick_launches": device_ticks,
            "captures_after_warmup": guard.new_compiles(),
            "warmup_captures": dict(graphs.captures), "replays": graphs.replays["decode"],
            "decode_tok_s": b * GRAPH_ENCDEC_STEPS / dt,
            "decode_step_ms": dt * 1e3 / GRAPH_ENCDEC_STEPS,
            "profile": {"wall_ms_per_step": wall_ms, "device_ms_per_step": dev_ms,
                        "device_busy_share": dev_ms / wall_ms if dev_ms else None}}


def check_graphs_encdec(torch, model, cfg, counters) -> dict:
    """Phase 22 on whisper-medium (phase 15's model): `launch.steps`' greedy
    decode step (the cross K/V read from the cache) through a `StepGraphs`
    against the same step eager, after one prefill step of phase 15's 4
    requests: tokens, launches per step, no capture after the warm-up, no
    host sync in a replay, memory back to its baseline. Greedy only: the
    steps emit argmax tokens (the engine's sampling is not theirs)."""
    frames, prompts = encdec_inputs(torch, cfg, ENCDEC_BATCH, ENCDEC_FRAMES, seed=15)
    runs = {}
    for mode in ("eager", "graphed"):
        base = resident_bytes(torch)
        runs[mode] = _encdec_graph_run(torch, model, cfg, counters, frames, prompts,
                                       graphed=mode == "graphed")
        runs[mode]["memory_delta_bytes"] = resident_bytes(torch) - base
    graph_checks("whisper decode", runs["eager"], runs["graphed"])
    out = {"t0.0": {m: {k: v for k, v in r.items() if k not in ("tokens", "profile")}
                    for m, r in runs.items()}}
    for mode, r in runs.items():
        out[f"profile_{mode}"] = r["profile"]
    return graph_row("whisper decode", out)


def graph_report(card: str, rows: dict) -> dict:
    """Phase 22's table, logged once at the end beside the card's name and
    power limit: per model and mode, decode tok/s, decode-step wall ms and
    busy share, graphed and eager."""
    log(f"graphs: phase 22 on {card}: model/mode | decode tok/s graphed, eager | step ms "
        "graphed, eager | profiled wall ms graphed, eager | busy graphed, eager")
    table = {}
    for label, out in rows.items():
        sm = out["summary"]
        table[label] = sm
        busy = ["not measured" if sm[m]["busy_share"] is None else f"{100 * sm[m]['busy_share']:.1f}%"
                for m in ("graphed", "eager")]
        log(f"graphs:   {label} | {sm['graphed']['decode_tok_s']:.1f}, {sm['eager']['decode_tok_s']:.1f} "
            f"| {sm['graphed']['decode_step_ms']:.2f}, {sm['eager']['decode_step_ms']:.2f} | "
            + ", ".join("not measured" if sm[m]["profiled_step_wall_ms"] is None
                        else f"{sm[m]['profiled_step_wall_ms']:.2f}" for m in ("graphed", "eager"))
            + f" | {busy[0]}, {busy[1]}")
    return {"card": card, "summary": table, "rows": rows}


def launch_counters() -> dict:
    """{name: kernel wrapper} of every kernel (`kernels.LAUNCH_COUNTERS`):
    each wrapper counts its launches in its `launches` attribute."""
    from repro_torch.kernels import LAUNCH_COUNTERS

    return dict(LAUNCH_COUNTERS)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import numpy as np

        from repro_torch.configs import get_config
        from repro_torch.kernels import _build, autotune
        from repro_torch.kernels import ternary_decode_gemm as tdg
        from repro_torch.models import init_cache, init_lm, pack_params, prefill
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    # phases 3-16 launch the heuristic plans: an empty plan cache under
    # build/ (never the user's), and no inline tuning
    shutil.rmtree(PLANS_DIR, ignore_errors=True)
    os.environ.pop(autotune.TUNE_ENV, None)
    autotune.reset_default_cache(str(PLANS_DIR / "cold.json"))
    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(name: str) -> None:
        nonlocal t_phase
        phase_s[name] = time.perf_counter() - t_phase
        log(f"phase {name} took {phase_s[name]:.1f} s")
        t_phase = time.perf_counter()

    # 1. device
    card = device_line()
    log(f"card: {card}")
    kind = torch.cuda.get_device_name(0)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"build: {line.strip()}")
    for template, tag in (("vector-LUT", "vlut_kernel"), ("decode", "decode_kernel")):
        for entry, r in kernel_registers(_build, tag).items():
            log(f"build: {template} instantiation {entry}: {r.get('registers')} registers, "
                f"{r.get('spill_bytes')} spill bytes")
    for entry, r in flash_registers(_build).items():
        log(f"build: flash instantiation {entry}: {r.get('registers')} registers, "
            f"{r.get('spill_bytes')} spill bytes, {r.get('smem_static')} static shared bytes")
    lut_grouped = grouped_build(torch, _build, "lookup")
    decode_grouped = grouped_build(torch, _build, "decode")

    # model for phases 3 to 5
    cfg = get_config("smollm-360m")
    t0 = time.perf_counter()
    model = pack_params(init_lm(cfg, torch.Generator(device="cuda").manual_seed(0)), cfg)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {cfg.dtype}, {cfg.n_layers} layers, packed in {time.perf_counter() - t0:.1f} s")

    phase_done("1-2 and the model")

    # 3. kernels
    max_err, per_n, weights, fused_traps = check_kernels(torch, model, cfg)
    phase_done("3")

    # 4. serve
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(16, 65))).astype(np.int32)
               for _ in range(8)]
    counters = launch_counters()
    runs = {}
    for name, meta in KERNEL_META.items():
        if meta["fusion"] != "fused":
            continue
        r = serve(torch, model, cfg, meta["impl"], prompts, counters)
        want = {nm: (224 * r["forwards"] if nm == name else 0) for nm in counters}
        if r["launches"] != want:
            raise AssertionError(f"impl={meta['impl']}: launches {r['launches']}, expected {want}")
        runs[meta["impl"]] = r
        log(f"serve: impl={meta['impl']} forwards={r['forwards']} launches={r['launches']} "
            f"prefill_tok_s={r['prefill_tok_s']:.1f} decode_tok_s={r['decode_tok_s']:.1f} "
            f"ttft_p50_ms={r['ttft_p50_ms']:.2f} wall_s={r['wall_s']:.3f}")
    if runs["decode"]["tokens"] != runs["lookup"]["tokens"]:
        raise AssertionError("impl=decode and impl=lookup emitted different greedy tokens")

    # the card against the CPU (plain path) on one prompt
    prompt = torch.from_numpy(prompts[0][None, :])
    logits_gpu, _ = prefill(model, prompt.cuda(), init_cache(cfg, 1, 256, device="cuda"), cfg)
    cpu_model = copy.deepcopy(model).to("cpu")
    logits_cpu, _ = prefill(cpu_model, prompt, init_cache(cfg, 1, 256, device="cpu"), cfg)
    logits_gpu = logits_gpu.float().cpu()
    if logits_gpu.shape != (1, cfg.vocab) or not torch.isfinite(logits_gpu).all():
        raise AssertionError(f"bad logits: shape {tuple(logits_gpu.shape)}")
    diff = (logits_gpu - logits_cpu).abs().max().item()
    scale = logits_cpu.abs().max().item()
    log(f"serve: card vs cpu prefill logits: max |diff| {diff:.5f}, max |logit| {scale:.4f}, "
        f"argmax {int(logits_gpu.argmax())} vs {int(logits_cpu.argmax())}")
    if diff > LOGIT_RTOL * scale:
        raise AssertionError(f"card and cpu logits differ by {diff} > {LOGIT_RTOL} * {scale}")

    prof = profile_decode(torch, model, cfg, prompts, cuda_graphs=False)
    log(f"profile: eager decode step (4 slots) wall {prof['wall_ms_per_step']:.3f} ms, device busy "
        f"{prof['device_ms_per_step']:.3f} ms"
        + (f" ({100 * prof['device_busy_share']:.1f}%)" if prof["device_busy_share"] else
           " (the profiler saw no device time: not measured)"))
    for name, ms in prof["top_kernels_ms_per_step"]:
        log(f"profile:   {ms:8.4f} ms  {name}")

    r = runs["decode"]
    log(f"serve: prefill_tok_s={r['prefill_tok_s']:.1f} decode_tok_s={r['decode_tok_s']:.1f} "
        f"ttft_p50_ms={r['ttft_p50_ms']:.2f} wall_s={r['wall_s']:.3f}")

    phase_done("4")

    # 5. unfused
    unfused = check_unfused(torch, model, cfg, weights, prompts, counters, runs, per_n)
    phase_done("5")

    # 8. multi-token serving (on phase 4's model, before it is freed)
    multi, multi_tokens = check_multi_token(torch, model, cfg, weights, prompts, counters,
                                            runs["decode"]["tokens"])
    phase_done("8")

    # 9. paged KV cache (on phase 4's model, after phase 8)
    paged, paged_tokens = check_paged(torch, model, cfg, prompts, counters,
                                      runs["decode"]["tokens"], multi_tokens, prof)
    phase_done("9")

    # 14. observability (on phase 4's model, after phase 9)
    observed = check_obs(torch, model, cfg, prompts, counters, runs["decode"]["tokens"],
                         multi_tokens, paged, paged_tokens)
    phase_done("14")

    # 22. graphed serving against eager serving, on each model while it is
    # loaded: smollm-360m here, then deepseek-v3 (phase 11), mamba2 (12),
    # gemma3 (13), whisper (15) and command-r (21); reported at the end
    graph_rows = {f"smollm {k}": v for k, v in
                  check_graphs_smollm(torch, model, cfg, counters).items()}
    phase_done("22 smollm")

    del model, cpu_model, weights
    torch.cuda.empty_cache()

    # 10. MoE FFN: llama4-scout at full width (after phase 9; its model is
    # freed before phase 11)
    moe = check_moe(torch, counters)
    phase_done("10")

    # 11. MLA: deepseek-v3-671b at full width, depth cut (its model is freed
    # before phases 6 and 7)
    mla = check_mla(torch, counters, graph_rows)
    phase_done("11")

    # 12. SSM: mamba2-1.3b at full width and depth; 13. windowed GQA:
    # gemma3-1b at full width and depth (each model freed after its phase)
    checked = set()          # launch shapes held to their plain versions in phases 12-21
    ssm = check_ssm(torch, counters, checked, graph_rows)
    phase_done("12")
    windowed = check_windowed(torch, counters, checked, graph_rows)
    phase_done("13")

    # 15. the encoder-decoder: whisper-medium at full width and depth, its
    # serving steps and its QAT training (its model freed before phase 6)
    encdec = check_encdec(torch, counters, graph_rows)
    phase_done("15")

    # 20. the hybrid jamba, one period at published widths; 21. the three
    # other dense GQA archs at full size (each model freed after its run)
    hybrid = check_hybrid(torch, counters, checked)
    phase_done("20")
    dense_archs = check_dense_archs(torch, counters, checked, graph_rows)
    phase_done("21")

    # 6. flash
    flash = check_flash(torch)
    phase_done("6")

    # 7. train
    trained = train(torch, counters)
    phase_done("7")

    # 16. dist: the xla impl and the world-1 sharded trainer (after phase 7)
    dist_out = check_dist(torch, counters, unfused, trained)
    phase_done("16")

    # 18. the step statistics: smollm-360m's steps traced on fake tensors
    # against the same steps on the card (after phase 7, whose profile of
    # the training step it reads)
    steps, steps_ctx = check_steps(torch, counters, prompts, trained)
    phase_done("18")

    # 19. lint: the IR registry on fake cuda tensors, phase 18's traces, the
    # registry's entries run under the sync debug mode, the steady-state
    # guard and the sanitizers (on phase 18's model, before phase 17)
    linted = check_lint(torch, counters, prompts, steps_ctx)
    del steps_ctx
    torch.cuda.empty_cache()
    phase_done("19")

    # 17. the measured launch-plan choice (after every other phase: its
    # plans would change what phases 3-16 launch)
    tuned = check_autotune(torch, counters, prompts, runs, encdec)
    phase_done("17")

    graphed = graph_report(card, graph_rows)

    def kernel_row(name, meta):
        if meta["fusion"] == "fused":
            row, launches, err = per_n[DECODE_N], runs[meta["impl"]]["device_launches"], max_err
            library_ms = row["library_ms"]
        else:
            row = unfused["per_tokens"][DECODE_N]
            launches, err = unfused["serve"][meta["impl"]]["device_launches"], unfused["max_abs_err"]
            library_ms = row["library"]["ms"]
        err = max([err[name]] + [r["kernels"]["max_abs_err"][name] for r in (
            ssm, windowed, encdec, hybrid, *dense_archs.values())])
        return {"name": name, "route": "cuda", "source": meta["source"],
                "replaces": meta["replaces"], "launches": launches[name],
                "max_abs_err": float(err), "ms": row[name]["ms"],
                "plain_ms": row[name]["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": library_ms}

    def grouped_row(name, meta):
        layer = moe["kernels"]["per_tokens"][MOE_TIME_TOKENS[0]]["layer"]
        return {"name": name, "route": "cuda", "source": meta["source"],
                "replaces": meta["replaces"],
                "launches": moe["serve"][meta["impl"]]["device_launches"][name],
                "max_abs_err": float(max(moe["kernels"]["max_abs_err"][name],
                                         hybrid["grouped"]["max_abs_err"][name])),
                "ms": layer[name]["ms"], "plain_ms": layer[name]["plain_ms"],
                "bound_ms": layer["bound_ms"], "bound_by": layer["bound_by"],
                "library_ms": layer["library_ms"]}

    def grouped_int_row(name, meta):
        layer = mla["kernels"]["per_layer"]["int"]
        err = max(moe["kernels"]["max_abs_err"][name], mla["kernels"]["max_abs_err"][name],
                  hybrid["grouped"]["max_abs_err"][name])
        return {"name": name, "route": "cuda", "source": meta["source"],
                "replaces": meta["replaces"],
                "launches": mla["serve"][f"unfused_{meta['impl']}"]["device_launches"][name],
                "max_abs_err": float(err), "ms": layer[name]["ms"],
                "plain_ms": layer[name]["plain_ms"], "bound_ms": layer["bound_ms"],
                "bound_by": layer["bound_by"], "library_ms": layer["library_ms"]}

    frow = flash["time"]
    kern_line = {"kernels": [
        kernel_row(name, meta) for name, meta in KERNEL_META.items()
    ] + [
        grouped_row(name, meta) for name, meta in GROUPED_META.items()
    ] + [
        grouped_int_row(name, meta) for name, meta in GROUPED_INT_META.items()
    ] + [
        {"name": "flash_attention", "route": "cuda", **FLASH_META,
         "launches": trained["launches"]["flash_attention"],
         "max_abs_err": max(flash["max_abs_err"], encdec["flash"]["max_abs_err"]),
         "ms": frow["ms"], "plain_ms": frow["plain_ms"], "bound_ms": frow["bound_ms"],
         "bound_by": frow["bound_by"], "library_ms": frow["library_ms"]},
    ]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "card": card, "kind": kind, "timing_unit": "mpGeMM: one forward, 224 BitLinear launches (unfused pipelines: 224 BitLinears); grouped mpGeMM: one llama4-scout MoE layer's 4 grouped launches at C = 4 rows per expert (plain_ms eager); grouped integer mpGeMM: one deepseek-v3 MoE layer's 6 grouped launches at C = 16 (plain_ms eager); compare: one call at (M, K) = (2560, 960); flash: one launch at the training shape; ms/plain_ms/library_ms device time (CUDA graph replay), eager_ms between events around eager launches",
        "per_tokens": per_n, "splitk_fused_traps": fused_traps,
        "decode_plans": {n: [plan_row(decode_plan_for(tdg, m, k // 5, n, 5)) for m, k in SHAPES]
                         for n in TOKENS},
        "lut_registers": {**kernel_registers(_build, "vlut_kernel"), **lut_grouped},
        "decode_registers": {**kernel_registers(_build, "decode_kernel"), **decode_grouped},
        "flash_registers": flash_registers(_build),
        "serve": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                                       for k, v in runs.items()},
        "unfused": {**unfused, "serve": {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
                                         for k, v in unfused["serve"].items()}},
        "logits_card_vs_cpu": {"max_abs_diff": diff, "max_abs_logit": scale},
        "decode_profile": prof,
        "multi_token": multi,
        "paged": paged,
        "obs": observed,
        "moe": moe, "mla": mla, "ssm": ssm, "windowed": windowed, "encdec": encdec,
        "hybrid": hybrid, "dense_archs": dense_archs,
        "flash": flash, "train": trained, "dist": dist_out, "autotune": tuned,
        "steps": steps, "lint": linted, "graphs": graphed,
        "phase_seconds": phase_s, "seconds": time.perf_counter() - t_start,
    }, indent=1))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kern_line))
    print(f"device: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
