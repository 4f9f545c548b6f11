"""Serving launcher: continuous batching over synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch ARCH \
      [--smoke] [--device cuda|cpu] [--mpgemm-impl decode|lookup] \
      [--spec-k N [--spec-adaptive | --spec-tree B1,B2,...]] \
      [--prefill-chunk N [--token-budget T]] \
      [--page-size P [--kv-pages N] [--offload-pages H]] \
      [--no-obs | [--stats-interval S] [--metrics-out M.json] [--trace-out T.json]]

--spec-k N turns on speculative decoding with the n-gram drafter (N draft
tokens per batched verify step); --spec-adaptive adapts each slot's draft
length to its acceptance, --spec-tree verifies a draft tree (top-B
candidates at each of the first depths) in one flattened pass.
--prefill-chunk N consumes prompts N tokens per tick in one batched mixed
prefill/decode step; --token-budget caps the real tokens per tick.
--page-size P serves from a paged KV cache of P-token pages with radix
prompt-prefix sharing; --kv-pages sizes its pool and --offload-pages its
host-RAM tier for cold prefix pages.

Observability (`repro_torch.obs`) is on by default (--no-obs turns it off):
the periodic stats line (--stats-interval S) and the summary's latency
columns read from the metrics registry, and --metrics-out / --trace-out
write the JSON metrics snapshot and a Perfetto-loadable trace at exit. The
trace holds one `mpgemm_dispatch` span per mpGeMM call (the steps run
eagerly); its duration is the host's cost of issuing the launches, not
their device time.

ARCH is any decoder-only architecture of `repro_torch.configs`:
smollm-360m, gemma3-1b, internlm2-1.8b, command-r-35b, chameleon-34b,
llama4-scout-17b-a16e, deepseek-v3-671b, mamba2-1.3b, jamba-1.5-large-398b.
The encoder-decoder whisper-medium is refused: the engine takes decoder-only
models, and its serving steps are `repro_torch.launch.steps`.
SSM layers (mamba2, jamba) and windowed layers (gemma3) serve whole prompts
only: the engine refuses speculation, chunked prefill and paging on them.

Weights are random, drawn from a seeded `torch.Generator` on the device and
packed a layer at a time (`init_lm(..., packed=True)`: llama4-scout's dense
weights would not fit the card). Prints one summary line (with the
speculative stats when --spec-k is given).
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_lm
from repro_torch.obs import ObsConfig, install
from repro_torch.serve import ContinuousBatchingScheduler, Engine, PagedKVConfig, Request
from repro_torch.spec import SpecConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mpgemm-impl", default="decode", choices=("decode", "lookup"))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding draft length (0 = off; n-gram "
                         "prompt-lookup drafter)")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="per-slot adaptive draft length from the running "
                         "acceptance rate (cold slots skip drafting)")
    ap.add_argument("--spec-tree", default="",
                    help="comma-separated branching factors (e.g. '2,2') for "
                         "tree-structured multi-candidate verification")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: consume prompts N tokens per tick in "
                         "one batched mixed prefill/decode step (0 = whole-prompt "
                         "admission prefill)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="cap on real tokens scheduled per chunked tick (0 = "
                         "unlimited; needs --prefill-chunk)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged KV: tokens per page (0 = dense slot cache); "
                         "enables radix prompt-prefix sharing")
    ap.add_argument("--kv-pages", type=int, default=0,
                    help="paged KV pool size incl. the null page "
                         "(0 = auto: slots*max_len/page_size + 1; "
                         "needs --page-size)")
    ap.add_argument("--offload-pages", type=int, default=0,
                    help="host-RAM offload tier capacity in pages for cold "
                         "prefix pages (0 = drop instead; needs --page-size)")
    ap.add_argument("--no-obs", action="store_true",
                    help="disable the observability layer (metrics + trace)")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="print a registry-backed stats line every S seconds "
                         "while serving (0 = off)")
    ap.add_argument("--metrics-out", default="",
                    help="write the JSON metrics snapshot here on exit")
    ap.add_argument("--trace-out", default="",
                    help="write the Perfetto trace_event JSON here on exit")
    args = ap.parse_args(argv)
    if (args.spec_adaptive or args.spec_tree) and not args.spec_k:
        ap.error("--spec-adaptive/--spec-tree require --spec-k N (N >= 1)")
    if args.token_budget and not args.prefill_chunk:
        ap.error("--token-budget requires --prefill-chunk N (N >= 1)")
    if (args.kv_pages or args.offload_pages) and not args.page_size:
        ap.error("--kv-pages/--offload-pages require --page-size N (N >= 1)")
    if args.spec_adaptive and args.spec_tree:
        ap.error("--spec-tree and --spec-adaptive are mutually exclusive")
    if args.no_obs and (args.stats_interval or args.metrics_out or args.trace_out):
        ap.error("--no-obs conflicts with --stats-interval/--metrics-out/--trace-out")

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        ap.error(f"--arch {args.arch} is an encoder-decoder: the continuous-batching engine "
                 "serves decoder-only models; serve it with the greedy prefill and decode "
                 "steps of repro_torch.launch.steps (make_prefill_step, make_decode_step)")
    device = resolve_device(args.device)
    model = init_lm(cfg, torch.Generator(device=device).manual_seed(args.seed), packed=True)
    spec = None
    if args.spec_k:
        tree = tuple(int(x) for x in args.spec_tree.split(",")) if args.spec_tree else None
        spec = SpecConfig(k=args.spec_k, adaptive_k=args.spec_adaptive, tree=tree)
    paged = None
    if args.page_size:
        paged = PagedKVConfig(page_size=args.page_size, n_pages=args.kv_pages,
                              host_offload_pages=args.offload_pages)
    eng = Engine(model, cfg, max_slots=args.slots, max_len=args.max_len,
                 temperature=args.temperature, seed=args.seed,
                 mpgemm_impl=args.mpgemm_impl, spec=spec,
                 prefill_chunk=args.prefill_chunk, token_budget=args.token_budget,
                 paged_kv=paged, device=device,
                 obs=None if args.no_obs else ObsConfig(metrics_out=args.metrics_out or None,
                                                        trace_out=args.trace_out or None))
    sched = ContinuousBatchingScheduler(eng)
    rng = np.random.default_rng(args.seed)
    sched.submit(
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    )
    obs = eng.obs
    t_serve = time.perf_counter()
    if args.stats_interval:
        # registry-backed periodic logging: tick by hand, report from the
        # metric objects (the gauges and counters on_tick syncs each tick)
        next_at = time.perf_counter() + args.stats_interval
        while sched.queue or eng.has_work:
            sched.tick()
            if time.perf_counter() >= next_at:
                print(f"[obs] {obs.stats_line()}", flush=True)
                next_at = time.perf_counter() + args.stats_interval
    stats = sched.run_to_completion()
    # the hand-ticked loop's work lands in this run's token counters, so its
    # wall time must land in the run's clock too
    stats.wall_s = time.perf_counter() - t_serve
    # latency columns from the registry's histograms when obs is on (p50 and
    # p95 interpolated from the bucket counts); without obs the median over
    # ServeStats' TTFTs. No TTFT at all: no column
    if obs.enabled and obs.h_ttft.count:
        lat = (f" ttft_p50_ms={1e3 * obs.h_ttft.percentile(0.5):.2f}"
               f" ttft_p95_ms={1e3 * obs.h_ttft.percentile(0.95):.2f}")
        if obs.h_tpot.count:
            lat += f" tpot_p50_ms={1e3 * obs.h_tpot.percentile(0.5):.2f}"
        if obs.s_eff_m.count:
            lat += f" eff_m={obs.s_eff_m.mean:.1f}"
    else:
        lat = f" ttft_median_ms={np.median(stats.ttft_s) * 1e3:.2f}" if stats.ttft_s else ""
    print(f"arch={cfg.name} device={device} impl={args.mpgemm_impl} "
          f"completed={stats.completed}/{args.requests} rejected={stats.rejected} "
          f"prefill_tok={stats.prefill_tokens} decode_tok={stats.decode_tokens} "
          f"wall_s={stats.wall_s:.3f} throughput_tok_s={stats.throughput_tok_s:.1f}"
          f"{lat} chunk_steps={stats.chunk_steps}")
    if paged is not None:
        pager = eng.pager
        print(f"paged: page_size={paged.page_size} pages={pager.total_pages} "
              f"free={pager.free_pages} shared={pager.shared_pages} "
              f"prefix_hit_tokens={stats.prefix_hit_tokens} "
              f"prefix_hit_requests={stats.prefix_hit_requests} "
              f"paged_out={pager.pages_paged_out} paged_in={pager.pages_paged_in}")
    if spec is not None:
        print(f"spec: k={spec.k} tree={spec.tree} adaptive={spec.adaptive_k} "
              f"steps={stats.spec_steps} drafted={stats.drafted_tokens} "
              f"accepted={stats.accepted_tokens} acceptance={stats.acceptance_rate:.3f} "
              f"tok_per_step={stats.decode_tokens_per_step:.3f} "
              f"nodes_per_step={stats.nodes_per_step:.2f} mean_k={stats.mean_draft_k:.2f} "
              f"skip_rate={stats.skip_rate:.3f}")
    for path in obs.finalize():
        print(f"wrote {path}")
    install(None)      # detach the kernel hook: main() may be called again
    return stats


if __name__ == "__main__":
    main()
