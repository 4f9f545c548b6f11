"""Serving launcher: continuous batching over synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      [--smoke] [--device cuda|cpu] [--mpgemm-impl decode|lookup] \
      [--spec-k N [--spec-adaptive | --spec-tree B1,B2,...]] \
      [--prefill-chunk N [--token-budget T]]

--spec-k N turns on speculative decoding with the n-gram drafter (N draft
tokens per batched verify step); --spec-adaptive adapts each slot's draft
length to its acceptance, --spec-tree verifies a draft tree (top-B
candidates at each of the first depths) in one flattened pass.
--prefill-chunk N consumes prompts N tokens per tick in one batched mixed
prefill/decode step; --token-budget caps the real tokens per tick.

Weights are random, drawn from a seeded `torch.Generator` on the device and
packed by `models.pack_params`. Prints one summary line (with the
speculative stats when --spec-k is given).
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_lm, pack_params
from repro_torch.serve import ContinuousBatchingScheduler, Engine, Request
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
    args = ap.parse_args(argv)
    if (args.spec_adaptive or args.spec_tree) and not args.spec_k:
        ap.error("--spec-adaptive/--spec-tree require --spec-k N (N >= 1)")
    if args.token_budget and not args.prefill_chunk:
        ap.error("--token-budget requires --prefill-chunk N (N >= 1)")
    if args.spec_adaptive and args.spec_tree:
        ap.error("--spec-tree and --spec-adaptive are mutually exclusive")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = pack_params(init_lm(cfg, torch.Generator(device=device).manual_seed(args.seed)), cfg)
    spec = None
    if args.spec_k:
        tree = tuple(int(x) for x in args.spec_tree.split(",")) if args.spec_tree else None
        spec = SpecConfig(k=args.spec_k, adaptive_k=args.spec_adaptive, tree=tree)
    eng = Engine(model, cfg, max_slots=args.slots, max_len=args.max_len,
                 temperature=args.temperature, seed=args.seed,
                 mpgemm_impl=args.mpgemm_impl, spec=spec,
                 prefill_chunk=args.prefill_chunk, token_budget=args.token_budget,
                 device=device)
    sched = ContinuousBatchingScheduler(eng)
    rng = np.random.default_rng(args.seed)
    sched.submit(
        Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    )
    stats = sched.run_to_completion()
    ttft = np.median(stats.ttft_s) * 1e3 if stats.ttft_s else float("nan")
    print(f"arch={cfg.name} device={device} impl={args.mpgemm_impl} "
          f"completed={stats.completed}/{args.requests} rejected={stats.rejected} "
          f"prefill_tok={stats.prefill_tokens} decode_tok={stats.decode_tokens} "
          f"wall_s={stats.wall_s:.3f} throughput_tok_s={stats.throughput_tok_s:.1f} "
          f"ttft_p50_ms={ttft:.2f} chunk_steps={stats.chunk_steps}")
    if spec is not None:
        print(f"spec: k={spec.k} tree={spec.tree} adaptive={spec.adaptive_k} "
              f"steps={stats.spec_steps} drafted={stats.drafted_tokens} "
              f"accepted={stats.accepted_tokens} acceptance={stats.acceptance_rate:.3f} "
              f"tok_per_step={stats.decode_tokens_per_step:.3f} "
              f"nodes_per_step={stats.nodes_per_step:.2f} mean_k={stats.mean_draft_k:.2f} "
              f"skip_rate={stats.skip_rate:.3f}")
    return stats


if __name__ == "__main__":
    main()
