"""Serving launcher: continuous batching over synthetic requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      [--smoke] [--device cuda|cpu] [--mpgemm-impl decode|lookup]

Weights are random, drawn from a seeded `torch.Generator` on the device and
packed by `models.pack_params`. Prints one summary line.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import init_lm, pack_params
from repro_torch.serve import ContinuousBatchingScheduler, Engine, Request


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
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = pack_params(init_lm(cfg, torch.Generator(device=device).manual_seed(args.seed)), cfg)
    eng = Engine(model, cfg, max_slots=args.slots, max_len=args.max_len,
                 temperature=args.temperature, seed=args.seed,
                 mpgemm_impl=args.mpgemm_impl, device=device)
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
          f"ttft_p50_ms={ttft:.2f}")
    return stats


if __name__ == "__main__":
    main()
