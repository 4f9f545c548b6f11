"""Training launcher with bounded-restart supervision.

  PYTHONPATH=src python -m repro_torch.launch.train --arch ARCH \
      [--smoke] [--device cuda|cpu] --steps 200 --batch 8 --seq 128 \
      --ckpt-dir build/run1

ARCH is any architecture of `repro_torch.configs`; an encoder-decoder
(whisper-medium) trains on the JAX package's stub audio frames.
Weights are random, drawn from a seeded `torch.Generator` on the device.
The supervisor restarts the trainer from its last checkpoint on retryable
failures; SIGTERM checkpoints and exits. A run whose checkpoint directory
already holds its last step resumes there and has nothing left to do.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.dist.fault_tolerance import run_with_restarts
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train.trainer import DEFAULT_CKPT_DIR


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--no-int8-state", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=3)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    tc = TrainConfig(
        total_steps=args.steps,
        microbatches=args.microbatches,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir,
        grad_compression=args.grad_compression,
    )
    opt = AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 5),
        total_steps=args.steps, int8_state=not args.no_int8_state,
    )
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    def attempt(i: int):
        print(f"[supervisor] attempt {i}")
        trainer = Trainer(cfg, opt, tc, dc, install_signals=True, device=args.device)
        trainer.run()

    run_with_restarts(attempt, max_restarts=args.max_restarts)
    print("[supervisor] training complete")


if __name__ == "__main__":
    main()
