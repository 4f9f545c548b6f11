"""Deterministic synthetic LM data pipeline (a copy of
`repro.data.pipeline`: numpy only, so batches are byte-identical to the JAX
package's for the same seed).

Sequences are drawn from a fixed random bigram chain (seeded by `data_seed`),
so models can genuinely learn (loss decreases below the unigram entropy) —
the end-to-end training example demonstrates real optimization, not noise.

Production posture:
  * host-sharded loading: each process materializes only its
    `global_batch / process_count` rows (`host_batch_slice`);
  * fully deterministic and *stateless per step*: batch(step) is a pure
    function of (seed, step), so restart-after-failure replays exactly;
  * checkpointable: `state_dict()` is just {step, seed} — restored by the
    trainer alongside the model state.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    branching: int = 4   # out-degree of the bigram chain (entropy = log b)


class SyntheticLM:
    def __init__(self, cfg: DataConfig, process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        assert cfg.global_batch % process_count == 0
        self.host_batch = cfg.global_batch // process_count
        self.step = 0
        # fixed bigram transition table: vocab x branching successor ids
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(
            0, cfg.vocab, size=(cfg.vocab, cfg.branching), dtype=np.int32
        )

    # -- checkpointing ------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def load_state_dict(self, d: dict) -> None:
        assert d["seed"] == self.cfg.seed, "data seed changed across restore"
        self.step = int(d["step"])

    # -- batch generation ----------------------------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step) — replay-exact across restarts."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, self.process_index))
        b, s = self.host_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, size=b)
        choices = rng.integers(0, cfg.branching, size=(b, s))
        for t in range(s):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __next__(self) -> dict[str, np.ndarray]:
        batch = self.batch_at(self.step)
        self.step += 1
        return batch

    def __iter__(self):
        return self


def host_batch_slice(global_batch: int, process_index: int, process_count: int):
    """Row range of the global batch owned by this host."""
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)
