"""Serving engine: slot-based continuous batching (ported from
`repro.serve.engine`, whole-prompt admission).

The engine owns a batched KV cache with `max_slots` request slots.
Admission runs the request's whole prompt as one B=1 bucketed prefill
copied into its slot; every tick then runs one batched decode step over all
`max_slots` rows (free rows included, as in the JAX engine, so shapes stay
static) and samples one token per active slot.

The cache is updated in place: the decode step writes each slot's new K/V
into the batched cache tensors, and admission copies the fresh B=1 cache
into its slot.

Not ported yet: speculative decoding (`spec`), chunked prefill
(`prefill_chunk`), the paged KV cache (`paged_kv`) and observability
(`obs`); asking for any of them raises.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import decode_step as model_decode
from repro_torch.models import init_cache, prefill_into_slot

from .sampling import sample


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    # filled by the engine
    slot: int = -1
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: str = ""               # admission rejection reason
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


class Engine:
    """Continuous-batching engine over a static (max_slots, max_len) KV
    cache. Admission budgets ``len(prompt) + max_new_tokens - 1`` cache
    positions: the final generated token is sampled but never written back.

    `params` (an `LM` with packed linears) is moved to `device` in place."""

    def __init__(self, params, cfg: ModelConfig, *, max_slots: int = 8,
                 max_len: int = 512, temperature: float = 0.0, seed: int = 0,
                 mpgemm_impl: str | None = None, mpgemm_fusion: str | None = None,
                 spec=None, prefill_chunk: int = 0,
                 paged_kv=None, obs=None, device="cuda"):
        unported = {"spec": spec is not None, "prefill_chunk": bool(prefill_chunk),
                    "paged_kv": paged_kv is not None, "obs": obs is not None}
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"Engine options {asked} are not ported yet")
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # mpGeMM routing for every BitLinear this engine runs (None: the
        # process DispatchConfig's default)
        self._mpgemm = dict(impl=mpgemm_impl, fusion=mpgemm_fusion)
        self.cache = init_cache(cfg, max_slots, max_len, device=self.device)
        self.slot_free = [True] * max_slots
        self.slot_req: dict[int, Request] = {}
        self.last_token = torch.zeros((max_slots, 1), dtype=torch.int32, device=self.device)
        self.active = np.zeros(max_slots, bool)
        # stats
        self.prefill_tokens = 0      # real prompt tokens prefilled
        self.prefill_pad_tokens = 0  # bucket padding (not real work)
        self.decode_tokens = 0
        self.decode_steps = 0        # batched decode step invocations

    def _validate(self, req: Request) -> None:
        """Reject a request that can never fit the slot KV cache."""
        need = len(req.prompt) + req.max_new_tokens - 1
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens - 1 ({req.max_new_tokens - 1}) = {need} "
                f"exceeds the model context (max_len={self.max_len}); "
                f"truncate the prompt, lower max_new_tokens, or grow max_len"
            )

    @torch.no_grad()
    def add(self, req: Request) -> bool:
        """Admit a request into a free slot: run its whole prompt and sample
        the first token. False if no slot is free; raises ValueError if the
        request cannot fit in max_len at all."""
        self._validate(req)
        try:
            slot = self.slot_free.index(True)
        except ValueError:
            return False
        req.slot = slot
        req.t_submit = req.t_submit or time.perf_counter()
        with kernel_ops.dispatch_override(**self._mpgemm):
            logits, self.cache, padded = prefill_into_slot(
                self.params, self.cache, slot, req.prompt, self.cfg,
                max_len=self.max_len,
            )
        self.prefill_tokens += len(req.prompt)
        self.prefill_pad_tokens += padded - len(req.prompt)
        nxt = int(self._sample(logits)[0])
        self._start_decoding(slot, req, nxt, time.perf_counter())
        return True

    def _start_decoding(self, slot: int, req: Request, first_tok: int, now: float) -> None:
        """Prefill complete: record the first generated token and start
        decoding the slot — or finish it when max_new_tokens=1."""
        req.generated.append(first_tok)
        req.t_first_token = now
        self.last_token[slot, 0] = first_tok
        if len(req.generated) >= req.max_new_tokens:
            req.done = True
            req.t_done = req.t_first_token
            self.slot_free[slot] = True
            return
        self.slot_free[slot] = False
        self.slot_req[slot] = req
        self.active[slot] = True

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self.generator, temperature=self.temperature)

    def _slot_exhausted(self, req: Request) -> bool:
        """True when the slot's next decode write would pass max_len
        (admission bounds this; a safety re-check)."""
        next_pos = len(req.prompt) + len(req.generated) - 1  # last_token's slot
        return next_pos >= self.max_len

    def _finish_slot(self, slot: int, req: Request, now: float) -> None:
        req.done = True
        req.t_done = now
        self.active[slot] = False
        self.slot_free[slot] = True
        del self.slot_req[slot]

    @property
    def has_work(self) -> bool:
        """True when a step() would do anything: some slot is decoding."""
        return bool(self.active.any())

    def step(self) -> None:
        """One engine tick: the batched decode step."""
        self.decode_once()

    @torch.no_grad()
    def decode_once(self) -> None:
        """One batched decode step over every slot; active slots take one
        token each."""
        if not self.active.any():
            return
        self.decode_steps += 1
        with kernel_ops.dispatch_override(**self._mpgemm):
            logits, self.cache = model_decode(self.params, self.last_token, self.cache, self.cfg)
        nxt_dev = self._sample(logits)                               # (B,)
        self.last_token = nxt_dev[:, None]
        nxt = np.asarray(nxt_dev.cpu())   # one host copy per tick
        now = time.perf_counter()
        for slot, req in list(self.slot_req.items()):
            if not self.active[slot]:
                continue
            self.decode_tokens += 1
            req.generated.append(int(nxt[slot]))
            if len(req.generated) >= req.max_new_tokens or self._slot_exhausted(req):
                self._finish_slot(slot, req, now)

    def reset_stats(self) -> None:
        """Zero the token counters (e.g. after a warmup run)."""
        self.prefill_tokens = self.prefill_pad_tokens = self.decode_tokens = 0
        self.decode_steps = 0
