"""Serving engine: slot-based continuous batching (ported from
`repro.serve.engine`).

The engine owns a batched KV cache with `max_slots` request slots; requests
of different lengths coexist through per-slot `idx` positions and
position-masked attention. Every step's shapes are static.

Two prefill policies:

  * Whole-prompt (`prefill_chunk=0`): admission runs the request's whole
    prompt as one B=1 bucketed prefill copied into its slot; every tick then
    runs one batched decode step over all `max_slots` rows.
  * Chunked (`prefill_chunk=N`): admission only claims a slot (PREFILLING);
    each tick one batched (max_slots, N) `models.verify_step` carries every
    scheduled prefill chunk and, without speculation, the last-token decode
    rows of the DECODING slots, so the mpGeMM kernels see N ≈ chunk ×
    (prefilling slots) + (decode rows) tokens every tick. A left-over chunk
    is mask-padded and its writes rolled back; `token_budget` caps the real
    tokens per tick (decode rows first, then FCFS chunks; one chunk always
    advances). TTFT is taken when the last chunk lands.

With `spec=SpecConfig(...)` decode becomes draft → verify → accept: the
drafter proposes K tokens per slot, one batched (B, K+1) `verify_step` runs
the target (N = B·(K+1) per launch), `accept_speculative` keeps the longest
valid prefix and the cache rolls back past the first rejection. Adaptive K
drafts `k_eff = spec.k_policy(ewma)` real tokens per slot and pads the rest;
`stochastic=True` samples ModelDrafter proposals and threads their
distributions into acceptance. `tree=(b1, ...)` verifies a draft tree of
n_nodes tokens per slot in one pass; `accept_tree` keeps the longest
accepted path and `compact_tree_cache` moves it onto contiguous slots.
Under chunked prefill, PREFILLING slots join draft/verify rows only after
their last chunk (the drafter's `on_admit` fires then).

With `paged_kv=PagedKVConfig(...)` the dense (max_slots, max_len) slabs
become a physical page pool with per-slot block tables (`models.paged`).
The host-side `Pager` (`serve.paging`) owns allocation, radix prefix
sharing with copy-on-write refcounts, and the host-RAM offload tier.
Admission reserves a request's worst-case page budget (an exhausted pool
queues the request, "waiting for free KV pages"), a prompt whose leading
full pages are in the radix index starts its prefill at the matched
frontier, and whole-prompt admission runs one wide in-place verify pass
over the prompt's remainder. The pager's tables reach the device at
admission and at tick start (`_flush_pager`): one host-to-device copy of
the table and the fresh pages to scrub.

The cache is updated in place: each step writes the slots' new K/V into the
batched cache tensors, and `rollback_cache` resets the write positions.
Greedy output of every mode is token for token that of plain decode.

With `obs=ObsConfig(...)` (or an `Obs`) the engine records TTFT and TPOT
histograms and, for every batched step, its wall time by kind and the real
parallel tokens it carried (`repro_torch.obs`); the enabled `Obs` is
installed for the mpGeMM dispatch spans. `obs=None` costs one `enabled`
check per step. Every figure comes from host state the step already holds:
observability adds no host sync.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch import module_to, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import compact_tree_cache, gather_page, init_cache
from repro_torch.models import decode_step as model_decode
from repro_torch.models import prefill as model_prefill
from repro_torch.models import prefill_bucket, prefill_into_slot, reset_slot_idx
from repro_torch.models import restore_page, rollback_cache, scrub_pages, set_block_tables
from repro_torch.models import verify_step as model_verify
from repro_torch.spec import SpecConfig

from .paging import OutOfPages, PagedKVConfig, Pager
from .sampling import accept_speculative, accept_tree, sample


# single definitions of the speculative metrics, shared by Engine (live
# counters) and ServeStats (per-run snapshot)
def spec_acceptance_rate(accepted_tokens: int, drafted_tokens: int) -> float:
    """Fraction of drafted tokens the target model accepted."""
    return accepted_tokens / drafted_tokens if drafted_tokens else 0.0


def spec_tokens_per_step(decode_tokens: int, spec_slot_steps: int) -> float:
    """Mean tokens a slot emits per verify step (1..k+1; 1.0 unspeculated)."""
    return decode_tokens / spec_slot_steps if spec_slot_steps else 1.0


def spec_skip_rate(spec_skipped_steps: int, spec_slot_steps: int) -> float:
    """Fraction of slot verify steps that skipped drafting (k_eff=0)."""
    return spec_skipped_steps / spec_slot_steps if spec_slot_steps else 0.0


def spec_mean_k(drafted_tokens: int, spec_slot_steps: int, spec_skipped_steps: int) -> float:
    """Mean effective draft length over the slot steps that did draft."""
    drafting = spec_slot_steps - spec_skipped_steps
    return drafted_tokens / drafting if drafting else 0.0


def spec_nodes_per_step(verified_nodes: int, spec_slot_steps: int) -> float:
    """Mean candidate tokens one slot's verify row carries per step: k+1 in
    chain mode, the tree's node count under tree verification (1.0
    unspeculated). Times max_slots, the N each mpGeMM launch sees."""
    return verified_nodes / spec_slot_steps if spec_slot_steps else 1.0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    # filled by the engine
    slot: int = -1
    prefill_pos: int = 0          # prompt tokens already in cache (chunked)
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False
    error: str = ""               # admission rejection reason
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0


class Engine:
    """Continuous-batching engine over a static (max_slots, max_len) KV
    cache. Admission budgets ``len(prompt) + max_new_tokens - 1`` cache
    positions (+ the draft window under speculation): the final generated
    token is sampled but never written back.

    `params` (an `LM` with packed linears) is moved to `device` in place;
    so is a ModelDrafter's draft model."""

    def __init__(self, params, cfg: ModelConfig, *, max_slots: int = 8,
                 max_len: int = 512, temperature: float = 0.0, seed: int = 0,
                 mpgemm_impl: str | None = None, mpgemm_fusion: str | None = None,
                 spec: SpecConfig | None = None, prefill_chunk: int = 0,
                 token_budget: int = 0, paged_kv: PagedKVConfig | None = None,
                 obs: obs_mod.ObsConfig | obs_mod.Obs | None = None, device="cuda"):
        specs = cfg.layer_specs()
        if paged_kv is not None:
            if any(s.mixer == "ssm" for s in specs):
                raise ValueError(
                    "paged KV needs per-position cache entries a block table "
                    f"can own; {cfg.name} has ssm layer(s), whose recurrent "
                    "state is neither rollbackable nor pageable")
            if any(s.window for s in specs):
                raise ValueError(
                    "paged KV is exact only for full-buffer caches; "
                    f"{cfg.name} has windowed (ring-cache) layers — a ring "
                    "buffer overwrites itself in place, so its pages can "
                    "never be remapped or shared")
            if any(s.cross_attn for s in specs):
                raise ValueError(
                    "paged KV does not cover cross-attention caches "
                    "(enc_len > 0): encoder K/V is per-request dense state, "
                    "not positionally growing history")
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got {prefill_chunk}")
        if token_budget < 0:
            raise ValueError(f"token_budget must be >= 0, got {token_budget}")
        if prefill_chunk:
            if prefill_chunk > max_len:
                raise ValueError(
                    f"prefill_chunk ({prefill_chunk}) exceeds max_len "
                    f"({max_len}); the chunk step cannot outgrow the cache")
            if any(s.mixer == "ssm" for s in specs):
                raise ValueError(
                    "chunked prefill needs rollbackable KV caches (the "
                    f"mask-padded chunk tail is rolled back); {cfg.name} has "
                    "ssm layer(s), whose recurrent state is neither "
                    "rollbackable nor pageable")
            if any(s.window for s in specs):
                raise ValueError(
                    "chunked prefill is exact only for full-buffer or paged "
                    f"KV caches; {cfg.name} has windowed (ring-cache) layers, "
                    "whose in-window history the padded-tail rollback would "
                    "clobber (the ring overwrites in place, so it is "
                    "genuinely non-pageable too)")
        if spec is not None:
            bad = [s.mixer for s in specs if s.mixer == "ssm"]
            if bad:
                raise ValueError(
                    "speculative decoding needs rollbackable KV caches; "
                    f"{cfg.name} has {len(bad)} ssm layer(s), whose recurrent "
                    "state is neither rollbackable nor pageable")
            if any(s.window for s in specs):
                raise ValueError(
                    "speculative decoding is exact only for full-buffer or "
                    f"paged KV caches; {cfg.name} has windowed (ring-cache) "
                    "layers, whose in-window history a rollback would "
                    "clobber (the ring overwrites in place, so it is "
                    "genuinely non-pageable too)")
        self.device = resolve_device(device)
        self.params = module_to(params, self.device) if params is not None else None
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # mpGeMM routing for every BitLinear this engine (and its drafter)
        # runs (None: the process DispatchConfig's default)
        self._mpgemm = dict(impl=mpgemm_impl, fusion=mpgemm_fusion)
        # paged KV: a physical page pool + per-slot block tables replace the
        # dense slabs; the host-side Pager owns allocation, prefix sharing
        # and offload, the device side is pure data movement (models.paged)
        self.pager: Pager | None = None
        if paged_kv is not None:
            ps = paged_kv.page_size
            n_pages = paged_kv.n_pages or max_slots * (max_len // ps) + 1
            self.cache = init_cache(cfg, max_slots, max_len, device=self.device,
                                    page_size=ps, n_pages=n_pages)
            self.pager = Pager(paged_kv, max_slots=max_slots, max_len=max_len,
                               n_pages=n_pages, page_out=self._page_out,
                               page_in=self._page_in)
        else:
            self.cache = init_cache(cfg, max_slots, max_len, device=self.device)
        self.slot_free = [True] * max_slots
        self.slot_req: dict[int, Request] = {}
        # each slot's last sampled token, kept on the host (every step reads
        # its sampled tokens back anyway) and uploaded with the step's input
        self.last_token = np.zeros((max_slots, 1), np.int32)
        self.active = np.zeros(max_slots, bool)
        self.prefill_chunk = prefill_chunk
        self.token_budget = token_budget
        self.prefilling: dict[int, Request] = {}    # slot → mid-prefill request
        # decode rows ride the chunk step only when their logits come off
        # the path plain decode uses: unless speculation runs its own draft
        # → verify step over them, and never on MLA layers, whose decode is
        # absorbed while the chunk step reads through prefill_resume (the
        # naive expansion); those slots decode in their own step each tick
        self._decode_rides = spec is None and not any(s.mixer == "mla" for s in specs)
        self.spec = spec
        self.drafter = None
        self._tree = None
        if spec is not None:
            self.drafter = spec.build(max_slots=max_slots, max_len=max_len, device=self.device)
            self._tree = spec.tree_struct()
            if self._tree is not None and temperature > 0.0:
                warnings.warn(
                    "tree verification at temperature>0 greedy-matches the "
                    "draft nodes and only *samples* the correction token — "
                    "output is greedy-filtered, not an exact target-temperature "
                    "sample (chain mode is exact; see sampling.accept_tree)",
                    stacklevel=2,
                )
        # the step entries every device step dispatches through, by name
        # (`step_entries`: what `repro_torch.lint.ir` traces and the
        # steady-state guard watches), the JAX engine's jitted callables
        self._prefill1 = lambda p, c, t: model_prefill(p, t, c, cfg)
        self._decode = lambda p, c, t: model_decode(p, t, c, cfg)
        # the chunk step, and a paged engine's whole-prompt admission (a wide
        # in-place verify pass)
        self._chunk_verify = None
        if prefill_chunk or paged_kv is not None:
            self._chunk_verify = lambda p, c, t, col: model_verify(
                p, t, c, cfg, prefill_resume=True, logit_cols=col)
        self._verify = self._compact = None
        if spec is not None:
            self._verify = lambda p, c, t: model_verify(p, t, c, cfg, tree=self._tree)
            if self._tree is not None:
                self._compact = compact_tree_cache
        self._set_tab = self._scrub = None
        if self.pager is not None:
            self._set_tab, self._scrub = set_block_tables, scrub_pages
        # per-slot adaptive-K state: acceptance EWMA (optimistic 1.0 on
        # admission), the skip streak that triggers a cold slot's probe, and
        # the last k_eff the policy chose
        self.slot_accept = np.ones(max_slots, np.float64)
        self.slot_skip_streak = np.zeros(max_slots, np.int64)
        self.slot_k_eff = np.full(max_slots, self._draft_k, np.int64)
        # stats
        self.prefill_tokens = 0      # real prompt tokens prefilled
        self.prefill_pad_tokens = 0  # bucket/chunk padding (not real work)
        self.decode_tokens = 0
        self.decode_steps = 0        # batched decode/verify step invocations
        self.chunk_steps = 0         # batched mixed chunk-step invocations
        self.spec_steps = 0          # batched verify steps
        self.spec_slot_steps = 0     # per-slot verify steps (Σ active slots)
        self.spec_skipped_steps = 0  # slot steps that skipped drafting (k_eff=0)
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.verified_nodes = 0      # candidate tokens verified (Σ per slot)
        # observability: the null instance is free (every method returns at
        # once); an enabled Obs also installs itself for the mpGeMM dispatch
        # hook (ops.ternary_matmul / ternary_matmul_batched)
        if obs is None:
            self.obs = obs_mod.NULL_OBS
        elif isinstance(obs, obs_mod.Obs):
            self.obs = obs
        else:
            self.obs = obs_mod.Obs(obs)
        if self.obs.enabled:
            obs_mod.install(self.obs)

    # ------------------------------------------------------------------
    @property
    def _draft_k(self) -> int:
        return self.spec.k if self.spec is not None else 0

    @property
    def _draft_window(self) -> int:
        """Cache slots one verify step writes past the root's position: k in
        chain mode, the tree's draft-node count under tree verification."""
        if self._tree is not None:
            return self._tree.n_draft
        return self._draft_k

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _validate(self, req: Request) -> None:
        """Reject a request that can never fit the slot KV cache: prompt +
        max_new_tokens - 1 (+ the draft window past the last kept token)."""
        need = len(req.prompt) + req.max_new_tokens - 1 + self._draft_window
        if need > self.max_len:
            extra = f" + draft window ({self._draft_window})" if self._draft_window else ""
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens - 1 ({req.max_new_tokens - 1}){extra} = {need} "
                f"exceeds the model context (max_len={self.max_len}); "
                f"truncate the prompt, lower max_new_tokens, or grow the "
                f"engine's max_len — this can never succeed, unlike a "
                f"transient out-of-pages deferral"
            )
        if self.pager is not None:
            # a reservation larger than the whole pool is equally permanent:
            # shared pages are pool pages too
            ps = self.pager.cfg.page_size
            need_pages = -(-need // ps)
            if need_pages > self.pager.total_pages:
                raise ValueError(
                    f"request {req.rid}: needs {need_pages} KV pages "
                    f"({need} positions at page_size={ps}) but the pool "
                    f"only has {self.pager.total_pages} allocatable pages; "
                    f"grow n_pages or shrink the request — this can never "
                    f"succeed, unlike a transient out-of-pages deferral"
                )

    @torch.no_grad()
    def add(self, req: Request) -> bool:
        """Admit a request into a free slot. False if no slot is free; raises
        ValueError if the request cannot fit in max_len at all.

        Whole-prompt mode runs the prompt and samples the first token here;
        chunked mode only claims the slot (PREFILLING), and the first token
        is sampled when the last chunk lands. A paged engine first reserves
        the request's page budget: an exhausted pool returns False with
        `req.error` saying it waits for free KV pages (a transient state,
        unlike the ValueError of a request that can never fit)."""
        self._validate(req)
        try:
            slot = self.slot_free.index(True)
        except ValueError:
            return False
        req.slot = slot
        req.t_submit = req.t_submit or time.perf_counter()
        matched = 0
        if self.pager is not None:
            need = len(req.prompt) + req.max_new_tokens - 1 + self._draft_window
            try:
                matched = self.pager.admit(slot, np.asarray(req.prompt), need)
            except OutOfPages as e:
                req.error = f"queued: waiting for free KV pages ({e})"
                return False
            req.error = ""
            self._flush_pager()
        if self.prefill_chunk or self.pager is not None:
            # the write position restarts at the matched prefix frontier (0
            # without a hit: matched pages already hold their KV); stale K/V
            # needs no clearing (see models.reset_slot_idx)
            reset_slot_idx(self.cache, slot, value=matched)
        if self.prefill_chunk:
            self.slot_free[slot] = False
            req.prefill_pos = matched
            self.prefilling[slot] = req
            return True
        if self.pager is not None:
            self._paged_prefill(slot, req, matched)
            return True
        # SSM layers cannot mask pads inside the scan: exact lengths
        has_ssm = any(s.mixer == "ssm" for s in self.cfg.layer_specs())
        with kernel_ops.dispatch_override(**self._mpgemm):
            logits, self.cache, padded = prefill_into_slot(
                self.params, self.cache, slot, req.prompt, self.cfg,
                max_len=self.max_len, exact_len=has_ssm, prefill_fn=self._prefill1,
            )
        self.prefill_tokens += len(req.prompt)
        self.prefill_pad_tokens += padded - len(req.prompt)
        nxt = int(self._sample(logits)[0])
        self._start_decoding(slot, req, nxt, time.perf_counter())
        return True

    def _paged_prefill(self, slot: int, req: Request, matched: int) -> None:
        """Whole-prompt admission for a paged engine: one wide in-place
        verify pass over the unmatched prompt suffix, writing K/V through
        the slot's freshly flushed block table (a fresh B=1 cache has no
        pages to copy from). Other slots' rows are padding whose frontier
        writes are rolled back as a chunk step's are; a prefix hit shrinks
        the pass to the suffix alone."""
        rem = req.prompt[matched:]
        bucket = prefill_bucket(len(rem), self.max_len)
        tokens = np.zeros((self.max_slots, bucket), np.int32)
        tokens[slot, :len(rem)] = rem
        col = np.zeros(self.max_slots, np.int64)
        col[slot] = len(rem) - 1
        new_idx = self._idx_vector()
        new_idx[slot] = len(req.prompt)
        with kernel_ops.dispatch_override(**self._mpgemm):
            rows, cache = self._chunk_verify(self.params, self.cache, self._dev(tokens),
                                             self._dev(col))
        self.cache = rollback_cache(cache, self._dev(new_idx))
        self.prefill_tokens += len(rem)
        self.prefill_pad_tokens += bucket - len(rem)
        nxt = int(self._sample(rows[slot][None])[0])
        self._start_decoding(slot, req, nxt, time.perf_counter())

    def _start_decoding(self, slot: int, req: Request, first_tok: int, now: float) -> None:
        """Prefill complete (whole prompt or last chunk): record the first
        generated token and start decoding the slot — or finish it when
        max_new_tokens=1."""
        req.generated.append(first_tok)
        req.t_first_token = now
        if req.t_submit:
            self.obs.observe_ttft(now - req.t_submit)
        self.last_token[slot, 0] = first_tok
        if len(req.generated) >= req.max_new_tokens:
            req.done = True
            req.t_done = req.t_first_token
            self.slot_free[slot] = True
            if self.pager is not None:
                self.pager.release(slot, np.asarray(req.prompt))
            return
        self.slot_free[slot] = False
        self.slot_req[slot] = req
        self.active[slot] = True
        if self.drafter is not None:
            # chunked mode gets here after the last chunk: the drafter syncs
            # the whole prompt exactly once
            with kernel_ops.dispatch_override(**self._mpgemm):
                self.drafter.on_admit(slot, req.prompt)
        # fresh request → optimistic acceptance state (starts at full k)
        self.slot_accept[slot] = 1.0
        self.slot_skip_streak[slot] = 0
        self.slot_k_eff[slot] = self._draft_k

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self.generator, temperature=self.temperature)

    # -- paged-KV device sync ------------------------------------------
    def _page_out(self, page: int) -> dict:
        """Pager offload callback: copy one physical page to the host."""
        return gather_page(self.cache, page)

    def _page_in(self, page: int, data: dict) -> None:
        """Pager page-in callback: restore a host copy into `page`. The
        restored slot_pos rides along with the K/V, so a paged-in page is
        not scrubbed (that would erase the positions that make the restored
        prefix attendable)."""
        restore_page(self.cache, page, data)

    def _flush_pager(self) -> None:
        """Push the pager's host state to the device before the next step:
        the block tables and the fresh pages whose slot_pos must be
        scrubbed to -1 travel in one host-to-device copy. Called at
        admission (before the prefill pass) and at tick start (after
        releases)."""
        if self.pager is None or not self.pager.dirty:
            return
        tab, fresh = self.pager.take_flush()
        buf = self._dev(np.concatenate([tab.reshape(-1), np.asarray(fresh, np.int32)]))
        if fresh:
            self._scrub(self.cache, buf[tab.size:])
        self._set_tab(self.cache, buf[:tab.size].view(tab.shape))

    def _slot_exhausted(self, req: Request) -> bool:
        """True when the slot's next step would write past max_len (the
        next write position plus the draft window). Admission bounds this;
        a safety re-check."""
        next_pos = len(req.prompt) + len(req.generated) - 1  # last_token's slot
        return next_pos + self._draft_window >= self.max_len

    def _finish_slot(self, slot: int, req: Request, now: float) -> None:
        req.done = True
        req.t_done = now
        # TPOT = mean inter-token gap after the first token (single-token
        # requests finish in _start_decoding)
        if len(req.generated) > 1 and req.t_first_token:
            self.obs.observe_tpot((now - req.t_first_token) / (len(req.generated) - 1))
        self.active[slot] = False
        self.slot_free[slot] = True
        del self.slot_req[slot]
        if self.pager is not None:
            # prefix pages return to the radix index, the rest to the free
            # pool; the table flush waits for the next admission or tick
            self.pager.release(slot, np.asarray(req.prompt))
        if self.drafter is not None:
            self.drafter.on_release(slot)

    @property
    def has_work(self) -> bool:
        """True when a step() would do anything: slots mid-prefill or
        decoding."""
        return bool(self.prefilling) or bool(self.active.any())

    def _idx_vector(self) -> np.ndarray:
        """Host mirror of every slot's true cache write position: a DECODING
        slot's is its last sampled token's position (that token is written
        by the next step), a PREFILLING slot's its consumed prompt prefix,
        free slots 0. Every batched rollback starts from it, so a step over
        some slots never moves another slot's idx."""
        idx = np.zeros(self.max_slots, np.int64)
        for slot, req in self.prefilling.items():
            idx[slot] = req.prefill_pos
        for slot, req in self.slot_req.items():
            if self.active[slot]:
                idx[slot] = len(req.prompt) + len(req.generated) - 1
        return idx

    def step(self) -> None:
        """One engine tick: the chunked-prefill step (when a slot is
        PREFILLING), then, or else, the batched decode step."""
        self._flush_pager()    # released slots' table rows → null before any step
        if self.prefilling:
            self._chunk_step()
            if not self._decode_rides:
                # speculative and MLA engines run their own decode (or draft
                # → verify) step over the decoding slots in the same tick
                self.decode_once()
        else:
            self.decode_once()

    @torch.no_grad()
    def _chunk_step(self) -> None:
        """One batched mixed prefill/decode step over the (max_slots,
        prefill_chunk) token grid.

        A scheduled PREFILLING slot carries its next c = min(chunk,
        remaining) prompt tokens (a short chunk is mask-padded: its pad
        positions pass every real query's and are rolled back); without
        speculation every DECODING slot rides along as a last-token row in
        column 0; other rows are padding. One `verify_step` writes them all.
        `token_budget` caps the real tokens: decode rows first, then chunks
        FCFS, at least one chunk per step."""
        _t0 = time.perf_counter() if self.obs.enabled else 0.0
        chunk = self.prefill_chunk
        include_decode = self._decode_rides and bool(self.active.any())
        used = int(self.active.sum()) if include_decode else 0
        budget = self.token_budget
        chosen: list[tuple[int, int]] = []
        for slot, req in self.prefilling.items():
            c = min(chunk, len(req.prompt) - req.prefill_pos)
            if chosen and budget and used + c > budget:
                break
            chosen.append((slot, c))
            used += c
        tokens = np.zeros((self.max_slots, chunk), np.int32)
        col = np.zeros(self.max_slots, np.int64)     # logits column per slot
        new_idx = self._idx_vector()
        for slot, c in chosen:
            req = self.prefilling[slot]
            tokens[slot, :c] = req.prompt[req.prefill_pos:req.prefill_pos + c]
            col[slot] = c - 1
            new_idx[slot] = req.prefill_pos + c
        decode_slots: list[int] = []
        if include_decode:
            for slot in self.slot_req:
                if not self.active[slot]:
                    continue
                tokens[slot, 0] = self.last_token[slot, 0]
                new_idx[slot] += 1          # _idx_vector holds last_token's pos
                decode_slots.append(slot)
        with kernel_ops.dispatch_override(**self._mpgemm):
            rows, cache = self._chunk_verify(self.params, self.cache, self._dev(tokens),
                                             self._dev(col))
        nxt = np.asarray(self._sample(rows).cpu())       # one host copy per tick
        now = time.perf_counter()
        self.chunk_steps += 1
        for slot, c in chosen:
            req = self.prefilling[slot]
            req.prefill_pos += c
            self.prefill_tokens += c
            self.prefill_pad_tokens += chunk - c
            if req.prefill_pos < len(req.prompt):
                continue
            # last chunk landed: first token, PREFILLING → DECODING
            del self.prefilling[slot]
            self._start_decoding(slot, req, int(nxt[slot]), now)
        for slot in decode_slots:
            req = self.slot_req[slot]
            self.decode_tokens += 1
            req.generated.append(int(nxt[slot]))
            self.last_token[slot, 0] = nxt[slot]
            if len(req.generated) >= req.max_new_tokens or self._slot_exhausted(req):
                self._finish_slot(slot, req, now)
        self.cache = rollback_cache(cache, self._dev(new_idx))
        if self.obs.enabled:
            # used = real tokens this step carried (chunk tokens + decode
            # rows): the effective M of the step's mpGeMM launches
            self.obs.step_event("chunk", _t0, m_real=used, m_padded=self.max_slots * chunk,
                                prefills=len(chosen), decodes=len(decode_slots))

    @torch.no_grad()
    def decode_once(self) -> None:
        """One batched decode step over every active slot. With spec enabled
        this is draft → verify → accept (1..k+1 tokens per slot)."""
        self._flush_pager()    # callers may run decode_once without step()
        if not self.active.any():
            return
        if self._tree is not None:
            return self._decode_spec_tree()
        if self.spec is not None:
            return self._decode_spec()
        self.decode_steps += 1
        _t0 = time.perf_counter() if self.obs.enabled else 0.0
        # rows finishing mid-loop still count
        _m_active = int(self.active.sum()) if self.obs.enabled else 0
        # the decode step advances EVERY slot's idx by 1 and writes a token
        # at every slot's frontier; a slot mid-chunked-prefill gets its idx
        # back (its next chunk rewrites that frontier before it is read)
        restore = bool(self.prefilling)
        if restore:
            new_idx = self._idx_vector()
            new_idx[self.active] += 1               # decode wrote last_token
        with kernel_ops.dispatch_override(**self._mpgemm):
            logits, self.cache = self._decode(self.params, self.cache,
                                              self._dev(self.last_token))
        nxt = np.asarray(self._sample(logits).cpu())   # one host copy per tick
        self.last_token = nxt[:, None].astype(np.int32)
        now = time.perf_counter()
        for slot, req in list(self.slot_req.items()):
            if not self.active[slot]:
                continue
            self.decode_tokens += 1
            req.generated.append(int(nxt[slot]))
            if len(req.generated) >= req.max_new_tokens or self._slot_exhausted(req):
                self._finish_slot(slot, req, now)
        if restore:
            self.cache = rollback_cache(self.cache, self._dev(new_idx))
        if self.obs.enabled:
            self.obs.step_event("decode", _t0, m_real=_m_active, m_padded=self.max_slots)

    def _choose_k_eff(self) -> np.ndarray:
        """Per-slot effective draft length for this step: spec.k everywhere
        unless adaptive_k, in which case each active slot gets
        spec.k_policy(acceptance EWMA, skip streak) in [0, k]."""
        k_eff = np.full(self.max_slots, self.spec.k, np.int64)
        if not self.spec.adaptive_k:
            return k_eff
        for slot in range(self.max_slots):
            if self.active[slot]:
                k_eff[slot] = self.spec.k_policy(
                    float(self.slot_accept[slot]),  # lint: disable=R3 -- slot_accept is a host np.ndarray EWMA
                    int(self.slot_skip_streak[slot]),  # lint: disable=R3 -- slot_skip_streak is host np.ndarray state
                )
        return k_eff

    def _update_slot_accept(self, slot: int, k_eff: int, n_acc: int) -> None:
        """Fold one verify step's verdict into the slot's acceptance EWMA;
        skipped (k_eff=0) steps only advance the probe streak."""
        if k_eff == 0:
            self.slot_skip_streak[slot] += 1
            self.spec_skipped_steps += 1
            return
        self.slot_skip_streak[slot] = 0
        a = self.spec.accept_ewma
        self.slot_accept[slot] = a * self.slot_accept[slot] + (1 - a) * (n_acc / k_eff)

    def _gather_contexts(self):
        """Per-slot drafting inputs: the full token context (prompt +
        generated; None for free slots) and the cache idx of the last
        sampled token. → (contexts, pos)."""
        contexts: list = [None] * self.max_slots
        pos = np.zeros(self.max_slots, np.int64)     # per-slot cache idx
        for slot, req in self.slot_req.items():
            if self.active[slot]:
                contexts[slot] = np.concatenate(
                    # lint: disable=R3 -- prompt/generated are host python lists
                    [np.asarray(req.prompt, np.int64), np.asarray(req.generated, np.int64)]
                )
                pos[slot] = len(req.prompt) + len(req.generated) - 1
        return contexts, pos

    @torch.no_grad()
    def _decode_spec(self) -> None:
        """One speculative decode step: the drafter's proposal, one batched
        (B, K+1) verify pass through the mpGeMM kernels, longest accepted
        prefix, and the cache rolled back to the last kept position. A slot
        drafting k_eff < k real tokens pads the rest of its row, and the
        draft_mask stops acceptance at k_eff (k_eff=0 is a plain decode row)."""
        _t0 = time.perf_counter() if self.obs.enabled else 0.0
        # slots finishing mid-loop flip self.active
        active0 = self.active.copy() if self.obs.enabled else None
        k = self.spec.k
        contexts, pos = self._gather_contexts()
        k_eff = self._choose_k_eff()
        self.slot_k_eff = k_eff.copy()
        stochastic = self.spec.stochastic and self.temperature > 0.0
        draft_probs = None
        with kernel_ops.dispatch_override(**self._mpgemm):
            if stochastic:
                draft, draft_probs = self.drafter.propose(
                    contexts, k, slot_k=k_eff, generator=self.generator,
                    temperature=self.temperature, return_probs=True)
            else:
                draft = self.drafter.propose(contexts, k, slot_k=k_eff)
            mask = np.arange(k)[None, :] < k_eff[:, None]                # (B, K)
            tokens = self._dev(np.concatenate([self.last_token, np.asarray(draft, np.int32)], 1))
            logits, cache = self._verify(self.params, self.cache, tokens)
        n_acc_dev, out_dev = accept_speculative(
            tokens[:, 1:], logits, self.generator, temperature=self.temperature,
            draft_probs=draft_probs, draft_mask=self._dev(mask))
        # one host copy per tick: n_acc in column 0, the emitted tokens after
        host = np.asarray(torch.cat([n_acc_dev[:, None], out_dev], 1).cpu())
        n_acc, out = host[:, 0], host[:, 1:]
        # inactive slots keep their true idx (free: 0, PREFILLING: the
        # consumed prompt prefix)
        new_idx = self._idx_vector()
        new_last = self.last_token.copy()
        now = time.perf_counter()
        for slot, req in list(self.slot_req.items()):
            if not self.active[slot]:
                continue
            remaining = req.max_new_tokens - len(req.generated)
            take = min(int(n_acc[slot]) + 1, remaining)
            req.generated.extend(int(t) for t in out[slot, :take])
            new_last[slot, 0] = out[slot, take - 1]
            new_idx[slot] = pos[slot] + take
            self.decode_tokens += take
            self.spec_slot_steps += 1
            self.drafted_tokens += int(k_eff[slot])  # lint: disable=R3 -- _choose_k_eff returns host np.ndarray
            self.verified_nodes += k + 1
            # acceptance counts the verifier's verdict, not the emission cap
            self.accepted_tokens += int(n_acc[slot])
            self._update_slot_accept(slot, int(k_eff[slot]), int(n_acc[slot]))  # lint: disable=R3 -- k_eff is host np from _choose_k_eff
            if len(req.generated) >= req.max_new_tokens or self._slot_exhausted(req):
                self._finish_slot(slot, req, now)
        self.spec_steps += 1
        self.decode_steps += 1
        self.last_token = new_last
        self.cache = rollback_cache(cache, self._dev(new_idx))
        if self.obs.enabled:
            # every verify row carries k_eff + 1 real candidate tokens
            self.obs.step_event("verify", _t0, m_real=int(np.sum(k_eff[active0] + 1)),
                                m_padded=self.max_slots * (k + 1), k=k)

    @torch.no_grad()
    def _decode_spec_tree(self) -> None:
        """One tree-speculative decode step: the drafter proposes a token
        tree per slot (n_nodes flattened nodes), one batched (B, n_nodes)
        verify pass runs the target over every node, `accept_tree` keeps the
        longest accepted root-to-leaf path, the path's cache entries move
        onto contiguous slots (`compact_tree_cache`), and the idx rolls back
        to the accepted depth."""
        _t0 = time.perf_counter() if self.obs.enabled else 0.0
        _m_active = int(self.active.sum()) if self.obs.enabled else 0
        tree = self._tree
        n_nodes = tree.n_nodes
        contexts, pos = self._gather_contexts()
        with kernel_ops.dispatch_override(**self._mpgemm):
            draft = self.drafter.propose(contexts, self.spec.k, tree=tree)
            tokens = self._dev(np.concatenate([self.last_token, np.asarray(draft, np.int32)], 1))
            logits, cache = self._verify(self.params, self.cache, tokens)
        n_acc_dev, out_dev, path_dev = accept_tree(
            tokens, logits, tree, self.generator, temperature=self.temperature)
        # one host copy per tick: n_acc, then the k+1 emitted tokens, then the
        # k+1 path nodes
        host = np.asarray(torch.cat([n_acc_dev[:, None], out_dev, path_dev], 1).cpu())
        n_acc, out, path = host[:, 0], host[:, 1:tree.k + 2], host[:, tree.k + 2:]
        # every row's window starts at its true idx: a decoding slot's
        # equals pos, an inactive slot (free: 0, PREFILLING: the consumed
        # prompt prefix) keeps its own
        base = self._idx_vector()
        new_idx = base.copy()
        # slots outside this step pass take = 0 with an identity sel:
        # compaction invalidates their whole window. Their rows were
        # verified too, so node j sits at slot base+j with the lower
        # position base+depth(j); left alone, a later chunk shorter than the
        # window would attend those entries.
        take_arr = np.zeros(self.max_slots, np.int64)
        new_last = self.last_token.copy()
        now = time.perf_counter()
        for slot, req in list(self.slot_req.items()):
            if not self.active[slot]:
                continue
            remaining = req.max_new_tokens - len(req.generated)
            take = min(int(n_acc[slot]) + 1, remaining)
            req.generated.extend(int(t) for t in out[slot, :take])
            new_last[slot, 0] = out[slot, take - 1]
            new_idx[slot] = pos[slot] + take
            take_arr[slot] = take
            self.decode_tokens += take
            self.spec_slot_steps += 1
            # drafted counts the per-path budget (depth k), as chain mode;
            # the node-level width is verified_nodes / nodes_per_step
            self.drafted_tokens += tree.k
            self.accepted_tokens += int(n_acc[slot])
            self.verified_nodes += n_nodes
            if len(req.generated) >= req.max_new_tokens or self._slot_exhausted(req):
                self._finish_slot(slot, req, now)
        self.spec_steps += 1
        self.decode_steps += 1
        self.last_token = new_last
        # window compaction: the winning path's depth-d node to slot pos+d,
        # the losers invalidated
        sel = np.tile(np.arange(n_nodes, dtype=np.int64), (self.max_slots, 1))
        sel[:, 1:tree.k + 1] = np.where(
            np.arange(1, tree.k + 1)[None, :] <= n_acc[:, None], path[:, 1:],
            sel[:, 1:tree.k + 1])
        self._compact(cache, self._dev(base), self._dev(sel), self._dev(take_arr))
        self.cache = rollback_cache(cache, self._dev(new_idx))
        if self.obs.enabled:
            self.obs.step_event("tree_verify", _t0, m_real=_m_active * n_nodes,
                                m_padded=self.max_slots * n_nodes, n_nodes=n_nodes)

    def step_entries(self) -> dict:
        """Every step callable this engine dispatches its device work
        through, by name (the JAX engine's `jit_entries`: "prefill1",
        "decode", "chunk_verify", "set_tab", "scrub", "verify", "compact",
        and the drafter's prefixed "drafter."): what `repro_torch.lint.ir`
        traces and `repro_torch.lint.guard_entries` guards."""
        entries = {"prefill1": self._prefill1, "decode": self._decode}
        if self._chunk_verify is not None:
            entries["chunk_verify"] = self._chunk_verify
        if self.pager is not None:
            entries["set_tab"] = self._set_tab
            entries["scrub"] = self._scrub
        if self._verify is not None:
            entries["verify"] = self._verify
        if self._compact is not None:
            entries["compact"] = self._compact
        probe = getattr(self.drafter, "step_entries", None)
        if callable(probe):
            entries.update({f"drafter.{k}": v for k, v in probe().items()})
        return entries

    def reset_stats(self) -> None:
        """Zero the token and acceptance counters (e.g. after a warmup run).
        Slot and cache state are untouched."""
        self.prefill_tokens = self.prefill_pad_tokens = self.decode_tokens = 0
        self.decode_steps = self.chunk_steps = 0
        self.spec_steps = self.spec_slot_steps = self.spec_skipped_steps = 0
        self.drafted_tokens = self.accepted_tokens = self.verified_nodes = 0
        if self.pager is not None:
            self.pager.prefix_hit_tokens = self.pager.prefix_hit_requests = 0

    @property
    def prefix_hit_tokens(self) -> int:
        """Prompt tokens admitted straight off shared radix-prefix pages
        (their prefill was skipped). 0 on unpaged engines."""
        return self.pager.prefix_hit_tokens if self.pager is not None else 0

    @property
    def prefix_hit_requests(self) -> int:
        """Admissions that matched at least one shared prefix page."""
        return self.pager.prefix_hit_requests if self.pager is not None else 0

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def acceptance_rate(self) -> float:
        return spec_acceptance_rate(self.accepted_tokens, self.drafted_tokens)

    @property
    def decode_tokens_per_step(self) -> float:
        return spec_tokens_per_step(self.decode_tokens, self.spec_slot_steps)

    @property
    def skip_rate(self) -> float:
        return spec_skip_rate(self.spec_skipped_steps, self.spec_slot_steps)

    @property
    def mean_draft_k(self) -> float:
        return spec_mean_k(self.drafted_tokens, self.spec_slot_steps, self.spec_skipped_steps)

    @property
    def nodes_per_step(self) -> float:
        return spec_nodes_per_step(self.verified_nodes, self.spec_slot_steps)
