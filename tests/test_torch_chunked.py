"""Chunked prefill in repro_torch against the JAX package (the non-MLA
cases of tests/test_chunked_prefill.py): each chunked run of the port is
held against the JAX chunked engine with the same settings (greedy tokens
and counters) and against the port's own whole-prompt engine (greedy
tokens), on bridged weights of the smollm-360m smoke config in f32.

Chunked steps read the prompt's K/V back from the bf16 cache, where
whole-prompt prefill attends its own f32 K/V, so on this small model a
near-tie can flip a greedy token between the two paths; the JAX package's
f32 engines flip the same token on the same input. The comparison with the
whole-prompt engine therefore allows a difference whose first divergent
step is such a near-tie (`TIE_RTOL`); the comparison with JAX is exact."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import serve as js  # noqa: E402
from repro import spec as jspec  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import models as tm  # noqa: E402
from repro_torch import serve as ts  # noqa: E402
from repro_torch import spec as tspec  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.configs import uniform_layers  # noqa: E402

#: logit_cols against the full logits, as tests/test_chunked_prefill.py
#: bounds it (one hidden state gathered before the head matmul, not after)
COLS_TOL = 2e-4
#: a greedy divergence between chunked and whole-prompt serving is allowed
#: only where the whole-prompt logits of the two tokens are within this
#: fraction of the largest logit: bf16 rounding of K/V (2^-8 relative)
#: moves the smoke model's logits by up to ~1% of the largest
TIE_RTOL = 1e-2
DTYPE = "float32"
_STATS = ("prefill_tokens", "prefill_pad_tokens", "decode_tokens", "decode_steps", "chunk_steps",
          "spec_steps", "spec_slot_steps", "spec_skipped_steps", "drafted_tokens",
          "accepted_tokens", "verified_nodes", "completed", "rejected")


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("smollm-360m", smoke=True).with_(dtype=DTYPE)
    tcfg = tget_config("smollm-360m", smoke=True).with_(dtype=DTYPE)
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, tcfg, params, jax.tree.map(np.asarray, params)


def _model(served):
    return bridge.lm_from_jax(served[3], served[1], device="cpu")


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _run(pkg, eng, prompts, max_new):
    sched = pkg.ContinuousBatchingScheduler(eng)
    reqs = [pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    sched.submit(reqs)
    return [r.generated for r in reqs], sched.run_to_completion()


def port_run(served, prompts, *, max_new=6, slots=3, max_len=96, spec=None, **kw):
    """The port's engine alone. → (tokens, stats, engine)."""
    eng = ts.Engine(_model(served), served[1], max_slots=slots, max_len=max_len,
                    spec=None if spec is None else tspec.SpecConfig(**spec), device="cpu", **kw)
    return (*_run(ts, eng, prompts, max_new), eng)


def chunked_pair(served, prompts, *, max_new=6, slots=3, max_len=96, spec=None, **kw):
    """The port's chunked engine against the JAX chunked engine (same
    tokens, same counters) and the port's whole-prompt engine (same
    tokens). → the port's (tokens, stats, engine)."""
    jcfg, _, params, _ = served
    jsp = None
    if spec is not None:
        jkw = dict(spec)
        if spec.get("drafter") == "model":
            jkw.update(draft_params=params, draft_cfg=jcfg)
        jsp = jspec.SpecConfig(**jkw)
        if spec.get("drafter") == "model":
            spec = dict(spec, draft_params=_model(served), draft_cfg=served[1])
    jg, jst = _run(js, js.Engine(params, jcfg, max_slots=slots, max_len=max_len, spec=jsp, **kw),
                   prompts, max_new)
    got, stats, eng = port_run(served, prompts, max_new=max_new, slots=slots, max_len=max_len,
                               spec=spec, **kw)
    assert got == jg
    for f in _STATS:
        assert getattr(stats, f) == getattr(jst, f), f
    assert len(stats.ttft_s) == len(jst.ttft_s)
    base, _, _ = port_run(served, prompts, max_new=max_new, slots=slots, max_len=max_len)
    assert_same_or_near_tie(served, prompts, got, base, max_len)
    return got, stats, eng


def assert_same_or_near_tie(served, prompts, got, base, max_len):
    """`got` equals the whole-prompt tokens `base`, or each request's first
    divergent token is a near-tie of the whole-prompt logits there."""
    tcfg = served[1]
    model = _model(served)
    for prompt, g, b in zip(prompts, got, base):
        if g == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(g, b)) if x != y)
        cache = tm.init_cache(tcfg, 1, max_len, device="cpu")
        with torch.no_grad():
            logits, cache, _ = tm.prefill_into_slot(model, cache, 0, prompt, tcfg,
                                                    max_len=max_len)
            for tok in b[:t]:
                logits, cache = tm.decode_step(model, torch.tensor([[tok]], dtype=torch.int32),
                                               cache, tcfg)
        row = logits[0]
        assert int(torch.argmax(row)) == b[t]
        gap = float(row[b[t]] - row[g[t]])
        assert gap <= TIE_RTOL * float(row.abs().max()), (t, b[t], g[t], gap)


# --------------------------------------------------------------------------
# prefill_bucket max_len clamp (pure)
# --------------------------------------------------------------------------
class TestPrefillBucket:
    def test_rounds_up_to_16(self):
        assert [tm.prefill_bucket(n) for n in (1, 16, 17)] == [16, 16, 32]

    @pytest.mark.parametrize("n,max_len,want", [(19, 20, 20), (30, 32, 32), (17, 20, 20),
                                                (19, 19, 19), (19, 512, 32), (19, None, 32)])
    def test_clamped_to_max_len(self, n, max_len, want):
        assert tm.prefill_bucket(n, max_len=max_len) == jm.prefill_bucket(n, max_len) == want


# --------------------------------------------------------------------------
# Chunked admission mechanics (no forward pass)
# --------------------------------------------------------------------------
class TestChunkedAdmission:
    def test_claim_runs_no_forward(self, served):
        """Admission only claims the slot: with no model at all, three
        requests sit in PREFILLING with nothing generated."""
        eng = ts.Engine(None, served[1], max_slots=3, max_len=64, prefill_chunk=16, device="cpu")
        for i in range(3):
            assert eng.add(ts.Request(rid=i, prompt=np.arange(8, dtype=np.int32),
                                      max_new_tokens=4))
        assert sorted(eng.prefilling) == [0, 1, 2]
        assert eng.has_work and eng.n_active == 0
        assert all(not r.generated for r in eng.prefilling.values())
        assert not eng.add(ts.Request(rid=3, prompt=np.arange(8, dtype=np.int32)))

    def test_claim_resets_only_its_slot(self, served):
        eng = ts.Engine(None, served[1], max_slots=3, max_len=64, prefill_chunk=16, device="cpu")
        eng.cache = tm.rollback_cache(eng.cache, torch.tensor([5, 6, 7]))
        assert eng.add(ts.Request(rid=0, prompt=np.arange(8, dtype=np.int32)))
        for layer in eng.cache:
            np.testing.assert_array_equal(layer["idx"].numpy(), [0, 6, 7])

    def test_admission_budget_still_enforced(self, served):
        eng = ts.Engine(None, served[1], max_slots=1, max_len=32, prefill_chunk=16, device="cpu")
        with pytest.raises(ValueError, match="max_len"):
            eng.add(ts.Request(rid=0, prompt=np.arange(30, dtype=np.int32), max_new_tokens=8))

    def test_rejects_windowed_and_ssm_archs(self, served):
        tcfg = served[1]
        with pytest.raises(ValueError, match="window"):
            ts.Engine(None, tcfg.with_(layers=uniform_layers(2, window=8)), max_slots=1,
                      max_len=64, prefill_chunk=16, device="cpu")
        with pytest.raises(ValueError, match="ssm"):
            ts.Engine(None, tcfg.with_(layers=uniform_layers(2, mixer="ssm")), max_slots=1,
                      max_len=64, prefill_chunk=16, device="cpu")

    @pytest.mark.parametrize("kw,match", [(dict(prefill_chunk=-1), "prefill_chunk"),
                                          (dict(prefill_chunk=128), "max_len"),
                                          (dict(token_budget=-1), "token_budget")])
    def test_knob_validation(self, served, kw, match):
        with pytest.raises(ValueError, match=match):
            ts.Engine(None, served[1], max_len=64, device="cpu", **kw)


# --------------------------------------------------------------------------
# Greedy exactness
# --------------------------------------------------------------------------
LENS = (7, 19, 34, 4, 25)           # shorter and longer than a 16-token chunk


class TestChunkedExactness:
    def test_chunk16(self, served):
        _, stats, _ = chunked_pair(served, _prompts(served[0].vocab, LENS), prefill_chunk=16)
        assert stats.chunk_steps > 0 and stats.prefill_tokens == sum(LENS)

    def test_chunk64_prompts_shorter_and_longer(self, served):
        _, stats, _ = chunked_pair(served, _prompts(served[0].vocab, (7, 40, 70)), max_len=160,
                                   prefill_chunk=64)
        assert stats.chunk_steps > 0

    @pytest.mark.parametrize("spec", [dict(k=3), dict(k=3, adaptive_k=True), dict(k=3, tree=(2,))],
                             ids=["chain", "adaptive", "tree"])
    def test_spec_modes(self, served, spec):
        """PREFILLING slots join draft/verify rows only after their last
        chunk; every spec mode stays exact under chunked prefill."""
        _, stats, _ = chunked_pair(served, _prompts(served[0].vocab, LENS), prefill_chunk=16,
                                   spec=spec)
        assert stats.spec_steps > 0 and stats.chunk_steps > 0

    def test_spec_model_drafter(self, served):
        """The ModelDrafter syncs the whole prompt once, after the last
        chunk (self-drafting oracle: every draft accepted)."""
        _, stats, _ = chunked_pair(served, _prompts(served[0].vocab, (7, 19, 34)),
                                   prefill_chunk=16, spec=dict(k=3, drafter="model"))
        assert stats.accepted_tokens == stats.drafted_tokens > 0

    def test_tree_window_wider_than_chunk(self, served):
        """Tree (2, 2) at k 3 verifies 11 nodes per row, more than a chunk
        of 8. The PREFILLING rows are verified in the same step, writing
        node j at slot pos+j with the lower position pos+depth(j); none of
        that may survive for the row's next chunk to attend. After every
        tick each cache slot holds its own position or none, and the tokens
        are the whole-prompt engine's. The JAX engine leaves those nodes in
        place, so it is no reference here."""
        prompts = _prompts(served[0].vocab, LENS)
        eng = ts.Engine(_model(served), served[1], max_slots=3, max_len=96, prefill_chunk=8,
                        spec=tspec.SpecConfig(k=3, tree=(2, 2)), device="cpu")
        sched = ts.ContinuousBatchingScheduler(eng)
        reqs = [ts.Request(rid=i, prompt=p.copy(), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        sched.submit(reqs)
        mixed = 0                   # tree steps with a row mid-prefill
        while sched.queue or eng.has_work:
            mixed += bool(eng.prefilling) and bool(eng.active.any())
            sched.tick()
            for layer in eng.cache:
                sp = layer["slot_pos"]
                own = torch.arange(sp.shape[1], dtype=sp.dtype)[None, :]
                assert bool(((sp < 0) | (sp == own)).all())
        assert mixed > 0 and eng.spec_steps > 0 and eng.chunk_steps > 0
        assert all(r.done for r in reqs)
        base, _, _ = port_run(served, prompts)
        assert_same_or_near_tie(served, prompts, [r.generated for r in reqs], base, 96)

    def test_ttft_recorded_after_last_chunk(self, served):
        _, stats, _ = port_run(served, _prompts(served[0].vocab, (34, 7)), prefill_chunk=16)
        assert len(stats.ttft_s) == 2 and all(t > 0 for t in stats.ttft_s)


# --------------------------------------------------------------------------
# Write window at the cache end: padded columns past max_len are dropped
# --------------------------------------------------------------------------
class TestChunkWindowBoundary:
    def test_final_chunk_crossing_max_len(self, served):
        """Prompt 70, chunk 64, max_len 96: the last chunk's columns at
        positions 96..127 are dropped, not wrapped onto 0..31."""
        chunked_pair(served, _prompts(served[0].vocab, (70,)), max_len=96, slots=2,
                     prefill_chunk=64)

    def test_decode_rider_near_max_len(self, served):
        """A decode row's pad columns cross max_len once its position nears
        the cache end."""
        chunked_pair(served, _prompts(served[0].vocab, (40, 70)), max_len=96, slots=2,
                     max_new=20, prefill_chunk=64)


# --------------------------------------------------------------------------
# Token budget
# --------------------------------------------------------------------------
class TestTokenBudget:
    def test_budget_paces_chunks_without_changing_output(self, served):
        prompts = _prompts(served[0].vocab, (34, 34, 34))
        wide, swide, _ = port_run(served, prompts, prefill_chunk=16)
        tight, stight, _ = chunked_pair(served, prompts, prefill_chunk=16, token_budget=16)
        assert wide == tight      # the budget moves no token
        assert stight.chunk_steps > swide.chunk_steps
        assert stight.chunk_steps == 9        # 3 prompts x ceil(34/16), one per tick

    def test_budget_always_advances_one_chunk(self, served):
        _, stats, _ = chunked_pair(served, _prompts(served[0].vocab, (34,)), prefill_chunk=16,
                                   token_budget=1)
        assert stats.completed == 1


# --------------------------------------------------------------------------
# Prefill-path regressions
# --------------------------------------------------------------------------
class TestPrefillBugfixes:
    def test_bucket_boundary_prompt_is_exact(self, served):
        """A prompt within 15 tokens of max_len (max_new_tokens=1): the
        clamped bucket reproduces the unpadded forward's argmax, and the
        JAX engine's token."""
        jcfg, tcfg, params, _ = served
        prompt = _prompts(jcfg.vocab, (19,))[0]
        model = _model(served)
        eng = ts.Engine(model, tcfg, max_slots=1, max_len=20, device="cpu")
        req = ts.Request(rid=0, prompt=prompt, max_new_tokens=1)
        assert eng.add(req)
        with torch.no_grad():
            h, _, _ = tm.lm_hidden(model, torch.from_numpy(prompt)[None], tcfg, mode="serve")
            want = int(torch.argmax(tm.lm_logits(model, h[:, -1], tcfg)))
        jreq = js.Request(rid=0, prompt=prompt, max_new_tokens=1)
        assert js.Engine(params, jcfg, max_slots=1, max_len=20).add(jreq)
        assert req.generated == jreq.generated == [want]

    def test_prefill_tokens_count_real_work(self, served):
        lens = (13, 16, 5)
        _, stats, _ = port_run(served, _prompts(served[0].vocab, lens), max_new=2)
        assert stats.prefill_tokens == sum(lens)
        assert stats.prefill_pad_tokens == sum(16 - n for n in lens)

    def test_idle_tick_skips_decode(self, served):
        got, stats, eng = port_run(served, _prompts(served[0].vocab, (6, 9, 12)), max_new=1)
        assert stats.completed == 3 and all(len(g) == 1 for g in got)
        assert eng.decode_steps == eng.chunk_steps == 0
        assert stats.decode_steps == stats.decode_tokens == 0

    def test_scheduler_counts_prefilling_as_pending(self, served):
        got, stats, _ = chunked_pair(served, _prompts(served[0].vocab, (34, 25)), max_new=1,
                                     prefill_chunk=16)
        assert stats.completed == 2 and all(len(g) == 1 for g in got)
        assert stats.decode_steps == stats.decode_tokens == 0 and stats.chunk_steps > 0


# --------------------------------------------------------------------------
# last-position logits: the chunk step's head matmul is (B, 1, d)
# --------------------------------------------------------------------------
class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


class TestLastPositionLogits:
    def test_logit_cols_matches_full_logits(self, served):
        _, tcfg, _, _ = served
        model = _model(served)
        b, s = 3, 8
        toks = torch.from_numpy(_prompts(tcfg.vocab, (b * s,))[0].reshape(b, s))
        cols = torch.tensor([0, s - 1, 3], dtype=torch.int32)
        with torch.no_grad():
            full, _ = tm.verify_step(model, toks, tm.init_cache(tcfg, b, 64, device="cpu"), tcfg,
                                     prefill_resume=True)
            rows, _ = tm.verify_step(model, toks, tm.init_cache(tcfg, b, 64, device="cpu"), tcfg,
                                     prefill_resume=True, logit_cols=cols)
        assert rows.shape == (b, tcfg.vocab)
        want = full[torch.arange(b), cols.long()]
        np.testing.assert_allclose(rows.numpy(), want.numpy(), rtol=COLS_TOL, atol=COLS_TOL)

    def test_chunk_step_never_materializes_full_vocab(self, served):
        """No op of a chunk step (one slot mid-prompt, one decoding) returns
        a (max_slots, chunk, vocab) tensor; the step's logits are per slot."""
        tcfg = served[1]
        slots, chunk = 3, 16
        eng = ts.Engine(_model(served), tcfg, max_slots=slots, max_len=96, prefill_chunk=chunk,
                        device="cpu")
        prompts = _prompts(tcfg.vocab, (7, 40))
        assert eng.add(ts.Request(rid=0, prompt=prompts[0], max_new_tokens=8))
        eng.step()                                     # request 0 now decoding
        assert eng.add(ts.Request(rid=1, prompt=prompts[1], max_new_tokens=8))
        with _Shapes() as mode:
            eng.step()
        assert eng.chunk_steps == 2 and eng.n_active == 1 and eng.prefilling
        assert (slots, chunk, tcfg.vocab) not in mode.shapes
        assert (slots, tcfg.vocab) in mode.shapes
