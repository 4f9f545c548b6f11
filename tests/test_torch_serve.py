"""repro_torch.serve against the JAX package's serving engine on bridged
smoke weights: greedy serving must be token-identical, with the same
scheduler bookkeeping."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import models as jm  # noqa: E402
from repro import serve as js  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import serve as ts  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402

MAX_LEN = 48
# the 40-token prompt's bucket is clamped to max_len: its admission prefill
# fills the whole cache (the `s >= buf` write branch); the last request can
# never fit and is rejected
PROMPT_LENS = (5, 13, 40, 20)
TOO_LONG = 45


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("smollm-360m", smoke=True).with_(dtype="float32")
    tcfg = tget_config("smollm-360m", smoke=True).with_(dtype="float32")
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab, size=n).astype(np.int32)
               for n in PROMPT_LENS + (TOO_LONG,)]
    return jcfg, tcfg, params, prompts


def _run(pkg, engine, prompts):
    sched = pkg.ContinuousBatchingScheduler(engine)
    reqs = [pkg.Request(rid=i, prompt=p, max_new_tokens=8) for i, p in enumerate(prompts)]
    sched.submit(reqs)
    stats = sched.run_to_completion()
    return reqs, sched, stats


def test_greedy_serving_token_identical(served):
    jcfg, tcfg, params, prompts = served
    jreqs, jsched, jstats = _run(js, js.Engine(params, jcfg, max_slots=3, max_len=MAX_LEN), prompts)
    for impl in ("decode", "lookup"):
        model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
        eng = ts.Engine(model, tcfg, max_slots=3, max_len=MAX_LEN, mpgemm_impl=impl, device="cpu")
        treqs, tsched, tstats = _run(ts, eng, prompts)
        assert [r.generated for r in treqs] == [r.generated for r in jreqs]
        assert all(len(r.generated) == 8 for r in treqs[:4]) and treqs[4].error
        assert [r.rid for r in tsched.completed] == [r.rid for r in jsched.completed]
        assert [r.rid for r in tsched.rejected] == [r.rid for r in jsched.rejected] == [4]
        for field in ("prefill_tokens", "prefill_pad_tokens", "decode_tokens",
                      "decode_steps", "completed", "rejected"):
            assert getattr(tstats, field) == getattr(jstats, field), field
        assert len(tstats.ttft_s) == len(jstats.ttft_s) == 4


def test_engine_refuses_unported_options(served):
    jcfg, tcfg, params, _ = served
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    for kw in (dict(paged_kv=object()), dict(obs=object())):
        with pytest.raises(NotImplementedError):
            ts.Engine(model, tcfg, max_slots=2, max_len=32, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.Engine(model, tcfg, max_slots=2, max_len=32)


def test_greedy_sample_matches_argmax():
    logits = np.random.default_rng(0).standard_normal((6, 50)).astype(np.float32)
    logits[2, [4, 9]] = 10.0                       # a tie: the first index wins
    got = ts.sample(torch.from_numpy(logits)).numpy()
    want = np.asarray(js.sample(jnp.asarray(logits), jax.random.PRNGKey(0)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got[2] == 4


@pytest.mark.parametrize("top_k", [0, 3])
def test_temperature_sampling_distribution(top_k):
    """jax.random and torch.Generator draw different streams, so the check
    is distributional: total-variation distance between the two packages'
    empirical distributions over 20000 draws, each against the exact
    tempered (top-k) softmax. TV of 20000 draws over 8 outcomes from the
    true distribution is ~0.01; the bound is 0.03."""
    n, temp = 20000, 0.7
    base = np.array([1.0, 0.2, -0.5, 2.0, 0.0, -1.0, 1.5, 0.3], np.float32)
    logits = np.tile(base, (n, 1))
    tdraw = ts.sample(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                      temperature=temp, top_k=top_k).numpy()
    jdraw = np.asarray(js.sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                                 temperature=temp, top_k=top_k))
    p = np.exp(base / temp)
    if top_k:
        p[np.argsort(-base)[top_k:]] = 0.0
    p /= p.sum()
    hist = [np.bincount(d, minlength=8) / n for d in (tdraw, jdraw)]
    for h in hist:
        assert 0.5 * np.abs(h - p).sum() < 0.03
    assert 0.5 * np.abs(hist[0] - hist[1]).sum() < 0.03
    if top_k:
        assert set(np.unique(tdraw)) <= set(np.argsort(-base)[:top_k])
    with pytest.raises(ValueError):
        ts.sample(torch.from_numpy(logits[:1]), temperature=1.0, top_k=-1)


def test_top_k_keeps_exactly_k_on_ties():
    """Mirror of tests/test_serve.py's tie regression: three tied logits and
    top_k=2 keep exactly tokens 0 and 1 (ties break toward lower ids)."""
    logits = torch.tensor([[1.0, 1.0, 1.0, 0.0, 0.0, 0.0]])
    seen = {int(ts.sample(logits, torch.Generator().manual_seed(s), temperature=1.0,
                          top_k=2)[0]) for s in range(64)}
    assert seen == {0, 1}


@pytest.mark.parametrize("row,top_k", [([1.0, 5.0, 3.0, 5.0, 5.0, 0.0, 5.0], 2),
                                       ([1.0, 5.0, 3.0, 5.0, 5.0, 0.0, 5.0], 3),
                                       ([2.0, 2.0, 2.0, 2.0], 1),
                                       ([0.5, -1.0, 0.5, 3.0, 0.5], 3)])
def test_top_k_kept_set_matches_jax(row, top_k):
    """The kept set is the one jax.lax.top_k picks, ties at the k-th logit
    included ([1, 5, 3, 5, 5, 0, 5], k=2 keeps {1, 3}; torch.topk would keep
    {3, 6}). Draws at a high temperature reach every kept token."""
    logits = np.asarray([row], np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(logits), top_k)
    want = set(np.asarray(jidx)[0].tolist())
    n = 4000
    tdraw = ts.sample(torch.from_numpy(np.tile(logits, (n, 1))), torch.Generator().manual_seed(0),
                      temperature=100.0, top_k=top_k).numpy()
    jdraw = np.asarray(js.sample(jnp.asarray(np.tile(logits, (n, 1))), jax.random.PRNGKey(0),
                                 temperature=100.0, top_k=top_k))
    assert set(np.unique(tdraw).tolist()) == want == set(np.unique(jdraw).tolist())


@pytest.mark.parametrize("wall_s,prefill,decode", [(0.0, 5, 7), (2.5, 100, 40), (0.125, 3, 0)])
def test_serve_stats_rates_match_jax(wall_s, prefill, decode):
    """ServeStats.decode_tok_s and prefill_tok_s: tokens over wall_s, 0 when
    wall_s is 0, as JAX's ServeStats defines them on the same counts."""
    kw = dict(wall_s=wall_s, prefill_tokens=prefill, decode_tokens=decode)
    got, want = ts.ServeStats(**kw), js.ServeStats(**kw)
    for name in ("decode_tok_s", "prefill_tok_s", "throughput_tok_s"):
        assert getattr(got, name) == getattr(want, name), name


def test_serve_cli_spec_and_chunked(capsys):
    """The launcher's speculative and chunked flags on the CPU: every
    request completes and the spec stats are printed."""
    from repro_torch.launch import serve as launch

    stats = launch.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--spec-k", "3",
                         "--prefill-chunk", "16", "--requests", "3", "--slots", "2",
                         "--max-new", "6", "--prompt-len", "20"])
    out = capsys.readouterr().out
    assert stats.completed == 3 and stats.chunk_steps > 0 and stats.spec_steps > 0
    assert "completed=3/3" in out
    assert f"spec: k=3 tree=None adaptive=False steps={stats.spec_steps} " in out
    assert f"accepted={stats.accepted_tokens} " in out and "acceptance=" in out
    with pytest.raises(SystemExit):
        launch.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--token-budget", "8"])
