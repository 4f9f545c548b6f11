"""repro_torch.spec, the acceptance rules, the verify step and the
speculative engine against the JAX package (the non-MLA cases of
tests/test_spec.py), on bridged weights of the smollm-360m smoke config in
f32 and the same numpy inputs on both sides."""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

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

#: verify_step against sequential decode, as tests/test_spec.py bounds it
VERIFY_TOL = 2e-4
#: the port's verify_step against JAX's on the same tokens and cache: the
#: f32 model bound of tests/test_torch_models.py (reductions in another
#: order; an int8 activation code at a rounding boundary)
JAX_TOL = 1e-5
#: total variation of 4000 draws from the exact distribution over 12 tokens
#: is ~0.02; the bound is tests/test_spec.py's
TV_BOUND = 0.08


@pytest.fixture(scope="module")
def served():
    jcfg = jget_config("smollm-360m", smoke=True).with_(dtype="float32")
    tcfg = tget_config("smollm-360m", smoke=True).with_(dtype="float32")
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(0), jcfg), jcfg)
    np_params = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, np_params


def _model(served):
    return bridge.lm_from_jax(served[3], served[1], device="cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a))


# --------------------------------------------------------------------------
# Drafters
# --------------------------------------------------------------------------
def _both_propose(cls_kw, contexts, k, **kw):
    got = tspec.NgramDrafter(**cls_kw).propose(contexts, k, **kw)
    want = jspec.NgramDrafter(**cls_kw).propose(contexts, k, **kw)
    np.testing.assert_array_equal(got, want)
    return got


class TestNgramDrafter:
    def test_prompt_lookup_continuation(self):
        out = _both_propose(dict(max_n=3, min_n=1), [np.array([1, 2, 3, 4, 9, 1, 2, 3])], 2)
        np.testing.assert_array_equal(out[0], [4, 9])

    def test_most_recent_match_wins(self):
        out = _both_propose(dict(max_n=2, min_n=1), [np.array([7, 1, 7, 2, 7])], 2)
        np.testing.assert_array_equal(out[0], [2, 7])

    def test_fallback_repeats_last_token(self):
        np.testing.assert_array_equal(_both_propose({}, [np.array([5])], 3)[0], [5, 5, 5])
        np.testing.assert_array_equal(_both_propose({}, [np.array([1, 2, 3, 4])], 2)[0], [4, 4])

    def test_short_continuation_padded(self):
        out = _both_propose(dict(max_n=1, min_n=1), [np.array([8, 3, 8])], 4)
        np.testing.assert_array_equal(out[0], [3, 8, 8, 8])

    def test_free_slots_skipped(self):
        out = _both_propose({}, [None, np.array([4, 4, 4])], 2)
        assert out.shape == (2, 2)
        np.testing.assert_array_equal(out[1], [4, 4])


class TestNgramTreeProposal:
    def test_branches_are_distinct_continuations(self):
        ctx = np.array([5, 8, 5, 8, 5, 3, 5])
        out = _both_propose(dict(max_n=1, min_n=1), [ctx], 2,
                            tree=tspec.build_tree(2, (2,)))[0]
        assert out[0] == 8 and out[1] == 3 and out.shape == (4,)

    def test_fewer_matches_than_branches_pads(self):
        out = _both_propose(dict(max_n=1, min_n=1), [np.array([5, 8, 5])], 1,
                            tree=tspec.build_tree(1, (3,)))[0]
        np.testing.assert_array_equal(out, [8, 8, 8])

    def test_free_slots_skipped(self):
        t = tspec.build_tree(2, (2,))
        out = _both_propose({}, [None, np.array([4, 4, 4])], 2, tree=t)
        assert out.shape == (2, t.n_draft)
        np.testing.assert_array_equal(out[0], 0)


# --------------------------------------------------------------------------
# Acceptance rules
# --------------------------------------------------------------------------
def _onehot_logits(picks, v):
    """Log of a near point mass at picks (numpy)."""
    oh = np.eye(v, dtype=np.float32)[np.asarray(picks)]
    return np.log(oh * (1 - 1e-6) + 1e-9).astype(np.float32)


class TestAcceptance:
    def test_greedy_accept_prefix_lengths(self):
        draft = np.array([[1, 2, 3], [1, 9, 3], [9, 2, 3], [1, 2, 9]], np.int32)
        tgt = np.array([[1, 2, 3, 4]] * 4, np.int32)
        got = ts.greedy_accept(_t(draft), _t(tgt)).numpy()
        np.testing.assert_array_equal(got, [3, 1, 0, 2])
        np.testing.assert_array_equal(got, np.asarray(js.greedy_accept(draft, tgt)))
        assert got.dtype == np.int32

    @pytest.mark.parametrize("seed", range(4))
    def test_greedy_rules_match_jax_bit_for_bit(self, seed):
        """greedy_accept and greedy accept_speculative, with and without a
        draft_mask, on random logits whose argmax the draft partly hits."""
        rng = np.random.default_rng(seed)
        b, k, v = 6, 4, 16
        logits = rng.standard_normal((b, k + 1, v)).astype(np.float32)
        draft = np.argmax(logits, -1)[:, :k].astype(np.int32)
        miss = rng.random((b, k)) < 0.3
        draft[miss] = (draft[miss] + 1) % v
        mask = np.arange(k)[None, :] < rng.integers(0, k + 1, b)[:, None]
        for m in (None, mask):
            tn, to = ts.accept_speculative(_t(draft), _t(logits), temperature=0.0,
                                           draft_mask=None if m is None else _t(m))
            jn, jo = js.accept_speculative(jnp.asarray(draft), jnp.asarray(logits),
                                           jax.random.PRNGKey(0), temperature=0.0,
                                           draft_mask=None if m is None else jnp.asarray(m))
            np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
            tg = ts.greedy_accept(_t(draft), _t(np.argmax(logits, -1).astype(np.int32)),
                                  None if m is None else _t(m))
            np.testing.assert_array_equal(tg.numpy(), np.asarray(jn))

    def test_stochastic_accepts_certain_tokens(self):
        draft = np.array([[2, 5, 1]], np.int32)
        logits = _onehot_logits([[2, 5, 1, 7]], 8)
        for seed in range(4):
            n_acc, out = ts.accept_speculative(_t(draft), _t(logits),
                                               torch.Generator().manual_seed(seed), temperature=1.0)
            jn, jo = js.accept_speculative(jnp.asarray(draft), jnp.asarray(logits),
                                           jax.random.PRNGKey(seed), temperature=1.0)
            assert int(n_acc[0]) == int(jn[0]) == 3
            np.testing.assert_array_equal(out[0].numpy(), [2, 5, 1, 7])
            np.testing.assert_array_equal(out.numpy(), np.asarray(jo))

    def test_stochastic_rejects_impossible_tokens(self):
        draft = np.array([[3, 3, 3]], np.int32)
        logits = _onehot_logits([[5, 5, 5, 5]], 8)
        for seed in range(4):
            n_acc, out = ts.accept_speculative(_t(draft), _t(logits),
                                               torch.Generator().manual_seed(seed), temperature=1.0)
            jn, jo = js.accept_speculative(jnp.asarray(draft), jnp.asarray(logits),
                                           jax.random.PRNGKey(seed), temperature=1.0)
            assert int(n_acc[0]) == int(jn[0]) == 0
            assert int(out[0, 0]) == int(jo[0, 0]) == 5

    def test_masked_greedy_accept_caps_prefix(self):
        draft = np.array([[1, 2, 3], [1, 2, 3]], np.int32)
        tgt = np.array([[1, 2, 3, 4]] * 2, np.int32)
        mask = np.array([[True, True, False], [False, False, False]])
        got = ts.greedy_accept(_t(draft), _t(tgt), _t(mask)).numpy()
        np.testing.assert_array_equal(got, [2, 0])
        np.testing.assert_array_equal(got, np.asarray(js.greedy_accept(draft, tgt, mask)))

    def test_masked_greedy_out_is_plain_argmax(self):
        logits = np.random.default_rng(0).standard_normal((2, 4, 16)).astype(np.float32)
        draft = np.argmax(logits, -1)[:, :3].astype(np.int32)
        mask = np.array([[True, True, False], [False, False, False]])
        n_acc, out = ts.accept_speculative(_t(draft), _t(logits), temperature=0.0,
                                           draft_mask=_t(mask))
        np.testing.assert_array_equal(n_acc.numpy(), [2, 0])
        np.testing.assert_array_equal(out.numpy(), np.argmax(logits, -1))

    def test_masked_stochastic_never_accepts_padding(self):
        draft = np.array([[2, 5, 1]], np.int32)
        logits = _onehot_logits([[2, 5, 1, 7]], 8)
        mask = np.array([[True, False, False]])
        for seed in range(8):
            n_acc, out = ts.accept_speculative(_t(draft), _t(logits),
                                               torch.Generator().manual_seed(seed),
                                               temperature=1.0, draft_mask=_t(mask))
            jn, jo = js.accept_speculative(jnp.asarray(draft), jnp.asarray(logits),
                                           jax.random.PRNGKey(seed), temperature=1.0,
                                           draft_mask=jnp.asarray(mask))
            assert int(n_acc[0]) == int(jn[0]) == 1
            np.testing.assert_array_equal(out[0, :2].numpy(), [2, 5])
            np.testing.assert_array_equal(np.asarray(jo[0, :2]), [2, 5])

    def test_rejected_token_never_resampled_on_vanishing_residual(self):
        v, k = 8, 2
        draft = np.array([[3, 3]], np.int32)
        logits = np.zeros((1, k + 1, v), np.float32)
        logits[:, :, 3] = 2.0                           # p(3) ≈ 0.51
        q = np.full((1, k, v), 1e6, np.float32)        # q >= p: residual ≡ 0
        for seed in range(64):
            n_acc, out = ts.accept_speculative(_t(draft), _t(logits),
                                               torch.Generator().manual_seed(seed),
                                               temperature=1.0, draft_probs=_t(q))
            assert int(n_acc[0]) == 0
            assert int(out[0, 0]) != 3

    @staticmethod
    def _tv(toks, p, v):
        return 0.5 * np.abs(np.bincount(toks, minlength=v) / len(toks) - p).sum()

    def test_stochastic_draft_probs_exact_distribution(self):
        """With sampled proposals q as draft_probs the emitted token at
        position 0 is distributed as the target's softmax: TV below
        TV_BOUND for the port's draws and for JAX's on the same logits."""
        v, k, n = 12, 2, 4000
        tl = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, k + 1, v)) * 1.5)
        q = np.asarray(jax.nn.softmax(jax.random.normal(jax.random.PRNGKey(1), (1, k, v)) * 1.5,
                                      axis=-1))
        gen = torch.Generator().manual_seed(2)
        qt = _t(np.repeat(q, n, axis=0))
        draft = torch.multinomial(qt.reshape(-1, v), 1, generator=gen).reshape(n, k)
        _, out = ts.accept_speculative(draft, _t(np.repeat(tl, n, axis=0)), gen,
                                       temperature=1.0, draft_probs=qt)

        def one(key):
            kd, ka = jax.random.split(key)
            d = jax.random.categorical(kd, jnp.log(q), axis=-1)
            return js.accept_speculative(d.astype(jnp.int32), tl, ka, temperature=1.0,
                                         draft_probs=q)[1][0, 0]

        jtoks = np.asarray(jax.vmap(one)(jax.random.split(jax.random.PRNGKey(2), n)))
        p0 = np.asarray(jax.nn.softmax(tl[0, 0]))
        assert self._tv(out[:, 0].numpy(), p0, v) < TV_BOUND
        assert self._tv(jtoks, p0, v) < TV_BOUND

    def test_masked_correction_samples_full_target(self):
        v, n = 12, 4000
        tl = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 3, v)) * 1.5)
        sm = np.exp(tl[:, 0] - tl[:, 0].max()) / np.exp(tl[:, 0] - tl[:, 0].max()).sum()
        q = np.stack([sm, np.full((1, v), 1.0 / v)], axis=1).astype(np.float32)
        gen = torch.Generator().manual_seed(4)
        qt = _t(np.repeat(q, n, axis=0))
        draft = torch.multinomial(qt.reshape(-1, v), 1, generator=gen).reshape(n, 2)
        n_acc, out = ts.accept_speculative(
            draft, _t(np.repeat(tl, n, axis=0)), gen, temperature=1.0, draft_probs=qt,
            draft_mask=_t(np.repeat(np.array([[True, False]]), n, axis=0)))
        np.testing.assert_array_equal(n_acc.numpy(), np.ones(n))
        p1 = np.exp(tl[0, 1] - tl[0, 1].max())
        assert self._tv(out[:, 1].numpy(), p1 / p1.sum(), v) < TV_BOUND


# --------------------------------------------------------------------------
# Draft trees
# --------------------------------------------------------------------------
class TestDraftTree:
    @pytest.mark.parametrize("k,branching", [(4, (2, 2)), (2, (2,)), (3, (3, 2)), (1, (3,))])
    def test_layout_matches_jax(self, k, branching):
        t, j = tspec.build_tree(k, branching), jspec.build_tree(k, branching)
        assert (t.k, t.branching, t.n_nodes, t.n_draft) == (j.k, j.branching, j.n_nodes, j.n_draft)
        for f in ("parents", "depths", "ranks", "ancestors", "leaf_paths"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))

    def test_structure_chain_after_branching(self):
        t = tspec.build_tree(4, (2, 2))
        assert t.n_nodes == 15 and t.n_draft == 14 and t.branching == (2, 2, 1, 1)
        np.testing.assert_array_equal(np.bincount(t.depths), [1, 2, 4, 4, 4])
        for path in t.leaf_paths:
            assert path[0] == 0
            for d in range(1, 5):
                assert t.parents[path[d]] == path[d - 1]

    def test_validation(self):
        with pytest.raises(ValueError, match="at most k deep"):
            tspec.build_tree(2, (2, 2, 2))
        with pytest.raises(ValueError, match=">= 1"):
            tspec.build_tree(2, (0,))
        with pytest.raises(ValueError, match="nodes"):
            tspec.build_tree(4, (8, 8, 8))
        with pytest.raises(ValueError, match="adaptive_k"):
            tspec.SpecConfig(k=2, tree=(2,), adaptive_k=True)
        with pytest.raises(ValueError, match="stochastic"):
            tspec.SpecConfig(k=2, tree=(2,), drafter="model", stochastic=True,
                             draft_params={}, draft_cfg={})
        with pytest.raises(ValueError, match="at most k deep"):
            tspec.SpecConfig(k=1, tree=(2, 2))
        assert tspec.SpecConfig(k=3, tree=(2,)).tree_struct().n_nodes == 7
        assert tspec.SpecConfig(k=3).tree_struct() is None


class TestAcceptTree:
    def _both(self, tokens, picks, tree, v=16, temperature=0.0, seed=0):
        logits = _onehot_logits(picks, v)
        got = ts.accept_tree(_t(np.asarray(tokens, np.int32)), _t(logits), tree,
                             torch.Generator().manual_seed(seed), temperature=temperature)
        want = js.accept_tree(jnp.asarray(tokens, jnp.int32), jnp.asarray(logits), tree,
                              jax.random.PRNGKey(seed), temperature=temperature)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert g.dtype == torch.int32
        return [g.numpy() for g in got]

    def test_longest_path_wins(self):
        n_acc, out, path = self._both([[5, 7, 9, 7, 8]], [[9, 0, 8, 0, 3]], tspec.build_tree(2, (2,)))
        assert n_acc[0] == 2
        np.testing.assert_array_equal(out[0], [9, 8, 3])
        np.testing.assert_array_equal(path[0], [0, 2, 4])

    def test_no_match_emits_correction_only(self):
        n_acc, out, _ = self._both([[5, 7, 9, 7, 8]], [[1, 0, 0, 0, 0]], tspec.build_tree(2, (2,)))
        assert n_acc[0] == 0 and out[0, 0] == 1

    def test_tie_resolves_to_lowest_rank_branch(self):
        n_acc, out, path = self._both([[5, 7, 7, 1, 2]], [[7, 9, 9, 0, 0]],
                                      tspec.build_tree(2, (2,)))
        assert n_acc[0] == 1
        np.testing.assert_array_equal(path[0], [0, 1, 3])
        np.testing.assert_array_equal(out[0, :2], [7, 9])

    @pytest.mark.parametrize("seed", range(4))
    def test_random_batches_match_jax(self, seed):
        """Greedy accept_tree on random trees whose nodes partly hit the
        target's picks, batch of 5, against JAX bit for bit."""
        rng = np.random.default_rng(seed)
        tree = tspec.build_tree(3, (2, 2))
        v = 6
        picks = rng.integers(0, v, (5, tree.n_nodes))
        tokens = picks[:, tree.parents].copy()
        miss = rng.random(tokens.shape) < 0.4
        tokens[miss] = rng.integers(0, v, miss.sum())
        self._both(tokens, picks, tree, v=v)

    def test_temperature_correction_sampled_from_last_accepted_node(self):
        t = tspec.build_tree(1, (2,))
        for seed in range(8):
            n_acc, out, _ = self._both([[5, 7, 9]], [[9, 0, 4]], t, temperature=1.0, seed=seed)
            assert n_acc[0] == 1
            np.testing.assert_array_equal(out[0], [9, 4])


# --------------------------------------------------------------------------
# compact_tree_cache: the port's layout is a list of per-layer dicts with
# the batch on axis 0 (JAX: stacked stages, batch on axis 1)
# --------------------------------------------------------------------------
class TestCompactTreeCache:
    @staticmethod
    def _run(k, sp, idx, pos, sel, take):
        """The port and JAX on the same cache; → the port's (k, slot_pos)
        after checking them against JAX's."""
        tc = [{"k": _t(k.copy()), "v": _t(-k), "slot_pos": _t(sp.copy()), "idx": _t(idx.copy())}]
        jc = {"k": jnp.asarray(k[None]), "v": jnp.asarray(-k[None]),
              "slot_pos": jnp.asarray(sp[None]), "idx": jnp.asarray(idx[None])}
        tm.compact_tree_cache(tc, _t(np.asarray(pos)), _t(np.asarray(sel)), _t(np.asarray(take)))
        jo = jm.compact_tree_cache(jc, jnp.asarray(pos), jnp.asarray(sel), jnp.asarray(take))
        for key in ("k", "v", "slot_pos", "idx"):
            np.testing.assert_array_equal(tc[0][key].numpy(), np.asarray(jo[key])[0])
        np.testing.assert_array_equal(tc[0]["idx"].numpy(), idx)   # rollback's job
        return tc[0]["k"].numpy()[:, :, 0, 0], tc[0]["slot_pos"].numpy()

    def test_moves_path_entries_and_invalidates_losers(self):
        b, L = 2, 12
        line = np.tile(np.arange(L, dtype=np.float32)[None, :, None, None], (b, 1, 1, 1))
        depths = np.array([0, 1, 1, 2, 2])
        sp = np.tile(np.arange(L, dtype=np.int32)[None], (b, 1))
        sp[0, 3:8] = 3 + depths
        sp[1, 0:5] = 0 + depths
        k, spo = self._run(line, sp, np.zeros(b, np.int32), [3, 0],
                           [[0, 2, 4, 3, 4], [0, 1, 2, 3, 4]], [3, 1])
        np.testing.assert_array_equal(k[0, :3], [0, 1, 2])
        np.testing.assert_array_equal(k[0, 3:8], [3, 5, 7, 6, 7])
        np.testing.assert_array_equal(spo[0, 3:8], [3, 4, 5, -1, -1])
        np.testing.assert_array_equal(spo[1, :5], [0, -1, -1, -1, -1])
        np.testing.assert_array_equal(spo[1, 5:], np.arange(5, L))

    def test_identity_window_is_noop(self):
        L, n = 10, 4
        k0 = np.random.default_rng(3).normal(size=(1, L, 1, 1)).astype(np.float32)
        sp = np.where(np.arange(L) < 6, np.arange(L), -1).astype(np.int32)[None]
        k, spo = self._run(k0, sp, np.full(1, 6, np.int32), [0], np.arange(n)[None], [n])
        np.testing.assert_array_equal(k, k0[:, :, 0, 0])
        np.testing.assert_array_equal(spo, sp)

    def test_identity_window_crossing_buffer_end_is_noop(self):
        """Identity window whose destinations run past the buffer (a full
        buffer, a slot outside the verify step): the columns past the end
        are dropped, the rest gather themselves."""
        L, n = 10, 4
        k0 = np.random.default_rng(5).normal(size=(1, L, 1, 1)).astype(np.float32)
        sp = np.arange(L, dtype=np.int32)[None]
        k, spo = self._run(k0, sp, np.full(1, L, np.int32), [L - 2], np.arange(n)[None], [n])
        np.testing.assert_array_equal(k, k0[:, :, 0, 0])
        np.testing.assert_array_equal(spo, sp)

    def test_oob_window_columns_never_clobber_last_entry(self):
        """A non-identity window at the buffer end: the columns whose
        destination passes the end are dropped, never clamped onto (or
        wrapped over) a live entry; their sources are clamped."""
        L = 8
        k0 = np.random.default_rng(7).normal(size=(1, L, 1, 1)).astype(np.float32)
        sp = np.arange(L, dtype=np.int32)[None]
        k, spo = self._run(k0, sp, np.full(1, L, np.int32), [L - 2], [[1, 0, 2, 0]], [2])
        assert k[0, 6] == k0[0, 7, 0, 0] and k[0, 7] == k0[0, 6, 0, 0]
        assert spo[0, 6] == 7 and spo[0, 7] == 6
        np.testing.assert_array_equal(k[0, :6], k0[0, :6, 0, 0])
        np.testing.assert_array_equal(spo[0, :6], np.arange(6))


# --------------------------------------------------------------------------
# Adaptive-K policy
# --------------------------------------------------------------------------
class TestKPolicy:
    def test_fixed_when_adaptive_disabled(self):
        assert tspec.SpecConfig(k=4).k_policy(0.0) == tspec.SpecConfig(k=4).k_policy(1.0) == 4

    def test_scales_with_acceptance_ewma(self):
        kw = dict(k=4, adaptive_k=True, k_min=1, skip_below=0.2)
        c, j = tspec.SpecConfig(**kw), jspec.SpecConfig(**kw)
        for ewma, want in ((1.0, 4), (0.5, 2), (0.25, 1), (0.05, 0), (0.7, 3), (0.2, 1)):
            assert c.k_policy(ewma) == j.k_policy(ewma) == want

    def test_cold_slot_probes_after_streak(self):
        c = tspec.SpecConfig(k=4, adaptive_k=True, probe_every=3)
        assert c.k_policy(0.0, skip_streak=0) == c.k_policy(0.0, skip_streak=2) == 0
        assert c.k_policy(0.0, skip_streak=3) == c.k_min

    def test_knob_validation(self):
        for kw, match in ((dict(accept_ewma=1.0), "accept_ewma"), (dict(k_min=0), "k_min"),
                          (dict(k_min=3), "k_min"), (dict(skip_below=1.5), "skip_below"),
                          (dict(probe_every=0), "probe_every"),
                          (dict(drafter="ngram", stochastic=True), "stochastic"),
                          (dict(drafter="model"), "draft_params")):
            with pytest.raises(ValueError, match=match):
                tspec.SpecConfig(k=2, **kw)

    def test_ngram_drafter_skips_slot_k_zero(self):
        out = _both_propose({}, [np.array([4, 4, 4]), np.array([7, 7, 7])], 2,
                            slot_k=np.array([0, 2]))
        np.testing.assert_array_equal(out[0], [0, 0])
        np.testing.assert_array_equal(out[1], [7, 7])
        _, probs = tspec.NgramDrafter().propose([np.array([4, 4])], 2, return_probs=True)
        assert probs is None


# --------------------------------------------------------------------------
# Multi-token verification + rollback (model level)
# --------------------------------------------------------------------------
class TestVerifyStep:
    def _prefilled(self, served, prompt_len=12, max_len=64):
        jcfg, tcfg, params, _ = served
        model = _model(served)
        prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (1, prompt_len)).astype(np.int32)
        logits, cache = tm.prefill(model, _t(prompt), tm.init_cache(tcfg, 1, max_len, device="cpu"),
                                   tcfg)
        return model, cache, int(torch.argmax(logits[0])), prompt

    @staticmethod
    def _clone(cache):
        return [{k: v.clone() for k, v in layer.items()} for layer in cache]

    def _sequential(self, model, cache, toks, tcfg):
        cache = self._clone(cache)
        out = []
        for t in toks:
            logits, cache = tm.decode_step(model, torch.tensor([[t]], dtype=torch.int32), cache, tcfg)
            out.append(logits[0])
        return torch.stack(out), cache

    def test_matches_sequential_decode(self, served):
        """verify_step over (1, K+1) tokens == K+1 sequential decode steps,
        and both leave the same idx."""
        tcfg = served[1]
        model, cache, t0, _ = self._prefilled(served)
        toks = [t0, 17, 401, 3]
        seq, seq_cache = self._sequential(model, cache, toks, tcfg)
        ver, ver_cache = tm.verify_step(model, torch.tensor([toks], dtype=torch.int32),
                                        self._clone(cache), tcfg)
        np.testing.assert_allclose(ver[0].numpy(), seq.numpy(), rtol=VERIFY_TOL, atol=VERIFY_TOL)
        for s, v in zip(seq_cache, ver_cache):
            np.testing.assert_array_equal(s["idx"].numpy(), v["idx"].numpy())

    def test_matches_jax_verify_step(self, served):
        """The port's verify_step against JAX's on the same prompt, tokens
        and cache: chain logits, tree logits, and the caches they leave."""
        jcfg, tcfg, params, _ = served
        model, cache, t0, prompt = self._prefilled(served)
        jl, jc = jm.prefill(params, jnp.asarray(prompt), jm.init_cache(jcfg, 1, 64), jcfg)
        assert int(jnp.argmax(jl[0])) == t0
        toks = np.array([[t0, 17, 401, 3]], np.int32)
        tl, tc = tm.verify_step(model, _t(toks), self._clone(cache), tcfg)
        jvl, jvc = jm.verify_step(params, jnp.asarray(toks), jc, jcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jvl), rtol=0, atol=JAX_TOL)
        for i, layer in enumerate(tc):
            np.testing.assert_array_equal(layer["slot_pos"].numpy(),
                                          np.asarray(jvc[0]["b0"]["slot_pos"])[i])
            np.testing.assert_array_equal(layer["idx"].numpy(), np.asarray(jvc[0]["b0"]["idx"])[i])
        tree = tspec.build_tree(2, (2,))
        ttoks = np.array([[t0, 17, 99, 401, 5]], np.int32)
        tl, _ = tm.verify_step(model, _t(ttoks), self._clone(cache), tcfg, tree=tree)
        jvl, _ = jm.verify_step(params, jnp.asarray(ttoks), jc, jcfg, tree=jspec.build_tree(2, (2,)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jvl), rtol=0, atol=JAX_TOL)

    def test_tree_matches_sequential_decode_of_each_path(self, served):
        """Tree verification of tree=(2, 2), k=3: every node's logits equal
        sequential decode along its root-to-node path."""
        tcfg = served[1]
        model, cache, t0, _ = self._prefilled(served)
        tree = tspec.build_tree(3, (2, 2))
        toks = np.random.default_rng(1).integers(0, tcfg.vocab, tree.n_nodes).astype(np.int32)
        toks[0] = t0
        ver, _ = tm.verify_step(model, _t(toks[None]), self._clone(cache), tcfg, tree=tree)
        for path in tree.leaf_paths:
            seq, _ = self._sequential(model, cache, [int(toks[j]) for j in path], tcfg)
            np.testing.assert_allclose(ver[0, path].numpy(), seq.numpy(),
                                       rtol=VERIFY_TOL, atol=VERIFY_TOL)

    def test_rollback_then_decode_is_exact(self, served):
        tcfg = served[1]
        model, cache, t0, _ = self._prefilled(served)
        tok = torch.tensor([[t0]], dtype=torch.int32)
        clean, _ = tm.decode_step(model, tok, self._clone(cache), tcfg)
        _, dirty = tm.verify_step(model, torch.tensor([[t0, 7, 7, 7]], dtype=torch.int32),
                                  cache, tcfg)
        restored = tm.rollback_cache(dirty, torch.tensor([12]))
        redo, _ = tm.decode_step(model, tok, restored, tcfg)
        np.testing.assert_allclose(clean.numpy(), redo.numpy(), rtol=1e-5, atol=1e-5)

    def test_verify_write_drops_columns_past_the_buffer(self, served):
        """A verify step whose columns pass the buffer end writes only the
        in-range ones (JAX's scatter mode="drop"): the slot's early K/V and
        positions are never overwritten."""
        tcfg = served[1]
        model, cache, t0, _ = self._prefilled(served, prompt_len=12, max_len=16)
        before = self._clone(cache)
        _, after = tm.verify_step(model, torch.tensor([[t0, 1, 2, 3, 4, 5, 6]], dtype=torch.int32),
                                  cache, tcfg)
        for b, a in zip(before, after):
            np.testing.assert_array_equal(a["slot_pos"][0].numpy(),
                                          np.concatenate([np.arange(12), np.arange(12, 16)]))
            torch.testing.assert_close(a["k"][0, :12], b["k"][0, :12], rtol=0, atol=0)
            assert int(a["idx"][0]) == 19

    def test_verify_rejects_windowed(self, served):
        tcfg = served[1].with_(layers=uniform_layers(2, window=8))
        model = tm.init_lm(tcfg, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="window"):
            tm.verify_step(model, torch.zeros((1, 3), dtype=torch.int32),
                           tm.init_cache(tcfg, 1, 32, device="cpu"), tcfg)
        with pytest.raises(ValueError, match="tree"):
            tm.lm_hidden(model, torch.zeros((1, 3), dtype=torch.int32), tcfg,
                         tree=tspec.build_tree(2, (1,)))

    def test_reset_slot_idx_touches_one_slot(self, served):
        tcfg = served[1]
        cache = tm.rollback_cache(tm.init_cache(tcfg, 3, 16, device="cpu"),
                                  torch.tensor([5, 6, 7]))
        ids = [layer["idx"].data_ptr() for layer in cache]
        out = tm.reset_slot_idx(cache, 1, value=2)
        assert [layer["idx"].data_ptr() for layer in out] == ids        # in place
        for layer in out:
            np.testing.assert_array_equal(layer["idx"].numpy(), [5, 2, 7])


# --------------------------------------------------------------------------
# Engine against the JAX engine
# --------------------------------------------------------------------------
_STATS = ("prefill_tokens", "prefill_pad_tokens", "decode_tokens", "decode_steps", "chunk_steps",
          "spec_steps", "spec_slot_steps", "spec_skipped_steps", "drafted_tokens",
          "accepted_tokens", "verified_nodes", "completed", "rejected")


def _specs(served, kw):
    """The same SpecConfig for both packages; drafter="model" drafts with
    the target's own (bridged) weights."""
    if kw is None:
        return None, None
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("drafter") == "model":
        jkw.update(draft_params=served[2], draft_cfg=served[0])
        tkw.update(draft_params=_model(served), draft_cfg=served[1])
    return jspec.SpecConfig(**jkw), tspec.SpecConfig(**tkw)


def _run(pkg, eng, prompts, max_new):
    sched = pkg.ContinuousBatchingScheduler(eng)
    reqs = [pkg.Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    sched.submit(reqs)
    return [r.generated for r in reqs], sched.run_to_completion()


def serve_pair(served, prompts, spec=None, *, max_new=8, max_len=64, slots=2, **kw):
    """Serve `prompts` on the JAX engine and the port's with the same
    settings; assert the same greedy tokens and counters. → the port's
    (tokens, stats, engine)."""
    jcfg, tcfg, params, _ = served
    jsp, tsp = _specs(served, spec)
    jg, jst = _run(js, js.Engine(params, jcfg, max_slots=slots, max_len=max_len, spec=jsp, **kw),
                   prompts, max_new)
    eng = ts.Engine(_model(served), tcfg, max_slots=slots, max_len=max_len, spec=tsp,
                    device="cpu", **kw)
    tg, tst = _run(ts, eng, prompts, max_new)
    assert tg == jg
    for f in _STATS:
        assert getattr(tst, f) == getattr(jst, f), f
    for f in ("acceptance_rate", "decode_tokens_per_step", "skip_rate", "mean_draft_k",
              "nodes_per_step"):
        assert getattr(tst, f) == getattr(jst, f), f
    assert len(tst.ttft_s) == len(jst.ttft_s)
    return tg, tst, eng


def plain_tokens(served, prompts, *, max_new=8, max_len=64, slots=2):
    """The port's whole-prompt, unspeculated greedy tokens."""
    eng = ts.Engine(_model(served), served[1], max_slots=slots, max_len=max_len, device="cpu")
    return _run(ts, eng, prompts, max_new)[0]


def _prompts(vocab, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _mixed_prompts(vocab, seed):
    """Half repetitive (n-gram drafting hits), half random."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, vocab, size=3)
    return ([np.tile(pat, 5).astype(np.int32) for _ in range(2)]
            + [rng.integers(0, vocab, size=n).astype(np.int32) for n in (6, 13)])


class TestSpecEngine:
    def test_greedy_ngram_chain(self, served):
        prompts = _mixed_prompts(served[0].vocab, 1) + _prompts(served[0].vocab, 2, (4, 19))
        got, stats, eng = serve_pair(served, prompts, dict(k=3))
        assert got == plain_tokens(served, prompts)
        assert eng.spec_steps > 0 and stats.accepted_tokens > 0
        assert stats.nodes_per_step == 4

    def test_greedy_model_drafter(self, served):
        prompts = _prompts(served[0].vocab, 3, (9, 9, 9))
        got, _, _ = serve_pair(served, prompts, dict(k=3, drafter="model"))
        assert got == plain_tokens(served, prompts)

    def test_oracle_drafter_accepts_everything(self, served):
        """Self-drafting with the target's weights: every draft accepted, and
        every uncapped step emits k+1 tokens."""
        k = 3
        _, stats, eng = serve_pair(served, _prompts(served[0].vocab, 4, (8,)),
                                   dict(k=k, drafter="model"), max_new=2 * (k + 1) + 1, slots=1)
        assert eng.acceptance_rate == 1.0
        assert eng.decode_tokens_per_step == k + 1
        assert stats.accepted_tokens == stats.spec_steps * k

    def test_adaptive_k(self, served):
        prompts = _mixed_prompts(served[0].vocab, 5)
        got, stats, _ = serve_pair(served, prompts,
                                   dict(k=3, adaptive_k=True, accept_ewma=0.5, skip_below=0.3,
                                        probe_every=2))
        assert got == plain_tokens(served, prompts)
        assert stats.spec_steps > 0

    def test_adaptive_cold_slot_skips_drafting(self, served):
        """A slot whose drafts are always rejected falls to k_eff=0, probes
        again, and still emits the plain greedy tokens; the JAX engine with
        the same drafter does the same steps."""

        class WrongDrafter(tspec.Drafter):
            # proposes last_token+1: (almost) never the target's greedy pick
            def __init__(self, vocab):
                self.vocab = vocab

            def propose(self, contexts, k, *, slot_k=None, generator=None, rng=None,
                        temperature=0.0, return_probs=False):
                out = np.zeros((len(contexts), k), np.int32)
                for i, ctx in enumerate(contexts):
                    if ctx is not None:
                        out[i] = (int(ctx[-1]) + 1) % self.vocab
                return (out, None) if return_probs else out

        jcfg, tcfg, params, _ = served
        prompt = _prompts(jcfg.vocab, 6, (8,))[0]
        base = plain_tokens(served, [prompt], max_new=14, slots=1)[0]
        kw = dict(k=4, adaptive_k=True, accept_ewma=0.5, skip_below=0.3, probe_every=3)
        engines = {"jax": js.Engine(params, jcfg, max_slots=1, max_len=64,
                                    spec=jspec.SpecConfig(**kw)),
                   "torch": ts.Engine(_model(served), tcfg, max_slots=1, max_len=64,
                                      spec=tspec.SpecConfig(**kw), device="cpu")}
        seen = {}
        for name, eng in engines.items():
            eng.drafter = WrongDrafter(jcfg.vocab)
            pkg = js if name == "jax" else ts
            req = pkg.Request(rid=0, prompt=prompt.copy(), max_new_tokens=14)
            assert eng.add(req)
            ks = []
            for _ in range(32):
                if req.done:
                    break
                eng.decode_once()
                ks.append(int(eng.slot_k_eff[0]))
            assert req.done and req.generated == base
            seen[name] = (ks, eng.spec_skipped_steps, eng.drafted_tokens, eng.spec_slot_steps)
        assert seen["torch"] == seen["jax"]
        ks, skipped, drafted, slot_steps = seen["torch"]
        assert skipped > 0 and drafted < slot_steps * kw["k"]
        assert kw["k"] in ks and 0 in ks

    def test_tree_mixed_batch(self, served):
        prompts = _mixed_prompts(served[0].vocab, 7)
        spec = dict(k=4, tree=(2, 2))
        got, stats, eng = serve_pair(served, prompts, spec, max_new=10)
        assert got == plain_tokens(served, prompts, max_new=10)
        assert stats.nodes_per_step == eng.nodes_per_step == 15 > spec["k"] + 1

    def test_tree_model_drafter(self, served):
        prompts = _prompts(served[0].vocab, 8, (9, 9))
        got, _, eng = serve_pair(served, prompts, dict(k=3, drafter="model", tree=(2,)))
        assert got == plain_tokens(served, prompts)
        assert eng.decode_tokens_per_step > 1.0

    def test_stats_flow_through_scheduler(self, served):
        _, stats, eng = serve_pair(served, _prompts(served[0].vocab, 9, (6,)), dict(k=2))
        assert stats.spec_steps == eng.spec_steps > 0
        assert stats.drafted_tokens == eng.drafted_tokens
        assert stats.decode_tokens_per_step == eng.decode_tokens_per_step
        assert stats.spec_skipped_steps == eng.spec_skipped_steps == 0
        assert stats.skip_rate == eng.skip_rate == 0.0
        assert stats.mean_draft_k == eng.mean_draft_k == 2.0

    def test_temperature_spec_completes(self, served):
        """Rejection sampling at temperature 1 with the n-gram drafter and
        with the stochastic self-drafter: valid tokens, every request
        completes, and the self-drafter (q == p up to round-off) accepts
        nearly everything."""
        tcfg = served[1]
        prompts = _prompts(tcfg.vocab, 10, (8, 8))
        for spec in (tspec.SpecConfig(k=2),
                     tspec.SpecConfig(k=2, drafter="model", stochastic=True,
                                      draft_params=_model(served), draft_cfg=tcfg)):
            eng = ts.Engine(_model(served), tcfg, max_slots=2, max_len=64, temperature=1.0,
                            seed=3, spec=spec, device="cpu")
            out, stats = _run(ts, eng, prompts, 8)
            assert stats.completed == 2 and all(len(g) == 8 for g in out)
            assert all(0 <= t < tcfg.vocab for g in out for t in g)
        assert eng.acceptance_rate > 0.9

    def test_tree_temperature_warns_and_completes(self, served):
        tcfg = served[1]
        with pytest.warns(UserWarning, match="greedy-filtered"):
            eng = ts.Engine(_model(served), tcfg, max_slots=2, max_len=64, temperature=1.0,
                            seed=5, spec=tspec.SpecConfig(k=2, tree=(2,)), device="cpu")
        out, stats = _run(ts, eng, _prompts(tcfg.vocab, 11, (8, 8)), 8)
        assert stats.completed == 2 and all(len(g) == 8 for g in out)

    def test_tree_draft_window_budget(self, served):
        tcfg = served[1]
        eng = ts.Engine(_model(served), tcfg, max_slots=1, max_len=32,
                        spec=tspec.SpecConfig(k=4, tree=(2, 2)), device="cpu")
        assert eng._draft_window == 14
        with pytest.raises(ValueError, match="draft window"):
            eng.add(ts.Request(rid=0, prompt=np.arange(10, dtype=np.int32), max_new_tokens=10))

    def test_spec_refuses_ssm_and_windowed(self, served):
        tcfg = served[1]
        with pytest.raises(ValueError, match="ssm"):
            ts.Engine(None, tcfg.with_(layers=uniform_layers(2, mixer="ssm")),
                      spec=tspec.SpecConfig(k=2), device="cpu")
        windowed = tcfg.with_(layers=uniform_layers(2, window=8))
        with pytest.raises(ValueError, match="window"):
            ts.Engine(None, windowed, spec=tspec.SpecConfig(k=2), device="cpu")
        with pytest.raises(ValueError, match="window"):
            tspec.ModelDrafter(None, windowed, max_slots=1, max_len=32, device="cpu")


class TestModelDrafterSlotK:
    def _drafter(self, served, slots):
        d = tspec.ModelDrafter(_model(served), served[1], max_slots=slots, max_len=32,
                               device="cpu")
        prompt = (np.arange(5) + 7).astype(np.int32)
        d.on_admit(0, prompt)
        calls = []
        real = d._decode
        d._decode = lambda *a: (calls.append(1), real(*a))[1]
        return d, prompt, calls

    def test_decode_loop_capped_and_free_slots_untouched(self, served):
        d, prompt, calls = self._drafter(served, 2)
        assert int(d.synced[1]) == 0
        out = d.propose([np.concatenate([prompt, [3]]).astype(np.int32), None], 4,
                        slot_k=np.array([2, 0]))
        assert out.shape == (2, 4)
        assert len(calls) == 1                      # deepest active k_eff 2
        assert int(d.synced[1]) == 0 and int(d.synced[0]) == 6

    def test_all_slots_skipping_runs_no_decode_steps(self, served):
        d, prompt, calls = self._drafter(served, 1)
        out = d.propose([np.concatenate([prompt, [3]]).astype(np.int32)], 3, slot_k=np.array([0]))
        assert out.shape == (1, 3) and len(calls) == 0

    def test_proposals_match_jax_drafter(self, served):
        """Chain and tree proposals of the port's ModelDrafter against the
        JAX ModelDrafter's on the same weights and contexts, two rounds."""
        jcfg, tcfg, params, _ = served
        prompts = _prompts(jcfg.vocab, 12, (7, 11))
        t = tspec.ModelDrafter(_model(served), tcfg, max_slots=3, max_len=48, device="cpu")
        j = jspec.ModelDrafter(params, jcfg, max_slots=3, max_len=48)
        for d in (t, j):
            for slot, p in enumerate(prompts):
                d.on_admit(slot, p)
        ctx = [np.concatenate([prompts[0], [5]]), None, None]
        ctx[1] = np.concatenate([prompts[1], [9]])
        np.testing.assert_array_equal(t.propose(ctx, 3), j.propose(ctx, 3))
        ctx = [np.concatenate([c, [1, 2]]) if c is not None else None for c in ctx]
        tree_t, tree_j = tspec.build_tree(3, (2, 2)), jspec.build_tree(3, (2, 2))
        np.testing.assert_array_equal(t.propose(ctx, 3, tree=tree_t),
                                      j.propose(ctx, 3, tree=tree_j))
        np.testing.assert_array_equal(t.synced, j.synced)

    def test_stochastic_proposal_returns_distributions(self, served):
        tcfg = served[1]
        d = tspec.ModelDrafter(_model(served), tcfg, max_slots=2, max_len=32, device="cpu")
        prompt = (np.arange(5) + 7).astype(np.int32)
        d.on_admit(1, prompt)
        draft, q = d.propose([None, np.concatenate([prompt, [3]]).astype(np.int32)], 3,
                             generator=torch.Generator().manual_seed(0), temperature=0.8,
                             return_probs=True)
        assert draft.shape == (2, 3) and q.shape == (2, 3, tcfg.vocab)
        np.testing.assert_allclose(q.sum(-1).numpy(), 1.0, rtol=1e-5)
        assert all(q[1, j, draft[1, j]] > 0 for j in range(3))


def test_stochastic_spec_matches_plain_sampling_distribution(served):
    """Temperature > 0 serving with the stochastic self-drafter is
    distributed as plain temperature sampling: over many requests on a
    16-token vocab, the first verify-emitted token's marginal is within TV
    0.15 of the plain engine's (tests/test_spec.py's bound)."""
    jcfg, tcfg, _, _ = served
    jcfg16 = dataclasses.replace(jcfg, vocab=16)
    params = jm.pack_params(jm.init_lm(jax.random.PRNGKey(1), jcfg16), jcfg16)
    model = bridge.lm_from_jax(jax.tree.map(np.asarray, params), tcfg.with_(vocab=16),
                               device="cpu")
    cfg = tcfg.with_(vocab=16)
    prompt = np.asarray([3, 11, 7, 2, 9, 14], np.int32)
    n = 600

    def collect(spec):
        # 8 slots admitted together by chunked prefill: each request's draws
        # are independent of the others'
        eng = ts.Engine(model, cfg, max_slots=8, max_len=32, temperature=1.5, seed=11,
                        spec=spec, prefill_chunk=8, device="cpu")
        sched = ts.ContinuousBatchingScheduler(eng)
        reqs = [ts.Request(rid=i, prompt=prompt.copy(), max_new_tokens=3) for i in range(n)]
        sched.submit(reqs)
        sched.run_to_completion()
        assert all(len(r.generated) == 3 for r in reqs)
        # the first decode/verify-step token
        return np.bincount([r.generated[1] for r in reqs], minlength=16) / n

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plain = collect(None)
        spec = collect(tspec.SpecConfig(k=2, drafter="model", stochastic=True,
                                        draft_params=model, draft_cfg=cfg))
    assert 0.5 * np.abs(plain - spec).sum() < 0.15
