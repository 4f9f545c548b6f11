"""The port's CUDA kernels on the card. Marked `cuda`: each test skips where
there is no NVIDIA GPU (the kernels have no CPU mode; on the CPU the
wrappers run the plain versions that the parity tests pin to JAX). This
file imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import copy
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import act_token_scale, pack_weight, ternary_quantize  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ternary_decode_gemm as tdg  # noqa: E402
from repro_torch.kernels import vlut_lookup_gemm as vlg  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import encdec_init, init_cache, init_lm, pack_params  # noqa: E402
from repro_torch.serve import ContinuousBatchingScheduler, Engine, PagedKVConfig, Request  # noqa: E402

KERNELS = {
    "decode": (tdg.ternary_decode_gemm_fused, tdg.ternary_decode_gemm_fused_plain),
    "lookup": (vlg.vlut_lookup_gemm_fused, vlg.vlut_lookup_gemm_fused_plain),
}
INT_KERNELS = {
    "decode": (tdg.ternary_decode_gemm, tdg.ternary_decode_gemm_plain),
    "lookup": (vlg.vlut_lookup_gemm, vlg.vlut_lookup_gemm_plain),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
def test_kernel_matches_plain(cuda, impl):
    """Each kernel against its plain version, bit for bit, on ragged edges
    (M, K-groups and N not multiples of the tiles) and a strided x."""
    kern, plain = KERNELS[impl]
    rng = np.random.default_rng(7)
    for m, kg, g, n in [(960, 192, 5, 4), (70, 1, 4, 3), (130, 7, 4, 33), (65, 13, 5, 17)]:
        packed = torch.tensor(rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8), device=cuda)
        wide = torch.tensor(rng.standard_normal((n, kg * g + 5)).astype(np.float32), device=cuda)
        x = wide[:, 5:]
        a_scale = act_token_scale(x.T).contiguous()
        for w_scale in (torch.tensor(rng.random(m).astype(np.float32), device=cuda),
                        torch.tensor([0.5], device=cuda)):
            for dt in (torch.float32, torch.bfloat16):
                before = kern.launches
                got = kern(packed, x.to(dt), a_scale, w_scale, g=g, out_dtype=dt)
                want = plain(packed, x.to(dt), a_scale, w_scale, g=g, out_dtype=dt)
                assert kern.launches == before + 1
                assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
def test_int_kernel_matches_plain(cuda, impl):
    """Each integer kernel against its plain version, bit for bit, on
    ragged edges (M, K-groups and N not multiples of the tiles) and the
    saturated case (all +1 weights, activations 127: every sum 127*K)."""
    kern, plain = INT_KERNELS[impl]
    rng = np.random.default_rng(8)
    for m, kg, g, n in [(960, 192, 5, 4), (70, 1, 4, 3), (130, 7, 4, 33), (65, 13, 5, 17),
                        (2560, 512, 5, 64)]:
        packed = torch.tensor(rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8), device=cuda)
        a_r = torch.tensor(rng.integers(-127, 128, (g, kg, n)).astype(np.int8), device=cuda)
        before = kern.launches
        got = kern(packed, a_r, g=g)
        want = plain(packed, a_r, g=g)
        assert kern.launches == before + 1
        assert got.dtype == torch.int32 and torch.equal(got, want)
    for g in (4, 5):
        packed = torch.full((70, 64), 3 ** g - 1, dtype=torch.uint8, device=cuda)   # all +1
        a_r = torch.full((g, 64, 19), 127, dtype=torch.int8, device=cuda)
        got = kern(packed, a_r, g=g)
        assert int(got.min()) == int(got.max()) == 127 * 64 * g


#: the segments (M, KG, g) of mamba2-1.3b's and gemma3-1b's BitLinears:
#: g=4 segments of 2, 4, 3 and 1 K-groups, M 256 and 8512
NEW_SEGMENTS = [(8512, 408, 5), (8512, 2, 4), (2048, 816, 5), (2048, 4, 4), (1024, 228, 5),
                (1024, 3, 4), (256, 228, 5), (256, 3, 4), (1152, 204, 5), (1152, 1, 4),
                (6912, 228, 5), (6912, 3, 4), (1152, 1380, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
@pytest.mark.parametrize("n", [1, 4, 17, 61, 200])
def test_kernels_match_plain_at_the_new_shapes(cuda, impl, n):
    """Fused (bf16 and f32) and integer kernels against their plain
    versions, bit for bit, at every new segment and exact-length N; the
    fused kernels read the segment's view of a (N, K) activation in place,
    as the model passes it."""
    kern, plain = KERNELS[impl]
    ikern, iplain = INT_KERNELS[impl]
    rng = np.random.default_rng(n)
    for m, kg, g in NEW_SEGMENTS:
        packed = torch.tensor(rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8), device=cuda)
        wide = torch.tensor(rng.standard_normal((n, kg * g + 16)).astype(np.float32), device=cuda)
        x = wide[:, 16:]
        w_scale = torch.tensor(rng.random(m).astype(np.float32), device=cuda)
        for dt in (torch.float32, torch.bfloat16):
            a_scale = act_token_scale(x.to(dt).T).contiguous()
            got = kern(packed, x.to(dt), a_scale, w_scale, g=g, out_dtype=dt)
            assert torch.equal(got, plain(packed, x.to(dt), a_scale, w_scale, g=g, out_dtype=dt))
        a_r = torch.tensor(rng.integers(-127, 128, (g, kg, n)).astype(np.int8), device=cuda)
        assert torch.equal(ikern(packed, a_r, g=g), iplain(packed, a_r, g=g))


# (M, KG, N, g): ragged M, N = 17 and 33, KG not divisible by the plan's
# splits, a g=4 segment of one K-group, smollm-360m's q at a decode step
LUT_TRAPS = [(70, 13, 17, 5), (1000, 77, 33, 5), (1000, 191, 17, 4), (70, 1, 3, 4),
             (960, 192, 4, 5)]
#: each impl's launch plan: (M, KG, N, g) -> a plan with `splits`
PLANS = {"decode": tdg.decode_plan, "lookup": vlg.lut_plan}


def _lut_cases(cuda, fused, impl):
    rng = np.random.default_rng(10)
    cases = []
    for m, kg, n, g in LUT_TRAPS:
        packed = torch.tensor(rng.integers(0, 3 ** g, (m, kg)).astype(np.uint8), device=cuda)
        if fused:
            x = torch.tensor((rng.standard_normal((n, kg * g)) * 3).astype(np.float32), device=cuda)
            w_scale = torch.tensor(rng.random(m).astype(np.float32), device=cuda)
            cases.append(((packed, x, act_token_scale(x.T).contiguous(), w_scale), dict(g=g)))
        else:
            a_r = torch.tensor(rng.integers(-127, 128, (g, kg, n)).astype(np.int8), device=cuda)
            cases.append(((packed, a_r), dict(g=g)))
    assert any(kg % PLANS[impl](m, kg, n, g).splits for m, kg, n, g in LUT_TRAPS)
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "int"])
def test_lut_split_k_repeat_and_back_to_back(cuda, fused, impl):
    """Both mpGeMM templates split K across blocks that meet in the shared
    int32 workspace: two launches of each shape, back to back with the
    other shapes and no sync between, equal the plain version bit for bit."""
    kern, plain = (KERNELS if fused else INT_KERNELS)[impl]
    cases = _lut_cases(cuda, fused, impl)
    first = [kern(*a, **kw) for a, kw in cases]
    second = [kern(*a, **kw) for a, kw in cases]
    for (a, kw), x, y in zip(cases, first, second):
        want = plain(*a, **kw)
        assert torch.equal(x, want) and torch.equal(y, want)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "int"])
def test_lut_split_k_graph_replays(cuda, fused, impl):
    """A CUDA graph of the kernel at every trap shape, replayed 3 times: the
    workspace and counters return to 0 after each launch, so the outputs
    still equal the plain version."""
    kern, plain = (KERNELS if fused else INT_KERNELS)[impl]
    cases = _lut_cases(cuda, fused, impl)
    for a, kw in cases:                           # eager first: sizes the workspace
        kern(*a, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [kern(*a, **kw) for a, kw in cases]
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    for (a, kw), out in zip(cases, outs):
        assert torch.equal(out, plain(*a, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
def test_lut_saturated_sums_at_the_largest_split(cuda, impl):
    """All +1 weights and activations 127 at the plan with the most
    K-splits on smollm-360m's shapes: every sum is 127*K."""
    m, kg, n = max(((m, kg, n) for m, kg in [(960, 192), (320, 192), (2560, 192), (960, 512)]
                    for n in (1, 4, 16, 64, 256)), key=lambda s: PLANS[impl](*s, 5).splits)
    assert PLANS[impl](m, kg, n, 5).splits > 1
    kern, plain = KERNELS[impl]
    packed = torch.full((m, kg), 3 ** 5 - 1, dtype=torch.uint8, device=cuda)
    out = INT_KERNELS[impl][0](packed, torch.full((5, kg, n), 127, dtype=torch.int8, device=cuda), g=5)
    assert int(out.min()) == int(out.max()) == 127 * kg * 5
    x = torch.ones((n, kg * 5), device=cuda)
    args = (packed, x, act_token_scale(x.T).contiguous(), torch.ones(m, device=cuda))
    assert torch.equal(kern(*args, g=5), plain(*args, g=5))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
def test_lut_refused_plan_raises(cuda, impl):
    """A plan the kernel refuses (shared memory it would size otherwise)
    raises in the wrapper; nothing falls back to the plain version."""
    from repro_torch.kernels import _build, _splitk

    packed = torch.zeros((128, 8), dtype=torch.uint8, device=cuda)
    a_r = torch.zeros((5, 8, 4), dtype=torch.int8, device=cuda)
    out = torch.empty((128, 4), dtype=torch.int32, device=cuda)
    plan = PLANS[impl](128, 8, 4, 5)
    bad = dataclasses.replace(plan, smem=plan.smem + 16)
    launch = _build.launch_decode_int if impl == "decode" else _build.launch_lut_int
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch(packed, a_r, 5, out, bad, *_splitk.launch_args(bad, a_r.device))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,fused,e", [("decode", True, None), ("lookup", False, None),
                                            ("decode_grouped", False, 3),
                                            ("lookup_grouped", True, 3)])
def test_tune_times_the_kernel_and_persists(cuda, kernel, fused, e, tmp_path):
    """`tune` with the default benchmark on a small problem: every candidate
    launched and held bit-equal to the heuristic plan's output, a positive
    time each, the winner persisted and served by `get_plan` without timing,
    and a tuned launch bit-equal to the plain version."""
    from repro_torch.kernels import autotune

    cache = autotune.PlanCache(str(tmp_path / "plans.json"))
    g, m, kg, n = 5, 300, 77, 17
    res = autotune.tune(kernel, g, m, kg, n, e=e, fused=fused, device=cuda, cache=cache)
    cands = autotune.candidate_plans(kernel, g, m, kg, n, e=e)
    assert len(res.trials) == len(cands) > 1 and all(s > 0 for _, s in res.trials)
    trials = autotune.tune.trials
    hit = autotune.get_plan(kernel, g, m, kg, n, e=e, fused=fused, device=cuda, cache=cache,
                            tune_if_missing=True)
    assert autotune.fields_of(kernel, hit) == autotune.fields_of(kernel, res.plan)
    assert autotune.tune.trials == trials
    rng = np.random.default_rng(11)
    lead = () if e is None else (e,)
    packed = torch.tensor(rng.integers(0, 3 ** g, (*lead, m, kg)).astype(np.uint8), device=cuda)
    wrapper = autotune._wrapper(kernel, fused)
    if fused:
        x = torch.tensor(rng.standard_normal((*lead, n, kg * g)).astype(np.float32), device=cuda)
        args = (x, act_token_scale(x.reshape(-1, kg * g).T).reshape(*lead, n).contiguous(),
                torch.ones((*lead, m), device=cuda))
        plain = tdg.ternary_decode_gemm_fused_plain
    else:
        args = (torch.tensor(rng.integers(-127, 128, (*lead, g, kg, n)).astype(np.int8),
                             device=cuda),)
        plain = tdg.ternary_decode_gemm_plain
    assert torch.equal(wrapper(packed, *args, g=g, plan=hit), plain(packed, *args, g=g))


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
def test_segment_mpgemm_launches_the_given_plan(cuda, impl):
    """`segment_mpgemm(plan=)` launches each legal candidate, fused and
    unfused, bit-equal to its launch with the plan `get_plan` gives."""
    from repro_torch.kernels import autotune

    rng = np.random.default_rng(12)
    packed = torch.tensor(rng.integers(0, 243, (960, 192)).astype(np.uint8), device=cuda)
    a = torch.tensor(rng.standard_normal((960, 4)).astype(np.float32), device=cuda)
    for fused in (True, False):
        want = ops.segment_mpgemm(packed, a, 5, impl, fused=fused)
        for plan in autotune.candidate_plans(impl, 5, 960, 192, 4):
            got = ops.segment_mpgemm(packed, a, 5, impl, fused=fused, plan=plan)
            assert torch.equal(got, want), plan


GROUPED = {
    "decode": (tdg.ternary_decode_gemm_fused_grouped, tdg.ternary_decode_gemm_fused_plain),
    "lookup": (vlg.vlut_lookup_gemm_fused_grouped, vlg.vlut_lookup_gemm_fused_plain),
}
#: each impl's grouped launch plan: (M, KG, N, g, E) -> a plan with `splits`
GROUPED_PLANS = {"decode": tdg.grouped_decode_plan, "lookup": vlg.grouped_lut_plan}
# (E, M, KG, g, C): split-K traps (odd E, M off the tiles, C 5 and 17, KG
# not divisible by the splits), a one-K-group g=4 segment, llama4-scout's
# w2 g=4 segment and a w1 slice of its 16 experts (no split)
GROUPED_TRAPS = [(3, 70, 13, 5, 5), (5, 130, 77, 4, 17), (3, 1000, 191, 5, 5), (7, 70, 1, 4, 3),
                 (16, 5120, 3, 4, 16), (16, 1024, 1024, 5, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
def test_grouped_kernel_matches_plain_and_single_launches(cuda, impl):
    """Each grouped kernel (E experts in one launch) against its plain
    version and against E launches of the single kernel, bit for bit, on
    split-K traps (two launches back to back: the experts' workspace and
    counters are left zeroed), a strided x, an all-zero padding row (its
    output must be exactly 0), (E, M) and (E, 1) weight scales, f32 and
    bf16."""
    kern, plain = GROUPED[impl]
    single = KERNELS[impl][0]
    rng = np.random.default_rng(11)
    assert any(GROUPED_PLANS[impl](m, kg, c, g, e).splits > 1 for e, m, kg, g, c in GROUPED_TRAPS)
    for e, m, kg, g, c in GROUPED_TRAPS:
        packed = torch.tensor(rng.integers(0, 3 ** g, (e, m, kg)).astype(np.uint8), device=cuda)
        wide = torch.tensor(rng.standard_normal((e, c, kg * g + 4)).astype(np.float32), device=cuda)
        x = wide[..., 4:]
        x[:, -1] = 0                                  # a padding row of every expert
        a_scale = act_token_scale(x.reshape(e * c, -1).T).reshape(e, c).contiguous()
        for w_scale in (torch.tensor(rng.random((e, m)).astype(np.float32), device=cuda),
                        torch.full((e, 1), 0.5, device=cuda)):
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                before = kern.launches
                got = [kern(packed, xd, a_scale, w_scale, g=g, out_dtype=dt) for _ in range(2)]
                assert kern.launches == before + 2
                want = plain(packed, xd, a_scale, w_scale, g=g, out_dtype=dt)
                each = torch.stack([single(packed[i], xd[i], a_scale[i], w_scale[i], g=g,
                                           out_dtype=dt) for i in range(e)])
                assert torch.equal(got[0], want) and torch.equal(got[1], want)
                assert torch.equal(got[0], each)
                assert not got[0][:, -1].any()


GROUPED_INT = {
    "decode": (tdg.ternary_decode_gemm_grouped, tdg.ternary_decode_gemm_plain),
    "lookup": (vlg.vlut_lookup_gemm_grouped, vlg.vlut_lookup_gemm_plain),
}


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
def test_grouped_int_kernel_matches_plain_and_single_launches(cuda, impl):
    """Each grouped integer kernel (E experts in one launch) against its
    plain version and E launches of the single integer kernel, bit for bit,
    on the grouped split-K traps, launched twice back to back (the
    experts' workspace and counters are left zeroed) and with C % 4 == 0
    and != 0 (word and byte loads of a_r)."""
    kern, plain = GROUPED_INT[impl]
    single = INT_KERNELS[impl][0]
    rng = np.random.default_rng(12)
    for e, m, kg, g, c in GROUPED_TRAPS:
        packed = torch.tensor(rng.integers(0, 3 ** g, (e, m, kg)).astype(np.uint8), device=cuda)
        a_r = torch.tensor(rng.integers(-127, 128, (e, g, kg, c)).astype(np.int8), device=cuda)
        before = kern.launches
        got = [kern(packed, a_r, g=g) for _ in range(2)]
        assert kern.launches == before + 2
        want = plain(packed, a_r, g=g)
        each = torch.stack([single(packed[i], a_r[i], g=g) for i in range(e)])
        assert torch.equal(got[0], want) and torch.equal(got[1], want)
        assert torch.equal(got[0], each)


@pytest.mark.cuda
def test_deepseek_smoke_serving_on_the_card_matches_the_cpu(cuda):
    """The MLA mixer and the 4-expert MoE on the card: deepseek-v3-671b's
    smoke config in f32 serves the CPU's greedy tokens with both impls,
    fused and unfused (one grouped integer launch per expert segment)."""
    cfg = get_config("deepseek-v3-671b", smoke=True).with_(dtype="float32")
    model = pack_params(init_lm(cfg, torch.Generator().manual_seed(0)), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (5, 17, 30)]
    outs = []
    for impl, fusion, device in (("decode", "fused", "cpu"), ("decode", "fused", "cuda"),
                                 ("lookup", "fused", "cuda"), ("decode", "unfused", "cuda"),
                                 ("lookup", "unfused", "cuda")):
        before = GROUPED_INT[impl][0].launches
        eng = Engine(model, cfg, max_slots=2, max_len=48, mpgemm_impl=impl,
                     mpgemm_fusion=fusion, device=device)
        sched = ContinuousBatchingScheduler(eng)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        sched.submit(reqs)
        assert sched.run_to_completion().completed == 3
        assert (GROUPED_INT[impl][0].launches > before) == (fusion == "unfused" and device == "cuda")
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1] == outs[2]
    assert outs[3] == outs[4]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b", "gemma3-1b"])
def test_ssm_and_windowed_smoke_serving_on_the_card_matches_the_cpu(cuda, arch):
    """The SSM mixer (exact-length prefill, recurrent decode), jamba's
    hybrid stack and gemma3's ring cache on the card: each smoke config in
    f32 serves the CPU's greedy tokens with both impls, fused and
    unfused."""
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    model = pack_params(init_lm(cfg, torch.Generator().manual_seed(0)), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (5, 17, 30)]
    outs = []
    for impl, fusion, device in (("decode", "fused", "cpu"), ("decode", "fused", "cuda"),
                                 ("lookup", "fused", "cuda"), ("decode", "unfused", "cpu"),
                                 ("decode", "unfused", "cuda"), ("lookup", "unfused", "cuda")):
        eng = Engine(model, cfg, max_slots=2, max_len=48, mpgemm_impl=impl,
                     mpgemm_fusion=fusion, device=device)
        sched = ContinuousBatchingScheduler(eng)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        sched.submit(reqs)
        assert sched.run_to_completion().completed == 3
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1] == outs[2]
    assert outs[3] == outs[4] == outs[5]


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
def test_whisper_smoke_steps_on_the_card_match_the_cpu(cuda, impl):
    """The encoder-decoder on the card: whisper-medium's smoke config in
    f32, encode + prefill + 6 greedy decode steps through `launch.steps`
    (the decode steps reading the cross K/V the prefill cached), gives the
    CPU's tokens with both impls, through the impl's kernel."""
    cfg = get_config("whisper-medium", smoke=True).with_(dtype="float32")
    model = pack_params(encdec_init(cfg, torch.Generator().manual_seed(0)), cfg)
    rng = np.random.default_rng(0)
    batch = {"frames": torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32))}
    outs = []
    for device in ("cpu", "cuda"):
        m = copy.deepcopy(model).to(device)
        pre, dec = make_prefill_step(cfg, device=device), make_decode_step(cfg, device=device)
        before = KERNELS[impl][0].launches
        with ops.dispatch_override(impl=impl):
            nt, cache = pre(m, init_cache(cfg, 2, 32, enc_len=16, device=device), batch)
            toks = [nt.cpu()]
            for _ in range(6):
                nt, cache = dec(m, cache, nt[:, None])
                toks.append(nt.cpu())
        assert (KERNELS[impl][0].launches > before) == (device == "cuda")
        outs.append(torch.stack(toks))
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["decode", "lookup"])
def test_unfused_pipeline_on_the_card(cuda, impl):
    """vlut_mpgemm: the unfused pipeline through the integer kernel equals
    the fused kernel bit for bit on one segment and to f32 rounding on two,
    and the same pipeline on the CPU bit for bit."""
    rng = np.random.default_rng(9)
    for k in (960, 964):
        w = torch.tensor(rng.standard_normal((320, k)).astype(np.float32))
        tw = ternary_quantize(w)
        pw = pack_weight(tw.values, tw.scale)
        a = torch.tensor(rng.standard_normal((k, 16)).astype(np.float32))
        cpu = ops.vlut_mpgemm(pw, a, impl=impl, fusion="unfused")
        pw_d = pack_weight(tw.values.to(cuda), tw.scale.to(cuda))
        before = INT_KERNELS[impl][0].launches
        got = ops.vlut_mpgemm(pw_d, a.to(cuda), impl=impl, fusion="unfused")
        assert INT_KERNELS[impl][0].launches == before + (2 if pw.k4 else 1)
        fused = ops.vlut_mpgemm(pw_d, a.to(cuda), impl=impl)
        assert torch.equal(got.cpu(), cpu)
        if pw.k4:
            torch.testing.assert_close(got, fused, rtol=0, atol=1e-6 * fused.abs().max().item())
        else:
            assert torch.equal(got, fused)


@pytest.mark.cuda
def test_serving_on_the_card_matches_the_cpu(cuda):
    """Smoke-size f32 serving: both kernels on the card and the plain path
    on the CPU emit the same greedy tokens."""
    cfg = get_config("smollm-360m", smoke=True).with_(dtype="float32")
    model = pack_params(init_lm(cfg, torch.Generator().manual_seed(0)), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (5, 17, 30)]
    outs = []
    for impl, device in (("decode", "cpu"), ("decode", "cuda"), ("lookup", "cuda")):
        eng = Engine(model, cfg, max_slots=2, max_len=48, mpgemm_impl=impl, device=device)
        sched = ContinuousBatchingScheduler(eng)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        sched.submit(reqs)
        assert sched.run_to_completion().completed == 3
        outs.append([r.generated for r in reqs])
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.cuda
def test_paged_serving_on_the_card_matches_dense(cuda):
    """Smoke-size f32 chunked serving on the card: the paged engine (page
    size 8, prompts sharing a 16-token prefix, so later admissions hit the
    radix index) emits the dense engine's greedy tokens, its pools and
    block table live on the card, and paged whole-prompt serving on the
    card emits the CPU's tokens."""
    cfg = get_config("smollm-360m", smoke=True).with_(dtype="float32")
    model = pack_params(init_lm(cfg, torch.Generator().manual_seed(0)), cfg)
    rng = np.random.default_rng(1)
    stem = rng.integers(0, cfg.vocab, size=16).astype(np.int32)
    prompts = [np.concatenate([stem, rng.integers(0, cfg.vocab, size=n).astype(np.int32)])
               for n in (3, 9, 14, 5)]
    outs, engines = [], []
    for device, chunk, paged in (("cuda", 8, False), ("cuda", 8, True), ("cuda", 0, True),
                                 ("cpu", 0, True)):
        eng = Engine(model, cfg, max_slots=2, max_len=48, prefill_chunk=chunk, device=device,
                     paged_kv=PagedKVConfig(page_size=8) if paged else None)
        sched = ContinuousBatchingScheduler(eng)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        sched.submit(reqs)
        stats = sched.run_to_completion()
        assert stats.completed == 4 and (stats.prefix_hit_requests > 0) == paged
        outs.append([r.generated for r in reqs])
        engines.append(eng)
    assert outs[0] == outs[1] and outs[2] == outs[3]
    for layer in engines[1].cache:
        assert all(layer[k].is_cuda for k in ("k", "v", "slot_pos", "tab", "idx"))


# Only the summation order differs between the kernel (online softmax over
# 64-key tiles, FMA dot products) and its plain version (full softmax,
# einsum): f32 agrees to ~1e-6 of the output's scale; bf16 outputs are one
# rounding of nearly equal f32 values, so at most one bf16 ulp (2^-8
# relative) apart.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2 ** -7}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(cuda, dtype):
    """Ragged S, odd D, GQA groups, window, softcap, causal and not, and the
    model's (B, S, H, D) memory read through transposed views."""
    rng = np.random.default_rng(3)
    for b, s, h, kv, d in [(2, 17, 15, 5, 64), (1, 100, 3, 1, 20), (2, 130, 4, 4, 128),
                           (1, 65, 2, 1, 256), (1, 1, 2, 2, 32)]:
        q, k, v = (torch.tensor(rng.standard_normal((b, s, n, d)).astype(np.float32),
                                device=cuda).to(dtype).transpose(1, 2) for n in (h, kv, kv))
        for causal, window, softcap in [(True, 0, 0.0), (False, 0, 0.0), (True, 24, 0.0),
                                        (False, 24, 20.0), (True, 0, 20.0)]:
            before = fa.flash_attention.launches
            got = fa.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
            want = fa.flash_attention_plain(q, k, v, causal=causal, window=window, softcap=softcap)
            torch.cuda.synchronize()
            assert fa.flash_attention.launches == before + 1
            assert got.dtype == dtype and got.stride() == q.stride()
            err = (got.float() - want.float()).abs().max().item()
            assert err <= FLASH_TOL[dtype] * max(1.0, want.float().abs().max().item()), \
                (b, s, h, kv, d, causal, window, softcap, err)


@pytest.mark.cuda
def test_flash_trainable_gradients(cuda):
    """The autograd.Function's gradients equal autograd through the plain
    version (its backward is that VJP; only the forward is the kernel)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.standard_normal((2, 3, 40, 32)).astype(np.float32),
                            device=cuda, requires_grad=True) for _ in range(3))
    k2, v2 = (torch.tensor(rng.standard_normal((2, 1, 40, 32)).astype(np.float32),
                           device=cuda, requires_grad=True) for _ in range(2))
    dout = torch.tensor(rng.standard_normal((2, 3, 40, 32)).astype(np.float32), device=cuda)
    for kk, vv in ((k, v), (k2, v2)):
        out = fa.flash_attention_trainable(q, kk, vv, True, 16, 20.0)
        g_kern = torch.autograd.grad(out, (q, kk, vv), dout)
        want = fa.flash_attention_plain(q, kk, vv, causal=True, window=16, softcap=20.0)
        g_plain = torch.autograd.grad(want, (q, kk, vv), dout)
        # the same plain VJP twice: equal up to the library's run-to-run order
        for a, b in zip(g_kern, g_plain):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
