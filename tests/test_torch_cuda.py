"""The port's CUDA kernels on the card. Marked `cuda`: each test skips where
there is no NVIDIA GPU (the kernels have no CPU mode; on the CPU the
wrappers run the plain versions that the parity tests pin to JAX). This
file imports no JAX, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import act_token_scale  # noqa: E402
from repro_torch.kernels import ternary_decode_gemm as tdg  # noqa: E402
from repro_torch.kernels import vlut_lookup_gemm as vlg  # noqa: E402
from repro_torch.models import init_lm, pack_params  # noqa: E402
from repro_torch.serve import ContinuousBatchingScheduler, Engine, Request  # noqa: E402

KERNELS = {
    "decode": (tdg.ternary_decode_gemm_fused, tdg.ternary_decode_gemm_fused_plain),
    "lookup": (vlg.vlut_lookup_gemm_fused, vlg.vlut_lookup_gemm_fused_plain),
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
