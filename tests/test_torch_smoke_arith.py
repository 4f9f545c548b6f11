"""The arithmetic behind `chip_smoke.py`'s per-architecture phases (12, 13
and 20-21 above all), on the meta device (shapes only, nothing allocated):
the launches per forward of the published configs, counted on the model
(`launches_per_forward`) and reckoned from the config alone
(`reckoned_launches`); the packed bytes that make phase 20 cut
jamba-1.5-large-398b to one period of its layer pattern; the capacities its
grouped-kernel checks run at."""
import functools
import importlib.util
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import init_lm  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: the card's device memory, bytes (NVIDIA H100 80GB HBM3)
CARD_BYTES = 80e9


@functools.cache
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def meta_model(arch: str, n_layers: int | None = None):
    """(cfg, model): the published config (its first `n_layers` layers),
    packed, on the meta device."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers, layers=cfg.layers[:n_layers])
    return cfg, init_lm(cfg, torch.Generator(), packed=True, device="meta")


#: (arch, layers or None for all, single launches, grouped launches) per
#: forward: 14 single a dense GQA layer (7 BitLinears of two segments each),
#: 4 an SSM layer, 6 grouped a MoE layer; jamba's period 7 SSM + 1
#: attention mixers, 4 dense + 4 MoE FFNs; llama4's shared expert 4 single
FORWARDS = [
    ("jamba-1.5-large-398b", 8, 60, 24),
    ("internlm2-1.8b", None, 336, 0),
    ("command-r-35b", None, 560, 0),
    ("chameleon-34b", None, 672, 0),
    ("gemma3-1b", None, 364, 0),
    ("mamba2-1.3b", None, 192, 0),
    ("llama4-scout-17b-a16e", None, 8 * 48, 4 * 48),
]


@pytest.mark.parametrize("impl, fusion", [("decode", "fused"), ("lookup", "fused"),
                                          ("decode", "unfused")])
@pytest.mark.parametrize("arch, n_layers, single, grouped", FORWARDS)
def test_launches_per_forward(arch, n_layers, single, grouped, impl, fusion):
    cs = chip_smoke()
    cfg, model = meta_model(arch, n_layers)
    kernel = cs.single_kernel(impl, fusion)
    want = {kernel: single, **({f"{kernel}_grouped": grouped} if grouped else {})}
    assert cs.launches_per_forward(model, impl, fusion) == want
    assert cs.reckoned_launches(cfg, impl, fusion) == want


def test_hybrid_depth_cut():
    """72 packed layers do not fit the card; phase 20's one period does,
    with room for one MoE layer's dense bf16 weights while it is drawn."""
    cs = chip_smoke()
    full, cut = (cs.packed_model_bytes(meta_model(cs.HYBRID_ARCH, n)[1])["total"]
                 for n in (None, cs.HYBRID_LAYERS))
    assert full > CARD_BYTES and cut < 16e9
    cfg, _ = meta_model(cs.HYBRID_ARCH, cs.HYBRID_LAYERS)
    specs = cfg.layer_specs()
    assert [sp.mixer for sp in specs] == ["ssm"] * 3 + ["attn"] + ["ssm"] * 4
    assert [sp.ffn for sp in specs] == ["dense", "moe"] * 4
    assert [specs[i].mixer for i in cs.HYBRID_CHECK_LAYERS] == ["ssm", "attn"]
    assert specs[cs.HYBRID_MOE_LAYER].ffn == "moe"


def test_hybrid_capacities():
    """Phase 20's grouped checks run at the rows per expert that 4, 64 and
    250 tokens get under top-2 of 16 experts and factor 1.25 (a decode
    step, a 64-token prefill, the longest prompt), timed at a decode
    step's."""
    cs = chip_smoke()
    cfg = get_config(cs.HYBRID_ARCH)
    assert [capacity(t, cfg) for t in cs.HYBRID_CAPACITY_TOKENS] == [8, 16, 40]
    assert [capacity(t, cfg) for t in cs.HYBRID_TIME_TOKENS] == [8]
