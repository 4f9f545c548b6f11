"""The port stands alone: no module of `src/repro_torch` and not
`chip_smoke.py` imports JAX or anything of the JAX package `repro`, nor
PyTorch's test-only helpers (`torch.testing._internal`: the fake process
group's backend is registered by the port's own code)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or name.startswith("torch.testing._internal")


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, (ast.Name, ast.Attribute))
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str) and not node.args[0].value.startswith(".")):
            yield node.lineno, node.args[0].value


def test_walk_covers_the_package():
    rels = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "chip_smoke.py" in rels
    assert "src/repro_torch/kernels/ops.py" in rels
    assert "src/repro_torch/serve/engine.py" in rels


def test_walk_covers_the_mla_slice():
    rels = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/models/mla.py", "src/repro_torch/configs/deepseek_v3_671b.py",
            "src/repro_torch/kernels/ternary_decode_gemm.py"} <= rels


def test_walk_covers_the_observability_slice():
    rels = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/obs/__init__.py", "src/repro_torch/obs/metrics.py",
            "src/repro_torch/obs/trace.py", "src/repro_torch/roofline/analysis.py"} <= rels


def test_walk_covers_the_encdec_slice():
    rels = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/models/encdec.py", "src/repro_torch/launch/steps.py",
            "src/repro_torch/configs/whisper_medium.py"} <= rels


def test_walk_covers_the_dist_slice():
    rels = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/dist/sharding.py", "src/repro_torch/dist/compression.py",
            "src/repro_torch/launch/mesh.py", "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/roofline/analysis.py"} <= rels


def test_walk_covers_the_autotune_slice():
    rels = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "src/repro_torch/kernels/autotune.py" in rels


def test_walk_covers_the_step_statistics_slice():
    rels = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"src/repro_torch/roofline/hlo_stats.py", "src/repro_torch/kernels/_library.py",
            "src/repro_torch/launch/mesh.py", "src/repro_torch/launch/dryrun.py"} <= rels


def test_walk_covers_the_lint_slice():
    rels = {p.relative_to(ROOT).as_posix() for p in FILES}
    lint = "src/repro_torch/lint/"
    assert {f"{lint}{m}.py" for m in ("__init__", "__main__", "core", "rules_hostsync",
                                      "rules_launch", "rules_recompile", "rules_scatter",
                                      "rules_timing", "sanitize")} <= rels
    assert {f"{lint}ir/{m}.py" for m in ("__init__", "core", "deadcode", "dtype_flow",
                                         "effects", "registry", "snapshots", "traffic")} <= rels


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line}: {name}" for line, name in _imports(tree) if _forbidden(name)]
    assert not bad, bad


def test_detector_flags_forbidden_imports():
    src = ("import jax\nimport jax.numpy as jnp\nfrom repro.core import packing\n"
           "import repro_torch\nfrom repro_torch.core import packing\n"
           "importlib.import_module('repro.configs')\n")
    found = [name for _, name in _imports(ast.parse(src)) if _forbidden(name)]
    assert found == ["jax", "jax.numpy", "repro.core", "repro.configs"]


def test_detector_flags_torch_testing_internal():
    src = ("from torch.testing._internal.distributed.fake_pg import FakeStore\n"
           "import torch.testing._internal.common_utils\nimport torch.testing\n"
           "from torch._C._distributed_c10d import FakeProcessGroup\n")
    found = [name for _, name in _imports(ast.parse(src)) if _forbidden(name)]
    assert found == ["torch.testing._internal.distributed.fake_pg",
                     "torch.testing._internal.common_utils"]
