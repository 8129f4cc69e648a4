"""The entry point refuses to run without a card and in a directory that
holds only the benchmark; nothing under ``benchmark/`` imports JAX or the
JAX package, and the reference imports nothing of the port."""
from __future__ import annotations

import ast
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import cell, registry

FORBIDDEN = {"jax", "jaxlib", "flax", "poseestimator_tpu"}
ARGS = ["--workload", "d435_single.track", "--seed", "3000000007", "--seconds", "1",
        "--trace", "0"]


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_jax_and_a_standalone_reference():
    files = list(registry.HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f
    for f in (registry.HERE / "reference").rglob("*.py"):
        assert "poseestimator_tpu_torch" not in _imports(f), f
        assert "poseestimator_tpu_torch" not in f.read_text(), f


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "poseestimator_tpu_torch_fake", sys)
    assert "poseestimator_tpu" not in cell.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "poseestimator_tpu.utils", sys)
    assert cell.loaded_forbidden() == ["poseestimator_tpu"]


def _run(cwd):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    p = _run(registry.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
