"""What the harness loads: never JAX or the JAX package (compared by whole
top-level name, since the port's name begins with the JAX package's), and
nothing of the port outside ``systems/``."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
YARDSTICK = ["gen", "reference", "yardstick", "tracing", "manifest", "readers",
             "faults", "spans", "dense.dot"]
PORT = "pim_embedding_lookup_tpu_torch"
JAX = {"jax", "jaxlib", "flax", "pim_embedding_lookup_tpu"}


def _loaded(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_yardstick_loads_nothing_of_the_program():
    top = _loaded("".join(f"import h100_bench.{m}\n" for m in YARDSTICK))
    assert not top & {"jax", "jaxlib", "flax", "pim_embedding_lookup_tpu",
                      "pim_embedding_lookup_tpu_torch"}


def test_harness_loads_the_port_and_no_jax():
    top = _loaded("import h100_bench.systems.dot, h100_bench.entries\n"
                  "from h100_bench import run\n"
                  "assert not run.forbidden_modules()")
    assert "pim_embedding_lookup_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "pim_embedding_lookup_tpu"}


def _imported(path: Path) -> set[str]:
    """Top-level names of the modules a source file imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_only_systems_import_the_program():
    """No module of the benchmark outside ``systems/`` and ``tests/``
    imports the port, and none imports JAX."""
    bench = REPO / "h100_bench"
    for path in bench.rglob("*.py"):
        part = path.relative_to(bench).parts[0]
        names = _imported(path)
        assert not names & JAX, path
        if part not in ("systems", "tests"):
            assert PORT not in names, path


def test_forbidden_names_compared_whole():
    sys.path.insert(0, str(REPO))
    from h100_bench import run

    saved = dict(sys.modules)
    try:
        sys.modules["pim_embedding_lookup_tpu_torch_x"] = sys
        assert "pim_embedding_lookup_tpu_torch_x" not in run.forbidden_modules()
        sys.modules["jax.numpy"] = sys
        assert "jax.numpy" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def _argv(cell="kaggle-score-b65536"):
    return [sys.executable, "h100_bench/run.py", "--workload", cell, "--seed", "1",
            "--seconds", "1", "--trace", "0"]


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(_argv(), cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_no_result_without_the_program(tmp_path):
    shutil.copytree(REPO / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(_argv(), cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()
