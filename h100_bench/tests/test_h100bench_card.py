"""On the card (the ``cuda`` marker; skipped without one): the toy cells
correct, and the control, the reference with TF32 on in the program's
place, not correct."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import toy  # noqa: E402


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _run_on_card(root, cell, *extra):
    import json
    import os
    import subprocess

    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", cell, "--seed", "21",
         "--seconds", "0.5", "--trace", "0", *extra],
        cwd=root, env=dict(os.environ), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["toy-score", "toy-train"])
def test_toy_cell_on_card(tmp_path, traffic):
    _card()
    root = toy.make(tmp_path, (traffic,))
    assert _run_on_card(root, f"{traffic}-cell")["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["toy-score", "toy-train"])
def test_control_not_correct(tmp_path, traffic):
    _card()
    root = toy.make(tmp_path, (traffic,))
    assert _run_on_card(root, f"{traffic}-cell", "--control", "tf32")["correct"] is False
