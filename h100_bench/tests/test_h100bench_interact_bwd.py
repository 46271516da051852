"""The ``interact_bwd_ms.train`` reader by hand, on a made-up train trace."""

from __future__ import annotations

import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import toy  # noqa: E402
from test_h100bench_check import _activities, _span  # noqa: E402

sys.path.insert(0, str(toy.REPO))
from h100_bench.manifest import Manifest  # noqa: E402
from h100_bench.tracing import Trace  # noqa: E402

# two train steps: the dense half launches a GEMM (100 us) and the
# interaction's backward a fill and a write (4 + 6 us) in the first, the
# same (120; 5 + 7) in the second
TRAIN_EVENTS = [
    _span("window", 0, 2000),
    _span("pel.train_step", 100, 400), _span("pel.train.dense", 170, 300),
    _span("pel.interact.backward", 240, 270),
    _span("pel.train_step", 1000, 1350), _span("pel.train.dense", 1090, 1250),
    _span("pel.interact.backward", 1200, 1230),
    *_activities([(200, 100, "gemm"), (250, 4, "fill"), (260, 6, "index_elementwise_kernel"),
                  (1100, 120, "gemm"), (1210, 5, "fill"),
                  (1220, 7, "index_elementwise_kernel")]),
]


def test_interact_bwd_reader_by_hand():
    """``interact_bwd_ms.train``: device ms a step of what the backward span
    launched; None off the card, and None on a program without the span (one
    that still differentiates the gather by indexing)."""
    reader = Manifest(toy.REPO).reader("interact_bwd_ms.train")

    def run(events, platform="gpu"):
        return types.SimpleNamespace(context={"platform": platform}, trace=Trace(events))

    assert reader.read(run(TRAIN_EVENTS)) == pytest.approx((4 + 6 + 5 + 7) / 2 * 1e-3,
                                                           rel=1e-9)
    assert reader.read(run(TRAIN_EVENTS, "cpu")) is None
    parent = [e for e in TRAIN_EVENTS if e["name"] != "pel.interact.backward"]
    assert reader.read(run(parent)) is None
