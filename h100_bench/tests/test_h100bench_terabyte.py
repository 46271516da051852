"""terabyte-train-2x2: MLPerf DLRM on Criteo Terabyte over 2 x 2 cards.

Its configuration parses with its mesh and row_hash sharding at the
published widths; a toy of the same keys and traffic (rows, dim and batch
cut) runs over a 2 x 2 gloo mesh on the CPU, correct, with the ``half`` and
``state`` faults caught; and its readers
(``metrics/*.tb.py``) give on a made-up trace what is worked out by hand,
and None where the program records no collective span."""

from __future__ import annotations

import json
import sys
import types
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import toy  # noqa: E402

REPO = toy.REPO
sys.path.insert(0, str(REPO))
from h100_bench.dense import dot  # noqa: E402
from h100_bench.manifest import Manifest  # noqa: E402
from h100_bench.tracing import Trace  # noqa: E402

CELL = "terabyte-train-2x2"
# the toy's limits: the cell's, but for the loss, which at B=64 moves by up
# to 2.6e-5 where the small set's rows, no longer bf16 values after a step
# at lr 1.0, are pooled rounded to bf16 (the faults read 0.02 and more)
TOY_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 0.05}
TB_METRICS = ["lookup_ms.tb", "dense_ms.tb", "sparse_update_ms.tb", "comm_model_ms.tb",
              "comm_data_ms.tb", "comm_calls.tb", "host_ms.tb", "launches.tb", "mfu.tb",
              "device_idle.tb"]


def _cell():
    man = Manifest(REPO)
    cell = man.cell(CELL)
    return man, cell, man.config(cell), man.traffic(cell)


def test_configuration_at_its_published_widths():
    man, cell, cfg, traffic = _cell()
    assert cell["chips"] == 4 and cfg["mesh"] == {"data": 2, "model": 2}
    assert cfg["sharding"] == "row_hash" and cfg["reduced"] == []
    assert len(cfg["tables"]) == 26 and sum(cfg["tables"]) == 187_767_399
    assert max(cfg["tables"]) <= 40_000_000
    assert sum(n <= cfg["small_set_max_rows"] for n in cfg["tables"]) == 13
    assert cfg["dim"] == 128 and cfg["mlp_bot"] == [512, 256, 128]
    assert cfg["mlp_top"] == [1024, 1024, 512, 256, 1]
    assert dot.top_in(cfg) == 479
    assert (traffic["entry"], traffic["batch_size"], traffic["optimizer"], traffic["lr"]) == (
        "train", 65536, "sgd", 1.0)
    assert set(man.limits(cell)) == {"loss_gap", "grad_gap", "change_gap"}


def test_cell_reports_its_metrics():
    man, cell, _, _ = _cell()
    assert {m["name"] for m in man.end_to_end(cell)} == {
        "train_samples_per_s", "peak_mem_gb", "setup_s"}
    assert [m["name"] for m in man.per_layer(cell)] == TB_METRICS


# -- a toy of the cell over a 2 x 2 gloo mesh --------------------------------------


@pytest.fixture(scope="module")
def toy_checkout(tmp_path_factory):
    """The benchmark with a toy of the cell: its configuration with every
    table of more than 8192 rows cut to 9,000-15,000 rows and the widths cut
    to dim 8, its traffic at B=64, ``TOY_LIMITS``."""
    root = toy.make(tmp_path_factory.mktemp("terabyte"), ())
    h = root / "h100_bench"
    real = json.loads((h / "configs" / "mlperf-dlrm-terabyte.json").read_text())
    rows = [n if n <= real["small_set_max_rows"] else 9000 + 500 * i
            for i, n in enumerate(real["tables"])]
    cfg = dict(real, name="toy-terabyte", tables=rows, dim=8, mlp_bot=[16, 8],
               mlp_top=[32, 16, 1])
    (h / "configs" / "toy-terabyte.json").write_text(json.dumps(cfg))
    traffic = dict(json.loads((h / "traffic" / "train-b65536-sgd.json").read_text()),
                   batch_size=64, in_flight=2, trace_seconds=0.2)
    (h / "traffic" / "toy-train-sgd-b64.json").write_text(json.dumps(traffic))
    (h / "workloads" / "toy-tb-cell.json").write_text(json.dumps({"limits": TOY_LIMITS}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-terabyte", "source": cfg["source"],
                             "file": "h100_bench/configs/toy-terabyte.json", "reduced": [],
                             "why": "toy"})
    bench["workloads"].append({"name": "toy-tb-cell", "config": "toy-terabyte",
                               "traffic": "toy-train-sgd-b64", "chips": 4, "why": "toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("toy-tb-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_toy_runs_correct_over_2x2(toy_checkout):
    result, proc = toy.run(toy_checkout, "toy-tb-cell", seed=2**31 + 53, seconds=0.5,
                           timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is True, result
    assert result["device"]["count"] == 4 and result["failed"] == 0
    assert "mesh 2 x 2: " in proc.stderr


@pytest.mark.parametrize("fault", ["half", "state"])
def test_toy_faults_caught(toy_checkout, fault):
    result, proc = toy.run(toy_checkout, "toy-tb-cell", "--fault", fault, seed=2**31 + 53,
                           seconds=0.5, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_toy_traced_over_2x2(toy_checkout):
    """Off the card the traced run writes no device metric, and the new
    readers raise nothing."""
    result, proc = toy.run(toy_checkout, "toy-tb-cell", seed=11, seconds=0.3, trace=1,
                           timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["metrics"] == {}


# -- the readers on a made-up trace --------------------------------------------------


def _span(name, lo, hi):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": lo, "dur": hi - lo}


def _activities(launches):
    """A runtime launch at host time ``t`` and its device activity of
    ``dur`` microseconds, tied by a correlation id."""
    out = []
    for corr, (t, dur, cat) in enumerate(launches, start=1):
        out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
                    "dur": 2, "args": {"correlation": corr}})
        out.append({"ph": "X", "cat": cat, "name": f"k{corr}", "ts": 5000 + 100 * corr,
                    "dur": dur, "args": {"correlation": corr}})
    return out


def _step(t0):
    """One train step's spans from host time ``t0``: the big set's psum in
    the lookup, two all-reduces in the dense half, six gathers in the
    sparse update."""
    data = [(t0 + 500, t0 + 520), (t0 + 540, t0 + 550)] + [
        (t0 + 620 + 20 * i, t0 + 630 + 20 * i) for i in range(6)]
    return [_span("pel.train_step", t0 + 100, t0 + 900), _span("pel.lookup", t0 + 110, t0 + 200),
            _span("pel.lookup.big", t0 + 150, t0 + 195),
            _span("pel.comm.model", t0 + 180, t0 + 190),
            _span("pel.train.dense", t0 + 210, t0 + 600),
            _span("pel.sparse_update", t0 + 610, t0 + 880),
            *[_span("pel.comm.data", lo, hi) for lo, hi in data]]


# two steps: the lookup launches 10 (K1) + 30 (psum) us and 40 (psum);
# the dense half 200 and 300 + 8 (an all-reduce) us; the sparse update 20
# (a gather) + 50 us and 60 us; one kernel outside the steps
TB_EVENTS = [
    _span("window", 0, 3000), *_step(0), *_step(1000),
    *_activities([(160, 10, "kernel"), (185, 30, "kernel"), (1185, 40, "kernel"),
                  (300, 200, "kernel"), (1300, 300, "kernel"), (1505, 8, "kernel"),
                  (625, 20, "kernel"), (800, 50, "kernel"), (1800, 60, "kernel"),
                  (2500, 99, "kernel")]),
]
READINGS = [
    ("comm_model_ms.tb", (30 + 40) / 2 * 1e-3),
    ("comm_data_ms.tb", (8 + 20) / 2 * 1e-3),
    ("comm_calls.tb", 9.0),
    ("lookup_ms.tb", (10 + 30 + 40) / 2 * 1e-3),
    ("dense_ms.tb", (200 + 300 + 8) / 2 * 1e-3),
    ("sparse_update_ms.tb", (20 + 50 + 60) / 2 * 1e-3),
    ("host_ms.tb", 800 * 1e-3),
    ("launches.tb", 9 / 2),
]


def _run(events, platform="gpu"):
    return types.SimpleNamespace(context={"platform": platform}, trace=Trace(events))


@pytest.mark.parametrize("metric,want", READINGS, ids=[r[0] for r in READINGS])
def test_tb_reader_by_hand(metric, want):
    reader = Manifest(REPO).reader(metric)
    assert reader.read(_run(TB_EVENTS)) == pytest.approx(want, rel=1e-9)
    assert reader.read(_run(TB_EVENTS, "cpu")) is None
    unspanned = [e for e in TB_EVENTS if not e["name"].startswith("pel.")]
    assert reader.read(_run(unspanned)) is None


@pytest.mark.parametrize("metric", ["comm_model_ms.tb", "comm_data_ms.tb", "comm_calls.tb"])
def test_comm_readers_silent_without_comm_spans(metric):
    """A program that records no collective span, as the port did before
    its collectives had spans: the readers give None and raise nothing."""
    no_comm = [e for e in TB_EVENTS if not e["name"].startswith("pel.comm.")]
    assert Manifest(REPO).reader(metric).read(_run(no_comm)) is None


def test_whole_step_readers():
    """``mfu.tb`` counts rank 0's own samples against one card's peak, and
    ``device_idle.tb`` reads the traced window: as their ``.train``
    siblings read the same run."""
    man = Manifest(REPO)
    run = types.SimpleNamespace(
        context={"platform": "gpu", "flops_per_sample": 3 * 4_820_000, "samples": 32768 * 380,
                 "window_s": 10.0}, trace=Trace(TB_EVENTS))
    for ours, theirs in (("mfu.tb", "mfu.train"), ("device_idle.tb", "device_idle.train")):
        assert man.reader(ours).read(run) == man.reader(theirs).read(run) is not None
