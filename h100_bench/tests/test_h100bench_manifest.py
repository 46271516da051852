"""BENCHMARK.json against the contract's limits, every file it names found
by name, and a cell added as data files alone run end to end on the CPU."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import toy  # noqa: E402

REPO = toy.REPO
sys.path.insert(0, str(REPO))
from h100_bench.entries import ENTRIES  # noqa: E402
from h100_bench.manifest import NAME, UNIT, Manifest  # noqa: E402

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
ONE_LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "h100_bench/run.py"]
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert ONE_LINE.match(e[key]), (key, e[key])
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    man = Manifest(REPO)
    c = man.cell(cell)
    cfg, traffic, limits = man.config(c), man.traffic(c), man.limits(c)
    assert cfg["name"] == c["config"]
    assert traffic["entry"] in ENTRIES
    assert limits and all(v > 0 for v in limits.values())
    e2e = {m["name"] for m in man.end_to_end(c)}
    assert {"setup_s", "peak_mem_gb"} <= e2e and len(e2e) >= 3
    layer = man.per_layer(c)
    assert layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    path = REPO / config["file"]
    assert path == REPO / "h100_bench" / "configs" / f"{config['name']}.json"
    cfg = json.loads(path.read_text())
    assert cfg["reduced"] == config["reduced"]
    assert cfg["source"] == config["source"]
    assert cfg["mlp_bot"][-1] == cfg["dim"]


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_readers(metric):
    mod = Manifest(REPO).reader(metric["name"])
    assert mod.UNIT == metric["unit"]
    assert callable(mod.read)


@pytest.mark.parametrize("traffic", list(toy.TRAFFIC))
def test_cell_added_as_data_files_runs(tmp_path, traffic):
    root = toy.make(tmp_path, (traffic,))
    result, proc = toy.run(root, f"{traffic}-cell")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is True, result
    assert result["attempted"] > 0 and result["failed"] == 0
    entry = toy.TRAFFIC[traffic]["entry"]
    own = {"score": "score_samples_per_s", "train": "train_samples_per_s"}[entry]
    assert {own, "setup_s", "peak_mem_gb"} <= set(result["metrics"])
    assert list(result)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("traffic", ["toy-score", "toy-train"])
def test_traced_run(tmp_path, traffic):
    root = toy.make(tmp_path, (traffic,))
    result, proc = toy.run(root, f"{traffic}-cell", trace=1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is True
    assert result["device"]["window_s"] > 0
    assert "breakdown" in result
    # off the card no device metric is written
    assert result["metrics"] == {}


@pytest.mark.parametrize("key,value", [("ids", "zipf"), ("wire", "csr"), ("hot_rows", 64),
                                       ("batch_size", 8.5), ("optimizer", "adam")])
def test_traffic_the_harness_does_not_implement_is_refused(tmp_path, key, value):
    """A mix that declares ids, a wire or a key the generator does not
    implement is refused before anything runs, never run as something else."""
    root = toy.make(tmp_path, ("toy-train",))
    path = root / "h100_bench" / "traffic" / "toy-train.json"
    traffic = json.loads(path.read_text())
    traffic[key] = value
    path.write_text(json.dumps(traffic))
    man = Manifest(root, root / "h100_bench")
    with pytest.raises(ValueError, match=key):
        man.traffic(man.cell("toy-train-cell"))
    result, proc = toy.run(root, "toy-train-cell")
    assert proc.returncode != 0 and result is None


@pytest.mark.parametrize("key,value", [("interaction", "cat"), ("dtype", "bfloat16"),
                                       ("mesh", {"data": 2, "model": 2}),
                                       ("sharding", "row_hash"), ("small_set_bf16", True)])
def test_configuration_the_harness_does_not_implement_is_refused(tmp_path, key, value):
    root = toy.make(tmp_path, ("toy-score",))
    path = root / "h100_bench" / "configs" / "toy-dlrm.json"
    cfg = json.loads(path.read_text())
    cfg[key] = value
    path.write_text(json.dumps(cfg))
    man = Manifest(root, root / "h100_bench")
    with pytest.raises(ValueError, match=key):
        man.config(man.cell("toy-score-cell"))


def test_qualified_end_to_end_metric_reads_its_quantity(tmp_path):
    """``score_samples_per_s.<cells>`` is the score rate of the cells it lists."""
    root = toy.make(tmp_path, ("toy-score",))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"]:
        if m["name"] == "score_samples_per_s":
            m["workloads"].remove("toy-score-cell")
    bench["end_to_end"].append({"name": "score_samples_per_s.toy", "unit": "samples/s",
                                "better": "higher", "bound": 0.25, "source": "host_clock",
                                "workloads": ["toy-score-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result, proc = toy.run(root, "toy-score-cell")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["metrics"]["score_samples_per_s.toy"]["value"] > 0
    assert "score_samples_per_s" not in result["metrics"]
