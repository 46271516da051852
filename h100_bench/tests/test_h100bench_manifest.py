"""BENCHMARK.json against the contract's limits, every file it names found
by name, a cell added as data files alone and a model family added as files
alone run end to end on the CPU, and what the harness does not implement
refused."""

from __future__ import annotations

import json
import re
import shutil
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


@pytest.mark.parametrize("key,value", [("ids", "zipf"), ("wire", "grpc"), ("hot_rows", 64),
                                       ("batch_size", 8.5), ("optimizer", "adam"),
                                       ("pooling", 0), ("pooling", [1, 2]),
                                       ("pooling", [1, 0, 2]), ("pooling", 2.0)])
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


# the check's numbers of the toy cells at seed 3 on the CPU (one thread), as
# the harness read them before a second family, a bag length a table and
# the CSR wire came in; grad_gap as read since the reference's first
# gradient is read back from its state as the program's is
TOY_READINGS = {
    "toy-score": {"prob_err": 0.0},
    "toy-score-l4": {"prob_err": 0.0},
    "toy-train": {"loss_gap": 1.59177409351052e-07, "grad_gap": 4.5366517912878865e-07,
                  "change_gap": 2.9802337145128673e-07},
    "toy-train-sgd": {"loss_gap": 0.0, "grad_gap": 9.654934942344977e-09,
                      "change_gap": 8.839979834238003e-08},
}


@pytest.mark.parametrize("traffic", list(TOY_READINGS))
def test_toy_cells_read_as_before(tmp_path, traffic):
    root = toy.make(tmp_path, (traffic,))
    result, proc = toy.run(root, f"{traffic}-cell")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert {k: c["value"] for k, c in result["checks"].items()} == TOY_READINGS[traffic]


NEW_MIXES = ["toy-score-lists", "toy-score-csr", "toy-train-lists", "toy-train-csr"]


@pytest.mark.parametrize("traffic", NEW_MIXES)
def test_family_added_as_files_alone(tmp_path, traffic):
    """A second interaction (``tests/toy_family``: ``dense/toycat.py`` and
    ``systems/toycat.py`` copied in, no file of the harness edited) runs
    score and train cells on both wires at a bag length a table, and is
    correct."""
    root = toy.make(tmp_path, (traffic,), family="toycat")
    result, proc = toy.run(root, f"{traffic}-cell")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is True, result
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("traffic,fault", [
    ("toy-score-lists", "answer"), ("toy-score-csr", "answer"),
    ("toy-train-lists", "half"), ("toy-train-csr", "half"),
    ("toy-train-lists", "state"), ("toy-train-csr", "state")])
def test_family_added_as_files_alone_catches_faults(tmp_path, traffic, fault):
    root = toy.make(tmp_path, (traffic,), family="toycat")
    result, proc = toy.run(root, f"{traffic}-cell", "--fault", fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("value,files", [("cross", ()), ("toycat", ("dense",)),
                                         ("toycat", ("systems",)), ("Dot", ()),
                                         ("../dot", ()), (3, ())])
def test_interaction_without_its_files_is_refused(tmp_path, value, files):
    """An interaction is implemented where both of its files exist."""
    root = toy.make(tmp_path, ("toy-score",))
    for folder in files:
        shutil.copy(toy.FAMILY_FILES / f"{folder}_toycat.py",
                    root / "h100_bench" / folder / "toycat.py")
    path = root / "h100_bench" / "configs" / "toy-dlrm.json"
    cfg = json.loads(path.read_text())
    cfg["interaction"] = value
    path.write_text(json.dumps(cfg))
    man = Manifest(root, root / "h100_bench")
    with pytest.raises(ValueError, match="interaction"):
        man.config(man.cell("toy-score-cell"))


@pytest.mark.parametrize("family,key,value", [("dot", "concat_scale", 0.5),
                                              ("dot", "cross_layers", 3),
                                              ("toycat", "concat_scale", None),
                                              ("toycat", "concat_scale", "half")])
def test_key_its_family_does_not_declare_is_refused(tmp_path, family, key, value):
    """A configuration holds the common keys and its family's own: a key
    that its interaction's module does not declare, or one it declares
    left out (None) or of another type, is refused."""
    root = toy.make(tmp_path, ("toy-score",), family=family)
    name = toy.FAMILIES[family][0]["name"]
    path = root / "h100_bench" / "configs" / f"{name}.json"
    cfg = json.loads(path.read_text())
    if value is None:
        del cfg[key]
    else:
        cfg[key] = value
    path.write_text(json.dumps(cfg))
    man = Manifest(root, root / "h100_bench")
    with pytest.raises(ValueError, match=key):
        man.config(man.cell("toy-score-cell"))
    result, proc = toy.run(root, "toy-score-cell")
    assert proc.returncode != 0 and result is None
