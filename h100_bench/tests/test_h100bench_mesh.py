"""A cell over a mesh on the CPU (gloo): the manifest's mesh and sharding,
``run.py`` launching one process a rank over 2 x 1, 1 x 2 and 2 x 2 meshes
with the check correct, a planted fault caught, and a rank that fails
ending the run."""

from __future__ import annotations

import json
import re
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import toy  # noqa: E402

REPO = toy.REPO
sys.path.insert(0, str(REPO))
from h100_bench import gen, reference  # noqa: E402
from h100_bench.manifest import Manifest  # noqa: E402
from h100_bench.ranks import Ranks  # noqa: E402

# (configuration, traffic, mesh, sharding): a cell "<name>-cell" each
MESH_CELLS = {
    "score-2x1": (toy.TOY, "toy-score", (2, 1), "replicate"),
    "score-1x2": (toy.TOY, "toy-score", (1, 2), "row_hash"),
    "train-2x2": (toy.TOY_BIG, "toy-train", (2, 2), "row_hash"),
}
# a family whose rank 1 fails in set-up, after rank 0 has joined
RAISING = '''from h100_bench.systems.dot import PortSystem as _Dot


class PortSystem(_Dot):
    def __init__(self, cfg, seed, device, mesh=None):
        if mesh is not None and mesh.rank == 1:
            raise RuntimeError("planted: rank 1 fails in set-up")
        super().__init__(cfg, seed, device, mesh=mesh)
'''


def _mesh_checkout(tmp: Path) -> Path:
    """A checkout of the toy cells with each of ``MESH_CELLS`` added as
    data files, and the raising family's 1 x 2 score cell."""
    root = toy.make(tmp, ("toy-score", "toy-train"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    h = root / "h100_bench"
    (h / "systems" / "raising.py").write_text(RAISING)
    (h / "dense" / "raising.py").write_text("from h100_bench.dense.dot import *  # noqa\n")
    cells = dict(MESH_CELLS, **{"raises-1x2": (dict(toy.TOY, interaction="raising"),
                                               "toy-score", (1, 2), "row_hash")})
    for name, (cfg, traffic, (d, m), sharding) in cells.items():
        cname = f"toy-{name}"
        cfg = dict(cfg, name=cname, mesh={"data": d, "model": m}, sharding=sharding)
        (h / "configs" / f"{cname}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cname, "source": cfg["source"],
                                 "file": f"h100_bench/configs/{cname}.json", "reduced": [],
                                 "why": "toy"})
        (h / "workloads" / f"{name}-cell.json").write_text(json.dumps({"limits": toy.LIMITS}))
        bench["workloads"].append({"name": f"{name}-cell", "config": cname, "traffic": traffic,
                                   "chips": d * m, "why": "toy"})
        for metric in bench["end_to_end"]:
            if f"{traffic}-cell" in metric.get("workloads", []):
                metric["workloads"].append(f"{name}-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return _mesh_checkout(tmp_path_factory.mktemp("mesh"))


def _config(root, cell, **change):
    """``Manifest.config`` of ``cell`` with its configuration file changed."""
    man = Manifest(root, root / "h100_bench")
    c = man.cell(cell)
    path = root / "h100_bench" / "configs" / f"{c['config']}.json"
    saved = path.read_text()
    try:
        path.write_text(json.dumps(dict(json.loads(saved), **change)))
        return man.config(c)
    finally:
        path.write_text(saved)


# -- the manifest ----------------------------------------------------------------


def test_manifest_takes_a_mesh_of_the_cells_cards(checkout):
    cfg = _config(checkout, "train-2x2-cell")
    assert cfg["mesh"] == {"data": 2, "model": 2} and cfg["sharding"] == "row_hash"
    assert _config(checkout, "score-1x2-cell", sharding="row")["sharding"] == "row"


@pytest.mark.parametrize("cell,change,key", [
    ("toy-score-cell", {"mesh": {"data": 2, "model": 2}}, "mesh"),
    ("train-2x2-cell", {"mesh": {"data": 2, "model": 1}}, "mesh"),
    ("train-2x2-cell", {"mesh": {"data": 2, "model": 0}}, "mesh"),
    ("train-2x2-cell", {"mesh": {"data": 4}}, "mesh"),
    ("train-2x2-cell", {"sharding": "column"}, "sharding"),
    ("toy-score-cell", {"sharding": "row"}, "sharding"),
])
def test_manifest_refuses_another_mesh_or_sharding(checkout, cell, change, key):
    with pytest.raises(ValueError, match=key) as err:
        _config(checkout, cell, **change)
    if key == "mesh" and all(n >= 1 for n in change["mesh"].values()) and len(
            change["mesh"]) == 2:  # names both numbers: the mesh's cards and the cell's
        assert re.search(r"takes \d+ card.*asks for \d+", str(err.value))


@pytest.mark.parametrize("config", ["criteo-kaggle-dlrm", "rsh-random-dlrm", "mlperf-dcnv2"])
def test_real_configurations_parse_as_before(config):
    man = Manifest(REPO)
    cell = next(w for w in man.data["workloads"] if w["config"] == config)
    cfg = man.config(cell)
    assert cfg == json.loads((REPO / "h100_bench" / "configs" / f"{config}.json").read_text())
    assert cfg["mesh"] == {"data": 1, "model": 1} and cfg["sharding"] == "replicate"


# -- the batch over the data axis ------------------------------------------------


class _Row:
    """A ``Ranks`` with its place in the mesh and no process group."""
    data_slice = Ranks.data_slice

    def __init__(self, data, index):
        self.data, self.data_index = data, index


@pytest.mark.parametrize("wire", ["dense", "csr"])
def test_data_rows_pool_their_samples(wire):
    """Each data row's part of a batch pools to its samples' rows of the
    global batch's pooling, on either wire."""
    cfg, seed = toy.TOY, 5
    b = gen.batch(seed, 0, table_rows_=tuple(cfg["tables"]), batch_size=12,
                  pooling=[2, 1, 3, 4], dense_dim=cfg["dense_dim"], device=torch.device("cpu"),
                  wire=wire)
    whole = reference.pooled(cfg, seed, b, 12)
    for i in range(3):
        part = _Row(3, i).data_slice(b)
        torch.testing.assert_close(reference.pooled(cfg, seed, part, 4), whole[4 * i:4 * i + 4],
                                   rtol=0, atol=0)
        assert torch.equal(part["labels"], b["labels"][4 * i:4 * i + 4])


# -- run.py over a mesh ----------------------------------------------------------


def _calls(proc) -> int:
    """The call count rank 0 fixed and every rank made, as rank 0 says."""
    found = re.findall(r"^mesh \d+ x \d+: (\d+) calls on every rank$", proc.stderr, re.M)
    assert len(found) == 1, proc.stderr[-3000:]
    return int(found[0])


@pytest.mark.parametrize("name", list(MESH_CELLS))
def test_mesh_cell_runs_correct(checkout, name):
    result, proc = toy.run(checkout, f"{name}-cell", seed=2**31 + 7, seconds=0.5, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is True, result
    assert result["attempted"] == _calls(proc) > 0 and result["failed"] == 0
    assert result["device"]["count"] == MESH_CELLS[name][2][0] * MESH_CELLS[name][2][1]
    assert list(result)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-1].startswith("check ")
    assert proc.stdout.strip().count("\n") == 0  # one line: rank 0's result alone


def test_mesh_fault_caught(checkout):
    result, proc = toy.run(checkout, "score-1x2-cell", "--fault", "answer", timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is False
    assert result["checks"]["prob_err"]["value"] > result["checks"]["prob_err"]["limit"]


def test_failing_rank_ends_the_run(checkout):
    t0 = time.monotonic()
    result, proc = toy.run(checkout, "raises-1x2-cell", timeout=120)
    assert proc.returncode != 0 and result is None and not proc.stdout.strip()
    assert "planted: rank 1 fails" in proc.stderr
    assert "rank 1 exited with code" in proc.stderr
    assert time.monotonic() - t0 < 60


def test_no_rank_left_behind(checkout):
    """The launcher waits for every rank: none outlives the run."""
    result, proc = toy.run(checkout, "score-2x1-cell", timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert not [p for p in Path("/proc").iterdir() if p.name.isdigit() and _is_rank(p, checkout)]


def _is_rank(proc_dir: Path, root: Path) -> bool:
    """Whether the process is a rank of ``run.py`` in ``root``."""
    try:
        cmd = (proc_dir / "cmdline").read_bytes().split(b"\0")
    except OSError:
        return False
    return b"--rank" in cmd and any(str(root).encode() in c for c in cmd)
