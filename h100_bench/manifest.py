"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, found in
``configs/<config>.json``, and a traffic mix, found in
``traffic/<traffic>.json``; the limits of its check are in
``workloads/<cell>.json``.  A per-layer metric is read by
``metrics/<metric>.py``.  A new cell, configuration, mix or metric is a new
file and an entry in ``BENCHMARK.json``: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


# Every key a configuration or a traffic mix may hold, with the values the
# harness implements: a tuple of the values it takes, or the type of a free
# value.  A file with any other key or value is refused, so that no cell
# reports what it declares and does not run.
CONFIG_KEYS = {
    "name": str, "source": str, "tables": list, "dim": int, "dtype": ("float32",),
    "dense_dim": int, "mlp_bot": list, "mlp_top": list, "interaction": ("dot",),
    "collection": ("hybrid",), "small_set_max_rows": int, "sharding": ("replicate",),
    "mesh": ({"data": 1, "model": 1},), "reduced": list, "assumed": dict,
}
_BATCHES = {"batch_size": int, "pooling": int, "pool_batches": int, "in_flight": int,
            "ids": ("uniform",), "wire": ("dense",), "trace_seconds": (int, float),
            "about": str}
TRAFFIC_KEYS = {
    "score": {"entry": ("score",), **_BATCHES},
    "train": {"entry": ("train",), **_BATCHES, "optimizer": ("sgd", "row_adagrad"),
              "lr": (int, float), "eps": (int, float)},
}
OPTIONAL = {"about"}


def check_keys(what: str, data: dict, keys: dict) -> dict:
    """``data``, if it holds every key of ``keys`` but the optional ones,
    no other, and each with a value the harness implements."""
    missing = set(keys) - set(data) - OPTIONAL
    unknown = set(data) - set(keys)
    if missing or unknown:
        raise ValueError(f"{what}: keys missing {sorted(missing)}, unknown {sorted(unknown)}")
    for k, v in data.items():
        want = keys[k]
        if isinstance(want, tuple) and not all(isinstance(w, type) for w in want):
            ok = v in want
        else:
            ok = isinstance(v, want) and not isinstance(v, bool)
        if not ok:
            raise ValueError(f"{what}: {k} = {v!r} is not implemented (takes {want!r})")
    return data


class Manifest:
    def __init__(self, root: Path, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _named(self, key: str, name: str) -> dict:
        for entry in self.data[key]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"{key} has no entry named {name!r}")

    def _file(self, folder: str, name: str, suffix: str) -> Path:
        if not NAME.match(name):
            raise ValueError(f"not a name: {name!r}")
        return self.here / folder / f"{name}{suffix}"

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, cell: dict) -> dict:
        data = json.loads(self._file("configs", cell["config"], ".json").read_text())
        return check_keys(f"configuration {cell['config']}", data, CONFIG_KEYS)

    def traffic(self, cell: dict) -> dict:
        data = json.loads(self._file("traffic", cell["traffic"], ".json").read_text())
        keys = TRAFFIC_KEYS.get(data.get("entry"))
        if keys is None:
            raise ValueError(f"traffic {cell['traffic']}: no entry {data.get('entry')!r}")
        return check_keys(f"traffic {cell['traffic']}", data, keys)

    def limits(self, cell: dict) -> dict:
        path = self._file("workloads", cell["name"], ".json")
        return json.loads(path.read_text()).get("limits", {}) if path.exists() else {}

    def end_to_end(self, cell: dict) -> list[dict]:
        """The cell's end-to-end metrics."""
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list[dict]:
        """The per-layer metrics the cell reports: those that list it, or,
        with no list, those whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py``: its ``read(run)`` gives the
        metric's value, or None where the run holds nothing to read."""
        path = self._file("metrics", metric, ".py")
        spec = importlib.util.spec_from_file_location(
            "h100_bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
