"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, found in
``configs/<config>.json``, and a traffic mix, found in
``traffic/<traffic>.json``; the limits of its check are in
``workloads/<cell>.json``.  A per-layer metric is read by
``metrics/<metric>.py``.  A configuration's model family is named by its
``interaction``: ``dense/<interaction>.py`` holds the reference's dense half
and the keys the family adds, ``systems/<interaction>.py`` the port's model.
A new cell, configuration, family, mix or metric is a new file and an entry
in ``BENCHMARK.json``: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


FAMILY = re.compile(r"^[a-z][a-z0-9_]{0,63}$")


def _mesh(v) -> bool:
    """``{"data": d, "model": m}`` with whole d, m >= 1."""
    return isinstance(v, dict) and set(v) == {"data", "model"} and all(
        isinstance(n, int) and not isinstance(n, bool) and n >= 1 for n in v.values())


# Every key a configuration or a traffic mix may hold, with the values the
# harness implements: a tuple of the values it takes, the type of a free
# value, or a function that accepts the value.  A file with any other key or
# value is refused, so that no cell reports what it declares and does not
# run.  A configuration holds these and the ``CONFIG_KEYS`` of its family's
# ``dense/<interaction>.py``.  ``mesh``: d x m cards, one process a card,
# rank r at data row r // m and model column r % m (the port's
# ``parallel/mesh.py``); ``sharding`` places the big set over the model
# axis, and row or row_hash needs more than one card: a 1 x 1 cell runs in
# one process with no process group, where the port keeps every table whole.
CONFIG_KEYS = {
    "name": str, "source": str, "tables": list, "dim": int, "dtype": ("float32",),
    "dense_dim": int, "interaction": str,
    "collection": ("hybrid",), "small_set_max_rows": int,
    "sharding": ("replicate", "row", "row_hash"), "mesh": _mesh, "reduced": list,
    "assumed": dict,
}
# ``pooling``: one bag length for every table, or a list of one a table
_BATCHES = {"batch_size": int, "pooling": (int, list), "pool_batches": int, "in_flight": int,
            "ids": ("uniform",), "wire": ("dense", "csr"), "trace_seconds": (int, float),
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
        takes = repr(want)
        if isinstance(want, types.FunctionType):
            ok, takes = want(v), want.__doc__
        elif isinstance(want, tuple) and not all(isinstance(w, type) for w in want):
            ok = v in want
        else:
            ok = isinstance(v, want) and not isinstance(v, bool)
        if not ok:
            raise ValueError(f"{what}: {k} = {v!r} is not implemented (takes {takes})")
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
        what = f"configuration {cell['config']}"
        data = json.loads(self._file("configs", cell["config"], ".json").read_text())
        family = self._family("dense", what, data.get("interaction"))
        cfg = check_keys(what, data, {**CONFIG_KEYS, **family.CONFIG_KEYS})
        cards = mesh_size(cfg)
        if cards != cell["chips"]:
            raise ValueError(f"{what}: mesh = {cfg['mesh']!r} takes {cards} card(s), "
                             f"the cell {cell['name']} asks for {cell['chips']}")
        if cards == 1 and cfg["sharding"] != "replicate":
            raise ValueError(f"{what}: sharding = {cfg['sharding']!r} needs a mesh of more "
                             f"than one card, and mesh = {cfg['mesh']!r}")
        return cfg

    def dense(self, cfg: dict):
        """The module ``dense/<interaction>.py``: the reference's dense half
        of the configuration's family."""
        return self._family("dense", f"configuration {cfg['name']}", cfg["interaction"])

    def system(self, cfg: dict):
        """The module ``systems/<interaction>.py``: the port's model of the
        configuration's family."""
        return self._family("systems", f"configuration {cfg['name']}", cfg["interaction"])

    def _family(self, folder: str, what: str, value):
        """A family's module; a family is implemented where both of its
        files exist."""
        ok = isinstance(value, str) and FAMILY.match(value)
        if not ok or not all((self.here / f / f"{value}.py").is_file()
                             for f in ("dense", "systems")):
            raise ValueError(f"{what}: interaction = {value!r} is not implemented "
                             f"(no dense/<it>.py and systems/<it>.py)")
        return _load(f"h100_bench.{folder}.{value}", self.here / folder / f"{value}.py")

    def traffic(self, cell: dict) -> dict:
        what = f"traffic {cell['traffic']}"
        data = json.loads(self._file("traffic", cell["traffic"], ".json").read_text())
        keys = TRAFFIC_KEYS.get(data.get("entry"))
        if keys is None:
            raise ValueError(f"{what}: no entry {data.get('entry')!r}")
        check_keys(what, data, keys)
        pooling = data["pooling"]
        tables = len(json.loads(self._file("configs", cell["config"], ".json").read_text())
                     ["tables"])
        lengths = pooling if isinstance(pooling, list) else [pooling] * tables
        if len(lengths) != tables or not all(
                isinstance(n, int) and not isinstance(n, bool) and n >= 1 for n in lengths):
            raise ValueError(f"{what}: pooling = {pooling!r} is neither a bag length >= 1 "
                             f"nor a list of one for each of the {tables} tables")
        return data

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
        return _load("h100_bench_metric_" + metric.replace(".", "_").replace("-", "_"),
                     self._file("metrics", metric, ".py"))


def mesh_size(cfg: dict) -> int:
    """The cards, and processes, of a configuration's mesh."""
    return cfg["mesh"]["data"] * cfg["mesh"]["model"]


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
