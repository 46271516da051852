"""A checkout of toy cells for the CPU tests: the benchmark copied, the port
linked, and cells added as data files alone; with ``family="toycat"`` a toy
model family added as files alone too (``toy_family/``)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
PORT = "pim_embedding_lookup_tpu_torch"

TOY = {"name": "toy-dlrm", "source": "https://github.com/facebookresearch/dlrm",
       "tables": [50, 20000, 300, 9000], "dim": 8, "dtype": "float32", "dense_dim": 4,
       "mlp_bot": [16, 8], "mlp_top": [16, 1], "interaction": "dot", "collection": "hybrid",
       "small_set_max_rows": 8192, "sharding": "replicate",
       "mesh": {"data": 1, "model": 1}, "reduced": [], "assumed": {}}
# no table under the hybrid's split: the port pools a small table's rows in
# bf16, which after a step are no longer bf16 values, so the f32 reference
# departs from a toy batch's later steps by that rounding; the train cells
# run here without a small set, to hold them to f32 order-of-summation limits
TOY_BIG = dict(TOY, name="toy-big-dlrm", tables=[9000, 20000, 12000])
# a second family: its own dense half over the port's collection
TOYCAT = dict(TOY, name="toycat", interaction="toycat", concat_scale=0.5)
TOYCAT_BIG = dict(TOY_BIG, name="toycat-big", interaction="toycat", concat_scale=0.5)
# (score, train) configurations of each family
FAMILIES = {"dot": (TOY, TOY_BIG), "toycat": (TOYCAT, TOYCAT_BIG)}
FAMILY_FILES = Path(__file__).resolve().parent / "toy_family"
TRAFFIC = {
    "toy-score": {"entry": "score", "batch_size": 64, "pooling": 1, "pool_batches": 3,
                  "in_flight": 2, "trace_seconds": 0.2},
    "toy-score-l4": {"entry": "score", "batch_size": 32, "pooling": 4, "pool_batches": 2,
                     "in_flight": 2, "trace_seconds": 0.2},
    "toy-train": {"entry": "train", "batch_size": 64, "pooling": 1, "pool_batches": 4,
                  "in_flight": 2, "optimizer": "row_adagrad", "lr": 0.1, "eps": 1e-8,
                  "trace_seconds": 0.2},
    "toy-train-sgd": {"entry": "train", "batch_size": 64, "pooling": 2, "pool_batches": 4,
                      "in_flight": 2, "optimizer": "sgd", "lr": 0.1, "eps": 1e-8,
                      "trace_seconds": 0.2},
    # a bag length a table, on each wire (the score configurations have 4
    # tables, the train ones 3)
    "toy-score-lists": {"entry": "score", "batch_size": 32, "pooling": [2, 1, 3, 4],
                        "pool_batches": 2, "in_flight": 2, "trace_seconds": 0.2},
    "toy-score-csr": {"entry": "score", "batch_size": 32, "pooling": [2, 1, 3, 4],
                      "pool_batches": 2, "in_flight": 2, "trace_seconds": 0.2, "wire": "csr"},
    "toy-train-lists": {"entry": "train", "batch_size": 48, "pooling": [1, 3, 2],
                        "pool_batches": 4, "in_flight": 2, "optimizer": "sgd", "lr": 0.1,
                        "eps": 1e-8, "trace_seconds": 0.2},
    "toy-train-csr": {"entry": "train", "batch_size": 48, "pooling": [1, 3, 2],
                      "pool_batches": 4, "in_flight": 2, "optimizer": "row_adagrad",
                      "lr": 0.1, "eps": 1e-8, "trace_seconds": 0.2, "wire": "csr"},
}
for _t in TRAFFIC.values():
    _t.setdefault("wire", "dense")
    _t.update(ids="uniform")
# each entry's own end-to-end metric, added where BENCHMARK.json lacks it
OWN_METRIC = {
    "score": {"name": "score_samples_per_s", "unit": "samples/s", "better": "higher",
              "bound": 0.25, "source": "host_clock"},
    "train": {"name": "train_samples_per_s", "unit": "samples/s", "better": "higher",
              "bound": 0.25, "source": "host_clock"},
}
# the program's CPU path against the reference on the CPU: f32 in another
# order of summation
LIMITS = {"prob_err": 1e-5, "loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4}


def make(tmp: Path, traffics=tuple(TRAFFIC), family: str = "dot") -> Path:
    """A checkout in ``tmp``: ``BENCHMARK.json`` and ``h100_bench`` copied,
    the port linked, and a toy cell of ``family`` for each of ``traffics``
    added; a family other than ``dot`` comes in as its two files."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "h100_bench", root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(REPO / PORT, root / PORT)
    if family != "dot":
        for folder in ("dense", "systems"):
            shutil.copy(FAMILY_FILES / f"{folder}_{family}.py",
                        root / "h100_bench" / folder / f"{family}.py")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for cfg in FAMILIES[family]:
        cname = cfg["name"]
        (root / "h100_bench" / "configs" / f"{cname}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cname, "source": cfg["source"],
                                 "file": f"h100_bench/configs/{cname}.json", "reduced": [],
                                 "why": "toy"})
    for name in traffics:
        (root / "h100_bench" / "traffic" / f"{name}.json").write_text(json.dumps(TRAFFIC[name]))
        (root / "h100_bench" / "workloads" / f"{name}-cell.json").write_text(
            json.dumps({"limits": LIMITS}))
        entry = TRAFFIC[name]["entry"]
        cname = FAMILIES[family][entry == "train"]["name"]
        bench["workloads"].append({"name": f"{name}-cell", "config": cname,
                                   "traffic": name, "chips": 1, "why": "toy"})
        own = OWN_METRIC[entry]
        if own["name"] not in {m["name"] for m in bench["end_to_end"]}:
            bench["end_to_end"].append(dict(own, workloads=[]))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and (m["name"] == own["name"] or m["name"].endswith("." + entry)):
                m["workloads"].append(f"{name}-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, cell: str, *extra: str, seed: int = 3, seconds: float = 0.3,
        trace: int = 0, timeout: float = 240) -> tuple[dict | None, subprocess.CompletedProcess]:
    """Runs one cell on the CPU; returns (the result line or None, the process)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", cell, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace), "--device", "cpu", *extra],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return result, proc
