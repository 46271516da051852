"""The port's multi-process tools on gloo CPU clusters: ``scaling_bench``
and ``routed_gather_audit`` (``pim_embedding_lookup_tpu_torch/tools``),
each run as a user runs it, ``--force-cpu 4`` (4 processes of one job with
torchrun's environment), all at once in a module fixture beside the JAX
``tools/scaling_bench.py`` on 4 virtual devices.

* scaling_bench, as ``tests/test_tools.py`` runs the JAX one: lookups/s at
  1, 2 and 4 shards, efficiency 1.0 at one shard, no routed drop (the
  data axis and the routed axis), and the JAX tool's keys;
* the audit at M = 1, 2 and 4, both capacity factors: the rows each shard
  gathers equal ``benchmarks/scaling_routed_cpu8.json``'s
  ``per_shard_gather_rows`` (cf 1.0) and ``per_shard_gather_rows_cf2``,
  which the JAX tool computed from its compiled HLO (the file is read,
  never written), and each record has the fields of the JAX ``audit()``.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALING = ["--force-cpu", "4", "--rows", "5000", "--tables", "2", "--batch", "64",
           "--pooling", "4", "--iters", "3"]
AUDIT_FIELDS = {"m", "e_total", "cf", "expected_routed_rows", "routed_gather_rows",
                "routed_csr_gather_rows", "broadcast_gather_rows"}


def _port(tool, args):
    return subprocess.Popen(
        [sys.executable, "-m", f"pim_embedding_lookup_tpu_torch.tools.{tool}", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


def _jax_scaling():
    code = ("import jax; jax.config.update('jax_platforms','cpu');"
            f"import sys; sys.argv=['tools/scaling_bench.py']+{SCALING!r};"
            "exec(open('tools/scaling_bench.py').read())")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)


@pytest.fixture(scope="module")
def runs():
    procs = {
        "data": _port("scaling_bench", SCALING),
        "routed": _port("scaling_bench", SCALING + ["--axis", "routed"]),
        "audit": _port("routed_gather_audit", ["--force-cpu", "4"]),
        "jax": _jax_scaling(),
    }
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, f"{name}: {stderr[-3000:]}"
        out[name] = [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]
    return out


@pytest.mark.parametrize("axis", ["data", "routed"])
def test_scaling_bench_force_cpu(runs, axis):
    rep = runs[axis][-1]
    assert list(rep["lookups_per_s"]) == ["1", "2", "4"]
    assert rep["scaling_efficiency"]["1"] == 1.0
    assert rep["routed_drops"] == {"1": 0, "2": 0, "4": 0}
    assert rep["axis"] == axis and rep["device_name"] == "cpu"
    want = set(runs["jax"][-1])
    assert want <= set(rep) and all(k.startswith("device_") for k in set(rep) - want)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_routed_audit_rows_match_committed_artifact(runs, m):
    with open(os.path.join(REPO, "benchmarks", "scaling_routed_cpu8.json")) as f:
        doc = json.load(f)
    records = {(r["m"], r["cf"]): r for r in runs["audit"]}
    for cf, section in ((1.0, "per_shard_gather_rows"), (2.0, "per_shard_gather_rows_cf2")):
        rec, want = records[(m, cf)], doc[section][str(m)]
        assert set(rec) == AUDIT_FIELDS
        assert rec["expected_routed_rows"] == want["expected_routed(me*k~cf*E/M)"]
        assert max(rec["routed_gather_rows"]) == want["routed_max_gather"]
        assert max(rec["routed_csr_gather_rows"]) == want["routed_csr_max_gather"]
        assert max(rec["broadcast_gather_rows"]) == want["broadcast_max_gather"]
        assert rec["e_total"] == want["e_total"]
        if m > 1 and cf == 1.0:  # routed: no gather touches all E entries
            assert rec["e_total"] not in rec["routed_gather_rows"] + rec["routed_csr_gather_rows"]
