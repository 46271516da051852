"""The port's lookup bench (``pim_embedding_lookup_tpu_torch/bench.py``),
the CLI's ``bench`` and ``sweep``, and the hybrid's ``mxu_threshold``,
against the JAX package and the repo-root ``bench.py`` on the CPU, at toy
sizes with ``--device cpu``.

* A module fixture runs the JAX bench on every case of ``CASES`` (each
  wire x dtype x ``--no-hybrid`` x ``--csr-ragged``, ``--mxu-threshold 32``
  where the big set is wanted), a few cases a process, the processes all
  at once.  For each case the port's ``bench.main`` prints the JAX bench's
  JSON keys (``tpu_us_per_iter`` as ``us_per_iter``) and besides only
  ``device_*`` keys, the same ``metric``, and the same fields on its
  ``layout:``, ``ragged CSR:`` and ``bucket plan:`` log lines (all but the
  pack's host time).
* ``build_lookup``'s first call equals the JAX collection's lookup on the
  same tables (the port's, through the JAX ``fused_host_array``) and the
  same host query, on every branch, at a mixed table set with both sets.
* ``HybridEmbeddingCollection.create(mxu_threshold=...)`` gives JAX's
  split, bucket plan and pooled output on both wires, at 500, 1000 and a
  threshold below every table (an empty small set, the sweep's case),
  with a float and an int8 big set.
* The sweep's records on every grid equal JAX's ``cmd_sweep`` records but
  for the rate fields, with both packages' rate call stubbed (the repo-root
  ``bench`` replaced in ``sys.modules``), at a budget that skips points and
  one that runs them; JAX's ``cmd_sweep`` with the real four-value return
  of ``bench.tpu_lookup_rate`` raises ``ValueError`` (the reference's fault,
  ``cli.py:388`` against ``bench.py:278``).
* The CLI's ``bench`` and ``sweep`` run on the CPU; without ``--device=cpu``
  and without a card both fail.
"""

import dataclasses
import importlib.util
import json
import os
import re
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.cli as jcli
import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu.ops.ragged import pack_length_buckets, plan_length_buckets
from pim_embedding_lookup_tpu.parallel import (
    EmbeddingCollection as JEC,
    HybridEmbeddingCollection as JHybrid,
    QuantizedEmbeddingCollection as JQuant,
    lookup_csr_bucketed,
    make_mesh,
)
from pim_embedding_lookup_tpu_torch import bench, cli
from pim_embedding_lookup_tpu_torch.parallel.hybrid import HybridEmbeddingCollection as THybrid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = ["--config", "toy", "--batch", "64", "--iters", "2", "--cpu-iters", "1"]
WIRES = {"dense": ["--wire", "dense"], "csr": ["--wire", "csr"],
         "csr-ragged": ["--wire", "csr", "--csr-ragged"],
         "bucketed": ["--wire", "csr-bucketed"],
         "bucketed-ragged": ["--wire", "csr-bucketed", "--csr-ragged"]}
# hybrid: big set only (toy tables have 64 rows, above 32), small set only
# (the default threshold), or no hybrid
SETS = {"hybrid-big": ["--mxu-threshold", "32"], "hybrid-small": [],
        "no-hybrid": ["--no-hybrid"]}
CASES = {
    f"{dtype}-{sets}-{wire}": ["--dtype", dtype, *SETS[sets], *WIRES[wire]]
    + ([] if (dtype, sets, wire) == ("bfloat16", "hybrid-big", "dense") else ["--no-baseline"])
    for dtype in ("float32", "bfloat16", "int8")
    for sets in SETS
    for wire in WIRES
    if sets != "hybrid-small" or wire in ("dense", "bucketed-ragged")
}
CASES["int8-row-hybrid-big-csr-ragged"] = ["--dtype", "int8", "--int8-scale", "row",
                                            *SETS["hybrid-big"], *WIRES["csr-ragged"],
                                            "--no-baseline"]
CASES["bfloat16-filter-big-dense"] = ["--mxu-threshold", "32", "--tables-filter", "big",
                                      "--no-baseline"]
JAX_PROCESSES = 4
LOG_LINES = ("layout:", "ragged CSR:", "bucket plan:")
RATE_FIELDS = {"lookups_per_s", "pooled_gbps", "mean_us", "device_mean_us"}
TOL = dict(rtol=1e-5, atol=1e-6)

# The JAX bench on several cases in one process: each case's JSON line and
# progress lines.
JAX_RUNNER = """
import contextlib, io, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import bench
out = {}
for name, argv in json.loads(sys.argv[1]):
    o, e = io.StringIO(), io.StringIO()
    sys.argv = ["bench.py"] + argv
    with contextlib.redirect_stdout(o), contextlib.redirect_stderr(e):
        bench.main()
    out[name] = {"line": json.loads(o.getvalue().strip().splitlines()[-1]),
                 "log": e.getvalue()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_bench():
    """{case: {"line": JSON line, "log": stderr}} of the JAX bench on one
    CPU device."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=1",
               OMP_NUM_THREADS="1")
    items = [(name, TOY + argv) for name, argv in CASES.items()]
    procs = [subprocess.Popen([sys.executable, "-c", JAX_RUNNER,
                               json.dumps(items[k::JAX_PROCESSES])],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=REPO, env=env)
             for k in range(JAX_PROCESSES)]
    runs = {}
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        runs.update(json.loads(out.strip().splitlines()[-1]))
    return runs


def log_fields(text):
    """{line kind: {field: value}} of the layout, ragged CSR and bucket plan
    lines, the pack's host time left out."""
    fields = {}
    for line in text.splitlines():
        for kind in LOG_LINES:
            if kind in line:
                body = line.split(kind, 1)[1]
                body = re.sub(r"host_pack=\S+", "", body)
                fields[kind] = re.findall(r"(\w+)=(\([^)]*\)|\S+)", body)
                if kind == "bucket plan:":
                    fields[kind].append(("packer", re.search(r"\((\w+) packer\)",
                                                             body).group(1)))
    return fields


@pytest.mark.parametrize("case", sorted(CASES))
def test_bench_line_and_log_match_jax(jax_bench, case, capsys):
    mine = bench.main(TOY + CASES[case] + ["--device", "cpu"])
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == mine
    want = dict(jax_bench[case]["line"])
    want["us_per_iter"] = want.pop("tpu_us_per_iter")
    assert set(want) <= set(mine), set(want) - set(mine)
    assert all(k.startswith("device_") for k in set(mine) - set(want)), set(mine) - set(want)
    assert mine["metric"] == want["metric"] and mine["unit"] == want["unit"]
    assert (mine["vs_baseline"] is None) == (want["vs_baseline"] is None)
    assert mine["device_name"] == "cpu" and mine["device_us_per_iter"] is None
    assert not any(mine["device_kernel_launches"].values())  # plain versions on the CPU
    jlog, tlog = log_fields(jax_bench[case]["log"]), log_fields(out.err)
    assert "layout:" in jlog and tlog == jlog


# -- build_lookup against the JAX collections ----------------------------------------

MIXED_ROWS = (3, 24, 583, 1460, 9000, 20000)  # 3 small tables and 3 big at 1000
THRESHOLD = 1000
BRANCHES = [  # (hybrid, dtype, int8 scale)
    (True, "float32", "table"), (True, "bfloat16", "table"), (True, "int8", "table"),
    (True, "int8", "row"), (False, "float32", "table"), (False, "bfloat16", "table"),
    (False, "int8", "table"), (False, "int8", "row"),
]


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(jcfg.MeshConfig(data=1, model=1))


def _tables(mod, rows=MIXED_ROWS, dim=16):
    return tuple(mod.TableConfig(num_rows=n, dim=dim, name=f"t{i}") for i, n in enumerate(rows))


def _np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def jax_twin(lk, jmesh, hybrid, dtype, scale):
    """The JAX collection of ``lk``'s branch and its params on ``lk``'s
    tables: float tables through the JAX ``device_put_tables``, int8 codes
    and scales as they are (global, in storage order)."""
    tables, pol = _tables(jcfg), jcfg.ShardingPolicy.REPLICATE
    cast = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    quant = dtype == "int8"

    def int8(params):
        return {k: jnp.asarray(v.numpy()) for k, v in params.items()}

    if hybrid:
        jc = JHybrid.create(tables, jmesh, pol, mxu_threshold=THRESHOLD, quantized_big=quant,
                            int8_scale_mode=scale)
        tc = lk.coll
        host = [None] * len(tables)
        for sub, ids in ((tc.small, tc.small_ids), (tc.big, tc.big_ids)):
            if sub is not None and not (quant and sub is tc.big):
                key = "small" if sub is tc.small else "big"
                for i, arr in zip(ids, sub.unfuse_host(lk.params[key].float())):
                    host[i] = arr
        jp = {"small": jc.small.device_put_tables([host[i] for i in tc.small_ids]).astype(cast)}
        jp["big"] = (int8(lk.params["big"]) if quant else
                     jc.big.device_put_tables([host[i] for i in tc.big_ids]).astype(cast))
        return jc, jp
    if quant:
        return JQuant.create(tables, jmesh, pol, scale_mode=scale), int8(lk.params)
    jc = JEC.create(tables, jmesh, pol, packed="auto")
    return jc, jc.device_put_tables(lk.coll.unfuse_host(lk.params.float())).astype(cast)


def jax_lookup(jc, jp, lk, wire, ragged):
    idx_np, off_np = lk.query
    if wire == "dense":
        return jc.lookup(jp, jnp.asarray(idx_np), jnp.ones(idx_np.shape, bool),
                         batch_size=lk.batch)
    if wire == "csr":
        return jc.lookup_csr(jp, jnp.asarray(idx_np), jnp.asarray(off_np))
    bls = (lk.pooling,) if not ragged else tuple(sorted({1, lk.pooling, 2 * lk.pooling}))
    plan = plan_length_buckets(off_np, bucket_ls=bls, slack=1.0)
    return lookup_csr_bucketed(jc, jp, pack_length_buckets(idx_np, off_np, plan))


@pytest.mark.parametrize("wire,ragged", [("dense", False), ("csr", False), ("csr", True),
                                         ("csr-bucketed", True)])
@pytest.mark.parametrize("hybrid,dtype,scale", BRANCHES)
def test_build_lookup_matches_jax(jmesh, hybrid, dtype, scale, wire, ragged):
    lk = bench.build_lookup(_tables(tcfg), 16, 3, seed=1, hybrid=hybrid, dtype=dtype,
                            mxu_threshold=THRESHOLD, wire=wire, int8_scale=scale,
                            csr_ragged=ragged, device="cpu")
    if hybrid:
        assert len(lk.coll.small_ids) == 3 and len(lk.coll.big_ids) == 3
    got = lk.fn(lk.idx)
    jc, jp = jax_twin(lk, jmesh, hybrid, dtype, scale)
    want = np.asarray(jax_lookup(jc, jp, lk, wire, ragged))
    assert got.shape == (16, len(MIXED_ROWS), 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_rotating_loop_rotates_bucketed_ids():
    """The bucketed wire's tuple of id arrays rotates alike, each table by
    its own stride, and stays in range."""
    lk = bench.build_lookup(_tables(tcfg), 16, 3, seed=2, wire="csr-bucketed",
                            csr_ragged=True, mxu_threshold=THRESHOLD, device="cpu")
    assert isinstance(lk.idx, tuple) and len(lk.idx) > 1
    loop = bench.common.RotatingLoop(lk.fn, lk.idx, lk.rows, lk.stride)
    loop()
    rows = np.asarray(MIXED_ROWS)[:, None]
    for before, after in zip(lk.idx, loop.idx):
        want = (before.numpy() + rows // 7 + 1) % rows
        np.testing.assert_array_equal(after.numpy(), want)
    assert float(loop.acc) == pytest.approx(float(lk.fn(lk.idx).sum()), rel=1e-6)


# -- mxu_threshold ---------------------------------------------------------------------

HYBRID_ROWS = (50, 40_000, 300, 60_000, 7)  # tests/test_hybrid.py's tables


@pytest.mark.parametrize("threshold", [500, 1000, 5])
@pytest.mark.parametrize("int8", [False, True])
def test_mxu_threshold_matches_jax(jmesh, threshold, int8):
    rng = np.random.default_rng(threshold)
    jt, tt = _tables(jcfg, HYBRID_ROWS), _tables(tcfg, HYBRID_ROWS)
    kw = dict(quantized_big=int8)
    jc = JHybrid.create(jt, jmesh, jcfg.ShardingPolicy.REPLICATE, mxu_threshold=threshold, **kw)
    tc = THybrid.create(tt, tcfg.ShardingPolicy.REPLICATE, mxu_threshold=threshold,
                        device="cpu", **kw)
    assert (tc.small_ids, tc.big_ids, tc.perm, tc.buckets) == (
        jc.small_ids, jc.big_ids, jc.perm, jc.buckets)
    if threshold == 5:  # below every table: no small set
        assert tc.small is None and jc.small is None and len(tc.big_ids) == 5
    host = [rng.standard_normal((n, 16)).astype(np.float32) for n in HYBRID_ROWS]
    jp, tp = jc.device_put_tables(host), tc.device_put_tables(host)
    b, l, t = 16, 3, len(HYBRID_ROWS)
    idx = np.stack([rng.integers(0, n, size=b * l) for n in HYBRID_ROWS]).astype(np.int32)
    mask = rng.random((t, b * l)) < 0.8
    got = tc.lookup(tp, torch.from_numpy(idx), torch.from_numpy(mask), batch_size=b)
    want = jc.lookup(jp, jnp.asarray(idx), jnp.asarray(mask), batch_size=b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lens = rng.integers(0, 5, size=(t, b))
    off = np.zeros((t, b + 1), np.int32)
    np.cumsum(lens, axis=1, out=off[:, 1:])
    cap = int(off[:, -1].max()) + 3
    cidx = np.stack([rng.integers(0, n, size=cap) for n in HYBRID_ROWS]).astype(np.int32)
    got = tc.lookup_csr(tp, torch.from_numpy(cidx), torch.from_numpy(off))
    want = jc.lookup_csr(jp, jnp.asarray(cidx), jnp.asarray(off))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the sweep ---------------------------------------------------------------------------


def jax_sweep(monkeypatch, capsys, argv, rate):
    """JAX's ``cmd_sweep`` records, the repo-root ``bench`` replaced by a
    module whose ``tpu_lookup_rate`` is ``rate``."""
    stub = types.ModuleType("bench")
    stub.tpu_lookup_rate = rate
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "bench", stub)
        jcli.cmd_sweep(argv)
    return [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]


SWEEPS = [
    *(["--grid", g, "--hbm-budget-gb", "0.1"] for g in cli.SWEEP_GRIDS),  # every point skips
    *(["--grid", g] for g in cli.SWEEP_GRIDS),  # 13.0 GB: most points run
    ["--grid", "table-size", "--hbm-budget-gb", "80", "--quantized-above-gb", "20"],
    ["--grid", "table-count", "--dtype", "float32", "--no-hybrid", "--hbm-budget-gb", "1"],
]


@pytest.mark.parametrize("argv", SWEEPS, ids=lambda a: "_".join(a[1::2]))
def test_sweep_records_match_jax(monkeypatch, capsys, argv):
    calls = {"jax": [], "port": []}

    def jax_rate(tables, batch, pooling, iters, **kw):
        calls["jax"].append((len(tables), tables[0].num_rows, batch, pooling, iters,
                             kw["hybrid"], kw["dtype"], kw["quantized"]))
        return 1e6, 2.0, 3e-6  # the three values cmd_sweep unpacks

    want = jax_sweep(monkeypatch, capsys, argv, jax_rate)

    def build(tables, batch, pooling, **kw):
        calls["port"].append((len(tables), tables[0].num_rows, batch, pooling, kw["hybrid"],
                              kw["dtype"], kw["quantized"]))
        return None

    monkeypatch.setattr(bench, "build_lookup", build)
    monkeypatch.setattr(bench, "lookup_rate",
                        lambda lk, iters: bench.Rate(1e6, 2.0, 3e-6, 0.1, 2e-6, {}))
    got = cli.cmd_sweep(argv + ["--device", "cpu"])
    assert [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()] == got
    assert [{k: v for k, v in r.items() if k not in RATE_FIELDS} for r in got] == [
        {k: v for k, v in r.items() if k not in RATE_FIELDS} for r in want]
    assert all(set(g) == set(w) | ({"device_mean_us"} if "mean_us" in w else set())
               for g, w in zip(got, want))
    assert [c[:4] + c[5:] for c in calls["jax"]] == calls["port"]
    if "0.1" in argv:  # a budget that skips points
        assert any("skipped" in r for r in got)
    else:  # one that runs them
        assert calls["port"]


def test_jax_sweep_fails_on_the_real_rate_return(monkeypatch, capsys):
    """The reference's fault: ``bench.tpu_lookup_rate`` returns four values
    (``lookups_per_s, gbps, dt, compile_s``, bench.py:278) and
    ``cmd_sweep`` unpacks three (cli.py:388), so the first point that runs
    raises.  The real function runs here on a toy table in place of the
    grid's."""
    spec = importlib.util.spec_from_file_location("repo_root_bench",
                                                  os.path.join(REPO, "bench.py"))
    real = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(real)
    toy = (jcfg.TableConfig(num_rows=64, dim=16, name="toy"),)

    def rate(tables, batch, pooling, iters, **kw):
        return real.tpu_lookup_rate(toy, 8, 2, 1, **kw)

    assert len(rate(None, 0, 0, 0, hybrid=True, dtype="bfloat16", quantized=False)) == 4
    with pytest.raises(ValueError, match="too many values to unpack"):
        jax_sweep(monkeypatch, capsys, ["--grid", "pooling"], rate)


def _cli(*runs):
    """Each argument list through the port's CLI in its own process, all at
    once; the finished processes' (returncode, stdout, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "pim_embedding_lookup_tpu_torch.cli",
                               *args], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=REPO, env=env) for args in runs]
    return [types.SimpleNamespace(returncode=p.returncode, stdout=out, stderr=err)
            for p in procs for out, err in [p.communicate(timeout=300)]]


def test_cli_bench_and_sweep_on_the_cpu():
    runs = _cli(("bench", "--device=cpu", "--config", "toy", "--iters", "2", "--no-baseline"),
                ("sweep", "--device=cpu", "--grid", "pooling", "--hbm-budget-gb", "0.1"),
                ("sweep", "--device=cpu", "--grid", "table-count", "--hbm-budget-gb", "0.13",
                 "--iters", "1"))
    for r in runs:
        assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(runs[0].stdout.strip().splitlines()[-1])
    assert line["metric"] == "criteo_toy_pooled_lookups_per_s_per_chip"
    assert "us_per_iter" in line and "tpu_us_per_iter" not in line
    skipped = [json.loads(x) for x in runs[1].stdout.strip().splitlines()]
    assert len(skipped) == 6 and all(r["needs_chips"] == 3 for r in skipped)
    ran = [json.loads(x) for x in runs[2].stdout.strip().splitlines()]
    assert ran[0]["tables"] == 2 and ran[0]["dtype"] == "bfloat16"
    assert ran[0]["lookups_per_s"] > 0 and ran[0]["device_mean_us"] is None
    assert all("skipped" in r for r in ran[1:])


def test_cli_bench_and_sweep_need_a_card_without_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for r in _cli(("bench", "--config", "toy", "--no-baseline"), ("sweep", "--grid", "pooling")):
        assert r.returncode != 0 and "CUDA is not available" in r.stderr, r.stderr[-2000:]
        assert not r.stdout.strip()  # no result: nothing fell back to the CPU


def test_lookup_is_a_dataclass_with_the_host_query():
    lk = bench.build_lookup(_tables(tcfg), 8, 2, wire="csr", csr_ragged=True, device="cpu")
    names = {f.name for f in dataclasses.fields(lk)}
    assert {"coll", "params", "idx", "fn", "query"} <= names
    idx_np, off_np = lk.query
    assert off_np.shape == (len(MIXED_ROWS), 9) and idx_np.shape[1] % 8 == 0
    np.testing.assert_array_equal(lk.idx.numpy(), idx_np)


@pytest.mark.parametrize("full_width", [False, True])
def test_kernel_launches_partition_the_counters(monkeypatch, full_width):
    """``tools/common.kernel_launches`` counts each launch in one kernel-table
    row, none negative, with masked int8 K2 launches among the int8 rows
    (the bench's JSON and chip_smoke both read this one mapping)."""
    from pim_embedding_lookup_tpu_torch.ops.csr_pool import (
        embedding_bag_csr_grad, embedding_bag_csr_packed, embedding_bag_csr_sum)
    from pim_embedding_lookup_tpu_torch.ops.gather_pool import embedding_bag_fixedl
    from pim_embedding_lookup_tpu_torch.tools import common

    counters = {  # 9 K1 (2 int8, 1 of them "row"; 3 bf16-rounded); 20 K2 (6 int8, 4 "row";
        # 5 masked, 3 int8)
        embedding_bag_fixedl: dict(launches=9, int8_launches=2, int8_row_launches=1,
                                   bf16_round_launches=3),
        embedding_bag_csr_packed: dict(launches=20, int8_launches=6, int8_row_launches=4,
                                       masked_launches=5, masked_int8_launches=3),
        embedding_bag_csr_sum: dict(launches=7),
        embedding_bag_csr_grad: dict(launches=8, masked_launches=2),
    }
    for fn, values in counters.items():
        for name, v in values.items():
            monkeypatch.setattr(fn, name, v)
    k2 = "K3" if full_width else "K2"
    assert common.kernel_launches(full_width) == {
        "K1": 4, "K1 small set": 3, "K1 int8 table": 1, "K1 int8 row": 1, k2: 12,
        "K2 int8 table": 2, "K2 int8 row": 4, "K2 masked": 2, "K4 fwd": 7, "K4 bwd": 6,
        "K4 bwd masked": 2}
    common.zero_kernel_launches()
    assert not any(common.kernel_launches().values())
