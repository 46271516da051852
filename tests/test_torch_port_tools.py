"""The port's single-process measurement tools
(``pim_embedding_lookup_tpu_torch/tools``) against the JAX package's
``tools/`` on the CPU, at toy sizes with ``--device cpu``.

A module fixture runs the JAX tools once, each in its own process, all at
once, with the arguments ``tests/test_tools.py`` gives them (train_bench,
which it does not run, at toy size); each port tool's JSON line has every
key of its JAX counterpart's, and besides only ``device_*`` keys.  Then the
numbers behind each tool, from the same params (converted from JAX) and
the same ids:

* train_bench's loss a step over 4 rotated sparse steps equals the JAX
  package's sparse step (rtol 1e-5), both wires and both optimisers;
* phase_bench's fetched block equals the JAX collection's lookup on the
  same bf16 params (bf16: rtol 2**-7);
* capacity_bench's three lookups, and their sums over 3 rotated
  iterations, equal the JAX int8 collection's (1e-5);
* a micro-batched, bucket-padded serving_bench dispatch gives each real
  request the JAX DLRM's probabilities (atol 1e-5);
* the kernel lab's probes agree with their plain versions (the lab raises
  where one does not), and ``drophot`` prints the lines
  ``tests/test_tools.py`` reads from the JAX lab;
* every tool without ``--device`` fails here with ``resolve_device``'s
  message, and a pinned kernel path refuses what the kernel cannot serve.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu.models import DLRM as JDLRM
from pim_embedding_lookup_tpu.models import dlrm as jdlrm
from pim_embedding_lookup_tpu.models import sparse_train as jst
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.parallel.hybrid import HybridEmbeddingCollection as JHybrid
from pim_embedding_lookup_tpu.parallel.quantized_collection import (
    QuantizedEmbeddingCollection as JQuant,
)
from pim_embedding_lookup_tpu_torch import params_from_jax, quantized_params_from_jax
from pim_embedding_lookup_tpu_torch.ops.csr_pool import embedding_bag_csr_packed
from pim_embedding_lookup_tpu_torch.ops.gather_pool import embedding_bag_fixedl
from pim_embedding_lookup_tpu_torch.parallel.hybrid import HybridEmbeddingCollection as THybrid
from pim_embedding_lookup_tpu_torch.parallel.quantized_collection import (
    QuantizedEmbeddingCollection as TQuant,
)
from pim_embedding_lookup_tpu_torch.tools import (
    build_times,
    capacity_bench,
    common,
    kernel_lab,
    phase_bench,
    routed_gather_audit,
    scaling_bench,
    serving_bench,
    trace_capture,
    train_bench,
)
from pim_embedding_lookup_tpu_torch.utils.profiling import PhaseTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = dict(rtol=1e-5, atol=0)
BF16_TOL = dict(rtol=2 ** -7, atol=1e-6)
MIXED_ROWS = (3, 24, 583, 1460, 9000, 20000)  # 4 small tables, 2 big
# (JAX script, port module, arguments): those of tests/test_tools.py
JAX_RUNS = {
    "train_bench": ("tools/train_bench.py", train_bench,
                    ["--config", "toy", "--batch", "16", "--iters", "2"]),
    "serving_bench": ("tools/serving_bench.py", serving_bench,
                      ["--config", "toy", "--batch", "16", "--qps", "50", "--duration", "2"]),
    "phase_bench": ("tools/phase_bench.py", phase_bench,
                    ["--config", "toy", "--batch", "32", "--iters", "2"]),
    "capacity_bench": ("tools/capacity_bench.py", capacity_bench,
                       ["--tables", "2", "--rows", "5000", "--dim", "16", "--batch", "64",
                        "--iters", "2"]),
}


def run_jax_tool(script, args):
    """The JAX tool in its own process on one CPU device, as
    tests/test_tools.py runs it; returns the process."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=1")
    code = ("import jax; jax.config.update('jax_platforms','cpu');"
            f"import sys; sys.argv=['{script}']+{list(args)!r};"
            f"exec(open('{script}').read())")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)


@pytest.fixture(scope="module")
def jax_lines():
    """Each JAX tool's JSON line, the tools run all at once."""
    procs = {name: run_jax_tool(script, args) for name, (script, _, args) in JAX_RUNS.items()}
    lines = {}
    for name, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, f"{name}: {err[-2000:]}"
        lines[name] = json.loads(out.strip().splitlines()[-1])
    return lines


@pytest.mark.parametrize("name", sorted(JAX_RUNS))
def test_tool_json_keys_match_jax(jax_lines, name, capsys):
    _, tool, args = JAX_RUNS[name]
    tool.main(args + ["--device", "cpu"])
    mine = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = set(jax_lines[name])
    assert want <= set(mine), want - set(mine)
    assert all(k.startswith("device_") for k in set(mine) - want), set(mine) - want


# -- train_bench ---------------------------------------------------------------------


def _mixed(mod):
    tables = tuple(mod.TableConfig(num_rows=n, dim=16, name=f"t{i}")
                   for i, n in enumerate(MIXED_ROWS))
    return mod.DLRMConfig(dense_dim=13, mlp_bot=(32, 16), mlp_top=(32, 1), tables=tables)


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(jcfg.MeshConfig(data=1, model=1))


def _models(jmesh, seed=0, packed=True):
    """The JAX and the port's mixed hybrid DLRM on the same params;
    ``packed=False`` stores the big set [rows, dim], as the JAX tool's
    ``--no-packed`` does and train_bench's ``build_model``."""
    jmodel = JDLRM(_mixed(jcfg), jmesh, jcfg.ShardingPolicy.REPLICATE, hybrid=True)
    if not packed:
        jmodel.collection = JHybrid.create(_mixed(jcfg).tables, jmesh,
                                           jcfg.ShardingPolicy.REPLICATE, packed=False)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = train_bench.build_model(_mixed(tcfg), hybrid=True, packed=packed,
                                     policy=tcfg.ShardingPolicy.REPLICATE, device="cpu",
                                     mesh=None)
    params_from_jax(jax.tree.map(np.asarray, params), tmodel)
    return jmodel, params, tmodel


def _jax_step(jmodel, dense_opt, lr, optimizer, wire):
    """The JAX tool's step body: the lookup, the dense tower's gradient,
    the optax update, and the sparse update of ``wire``."""
    coll = jmodel.collection

    @jax.jit
    def step(emb, acc, dp, os_, dense, idx, second, labels):
        pooled = (coll.lookup(emb, idx, second, batch_size=dense.shape[0]) if wire == "dense"
                  else coll.lookup_csr(emb, idx, second))

        def loss_fn(dp_, pooled_):
            logits = jmodel.apply_from_pooled({**dp_, "emb": None}, dense, pooled_)
            return jdlrm.bce_loss(logits, labels)

        loss, (g_dense, g_pooled) = jax.value_and_grad(loss_fn, argnums=(0, 1))(dp, pooled)
        updates, os_ = dense_opt.update(g_dense, os_, dp)
        dp = optax.apply_updates(dp, updates)
        update = jst._apply_sparse if wire == "dense" else jst._apply_sparse_csr
        emb, acc = update(coll, emb, acc, idx, second, g_pooled, lr=lr, optimizer=optimizer,
                          eps=1e-8)
        return emb, acc, dp, os_, loss

    return step


@pytest.mark.parametrize("wire", ["dense", "csr"])
@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
def test_train_bench_losses_match_jax(jmesh, wire, optimizer):
    """4 rotated steps of train_bench's loop (the mixed hybrid config,
    B=16, L=2) give the JAX sparse step's loss a step."""
    _train_bench_losses_match_jax(jmesh, wire, optimizer, packed=True)


@pytest.mark.parametrize("wire", ["dense", "csr"])
def test_train_bench_unpacked_losses_match_jax(jmesh, wire):
    """The same with the big set stored [rows, dim] on both sides
    (``--no-packed``: ``DLRM(..., packed=False)`` in the port)."""
    _train_bench_losses_match_jax(jmesh, wire, "row_adagrad", packed=False)


def _train_bench_losses_match_jax(jmesh, wire, optimizer, *, packed):
    b, pooling, lr, steps = 16, 2, 0.05, 4
    jmodel, params, tmodel = _models(jmesh, packed=packed)
    big = tmodel.collection.big.layout
    assert (big.pack > 1) == packed and tuple(tmodel.emb_big.shape) == (
        big.storage_rows, big.storage_width)
    cfg = _mixed(tcfg)
    dense, idx, labels = train_bench.make_inputs(cfg, b, pooling, np.random.default_rng(0))
    loop = train_bench.TrainLoop(tmodel, dense, idx, labels, pooling=pooling,
                                 optimizer=optimizer, lr=lr, wire=wire)
    got = [float(loop()) for _ in range(steps)]

    dense_opt, os_, acc = jst.make_sparse_train_state(jmodel, params, lr=lr)
    step = _jax_step(jmodel, dense_opt, lr, optimizer, wire)
    emb, dp = params["emb"], {k: params[k] for k in ("bot", "top")}
    t = len(cfg.tables)
    second = (jnp.ones(idx.shape, bool) if wire == "dense" else
              jnp.asarray(np.tile(np.arange(b + 1, dtype=np.int32) * pooling, (t, 1))))
    rows = np.asarray([tb.num_rows for tb in cfg.tables], np.int32)[:, None]
    stride = np.maximum(1, rows // 7 + 1)
    want, idx_i = [], idx
    for _ in range(steps):
        emb, acc, dp, os_, loss = step(emb, acc, dp, os_, jnp.asarray(dense),
                                       jnp.asarray(idx_i), second, jnp.asarray(labels))
        want.append(float(loss))
        idx_i = (idx_i + stride) % rows
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert loop.steps == steps and float(loop.loss_sum) == pytest.approx(sum(got), rel=1e-6)


# -- phase_bench -----------------------------------------------------------------------


def test_phase_bench_block_matches_jax(jmesh):
    """The block phase_bench fetches equals the JAX hybrid collection's
    lookup on the same bf16 params."""
    b, pooling = 32, 2
    jt, tt = _mixed(jcfg).tables, _mixed(tcfg).tables
    jc = JHybrid.create(jt, jmesh, jcfg.ShardingPolicy.REPLICATE)
    jp = jc.init(jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    tc = THybrid.create(tt, device="cpu")
    tp = {k: torch.from_numpy(np.asarray(v, dtype=np.float32)).to(torch.bfloat16)
          for k, v in jp.items()}
    rng = np.random.default_rng(0)
    idx = common.uniform_ids(rng, tt, b * pooling)
    mask = rng.random(idx.shape) < 0.8
    timer = PhaseTimer()
    got = phase_bench.run_phases(tc, tp, [(idx, mask)], batch=b, device=torch.device("cpu"),
                                 timer=timer)
    want = np.asarray(jc.lookup(jp, jnp.asarray(idx), jnp.asarray(mask), batch_size=b),
                      dtype=np.float32)
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert list(timer.report()) == ["feed", "dispatch", "compute", "fetch", "decode"]


# -- capacity_bench --------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["table", "row"])
def test_capacity_bench_sums_match_jax(jmesh, mode):
    """capacity_bench's three lookups (fixed-L SUM, CSR, MEAN) on the
    JAX int8 params, their plain versions (the bench's own check), and
    their sums over 3 rotated iterations, equal the JAX int8 collection's."""
    b, pooling, n = 64, 2, 3
    jt = tuple(jcfg.TableConfig(num_rows=5000, dim=16, name=f"cap_{i}") for i in range(2))
    tt = tuple(tcfg.TableConfig(num_rows=5000, dim=16, name=f"cap_{i}") for i in range(2))
    jc = JQuant.create(jt, jmesh, jcfg.ShardingPolicy.REPLICATE, scale_mode=mode)
    jp = jc.init(jax.random.PRNGKey(0))
    tc = TQuant.create(tt, tcfg.ShardingPolicy.REPLICATE, scale_mode=mode, device="cpu")
    tp = quantized_params_from_jax(tc, jax.tree.map(np.asarray, jp))
    t = len(tt)
    idx = common.uniform_ids(np.random.default_rng(0), tt, b * pooling)
    offsets = np.tile(np.arange(b + 1, dtype=np.int32) * pooling, (t, 1))
    mask = np.ones(idx.shape, bool)
    rows, stride = common.rotation(tt, "cpu")
    fns = capacity_bench.lookups(tc, tp, b, torch.from_numpy(offsets))
    jfns = {
        "fixed": lambda i: jc.lookup(jp, i, jnp.asarray(mask), batch_size=b),
        "csr": lambda i: jc.lookup_csr(jp, i, jnp.asarray(offsets)),
        "mean": lambda i: jc.lookup(jp, i, jnp.asarray(mask), batch_size=b, combiner="mean"),
    }
    tmask = torch.from_numpy(mask)
    plain, _ = capacity_bench.plain_lookups(tc, tp, torch.from_numpy(idx),
                                            torch.from_numpy(offsets), b, pooling)
    for name, fn in fns.items():
        for got in (fn(torch.from_numpy(idx), tmask), plain[name]):
            np.testing.assert_allclose(got.numpy(), np.asarray(jfns[name](jnp.asarray(idx))),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
        loop = common.RotatingLoop(lambda i, fn=fn: fn(i, tmask), torch.from_numpy(idx),
                                   rows, stride)
        want, idx_i = 0.0, idx
        for _ in range(n):
            loop()
            want += float(jnp.sum(jfns[name](jnp.asarray(idx_i))))
            idx_i = (idx_i + stride.numpy()) % rows.numpy()
        np.testing.assert_allclose(float(loop.acc), want, rtol=1e-5, atol=1e-5, err_msg=name)


# -- serving_bench ---------------------------------------------------------------------


@pytest.mark.parametrize("staged", [True, False])
def test_serving_dispatch_matches_jax(jmesh, staged):
    """Three requests in one dispatch, padded to the bucket of 8 by the
    last: each real request's probabilities are the JAX DLRM's on its own
    dense features plus the dispatch's salt."""
    b, pooling, salt = 4, 2, 5
    jmodel, params, tmodel = _models(jmesh, seed=2)
    cfg = _mixed(tcfg)
    rng = np.random.default_rng(3)
    reqs = [serving_bench.make_request(rng, cfg, b, pooling, 0.0) for _ in range(3)]
    server = serving_bench.Server(tmodel, tmodel.collection, tmodel.emb_params(),
                                  buckets=serving_bench.buckets_for(8),
                                  device=torch.device("cpu"))
    server.dispatches = salt
    payloads = [tuple(torch.from_numpy(a) for a in r) for r in reqs]
    items = [(0.0, server.stage(p) if staged else r) for p, r in zip(payloads, reqs)]
    out = server.dispatch(items, staged=staged)
    assert out.shape == (8 * b,) and server.padded == 5
    mask = jnp.ones((len(cfg.tables), b * pooling), bool)
    for k, (dense, idx) in enumerate(reqs):
        pooled = jmodel.collection.lookup(params["emb"], jnp.asarray(idx), mask, batch_size=b)
        logits = jmodel.apply_from_pooled(params, jnp.asarray(dense)
                                          + (jnp.float32(salt) % 977.0) * 1e-7, pooled)
        np.testing.assert_allclose(out[k * b:(k + 1) * b].numpy(),
                                   np.asarray(jax.nn.sigmoid(logits)), rtol=0, atol=1e-5)
    server.drain(block=True)
    assert server.requests == 3 and not server.inflight


def test_serving_bench_microbatch_aggregates(capsys):
    rep = serving_bench.main(["--config", "toy", "--batch", "8", "--qps", "500",
                              "--duration", "1", "--microbatch", "4", "--inflight", "2",
                              "--max-wait-ms", "5", "--device", "cpu"])
    assert json.loads(json.dumps(rep)) == json.loads(
        capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["microbatch"] == 4 and rep["requests"] > 0
    assert rep["dispatches"] < rep["requests"]
    assert 0 < rep["p50_ms"] <= rep["p95_ms"] <= rep["p99_ms"]


# -- kernel_lab, trace_capture -------------------------------------------------------


def test_kernel_lab_drophot_lines(capsys):
    kernel_lab.main(["--rows", "4096", "--dim", "16", "--batch", "32", "--tables", "2",
                     "--iters", "2", "--only", "drophot", "--device", "cpu"])
    err = capsys.readouterr().err
    for line in ("scatter dropfrac=0.9", "scatter zipf-ids", "gather hotfrac=0.5"):
        assert line in err


def test_kernel_lab_every_probe_checks():
    """Every probe runs, and each one that pools or gathers is checked
    against its plain version (a mismatch raises in the lab)."""
    res = kernel_lab.main(["--rows", "4096", "--dim", "16", "--batch", "32", "--tables",
                           "2", "--pooling", "2", "--iters", "1", "--chain", "1", "--reps",
                           "1", "--device", "cpu"])
    names = " ".join(res)
    for probe in ("take", "csrseg", "csrnarrow", "dedup", "sort+take", "pallas", "chain",
                  "packed", "sdk", "scatter", "gather hotfrac", "wide", "dwide", "onehot",
                  "hotcache"):
        assert probe in names, probe
    checked = [k for k, v in res.items() if v["max_abs_err"] is not None]
    assert {"pallas K4 fwd (embedding_bag_csr_sum)", "chain K1 path=auto",
            "csrnarrow K2 packed", "scatter K4 bwd (csr_grad_kernel)"} <= set(checked)
    assert all(v["max_abs_err"] < 1e-4 for k, v in res.items() if k in checked)


def test_trace_capture_writes_one_interval_per_iteration(tmp_path):
    out = tmp_path / "trace"
    res = trace_capture.main(["--config", "toy", "--batch", "16", "--iters", "3",
                              "--out", str(out), "--device", "cpu"])
    lines = (out / "intervals.csv").read_text().strip().splitlines()
    assert lines[0] == "rank_id,label,start_ms,end_ms" and len(lines) == 4
    assert res["rows"] == 3 and (out / "perfetto_trace.json.gz").stat().st_size > 0


# -- the device, and pinned kernel paths --------------------------------------------


TOOLS = [train_bench, serving_bench, phase_bench, capacity_bench, trace_capture, kernel_lab,
         scaling_bench, routed_gather_audit]


@pytest.mark.parametrize("tool", TOOLS, ids=lambda t: t.__name__.rsplit(".", 1)[-1])
def test_tool_without_device_fails_without_a_card(tool, tmp_path):
    """No card here: every tool refuses to run rather than fall back."""
    args = ["--out", str(tmp_path)] if tool is trace_capture else []
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(args)


def test_build_times_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build-time tool raises, as the kernels' build does;
    it never times anything else."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build_times.main(["--csrc", str(tmp_path)])


def test_build_times_counts_kernel_instances():
    line = "ptxas info    : Compiling entry function '_Z1kILi{}EEvv' for 'sm_90a'\n"
    log = "".join(line.format(i) + "ptxas info    : Used 40 registers\n" for i in range(3))
    assert build_times.instances(log) == 3 and build_times.instances("") == 0


def test_tool_process_without_device_exits_nonzero():
    r = subprocess.run([sys.executable, "-m", "pim_embedding_lookup_tpu_torch.tools.train_bench",
                        "--config", "toy"], capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_pinned_kernel_path_refused():
    """A pinned path never falls back to the plain version: on the CPU it
    raises, as does a group the kernels cannot serve."""
    storage = torch.zeros(64, 16)
    ids = torch.zeros(8, dtype=torch.int32)
    off = torch.arange(9, dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        embedding_bag_fixedl(storage, 16, ids, pooling=1, batch_size=8, path=(16, 3, False))
    with pytest.raises(ValueError, match="only the card"):
        embedding_bag_fixedl(storage, 16, ids, pooling=2, batch_size=4, path=(16, 4, False))
    with pytest.raises(ValueError, match="by-group"):
        embedding_bag_fixedl(storage, 16, ids, pooling=1, batch_size=8, path=(0, 4, True))
    with pytest.raises(ValueError, match="only the card"):
        embedding_bag_csr_packed(storage, 16, ids, off, batch_size=8, path=(0, 16, True))
    assert kernel_lab.sweep_paths(storage, 16, 8, 8, kernel_lab.parse_args([])) == [None]
