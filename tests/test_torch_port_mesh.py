"""The port's sharded engine on a gloo cluster against the JAX package on
conftest's 8 CPU devices, on a (data=1, model=4) mesh here and a (data=2,
model=2) one in ``test_torch_port_mesh_2x2.py``, which takes its cases from
this file (two files, so that test workers run the two meshes side by side).

A module-scoped fixture starts one cluster of 4 CPU processes
(``python -m pim_embedding_lookup_tpu_torch.mesh_battery``, gloo over a
file store in a temporary directory, one thread each, no JAX in the
workers).  Every rank runs the whole battery once on inputs made from a
seed (an ``.npz``) and writes its results, gathered to the global batch and
the global tables.  Here each case is one test: the same case computed by
the JAX package from the same arrays, and every rank's results equal to
rank 0's (the replicas agree bitwise).

Tolerances: the sum over shards changes the order of f32 additions, so
lookups, gradients and one train step compare at rtol 1e-5 / atol 1e-6, and
three train steps at rtol 1e-4 (atol 1e-6 for values near 0).  The hybrid
small set's gradient passes through bf16 on both sides (the forward casts
weights and one-hot to bf16), rounded once by JAX and twice by torch, so it
compares within 2**-6 of its largest value, as the one-device step does in
``test_torch_port_train.py``.  Drop counts and the hot cache's ids compare
exactly, and refused calls raise the JAX package's errors.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import pim_embedding_lookup_tpu.config as jcfg
from pim_embedding_lookup_tpu.models import DLRM as JDLRM
from pim_embedding_lookup_tpu.models import sparse_train as jst
from pim_embedding_lookup_tpu.models import train as jtrain
from pim_embedding_lookup_tpu.parallel import hotcache as jhot
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.parallel import sparse_update as jsu
from pim_embedding_lookup_tpu.parallel.collection import EmbeddingCollection as JColl
from pim_embedding_lookup_tpu.parallel.hybrid import HybridEmbeddingCollection as JHybrid
from pim_embedding_lookup_tpu_torch import mesh_battery as mb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0
MESH = (1, 4)  # (data, model)
TOL = dict(rtol=1e-5, atol=1e-6)
TRACE_TOL = dict(rtol=1e-4, atol=1e-6)


def _run_cluster(tmp, data, model, timeout=300, group="main", module="mesh_battery",
                 inp=None):
    """The battery's case ``group`` on ``data * model`` gloo processes;
    returns the inputs and each rank's results.  ``module``: another
    battery of the port with the same arguments but no case group (None),
    run on ``inp``."""
    world = data * model
    inp = mb.make_inputs(SEED, data) if inp is None else inp
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", f"pim_embedding_lookup_tpu_torch.{module}", str(r),
             str(world), str(data), str(model), str(tmp / "store"), str(tmp / "inputs.npz"),
             str(tmp), "cpu"] + ([group] if group else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
        for r in range(world)
    ]
    # liveness guard: a dead worker leaves its peers waiting in a collective
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        if any(c not in (None, 0) for c in codes):
            time.sleep(2)
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    outs = [p.communicate(timeout=30) for p in procs]
    failed = [(r, p.returncode, err) for r, (p, (_, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n\n".join(f"rank {r} rc={rc}\n{err[-4000:]}" for r, rc, err in failed)
    return inp, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


def start_cluster(tmp_path_factory, data, model, group="main"):
    """The battery's results on a (data, model) gloo cluster, and the JAX
    mesh of the same shape."""
    inp, ranks = _run_cluster(tmp_path_factory.mktemp(f"mesh{data}x{model}"), data, model,
                              group=group)
    return make_mesh(jcfg.MeshConfig(data=data, model=model)), inp, ranks


# -- the JAX side of each case ---------------------------------------------------


def _j(x):
    return jnp.asarray(x)


def _coll(jm, inp, policy):
    jc = JColl.create(mb.tables(jcfg, mb.ROWS), jm, jcfg.ShardingPolicy(policy),
                      packed="auto")
    return jc, jc.device_put_tables(mb.host_tables(inp, "table", mb.ROWS))


def _lookup(jm, inp, policy, comb):
    jc, f = _coll(jm, inp, policy)
    return {"out": jc.lookup(f, _j(inp["idx"]), _j(inp["mask"]), batch_size=mb.BATCH,
                             combiner=comb)}


def _csr(jm, inp, policy, comb):
    jc, f = _coll(jm, inp, policy)
    return {"out": jc.lookup_csr(f, _j(inp["cidx"]), _j(inp["coff"]), combiner=comb)}


def _csr_ds(jm, inp, policy, comb):
    jc, f = _coll(jm, inp, policy)
    return {"out": jc.lookup_csr(f, _j(inp["widx"]), _j(inp["woff"]), combiner=comb,
                                 data_sharded=True)}


def _routed(jm, inp, policy, comb, cf=None):
    jc, f = _coll(jm, inp, policy)
    out, dropped = jc.lookup_routed(f, _j(inp["zidx"]), _j(inp["zmask"]), batch_size=mb.BATCH,
                                    capacity_factor=cf, return_stats=True, combiner=comb)
    return {"out": out, "dropped": dropped}


def _csr_routed(jm, inp, policy, comb, ds=False, cf=None):
    jc, f = _coll(jm, inp, policy)
    q = (inp["widx"], inp["woff"]) if ds else (inp["cidx"], inp["coff"])
    out, dropped = jc.lookup_csr(f, *map(_j, q), combiner=comb, data_sharded=ds, routed=True,
                                 capacity_factor=cf, return_stats=True)
    return {"out": out, "dropped": dropped}


def _hot(jm, inp, policy):
    jc, f = _coll(jm, inp, policy)
    ids, rows = jhot.build_hot_cache(jc, f, jhot.hot_ids_from_sample(jc, inp["zidx"], mb.HOT_K))
    out, dropped = jc.lookup_routed(f, _j(inp["zidx"]), _j(inp["zmask"]), batch_size=mb.BATCH,
                                    hot_cache=(ids, rows), return_stats=True,
                                    capacity_factor=1.0)
    return {"hot_ids": ids, "hot_rows": rows, "out": out, "dropped": dropped}


def _update(jm, inp, policy, opt, routed=False, cf=None, zipf=False):
    jc, f = _coll(jm, inp, policy)
    key = "z" if zipf else ""
    f, acc, dropped = jsu.sparse_update(
        jc, f, jsu.init_accumulator(jc), _j(inp[key + "idx"]), _j(inp[key + "mask"]),
        _j(inp["g"]), lr=0.1, optimizer=opt, routed=routed, capacity_factor=cf,
        return_stats=True)
    return {"table": f, "acc": acc, "dropped": dropped}


def _update_csr(jm, inp, policy, ds=False, routed=False):
    jc, f = _coll(jm, inp, policy)
    q = (inp["widx"], inp["woff"]) if ds else (inp["cidx"], inp["coff"])
    f, acc, dropped = jsu.sparse_update_csr(
        jc, f, jsu.init_accumulator(jc), *map(_j, q), _j(inp["g"]), lr=0.1,
        optimizer="row_adagrad", routed=routed, data_sharded=ds, return_stats=True)
    return {"table": f, "acc": acc, "dropped": dropped}


def _hybrid_lookups(jm, inp):
    jh = JHybrid.create(mb.tables(jcfg, mb.MIXED_ROWS), jm, jcfg.ShardingPolicy.ROW_HASH)
    params = jh.device_put_tables(mb.host_tables(inp, "mtable", mb.MIXED_ROWS))
    q = _j(inp["midx0"]), _j(inp["mmask0"])
    pooled, dropped = jh.lookup(params, *q, batch_size=mb.BATCH, combiner="mean",
                                routed=True, return_stats=True)
    return {"broadcast": jh.lookup(params, *q, batch_size=mb.BATCH),
            "routed_mean": pooled, "routed_dropped": dropped}


def _model(jm, inp, policy, hybrid=True):
    model = JDLRM(mb.mixed_config(jcfg), jm, jcfg.ShardingPolicy(policy), hybrid=hybrid)
    mlp = {k: [{n: _j(a) for n, a in layer.items()} for layer in v]
           for k, v in mb.mlp_params(inp).items()}
    emb = model.collection.device_put_tables(mb.host_tables(inp, "mtable", mb.MIXED_ROWS))
    return model, {"emb": emb, **mlp}


def _dense_state(params):
    out = {"emb": params["emb"]}
    for name in ("bot", "top"):
        for j, layer in enumerate(params[name]):
            out[f"{name}{j}_w"], out[f"{name}{j}_b"] = layer["w"], layer["b"]
    return out


def _train_autodiff(jm, inp, policy, kind, steps):
    model, params = _model(jm, inp, policy, hybrid=False)
    opt = jtrain.make_optimizer(mb.LR, kind)
    step = jtrain.make_train_step(model, opt)
    state, losses = opt.init(params), []
    for s in range(steps):
        batch = [_j(inp[f"{k}{s}"]) for k in ("mdense", "midx", "mmask", "mlabels")]
        params, state, loss, _ = step(params, state, *batch)
        losses.append(float(loss))
    return {"losses": np.asarray(losses, np.float32), **_dense_state(params)}


def _fit(jm, inp, policy):
    model, params = _model(jm, inp, policy, hybrid=False)
    batch = [tuple(inp[f"{k}{s}"] for k in ("mdense", "midx", "mmask", "mlabels"))
             for s in range(3)]
    params, reports = jtrain.fit(model, params, iter(batch[:2]), lr=mb.LR, test_freq=1,
                                 test_batches=batch[2:])
    rows = [[r.step, r.loss, r.accuracy, r.auc] for r in reports]
    return {"reports": np.asarray(rows, np.float64), **_dense_state(params)}


def _grad(fn, storage, w):
    return jax.grad(lambda f: jnp.sum(fn(f) * w))(storage)


def _grad_lookup(jm, inp, policy, comb):
    jc, f = _coll(jm, inp, policy)
    return {"grad": _grad(lambda f: jc.lookup(f, _j(inp["idx"]), _j(inp["mask"]),
                                              batch_size=mb.BATCH, combiner=comb),
                          f, _j(inp["g"]))}


def _grad_csr(jm, inp, policy, comb, ds=False, routed=False):
    jc, f = _coll(jm, inp, policy)
    q = (inp["widx"], inp["woff"]) if ds else (inp["cidx"], inp["coff"])
    return {"grad": _grad(lambda f: jc.lookup_csr(f, *map(_j, q), combiner=comb,
                                                  data_sharded=ds, routed=routed),
                          f, _j(inp["g"]))}


def _grad_routed(jm, inp, policy):
    jc, f = _coll(jm, inp, policy)
    return {"grad": _grad(lambda f: jc.lookup_routed(f, _j(inp["zidx"]), _j(inp["zmask"]),
                                                     batch_size=mb.BATCH),
                          f, _j(inp["g"]))}


def _grad_hot(jm, inp, policy):
    jc, f = _coll(jm, inp, policy)
    ids, rows = jhot.build_hot_cache(jc, f, jhot.hot_ids_from_sample(jc, inp["zidx"], mb.HOT_K))

    def loss(f, hot):
        out = jc.lookup_routed(f, _j(inp["zidx"]), _j(inp["zmask"]), batch_size=mb.BATCH,
                               hot_cache=(ids, hot), capacity_factor=1.0)
        return jnp.sum(out * _j(inp["g"]))

    grad, hot_grad = jax.grad(loss, argnums=(0, 1))(f, rows)
    return {"grad": grad, "hot_grad": hot_grad}


def _grad_hybrid(jm, inp):
    jh = JHybrid.create(mb.tables(jcfg, mb.MIXED_ROWS), jm, jcfg.ShardingPolicy.ROW)
    params = jh.device_put_tables(mb.host_tables(inp, "mtable", mb.MIXED_ROWS))
    return _grad(lambda p: jh.lookup(p, _j(inp["midx0"]), _j(inp["mmask0"]),
                                     batch_size=mb.BATCH), params, _j(inp["mg"]))


def _train(jm, inp, policy, opt, steps, routed=False, hot=False):
    model, params = _model(jm, inp, policy)
    dense_opt, opt_state, acc = jst.make_sparse_train_state(model, params, optimizer=opt,
                                                            lr=mb.LR)
    step = jst.make_sparse_train_step(model, dense_opt, lr=mb.LR, optimizer=opt,
                                      routed=routed, hot_cache=hot)
    emb, dp = params["emb"], {k: params[k] for k in ("bot", "top")}
    big = model.collection.big
    if hot:
        sel = list(model.collection.big_ids)
        sample = np.concatenate([inp[f"midx{s}"][sel] for s in range(steps)], axis=1)
        hot_ids = jhot.hot_ids_from_sample(big, sample, mb.HOT_K)
    losses = []
    for s in range(steps):
        hc = jhot.build_hot_cache(big, emb["big"], hot_ids) if hot else ()
        batch = [_j(inp[f"{k}{s}"]) for k in ("mdense", "midx", "mmask", "mlabels")]
        emb, acc, dp, opt_state, loss = step(emb, acc, dp, opt_state, *batch, *hc)
        losses.append(float(loss))
    out = {"losses": np.asarray(losses, np.float32)}
    for key in ("small", "big"):
        out[f"emb_{key}"], out[f"acc_{key}"] = emb[key], acc[key]
    for name in ("bot", "top"):
        for j, layer in enumerate(dp[name]):
            out[f"{name}{j}_w"], out[f"{name}{j}_b"] = layer["w"], layer["b"]
    return out


def _error_text(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 -- the error is the result
        return f"{type(e).__name__}: {e}"
    raise AssertionError("nothing raised")


def _guard(jm, inp, which):
    jc, f = _coll(jm, inp, {"routed_column": "column", "csr_update_column": "column",
                            "routed_update_replicate": "replicate"}.get(which, "row_hash"))
    q = _j(inp["idx"]), _j(inp["mask"])
    b = mb.BATCH

    def step_without_cache():
        model, params = _model(jm, inp, "row_hash")
        opt, state, acc = jst.make_sparse_train_state(model, params, lr=mb.LR)
        step = jst.make_sparse_train_step(model, opt, lr=mb.LR, routed=True, hot_cache=True)
        step(params["emb"], acc, {k: params[k] for k in ("bot", "top")}, state,
             *[_j(inp[f"{k}0"]) for k in ("mdense", "midx", "mmask", "mlabels")])

    calls = {
        "routed_column": lambda: jc.lookup_routed(f, *q, batch_size=b),
        "routed_max": lambda: jc.lookup_routed(f, *q, batch_size=b, combiner="max"),
        "stats_unrouted": lambda: jc.lookup_csr(f, _j(inp["cidx"]), _j(inp["coff"]),
                                                return_stats=True),
        "routed_update_replicate": lambda: jsu.sparse_update(
            jc, f, jsu.init_accumulator(jc), *q, _j(inp["g"]), lr=0.1, routed=True),
        "csr_update_column": lambda: jsu.sparse_update_csr(
            jc, f, jsu.init_accumulator(jc), _j(inp["cidx"]), _j(inp["coff"]), _j(inp["g"]),
            lr=0.1),
        "hot_unrouted": lambda: jst.make_sparse_train_step(
            _model(jm, inp, "row_hash")[0], None, hot_cache=True),
        "step_args": step_without_cache,
        "grad_rowshard_max": lambda: _grad(lambda f: jc.lookup(
            f, *q, batch_size=b, combiner="max"), f, 1.0),
    }
    return calls[which]


def _expected(name, jm, inp):
    kind, *rest = name.split("-")
    if kind == "lookup":
        return _lookup(jm, inp, *rest)
    if kind == "csr":
        return _csr(jm, inp, *rest)
    if kind == "csr_ds":
        return _csr_ds(jm, inp, *rest)
    if kind == "routed":
        return _routed(jm, inp, *rest)
    if kind == "routed_lowcf":
        return _routed(jm, inp, rest[0], "sum", cf=1.0)
    if kind == "csr_routed":
        return _csr_routed(jm, inp, *rest)
    if kind == "csr_routed_ds":
        return _csr_routed(jm, inp, rest[0], "sum", ds=True, cf=1.0)
    if kind == "hot":
        return _hot(jm, inp, rest[0])
    if kind == "update":
        return _update(jm, inp, *rest)
    if kind == "update_routed":
        return _update(jm, inp, rest[0], "row_adagrad", routed=True, zipf=True)
    if kind == "update_routed_lowcf":
        return _update(jm, inp, rest[0], "sgd", routed=True, cf=1.0, zipf=True)
    if kind == "update_csr":
        return _update_csr(jm, inp, rest[0])
    if kind == "update_csr_ds":
        return _update_csr(jm, inp, rest[0], ds=True)
    if kind == "update_csr_routed_ds":
        return _update_csr(jm, inp, rest[0], ds=True, routed=True)
    if kind == "hybrid_lookups":
        return _hybrid_lookups(jm, inp)
    if kind == "train":
        return _train(jm, inp, rest[0], "sgd", 1)
    if kind == "train_routed_trace":
        return _train(jm, inp, "row_hash", "row_adagrad", mb.TRAIN_STEPS, routed=True)
    if kind == "train_hot":
        return _train(jm, inp, "row_hash", "row_adagrad", mb.TRAIN_STEPS, routed=True,
                       hot=True)
    if kind == "grad":
        return _grad_lookup(jm, inp, *rest)
    if kind == "grad_csr":
        return _grad_csr(jm, inp, *rest)
    if kind == "grad_csr_ds":
        return _grad_csr(jm, inp, *rest, ds=True)
    if kind == "grad_routed":
        return _grad_routed(jm, inp, rest[0])
    if kind == "grad_hot":
        return _grad_hot(jm, inp, rest[0])
    if kind == "grad_csr_routed_ds":
        return _grad_csr(jm, inp, rest[0], "sum", ds=True, routed=True)
    if kind == "grad_hybrid":
        return _grad_hybrid(jm, inp)
    if kind == "train_autodiff":
        return _train_autodiff(jm, inp, rest[0], "sgd", 1)
    if kind == "train_autodiff_trace":
        return _train_autodiff(jm, inp, "row_hash", "adagrad", mb.TRAIN_STEPS)
    if kind == "fit":
        return _fit(jm, inp, rest[0])
    raise KeyError(name)


def check_case(cluster, case, expected=None):
    """One battery case: every rank agrees bitwise, and rank 0 matches the
    JAX package (or raises its error); ``expected(case, jm, inp)`` computes
    the JAX side (default: this file's)."""
    jm, inp, ranks = cluster
    got = {k[len(case) + 1:]: v for k, v in ranks[0].items() if k.startswith(case + "/")}
    assert "error" not in got, bytes(got["error"]).decode()
    for r, other in enumerate(ranks[1:], 1):  # replicas and model peers agree bitwise
        for key, val in got.items():
            np.testing.assert_array_equal(other[f"{case}/{key}"], val, err_msg=f"rank {r} {key}")
    if case.startswith("guard-"):
        text = bytes(got["error_text"]).decode()
        assert text == _error_text(_guard(jm, inp, case.split("-", 1)[1]))
        return
    want = {k: np.asarray(v) for k, v in (expected or _expected)(case, jm, inp).items()}
    assert set(got) == set(want)
    tol = TRACE_TOL if case in mb.TRACE_CASES else TOL
    for key, val in want.items():
        if key.endswith("dropped") or key == "hot_ids":
            np.testing.assert_array_equal(got[key], val, err_msg=key)
        elif (case, key) in mb.BF16_RESULTS:  # module docstring
            assert np.abs(val).max() > 0
            np.testing.assert_allclose(got[key], val, rtol=0,
                                       atol=2.0 ** -6 * np.abs(val).max(), err_msg=key)
        else:
            np.testing.assert_allclose(got[key], val, **tol, err_msg=key)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    return start_cluster(tmp_path_factory, *MESH)


@pytest.mark.parametrize("case", mb.case_names())
def test_mesh_case_matches_jax(cluster, case):
    check_case(cluster, case)
