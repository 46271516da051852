"""The port's training path against the JAX package's on the CPU: the
gradients of the big-set lookups (``lookup`` and ``lookup_csr``) against
``jax.grad``, the sparse train step on both wires (loss trace and final
parameters over 5 steps), the dense-autodiff step and ``fit``, optax's
SGD and AdaGrad rules, the metrics, and the accumulator converter.

Tolerances: one lookup gradient, rtol 1e-5 / atol 1e-6 (f32 sums in another
order).  Over several steps the f32 differences of the MLPs (matmuls
summed in another order) grow with each update, so traces and final
parameters compare at rtol 1e-4 / atol 1e-5.  The dense-autodiff step's
small-set table gradient passes through bf16 on both sides (the forward
casts weights and one-hot to bf16), rounded once by JAX (f32 sums, then
bf16) and twice by torch (bf16 cotangent, then bf16 sums).  So on the
hybrid model that step compares at bf16 level: two rounding units (rtol
2**-7, atol 1e-5) for losses, logits and params, and the small table's
update within 2**-6 of the largest update."""

import subprocess
import sys
from pathlib import Path

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
from pim_embedding_lookup_tpu.models import train as jtrain
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.parallel.collection import EmbeddingCollection as JColl
from pim_embedding_lookup_tpu_torch import params_from_jax, train_state_from_jax
from pim_embedding_lookup_tpu_torch.models import DLRM as TDLRM
from pim_embedding_lookup_tpu_torch.models import bce_loss as tbce
from pim_embedding_lookup_tpu_torch.models import sparse_train as tst
from pim_embedding_lookup_tpu_torch.models import train as ttrain
from pim_embedding_lookup_tpu_torch.ops.ragged import pack_bags
from pim_embedding_lookup_tpu_torch.parallel.collection import EmbeddingCollection as TColl
from pim_embedding_lookup_tpu_torch.parallel.hybrid import HybridEmbeddingCollection as THybrid

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
TRACE_TOL = dict(rtol=1e-4, atol=1e-5)
ROWS = (50, 300, 17)
MIXED_ROWS = (3, 24, 583, 1460, 9000, 20000)  # 4 small tables, 2 big
POISON = 1 << 30


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jcfg.MeshConfig(data=1, model=1))


def _tables(mod, rows, dim=16):
    return tuple(mod.TableConfig(num_rows=n, dim=dim, name=f"t{i}")
                 for i, n in enumerate(rows))


def _mixed(mod):
    return mod.DLRMConfig(dense_dim=13, mlp_bot=(32, 16), mlp_top=(32, 1),
                          tables=_tables(mod, MIXED_ROWS))


def _models(mesh, cfg_fn, hybrid, seed=0):
    """The JAX model and its params, and the port's model holding the same
    params."""
    jmodel = JDLRM(cfg_fn(jcfg), mesh, jcfg.ShardingPolicy.REPLICATE, hybrid=hybrid)
    params = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = TDLRM(cfg_fn(tcfg), tcfg.ShardingPolicy.REPLICATE, hybrid=hybrid,
                   device="cpu", generator=torch.Generator())
    params_from_jax(jax.tree.map(np.asarray, params), tmodel)
    return jmodel, params, tmodel


def _dense_batch(rng, rows, b, l=1, keep=0.8):
    dense = rng.random((b, 13), dtype=np.float32)
    idx = np.stack([rng.integers(0, n, size=b * l) for n in rows]).astype(np.int32)
    mask = rng.random(idx.shape) < keep  # masked ids stay valid: JAX's lookup reads them
    labels = (rng.random(b) < 0.5).astype(np.float32)
    return dense, idx, mask, labels


def _csr_batch(rng, rows, b, max_len=4):
    """Ragged bags with empty ones; padding after offsets[B] poisoned."""
    dense = rng.random((b, 13), dtype=np.float32)
    bags_all = [[rng.integers(0, n, size=rng.integers(0, max_len)).tolist()
                 for _ in range(b)] for n in rows]
    cap = max(sum(map(len, bags)) for bags in bags_all) + 3
    idxs, offs = [], []
    for bags in bags_all:
        idx, off = pack_bags(bags, capacity=cap)
        idx[off[-1]:] = POISON
        idxs.append(idx)
        offs.append(off)
    labels = (rng.random(b) < 0.5).astype(np.float32)
    return dense, np.stack(idxs), np.stack(offs), labels


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_params(tmodel, jparams, tol=TRACE_TOL, small_tol=None):
    emb = jparams["emb"]
    if tmodel.hybrid:
        for key in ("small", "big"):
            np.testing.assert_allclose(getattr(tmodel, f"emb_{key}").detach().numpy(),
                                       np.asarray(emb[key]),
                                       **(small_tol if small_tol and key == "small" else tol))
    else:
        np.testing.assert_allclose(tmodel.emb.detach().numpy(), np.asarray(emb), **tol)
    for name in ("bot", "top"):
        for lin, p in zip(getattr(tmodel, name), jparams[name]):
            np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(p["w"]).T,
                                       **tol)
            np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(p["b"]), **tol)


# -- gradients of the big-set lookups -------------------------------------------


@pytest.mark.parametrize("wire", ["dense", "csr"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_lookup_grad_matches_jax(rng, mesh, wire, packed, combiner):
    """d(sum(pooled * w))/d(storage) through the port's lookup (the K1 or
    K2 autograd function) equals jax.grad through the JAX lookup."""
    b = 8
    host = [rng.standard_normal((n, 16)).astype(np.float32) for n in ROWS]
    jc = JColl.create(_tables(jcfg, ROWS), mesh, jcfg.ShardingPolicy.REPLICATE,
                      packed=packed)
    tc = TColl.create(_tables(tcfg, ROWS), tcfg.ShardingPolicy.REPLICATE,
                      packed=packed, device="cpu")
    if wire == "dense":
        _, idx, mask, _ = _dense_batch(rng, ROWS, b, l=3, keep=0.7)
        q = (idx, mask)
        jlook = lambda f: jc.lookup(f, *_j(*q), batch_size=b, combiner=combiner)  # noqa: E731
        tlook = lambda f: tc.lookup(f, *_t(*q), batch_size=b, combiner=combiner)  # noqa: E731
    else:
        _, idx, off, _ = _csr_batch(rng, ROWS, b)
        q = (idx, off)
        jlook = lambda f: jc.lookup_csr(f, *_j(*q), combiner=combiner)  # noqa: E731
        tlook = lambda f: tc.lookup_csr(f, *_t(*q), combiner=combiner)  # noqa: E731
    w = rng.standard_normal((b, len(ROWS), 16)).astype(np.float32)
    want = jax.grad(lambda f: jnp.sum(jlook(f) * w))(jc.device_put_tables(host))
    fused = tc.device_put_tables(host).requires_grad_(True)
    pooled = tlook(fused)
    assert pooled.grad_fn is not None
    (pooled * torch.from_numpy(w)).sum().backward()
    assert fused.grad.shape == fused.shape
    np.testing.assert_allclose(fused.grad.numpy(), np.asarray(want), **GRAD_TOL)


@pytest.mark.parametrize("wire", ["dense", "csr"])
def test_lookup_without_grad_builds_no_graph(rng, wire):
    """Serving (no grad) makes no autograd node, even on storage that
    requires grad; with grad on, the node is the port's own function."""
    tc = TColl.create(_tables(tcfg, ROWS), tcfg.ShardingPolicy.REPLICATE, packed=True,
                      device="cpu")
    fused = tc.init(torch.Generator())
    if wire == "dense":
        _, idx, mask, _ = _dense_batch(rng, ROWS, 4)
        look = lambda f: tc.lookup(f, *_t(idx, mask), batch_size=4)  # noqa: E731
        node = "_FixedLBagSumBackward"
    else:
        _, idx, off, _ = _csr_batch(rng, ROWS, 4)
        look = lambda f: tc.lookup_csr(f, *_t(idx, off))  # noqa: E731
        node = "_CSRBagSumBackward"
    assert look(fused).grad_fn is None
    fused.requires_grad_(True)
    with torch.no_grad():
        assert look(fused).grad_fn is None
    assert node in _graph_nodes(look(fused).grad_fn)


def _graph_nodes(fn):
    """Names of the autograd nodes reachable from ``fn``."""
    names, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is not None and type(f).__name__ not in names:
            names.add(type(f).__name__)
            todo.extend(nxt for nxt, _ in f.next_functions)
    return names


# -- the sparse train step ------------------------------------------------------


def _jax_csr_step(jmodel, dense_opt, lr, optimizer):
    """The JAX CSR-wire sparse step, composed as tools/train_bench.py does."""
    coll = jmodel.collection

    @jax.jit
    def step(emb, acc, dp, os_, dense, idx, off, labels):
        pooled = coll.lookup_csr(emb, idx, off)

        def loss_fn(dp_, pooled_):
            logits = jmodel.apply_from_pooled({**dp_, "emb": None}, dense, pooled_)
            return jdlrm.bce_loss(logits, labels)

        loss, (g_dense, g_pooled) = jax.value_and_grad(loss_fn, argnums=(0, 1))(dp, pooled)
        updates, os_ = dense_opt.update(g_dense, os_, dp)
        dp = optax.apply_updates(dp, updates)
        emb, acc = jst._apply_sparse_csr(coll, emb, acc, idx, off, g_pooled, lr=lr,
                                         optimizer=optimizer, eps=1e-8)
        return emb, acc, dp, os_, loss

    return step


def _torch_csr_step(tmodel, dense_opt, lr, optimizer):
    """The port's CSR-wire sparse step: lookup_csr, apply_from_pooled and
    _apply_sparse_csr."""
    coll = tmodel.collection

    def step(acc, dense, idx, off, labels):
        with torch.no_grad():
            pooled = coll.lookup_csr(tmodel.emb_params(), idx, off)
        pooled.requires_grad_(True)
        dense_opt.zero_grad(set_to_none=True)
        loss = tbce(tmodel.apply_from_pooled(dense, pooled), labels)
        loss.backward()
        dense_opt.step()
        with torch.no_grad():
            _, acc = tst._apply_sparse_csr(coll, tmodel.emb_params(), acc, idx, off,
                                           pooled.grad, lr=lr, optimizer=optimizer,
                                           eps=1e-8)
        return acc, loss.detach()

    return step


@pytest.mark.parametrize("hybrid,wire,optimizer", [
    (True, "dense", "sgd"), (True, "dense", "row_adagrad"),
    (True, "csr", "sgd"), (True, "csr", "row_adagrad"),
    (False, "dense", "row_adagrad"), (False, "csr", "sgd"),
])
def test_sparse_train_trace_matches_jax(rng, mesh, hybrid, wire, optimizer):
    """5 steps of the sparse step, fresh ids each step, on the mixed hybrid
    config or the plain collection of the same tables: the loss trace, the
    final tables, MLPs and accumulators."""
    lr, b = 0.1, 32
    jmodel, params, tmodel = _models(mesh, _mixed, hybrid=hybrid)
    dense_opt, opt_state, jacc = jst.make_sparse_train_state(jmodel, params, lr=lr)
    topt, tacc = tst.make_sparse_train_state(tmodel, optimizer=optimizer, lr=lr)
    if wire == "dense":
        jstep = jst.make_sparse_train_step(jmodel, dense_opt, lr=lr, optimizer=optimizer)
        tstep = tst.make_sparse_train_step(tmodel, topt, lr=lr, optimizer=optimizer)
    else:
        jstep = _jax_csr_step(jmodel, dense_opt, lr, optimizer)
        tstep = _torch_csr_step(tmodel, topt, lr, optimizer)
    emb, dp = params["emb"], {k: params[k] for k in ("bot", "top")}
    jlosses, tlosses = [], []
    for _ in range(5):
        batch = (_dense_batch(rng, MIXED_ROWS, b, l=2) if wire == "dense"
                 else _csr_batch(rng, MIXED_ROWS, b))
        emb, jacc, dp, opt_state, loss = jstep(emb, jacc, dp, opt_state, *_j(*batch))
        jlosses.append(float(loss))
        tacc, tloss = tstep(tacc, *_t(*batch))
        tlosses.append(float(tloss))
    np.testing.assert_allclose(tlosses, jlosses, **TRACE_TOL)
    _assert_params(tmodel, {"emb": emb, **dp})
    pairs = ([(tacc[k], jacc[k]) for k in ("small", "big")] if hybrid else [(tacc, jacc)])
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRACE_TOL)


def test_sparse_sgd_matches_dense_backward():
    """The port's own analog of tests/test_sparse_train.py: one sparse SGD
    step equals one dense-autodiff SGD step (plain collection, multi-hot,
    masked entries)."""
    cfg = tcfg.toy_config()
    rng = np.random.default_rng(5)
    a = TDLRM(cfg, tcfg.ShardingPolicy.REPLICATE, device="cpu",
              generator=torch.Generator().manual_seed(1))
    b_ = TDLRM(cfg, tcfg.ShardingPolicy.REPLICATE, device="cpu",
               generator=torch.Generator().manual_seed(1))
    batch = _t(*_dense_batch(rng, [t.num_rows for t in cfg.tables], 16, l=3))
    batch[0] = batch[0][:, : cfg.dense_dim].contiguous()
    loss_ref, _ = ttrain.make_train_step(a, ttrain.make_optimizer(0.1))(*batch)
    opt, acc = tst.make_sparse_train_state(b_, lr=0.1)
    _, loss = tst.make_sparse_train_step(b_, opt, lr=0.1)(acc, *batch)
    assert abs(float(loss) - float(loss_ref)) < 1e-6
    for (name, x), y in zip(a.state_dict().items(), b_.state_dict().values()):
        torch.testing.assert_close(y, x.detach(), rtol=1e-5, atol=1e-6, msg=name)


def test_sparse_step_refuses_routed_and_hot_cache(mesh):
    _, _, tmodel = _models(mesh, _mixed, hybrid=True)
    opt, _ = tst.make_sparse_train_state(tmodel)
    with pytest.raises(ValueError, match="mesh"):
        tst.make_sparse_train_step(tmodel, opt, routed=True)
    with pytest.raises(ValueError, match="mesh"):
        tst.make_sparse_train_step(tmodel, opt, routed=True, hot_cache=True)
    with pytest.raises(ValueError, match="routed"):
        tst.make_sparse_train_step(tmodel, opt, hot_cache=True)


def test_train_state_from_jax_continues_training(rng, mesh):
    """Two JAX row-AdaGrad steps, then the state carried into the port by
    params_from_jax and train_state_from_jax: two more steps on each side
    agree."""
    lr = 0.1
    jmodel, params, tmodel = _models(mesh, _mixed, hybrid=True, seed=3)
    dense_opt, opt_state, jacc = jst.make_sparse_train_state(jmodel, params, lr=lr)
    jstep = jst.make_sparse_train_step(jmodel, dense_opt, lr=lr, optimizer="row_adagrad")
    emb, dp = params["emb"], {k: params[k] for k in ("bot", "top")}
    batches = [_dense_batch(rng, MIXED_ROWS, 16) for _ in range(4)]
    for batch in batches[:2]:
        emb, jacc, dp, opt_state, _ = jstep(emb, jacc, dp, opt_state, *_j(*batch))
    params_from_jax(jax.tree.map(np.asarray, {"emb": emb, **dp}), tmodel)
    tacc = train_state_from_jax(jax.tree.map(np.asarray, jacc), tmodel)
    for key in ("small", "big"):
        np.testing.assert_array_equal(tacc[key].numpy(), np.asarray(jacc[key]))
    topt, _ = tst.make_sparse_train_state(tmodel, lr=lr)
    tstep = tst.make_sparse_train_step(tmodel, topt, lr=lr, optimizer="row_adagrad")
    for batch in batches[2:]:
        emb, jacc, dp, opt_state, jloss = jstep(emb, jacc, dp, opt_state, *_j(*batch))
        tacc, tloss = tstep(tacc, *_t(*batch))
        np.testing.assert_allclose(float(tloss), float(jloss), **TRACE_TOL)
    _assert_params(tmodel, {"emb": emb, **dp})
    # the plain collection's accumulator is one array
    cfg = tcfg.toy_config()
    plain = TDLRM(cfg, tcfg.ShardingPolicy.REPLICATE, device="cpu", generator=torch.Generator())
    rows = plain.collection.layout.total_rows
    one = train_state_from_jax(np.arange(rows, dtype=np.float32), plain)
    np.testing.assert_array_equal(one.numpy(), np.arange(rows, dtype=np.float32))
    with pytest.raises(ValueError, match="shape"):
        train_state_from_jax(np.zeros(rows + 1, np.float32), plain)


# -- the dense-autodiff step, fit, optimizers, metrics -------------------------


@pytest.mark.parametrize("kind", ["sgd", "adagrad"])
def test_make_optimizer_matches_optax(rng, kind):
    """5 updates of random params by random gradients, the port's optimizer
    against optax's rule."""
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    grads = [rng.standard_normal((7, 5)).astype(np.float32) for _ in range(5)]
    grads[1][0, 0] = 0.0  # a zero gradient: acc stays positive
    jopt = jtrain.make_optimizer(lr=0.3, kind=kind)
    jp = jnp.asarray(p0)
    state = jopt.init(jp)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = ttrain.make_optimizer(lr=0.3, kind=kind)([p])
    for g in grads:
        upd, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        p.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-6)
    if kind == "adagrad":
        np.testing.assert_allclose(topt.state[p]["sum_of_squares"].numpy(),
                                   np.asarray(state[0].sum_of_squares), rtol=1e-6)
    with pytest.raises(ValueError):
        ttrain.make_optimizer(kind="adam")


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("kind", ["sgd", "adagrad"])
def test_make_train_step_matches_jax(rng, mesh, hybrid, kind):
    """3 dense-autodiff steps (the gradient flows into the tables through
    the lookups), JAX against the port: losses, logits, final params."""
    cfg_fn = _mixed if hybrid else (lambda mod: mod.toy_config())
    jmodel, params, tmodel = _models(mesh, cfg_fn, hybrid=hybrid, seed=2)
    rows = [t.num_rows for t in tmodel.config.tables]
    jopt = jtrain.make_optimizer(lr=0.1, kind=kind)
    jstep = jtrain.make_train_step(jmodel, jopt)
    tstep = ttrain.make_train_step(tmodel, ttrain.make_optimizer(lr=0.1, kind=kind))
    state = jopt.init(params)
    small0 = tmodel.emb_small.detach().clone() if hybrid else None
    tol = dict(rtol=2.0 ** -7, atol=1e-5) if hybrid else TRACE_TOL
    for _ in range(3):
        dense, idx, mask, labels = _dense_batch(rng, rows, 16, l=2)
        dense = dense[:, : tmodel.config.dense_dim]
        params, state, jloss, jlogits = jstep(params, state, *_j(dense, idx, mask, labels))
        tloss, tlogits = tstep(*_t(dense, idx, mask, labels))
        np.testing.assert_allclose(float(tloss), float(jloss), **tol)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **tol)
    if hybrid:
        got = (tmodel.emb_small.detach() - small0).numpy()
        want = np.asarray(params["emb"]["small"]) - small0.numpy()
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -6 * np.abs(want).max())
    _assert_params(tmodel, params, tol=tol)


def test_fit_matches_jax(rng, mesh):
    """fit over 6 batches, evaluating every 3 steps on 2 held-out batches:
    the same reports (step, loss, accuracy, AUC) and final params."""
    jmodel, params, tmodel = _models(mesh, lambda mod: mod.toy_config(), hybrid=False)
    rows = [t.num_rows for t in tmodel.config.tables]

    def batches(n, seed):
        r = np.random.default_rng(seed)
        out = []
        for _ in range(n):
            dense, idx, mask, labels = _dense_batch(r, rows, 32, l=2)
            out.append((dense[:, : tmodel.config.dense_dim], idx, mask, labels))
        return out

    train, test = batches(6, 11), batches(2, 12)
    jparams, jreports = jtrain.fit(jmodel, params, iter(train), lr=0.1, test_freq=3,
                                   test_batches=test)
    logged = []
    treports = ttrain.fit(tmodel, iter(train), lr=0.1, test_freq=3, test_batches=test,
                          log_fn=logged.append)
    assert [r.step for r in treports] == [r.step for r in jreports] == [3, 6]
    assert logged == treports
    for tr, jr in zip(treports, jreports):
        np.testing.assert_allclose([tr.loss, tr.auc], [jr.loss, jr.auc], **TRACE_TOL)
        assert tr.accuracy == jr.accuracy
    _assert_params(tmodel, jparams)


def test_metrics_match_jax(rng):
    probs = np.round(rng.random(200), 1).astype(np.float32)  # many ties
    labels = (rng.random(200) < 0.4).astype(np.float32)
    assert ttrain.roc_auc(probs, labels) == jtrain.roc_auc(probs, labels)
    assert ttrain.binary_accuracy(probs, labels) == jtrain.binary_accuracy(probs, labels)
    tied = np.full(10, 0.5, np.float32)
    assert ttrain.roc_auc(tied, labels[:10]) == jtrain.roc_auc(tied, labels[:10]) == 0.5
    assert np.isnan(ttrain.roc_auc(probs[:5], np.ones(5, np.float32)))


def test_eval_step_gives_probabilities(mesh):
    jmodel, params, tmodel = _models(mesh, lambda mod: mod.toy_config(), hybrid=False)
    rng = np.random.default_rng(4)
    dense, idx, mask, _ = _dense_batch(rng, [t.num_rows for t in tmodel.config.tables], 8)
    dense = dense[:, : tmodel.config.dense_dim]
    want = jtrain.make_eval_step(jmodel)(params, *_j(dense, idx, mask))
    got = ttrain.make_eval_step(tmodel)(*_t(dense, idx, mask))
    assert got.grad_fn is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


# -- no CUDA, no JAX -----------------------------------------------------------


@pytest.mark.parametrize("build", ["dlrm", "hybrid", "collection"])
def test_train_entry_points_raise_without_cuda(monkeypatch, build):
    """The train path's objects default to CUDA and raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if build == "dlrm":
            TDLRM(_mixed(tcfg), hybrid=True, generator=torch.Generator())
        elif build == "hybrid":
            THybrid.create(_tables(tcfg, MIXED_ROWS))
        else:
            TColl.create(_tables(tcfg, ROWS))


def test_train_modules_import_no_jax():
    code = (
        "import re, sys\n"
        "import pim_embedding_lookup_tpu_torch.models.train\n"
        "import pim_embedding_lookup_tpu_torch.models.sparse_train\n"
        "import pim_embedding_lookup_tpu_torch.parallel.sparse_update\n"
        "import pim_embedding_lookup_tpu_torch.convert\n"
        "bad = [m for m in sys.modules if re.match(r'(jax|optax)', m) or "
        "re.match(r'pim_embedding_lookup_tpu(?!_torch)', m)]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).parent.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
