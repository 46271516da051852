"""The port's utils against the JAX package's: profiling (phase timer,
interval CSV, Gantt plot, trace, cost stats), guards, and checkpoints (the
layout fingerprint, refusals, and resume equivalence: training N steps
straight equals k steps, save, restore into a fresh model, N-k steps).

Tolerances: cost stats, CSV text, fingerprints and guard paths are exact;
the resumed run at rtol 1e-6 / atol 1e-7, as tests/test_checkpoint_resume.py
holds the JAX package's (a round trip through a file changes no bit, so
the runs agree bitwise in practice)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu.utils.checkpoint as jckpt
import pim_embedding_lookup_tpu.utils.guards as jguards
import pim_embedding_lookup_tpu.utils.profiling as jprof
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.parallel.collection import EmbeddingCollection as JColl
from pim_embedding_lookup_tpu.parallel.hybrid import HybridEmbeddingCollection as JHybrid
from pim_embedding_lookup_tpu_torch.models import DLRM
from pim_embedding_lookup_tpu_torch.models import sparse_train as tst
from pim_embedding_lookup_tpu_torch.models.train import make_optimizer
from pim_embedding_lookup_tpu_torch.parallel.collection import EmbeddingCollection as TColl
from pim_embedding_lookup_tpu_torch.parallel.hybrid import HybridEmbeddingCollection as THybrid
from pim_embedding_lookup_tpu_torch.parallel.mesh import PortMesh
from pim_embedding_lookup_tpu_torch.utils import (
    IntervalRecorder,
    PhaseTimer,
    checkpoint,
    cost_stats,
    plot_gantt,
    trace,
    write_intervals_csv,
)
from pim_embedding_lookup_tpu_torch.utils import guards as tguards
from pim_embedding_lookup_tpu_torch.utils.profiling import Interval

RESUME_TOL = dict(rtol=1e-6, atol=1e-7)

# -- profiling ----------------------------------------------------------------


def test_phase_timer_and_intervals_csv(tmp_path):
    pt = PhaseTimer()
    x = torch.arange(1000.0)
    for _ in range(3):
        with pt.phase("launch", sync=x):
            (x * 2).sum()
    rep = pt.report()
    assert list(rep) == ["launch"] and rep["launch"] > 0 and pt.phases["launch"].count == 3
    rec = IntervalRecorder()
    with rec.record(0, "lookup"):
        pass
    with rec.record(1, "lookup"):
        pass
    assert [iv.unit for iv in rec.intervals] == [0, 1]
    # the same intervals through both writers give the same file
    ivs = [Interval(0, "lookup", 0.0, 0.0012345), Interval(3, "merge", 0.5, 0.75)]
    write_intervals_csv(str(tmp_path / "t.csv"), ivs)
    jprof.write_intervals_csv(str(tmp_path / "j.csv"),
                              [jprof.Interval(i.unit, i.label, i.start_s, i.end_s) for i in ivs])
    text = (tmp_path / "t.csv").read_text()
    assert text == (tmp_path / "j.csv").read_text() and "rank_id" in text


def test_print_report(capsys):
    pt = PhaseTimer()
    with pt.phase("inference"):
        pass
    pt.print_report()
    assert capsys.readouterr().out.startswith("inference: ")


def test_gantt_plot(tmp_path, capsys):
    rec = IntervalRecorder()
    for unit in range(4):
        with rec.record(unit, "lookup"):
            pass
    csv_path = str(tmp_path / "iv.csv")
    write_intervals_csv(csv_path, rec.intervals)
    png = str(tmp_path / "gantt.png")
    plot_gantt(csv_path, png)
    try:
        import matplotlib  # noqa: F401
    except ImportError:  # the documented note, and no file
        assert "matplotlib unavailable" in capsys.readouterr().out
        assert not os.path.exists(png)
    else:
        assert os.path.getsize(png) > 1000


def test_trace_writes_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d):
        torch.arange(1000.0).sum()
    path = os.path.join(d, "trace.json")
    assert os.path.getsize(path) > 0 and "traceEvents" in open(path).read()


def test_cost_stats_matches_jax():
    """One [128, 128] @ [128, 128] f32 product: the flops and bytes XLA's
    cost analysis gives."""
    want = jprof.cost_stats(jax.jit(lambda a, b: a @ b), jnp.ones((128, 128)),
                            jnp.ones((128, 128)))
    x = torch.ones(128, 128)
    got = cost_stats(lambda a, b: a @ b, x, x)
    assert got == want == {"flops": 4194304.0, "bytes_accessed": 196608.0}
    # views move no bytes: a transpose before the product counts the same
    assert cost_stats(lambda a, b: a.t() @ b, x, x) == want


# -- guards -------------------------------------------------------------------


def test_check_finite_raises_with_jax_path():
    tguards.check_finite({"a": torch.ones(3)}, "params")
    state = {"b": [torch.ones(2), {"w": torch.tensor([1.0, float("nan")])}],
             "a": torch.ones(3), "n": np.arange(3)}
    with pytest.raises(tguards.NonFiniteError) as got:
        tguards.check_finite(state, "params")
    jstate = {"b": [np.ones(2), {"w": np.array([1.0, np.nan])}], "a": np.ones(3),
              "n": np.arange(3)}
    with pytest.raises(jguards.NonFiniteError) as want:
        jguards.check_finite(jstate, "params")
    assert got.value.where == want.value.where == "params['b'][1]['w']"
    assert str(got.value) == str(want.value)


def test_finite_or_skip_update():
    old = {"w": torch.zeros(2), "v": [torch.zeros(3)]}
    new = {"w": torch.ones(2), "v": [torch.full((3,), 2.0)]}
    kept = tguards.finite_or_skip_update(new, old, torch.tensor(0.5))
    np.testing.assert_array_equal(kept["w"].numpy(), [1, 1])
    np.testing.assert_array_equal(kept["v"][0].numpy(), [2, 2, 2])
    skipped = tguards.finite_or_skip_update(new, old, torch.tensor(float("nan")))
    np.testing.assert_array_equal(skipped["w"].numpy(), [0, 0])
    np.testing.assert_array_equal(skipped["v"][0].numpy(), [0, 0, 0])


def test_train_with_restart_rolls_back():
    saves, calls = {}, {"n": 0}

    def run_steps(state, n):
        calls["n"] += 1
        if calls["n"] == 2:  # the second chunk poisons
            raise tguards.NonFiniteError("loss")
        return state + n, 0.1

    result = tguards.train_with_restart(
        run_steps, save=lambda s, step: saves.__setitem__(step, s),
        restore=lambda step: saves[step], state=0, total_steps=30, checkpoint_every=10)
    assert result == 30 and calls["n"] == 4 and set(saves) == {0, 10, 20, 30}


def test_train_with_restart_gives_up():
    def run_steps(state, n):
        return state, torch.tensor(float("inf"))  # check_finite raises on the loss

    with pytest.raises(tguards.NonFiniteError, match="loss"):
        tguards.train_with_restart(run_steps, save=lambda s, step: None,
                                   restore=lambda step: 0, state=0, total_steps=10,
                                   checkpoint_every=5, max_restarts=2)


# -- the layout fingerprint ---------------------------------------------------

ROWS = (64, 200, 9000, 20000)
POLICIES = ["auto", "replicate", "row", "row_hash", "table_wise", "column"]


def _tables(mod, rows=ROWS, dim=16):
    return tuple(mod.TableConfig(num_rows=n, dim=dim, name=f"t{i}") for i, n in enumerate(rows))


@pytest.fixture(scope="module")
def jax_meshes():
    return {m: make_mesh(jcfg.MeshConfig(data=1, model=m)) for m in (1, 4)}


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("hybrid", [False, True])
def test_collection_meta_matches_jax(jax_meshes, policy, m, hybrid):
    """The same collection gives the same fingerprint in both packages: one
    process without a mesh against JAX's (1, 1); M=4 through the planner
    on a mesh object that no process group backs."""
    mesh = None if m == 1 else PortMesh(1, m, torch.device("cpu"), 0, {})
    tpol, jpol = tcfg.ShardingPolicy(policy), jcfg.ShardingPolicy(policy)
    if hybrid:
        got = THybrid.create(_tables(tcfg), tpol, device="cpu", mesh=mesh)
        want = JHybrid.create(_tables(jcfg), jax_meshes[m], jpol)
    else:
        got = TColl.create(_tables(tcfg), tpol, device="cpu", mesh=mesh)
        want = JColl.create(_tables(jcfg), jax_meshes[m], jpol)
    assert checkpoint.collection_meta(got) == jckpt.collection_meta(want)


def _coll(policy):
    return TColl.create(_tables(tcfg), tcfg.ShardingPolicy(policy), device="cpu",
                        mesh=PortMesh(1, 4, torch.device("cpu"), 0, {}))


def test_layout_mismatch_rejected(tmp_path):
    row, hashed = _coll("row"), _coll("row_hash")
    fused = row.init(torch.Generator().manual_seed(0))
    path = str(tmp_path / "ck")
    checkpoint.save(path, {"emb": fused}, meta={"collection": checkpoint.collection_meta(row)})
    other = hashed.init(torch.Generator().manual_seed(1))
    assert other.shape == fused.shape
    with pytest.raises(ValueError, match="layout mismatch"):
        checkpoint.restore(path, {"emb": other},
                           expect_meta={"collection": checkpoint.collection_meta(hashed)})
    target = torch.zeros_like(fused)
    out = checkpoint.restore(path, {"emb": target},
                             expect_meta={"collection": checkpoint.collection_meta(row)})
    assert out["emb"] is target  # restored in place
    np.testing.assert_array_equal(target.numpy(), fused.numpy())


def test_meta_absent_is_permissive(tmp_path):
    coll = _coll("row")
    fused = coll.init(torch.Generator().manual_seed(0))
    path = str(tmp_path / "ck")
    checkpoint.save(path, {"emb": fused})
    assert checkpoint.saved_meta(path) is None
    out = checkpoint.restore(path, {"emb": torch.zeros_like(fused)},
                             expect_meta={"collection": checkpoint.collection_meta(coll)})
    np.testing.assert_array_equal(out["emb"].numpy(), fused.numpy())


def test_restore_checks_the_template(tmp_path):
    path = str(tmp_path / "ck")
    state = {"emb": torch.arange(12.0).reshape(3, 4), "step": 7,
             "nested": {"w": torch.ones(2, 2), "none": None}, "list": [torch.zeros(1)]}
    checkpoint.save(path, state)
    raw = checkpoint.restore_raw(path)
    assert raw["step"] == 7 and raw["nested"]["none"] is None
    tpl = {"emb": torch.zeros(3, 4), "step": 0, "nested": {"w": torch.zeros(2, 2)},
           "list": [torch.zeros(1)]}
    out = checkpoint.restore(path, tpl)
    assert out["step"] == 7 and out["nested"]["none"] is None
    np.testing.assert_array_equal(tpl["emb"].numpy(), state["emb"].numpy())
    with pytest.raises(ValueError, match="shape|template"):
        checkpoint.restore(path, {**tpl, "emb": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="lacks"):
        checkpoint.restore(path, {**tpl, "acc": torch.zeros(1)})
    # a save over another number of model shards is refused, not misread
    os.rename(os.path.join(path, "model0-of-1.pt"), os.path.join(path, "model0-of-2.pt"))
    with pytest.raises(ValueError, match="layout mismatch"):
        checkpoint.restore_raw(path)


# -- resume equivalence -------------------------------------------------------

CONFIG = tcfg.DLRMConfig(dense_dim=4, mlp_bot=(8, 16), mlp_top=(8, 1),
                         tables=_tables(tcfg, (64, 200, 500, 9000)))


def _batches(rng, n, b=16, l=2):
    out = []
    for _ in range(n):
        dense = rng.standard_normal((b, CONFIG.dense_dim)).astype(np.float32)
        idx = np.stack([rng.integers(0, t.num_rows, size=b * l)
                        for t in CONFIG.tables]).astype(np.int32)
        mask = rng.random((len(CONFIG.tables), b * l)) < 0.8
        labels = (rng.random(b) < 0.5).astype(np.float32)
        out.append(tuple(torch.from_numpy(x) for x in (dense, idx, mask, labels)))
    return out


def _state(hybrid, optimizer, seed):
    model = DLRM(CONFIG, hybrid=hybrid, device="cpu",
                 generator=torch.Generator().manual_seed(seed))
    dense_opt, acc = tst.make_sparse_train_state(
        model, optimizer=optimizer, lr=0.1,
        dense_optimizer=make_optimizer(0.1, "adagrad" if optimizer == "row_adagrad" else "sgd"))
    step = tst.make_sparse_train_step(model, dense_opt, lr=0.1, optimizer=optimizer)
    return model, dense_opt, acc, step


def _full(model, dense_opt, acc, stepno):
    params = checkpoint.model_params(model)
    return {"emb": params["emb"], "acc": acc, "dense": {k: params[k] for k in ("bot", "top")},
            "opt_state": dense_opt.state_dict(), "step": stepno}


def _run(hybrid, optimizer, batches, path=None, save_at=None):
    model, dense_opt, acc, step = _state(hybrid, optimizer, 0)
    meta = {"collection": checkpoint.collection_meta(model.collection), "state": "full"}
    for i, batch in enumerate(batches):
        acc, _ = step(acc, *batch)
        if i + 1 == save_at:
            checkpoint.save(path, _full(model, dense_opt, acc, i + 1), meta=meta)
            # restore into a fresh model (another seed), optimizer and accumulator
            model, dense_opt, acc, step = _state(hybrid, optimizer, 99)
            st = checkpoint.restore(path, _full(model, dense_opt, acc, 0), expect_meta=meta)
            acc = st["acc"]
            dense_opt.load_state_dict(st["opt_state"])
            assert st["step"] == i + 1
    return [t.detach().clone() for t in (*model.buffers(), *model.parameters())], acc


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
@pytest.mark.parametrize("hybrid", [False, True])
def test_resume_equivalence(tmp_path, hybrid, optimizer):
    batches = _batches(np.random.default_rng(0), 6)
    tensors_a, acc_a = _run(hybrid, optimizer, batches)
    tensors_b, acc_b = _run(hybrid, optimizer, batches, str(tmp_path / "ck"), save_at=3)
    for a, b in zip(tensors_a, tensors_b):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **RESUME_TOL)
    for a, b in zip(tguards._leaves_with_path(acc_a), tguards._leaves_with_path(acc_b)):
        assert a[0] == b[0]
        np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), **RESUME_TOL)
    if optimizer == "row_adagrad":
        assert any(float(t.abs().sum()) > 0 for _, t in tguards._leaves_with_path(acc_b))
