"""The CSR wire of the port against the JAX package's: ``lookup_csr`` on the
plain and the hybrid collection, ``lookup_csr_bucketed``, and the slice as a
whole (the Kaggle hybrid DLRM served over CSR: ``lookup_csr`` then
``apply_from_pooled``, parameters carried across by ``params_from_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu.models import DLRM as JDLRM
from pim_embedding_lookup_tpu.ops.ragged import shard_csr
from pim_embedding_lookup_tpu.parallel import lookup_csr_bucketed as jbucketed
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.parallel.collection import (
    EmbeddingCollection as JColl,
)
from pim_embedding_lookup_tpu.parallel.hybrid import (
    HybridEmbeddingCollection as JHybrid,
)
from pim_embedding_lookup_tpu_torch import params_from_jax
from pim_embedding_lookup_tpu_torch.models import DLRM as TDLRM
from pim_embedding_lookup_tpu_torch.ops.csr_pool import embedding_bag_csr_packed
from pim_embedding_lookup_tpu_torch.ops.ragged import (
    pack_length_buckets,
    plan_length_buckets,
)
from pim_embedding_lookup_tpu_torch.parallel import lookup_csr_bucketed as tbucketed
from pim_embedding_lookup_tpu_torch.parallel.collection import (
    EmbeddingCollection as TColl,
)
from pim_embedding_lookup_tpu_torch.parallel.hybrid import (
    HybridEmbeddingCollection as THybrid,
)

TOL = dict(rtol=1e-5, atol=1e-5)
ROWS = (50, 300, 17)
HYBRID_ROWS = (3, 24, 583, 1460, 9000, 20000)  # 4 small tables, 2 big


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jcfg.MeshConfig(data=1, model=1))


def _tables(mod, rows, dim):
    return tuple(mod.TableConfig(num_rows=n, dim=dim, name=f"t{i}")
                 for i, n in enumerate(rows))


def _host_tables(rng, rows, dim):
    return [rng.standard_normal((n, dim)).astype(np.float32) for n in rows]


def make_bags(rng, rows, b, max_len=6, empty_rate=0.2):
    """Ragged per-table bags with deliberate empty bags, as in
    tests/test_hybrid_csr.py."""
    return [[rng.integers(0, n, size=0 if rng.random() < empty_rate
                          else int(rng.integers(1, max_len))).tolist()
             for _ in range(b)] for n in rows]


def _csr(rng, rows, b, cap=None):
    idx, off = shard_csr(make_bags(rng, rows, b), 1, cap or 8 * b)
    return idx, off


def _both(idx, off):
    return (jnp.asarray(idx), jnp.asarray(off)), (torch.from_numpy(idx),
                                                  torch.from_numpy(off))


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("packed", [False, True])
def test_collection_lookup_csr_matches(rng, mesh, combiner, packed):
    dim, b = 16, 12
    host = _host_tables(rng, ROWS, dim)
    jq, tq = _both(*_csr(rng, ROWS, b))
    jc = JColl.create(_tables(jcfg, ROWS, dim), mesh,
                      jcfg.ShardingPolicy.REPLICATE, packed=packed)
    want = jc.lookup_csr(jc.device_put_tables(host), *jq, combiner=combiner)
    tc = TColl.create(_tables(tcfg, ROWS, dim), tcfg.ShardingPolicy.REPLICATE,
                      packed=packed, device="cpu")
    got = tc.lookup_csr(tc.device_put_tables(host), *tq, combiner=combiner)
    assert got.shape == (b, len(ROWS), dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("combiner", ["sum", "mean"])
def test_collection_lookup_csr_full_width_rows(rng, mesh, combiner):
    """d = 128: the rows K3 walks."""
    rows, dim, b = (70, 130), 128, 9
    host = _host_tables(rng, rows, dim)
    jq, tq = _both(*_csr(rng, rows, b))
    jc = JColl.create(_tables(jcfg, rows, dim), mesh, jcfg.ShardingPolicy.REPLICATE)
    want = jc.lookup_csr(jc.device_put_tables(host), *jq, combiner=combiner)
    tc = TColl.create(_tables(tcfg, rows, dim), tcfg.ShardingPolicy.REPLICATE,
                      device="cpu")
    assert tc.layout.storage_width == 128
    got = tc.lookup_csr(tc.device_put_tables(host), *tq, combiner=combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_collection_lookup_csr_full_buffer_and_padding(rng, mesh):
    """offsets[B] equal to the capacity, and padding ids that are out of
    every table's range: both sides read no padding."""
    dim, b = 16, 6
    host = _host_tables(rng, ROWS, dim)
    bags = [[[int(rng.integers(0, n))] * 2 for _ in range(b)] for n in ROWS]
    idx, off = shard_csr(bags, 1, 2 * b)
    assert (off[:, -1] == idx.shape[1]).all()
    pad_idx, pad_off = shard_csr(bags, 1, 2 * b + 5, pad_index=10_000)
    tc = TColl.create(_tables(tcfg, ROWS, dim), packed=True, device="cpu")
    params = tc.device_put_tables(host)
    full = tc.lookup_csr(params, *_both(idx, off)[1])
    padded = tc.lookup_csr(params, *_both(pad_idx, pad_off)[1])
    torch.testing.assert_close(full, padded, rtol=0, atol=0)
    jc = JColl.create(_tables(jcfg, ROWS, dim), mesh, jcfg.ShardingPolicy.REPLICATE,
                      packed=True)
    want = jc.lookup_csr(jc.device_put_tables(host), *_both(idx, off)[0])
    np.testing.assert_allclose(full.numpy(), np.asarray(want), **TOL)


def test_collection_lookup_csr_data_sharded_is_plain_on_one_device(rng, mesh):
    dim, b = 16, 8
    host = _host_tables(rng, ROWS, dim)
    jq, tq = _both(*_csr(rng, ROWS, b))
    jc = JColl.create(_tables(jcfg, ROWS, dim), mesh, jcfg.ShardingPolicy.REPLICATE)
    want = jc.lookup_csr(jc.device_put_tables(host), *jq, data_sharded=True)
    tc = TColl.create(_tables(tcfg, ROWS, dim), tcfg.ShardingPolicy.REPLICATE,
                      device="cpu")
    params = tc.device_put_tables(host)
    got = tc.lookup_csr(params, *tq, data_sharded=True)
    torch.testing.assert_close(got, tc.lookup_csr(params, *tq), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_collection_lookup_csr_runs_the_kernel_wrapper(rng, monkeypatch):
    """SUM and MEAN pool through the K2 wrapper, once per call, for all
    tables together."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[2].shape)
        return embedding_bag_csr_packed(*args, **kw)

    import pim_embedding_lookup_tpu_torch.parallel.collection as tcoll
    monkeypatch.setattr(tcoll, "embedding_bag_csr_packed", spy)
    tc = TColl.create(_tables(tcfg, ROWS, 16), packed=True, device="cpu")
    params = tc.init(torch.Generator().manual_seed(0))
    idx, off = _csr(rng, ROWS, 5)
    for combiner in ("sum", "mean"):
        tc.lookup_csr(params, torch.from_numpy(idx), torch.from_numpy(off),
                      combiner=combiner)
    assert calls == [idx.shape, idx.shape]


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_hybrid_lookup_csr_matches(rng, mesh, combiner):
    dim, b = 16, 10
    host = _host_tables(rng, HYBRID_ROWS, dim)
    jq, tq = _both(*_csr(rng, HYBRID_ROWS, b))
    jh = JHybrid.create(_tables(jcfg, HYBRID_ROWS, dim), mesh,
                        jcfg.ShardingPolicy.REPLICATE)
    want = jh.lookup_csr(jh.device_put_tables(host), *jq, combiner=combiner)
    th = THybrid.create(_tables(tcfg, HYBRID_ROWS, dim),
                        tcfg.ShardingPolicy.REPLICATE, device="cpu")
    got = th.lookup_csr(th.device_put_tables(host), *tq, combiner=combiner)
    assert got.shape == (b, len(HYBRID_ROWS), dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_hybrid_lookup_csr_small_set_is_bf16_rounded(rng):
    """Single-entry bags: the small set returns f32(bf16(w[id])) and the big
    set w[id] exactly, as the JAX package does."""
    dim, b = 16, 6
    host = _host_tables(rng, HYBRID_ROWS, dim)
    th = THybrid.create(_tables(tcfg, HYBRID_ROWS, dim), device="cpu")
    bags = [[[int(rng.integers(0, n))] for _ in range(b)] for n in HYBRID_ROWS]
    idx, off = shard_csr(bags, 1, b + 3)
    got, dropped = th.lookup_csr(th.device_put_tables(host), torch.from_numpy(idx),
                                 torch.from_numpy(off), return_stats=True)
    assert int(dropped) == 0
    for t in range(len(HYBRID_ROWS)):
        w = torch.from_numpy(host[t][idx[t, :b]])
        if t in th.small_ids:
            w = w.to(torch.bfloat16).float()
        torch.testing.assert_close(got[:, t], w, rtol=0, atol=0)


def test_routed_and_other_policies_raise(rng):
    idx, off = _csr(rng, (40, 50), 4)
    q = torch.from_numpy(idx), torch.from_numpy(off)
    rep = TColl.create(_tables(tcfg, (40, 50), 16), tcfg.ShardingPolicy.REPLICATE,
                       device="cpu")
    params = rep.init(torch.Generator())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rep.lookup_csr(params, *q, routed=True)
    with pytest.raises(ValueError, match="return_stats"):
        rep.lookup_csr(params, *q, return_stats=True)
    with pytest.raises(ValueError, match="combiner"):
        rep.lookup_csr(params, *q, combiner="median")
    row = TColl.create(_tables(tcfg, (40, 50), 16), tcfg.ShardingPolicy.ROW,
                       device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        row.lookup_csr(row.init(torch.Generator()), *q)
    hyb = THybrid.create(_tables(tcfg, (40, 50_000), 16), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hyb.lookup_csr(hyb.init(torch.Generator()), *q, routed=True)


# -- length-bucketed CSR ------------------------------------------------------


def _ragged(rng, rows, b, max_len=12, empty_rate=0.15):
    """Empties, short bags, and bags longer than the largest bucket (the
    mixture of tests/test_bucketed_csr.py)."""
    bags = []
    for n in rows:
        tb = []
        for _ in range(b):
            r = rng.random()
            k = (0 if r < empty_rate else int(rng.integers(1, 5)) if r < 0.8
                 else int(rng.integers(5, max_len)))
            tb.append(rng.integers(0, n, size=k).tolist())
        bags.append(tb)
    return shard_csr(bags, 1, 16 * b)


@pytest.mark.parametrize("kind,combiner,bucket_ls,slack", [
    ("plain", "sum", (1, 2, 4), 1.2),
    ("plain", "mean", (1, 2, 4), 1.2),
    ("plain", "max", (1, 2, 4), 1.2),
    ("hybrid", "sum", (1, 4), 1.5),
    ("hybrid", "max", (1, 4), 1.5),
])
def test_bucketed_matches_jax_and_lookup_csr(mesh, kind, combiner, bucket_ls, slack):
    rng = np.random.default_rng(2)
    rows = ROWS if kind == "plain" else HYBRID_ROWS
    host = _host_tables(rng, rows, 16)
    idx, off = _ragged(rng, rows, 24)
    plan = plan_length_buckets(off, bucket_ls=bucket_ls, slack=slack)
    packed = pack_length_buckets(idx, off, plan)
    assert packed.tail_idx is not None and not packed.identity
    if kind == "plain":
        jc = JColl.create(_tables(jcfg, rows, 16), mesh,
                          jcfg.ShardingPolicy.REPLICATE, packed=True)
        tc = TColl.create(_tables(tcfg, rows, 16), packed=True, device="cpu")
    else:
        jc = JHybrid.create(_tables(jcfg, rows, 16), mesh,
                            jcfg.ShardingPolicy.REPLICATE)
        tc = THybrid.create(_tables(tcfg, rows, 16), device="cpu")
    want = jbucketed(jc, jc.device_put_tables(host), packed, combiner=combiner)
    params = tc.device_put_tables(host)
    got = tbucketed(tc, params, packed, combiner=combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    direct = tc.lookup_csr(params, torch.from_numpy(idx), torch.from_numpy(off),
                           combiner=combiner)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), **TOL)


def test_bucketed_identity_fast_path_matches_jax(rng, mesh):
    b = 16
    host = _host_tables(rng, ROWS, 16)
    bags = [[[int(rng.integers(0, n))] for _ in range(b)] for n in ROWS]
    idx, off = shard_csr(bags, 1, b)
    plan = plan_length_buckets(off, bucket_ls=(1,), slack=1.0)
    packed = pack_length_buckets(idx, off, plan)
    assert packed.identity and plan.tail_bags == 0
    jc = JColl.create(_tables(jcfg, ROWS, 16), mesh, jcfg.ShardingPolicy.REPLICATE,
                      packed=True)
    tc = TColl.create(_tables(tcfg, ROWS, 16), packed=True, device="cpu")
    want = jbucketed(jc, jc.device_put_tables(host), packed)
    got = tbucketed(tc, tc.device_put_tables(host), packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the slice as a whole -------------------------------------------------------

ROW_CAP = 10_000  # keeps 16 tables in the small set and 10 in the big set


def _capped_kaggle(mod):
    cfg = mod.kaggle_config()
    tables = tuple(mod.TableConfig(num_rows=min(t.num_rows, ROW_CAP), dim=t.dim,
                                   name=t.name) for t in cfg.tables)
    return mod.DLRMConfig(dense_dim=cfg.dense_dim, mlp_bot=cfg.mlp_bot,
                          mlp_top=cfg.mlp_top, tables=tables)


def _kaggle_csr(rng, rows, b, pooling):
    """bench.py's ragged mixture: 10 % empty bags, 80 % of 1..pooling ids,
    10 % of 2*pooling..4*pooling; capacity rounded up to 8, padding after."""
    t = len(rows)
    r = rng.random((t, b))
    lens = np.where(r >= 0.10, rng.integers(1, pooling + 1, size=(t, b)), 0)
    lens = np.where(r >= 0.90, rng.integers(2 * pooling, 4 * pooling + 1,
                                            size=(t, b)), lens)
    cap = -(-int(lens.sum(axis=1).max()) // 8) * 8
    off = np.zeros((t, b + 1), np.int32)
    np.cumsum(lens, axis=1, out=off[:, 1:])
    idx = np.stack([rng.integers(0, n, size=cap) for n in rows]).astype(np.int32)
    return idx, off


@pytest.mark.parametrize("pooling", [1, 3])
def test_csr_served_logits_match_jax(pooling):
    """lookup_csr then apply_from_pooled, on the capped Kaggle hybrid DLRM,
    with the JAX model's parameters loaded by params_from_jax unchanged."""
    cfg_j = _capped_kaggle(jcfg)
    jmodel = JDLRM(cfg_j, make_mesh(jcfg.MeshConfig(data=1, model=1)),
                   jcfg.ShardingPolicy.REPLICATE, hybrid=True)
    params = jmodel.init(jax.random.PRNGKey(2))
    tmodel = TDLRM(_capped_kaggle(tcfg), tcfg.ShardingPolicy.REPLICATE,
                   hybrid=True, device="cpu", generator=torch.Generator())
    params_from_jax(jax.tree.map(np.asarray, params), tmodel)
    rng = np.random.default_rng(5)
    b = 32
    rows = [t.num_rows for t in cfg_j.tables]
    dense = rng.random((b, 13), dtype=np.float32)
    idx, off = _kaggle_csr(rng, rows, b, pooling)
    jpooled = jmodel.collection.lookup_csr(params["emb"], jnp.asarray(idx),
                                           jnp.asarray(off))
    want = np.asarray(jmodel.apply_from_pooled(params, jnp.asarray(dense), jpooled))
    with torch.no_grad():
        pooled = tmodel.collection.lookup_csr(
            tmodel.emb_params(), torch.from_numpy(idx), torch.from_numpy(off))
        got = tmodel.apply_from_pooled(torch.from_numpy(dense), pooled).numpy()
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), **TOL)
    assert got.shape == (b,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
