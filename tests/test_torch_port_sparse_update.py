"""The port's sparse embedding update against the JAX package's, on one
device: ``sparse_update`` and ``sparse_update_csr`` (SGD and row-wise
AdaGrad, packed and unpacked storage, masked entries, ragged bags with
empty bags and poisoned padding), and ``sparse_update_hybrid(_csr)`` at the
Criteo-Kaggle widths with rows capped.

Tolerance after one step: rtol 1e-5, atol 1e-6 (f32 sums in another
order), the bar of tests/test_sparse_train.py.  bf16 storage adds the same
bf16-rounded steps on both sides; rows hit by several entries round after
each add, in an order that may differ, so bf16 cases compare within one
bf16 ulp of the weights (rtol 2**-7)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.parallel import hybrid as jhybrid
from pim_embedding_lookup_tpu.parallel import sparse_update as jsu
from pim_embedding_lookup_tpu.parallel.collection import EmbeddingCollection as JColl
from pim_embedding_lookup_tpu_torch.ops.ragged import pack_bags
from pim_embedding_lookup_tpu_torch.parallel import hybrid as thybrid
from pim_embedding_lookup_tpu_torch.parallel import sparse_update as tsu
from pim_embedding_lookup_tpu_torch.parallel.collection import EmbeddingCollection as TColl

TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
ROWS = (50, 300, 17)
DIM = 16
POISON = 1 << 30  # an id far outside every table
ROW_CAP = 10_000  # Kaggle rows capped: 16 small tables, 10 big ones


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jcfg.MeshConfig(data=1, model=1))


def _tables(mod, rows, dim=DIM):
    return tuple(mod.TableConfig(num_rows=n, dim=dim, name=f"t{i}")
                 for i, n in enumerate(rows))


def _colls(mesh, rows, packed):
    jc = JColl.create(_tables(jcfg, rows), mesh, jcfg.ShardingPolicy.REPLICATE,
                      packed=packed)
    tc = TColl.create(_tables(tcfg, rows), tcfg.ShardingPolicy.REPLICATE,
                      packed=packed, device="cpu")
    return jc, tc


def _state(rng, rows, tc):
    """Random host tables and a non-zero accumulator (as after earlier
    steps), so that AdaGrad's rsqrt sees both old and new sums."""
    host = [rng.standard_normal((n, DIM)).astype(np.float32) for n in rows]
    acc = (rng.random(tc.layout.total_rows) * 0.1).astype(np.float32)
    return host, acc


def _dense_query(rng, rows, b, l):
    """[T, B*L] ids and mask: masked entries hold a poisoned id, and the
    first bag of every table is empty."""
    idx = np.stack([rng.integers(0, n, size=b * l) for n in rows]).astype(np.int32)
    mask = rng.random(idx.shape) < 0.7
    mask[:, :l] = False
    idx[~mask] = POISON
    return idx, mask


def _csr_query(rng, rows, b, max_len=6):
    """[T, C] ids and [T, B+1] offsets: empty bags, ragged lengths, and
    padding after offsets[B] poisoned."""
    idxs, offs = [], []
    bags_all = [[rng.integers(0, n, size=rng.integers(0, max_len)).tolist()
                 for _ in range(b)] for n in rows]
    cap = max(sum(map(len, bags)) for bags in bags_all) + 5
    for bags in bags_all:
        idx, off = pack_bags(bags, capacity=cap)
        idx[off[-1]:] = POISON
        idxs.append(idx)
        offs.append(off)
    return np.stack(idxs), np.stack(offs)


def _close(got, want, dtype):
    got = got.float().numpy().reshape(np.shape(want))
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(BF16_TOL if dtype == "bf16" else TOL))


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
@pytest.mark.parametrize("packed,l,dtype", [(False, 1, "f32"), (True, 1, "f32"),
                                            (True, 3, "f32"), (False, 3, "f32"),
                                            (True, 2, "bf16")])
def test_sparse_update_matches(rng, mesh, optimizer, packed, l, dtype):
    b, lr = 8, 0.3
    jc, tc = _colls(mesh, ROWS, packed)
    host, acc = _state(rng, ROWS, tc)
    idx, mask = _dense_query(rng, ROWS, b, l)
    g = rng.standard_normal((b, len(ROWS), DIM)).astype(np.float32)
    jfused = jc.device_put_tables(host)
    tfused = tc.device_put_tables(host)
    if dtype == "bf16":
        jfused, tfused = jfused.astype(jnp.bfloat16), tfused.to(torch.bfloat16)
    want_f, want_a = jsu.sparse_update(
        jc, jfused, jnp.asarray(acc), jnp.asarray(idx), jnp.asarray(mask),
        jnp.asarray(g), lr=lr, optimizer=optimizer)
    got_f, got_a = tsu.sparse_update(
        tc, tfused, torch.from_numpy(acc.copy()), torch.from_numpy(idx),
        torch.from_numpy(mask), torch.from_numpy(g), lr=lr, optimizer=optimizer)
    assert got_f is tfused and got_f.dtype == tfused.dtype  # in place
    _close(got_f, want_f.astype(jnp.float32), dtype)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
@pytest.mark.parametrize("packed", [False, True])
def test_sparse_update_csr_matches(rng, mesh, optimizer, packed):
    b, lr = 9, 0.3
    jc, tc = _colls(mesh, ROWS, packed)
    host, acc = _state(rng, ROWS, tc)
    idx, off = _csr_query(rng, ROWS, b)
    g = rng.standard_normal((b, len(ROWS), DIM)).astype(np.float32)
    want_f, want_a = jsu.sparse_update_csr(
        jc, jc.device_put_tables(host), jnp.asarray(acc), jnp.asarray(idx),
        jnp.asarray(off), jnp.asarray(g), lr=lr, optimizer=optimizer)
    got_f, got_a = tsu.sparse_update_csr(
        tc, tc.device_put_tables(host), torch.from_numpy(acc.copy()),
        torch.from_numpy(idx), torch.from_numpy(off), torch.from_numpy(g), lr=lr,
        optimizer=optimizer)
    _close(got_f, want_f, "f32")
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
def test_poisoned_padding_changes_nothing(rng, optimizer):
    """Padding and masked ids of 1 << 30 give the same bits as padding of
    valid ids, and rows no entry touched keep their bits."""
    tc = TColl.create(_tables(tcfg, ROWS), tcfg.ShardingPolicy.REPLICATE, packed=True,
                      device="cpu")
    host, acc = _state(rng, ROWS, tc)
    idx, off = _csr_query(rng, ROWS, 9)
    g = torch.from_numpy(rng.standard_normal((9, len(ROWS), DIM)).astype(np.float32))
    clean = np.where(idx == POISON, 0, idx)
    outs = []
    for ids in (idx, clean):
        fused, a = tc.device_put_tables(host), torch.from_numpy(acc.copy())
        tsu.sparse_update_csr(tc, fused, a, torch.from_numpy(ids), torch.from_numpy(off),
                              g, lr=0.3, optimizer=optimizer)
        outs.append((fused, a))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    before = torch.from_numpy(tc.fused_host_array(host)).view(-1, DIM)
    touched = np.zeros(tc.layout.total_rows, bool)
    for t, o in enumerate(tc.layout.row_offsets):
        touched[o + idx[t, : off[t, -1]]] = True
    after = outs[0][0].view(-1, DIM)
    assert torch.equal(after[~touched], before[~touched])
    assert not torch.equal(after[touched], before[touched])
    # the dense wire: masked entries with poisoned ids
    didx, dmask = _dense_query(rng, ROWS, 8, 2)
    gd = torch.from_numpy(rng.standard_normal((8, len(ROWS), DIM)).astype(np.float32))
    res = []
    for ids in (didx, np.where(dmask, didx, 0)):
        fused = tc.device_put_tables(host)
        tsu.sparse_update(tc, fused, torch.from_numpy(acc.copy()), torch.from_numpy(ids),
                          torch.from_numpy(dmask), gd, lr=0.3, optimizer=optimizer)
        res.append(fused)
    assert torch.equal(res[0], res[1])


def _capped_kaggle_tables(mod):
    return tuple(mod.TableConfig(num_rows=min(n, ROW_CAP), dim=DIM, name=f"cat_{i}")
                 for i, n in enumerate(mod.KAGGLE_TABLE_ROWS))


@pytest.fixture(scope="module")
def kaggle_hybrid(mesh):
    jh = jhybrid.HybridEmbeddingCollection.create(
        _capped_kaggle_tables(jcfg), mesh, jcfg.ShardingPolicy.REPLICATE)
    th = thybrid.HybridEmbeddingCollection.create(
        _capped_kaggle_tables(tcfg), tcfg.ShardingPolicy.REPLICATE, device="cpu")
    assert len(th.small_ids) == 16 and len(th.big_ids) == 10
    return jh, th


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
@pytest.mark.parametrize("wire", ["dense", "csr"])
def test_sparse_update_hybrid_matches(rng, kaggle_hybrid, optimizer, wire):
    jh, th = kaggle_hybrid
    rows = [t.num_rows for t in th.tables]
    b, lr = 16, 0.2
    host = [rng.standard_normal((n, DIM)).astype(np.float32) for n in rows]
    acc = {k: (rng.random(c.layout.total_rows) * 0.1).astype(np.float32)
           for k, c in (("small", th.small), ("big", th.big))}
    g = rng.standard_normal((b, len(rows), DIM)).astype(np.float32)
    if wire == "dense":
        q = _dense_query(rng, rows, b, 2)
        jfn, tfn = jhybrid.sparse_update_hybrid, thybrid.sparse_update_hybrid
    else:
        q = _csr_query(rng, rows, b, max_len=4)
        jfn, tfn = jhybrid.sparse_update_hybrid_csr, thybrid.sparse_update_hybrid_csr
    want_p, want_a = jfn(jh, jh.device_put_tables(host),
                         {k: jnp.asarray(v) for k, v in acc.items()},
                         *map(jnp.asarray, q), jnp.asarray(g), lr=lr, optimizer=optimizer)
    got_p, got_a, dropped = tfn(
        th, th.device_put_tables(host), {k: torch.from_numpy(v.copy()) for k, v in acc.items()},
        *map(torch.from_numpy, q), torch.from_numpy(g), lr=lr, optimizer=optimizer,
        return_stats=True)
    assert int(dropped) == 0
    for key in ("small", "big"):
        _close(got_p[key], want_p[key], "f32")
        np.testing.assert_allclose(got_a[key].numpy(), np.asarray(want_a[key]), **TOL)


def test_init_accumulator_is_one_f32_per_fused_row():
    tc = TColl.create(_tables(tcfg, ROWS), tcfg.ShardingPolicy.REPLICATE, packed=True,
                      device="cpu")
    acc = tsu.init_accumulator(tc)
    assert acc.shape == (tc.layout.total_rows,) and acc.dtype == torch.float32
    assert not acc.any()
    th = thybrid.HybridEmbeddingCollection.create(
        _tables(tcfg, (3, 24, 583, 1460, 9000, 20000)), device="cpu")
    accs = thybrid.init_accumulator_hybrid(th)
    assert accs["small"].shape == (th.small.layout.total_rows,)
    assert accs["big"].shape == (th.big.layout.total_rows,)


@pytest.mark.parametrize("case", ["routed", "row_policy", "unknown_optimizer"])
def test_unsupported_cases_raise(case):
    policy = (tcfg.ShardingPolicy.ROW if case == "row_policy"
              else tcfg.ShardingPolicy.REPLICATE)
    tc = TColl.create(_tables(tcfg, ROWS), policy, device="cpu")
    fused = tc.init(torch.Generator())
    before = fused.clone()
    idx = torch.zeros(len(ROWS), 4, dtype=torch.int32)
    kw = dict(lr=0.1, optimizer="adam" if case == "unknown_optimizer" else "sgd",
              routed=case == "routed")
    err = {"routed": "ROW/ROW_HASH/TABLE_WISE", "row_policy": "mesh",
           "unknown_optimizer": "optimizer"}[case]
    with pytest.raises(ValueError, match=err):
        tsu.sparse_update(tc, fused, tsu.init_accumulator(tc), idx,
                          torch.ones(idx.shape, dtype=torch.bool),
                          torch.ones(4, len(ROWS), DIM), **kw)
    with pytest.raises(ValueError, match=err):
        tsu.sparse_update_csr(tc, fused, tsu.init_accumulator(tc), idx,
                              torch.tensor([[0, 1, 2, 3, 4]] * len(ROWS), dtype=torch.int32),
                              torch.ones(4, len(ROWS), DIM), **kw)
    assert torch.equal(fused, before)


def test_hybrid_checks_both_sets_before_updating():
    th = thybrid.HybridEmbeddingCollection.create(
        _tables(tcfg, (3, 24, 20000)), tcfg.ShardingPolicy.ROW, device="cpu")
    params = th.init(torch.Generator())
    small = params["small"].clone()
    idx = torch.zeros(3, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="REPLICATE"):
        thybrid.sparse_update_hybrid(
            th, params, thybrid.init_accumulator_hybrid(th), idx,
            torch.ones(3, 4, dtype=torch.bool), torch.ones(4, 3, DIM), lr=0.1)
    assert torch.equal(params["small"], small)
