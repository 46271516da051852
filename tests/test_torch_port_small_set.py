"""The hybrid's small set on the dense wire against the JAX package's on the
CPU.  The port pools it with K1 over its fused rows, each element rounded
to bf16 as it is added (``embedding_bag_fixedl(..., round_bf16=True)``);
the JAX package pools each bucket as a bf16 one-hot product.  The small
tables hold f32 values that bf16 does not represent, so the rounding
shows: at L=1 the small set's pooled rows equal JAX's bit for bit, and
bags of 3 with masked entries agree at the lookups' tolerance (f32 sums in
another order).  Under autograd the small storage's gradient is held
against the one-hot product's (each entry's cotangent rounded to bf16,
each row's sum rounded to bf16), bit for bit, at the lookup and through a
dense-autodiff train step."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.parallel.hybrid import HybridEmbeddingCollection as JHybrid
from pim_embedding_lookup_tpu_torch.models import DLRM as TDLRM
from pim_embedding_lookup_tpu_torch.models import train as ttrain
from pim_embedding_lookup_tpu_torch.parallel import collection as collection_mod
from pim_embedding_lookup_tpu_torch.parallel import hybrid as hybrid_mod
from pim_embedding_lookup_tpu_torch.parallel.collection import _NEG_INF, _finish_combiner
from pim_embedding_lookup_tpu_torch.parallel.hybrid import HybridEmbeddingCollection as THybrid

ROWS = (3, 24, 583, 1460, 9000, 20000)  # 4 small tables in 3 buckets, 2 big
DIM, B = 16, 8
TOL = dict(rtol=1e-5, atol=1e-5)  # the lookups' tolerance against the JAX package
COMBINERS = ["sum", "mean", "max"]


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jcfg.MeshConfig(data=1, model=1))


def _tables(mod, rows=ROWS):
    return tuple(mod.TableConfig(num_rows=n, dim=DIM, name=f"t{i}") for i, n in enumerate(rows))


def _host(rng, rows=ROWS):
    """f32 tables of which almost no value is a bf16 value."""
    host = [rng.standard_normal((n, DIM)).astype(np.float32) for n in rows]
    small = np.concatenate([h.reshape(-1) for h in host[:4]])
    assert (torch.from_numpy(small).to(torch.bfloat16).float().numpy() != small).mean() > 0.99
    return host


def _query(rng, l, keep, rows=ROWS):
    """[T, B*L] valid ids (the JAX package reads masked ones too) and a
    mask; the first bag of every table is empty where ``keep`` < 1."""
    idx = np.stack([rng.integers(0, n, size=B * l) for n in rows]).astype(np.int32)
    mask = rng.random(idx.shape) < keep
    if keep < 1:
        mask[:, :l] = False
    return idx, mask


def _both(mesh, quantized):
    kw = dict(quantized_big=True) if quantized else {}
    th = THybrid.create(_tables(tcfg), tcfg.ShardingPolicy.REPLICATE, device="cpu", **kw)
    jh = JHybrid.create(_tables(jcfg), mesh, jcfg.ShardingPolicy.REPLICATE, **kw)
    assert (th.small_ids, th.buckets) == (jh.small_ids, jh.buckets)
    assert th.small_ids == (0, 1, 2, 3) and th._big_quantized == quantized
    return th, jh


def _lookups(th, jh, host, idx, mask, combiner):
    got = th.lookup(th.device_put_tables(host), torch.from_numpy(idx),
                    torch.from_numpy(mask), batch_size=B, combiner=combiner)
    want = jh.lookup(jh.device_put_tables(host), jnp.asarray(idx), jnp.asarray(mask),
                     batch_size=B, combiner=combiner)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32-big", "int8-big"])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_small_set_equals_jax_bitwise_at_l1(rng, mesh, combiner, quantized):
    """Single-hot bags, some masked: the small tables' pooled rows are
    JAX's one-hot products' bit for bit, f32(bf16(w[id])), and not the f32
    rows; the big set's agree at the lookups' tolerance."""
    host = _host(rng)
    th, jh = _both(mesh, quantized)
    idx, mask = _query(rng, 1, 0.7)
    got, want = _lookups(th, jh, host, idx, mask, combiner)
    small = list(th.small_ids)
    np.testing.assert_array_equal(got[:, small], want[:, small])
    np.testing.assert_allclose(got, want, **TOL)
    for t in small:
        kept = mask[t]
        w = host[t][idx[t][kept]]
        rounded = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(got[kept, t], rounded)
        assert (got[kept, t] != w).any()
        np.testing.assert_array_equal(got[~kept, t], 0.0)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32-big", "int8-big"])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_small_set_bags_match_jax(rng, mesh, combiner, quantized):
    """Bags of 3 with a tenth to a half of their entries masked, and an
    empty first bag in every table."""
    host = _host(rng)
    th, jh = _both(mesh, quantized)
    idx, mask = _query(rng, 3, 0.6)
    got, want = _lookups(th, jh, host, idx, mask, combiner)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[0], 0.0)


@pytest.mark.parametrize("combiner", COMBINERS)
def test_small_set_is_k1_with_rounding(rng, combiner):
    """The small set calls K1's wrapper with ``round_bf16`` (SUM and MEAN:
    one call over all its tables; MAX: one gather a table, pooling 1), the
    big set without it, and the one-hot product is not made."""
    host = _host(rng)
    th = THybrid.create(_tables(tcfg), tcfg.ShardingPolicy.REPLICATE, device="cpu")
    idx, mask = _query(rng, 2, 0.8)
    real = collection_mod.embedding_bag_fixedl
    with mock.patch.object(collection_mod, "embedding_bag_fixedl", wraps=real) as k1, \
            mock.patch.object(hybrid_mod, "_bucket_entry_rows") as onehot:
        th.lookup(th.device_put_tables(host), torch.from_numpy(idx), torch.from_numpy(mask),
                  batch_size=B, combiner=combiner)
    onehot.assert_not_called()
    rounded = [c.kwargs for c in k1.call_args_list if c.kwargs.get("round_bf16")]
    plain = [c.kwargs for c in k1.call_args_list if not c.kwargs.get("round_bf16")]
    if combiner == "max":
        assert [kw["pooling"] for kw in rounded] == [1] * 4 and plain == []
    else:
        assert [(kw["pooling"], kw["batch_size"]) for kw in rounded] == [(2, 4 * B)]
        assert [(kw["pooling"], kw["batch_size"]) for kw in plain] == [(2, 2 * B)]


# -- the gradient: the one-hot product's --------------------------------------------


def _product_lookup(fused, buckets, indices, mask, *, batch_size, combiner):
    """The small set as the bf16 one-hot products (``_bucket_entry_rows``,
    which the CSR wire keeps), pooled per bucket: the port's dense-wire
    small set before it took K1, the formula the gradient is held to."""
    pooling = indices.shape[1] // batch_size
    outs = []
    for bucket in buckets:
        rows, mk = hybrid_mod._bucket_entry_rows(fused, bucket, indices, mask)
        g, _, d = rows.shape
        rows = rows.reshape(g, batch_size, pooling, d)
        if combiner == "max":
            rows = torch.where(mk.reshape(g, batch_size, pooling, 1), rows, _NEG_INF)
            outs.append(rows.amax(dim=2))
        else:
            outs.append(rows.sum(dim=2))
    pooled = torch.cat(outs, dim=0).transpose(0, 1)
    if combiner == "sum":
        return pooled
    return _finish_combiner(combiner, pooling, pooled, mask)


def _rounded_sum_grad(th, idx, mask, g_small, rows):
    """SUM's small-storage gradient written out: each kept entry's bag
    cotangent rounded to bf16, added at its fused row in f32, each row's
    sum rounded to bf16."""
    l = idx.shape[1] // B
    offs = th.small.layout.row_offsets
    grad = torch.zeros(rows, DIM)
    for k, t in enumerate(th.small_ids):
        for e in np.flatnonzero(mask[t]):
            grad[offs[k] + idx[t, e]] += g_small[e // l, k].to(torch.bfloat16).float()
    return grad.to(torch.bfloat16).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 3])
@pytest.mark.parametrize("combiner", COMBINERS)
def test_small_set_gradient_is_the_products(rng, combiner, l, dtype):
    """The small storage's gradient through the hybrid's lookup equals the
    one-hot product's autograd bit for bit, in f32 and bf16 storage; for
    SUM also the formula written out."""
    host = _host(rng)
    th = THybrid.create(_tables(tcfg), tcfg.ShardingPolicy.REPLICATE, device="cpu")
    params = th.device_put_tables(host)
    small = params["small"].to(dtype)
    idx, mask = _query(rng, l, 0.7)
    g = torch.from_numpy(rng.standard_normal((B, 4, DIM)).astype(np.float32))
    sel = list(th.small_ids)  # the first 4 tables: their columns of the lookup
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    grads = []
    for fn in (lambda s: th.lookup({"small": s, "big": params["big"]}, ti, tm,
                                   batch_size=B, combiner=combiner)[:, sel],
               lambda s: _product_lookup(s, th.buckets, ti[sel], tm[sel], batch_size=B,
                                         combiner=combiner)):
        s = small.clone().requires_grad_(True)
        (fn(s) * g).sum().backward()
        assert s.grad.dtype == dtype
        grads.append(s.grad)
    assert torch.equal(grads[0], grads[1])
    assert grads[0].abs().max() > 0
    if combiner == "sum":
        want = _rounded_sum_grad(th, idx, mask, g, small.shape[0])
        assert torch.equal(grads[0].float(), want)


@pytest.mark.parametrize("kind", ["sgd", "adagrad"])
def test_dense_autodiff_small_update_is_the_products(rng, kind):
    """Two dense-autodiff steps (``models/train.py``) on a hybrid DLRM, bags
    of 2: the small table moves exactly as with the one-hot product in the
    small set's place, and so does every other tensor."""
    cfg = tcfg.DLRMConfig(dense_dim=13, mlp_bot=(32, 16), mlp_top=(32, 1),
                          tables=_tables(tcfg))
    batches = []
    for _ in range(2):
        idx, mask = _query(rng, 2, 0.8)
        batches.append([torch.from_numpy(a) for a in (
            rng.random((B, 13), dtype=np.float32), idx, mask,
            (rng.random(B) < 0.5).astype(np.float32))])
    models = []
    for product in (False, True):
        model = TDLRM(cfg, tcfg.ShardingPolicy.REPLICATE, hybrid=True, device="cpu",
                      generator=torch.Generator().manual_seed(4))
        coll = model.collection

        def onehot(small, fused, indices, mask, *, batch_size, combiner):
            return _product_lookup(fused, coll.buckets, indices, mask,
                                   batch_size=batch_size, combiner=combiner)

        step = ttrain.make_train_step(model, ttrain.make_optimizer(lr=0.1, kind=kind))
        with mock.patch.object(hybrid_mod, "_small_pooled_lookup",
                               onehot if product else hybrid_mod._small_pooled_lookup):
            for batch in batches:
                step(*batch)
        models.append(model)
    got, want = (dict(m.named_buffers()) | dict(m.named_parameters()) for m in models)
    assert got.keys() == want.keys() and "emb_small" in got
    for name in got:
        assert torch.equal(got[name], want[name]), name
    init = TDLRM(cfg, tcfg.ShardingPolicy.REPLICATE, hybrid=True, device="cpu",
                 generator=torch.Generator().manual_seed(4))
    assert not torch.equal(got["emb_small"], init.emb_small)
