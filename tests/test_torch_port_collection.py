"""The port's EmbeddingCollection and HybridEmbeddingCollection against the
JAX package's, on one device, with the same tables and queries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.parallel.collection import (
    EmbeddingCollection as JColl,
)
from pim_embedding_lookup_tpu.parallel.hybrid import (
    HybridEmbeddingCollection as JHybrid,
)
from pim_embedding_lookup_tpu_torch.parallel.collection import (
    EmbeddingCollection as TColl,
)
from pim_embedding_lookup_tpu_torch.parallel.hybrid import (
    HybridEmbeddingCollection as THybrid,
)

HYBRID_ROWS = (3, 24, 583, 1460, 9000, 20000)  # 4 small tables, 2 big


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(jcfg.MeshConfig(data=1, model=1))


def _tables(mod, rows, dim):
    return tuple(mod.TableConfig(num_rows=n, dim=dim, name=f"t{i}")
                 for i, n in enumerate(rows))


def _query(rng, rows, b, l):
    idx = np.stack([rng.integers(0, n, size=b * l) for n in rows]).astype(np.int32)
    mask = rng.random(idx.shape) < 0.7
    mask[:, :l] = False  # the first bag of every table is empty
    return idx, mask


def _host_tables(rng, rows, dim):
    return [rng.standard_normal((n, dim)).astype(np.float32) for n in rows]


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("l", [1, 3])
def test_collection_lookup_matches(rng, mesh, combiner, packed, l):
    rows, dim, b = (50, 300, 17), 16, 8
    host = _host_tables(rng, rows, dim)
    idx, mask = _query(rng, rows, b, l)
    jc = JColl.create(_tables(jcfg, rows, dim), mesh,
                      jcfg.ShardingPolicy.REPLICATE, packed=packed)
    want = jc.lookup(jc.device_put_tables(host), jnp.asarray(idx),
                     jnp.asarray(mask), batch_size=b, combiner=combiner)
    tc = TColl.create(_tables(tcfg, rows, dim), tcfg.ShardingPolicy.REPLICATE,
                      packed=packed, device="cpu")
    assert tc.layout.pack == jc.layout.pack
    got = tc.lookup(tc.device_put_tables(host), torch.from_numpy(idx),
                    torch.from_numpy(mask), batch_size=b, combiner=combiner)
    assert got.shape == (b, len(rows), dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("l", [1, 3])
def test_hybrid_lookup_matches(rng, mesh, combiner, l):
    dim, b = 16, 8
    host = _host_tables(rng, HYBRID_ROWS, dim)
    idx, mask = _query(rng, HYBRID_ROWS, b, l)
    jh = JHybrid.create(_tables(jcfg, HYBRID_ROWS, dim), mesh,
                        jcfg.ShardingPolicy.REPLICATE)
    want = jh.lookup(jh.device_put_tables(host), jnp.asarray(idx),
                     jnp.asarray(mask), batch_size=b, combiner=combiner)
    th = THybrid.create(_tables(tcfg, HYBRID_ROWS, dim),
                        tcfg.ShardingPolicy.REPLICATE, device="cpu")
    assert (th.small_ids, th.big_ids, th.perm, th.buckets) == (
        jh.small_ids, jh.big_ids, jh.perm, jh.buckets)
    assert len(th.small_ids) == 4 and th.big.layout.pack == 8
    params = th.device_put_tables(host)
    jparams = jh.device_put_tables(host)
    for key in ("small", "big"):
        np.testing.assert_array_equal(params[key].numpy(), np.asarray(jparams[key]))
    got = th.lookup(params, torch.from_numpy(idx), torch.from_numpy(mask),
                    batch_size=b, combiner=combiner)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_hybrid_small_set_is_bf16_rounded(rng):
    """The small set pools f32(bf16(w[id])), as the JAX package does."""
    dim, b = 16, 4
    host = _host_tables(rng, HYBRID_ROWS, dim)
    th = THybrid.create(_tables(tcfg, HYBRID_ROWS, dim), device="cpu")
    idx, _ = _query(rng, HYBRID_ROWS, b, 1)
    mask = np.ones_like(idx, dtype=bool)
    got = th.lookup(th.device_put_tables(host), torch.from_numpy(idx),
                    torch.from_numpy(mask), batch_size=b)
    for t in th.small_ids:
        w = torch.from_numpy(host[t][idx[t]]).to(torch.bfloat16).float()
        torch.testing.assert_close(got[:, t], w, rtol=0, atol=0)
    for t in th.big_ids:
        torch.testing.assert_close(got[:, t], torch.from_numpy(host[t][idx[t]]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("policy", ["replicate", "row_hash", "table_wise"])
@pytest.mark.parametrize("packed", [False, "auto"])
def test_fused_host_array_round_trip(rng, policy, packed):
    rows, dim = (50, 300, 17), 16
    host = _host_tables(rng, rows, dim)
    tc = TColl.create(_tables(tcfg, rows, dim), tcfg.ShardingPolicy(policy),
                      packed=packed, device="cpu")
    fused = tc.fused_host_array(host)
    assert fused.shape == (tc.layout.storage_rows, tc.layout.storage_width)
    for a, b in zip(tc.unfuse_host(torch.from_numpy(fused)), host):
        np.testing.assert_array_equal(a, b)


def test_fused_host_array_matches_jax(rng, mesh):
    rows, dim = HYBRID_ROWS, 16
    host = _host_tables(rng, rows, dim)
    jc = JColl.create(_tables(jcfg, rows, dim), mesh, packed="auto")
    tc = TColl.create(_tables(tcfg, rows, dim), packed="auto", device="cpu")
    np.testing.assert_array_equal(tc.fused_host_array(host),
                                  jc.fused_host_array(host))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_within_table_bounds(dtype):
    rows, dim = (3, 70, 1000), 16
    tc = TColl.create(_tables(tcfg, rows, dim), packed=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    fused = tc.init(gen, dtype)
    assert fused.dtype == dtype
    assert fused.shape == (tc.layout.storage_rows, tc.layout.storage_width)
    for w, n in zip(tc.unfuse_host(fused), rows):
        bound = 1.0 / np.sqrt(n)
        # bf16 rounds to its nearest value, at most half an ulp past the bound
        slack = bound * 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
        assert np.abs(w).max() <= bound + slack
        assert np.abs(w).max() > 0.5 * bound  # drawn, not left at zero


def test_other_policies_raise_not_implemented(rng):
    """Without a mesh a sharded policy is refused, with or without grad
    (autodiff through a sharded lookup runs on a mesh:
    ``test_torch_port_mesh.py``)."""
    tc = TColl.create(_tables(tcfg, (40, 50), 16), tcfg.ShardingPolicy.ROW,
                      device="cpu")
    idx, mask = _query(rng, (40, 50), 4, 1)
    q = torch.from_numpy(idx), torch.from_numpy(mask)
    with pytest.raises(ValueError, match="mesh"):
        tc.lookup(tc.init(torch.Generator()).requires_grad_(True), *q, batch_size=4)
    with pytest.raises(ValueError, match="mesh"):
        tc.lookup(tc.init(torch.Generator()), *q, batch_size=4)
