"""The per-shard bodies of the port's sharded lookups, with no process
group: each model shard s of M = 4 pools from its own part of the storage
(a row shard the entries it owns, through K1 or K2 with the ownership mask;
a COLUMN shard its dim slice), the partials are reduced by hand (summed, or
maxed for MAX; COLUMN's slices concatenated) and finished, and the result is
held against the JAX collection's lookup on a (data=1, model=4) mesh.  Every
policy, sum/mean/max, packed and unpacked storage, both wires.  These are
the bodies that a process runs on a mesh between its collectives.

Tolerance: rtol 1e-5 / atol 1e-6, the partials add in another order than
the JAX package's sum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu.ops.ragged import shard_csr
from pim_embedding_lookup_tpu.parallel import make_mesh
from pim_embedding_lookup_tpu.parallel.collection import EmbeddingCollection as JColl
from pim_embedding_lookup_tpu_torch.parallel.collection import (
    EmbeddingCollection as TColl,
    _csr_finish,
    _csr_local_pool,
    _csr_rowshard_pool,
    _finish_combiner,
    _local_pooled_lookup,
    _rowshard_pooled_lookup,
    shard_storage,
)
from pim_embedding_lookup_tpu_torch.parallel.planner import plan

M = 4
ROWS = (100, 1000, 37, 4000)  # the last shard holds padding rows
DIM = 16
B, L = 12, 3
POISON = 1 << 30  # CSR padding ids: out of every shard's range
TOL = dict(rtol=1e-5, atol=1e-6)
POLICIES = ("replicate", "row", "row_hash", "column", "table_wise")
LAYOUTS = [(p, packed) for p in POLICIES for packed in (False, True)
           if not (p == "column" and packed)]  # COLUMN refuses packing


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(jcfg.MeshConfig(data=1, model=M))


def _tables(mod):
    return tuple(mod.TableConfig(num_rows=n, dim=DIM, name=f"t{i}") for i, n in enumerate(ROWS))


def _inputs(seed):
    """Tables, a dense-wire query (multi-hot, masked, a few bags with every
    entry masked) and a CSR query (ragged, empty bags, POISON padding)."""
    rng = np.random.default_rng(seed)
    host = [rng.standard_normal((n, DIM)).astype(np.float32) for n in ROWS]
    idx = np.stack([rng.integers(0, n, B * L) for n in ROWS]).astype(np.int32)
    mask = rng.random(idx.shape) < 0.7
    mask[:, :L] = False  # bag 0 of every table: nothing kept
    bags = [[rng.integers(0, n, size=rng.integers(0, 5)).tolist() for _ in range(B)]
            for n in ROWS]
    cidx, coff = shard_csr(bags, 1, 8 * B, pad_index=POISON)
    return host, idx, mask, cidx, coff


def _port_shards(policy, packed, host):
    """The port's collection planned over M shards, and each shard's
    storage cut from the global fused array."""
    tc = TColl(plan(_tables(tcfg), M, tcfg.ShardingPolicy(policy), packed),
               torch.device("cpu"))
    fused = tc.fused_host_array(host)
    shards = [torch.from_numpy(np.ascontiguousarray(shard_storage(tc.layout, s, fused)))
              for s in range(M)]
    return tc, shards


def _reduce(parts, combiner):
    stacked = torch.stack(parts)
    return stacked.amax(dim=0) if combiner == "max" else stacked.sum(dim=0)


def _rowshard_kw(lay, s):
    return dict(shard=s, num_shards=M, rows_per_shard=lay.rows_per_shard,
                strided=lay.policy == tcfg.ShardingPolicy.ROW_HASH)


def _dense_port(tc, shards, idx, mask, combiner):
    lay = tc.layout
    g = tc.globalize(torch.from_numpy(idx))
    keep = torch.from_numpy(mask)
    if lay.policy == tcfg.ShardingPolicy.COLUMN:
        pooled = torch.cat([_local_pooled_lookup(st, DIM // M, g, keep, L, combiner)
                            for st in shards], dim=2)
    elif lay.policy == tcfg.ShardingPolicy.REPLICATE:
        outs = [_local_pooled_lookup(st, DIM, g, keep, L, combiner) for st in shards]
        assert all(torch.equal(o, outs[0]) for o in outs)
        pooled = outs[0]
    else:
        pooled = _reduce([_rowshard_pooled_lookup(st, DIM, g, keep, L, combiner,
                                                  **_rowshard_kw(lay, s))
                          for s, st in enumerate(shards)], combiner)
    return pooled if combiner == "sum" else _finish_combiner(combiner, L, pooled, keep)


def _csr_port(tc, shards, cidx, coff, combiner):
    lay = tc.layout
    g = tc.globalize(torch.from_numpy(cidx)).contiguous()
    off = torch.from_numpy(coff)
    if lay.policy == tcfg.ShardingPolicy.COLUMN:
        pooled = torch.cat([_csr_local_pool(st, DIM // M, g, off, B, combiner)
                            for st in shards], dim=2)
    elif lay.policy == tcfg.ShardingPolicy.REPLICATE:
        outs = [_csr_local_pool(st, DIM, g, off, B, combiner) for st in shards]
        assert all(torch.equal(o, outs[0]) for o in outs)
        pooled = outs[0]
    else:
        pooled = _reduce([_csr_rowshard_pool(st, DIM, g, off, B, combiner,
                                             **_rowshard_kw(lay, s))
                          for s, st in enumerate(shards)], combiner)
    return _csr_finish(combiner, pooled, off)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("wire", ["dense", "csr"])
@pytest.mark.parametrize("policy,packed", LAYOUTS)
def test_shard_bodies_match_jax(jmesh, policy, packed, wire, combiner):
    host, idx, mask, cidx, coff = _inputs(POLICIES.index(policy) + 10 * packed)
    tc, shards = _port_shards(policy, packed, host)
    jc = JColl.create(_tables(jcfg), jmesh, jcfg.ShardingPolicy(policy), packed=packed)
    assert (tc.layout.storage_rows, tc.layout.storage_width, tc.layout.rows_per_shard) == (
        jc.layout.storage_rows, jc.layout.storage_width, jc.layout.rows_per_shard)
    jf = jc.device_put_tables(host)
    if wire == "dense":
        want = jc.lookup(jf, jnp.asarray(idx), jnp.asarray(mask), batch_size=B,
                         combiner=combiner)
        got = _dense_port(tc, shards, idx, mask, combiner)
    else:
        want = jc.lookup_csr(jf, jnp.asarray(cidx), jnp.asarray(coff), combiner=combiner)
        got = _csr_port(tc, shards, cidx, coff, combiner)
    assert got.shape == (B, len(ROWS), DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("wire", ["dense", "csr"])
@pytest.mark.parametrize("policy", ["row", "row_hash", "table_wise"])
def test_row_shard_never_reads_dropped_entries(policy, wire):
    """Masked entries (dense) and padding (CSR) that point at a NaN row of
    the shard itself pool to the same finite partial as before: a dropped
    entry's row is never read, not multiplied by 0."""
    host, idx, mask, cidx, coff = _inputs(7)
    tc, shards = _port_shards(policy, True, host)
    lay, s = tc.layout, 1
    kw = _rowshard_kw(lay, s)
    owned = [f for f in range(lay.total_rows)
             if (f % M if kw["strided"] else f // lay.rows_per_shard) == s]
    f = owned[len(owned) // 2]  # a fused row of shard s
    local = f // M if kw["strided"] else f - s * lay.rows_per_shard
    poisoned = shards[s].clone()
    poisoned.view(-1, DIM)[local] = float("nan")
    if wire == "dense":
        g = tc.globalize(torch.from_numpy(idx))
        keep = torch.from_numpy(mask) & (g != f)
        g = torch.where(keep, g, f)
        part = lambda st: _rowshard_pooled_lookup(st, DIM, g, keep, L, "sum", **kw)  # noqa: E731
    else:
        g = tc.globalize(torch.from_numpy(cidx))
        off = torch.from_numpy(coff)
        g = torch.where(torch.arange(g.shape[1])[None, :] >= off[:, -1:], f, g).contiguous()
        assert (g[torch.arange(g.shape[1])[None, :] < off[:, -1:]] != f).all()
        part = lambda st: _csr_rowshard_pool(st, DIM, g, off, B, "sum", **kw)  # noqa: E731
    got = part(poisoned)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, part(shards[s]), rtol=0, atol=0)


LONG_L = 40  # past a 32-id window and a by-group round: the compacted walk's edges


@pytest.mark.parametrize("wire", ["dense", "csr"])
@pytest.mark.parametrize("packed", [False, True])
def test_row_hash_long_bags_match_jax(jmesh, packed, wire):
    """ROW_HASH's shard bodies over long bags (L = 40 on the dense wire, 32
    to 48 ids a CSR bag), where each shard owns about 1 entry in 4 and its
    kernel drops the rest before its row loads: summed, equal to the JAX
    collection's lookup on the (1, 4) mesh."""
    rng = np.random.default_rng(20 + packed)
    host = [rng.standard_normal((n, DIM)).astype(np.float32) for n in ROWS]
    tc, shards = _port_shards("row_hash", packed, host)
    jc = JColl.create(_tables(jcfg), jmesh, jcfg.ShardingPolicy.ROW_HASH, packed=packed)
    jf = jc.device_put_tables(host)
    lay = tc.layout
    if wire == "dense":
        idx = np.stack([rng.integers(0, n, B * LONG_L) for n in ROWS]).astype(np.int32)
        mask = rng.random(idx.shape) < 0.7
        want = jc.lookup(jf, jnp.asarray(idx), jnp.asarray(mask), batch_size=B)
        g = tc.globalize(torch.from_numpy(idx))
        keep = torch.from_numpy(mask)
        got = _reduce([_rowshard_pooled_lookup(st, DIM, g, keep, LONG_L, "sum",
                                               **_rowshard_kw(lay, s))
                       for s, st in enumerate(shards)], "sum")
    else:
        bags = [[rng.integers(0, n, size=rng.integers(32, 49)).tolist() for _ in range(B)]
                for n in ROWS]
        cidx, coff = shard_csr(bags, 1, 48 * B + 8, pad_index=POISON)
        want = jc.lookup_csr(jf, jnp.asarray(cidx), jnp.asarray(coff))
        g = tc.globalize(torch.from_numpy(cidx)).contiguous()
        off = torch.from_numpy(coff)
        got = _reduce([_csr_rowshard_pool(st, DIM, g, off, B, "sum", **_rowshard_kw(lay, s))
                       for s, st in enumerate(shards)], "sum")
    assert got.shape == (B, len(ROWS), DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
