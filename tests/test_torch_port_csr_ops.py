"""The port's ragged (CSR) helpers, length-bucket planner and packer, plain
lookup ops and the ``embedding_bag`` facade against the JAX package's, on
the same numpy inputs."""

import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import pim_embedding_lookup_tpu.ops as jops
import pim_embedding_lookup_tpu.ops.ragged as jragged
import pim_embedding_lookup_tpu_torch.ops as tops
import pim_embedding_lookup_tpu_torch.ops.ragged as tragged
import pim_embedding_lookup_tpu_torch.utils.native as tnative
from pim_embedding_lookup_tpu.config import Combiner as JCombiner
from pim_embedding_lookup_tpu.config import LookupImpl as JImpl
from pim_embedding_lookup_tpu_torch.config import Combiner as TCombiner
from pim_embedding_lookup_tpu_torch.config import LookupImpl as TImpl
from torch_port_native_lib import (  # noqa: F401
    force_native,
    native_build,
    native_lib,
    native_so,
)

TOL = dict(rtol=1e-5, atol=1e-5)

# offsets [B+1] with empty bags at the start, middle and end, and a last
# boundary equal to the capacity (8)
OFFSET_CASES = {
    "plain": [0, 2, 5, 6],
    "empty_first": [0, 0, 3, 4],
    "empty_middle": [0, 2, 2, 2, 5],
    "empty_last": [0, 3, 5, 5],
    "full_buffer": [0, 3, 5, 8],
    "all_empty": [0, 0, 0],
    "full_then_empty": [0, 8, 8],
}


def _bags(rng, b, n, max_len=9, empty_rate=0.2):
    return [[] if rng.random() < empty_rate
            else rng.integers(0, n, size=int(rng.integers(1, max_len))).tolist()
            for _ in range(b)]


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- ragged helpers ---------------------------------------------------------


@pytest.mark.parametrize("case", list(OFFSET_CASES))
def test_segment_ids_match_jax(case):
    off = np.asarray(OFFSET_CASES[case], np.int32)
    want = np.asarray(jragged.segment_ids_from_offsets(jnp.asarray(off), 8))
    got = tragged.segment_ids_from_offsets(_t(off), 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_ids_batched_match_jax_per_row(rng):
    """[T, B+1] offsets give one row of segment ids per table."""
    t, b, cap = 4, 12, 60
    bags = [_bags(rng, b, 50) for _ in range(t)]
    _, off = jragged.shard_csr(bags, 1, cap)
    got = tragged.segment_ids_from_offsets(_t(off), cap).numpy()
    for ti in range(t):
        want = jragged.segment_ids_from_offsets(jnp.asarray(off[ti]), cap)
        np.testing.assert_array_equal(got[ti], np.asarray(want))


def test_pack_bags_and_shard_csr_match_jax(rng):
    bags = _bags(rng, 10, 40)
    for a, b in zip(tragged.pack_bags(bags, 64, pad_index=3),
                    jragged.pack_bags(bags, 64, pad_index=3)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        tragged.pack_bags([[1, 2, 3]], 2)
    per_table = [_bags(rng, 8, 30) for _ in range(3)]
    for shards in (1, 2, 4):
        for a, b in zip(tragged.shard_csr(per_table, shards, 40),
                        jragged.shard_csr(per_table, shards, 40)):
            np.testing.assert_array_equal(a, b)


def test_dense_csr_round_trip_matches_jax(rng):
    dense = rng.integers(0, 100, size=(6, 3)).astype(np.int32)
    for a, b in zip(tragged.dense_to_csr(_t(dense)),
                    jragged.dense_to_csr(jnp.asarray(dense))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    idx, off = jragged.pack_bags(_bags(rng, 7, 50), 40, pad_index=5)
    for max_len in (1, 4, 9):
        got = tragged.csr_to_dense(_t(idx), _t(off), max_len, pad_index=-1)
        want = jragged.csr_to_dense(jnp.asarray(idx), jnp.asarray(off), max_len,
                                    pad_index=-1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tragged.bag_lengths(_t(off)).numpy(),
        np.asarray(jragged.bag_lengths(jnp.asarray(off))))


# -- length buckets ---------------------------------------------------------


def _ragged_tables(rng, rows, b, max_len=12, empty_rate=0.15):
    """The mixture of tests/test_bucketed_csr.py: empties, short bags and
    bags longer than the largest bucket."""
    bags = []
    for n in rows:
        tb = []
        for _ in range(b):
            r = rng.random()
            k = (0 if r < empty_rate else int(rng.integers(1, 5)) if r < 0.8
                 else int(rng.integers(5, max_len)))
            tb.append(rng.integers(0, n, size=k).tolist())
        bags.append(tb)
    return bags


def _assert_packed_equal(p, q):
    assert p.identity == q.identity
    assert dataclasses.asdict(p.plan) == dataclasses.asdict(q.plan)
    for a, b in zip(p.idx + p.mask + p.pos, q.idx + q.mask + q.pos):
        np.testing.assert_array_equal(a, b)
    for a, b in ((p.tail_idx, q.tail_idx), (p.tail_off, q.tail_off),
                 (p.tail_pos, q.tail_pos)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bucket_ls,slack", [
    ((1, 2, 4), 1.2), ((1, 4), 1.5), ((1, 2, 4, 8), 1.0), ((2,), 1.3),
])
def test_bucket_plan_and_pack_match_jax(bucket_ls, slack):
    rng = np.random.default_rng(11)
    b = 40
    idx, off = jragged.shard_csr(_ragged_tables(rng, (100, 3000, 37), b), 1, 16 * b)
    tplan = tragged.plan_length_buckets(off, bucket_ls=bucket_ls, slack=slack)
    jplan = jragged.plan_length_buckets(off, bucket_ls=bucket_ls, slack=slack)
    assert dataclasses.asdict(tplan) == dataclasses.asdict(jplan)
    _assert_packed_equal(
        tragged.pack_length_buckets(idx, off, tplan),
        jragged.pack_length_buckets(idx, off, jplan, impl="numpy"))


def test_bucket_pack_identity_and_spill_match_jax():
    rng = np.random.default_rng(12)
    b = 32
    single = [[[int(rng.integers(0, 50))] for _ in range(b)] for _ in range(3)]
    idx, off = jragged.shard_csr(single, 1, b)
    plan = tragged.plan_length_buckets(off, bucket_ls=(1, 2), slack=1.0)
    packed = tragged.pack_length_buckets(idx, off, plan)
    assert packed.identity
    _assert_packed_equal(packed, jragged.pack_length_buckets(
        idx, off, jragged.plan_length_buckets(off, bucket_ls=(1, 2), slack=1.0),
        impl="numpy"))
    # a plan made on a lighter batch: bucket 1 overflows and spills upward
    ragged = _ragged_tables(rng, (50, 60, 70), b)
    idx2, off2 = jragged.shard_csr(ragged, 1, 16 * b)
    light = dataclasses.replace(
        tragged.plan_length_buckets(off2, bucket_ls=(1, 2, 4), slack=1.5),
        capacities=(8, 16, 24))
    _assert_packed_equal(
        tragged.pack_length_buckets(idx2, off2, light),
        jragged.pack_length_buckets(idx2, off2, jragged.LengthBucketPlan(
            **dataclasses.asdict(light)), impl="numpy"))


def test_bucket_pack_errors(monkeypatch, native_build):
    off = np.zeros((2, 9), np.int64)
    off[:, 1:] = np.cumsum(np.ones((2, 8)), axis=1)
    idx = np.zeros((2, 8), np.int32)
    plan = tragged.plan_length_buckets(off, bucket_ls=(1,), slack=1.0)
    for impl in ("numpy", "native", "auto"):
        with pytest.raises(ValueError, match="plan batch"):
            tragged.pack_length_buckets(idx[:, :4], off[:, :5], plan, impl=impl)
    # the native packer where its library is built, byte-identical to numpy;
    # forced absent, asking for it raises
    if native_build is not None:
        monkeypatch.setattr(tnative, "_LIB", tnative._declare(ctypes.CDLL(native_build)))
        _assert_packed_equal(tragged.pack_length_buckets(idx, off, plan, impl="native"),
                             tragged.pack_length_buckets(idx, off, plan, impl="numpy"))
    monkeypatch.setattr(tnative, "_LIB", False)
    with pytest.raises(RuntimeError, match="make -C native"):
        tragged.pack_length_buckets(idx, off, plan, impl="native")
    heavy = np.zeros((2, 9), np.int64)
    heavy[:, 1:] = np.cumsum(np.full((2, 8), 3), axis=1)
    with pytest.raises(ValueError, match="overflow"):
        tragged.pack_length_buckets(np.zeros((2, 24), np.int32), heavy, plan)
    with pytest.raises(ValueError, match="positive"):
        tragged.plan_length_buckets(off, bucket_ls=(0, 2))


def test_native_bucket_pack_matches_jax_native(force_native):
    """The port's native packer against the JAX package's ``impl="native"``
    (tests/test_bucketed_csr.py's parity): random ragged batches with
    empty bags, spill into larger buckets and the tail, then the identity
    case; and the same bytes as the numpy packer."""
    rng = np.random.default_rng(7)
    cases = []
    for _ in range(12):
        b = int(rng.integers(4, 120))
        idx, off = jragged.shard_csr(_ragged_tables(rng, (100, 3000, 37), b), 1, 16 * b)
        plan = tragged.plan_length_buckets(off, bucket_ls=(1, 2, 4),
                                           slack=float(rng.uniform(1.0, 1.6)))
        cases.append((idx, off, plan))
    idx, off = jragged.shard_csr(_ragged_tables(rng, (50, 60, 70), 32), 1, 512)
    cases.append((idx, off, dataclasses.replace(  # a lighter batch's plan: spills
        tragged.plan_length_buckets(off, bucket_ls=(1, 2, 4), slack=1.5),
        capacities=(8, 16, 24))))
    single = np.ones((3, 64), np.int64)
    off = np.zeros((3, 65), np.int64)
    np.cumsum(single, axis=1, out=off[:, 1:])
    idx = rng.integers(0, 50, size=(3, 64)).astype(np.int32)
    cases.append((idx, off, tragged.plan_length_buckets(off, bucket_ls=(1, 2), slack=1.0)))
    for idx, off, plan in cases:
        got = tragged.pack_length_buckets(idx, off, plan, impl="native")
        _assert_packed_equal(got, jragged.pack_length_buckets(
            idx, off, jragged.LengthBucketPlan(**dataclasses.asdict(plan)), impl="native"))
        _assert_packed_equal(got, tragged.pack_length_buckets(idx, off, plan, impl="numpy"))
    assert got.identity


# -- plain lookup ops -------------------------------------------------------


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_embedding_bag_csr_matches_jax(rng, combiner):
    n, d, b = 300, 16, 24
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx, off = jragged.pack_bags(_bags(rng, b, n), b * 9, pad_index=7)
    want = jops.embedding_bag_csr(jnp.asarray(table), jnp.asarray(idx),
                                  jnp.asarray(off), batch_size=b,
                                  combiner=JCombiner(combiner))
    got = tops.embedding_bag_csr(_t(table), _t(idx), _t(off), batch_size=b,
                                 combiner=TCombiner(combiner))
    assert got.shape == (b, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_bag_dense_matches_jax(rng, combiner, masked):
    n, d, b, l = 200, 8, 12, 4
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, l)).astype(np.int32)
    mask = rng.random((b, l)) < 0.6 if masked else None
    if masked:
        mask[0] = False  # an empty bag
    want = jops.embedding_bag_dense(
        jnp.asarray(table), jnp.asarray(idx),
        None if mask is None else jnp.asarray(mask), combiner=JCombiner(combiner))
    got = tops.embedding_bag_dense(
        _t(table), _t(idx), None if mask is None else _t(mask),
        combiner=TCombiner(combiner))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding_bag_onehot_matches_jax(rng):
    n, d, b = 40, 16, 20
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx, off = jragged.pack_bags(_bags(rng, b, n), b * 9, pad_index=39)
    want = jops.embedding_bag_onehot(jnp.asarray(table), jnp.asarray(idx),
                                     jnp.asarray(off), batch_size=b)
    got = tops.embedding_bag_onehot(_t(table), _t(idx), _t(off), batch_size=b)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embedding_bag_csr_grad_matches_jax(rng):
    """The plain CSR bag is differentiable, as the JAX one is."""
    n, d, b = 50, 8, 10
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx, off = jragged.pack_bags(_bags(rng, b, n), b * 9)
    g = rng.standard_normal((b, d)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jops.embedding_bag_csr(
        t, jnp.asarray(idx), jnp.asarray(off), batch_size=b) * g))(jnp.asarray(table))
    w = _t(table).clone().requires_grad_(True)
    (tops.embedding_bag_csr(w, _t(idx), _t(off), batch_size=b) * _t(g)).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want), **TOL)


# -- the facade -------------------------------------------------------------

ALLOWED = [("auto", "sum"), ("auto", "mean"), ("auto", "max"),
           ("jnp", "sum"), ("jnp", "mean"), ("jnp", "max"),
           ("onehot", "sum"), ("pallas", "sum"), ("pallas", "mean")]
REFUSED = [("onehot", "mean"), ("onehot", "max"), ("pallas", "max")]


@pytest.mark.parametrize("rows", [60, 3000])  # below / above the one-hot threshold
@pytest.mark.parametrize("impl,combiner", ALLOWED)
def test_facade_matches_jax(rng, rows, impl, combiner):
    d, b = 16, 16
    table = rng.standard_normal((rows, d)).astype(np.float32)
    idx, off = jragged.pack_bags(_bags(rng, b, rows), b * 9)
    with pltpu.force_tpu_interpret_mode():
        want = jops.embedding_bag(
            jnp.asarray(table), jnp.asarray(idx), jnp.asarray(off), batch_size=b,
            combiner=JCombiner(combiner), impl=JImpl(impl))
        want = np.asarray(want)
    got = tops.embedding_bag(_t(table), _t(idx), _t(off), batch_size=b,
                             combiner=TCombiner(combiner), impl=TImpl(impl))
    assert got.shape == (b, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("impl,combiner", REFUSED)
def test_facade_refuses_what_jax_refuses(rng, impl, combiner):
    table = rng.standard_normal((30, 16)).astype(np.float32)
    idx, off = jragged.pack_bags([[1, 2], [3]], 4)
    with pytest.raises(NotImplementedError):
        jops.embedding_bag(jnp.asarray(table), jnp.asarray(idx), jnp.asarray(off),
                           batch_size=2, combiner=JCombiner(combiner),
                           impl=JImpl(impl))
    with pytest.raises(NotImplementedError):
        tops.embedding_bag(_t(table), _t(idx), _t(off), batch_size=2,
                           combiner=TCombiner(combiner), impl=TImpl(impl))


def test_facade_threshold_matches_jax():
    assert tops.ONEHOT_ROW_THRESHOLD == jops.ONEHOT_ROW_THRESHOLD == 2048
