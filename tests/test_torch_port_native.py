"""The port's native feeder binding (``utils/native.py``) and synthetic
data (``data/synthetic.py``) against the JAX package's, on the same
library and the same seeds.  Everything here is integer or copied data,
so every comparison is bitwise."""

import os

import numpy as np
import pytest

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu.data.synthetic as jsyn
import pim_embedding_lookup_tpu.ops.ragged as jragged
import pim_embedding_lookup_tpu.utils.native as jnative
import pim_embedding_lookup_tpu_torch.config as tcfg
import pim_embedding_lookup_tpu_torch.data.synthetic as tsyn
import pim_embedding_lookup_tpu_torch.ops.ragged as tragged
import pim_embedding_lookup_tpu_torch.utils.native as tnative
from torch_port_native_lib import (  # noqa: F401
    force_native,
    force_numpy,
    native_build,
    native_lib,
    native_so,
)

ROWS = np.array([100, 5000, 7, 1 << 20], dtype=np.int64)


def _equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("distribution,alpha", [("uniform", 1.05), ("zipf", 1.2)])
def test_gen_query_matches_jax(force_native, distribution, alpha):
    kw = dict(distribution=distribution, alpha=alpha, seed=17)
    got = tnative.gen_query(ROWS, 64, 8, **kw)
    assert got.shape == (4, 64, 8) and got.dtype == np.int32
    _equal(got, jnative.gen_query(ROWS, 64, 8, **kw))
    assert (got >= 0).all() and (got < ROWS[:, None, None]).all()
    assert not np.array_equal(got, tnative.gen_query(ROWS, 64, 8, **{**kw, "seed": 18}))


@pytest.mark.parametrize("distribution", ["uniform", "zipf"])
def test_gen_query_numpy_fallback_matches_jax(force_numpy, distribution):
    kw = dict(distribution=distribution, seed=5)
    _equal(tnative.gen_query(ROWS, 16, 3, **kw), jnative.gen_query(ROWS, 16, 3, **kw))


def test_parse_criteo_raw_matches_jax(force_native, tmp_path):
    raw = tmp_path / "train.txt"
    rng = np.random.default_rng(3)
    lines = ["1\t5\t\t3" + "\t1" * 10 + "\t" + "\t".join(["0a1b2c3d"] * 26),
             "0" + "\t2" * 13 + "\t" + "\t".join([""] * 26)]
    for _ in range(20):
        ints = [str(int(v)) if v >= 0 else "" for v in rng.integers(-3, 500, 13)]
        cats = [f"{int(v):08x}" if v % 5 else "" for v in rng.integers(0, 2**32, 26)]
        lines.append("\t".join([str(int(rng.integers(0, 2)))] + ints + cats))
    raw.write_text("\n".join(lines) + "\n")
    for max_rows, hash_mod in ((30, 1 << 20), (7, 1000)):
        got = tnative.parse_criteo_raw(str(raw), max_rows, hash_mod)
        _equal(got, jnative.parse_criteo_raw(str(raw), max_rows, hash_mod))
    assert len(got[0]) == 7 and got[2][0, 0] == 0x0A1B2C3D % 1000
    with pytest.raises(FileNotFoundError):
        tnative.parse_criteo_raw(str(tmp_path / "absent.txt"), 4)


def test_pack_csr_matches_jax_and_shard_csr(force_native):
    rng = np.random.default_rng(4)
    t, b, nd, cap = 3, 12, 2, 24
    bags = [[rng.integers(0, 500, size=rng.integers(0, 5)).tolist() for _ in range(b)]
            for _ in range(t)]
    lens = np.asarray([[len(bag) for bag in tb] for tb in bags], np.int32)
    values = np.asarray([i for tb in bags for bag in tb for i in bag], np.int32)
    voff = np.zeros(t + 1, np.int64)
    np.cumsum(lens.sum(axis=1), out=voff[1:])
    kw = dict(num_shards=nd, capacity_per_shard=cap, pad_index=7)
    got = tnative.pack_csr(values, voff, lens, **kw)
    _equal(got, jnative.pack_csr(values, voff, lens, **kw))
    _equal(got, tragged.shard_csr(bags, nd, cap, pad_index=7))
    with pytest.raises(ValueError, match="exceeds capacity"):
        tnative.pack_csr(values, voff, lens, num_shards=nd, capacity_per_shard=2)
    with pytest.raises(ValueError, match="num_shards"):
        tnative.pack_csr(values, voff, lens, num_shards=5, capacity_per_shard=cap)


def _ragged(rng, t, b):
    lens = rng.choice([0, 1, 1, 2, 3, 6, 11], size=(t, b))
    off = np.zeros((t, b + 1), np.int64)
    np.cumsum(lens, axis=1, out=off[:, 1:])
    idx = rng.integers(0, 900, size=(t, int(off[:, -1].max()) + 5)).astype(np.int32)
    return idx, off


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_buckets_matches_jax(force_native, seed):
    rng = np.random.default_rng(seed)
    idx, off = _ragged(rng, 3, 40)
    plan = tragged.plan_length_buckets(off, bucket_ls=(1, 2, 4), slack=1.2)
    kw = dict(bucket_ls=plan.bucket_ls, capacities=plan.capacities, tail_bags=plan.tail_bags,
              tail_entries=plan.tail_entries, pad_index=3)
    _equal(tnative.pack_buckets(idx, off, **kw), jnative.pack_buckets(idx, off, **kw))


def test_pack_buckets_shape_checks(force_native):
    """Two checks the JAX binding lacks (it reads out of bounds): the
    tables of indices and offsets, and one capacity per bucket."""
    rng = np.random.default_rng(9)
    idx, off = _ragged(rng, 3, 16)
    kw = dict(bucket_ls=(1, 2), capacities=(16, 16), tail_bags=16, tail_entries=200)
    with pytest.raises(ValueError, match="one T"):
        tnative.pack_buckets(idx[:2], off, **kw)
    with pytest.raises(ValueError, match="capacities"):
        tnative.pack_buckets(idx, off, **{**kw, "capacities": (16,)})
    with pytest.raises(ValueError, match="non-decreasing"):
        tnative.pack_buckets(idx, off[:, ::-1].copy(), **kw)


def test_absent_or_stale_library(monkeypatch, force_numpy):
    rows = np.array([10], np.int64)
    assert not tnative.available()
    assert tnative.parse_criteo_raw("x", 1) is None
    assert tnative.pack_csr(np.zeros(1, np.int32), np.array([0, 1]), np.ones((1, 1)),
                            num_shards=1, capacity_per_shard=1) is None
    assert tnative.pack_buckets(np.zeros((1, 1), np.int32), np.array([[0, 1]]),
                                bucket_ls=(1,), capacities=(1,), tail_bags=0,
                                tail_entries=0) is None
    assert tnative.gen_query(rows, 2, 2).shape == (1, 2, 2)
    # a library built before pel_pack_buckets: the packer is absent, as in JAX
    stale = object()
    monkeypatch.setattr(tnative, "_LIB", stale)
    monkeypatch.setattr(jnative, "_LIB", stale)
    args = (np.zeros((1, 1), np.int32), np.array([[0, 1]]))
    kw = dict(bucket_ls=(1,), capacities=(1,), tail_bags=0, tail_entries=0)
    assert tnative.pack_buckets(*args, **kw) is None is jnative.pack_buckets(*args, **kw)


def test_search_order_env_first(monkeypatch, native_so):
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setenv("PEL_NATIVE_LIB", native_so)
    assert tnative.available() and tnative._LIB._name == native_so
    repo_so = os.path.join(os.path.dirname(tnative.__file__), "..", "..", "native",
                           "libpelfeeder.so")
    assert os.path.normpath(repo_so) == os.path.normpath(
        os.path.join(os.path.dirname(jnative.__file__), "..", "..", "native",
                     "libpelfeeder.so"))
    assert tnative._search_paths()[1:] == (repo_so, "libpelfeeder.so")


def _tables(mod, rows=(100, 3000, 7, 40000), dim=8):
    return tuple(mod.TableConfig(num_rows=n, dim=dim, name=f"t{i}") for i, n in enumerate(rows))


@pytest.mark.parametrize("branch", ["native", "numpy"])
@pytest.mark.parametrize("distribution,fixed", [("uniform", True), ("zipf", False)])
def test_query_generator_matches_jax(request, branch, distribution, fixed):
    request.getfixturevalue("force_" + branch)
    kw = dict(distribution=distribution, seed=11, fixed_length=fixed)
    tgen = tsyn.QueryGenerator(_tables(tcfg), tcfg.QueryConfig(6, 3), **kw)
    jgen = jsyn.QueryGenerator(_tables(jcfg), jcfg.QueryConfig(6, 3), **kw)
    for got, want in zip(tgen.queries(3), jgen.queries(3)):
        assert got[0].shape == (4, 18)
        _equal(got, want)


@pytest.mark.parametrize("branch", ["native", "numpy"])
def test_synthetic_batches_match_jax(request, branch):
    request.getfixturevalue("force_" + branch)

    def config(mod):
        return mod.DLRMConfig(dense_dim=5, mlp_bot=(8, 8), mlp_top=(4, 1),
                              tables=_tables(mod))

    got = list(tsyn.SyntheticDLRMBatches(config(tcfg), 12, 2, 4, seed=3))
    want = list(jsyn.SyntheticDLRMBatches(config(jcfg), 12, 2, 4, seed=3))
    assert len(got) == 4
    for g, w in zip(got, want):
        _equal(tuple(g), tuple(w))


def test_random_tables_match_jax():
    for g, w in zip(tsyn.random_tables(_tables(tcfg), seed=2, scale=0.5),
                    jsyn.random_tables(_tables(jcfg), seed=2, scale=0.5)):
        _equal(g, w)


def test_bucket_pack_native_auto_matches_jax(force_native):
    """``pack_length_buckets`` takes the native packer by default."""
    rng = np.random.default_rng(21)
    idx, off = _ragged(rng, 3, 30)
    plan = tragged.plan_length_buckets(off, bucket_ls=(1, 2, 4), slack=1.3)
    got = tragged.pack_length_buckets(idx, off, plan)
    want = jragged.pack_length_buckets(idx, off, jragged.LengthBucketPlan(
        **vars(plan)), impl="native")
    for a, b in zip(got.idx + got.mask + got.pos, want.idx + want.mask + want.pos):
        np.testing.assert_array_equal(a, b)
    assert got.identity == want.identity
