"""The port's data layer against the JAX package's: the Criteo Kaggle
loaders (npz, and raw ``train.txt`` through the native and the Python
parser) and their batches, bitwise; and ``device_prefetch``'s order,
structure and error propagation on the CPU."""

import numpy as np
import pytest
import torch

import pim_embedding_lookup_tpu.data.criteo as jcriteo
import pim_embedding_lookup_tpu_torch.data.criteo as tcriteo
from pim_embedding_lookup_tpu_torch.data import device_prefetch, find_dataset
from torch_port_native_lib import (  # noqa: F401
    force_native,
    force_numpy,
    native_build,
    native_lib,
    native_so,
)


def _raw_file(tmp_path, n=40, seed=0):
    rng = np.random.default_rng(seed)
    lines = ["1\t5\t\t3" + "\t1" * 10 + "\t" + "\t".join(["0a1b2c3d"] * 26),
             "0" + "\t2" * 13 + "\t" + "\t".join(["ff"] * 26)]
    for _ in range(n - 2):
        ints = [str(int(v)) if v >= 0 else "" for v in rng.integers(-2, 900, 13)]
        cats = [f"{int(v):x}" if v % 7 else "" for v in rng.integers(0, 2**32, 26)]
        lines.append("\t".join([str(int(rng.integers(0, 2)))] + ints + cats))
    path = tmp_path / "train.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _npz_file(tmp_path, n=60):
    rng = np.random.default_rng(1)
    path = tmp_path / "proc.npz"
    np.savez(path, X_int=rng.integers(-5, 100, size=(n, 13)),
             X_cat=rng.integers(0, 1000, size=(n, 26)), y=rng.integers(0, 2, size=n),
             counts=np.array([10, 20, 30] + [5] * 23))
    return str(path)


def _same_dataset(t, j):
    for name in ("x_int", "x_cat", "y", "counts"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


def _same_batches(t, j):
    assert len(t) == len(j) > 0
    for tb, jb in zip(t, j):
        for a, b in zip(tb, jb):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("parser", ["native", "numpy"])
@pytest.mark.parametrize("max_rows", [None, 25])
def test_parse_raw_matches_jax(request, tmp_path, parser, max_rows):
    request.getfixturevalue("force_" + parser)
    path = _raw_file(tmp_path)
    t = tcriteo.CriteoKaggle.parse_raw(path, max_rows, hash_mod=5000)
    j = jcriteo.CriteoKaggle.parse_raw(path, max_rows, hash_mod=5000)
    _same_dataset(t, j)
    assert t.x_int.shape == (max_rows or 40, 13)
    _same_batches(list(t.batches(8, shuffle=True, seed=3)),
                  list(j.batches(8, shuffle=True, seed=3)))


def test_native_and_python_parsers_agree(request, tmp_path):
    path = _raw_file(tmp_path, seed=5)
    request.getfixturevalue("force_native")
    native = tcriteo.CriteoKaggle.parse_raw(path)
    request.getfixturevalue("force_numpy")  # overrides the library set above
    _same_dataset(native, tcriteo.CriteoKaggle.parse_raw(path))


def test_npz_split_config_and_batches_match_jax(tmp_path):
    path = _npz_file(tmp_path)
    t, j = tcriteo.CriteoKaggle.load_npz(path), jcriteo.CriteoKaggle.load_npz(path)
    _same_dataset(t, j)
    assert (t.x_cat < t.counts[None, :]).all()
    tc, jc = t.dlrm_config(dim=8), j.dlrm_config(dim=8)
    assert [(x.num_rows, x.dim, x.name) for x in tc.tables] == \
        [(x.num_rows, x.dim, x.name) for x in jc.tables]
    assert (tc.dense_dim, tuple(tc.mlp_bot), tuple(tc.mlp_top)) == \
        (jc.dense_dim, tuple(jc.mlp_bot), tuple(jc.mlp_top))
    (ttr, tte), (jtr, jte) = t.split(), j.split()
    _same_dataset(ttr, jtr)
    _same_dataset(tte, jte)
    for kw in (dict(), dict(shuffle=True, seed=9), dict(drop_last=False)):
        _same_batches(list(ttr.batches(7, **kw)), list(jtr.batches(7, **kw)))
    _same_dataset(tcriteo.CriteoKaggle.load_npz(path, 13), jcriteo.CriteoKaggle.load_npz(path, 13))


def test_find_dataset(tmp_path):
    there = tmp_path / "d.npz"
    there.write_bytes(b"")
    assert find_dataset((str(tmp_path / "absent.npz"), str(there))) == str(there)
    assert find_dataset((str(tmp_path / "absent.npz"),)) is None


def test_device_prefetch_keeps_order_and_structure():
    batches = [{"x": np.ones((4, 4)) * i, "y": (np.arange(4) + i, np.arange(2) < i)}
               for i in range(7)]
    seen = list(device_prefetch(iter(batches), buffer_size=2, device="cpu"))
    assert len(seen) == 7
    for i, b in enumerate(seen):
        assert isinstance(b["x"], torch.Tensor) and isinstance(b["y"], tuple)
        np.testing.assert_array_equal(b["x"].numpy(), batches[i]["x"])
        np.testing.assert_array_equal(b["y"][0].numpy(), batches[i]["y"][0])
        assert b["y"][1].dtype == torch.bool
    batches[0]["x"][:] = 99  # the staged batch is a copy
    assert float(seen[0]["x"].max()) == 0.0


def test_device_prefetch_propagates_errors():
    def gen():
        yield (np.ones(2),)
        raise ValueError("boom")

    it = device_prefetch(gen(), device="cpu")
    assert next(it)[0].shape == (2,)
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_device_prefetch_defaults_to_cuda():
    """No quiet CPU run: the default device is CUDA, which this machine
    lacks (on a card the card tests cover it)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: tests/test_torch_port_card.py covers it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_prefetch(iter([(np.ones(2),)])))
