"""The port's config, planner and import isolation against the JAX package."""

import dataclasses
import enum
import itertools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import pim_embedding_lookup_tpu.config as jcfg
import pim_embedding_lookup_tpu.parallel.hybrid as jhybrid
import pim_embedding_lookup_tpu.parallel.planner as jplanner
import pim_embedding_lookup_tpu_torch.config as tcfg
import pim_embedding_lookup_tpu_torch.parallel.hybrid as thybrid
import pim_embedding_lookup_tpu_torch.parallel.planner as tplanner

PORT_DIR = Path(tcfg.__file__).resolve().parent


def _plain(x):
    """Dataclasses, enums and dtypes -> comparable plain values."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, type) or isinstance(x, np.dtype):
        return np.dtype(x).name
    return x


def _tables(mod, rows, dim=16):
    return tuple(mod.TableConfig(num_rows=n, dim=dim, name=f"t{i}")
                 for i, n in enumerate(rows))


@pytest.mark.parametrize("preset", ["kaggle_config", "random_config",
                                    "toy_config", "loadgen_config"])
def test_presets_match(preset):
    """Every field of the JAX package's preset, equal; the port's
    ``DLRMConfig`` adds the cross interaction's sizes, which the JAX package
    has no interaction for: a dot preset leaves them at 0."""
    port, jax = _plain(getattr(tcfg, preset)()), _plain(getattr(jcfg, preset)())
    if isinstance(port, dict):
        assert (port.pop("dcn_num_layers"), port.pop("dcn_low_rank_dim")) == (0, 0)
    assert port == jax


def test_enums_and_table_bytes_match():
    for name in ("Combiner", "ShardingPolicy", "LookupImpl"):
        assert [e.value for e in getattr(tcfg, name)] == [
            e.value for e in getattr(jcfg, name)]
    assert tcfg.KAGGLE_TABLE_ROWS == jcfg.KAGGLE_TABLE_ROWS
    for mod in (tcfg, jcfg):
        assert mod.TableConfig(num_rows=10, dim=16).bytes == 640
    assert tcfg.QueryConfig(8, 3).capacity == jcfg.QueryConfig(8, 3).capacity
    assert tcfg.MeshConfig(2, 4).num_devices == jcfg.MeshConfig(2, 4).num_devices


TABLE_SETS = {
    "kaggle": jcfg.KAGGLE_TABLE_ROWS,
    "mixed": (3, 24, 583, 1460, 9000, 20000),
    "big": (5_000_000, 3_000_000, 700_000),
}


@pytest.mark.parametrize("rows_name", list(TABLE_SETS))
@pytest.mark.parametrize("dim", [16, 128, 256])
def test_plan_matches(rows_name, dim):
    rows = TABLE_SETS[rows_name]
    for policy, shards, packed in itertools.product(
        list(tcfg.ShardingPolicy), (1, 2, 4, 8), (False, True, "auto")
    ):
        jpol = jcfg.ShardingPolicy(policy.value)
        try:
            want = jplanner.plan(_tables(jcfg, rows, dim), shards, jpol, packed)
        except ValueError:
            with pytest.raises(ValueError):
                tplanner.plan(_tables(tcfg, rows, dim), shards, policy, packed)
            continue
        got = tplanner.plan(_tables(tcfg, rows, dim), shards, policy, packed)
        assert _plain(got) == _plain(want), (policy, shards, packed)
        assert (got.rows_per_shard, got.storage_rows, got.storage_width) == (
            want.rows_per_shard, want.storage_rows, want.storage_width)


@pytest.mark.parametrize("rows_name", ["kaggle", "mixed"])
def test_plan_small_bucketed_matches(rows_name):
    rows = TABLE_SETS[rows_name]
    small = [i for i, n in enumerate(rows) if n <= 8192]
    want = jhybrid._plan_small_bucketed(_tables(jcfg, rows), small, 1)
    got = thybrid._plan_small_bucketed(_tables(tcfg, rows), small, 1)
    assert _plain(got) == _plain(want)


def test_import_pulls_in_no_jax():
    code = (
        "import re, sys\n"
        "import pim_embedding_lookup_tpu_torch\n"
        "bad = [m for m in sys.modules if m.startswith('jax') or "
        "re.match(r'pim_embedding_lookup_tpu(?!_torch)', m)]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = PORT_DIR.parent
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax\w*|pim_embedding_lookup_tpu(?!_torch)\w*)\b",
        re.M,
    )
    files = sorted(PORT_DIR.rglob("*.py"))
    assert len(files) >= 10
    for path in files:
        assert not pattern.search(path.read_text()), path
