"""The plain version of the port's gather+pool kernel (K1) against the
Pallas kernel it replaces, in interpret mode; the wrapper's checks.

The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pim_embedding_lookup_tpu.ops.pallas_lookup import (
    pack_table_lanes,
    pallas_embedding_bag_fixedl,
)
from pim_embedding_lookup_tpu_torch.ops import gather_pool
from pim_embedding_lookup_tpu_torch.ops.gather_pool import (
    KernelPath,
    embedding_bag_fixedl,
    embedding_bag_fixedl_reference,
    fitted_path,
    kernel_path,
    row_load,
    walks_by_group,
)


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _pallas(table, d, idx, mask, b, l, tile_b, nbuf):
    packed = np.array(pack_table_lanes(jnp.asarray(table))) if d < 128 else table
    out = pallas_embedding_bag_fixedl(
        jnp.asarray(packed), d, jnp.asarray(idx), pooling=l, batch_size=b,
        tile_b=tile_b, nbuf=nbuf,
        mask=None if mask is None else jnp.asarray(mask),
    )
    return packed, np.asarray(out)


@pytest.mark.parametrize("masked", [False, True, "1 in 4"])
@pytest.mark.parametrize("d,b,l,tile_b,nbuf", [
    (16, 32, 4, 8, 8),    # packed, multi-hot
    (16, 64, 1, 8, 16),   # packed, single-hot
    (128, 16, 2, 8, 4),   # full-width rows
    (16, 16, 40, 8, 8),   # packed, long bags (past a 32-id window)
])
def test_matches_pallas(rng, d, b, l, tile_b, nbuf, masked):
    """``masked``: none, 6 entries in 10 kept, or 1 in 4 (a row shard of
    4's share, where the kernel's compacted walk drops 3 entries in 4
    before its row loads)."""
    n = 500
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, size=b * l).astype(np.int32)
    mask = rng.random(b * l) < (0.25 if masked == "1 in 4" else 0.6) if masked else None
    packed, want = _pallas(table, d, idx, mask, b, l, tile_b, nbuf)
    got = embedding_bag_fixedl(
        torch.from_numpy(packed), d, torch.from_numpy(idx), pooling=l,
        batch_size=b, mask=None if mask is None else torch.from_numpy(mask),
    )
    assert got.dtype == torch.float32 and got.shape == (b, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bf16_storage_matches_pallas_on_rounded_values(rng):
    """bf16 storage accumulates in f32: equal to the Pallas kernel fed the
    same bf16-rounded values in f32."""
    n, d, b, l = 400, 16, 32, 4
    table_bf16 = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)
                                  ).to(torch.bfloat16)
    rounded = table_bf16.float().numpy()
    idx = rng.integers(0, n, size=b * l).astype(np.int32)
    mask = rng.random(b * l) < 0.7
    _, want = _pallas(rounded, d, idx, mask, b, l, 8, 8)
    got = embedding_bag_fixedl(
        table_bf16.reshape(-1, 128), d, torch.from_numpy(idx), pooling=l,
        batch_size=b, mask=torch.from_numpy(mask),
    )
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_masked_entries_are_not_read(rng):
    """A masked entry may carry any id (even out of range) and adds 0."""
    table = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    idx = torch.tensor([3, 10_000, 5, -7], dtype=torch.int32)
    mask = torch.tensor([True, False, True, False])
    got = embedding_bag_fixedl_reference(table, 16, idx, pooling=2,
                                         batch_size=2, mask=mask)
    torch.testing.assert_close(got, torch.stack([table[3], table[5]]),
                               rtol=0, atol=0)


@pytest.mark.parametrize("bad", [
    dict(indices=torch.zeros(8, dtype=torch.int64)),           # id dtype
    dict(indices=torch.zeros(7, dtype=torch.int32)),           # id count
    dict(mask=torch.ones(4, dtype=torch.bool)),                # mask length
    dict(mask=torch.ones(8, dtype=torch.float32)),             # mask dtype
    dict(storage=torch.zeros(16, 64)),                         # width
    dict(storage=torch.zeros(16, 128, dtype=torch.float16)),   # storage dtype
    dict(storage=torch.zeros(128, 16)[:, :8].t()),             # layout
])
def test_wrapper_rejects(bad):
    args = dict(storage=torch.zeros(16, 128), indices=torch.zeros(8, dtype=torch.int32),
                mask=None)
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        embedding_bag_fixedl(args["storage"], 16, args["indices"], pooling=2,
                             batch_size=4, mask=args["mask"])


def test_cpu_tensor_does_not_count_a_launch(rng):
    before = embedding_bag_fixedl.launches
    embedding_bag_fixedl(torch.zeros(8, 128), 16, torch.zeros(4, dtype=torch.int32),
                         pooling=1, batch_size=4)
    assert embedding_bag_fixedl.launches == before
    # importing and calling on the CPU builds nothing
    assert gather_pool._build._loaded == {}


@pytest.mark.parametrize("dtype,d,offset,want", [
    (torch.float32, 16, 0, (True, 4)),      # 64-byte rows: 4 vectors, a group of 4
    (torch.bfloat16, 16, 0, (True, 2)),     # 32-byte rows: 2 vectors
    (torch.float32, 128, 0, (True, 32)),    # a whole warp a bag
    (torch.float32, 256, 0, (True, 32)),    # 64 vectors: two rounds of a warp
    (torch.float32, 20, 0, (True, 8)),      # 5 vectors, rounded up to 8 threads
    (torch.float32, 4, 0, (True, 1)),       # one vector: 32 bags a warp
    (torch.bfloat16, 20, 0, (False, 32)),   # 40-byte rows: scalar, 20 -> 32
    (torch.float32, 1, 0, (False, 1)),      # 4-byte rows: scalar
    (torch.float32, 16, 1, (False, 16)),    # a view 1 element in: not 16-byte aligned
    (torch.bfloat16, 16, 8, (True, 2)),     # 8 bf16 in: aligned again
    # int8 rows, single hot: 8 codes a thread (two float4 of output), or 4
    # (one 32-bit word, one float4) where rows are 4- but not 8-byte aligned
    (torch.int8, 4, 0, (True, 1)),          # one word: 32 bags a warp
    (torch.int8, 16, 0, (True, 2)),         # the Kaggle width: 16 bags a warp
    (torch.int8, 20, 0, (True, 8)),         # 5 words, rounded up to 8 threads
    (torch.int8, 64, 0, (True, 8)),         # the capacity width: 4 bags a warp
    (torch.int8, 128, 0, (True, 16)),
    (torch.int8, 16, 1, (False, 16)),       # a view 1 byte in: not 4-byte aligned
    (torch.int8, 64, 1, (False, 32)),       # ... scalar, 64 -> 32 threads
    (torch.int8, 16, 4, (True, 4)),         # 4 bytes in: words, not 8-byte loads
    (torch.int8, 16, 8, (True, 2)),         # 8 bytes in: aligned again
    (torch.int8, 6, 0, (False, 8)),         # 6-byte rows: scalar
])
def test_row_path_picks_vector_loads_and_group(dtype, d, offset, want):
    """The kernels read rows with vector loads (16 bytes a thread; 4 for
    int8 rows) only where the row bytes and the storage pointer are that
    aligned; a bag gets one thread per vector (or element) of its row,
    rounded up to a power of two, at most a warp."""
    buf = torch.zeros(64 * d + offset, dtype=dtype)
    storage = buf[offset:].view(64, d)
    assert storage.is_contiguous() and storage.storage_offset() == offset
    path = kernel_path(storage, d, 64, 64)
    assert (path.load > 0, path.group) == want
    assert path == (row_load(storage, d), want[1], False)
    if dtype != torch.int8:
        assert path.load == 16 * want[0]


@pytest.mark.parametrize("d,pooling,want", [
    (16, 1, (8, 2, False)),     # the int8 Kaggle big set: 8-byte loads, one window
    (16, 2, (8, 2, False)),     # 16 bags of 2: still one window
    (16, 3, (4, 4, False)),     # 48 entries a tile at 8 bytes: words, 8 bags a window
    (16, 8, (4, 4, True)),      # long bags: words, by group
    (64, 1, (8, 8, False)),     # the capacity bench at L=1
    (64, 120, (4, 16, True)),   # cli sweep's int8 points: 16 threads a bag
    (20, 1, (4, 8, False)),     # 20-byte rows take no 8-byte loads
])
def test_int8_row_load_follows_bag_length(d, pooling, want):
    """int8 rows load 8 codes a thread where the tile of that group walks by
    window (short bags), and 4 codes (twice the threads a bag) where its bags
    are long enough to walk by group."""
    storage = torch.zeros(64, d, dtype=torch.int8)
    bags = 100
    assert kernel_path(storage, d, bags * pooling, bags) == want
    assert row_load(storage, d, bags * pooling, bags) == want[0]


@pytest.mark.parametrize("d,offset,path,refused", [
    (16, 0, (12, 4, False), "row loads of 12 bytes"),    # no such load
    (16, 0, (32, 1, False), "row loads of 32 bytes"),    # wider than a vector
    (20, 0, (8, 4, False), "8-byte row loads"),          # 20-byte rows: not 8-aligned
    (20, 0, (16, 2, False), "row loads of 16 bytes"),    # int8 rows take no 16-byte loads
    (16, 1, (4, 4, False), "4-byte row loads"),          # a view 1 byte in
    (16, 2, (4, 4, False), "4-byte row loads"),          # ... 2 bytes in
    (16, 4, (8, 2, False), "8-byte row loads"),          # 4 bytes in: not 8-aligned
    (16, 8, (16, 1, False), "row loads of 16 bytes"),    # ... aligned or not
    (16, 0, (2, 8, False), "row loads of 2 bytes"),      # narrower than a word
    (16, 0, (64, 1, False), "row loads of 64 bytes"),    # a whole row at once
    (6, 0, (4, 2, False), "4-byte row loads"),           # 6-byte rows: not 4-aligned
])
def test_pinned_int8_row_load_refused(d, offset, path, refused):
    """A pinned path (``path=``) whose row loads int8 storage cannot take
    is refused before any launch, on the CPU too; the kernels never fall
    back to another load."""
    storage = torch.zeros(64 * d + offset, dtype=torch.int8)[offset:].view(64, d)
    ids = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match=refused):
        kernel_path(storage, d, 8, 8, path)
    with pytest.raises(ValueError, match=refused):
        embedding_bag_fixedl(storage, d, ids, pooling=1, batch_size=8, path=path)


def test_pinned_float_row_loads_are_16_bytes():
    """f32 and bf16 kernels load 16 bytes a thread or one element: the int8
    loads are refused for them."""
    for dtype in (torch.float32, torch.bfloat16):
        storage = torch.zeros(64, 16, dtype=dtype)
        for path in ((4, 4, False), (8, 4, False), (12, 4, False)):
            with pytest.raises(ValueError, match="row loads"):
                kernel_path(storage, 16, 64, 64, path)
        with pytest.raises(ValueError, match="only the card"):  # a valid pin on the CPU
            kernel_path(storage, 16, 64, 64, (16, 4, False))


@pytest.mark.parametrize("group,pooling,want", [
    (4, 1, False),    # the main path: 8 single-hot bags, one window
    (4, 4, False),    # 32 entries a tile: still one window
    (4, 8, True),     # 64 entries a tile: each group along its own bag
    (32, 9, False),   # d=128 f32: one bag a tile
    (32, 40, True),   # ... longer than a window
    (1, 2, True),     # 32 bags of 2
])
def test_fixedl_walk(group, pooling, want):
    """K1's tile of 32 / group bags holds 32 / group * L entries: past 32,
    ids go along each bag, not in shared windows."""
    bags = 100
    assert walks_by_group(group, bags * pooling, bags) == want


@pytest.mark.parametrize("dtype,d,pooling", [
    (torch.float32, 16, 1), (torch.float32, 16, 40), (torch.bfloat16, 64, 120),
    (torch.bfloat16, 128, 32), (torch.int8, 16, 3), (torch.int8, 64, 120),
])
def test_wrapper_walk_is_compacted(dtype, d, pooling):
    """A kernel path has three fields, the row load, the group and the walk:
    what ``kernel_path`` picks and what ``fitted_path`` pins; the masked
    walk follows from the kernel and its walk, not from a field."""
    storage = torch.zeros(64, d, dtype=dtype)
    bags = 100
    path = kernel_path(storage, d, bags * pooling, bags)
    fitted = fitted_path(storage, d, bags * pooling, bags, 4 if dtype == torch.int8 else 16)
    assert KernelPath._fields == ("load", "group", "by_group")
    for p in (path, fitted):
        assert type(p) is KernelPath and len(p) == 3
        assert KernelPath(*p) == p
    assert fitted == path  # the load the kernels pick at these shapes, pinned


@pytest.mark.parametrize("pin", [
    (16, 4, False, False),  # four fields, by window
    (16, 4, True, False),   # ... by group
    (16, 4, True, True),    # ... the fourth set
    (16, 4, True),          # three fields: a valid pin
    (0, 16, False, False),  # the scalar path, four fields
])
def test_first_masked_walk_is_a_card_only_pin(pin):
    """A path pins three fields (load, group, by_group), and like every pin
    only for a tensor on the card: a CPU tensor's call is refused before
    the plain version runs, on K1 and on K2.  A pin of four fields is
    refused, naming the three, before that."""
    from pim_embedding_lookup_tpu_torch.ops.csr_pool import embedding_bag_csr_packed

    storage = torch.zeros(64, 16)
    ids = torch.zeros(32, dtype=torch.int32)
    mask = torch.zeros(32, dtype=torch.bool)
    refused = "only the card" if len(pin) == 3 else r"\(load, group, by_group\)"
    with pytest.raises(ValueError, match=refused):
        kernel_path(storage, 16, 32, 8, pin)
    with pytest.raises(ValueError, match=refused):
        embedding_bag_fixedl(storage, 16, ids, pooling=4, batch_size=8, mask=mask, path=pin)
    with pytest.raises(ValueError, match=refused):
        embedding_bag_csr_packed(storage, 16, ids, torch.arange(9, dtype=torch.int32) * 4,
                                 batch_size=8, mask=mask, path=pin)
