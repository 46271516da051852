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
    embedding_bag_fixedl,
    embedding_bag_fixedl_reference,
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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d,b,l,tile_b,nbuf", [
    (16, 32, 4, 8, 8),    # packed, multi-hot
    (16, 64, 1, 8, 16),   # packed, single-hot
    (128, 16, 2, 8, 4),   # full-width rows
])
def test_matches_pallas(rng, d, b, l, tile_b, nbuf, masked):
    n = 500
    table = rng.standard_normal((n, d)).astype(np.float32)
    idx = rng.integers(0, n, size=b * l).astype(np.int32)
    mask = rng.random(b * l) < 0.6 if masked else None
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
