"""The plain versions of the port's CSR kernels against the Pallas kernels
they replace, in interpret mode: K2 (``pallas_embedding_bag_csr_packed``),
K3 (the same CSR walk over full-width rows) and K4
(``pallas_embedding_bag_csr`` with its custom VJP), on the shapes of
tests/test_pallas.py, K4's masked backward (a row shard's gradient) against
``jax.grad`` of the JAX package's masked CSR pool, and the wrappers'
checks.  The CUDA kernels themselves
are held against their plain versions on the card by
tests/test_torch_port_card.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pim_embedding_lookup_tpu.ops.pallas_lookup import (
    pack_table_lanes,
    pallas_embedding_bag_csr,
    pallas_embedding_bag_csr_packed,
)
from pim_embedding_lookup_tpu.ops.ragged import pack_bags, segment_ids_from_offsets
from pim_embedding_lookup_tpu_torch.ops import csr_pool
from pim_embedding_lookup_tpu_torch.ops.csr_pool import (
    embedding_bag_csr_grad,
    embedding_bag_csr_grad_reference,
    embedding_bag_csr_packed,
    embedding_bag_csr_sum,
)
from pim_embedding_lookup_tpu_torch.ops.gather_pool import kernel_path, walks_by_group

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _toy(rng):
    table = np.stack([(r + 1) * np.arange(1, 9, dtype=np.float32) for r in range(4)])
    return table, [[1, 3, 2, 0]] * 16, 64  # capacity == offsets[B]


def _ragged(rng):
    n = 300
    table = rng.standard_normal((n, 16), dtype=np.float32)
    bags = [rng.integers(0, n, size=rng.integers(0, 9)).tolist() for _ in range(24)]
    return table, bags, 24 * 9


def _unaligned(rng):
    n = 100
    table = rng.standard_normal((n, 32), dtype=np.float32)
    return table, [rng.integers(0, n, size=3).tolist() for _ in range(13)], 39


def _deep(rng):
    n = 64
    table = rng.standard_normal((n, 16), dtype=np.float32)
    bags = [rng.integers(0, n, size=rng.integers(1, 20)).tolist() for _ in range(8)]
    return table, bags, 160


def _wide(rng):
    n = 200
    table = rng.standard_normal((n, 128), dtype=np.float32)
    bags = [rng.integers(0, n, size=rng.integers(0, 6)).tolist() for _ in range(16)]
    return table, bags, 96


CASES = {"toy": (_toy, 8, 8), "ragged_d16": (_ragged, 8, 8),
         "unaligned_d32": (_unaligned, 8, 8), "deep_pipeline": (_deep, 8, 16),
         "full_width_d128": (_wide, 8, 4)}


def _case(rng, name):
    make, tile_b, nbuf = CASES[name]
    table, bags, cap = make(rng)
    idx, off = pack_bags(bags, cap, pad_index=1)
    return table, len(bags), idx, off, tile_b, nbuf


def _packed(table):
    d = table.shape[1]
    return table if d % 128 == 0 else np.array(pack_table_lanes(jnp.asarray(table)))


# -- K2 / K3 ----------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_csr_packed_matches_pallas(rng, name):
    """K2 over lane-packed storage (K3 at d = 128)."""
    table, b, idx, off, tile_b, nbuf = _case(rng, name)
    d = table.shape[1]
    storage = _packed(table)
    want = np.asarray(pallas_embedding_bag_csr_packed(
        jnp.asarray(storage), d, jnp.asarray(idx), jnp.asarray(off),
        batch_size=b, tile_b=tile_b, nbuf=nbuf))
    got = embedding_bag_csr_packed(torch.from_numpy(storage), d,
                                   torch.from_numpy(idx), torch.from_numpy(off),
                                   batch_size=b)
    assert got.shape == (b, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["ragged_d16", "full_width_d128"])
def test_csr_unpacked_storage_matches_pallas(rng, name):
    """[N, d] storage: K3's ``_pallas_sum_csr`` form at d = 128; the same
    walk over unpacked rows at d = 16."""
    table, b, idx, off, tile_b, nbuf = _case(rng, name)
    d = table.shape[1]
    want = np.asarray(pallas_embedding_bag_csr(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(off), batch_size=b,
        tile_b=tile_b, nbuf=nbuf))
    got = embedding_bag_csr_packed(torch.from_numpy(table), d, torch.from_numpy(idx),
                                   torch.from_numpy(off), batch_size=b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_many_tables_in_one_call_match_per_table_pallas(rng):
    """[T, C] ids with [T, B+1] offsets: table t's bags land in rows
    t*B .. t*B+B-1, and its padding stays out of its last bag."""
    n, d, b, t, cap = 120, 16, 10, 3, 60
    table = rng.standard_normal((n, d), dtype=np.float32)
    storage = _packed(table)
    idx, off, want = [], [], []
    for _ in range(t):
        bags = [rng.integers(0, n, size=rng.integers(0, 5)).tolist() for _ in range(b)]
        i, o = pack_bags(bags, cap, pad_index=int(rng.integers(0, n)))
        idx.append(i)
        off.append(o)
        want.append(np.asarray(pallas_embedding_bag_csr_packed(
            jnp.asarray(storage), d, jnp.asarray(i), jnp.asarray(o), batch_size=b)))
    got = embedding_bag_csr_packed(torch.from_numpy(storage), d,
                                   torch.from_numpy(np.stack(idx)),
                                   torch.from_numpy(np.stack(off)), batch_size=b)
    assert got.shape == (t * b, d)
    np.testing.assert_allclose(got.numpy(), np.concatenate(want), **TOL)


def test_bf16_storage_matches_pallas_on_rounded_values(rng):
    """bf16 storage adds in f32: equal to the Pallas kernel fed the same
    bf16-rounded values in f32."""
    table, b, idx, off, _, _ = _case(rng, "ragged_d16")
    bf16 = torch.from_numpy(_packed(table)).to(torch.bfloat16)  # [S, 128]
    want = np.asarray(pallas_embedding_bag_csr_packed(
        jnp.asarray(bf16.float().numpy()), 16, jnp.asarray(idx), jnp.asarray(off),
        batch_size=b))
    got = embedding_bag_csr_packed(bf16, 16, torch.from_numpy(idx),
                                   torch.from_numpy(off), batch_size=b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_padding_and_empty_bags_are_not_read():
    """Padding entries may hold any id (even out of range) and add 0."""
    table = torch.arange(64 * 16, dtype=torch.float32).reshape(64, 16)
    idx = torch.tensor([3, 5, 9, 10_000, -4], dtype=torch.int32)
    off = torch.tensor([0, 2, 2, 3], dtype=torch.int32)  # bag 1 empty
    got = embedding_bag_csr_packed(table, 16, idx, off, batch_size=3)
    want = torch.stack([table[3] + table[5], torch.zeros(16), table[9]])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    dtable = embedding_bag_csr_grad(torch.ones(3, 16), idx, off, 64)
    assert dtable.sum().item() == 3 * 16
    for r in (3, 5, 9):
        torch.testing.assert_close(dtable[r], torch.ones(16), rtol=0, atol=0)


# -- K4 ---------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_bag_sum_forward_matches_pallas(rng, name):
    table, b, idx, off, tile_b, nbuf = _case(rng, name)
    want = np.asarray(pallas_embedding_bag_csr(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(off), batch_size=b,
        tile_b=tile_b, nbuf=nbuf))
    got = embedding_bag_csr_sum(torch.from_numpy(table), torch.from_numpy(idx),
                                torch.from_numpy(off), batch_size=b)
    assert got.shape == (b, table.shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["grad_case", "ragged_d16", "deep_pipeline"])
def test_bag_sum_grad_matches_jax_grad(rng, name):
    """``test_pallas_grad``'s case, and ragged bags with empties and padding."""
    if name == "grad_case":
        n, d, b = 32, 8, 8
        table = rng.standard_normal((n, d), dtype=np.float32)
        bags = [rng.integers(0, n, size=3).tolist() for _ in range(b)]
        idx, off = pack_bags(bags, b * 3)
    else:
        table, b, idx, off, _, _ = _case(rng, name)
    g = rng.standard_normal((b, table.shape[1]), dtype=np.float32)

    def loss(t):
        out = pallas_embedding_bag_csr(t, jnp.asarray(idx), jnp.asarray(off),
                                       batch_size=b)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(loss)(jnp.asarray(table)))
    w = torch.from_numpy(table).clone().requires_grad_(True)
    idx_t, off_t = torch.from_numpy(idx), torch.from_numpy(off)
    out = embedding_bag_csr_sum(w, idx_t, off_t, batch_size=b)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(w.grad.numpy(), want, **TOL)
    np.testing.assert_allclose(
        embedding_bag_csr_grad_reference(torch.from_numpy(g), idx_t, off_t,
                                         table.shape[0]).numpy(), want, **TOL)


def test_bag_sum_bf16_table_matches_jax():
    """A bf16 table: the forward adds in f32 and returns bf16, the gradient
    comes back in bf16.  Small integers keep every sum exact on both sides."""
    rng = np.random.default_rng(3)
    n, d, b = 40, 16, 12
    table = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    bags = [rng.integers(0, n, size=rng.integers(0, 6)).tolist() for _ in range(b)]
    idx, off = pack_bags(bags, 72)
    g = rng.integers(-4, 5, size=(b, d)).astype(np.float32)
    jt = jnp.asarray(table, jnp.bfloat16)
    want = pallas_embedding_bag_csr(jt, jnp.asarray(idx), jnp.asarray(off), batch_size=b)
    want_grad = jax.grad(lambda t: jnp.sum(pallas_embedding_bag_csr(
        t, jnp.asarray(idx), jnp.asarray(off), batch_size=b).astype(jnp.float32) * g))(jt)
    w = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    out = embedding_bag_csr_sum(w, torch.from_numpy(idx), torch.from_numpy(off),
                                batch_size=b)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(g)).sum().backward()
    assert w.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(w.grad.float().numpy(),
                                  np.asarray(want_grad.astype(jnp.float32)))


def test_bag_sum_gives_no_gradient_to_ids():
    w = torch.randn(10, 8, requires_grad=True)
    idx = torch.tensor([1, 2, 3], dtype=torch.int32)
    off = torch.tensor([0, 1, 3], dtype=torch.int32)
    out = embedding_bag_csr_sum(w, idx, off, batch_size=2)
    grads = torch.autograd.grad(out.sum(), [w])
    assert grads[0].shape == w.shape and not idx.requires_grad


@pytest.mark.parametrize("packed", [True, False])
def test_masked_grad_matches_jax_grad(rng, packed):
    """K4's backward with a mask, through the masked pool's autograd and as
    its plain version, against ``jax.grad`` of the masked CSR pool as the
    JAX package's row shard computes it in XLA (collection.py
    ``_csr_pooled_lookup``: a dropped entry reads row 0 and is multiplied
    by 0, then a segment sum): two tables of ragged bags with empty ones
    and padding, and dropped entries whose ids lie out of range."""
    n, d, b, t, cap = 96, 16, 10, 2, 40
    table = rng.standard_normal((n, d), dtype=np.float32)
    idx, off = [], []
    for _ in range(t):
        bags = [rng.integers(0, n, size=rng.integers(0, 6)).tolist() for _ in range(b)]
        bags[3] = []
        i, o = pack_bags(bags, cap, pad_index=int(rng.integers(0, n)))
        idx.append(i)
        off.append(o)
    off = np.stack(off)
    mask = rng.random((t, cap)) < 0.6
    far = np.where(rng.random((t, cap)) < 0.5, 1 << 30, -4)
    idx = np.where(mask, np.stack(idx), far).astype(np.int32)
    g = rng.standard_normal((t * b, d), dtype=np.float32)

    def pool(tab):
        outs = []
        for k in range(t):
            seg = segment_ids_from_offsets(jnp.asarray(off[k]), cap)
            keep = (seg < b) & jnp.asarray(mask[k])
            rows = tab[jnp.where(keep, jnp.asarray(idx[k]), 0)] * keep[:, None]
            outs.append(jax.ops.segment_sum(rows, jnp.minimum(seg, b),
                                            num_segments=b + 1)[:b])
        return jnp.concatenate(outs)

    want_out, vjp = jax.vjp(pool, jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    assert np.abs(want).max() > 0
    idx_t, off_t, mask_t, g_t = map(torch.from_numpy, (idx, off, mask, g))
    storage = torch.from_numpy(table.reshape(-1, 128) if packed else table.copy())
    storage.requires_grad_(True)
    before = (embedding_bag_csr_grad.launches, embedding_bag_csr_grad.masked_launches)
    out = embedding_bag_csr_packed(storage, d, idx_t, off_t, batch_size=b, mask=mask_t)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **TOL)
    out.backward(g_t)
    assert storage.grad.shape == storage.shape
    np.testing.assert_allclose(storage.grad.reshape(n, d).numpy(), want, **TOL)
    for m in (mask_t, mask_t.to(torch.uint8)):
        np.testing.assert_allclose(
            embedding_bag_csr_grad_reference(g_t, idx_t, off_t, n, m).numpy(), want, **TOL)
        torch.testing.assert_close(embedding_bag_csr_grad(g_t, idx_t, off_t, n, m),
                                   embedding_bag_csr_grad_reference(g_t, idx_t, off_t, n, m))
    assert (embedding_bag_csr_grad.launches,
            embedding_bag_csr_grad.masked_launches) == before  # CPU: no kernel
    with pytest.raises(ValueError, match="mask"):
        embedding_bag_csr_grad(g_t, idx_t, off_t, n, mask_t[:, :-1].contiguous())


# -- the wrappers -----------------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(indices=torch.zeros(8, dtype=torch.int64)),            # id dtype
    dict(offsets=torch.zeros(4, dtype=torch.int32)),            # B+1 boundaries
    dict(indices=torch.zeros(2, 8, dtype=torch.int32)),         # rank mismatch
    dict(storage=torch.zeros(16, 64)),                          # width
    dict(storage=torch.zeros(16, 128, dtype=torch.float16)),    # storage dtype
    dict(storage=torch.zeros(128, 16)[:, :8].t()),              # layout
    dict(offsets=torch.zeros(10, dtype=torch.int32)[::2]),      # not contiguous
])
def test_wrapper_rejects(bad):
    args = dict(storage=torch.zeros(16, 128), indices=torch.zeros(8, dtype=torch.int32),
                offsets=torch.zeros(5, dtype=torch.int32))
    args.update(bad)
    with pytest.raises((TypeError, ValueError)):
        embedding_bag_csr_packed(args["storage"], 16, args["indices"], args["offsets"],
                                 batch_size=4)


def test_cpu_tensors_count_no_launch():
    before = (embedding_bag_csr_packed.launches, embedding_bag_csr_sum.launches,
              embedding_bag_csr_grad.launches)
    idx = torch.zeros(4, dtype=torch.int32)
    off = torch.tensor([0, 1, 2, 3, 4], dtype=torch.int32)
    embedding_bag_csr_packed(torch.zeros(8, 128), 16, idx, off, batch_size=4)
    w = torch.zeros(8, 16, requires_grad=True)
    embedding_bag_csr_sum(w, idx, off, batch_size=4).sum().backward()
    assert (embedding_bag_csr_packed.launches, embedding_bag_csr_sum.launches,
            embedding_bag_csr_grad.launches) == before
    # importing and calling on the CPU builds nothing
    assert "csr_pool" not in csr_pool._build._loaded


@pytest.mark.parametrize("dtype,d,offset,want", [
    (torch.float32, 16, 0, (True, 4)),    # lane-packed d=16 f32: 4 threads a bag, 8 a warp
    (torch.float32, 16, 1, (False, 16)),  # the same storage one element in: scalar path
    (torch.float32, 128, 0, (True, 32)),  # K3: a warp a bag
    (torch.float32, 8, 4, (True, 2)),     # 4 f32 in is 16 bytes: still aligned
    # int8 codes lane-packed [S, 128], short bags: 8 codes a thread
    (torch.int8, 4, 0, (True, 1)),        # 4-byte rows: one word a thread
    (torch.int8, 16, 0, (True, 2)),       # the int8 Kaggle big set
    (torch.int8, 64, 0, (True, 8)),       # the capacity bench's rows
    (torch.int8, 128, 0, (True, 16)),
    (torch.int8, 16, 1, (False, 16)),     # one byte in: scalar path
    (torch.int8, 64, 1, (False, 32)),
    (torch.int8, 16, 4, (True, 4)),       # 4 bytes in: words
])
def test_csr_storage_row_path(dtype, d, offset, want):
    """The path the CSR wrapper passes to its kernel, for lane-packed
    [S, 128] storage and views of it."""
    buf = torch.zeros(8 * 128 + offset, dtype=dtype)
    storage = buf[offset:].view(8, 128)
    path = kernel_path(storage, d, 8, 8)
    assert (path.load > 0, path.group) == want


@pytest.mark.parametrize("group,capacity,batch,want", [
    (4, 9104, 8192, False),   # the CSR main path: pooling-1 mixture, 10 x 8192
    (4, 12480, 2048, True),   # the pooling-8 mixture, 10 x 2048
    (32, 25784, 8192, False),  # K3: 1M x 128, pooling-4 mixture
    (2, 9104, 8192, False),   # bf16 storage: 16 bags a tile
])
def test_csr_walk(group, capacity, batch, want):
    """The CSR walk goes by group where C / B entries a bag (padding
    included) fill a tile of 32 / group bags past 32 entries."""
    assert walks_by_group(group, capacity, batch) == want
