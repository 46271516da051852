"""The port's CUDA kernels against their plain PyTorch versions on a CUDA
card: K1 (fixed-L gather+pool), K2/K3 (CSR gather+pool) and K4 (the
differentiable CSR bag, forward and backward), and the edge cases of the
warp-tile pool kernels on both row paths (16-byte vector and scalar).

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the repo's conftest, so on a machine with a card
and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_port_card.py -q
"""

import itertools

import numpy as np
import pytest
import torch

from pim_embedding_lookup_tpu_torch.ops.csr_pool import (
    embedding_bag_csr_grad,
    embedding_bag_csr_grad_reference,
    embedding_bag_csr_packed,
    embedding_bag_csr_packed_reference,
    embedding_bag_csr_sum,
)
from pim_embedding_lookup_tpu_torch.ops.gather_pool import (
    embedding_bag_fixedl,
    embedding_bag_fixedl_reference,
    row_path,
    walks_by_group,
)

pytestmark = pytest.mark.cuda

# f32 sums in another order; bf16 storage adds the same bf16 values in f32
# on both sides
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _csr(seed, n, t, b, max_len):
    """[T, C] ids and [T, B+1] offsets with empty bags and padding after
    offsets[B]."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, max_len + 1, size=(t, b))
    cap = -(-int(lens.sum(axis=1).max()) // 8) * 8 + 8
    off = np.zeros((t, b + 1), np.int32)
    np.cumsum(lens, axis=1, out=off[:, 1:])
    idx = rng.integers(0, n, size=(t, cap)).astype(np.int32)
    return torch.from_numpy(idx), torch.from_numpy(off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,pooling,packed", [(16, 1, True), (16, 8, True),
                                               (32, 3, False), (128, 4, False)])
def test_fixedl_kernel_matches_plain(cuda, dtype, d, pooling, packed):
    n, b = 5000, 900
    gen = torch.Generator(device=cuda).manual_seed(0)
    storage = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    if packed:
        storage = storage.reshape(-1, 128)
    ids = torch.randint(0, n, (b * pooling,), generator=gen, device=cuda,
                        dtype=torch.int32)
    mask = torch.rand(b * pooling, generator=gen, device=cuda) < 0.7
    before = embedding_bag_fixedl.launches
    got = embedding_bag_fixedl(storage, d, ids, pooling=pooling, batch_size=b, mask=mask)
    want = embedding_bag_fixedl_reference(storage, d, ids, pooling=pooling,
                                          batch_size=b, mask=mask)
    torch.cuda.synchronize()
    assert embedding_bag_fixedl.launches == before + 1
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,tables,packed", [(16, 3, True), (16, 1, False),
                                             (32, 2, True), (128, 1, False)])
def test_csr_kernel_matches_plain(cuda, dtype, d, tables, packed):
    n, b = 5000, 700
    gen = torch.Generator(device=cuda).manual_seed(1)
    storage = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    if packed:
        storage = storage.reshape(-1, 128)
    idx, off = (x.to(cuda) for x in _csr(2, n, tables, b, 6))
    before = embedding_bag_csr_packed.launches
    got = embedding_bag_csr_packed(storage, d, idx, off, batch_size=b)
    want = embedding_bag_csr_packed_reference(storage, d, idx, off, batch_size=b)
    torch.cuda.synchronize()
    assert embedding_bag_csr_packed.launches == before + 1
    assert got.shape == (tables * b, d)
    torch.testing.assert_close(got, want, **TOL)


def test_csr_kernel_skips_padding_and_empty_bags(cuda):
    table = torch.arange(64 * 16, dtype=torch.float32, device=cuda).reshape(64, 16)
    idx = torch.tensor([3, 5, 9, 10_000, -4], dtype=torch.int32, device=cuda)
    off = torch.tensor([0, 2, 2, 3], dtype=torch.int32, device=cuda)
    got = embedding_bag_csr_packed(table, 16, idx, off, batch_size=3)
    torch.cuda.synchronize()
    want = torch.stack([table[3] + table[5], torch.zeros_like(table[0]), table[9]])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bag_sum_kernels_match_plain(cuda, dtype):
    n, d, b = 3000, 16, 900
    gen = torch.Generator(device=cuda).manual_seed(3)
    idx, off = (x[0].to(cuda) for x in _csr(4, n, 1, b, 5))
    table = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    w = table.clone().requires_grad_(True)
    g = torch.randn(b, d, generator=gen, device=cuda).to(dtype)
    before = (embedding_bag_csr_sum.launches, embedding_bag_csr_grad.launches)
    out = embedding_bag_csr_sum(w, idx, off, batch_size=b)
    out.backward(g)
    torch.cuda.synchronize()
    assert (embedding_bag_csr_sum.launches, embedding_bag_csr_grad.launches) == (
        before[0] + 1, before[1] + 1)
    assert out.dtype == dtype and w.grad.dtype == dtype
    want = embedding_bag_csr_packed_reference(table, d, idx, off, batch_size=b)
    torch.testing.assert_close(out, want.to(dtype), **TOL)
    # f32 atomicAdd sums shared rows in an order that changes from run to
    # run; both sides add in f32 and round to the table's dtype once
    want_grad = embedding_bag_csr_grad_reference(g.float(), idx, off, n)
    torch.testing.assert_close(w.grad, want_grad.to(dtype), **TOL)


# -- edge cases of the warp-tile pool kernels (K1, and K2 for K3 and K4) ------

EDGE_ROWS = 128  # a multiple of every pack 128 / d
EDGE_BAGS = 37  # not a multiple of any warp tile (32 / group bags)
NEVER_READ = 1 << 30  # id of padding and masked entries: a read would fault
# (dtype, d, layout): packed [S, 128] where d | 128, [N, d], and an [N, d]
# view one element into its buffer, which takes the scalar path
EDGE_STORAGE = [
    (dtype, d, layout)
    for dtype, d in itertools.product((torch.float32, torch.bfloat16), (1, 4, 16, 20, 128, 256))
    for layout in ("packed", "unpacked", "unaligned")
    if layout != "packed" or (d < 128 and 128 % d == 0)
]


def _edge_storage(device, dtype, d, layout):
    gen = torch.Generator(device=device).manual_seed(d)
    rows = torch.randn(EDGE_ROWS, d, generator=gen, device=device).to(dtype)
    if layout == "packed":
        return rows.reshape(-1, 128)
    if layout == "unaligned":
        buf = torch.empty(EDGE_ROWS * d + 1, dtype=dtype, device=device)
        buf[1:] = rows.reshape(-1)
        return buf[1:].view(EDGE_ROWS, d)
    return rows


def _edge_csr(device, seed, tables, max_len, empty):
    """A fifth of the bags empty (all if ``empty``), the rest 1..max_len ids;
    padding past each table's offsets[B] holds NEVER_READ."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, max_len + 1, size=(tables, EDGE_BAGS))
    lens[rng.random((tables, EDGE_BAGS)) < 0.2] = 0
    if empty:
        lens[:] = 0
    off = np.zeros((tables, EDGE_BAGS + 1), np.int32)
    np.cumsum(lens, axis=1, out=off[:, 1:])
    cap = int(off[:, -1].max()) + 8
    idx = rng.integers(0, EDGE_ROWS, size=(tables, cap)).astype(np.int32)
    idx[np.arange(cap)[None, :] >= off[:, -1:]] = NEVER_READ
    return torch.from_numpy(idx).to(device), torch.from_numpy(off).to(device)


@pytest.mark.parametrize("tables,max_len,empty", [
    (1, 40, False),  # bags longer than the unroll and than a 32-id window
    (10, 6, False),  # T = 10, each table with its own end
    (3, 3, True),  # all bags empty
    (2, 100, False),  # long bags: every group walks its own
])
@pytest.mark.parametrize("dtype,d,layout", EDGE_STORAGE)
def test_csr_kernel_edge_cases(cuda, dtype, d, layout, tables, max_len, empty):
    storage = _edge_storage(cuda, dtype, d, layout)
    vector = layout != "unaligned" and d * storage.element_size() % 16 == 0
    assert row_path(storage, d)[0] == vector
    idx, off = _edge_csr(cuda, d + tables, tables, max_len, empty)
    if max_len == 100:
        assert walks_by_group(row_path(storage, d)[1], idx.shape[1], EDGE_BAGS)
    got = embedding_bag_csr_packed(storage, d, idx, off, batch_size=EDGE_BAGS)
    again = embedding_bag_csr_packed(storage, d, idx, off, batch_size=EDGE_BAGS)
    want = embedding_bag_csr_packed_reference(
        storage, d, torch.where(idx == NEVER_READ, 0, idx), off, batch_size=EDGE_BAGS)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)


@pytest.mark.parametrize("masking", ["none", "random", "all false"])
@pytest.mark.parametrize("pooling", [1, 3, 8, 9])
@pytest.mark.parametrize("dtype,d,layout", EDGE_STORAGE)
def test_fixedl_kernel_edge_cases(cuda, dtype, d, layout, pooling, masking):
    storage = _edge_storage(cuda, dtype, d, layout)
    rng = np.random.default_rng(pooling)
    n = EDGE_BAGS * pooling
    ids = torch.from_numpy(rng.integers(0, EDGE_ROWS, size=n).astype(np.int32)).to(cuda)
    mask = {"none": None, "random": torch.from_numpy(rng.random(n) < 0.6).to(cuda),
            "all false": torch.zeros(n, dtype=torch.bool, device=cuda)}[masking]
    read = ids if mask is None else torch.where(mask, ids, NEVER_READ)
    kw = dict(pooling=pooling, batch_size=EDGE_BAGS, mask=mask)
    got = embedding_bag_fixedl(storage, d, read, **kw)
    again = embedding_bag_fixedl(storage, d, read, **kw)
    want = embedding_bag_fixedl_reference(storage, d, ids, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)


def test_repeated_launches_are_bitwise_equal(cuda):
    """The forward kernels have no atomics and sum each bag in entry order:
    many launches over many bags give the same bits."""
    n, d, b = 100_000, 16, 20_000
    gen = torch.Generator(device=cuda).manual_seed(5)
    storage = torch.randn(n, d, generator=gen, device=cuda).reshape(-1, 128)
    idx, off = (x.to(cuda) for x in _csr(6, n, 4, b, 12))
    first = embedding_bag_csr_packed(storage, d, idx, off, batch_size=b)
    ids = torch.randint(0, n, (b * 8,), generator=gen, device=cuda, dtype=torch.int32)
    mask = torch.rand(b * 8, generator=gen, device=cuda) < 0.7
    first_k1 = embedding_bag_fixedl(storage, d, ids, pooling=8, batch_size=b, mask=mask)
    for _ in range(5):
        assert torch.equal(embedding_bag_csr_packed(storage, d, idx, off, batch_size=b), first)
        assert torch.equal(embedding_bag_fixedl(storage, d, ids, pooling=8, batch_size=b,
                                                mask=mask), first_k1)
