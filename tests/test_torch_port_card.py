"""The port's CUDA kernels against their plain PyTorch versions on a CUDA
card: K1 (fixed-L gather+pool), K2/K3 (CSR gather+pool) and K4 (the
differentiable CSR bag, forward and backward), and the edge cases of the
warp-tile pool kernels on both row paths (16-byte vector and scalar).  Then
the training path: the gradients of the big-set lookups through K1 and K2
against the plain versions' autograd, one sparse train step on the card
against the same step on the CPU, and dropped entries with ids far out of
range.  Last the sharded engine: K2 and K4's backward with a row shard's
ownership mask, and every sharded lookup, its gradient, the sparse update
and the dense-autodiff step on an NCCL mesh of one card against the same
call under REPLICATE.  Then the int8 kernels and serving, and the training
entry point's layers on the card: ``device_prefetch`` against its host
arrays, a full-state checkpoint round trip, and a toy CLI run.

Every test here is marked ``cuda`` and skips without a card.  The file
imports neither JAX nor the repo's conftest, so on a machine with a card
and no JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_port_card.py -q
"""

import itertools
from unittest import mock

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pim_embedding_lookup_tpu_torch import (
    DLRM,
    DLRMConfig,
    ShardingPolicy,
    TableConfig,
    kaggle_config,
    make_optimizer,
    make_train_step,
)
from pim_embedding_lookup_tpu_torch.models.sparse_train import (
    _apply_sparse_csr,
    make_sparse_train_state,
    make_sparse_train_step,
)
from pim_embedding_lookup_tpu_torch.models import bce_loss
from pim_embedding_lookup_tpu_torch.parallel import collection as collection_mod
from pim_embedding_lookup_tpu_torch.parallel.collection import EmbeddingCollection
from pim_embedding_lookup_tpu_torch.parallel.hybrid import (
    HybridEmbeddingCollection,
    step_plan_hybrid,
)
from pim_embedding_lookup_tpu_torch.parallel.mesh import MODEL_AXIS, init_distributed, make_mesh
from pim_embedding_lookup_tpu_torch.parallel.sparse_update import (
    init_accumulator,
    sparse_update,
    sparse_update_csr,
    step_plan,
)
from pim_embedding_lookup_tpu_torch.ops.csr_pool import (
    embedding_bag_csr_grad,
    embedding_bag_csr_grad_reference,
    embedding_bag_csr_packed,
    embedding_bag_csr_packed_reference,
    embedding_bag_csr_sum,
)
from pim_embedding_lookup_tpu_torch.ops.sparse_step import sparse_step, sparse_step_reference
from pim_embedding_lookup_tpu_torch.ops.gather_pool import (
    KernelPath,
    embedding_bag_fixedl,
    embedding_bag_fixedl_reference,
    fitted_path,
    group_size,
    kernel_path,
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
    assert (kernel_path(storage, d, 1, 1).load > 0) == vector
    idx, off = _edge_csr(cuda, d + tables, tables, max_len, empty)
    if max_len == 100:
        assert walks_by_group(kernel_path(storage, d, 1, 1).group, idx.shape[1], EDGE_BAGS)
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


# -- pinned kernel paths (the kernel lab's sweep) ----------------------------------

PINNED = [(load, group, by_group) for load in (16, 0)
          for group in (1, 2, 4, 8, 16, 32) for by_group in (False, True)]


@pytest.mark.parametrize("path", PINNED, ids=lambda p: "{}-G{}-{}".format(
    "vector" if p[0] else "scalar", p[1], "group" if p[2] else "window"))
@pytest.mark.parametrize("dtype,d", [(torch.float32, 16), (torch.bfloat16, 16),
                                     (torch.float32, 128)])
def test_pinned_paths_match_plain(cuda, dtype, d, path):
    """Every path a caller can pin (``path=``) gives the plain version's
    pools: K2 over CSR bags, K1 at L=3 and, on the window walk, at L=1;
    a vector path over an unaligned view is refused, not served scalar."""
    storage = _edge_storage(cuda, dtype, d, "unpacked")
    idx, off = _edge_csr(cuda, d, 3, 40, False)
    got = embedding_bag_csr_packed(storage, d, idx, off, batch_size=EDGE_BAGS, path=path)
    want = embedding_bag_csr_packed_reference(
        storage, d, torch.where(idx == NEVER_READ, 0, idx), off, batch_size=EDGE_BAGS)
    torch.testing.assert_close(got, want, **TOL)
    rng = np.random.default_rng(d)
    for pooling in (3,) if path[2] else (1, 3):
        ids = torch.from_numpy(rng.integers(0, EDGE_ROWS, size=EDGE_BAGS * pooling)
                               .astype(np.int32)).to(cuda)
        kw = dict(pooling=pooling, batch_size=EDGE_BAGS)
        torch.testing.assert_close(embedding_bag_fixedl(storage, d, ids, path=path, **kw),
                                   embedding_bag_fixedl_reference(storage, d, ids, **kw),
                                   **TOL)
    if path[0]:
        unaligned = _edge_storage(cuda, dtype, d, "unaligned")
        with pytest.raises(ValueError, match="16-byte"):
            embedding_bag_csr_packed(unaligned, d, idx, off, batch_size=EDGE_BAGS, path=path)


# -- the hybrid's small set: K1 over f32 rows rounded to bf16 -----------------------


def _ties(storage_rows):
    """f32 rows whose first 64 hold bf16 ties (the low 16 bits 0x8000, both
    parities of the kept bit), so that round-to-nearest-even shows."""
    bits = storage_rows.view(torch.int32)
    bits[:64] = (bits[:64] & ~0xFFFF) | 0x8000
    return storage_rows


def _in_entry_order(rows, mask, pooling):
    """Bag sums of [B*L, d] f32 rows in entry order from 0, the kernel's
    order; a masked entry adds nothing."""
    if mask is not None:
        rows = torch.where(mask[:, None], rows, 0.0)
    rows = rows.view(-1, pooling, rows.shape[1])
    acc = torch.zeros_like(rows[:, 0])
    for k in range(pooling):
        acc = acc + rows[:, k]
    return acc


# (d, layout, row load, by group, L): both row paths (16-byte loads and the
# scalar path, which an unaligned view takes), both walks (by group only
# where a tile holds more than one window's worth: not at L=1)
SMALL_CASES = [
    (d, layout, load, by_group, pooling)
    for d, layout in ((16, "packed"), (128, "unpacked"), (16, "unaligned"))
    for load in ((0,) if layout == "unaligned" else (16, 0))
    for pooling in (1, 4)
    for by_group in ((False,) if pooling == 1 else (False, True))
]


@pytest.mark.parametrize("masking", ["none", "random"])
@pytest.mark.parametrize("d,layout,load,by_group,pooling", SMALL_CASES)
def test_bf16_rounding_instance_is_bitwise_plain(cuda, d, layout, load, by_group, pooling,
                                                 masking):
    """K1's ``round_bf16`` instance (the hybrid's small set over f32 rows)
    on both row paths and both walks: bitwise the plain version at L=1, and
    at L=4 bitwise its rows rounded to bf16 summed in entry order; the
    unflagged f32 instance on the same path bitwise the unrounded rows.
    Ties round to even; masked ids are never read."""
    storage = _edge_storage(cuda, torch.float32, d, layout)
    _ties(storage.view(-1, d))
    path = KernelPath(load, group_size(storage, d, load), by_group)
    rng = np.random.default_rng(d + pooling)
    n = EDGE_BAGS * pooling
    ids = torch.from_numpy(rng.integers(0, EDGE_ROWS, size=n).astype(np.int32)).to(cuda)
    ids[:32] = torch.arange(32, device=cuda, dtype=torch.int32)  # rows with ties
    mask = None if masking == "none" else torch.from_numpy(rng.random(n) < 0.6).to(cuda)
    read = ids if mask is None else torch.where(mask, ids, NEVER_READ)
    kw = dict(pooling=pooling, batch_size=EDGE_BAGS, mask=mask, path=path)
    rows = storage.reshape(-1, d)[ids.long()]
    got = {}
    for rounded in (True, False):
        before = (embedding_bag_fixedl.launches, embedding_bag_fixedl.bf16_round_launches)
        got[rounded] = embedding_bag_fixedl(storage, d, read, round_bf16=rounded, **kw)
        torch.cuda.synchronize()
        assert (embedding_bag_fixedl.launches, embedding_bag_fixedl.bf16_round_launches) == (
            before[0] + 1, before[1] + rounded)
        want = _in_entry_order(rows.to(torch.bfloat16).float() if rounded else rows, mask,
                               pooling)
        assert torch.equal(got[rounded], want)
        if pooling == 1:
            plain = embedding_bag_fixedl_reference(storage, d, ids, pooling=1,
                                                   batch_size=EDGE_BAGS, mask=mask,
                                                   round_bf16=rounded)
            assert torch.equal(got[rounded], plain)
    assert not torch.equal(got[True], got[False])


def test_bf16_rounding_of_bf16_rows_is_the_bf16_instance(cuda):
    """bf16 rows need no rounding: ``round_bf16`` launches the bf16
    instance, bitwise the same, and counts no rounding launch; int8 codes
    are refused."""
    storage = _edge_storage(cuda, torch.bfloat16, 16, "packed")
    ids = torch.randint(0, EDGE_ROWS, (EDGE_BAGS * 3,), device=cuda, dtype=torch.int32)
    kw = dict(pooling=3, batch_size=EDGE_BAGS)
    before = embedding_bag_fixedl.bf16_round_launches
    got = embedding_bag_fixedl(storage, 16, ids, round_bf16=True, **kw)
    assert torch.equal(got, embedding_bag_fixedl(storage, 16, ids, **kw))
    assert embedding_bag_fixedl.bf16_round_launches == before
    codes = torch.zeros(EDGE_ROWS, 16, dtype=torch.int8, device=cuda)
    with pytest.raises(TypeError, match="round_bf16"):
        embedding_bag_fixedl(codes, 16, ids, round_bf16=True, **kw)


@pytest.mark.parametrize("l", [1, 3])
def test_hybrid_small_set_on_card_matches_cpu(cuda, l):
    """The hybrid's dense-wire lookup on the card against the CPU: the small
    set through the rounding instance, once a lookup, its pooled rows
    bitwise the CPU's at L=1; its storage gradient (each entry's cotangent
    and each row's sum rounded to bf16) within a bf16 unit."""
    rows = (3, 24, 583, 1460, 9000, 20000)
    tables = tuple(TableConfig(num_rows=n, dim=16, name=f"t{i}") for i, n in enumerate(rows))
    rng = np.random.default_rng(l)
    host = [rng.standard_normal((n, 16)).astype(np.float32) for n in rows]
    idx = np.stack([rng.integers(0, n, size=64 * l) for n in rows]).astype(np.int32)
    mask = rng.random(idx.shape) < 0.7
    g = torch.from_numpy(rng.standard_normal((64, len(rows), 16)).astype(np.float32))
    out, grads = [], []
    for dev in (cuda, torch.device("cpu")):
        coll = HybridEmbeddingCollection.create(tables, ShardingPolicy.REPLICATE, device=dev)
        params = coll.device_put_tables(host)
        params["small"].requires_grad_(True)
        before = embedding_bag_fixedl.bf16_round_launches
        pooled = coll.lookup(params, torch.from_numpy(idx).to(dev),
                             torch.from_numpy(mask).to(dev), batch_size=64)
        assert embedding_bag_fixedl.bf16_round_launches == before + (dev.type == "cuda")
        (pooled * g.to(dev)).sum().backward()
        out.append(pooled.detach().cpu())
        grads.append(params["small"].grad.cpu())
    small = list(coll.small_ids)
    if l == 1:
        assert torch.equal(out[0][:, small], out[1][:, small])
    torch.testing.assert_close(out[0], out[1], **TOL)
    torch.testing.assert_close(grads[0], grads[1], rtol=2.0 ** -7, atol=1e-6)


# -- the training path ------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,pooling,packed", [(16, 1, True), (16, 8, True), (32, 3, False)])
def test_fixedl_backward_matches_plain(cuda, dtype, d, pooling, packed):
    """K1 on storage that requires grad: the forward is one launch, the
    backward (the gather's transpose, summed in f32 and rounded once to the
    storage dtype) equals the plain version's autograd on the same values in
    f32 storage; bf16 within one bf16 ulp."""
    n, b = 5000, 900
    gen = torch.Generator(device=cuda).manual_seed(3)
    rows = torch.randn(n, d, generator=gen, device=cuda).to(dtype)
    ids = torch.randint(0, n, (b * pooling,), generator=gen, device=cuda, dtype=torch.int32)
    mask = torch.rand(b * pooling, generator=gen, device=cuda) < 0.7
    w = torch.randn(b, d, generator=gen, device=cuda)
    kw = dict(pooling=pooling, batch_size=b, mask=mask)
    grads = []
    for fn, src in ((embedding_bag_fixedl, rows), (embedding_bag_fixedl_reference, rows.float())):
        storage = (src.reshape(-1, 128) if packed else src).clone().requires_grad_(True)
        before = embedding_bag_fixedl.launches
        (fn(storage, d, torch.where(mask, ids, NEVER_READ) if fn is embedding_bag_fixedl
            else ids, **kw) * w).sum().backward()
        assert embedding_bag_fixedl.launches == before + (fn is embedding_bag_fixedl)
        assert storage.grad.dtype == storage.dtype and storage.grad.shape == storage.shape
        grads.append(storage.grad.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(grads[0], grads[1], **(
        TOL if dtype == torch.float32 else dict(rtol=2.0 ** -7, atol=1e-6)))

GRAD_ROWS = (5000, 300, 20000)


def _grad_coll(cuda, packed):
    tables = tuple(TableConfig(num_rows=n, dim=16, name=f"t{i}")
                   for i, n in enumerate(GRAD_ROWS))
    return EmbeddingCollection.create(tables, ShardingPolicy.REPLICATE, packed=packed,
                                      device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("wire", ["dense", "csr"])
def test_lookup_grad_matches_plain(cuda, wire, packed, dtype):
    """The table gradient through lookup (K1 forward, its transpose) or
    lookup_csr (K2 forward, K4's gradient kernel) equals the gradient of the
    same lookup pooled by the plain version, which autograd differentiates,
    over the same values in f32 storage.  The port sums the gradient in f32
    and rounds it once to the storage dtype: bf16 within one bf16 ulp.  The
    kernel runs once per lookup; without grad no autograd node is made."""
    coll = _grad_coll(cuda, packed)
    gen = torch.Generator(device=cuda).manual_seed(7)
    b = 700
    if wire == "dense":
        idx = torch.stack([torch.randint(0, n, (b * 3,), generator=gen, device=cuda,
                                         dtype=torch.int32) for n in GRAD_ROWS])
        mask = torch.rand(idx.shape, generator=gen, device=cuda) < 0.7
        look = lambda f: coll.lookup(f, idx, mask, batch_size=b)  # noqa: E731
        name, plain, counted = ("embedding_bag_fixedl", embedding_bag_fixedl_reference,
                                embedding_bag_fixedl)
    else:
        idx, off = (x.to(cuda) for x in _csr(8, min(GRAD_ROWS), len(GRAD_ROWS), b, 5))
        look = lambda f: coll.lookup_csr(f, idx, off)  # noqa: E731
        name, plain, counted = ("embedding_bag_csr_packed",
                                embedding_bag_csr_packed_reference, embedding_bag_csr_packed)
    w = torch.randn(b, len(GRAD_ROWS), 16, generator=gen, device=cuda)
    table = coll.init(gen, dtype)
    grads = []
    for patch in (False, True):
        fused = table.to(torch.float32 if patch else dtype, copy=True).requires_grad_(True)
        before = counted.launches
        if patch:
            with mock.patch.object(collection_mod, name, plain):
                (look(fused) * w).sum().backward()
        else:
            (look(fused) * w).sum().backward()
            assert counted.launches == before + 1
        grads.append(fused.grad.float())
    torch.cuda.synchronize()
    torch.testing.assert_close(grads[0], grads[1], **(
        TOL if dtype == torch.float32 else dict(rtol=2.0 ** -7, atol=1e-6)))
    with torch.no_grad():
        assert look(table.clone().requires_grad_(True)).grad_fn is None
    assert look(table).grad_fn is None


def _mixed_model(device, seed):
    rows = (3, 24, 583, 1460, 9000, 20000)
    cfg = DLRMConfig(dense_dim=13, mlp_bot=(32, 16), mlp_top=(32, 1),
                     tables=tuple(TableConfig(num_rows=n, dim=16, name=f"t{i}")
                                  for i, n in enumerate(rows)))
    return DLRM(cfg, ShardingPolicy.REPLICATE, hybrid=True, device=device,
                generator=torch.Generator(device="cpu").manual_seed(seed)
                if device == "cpu" else torch.Generator(device=device).manual_seed(seed))


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
@pytest.mark.parametrize("wire", ["dense", "csr"])
def test_sparse_step_matches_cpu(cuda, wire, optimizer):
    """One sparse train step on the card equals the same step of the port
    on the CPU (loss, tables, MLPs, accumulators), with padding ids of
    1 << 30 on the CSR wire.  The dense wire's step on the card is one
    launch of the sparse step kernel; the CSR wire's launches none."""
    cpu = _mixed_model("cpu", 3)
    gpu = _mixed_model(cuda, 3)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(9)
    b = 64
    rows = [t.num_rows for t in cpu.config.tables]
    dense = torch.from_numpy(rng.random((b, 13), dtype=np.float32))
    labels = torch.from_numpy((rng.random(b) < 0.5).astype(np.float32))
    if wire == "dense":
        idx = torch.from_numpy(np.stack([rng.integers(0, n, size=b * 2) for n in rows])
                               .astype(np.int32))
        second = torch.from_numpy(rng.random(idx.shape) < 0.8)
    else:
        idx, second = _csr(10, min(rows), len(rows), b, 4)
        idx[torch.arange(idx.shape[1])[None, :] >= second[:, -1:]] = NEVER_READ
    results = []
    launches = sparse_step.launches
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        opt, acc = make_sparse_train_state(model, optimizer=optimizer, lr=0.1)
        batch = [t.to(dev) for t in (dense, idx, second, labels)]
        if wire == "dense":
            acc, loss = make_sparse_train_step(model, opt, lr=0.1, optimizer=optimizer)(
                acc, *batch)
        else:
            with torch.no_grad():
                pooled = model.collection.lookup_csr(model.emb_params(), batch[1], batch[2])
            pooled.requires_grad_(True)
            loss = bce_loss(model.apply_from_pooled(batch[0], pooled), batch[3])
            loss.backward()
            opt.step()
            with torch.no_grad():
                _, acc = _apply_sparse_csr(model.collection, model.emb_params(), acc,
                                           batch[1], batch[2], pooled.grad, lr=0.1,
                                           optimizer=optimizer, eps=1e-8)
        results.append((loss.detach().cpu(), {k: v.cpu() for k, v in acc.items()},
                        {k: v.detach().cpu() for k, v in model.state_dict().items()}))
    torch.cuda.synchronize()
    assert sparse_step.launches - launches == (1 if wire == "dense" else 0)
    (lc, ac, sc), (lg, ag, sg) = results
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)
    for key in ac:
        torch.testing.assert_close(ag[key], ac[key], rtol=1e-4, atol=1e-4)
    for key in sc:
        torch.testing.assert_close(sg[key], sc[key], rtol=1e-4, atol=1e-4, msg=key)


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
def test_dropped_entries_change_nothing(cuda, optimizer):
    """Masked entries and CSR padding with ids of 1 << 30 neither assert on
    the card nor change anything: the same result as with valid ids there
    (within the order of f32 atomics), and rows no valid entry touched keep
    their bits."""
    coll = _grad_coll(cuda, True)
    gen = torch.Generator(device=cuda).manual_seed(11)
    table = coll.init(gen)
    b, t = 300, len(GRAD_ROWS)
    g = torch.randn(b, t, 16, generator=gen, device=cuda)
    ids = torch.stack([torch.randint(0, n, (b * 2,), generator=gen, device=cuda,
                                     dtype=torch.int32) for n in GRAD_ROWS])
    mask = torch.rand(ids.shape, generator=gen, device=cuda) < 0.6
    idx, off = (x.to(cuda) for x in _csr(12, min(GRAD_ROWS), t, b, 4))
    pad = torch.arange(idx.shape[1], device=cuda)[None, :] >= off[:, -1:]
    outs = []
    for poison in (True, False):
        fused, acc = table.clone(), init_accumulator(coll)
        dense_ids = torch.where(mask, ids, NEVER_READ if poison else 0)
        sparse_update(coll, fused, acc, dense_ids, mask, g, lr=0.1, optimizer=optimizer)
        sparse_update_csr(coll, fused, acc, torch.where(pad, NEVER_READ if poison else 0, idx),
                          off, g, lr=0.1, optimizer=optimizer)
        outs.append((fused, acc))
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-5, atol=1e-6)
    touched = torch.zeros(coll.layout.total_rows, dtype=torch.bool, device=cuda)
    touched[coll.globalize(ids)[mask].long()] = True
    touched[coll.globalize(idx)[~pad].long()] = True
    before, after = table.view(-1, 16), outs[0][0].view(-1, 16)
    assert torch.equal(after[~touched], before[~touched])
    assert not torch.equal(after[touched], before[touched])


# -- the sparse step kernel (ops.sparse_step) -------------------------------------

U = 2.0 ** -24  # f32 unit roundoff
BF16_ULP = 2.0 ** -7  # the largest bf16 spacing, relative to the value
KAGGLE_ROWS = tuple(t.num_rows for t in kaggle_config().tables)
# terabyte-train-2x2's kinds of table at d=128: small ones of 3-976 rows
# (padded to 8-1024), big ones row-sharded over 2
SHARD_ROWS = (3, 20000, 10, 36, 50001, 155, 976, 9001)


class _ModelShard:
    """Model shard ``shard`` of a (1, ``shards``) mesh with no process
    group: enough to plan a row shard and draw its storage."""

    def __init__(self, shards, shard, device):
        self.data, self.model, self.device = 1, shards, torch.device(device)
        self._shard = shard

    def index(self, axis):
        return self._shard if axis == MODEL_AXIS else 0


def _step_case(device, case, dtype):
    """(plan, small (storage, acc) or None, big (storage, acc), ids, mask,
    g) of a sparse step case: Kaggle's 16 + 10 split at B=65536, L=1 (all
    kept); a non-hybrid collection of random's shape at L=120, 7 in 10
    kept; the 3-row table beside a big one, all 65,536 entries kept; a big
    set whose entries fall on 400 rows, 8 in 10 kept; shard 0 of 2 under
    ROW_HASH, shard 1 of 2 under ROW and shard 0 of 2 under TABLE_WISE
    (whole tables a shard) of a hybrid at d=128 (the whole
    batch of 16,384, 9 in 10 kept: a half to two thirds of the big entries
    belong to the other shard, and the big tables' last entries, ids past the
    storage, to none).  Masked ids are 1 << 30.  Cotangents lie in {0,
    +-1/2, +-1} and accumulators (what earlier steps left) are multiples
    of 2^-8, so that every row's sums of cotangents and squares are exact
    in f32 in any order."""
    gen = torch.Generator(device=device).manual_seed(23)
    rows, b, pooling, keep, hybrid, dim, hot = {
        "kaggle": (KAGGLE_ROWS, 65536, 1, 1.0, True, 16, None),
        "random_l120": ((100_000,) * 8, 256, 120, 0.7, False, 64, None),
        "three_rows": ((3, 20000), 65536, 1, 1.0, True, 16, None),
        "big_duplicates": ((24, 20000, 50000), 4096, 4, 0.8, True, 16, 400),
        "row_hash_shard": (SHARD_ROWS, 16384, 1, 0.9, True, 128, None),
        "row_shard": (SHARD_ROWS, 16384, 1, 0.9, True, 128, None),
        "table_wise_shard": (SHARD_ROWS, 16384, 1, 0.9, True, 128, None),
    }[case]
    tables = tuple(TableConfig(num_rows=n, dim=dim, name=f"t{i}") for i, n in enumerate(rows))
    shard = {"row_hash_shard": (ShardingPolicy.ROW_HASH, 0),
             "row_shard": (ShardingPolicy.ROW, 1),
             "table_wise_shard": (ShardingPolicy.TABLE_WISE, 0)}.get(case)
    if shard is not None:
        coll = HybridEmbeddingCollection.create(tables, shard[0],
                                                mesh=_ModelShard(2, shard[1], device))
        assert step_plan_hybrid(coll).row_shard == (2, shard[1], case == "row_hash_shard")
    if hybrid and shard is None:
        coll = HybridEmbeddingCollection.create(tables, device=device)
    if hybrid:
        plan, params = step_plan_hybrid(coll), coll.init(gen, dtype)
        storages = [params["small"], params["big"]]
        big_ids = set(coll.big_ids)
    else:
        coll = EmbeddingCollection.create(tables, packed="auto", device=device)
        plan, storages = step_plan(coll), [None, coll.init(gen, dtype)]
        big_ids = set(range(len(rows)))
    sets = [None if w is None else
            (w, torch.randint(0, 26, (w.numel() // dim,), generator=gen,
                              device=device).float() * 2.0 ** -8)
            for w in storages]
    ids = torch.stack([torch.randint(0, hot if hot and t in big_ids else n, (b * pooling,),
                                     generator=gen, device=device, dtype=torch.int32)
                       for t, n in enumerate(rows)])
    mask = torch.rand(ids.shape, generator=gen, device=device) < keep
    if shard is not None:  # fused rows past every shard's storage
        ids[sorted(big_ids), -3:] = coll.big.layout.total_rows
    g = torch.randint(-2, 3, (b, len(rows), dim), generator=gen, device=device).float() * 0.5
    return plan, sets[0], sets[1], torch.where(mask, ids, NEVER_READ), mask, g


def _set_hits(plan, which, ids, mask, g):
    """Per row of a set, in f64: the kept entries n, the sums of their
    cotangents and of the cotangents' magnitudes [rows, D].  A big entry
    counts at its row of the storage, on a row shard only where the shard
    owns it (``collection._owner_local``)."""
    rows = plan.small_rows if which == "small" else plan.big_rows
    b, _, d = g.shape
    pooling = ids.shape[1] // b
    n = torch.zeros(rows, dtype=torch.float64, device=g.device)
    sums = torch.zeros(rows, d, dtype=torch.float64, device=g.device)
    abs_sums = torch.zeros(rows, d, dtype=torch.float64, device=g.device)
    bag = torch.arange(ids.shape[1], device=g.device) // pooling
    for t in (plan.small_ids if which == "small" else plan.big_ids):
        k = mask[t]
        r = plan.firsts[t] + ids[t][k].long()
        if which == "big" and plan.row_shard is not None:
            shards, shard, strided = plan.row_shard
            owner, local = collection_mod._owner_local(r, rows, shards, strided)
            owned = (owner == shard) & (local < rows)
            k = k.clone()
            k[mask[t]] = owned
            r = local[owned]
        ge = g[bag[k], t].double()
        n.index_add_(0, r, torch.ones_like(r, dtype=torch.float64))
        sums.index_add_(0, r, ge)
        abs_sums.index_add_(0, r, ge.abs())
    return n, sums, abs_sums


def _assert_step_close(which, got, want, before, hits, lr, eps, adagrad, d):
    """The kernel's (storage, acc) of a set against the plain version's.
    The cases' sums are exact in any order, so the accumulators agree bit
    for bit and a small-set row's step differs only by the rsqrt (the
    kernel's 1 / sqrt, correctly rounded; the plain version's rsqrt) and
    the rounding of w - step.  A big-set row adds its n steps to w one by
    one in another order (atomics on both sides on the card), each sum off
    by at most n * 2^-24 * (|w0| + sum |steps|), the bound of recursive
    summation.  bf16 storage adds a spacing where the two round (the small
    set once, the big set at each of its n adds).  Rows no entry touched
    keep their bits."""
    (gw, ga), (pw, pa), (w0, a0) = got, want, before
    n, sums, abs_sums = hits
    rows = n.shape[0]
    w0, gw, pw = (x.reshape(rows, d) for x in (w0, gw, pw))
    untouched = n == 0
    assert torch.equal(gw[untouched], w0[untouched]), f"{which}: an untouched row changed"
    if adagrad:
        assert torch.equal(ga, pa), f"{which}: the accumulators differ"
        scale = lr * (pa.double() + eps).rsqrt()
    else:
        assert torch.equal(ga, a0) and torch.equal(pa, a0)
        scale = torch.full_like(n, lr)
    nn, w_new, w_old = n[:, None], pw.double().abs(), w0.double().abs()
    bf16 = gw.dtype == torch.bfloat16
    if which == "small":  # densified: exact sums, one step, one rounding of w
        allowed = 8 * U * scale[:, None] * sums.abs() + 4 * U * w_new
        allowed = allowed + (BF16_ULP * w_new if bf16 else 0)
    else:  # entry-wise: n adds to w in another order
        s_a = scale[:, None] * abs_sums
        allowed = 2 * nn * U * (w_old + s_a) + 8 * U * s_a + 4 * U * w_new
        allowed = allowed + ((nn + 1) * BF16_ULP * (w_old + s_a) if bf16 else 0)
    diff = (gw.double() - pw.double()).abs()
    over = diff - 2 * allowed
    assert over.max().item() <= 0, (
        f"{which} storage: kernel differs from the plain version by {diff.max().item():.3g}, "
        f"past the bound by {over.max().item():.3g}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
@pytest.mark.parametrize("case", ["kaggle", "random_l120", "three_rows", "big_duplicates",
                                  "row_hash_shard", "row_shard", "table_wise_shard"])
def test_sparse_step_kernel_matches_plain(cuda, case, optimizer, dtype):
    """One launch of the sparse step kernel against its plain version on
    the card, from the same state: both sets' storage and accumulators
    within the summation bound of ``_assert_step_close`` (atomics sum in
    a varying order), rows no entry touched bitwise unchanged (on a row
    shard: every row no entry it owns touched, whatever the other shard's
    entries), masked ids of 1 << 30 never read."""
    plan, small, big, ids, mask, g = _step_case(cuda, case, dtype)
    kw = dict(lr=0.1, optimizer=optimizer, eps=1e-8)
    sets = {"small": small, "big": big}
    before = {k: None if v is None else tuple(x.clone() for x in v) for k, v in sets.items()}
    plain = {k: None if v is None else tuple(x.clone() for x in v) for k, v in sets.items()}
    launches = sparse_step.launches
    sparse_step(plan, small, big, ids, mask, g, **kw)
    assert sparse_step.launches == launches + 1
    sparse_step_reference(plan, plain["small"], plain["big"], ids, mask, g, **kw)
    torch.cuda.synchronize()
    for which, got in sets.items():
        if got is None:
            continue
        hits = _set_hits(plan, which, ids, mask, g)
        _assert_step_close(which, got, plain[which], before[which], hits, kw["lr"],
                           kw["eps"], optimizer == "row_adagrad", plan.dim)


def test_sparse_step_kernel_alerts_deterministic_mode(cuda):
    """Under ``torch.use_deterministic_algorithms(True)`` the kernel, whose
    atomics add in a varying order, raises before it launches; with
    ``warn_only=True`` it warns and launches."""
    plan, small, big, ids, mask, g = _step_case(cuda, "three_rows", torch.float32)
    kw = dict(lr=0.1, optimizer="row_adagrad", eps=1e-8)
    before = small[0].clone()
    launches = sparse_step.launches
    try:
        torch.use_deterministic_algorithms(True)
        with pytest.raises(RuntimeError, match="deterministic"):
            sparse_step(plan, small, big, ids, mask, g, **kw)
        assert sparse_step.launches == launches and torch.equal(small[0], before)
        torch.use_deterministic_algorithms(True, warn_only=True)
        with pytest.warns(UserWarning, match="sparse_step does not have a deterministic"):
            sparse_step(plan, small, big, ids, mask, g, **kw)
        assert sparse_step.launches == launches + 1
    finally:
        torch.use_deterministic_algorithms(False)


# -- the sharded engine ------------------------------------------------------------


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("d", [4, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_csr_kernel_matches_plain(cuda, dtype, d, packed):
    """K2 with a per-entry mask (a row shard's ownership) against its plain
    version: empty bags, bags whose entries are all masked (exactly 0),
    masked entries and padding, masked or not, holding ids of 1 << 30 that
    fault if read; d = 4 (f32: 16-byte rows; bf16: 8-byte rows, the scalar
    path) and 16, packed and unpacked, f32 and bf16 storage."""
    n, t, b, dead = 4096, 3, 300, 10
    rng = np.random.default_rng(d + 2 * packed)
    rows = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    storage = rows.to(dtype).reshape(-1, 128) if packed else rows.to(dtype)
    idx, off = _csr(20 + d, n, t, b, 6)
    mask = torch.from_numpy(rng.random(idx.shape) < 0.5)
    for ti in range(t):  # the first ``dead`` bags of each table: all masked
        mask[ti, :off[ti, dead]] = False
    valid = torch.arange(idx.shape[1])[None, :] < off[:, -1:]
    assert (mask & ~valid).any() and (~mask & ~valid).any()  # padding both ways
    idx = torch.where(mask & valid, idx, NEVER_READ)
    idx, off, mask = idx.to(cuda), off.to(cuda), mask.to(cuda)
    before = (embedding_bag_csr_packed.launches, embedding_bag_csr_packed.masked_launches)
    got = embedding_bag_csr_packed(storage, d, idx, off, batch_size=b, mask=mask)
    want = embedding_bag_csr_packed_reference(storage, d, idx, off, batch_size=b, mask=mask)
    torch.cuda.synchronize()
    assert (embedding_bag_csr_packed.launches, embedding_bag_csr_packed.masked_launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got.view(t, b, d)[:, :dead], torch.zeros(t, dead, d, device=cuda))
    # a uint8 mask is the same mask
    torch.testing.assert_close(
        embedding_bag_csr_packed(storage, d, idx, off, batch_size=b, mask=mask.to(torch.uint8)),
        got, rtol=0, atol=0)


@pytest.mark.parametrize("d,tables", [(16, 3), (4, 2), (16, 1), (20, 2), (128, 2)])
def test_masked_csr_grad_kernel_matches_plain(cuda, d, tables):
    """K4's backward with a per-entry mask against its plain version: empty
    bags, bags whose entries are all masked (no gradient), and masked
    entries and padding holding ids of 1 << 30 that fault if read; a uint8
    mask is the same mask.  The unmasked launch over the same entries adds
    the masked ones too."""
    n, b, dead = 2048, 300, 10
    rng = np.random.default_rng(d + tables)
    idx, off = _csr(40 + d, n, tables, b, 6)
    mask = torch.from_numpy(rng.random(idx.shape) < 0.5)
    for ti in range(tables):  # the first ``dead`` bags of each table: all masked
        mask[ti, :off[ti, dead]] = False
    valid = torch.arange(idx.shape[1])[None, :] < off[:, -1:]
    clean = idx.clone()
    idx = torch.where(mask & valid, idx, NEVER_READ)
    g = torch.from_numpy(rng.standard_normal((tables * b, d)).astype(np.float32))
    idx, off, mask, g, clean = (x.to(cuda) for x in (idx, off, mask, g, clean))
    rows = n
    before = (embedding_bag_csr_grad.launches, embedding_bag_csr_grad.masked_launches)
    got = embedding_bag_csr_grad(g, idx, off, rows, mask)
    want = embedding_bag_csr_grad_reference(g, idx, off, rows, mask)
    torch.cuda.synchronize()
    assert (embedding_bag_csr_grad.launches, embedding_bag_csr_grad.masked_launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(embedding_bag_csr_grad(g, idx, off, rows, mask.to(torch.uint8)),
                               got, **TOL)
    unmasked = embedding_bag_csr_grad(g, clean, off, rows)
    torch.testing.assert_close(unmasked, embedding_bag_csr_grad_reference(g, clean, off, rows),
                               **TOL)
    assert unmasked.abs().sum() > got.abs().sum()


MESH_ROWS = (100, 1000, 37, 4000)


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A (1, 1) mesh over an NCCL process group of one process, joined
    through a file store."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    init_distributed(0, 1, f"file://{tmp_path_factory.mktemp('nccl') / 'store'}")
    yield make_mesh(data=1, model=1)
    dist.destroy_process_group()


@pytest.mark.parametrize("policy", ["row", "row_hash", "table_wise", "column"])
def test_mesh_of_one_matches_replicate(nccl_mesh, policy):
    """On an NCCL mesh of one card each sharded call equals the same call
    under REPLICATE on the card: lookup and lookup_csr (both data_sharded
    forms) for sum/mean/max, the routed lookups with no drops, and one
    sparse row-AdaGrad update, broadcast and routed.  The masked kernels run
    on every row shard's lookup."""
    cuda = nccl_mesh.device
    rng = np.random.default_rng(0)
    tables = tuple(TableConfig(num_rows=n, dim=16, name=f"t{i}")
                   for i, n in enumerate(MESH_ROWS))
    host = [rng.standard_normal((n, 16)).astype(np.float32) for n in MESH_ROWS]
    sharded = EmbeddingCollection.create(tables, ShardingPolicy(policy), packed="auto",
                                         mesh=nccl_mesh)
    rep = EmbeddingCollection.create(tables, ShardingPolicy.REPLICATE, packed="auto",
                                     device=cuda)
    fs, fr = sharded.device_put_tables(host), rep.device_put_tables(host)
    b, pooling = 64, 3
    idx = torch.from_numpy(np.stack([rng.integers(0, n, b * pooling) for n in MESH_ROWS])
                           .astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random(idx.shape) < 0.7).to(cuda)
    cidx, coff = (x.to(cuda) for x in _csr(30, min(MESH_ROWS), len(MESH_ROWS), b, 5))
    rowish = policy != "column"
    before = (embedding_bag_fixedl.launches, embedding_bag_csr_packed.masked_launches)
    for comb in ("sum", "mean", "max"):
        torch.testing.assert_close(
            sharded.lookup(fs, idx, mask, batch_size=b, combiner=comb),
            rep.lookup(fr, idx, mask, batch_size=b, combiner=comb), **TOL)
        for ds in (False, True):
            torch.testing.assert_close(
                sharded.lookup_csr(fs, cidx, coff, combiner=comb, data_sharded=ds),
                rep.lookup_csr(fr, cidx, coff, combiner=comb), **TOL)
    launched = (embedding_bag_fixedl.launches - before[0],
                embedding_bag_csr_packed.masked_launches - before[1])
    # sum and mean pool through the kernels, on the mesh and under REPLICATE;
    # only a row shard masks
    assert launched == (4, 4 if rowish else 0)
    if rowish:
        for comb in ("sum", "mean"):
            out, dropped = sharded.lookup_routed(fs, idx, mask, batch_size=b, combiner=comb,
                                                 return_stats=True)
            assert int(dropped.item()) == 0
            torch.testing.assert_close(out, rep.lookup(fr, idx, mask, batch_size=b,
                                                       combiner=comb), **TOL)
            out, dropped = sharded.lookup_csr(fs, cidx, coff, combiner=comb, routed=True,
                                              return_stats=True)
            assert int(dropped.item()) == 0
            torch.testing.assert_close(out, rep.lookup_csr(fr, cidx, coff, combiner=comb),
                                       **TOL)
    g = torch.from_numpy(rng.standard_normal((b, len(MESH_ROWS), 16)).astype(np.float32))
    want_f, want_a = fr.clone(), init_accumulator(rep)
    sparse_update(rep, want_f, want_a, idx, mask, g.to(cuda), lr=0.1, optimizer="row_adagrad")
    for routed in (False, True) if rowish else (False,):
        f, a = fs.clone(), init_accumulator(sharded)
        sparse_update(sharded, f, a, idx, mask, g.to(cuda), lr=0.1, optimizer="row_adagrad",
                      routed=routed)
        # index_add_ adds rows hit by several entries in a run-dependent order
        np.testing.assert_allclose(np.concatenate(sharded.unfuse_host(f)),
                                   np.concatenate(rep.unfuse_host(want_f)), rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(_per_table(sharded, a), _per_table(rep, want_a),
                                   rtol=1e-5, atol=1e-6)


def _per_table(coll, acc):
    """A row-AdaGrad accumulator in table order, whatever the placement."""
    lay = coll.layout
    return torch.cat([acc[o:o + n] for o, n in zip(lay.row_offsets, lay.table_rows)])


@pytest.mark.parametrize("policy", ["row", "row_hash", "table_wise", "column"])
def test_mesh_of_one_gradients_match_replicate(nccl_mesh, policy):
    """On an NCCL mesh of one card the storage's gradient through each
    sharded call equals the gradient of the same call under REPLICATE:
    lookup (sum, mean; max on COLUMN), lookup_csr (both data_sharded forms),
    and the routed lookups; a row shard's MAX under grad raises JAX's
    error; one dense-autodiff step of a sharded DLRM equals REPLICATE's.
    A row shard's CSR gradient launches K4's masked backward."""
    cuda = nccl_mesh.device
    rng = np.random.default_rng(1)
    tables = tuple(TableConfig(num_rows=n, dim=16, name=f"t{i}")
                   for i, n in enumerate(MESH_ROWS))
    host = [rng.standard_normal((n, 16)).astype(np.float32) for n in MESH_ROWS]
    sharded = EmbeddingCollection.create(tables, ShardingPolicy(policy), packed="auto",
                                         mesh=nccl_mesh)
    rep = EmbeddingCollection.create(tables, ShardingPolicy.REPLICATE, packed="auto",
                                     device=cuda)
    fs, fr = sharded.device_put_tables(host), rep.device_put_tables(host)
    b, pooling = 64, 3
    idx = torch.from_numpy(np.stack([rng.integers(0, n, b * pooling) for n in MESH_ROWS])
                           .astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random(idx.shape) < 0.7).to(cuda)
    cidx, coff = (x.to(cuda) for x in _csr(31, min(MESH_ROWS), len(MESH_ROWS), b, 5))
    w = torch.from_numpy(rng.standard_normal((b, len(MESH_ROWS), 16)).astype(np.float32)).to(cuda)
    rowish = policy != "column"

    def grad(coll, storage, fn):
        table = storage.clone().requires_grad_(True)
        (fn(coll, table) * w).sum().backward()
        return np.concatenate(coll.unfuse_host(table.grad))

    calls = [lambda c, f, m=comb: c.lookup(f, idx, mask, batch_size=b, combiner=m)
             for comb in ("sum", "mean") + (() if rowish else ("max",))]
    calls += [lambda c, f, ds=ds: c.lookup_csr(f, cidx, coff, data_sharded=ds)
              for ds in (False, True)]
    masked = embedding_bag_csr_grad.masked_launches
    for fn in calls:
        np.testing.assert_allclose(grad(sharded, fs, fn), grad(rep, fr, fn), rtol=1e-5,
                                   atol=1e-5)
    assert embedding_bag_csr_grad.masked_launches - masked == (2 if rowish else 0)
    if rowish:
        for fn, ref in ((lambda c, f: c.lookup_routed(f, idx, mask, batch_size=b),
                         lambda c, f: c.lookup(f, idx, mask, batch_size=b)),
                        (lambda c, f: c.lookup_csr(f, cidx, coff, routed=True),
                         lambda c, f: c.lookup_csr(f, cidx, coff))):
            np.testing.assert_allclose(grad(sharded, fs, fn), grad(rep, fr, ref), rtol=1e-5,
                                       atol=1e-5)
        with pytest.raises(NotImplementedError, match="pmax"):
            sharded.lookup(fs.clone().requires_grad_(True), idx, mask, batch_size=b,
                           combiner="max")
    cfg = DLRMConfig(dense_dim=13, mlp_bot=(32, 16), mlp_top=(32, 1), tables=tables)
    dense = torch.from_numpy(rng.random((b, 13), dtype=np.float32)).to(cuda)
    labels = torch.from_numpy((rng.random(b) < 0.5).astype(np.float32)).to(cuda)
    states = []
    for pol, mesh in ((ShardingPolicy(policy), nccl_mesh), (ShardingPolicy.REPLICATE, None)):
        model = DLRM(cfg, pol, mesh=mesh, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(5))
        loss, _ = make_train_step(model, make_optimizer(0.1))(dense, idx, mask, labels)
        states.append((loss, model.collection.unfuse_host(model.emb),
                       [p.detach() for p in model.parameters()]))
    (ls, es, ps), (lr_, er, pr) = states
    torch.testing.assert_close(ls, lr_, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.concatenate(es), np.concatenate(er), rtol=1e-5, atol=1e-6)
    for a, r in zip(ps, pr):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)


# -- int8 storage: the capacity mode's instances of K1 and K2 --------------------

# (d, layout): vector rows (4-byte words; 8-byte loads where d is a
# multiple of 8) and the scalar path (an [N, d] view one byte into its
# buffer); d = 64 is the capacity bench's width
INT8_STORAGE = [(d, layout) for d in (4, 16, 20, 32, 64, 128)
                for layout in ("packed", "unpacked", "unaligned")
                if layout != "packed" or 128 % d == 0]
# (scale mode, int8 path): the path the wrapper picks (8- or 4-byte loads
# by bag length), and pinned, each of the loads it picks from
INT8_PATHS = [(mode, name) for mode in ("table", "row")
              for name in ("chosen", "8-byte", "4-byte")]


def _int8_path(name, storage, d, entries, bags):
    """The pin of an INT8_PATHS name for this storage (None: the wrapper's
    choice), where the storage takes its load, else the scalar path."""
    load = {"chosen": None, "8-byte": 8, "4-byte": 4}[name]
    return None if load is None else fitted_path(storage, d, entries, bags, load)


def _int8_storage(device, d, layout):
    """Codes in [-127, 127] with row 0 all zero, and per-row scales with
    row 0's 1 (a zero row's scale)."""
    gen = torch.Generator(device=device).manual_seed(100 + d)
    q = torch.randint(-127, 128, (EDGE_ROWS, d), generator=gen, device=device,
                      dtype=torch.int8)
    q[0] = 0
    scale = torch.rand(EDGE_ROWS, generator=gen, device=device) * 0.02 + 1e-4
    scale[0] = 1.0
    if layout == "packed":
        return q.reshape(-1, 128), scale
    if layout == "unaligned":
        buf = torch.empty(EDGE_ROWS * d + 1, dtype=torch.int8, device=device)
        buf[1:] = q.reshape(-1)
        return buf[1:].view(EDGE_ROWS, d), scale
    return q, scale


@pytest.mark.parametrize("masking", ["none", "random", "all false"])
@pytest.mark.parametrize("pooling", [1, 3, 9])
@pytest.mark.parametrize("mode,path", INT8_PATHS)
@pytest.mark.parametrize("d,layout", INT8_STORAGE)
def test_int8_fixedl_kernel_edge_cases(cuda, d, layout, mode, path, pooling, masking):
    """int8 K1 ("table": codes; "row": codes times per-row scales) on each
    int8 path against its plain version, on both row paths and both id
    walks, bitwise at L = 1; masked entries hold ids that fault if read,
    and so would their scales."""
    storage, scale = _int8_storage(cuda, d, layout)
    scale = scale if mode == "row" else None
    vector = layout != "unaligned" and d % 4 == 0
    assert (kernel_path(storage, d, 1, 1).load > 0) == vector
    rng = np.random.default_rng(pooling + d)
    n = EDGE_BAGS * pooling
    pin = _int8_path(path, storage, d, n, EDGE_BAGS)
    if pin is not None and pooling == 1:  # a single-hot tile is one window
        pin = pin._replace(by_group=False)
    ids = torch.from_numpy(rng.integers(0, EDGE_ROWS, size=n).astype(np.int32)).to(cuda)
    mask = {"none": None, "random": torch.from_numpy(rng.random(n) < 0.6).to(cuda),
            "all false": torch.zeros(n, dtype=torch.bool, device=cuda)}[masking]
    read = ids if mask is None else torch.where(mask, ids, NEVER_READ)
    kw = dict(pooling=pooling, batch_size=EDGE_BAGS, mask=mask, scale=scale)
    before = (embedding_bag_fixedl.int8_launches, embedding_bag_fixedl.int8_row_launches)
    got = embedding_bag_fixedl(storage, d, read, path=pin, **kw)
    again = embedding_bag_fixedl(storage, d, read, path=pin, **kw)
    want = embedding_bag_fixedl_reference(storage, d, ids, **kw)
    torch.cuda.synchronize()
    assert (embedding_bag_fixedl.int8_launches, embedding_bag_fixedl.int8_row_launches) == (
        before[0] + 2, before[1] + 2 * (mode == "row"))
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    if pooling == 1:  # one product a bag, rounded once on both sides
        assert torch.equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tables,max_len,empty", [(1, 40, False), (10, 6, False),
                                                  (3, 3, True), (2, 100, False)])
@pytest.mark.parametrize("mode,path", INT8_PATHS)
@pytest.mark.parametrize("d,layout", INT8_STORAGE)
def test_int8_csr_kernel_edge_cases(cuda, d, layout, mode, path, tables, max_len, empty,
                                    masked):
    """int8 K2 on each int8 path, unmasked and with a row shard's mask,
    against its plain version (bitwise on bags of at most one entry): empty
    bags, long bags (the by-group walk), padding and masked entries holding
    ids that fault if read."""
    storage, scale = _int8_storage(cuda, d, layout)
    scale = scale if mode == "row" else None
    idx, off = _edge_csr(cuda, d + tables, tables, max_len, empty)
    pin = _int8_path(path, storage, d, idx.shape[1], EDGE_BAGS)
    clean = torch.where(idx == NEVER_READ, 0, idx)
    mask = None
    if masked:
        mask = torch.from_numpy(np.random.default_rng(d).random(tuple(idx.shape)) < 0.5).to(cuda)
        idx = torch.where(mask, idx, NEVER_READ)
    kw = dict(batch_size=EDGE_BAGS, mask=mask, scale=scale)
    before = (embedding_bag_csr_packed.int8_launches, embedding_bag_csr_packed.int8_row_launches)
    got = embedding_bag_csr_packed(storage, d, idx, off, path=pin, **kw)
    again = embedding_bag_csr_packed(storage, d, idx, off, path=pin, **kw)
    want = embedding_bag_csr_packed_reference(storage, d, clean, off, **kw)
    torch.cuda.synchronize()
    assert (embedding_bag_csr_packed.int8_launches,
            embedding_bag_csr_packed.int8_row_launches) == (
        before[0] + 2, before[1] + 2 * (mode == "row"))
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, again)
    single = ((off[:, 1:] - off[:, :-1]) <= 1).reshape(-1)  # bags of 0 or 1 entries
    assert torch.equal(got[single], want[single])


# -- the masked walk: the kernels' sums in entry order ------------------------------

MASKED_L = 40  # past a 32-id window and a by-group round of G*U entries


def _entry_order(storage, d, idx, off, mask, scale=None):
    """Each bag's kept entries summed in f32 in entry order on the CPU,
    code times scale where ``scale`` is given: [T*B, d] for [T, C] ids and
    [T, B+1] offsets, on the storage's device.  Masked entries and padding
    are never read."""
    idx, off, mask = idx.cpu(), off.cpu(), mask.cpu()
    rows = storage.reshape(-1, d).cpu()
    scale = None if scale is None else scale.cpu()
    acc = torch.zeros(off.numel() - off.shape[0], d)
    for bag, (t, b) in enumerate(itertools.product(range(off.shape[0]), range(off.shape[1] - 1))):
        for e in range(int(off[t, b]), int(off[t, b + 1])):
            if mask[t, e]:
                i = int(idx[t, e])
                acc[bag] += rows[i].float() if scale is None else rows[i].float() * scale[i]
    return acc.to(storage.device)


def _masked_walk(device, storage, d, kernel, by_group, keep, seed, scale=None):
    """One masked K1 (L = MASKED_L) or K2 (two tables of bags of 0-80 ids)
    launch on the chosen path, its walk pinned to ``by_group``, twice:
    bitwise the sum in entry order (:func:`_entry_order`) and within TOL
    of the plain version; masked entries and padding hold NEVER_READ."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if kernel == "K1":
        n = EDGE_BAGS * MASKED_L
        ids = torch.randint(0, EDGE_ROWS, (n,), generator=gen, device=device, dtype=torch.int32)
        mask = torch.rand(n, generator=gen, device=device) < keep
        kw = dict(pooling=MASKED_L, batch_size=EDGE_BAGS, mask=mask, scale=scale)
        pin = kernel_path(storage, d, n, EDGE_BAGS)._replace(by_group=by_group)
        got, again = (embedding_bag_fixedl(storage, d, torch.where(mask, ids, NEVER_READ),
                                           path=pin, **kw) for _ in range(2))
        want = embedding_bag_fixedl_reference(storage, d, ids, **kw)
        off = torch.arange(EDGE_BAGS + 1, dtype=torch.int32)[None] * MASKED_L
        order = _entry_order(storage, d, ids[None], off, mask[None], scale)
    else:
        idx, off = _edge_csr(device, seed, 2, 80, False)
        mask = torch.rand(tuple(idx.shape), generator=gen, device=device) < keep
        clean = torch.where(idx == NEVER_READ, 0, idx)
        kw = dict(batch_size=EDGE_BAGS, mask=mask, scale=scale)
        pin = kernel_path(storage, d, idx.shape[1], EDGE_BAGS)._replace(by_group=by_group)
        got, again = (embedding_bag_csr_packed(storage, d, torch.where(mask, idx, NEVER_READ),
                                               off, path=pin, **kw) for _ in range(2))
        want = embedding_bag_csr_packed_reference(storage, d, clean, off, **kw)
        order = _entry_order(storage, d, idx, off, mask, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, order)
    assert torch.equal(again, order)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("by_group", [False, True], ids=["window", "group"])
@pytest.mark.parametrize("keep", [0.25, 1.0, 0.0])
@pytest.mark.parametrize("dtype,d,layout", EDGE_STORAGE)
def test_masked_walk_sums_in_entry_order(cuda, dtype, d, layout, keep, by_group, kernel):
    """K1 (by window the mask rides as flags, by group it is compacted) and
    masked K2 (compacted on both walks) add each bag's kept entries in
    entry order: bitwise the f32 sum of them in that order, 1 entry in 4
    kept (a row shard of 4), all kept and none kept, and within TOL of the
    plain version."""
    storage = _edge_storage(cuda, dtype, d, layout)
    _masked_walk(cuda, storage, d, kernel, by_group, keep, seed=d + int(keep * 4))


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("by_group", [False, True], ids=["window", "group"])
@pytest.mark.parametrize("mode", ["table", "row"])
@pytest.mark.parametrize("d,layout", INT8_STORAGE)
def test_int8_masked_walk_sums_in_entry_order(cuda, d, layout, mode, by_group, kernel):
    """The same for int8 K1 and K2 in both scale modes, 1 entry in 4 kept:
    each entry adds its code times its scale, rounded once; masked
    entries' scales are never read either."""
    storage, scale = _int8_storage(cuda, d, layout)
    _masked_walk(cuda, storage, d, kernel, by_group, 0.25, seed=d,
                 scale=scale if mode == "row" else None)


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    storage, scale = _int8_storage(cuda, 16, "unpacked")
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        embedding_bag_fixedl(storage.float(), 16, ids, pooling=1, batch_size=4, scale=scale)
    with pytest.raises(ValueError, match="scale"):
        embedding_bag_fixedl(storage, 16, ids, pooling=1, batch_size=4, scale=scale[:-1])
    with pytest.raises(TypeError, match="scale"):
        embedding_bag_fixedl(storage, 16, ids, pooling=1, batch_size=4, scale=scale.double())


@pytest.mark.parametrize("mode", ["table", "row"])
@pytest.mark.parametrize("wire", ["dense", "csr"])
def test_int8_hybrid_request_matches_cpu(cuda, wire, mode):
    """``quantize_dlrm_embeddings`` of the same model on the card and on the
    CPU: the same int8 params, and one request served through the int8 K1
    (dense wire) or K2 (CSR wire), launched once, to the same logits."""
    from pim_embedding_lookup_tpu_torch import quantize_dlrm_embeddings

    cpu = _mixed_model("cpu", 5)
    gpu = _mixed_model(cuda, 5)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(13)
    b = 64
    rows = [t.num_rows for t in cpu.config.tables]
    dense = torch.from_numpy(rng.random((b, 13), dtype=np.float32))
    if wire == "dense":
        idx = torch.from_numpy(np.stack([rng.integers(0, n, size=b * 2) for n in rows])
                               .astype(np.int32))
        second = torch.from_numpy(rng.random(idx.shape) < 0.8)
    else:
        idx, second = _csr(14, min(rows), len(rows), b, 4)
        idx[torch.arange(idx.shape[1])[None, :] >= second[:, -1:]] = NEVER_READ
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        coll, emb = quantize_dlrm_embeddings(model, scale_mode=mode)
        q = (idx.to(dev), second.to(dev))
        before = (embedding_bag_fixedl.int8_launches, embedding_bag_csr_packed.int8_launches)
        with torch.no_grad():
            pooled = (coll.lookup(emb, *q, batch_size=b) if wire == "dense"
                      else coll.lookup_csr(emb, *q))
            outs.append((model.apply_from_pooled(dense.to(dev), pooled).cpu(),
                         {k: v.cpu() for k, v in emb["big"].items()}))
        launched = (embedding_bag_fixedl.int8_launches - before[0],
                    embedding_bag_csr_packed.int8_launches - before[1])
        if dev == cuda:
            assert launched == ((1, 0) if wire == "dense" else (0, 1))
    torch.cuda.synchronize()
    (lc, pc), (lg, pg) = outs
    for key in pc:
        assert torch.equal(pg[key], pc[key]), key
    assert torch.isfinite(lg).all()
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["table", "row"])
def test_int8_mesh_of_one_matches_replicate(nccl_mesh, mode):
    """int8 under ROW_HASH on an NCCL mesh of one: the broadcast lookups
    (masked int8 K1 and K2) and the routed lookup with a hot cache built
    against the int8 params equal REPLICATE int8 on the card."""
    from pim_embedding_lookup_tpu_torch import QuantizedEmbeddingCollection
    from pim_embedding_lookup_tpu_torch.parallel.hotcache import (
        build_hot_cache,
        hot_ids_from_sample,
    )

    cuda = nccl_mesh.device
    rng = np.random.default_rng(1)
    tables = tuple(TableConfig(num_rows=n, dim=16, name=f"t{i}")
                   for i, n in enumerate(MESH_ROWS))
    host = [rng.standard_normal((n, 16)).astype(np.float32) for n in MESH_ROWS]
    sharded = QuantizedEmbeddingCollection.create(tables, ShardingPolicy.ROW_HASH,
                                                  scale_mode=mode, mesh=nccl_mesh)
    rep = QuantizedEmbeddingCollection.create(tables, ShardingPolicy.REPLICATE,
                                              scale_mode=mode, device=cuda)
    ps, pr = sharded.quantize_tables(host), rep.quantize_tables(host)
    b, pooling = 64, 3
    zipf = np.stack([(rng.zipf(1.3, b * pooling) - 1) % n for n in MESH_ROWS])
    idx = torch.from_numpy(zipf.astype(np.int32)).to(cuda)
    mask = torch.from_numpy(rng.random(idx.shape) < 0.8).to(cuda)
    cidx, coff = (x.to(cuda) for x in _csr(31, min(MESH_ROWS), len(MESH_ROWS), b, 5))
    want = rep.lookup(pr, idx, mask, batch_size=b)
    before = embedding_bag_csr_packed.masked_launches
    torch.testing.assert_close(sharded.lookup(ps, idx, mask, batch_size=b), want, **TOL)
    torch.testing.assert_close(sharded.lookup_csr(ps, cidx, coff), rep.lookup_csr(pr, cidx, coff),
                               **TOL)
    assert embedding_bag_csr_packed.masked_launches == before + 1
    cache = build_hot_cache(sharded, ps, hot_ids_from_sample(sharded, zipf, 16))
    assert cache[1].dtype == torch.float32
    out, dropped = sharded.lookup_routed(ps, idx, mask, batch_size=b, hot_cache=cache,
                                         return_stats=True)
    assert int(dropped.item()) == 0
    torch.testing.assert_close(out, want, **TOL)


# -- the data layer, checkpoints and the CLI on the card -----------------------


def test_prefetch_on_card_matches_host(cuda):
    """``device_prefetch`` stages each batch on a side stream; the consumer
    reads it only after the copy, and a batch dropped while a kernel still
    reads it keeps its memory until that kernel ends (``record_stream``):
    a sum launched behind a sleep kernel, with the batch deleted at once,
    equals the host array's sum."""
    from pim_embedding_lookup_tpu_torch.data import device_prefetch

    rng = np.random.default_rng(4)
    host = [(rng.random((2048, 13), dtype=np.float32),
             rng.integers(0, 1 << 20, size=(26, 2048)).astype(np.int32),
             rng.random((26, 2048)) < 0.9) for _ in range(16)]
    sums, seen = [], 0
    for batch in device_prefetch(iter(host), buffer_size=2, device=cuda):
        assert all(t.device.type == "cuda" for t in batch)
        torch.cuda._sleep(2_000_000)
        sums.append([t.double().sum() for t in batch])
        for got, want in zip(batch, host[seen]):
            assert torch.equal(got, torch.from_numpy(want).to(cuda))
        seen += 1
        del batch
    torch.cuda.synchronize()
    assert seen == 16
    for got, want in zip(sums, host):
        for s, w in zip(got, want):
            assert float(s) == float(np.asarray(w, np.float64).sum())


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """A full sparse train state saved from the card restores into a fresh
    model's tensors in place, on the card, bitwise."""
    from pim_embedding_lookup_tpu_torch.utils import checkpoint

    model = _mixed_model(cuda, 3)
    opt, acc = make_sparse_train_state(model, optimizer="row_adagrad", lr=0.1)
    with torch.no_grad():
        for a in acc.values():
            a.uniform_(0, 1)
    params = checkpoint.model_params(model)
    state = {"emb": params["emb"], "acc": acc, "dense": {k: params[k] for k in ("bot", "top")},
             "opt_state": opt.state_dict(), "step": 5}
    meta = {"collection": checkpoint.collection_meta(model.collection), "state": "full"}
    checkpoint.save(str(tmp_path / "ck"), state, meta=meta)
    fresh = _mixed_model(cuda, 4)
    opt2, acc2 = make_sparse_train_state(fresh, optimizer="row_adagrad", lr=0.1)
    p2 = checkpoint.model_params(fresh)
    st = checkpoint.restore(str(tmp_path / "ck"),
                            {"emb": p2["emb"], "acc": acc2,
                             "dense": {k: p2[k] for k in ("bot", "top")},
                             "opt_state": opt2.state_dict(), "step": 0}, expect_meta=meta)
    assert st["step"] == 5 and st["acc"]["big"] is acc2["big"]
    for key, want in model.state_dict().items():
        got = fresh.state_dict()[key]
        assert got.device.type == "cuda" and torch.equal(got, want), key
    for key in acc:
        assert torch.equal(acc2[key], acc[key])


def test_cli_toy_run_on_card(cuda, tmp_path):
    """The CLI with ``--device=cuda``: sparse training with reports and a
    full-state save, then inference from it."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ck = str(tmp_path / "ck")
    common = [sys.executable, "-m", "pim_embedding_lookup_tpu_torch.cli", "train",
              "--device=cuda", "--arch-embedding-size=200-9000-20000",
              "--arch-sparse-feature-size=16", "--arch-mlp-bot=4-16-16", "--arch-mlp-top=8-1",
              "--mini-batch-size=64", "--num-indices-per-lookup=2", "--hybrid",
              "--num-batches=4"]
    r = subprocess.run(common + ["--test-freq=2", "--optimizer=adagrad", f"--save-model={ck}"],
                       capture_output=True, text=True, cwd=repo, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "step 2:" in r.stdout and "step 4:" in r.stdout and "saved full train state" in r.stdout
    r = subprocess.run(common + ["--inference-only", "--print-time", f"--load-model={ck}"],
                       capture_output=True, text=True, cwd=repo, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "accuracy=" in r.stdout and "inference:" in r.stdout


# -- the lookup bench's configurations (bench.build_lookup) --------------------------


def _copy_params(dst, src):
    """Copy params ``src`` (tensors, dicts of them, None) into ``dst`` in
    place."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_params(dst[k], src[k])
    elif dst is not None:
        dst.copy_(src.cpu())


@pytest.mark.parametrize("wire,ragged", [("dense", False), ("csr", False), ("csr", True),
                                         ("csr-bucketed", True)])
@pytest.mark.parametrize("hybrid,dtype,scale", [
    (True, "float32", "table"), (True, "bfloat16", "table"), (True, "int8", "table"),
    (True, "int8", "row"), (False, "float32", "table"), (False, "bfloat16", "table"),
    (False, "int8", "table"), (False, "int8", "row")])
def test_bench_lookup_matches_cpu(cuda, hybrid, dtype, scale, wire, ragged):
    """Every branch of ``bench.build_lookup`` (hybrid or not, f32, bf16 and
    int8 in both scale modes, on every wire) at toy size: the first call on
    the card, through the pool kernels, against the same lookup on the CPU
    on the card's tables and the same ids."""
    from pim_embedding_lookup_tpu_torch import bench
    from pim_embedding_lookup_tpu_torch.tools import common

    tables = tuple(TableConfig(num_rows=n, dim=16, name=f"t{i}")
                   for i, n in enumerate((3, 24, 583, 1460, 9000, 20000)))
    kw = dict(seed=3, hybrid=hybrid, dtype=dtype, mxu_threshold=1000, wire=wire,
              int8_scale=scale, csr_ragged=ragged)
    on_card = bench.build_lookup(tables, 64, 3, device=cuda, **kw)
    on_cpu = bench.build_lookup(tables, 64, 3, device="cpu", **kw)
    _copy_params(on_cpu.params, on_card.params)
    before = sum(common.kernel_launches().values())
    got = on_card.fn(on_card.idx)
    torch.cuda.synchronize()
    assert sum(common.kernel_launches().values()) > before  # the big set's kernel ran
    torch.testing.assert_close(got.cpu(), on_cpu.fn(on_cpu.idx), **TOL)
