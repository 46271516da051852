"""``ops.sparse_step`` on the CPU: the wrapper's refusals, its plan of a
collection, the path the dense-wire steps choose, and the plain version the
CPU takes (the kernel's launch counter stays at 0).  The kernel itself runs
in ``tests/test_torch_port_card.py``; the plain version is held to the JAX
package by ``tests/test_torch_port_sparse_update.py``."""

import dataclasses
from unittest import mock

import pytest
import torch

from pim_embedding_lookup_tpu_torch.config import ShardingPolicy, TableConfig
from pim_embedding_lookup_tpu_torch.ops import sparse_step as step_mod
from pim_embedding_lookup_tpu_torch.ops.sparse_step import (
    BIG,
    PRIVATE,
    SMALL,
    make_plan,
    privatized,
    sparse_step,
)
from pim_embedding_lookup_tpu_torch.parallel import hybrid as hybrid_mod
from pim_embedding_lookup_tpu_torch.parallel import sparse_update as update_mod
from pim_embedding_lookup_tpu_torch.parallel.collection import EmbeddingCollection
from pim_embedding_lookup_tpu_torch.parallel.hybrid import HybridEmbeddingCollection

DIM = 16
KAGGLE_ROWS = (1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683, 8351593,
               3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15, 286181, 105,
               142572)
MIXED_ROWS = (3, 24, 583, 1460, 9000, 20000)


def _tables(rows, dim=DIM):
    return tuple(TableConfig(num_rows=n, dim=dim, name=f"t{i}") for i, n in enumerate(rows))


def _hybrid(rows=MIXED_ROWS, policy=ShardingPolicy.REPLICATE):
    return HybridEmbeddingCollection.create(_tables(rows), policy, device="cpu")


def _query(rows, b, pooling, seed=0):
    gen = torch.Generator().manual_seed(seed)
    idx = torch.stack([torch.randint(0, n, (b * pooling,), generator=gen, dtype=torch.int32)
                       for n in rows])
    mask = torch.rand(idx.shape, generator=gen) < 0.7
    g = torch.randn(b, len(rows), DIM, generator=gen)
    return torch.where(mask, idx, 1 << 30), mask, g


def _step_args():
    """A plain collection's plan, its storage and accumulator, a query."""
    coll = EmbeddingCollection.create(_tables((50, 300, 17)), device="cpu")
    fused = coll.init(torch.Generator().manual_seed(1))
    acc = update_mod.init_accumulator(coll)
    idx, mask, g = _query((50, 300, 17), 8, 2)
    return update_mod.step_plan(coll), fused, acc, idx, mask, g


def _refused(case, plan, fused, acc, idx, mask, g):
    """The arguments of ``case``: (plan, small, big, indices, mask, g)."""
    big = (fused, acc)
    return {
        "indices_int64": (plan, None, big, idx.long(), mask, g),
        "mask_uint8": (plan, None, big, idx, mask.to(torch.uint8), g),
        "g_f64": (plan, None, big, idx, mask, g.double()),
        "storage_f16": (plan, None, (fused.half(), acc), idx, mask, g),
        "acc_f64": (plan, None, (fused, acc.double()), idx, mask, g),
        "tables": (plan, None, big, idx[:2].contiguous(), mask[:2].contiguous(),
                   g[:, :2].contiguous()),
        "dim": (plan, None, big, idx, mask, g[..., :8].contiguous()),
        "bags": (plan, None, big, idx, mask, g[:3].contiguous()),
        "storage_rows": (plan, None, (fused[:-1], acc), idx, mask, g),
        "acc_rows": (plan, None, (fused, acc[:-1]), idx, mask, g),
        "indices_strided": (plan, None, big, idx.t().contiguous().t(), mask, g),
        "g_strided": (plan, None, big, idx, mask, g.transpose(0, 1).contiguous()
                      .transpose(0, 1)),
        "device": (plan, None, big, idx, mask, g.to("meta")),
        "missing_set": (plan, None, None, idx, mask, g),
        "extra_set": (plan, big, big, idx, mask, g),
    }[case]


REFUSALS = ["indices_int64", "mask_uint8", "g_f64", "storage_f16", "acc_f64", "tables",
            "dim", "bags", "storage_rows", "acc_rows", "indices_strided", "g_strided",
            "device", "missing_set", "extra_set", "optimizer"]


@pytest.mark.parametrize("case", REFUSALS)
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    """A wrong dtype, shape, contiguity, device, set or optimizer raises
    before anything is written."""
    plan, fused, acc, idx, mask, g = _step_args()
    before = fused.clone(), acc.clone()
    launches = sparse_step.launches
    if case == "optimizer":
        args, kw = (plan, None, (fused, acc), idx, mask, g), dict(optimizer="adam")
    else:
        args, kw = _refused(case, plan, fused, acc, idx, mask, g), {}
    with pytest.raises((TypeError, ValueError)):
        sparse_step(*args, lr=0.1, **kw)
    assert torch.equal(fused, before[0]) and torch.equal(acc, before[1])
    assert sparse_step.launches == launches


def test_plan_of_kaggle_hybrid():
    """Kaggle's 16 small tables split by padded rows (at d=16 tables of at
    most 32 padded rows are summed in shared memory), its 10 big ones
    entry-wise; the launch order takes the privatized tables, then the
    other small ones, then the big ones, each in caller order."""
    coll = HybridEmbeddingCollection.create(_tables(KAGGLE_ROWS), device="cpu")
    plan = hybrid_mod.step_plan_hybrid(coll)
    assert hybrid_mod.step_plan_hybrid(coll) is plan  # built once
    npad = {t: max(8, 1 << (n - 1).bit_length()) for t, n in enumerate(KAGGLE_ROWS)}
    small = set(coll.small_ids)
    want = [BIG if t not in small else PRIVATE if npad[t] <= 32 else SMALL
            for t in range(len(KAGGLE_ROWS))]
    assert list(plan.kinds) == want
    assert (plan.count(PRIVATE), plan.count(SMALL), plan.count(BIG)) == (7, 9, 10)
    assert plan.private_rows == 32 and not privatized(64, DIM) and privatized(32, DIM)
    assert [plan.kinds[t] for t in plan.order] == sorted(want)
    for pos, t in enumerate(coll.small_ids):
        assert plan.firsts[t] == coll.small.layout.row_offsets[pos]
        assert plan.padded[t] == npad[t]
    for pos, t in enumerate(coll.big_ids):
        assert (plan.firsts[t], plan.padded[t]) == (coll.big.layout.row_offsets[pos], 0)
    assert (plan.small_rows, plan.big_rows) == (29456, coll.big.layout.total_rows)
    table = plan.tensors["table"].tolist()
    assert table[:3 * len(want)] == [x for row in zip(plan.kinds, plan.firsts, plan.padded)
                                     for x in row]
    assert tuple(table[3 * len(want):]) == plan.order


def test_plan_of_plain_collection_is_all_big_set():
    coll = EmbeddingCollection.create(_tables((50, 300, 17), dim=64), device="cpu")
    plan = update_mod.step_plan(coll)
    assert update_mod.step_plan(coll) is plan
    assert plan.kinds == (BIG,) * 3 and plan.order == (0, 1, 2)
    assert plan.firsts == coll.layout.row_offsets and plan.small_rows == 0
    assert plan.big_rows == coll.layout.total_rows and plan.dim == 64
    # wide rows: no small table of any size is privatized at d=128
    assert not privatized(8, 128)
    assert make_plan(DIM, "cpu", big=((1, 0), (0, 50), 60)).order == (0, 1)


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
@pytest.mark.parametrize("kind", ["hybrid", "plain"])
def test_cpu_step_takes_the_plain_version(kind, optimizer):
    """On the CPU ``sparse_update_hybrid`` and ``sparse_update`` go through
    ``ops.sparse_step``, which runs its plain version once, in place, and
    launches nothing."""
    rows = MIXED_ROWS if kind == "hybrid" else (50, 300, 17)
    idx, mask, g = _query(rows, 16, 2, seed=3)
    launches = sparse_step.launches
    with mock.patch.object(step_mod, "sparse_step_reference",
                           wraps=step_mod.sparse_step_reference) as plain:
        if kind == "hybrid":
            coll = _hybrid(rows)
            params = coll.init(torch.Generator().manual_seed(2))
            accs = hybrid_mod.init_accumulator_hybrid(coll)
            before = {k: v.clone() for k, v in params.items()}
            out, out_accs, dropped = hybrid_mod.sparse_update_hybrid(
                coll, params, accs, idx, mask, g, lr=0.1, optimizer=optimizer,
                return_stats=True)
            assert int(dropped) == 0
            assert all(out[k] is params[k] for k in params)  # in place
            changed = [not torch.equal(out[k], before[k]) for k in params]
        else:
            coll = EmbeddingCollection.create(_tables(rows), device="cpu")
            fused = coll.init(torch.Generator().manual_seed(2))
            before = fused.clone()
            acc = update_mod.init_accumulator(coll)
            out, out_acc = update_mod.sparse_update(coll, fused, acc, idx, mask, g, lr=0.1,
                                                    optimizer=optimizer)
            assert out is fused and out_acc is acc
            changed = [not torch.equal(out, before)]
    assert plain.call_count == 1 and all(changed)
    assert sparse_step.launches == launches


@pytest.mark.parametrize("case", ["one_process", "mesh", "routed", "column"])
def test_path_chooser(case):
    """The dense-wire step takes ``ops.sparse_step`` on one process only:
    a mesh, the routed path and COLUMN keep the eager step."""
    policy = ShardingPolicy.COLUMN if case == "column" else ShardingPolicy.REPLICATE
    rows = (50, 300, 17) if case == "column" else MIXED_ROWS
    tables = _tables(rows, dim=256 if case == "column" else DIM)
    coll = EmbeddingCollection.create(tables, policy, device="cpu")
    hybrid = HybridEmbeddingCollection.create(tables, policy, device="cpu",
                                              mxu_threshold=100)
    if case == "mesh":
        coll = dataclasses.replace(coll, mesh=mock.Mock())
        hybrid = dataclasses.replace(hybrid, big=dataclasses.replace(hybrid.big,
                                                                     mesh=mock.Mock()))
    routed = case == "routed"
    want = case == "one_process"
    assert update_mod.takes_sparse_step(coll, routed) is want
    assert hybrid_mod._takes_sparse_step(hybrid, routed) is want


@pytest.mark.parametrize("kind", ["hybrid", "plain"])
def test_csr_wire_keeps_the_eager_step(kind):
    """The CSR wire's steps never call ``ops.sparse_step``."""
    rows = MIXED_ROWS
    b = 8
    gen = torch.Generator().manual_seed(4)
    idx = torch.stack([torch.randint(0, n, (2 * b,), generator=gen, dtype=torch.int32)
                       for n in rows])
    off = (torch.arange(b + 1, dtype=torch.int32) * 2).repeat(len(rows), 1)
    g = torch.randn(b, len(rows), DIM, generator=gen)
    never = mock.Mock(side_effect=AssertionError("sparse_step on the CSR wire"))
    with mock.patch.object(update_mod, "sparse_step", never), \
            mock.patch.object(hybrid_mod, "sparse_step", never):
        if kind == "hybrid":
            coll = _hybrid(rows)
            hybrid_mod.sparse_update_hybrid_csr(
                coll, coll.init(torch.Generator()), hybrid_mod.init_accumulator_hybrid(coll),
                idx, off, g, lr=0.1, optimizer="row_adagrad")
        else:
            coll = EmbeddingCollection.create(_tables(rows), device="cpu")
            update_mod.sparse_update_csr(coll, coll.init(torch.Generator()),
                                         update_mod.init_accumulator(coll), idx, off, g,
                                         lr=0.1, optimizer="row_adagrad")
    never.assert_not_called()


def test_reference_drops_big_entries_outside_the_storage():
    """A kept entry whose fused row lies outside the big set's storage adds
    nothing, as the eager step's ownership test drops it."""
    plan, fused, acc, idx, mask, g = _step_args()
    bad = idx.clone()
    bad[2, :] = torch.where(mask[2], 10_000, bad[2])  # table 2 of 17 rows, the last
    want_f, want_a = fused.clone(), acc.clone()
    keep = mask.clone()
    keep[2] = False
    sparse_step(plan, None, (want_f, want_a), idx, keep, g, lr=0.1, optimizer="row_adagrad")
    sparse_step(plan, None, (fused, acc), bad, mask, g, lr=0.1, optimizer="row_adagrad")
    assert torch.equal(fused, want_f) and torch.equal(acc, want_a)
