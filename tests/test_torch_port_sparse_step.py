"""``ops.sparse_step`` on the CPU: the wrapper's refusals, its plan of a
collection, the path the dense-wire steps choose, and the plain version the
CPU takes (the kernel's launch counter stays at 0), on a row shard bitwise
the eager step's operations.  The kernel itself runs in
``tests/test_torch_port_card.py``; the plain version is held to the JAX
package by ``tests/test_torch_port_sparse_update.py``, the mesh's path to
the eager one by ``tests/test_torch_port_sparse_step_mesh.py``."""

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
    apply_entries,
    densified_step,
    entry_updates,
    make_plan,
    private_copies,
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
    # wide rows: one copy a block, so tables of up to 64 padded rows are
    # privatized at d=128 (terabyte-train-2x2's 3- to 63-row tables)
    assert (private_copies(DIM), private_copies(128)) == (8, 1)
    assert privatized(64, 128) and not privatized(128, 128)
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


@pytest.mark.parametrize("case", ["one_process", "mesh", "routed", "column", "mesh_column",
                                  "mesh_routed"])
def test_path_chooser(case):
    """The dense-wire step takes ``ops.sparse_step`` on one process and on
    a mesh: the routed path and COLUMN, on either, keep the eager step."""
    column = case.endswith("column")
    policy = ShardingPolicy.COLUMN if column else ShardingPolicy.REPLICATE
    rows = (50, 300, 17) if column else MIXED_ROWS
    tables = _tables(rows, dim=256 if column else DIM)
    coll = EmbeddingCollection.create(tables, policy, device="cpu")
    hybrid = HybridEmbeddingCollection.create(tables, policy, device="cpu",
                                              mxu_threshold=100)
    if case.startswith("mesh"):
        coll = dataclasses.replace(coll, mesh=mock.Mock())
        hybrid = dataclasses.replace(hybrid, big=dataclasses.replace(hybrid.big,
                                                                     mesh=mock.Mock()))
    routed = case.endswith("routed")
    want = case in ("one_process", "mesh")
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


class _ModelShard:
    """Model shard ``shard`` of a (1, ``shards``) mesh with no process
    group: enough to plan a row shard and draw its storage."""

    def __init__(self, shards, shard):
        self.data, self.model, self.device = 1, shards, torch.device("cpu")
        self._shard = shard

    def index(self, axis):
        return self._shard if axis == "model" else 0


@pytest.mark.parametrize("mesh", [None, (1, 0), (2, 1)])
@pytest.mark.parametrize("policy", [ShardingPolicy.ROW, ShardingPolicy.ROW_HASH,
                                    ShardingPolicy.TABLE_WISE])
def test_row_shard_only_over_shards(policy, mesh):
    """The plan carries a row shard only where the big set is cut into
    more than one: one process, or a model axis of one, keeps the one-card
    plan (every row, no ownership test), whatever the policy."""
    kw = {"device": "cpu"} if mesh is None else {"mesh": _ModelShard(*mesh)}
    coll = HybridEmbeddingCollection.create(_tables(MIXED_ROWS), policy, **kw)
    plain = EmbeddingCollection.create(_tables(MIXED_ROWS), policy, **kw)
    for c, plan in ((coll.big, hybrid_mod.step_plan_hybrid(coll)),
                    (plain, update_mod.step_plan(plain))):
        lay = c.layout
        if mesh is None or mesh[0] == 1:
            assert plan.row_shard is None and plan.big_rows == lay.total_rows
        else:
            assert plan.row_shard == (2, 1, policy == ShardingPolicy.ROW_HASH)
            assert plan.big_rows == lay.rows_per_shard < lay.total_rows
        assert update_mod.init_accumulator(c).numel() == plan.big_rows


def _eager_step(coll, params, accs, indices, mask, g, *, lr, optimizer, eps=1e-8):
    """The mesh's step as the eager path takes it on a gathered stream,
    in place: the small set's selection expanded and stepped densified,
    the big set's globalized, expanded, kept by ``_owned_entries`` and
    applied entry by entry."""
    pooling = indices.shape[1] // g.shape[0]
    sel = list(coll.small_ids)
    idx, mk = indices[sel], mask[sel]
    _, g_e, _ = entry_updates(idx, mk, g[:, sel], pooling)
    densified_step(coll.buckets, params["small"], accs["small"], idx, mk,
                   g_e.reshape(*idx.shape, -1), lr=lr, optimizer=optimizer, eps=eps)
    sel = list(coll.big_ids)
    ids, updates, valid = entry_updates(coll.big.globalize(indices[sel]), mask[sel], g[:, sel],
                                        pooling)
    local, keep = update_mod._owned_entries(coll.big, ids, valid)
    apply_entries(params["big"], accs["big"], local, updates, keep, lr=lr, eps=eps,
                  use_adagrad=optimizer == "row_adagrad")


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
@pytest.mark.parametrize("shard", [0, 1])
@pytest.mark.parametrize("policy", [ShardingPolicy.ROW, ShardingPolicy.ROW_HASH])
def test_row_shard_reference_is_the_eager_step(policy, shard, optimizer):
    """On a row shard the plain version keeps the big entries the shard
    owns (the plan's ``row_shard``) and steps both sets with the eager
    step's operations on the same gathered stream: storage and
    accumulators bit for bit, from a state that earlier steps left."""
    rows = (3, 24, 583, 9000, 20000, 50000)
    coll = HybridEmbeddingCollection.create(_tables(rows), policy,
                                            mesh=_ModelShard(2, shard), mxu_threshold=1000)
    plan = hybrid_mod.step_plan_hybrid(coll)
    assert plan.row_shard == (2, shard, policy == ShardingPolicy.ROW_HASH)
    assert plan.big_rows == coll.big.layout.rows_per_shard
    idx, mask, g = _query(rows, 32, 2, seed=7)
    params = coll.init(torch.Generator().manual_seed(8))
    gen = torch.Generator().manual_seed(9)
    accs = {k: torch.rand(v.numel() // DIM, generator=gen) for k, v in params.items()}
    want_p = {k: v.clone() for k, v in params.items()}
    want_a = {k: v.clone() for k, v in accs.items()}
    _eager_step(coll, want_p, want_a, idx, mask, g, lr=0.1, optimizer=optimizer)
    sparse_step(plan, (params["small"], accs["small"]), (params["big"], accs["big"]), idx,
                mask, g, lr=0.1, optimizer=optimizer)
    for key in params:
        assert torch.equal(params[key].view(torch.int32), want_p[key].view(torch.int32)), key
        assert torch.equal(accs[key].view(torch.int32), want_a[key].view(torch.int32)), key
    assert not torch.equal(params["big"], coll.init(torch.Generator().manual_seed(8))["big"])
