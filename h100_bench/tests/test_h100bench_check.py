"""The check: the plain reference against the port's CPU path, each fault
the check has to catch caught, and the yardstick's counts by hand."""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import toy  # noqa: E402

sys.path.insert(0, str(toy.REPO))
from h100_bench import gen, reference, yardstick  # noqa: E402

CPU = torch.device("cpu")


def _system(cfg, seed):
    from h100_bench.system import PortSystem

    return PortSystem(cfg, seed, CPU)


@pytest.mark.parametrize("pooling", [1, 3])
def test_reference_against_port(pooling):
    cfg, seed = toy.TOY, 11
    s = _system(cfg, seed)
    dh = reference.DenseHalf(cfg, seed, CPU)
    for i in range(3):
        b = gen.batch(seed, i, table_rows_=tuple(cfg["tables"]), batch_size=40, pooling=pooling,
                      dense_dim=cfg["dense_dim"], device=CPU)
        got = s.predict(b)
        want = reference.probabilities(cfg, seed, dh, b)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_port_storage_holds_the_generated_rows():
    cfg, seed = toy.TOY, 5
    s = _system(cfg, seed)
    for t, n in enumerate(cfg["tables"]):
        ids = torch.tensor([0, n // 2, n - 1])
        torch.testing.assert_close(s.rows(t, ids), gen.table_rows(seed, cfg, t, ids),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
@pytest.mark.parametrize("cfg,steps", [(toy.TOY, 1), (toy.TOY_BIG, 2)],
                         ids=["small-set-first-step", "no-small-set"])
def test_trainer_against_port_step(optimizer, cfg, steps):
    """The first step over bf16-valued small tables, and later steps
    without a small set, whose rows the port pools in f32 as the reference
    does."""
    seed = 7
    s = _system(cfg, seed)
    s.make_train({"optimizer": optimizer, "lr": 0.1, "eps": 1e-8})
    bs = [gen.batch(seed, i, table_rows_=tuple(cfg["tables"]), batch_size=32, pooling=2,
                    dense_dim=cfg["dense_dim"], device=CPU, stream=1) for i in range(steps)]
    ref = reference.Trainer(cfg, seed, bs, lr=0.1, optimizer=optimizer, eps=1e-8, device=CPU)
    for i, b in enumerate(bs):
        loss = float(s.train_step(b))
        assert loss == pytest.approx(ref.step(i, b)["loss"], rel=1e-6)
    for t in range(len(cfg["tables"])):
        torch.testing.assert_close(s.rows(t, ref.uniq[t]), ref.rows[t], rtol=1e-5, atol=1e-7)
    for name, p in s.dense_leaves().items():
        torch.testing.assert_close(p.detach(), ref.dense.leaves()[name].detach(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("strided", [False, True])
def test_fill_fused_holds_table_rows(strided):
    offsets, rows, total = (0, 7, 20), (7, 9, 3), 24
    cfg = {"tables": [5, 9, 3, 6, 7], "dim": 4, "small_set_max_rows": 8}
    parts = []
    for shard in range(2):
        st = torch.empty(total // 2, 4)
        gen.fill_fused(st, seed=2**33 + 1, cfg=cfg, table_ids=(4, 1, 2), row_offsets=offsets,
                       total_rows=total, shard=shard, num_shards=2, strided=strided)
        parts.append(st)
    full = torch.empty(total, 4)
    if strided:
        full[0::2], full[1::2] = parts
    else:
        full = torch.cat(parts)
    for tid, off, n in zip((4, 1, 2), offsets, rows):
        want = gen.table_rows(2**33 + 1, cfg, tid, torch.arange(n))
        assert torch.equal(full[off:off + n], want)
        assert float(want.abs().max()) <= 1 / n ** 0.5 * (1 + 2**-8)
        assert torch.equal(want.bfloat16().float(), want) == (n <= 8)
    assert torch.equal(full[16:20], torch.zeros(4, 4))
    assert torch.equal(full[23:], torch.zeros(1, 4))


def test_same_seed_same_inputs():
    kw = dict(table_rows_=(10, 1000), batch_size=8, pooling=2, dense_dim=3, device=CPU)
    a, b = gen.batch(2**31 + 9, 1, **kw), gen.batch(2**31 + 9, 1, **kw)
    c = gen.batch(2**31 + 10, 1, **kw)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["ids"], c["ids"])
    assert int(a["ids"][0].max()) < 10


def test_byte_model_by_hand():
    ids = torch.tensor([[1, 1, 2], [1, 3, 3]], dtype=torch.int32)
    keep = torch.tensor([[True, True, True], [True, True, False]])
    assert yardstick.distinct_rows(ids, keep) == 4  # {1, 2} and {1, 3}
    assert yardstick.pool_bytes(ids, keep, 16) == 4 * 16 * 4 + 6 * 5
    assert yardstick.pool_out_bytes(2, 3, 16) == 2 * 3 * 16 * 4


def test_flop_model_by_hand():
    cfg = {"tables": [10] * 26, "dim": 16, "dense_dim": 13, "mlp_bot": [512, 256, 64, 16],
           "mlp_top": [512, 256, 1]}
    bot = 13 * 512 + 512 * 256 + 256 * 64 + 64 * 16
    pairs = 27 * 26 // 2
    top = (16 + pairs) * 512 + 512 * 256 + 256
    assert yardstick.forward_flops_per_sample(cfg, 1) == 2 * (bot + pairs * 16 + top)
    assert (yardstick.forward_flops_per_sample(cfg, 5)
            == 2 * (bot + pairs * 16 + top) + 26 * 4 * 16)


def test_spread():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert yardstick.spread(v) == pytest.approx((q3 - q1) / 12.5)


@pytest.mark.parametrize("traffic,fault", [
    ("toy-score", "answer"), ("toy-score-l4", "answer"),
    ("toy-train", "half"), ("toy-train", "state"),
    ("toy-train-sgd", "half"), ("toy-train-sgd", "state")])
def test_fault_caught(tmp_path, traffic, fault):
    """A run with the timed path broken underneath, the look for a card
    skipped: ``correct`` comes out false."""
    root = toy.make(tmp_path, (traffic,))
    result, proc = toy.run(root, f"{traffic}-cell", "--fault", fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())
