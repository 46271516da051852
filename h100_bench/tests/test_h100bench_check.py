"""The check: the plain reference against the port's CPU path on both
wires and at a bag length a table, each fault the check has to catch
caught, the inputs made from the seed as before, the yardstick's counts and
the per-layer readers by hand."""

from __future__ import annotations

import hashlib
import statistics
import sys
import types
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import toy  # noqa: E402

sys.path.insert(0, str(toy.REPO))
from h100_bench import gen, readers, reference, yardstick  # noqa: E402
from h100_bench.dense import dot  # noqa: E402
from h100_bench.manifest import Manifest  # noqa: E402
from h100_bench.tracing import Trace  # noqa: E402

CPU = torch.device("cpu")


def _system(cfg, seed):
    from h100_bench.systems.dot import PortSystem

    return PortSystem(cfg, seed, CPU)


def _batch(cfg, seed, i, pooling, wire="dense", batch_size=40, stream=0):
    return gen.batch(seed, i, table_rows_=tuple(cfg["tables"]), batch_size=batch_size,
                     pooling=pooling, dense_dim=cfg["dense_dim"], device=CPU, stream=stream,
                     wire=wire)


@pytest.mark.parametrize("pooling,wire", [(1, "dense"), (3, "dense"), ([2, 1, 4, 3], "dense"),
                                          ([2, 1, 4, 3], "csr"), (3, "csr")])
def test_reference_against_port(pooling, wire):
    cfg, seed = toy.TOY, 11
    s = _system(cfg, seed)
    dh = dot.DenseHalf(cfg, seed, CPU)
    for i in range(3):
        b = _batch(cfg, seed, i, pooling, wire)
        got = s.predict(b)
        want = reference.probabilities(cfg, seed, dh, b)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


# sha256 of dense, ids, mask and labels of gen.batch(seed, index, stream=...)
# as the harness made them before a bag length a table and the CSR wire
# came in (int pooling, dense wire): (seed, index, stream, rows, B, L, dense_dim)
PARENT_BATCHES = [
    ((7, 0, 0, (50, 20000, 300, 9000), 64, 1, 4),
     "624f4a59ca5ead7e372d1ac450486310ea5aed483214904c51ca60a6cb26e17d"),
    ((2**33 + 5, 2, 1, (50, 20000, 300, 9000), 32, 3, 4),
     "9a79706de97f71a29799f59e12783059aa18aa6a20c51da21387ce7f599c6373"),
    ((3000000019, 1, 0, (10, 1000, 8192, 500000), 16, 120, 13),
     "fa270a4ea93e78218c3037e8b2f8c231eed490963e398e45a9f7059122e0e7a7"),
]


def _digest(b):
    h = hashlib.sha256()
    for k in ("dense", "ids", "mask", "labels"):
        h.update(k.encode())
        h.update(b[k].contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("args,want", PARENT_BATCHES, ids=["l1", "l3-stream1", "l120"])
def test_int_pooling_batches_as_before(args, want):
    seed, index, stream, rows, bsz, pooling, dd = args
    kw = dict(table_rows_=rows, batch_size=bsz, dense_dim=dd, device=CPU, stream=stream)
    b = gen.batch(seed, index, pooling=pooling, **kw)
    assert b["ids"].dtype == torch.int32 and b["mask"].all()
    assert _digest(b) == want
    # a list of one equal length a table is the same batch
    same = gen.batch(seed, index, pooling=[pooling] * len(rows), **kw)
    assert all(torch.equal(b[k], same[k]) for k in b)


def test_equal_lengths_pool_alike_on_both_wires():
    cfg, seed = toy.TOY, 2**31 + 7
    t = len(cfg["tables"])
    want = reference.pooled(cfg, seed, _batch(cfg, seed, 1, 3), 40)
    for pooling, wire in (([3] * t, "dense"), (3, "csr"), ([3] * t, "csr")):
        got = reference.pooled(cfg, seed, _batch(cfg, seed, 1, pooling, wire), 40)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


def test_bag_lengths_by_table():
    """Table t's bags hold L_t ids on either wire, the same ids on both; on
    the dense wire the slots past L_t are masked off."""
    cfg, lengths, bsz = toy.TOY, [2, 1, 4, 3], 5
    dense = _batch(cfg, 9, 0, lengths, batch_size=bsz)
    csr = _batch(cfg, 9, 0, lengths, "csr", batch_size=bsz)
    assert dense["ids"].shape == csr["ids"].shape == (4, bsz * 4)
    assert torch.equal(dense["dense"], csr["dense"]) and torch.equal(dense["labels"],
                                                                     csr["labels"])
    for k, n in enumerate(lengths):
        assert torch.equal(csr["offsets"][k], torch.arange(bsz + 1, dtype=torch.int32) * n)
        slots = dense["mask"][k].view(bsz, 4)
        assert slots[:, :n].all() and not slots[:, n:].any()
        assert torch.equal(dense["ids"][k].view(bsz, 4)[:, :n].reshape(-1),
                           csr["ids"][k, :bsz * n])
        assert not csr["ids"][k, bsz * n:].any()
        assert int(csr["ids"][k].max()) < cfg["tables"][k]
    with pytest.raises(ValueError, match="bag lengths"):
        _batch(cfg, 9, 0, [1, 2])


def test_port_storage_holds_the_generated_rows():
    cfg, seed = toy.TOY, 5
    s = _system(cfg, seed)
    for t, n in enumerate(cfg["tables"]):
        ids = torch.tensor([0, n // 2, n - 1])
        torch.testing.assert_close(s.rows(t, ids), gen.table_rows(seed, cfg, t, ids),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("wire", ["dense", "csr"])
@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
@pytest.mark.parametrize("cfg,steps", [(toy.TOY, 1), (toy.TOY_BIG, 2)],
                         ids=["small-set-first-step", "no-small-set"])
def test_trainer_against_port_step(optimizer, cfg, steps, wire):
    """The first step over bf16-valued small tables, and later steps
    without a small set, whose rows the port pools in f32 as the reference
    does."""
    seed = 7
    s = _system(cfg, seed)
    s.make_train({"optimizer": optimizer, "lr": 0.1, "eps": 1e-8, "wire": wire})
    pooling = [2, 1, 3, 2][:len(cfg["tables"])] if wire == "csr" else 2
    bs = [_batch(cfg, seed, i, pooling, wire, batch_size=32, stream=1) for i in range(steps)]
    ref = reference.Trainer(cfg, seed, bs, dense_half=dot.DenseHalf(cfg, seed, CPU), lr=0.1,
                            optimizer=optimizer, eps=1e-8, device=CPU)
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
    assert dot.flops_per_sample(cfg, [1] * 26) == 2 * (bot + pairs * 16 + top)
    assert dot.flops_per_sample(cfg, [5] * 26) == 2 * (bot + pairs * 16 + top) + 26 * 4 * 16
    lengths = [1, 3] * 13
    assert (dot.flops_per_sample(cfg, lengths)
            == 2 * (bot + pairs * 16 + top) + 13 * 2 * 16)


def test_spread():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert yardstick.spread(v) == pytest.approx((q3 - q1) / 12.5)


@pytest.mark.parametrize("traffic,fault", [
    ("toy-score", "answer"), ("toy-score-l4", "answer"), ("toy-score-csr", "answer"),
    ("toy-train", "half"), ("toy-train", "state"),
    ("toy-train-sgd", "half"), ("toy-train-sgd", "state"),
    ("toy-train-csr", "half"), ("toy-train-csr", "state")])
def test_fault_caught(tmp_path, traffic, fault):
    """A run with the timed path broken underneath, the look for a card
    skipped: ``correct`` comes out false."""
    root = toy.make(tmp_path, (traffic,))
    result, proc = toy.run(root, f"{traffic}-cell", "--fault", fault)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


# -- the per-layer readers by hand ----------------------------------------------


def _span(name, lo, hi):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": lo, "dur": hi - lo}


def _activities(launches):
    """A runtime launch at host time ``t`` and its device activity ``name``
    of ``dur`` microseconds, tied by a correlation id."""
    out = []
    for corr, (t, dur, name) in enumerate(launches, start=1):
        out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
                    "dur": 2, "args": {"correlation": corr}})
        out.append({"ph": "X", "cat": "kernel", "name": name, "ts": 5000 + 100 * corr,
                    "dur": dur, "args": {"correlation": corr}})
    return out


# two forward calls: the lookup launches the small set's K1 (30, 40 us), a
# fill (5) and the big set's K1 (10, 12); the dense half 20 + 7 and 25 us;
# one kernel outside the calls
SCORE_EVENTS = [
    _span("window", 0, 1000),
    _span("pel.forward", 100, 200), _span("pel.lookup", 110, 170),
    _span("pel.forward", 500, 640), _span("pel.lookup", 510, 600),
    *_activities([(120, 30, "fixedl_pool_kernel<float, 16, 4, true>"), (130, 5, "fill"),
                  (150, 10, "fixedl_pool_kernel<float, 16, 4, false>"), (180, 20, "gemm"),
                  (190, 7, "relu"), (520, 40, "fixedl_pool_kernel<float, 16, 4, true>"),
                  (575, 12, "fixedl_pool_kernel<float, 16, 4, false>"), (610, 25, "gemm"),
                  (700, 50, "other")]),
]
READINGS = [
    ("lookup_ms.score", (30 + 5 + 10 + 40 + 12) / 2 * 1e-3),
    ("lookup_ms.longbag", (30 + 5 + 10 + 40 + 12) / 2 * 1e-3),
    ("dense_half_ms.score", (20 + 7 + 25) / 2 * 1e-3),
    ("dense_half_ms.longbag", (20 + 7 + 25) / 2 * 1e-3),
    # 3.35e6 bytes in both calls: 1 us at the HBM peak, over K1's 92 us
    ("pool_roofline.score", 1.0 / 92 * 100),
    ("pool_roofline.longbag", 1.0 / 92 * 100),
]


@pytest.mark.parametrize("metric,want", READINGS, ids=[r[0] for r in READINGS])
def test_reader_by_hand(metric, want):
    """Each reader on a made-up on-card trace; None off the card, and None
    on a trace without the port's spans or K1."""
    reader = Manifest(toy.REPO).reader(metric)

    def run(events, platform="gpu"):
        return types.SimpleNamespace(context={"platform": platform, "pool_bytes": 3.35e6},
                                     trace=Trace(events))

    assert reader.read(run(SCORE_EVENTS)) == pytest.approx(want, rel=1e-9)
    assert reader.read(run(SCORE_EVENTS, "cpu")) is None
    bare = [e for e in SCORE_EVENTS
            if not e["name"].startswith(("pel.", "fixedl"))]
    assert reader.read(run(bare)) is None


def test_dense_half_needs_the_lookup_span():
    """Without ``pel.lookup`` in the trace the dense half is not read as
    the whole forward."""
    no_lookup = [e for e in SCORE_EVENTS if e["name"] != "pel.lookup"]
    run = types.SimpleNamespace(context={"platform": "gpu"}, trace=Trace(no_lookup))
    assert readers.span_device_ms(run, "pel.forward") == pytest.approx(149 / 2 * 1e-3)
    assert readers.span_device_ms(run, "pel.forward", less="pel.lookup") is None


def test_pool_bytes_cover_both_sets():
    """``pool_roofline.score``'s bytes: every table of a batch, the small
    set's and the big set's, as the yardstick counts one pool launch."""
    from h100_bench import entries

    cfg = toy.TOY
    b = _batch(cfg, 4, 0, [2, 1, 3, 1], batch_size=8)
    want = sum(yardstick.pool_bytes(b["ids"][k:k + 1], b["mask"][k:k + 1], cfg["dim"])
               for k in range(4)) + yardstick.pool_out_bytes(4, 8, cfg["dim"])
    assert entries._pool_bytes(cfg, b) == want
