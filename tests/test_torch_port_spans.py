"""The port's own spans (``utils.profiling.span``): free while no profiler
records, once a call at each layer boundary while one does, nested as the
layers are, with no effect on a result; ``h100_bench.tracing.Trace`` reads
them back, and the benchmark's readers of them give what is worked out by
hand from a trace made up for them."""

from __future__ import annotations

import contextlib
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pim_embedding_lookup_tpu_torch.config as tcfg
from pim_embedding_lookup_tpu_torch.models import DLRM
from pim_embedding_lookup_tpu_torch.models import sparse_train as tst
from pim_embedding_lookup_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from h100_bench.manifest import Manifest  # noqa: E402
from h100_bench.tracing import Trace  # noqa: E402

MIXED_ROWS = (50, 20000, 300, 9000)  # two tables on each side of the split
BIG_ROWS = (9000, 20000, 12000)  # every table above it
B, CALLS = 16, 3

FORWARD = {"pel.forward": None, "pel.lookup": "pel.forward",
           "pel.lookup.small": "pel.lookup", "pel.lookup.big": "pel.lookup"}
TRAIN = {"pel.train_step": None, "pel.lookup": "pel.train_step",
         "pel.lookup.small": "pel.lookup", "pel.lookup.big": "pel.lookup",
         "pel.train.dense": "pel.train_step", "pel.sparse_update": "pel.train_step",
         "pel.interact.backward": "pel.train.dense"}
SIBLINGS = [("pel.lookup.small", "pel.lookup.big"), ("pel.lookup", "pel.train.dense"),
            ("pel.train.dense", "pel.sparse_update"), ("pel.lookup", "pel.sparse_update"),
            ("pel.lookup", "pel.cross")]
# a DCNv2 model's cross network: inside the forward, and inside the train
# step's dense half; it has no dot interaction, so no backward of one
FORWARD_DCN = dict(FORWARD, **{"pel.cross": "pel.forward"})
TRAIN_DCN = {**{k: v for k, v in TRAIN.items() if k != "pel.interact.backward"},
             "pel.cross": "pel.train.dense"}
DCN = dict(interaction="dcn", dcn_num_layers=2, dcn_low_rank_dim=4)


def _model(rows, seed=0, **dcn):
    cfg = tcfg.DLRMConfig(dense_dim=5, mlp_bot=(16, 8), mlp_top=(16, 1),
                          tables=tuple(tcfg.TableConfig(num_rows=n, dim=8, name=f"t{i}")
                                       for i, n in enumerate(rows)), **dcn)
    return DLRM(cfg, tcfg.ShardingPolicy.REPLICATE, hybrid=True, device="cpu",
                generator=torch.Generator().manual_seed(seed))


def _batches(rows, n=CALLS, pooling=2):
    rng = np.random.default_rng(3)
    out = []
    for _ in range(n):
        ids = np.stack([rng.integers(0, r, B * pooling) for r in rows]).astype(np.int32)
        out.append((torch.from_numpy(rng.random((B, 5), dtype=np.float32)),
                    torch.from_numpy(ids),
                    torch.from_numpy(rng.random(ids.shape) < 0.8),
                    torch.from_numpy((rng.random(B) < 0.5).astype(np.float32))))
    return out


def _annotations(prof, tmp_path) -> tuple[list[dict], dict]:
    """The chrome trace's events, and its user spans by name as sorted
    (start, end) pairs in microseconds."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    return events, {k: sorted(v) for k, v in spans.items()}


def _run(kind, rows, optimizer="row_adagrad", *, traced, tmp_path=None, dcn=False):
    """``CALLS`` forward calls or sparse train steps on a fresh model (a
    DCNv2 one with ``dcn``); with ``traced``, under ``torch.profiler``.
    Returns (results, events, spans)."""
    model = _model(rows, **(DCN if dcn else {}))
    batches = _batches(rows)
    if kind == "forward":
        def call(b):
            with torch.no_grad():
                return model(*b[:3])
    else:
        opt, acc = tst.make_sparse_train_state(model, optimizer=optimizer, lr=0.1)
        step = tst.make_sparse_train_step(model, opt, lr=0.1, optimizer=optimizer)
        state = {"acc": acc}

        def call(b):
            state["acc"], loss = step(state["acc"], *b)
            return loss
    ctx = profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()
    with ctx as prof:
        outs = [call(b) for b in batches]
    if kind == "train":
        outs += list(model.state_dict().values())
        outs += [a for a in state["acc"].values() if a is not None]
    if not traced:
        return outs, None, None
    return (outs, *_annotations(prof, tmp_path))


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _check_tree(spans, tree, calls):
    pel = {k for k in spans if k.startswith("pel.")}
    assert pel == set(tree), pel
    for name, parent in tree.items():
        assert len(spans[name]) == calls, (name, spans[name])
        if parent is not None:
            for iv in spans[name]:
                assert sum(_inside(iv, p) for p in spans[parent]) == 1, (name, iv)
    for a, b in SIBLINGS:
        for x in spans.get(a, []):
            for y in spans.get(b, []):
                assert x[1] <= y[0] or y[1] <= x[0], (a, x, b, y)


def test_span_off_is_one_shared_noop(monkeypatch):
    """With no profiler recording, ``span`` makes no ``record_function``:
    every call hands back one no-op, and a forward call and a train step
    make none named ``pel.*`` (the optimizers make their own); with one
    recording, each span is one."""
    assert not torch._C._autograd._profiler_enabled()
    first = profiling.span("pel.a")
    assert first is profiling.span("pel.b")
    assert isinstance(first, contextlib.nullcontext)

    made = []
    real = torch.autograd.profiler.record_function

    def counted(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    _run("forward", MIXED_ROWS, traced=False)
    _run("train", MIXED_ROWS, traced=False)
    assert not [n for n in made if n.startswith("pel.")], made
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("pel.a"):
            pass
    assert made[-1] == "pel.a"


def test_span_off_is_free_in_a_dcn_model(monkeypatch):
    """The same of a DCNv2 model: its ``pel.cross`` too makes no
    ``record_function`` while no profiler records."""
    made = []
    real = torch.autograd.profiler.record_function

    def counted(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    _run("forward", MIXED_ROWS, traced=False, dcn=True)
    _run("train", MIXED_ROWS, traced=False, dcn=True)
    assert not [n for n in made if n.startswith("pel.")], made


def test_forward_spans_once_a_call_nested(tmp_path):
    outs, _, spans = _run("forward", MIXED_ROWS, traced=True, tmp_path=tmp_path)
    _check_tree(spans, FORWARD, CALLS)


@pytest.mark.parametrize("optimizer", ["sgd", "row_adagrad"])
def test_train_spans_once_a_step_nested(tmp_path, optimizer):
    _, _, spans = _run("train", MIXED_ROWS, optimizer, traced=True, tmp_path=tmp_path)
    _check_tree(spans, TRAIN, CALLS)


@pytest.mark.parametrize("kind,tree", [("forward", FORWARD_DCN), ("train", TRAIN_DCN)],
                         ids=["forward", "train"])
def test_dcn_cross_span_once_a_call_nested(tmp_path, kind, tree):
    """``pel.cross`` once a call, inside ``pel.forward``, and inside a train
    step's ``pel.train.dense``."""
    _, _, spans = _run(kind, MIXED_ROWS, traced=True, tmp_path=tmp_path, dcn=True)
    _check_tree(spans, tree, CALLS)


@pytest.mark.parametrize("kind", ["forward", "train"])
def test_dcn_traced_results_bit_identical(tmp_path, kind):
    plain, _, _ = _run(kind, MIXED_ROWS, traced=False, dcn=True)
    traced, _, _ = _run(kind, MIXED_ROWS, traced=True, tmp_path=tmp_path, dcn=True)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,optimizer,dcn,want", [
    ("train", "sgd", False, CALLS), ("train", "row_adagrad", False, CALLS),
    ("forward", None, False, 0), ("forward", None, True, 0), ("train", "row_adagrad", True, 0)],
    ids=["dot-train-sgd", "dot-train-row_adagrad", "dot-score", "dcn-score", "dcn-train"])
def test_interact_backward_span_once_a_dot_train_step(tmp_path, kind, optimizer, dcn, want):
    """``pel.interact.backward`` (the dot interaction's gather backward) once
    a sparse train step of a dot model, inside its ``pel.train.dense``; never
    in a score forward, and never in a DCNv2 model, which has no such
    gather."""
    kw = {} if optimizer is None else {"optimizer": optimizer}
    _, _, spans = _run(kind, MIXED_ROWS, traced=True, tmp_path=tmp_path, dcn=dcn, **kw)
    got = spans.get("pel.interact.backward", [])
    assert len(got) == want
    for iv in got:
        assert sum(_inside(iv, p) for p in spans["pel.train.dense"]) == 1


@pytest.mark.parametrize("kind", ["forward", "train"])
def test_no_small_span_without_a_small_set(tmp_path, kind):
    _, _, spans = _run(kind, BIG_ROWS, traced=True, tmp_path=tmp_path)
    tree = {k: v for k, v in (FORWARD if kind == "forward" else TRAIN).items()
            if k != "pel.lookup.small"}
    _check_tree(spans, tree, CALLS)


@pytest.mark.parametrize("kind,optimizer", [("forward", None), ("train", "sgd"),
                                            ("train", "row_adagrad")])
def test_traced_results_bit_identical(tmp_path, kind, optimizer):
    """Logits, and after the steps every parameter and accumulator, equal
    bit for bit with and without the profiler."""
    kw = {} if optimizer is None else {"optimizer": optimizer}
    plain, _, _ = _run(kind, MIXED_ROWS, traced=False, **kw)
    traced, _, _ = _run(kind, MIXED_ROWS, traced=True, tmp_path=tmp_path, **kw)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["forward", "train"])
def test_harness_trace_reads_the_spans(tmp_path, kind):
    events, spans = _run(kind, MIXED_ROWS, traced=True, tmp_path=tmp_path)[1:]
    tr = Trace(events)
    for name in FORWARD if kind == "forward" else TRAIN:
        assert tr.count(name) == CALLS
        got = [t for iv in tr.spans[name] for t in iv]
        assert got == pytest.approx([t * 1e-6 for iv in spans[name] for t in iv], abs=1e-7)
    off = {"pel.forward", "pel.train_step"} - set(FORWARD if kind == "forward" else TRAIN)
    assert all(tr.count(name) == 0 for name in off)


def test_lookup_fills_the_drop_count_only_when_asked(tmp_path):
    """``return_stats`` adds the drop count, a zero; without it the lookup
    makes no such tensor, and its output is the same."""
    model = _model(MIXED_ROWS)
    dense, ids, mask, _ = _batches(MIXED_ROWS, 1)[0]
    coll, emb = model.collection, model.emb_params()

    def zeros_in_lookup(**kw):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = coll.lookup(emb, ids, mask, batch_size=B, **kw)
        events, spans = _annotations(prof, tmp_path)
        (lo, hi), = spans["pel.lookup"]
        n = sum(1 for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::zeros"
                and lo <= e["ts"] <= hi)
        return out, n

    plain, n_plain = zeros_in_lookup()
    (stats, dropped), n_stats = zeros_in_lookup(return_stats=True)
    assert torch.equal(plain, stats)
    assert dropped.shape == () and dropped.dtype == torch.int32 and int(dropped) == 0
    assert n_stats == n_plain + 1


# -- the benchmark's readers of the port's spans, on a made-up trace ----------

def _span(name, lo, hi):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": lo, "dur": hi - lo}


def _activities(launches):
    """A runtime launch at host time ``t`` and its device activity of
    ``dur`` microseconds, tied by a correlation id."""
    out = []
    for corr, (t, dur, cat) in enumerate(launches, start=1):
        out.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t,
                    "dur": 2, "args": {"correlation": corr}})
        out.append({"ph": "X", "cat": cat, "name": f"k{corr}", "ts": 5000 + 100 * corr,
                    "dur": dur, "args": {"correlation": corr}})
    return out


# two forward calls: the small set launches 30 + 10 and 40 us, the big set
# 6 + 10 us and a 4 us fill, the dense half 20 us; one kernel outside
SCORE_EVENTS = [
    _span("window", 0, 1000),
    _span("pel.forward", 100, 200), _span("pel.lookup", 110, 170),
    _span("pel.lookup.small", 115, 140), _span("pel.lookup.big", 145, 165),
    _span("pel.forward", 500, 640), _span("pel.lookup", 510, 600),
    _span("pel.lookup.small", 515, 550), _span("pel.lookup.big", 560, 590),
    *_activities([(120, 30, "kernel"), (130, 10, "kernel"), (150, 6, "kernel"),
                  (180, 20, "kernel"), (520, 40, "kernel"), (570, 4, "gpu_memset"),
                  (575, 10, "kernel"), (700, 50, "kernel")]),
]
# two steps: the lookup launches 20 + 10 and 30 us, the dense half 100 + 50
# and 140 us, the sparse update 30 and 40 us and a 2 us fill; one kernel
# between the lookup and the dense half, one outside the steps
TRAIN_EVENTS = [
    _span("window", 0, 2000),
    _span("pel.train_step", 100, 400), _span("pel.lookup", 110, 160),
    _span("pel.lookup.small", 112, 130), _span("pel.lookup.big", 132, 158),
    _span("pel.train.dense", 170, 300), _span("pel.sparse_update", 310, 390),
    _span("pel.train_step", 1000, 1350), _span("pel.lookup", 1010, 1080),
    _span("pel.train.dense", 1090, 1250), _span("pel.sparse_update", 1260, 1340),
    *_activities([(120, 20, "kernel"), (150, 10, "kernel"), (165, 5, "kernel"),
                  (200, 100, "kernel"), (250, 50, "kernel"), (320, 30, "kernel"),
                  (1020, 30, "kernel"), (1100, 140, "kernel"), (1300, 40, "kernel"),
                  (1305, 2, "gpu_memset"), (1500, 99, "kernel")]),
]
# the DCNv2 cell's two forward calls: as SCORE_EVENTS, with the cross
# network launching 20 + 8 and 30 us and the top MLP 5 us after it
DCN_EVENTS = [
    _span("window", 0, 1000),
    _span("pel.forward", 100, 200), _span("pel.lookup", 110, 170),
    _span("pel.lookup.small", 115, 140), _span("pel.lookup.big", 145, 165),
    _span("pel.cross", 172, 190),
    _span("pel.forward", 500, 640), _span("pel.lookup", 510, 600),
    _span("pel.lookup.small", 515, 550), _span("pel.lookup.big", 560, 590),
    _span("pel.cross", 605, 630),
    *_activities([(120, 30, "kernel"), (130, 10, "kernel"), (150, 6, "kernel"),
                  (175, 20, "kernel"), (185, 8, "kernel"), (195, 5, "kernel"),
                  (520, 40, "kernel"), (570, 4, "gpu_memset"), (575, 10, "kernel"),
                  (610, 30, "kernel"), (700, 50, "kernel")]),
]
# cross_flops_per_sample of mlperf-dcnv2 (2 x 3 layers x 2 x 3456 x 512)
# times its batch, over 29 us a call, over 67 TFLOP/s
DCN_CROSS_FLOPS = 2 * 3 * 2 * 3456 * 512 * 65536
READINGS = [
    ("small_set_ms.score", SCORE_EVENTS, (30 + 10 + 40) / 2 * 1e-3),
    ("big_set_ms.score", SCORE_EVENTS, (6 + 4 + 10) / 2 * 1e-3),
    ("host_ms.score", SCORE_EVENTS, (100 + 140) / 2 * 1e-3),
    ("launches.score", SCORE_EVENTS, 7 / 2),
    ("host_ms.longbag", SCORE_EVENTS, (100 + 140) / 2 * 1e-3),
    ("launches.longbag", SCORE_EVENTS, 7 / 2),
    ("lookup_ms.train", TRAIN_EVENTS, (20 + 10 + 30) / 2 * 1e-3),
    ("dense_ms.train", TRAIN_EVENTS, (100 + 50 + 140) / 2 * 1e-3),
    ("sparse_update_ms.train", TRAIN_EVENTS, (30 + 40 + 2) / 2 * 1e-3),
    ("host_ms.train", TRAIN_EVENTS, (300 + 350) / 2 * 1e-3),
    ("launches.train", TRAIN_EVENTS, 10 / 2),
    ("cross_ms.dcn", DCN_EVENTS, (20 + 8 + 30) / 2 * 1e-3),
    ("cross_roofline.dcn", DCN_EVENTS, DCN_CROSS_FLOPS / 29e-6 / 67e12 * 100),
    ("dense_half_ms.dcn", DCN_EVENTS, (20 + 8 + 5 + 30) / 2 * 1e-3),
    ("lookup_ms.dcn", DCN_EVENTS, (30 + 10 + 6 + 40 + 4 + 10) / 2 * 1e-3),
    ("launches.dcn", DCN_EVENTS, 10 / 2),
]


@pytest.mark.parametrize("metric,events,want", READINGS, ids=[r[0] for r in READINGS])
def test_span_reader_by_hand(metric, events, want):
    """Each reader on a made-up on-card trace; None off the card, and None
    on a trace of a program that records no ``pel.*`` span."""
    entry = {m["name"]: m for m in json.loads((REPO / "BENCHMARK.json").read_text())
             ["per_layer"]}[metric]
    assert entry["source"] == "program_span"
    reader = Manifest(REPO).reader(metric)

    def run(evs, platform="gpu"):
        return types.SimpleNamespace(context={"platform": platform}, trace=Trace(evs))

    assert reader.read(run(events)) == pytest.approx(want, rel=1e-9)
    assert reader.read(run(events, "cpu")) is None
    unspanned = [e for e in events if not e["name"].startswith("pel.")]
    assert reader.read(run(unspanned)) is None
