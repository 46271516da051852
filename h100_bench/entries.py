"""The two entries a cell drives, ``score`` and ``train``: set-up,
the measured window, the traced segment and the check against the plain
reference.

Each entry returns a ``Run``: what was attempted and failed, the window's
end-to-end numbers, what the per-layer readers read, and the numbers the
check compared.  ``dense`` is the family's module of ``dense/``, whose
``DenseHalf`` the reference runs.  ``control`` puts the reference in the
program's place, computed with TF32 on; ``fault`` plants one of the faults
the check has to catch in the program's timed path.

On a mesh (``ranks``, a ``ranks.Ranks``) each rank feeds its data row's
part of every global batch, and every rank makes the same number of calls:
rank 0 fixes it from the warm-up's second pass and broadcasts it.  The
window runs from a barrier to the last rank's last completion, and its rate
counts the global batch.  Rank 0's card alone is traced, and the readers
read rank 0's own samples.  Each rank checks what it holds against the
reference of the global batches: its part of the probabilities; the global
losses, the dense leaves and the rows it holds, a table split over the
model axis compared as one leaf.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
import time
from collections import deque

import torch

from . import gen, reference, tracing, yardstick
from .faults import plant


@dataclasses.dataclass
class Run:
    attempted: int = 0
    failed: int = 0
    e2e: dict = dataclasses.field(default_factory=dict)  # name -> value
    context: dict = dataclasses.field(default_factory=dict)  # what the readers read
    checks: dict = dataclasses.field(default_factory=dict)  # name -> value
    trace: object = None
    peak_bytes: int = 0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def _pool(cfg, traffic, seed, device, stream=0):
    return [gen.batch(seed, i, table_rows_=tuple(cfg["tables"]), batch_size=traffic["batch_size"],
                      pooling=traffic["pooling"], dense_dim=cfg["dense_dim"], device=device,
                      stream=stream, wire=traffic["wire"])
            for i in range(traffic["pool_batches"])]


def _flops_per_sample(dense, cfg, traffic) -> int:
    return dense.flops_per_sample(cfg, gen.lengths(traffic["pooling"], len(cfg["tables"])))


def _pool_bytes(cfg, b) -> int:
    """Bytes a pool kernel must move for batch ``b`` on the dense wire, the
    small set's and the big set's tables alike: each distinct kept row once,
    every id and mask byte once, and the f32 output once."""
    t, bsz = len(cfg["tables"]), b["dense"].shape[0]
    return (yardstick.pool_bytes(b["ids"], b["mask"], cfg["dim"])
            + yardstick.pool_out_bytes(t, bsz, cfg["dim"]))


def _closed_loop(fn, items, seconds, in_flight, device, first=0, keep=None, per_second=None,
                 count=None):
    """Calls ``fn`` on ``items`` in turn, ``in_flight`` outstanding, until
    ``seconds`` have passed (or, given ``count``, ``count`` times), then
    waits for all.  Returns (calls, window seconds from the first call to
    the last completion).  ``per_second``, a list, gets the calls begun in
    each second of the window."""
    inflight = deque()
    calls = 0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds if count is None else calls >= count:
            break
        if per_second is not None:
            sec = int(now - t0)
            per_second.extend([0] * (sec + 1 - len(per_second)))
            per_second[sec] += 1
        k = (first + calls) % len(items)
        out = fn(items[k])
        if keep is not None:
            keep[k] = out
        ev = None
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
        inflight.append(ev)
        calls += 1
        if len(inflight) >= in_flight:
            ev = inflight.popleft()
            if ev is not None:
                ev.synchronize()
    _sync(device)
    return calls, time.perf_counter() - t0


# -- score --------------------------------------------------------------------


def score(system, dense, cfg, traffic, seed, seconds, device, *, trace, control, fault,
          ranks=None):
    run = Run()
    pool = _pool(cfg, traffic, seed, device)
    if ranks is not None:
        pool = [ranks.data_slice(b) for b in pool]
    predict = plant(fault, "predict",
                    _control(dense, cfg, seed, device) if control else system.predict)
    for b in pool:  # every shape of the cell, twice
        predict(b)
    counts = (None, None)
    if ranks is None:
        for b in pool:
            predict(b)
    else:
        counts = ranks.counts(predict, pool, seconds, traffic["trace_seconds"])
        ranks.barrier()
    _sync(device)
    yield "setup_done"
    outs, timeline = {}, []
    calls, window = _closed_loop(predict, pool, seconds, traffic["in_flight"], device, keep=outs,
                                 per_second=timeline, count=counts[0])
    run.context["timeline"] = timeline
    bsz = traffic["batch_size"]
    run.attempted = calls
    run.context.update(samples=calls * pool[0]["dense"].shape[0], window_s=window,
                       flops_per_sample=_flops_per_sample(dense, cfg, traffic))
    if ranks is not None:
        window = ranks.window(window)
    run.e2e["score_samples_per_s"] = calls * bsz / window
    if trace and not control:
        with _traced(device, ranks) as tr:
            n, _ = _closed_loop(system.predict, pool, traffic["trace_seconds"],
                                traffic["in_flight"], device, count=counts[1])
        run.trace = tr["trace"]
        if traffic["wire"] == "dense":
            per_batch = [_pool_bytes(cfg, b) for b in pool]
            run.context["pool_bytes"] = sum(per_batch[k % len(pool)] for k in range(n))
        run.context["traced_batches"] = n
    run.peak_bytes = _peak(device)
    got = {k: v.float().cpu() for k, v in outs.items()}
    system.free()
    yield "window_done"
    dense_half = dense.DenseHalf(cfg, seed, device)
    err = 0.0
    for k, p in got.items():
        want = reference.probabilities(cfg, seed, dense_half, pool[k]).cpu()
        err = max(err, float((p - want).abs().max()))
    run.checks["prob_err"] = err
    yield run


def _traced(device, ranks):
    """The profiler over the traced segment: on a mesh over rank 0's card
    alone, the other ranks running the same segment untraced."""
    if ranks is None or ranks.lead:
        return tracing.traced(device)
    return contextlib.nullcontext({"trace": None})


def _control(dense, cfg, seed, device):
    """The reference's probabilities with TF32 on, in the program's place."""
    dense_half = dense.DenseHalf(cfg, seed, device)
    return lambda b: reference.probabilities(cfg, seed, dense_half, b, tf32=True)


# -- train --------------------------------------------------------------------


CHECK_STEPS = 3


def train(system, dense, cfg, traffic, seed, seconds, device, *, trace, control, fault,
          ranks=None):
    run = Run()
    pool = _pool(cfg, traffic, seed, device, stream=1)
    if len(pool) <= CHECK_STEPS:
        raise ValueError(f"a train cell needs more than {CHECK_STEPS} pool batches")
    lr, t = traffic["lr"], len(cfg["tables"])
    first = pool[:CHECK_STEPS]
    uniq = [torch.unique(torch.cat([b["ids"][k].long() for b in first])) for k in range(t)]
    # on a mesh: the rank's part of each batch, and of each table's touched
    # rows those it holds (None: all of them); ``split``, the tables whose
    # rows the model axis splits
    feed, held, split = pool, None, set()
    if ranks is not None and not control:
        feed = [ranks.data_slice(b) for b in pool]
        held = [system.holds(k, uniq[k]) for k in range(t)]
        split = {f"emb.{k}" for k in range(t) if system.split(k)}
    mine = uniq if held is None else [u[h] for u, h in zip(uniq, held)]
    counts = (None, None)
    if control:
        snap = _control_readings(dense, cfg, seed, first, traffic, device)
    else:
        system.make_train(traffic)
        step = plant(fault, "train_step", system.train_step, system=system)
        snap = {"loss": []}
        for i, b in enumerate(feed[:CHECK_STEPS]):  # the check's three steps: the first warm-up
            snap["loss"].append(float(step(b)))
            if i == 0:
                snap["p1"] = {n: p.detach().clone() for n, p in system.dense_leaves().items()}
                snap["w1"] = [system.rows(k, mine[k]) for k in range(t)]
                if traffic["optimizer"] == "row_adagrad":
                    snap["acc1"] = [system.accumulator(k, mine[k]).clone() for k in range(t)]
        snap["p3"] = {n: p.detach().clone() for n, p in system.dense_leaves().items()}
        snap["w3"] = [system.rows(k, mine[k]) for k in range(t)]
        if ranks is None:
            step(pool[CHECK_STEPS])  # the window's first shapes once more
        else:
            counts = ranks.counts(step, feed, seconds, traffic["trace_seconds"])
    if ranks is not None:
        ranks.barrier()
    _sync(device)
    yield "setup_done"
    if not control:
        timeline = run.context["timeline"] = []
        calls, window = _closed_loop(step, feed, seconds, traffic["in_flight"], device,
                                     first=CHECK_STEPS + 1, per_second=timeline,
                                     count=counts[0])
        bsz = traffic["batch_size"]
        run.attempted = calls
        run.context.update(samples=calls * feed[0]["dense"].shape[0], window_s=window,
                           flops_per_sample=3 * _flops_per_sample(dense, cfg, traffic))
        if ranks is not None:
            window = ranks.window(window)
        run.e2e["train_samples_per_s"] = calls * bsz / window
        if trace:
            def spanned(b):
                with tracing.span("train_step"):
                    return step(b)

            with _traced(device, ranks) as tr:
                _closed_loop(spanned, feed, traffic["trace_seconds"], traffic["in_flight"],
                             device, count=counts[1])
            run.trace = tr["trace"]
    run.peak_bytes = _peak(device)
    system.free()
    yield "window_done"
    ref = reference.Trainer(cfg, seed, first, dense_half=dense.DenseHalf(cfg, seed, device),
                            lr=lr, optimizer=traffic["optimizer"], eps=traffic["eps"],
                            device=device)
    for k in range(t):
        if not torch.equal(ref.uniq[k], uniq[k]):
            raise RuntimeError("the reference's touched rows differ from the harness's")
    w0 = {f"emb.{k}": r.clone() for k, r in enumerate(ref.rows)}
    p0 = {n: p.detach().clone() for n, p in ref.dense.leaves().items()}
    steps, ref_snap = [], {}
    for i, b in enumerate(first):
        steps.append(ref.step(i, b))
        if i == 0:
            ref_snap = {"p1": {n: p.detach().clone() for n, p in ref.dense.leaves().items()},
                        "w1": [r.clone() for r in ref.rows], "acc1": [a.clone() for a in ref.acc]}
    ref_g = steps[0]["grads"]
    # both sides' first gradient read back from their state after one step,
    # so that the readout's rounding, ulp(w0) / lr, falls on both alike
    # the program's rows start from the reference's first rows it holds
    w0p = w0 if held is None else {f"emb.{k}": w0[f"emb.{k}"][h] for k, h in enumerate(held)}
    prog_g = _first_grads(p0, w0p, snap, lr=lr, traffic=traffic)
    ref_read = _first_grads(p0, w0, ref_snap, lr=lr, traffic=traffic)
    ref_d = {n: p.detach() - p0[n] for n, p in ref.dense.leaves().items()}
    ref_d.update({f"emb.{k}": r - w0[f"emb.{k}"] for k, r in enumerate(ref.rows)})
    prog_d = {n: snap["p3"][n] - p0[n] for n in p0}
    prog_d.update({f"emb.{k}": snap["w3"][k] - w0p[f"emb.{k}"] for k in range(t)})
    ref_loss = [s["loss"] for s in steps]
    run.checks["loss_gap"] = max(abs(a - b) / abs(b) for a, b in zip(snap["loss"], ref_loss))
    norms = {n: float(g.norm()) for n, g in ref_g.items()}
    med = statistics.median(norms.values())
    moving = [n for n, v in norms.items() if v >= 1e-3 * med]
    worst = {}
    for name, prog, want, names in (("grad_gap", prog_g, ref_read, list(norms)),
                                    ("change_gap", prog_d, ref_d, moving)):
        run.checks[name], worst[name] = _worst_leaf(_norms(prog, names, split, ranks),
                                                    _norms(want, names), names)
    run.context["worst_leaf"] = worst
    run.context["leaves_left_out"] = sorted(set(norms) - set(moving))
    yield run


def _first_grads(p0: dict, w0: dict, snap: dict, *, lr: float, traffic: dict) -> dict:
    """The first gradient as the optimizer got it, worked out from the state
    after one step: (w0 - w1) / lr, on rows under row-AdaGrad times
    sqrt(acc1 + eps)."""
    g = {n: (p0[n] - snap["p1"][n]) / lr for n in p0}
    for k, w1 in enumerate(snap["w1"]):
        dw = w0[f"emb.{k}"] - w1
        if traffic["optimizer"] == "row_adagrad":
            dw = dw * torch.sqrt(snap["acc1"][k] + traffic["eps"])[:, None]
        g[f"emb.{k}"] = dw / lr
    return g


def _norms(leaves: dict, names, split=(), ranks=None) -> dict:
    """Each named leaf's norm; a leaf in ``split`` is a rank's part of one
    that spans the model axis, whose squares are summed over its peers."""
    out = {n: float(leaves[n].norm()) for n in {*names, *split}}
    if split:  # every rank sums every split leaf, so that the collective matches
        parts = sorted(split)
        out.update(zip(parts, map(math.sqrt, ranks.model_sum([out[n] ** 2 for n in parts]))))
    return out


def _worst_leaf(prog_n: dict, ref_n: dict, names) -> tuple[float, str]:
    """The largest gap between the program's norm of a leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; and that leaf's name."""
    med = statistics.median(ref_n[n] for n in names)
    return max((abs(prog_n[n] - ref_n[n]) / max(ref_n[n], med), n) for n in names)


def _control_readings(dense, cfg, seed, first, traffic, device) -> dict:
    """The reference with TF32 on, read as the program's state is read."""
    ctl = reference.Trainer(cfg, seed, first, dense_half=dense.DenseHalf(cfg, seed, device),
                            lr=traffic["lr"], optimizer=traffic["optimizer"],
                            eps=traffic["eps"], device=device, tf32=True)
    snap = {"loss": []}
    for i, b in enumerate(first):
        snap["loss"].append(ctl.step(i, b)["loss"])
        if i == 0:
            snap["p1"] = {n: p.detach().clone() for n, p in ctl.dense.leaves().items()}
            snap["w1"] = [r.clone() for r in ctl.rows]
            snap["acc1"] = [a.clone() for a in ctl.acc]
    snap["p3"] = {n: p.detach().clone() for n, p in ctl.dense.leaves().items()}
    snap["w3"] = [r.clone() for r in ctl.rows]
    return snap


ENTRIES = {"score": score, "train": train}
