"""Profiling, tracing and observability.

The counterpart of ``pim_embedding_lookup_tpu.utils.profiling``:

1. ``PhaseTimer``: named host-clock phases, each optionally ending in a
   synchronize of a tensor's device.
2. ``IntervalRecorder`` + ``write_intervals_csv`` + ``plot_gantt``: per-unit
   busy intervals, the CSV schema of the JAX package, and a Gantt chart.
3. ``cost_stats``: flops and bytes accessed of one call.
4. ``trace``: a ``torch.profiler`` Chrome trace, viewable in Perfetto.
5. ``span``: a named span at a layer boundary of the program, recorded
   only while a profiler records.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import os
import tempfile
import time
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass
class Phase:
    name: str
    total_s: float = 0.0
    count: int = 0

    @property
    def mean_us(self) -> float:
        return 1e6 * self.total_s / max(self.count, 1)


class PhaseTimer:
    """Named-phase wall timer.  ``sync``: a tensor whose device is
    synchronized before the phase ends, so that the phase covers the work it
    launched and not only the launches."""

    def __init__(self):
        self.phases: dict[str, Phase] = {}

    @contextlib.contextmanager
    def phase(self, name: str, *, sync: torch.Tensor | None = None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.device.type == "cuda":
            torch.cuda.synchronize(sync.device)
        dt = time.perf_counter() - t0
        p = self.phases.setdefault(name, Phase(name))
        p.total_s += dt
        p.count += 1

    def report(self) -> dict[str, float]:
        return {name: p.mean_us for name, p in self.phases.items()}

    def print_report(self) -> None:
        for name, p in self.phases.items():
            print(f"{name}: {p.mean_us:.1f} us (n={p.count})")


@dataclasses.dataclass
class Interval:
    unit: int  # shard / device index
    label: str
    start_s: float
    end_s: float


class IntervalRecorder:
    """Collects per-unit busy intervals for the Gantt export."""

    def __init__(self):
        self.intervals: list[Interval] = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def record(self, unit: int, label: str = "lookup") -> Iterator[None]:
        s = time.perf_counter() - self._t0
        yield
        e = time.perf_counter() - self._t0
        self.intervals.append(Interval(unit, label, s, e))


def write_intervals_csv(path: str, intervals: list[Interval]) -> None:
    """Rows of (rank_id, label, start_ms, end_ms)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["rank_id", "label", "start_ms", "end_ms"])
        for iv in intervals:
            w.writerow([iv.unit, iv.label, f"{iv.start_s*1e3:.3f}", f"{iv.end_s*1e3:.3f}"])


def plot_gantt(csv_path: str, out_png: str) -> None:
    """Per-unit interval Gantt chart of ``write_intervals_csv``'s file.
    Imports matplotlib when called, and prints a note and draws nothing
    where it is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # plotting is optional
        print("matplotlib unavailable; skipping gantt plot")
        return
    rows = []
    with open(csv_path) as f:
        for rec in csv.DictReader(f):
            rows.append((int(rec["rank_id"]), float(rec["start_ms"]), float(rec["end_ms"])))
    fig, ax = plt.subplots(figsize=(12, 6))
    for unit, s, e in rows:
        ax.barh(unit, e - s, left=s, height=0.8)
    ax.set_xlabel("time (ms)")
    ax.set_ylabel("shard")
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


@contextlib.contextmanager
def trace(log_dir: str | None = None) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block (CPU activity, and CUDA where a
    card is present), written as a Chrome trace to ``log_dir/trace.json``
    (default: ``pel_trace`` in the temporary directory).  Yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "pel_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` named ``name`` while the
    autograd profiler records (``trace``, ``torch.profiler.profile``), so
    that the trace shows the span and the device work launched inside it;
    otherwise one shared no-op context, which costs a fraction of a
    ``record_function`` that records nothing."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class _BytesAccessed(TorchDispatchMode):
    """Sums the bytes of every tensor that each ATen operation inside it
    takes or returns; views move nothing and are not counted."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for x in torch.utils._pytree.tree_leaves((args, kwargs, out)):
                if isinstance(x, torch.Tensor):
                    self.bytes += x.numel() * x.element_size()
        return out


def cost_stats(fn, *args) -> dict[str, float]:
    """Flops (``torch.utils.flop_counter.FlopCounterMode``) and bytes
    accessed of one call ``fn(*args)``.  The bytes are those of every ATen
    operation's inputs and outputs: eager PyTorch fuses nothing, so a
    program of several operations counts each intermediate twice, where
    XLA's cost analysis of a fused program counts it not at all.  For one
    matmul the two agree."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as flops, _BytesAccessed() as moved:
        fn(*args)
    return {"flops": float(flops.get_total_flops()), "bytes_accessed": float(moved.bytes)}
