"""The traced segment: ``torch.profiler`` around a stretch of the workload,
its chrome trace read back into kernels, operators and the harness's own
spans.

A device activity (kernel, copy or fill) belongs to the harness span in
which the host launched it: the runtime call that launched it carries the
same correlation id, and its host time lies inside the span.  The device is
busy over the union of its activities' intervals, clipped to the
``window`` span, which ends after a synchronize.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
WINDOW = "window"


class Trace:
    """What a traced segment holds, in seconds on the profiler's clock."""

    def __init__(self, events: list[dict]):
        spans: dict[str, list[tuple[float, float]]] = {}
        launches: dict[int, float] = {}
        self.device = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6
            if cat == "user_annotation":
                spans.setdefault(e["name"], []).append((ts, ts + dur))
            elif cat in DEVICE_CATS:
                self.device.append((e["name"], ts, ts + dur, e.get("args", {}).get("correlation")))
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = ts
        self.spans = {k: sorted(v) for k, v in spans.items()}
        self._launch = launches
        win = self.spans.get(WINDOW, [])
        self.window = (win[0][0], win[-1][1]) if win else None

    def count(self, span: str) -> int:
        return len(self.spans.get(span, []))

    def _inside(self, span: str, t: float | None) -> bool:
        iv = self.spans.get(span, [])
        if t is None or not iv:
            return False
        i = bisect.bisect_right(iv, (t, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]

    def device_in(self, span: str):
        """Device activities launched inside ``span``: (name, start, end)."""
        return [(n, s, e) for n, s, e, c in self.device
                if self._inside(span, self._launch.get(c))]

    def kernel_seconds(self, substring: str) -> tuple[float, int]:
        """Summed time and count of device activities whose name holds
        ``substring``."""
        hits = [e - s for n, s, e, _ in self.device if substring in n]
        return sum(hits), len(hits)

    @property
    def window_s(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds in the window in which some device activity ran."""
        if self.window is None:
            return 0.0
        lo_w, hi_w = self.window
        busy, end = 0.0, lo_w
        for s, e in sorted((max(s, lo_w), min(e, hi_w)) for _, s, e, _ in self.device):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def breakdown(self, top: int = 10) -> dict:
        """The device activities that took most time, by name, and the
        longest idle gaps, each named by the innermost harness span the host
        was in when the gap began."""
        by_name: dict[str, float] = {}
        for n, s, e, _ in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        if self.window is not None:
            end = self.window[0]
            for s, e in sorted((s, e) for _, s, e, _ in self.device):
                if s > end:
                    gaps.append((s - end, end))
                end = max(end, e)
            if self.window[1] > end:
                gaps.append((self.window[1] - end, end))
        gaps.sort(reverse=True)
        return {"device_ops": [[n[:120], t] for n, t in ops],
                "idle_gaps": [[self.span_at(t0), g] for g, t0 in gaps[:top]]}

    def span_at(self, t: float) -> str:
        """The shortest harness span around host time ``t`` (``host`` where
        none but the window holds it)."""
        best, width = "host", float("inf")
        for name, iv in self.spans.items():
            if name == WINDOW:
                continue
            i = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if i >= 0 and iv[i][0] <= t <= iv[i][1] and iv[i][1] - iv[i][0] < width:
                best, width = name, iv[i][1] - iv[i][0]
        return best


@contextlib.contextmanager
def traced(device: torch.device):
    """Profile the body; yields a dict whose ``trace`` is set on exit."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out: dict = {}
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            yield out
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["trace"] = Trace(json.load(f).get("traceEvents", []))
    finally:
        os.unlink(path)


span = record_function
