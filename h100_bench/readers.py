"""What the per-layer readers in ``metrics/`` share.  Each reader returns
None where its run holds nothing to read: a run off the card, or a trace
without the spans or kernels it looks for."""

from __future__ import annotations

from .yardstick import PEAKS


def on_card(run) -> bool:
    return run.context.get("platform") == "gpu"


def traced(run):
    return run.trace if on_card(run) and run.trace is not None else None


def span_device_ms(run, span: str, less: str | None = None):
    """Device ms of the activities launched inside ``span``, per span;
    with ``less``, those launched inside the span ``less`` (one nested in
    ``span``) left out."""
    tr = traced(run)
    if tr is None or not tr.count(span) or (less is not None and not tr.count(less)):
        return None
    acts = tr.device_in(span)
    inner = tr.device_in(less) if less is not None else []
    if len(acts) <= len(inner):
        return None
    seconds = sum(e - s for _, s, e in acts) - sum(e - s for _, s, e in inner)
    return seconds / tr.count(span) * 1e3


def idle_share(run):
    """Per cent of the traced window in which the device ran nothing."""
    tr = traced(run)
    if tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return (1.0 - tr.busy_s() / tr.window_s) * 100.0


def mfu(run):
    """Per cent of the card's f32 peak that the window's model operations
    take: operations a sample x samples / window seconds / peak."""
    c = run.context
    if not on_card(run) or not c.get("window_s"):
        return None
    return c["flops_per_sample"] * c["samples"] / c["window_s"] / PEAKS["f32_flops"] * 100.0


def roofline(run, kernel: str, bytes_key: str):
    """Per cent of the HBM bound: the bytes the kernel's launches must move
    over the card's bandwidth, over the summed time of every activity whose
    name holds ``kernel`` in the trace."""
    tr = traced(run)
    moved = run.context.get(bytes_key)
    if tr is None or not moved:
        return None
    seconds, count = tr.kernel_seconds(kernel)
    if not count or seconds <= 0:
        return None
    return moved / PEAKS["hbm_bytes_per_s"] / seconds * 100.0
