"""What the readers of the port's own spans share (``pel.*``, recorded by
``pim_embedding_lookup_tpu_torch.utils.profiling.span`` while the traced
segment profiles).  Like ``readers``, each returns None where its run holds
nothing to read: a run off the card, or a program that records no such
span."""

from __future__ import annotations

from . import readers


def host_ms(run, span: str):
    """Host ms a call of ``span``: its mean duration on the profiler's
    clock, the profiler's own cost for each operation inside it included."""
    tr = readers.traced(run)
    iv = tr.spans.get(span) if tr is not None else None
    if not iv:
        return None
    return sum(e - s for s, e in iv) / len(iv) * 1e3


def launches(run, span: str):
    """Device activities (kernels, copies, fills) a call of ``span``
    launched."""
    tr = readers.traced(run)
    if tr is None or not tr.count(span):
        return None
    return len(tr.device_in(span)) / tr.count(span)
