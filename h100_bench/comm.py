"""What the readers of a train step over a mesh share: the device time
and the count of the port's collective spans (``pel.comm.model``,
``pel.comm.data``, recorded by ``parallel/mesh.py`` around each collective
of an axis), a train step: summed over the traced segment and divided by
its count of the port's ``pel.train_step``.  Like ``readers``, each
returns None where its run holds nothing to read: a run off the card, or a
program that records no such span."""

from __future__ import annotations

from . import readers

STEP = "pel.train_step"


def device_ms_a_step(run, span: str):
    """Device ms a train step of the activities launched inside ``span``.
    A collective's kernel runs until every peer has joined it, so the wait
    for a peer counts in it."""
    tr = readers.traced(run)
    if tr is None or not tr.count(span) or not tr.count(STEP):
        return None
    return sum(e - s for _, s, e in tr.device_in(span)) / tr.count(STEP) * 1e3


def spans_a_step(run, *spans: str):
    """Spans named ``spans`` a train step."""
    tr = readers.traced(run)
    if tr is None or not tr.count(STEP) or not any(tr.count(s) for s in spans):
        return None
    return sum(tr.count(s) for s in spans) / tr.count(STEP)
