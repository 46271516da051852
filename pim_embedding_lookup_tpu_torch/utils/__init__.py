"""Utilities: profiling/tracing, checkpointing, guards, native feeder
binding."""

from .profiling import (
    IntervalRecorder,
    PhaseTimer,
    cost_stats,
    plot_gantt,
    trace,
    write_intervals_csv,
)

__all__ = [
    "PhaseTimer",
    "IntervalRecorder",
    "write_intervals_csv",
    "plot_gantt",
    "trace",
    "cost_stats",
]
