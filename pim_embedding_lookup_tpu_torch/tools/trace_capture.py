"""Capture trace artifacts of N hybrid lookups at bf16: the analog of the
reference's checked-in ``upmem/test.json`` (a Chrome trace of SDK internals
over a 100-lookup toy run).

Writes under ``--out`` (default ``port_tools_out/trace``, which git
ignores):
  * ``perfetto_trace.json.gz``: ``utils.profiling.trace`` (torch.profiler,
    CPU and CUDA activity) over the timed lookups, gzipped; loadable in
    Perfetto or chrome://tracing;
  * ``intervals.csv`` + ``gantt.png``: one busy interval per lookup,
    ending in a synchronize, through ``IntervalRecorder`` and the Gantt
    plotter (``gantt.png`` only where matplotlib is installed).

The counterpart of the JAX package's ``tools/trace_capture.py``, with its
flags and defaults but for ``--out``, plus ``--device``.

    python -m pim_embedding_lookup_tpu_torch.tools.trace_capture --config kaggle \\
        --batch 1024 --iters 3
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import tempfile

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.hybrid import HybridEmbeddingCollection
from ..utils.profiling import IntervalRecorder, plot_gantt, trace, write_intervals_csv
from . import common


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="trace_capture")
    ap.add_argument("--config", default="kaggle", choices=list(common.CONFIGS))
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--pooling", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("port_tools_out", "trace"))
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns the paths written and the number of intervals."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = common.CONFIGS[args.config]()
    coll = HybridEmbeddingCollection.create(cfg.tables, device=dev)
    params = coll.init(torch.Generator(device=dev).manual_seed(0), dtype=torch.bfloat16)

    rng = np.random.default_rng(0)
    t, b, l = len(cfg.tables), args.batch, args.pooling
    mask = torch.ones(t, b * l, dtype=torch.bool, device=dev)

    def query():
        return torch.from_numpy(common.uniform_ids(rng, cfg.tables, b * l)).to(dev)

    # warm up outside the trace window, so that the capture shows steady state
    coll.lookup(params, query(), mask, batch_size=b)
    common.sync(dev)

    os.makedirs(args.out, exist_ok=True)
    rec = IntervalRecorder()
    with tempfile.TemporaryDirectory(prefix="pel_trace_capture_") as tmp:
        with trace(tmp):
            for i in range(args.iters):
                q = query()
                with rec.record(unit=0, label=f"lookup_{i}"):
                    coll.lookup(params, q, mask, batch_size=b)
                    common.sync(dev)
        dst = os.path.join(args.out, "perfetto_trace.json.gz")
        with open(os.path.join(tmp, "trace.json"), "rb") as src, gzip.open(dst, "wb") as gz:
            shutil.copyfileobj(src, gz)
    print(f"trace: {dst} ({os.path.getsize(dst) / 1e3:.0f} KB)")
    csv_path = os.path.join(args.out, "intervals.csv")
    write_intervals_csv(csv_path, rec.intervals)
    plot_gantt(csv_path, os.path.join(args.out, "gantt.png"))
    print(f"intervals: {csv_path} ({len(rec.intervals)} rows)")
    return {"trace": dst, "intervals": csv_path, "rows": len(rec.intervals)}


if __name__ == "__main__":
    main()
