"""Per-phase lookup latency: the reference's phase prints (emb_host.h:395-402:
indices/offsets copy-in, query-len copy, dpu_launch, results copy-out,
callback prep, dpu_sync) mapped to the port's stages on one device:

  feed       host -> device copy of the query (ids + mask), from pinned host
             memory on the card, to a synchronize
  dispatch   the lookup's launches, returning before the card finishes
  compute    the device work left after the launches, to a synchronize
  fetch      device -> host copy of the pooled [B, T, D] block
  decode     host-side ndarray view (the fixed-point decode slot: a no-op
             here, since the port pools in float)

The counterpart of the JAX package's ``tools/phase_bench.py``, with its
flags, defaults and JSON keys, plus ``--device`` and the device keys.  The
tables are bf16, as there.  Each phase ends where the next begins, so the
phases add up to the request.

    python -m pim_embedding_lookup_tpu_torch.tools.phase_bench --config kaggle --batch 8192
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..device import resolve_device
from ..parallel.collection import EmbeddingCollection
from ..parallel.hybrid import HybridEmbeddingCollection
from ..utils.profiling import PhaseTimer
from . import common

NOTE = ("On the card feed is a PCIe copy from pinned host memory and fetch a PCIe "
        "copy into pageable host memory, both to a synchronize; dispatch is the "
        "host's launch time, compute the device time the launches leave.")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="phase_bench")
    ap.add_argument("--config", default="kaggle", choices=list(common.CONFIGS))
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--pooling", type=int, default=1)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--hybrid", action="store_true", default=True)
    ap.add_argument("--no-hybrid", dest="hybrid", action="store_false")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def run_phases(coll, params, queries, *, batch, device, timer: PhaseTimer) -> np.ndarray:
    """Times each host query ``(ids [T, B*L] int32, mask)`` (numpy) through
    the five phases into ``timer``; returns the last fetched block."""
    host = None
    for idx_np, mask_np in queries:
        idx_h, mask_h = torch.from_numpy(idx_np), torch.from_numpy(mask_np)
        if device.type == "cuda":
            idx_h, mask_h = idx_h.pin_memory(), mask_h.pin_memory()
        with timer.phase("feed"):
            idx = idx_h.to(device, non_blocking=True)
            mask = mask_h.to(device, non_blocking=True)
            common.sync(device)
        with timer.phase("dispatch"):
            out = coll.lookup(params, idx, mask, batch_size=batch)
        with timer.phase("compute", sync=out):
            pass
        with timer.phase("fetch"):
            host = out.cpu().numpy()
        with timer.phase("decode"):
            host = host.view()  # float path: no fixed-point decode
    return host


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = common.CONFIGS[args.config]()
    tables = cfg.tables
    gen = torch.Generator(device=dev).manual_seed(0)
    if args.hybrid:
        coll = HybridEmbeddingCollection.create(tables, device=dev)
    else:
        coll = EmbeddingCollection.create(tables, packed="auto", device=dev)
    params = coll.init(gen, dtype=torch.bfloat16)

    rng = np.random.default_rng(0)
    t, b, l = len(tables), args.batch, args.pooling
    mask_np = np.ones((t, b * l), bool)
    # warm-up: the first call of each shape pays set-up (allocator, cuBLAS)
    run_phases(coll, params, [(common.uniform_ids(rng, tables, b * l), mask_np)],
               batch=b, device=dev, timer=PhaseTimer())
    timer = PhaseTimer()
    run_phases(coll, params,
               ((common.uniform_ids(rng, tables, b * l), mask_np) for _ in range(args.iters)),
               batch=b, device=dev, timer=timer)
    result = {
        "metric": "lookup_phase_latency_us",
        "config": args.config,
        "batch": b,
        "phases_us": {k: round(v, 1) for k, v in timer.report().items()},
        "note": NOTE,
        **common.device_info(dev),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
