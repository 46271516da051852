"""Capacity bench: the int8 collection at table sizes its f32 form cannot
hold on the device.

Tables are drawn straight in int8 on the device
(``QuantizedEmbeddingCollection.init``), so no f32 copy ever exists.  Three
loops of rotated lookups are timed (``tools/common.py``): the dense wire
(fixed-L SUM: int8 K1), the CSR wire (the same bags as offsets: int8 K2)
and the MEAN combiner.  Before it builds anything the tool prints the
device's free and total memory beside the tables' int8 and f32 bytes, and
whether the f32 form would fit.  On an 80 GB card, ``--tables 4 --rows
100000000 --dim 64`` is 25.6 GB of int8 codes (plus 1.6 GB of row scales
in "row" mode) against 102.4 GB in f32.

The counterpart of the JAX package's ``tools/capacity_bench.py``, with its
flags, defaults and JSON keys, plus ``--device`` and the device keys
(``device_us_per_iter``, ``device_csr_us_per_iter``,
``device_mean_us_per_iter``: CUDA events over the loop behind a sleep
kernel; ``device_plain_max_abs_err``: each lookup on the first ids against
its plain version, which must agree, and ``device_storage_elements_read``,
past 2^31 at the size above; the device's memory; ``device_name``,
``device_count``).

    python -m pim_embedding_lookup_tpu_torch.tools.capacity_bench --rows 100000000
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..config import ShardingPolicy, TableConfig
from ..device import resolve_device
from ..ops.csr_pool import embedding_bag_csr_packed_reference
from ..ops.gather_pool import embedding_bag_fixedl_reference
from ..parallel.quantized_collection import QuantizedEmbeddingCollection
from . import common

ROUTED_NOTE = ("routed int8 runs on a mesh of more than one model shard; it is held "
               "against the JAX package on gloo meshes by "
               "tests/test_torch_port_quantized_mesh.py and, on one card, by "
               "chip_smoke.py's mesh_1 int8 lines")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="capacity_bench")
    ap.add_argument("--tables", type=int, default=4)
    ap.add_argument("--rows", type=int, default=25_000_000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--pooling", type=int, default=1)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--scale-mode", default="table", choices=["table", "row"],
                    help="int8 scale granularity: per-table (folded after pooling) or "
                         "per-row (each entry's scale loaded beside its row)")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def lookups(coll, params, b: int, offsets):
    """The three timed lookups, each ``ids, mask -> [B, T, D] f32``."""
    return {
        "fixed": lambda i, m: coll.lookup(params, i, m, batch_size=b),
        "csr": lambda i, m: coll.lookup_csr(params, i, offsets),
        "mean": lambda i, m: coll.lookup(params, i, m, batch_size=b, combiner="mean"),
    }


def plain_lookups(coll, params, idx, offsets, b: int, pooling: int) -> dict:
    """The three lookups' plain versions on the same int8 storage and
    scales: each table's bags pooled by the kernels' plain PyTorch versions
    at fused rows computed here from the layout's row offsets in int64
    (REPLICATE: a fused row is a storage row)."""
    t, d = idx.shape[0], coll.layout.dim
    q, scale = params["q"], params.get("scale")
    fused = idx.long() + torch.tensor(coll.layout.row_offsets, dtype=torch.int64,
                                      device=idx.device)[:, None]
    fixed = torch.stack([embedding_bag_fixedl_reference(q, d, fused[i], pooling=pooling,
                                                        batch_size=b, scale=scale)
                         for i in range(t)], dim=1)
    csr = embedding_bag_csr_packed_reference(q, d, fused, offsets, batch_size=b,
                                             scale=scale).reshape(t, b, d).transpose(0, 1)
    ts = params["tscale"][None, :, None] if "tscale" in params else 1.0
    out = {"fixed": fixed * ts, "csr": csr * ts, "mean": fixed / pooling * ts}
    return out, int(fused.max() + 1) * d


def check_plain(coll, params, fns, idx, mask, offsets, b: int, pooling: int) -> dict:
    """Each lookup's output on ``idx`` against :func:`plain_lookups` at rtol
    1e-5 and atol 1e-5 of the largest pooled value (the values are codes
    times 1/(sqrt(rows)·127)); raises on a mismatch.  Returns the max abs
    errors and the storage element past the furthest one read."""
    want, end = plain_lookups(coll, params, idx, offsets, b, pooling)
    errs = {}
    for name, fn in fns.items():
        got, ref = fn(idx, mask), want[name]
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item(),
                                   msg=lambda m, name=name: f"capacity {name}: {m}")
        errs[name] = (got - ref).abs().max().item()
    print(f"plain check: max abs err {errs}; storage elements read up to {end} "
          f"(2^31 = {2 ** 31})", file=sys.stderr)
    return {"device_plain_max_abs_err": errs, "device_storage_elements_read": end}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    tables = tuple(TableConfig(num_rows=args.rows, dim=args.dim, name=f"cap_{i}")
                   for i in range(args.tables))
    scale_bytes = 4 if args.scale_mode == "row" else 0
    gb_int8 = sum(t.num_rows * (t.dim + scale_bytes) for t in tables) / 1e9
    gb_f32 = sum(t.num_rows * t.dim * 4 for t in tables) / 1e9
    memory = {}
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        memory = {"device_free_gb": round(free / 1e9, 2), "device_total_gb": round(total / 1e9, 2)}
        print(f"device memory: {free / 1e9:.1f} GB free of {total / 1e9:.1f} GB; the f32 "
              f"tables ({gb_f32:.1f} GB) {'fit' if gb_f32 * 1e9 <= free else 'do not fit'}",
              file=sys.stderr)
    print(f"int8 {gb_int8:.1f}GB (f32 would be {gb_f32:.1f}GB) "
          f"scale_mode={args.scale_mode}", file=sys.stderr)

    coll = QuantizedEmbeddingCollection.create(tables, ShardingPolicy.REPLICATE,
                                               scale_mode=args.scale_mode, device=dev)
    params = coll.init(torch.Generator(device=dev).manual_seed(0))
    common.sync(dev)
    print(f"params ready pack={coll.layout.pack}", file=sys.stderr)

    rng = np.random.default_rng(0)
    t, b, l = len(tables), args.batch, args.pooling
    idx = torch.from_numpy(common.uniform_ids(rng, tables, b * l)).to(dev)
    mask = torch.ones(t, b * l, dtype=torch.bool, device=dev)
    rows, stride = common.rotation(tables, dev)
    offsets = (torch.arange(b + 1, dtype=torch.int32, device=dev) * l).expand(t, -1).contiguous()
    fns = lookups(coll, params, b, offsets)
    checked = check_plain(coll, params, fns, idx, mask, offsets, b, l)
    times = {}
    for name, fn in fns.items():
        loop = common.RotatingLoop(lambda i, fn=fn: fn(i, mask), idx, rows, stride)
        times[name] = common.loop_us(loop, args.iters, dev)
        print(f"{name}: {times[name][0]:.1f} us/iter", file=sys.stderr)

    def rnd(us):
        return None if us is None else round(us, 1)

    result = {
        "metric": "int8_capacity_pooled_lookups_per_s",
        "scale_mode": args.scale_mode,
        "tables_gb_int8": round(gb_int8, 2),
        "tables_gb_f32_equiv": round(gb_f32, 2),
        "us_per_iter": rnd(times["fixed"][0]),
        "value": round(b * t / times["fixed"][0] * 1e6, 1),
        "unit": "lookups/s",
        "csr_us_per_iter": rnd(times["csr"][0]),
        "csr_lookups_per_s": round(b * t / times["csr"][0] * 1e6, 1),
        "mean_us_per_iter": rnd(times["mean"][0]),
        "mean_lookups_per_s": round(b * t / times["mean"][0] * 1e6, 1),
        "routed_note": ROUTED_NOTE,
        "device_us_per_iter": rnd(times["fixed"][1]),
        "device_csr_us_per_iter": rnd(times["csr"][1]),
        "device_mean_us_per_iter": rnd(times["mean"][1]),
        **checked,
        **memory,
        **common.device_info(dev),
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
