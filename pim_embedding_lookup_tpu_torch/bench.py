"""Lookup bench: pooled embedding lookups/s on one card, at the
Criteo-Kaggle 26-table config and the r.sh presets.

The counterpart of the JAX package's bench (the repo-root ``bench.py``),
with its flags, defaults, configs, wires and log lines, plus ``--device``.
It builds the tables and one query (:func:`build_lookup`), then times a
loop of lookups (:func:`lookup_rate`) as the JAX bench's in-graph loop
runs them: every iteration rotates each table's ids on the device by
``(idx + stride) % rows`` (stride ``rows // 7 + 1``) and consumes the whole
pooled output into an accumulator (``tools/common.py``'s rotating loop).
Two clocks read the loop: the host clock over ``--iters`` iterations to a
synchronize (``us_per_iter``, launch cost included: what a caller in a
loop sees; the JAX bench's ``tpu_us_per_iter``) and, on the card, CUDA
events around one iteration held behind a sleep kernel, the median of 20
(``device_us_per_iter``, the device's own time).  ``value`` is batch x tables lookups over the host
time, ``device_lookups_per_s`` the same over the device time;
``compile_s`` is the timed warm-up of two iterations (the kernels' library
load, cuBLAS handles, first-seen CSR capacities); ``gbps_gather_model`` is
the JAX bench's byte model (one row at the storage width an entry, 4 more
bytes for an int8 row scale, an f32 pooled row a bag) over the host time.
``vs_baseline`` divides by torch ``EmbeddingBag`` on the host CPU
(:func:`cpu_torch_rate`).  ``device_kernel_launches`` counts the pool
kernels' launches over the timed loops, by row of the kernel table
(``tools/common.kernel_launches``); on the CPU, which runs their plain
versions, they are 0.

    python -m pim_embedding_lookup_tpu_torch.bench                    # Kaggle, B=8192, bf16
    python -m pim_embedding_lookup_tpu_torch.bench --config random --no-baseline
    python -m pim_embedding_lookup_tpu_torch.bench --device=cpu --config toy --iters 2
    torchrun --nproc-per-node 4 -m pim_embedding_lookup_tpu_torch.bench --no-baseline

It runs on CUDA unless ``--device=cpu``, and fails without a card
otherwise.  Under torchrun with more than one process the tables lie on a
(1, world) mesh under ROW_HASH, as the JAX bench places them on more than
one device; every process runs the whole batch, the device clock is off
(the loop has collectives) and rank 0 prints.  Prints one JSON line; the
progress lines go to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .config import ShardingPolicy, TableConfig
from .device import resolve_device
from .ops.ragged import pack_length_buckets, plan_length_buckets
from .parallel.bucketed import lookup_csr_bucketed
from .parallel.collection import EmbeddingCollection
from .parallel.hybrid import MXU_THRESHOLD, HybridEmbeddingCollection
from .parallel.quantized_collection import QuantizedEmbeddingCollection
from .tools import common
from .utils import native

_T0 = time.time()
TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the device clock: one iteration a run behind the sleep kernel (an
# iteration of the Kaggle hybrid dispatches 174 ATen operations on the dense
# wire and 642 on the bucketed CSR wire, and a run must fit the launch
# queue's ~1000 entries, or the sleep ends early and the gaps count), the
# median of DEVICE_RUNS runs, the sleep sized from HOLD_RUNS host runs
DEVICE_RUNS, HOLD_RUNS = 20, 3


def log(*a):
    print(f"[{time.time() - _T0:7.1f}s]", *a, file=sys.stderr, flush=True)


def bigtable_tables() -> tuple[TableConfig, ...]:
    """The JAX bench's synthetic big-table config: 8 x 2M rows x dim 128."""
    return tuple(TableConfig(num_rows=2_000_000, dim=128, name=f"big_{i}") for i in range(8))


@dataclasses.dataclass
class Lookup:
    """One configuration ready to time: ``fn(idx)`` pools one query
    ([B, T, D] f32); ``idx`` is the query's ids on the device (a [T, C]
    tensor, or on the bucketed CSR wire the tuple of each bucket's ids and
    the tail's), rotated by ``rows``/``stride`` ([T, 1] int32) between
    iterations.  ``query`` is the host query it was built from: per-table
    ids [T, C] int32 and, on the CSR wires, offsets [T, B+1]."""

    coll: object
    params: object
    idx: torch.Tensor | tuple[torch.Tensor, ...]
    fn: Callable
    query: tuple[np.ndarray, np.ndarray | None]
    rows: torch.Tensor
    stride: torch.Tensor
    tables: tuple[TableConfig, ...]
    batch: int
    pooling: int
    quantized: bool
    dtype: str
    int8_scale: str

    @property
    def device(self) -> torch.device:
        return self.rows.device


def build_lookup(tables, batch, pooling, *, seed=0, hybrid=True, dtype="float32",
                 packed="auto", quantized=False, mxu_threshold=MXU_THRESHOLD, wire="dense",
                 int8_scale="table", csr_ragged=False, device=None, mesh=None) -> Lookup:
    """The collection, its params drawn from ``seed``, one query and its
    lookup, as the JAX bench's ``tpu_lookup_rate`` builds them: a hybrid
    (f32/bf16, or with ``quantized`` an int8 big set), the int8 collection,
    or the plain collection; on the dense wire, the CSR wire (fixed-L
    offsets, or with ``csr_ragged`` the JAX bench's mixture of empty, short
    and 2-4x-pooling bags, drawn in its order from
    ``np.random.default_rng(seed)``) or the bucketed CSR wire (the bucket
    plan and pack on the host, the packed arrays then on the device).
    REPLICATE without ``mesh``, ROW_HASH over its model axis with one."""
    device = mesh.device if mesh is not None else resolve_device(device)
    policy = ShardingPolicy.REPLICATE if mesh is None else ShardingPolicy.ROW_HASH
    quantized = quantized or dtype == "int8"
    table_dtype = torch.float32 if dtype == "int8" else TABLE_DTYPES[dtype]
    gen = torch.Generator(device=device).manual_seed(seed)
    place = dict(device=device, mesh=mesh)
    if quantized and hybrid:
        coll = HybridEmbeddingCollection.create(
            tables, policy, mxu_threshold=mxu_threshold, packed=packed, quantized_big=True,
            int8_scale_mode=int8_scale, **place)
        log(f"layout: hybrid-int8 mxu_tables={len(coll.small_ids)} "
            f"int8_tables={len(coll.big_ids)} scale_mode={int8_scale} "
            f"pack={coll.big.layout.pack if coll.big else 1}")
        params = coll.init(gen)
    elif quantized:
        coll = QuantizedEmbeddingCollection.create(tables, policy, packed=packed,
                                                   scale_mode=int8_scale, **place)
        log(f"layout: int8 quantized policy={coll.layout.policy} "
            f"scale_mode={int8_scale} "
            f"total_rows={coll.layout.total_rows} pack={coll.layout.pack}")
        params = coll.init(gen)
    elif hybrid:
        coll = HybridEmbeddingCollection.create(tables, policy, mxu_threshold=mxu_threshold,
                                                packed=packed, **place)
        log(f"layout: hybrid mxu_tables={len(coll.small_ids)} "
            f"gather_tables={len(coll.big_ids)} dtype={dtype} "
            f"pack={coll.big.layout.pack if coll.big else 1}")
        params = coll.init(gen, table_dtype)
    else:
        coll = EmbeddingCollection.create(tables, policy, packed=packed, **place)
        log(f"layout: policy={coll.layout.policy} "
            f"total_rows={coll.layout.total_rows} dtype={dtype} "
            f"pack={coll.layout.pack}")
        params = coll.init(gen, table_dtype)
    common.sync(device)

    rng = np.random.default_rng(seed)
    t = len(tables)
    capacity = batch * pooling
    offsets_np = None
    if wire in ("csr", "csr-bucketed"):
        if csr_ragged:
            # ragged bags of mean length ~ pooling: empties, short bags and
            # 2-4x-pooling outliers, in the JAX bench's draw order
            lens = np.zeros((t, batch), np.int64)
            r = rng.random((t, batch))
            lens[r >= 0.10] = np.maximum(
                1, rng.integers(1, pooling + 1, size=(t, batch)))[r >= 0.10]
            long_sel = r >= 0.90
            lens[long_sel] = rng.integers(2 * pooling, 4 * pooling + 1,
                                          size=(t, batch))[long_sel]
            capacity = int(lens.sum(axis=1).max())
            capacity = -(-capacity // 8) * 8
            offsets_np = np.zeros((t, batch + 1), np.int32)
            np.cumsum(lens, axis=1, out=offsets_np[:, 1:])
            log(f"ragged CSR: capacity={capacity} "
                f"mean_len={lens.mean():.2f} max_len={lens.max()}")
        else:  # fixed-L bags on the CSR wire
            offsets_np = np.tile(np.arange(batch + 1, dtype=np.int32) * pooling, (t, 1))
    idx_np = common.uniform_ids(rng, tables, capacity)

    def put(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(device)

    idx = put(idx_np)
    if wire == "dense":
        mask = torch.ones((t, capacity), dtype=torch.bool, device=device)

        def fn(i):
            return coll.lookup(params, i, mask, batch_size=batch)
    elif wire == "csr":
        offsets = put(offsets_np)

        def fn(i):
            return coll.lookup_csr(params, i, offsets)
    elif wire == "csr-bucketed":
        # the pack runs on the host before the loop; the loop rotates the
        # packed id arrays on the device like every other wire's
        bls = (pooling,) if not csr_ragged else tuple(sorted({1, pooling, 2 * pooling}))
        plan0 = plan_length_buckets(offsets_np, bucket_ls=bls, slack=1.0)
        packer = "native" if native.available() else "numpy"
        pack_length_buckets(idx_np, offsets_np, plan0)  # warm (library load)
        t_pack0 = time.perf_counter()
        packed0 = pack_length_buckets(idx_np, offsets_np, plan0)
        pack_ms = (time.perf_counter() - t_pack0) * 1e3
        log(f"bucket plan: ls={plan0.bucket_ls} caps={plan0.capacities} "
            f"tail_bags={plan0.tail_bags} tail_entries={plan0.tail_entries} "
            f"host_pack={pack_ms:.1f}ms/batch ({packer} packer)")
        static = dataclasses.replace(
            packed0, idx=tuple(map(put, packed0.idx)), mask=tuple(map(put, packed0.mask)),
            pos=tuple(map(put, packed0.pos)), tail_idx=put(packed0.tail_idx),
            tail_off=put(packed0.tail_off), tail_pos=put(packed0.tail_pos))
        tail = static.tail_idx is not None
        idx = static.idx + ((static.tail_idx,) if tail else ())

        def fn(i):
            pk = (dataclasses.replace(static, idx=i[:-1], tail_idx=i[-1]) if tail
                  else dataclasses.replace(static, idx=i))
            return lookup_csr_bucketed(coll, params, pk)
    else:
        raise ValueError(f"unknown wire {wire!r}")
    rows, stride = common.rotation(tables, device)
    return Lookup(coll, params, idx, fn, (idx_np, offsets_np), rows, stride, tuple(tables),
                  batch, pooling, quantized, dtype, int8_scale)


@dataclasses.dataclass(frozen=True)
class Rate:
    """What :func:`lookup_rate` measures; times in seconds an iteration."""

    lookups_per_s: float  # batch x tables over the host time
    gbps: float  # the gather model's bytes over the host time
    dt: float  # host clock
    compile_s: float
    device_dt: float | None  # CUDA events; None on the CPU or on a mesh
    launches: dict


def lookup_rate(lk: Lookup, iters: int, *, events: bool = True) -> Rate:
    """Times ``lk`` in the rotating loop: a timed warm-up of two
    iterations (``compile_s``), ``iters`` iterations on the host clock,
    then on the card (unless ``events`` is False) CUDA events around one
    iteration behind the sleep kernel, the median of ``DEVICE_RUNS``."""
    dev = lk.device
    t, dim = len(lk.tables), lk.tables[0].dim
    before = common.kernel_launches(full_width=dim % 128 == 0)
    loop = common.RotatingLoop(lk.fn, lk.idx, lk.rows, lk.stride)
    tc0 = time.perf_counter()
    loop()
    loop()
    common.sync(dev)
    compile_s = time.perf_counter() - tc0
    log(f"warmed up in {compile_s:.2f}s; timing")
    host_us, device_us = common.loop_us(
        loop, iters, dev, warmup=0, device_calls=1, device_runs=DEVICE_RUNS,
        hold_runs=HOLD_RUNS, events=events)
    if not torch.isfinite(loop.acc):
        raise RuntimeError(f"non-finite lookup sum {loop.acc.item()}")
    launches = {k: v - before[k]
                for k, v in common.kernel_launches(full_width=dim % 128 == 0).items()}
    dt = host_us / 1e6
    # bytes at the storage dtype (gather model): per entry one dim-wide row,
    # +4 B of row scale in int8 "row" mode; per bag an f32 pooled row.  The
    # hybrid's small set moves matmul bytes instead: the gather engine's
    # bound, not a hybrid-exact count
    itemsize = {"int8": 1, "bfloat16": 2, "float32": 4}[
        "int8" if lk.quantized else lk.dtype]
    entry_bytes = dim * itemsize + (4 if (lk.quantized and lk.int8_scale == "row") else 0)
    bytes_moved = lk.batch * t * lk.pooling * entry_bytes + lk.batch * t * dim * 4
    rate = Rate(lk.batch * t / dt, bytes_moved / dt / 1e9, dt, compile_s,
                None if device_us is None else device_us / 1e6, launches)
    log(f"{dev.type}: {host_us:.1f} us/iter (host clock), "
        f"{'not measured' if device_us is None else f'{device_us:.1f}'} us/iter "
        f"(device), {rate.lookups_per_s / 1e6:.2f}M lookups/s, {rate.gbps:.1f} GB/s "
        f"pooled (storage-dtype gather model)")
    return rate


def cpu_torch_rate(tables, batch, pooling, iters, seed=0):
    """Host-CPU torch EmbeddingBag: the engine the reference's PIM path
    replaces (dlrm_dpu_pytorch's apply_emb fallback)."""
    torch.manual_seed(seed)
    # tables must be materialized (pages faulted, non-zero): untouched
    # pages alias the zero page, so gathers would hit cache instead of
    # DRAM; a small random block tiled over each table faults every page
    prng = np.random.default_rng(seed)
    block = prng.standard_normal((65536, tables[0].dim)).astype(np.float32)

    def make_table(nr, dim):
        blk = (block if dim == block.shape[1]
               else prng.standard_normal((65536, dim)).astype(np.float32))
        arr = np.empty((nr, dim), np.float32)
        for r0 in range(0, nr, blk.shape[0]):
            n = min(blk.shape[0], nr - r0)
            arr[r0 : r0 + n] = blk[:n]
        return torch.from_numpy(arr)

    bags = [
        torch.nn.EmbeddingBag.from_pretrained(
            make_table(tb.num_rows, tb.dim), mode="sum", freeze=True,
        )
        for tb in tables
    ]
    rng = np.random.default_rng(seed)
    idx = [
        torch.from_numpy(
            rng.integers(0, tb.num_rows, size=(batch, pooling)).astype(np.int64)
        )
        for tb in tables
    ]
    # median of 3 repeats: single runs swing with the host's scheduling
    reps = []
    with torch.no_grad():
        for b, i in zip(bags, idx):  # warmup
            b(i)
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(iters):
                for b, i in zip(bags, idx):
                    b(i)
            reps.append((time.perf_counter() - t0) / iters)
    dt = sorted(reps)[1]
    rate = batch * len(tables) / dt
    log(f"cpu torch: {dt*1e6:.1f} us/iter (median of {[f'{r*1e6:.0f}' for r in reps]}), "
        f"{rate/1e6:.3f}M lookups/s")
    return rate


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="bench")
    ap.add_argument("--config", default="kaggle",
                    choices=["kaggle", "random", "toy", "bigtable"])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--pooling", type=int, default=0,
                    help="indices per bag (default: 1 for kaggle single-hot, "
                         "32 for bigtable, 120 for random per r.sh)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--cpu-iters", type=int, default=10)
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--no-hybrid", action="store_true",
                    help="disable the small-table (bf16-pooled) path")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16", "int8"],
                    help="table storage dtype (accumulation is always f32); "
                         "int8 = capacity mode (hybrid: bf16-pooled small set + "
                         "int8 big set)")
    ap.add_argument("--no-packed", action="store_true",
                    help="disable lane-packed storage for dim<128 tables")
    ap.add_argument("--mxu-threshold", type=int, default=0,
                    help="override the hybrid small-table row threshold "
                         "(0 = library default)")
    ap.add_argument("--wire", default="dense",
                    choices=["dense", "csr", "csr-bucketed"],
                    help="query wire shape: dense padded [T,B*L], the "
                         "reference's CSR indices+offsets (emb_host.h:234), "
                         "or CSR re-wired through host-side length "
                         "bucketing (ops/ragged.py)")
    ap.add_argument("--csr-ragged", action="store_true",
                    help="with a csr wire: genuinely ragged bag lengths "
                         "(mixture incl. empties and 4x-pooling outliers) "
                         "instead of fixed-L offsets")
    ap.add_argument("--int8-scale", default="table",
                    choices=["table", "row"],
                    help="int8 scale granularity: per-table (folded in "
                         "post-pool) or per-row (each entry's scale loaded "
                         "beside its row)")
    ap.add_argument("--tables-filter", default="",
                    choices=["", "small", "big"],
                    help="bench only the tables below/above the small-set "
                         "threshold (cost-split diagnostic)")
    common.add_device_arg(ap)
    args = ap.parse_args(argv)
    args.mxu_threshold = args.mxu_threshold or MXU_THRESHOLD
    return args


def bench_tables(args) -> tuple[TableConfig, ...]:
    """The tables ``--config`` and ``--tables-filter`` select; sets
    ``args.pooling``'s default for the config."""
    if args.config == "bigtable":
        tables = bigtable_tables()
    else:
        tables = common.CONFIGS[args.config]().tables
    if not args.pooling:
        args.pooling = {"kaggle": 1, "toy": 1, "random": 120, "bigtable": 32}[args.config]
    if args.tables_filter:
        thr = args.mxu_threshold
        keep = ((lambda n: n <= thr) if args.tables_filter == "small"
                else (lambda n: n > thr))
        tables = tuple(tb for tb in tables if keep(tb.num_rows))
        log(f"tables-filter={args.tables_filter}: {len(tables)} tables")
        if not tables:
            sys.exit(f"--tables-filter={args.tables_filter} leaves no table of "
                     f"--config {args.config} (threshold {thr} rows)")
    return tables


def lookup_for(args, *, device=None, mesh=None) -> Lookup:
    """:func:`build_lookup` for parsed command-line ``args``."""
    return build_lookup(
        bench_tables(args), args.batch, args.pooling, hybrid=not args.no_hybrid,
        dtype=args.dtype, packed=False if args.no_packed else "auto",
        mxu_threshold=args.mxu_threshold, wire=args.wire, int8_scale=args.int8_scale,
        csr_ragged=args.csr_ragged, device=device, mesh=mesh)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev, mesh, _, joined = common.tool_mesh(args.device, routed=False)
    lk = lookup_for(args, device=dev, mesh=mesh)
    log("params ready; warming up the timed loop")
    rate = lookup_rate(lk, args.iters, events=mesh is None)
    tables = lk.tables
    del lk  # the device tables, before the CPU baseline
    result = None
    if common.primary():
        vs_baseline = None
        if not args.no_baseline:
            cpu_rate = cpu_torch_rate(tables, args.batch, args.pooling, args.cpu_iters)
            vs_baseline = rate.lookups_per_s / cpu_rate
        dev_dt = rate.device_dt
        result = {
            "metric": f"criteo_{args.config}_pooled_lookups_per_s_per_chip",
            "value": round(rate.lookups_per_s, 1),
            "unit": "lookups/s",
            "vs_baseline": round(vs_baseline, 3) if vs_baseline else None,
            "us_per_iter": round(rate.dt * 1e6, 1),
            "compile_s": round(rate.compile_s, 1),
            "gbps_gather_model": round(rate.gbps, 1),
            "device_us_per_iter": None if dev_dt is None else round(dev_dt * 1e6, 1),
            "device_lookups_per_s": (None if dev_dt is None
                                     else round(args.batch * len(tables) / dev_dt, 1)),
            "device_kernel_launches": rate.launches,
            "device_mesh": [1, dist.get_world_size()] if mesh is not None else None,
            **common.device_info(dev),
        }
        print(json.dumps(result), flush=True)
    common.leave(joined)
    return result


if __name__ == "__main__":
    main()
