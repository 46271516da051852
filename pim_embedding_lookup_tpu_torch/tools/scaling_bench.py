"""Scaling efficiency: pooled lookups/s at 1, 2, 4, 8, ... shards, up to the
processes of the job (one process a device).

Three axes (``--axis``):

* data   the batch on a (s, 1) mesh: the global batch grows with s and
         every process pools its slice; the throughput axis.
* routed the model axis with all-to-all id routing (``lookup_routed``,
         ROW_HASH) on a (1, s) mesh: each shard gathers ~cf*E/s rows, so
         capacity and throughput scale together.  Drops are counted.
* model  the model axis with the broadcast-and-mask lookup: every shard
         still walks all E entries; capacity scales, throughput does not.

Each shard count s runs on ranks [0, s) of the job (a mesh smaller than the
world); the other ranks wait.  A shard count's time per call is the slowest
member's (a loop of rotated calls, ``tools/common.py``); lookups/s is the
global lookups a call over it.  ``scaling_efficiency`` is lookups/s at s over
s times lookups/s at 1.

The counterpart of the JAX package's ``tools/scaling_bench.py``, with its
flags, defaults and JSON keys, plus ``--device`` and the device keys
(``device_lookups_per_s``: the same rates by CUDA events, where no
collective runs in the loop, so on the data axis; ``device_name``,
``device_count``).  On the card run it under torchrun, one process a card
(NCCL):

    torchrun --nproc-per-node 4 -m pim_embedding_lookup_tpu_torch.tools.scaling_bench --axis data

``--force-cpu N`` starts N gloo processes on the CPU instead.  They share
one host's cores, so their efficiency means nothing; what they show is the
structure: the collectives run, and the routed axis drops nothing.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..config import ShardingPolicy, TableConfig
from ..parallel.collection import EmbeddingCollection
from ..parallel.mesh import make_mesh
from . import common

MODULE = "pim_embedding_lookup_tpu_torch.tools.scaling_bench"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="scaling_bench")
    ap.add_argument("--force-cpu", type=int, default=0,
                    help="start N gloo processes on the CPU instead of using the job's "
                         "devices (efficiency there means nothing)")
    ap.add_argument("--axis", default="data", choices=["data", "model", "routed"])
    ap.add_argument("--rows", type=int, default=500_000)
    ap.add_argument("--tables", type=int, default=8)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--batch", type=int, default=1024,
                    help="per-data-shard batch (data axis) or global batch")
    ap.add_argument("--pooling", type=int, default=16)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--policy", default="row_hash")
    ap.add_argument("--capacity-factor", type=float, default=2.0,
                    help="routed-axis bucket capacity (throughput mode; drops are "
                         "counted and reported)")
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def rate_at(num_shards, axis, tables, batch, pooling, iters, policy_name, dev,
            capacity_factor=2.0):
    """(global lookups a call, host µs, device µs or None, routed drops) of
    this process at ``num_shards``; a rank outside the mesh returns None."""
    if axis == "data":
        mesh = make_mesh(data=num_shards, model=1, device=dev)
        policy = ShardingPolicy.REPLICATE
        b = batch * num_shards  # the global batch grows with the data axis
    else:
        mesh = make_mesh(data=1, model=num_shards, device=dev)
        policy = (ShardingPolicy.REPLICATE if num_shards == 1
                  else ShardingPolicy(policy_name))
        b = batch
    if not mesh.member:
        return None
    coll = EmbeddingCollection.create(tables, policy, packed="auto", mesh=mesh)
    fused = coll.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    t = len(tables)
    idx = mesh.data_slice(torch.from_numpy(common.uniform_ids(rng, tables, b * pooling)), 1)
    idx = idx.contiguous().to(dev)
    mask = torch.ones(idx.shape, dtype=torch.bool, device=dev)
    rows, stride = common.rotation(tables, dev)
    routed = axis == "routed" and num_shards > 1
    drops = 0
    if routed:  # the uniform stream at this capacity factor should drop nothing
        _, d = coll.lookup_routed(fused, idx, mask, batch_size=idx.shape[1] // pooling,
                                  capacity_factor=capacity_factor, return_stats=True)
        drops = int(d)
        body = lambda i: coll.lookup_routed(  # noqa: E731
            fused, i, mask, batch_size=i.shape[1] // pooling, capacity_factor=capacity_factor)
    else:
        body = lambda i: coll.lookup(fused, i, mask, batch_size=i.shape[1] // pooling)  # noqa: E731
    loop = common.RotatingLoop(body, idx, rows, stride)
    # events only where the loop runs no collective: each rank's sleep
    # kernel ends at its own time, and a collective would count the wait
    host_us, device_us = common.loop_us(loop, iters, dev,
                                        events=axis == "data" or num_shards == 1)
    return b * t, host_us, device_us, drops


def run(args) -> dict | None:
    """One process of the job: every shard count, the result on rank 0."""
    dev, joined = common.join(args.device, group_of_one=True)
    try:
        tables = tuple(TableConfig(num_rows=args.rows, dim=args.dim, name=f"t{i}")
                       for i in range(args.tables))
        n = dist.get_world_size()
        counts = [s for s in [1, 2, 4, 8, 16, 32] if s <= n]
        results, device_rates, drops = {}, {}, {}
        for s in counts:
            mine = rate_at(s, args.axis, tables, args.batch, args.pooling, args.iters,
                           args.policy, dev, args.capacity_factor)
            every = [None] * n
            dist.all_gather_object(every, mine)  # non-members wait here
            members = [r for r in every if r is not None]
            lookups = members[0][0]
            results[s] = lookups / max(r[1] for r in members) * 1e6
            if all(r[2] is not None for r in members):  # the data axis on the card
                device_rates[s] = lookups / max(r[2] for r in members) * 1e6
            drops[s] = max(r[3] for r in members)
            if common.primary():
                print(f"shards={s}: {results[s] / 1e6:.2f}M lookups/s (drops={drops[s]})",
                      file=sys.stderr, flush=True)
        base = results[counts[0]]
        result = {
            "axis": args.axis,
            "policy": args.policy,
            "capacity_factor": args.capacity_factor,
            "lookups_per_s": {str(s): round(r, 1) for s, r in results.items()},
            "routed_drops": {str(s): d for s, d in drops.items()},
            "scaling_efficiency": {str(s): round(r / (base * s), 3) for s, r in results.items()},
            "device_lookups_per_s": {str(s): round(r, 1) for s, r in device_rates.items()}
            or None,
            **common.device_info(dev),
        }
        if common.primary():
            print(json.dumps(result), flush=True)
            return result
        return None
    finally:
        common.leave(joined)


def main(argv=None) -> dict | None:
    args = parse_args(argv)
    if not args.force_cpu:
        return run(args)
    print(f"scaling_bench: {args.force_cpu} gloo processes on one host's CPU share its "
          "cores: the efficiency below means nothing, only the structure does",
          file=sys.stderr)
    out = common.launch_local(MODULE, common.without_flag(
        sys.argv[1:] if argv is None else argv, "--force-cpu"), args.force_cpu)
    line = out.strip().splitlines()[-1]
    print(line, flush=True)
    return json.loads(line)


if __name__ == "__main__":
    main()
