"""The rows each model shard gathers, broadcast against routed: the
evidence for the routed lookup's ~cf*E/M claim.

The counterpart of the JAX package's ``tools/routed_hlo_audit.py``.  The
JAX tool reads the gathers' row counts out of the compiled per-shard HLO;
eager PyTorch has no HLO, so this tool records them as they run: a
``TorchDispatchMode`` on each rank of an M-process mesh notes the first
dimension of every gather-like operation's output (``index_select``,
``embedding_bag``, ``embedding``, ``gather`` and advanced indexing), and
the pool kernels' wrappers as the collection calls them (the ids they
read; on the CPU their plain versions' ``index_select`` shows the same
count), over three lookups on ROW_HASH storage:

* the broadcast ``lookup``: every shard walks all E entries;
* ``lookup_routed``: the largest gather is the capacity-bucketed M*K
  table-shard gather, K = ``routed_bucket_k(ceil(E/M), cf, M)``, and no
  gather touches E rows (for M > 1);
* ``lookup_csr(routed=True)`` on single-entry bags: the same.

A record has the fields of the JAX tool's ``audit()``.  The tool prints
one record per (cf, M), M = 1, 2, 4, 8, ... up to the job's processes, and
writes nothing (the JAX tool rewrites ``benchmarks/scaling_routed_cpu8.json``;
``tests/test_torch_port_tools_mesh.py`` holds this tool's rows against
that file).

    python -m pim_embedding_lookup_tpu_torch.tools.routed_gather_audit --force-cpu 8
    torchrun --nproc-per-node 4 -m pim_embedding_lookup_tpu_torch.tools.routed_gather_audit
"""

from __future__ import annotations

import argparse
import json
import sys
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..config import ShardingPolicy, TableConfig
from ..parallel import collection as collection_mod
from ..parallel.collection import EmbeddingCollection, routed_bucket_k
from ..parallel.mesh import make_mesh
from . import common

MODULE = "pim_embedding_lookup_tpu_torch.tools.routed_gather_audit"
_aten = torch.ops.aten
GATHERS = {_aten.index_select.default, _aten.embedding.default, _aten.gather.default,
           _aten.index.Tensor, _aten._embedding_bag.default,
           _aten._embedding_bag_forward_only.default}


class GatherRows(TorchDispatchMode):
    """Records the first output dimension of every gather-like operation,
    and the ids each pool kernel's wrapper reads, inside it."""

    def __init__(self):
        super().__init__()
        self.rows: list[int] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in GATHERS:
            first = out[0] if isinstance(out, tuple) else out
            self.rows.append(int(first.shape[0]))
        return out

    def pool(self, fn):
        """``fn`` (a pool wrapper) recording the entries it reads."""
        def wrapped(storage, d, indices, *args, **kwargs):
            self.rows.append(int(indices.numel()))
            return fn(storage, d, indices, *args, **kwargs)
        return wrapped


def recorded(call) -> list[int]:
    """Sorted distinct gather row counts of ``call()``."""
    with GatherRows() as rec, \
            mock.patch.object(collection_mod, "embedding_bag_fixedl",
                              rec.pool(collection_mod.embedding_bag_fixedl)), \
            mock.patch.object(collection_mod, "embedding_bag_csr_packed",
                              rec.pool(collection_mod.embedding_bag_csr_packed)):
        call()
    return sorted(set(rec.rows))


def audit(mesh, *, e_total: int = 1024, rows: int = 4096, num_tables: int = 4,
          cf: float = 1.0) -> dict:
    """The record of one M (this process's gathers on a (1, M) mesh), with
    the fields of the JAX tool's ``audit()``."""
    m = mesh.model
    tables = tuple(TableConfig(num_rows=rows, dim=16, name=f"t{i}") for i in range(num_tables))
    c = e_total // num_tables
    coll = EmbeddingCollection.create(tables, ShardingPolicy.ROW_HASH, mesh=mesh)
    fused = coll.init(torch.Generator(device=mesh.device).manual_seed(0))
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(np.stack([rng.integers(0, rows, size=c) for _ in tables])
                           .astype(np.int32)).to(mesh.device)
    mask = torch.ones(num_tables, c, dtype=torch.bool, device=mesh.device)
    # single-entry bags: B == C, E unchanged
    offsets = torch.arange(c + 1, dtype=torch.int32, device=mesh.device).expand(
        num_tables, -1).contiguous()
    with torch.no_grad():
        routed = recorded(lambda: coll.lookup_routed(fused, idx, mask, batch_size=c,
                                                     capacity_factor=cf))
        bcast = recorded(lambda: coll.lookup(fused, idx, mask, batch_size=c))
        csr = recorded(lambda: coll.lookup_csr(fused, idx, offsets, routed=True,
                                               capacity_factor=cf))
    em = -(-e_total // m)
    k = routed_bucket_k(em, cf, m)  # the library's own K
    return {
        "m": m,
        "e_total": e_total,
        "cf": cf,
        "expected_routed_rows": m * k,
        "routed_gather_rows": routed,
        "routed_csr_gather_rows": csr,
        "broadcast_gather_rows": bcast,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="routed_gather_audit")
    ap.add_argument("--force-cpu", type=int, default=0,
                    help="start N gloo processes on the CPU (8: the JAX tool's mesh)")
    ap.add_argument("--cf", default="1.0,2.0",
                    help="capacity factors, comma-separated (1.0: the tightest bucket; "
                         "2.0: the documented ROW_HASH scaling point)")
    ap.add_argument("--e-total", type=int, default=1024)
    common.add_device_arg(ap)
    return ap.parse_args(argv)


def run(args) -> list[dict] | None:
    """One process of the job: the records of every M, on rank 0."""
    dev, joined = common.join(args.device, group_of_one=True)
    try:
        n = dist.get_world_size()
        records = []
        for m in [s for s in [1, 2, 4, 8, 16, 32] if s <= n]:
            mesh = make_mesh(data=1, model=m, device=dev)  # ranks past m wait
            mine = ([audit(mesh, e_total=args.e_total, cf=float(cf))
                     for cf in args.cf.split(",")] if mesh.member else None)
            every = [None] * n
            dist.all_gather_object(every, mine)
            members = [r for r in every if r is not None]
            if any(r != members[0] for r in members):
                raise AssertionError(f"M={m}: the shards gathered different rows: {members}")
            records += members[0]
        if common.primary():
            for r in records:
                print(json.dumps(r), flush=True)
            return records
        return None
    finally:
        common.leave(joined)


def main(argv=None) -> list[dict] | None:
    args = parse_args(argv)
    if not args.force_cpu:
        return run(args)
    out = common.launch_local(MODULE, common.without_flag(
        sys.argv[1:] if argv is None else argv, "--force-cpu"), args.force_cpu)
    print(out, end="", flush=True)
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


if __name__ == "__main__":
    main()
