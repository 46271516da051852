"""The multi-host battery: one process of a job that a launcher started,
one process a device, several hosts.

The counterpart of the JAX package's multi-process worker: each process
joins through ``multihost.initialize()`` from the launcher's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``), builds the pod mesh
(a data row a host, the model axis within it), feeds only its host's slice
of the batch (``make_global_queries``) and only its shard of the tables
(``device_put_tables``), and checks its own results against a numpy oracle
made from the seed every process shares.  No process builds a global query
or a global table.

Cases, in order: the pod mesh; REPLICATE, ROW, COLUMN and ROW_HASH lookups
and sparse SGD, and for ROW and ROW_HASH the routed lookup and update with
no drops; for ROW_HASH the data-sharded CSR lookup, broadcast and routed,
and one hybrid sparse train step routed against broadcast; a pod mesh whose
model row would span two hosts, refused; last a mesh smaller than the
world, whose members serve a lookup and whose other ranks enter none of
its collectives.  Each process writes ``<out>/rank<r>.json``: per case
"ok", or the traceback.

    python -m pim_embedding_lookup_tpu_torch.multihost_battery OUT_DIR [cpu|cuda]

With ``cuda`` the hosts are simulated on one machine: process r drives
card r.
"""

from __future__ import annotations

import json
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .config import DLRMConfig, ShardingPolicy, TableConfig
from .models import DLRM
from .models.sparse_train import make_sparse_train_state, make_sparse_train_step
from .ops.ragged import shard_csr
from .parallel import multihost
from .parallel.collection import EmbeddingCollection
from .parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh
from .parallel.sparse_update import init_accumulator, sparse_update

TABLES = (96, 40, 256)  # rows of each table, dim DIM
DIM = 16
BATCH, POOLING = 8, 3  # global batch
LR = 0.05
TOL = dict(rtol=1e-5, atol=1e-5)
POLICIES = ("replicate", "row", "column", "row_hash")


def tables():
    return tuple(TableConfig(num_rows=n, dim=DIM, name=f"t{i}") for i, n in enumerate(TABLES))


class Job:
    """One process's view: its mesh, its host's slice, the shared data."""

    def __init__(self, device: torch.device):
        self.device = device
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.host = int(os.environ["GROUP_RANK"])
        rng = np.random.default_rng(7)  # the same seed in every process
        self.host_tables = [rng.standard_normal((n, DIM)).astype(np.float32) for n in TABLES]
        t = len(TABLES)
        self.idx = np.stack([rng.integers(0, n, size=BATCH * POOLING)
                             for n in TABLES]).astype(np.int32)
        self.mask = rng.random((t, BATCH * POOLING)) < 0.8
        self.g = rng.standard_normal((BATCH, t, DIM)).astype(np.float32)
        self.oracle = np.zeros((BATCH, t, DIM), np.float32)
        self.updated = [a.copy() for a in self.host_tables]
        for k in range(t):
            for e in range(BATCH * POOLING):
                if self.mask[k, e]:
                    self.oracle[e // POOLING, k] += self.host_tables[k][self.idx[k, e]]
                    self.updated[k][self.idx[k, e]] -= LR * self.g[e // POOLING, k]
        self.mesh = None

    # -- this process's part ------------------------------------------------

    def hosts(self) -> int:
        return self.world // int(os.environ["LOCAL_WORLD_SIZE"])

    def bags(self):
        """This host's bags [lo, hi) of the global batch."""
        bd = BATCH // self.hosts()
        return self.host * bd, (self.host + 1) * bd

    def queries(self):
        lo, hi = self.bags()
        return multihost.make_global_queries(self.mesh, self.idx[:, lo * POOLING:hi * POOLING],
                                             self.mask[:, lo * POOLING:hi * POOLING])

    def grads(self):
        lo, hi = self.bags()
        return torch.from_numpy(self.g[lo:hi]).to(self.device)

    def check(self, got, want, what):
        np.testing.assert_allclose(got.detach().cpu().numpy(), want, **TOL,
                                   err_msg=f"{what} (rank {self.rank})")

    def loaded(self, policy):
        coll = EmbeddingCollection.create(tables(), ShardingPolicy(policy), mesh=self.mesh)
        return coll, multihost.device_put_tables(coll, self.host_tables)

    # -- cases --------------------------------------------------------------

    def pod_mesh(self):
        again = multihost.initialize()
        assert again == self.device, (again, self.device)
        local = int(os.environ["LOCAL_WORLD_SIZE"])
        self.mesh = multihost.make_pod_mesh()
        assert (self.mesh.data, self.mesh.model) == (self.hosts(), local), self.mesh.shape
        assert self.mesh.index(DATA_AXIS) == self.host  # a data row a host
        assert multihost.is_primary() == (self.rank == 0)
        keys = [None] * self.world
        dist.all_gather_object(keys, multihost.host_key())
        for row in range(self.mesh.data):  # every model row on one host
            assert len(set(keys[row * local:(row + 1) * local])) == 1, keys

    def lookup_update(self, policy):
        coll, fused = self.loaded(policy)
        idx, mask = self.queries()
        lo, hi = self.bags()
        self.check(coll.lookup(fused, idx, mask, batch_size=hi - lo), self.oracle[lo:hi],
                   f"{policy} lookup")
        want = coll.shard_host_array(coll.fused_host_array(self.updated))
        f, acc = fused.clone(), init_accumulator(coll)
        sparse_update(coll, f, acc, idx, mask, self.grads(), lr=LR, optimizer="sgd")
        self.check(f, want, f"{policy} sparse SGD")
        if policy in ("row", "row_hash"):
            out, dropped = coll.lookup_routed(fused, idx, mask, batch_size=hi - lo,
                                              return_stats=True)
            assert int(dropped.item()) == 0, f"routed lookup dropped {int(dropped.item())}"
            self.check(out, self.oracle[lo:hi], f"{policy} routed lookup")
            f, acc = fused.clone(), init_accumulator(coll)
            _, _, dropped = sparse_update(coll, f, acc, idx, mask, self.grads(), lr=LR,
                                          optimizer="sgd", routed=True, return_stats=True)
            assert int(dropped.item()) == 0, f"routed update dropped {int(dropped.item())}"
            self.check(f, want, f"{policy} routed sparse SGD")

    def csr_data_sharded(self):
        coll, fused = self.loaded("row_hash")
        rng = np.random.default_rng(11)
        bags = [[rng.integers(0, n, size=rng.integers(0, 5)).tolist() for _ in range(BATCH)]
                for n in TABLES]
        nd, cap = self.hosts(), BATCH * 5 // self.hosts()
        idx_host, off_host = shard_csr(bags, nd, capacity_per_shard=cap)
        oracle = np.zeros((BATCH, len(TABLES), DIM), np.float32)
        for k, table_bags in enumerate(bags):
            for b, bag in enumerate(table_bags):
                for r in bag:
                    oracle[b, k] += self.host_tables[k][r]
        lo, hi = self.bags()
        h, bd = self.host, hi - lo
        idx, off = multihost.make_global_queries(
            self.mesh, idx_host[:, h * cap:(h + 1) * cap],
            off_host[:, h * (bd + 1):(h + 1) * (bd + 1)])
        self.check(coll.lookup_csr(fused, idx, off, data_sharded=True), oracle[lo:hi],
                   "data-sharded CSR lookup")
        out, dropped = coll.lookup_csr(fused, idx, off, data_sharded=True, routed=True,
                                       return_stats=True)
        assert int(dropped.item()) == 0, f"routed CSR dropped {int(dropped.item())}"
        self.check(out, oracle[lo:hi], "routed data-sharded CSR lookup")

    def hybrid_step(self):
        cfg = DLRMConfig(dense_dim=4, mlp_bot=(8, 16), mlp_top=(8, 1), tables=(
            TableConfig(num_rows=48, dim=16, name="s"), TableConfig(num_rows=16384, dim=16,
                                                                    name="b")))
        rng = np.random.default_rng(23)
        b, l = 8 * self.hosts(), 2
        dense = rng.standard_normal((b, 4)).astype(np.float32)
        idx = np.stack([rng.integers(0, t.num_rows, size=b * l)
                        for t in cfg.tables]).astype(np.int32)
        labels = (rng.random(b) < 0.5).astype(np.float32)
        h, bd = self.host, b // self.hosts()
        q = multihost.make_global_queries(self.mesh, idx[:, h * bd * l:(h + 1) * bd * l],
                                          np.ones((2, bd * l), bool))
        batch = (torch.from_numpy(dense[h * bd:(h + 1) * bd]).to(self.device), *q,
                 torch.from_numpy(labels[h * bd:(h + 1) * bd]).to(self.device))
        out = {}
        for routed in (False, True):
            model = DLRM(cfg, ShardingPolicy.ROW_HASH, hybrid=True, mesh=self.mesh,
                         generator=torch.Generator(device=self.device).manual_seed(0))
            opt, acc = make_sparse_train_state(model, lr=0.2)
            step = make_sparse_train_step(model, opt, lr=0.2, optimizer="row_adagrad",
                                          routed=routed)
            _, loss = step(acc, *batch)
            out[routed] = (float(loss), model.emb_big.detach().clone())
        assert abs(out[True][0] - out[False][0]) < 1e-5, (out[True][0], out[False][0])
        self.check(out[True][1], out[False][1].cpu().numpy(), "hybrid routed big-set shard")

    def refuse_cross_host(self):
        try:
            multihost.make_pod_mesh(data=1, model=self.world)
        except ValueError as e:
            assert "spans hosts" in str(e), e
        else:
            raise AssertionError("a model row across hosts was not refused")

    def sub_mesh(self):
        """A (1, 2) mesh in the whole world: ranks 0 and 1 serve a ROW_HASH
        lookup of the whole batch; the others are outside it, refuse a
        lookup and enter no collective."""
        sub = make_mesh(data=1, model=2, device=self.device)
        coll = EmbeddingCollection.create(tables(), ShardingPolicy.ROW_HASH, mesh=sub)
        idx, mask = (torch.from_numpy(x).to(self.device) for x in (self.idx, self.mask))
        if not sub.member:
            assert self.rank >= 2
            dummy = torch.zeros(coll.layout.storage_rows // 2, coll.layout.storage_width,
                                device=self.device)
            try:
                coll.lookup(dummy, idx, mask, batch_size=BATCH)
            except ValueError as e:
                assert "outside" in str(e), e
            else:
                raise AssertionError("a lookup outside the mesh was not refused")
            return
        fused = coll.device_put_tables(self.host_tables)
        self.check(coll.lookup(fused, idx, mask, batch_size=BATCH), self.oracle,
                   "sub-mesh ROW_HASH lookup")
        dist.barrier(group=sub.group(MODEL_AXIS))

    def run(self, case):
        kind, _, policy = case.partition("-")
        if kind == "lookup_update":
            return self.lookup_update(policy)
        return {"pod_mesh": self.pod_mesh, "csr_data_sharded": self.csr_data_sharded,
                "hybrid_step": self.hybrid_step, "refuse_cross_host": self.refuse_cross_host,
                "sub_mesh": self.sub_mesh}[kind]()


CASES = ("pod_mesh", *(f"lookup_update-{p}" for p in POLICIES), "csr_data_sharded-row_hash",
         "hybrid_step-row_hash", "refuse_cross_host", "sub_mesh")


def main(argv) -> int:
    out_dir = Path(argv[0])
    kind = argv[1] if len(argv) > 1 else "cuda"
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank = int(os.environ["RANK"])
    device = (torch.device("cpu") if kind == "cpu"
              else torch.device("cuda", rank % torch.cuda.device_count()))
    job = Job(multihost.initialize(device=device))
    results = {}
    for name in CASES:
        try:
            job.run(name)
            results[name] = "ok"
        except Exception:  # noqa: BLE001 -- recorded for the case's test
            results[name] = traceback.format_exc()
    (out_dir / f"rank{rank}.json").write_text(json.dumps(results))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
