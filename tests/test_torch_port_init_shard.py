"""``EmbeddingCollection.init`` by shard, and the mesh's collectives in
their spans and counters.

A process draws every table in chunks (``collection.INIT_CHUNK_ELEMENTS``)
and keeps what its shard holds, so no process holds the global storage.
Over 1 x 2, 2 x 1 and 2 x 2 gloo clusters (a module fixture starts the
three at once, 8 CPU processes, each this file run as a script: ``python
tests/test_torch_port_init_shard.py RANK WORLD DATA MODEL STORE OUT``),
every rank's shard under ROW, ROW_HASH and COLUMN, gathered over the model
axis, equals the one-process init's tables bit for bit, at the default
chunk and at one of 100 rows that cuts tables and shards at other places.
The 2 x 2 cluster also runs one sparse train step of a hybrid DLRM under
the profiler: its collectives, their ``pel.comm.*`` spans inside the
layer spans, and ``mesh.comm_calls`` / ``comm_bytes``.  On one process the
init of a table within one chunk draws as it always has.  On the card
(``-m cuda``) a ROW_HASH shard's init allocates no more than the shard and
one chunk.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pim_embedding_lookup_tpu_torch import config as tcfg
from pim_embedding_lookup_tpu_torch.parallel import collection as coll_mod
from pim_embedding_lookup_tpu_torch.parallel import mesh as mesh_mod
from pim_embedding_lookup_tpu_torch.parallel.collection import EmbeddingCollection
from pim_embedding_lookup_tpu_torch.parallel.hybrid import HybridEmbeddingCollection

REPO = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (2, 1), (2, 2))  # (data, model)
POLICIES = ("row", "row_hash", "column")
ROWS = (50, 700, 1234, 97)  # two tables past a chunk of 100 rows
DIM = 8
SEED = 7
CHUNKS = {"default": coll_mod.INIT_CHUNK_ELEMENTS, "small": 100 * DIM}
# the train step's model: a small set of two tables and a big set of two
STEP_ROWS = (50, 300, 9000, 20000)
STEP_BATCH, STEP_POOLING = 16, 2  # global batch, ids a bag


def _tables(rows=ROWS, dim=DIM):
    return [tcfg.TableConfig(num_rows=n, dim=dim, name=f"t{i}") for i, n in enumerate(rows)]


def _gen(seed=SEED, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


def _step_model(mesh=None):
    from pim_embedding_lookup_tpu_torch.models import DLRM

    cfg = tcfg.DLRMConfig(dense_dim=4, mlp_bot=(16, DIM), mlp_top=(16, 1),
                          tables=tuple(_tables(STEP_ROWS)))
    return DLRM(cfg, tcfg.ShardingPolicy.ROW_HASH if mesh else tcfg.ShardingPolicy.REPLICATE,
                hybrid=True, device="cpu", mesh=mesh, generator=_gen(0))


def _step_batch(data, index):
    """Data row ``index``'s part of the step's global batch."""
    rng = np.random.default_rng(11)
    bsz, n = STEP_BATCH, STEP_BATCH * STEP_POOLING
    ids = np.stack([rng.integers(0, r, n) for r in STEP_ROWS]).astype(np.int32)
    dense = rng.random((bsz, 4), dtype=np.float32)
    labels = (rng.random(bsz) < 0.5).astype(np.float32)
    bd = bsz // data
    lo, hi = index * bd, (index + 1) * bd
    return (torch.from_numpy(dense[lo:hi].copy()),
            torch.from_numpy(ids[:, lo * STEP_POOLING:hi * STEP_POOLING].copy()),
            torch.ones(len(STEP_ROWS), bd * STEP_POOLING, dtype=torch.bool),
            torch.from_numpy(labels[lo:hi].copy()))


def _enclosing(spans: dict, name: str, layers) -> list:
    """For each span ``name``, the innermost of ``layers`` around it."""
    out = []
    for s, e in spans.get(name, []):
        around = [(le - ls, layer) for layer in layers for ls, le in spans.get(layer, [])
                  if ls <= s and e <= le]
        out.append(min(around)[1] if around else None)
    return out


# -- a rank of a cluster ----------------------------------------------------------


def _worker(rank, world, data, model, store, out) -> int:
    from torch.profiler import ProfilerActivity, profile

    from pim_embedding_lookup_tpu_torch.models.sparse_train import (
        make_sparse_train_state,
        make_sparse_train_step,
    )

    torch.set_num_threads(1)
    mesh_mod.init_distributed(rank, world, f"file://{store}", device="cpu")
    mesh = mesh_mod.make_mesh(data=data, model=model, device="cpu")
    arrays, meta = {}, {}
    for chunk, elements in CHUNKS.items():
        coll_mod.INIT_CHUNK_ELEMENTS = elements
        for policy in POLICIES:
            coll = EmbeddingCollection.create(_tables(), tcfg.ShardingPolicy(policy),
                                              packed="auto", mesh=mesh)
            local = coll.init(_gen())
            meta[f"{chunk}-{policy}"] = list(local.shape)
            for i, table in enumerate(coll.unfuse_host(local)):
                arrays[f"{chunk}-{policy}-t{i}"] = table
    coll_mod.INIT_CHUNK_ELEMENTS = CHUNKS["default"]
    if (data, model) == (2, 2):
        model_ = _step_model(mesh)
        dense_opt, acc = make_sparse_train_state(model_, lr=0.1)
        step = make_sparse_train_step(model_, dense_opt, lr=0.1)
        batch = _step_batch(data, mesh.index("data"))
        mesh_mod.comm_calls.clear()
        mesh_mod.comm_bytes.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(acc, *batch)
        meta["calls"] = [[*k, v] for k, v in mesh_mod.comm_calls.items()]
        meta["bytes"] = [[*k, v] for k, v in mesh_mod.comm_bytes.items()]
        trace = Path(out) / f"trace{rank}.json"
        prof.export_chrome_trace(str(trace))
        spans: dict = {}
        for e in json.loads(trace.read_text())["traceEvents"]:
            if e.get("ph") == "X" and e.get("cat") == "user_annotation":
                spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
        layers = ("pel.lookup.big", "pel.lookup", "pel.train.dense", "pel.sparse_update",
                  "pel.train_step")
        meta["inside"] = {name: _enclosing(spans, name, layers)
                          for name in mesh_mod.COMM_SPANS.values()}
        meta["train_steps"] = len(spans.get("pel.train_step", []))
    np.savez(Path(out) / f"rank{rank}.npz", **arrays)
    (Path(out) / f"rank{rank}.json").write_text(json.dumps(meta))
    torch.distributed.barrier()  # no rank leaves while a peer's gloo still talks to it
    torch.distributed.destroy_process_group()
    return 0


# -- the clusters -----------------------------------------------------------------


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Every mesh's ranks, started at once: {(data, model): [(arrays, meta)
    of each rank]}."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    started = {}
    for data, model in MESHES:
        tmp = tmp_path_factory.mktemp(f"init{data}x{model}")
        world = data * model
        started[data, model] = tmp, [
            subprocess.Popen([sys.executable, __file__, str(r), str(world), str(data),
                              str(model), str(tmp / "store"), str(tmp)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             cwd=REPO, env=env)
            for r in range(world)]
    procs = [p for _, ps in started.values() for p in ps]
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline and any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            time.sleep(2)
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    out, failed = {}, []
    for key, (tmp, ps) in started.items():
        for r, p in enumerate(ps):
            _, err = p.communicate(timeout=30)
            if p.returncode != 0:
                failed.append(f"mesh {key} rank {r} rc={p.returncode}\n{err[-4000:]}")
        if not failed:
            out[key] = [(dict(np.load(tmp / f"rank{r}.npz")),
                         json.loads((tmp / f"rank{r}.json").read_text()))
                        for r in range(len(ps))]
    assert not failed, "\n\n".join(failed)
    return out


def _one_process_tables(chunk: str):
    saved = coll_mod.INIT_CHUNK_ELEMENTS
    coll_mod.INIT_CHUNK_ELEMENTS = CHUNKS[chunk]
    try:
        coll = EmbeddingCollection.create(_tables(), device="cpu")
        return coll.unfuse_host(coll.init(_gen()))
    finally:
        coll_mod.INIT_CHUNK_ELEMENTS = saved


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_shards_gather_to_the_one_process_tables(clusters, mesh, policy, chunk):
    want = _one_process_tables(chunk)
    for rank, (arrays, meta) in enumerate(clusters[mesh]):
        for i, table in enumerate(want):
            got = arrays[f"{chunk}-{policy}-t{i}"]
            assert np.array_equal(_bits(got), _bits(table)), (mesh, rank, i)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_each_rank_holds_its_shard_alone(clusters, mesh, policy):
    """A row shard holds rows_per_shard fused rows, a COLUMN shard its dims
    of every row: never the global storage."""
    data, model = mesh
    lay = EmbeddingCollection.create(_tables(), tcfg.ShardingPolicy(policy), packed="auto",
                                     mesh=_FakeMesh(data, model)).layout
    for _, meta in clusters[mesh]:
        rows, width = meta[f"default-{policy}"]
        assert rows * width == lay.total_rows * lay.dim // model


class _Draws(TorchDispatchMode):
    """The element count of each ``uniform_`` inside it."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.uniform_.default:
            self.sizes.append(args[0].numel())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", POLICIES)
def test_every_shard_draws_every_table_chunk_by_chunk(monkeypatch, policy):
    """Each shard draws every table whole, in chunks of at most
    ``INIT_CHUNK_ELEMENTS``, from each table's first row."""
    monkeypatch.setattr(coll_mod, "INIT_CHUNK_ELEMENTS", CHUNKS["small"])
    want = [min(100, n - lo) * DIM for n in ROWS for lo in range(0, n, 100)]
    for shard in range(2):
        coll = EmbeddingCollection.create(_tables(), tcfg.ShardingPolicy(policy),
                                          packed="auto", mesh=_FakeMesh(1, 2, rank=shard))
        with _Draws() as draws:
            coll.init(_gen())
        assert draws.sizes == want


def _init_as_before(lay, generator, dtype=torch.float32):
    """The one-process init as it was before chunks: the fused storage
    zeroed, then each table drawn in one call, in table order."""
    fused = torch.zeros(lay.total_rows, lay.dim, dtype=dtype)
    for off, rows in zip(lay.row_offsets, lay.table_rows):
        bound = 1.0 / np.sqrt(rows)
        fused[off:off + rows].uniform_(-bound, bound, generator=generator)
    return fused.view(lay.storage_rows, lay.storage_width)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("policy,packed", [("replicate", False), ("replicate", "auto"),
                                           ("row", "auto"), ("row_hash", False),
                                           ("column", False), ("table_wise", "auto")])
def test_one_process_init_unchanged_within_a_chunk(policy, packed, dtype):
    coll = EmbeddingCollection.create(_tables(), tcfg.ShardingPolicy(policy), packed=packed,
                                      device="cpu")
    got = coll.init(_gen(), dtype)
    want = _init_as_before(coll.layout, _gen(), dtype)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_one_process_hybrid_init_unchanged():
    """Both sets of a hybrid, drawn from one generator in their order."""
    hyb = HybridEmbeddingCollection.create(_tables(STEP_ROWS), device="cpu")
    got = hyb.init(_gen())
    g = _gen()
    big = _init_as_before(hyb.big.layout, g)
    small = _init_as_before(hyb.small.layout, g)
    assert torch.equal(got["big"], big) and torch.equal(got["small"], small)


class _FakeMesh:
    """A place in a (data, model) mesh with no process group: enough for
    planning and for ``init``, which runs no collective."""

    def __init__(self, data, model, rank=0, device="cpu"):
        self.data, self.model, self.rank = data, model, rank
        self.device = torch.device(device)

    def index(self, axis):
        return self.rank // self.model if axis == mesh_mod.DATA_AXIS else self.rank % self.model


# -- the collectives' spans and counters -------------------------------------------


def _expected_step_comm():
    """(calls, bytes) by (op, axis) of one sparse step on the 2 x 2 mesh:
    the big set's psum over the model axis; the dense gradients' and the
    loss's psums over the data axis; the ids (int32), the mask (bytes) and
    the cotangents (f32) of every table gathered over it, once each."""
    tables = len(STEP_ROWS)
    big = sum(n > 8192 for n in STEP_ROWS)
    bd = STEP_BATCH // 2
    entries = bd * STEP_POOLING
    params = sum(p.numel() for p in _step_model().parameters())
    gathers = [tables * entries * 4, tables * entries, bd * tables * DIM * 4]
    calls = {("psum", "model"): 1, ("psum", "data"): 2, ("all_gather", "data"): 3}
    nbytes = {("psum", "model"): bd * big * DIM * 4, ("psum", "data"): params * 4 + 4,
              ("all_gather", "data"): sum(gathers)}
    return calls, nbytes


def test_train_step_counts_its_collectives(clusters):
    calls, nbytes = _expected_step_comm()
    for _, meta in clusters[2, 2]:
        assert {(op, ax): n for op, ax, n in meta["calls"]} == calls
        assert {(op, ax): n for op, ax, n in meta["bytes"]} == nbytes


def test_train_step_records_comm_spans_inside_its_layers(clusters):
    """The model axis's psum inside the big set's lookup, the data axis's
    two psums inside the dense half and its three gathers inside the sparse
    update: six spans a step."""
    for _, meta in clusters[2, 2]:
        assert meta["train_steps"] == 1
        assert meta["inside"]["pel.comm.model"] == ["pel.lookup.big"]
        inside = sorted(meta["inside"]["pel.comm.data"])
        assert inside == ["pel.sparse_update"] * 3 + ["pel.train.dense"] * 2


def test_one_process_step_runs_no_collective():
    from pim_embedding_lookup_tpu_torch.models.sparse_train import (
        make_sparse_train_state,
        make_sparse_train_step,
    )

    model = _step_model()
    dense_opt, acc = make_sparse_train_state(model, lr=0.1)
    step = make_sparse_train_step(model, dense_opt, lr=0.1)
    before = sum(mesh_mod.comm_calls.values())
    step(acc, *_step_batch(1, 0))
    assert sum(mesh_mod.comm_calls.values()) == before


# -- on the card ------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_card_row_hash_init_holds_its_shard_and_one_chunk():
    """A ROW_HASH shard of two of 6.1 GB of tables (d=128, f32) over a
    model axis of 2: the init's peak is the 3.07 GB shard and one 1 GB
    chunk, each a block of whole 2 MiB units of the caching allocator, not
    the global storage."""
    dev = torch.device("cuda", torch.cuda.current_device())
    tables = _tables((6_000_000, 5_999_993), 128)
    coll = EmbeddingCollection.create(tables, tcfg.ShardingPolicy.ROW_HASH,
                                      mesh=_FakeMesh(1, 2, rank=1, device=dev))
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    local = coll.init(_gen(device=dev))
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    lay = coll.layout
    shard = lay.rows_per_shard * lay.dim * 4
    assert local.numel() * 4 == shard
    block = 2 << 20
    assert peak <= sum(-(-n // block) * block for n in (shard, coll_mod.INIT_CHUNK_ELEMENTS * 4))
    assert peak < lay.total_rows * lay.dim * 4
    del local


if __name__ == "__main__":
    rank_, world_, data_, model_ = map(int, sys.argv[1:5])
    sys.exit(_worker(rank_, world_, data_, model_, *sys.argv[5:7]))
