"""The dense wire's sparse step on a mesh: ``sparse_update_hybrid`` gathers
the ids, the mask and the cotangents over the data axis once each and takes
``ops.sparse_step``, whose plain version runs on the CPU.  Over 1 x 2 and
2 x 1 ROW_HASH gloo clusters (a module fixture starts both at once, 4 CPU
processes, each this file run as a script: ``python
tests/test_torch_port_sparse_step_mesh.py RANK WORLD DATA MODEL STORE
OUT``), every rank's storage and accumulators after the step equal, bit for
bit, those of the eager step the mesh took before (this file's
``_eager_mesh_step``: each set gathered on its own, every entry's cotangent
expanded, the small set stepped densified, the big set's owned entries one
by one), in SGD and row AdaGrad.  The step makes three collectives, and the
data replicas of a shard agree bit for bit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pim_embedding_lookup_tpu_torch.config import ShardingPolicy, TableConfig
from pim_embedding_lookup_tpu_torch.ops.sparse_step import (
    OPTIMIZERS,
    apply_entries,
    densified_step,
    entry_updates,
)
from pim_embedding_lookup_tpu_torch.parallel import mesh as mesh_mod
from pim_embedding_lookup_tpu_torch.parallel.hybrid import (
    HybridEmbeddingCollection,
    sparse_update_hybrid,
)
from pim_embedding_lookup_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS
from pim_embedding_lookup_tpu_torch.parallel.sparse_update import _owned_entries

REPO = Path(__file__).resolve().parents[1]
MESHES = ((1, 2), (2, 1))  # (data, model)
ROWS = (3, 24, 583, 9000, 20000, 50000)  # three small tables, three big
MXU_THRESHOLD = 1000
DIM = 8
BATCH, POOLING = 16, 2  # global batch, ids a bag
LR, EPS = 0.1, 1e-8


def _collection(mesh):
    tables = [TableConfig(num_rows=n, dim=DIM, name=f"t{i}") for i, n in enumerate(ROWS)]
    return HybridEmbeddingCollection.create(tables, ShardingPolicy.ROW_HASH, device="cpu",
                                            mesh=mesh, mxu_threshold=MXU_THRESHOLD)


def _batch():
    """The global batch: ids [T, B*L] (masked ones 1 << 30), mask, and
    cotangents [B, T, D]."""
    gen = torch.Generator().manual_seed(5)
    ids = torch.stack([torch.randint(0, n, (BATCH * POOLING,), generator=gen,
                                     dtype=torch.int32) for n in ROWS])
    mask = torch.rand(ids.shape, generator=gen) < 0.7
    g = torch.randn(BATCH, len(ROWS), DIM, generator=gen)
    return torch.where(mask, ids, 1 << 30), mask, g


def _eager_mesh_step(coll, params, accs, indices, mask, g_pooled, *, optimizer):
    """The mesh's step before it took ``ops.sparse_step``, in place: each
    set's ids, mask and cotangents gathered over the data axis on their
    own, every entry's cotangent expanded, the small set stepped
    densified, the big set's owned entries applied one by one."""
    mesh = coll.mesh
    pooling = indices.shape[1] // g_pooled.shape[0]
    sel = coll._index["small_ids"]
    idx = mesh.all_gather(indices[sel], DATA_AXIS, 1)
    mk = mesh.all_gather(mask[sel], DATA_AXIS, 1)
    gp = mesh.all_gather(g_pooled[:, sel].contiguous(), DATA_AXIS, 0)
    _, g_e, _ = entry_updates(idx, mk, gp, pooling)
    densified_step(coll.buckets, params["small"], accs["small"], idx, mk,
                   g_e.reshape(*idx.shape, -1), lr=LR, optimizer=optimizer, eps=EPS)
    sel = coll._index["big_ids"]
    g_idx = mesh.all_gather(coll.big.globalize(indices[sel]), DATA_AXIS, 1)
    mk = mesh.all_gather(mask[sel], DATA_AXIS, 1)
    gp = mesh.all_gather(g_pooled[:, sel], DATA_AXIS, 0)
    ids, updates, valid = entry_updates(g_idx, mk, gp, pooling)
    local, keep = _owned_entries(coll.big, ids, valid)
    apply_entries(params["big"], accs["big"], local, updates, keep, lr=LR, eps=EPS,
                  use_adagrad=optimizer == "row_adagrad")


# -- a rank of a cluster ----------------------------------------------------------


def _worker(rank, world, data, model, store, out) -> int:
    torch.set_num_threads(1)
    mesh_mod.init_distributed(rank, world, f"file://{store}", device="cpu")
    mesh = mesh_mod.make_mesh(data=data, model=model, device="cpu")
    coll = _collection(mesh)
    idx, mask, g = _batch()
    mine = mesh.data_slice(idx, 1), mesh.data_slice(mask, 1), mesh.data_slice(g, 0)
    arrays = {}
    for optimizer in OPTIMIZERS:
        params = coll.init(torch.Generator().manual_seed(6))
        gen = torch.Generator().manual_seed(7 + mesh.index(MODEL_AXIS))
        accs = {k: torch.rand(v.numel() // DIM, generator=gen) for k, v in params.items()}
        old = ({k: v.clone() for k, v in params.items()}, {k: v.clone() for k, v in accs.items()})
        mesh_mod.comm_calls.clear()
        sparse_update_hybrid(coll, params, accs, *mine, lr=LR, optimizer=optimizer, eps=EPS)
        arrays[f"{optimizer}-calls"] = np.array([[op == "all_gather", axis == DATA_AXIS, n]
                                                 for (op, axis), n in
                                                 mesh_mod.comm_calls.items()])
        _eager_mesh_step(coll, *old, *mine, optimizer=optimizer)
        for key in params:
            arrays[f"{optimizer}-new-w-{key}"] = params[key].numpy()
            arrays[f"{optimizer}-new-acc-{key}"] = accs[key].numpy()
            arrays[f"{optimizer}-old-w-{key}"] = old[0][key].numpy()
            arrays[f"{optimizer}-old-acc-{key}"] = old[1][key].numpy()
    np.savez(Path(out) / f"rank{rank}.npz", **arrays)
    torch.distributed.barrier()  # no rank leaves while a peer's gloo still talks to it
    torch.distributed.destroy_process_group()
    return 0


# -- the clusters -----------------------------------------------------------------


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Both meshes' ranks, started at once: {(data, model): [arrays of each
    rank]}."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    started = {}
    for data, model in MESHES:
        tmp = tmp_path_factory.mktemp(f"step{data}x{model}")
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
            out[key] = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(len(ps))]
    assert not failed, "\n\n".join(failed)
    return out


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_step_is_the_eager_step(clusters, mesh, optimizer):
    """Both sets' storage and accumulators on every rank, bit for bit; the
    step moved them."""
    for rank, arrays in enumerate(clusters[mesh]):
        for what in ("w", "acc"):
            for key in ("small", "big"):
                new = arrays[f"{optimizer}-new-{what}-{key}"]
                old = arrays[f"{optimizer}-old-{what}-{key}"]
                assert np.array_equal(_bits(new), _bits(old)), (mesh, rank, what, key)
    first = clusters[mesh][0]
    for key in ("small", "big"):
        before = _collection(None).init(torch.Generator().manual_seed(6))[key]
        if mesh == (2, 1):  # one shard of every row
            assert not np.array_equal(first[f"{optimizer}-new-w-{key}"], before.numpy())


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mesh_step_gathers_each_tensor_once(clusters, mesh):
    """The ids, the mask and the cotangents, one all_gather each over the
    data axis, and no other collective."""
    for arrays in clusters[mesh]:
        for optimizer in OPTIMIZERS:
            assert arrays[f"{optimizer}-calls"].tolist() == [[1, 1, 3]]


def test_data_replicas_agree(clusters):
    """On the 2 x 1 mesh both ranks hold the one shard, and step it alike."""
    a, b = clusters[2, 1]
    for name in a:
        if "-new-" in name:
            assert np.array_equal(_bits(a[name]), _bits(b[name])), name


if __name__ == "__main__":
    rank_, world_, data_, model_ = map(int, sys.argv[1:5])
    sys.exit(_worker(rank_, world_, data_, model_, *sys.argv[5:7]))
