"""The port's CLI on a (2, 2) mesh of 4 gloo CPU processes, each started
with the environment torchrun gives a process of ``--nproc-per-node 4``
(``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
``GROUP_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` on localhost), as
tests/test_torch_port_multihost.py starts its job.

A module fixture runs the jobs once: routed ROW_HASH training with the
hot-row cache; ROW_HASH broadcast training that saves its full state,
beside the same run on one process under REPLICATE; then that state
resumed on (2, 2) and refused on (1, 4).  The DLRM draws the same model on
every mesh from one seed, so the mesh's losses equal the single process's
(1e-5 on the 4-decimal prints; accuracy and AUC, over the gathered global
batch, at 1e-3)."""

import os
import re
import socket
import subprocess
import sys
import time

import pytest

from pim_embedding_lookup_tpu_torch.utils import checkpoint
from torch_port_native_lib import native_build  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
REPORT = re.compile(r"step (\d+): loss=([-\d.]+) acc=([\d.]+) auc=([\d.na]+)")
COMMON = ["train", "--device=cpu", "--data-generation=random",
          "--arch-embedding-size=200-9000-20000", "--arch-sparse-feature-size=8",
          "--arch-mlp-bot=4-8-8", "--arch-mlp-top=8-1", "--mini-batch-size=16",
          "--num-indices-per-lookup=2", "--hybrid", "--num-batches=6", "--test-freq=3",
          "--optimizer=adagrad"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args, native, world=WORLD):
    """Every process loads the same feeder library (``native``, a private
    build), or none where it cannot be built, so that all of them draw the
    same batches from the seed."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        if native:
            env["PEL_NATIVE_LIB"] = native
        if world > 1:
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                       RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                       GROUP_RANK="0")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pim_embedding_lookup_tpu_torch.cli", *COMMON, *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env))
    return procs


def _wait(procs, timeout=180):
    """Each rank's (returncode, stdout, stderr); a rank that outlives the
    others' failure is killed, since it waits in a collective."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        if any(c not in (None, 0) for c in codes):
            time.sleep(5)
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    return [(p.returncode, *p.communicate(timeout=30)) for p in procs]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, native_build):
    ck = str(tmp_path_factory.mktemp("cli_mesh") / "full")
    first = {
        "routed": _start(["--sharding=row_hash", "--mesh-data=2", "--mesh-model=2",
                          "--routed", "--hot-k=16", "--hot-rebuild-every=2"], native_build),
        "broadcast": _start(["--sharding=row_hash", "--mesh-data=2", "--mesh-model=2",
                             f"--save-model={ck}"], native_build),
        "replicate": _start([], native_build, world=1),
    }
    out = {name: _wait(procs) for name, procs in first.items()}
    then = {
        "resume": _start(["--sharding=row_hash", "--mesh-data=2", "--mesh-model=2",
                          f"--load-model={ck}"], native_build),
        "other_mesh": _start(["--sharding=row_hash", "--mesh-data=1", "--mesh-model=4",
                              f"--load-model={ck}"], native_build),
    }
    out.update({name: _wait(procs) for name, procs in then.items()})
    out["ckpt"] = ck
    return out


def _ok(ranks):
    for r, (rc, _, err) in enumerate(ranks):
        assert rc == 0, f"rank {r} rc={rc}\n{err[-3000:]}"
    return ranks[0][1]


def _reports(text):
    return [tuple(float(v) for v in m.groups()) for m in REPORT.finditer(text)]


def test_routed_hot_cache_runs_and_reports(jobs):
    out = _ok(jobs["routed"])
    assert [r[0] for r in _reports(out)] == [3, 6]
    for _, stdout, _ in jobs["routed"][1:]:  # only rank 0 prints
        assert stdout == ""


def test_row_hash_broadcast_equals_replicate(jobs):
    got, want = _reports(_ok(jobs["broadcast"])), _reports(_ok(jobs["replicate"]))
    assert [g[0] for g in got] == [w[0] for w in want] == [3, 6]
    for g, w in zip(got, want):
        assert abs(g[1] - w[1]) <= 1e-5, (g, w)
        assert abs(g[2] - w[2]) <= 1e-3 and abs(g[3] - w[3]) <= 1e-3, (g, w)


def test_full_state_saved_per_model_shard(jobs):
    assert "saved full train state" in _ok(jobs["broadcast"])
    files = sorted(f for f in os.listdir(jobs["ckpt"]) if f.endswith(".pt"))
    assert files == ["model0-of-2.pt", "model1-of-2.pt"]
    meta = checkpoint.saved_meta(jobs["ckpt"])
    assert meta["state"] == "full" and meta["collection"]["big"]["num_shards"] == 2


def test_full_state_resumes_on_same_mesh(jobs):
    out = _ok(jobs["resume"])
    assert "resumed full train state" in out and "at step 6" in out
    assert [r[0] for r in _reports(out)] == [9, 12]


def test_full_state_refused_on_other_mesh(jobs):
    for r, (rc, _, err) in enumerate(jobs["other_mesh"]):
        assert rc != 0 and "layout mismatch" in err, f"rank {r} rc={rc}\n{err[-3000:]}"
