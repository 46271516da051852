"""The port's multi-host entry (``parallel/multihost.py``) on 2 simulated
hosts of 2 gloo processes each: the analog of ``tests/test_multiprocess.py``.

A module fixture starts 4 CPU processes of
``python -m pim_embedding_lookup_tpu_torch.multihost_battery``, each with
the environment torchrun gives a process of ``--nnodes 2 --nproc-per-node
2`` (``GROUP_RANK`` 0/1, ``LOCAL_WORLD_SIZE`` 2, ``LOCAL_RANK``, ``RANK``,
``WORLD_SIZE`` 4, ``MASTER_ADDR``/``MASTER_PORT`` on localhost).  Each
process calls ``initialize()`` twice and ``make_pod_mesh()``, which gives a
(2, 2) mesh, feeds its host's slice of the batch and its shard of the
tables, and checks its own results against a numpy oracle from the shared
seed.  Each battery case is one test here, passing where every rank
reported it passed.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from pim_embedding_lookup_tpu_torch import multihost_battery as mhb
from pim_embedding_lookup_tpu_torch.parallel import multihost
from pim_embedding_lookup_tpu_torch.parallel.mesh import PortMesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOSTS, LOCAL = 2, 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_job(tmp, timeout=240):
    world, port = HOSTS * LOCAL, _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                   LOCAL_RANK=str(rank % LOCAL), LOCAL_WORLD_SIZE=str(LOCAL),
                   GROUP_RANK=str(rank // LOCAL))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pim_embedding_lookup_tpu_torch.multihost_battery",
             str(tmp), "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO, env=env))
    # liveness guard: a dead process leaves its peers waiting in a collective
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        if all(c is not None for c in codes):
            break
        if any(c not in (None, 0) for c in codes):
            time.sleep(2)
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
    outs = [p.communicate(timeout=30) for p in procs]
    failed = [(r, p.returncode, err) for r, (p, (_, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    assert not failed, "\n\n".join(f"rank {r} rc={rc}\n{err[-4000:]}" for r, rc, err in failed)
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(world)]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return _run_job(tmp_path_factory.mktemp("multihost"))


@pytest.mark.parametrize("case", mhb.CASES)
def test_multihost_case(job, case):
    for r, results in enumerate(job):
        assert results[case] == "ok", f"rank {r}:\n{results[case]}"


def test_initialize_needs_a_coordinator(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        multihost.initialize(device="cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        multihost.initialize("127.0.0.1:1", device="cpu")


def test_queries_outside_the_mesh_raise():
    outside = PortMesh(data=1, model=2, device=torch.device("cpu"), rank=3, groups={})
    assert not outside.member
    with pytest.raises(ValueError, match="outside"):
        multihost.make_global_queries(outside, torch.zeros(2, 4), torch.zeros(2, 4))
