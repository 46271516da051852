"""The multi-host entry: join the job a launcher started, and build the pod
mesh with each model row on one host.

The counterpart of ``pim_embedding_lookup_tpu.parallel.multihost``.  One
process drives one device here, so a JAX "process" (a host of several
devices) is a *host* of ``LOCAL_WORLD_SIZE`` processes, ranked as torchrun
ranks them: ``GROUP_RANK * LOCAL_WORLD_SIZE + LOCAL_RANK``.  The model axis
(table shards, collectives on every lookup) stays within a host, and the
data axis (the batch, one gradient sum a step) spans hosts.

Usage, one process per device on each host:

    torchrun --nnodes 2 --nproc-per-node 4 --rdzv-backend c10d \\
        --rdzv-endpoint HOST0:29500 train.py

    from pim_embedding_lookup_tpu_torch.parallel import multihost
    device = multihost.initialize()
    mesh = multihost.make_pod_mesh()                  # (hosts, 4)
    coll = EmbeddingCollection.create(tables, policy, mesh=mesh)
    fused = multihost.device_put_tables(coll, host_tables)
    idx, mask = multihost.make_global_queries(mesh, host_idx, host_mask)
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, PortMesh, init_distributed, make_mesh


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device=None) -> torch.device:
    """Join the default process group and return this process's device.

    Arguments override the launcher's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` for the coordinator (``"host:port"``), ``WORLD_SIZE``
    and ``RANK``.  The device is CUDA card ``LOCAL_RANK`` unless ``device``
    names another; the CPU runs only when asked for.  NCCL on a card, gloo
    on the CPU.  A second call joins nothing and returns the same device."""
    if dist.is_initialized():  # init_distributed made this process's card current
        return (torch.device("cuda", torch.cuda.current_device())
                if dist.get_backend() == "nccl" else torch.device("cpu"))
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if addr is None or port is None:
            raise ValueError("no coordinator: pass coordinator_address or set "
                             "MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{addr}:{port}"
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("pass num_processes and process_id or set WORLD_SIZE and RANK")
    if device is None:
        device = torch.device("cuda", _env_int("LOCAL_RANK") or 0)
    return init_distributed(rank, world, f"tcp://{coordinator_address}", device)


def host_key() -> str:
    """The host this process runs on: the launcher's ``GROUP_RANK`` where
    set, else the host name."""
    group = os.environ.get("GROUP_RANK")
    return f"group {group}" if group is not None else socket.gethostname()


def make_pod_mesh(data: int | None = None, model: int | None = None) -> PortMesh:
    """The (data, model) mesh over every process of the job.  The model
    axis defaults to one host's processes (``LOCAL_WORLD_SIZE``), the data
    axis to the rest; data * model must be the world size.  Raises
    ``ValueError`` where a model row would span two hosts."""
    n, rank = dist.get_world_size(), dist.get_rank()
    keys = [None] * n
    dist.all_gather_object(keys, host_key())
    if model is None:
        local = _env_int("LOCAL_WORLD_SIZE") or keys.count(keys[rank])
        model = min(local, n)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    for row in range(data):
        hosts = sorted(set(keys[row * model:(row + 1) * model]))
        if len(hosts) > 1:
            raise ValueError(f"model row {row} (ranks {row * model}..{(row + 1) * model - 1})"
                             f" spans hosts {hosts}: the model axis must stay within a host")
    return make_mesh(data=data, model=model, device=initialize())


def is_primary() -> bool:
    return dist.get_rank() == 0


def device_put_tables(coll, host_tables) -> torch.Tensor:
    """Every process holds the whole per-table host weights; each keeps
    only its own shard, on its device (the collection's own
    ``device_put_tables``)."""
    return coll.device_put_tables(host_tables)


def make_global_queries(mesh: PortMesh, indices, mask) -> tuple[torch.Tensor, torch.Tensor]:
    """This process's part of the global [T, B*L] query, from its host's
    slice of the batch (numpy or tensors, split on dim 1 as the lookups
    take it; any pair of arrays, such as a CSR window's indices and
    offsets).  No process builds the global query.  Under
    ``make_pod_mesh``'s layout a host holds whole data rows, consecutive
    ones: where it holds several, the host slice is cut into them."""
    mesh.check_member("make_global_queries")
    local = _env_int("LOCAL_WORLD_SIZE")
    rows = max(1, local // mesh.model) if local else 1  # data rows on this host
    i = mesh.index(DATA_AXIS) % rows
    out = []
    for x in (indices, mask):
        x = torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x)
        if x.shape[1] % rows:
            raise ValueError(f"host slice width {x.shape[1]} not divisible by its "
                             f"{rows} data rows")
        step = x.shape[1] // rows
        out.append(x[:, i * step:(i + 1) * step].contiguous().to(mesh.device))
    return out[0], out[1]
