"""A rank's entry into a cell over a mesh, through the port's own
multi-process entry (``parallel/multihost.py``): join the process group
that ``h100_bench/ranks.py``'s launcher describes in the environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), NCCL on a card
and gloo on the CPU, and build the (data, model) mesh over every rank."""

from __future__ import annotations

import torch

from pim_embedding_lookup_tpu_torch.parallel import multihost


def join(device: torch.device, data: int, model: int):
    """This rank's ``PortMesh`` of ``data`` x ``model`` processes."""
    multihost.initialize(device=device)
    return multihost.make_pod_mesh(data=data, model=model)
