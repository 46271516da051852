"""The (data, model) device mesh over ``torch.distributed``.

The counterpart of ``pim_embedding_lookup_tpu.parallel.mesh``.  One process
drives one device: rank r sits at data row ``r // model`` and model column
``r % model``, as device r of the JAX package's ``make_mesh`` does.  The JAX
package's collectives inside ``shard_map`` (psum, pmax, all_gather and
all_to_all over an axis) become ``torch.distributed`` calls on the axis's
process group.  Every collective goes through them, even over an axis of
size 1.  The backend follows the device: NCCL for CUDA, gloo for the CPU.
Nothing falls back from one to the other.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..config import MeshConfig
from ..device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(rank: int, world_size: int, init_method: str,
                     device=None) -> torch.device:
    """Join the default process group and return this process's device.

    NCCL on a CUDA device (card ``rank % device_count`` unless ``device``
    names one), gloo on the CPU.  ``init_method`` is a ``file://`` or
    ``tcp://`` address: nothing is read from the environment."""
    dev = resolve_device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no process group backend for device {dev}")
    kwargs = {}
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else rank % torch.cuda.device_count()
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    dist.init_process_group(BACKENDS[dev.type], init_method=init_method, rank=rank,
                            world_size=world_size, **kwargs)
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class PortMesh:
    """This process's place in the (data, model) mesh, and the collectives
    over each axis.  A reducing collective works in place where its input is
    contiguous, and returns the result."""

    device_mesh: DeviceMesh
    device: torch.device

    @property
    def data(self) -> int:
        return self.device_mesh.size(0)

    @property
    def model(self) -> int:
        return self.device_mesh.size(1)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def index(self, axis: str) -> int:
        """This process's position along ``axis``."""
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def data_slice(self, x, dim: int):
        """This process's data row's part of a global batch ``x`` (numpy or
        tensor), split on ``dim`` as the JAX package's P(..., "data") splits
        it: the dense-wire indices and mask on dim 1, dense features and
        labels on dim 0."""
        n, nd = x.shape[dim], self.data
        if n % nd:
            raise ValueError(f"batch dim {n} not divisible by data axis {nd}")
        i, step = self.index(DATA_AXIS), n // nd
        return x[(slice(None),) * dim + (slice(i * step, (i + 1) * step),)]

    def csr_window(self, indices, offsets):
        """This process's window of a data-sharded CSR query: global
        indices [T, Nd*Cd] and offsets [T, Nd*(Bd+1)] as
        ``ops.ragged.shard_csr`` lays them out -> [T, Cd], [T, Bd+1]."""
        nd = self.data
        c, w = indices.shape[1], offsets.shape[1]
        if c % nd or w % nd:
            raise ValueError(f"data_sharded CSR needs data axis {nd} to divide capacity "
                             f"{c} and offsets width {w}")
        return self.data_slice(indices, 1), self.data_slice(offsets, 1)

    def psum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group(axis))
        return x

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        x = x.contiguous()
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group(axis))
        return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every peer's ``x`` along ``axis``, concatenated on ``dim`` in the
        peers' order (JAX's tiled all_gather)."""
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
        parts = [torch.empty_like(wire) for _ in range(self.size(axis))]
        dist.all_gather(parts, wire, group=self.group(axis))
        out = torch.cat(parts, dim=dim)
        return out.bool() if x.dtype == torch.bool else out

    def all_to_all(self, x: torch.Tensor, axis: str = MODEL_AXIS) -> torch.Tensor:
        """Split ``x``'s first dim into equal blocks, one per peer, and
        return the blocks the peers sent, in their order."""
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group(axis))
        return out


def make_mesh(config: MeshConfig | None = None, *, data: int | None = None,
              model: int | None = None, device=None) -> PortMesh:
    """The (data, model) mesh over the default process group, which must
    be joined first (``init_distributed``).  With no sizes every process
    goes on the model axis; the sizes must multiply to the world size.
    ``device`` is this process's device (CUDA unless named; a CUDA device
    with no index is the current card)."""
    if config is not None:
        data, model = config.data, config.model
    n = dist.get_world_size()
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes, have {n}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = dist.get_backend()
    if BACKENDS.get(dev.type) != backend:
        raise ValueError(f"a {dev.type} mesh needs the {BACKENDS.get(dev.type)} backend, "
                         f"the process group runs {backend}")
    dm = init_device_mesh(dev.type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return PortMesh(dm, dev)


def shard_count(mesh: PortMesh | None) -> int:
    return 1 if mesh is None else mesh.model
