"""The (data, model) device mesh over ``torch.distributed``.

The counterpart of ``pim_embedding_lookup_tpu.parallel.mesh``.  One process
drives one device: rank r sits at data row ``r // model`` and model column
``r % model``, as device r of the JAX package's ``make_mesh`` does.  A mesh
smaller than the world takes ranks [0, data * model); the other ranks hold
a ``PortMesh`` whose ``member`` is False and join none of its collectives.
The JAX package's collectives inside ``shard_map`` (psum, pmax, all_gather
and all_to_all over an axis) become ``torch.distributed`` calls on the
axis's process group.  Every collective goes through them, even over an
axis of size 1.  The backend follows the device: NCCL for CUDA, gloo for
the CPU.  Nothing falls back from one to the other.

Under autograd (an input that requires grad, grad mode on) the collectives
are differentiable, with the transposes JAX gives them where every peer of
the axis computes the same loss from their result:

  psum        the cotangent passes through: each peer already holds all of it
  pmax        raises, as JAX has no differentiation rule for pmax
  all_gather  each peer takes its own slice of the cotangent
  all_to_all  the reverse all_to_all, which is the same exchange
  pvary       the identity, whose cotangent is summed over the axis: it marks
              a value that the axis's peers hold alike but use on different
              data (JAX's pvary, whose transpose is psum)

``torch.distributed.nn.functional`` is not used: its all_reduce also
all-reduces the cotangent, which counts each peer's loss once per peer.

Every collective, a transpose's included, runs inside the span of its axis
(``utils.profiling.span``: ``pel.comm.data``, ``pel.comm.model``) and is
counted in ``comm_calls`` and ``comm_bytes`` by (op, axis): the bytes are
those this process puts in.
"""

from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..device import resolve_device
from ..utils.profiling import span

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
COMM_SPANS = {DATA_AXIS: "pel.comm.data", MODEL_AXIS: "pel.comm.model"}

# the collectives this process has taken part in, by (op, axis): calls, and
# bytes put in ("psum", "pmax", "all_gather", "all_to_all")
comm_calls: collections.Counter = collections.Counter()
comm_bytes: collections.Counter = collections.Counter()


def _comm(op: str, axis: str, x: torch.Tensor):
    """Counts a collective ``op`` over ``axis`` on ``x``; returns the span
    it runs in."""
    comm_calls[op, axis] += 1
    comm_bytes[op, axis] += x.numel() * x.element_size()
    return span(COMM_SPANS[axis])


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
    over each axis.  Without grad a reducing collective works in place where
    its input is contiguous, and returns the result.  Outside the mesh
    (``member`` False) every collective and position raises."""

    data: int
    model: int
    device: torch.device
    rank: int  # in the default group
    groups: dict = dataclasses.field(repr=False)  # axis -> this rank's group

    @property
    def member(self) -> bool:
        return self.rank < self.data * self.model

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    def check_member(self, what: str = "this call"):
        if not self.member:
            raise ValueError(f"{what}: rank {self.rank} is outside the "
                             f"{self.data}x{self.model} mesh")

    def index(self, axis: str) -> int:
        """This process's position along ``axis``."""
        self.check_member(f"index({axis!r})")
        return self.rank // self.model if axis == DATA_AXIS else self.rank % self.model

    def group(self, axis: str):
        self.check_member(f"a collective over {axis!r}")
        return self.groups[axis]

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
        group = self.group(axis)
        with _comm("psum", axis, x):
            if _differentiated(x):
                return _Psum.apply(x, group)
            x = x.contiguous()
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
            return x

    def pmax(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        if _differentiated(x):
            raise NotImplementedError("Differentiation rule for 'pmax' not implemented")
        group = self.group(axis)
        with _comm("pmax", axis, x):
            x = x.contiguous()
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
            return x

    def all_gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """Every peer's ``x`` along ``axis``, concatenated on ``dim`` in the
        peers' order (JAX's tiled all_gather)."""
        group = self.group(axis)
        with _comm("all_gather", axis, x):
            if _differentiated(x):
                return _AllGather.apply(x, group, self.size(axis), self.index(axis), dim)
            return _all_gather(x, group, self.size(axis), dim)

    def all_to_all(self, x: torch.Tensor, axis: str = MODEL_AXIS) -> torch.Tensor:
        """Split ``x``'s first dim into equal blocks, one per peer, and
        return the blocks the peers sent, in their order."""
        group = self.group(axis)
        with _comm("all_to_all", axis, x):
            if _differentiated(x):
                return _AllToAll.apply(x, group, axis)
            return _all_to_all(x, group)

    def pvary(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``x`` itself, with its cotangent summed over ``axis`` (the module
        docstring); without grad ``x`` as it is."""
        if _differentiated(x):
            return _Pvary.apply(x, self.group(axis), axis)
        return x


def _differentiated(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


# one collective into one buffer; renamed all_gather_single in later PyTorch
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _all_gather(x, group, size, dim):
    """The peers' ``x`` gathered into one [size * n, ...] buffer, which is
    already their concatenation on dim 0; on another dim one copy moves the
    peers' blocks there."""
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = wire.new_empty((size * wire.shape[0], *wire.shape[1:]))
    _gather_into(out, wire, group=group)
    dim %= wire.dim()
    if dim:
        shape = list(wire.shape)
        shape[dim] *= size
        out = out.view(size, *wire.shape).movedim(0, dim).reshape(shape)
    return out.bool() if x.dtype == torch.bool else out


def _all_to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _summed(x, group):
    """A copy of ``x`` summed over ``group`` (the input is left as it is)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _comm("psum", ctx.axis, g):
            return _summed(g, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index, dim):
        ctx.index, ctx.dim, ctx.width = index, dim, x.shape[dim]
        return _all_gather(x, group, size, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.width, ctx.width), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        with _comm("all_to_all", ctx.axis, g):
            return _all_to_all(g, ctx.group), None, None


def make_mesh(config: MeshConfig | None = None, *, data: int | None = None,
              model: int | None = None, device=None) -> PortMesh:
    """The (data, model) mesh over ranks [0, data * model) of the default
    process group, which must be joined first (``init_distributed``).  With
    no sizes every process goes on the model axis.  Every rank of the
    default group must call this (``new_group`` is collective over it); a
    rank past data * model gets a mesh whose ``member`` is False.
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
    if data < 1 or model < 1 or data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes, have {n}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = dist.get_backend()
    if BACKENDS.get(dev.type) != backend:
        raise ValueError(f"a {dev.type} mesh needs the {BACKENDS.get(dev.type)} backend, "
                         f"the process group runs {backend}")
    rank, groups = dist.get_rank(), {}
    # every rank makes every group, in one order: new_group is collective
    for axis, members in ((MODEL_AXIS, [[i * model + j for j in range(model)]
                                        for i in range(data)]),
                          (DATA_AXIS, [[i * model + j for i in range(data)]
                                       for j in range(model)])):
        for ranks in members:
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return PortMesh(data, model, dev, rank, groups)


def shard_count(mesh: PortMesh | None) -> int:
    return 1 if mesh is None else mesh.model
