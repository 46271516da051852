"""Sharded int8 embedding collection: the capacity mode, inference only.

The counterpart of ``pim_embedding_lookup_tpu.parallel.quantized_collection``.
int8 rows quarter the bytes of f32 tables, so four times the rows fit on a
card; pooling adds in f32.  Storage comes in two scale granularities
(``scale_mode``):

* ``"table"``: ``{"q": int8 [storage_rows, storage_width], "tscale": f32
  [T]}``.  One symmetric scale per table, folded into the pooled [B, T, D]
  output after pooling (``_apply_tscale``): the kernels pool the codes and
  pay nothing per entry for the scale.
* ``"row"``: ``{"q": ..., "scale": f32 [total_rows]}``.  One scale per
  fused row, in storage order; each entry adds its codes times its row's
  scale, the scale loaded beside the row.

Lane packing and ROW_HASH's strided placement are those of
``EmbeddingCollection``.  Every lookup dispatch of ``EmbeddingCollection``
runs on the int8 dict storage (its module docstring): dense and CSR wires,
SUM/MEAN/MAX, routed lookups and the hot-row cache; on the card SUM and
MEAN go through the int8 instances of K1 and K2.  On a mesh a process holds
its shard: ``q`` cut like the f32 storage, ``scale`` like the row-AdaGrad
accumulator.  COLUMN sharding is refused: it would split the per-row
scales.  int8 rows take no gradient or sparse update.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import ShardingPolicy, TableConfig
from ..device import resolve_device
from .collection import EmbeddingCollection, _rowish, shard_accumulator, shard_storage
from .mesh import MODEL_AXIS, PortMesh
from .planner import FusedLayout, plan

SCALE_MODES = ("table", "row")


@dataclasses.dataclass(frozen=True)
class QuantizedEmbeddingCollection:
    """int8 fused storage with per-table or per-row scales (inference only).

    Usage:
        coll = QuantizedEmbeddingCollection.create(tables, device="cuda")
        params = coll.quantize_tables(host_tables)   # {"q", "tscale"}
        pooled = coll.lookup(params, idx, mask)      # [B, T, D] f32
    """

    layout: FusedLayout
    device: torch.device
    mesh: PortMesh | None = None
    scale_mode: str = "table"  # "table" | "row"
    # the f32 collection of the same layout, whose dispatches read the int8
    # dict storage
    _delegate: EmbeddingCollection = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        # checked here too, not only in create(): a collection built
        # directly on an existing layout (models/quantize.py) must not take
        # a mistyped mode
        if self.scale_mode not in SCALE_MODES:
            raise ValueError(f"scale_mode must be 'table' or 'row': {self.scale_mode!r}")
        object.__setattr__(self, "_delegate",
                           EmbeddingCollection(self.layout, self.device, self.mesh))

    @staticmethod
    def create(
        tables: Sequence[TableConfig],
        policy: ShardingPolicy = ShardingPolicy.AUTO,
        *,
        packed: bool | str = "auto",
        scale_mode: str = "table",
        device=None,
        mesh: PortMesh | None = None,
    ) -> "QuantizedEmbeddingCollection":
        """Planned over the mesh's model axis (one shard without a mesh),
        as ``EmbeddingCollection.create`` plans; COLUMN is refused."""
        if scale_mode not in SCALE_MODES:
            raise ValueError(f"scale_mode must be 'table' or 'row': {scale_mode}")
        num_shards = 1 if mesh is None else mesh.model
        device = mesh.device if mesh is not None else resolve_device(device)
        lay = plan(tables, num_shards, policy, packed)
        if lay.policy == ShardingPolicy.COLUMN:
            raise ValueError("int8 collection: COLUMN sharding would split per-row scales")
        return QuantizedEmbeddingCollection(lay, device, mesh, scale_mode)

    # -- placement ----------------------------------------------------------

    @property
    def shard(self) -> int:
        return self._delegate.shard

    @property
    def _strided(self) -> bool:
        return self.layout.policy == ShardingPolicy.ROW_HASH

    def _require_mesh(self, name):
        self._delegate._require_mesh(name)

    # -- storage ------------------------------------------------------------

    def init(self, generator: torch.Generator) -> dict:
        """This process's params drawn straight in int8: uniform codes in
        [-127, 127] (u ~ U(-bound, bound) quantized with the analytic scale
        bound/127), over the whole storage and then cut, so that one seed
        gives the same tables on every mesh.  Every row of a table has the
        analytic scale (1/sqrt(rows))/127, so the two modes give the same
        lookups at init; they differ on trained tables (quantize_tables)."""
        self._require_mesh("init")
        lay = self.layout
        q = torch.randint(-127, 128, (lay.storage_rows, lay.storage_width),
                          generator=generator, dtype=torch.int8, device=self.device)
        q = shard_storage(lay, self.shard, q).contiguous()
        if self.scale_mode == "table":
            tscale = [1.0 / (np.sqrt(r) * 127.0) for r in lay.table_rows]
            return {"q": q, "tscale": torch.tensor(tscale, dtype=torch.float32,
                                                   device=self.device)}
        return {"q": q, "scale": self._put(shard_accumulator(lay, self.shard,
                                                             self._init_scale()))}

    def _init_scale(self) -> np.ndarray:
        """The global [total_rows] analytic scale in storage order, as the
        JAX package computes it (f32 1/sqrt(rows) over 127)."""
        lay = self.layout
        pairs = sorted((off + rows, 1.0 / np.sqrt(rows))
                       for off, rows in zip(lay.row_offsets, lay.table_rows))
        ends = np.asarray([p[0] for p in pairs], dtype=np.int64)
        inv = np.asarray([p[1] for p in pairs], dtype=np.float32)
        p = np.arange(lay.total_rows, dtype=np.int64)
        s, j = p // lay.rows_per_shard, p % lay.rows_per_shard
        frow = j * lay.num_shards + s if self._strided else p
        tid = np.minimum(np.searchsorted(ends, frow, side="right"), len(lay.table_rows) - 1)
        return inv[tid] / np.float32(127.0)

    def host_params(self, host_tables: Sequence[np.ndarray]) -> dict:
        """Host f32 tables -> the global int8 params as numpy arrays, in
        storage order: the JAX package's ``quantize_tables`` before its
        device placement, bit for bit (numpy f32 division, round half to
        even).  "table": one symmetric scale per table (absmax / 127);
        "row": one per row.  Zero rows or tables get scale 1."""
        lay = self.layout
        fused = np.zeros((lay.total_rows, lay.dim), np.float32)
        for arr, off, rows in zip(host_tables, lay.row_offsets, lay.table_rows):
            if np.shape(arr) != (rows, lay.dim):
                raise ValueError(f"table shape {np.shape(arr)} != {(rows, lay.dim)}")
            fused[off : off + rows] = arr
        if self.scale_mode == "table":
            tscale = np.empty(len(lay.table_rows), np.float32)
            scale = np.ones(lay.total_rows, np.float32)
            for t, (off, rows) in enumerate(zip(lay.row_offsets, lay.table_rows)):
                am = np.abs(fused[off : off + rows]).max() if rows else 0.0
                tscale[t] = am / 127.0 if am > 0 else 1.0
                scale[off : off + rows] = tscale[t]
        else:
            absmax = np.abs(fused).max(axis=1)
            scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(fused / scale[:, None]), -127, 127).astype(np.int8)
        if self._strided:
            m, rps = lay.num_shards, lay.rows_per_shard
            perm = (np.arange(rps)[None, :] * m + np.arange(m)[:, None]).reshape(-1)
            q, scale = q[perm], scale[perm]
        q = q.reshape(lay.storage_rows, lay.storage_width)
        if self.scale_mode == "table":
            return {"q": q, "tscale": tscale}
        return {"q": q, "scale": scale}

    def shard_params(self, params_np: dict) -> dict:
        """Global int8 params (numpy, in storage order: ``host_params``, or
        a JAX tree as numpy) -> this process's shard on this collection's
        device: ``q`` cut like the storage, ``scale`` like the accumulator,
        ``tscale`` whole."""
        self._require_mesh("shard_params")
        lay = self.layout
        want = {"q", "tscale" if self.scale_mode == "table" else "scale"}
        if set(params_np) != want:
            raise ValueError(f"{self.scale_mode!r} mode params hold {sorted(want)}, "
                             f"got {sorted(params_np)}")
        q = np.asarray(params_np["q"])
        if q.dtype != np.int8 or q.shape != (lay.storage_rows, lay.storage_width):
            raise ValueError(f"q {q.dtype} {q.shape} != int8 "
                             f"{(lay.storage_rows, lay.storage_width)}")
        out = {"q": self._put(shard_storage(lay, self.shard, q))}
        if "tscale" in params_np:
            ts = np.asarray(params_np["tscale"], dtype=np.float32)
            if ts.shape != (len(lay.table_rows),):
                raise ValueError(f"tscale shape {ts.shape} != {(len(lay.table_rows),)}")
            out["tscale"] = self._put(ts)
        else:
            sc = np.asarray(params_np["scale"], dtype=np.float32)
            if sc.shape != (lay.total_rows,):
                raise ValueError(f"scale shape {sc.shape} != {(lay.total_rows,)}")
            out["scale"] = self._put(shard_accumulator(lay, self.shard, sc))
        return out

    def quantize_tables(self, host_tables: Sequence[np.ndarray]) -> dict:
        """Host f32 tables -> this process's int8 params on the device,
        quantized on the host: tables that fit the card only in int8 never
        go there in f32."""
        return self.shard_params(self.host_params(host_tables))

    @torch.no_grad()
    def quantize_storage(self, fused: torch.Tensor) -> dict:
        """This process's float storage of the same layout (an
        ``EmbeddingCollection``'s shard, e.g. a trained model's) -> its int8
        params, computed where the storage lies, with no copy to the host:
        bit for bit what ``quantize_tables`` gives for the same tables.
        Every division is f32 tensor by tensor (never by a scalar, which
        PyTorch's CUDA division turns into a product with the reciprocal),
        rounding is half to even, and rows outside every table quantize as
        zeros with scale 1.  "table" mode takes each table's absmax over the
        model axis (a pmax) on a row-sharded mesh."""
        self._require_mesh("quantize_storage")
        lay = self.layout
        rows = fused.detach().reshape(-1, lay.dim).float()
        n, dev = rows.shape[0], rows.device
        pos = torch.arange(n, device=dev)
        if _rowish(lay.policy):
            pos = pos + self.shard * lay.rows_per_shard  # global storage position
        frow = (pos % lay.rows_per_shard * lay.num_shards + pos // lay.rows_per_shard
                if self._strided else pos)
        order = np.argsort(lay.row_offsets, kind="stable")
        starts = torch.tensor([lay.row_offsets[i] for i in order], device=dev)
        sizes = torch.tensor([lay.table_rows[i] for i in order], device=dev)
        k = (torch.searchsorted(starts, frow, right=True) - 1).clamp(min=0)
        inside = (frow >= starts[k]) & (frow < starts[k] + sizes[k])
        table = torch.tensor(order, device=dev)[k]
        rows = torch.where(inside[:, None], rows, 0.0)
        absmax = rows.abs().amax(dim=1)
        one = torch.ones((), device=dev)
        if self.scale_mode == "table":
            tmax = torch.zeros(len(lay.table_rows), device=dev).scatter_reduce(
                0, table, absmax, "amax")
            if self.mesh is not None and _rowish(lay.policy):
                tmax = self.mesh.pmax(tmax, MODEL_AXIS)
            tscale = torch.where(tmax > 0, tmax / torch.full_like(tmax, 127.0), one)
            scale = torch.where(inside, tscale[table], one)
        else:
            scale = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), one)
        q = torch.clamp(torch.round(rows / scale[:, None]), -127, 127).to(torch.int8)
        q = q.reshape(fused.shape)
        if self.scale_mode == "table":
            return {"q": q, "tscale": tscale}
        return {"q": q, "scale": scale}

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:  # a view of a JAX array
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)

    # -- lookup -------------------------------------------------------------

    def globalize(self, indices: torch.Tensor) -> torch.Tensor:
        return self._delegate.globalize(indices)

    def _storage(self, params: dict) -> dict:
        """The dict the shared dispatches read: "table" mode's [T] tscale is
        not per fused row and stays out; its rows come back in quantized
        units."""
        return {k: params[k] for k in ("q", "scale") if k in params}

    def _apply_tscale(self, params: dict, out):
        """Fold the per-table scale into the pooled [B, T, D] output: sound
        for SUM and MEAN (linear) and MAX (the scale is positive).  ``out``
        may be (pooled, dropped) from a ``return_stats`` dispatch."""
        if "tscale" not in params:
            return out
        ts = params["tscale"][None, :, None]
        if isinstance(out, tuple):
            pooled, stats = out
            return pooled * ts, stats
        return out * ts

    def lookup(self, params: dict, indices: torch.Tensor, mask: torch.Tensor, *,
               batch_size: int | None = None, combiner: str = "sum") -> torch.Tensor:
        """``EmbeddingCollection.lookup`` on int8 storage: [B, T, D] f32."""
        return self._apply_tscale(params, self._delegate.lookup(
            self._storage(params), indices, mask, batch_size=batch_size, combiner=combiner))

    def lookup_csr(self, params: dict, indices: torch.Tensor, offsets: torch.Tensor, *,
                   combiner: str = "sum", data_sharded: bool = False, routed: bool = False,
                   capacity_factor: float | None = None, return_stats: bool = False):
        """``EmbeddingCollection.lookup_csr`` on int8 storage, with its
        contract (routed and data-sharded queries included)."""
        return self._apply_tscale(params, self._delegate.lookup_csr(
            self._storage(params), indices, offsets, combiner=combiner,
            data_sharded=data_sharded, routed=routed, capacity_factor=capacity_factor,
            return_stats=return_stats))

    def lookup_routed(self, params: dict, indices: torch.Tensor, mask: torch.Tensor, *,
                      batch_size: int | None = None, capacity_factor: float | None = None,
                      hot_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
                      return_stats: bool = False, combiner: str = "sum"):
        """``EmbeddingCollection.lookup_routed`` on int8 storage.  "row"
        mode dequantizes on the owner and the rows ride back in f32;
        "table" mode sends the codes back in bf16 (exact) and folds the
        scale into the pooled output.  ``hot_cache`` must come from
        ``build_hot_cache`` against these params, so that its rows are in
        the units of the gathered rows (quantized units in "table" mode)."""
        return self._apply_tscale(params, self._delegate.lookup_routed(
            self._storage(params), indices, mask, batch_size=batch_size,
            capacity_factor=capacity_factor, hot_cache=hot_cache,
            return_stats=return_stats, combiner=combiner))

    @property
    def safe_capacity_factor(self) -> float:
        return self._delegate.safe_capacity_factor
