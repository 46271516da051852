"""Embedding collection: same-dim tables fused into one storage tensor, and
their pooled lookup, on one device or sharded over a (data, model) mesh.

The counterpart of ``pim_embedding_lookup_tpu.parallel.collection``.
Queries come in two forms: ``lookup`` takes the dense padded form, indices
and mask of shape [T, B*L] (B*L entries per table, bag-major), and
``lookup_csr`` the ragged CSR form, indices [T, C] and offsets [T, B+1].
Both return [B, T, D] in f32 whatever the storage dtype.  On a CUDA tensor
SUM and MEAN go through a gather+pool kernel (K1 for the dense form, K2 for
CSR); MAX is plain PyTorch, as it is XLA work in the JAX package.

Without a mesh the collection is REPLICATE on one device.  On a mesh
(``parallel.mesh.PortMesh``) each process holds its shard of the storage,
as the JAX package's ``table_sharding`` places it:

  ROW, ROW_HASH, TABLE_WISE  storage rows [s*S/M, (s+1)*S/M) of model shard s
  COLUMN                     every row, dims [s*D/M, (s+1)*D/M)
  REPLICATE                  everything

and the JAX package's shard_map bodies run per process, their collectives
over the mesh's axes.  A row shard pools only the entries it owns (K1 or K2
with an ownership mask), then the partials are summed (MAX: maxed) over the
model axis; a COLUMN shard pools its dim slice and the slices are gathered
over the model axis.  Dense-wire queries are the process's data row's slice
[T, Bd*L]; CSR queries are the whole batch, or with ``data_sharded`` the
process's own window (``ops.ragged.shard_csr``).  ``lookup_routed`` and
``lookup_csr(routed=True)`` send each entry to its owner through
capacity-bucketed all-to-alls instead (``_route_rows``).

Every dispatch also reads int8 dict storage, the JAX package's form for
``QuantizedEmbeddingCollection`` (``parallel.quantized_collection``):
``{"q": int8 [S, W], "scale": f32 [rows]}`` ("row" scale mode: each entry
is its codes times its row's scale) or ``{"q": int8 [S, W]}`` ("table"
mode: rows in quantized units, the caller folds the per-table scale into
the pooled output).  SUM and MEAN go through the int8 instances of K1 and
K2; MAX and the routed gather dequantize per entry (in "row" mode the
scale differs per entry, so it does not commute with MAX).  int8 storage
is inference-only: it cannot require grad.

Every lookup is differentiable w.r.t. the storage where the storage
requires grad (and grad mode is on), on a mesh too, through the
collectives' transposes (``parallel.mesh``).  The gradient a process holds
is its shard of the gradient of the global loss, as ``jax.grad`` gives it:
where the query is sharded over the data axis (the dense wire, routed
lookups, ``lookup_csr(data_sharded=True)``) the global loss is the sum of
the data rows' losses, and the lookup's backward sums the storage's
gradient over the data axis at its input (``PortMesh.pvary``), so that the
caller sums nothing; where every data row passes the whole CSR batch
(``data_sharded=False``) each computes the whole loss, counted once, and
nothing is summed.  Model peers compute the same loss, which counts once.
A row shard's MAX under grad raises as JAX's pmax does.  The routed
lookup's hot-row cache entries are not routed, so they add nothing to the
storage's gradient; where ``hot_rows`` requires grad, theirs goes there,
summed over the whole mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import ShardingPolicy, TableConfig
from ..device import resolve_device
from ..ops.csr_pool import embedding_bag_csr_packed
from ..ops.gather_pool import embedding_bag_fixedl, gather_rows
from ..ops.ragged import segment_ids_from_offsets
from .mesh import DATA_AXIS, MODEL_AXIS, PortMesh
from .planner import FusedLayout, plan

_NEG_INF = -3.0e38  # max-combiner identity
# elements a table is drawn in a call by ``EmbeddingCollection.init``: 1 GB
# of f32, so that the draw of a shard never holds the global storage
INIT_CHUNK_ELEMENTS = 250_000_000


def _parts(storage):
    """(rows, per-row scale or None) of float storage or int8 dict
    storage (the module docstring)."""
    if isinstance(storage, dict):
        return storage["q"], storage.get("scale")
    return storage, None


def _rowish(policy) -> bool:
    return policy in (ShardingPolicy.ROW, ShardingPolicy.ROW_HASH,
                      ShardingPolicy.TABLE_WISE)


def _owner_local(g, rows_per_shard, num_shards, strided):
    """(owner shard, owner-local row id) of fused ids ``g``.  Contiguous
    (ROW, TABLE_WISE): owner = g // rows_per_shard; strided (ROW_HASH):
    owner = g % num_shards, local = g // num_shards."""
    if strided:
        return g % num_shards, g // num_shards
    owner = g // rows_per_shard
    return owner, g - owner * rows_per_shard


def shard_storage(layout: FusedLayout, shard: int, storage):
    """Model shard ``shard``'s part of the global [storage_rows,
    storage_width] storage (numpy or tensor, in storage order)."""
    m = layout.num_shards
    if layout.policy == ShardingPolicy.COLUMN:
        w = layout.storage_width // m
        return storage[:, shard * w:(shard + 1) * w]
    if _rowish(layout.policy):
        r = layout.storage_rows // m
        return storage[shard * r:(shard + 1) * r]
    return storage


def shard_accumulator(layout: FusedLayout, shard: int, acc):
    """Model shard ``shard``'s part of a global [total_rows] row-AdaGrad
    accumulator: its rows under a row policy, else all of it."""
    if _rowish(layout.policy):
        r = layout.rows_per_shard
        return acc[shard * r:(shard + 1) * r]
    return acc


@dataclasses.dataclass(frozen=True)
class EmbeddingCollection:
    """A set of same-dim embedding tables fused into one tensor.

    Usage:
        coll = EmbeddingCollection.create(tables, device="cuda")
        fused = coll.init(generator)                # [storage_rows, width]
        pooled = coll.lookup(fused, idx, mask)      # [B, T, D]
    On a mesh, ``create(..., mesh=mesh)`` and ``fused`` is this process's
    shard.
    """

    layout: FusedLayout
    device: torch.device
    mesh: PortMesh | None = None
    # row_offsets on the device, so that a lookup copies nothing from the
    # host (a copy from pageable memory would wait for the card)
    _row_offsets: torch.Tensor = dataclasses.field(
        init=False, repr=False, compare=False)
    # ops.sparse_step's plan, built at the first dense-wire step
    _step_plan: object = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_row_offsets", torch.tensor(
            self.layout.row_offsets, dtype=torch.int32, device=self.device))

    @staticmethod
    def create(
        tables: Sequence[TableConfig],
        policy: ShardingPolicy = ShardingPolicy.AUTO,
        *,
        packed: bool | str = False,
        device=None,
        mesh: PortMesh | None = None,
    ) -> "EmbeddingCollection":
        """Planned over the mesh's model axis (one shard without a mesh).
        ``packed``: lane-pack storage for dim < 128 (False | True |
        "auto"), see FusedLayout.pack.  On a mesh the device is the
        mesh's."""
        num_shards = 1 if mesh is None else mesh.model
        device = mesh.device if mesh is not None else resolve_device(device)
        return EmbeddingCollection(plan(tables, num_shards, policy, packed), device, mesh)

    # -- placement ----------------------------------------------------------

    @property
    def shard(self) -> int:
        """This process's model shard."""
        return 0 if self.mesh is None else self.mesh.index(MODEL_AXIS)

    @property
    def _strided(self) -> bool:
        return self.layout.policy == ShardingPolicy.ROW_HASH

    def _require_mesh(self, name):
        if self.mesh is None and self.layout.policy != ShardingPolicy.REPLICATE:
            raise ValueError(
                f"{name}: policy {self.layout.policy.value} shards the storage over "
                "a mesh; create the collection with mesh=... (only REPLICATE runs "
                "without one)")
        if self.mesh is not None:
            self.mesh.check_member(name)

    def _lookup_input(self, name, storage, data_sharded=True):
        """The storage a lookup reads: checked, and on a mesh with a
        data-sharded query under grad, passed through ``pvary`` over the
        data axis (the module docstring)."""
        self._require_mesh(name)
        if self.mesh is None or not data_sharded or isinstance(storage, dict):
            return storage  # int8 dict storage never requires grad
        return self.mesh.pvary(storage, DATA_AXIS)

    # -- storage ------------------------------------------------------------

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """This process's storage with per-table uniform(-1/sqrt(n),
        1/sqrt(n)) rows, the dlrm EmbeddingBag init; padding rows are zero.

        Every process draws every table, in table order, in chunks of
        ``INIT_CHUNK_ELEMENTS`` (whole rows, from each table's first), and
        keeps what its shard holds: under ROW and TABLE_WISE its fused rows,
        under ROW_HASH the rows g with g % m == s at local row g // m, under
        COLUMN its dims, under REPLICATE everything.  The chunks depend on
        the layout's tables alone, so one seed gives the same logical tables
        on every mesh, and no process holds more than its shard and one
        chunk.  Where the shard is the whole storage, it is drawn in place."""
        lay = self.layout
        if lay.policy == ShardingPolicy.COLUMN:
            local = torch.zeros(lay.total_rows, lay.dim // lay.num_shards, dtype=dtype,
                                device=self.device)
        else:
            local = torch.zeros(lay.rows_per_shard if _rowish(lay.policy) else lay.total_rows,
                                lay.dim, dtype=dtype, device=self.device)
        step = max(1, INIT_CHUNK_ELEMENTS // lay.dim)
        chunk = None  # one buffer for every chunk: a draw never holds two
        if lay.num_shards > 1 and lay.policy != ShardingPolicy.REPLICATE:
            chunk = torch.empty(min(step, max(lay.table_rows)), lay.dim, dtype=dtype,
                                device=self.device)
        for off, rows in zip(lay.row_offsets, lay.table_rows):
            bound = 1.0 / np.sqrt(rows)
            for lo in range(off, off + rows, step):
                hi = min(lo + step, off + rows)
                if chunk is None:
                    local[lo:hi].uniform_(-bound, bound, generator=generator)
                    continue
                drawn = chunk[:hi - lo].uniform_(-bound, bound, generator=generator)
                self._keep_held(local, drawn, lo)
        if lay.policy == ShardingPolicy.COLUMN:
            return local
        return local.view(-1, lay.storage_width)

    def _keep_held(self, local, chunk, lo):
        """Copies into ``local`` what this shard holds of ``chunk``, the
        drawn fused rows [lo, lo + len(chunk))."""
        lay = self.layout
        m, s, hi = lay.num_shards, self.shard, lo + chunk.shape[0]
        if lay.policy == ShardingPolicy.COLUMN:
            w = lay.dim // m
            local[lo:hi] = chunk[:, s * w:(s + 1) * w]
        elif self._strided:  # fused row g at local row g // m, g % m == s
            g0 = lo + (s - lo) % m
            if g0 < hi:
                kept = chunk[g0 - lo::m]
                local[g0 // m:g0 // m + kept.shape[0]] = kept
        else:
            first = s * lay.rows_per_shard
            a, b = max(lo, first), min(hi, first + lay.rows_per_shard)
            if a < b:
                local[a - first:b - first] = chunk[a - lo:b - lo]

    def fused_host_array(self, host_tables: Sequence[np.ndarray]) -> np.ndarray:
        """Per-table host weights -> the global fused [storage_rows,
        storage_width] f32 numpy array in this layout's storage order
        (ROW_HASH striding and lane packing applied)."""
        lay = self.layout
        fused = np.zeros((lay.total_rows, lay.dim), np.float32)
        for arr, off, rows in zip(host_tables, lay.row_offsets, lay.table_rows):
            if arr.shape != (rows, lay.dim):
                raise ValueError(f"table shape {arr.shape} != {(rows, lay.dim)}")
            fused[off : off + rows] = arr
        if lay.policy == ShardingPolicy.ROW_HASH:
            fused = fused[self._row_hash_perm()]
        return fused.reshape(lay.storage_rows, lay.storage_width)

    def shard_host_array(self, storage: np.ndarray) -> np.ndarray:
        """This process's shard of a global storage array (numpy, in storage
        order: what ``fused_host_array`` returns, or a JAX global array)."""
        lay = self.layout
        arr = np.asarray(storage)
        if arr.shape != (lay.storage_rows, lay.storage_width):
            raise ValueError(f"storage shape {arr.shape} != "
                             f"{(lay.storage_rows, lay.storage_width)}")
        return np.ascontiguousarray(shard_storage(lay, self.shard, arr))

    def shard_host_accumulator(self, acc: np.ndarray) -> np.ndarray:
        """This process's shard of a global [total_rows] accumulator."""
        arr = np.asarray(acc)
        if arr.shape != (self.layout.total_rows,):
            raise ValueError(f"accumulator shape {arr.shape} != "
                             f"{(self.layout.total_rows,)}")
        return np.ascontiguousarray(shard_accumulator(self.layout, self.shard, arr))

    def device_put_tables(self, host_tables: Sequence[np.ndarray]) -> torch.Tensor:
        """Load pre-existing per-table weights: this process's shard, on
        this collection's device."""
        shard = self.shard_host_array(self.fused_host_array(host_tables))
        return torch.from_numpy(shard).to(self.device)

    def gather_storage(self, fused: torch.Tensor) -> torch.Tensor:
        """The global storage from every model shard's part (an all-gather
        over the model axis; a replicated storage is returned as is)."""
        pol = self.layout.policy
        if self.mesh is None or pol == ShardingPolicy.REPLICATE:
            return fused
        return self.mesh.all_gather(fused, MODEL_AXIS, 1 if pol == ShardingPolicy.COLUMN else 0)

    def gather_accumulator(self, acc: torch.Tensor) -> torch.Tensor:
        """The global accumulator from every model shard's part."""
        if self.mesh is None or not _rowish(self.layout.policy):
            return acc
        return self.mesh.all_gather(acc, MODEL_AXIS, 0)

    def unfuse_host(self, fused) -> list[np.ndarray]:
        """Inverse of fused_host_array: fused storage -> per-table [rows,
        dim] numpy weights in table order.  A tensor is this process's
        shard (gathered over the model axis first); a numpy array is the
        global storage."""
        lay = self.layout
        if isinstance(fused, torch.Tensor):
            fused = self.gather_storage(fused).detach().float().cpu().numpy()
        arr = np.asarray(fused).reshape(-1, lay.dim)
        if lay.policy == ShardingPolicy.ROW_HASH:
            perm = self._row_hash_perm()
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            arr = arr[inv]
        return [arr[off : off + rows]
                for off, rows in zip(lay.row_offsets, lay.table_rows)]

    def _row_hash_perm(self) -> np.ndarray:
        """Strided placement: shard s's local row j holds fused row j*m+s."""
        m, rps = self.layout.num_shards, self.layout.rows_per_shard
        return (np.arange(rps)[None, :] * m + np.arange(m)[:, None]).reshape(-1)

    # -- lookup -------------------------------------------------------------

    def globalize(self, indices: torch.Tensor) -> torch.Tensor:
        """Per-table local ids [T, C] -> fused row ids."""
        return indices + self._row_offsets.to(indices.dtype)[:, None]

    def _shard_kw(self):
        lay = self.layout
        return dict(shard=self.shard, num_shards=lay.num_shards,
                    rows_per_shard=lay.rows_per_shard, strided=self._strided)

    def lookup(
        self,
        fused_table: torch.Tensor,
        indices: torch.Tensor,  # [T, B*L] local ids (this data row's slice)
        mask: torch.Tensor,  # [T, B*L] bool
        *,
        batch_size: int | None = None,
        combiner: str = "sum",  # "sum" | "mean" | "max"
    ) -> torch.Tensor:  # [B, T, D] f32
        """Pooled lookup.  Empty bags pool to 0 for every combiner."""
        t, c = indices.shape
        b = batch_size if batch_size is not None else c
        if c % b:
            raise ValueError(f"capacity {c} not divisible by batch {b}")
        if combiner not in ("sum", "mean", "max"):
            raise ValueError(f"unknown combiner {combiner!r}")
        fused_table = self._lookup_input("lookup", fused_table)
        pooling = c // b
        mask = mask.to(torch.bool)
        g_idx = self.globalize(indices.to(torch.int32))
        lay = self.layout
        if lay.policy == ShardingPolicy.REPLICATE:
            pooled = _local_pooled_lookup(fused_table, lay.dim, g_idx, mask, pooling, combiner)
        elif lay.policy == ShardingPolicy.COLUMN:
            # torch has no lazy gather: the dim slices are gathered here,
            # where the JAX package's consumer would gather them
            part = _local_pooled_lookup(fused_table, lay.dim // lay.num_shards, g_idx, mask,
                                        pooling, combiner)
            pooled = self.mesh.all_gather(part, MODEL_AXIS, 2)
        else:
            part = _rowshard_pooled_lookup(fused_table, lay.dim, g_idx, mask, pooling,
                                           combiner, **self._shard_kw())
            pooled = (self.mesh.pmax if combiner == "max" else self.mesh.psum)(
                part, MODEL_AXIS)
        if combiner == "sum":
            return pooled
        return _finish_combiner(combiner, pooling, pooled, mask)

    def lookup_csr(
        self,
        fused_table: torch.Tensor,
        indices: torch.Tensor,  # [T, C] local ids, padded
        offsets: torch.Tensor,  # [T, B+1] bag offsets
        *,
        combiner: str = "sum",  # "sum" | "mean" | "max"
        data_sharded: bool = False,
        routed: bool = False,
        capacity_factor: float | None = None,
        return_stats: bool = False,
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:  # [B, T, D] f32
        """Pooled lookup over ragged (CSR) bags, the reference's wire
        (emb_host.h:234).  Table t's bag b owns entries
        [offsets[t, b], offsets[t, b+1]) of indices[t]; entries past
        offsets[t, B] are padding.  Empty bags pool to 0 for every combiner.

        ``data_sharded=False``: every process passes the whole batch and
        gets all of it.  ``data_sharded=True``: each process passes its own
        window (``ops.ragged.shard_csr``; offsets relative to the window)
        and gets its Bd bags.  The pooling is the same either way; the flag
        says whether a routed drop count, and under grad the storage's
        gradient, is summed over the data axis.

        ``routed=True`` (ROW/ROW_HASH/TABLE_WISE, SUM/MEAN) sends the
        entries to their owners through the all-to-all routing of
        ``lookup_routed``, with the same capacity factor and drop count
        (``return_stats=True`` returns ``(pooled, dropped)``).  MEAN divides
        by the full bag length."""
        if return_stats and not routed:
            raise ValueError("return_stats requires routed=True (the "
                             "broadcast CSR path cannot drop entries)")
        if routed:
            if not _rowish(self.layout.policy):
                raise ValueError("routed lookup_csr requires ROW/ROW_HASH/TABLE_WISE")
            if combiner not in ("sum", "mean"):
                raise ValueError("routed lookup_csr supports sum/mean")
        elif combiner not in ("sum", "mean", "max"):
            raise ValueError(f"unknown combiner {combiner!r}")
        fused_table = self._lookup_input("lookup_csr", fused_table, data_sharded)
        b = offsets.shape[1] - 1
        g_idx = self.globalize(indices.to(torch.int32)).contiguous()
        offsets = offsets.to(torch.int32).contiguous()
        lay = self.layout
        if routed:
            pooled, dropped = _routed_csr_pooled_lookup(
                fused_table, lay.dim, g_idx, offsets, b, mesh=self.mesh,
                rows_per_shard=lay.rows_per_shard, cf=self._resolve_cf(capacity_factor),
                strided=self._strided)
            if combiner == "mean":
                pooled = pooled / _csr_counts(offsets).clamp(min=1)
            if not return_stats:
                return pooled
            if data_sharded:
                dropped = self.mesh.psum(dropped, DATA_AXIS)
            return pooled, dropped.reshape(())
        if lay.policy == ShardingPolicy.REPLICATE:
            pooled = _csr_local_pool(fused_table, lay.dim, g_idx, offsets, b, combiner)
        elif lay.policy == ShardingPolicy.COLUMN:
            part = _csr_local_pool(fused_table, lay.dim // lay.num_shards, g_idx, offsets,
                                   b, combiner)
            pooled = self.mesh.all_gather(part, MODEL_AXIS, 2)
        else:
            part = _csr_rowshard_pool(fused_table, lay.dim, g_idx, offsets, b, combiner,
                                      **self._shard_kw())
            pooled = (self.mesh.pmax if combiner == "max" else self.mesh.psum)(
                part, MODEL_AXIS)
        return _csr_finish(combiner, pooled, offsets)

    # -- routed lookups -----------------------------------------------------

    @property
    def safe_capacity_factor(self) -> float:
        """The smallest capacity factor at which routed drops are
        impossible: cf = M makes every (source, owner) bucket as large as a
        process's whole slice of entries.  The API default: exact, but each
        owner still gathers about E slots; a lower cf (the throughput mode)
        drops what overflows, and counts it."""
        return float(self.layout.num_shards)

    def _resolve_cf(self, capacity_factor: float | None) -> float:
        if capacity_factor is None:
            return self.safe_capacity_factor
        return float(capacity_factor)

    def lookup_routed(
        self,
        fused_table: torch.Tensor,
        indices: torch.Tensor,  # [T, B*L] local ids (this data row's slice)
        mask: torch.Tensor,  # [T, B*L]
        *,
        batch_size: int | None = None,
        capacity_factor: float | None = None,
        hot_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
        return_stats: bool = False,
        combiner: str = "sum",  # "sum" | "mean" (max: the broadcast lookup)
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
        """Pooled SUM/MEAN lookup with all-to-all id routing (ROW, ROW_HASH,
        TABLE_WISE).  Each model peer of a data row takes an E/M slice of
        the row's entries, sends each entry to its owner shard through
        capacity-bucketed all-to-alls (ceil(cf * E/M / M) slots per (source,
        owner) pair), the owner gathers the rows it holds and they ride an
        all-to-all back; pooled partials are summed over the model axis.

        ``capacity_factor=None`` is ``safe_capacity_factor``: nothing can
        drop.  Below it an overflowing entry is dropped (it adds zero) and
        counted: ``return_stats=True`` returns ``(pooled, dropped)``, the
        count over the whole mesh.  MEAN divides by the full masked bag
        size.  ``hot_cache``: ``(hot_ids [K] sorted, hot_rows [K, D])`` from
        ``hotcache.build_hot_cache``; entries it holds are served from it
        and not routed (under grad: the module docstring)."""
        if not _rowish(self.layout.policy):
            raise ValueError("lookup_routed requires ROW/ROW_HASH/TABLE_WISE sharding")
        if combiner not in ("sum", "mean"):
            raise ValueError("lookup_routed supports sum/mean combiners")
        t, c = indices.shape
        b = batch_size if batch_size is not None else c
        if c % b:
            raise ValueError(f"capacity {c} not divisible by batch {b}")
        fused_table = self._lookup_input("lookup_routed", fused_table)
        if hot_cache is not None:
            # every process reads the replicated rows for its own slice of
            # entries, so under grad their cotangent is summed over the mesh
            hot_ids, hot_rows = hot_cache
            hot_cache = hot_ids, self.mesh.pvary(self.mesh.pvary(hot_rows, MODEL_AXIS),
                                                 DATA_AXIS)
        mask = mask.to(torch.bool)
        g_idx = self.globalize(indices.to(torch.int32))
        lay = self.layout
        pooled, dropped = _routed_pooled_lookup(
            fused_table, lay.dim, g_idx, mask, c // b, mesh=self.mesh,
            rows_per_shard=lay.rows_per_shard, cf=self._resolve_cf(capacity_factor),
            strided=self._strided, hot_cache=hot_cache)
        if combiner == "mean":
            pooled = _finish_combiner("mean", c // b, pooled, mask)
        if return_stats:
            return pooled, self.mesh.psum(dropped, DATA_AXIS).reshape(())
        return pooled


# -- per-shard bodies ---------------------------------------------------------------


def _local_pooled_lookup(storage, d, g_idx, keep, pooling, combiner, round_bf16=False):
    """[T, B*L] ids and kept entries -> [B, T, d] f32: K1 for SUM/MEAN
    (the SUM), MAX in plain PyTorch with -3e38 for bags with nothing kept
    (finished by _finish_combiner).  Dropped entries are never read.
    ``round_bf16`` (float storage: the hybrid's small set): each row is
    rounded to bf16 (``embedding_bag_fixedl``'s keyword)."""
    t, c = g_idx.shape
    b = c // pooling
    if combiner == "max":
        return _max_pool_raw(storage, d, g_idx, keep, pooling, round_bf16)
    rows, scale = _parts(storage)
    out = embedding_bag_fixedl(rows, d, g_idx.reshape(-1), pooling=pooling,
                               batch_size=t * b, mask=keep.reshape(-1), scale=scale,
                               round_bf16=round_bf16)
    return out.reshape(t, b, d).transpose(0, 1)


def _rowshard_pooled_lookup(storage, d, g_idx, mask, pooling, combiner, *, shard,
                            num_shards, rows_per_shard, strided):
    """Model shard ``shard``'s partial of a dense-wire lookup: the entries
    it owns, pooled from its rows, [B, T, d] (the JAX package's
    ``_rowshard_pooled_lookup`` before its psum/pmax).  An entry is owned
    where its owner is this shard and its local row lies in the shard
    (a last shard's padding, TABLE_WISE's bins)."""
    owner, local = _owner_local(g_idx, rows_per_shard, num_shards, strided)
    owned = (owner == shard) & (local < rows_per_shard) & mask
    return _local_pooled_lookup(storage, d, local, owned, pooling, combiner)


def _max_pool_raw(storage, d, g_idx, keep, pooling, round_bf16=False):
    """Masked MAX over each bag, one table at a time so that the gathered
    rows never exceed [B*L, d]; bags with nothing kept hold -3e38.
    ``round_bf16``: the rows come from K1 at L=1 rounding them to bf16, so
    that under grad the storage gets K1's rounded gradient."""
    per_table = []
    for ids, kp in zip(g_idx, keep):
        if round_bf16:
            rows = embedding_bag_fixedl(storage, d, ids, pooling=1, batch_size=ids.numel(),
                                        mask=kp, round_bf16=True)
        else:
            rows = _gather_rows(storage, d, torch.where(kp, ids, 0).long())
        rows = torch.where(kp[:, None], rows, _NEG_INF)
        per_table.append(rows.reshape(-1, pooling, d).amax(dim=1))
    return torch.stack(per_table, dim=1)  # [B, T, d]


def _finish_combiner(combiner, pooling, pooled, mask):
    """MEAN/MAX finish on the merged [B, T, D]: MEAN divides by max(count,
    1), MAX sends empty bags to 0 (counts from the whole query's mask)."""
    t, c = mask.shape
    counts = mask.reshape(t, c // pooling, pooling).sum(dim=-1)  # [T, B]
    counts = counts.transpose(0, 1)[..., None]  # [B, T, 1]
    if combiner == "mean":
        return pooled / counts.clamp(min=1)
    return torch.where(counts > 0, pooled, 0.0)


def _csr_counts(offsets):
    """Bag sizes [B, T, 1] from [T, B+1] offsets."""
    return (offsets[:, 1:] - offsets[:, :-1]).transpose(0, 1)[..., None]


def _csr_finish(combiner, pooled, offsets):
    """SUM as is; MEAN divides by the bag sizes; MAX sends empty bags to 0."""
    if combiner == "sum":
        return pooled
    counts = _csr_counts(offsets)
    if combiner == "mean":
        return pooled / counts.clamp(min=1)
    return torch.where(counts > 0, pooled, 0.0)


def _csr_local_pool(storage, d, g_idx, offsets, batch, combiner, mask=None):
    """[T, C] ids, [T, B+1] offsets -> [B, T, d] f32 over this process's
    storage: K2 (its SUM) for SUM/MEAN, plain MAX (-3e38 for bags with
    nothing kept).  ``mask`` [T, C] drops entries, which are never read."""
    t = g_idx.shape[0]
    if combiner == "max":
        return _csr_max_raw(storage, d, g_idx, offsets, mask)
    rows, scale = _parts(storage)
    out = embedding_bag_csr_packed(rows, d, g_idx, offsets, batch_size=batch, mask=mask,
                                   scale=scale)
    return out.reshape(t, batch, d).transpose(0, 1)


def _csr_rowshard_pool(storage, d, g_idx, offsets, batch, combiner, *, shard, num_shards,
                       rows_per_shard, strided):
    """Model shard ``shard``'s partial of a CSR lookup, [B, T, d]: K2 with
    the ownership mask over the owner-local ids (the local part of the JAX
    package's ``_csr_pooled_lookup`` on a row shard).  Ids of other shards
    stay as they are: masked, they are never read."""
    owner, local = _owner_local(g_idx, rows_per_shard, num_shards, strided)
    owned = (owner == shard) & (local < rows_per_shard)
    return _csr_local_pool(storage, d, local.to(torch.int32).contiguous(), offsets, batch,
                           combiner, mask=owned.contiguous())


def _csr_max_raw(storage, d, g_idx, offsets, mask=None):
    """Per-bag MAX over CSR bags: [B, T, d] f32, bags with nothing kept
    -3e38."""
    t, c = g_idx.shape
    b = offsets.shape[1] - 1
    seg = segment_ids_from_offsets(offsets, c).long()  # [T, C]
    valid = seg < b
    if mask is not None:
        valid = valid & mask
    rows = _gather_rows(storage, d, torch.where(valid, g_idx, 0).long().reshape(-1))
    rows = torch.where(valid.reshape(-1, 1), rows, _NEG_INF)
    fseg = torch.arange(t, device=seg.device)[:, None] * (b + 1) + seg
    pooled = torch.full((t * (b + 1), d), _NEG_INF, dtype=torch.float32,
                        device=rows.device)
    pooled.scatter_reduce_(0, fseg.reshape(-1, 1).expand(-1, d), rows, "amax")
    return pooled.reshape(t, b + 1, d)[:, :b].transpose(0, 1)


# -- routing ----------------------------------------------------------------------


def routed_bucket_k(em: int, cf: float, m: int) -> int:
    """Per-(source, owner) routing bucket capacity: ceil(cf * em / m), at
    least 8 and at most em (one process's whole slice)."""
    return min(em, max(8, -(-int(cf * em) // m)))


def _slice_entries(mi, m, em, *arrays):
    """Pad flat per-entry arrays to em*m with zeros and take model peer
    ``mi``'s em-slice."""
    out = []
    for a in arrays:
        pad = em * m - a.shape[0]
        if pad:
            a = torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
        out.append(a[mi * em:(mi + 1) * em])
    return out


def _bucket_slots(owner, valid, m, k):
    """Each valid entry's slot owner*k + (its position among the valid
    entries bound for that owner), and m*k (a slot past the end) where
    the entry is invalid or its bucket is full.  Returns (slot, kept)."""
    oh = torch.nn.functional.one_hot(owner, m) * valid[:, None]  # [E, M]
    pos = (torch.cumsum(oh, dim=0) - oh).gather(1, owner[:, None])[:, 0]
    ok = valid & (pos < k)
    return torch.where(ok, owner * k + pos, m * k), ok


def _gather_rows(storage, d, ids):
    """Rows ``ids`` (int64, 1-D) of d-wide storage, in f32 (int8 dict
    storage: the codes, times their scales in "row" mode)."""
    rows, scale = _parts(storage)
    return gather_rows(rows, d, ids, scale)


def _route_rows(storage, d, gs, vs, *, mesh, rows_per_shard, cf, strided, hot_cache=None):
    """The routing core of both routed lookups: this process's slice of
    (fused id, valid) entries goes to the owner shards through
    capacity-bucketed all-to-alls, each owner gathers the rows it holds
    (ordinary torch: XLA's gather in the JAX package), and the rows ride
    back.  Returns (rows [Em, D] f32, zero for invalid or dropped entries;
    dropped [1] int32, summed over the model axis)."""
    m = mesh.model
    em = gs.shape[0]
    hot_e = None
    if hot_cache is not None:
        from .hotcache import hot_cache_select

        hit, hot_e = hot_cache_select(*hot_cache, gs, vs)
        vs = vs & ~hit  # hot entries are served here, not routed
    owner, local = _owner_local(gs, rows_per_shard, m, strided)
    owner = owner.clamp(0, m - 1).long()
    k = routed_bucket_k(em, cf, m)
    slot, ok = _bucket_slots(owner, vs, m, k)
    dropped = mesh.psum((vs & ~ok).sum(dtype=torch.int32).reshape(1), MODEL_AXIS)

    # owner-local ids, the sentinel rows_per_shard in empty slots; slot
    # m*k is a dump for what is not sent
    send = torch.full((m * k + 1,), rows_per_shard, dtype=gs.dtype, device=gs.device)
    send[slot] = torch.where(ok, local, rows_per_shard).to(gs.dtype)
    recv = mesh.all_to_all(send[: m * k])  # ids I own, one k-block per source
    have = (recv >= 0) & (recv < rows_per_shard)
    rows = _gather_rows(storage, d, torch.where(have, recv, 0).long())
    rows = torch.where(have[:, None], rows, 0.0)
    # bf16-stored rows are exact in bf16 (a gather never adds), and so are
    # int8 codes ("table" mode), so they ride back in bf16, half the bytes;
    # f32 rows and codes times their scales ("row" mode) in f32
    rows_t, scale = _parts(storage)
    exact = rows_t.dtype == torch.bfloat16 or (rows_t.dtype == torch.int8 and scale is None)
    wire = torch.bfloat16 if exact else torch.float32
    back = mesh.all_to_all(rows.to(wire))  # row my slot (o, kk) asked owner o for
    back = torch.cat([back, back.new_zeros(1, d)])
    rows_e = back[slot].float()  # dropped and invalid entries -> the zero row
    if hot_e is not None:
        rows_e = rows_e + hot_e
    return rows_e, dropped


def _routed_pooled_lookup(storage, d, g_idx, mask, pooling, *, mesh, rows_per_shard, cf,
                          strided, hot_cache=None):
    """Per-process body of lookup_routed: g_idx and mask [T, Cd] (the same
    on every model peer of a data row); peer mi routes the mi-th slice of
    the T*Cd entries.  Returns (pooled SUM [Bd, T, D] summed over the model
    axis, dropped [1])."""
    t, cd = g_idx.shape
    m, mi = mesh.model, mesh.index(MODEL_AXIS)
    em = -(-t * cd // m)
    gs, vs = _slice_entries(mi, m, em, g_idx.reshape(-1), mask.reshape(-1))
    rows_e, dropped = _route_rows(storage, d, gs, vs, mesh=mesh,
                                  rows_per_shard=rows_per_shard, cf=cf, strided=strided,
                                  hot_cache=hot_cache)
    # entry e of the flat [T*Cd] belongs to table e // Cd, bag (e % Cd) // L
    bd = cd // pooling
    e_ids = mi * em + torch.arange(em, device=gs.device)
    seg = (e_ids // cd).clamp(max=t - 1) * bd + (e_ids % cd) // pooling
    pooled = torch.zeros(t * bd, d, dtype=torch.float32, device=gs.device)
    pooled.index_add_(0, seg, rows_e)
    pooled = pooled.reshape(t, bd, d).transpose(0, 1).contiguous()
    return mesh.psum(pooled, MODEL_AXIS), dropped


def _routed_csr_pooled_lookup(storage, d, g_idx, offsets, batch, *, mesh, rows_per_shard,
                              cf, strided):
    """Per-process body of lookup_csr(routed=True): bag membership from
    the offsets, each entry carrying its fused (table, bag) segment id
    through the slice.  Returns (pooled SUM [B, T, D] summed over the model
    axis, dropped [1])."""
    t, cd = g_idx.shape
    m, mi = mesh.model, mesh.index(MODEL_AXIS)
    seg = segment_ids_from_offsets(offsets, cd).long()  # [T, Cd]; padding -> B
    valid = seg < batch
    tid = torch.arange(t, device=seg.device)[:, None]
    fseg = tid * batch + seg.clamp(max=max(batch - 1, 0))
    em = -(-t * cd // m)
    gs, vs, ss = _slice_entries(mi, m, em, g_idx.reshape(-1), valid.reshape(-1),
                                fseg.reshape(-1))
    rows_e, dropped = _route_rows(storage, d, gs, vs, mesh=mesh,
                                  rows_per_shard=rows_per_shard, cf=cf, strided=strided)
    pooled = torch.zeros(t * batch, d, dtype=torch.float32, device=gs.device)
    pooled.index_add_(0, ss, rows_e)
    pooled = pooled.reshape(t, batch, d).transpose(0, 1).contiguous()
    return mesh.psum(pooled, MODEL_AXIS), dropped
