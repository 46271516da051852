"""Hot-row replication cache for skewed (zipf) id streams.

The counterpart of ``pim_embedding_lookup_tpu.parallel.hotcache``.  Under
row sharding every hot row lives on one shard, so a routed lookup funnels
the hot traffic to a few owners.  The cache replicates the top-k rows:

* ``hot_ids_from_sample``: the k hottest fused ids of a query sample (host,
  numpy);
* ``build_hot_cache``: those rows gathered out of the sharded storage into
  a replicated [K, D] f32 tensor (each owner gathers its rows, the others
  add zeros, summed over the model axis).  Over int8 params of a
  ``QuantizedEmbeddingCollection`` the rows are in the units the routed
  gather returns: f32 rows in "row" scale mode, quantized units in
  "table" mode (the per-table scale folds into the pooled output);
* ``EmbeddingCollection.lookup_routed(..., hot_cache=...)``: entries the
  cache holds are served from it (``hot_cache_select``, a binary search)
  and are not routed.

The cache is a snapshot: after training steps it is stale until rebuilt.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import ShardingPolicy
from .collection import EmbeddingCollection, _gather_rows, _owner_local, _rowish
from .mesh import MODEL_AXIS
from .quantized_collection import QuantizedEmbeddingCollection


def hot_ids_from_sample(coll: EmbeddingCollection, indices_sample: np.ndarray,
                        k: int) -> np.ndarray:
    """The k hottest fused ids of ``indices_sample`` ([T, C] local
    per-table ids), sorted ascending, int32."""
    offs = np.asarray(coll.layout.row_offsets, dtype=np.int64)
    fused = (indices_sample.astype(np.int64) + offs[:, None]).reshape(-1)
    ids, counts = np.unique(fused, return_counts=True)
    top = ids[np.argsort(-counts)[:k]]  # the JAX package's order among ties
    return np.sort(top).astype(np.int32)


def build_hot_cache(coll: EmbeddingCollection | QuantizedEmbeddingCollection, fused,
                    hot_ids: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """(hot_ids [K] int32 sorted, hot_rows [K, D] f32), the same on every
    process.  ``fused`` is this process's storage (int8 params for a
    QuantizedEmbeddingCollection)."""
    if isinstance(coll, QuantizedEmbeddingCollection):
        coll, fused = coll._delegate, coll._storage(fused)
    coll._require_mesh("build_hot_cache")
    lay = coll.layout
    ids = torch.from_numpy(np.sort(np.asarray(hot_ids)).astype(np.int32)).to(coll.device)
    if _rowish(lay.policy):
        owner, local = _owner_local(ids, lay.rows_per_shard, lay.num_shards,
                                    lay.policy == ShardingPolicy.ROW_HASH)
        owned = owner == coll.shard
        rows = _gather_rows(fused, lay.dim, torch.where(owned, local, 0).long())
        rows = torch.where(owned[:, None], rows, 0.0)
        return ids, coll.mesh.psum(rows, MODEL_AXIS)
    if lay.policy == ShardingPolicy.COLUMN:
        rows = _gather_rows(fused, lay.dim // lay.num_shards, ids.long())
        return ids, coll.mesh.all_gather(rows, MODEL_AXIS, 1)
    return ids, _gather_rows(fused, lay.dim, ids.long())


def hot_cache_select(hot_ids: torch.Tensor, hot_rows: torch.Tensor, gs: torch.Tensor,
                     vs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-entry cache probe of fused ids ``gs`` (kept where ``vs``):
    (hit [E], rows [E, D] f32, zero where there is no hit)."""
    k = hot_ids.shape[0]
    pos = torch.searchsorted(hot_ids, gs.to(hot_ids.dtype))
    pos_c = pos.clamp(max=k - 1)
    hit = (hot_ids[pos_c] == gs) & (pos < k) & vs
    rows = torch.where(hit[:, None], hot_rows[pos_c].float(), 0.0)
    return hit, rows
