"""Train in f32, serve in int8: a trained DLRM's embedding storage in the
capacity-mode layout, the dense MLP weights untouched.

The counterpart of ``pim_embedding_lookup_tpu.models.quantize``.  A hybrid
model keeps its small set's float weights (the one-hot products cost almost
nothing) and quantizes only the big set:

    serve_coll, emb = quantize_dlrm_embeddings(model, scale_mode="table")
    pooled = serve_coll.lookup(emb, idx, mask, batch_size=b)   # or lookup_csr
    logits = model.apply_from_pooled(dense, pooled)
"""

from __future__ import annotations

import dataclasses

from ..config import ShardingPolicy
from ..parallel.hybrid import HybridEmbeddingCollection
from ..parallel.quantized_collection import QuantizedEmbeddingCollection

_COLUMN_REFUSAL = ("quantize_dlrm_embeddings: COLUMN sharding would split per-row "
                   "scales — retrain/re-shard rowish or REPLICATE for int8 serving")


def quantize_dlrm_embeddings(model, *, scale_mode: str = "table") -> tuple[object, object]:
    """``model`` (its ``collection`` and ``emb_params()``) -> (serving
    collection, serving params): the params in the form the serving
    collection's lookups take, whose pooled output feeds
    ``model.apply_from_pooled``.

    A plain collection becomes a QuantizedEmbeddingCollection of the same
    layout (every table int8).  A hybrid keeps its small set (the same
    tensor) and its big set becomes int8 on the same layout; a hybrid whose
    big set is already int8, or that has none, is returned as it is.  The
    storage is quantized where it lies, each process its own shard
    (``QuantizedEmbeddingCollection.quantize_storage``: the params
    ``quantize_tables`` gives for the same tables, bit for bit).
    ``scale_mode``: "table" (one scale per table, folded after pooling) or
    "row" (one scale per row, loaded beside each row).  COLUMN sharding is
    refused."""
    coll = model.collection
    params = model.emb_params()
    if isinstance(coll, HybridEmbeddingCollection):
        if coll.big is None or isinstance(coll.big, QuantizedEmbeddingCollection):
            return coll, params  # nothing to quantize, or already the serving layout
        if coll.big.layout.policy == ShardingPolicy.COLUMN:
            raise ValueError(_COLUMN_REFUSAL)
        qbig = QuantizedEmbeddingCollection(coll.big.layout, coll.device, coll.mesh,
                                            scale_mode)
        big = qbig.quantize_storage(params["big"])
        return dataclasses.replace(coll, big=qbig), {"small": params["small"], "big": big}
    if coll.layout.policy == ShardingPolicy.COLUMN:
        raise ValueError(_COLUMN_REFUSAL)
    qcoll = QuantizedEmbeddingCollection(coll.layout, coll.device, coll.mesh, scale_mode)
    return qcoll, qcoll.quantize_storage(params)
