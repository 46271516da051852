"""Table placement and embedding collections."""

from . import multihost
from .bucketed import lookup_csr_bucketed
from .collection import EmbeddingCollection
from .hybrid import HybridEmbeddingCollection
from .mesh import DATA_AXIS, MODEL_AXIS, make_mesh, shard_count
from .planner import FusedLayout, plan, resolve_pack
from .quantized_collection import QuantizedEmbeddingCollection

__all__ = [
    "EmbeddingCollection", "HybridEmbeddingCollection", "QuantizedEmbeddingCollection",
    "FusedLayout", "plan",
    "resolve_pack", "lookup_csr_bucketed", "multihost",
    "make_mesh", "shard_count", "DATA_AXIS", "MODEL_AXIS",
]
