"""Table placement and embedding collections."""

from . import multihost
from .bucketed import lookup_csr_bucketed
from .collection import EmbeddingCollection
from .hybrid import HybridEmbeddingCollection
from .planner import FusedLayout, plan, resolve_pack
from .quantized_collection import QuantizedEmbeddingCollection

__all__ = [
    "EmbeddingCollection", "HybridEmbeddingCollection", "QuantizedEmbeddingCollection",
    "FusedLayout", "plan",
    "resolve_pack", "lookup_csr_bucketed", "multihost",
]
