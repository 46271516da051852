"""Table placement and embedding collections."""

from .bucketed import lookup_csr_bucketed
from .collection import EmbeddingCollection
from .hybrid import HybridEmbeddingCollection
from .planner import FusedLayout, plan, resolve_pack

__all__ = [
    "EmbeddingCollection", "HybridEmbeddingCollection", "FusedLayout", "plan",
    "resolve_pack", "lookup_csr_bucketed",
]
