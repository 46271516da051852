"""Table placement and embedding collections."""

from .collection import EmbeddingCollection
from .hybrid import HybridEmbeddingCollection
from .planner import FusedLayout, plan, resolve_pack

__all__ = [
    "EmbeddingCollection", "HybridEmbeddingCollection", "FusedLayout", "plan",
    "resolve_pack",
]
