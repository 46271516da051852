"""Models over the embedding collections."""

from .dlrm import DLRM, bce_loss, interact_dot

__all__ = ["DLRM", "bce_loss", "interact_dot"]
