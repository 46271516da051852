"""Kernels of the port, each beside its plain PyTorch version."""

from .gather_pool import embedding_bag_fixedl, embedding_bag_fixedl_reference

__all__ = ["embedding_bag_fixedl", "embedding_bag_fixedl_reference"]
