"""Single-shard embedding-bag ops: the hand-written kernels, each beside its
plain PyTorch version, the plain ops, the ragged helpers, and the
impl-dispatching facade ``embedding_bag``."""

from __future__ import annotations

import torch

from ..config import Combiner, LookupImpl
from .csr_pool import (
    embedding_bag_csr_grad,
    embedding_bag_csr_grad_reference,
    embedding_bag_csr_packed,
    embedding_bag_csr_packed_reference,
    embedding_bag_csr_sum,
)
from .fixedpoint import SCALE, decode, embedding_bag_fixed_point, encode
from .gather_pool import embedding_bag_fixedl, embedding_bag_fixedl_reference
from .lookup import embedding_bag_csr, embedding_bag_dense, embedding_bag_onehot
from .ragged import (
    bag_lengths,
    csr_to_dense,
    dense_to_csr,
    pack_bags,
    segment_ids_from_offsets,
)

# Tables at or below this many rows run the one-hot path when impl=AUTO.
ONEHOT_ROW_THRESHOLD = 2048


def embedding_bag(
    table: torch.Tensor,
    indices: torch.Tensor,
    offsets: torch.Tensor,
    *,
    batch_size: int,
    combiner: Combiner = Combiner.SUM,
    impl: LookupImpl = LookupImpl.AUTO,
) -> torch.Tensor:
    """Pooled CSR embedding lookup on one device, by ``impl``: ONEHOT (SUM
    only), JNP (the plain ops, every combiner) or PALLAS (the K4 kernel,
    SUM and MEAN).  AUTO takes ONEHOT for SUM over tables of at most
    ONEHOT_ROW_THRESHOLD rows, else JNP."""
    impl = LookupImpl(impl)
    combiner = Combiner(combiner)
    if impl == LookupImpl.AUTO:
        if (
            combiner == Combiner.SUM
            and table.shape[0] <= ONEHOT_ROW_THRESHOLD
            and table.dim() == 2
        ):
            impl = LookupImpl.ONEHOT
        else:
            impl = LookupImpl.JNP
    if impl == LookupImpl.ONEHOT:
        if combiner != Combiner.SUM:
            raise NotImplementedError("onehot path supports SUM only")
        return embedding_bag_onehot(table, indices, offsets, batch_size=batch_size)
    if impl == LookupImpl.PALLAS:
        if combiner == Combiner.MAX:
            raise NotImplementedError("pallas path supports SUM/MEAN")
        pooled = embedding_bag_csr_sum(table, indices, offsets, batch_size=batch_size)
        if combiner == Combiner.SUM:
            return pooled
        lengths = bag_lengths(offsets).clamp(min=1).to(pooled.dtype)
        return pooled / lengths[:, None]
    return embedding_bag_csr(
        table, indices, offsets, batch_size=batch_size, combiner=combiner
    )


__all__ = [
    "Combiner",
    "LookupImpl",
    "ONEHOT_ROW_THRESHOLD",
    "embedding_bag",
    "embedding_bag_csr",
    "embedding_bag_dense",
    "embedding_bag_onehot",
    "embedding_bag_csr_packed",
    "embedding_bag_csr_packed_reference",
    "embedding_bag_csr_sum",
    "embedding_bag_csr_grad",
    "embedding_bag_csr_grad_reference",
    "embedding_bag_fixedl",
    "embedding_bag_fixedl_reference",
    "embedding_bag_fixed_point",
    "encode",
    "decode",
    "SCALE",
    "pack_bags",
    "dense_to_csr",
    "csr_to_dense",
    "bag_lengths",
    "segment_ids_from_offsets",
]
