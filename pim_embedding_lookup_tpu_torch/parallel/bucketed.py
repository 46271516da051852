"""Length-bucketed CSR dispatch: ragged bags -> a few fixed-L dense
lookups plus a residual CSR tail, merged by a per-batch-element copy.

The counterpart of ``pim_embedding_lookup_tpu.parallel.bucketed``.  The
host packer (``ops.ragged.pack_length_buckets``) groups batch elements by
their longest bag into fixed-L buckets; each bucket runs the collection's
dense ``lookup`` (the K1 kernel on the card for the big set) and only the
long bags run ``lookup_csr`` (K2).  Positions are per batch element and
shared across tables, so the merge moves at most B rows of [T*D], and it is
a slice when the pack is the identity.

Every batch element with entries holds exactly one bucket or tail slot, so
the merge is exact for every combiner; all-empty elements keep zeros.
Unused slots carry position ``batch`` and land in a row that is cut off.
"""

from __future__ import annotations

import torch

from ..ops.ragged import BucketedCSR


def lookup_csr_bucketed(
    coll,
    params,
    packed: BucketedCSR,
    *,
    combiner: str = "sum",
) -> torch.Tensor:  # [B, T, D] f32
    """Dispatch a host-packed BucketedCSR through ``coll`` (an
    EmbeddingCollection or HybridEmbeddingCollection) and merge.  The
    packed arrays are numpy, or tensors of the same shapes."""
    plan = packed.plan
    b = plan.batch

    def put(x):
        return torch.as_tensor(x).to(coll.device)

    parts = []  # (pooled [Bk, T, D], pos [Bk])
    for k in range(len(plan.bucket_ls)):
        if plan.capacities[k] == 0:
            continue
        pooled = coll.lookup(
            params, put(packed.idx[k]), put(packed.mask[k]),
            batch_size=plan.capacities[k], combiner=combiner,
        )
        parts.append((pooled, packed.pos[k]))

    if packed.identity and parts:
        # fixed-L fast path: slot j is batch element j, and the tail is
        # unused, so it is not dispatched
        return parts[0][0][:b]

    if plan.tail_bags:
        pooled = coll.lookup_csr(
            params, put(packed.tail_idx), put(packed.tail_off), combiner=combiner,
        )
        parts.append((pooled, packed.tail_pos))

    if not parts:
        raise ValueError("bucketed CSR with all-zero capacities")

    _, t, d = parts[0][0].shape
    out_flat = torch.zeros(b + 1, t * d, dtype=parts[0][0].dtype,
                           device=parts[0][0].device)
    for pooled, pos in parts:
        out_flat.index_copy_(0, put(pos).long(), pooled.reshape(-1, t * d))
    return out_flat[:b].reshape(b, t, d)
