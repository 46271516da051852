"""Hybrid embedding collection: small tables pooled in bf16, big ones in
their storage's precision, both by the fused gather+pool kernel.

The counterpart of ``pim_embedding_lookup_tpu.parallel.hybrid``: lookups and
the sparse optimizer step, on one device or on a mesh, with routed big-set
lookups and updates and the hot-row cache.  Tables with at most
``mxu_threshold`` rows (``create``'s argument, default ``MXU_THRESHOLD``)
form the small set: each is padded to a power-of-two bucket and equal
buckets lie side by side, the JAX package's layout.  The JAX package pools
each bucket as one batched product of a bf16 one-hot with the bf16
weights, accumulated in f32, built for the TPU's matrix unit; each output
row of it has one nonzero term, so an entry adds f32(bf16(w[id])).  On the
dense wire the port pools the small set with K1 over its fused rows, each
element rounded to bf16 as it is added (``round_bf16``): the same values,
bit for bit at L=1, with the product's gradient under autograd, and no
[G, B*L, rows] one-hot written.  The CSR wire still pools each bucket's
one-hot product.  The rest form the big set, an EmbeddingCollection whose
lookup runs the gather+pool kernel on the card.  On a mesh the small set is
planned over the model axis but replicated on every process; the big set is
sharded by its policy, and ``routed``, ``capacity_factor``, ``hot_cache``,
``return_stats`` and ``data_sharded`` pass through to it.  Both sets are
differentiable w.r.t. their storage, with the big set's contract
(``collection``'s module docstring): the small set, replicated, has its
gradient summed over the data axis only, where the query is data-sharded.

With ``quantized_big`` the big set is a ``QuantizedEmbeddingCollection``
(int8 rows with per-table or per-row scales, the capacity mode) while the
small set keeps its float weights; such a hybrid serves and does not train.

Params are a dict ``{"small": [R_s, D] | None, "big": [S, W] | None}`` (an
int8 big set's params are its dict), and so is the row-AdaGrad accumulator.
The sparse step updates the small set by densifying each bucket's gradient
and stepping it row by row, the big set by the entry-wise scatter of
``sparse_update``.  On a mesh the small set's entry stream is first
gathered over the data axis, so that every replica applies the whole
batch.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..config import ShardingPolicy, TableConfig
from ..device import resolve_device
from ..ops.ragged import segment_ids_from_offsets
from ..utils.profiling import span
from .collection import (
    _NEG_INF,
    EmbeddingCollection,
    _csr_counts,
    _finish_combiner,
    _local_pooled_lookup,
)
from .mesh import DATA_AXIS, PortMesh
from .planner import FusedLayout
from .quantized_collection import QuantizedEmbeddingCollection
from .sparse_update import (
    _check_supported,
    _entry_updates,
    _entry_updates_csr,
    init_accumulator,
    sparse_update,
    sparse_update_csr,
)

# The JAX package's split between the two sets, kept so that layouts match.
MXU_THRESHOLD = 8192

# (row_start, padded_rows, pos_lo, pos_hi): small-set members
# [pos_lo, pos_hi) share bucket size padded_rows starting at fused row_start.
Bucket = tuple[int, int, int, int]


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _plan_small_bucketed(
    tables: Sequence[TableConfig], small_ids: Sequence[int], num_shards: int
) -> tuple[tuple[int, ...], FusedLayout, tuple[Bucket, ...]]:
    """Order small tables by bucket size, pad each to its bucket, and lay
    them out contiguously so each bucket's weights are one view
    [G, n_pad, D] of the fused tensor."""
    dim = tables[small_ids[0]].dim
    npad = {i: max(8, _next_pow2(tables[i].num_rows)) for i in small_ids}
    order = tuple(sorted(small_ids, key=lambda i: (npad[i], i)))
    offsets, rows, buckets = [], [], []
    acc = 0
    for pos, i in enumerate(order):
        if buckets and buckets[-1][1] == npad[i]:
            s, n, lo, hi = buckets[-1]
            buckets[-1] = (s, n, lo, hi + 1)
        else:
            buckets.append((acc, npad[i], pos, pos + 1))
        offsets.append(acc)
        rows.append(tables[i].num_rows)
        acc += npad[i]
    layout = FusedLayout(
        policy=ShardingPolicy.REPLICATE,
        dim=dim,
        num_shards=num_shards,
        row_offsets=tuple(offsets),
        table_rows=tuple(rows),
        total_rows=acc,
        pack=1,
    )
    return order, layout, tuple(buckets)


@dataclasses.dataclass(frozen=True)
class HybridEmbeddingCollection:
    """Two sub-collections plus the routing back to the caller's table
    order."""

    tables: tuple[TableConfig, ...]
    small: EmbeddingCollection | None
    big: EmbeddingCollection | QuantizedEmbeddingCollection | None
    small_ids: tuple[int, ...]  # original table indices, in small-set order
    big_ids: tuple[int, ...]
    perm: tuple[int, ...]  # position of original table t in concat(small, big)
    device: torch.device
    buckets: tuple[Bucket, ...] = ()
    mesh: PortMesh | None = None
    # small_ids, big_ids and perm on the device, so that a lookup copies
    # nothing from the host
    _index: dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "_index", {
            name: torch.tensor(getattr(self, name), dtype=torch.long,
                               device=self.device)
            for name in ("small_ids", "big_ids", "perm")
        })

    @staticmethod
    def create(
        tables: Sequence[TableConfig],
        policy: ShardingPolicy = ShardingPolicy.AUTO,
        *,
        device=None,
        mesh: PortMesh | None = None,
        mxu_threshold: int = MXU_THRESHOLD,
        packed: bool | str = "auto",
        quantized_big: bool = False,
        int8_scale_mode: str = "table",
    ) -> "HybridEmbeddingCollection":
        """Tables of at most ``mxu_threshold`` rows go to the small set
        (replicated), the rest to the big set; either set may be empty
        (None).  The big set, lane-packed where its dim allows (``packed``,
        as ``EmbeddingCollection.create`` takes it), is placed by
        ``policy`` over the mesh's model axis.  ``quantized_big``:
        the big set stores int8 rows (inference only), with one scale per
        table (``int8_scale_mode="table"``) or per row ("row")."""
        device = mesh.device if mesh is not None else resolve_device(device)
        small_raw = [i for i, t in enumerate(tables) if t.num_rows <= mxu_threshold]
        big_ids = tuple(i for i, t in enumerate(tables) if t.num_rows > mxu_threshold)
        small = None
        small_ids: tuple[int, ...] = ()
        buckets: tuple[Bucket, ...] = ()
        if small_raw:
            small_ids, lay, buckets = _plan_small_bucketed(
                tables, small_raw, 1 if mesh is None else mesh.model)
            small = EmbeddingCollection(layout=lay, device=device, mesh=mesh)
        big = None
        if big_ids:
            big_tables = [tables[i] for i in big_ids]
            big = (QuantizedEmbeddingCollection.create(
                       big_tables, policy, packed=packed, scale_mode=int8_scale_mode,
                       device=device, mesh=mesh)
                   if quantized_big else
                   EmbeddingCollection.create(big_tables, policy, packed=packed,
                                              device=device, mesh=mesh))
        order = list(small_ids) + list(big_ids)
        perm = tuple(order.index(t) for t in range(len(tables)))
        return HybridEmbeddingCollection(
            tables=tuple(tables),
            small=small,
            big=big,
            small_ids=small_ids,
            big_ids=big_ids,
            perm=perm,
            device=device,
            buckets=buckets,
            mesh=mesh,
        )

    # -- params -------------------------------------------------------------

    @property
    def _big_quantized(self) -> bool:
        return isinstance(self.big, QuantizedEmbeddingCollection)

    def init(self, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> dict:
        """``dtype`` applies to float storage; an int8 big set is drawn
        in int8."""
        big = None
        if self.big is not None:
            big = (self.big.init(generator) if self._big_quantized
                   else self.big.init(generator, dtype))
        return {
            "small": None if self.small is None else self.small.init(generator, dtype),
            "big": big,
        }

    def device_put_tables(self, host_tables) -> dict:
        """Per-table host weights -> params; an int8 big set quantizes
        its tables."""
        big = None
        if self.big is not None:
            big_tables = [host_tables[i] for i in self.big_ids]
            big = (self.big.quantize_tables(big_tables) if self._big_quantized
                   else self.big.device_put_tables(big_tables))
        return {
            "small": None if self.small is None else self.small.device_put_tables(
                [host_tables[i] for i in self.small_ids]),
            "big": big,
        }

    # -- lookup -------------------------------------------------------------

    def lookup(
        self,
        params: dict,
        indices: torch.Tensor,  # [T, B*L]
        mask: torch.Tensor,  # [T, B*L]
        *,
        batch_size: int,
        combiner: str = "sum",  # "sum" | "mean" | "max"
        routed: bool = False,
        capacity_factor: float | None = None,
        hot_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
        return_stats: bool = False,
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:  # [B, T, D] f32
        """Pooled lookup in the caller's table order.  ``routed=True``
        sends the big set through ``lookup_routed`` (SUM/MEAN), with
        ``capacity_factor`` and ``hot_cache``; the small set has nothing to
        route.  ``return_stats`` adds the big set's drop count (0 off the
        routed path)."""
        if routed and combiner == "max":
            raise ValueError("routed lookup supports sum/mean combiners")
        with span("pel.lookup"):
            mask = mask.to(torch.bool)
            dropped = (torch.zeros((), dtype=torch.int32, device=self.device)
                       if return_stats else None)
            parts = []
            if self.small is not None:
                with span("pel.lookup.small"):
                    sel = self._index["small_ids"]
                    parts.append(_small_pooled_lookup(
                        self.small, self.small._lookup_input("lookup", params["small"]),
                        indices[sel], mask[sel], batch_size=batch_size, combiner=combiner,
                    ))
            if self.big is not None:
                with span("pel.lookup.big"):
                    sel = self._index["big_ids"]
                    kw = dict(batch_size=batch_size, combiner=combiner)
                    if routed:
                        out = self.big.lookup_routed(
                            params["big"], indices[sel], mask[sel],
                            capacity_factor=capacity_factor, hot_cache=hot_cache,
                            return_stats=return_stats, **kw)
                        bp, dropped = out if return_stats else (out, dropped)
                    else:
                        bp = self.big.lookup(params["big"], indices[sel], mask[sel], **kw)
                    parts.append(bp)
            pooled = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
            out = pooled[:, self._index["perm"]]
        if return_stats:
            return out, dropped
        return out

    def lookup_csr(
        self,
        params: dict,
        indices: torch.Tensor,  # [T, C]
        offsets: torch.Tensor,  # [T, B+1]
        *,
        combiner: str = "sum",
        data_sharded: bool = False,
        routed: bool = False,
        capacity_factor: float | None = None,
        return_stats: bool = False,
    ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:  # [B, T, D] f32
        """Pooled lookup over ragged (CSR) bags in the caller's table order,
        with EmbeddingCollection.lookup_csr's contract: the small set pools
        its bucketed one-hot rows by a segment reduce (over this process's
        window when ``data_sharded``), the big set runs the CSR kernel (K2),
        or the routed path.  ``return_stats`` adds the big set's count of
        dropped entries, which is 0 off the routed path."""
        if routed and combiner == "max":
            raise ValueError("routed lookup_csr supports sum/mean combiners")
        dropped = torch.zeros((), dtype=torch.int32, device=self.device)
        parts = []
        if self.small is not None:
            sel = self._index["small_ids"]
            parts.append(_mxu_csr_lookup(
                self.small._lookup_input("lookup_csr", params["small"], data_sharded),
                self.buckets, indices[sel], offsets[sel],
                combiner=combiner,
            ))
        if self.big is not None:
            sel = self._index["big_ids"]
            out = self.big.lookup_csr(
                params["big"], indices[sel], offsets[sel], combiner=combiner,
                data_sharded=data_sharded, routed=routed, capacity_factor=capacity_factor,
                return_stats=routed and return_stats,
            )
            bp, dropped = out if routed and return_stats else (out, dropped)
            parts.append(bp)
        pooled = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        out = pooled[:, self._index["perm"]]
        if return_stats:
            return out, dropped
        return out


# -- bucketed one-hot products -------------------------------------------------


def _bucket_entry_rows(fused, bucket, indices, mask):
    """One bucket's per-entry rows: [G, C, D] f32 = onehot(ids) @ W with
    both operands in bf16, as the JAX package computes them, so each row
    equals f32(bf16(w[id])).

    The one-hot is written straight into bf16 (a scatter of the mask into
    zeros): masked entries give all-zero one-hot rows and exact zeros."""
    start, npad, lo, hi = bucket
    g = hi - lo
    d = fused.shape[-1]
    w = fused[start : start + g * npad].reshape(g, npad, d).to(torch.bfloat16)
    ids = indices[lo:hi].long()  # [G, C]
    mk = mask[lo:hi]
    oh = torch.zeros(g, ids.shape[1], npad, dtype=torch.bfloat16,
                     device=fused.device)
    oh.scatter_(2, torch.where(mk, ids, 0)[..., None],
                mk[..., None].to(torch.bfloat16))
    # one nonzero term per output: the bf16 product is exact
    return torch.bmm(oh, w).float(), mk


def _small_pooled_lookup(small, fused, indices, mask, *, batch_size, combiner="sum"):
    """The small set's dense-wire lookup: ids globalized by its padded row
    offsets, then K1 over its fused rows with each element rounded to bf16
    (SUM/MEAN), or MAX over the same rounded rows.  Returns [B, Ts, D] f32."""
    pooling = indices.shape[1] // batch_size
    g_idx = small.globalize(indices.to(torch.int32))
    pooled = _local_pooled_lookup(fused, small.layout.dim, g_idx, mask, pooling, combiner,
                                  round_bf16=True)
    if combiner == "sum":
        return pooled
    return _finish_combiner(combiner, pooling, pooled, mask)


def _mxu_csr_lookup(fused, buckets, indices, offsets, *, combiner="sum"):
    """CSR form of the small set: each bucket's per-entry one-hot rows, then
    a segment reduce over the fused bag ids g*(B+1) + min(seg, B) (bag B
    takes the padding and is dropped).  Returns [B, Ts, D] f32."""
    t, c = indices.shape
    b = offsets.shape[1] - 1
    seg = segment_ids_from_offsets(offsets, c).long()  # [Ts, C]
    valid = seg < b
    outs = []
    for bucket in buckets:
        _, _, lo, hi = bucket
        g = hi - lo
        rows, mk = _bucket_entry_rows(fused, bucket, indices, valid)
        d = rows.shape[-1]
        base = torch.arange(g, device=seg.device)[:, None] * (b + 1)
        fseg = (base + seg[lo:hi]).reshape(-1)
        flat = rows.reshape(g * c, d)
        if combiner == "max":
            flat = torch.where(mk.reshape(-1, 1), flat, _NEG_INF)
            pooled = torch.full((g * (b + 1), d), _NEG_INF, device=flat.device)
            pooled.scatter_reduce_(0, fseg[:, None].expand(-1, d), flat, "amax")
        else:
            pooled = torch.zeros(g * (b + 1), d, device=flat.device)
            pooled.index_add_(0, fseg, flat)
        outs.append(pooled.reshape(g, b + 1, d)[:, :b])
    pooled = torch.cat(outs, dim=0).transpose(0, 1)  # [B, Ts, D]
    if combiner == "sum":
        return pooled
    counts = _csr_counts(offsets)
    if combiner == "mean":
        return pooled / counts.clamp(min=1)
    return torch.where(counts > 0, pooled, 0.0)


# -- the sparse optimizer step --------------------------------------------------


def init_accumulator_hybrid(coll: HybridEmbeddingCollection) -> dict:
    return {
        "small": init_accumulator(coll.small) if coll.small else None,
        "big": init_accumulator(coll.big) if coll.big else None,
    }


def _check_sets(coll, optimizer, routed, name):
    """Refuse what the step cannot do before either set is touched (the
    small set never routes)."""
    if coll.small is not None:
        _check_supported(coll.small, optimizer, False, name)
    if coll.big is not None:
        _check_supported(coll.big, optimizer, routed, name)


def sparse_update_hybrid(
    coll: HybridEmbeddingCollection,
    params: dict,  # updated in place
    accs: dict,  # updated in place
    indices: torch.Tensor,  # [T, B*L]
    mask: torch.Tensor,  # [T, B*L]
    g_pooled: torch.Tensor,  # [B, T, D] in the caller's table order
    *,
    lr: float,
    optimizer: str = "sgd",
    eps: float = 1e-8,
    routed: bool = False,
    capacity_factor: float | None = None,
    return_stats: bool = False,
):
    """Apply the embedding optimizer step to both sets: the small set by
    the bucketed densified step, the big set by ``sparse_update``
    (``routed``: through the all-to-all routing).  Returns (params, accs),
    or with ``return_stats`` also the big set's count of dropped entries
    (0 off the routed path).  An int8 big set is refused."""
    if coll.big is not None and coll._big_quantized:
        raise ValueError(
            "sparse_update_hybrid: int8 big set is inference-only (gradient "
            "scatters cannot land in quantized rows) — train in f32/bf16 and "
            "quantize_tables for serving"
        )
    _check_sets(coll, optimizer, routed, "sparse_update_hybrid")
    params, accs = dict(params), dict(accs)
    with span("pel.sparse_update"):
        mask = mask.to(torch.bool)
        dropped = torch.zeros((), dtype=torch.int32, device=coll.device)
        if coll.small is not None:
            sel = coll._index["small_ids"]
            params["small"], accs["small"] = _mxu_sparse_update(
                coll.buckets, params["small"], accs["small"], indices[sel], mask[sel],
                g_pooled[:, sel], lr=lr, optimizer=optimizer, eps=eps, mesh=coll.mesh,
            )
        if coll.big is not None:
            sel = coll._index["big_ids"]
            params["big"], accs["big"], dropped = sparse_update(
                coll.big, params["big"], accs["big"], indices[sel], mask[sel],
                g_pooled[:, sel], lr=lr, optimizer=optimizer, eps=eps, routed=routed,
                capacity_factor=capacity_factor, return_stats=True,
            )
    if return_stats:
        return params, accs, dropped
    return params, accs


def sparse_update_hybrid_csr(
    coll: HybridEmbeddingCollection,
    params: dict,
    accs: dict,
    indices: torch.Tensor,  # [T, C]
    offsets: torch.Tensor,  # [T, B+1]
    g_pooled: torch.Tensor,  # [B, T, D] in the caller's table order
    *,
    lr: float,
    optimizer: str = "sgd",
    eps: float = 1e-8,
    routed: bool = False,
    data_sharded: bool = False,
    capacity_factor: float | None = None,
    return_stats: bool = False,
):
    """CSR (ragged-bag) form of ``sparse_update_hybrid``: the backward of
    ``lookup_csr``, with its ``data_sharded`` contract.  An int8 big set
    is refused."""
    if coll.big is not None and coll._big_quantized:
        raise ValueError("sparse_update_hybrid_csr: int8 big set is inference-only")
    _check_sets(coll, optimizer, routed, "sparse_update_hybrid_csr")
    params, accs = dict(params), dict(accs)
    dropped = torch.zeros((), dtype=torch.int32, device=coll.device)
    if coll.small is not None:
        sel = coll._index["small_ids"]
        params["small"], accs["small"] = _mxu_sparse_update_csr(
            coll.buckets, params["small"], accs["small"], indices[sel], offsets[sel],
            g_pooled[:, sel], lr=lr, optimizer=optimizer, eps=eps,
            mesh=coll.mesh if data_sharded else None,
        )
    if coll.big is not None:
        sel = coll._index["big_ids"]
        params["big"], accs["big"], dropped = sparse_update_csr(
            coll.big, params["big"], accs["big"], indices[sel], offsets[sel],
            g_pooled[:, sel], lr=lr, optimizer=optimizer, eps=eps, routed=routed,
            data_sharded=data_sharded, capacity_factor=capacity_factor,
            return_stats=True,
        )
    if return_stats:
        return params, accs, dropped
    return params, accs


def _mxu_sparse_update(buckets, fused, acc, indices, mask, g_pooled, *, lr,
                       optimizer, eps, mesh=None):
    """Small-set step over the dense wire: every kept entry of a bag gets
    the bag's cotangent (sum-pool backward), then the bucketed step.  On a
    mesh the whole batch's entries, gathered over the data axis."""
    if mesh is not None:
        indices = mesh.all_gather(indices, DATA_AXIS, 1)
        mask = mesh.all_gather(mask, DATA_AXIS, 1)
        g_pooled = mesh.all_gather(g_pooled.contiguous(), DATA_AXIS, 0)
    _, g_e, _ = _entry_updates(indices, mask, g_pooled.float(),
                               indices.shape[1] // g_pooled.shape[0])
    t, c = indices.shape
    return _mxu_apply_entries(buckets, fused, acc, indices, mask,
                              g_e.reshape(t, c, -1), lr=lr, optimizer=optimizer,
                              eps=eps)


def _mxu_sparse_update_csr(buckets, fused, acc, indices, offsets, g_pooled, *,
                           lr, optimizer, eps, mesh=None):
    """Small-set step over the CSR wire: bag cotangents gathered by segment
    id from the offsets.  With ``mesh`` (data-sharded windows) every
    window's entries, gathered over the data axis in data-row order."""
    _, g_e, valid = _entry_updates_csr(indices, offsets, g_pooled.float())
    t, c = indices.shape
    valid, g_e = valid.reshape(t, c), g_e.reshape(t, c, -1)
    if mesh is not None:
        indices = mesh.all_gather(indices, DATA_AXIS, 1)
        valid = mesh.all_gather(valid, DATA_AXIS, 1)
        g_e = mesh.all_gather(g_e, DATA_AXIS, 1)
    return _mxu_apply_entries(buckets, fused, acc, indices, valid, g_e, lr=lr,
                              optimizer=optimizer, eps=eps)


def _mxu_apply_entries(buckets, fused, acc, indices, mask, g_e, *, lr,
                       optimizer, eps):
    """Bucketed step over a per-entry cotangent stream (indices/mask
    [Ts, C], g_e [Ts, C, D]), in place.

    Per bucket the entries' cotangents are summed into a dense f32
    [G * npad, D] gradient by ``index_add_`` (the sums of the JAX package's
    f32 one-hot^T @ g_e at HIGHEST precision, without the one-hot), then
    every row steps once: w = (f32(w) - step).to(dtype), with
    step = lr * grad, or lr * rsqrt(acc + eps) * grad where acc first gains
    the densified per-entry mean_d(g^2).  In exact arithmetic this equals
    the big set's entry-wise step.  Masked entries add zeros at the
    bucket's first row, so their ids are never used."""
    d = g_e.shape[-1]
    adagrad = optimizer == "row_adagrad"
    for start, npad, lo, hi in buckets:
        g = hi - lo
        mk = mask[lo:hi]
        rows = (torch.arange(g, device=fused.device)[:, None] * npad
                + torch.where(mk, indices[lo:hi].long(), 0)).reshape(-1)  # [G*C]
        gk = torch.where(mk[..., None], g_e[lo:hi], 0.0).reshape(-1, d)
        grad = torch.zeros(g * npad, d, dtype=torch.float32, device=fused.device)
        grad.index_add_(0, rows, gk)
        w = fused[start : start + g * npad]
        if adagrad:
            sq = torch.zeros(g * npad, dtype=torch.float32, device=fused.device)
            sq.index_add_(0, rows, (gk * gk).mean(dim=-1))
            a = acc[start : start + g * npad]
            a.copy_(a + sq)
            step = (lr * torch.rsqrt(a + eps))[:, None] * grad
        else:
            step = lr * grad
        w.copy_((w.float() - step).to(fused.dtype))
    return fused, acc
