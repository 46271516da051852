"""The sparse optimizer step of an embedding collection on the dense wire
(row-wise AdaGrad or SGD), both sets of the hybrid in one call, and its
plain PyTorch version.

The step is the backward of a SUM-pooled lookup folded into the storage:
entry (t, c) of the [T, B*L] ids, where its mask is set, receives its bag's
cotangent ``g_pooled[c // L, t]``.  A table of the small set (the hybrid's
bucketed tables, in a storage of their own) steps densified: its entries'
cotangents and square means are summed a row, then every row of the set
steps once (:func:`densified_step`).  A table of the big set steps entry by
entry: every entry's mean_d(g^2) joins ``acc`` before any entry reads it,
then each adds -lr * rsqrt(acc[row] + eps) * g to its row
(:func:`apply_entries`).  SGD drops the accumulator.  The JAX package takes
both steps with XLA scatters; the port takes them with these same plain ops
on the routed path, under COLUMN and on the CSR wire
(``parallel/sparse_update.py``, ``parallel/hybrid.py``).

On the card the step is ``csrc/sparse_step.cu``: a memset of the small
set's workspace and two launches, for both sets, reading the caller's ids,
mask and cotangent in place (no per-set copies, no [T*B*L, D] expansion).
:class:`StepPlan` holds what it needs of a collection, built once: each
table's set, first row and padded rows, the order the launches take the
tables in, and on a mesh the big set's row shard (``row_shard``): a big
entry's fused row is kept only where this shard owns it, and then steps its
row of the shard's storage, the rule of ``parallel/collection.py``
``_owner_local``.  On a mesh the caller passes the whole batch, gathered
over the data axis.  Small tables whose sums fit shared memory (the rule of
:func:`privatized`; Kaggle's tables of 3-27 rows at d=16) are summed there
(``PRIVATE``), the others by global atomics.

The plain version (:func:`sparse_step_reference`) runs for CPU tensors: the
port's eager step, the same operations on the same values as the eager
step of the paths above, so that the CPU keeps its bits against the JAX
package.  A CUDA tensor launches the kernel or raises; it never falls back.
Its atomics add in an order that varies from run to run (as CUDA's
``index_add_`` does), so under ``torch.use_deterministic_algorithms(True)``
it raises (with ``warn_only=True``, warns), as PyTorch's own such ops do;
on a mesh the data replicas of a shard then agree within the bound of
recursive summation, not bit for bit.  ``sparse_step.launches`` counts the
steps launched on the card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import warnings

import torch

from . import _build

OPTIMIZERS = ("sgd", "row_adagrad")
PRIVATE, SMALL, BIG = 0, 1, 2  # a table's kind in the kernel's table
_WARPS = 8  # of a block of the kernel
_PRIVATE_BYTES = 32 << 10  # shared memory for a privatized table's copies, one a warp
_SHARED_BYTES = 48 << 10  # the same for one copy a block (the kernel's limit)
_STORAGE_DTYPES = (torch.float32, torch.bfloat16)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "pel_sparse_step": (
        [_P, _P, _P, _P, _P, _I, _I, _I, _L, _I, _I, _I,  # entries, tables
         _P, _I, _P, _L, _P, _I, _P, _L, _P,  # the sets, the workspace
         ctypes.c_float, ctypes.c_float, _I, _I, _I,  # step, the private sums
         _I, _I, _I, _I, _P],  # the row shard, the device
        ctypes.c_int),
    "pel_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


# -- the eager step (the plain version's parts, and the sharded paths') --------


def entry_updates(g_idx, mask, g_pooled, pooling):
    """Flatten [T, B*L] entries -> (ids [T*C], updates [T*C, D], valid
    [T*C]).  Each kept entry (t, b, l) receives its bag's full cotangent
    g_pooled[b, t] (the sum-pool backward); masked entries get zeros."""
    t, c = g_idx.shape
    b = c // pooling
    d = g_pooled.shape[-1]
    g_e = g_pooled.transpose(0, 1)[:, :, None, :].expand(t, b, pooling, d).reshape(t, c, d)
    g_e = g_e * mask[..., None].to(g_e.dtype)
    return g_idx.reshape(-1), g_e.reshape(t * c, d), mask.reshape(-1)


def _scatter_step(emb, local, step, keep):
    """Add per-entry steps [C, D] at local row ids ``local`` in the
    storage's dtype.  Lane-packed [S, 128] storage has the bytes of
    [rows, D], so one view serves both layouts; dropped entries add -0.0
    at row 0."""
    d = step.shape[-1]
    step = torch.where(keep[:, None], step, -0.0).to(emb.dtype)
    emb.view(-1, d).index_add_(0, torch.where(keep, local, 0), step)
    return emb


def apply_entries(emb, acc, local, updates, keep, *, lr, eps, use_adagrad, mean_sq=None):
    """Entry-wise step over a flat entry stream (local row ids [E], updates
    [E, D], kept [E]), in place.  Row AdaGrad adds every entry's
    mean_d(g^2) (through ``mean_sq`` where the dims are split) into
    ``acc`` before any entry reads it, then steps each entry by
    -lr * rsqrt(acc[row] + eps) * g_e.  Dropped entries add an exact
    identity at row 0: -0.0 to a weight (w + -0.0 == w for every w), 0.0
    to the non-negative accumulator."""
    local = local.long()
    if use_adagrad:
        sq = (updates * updates).mean(dim=-1)  # [E]
        if mean_sq is not None:
            sq = mean_sq(sq)
        safe = torch.where(keep, local, 0)
        acc.index_add_(0, safe, torch.where(keep, sq, 0.0))
        scale = lr * torch.rsqrt(acc[safe] + eps)  # [E]
        _scatter_step(emb, local, -scale[:, None] * updates, keep)
    else:
        _scatter_step(emb, local, -lr * updates, keep)
    return emb, acc


def densified_step(buckets, fused, acc, indices, mask, g_e, *, lr, optimizer, eps):
    """The small set's step over a per-entry cotangent stream
    (indices/mask [Ts, C] in small-set order, g_e [Ts, C, D]), in place.

    Per bucket (start, padded rows, first and last member) the entries'
    cotangents are summed into a dense f32 [G * npad, D] gradient by
    ``index_add_`` (the sums of the JAX package's f32 one-hot^T @ g_e at
    HIGHEST precision, without the one-hot), then every row steps once:
    w = (f32(w) - step).to(dtype), with step = lr * grad, or
    lr * rsqrt(acc + eps) * grad where acc first gains the densified
    per-entry mean_d(g^2).  In exact arithmetic this equals the big set's
    entry-wise step.  Masked entries add zeros at the bucket's first row,
    so their ids are never used."""
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


# -- the plan ------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """What the step needs of a collection, in the caller's table order.
    The small set (``small_ids``: caller tables in small-set order, with
    its ``buckets``) and the big set (``big_ids``) are those of
    ``parallel/hybrid.py``; a plain collection is all big set.  On a mesh
    ``row_shard`` is the big set's (shards, this shard, strided) under a
    row policy, and ``big_rows`` the rows of this shard."""

    dim: int
    kinds: tuple[int, ...]  # PRIVATE, SMALL or BIG, a caller table
    firsts: tuple[int, ...]  # its first row in its set's storage (fused row, big set)
    padded: tuple[int, ...]  # its padded rows (small set), 0 (big set)
    order: tuple[int, ...]  # the PRIVATE tables, then the SMALL, then the BIG
    small_rows: int
    big_rows: int
    buckets: tuple = ()
    small_ids: tuple[int, ...] = ()
    big_ids: tuple[int, ...] = ()
    row_shard: tuple[int, int, bool] | None = None
    # on the device: [T, 3] kind, first row, padded rows, then ``order``;
    # the sets' selections and the big set's offsets for the plain version
    tensors: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_tables(self) -> int:
        return len(self.kinds)

    def count(self, kind: int) -> int:
        return self.kinds.count(kind)

    @property
    def private_rows(self) -> int:
        return max((n for k, n in zip(self.kinds, self.padded) if k == PRIVATE), default=0)


def private_copies(dim: int) -> int:
    """Copies of a privatized table's [rows, dim + 1] f32 sums that a block
    of the kernel keeps in shared memory.  Rows narrower than 128 take a
    few lanes each, so a warp holds several entries at once: a copy a warp,
    whose groups add in turn with no atomics.  Wider rows take a whole warp
    an entry: one copy a block, which its warps add to by shared atomics.
    ``csrc/sparse_step.cu`` chooses its instance by the same rule, which
    the two must agree on."""
    return _WARPS if dim < 128 else 1


def privatized(padded_rows: int, dim: int) -> bool:
    """Whether a small table of ``padded_rows`` is summed in shared memory:
    its copies (:func:`private_copies`) fit ``_PRIVATE_BYTES``, one a warp,
    or ``_SHARED_BYTES``, one a block."""
    copies = private_copies(dim)
    budget = _PRIVATE_BYTES if copies == _WARPS else _SHARED_BYTES
    return copies * padded_rows * (dim + 1) * 4 <= budget


def make_plan(dim: int, device, *, small=None, big=None, row_shard=None) -> StepPlan:
    """The plan of a collection of ``dim``-wide tables on ``device``.
    ``small``: (caller ids in small-set order, first rows, buckets, rows of
    its storage); ``big``: (caller ids in big-set order, first fused rows,
    rows of its storage); either may be None.  ``row_shard``: the big
    set's (shards, this shard, strided) on a mesh under ROW / TABLE_WISE
    (strided False) or ROW_HASH (True), whose storage holds the shard's
    rows alone."""
    small_ids, small_firsts, buckets, small_rows = small or ((), (), (), 0)
    big_ids, big_firsts, big_rows = big or ((), (), 0)
    t = len(small_ids) + len(big_ids)
    kinds, firsts, padded = [BIG] * t, [0] * t, [0] * t
    for start, npad, lo, hi in buckets:
        for pos in range(lo, hi):
            table = small_ids[pos]
            kinds[table] = PRIVATE if privatized(npad, dim) else SMALL
            firsts[table], padded[table] = small_firsts[pos], npad
    for pos, table in enumerate(big_ids):
        firsts[table] = big_firsts[pos]
    order = tuple(sorted(range(t), key=lambda i: kinds[i]))  # stable: caller order within
    table = torch.tensor([*(x for row in zip(kinds, firsts, padded) for x in row), *order],
                         dtype=torch.int32, device=device)

    def longs(ids):
        return torch.tensor(ids, dtype=torch.long, device=device)

    return StepPlan(
        dim=dim, kinds=tuple(kinds), firsts=tuple(firsts), padded=tuple(padded), order=order,
        small_rows=small_rows, big_rows=big_rows, buckets=tuple(buckets),
        small_ids=tuple(small_ids), big_ids=tuple(big_ids),
        row_shard=None if row_shard is None else tuple(row_shard),
        tensors={"table": table, "small": longs(small_ids), "big": longs(big_ids),
                 "big_offsets": torch.tensor(big_firsts, dtype=torch.int32, device=device)})


# -- the step --------------------------------------------------------------------------


def _check(plan, small, big, indices, mask, g_pooled, optimizer):
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown embedding optimizer {optimizer!r}; expected one of "
                         f"{OPTIMIZERS}")
    if indices.dtype != torch.int32 or indices.dim() != 2:
        raise TypeError("indices must be a [T, B*L] int32 tensor")
    if mask.dtype != torch.bool or mask.shape != indices.shape:
        raise TypeError("mask must be a bool tensor of the indices' shape")
    if g_pooled.dtype != torch.float32 or g_pooled.dim() != 3:
        raise TypeError("g_pooled must be a [B, T, D] f32 tensor")
    t, c = indices.shape
    b = g_pooled.shape[0]
    if t != plan.num_tables or g_pooled.shape[1:] != (t, plan.dim) or (b and c % b):
        raise ValueError(f"indices {tuple(indices.shape)} and g_pooled "
                         f"{tuple(g_pooled.shape)} for {plan.num_tables} tables of dim "
                         f"{plan.dim}")
    tensors = [indices, mask, g_pooled]
    for name, part, ids, rows in (("small", small, plan.small_ids, plan.small_rows),
                                  ("big", big, plan.big_ids, plan.big_rows)):
        if (part is None) != (not ids):
            raise ValueError(f"the plan {'has' if ids else 'has no'} {name} set")
        if part is None:
            continue
        fused, acc = part
        if fused.dtype not in _STORAGE_DTYPES:
            raise TypeError(f"{name} storage dtype {fused.dtype} not in {_STORAGE_DTYPES}")
        if acc.dtype != torch.float32 or acc.dim() != 1:
            raise TypeError(f"{name} accumulator must be a 1-D f32 tensor")
        if fused.numel() != rows * plan.dim or acc.numel() != rows:
            raise ValueError(f"{name} storage of {fused.numel()} elements and accumulator of "
                             f"{acc.numel()} for {rows} rows of dim {plan.dim}")
        tensors += [fused, acc]
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("indices, mask, g_pooled, storages and accumulators must be "
                         "contiguous")
    device = indices.device
    for x in (*tensors, plan.tensors["table"]):
        if x.device != device:
            raise ValueError(f"tensor on {x.device}, indices on {device}")


def _owned(plan, ids, valid):
    """(row in the big set's storage, kept) of fused rows ``ids``: on one
    process every valid row inside the storage; on a row shard the valid
    rows it owns (``parallel/collection.py`` ``_owner_local``), at their
    row of the shard."""
    if plan.row_shard is None:
        return ids, valid & (ids >= 0) & (ids < plan.big_rows)
    shards, shard, strided = plan.row_shard
    rows = plan.big_rows
    if strided:
        owner, local = ids % shards, ids // shards
    else:
        owner = ids // rows
        local = ids - owner * rows
    return local, valid & (ids >= 0) & (owner == shard) & (local < rows)


def sparse_step_reference(plan, small, big, indices, mask, g_pooled, *, lr, optimizer, eps):
    """Plain PyTorch version of the step, in place: the small set's
    :func:`densified_step`, then the big set's :func:`apply_entries`, each
    over its tables' selection; a big entry outside the set's storage, or
    on a row shard one the shard does not own, is dropped."""
    pooling = indices.shape[1] // g_pooled.shape[0]
    sel = plan.tensors
    if small is not None:
        idx, mk = indices[sel["small"]], mask[sel["small"]]
        _, g_e, _ = entry_updates(idx, mk, g_pooled[:, sel["small"]], pooling)
        densified_step(plan.buckets, *small, idx, mk, g_e.reshape(*idx.shape, -1), lr=lr,
                       optimizer=optimizer, eps=eps)
    if big is not None:
        g_idx = indices[sel["big"]] + sel["big_offsets"][:, None]
        ids, updates, valid = entry_updates(g_idx, mask[sel["big"]], g_pooled[:, sel["big"]],
                                            pooling)
        local, keep = _owned(plan, ids, valid)
        apply_entries(*big, local, updates, keep, lr=lr, eps=eps,
                      use_adagrad=optimizer == "row_adagrad")


def _alert_not_deterministic():
    if not torch.are_deterministic_algorithms_enabled():
        return
    msg = ("sparse_step does not have a deterministic implementation, but you set "
           "'torch.use_deterministic_algorithms(True)'")
    if not torch.is_deterministic_algorithms_warn_only_enabled():
        raise RuntimeError(msg)
    warnings.warn(msg, stacklevel=3)


def _aligned(*tensors) -> bool:
    return all(x is None or x.data_ptr() % 16 == 0 for x in tensors)


def sparse_step(
    plan: StepPlan,
    small: tuple[torch.Tensor, torch.Tensor] | None,  # (storage, f32 accumulator), in place
    big: tuple[torch.Tensor, torch.Tensor] | None,  # the same of the big set
    indices: torch.Tensor,  # [T, B*L] int32 per-table ids, the caller's table order
    mask: torch.Tensor,  # [T, B*L] bool
    g_pooled: torch.Tensor,  # [B, T, D] f32 d(loss)/d(pooled SUM)
    *,
    lr: float,
    optimizer: str = "sgd",  # "sgd" | "row_adagrad"
    eps: float = 1e-8,
) -> None:
    """One optimizer step of both sets, in place.  Every tensor contiguous
    and on the plan's device; a storage f32 or bf16 ([rows, D], or
    lane-packed [S, 128]), its accumulator f32 [rows] (read only by
    row AdaGrad).  Masked ids may hold anything."""
    _check(plan, small, big, indices, mask, g_pooled, optimizer)
    if g_pooled.shape[0] == 0:
        return
    if indices.device.type == "cpu":
        sparse_step_reference(plan, small, big, indices, mask, g_pooled, lr=lr,
                              optimizer=optimizer, eps=eps)
        return
    if indices.device.type != "cuda":
        raise ValueError(f"no kernel for device {indices.device}")
    _alert_not_deterministic()
    d, (t, c) = plan.dim, indices.shape
    sw, sa = small if small is not None else (None, None)
    bw, ba = big if big is not None else (None, None)
    ws = (torch.empty(plan.small_rows * (d + 1), dtype=torch.float32, device=indices.device)
          if small is not None else None)
    vec = 4 if d % 4 == 0 and _aligned(g_pooled, sw, bw, ws) else 1
    shards, shard, strided = plan.row_shard or (0, 0, False)
    table = plan.tensors["table"]
    lib = _build.load("sparse_step", _SIGNATURES)
    err = lib.pel_sparse_step(
        indices.data_ptr(), mask.data_ptr(), g_pooled.data_ptr(), table.data_ptr(),
        table.data_ptr() + 3 * t * table.element_size(),
        plan.count(PRIVATE), plan.count(SMALL), plan.count(BIG), c, t,
        c // g_pooled.shape[0], d,
        None if sw is None else sw.data_ptr(), sw is not None and sw.dtype == torch.bfloat16,
        None if sa is None else sa.data_ptr(), plan.small_rows,
        None if bw is None else bw.data_ptr(), bw is not None and bw.dtype == torch.bfloat16,
        None if ba is None else ba.data_ptr(), plan.big_rows,
        None if ws is None else ws.data_ptr(), lr, eps, optimizer == "row_adagrad", vec,
        plan.private_rows, shards, shard, strided,
        indices.device.index, torch.cuda.current_stream(indices.device).cuda_stream)
    if err != 0:
        msg = lib.pel_error_string(err).decode()
        raise RuntimeError(f"sparse_step launch failed: {msg} ({err})")
    sparse_step.launches += 1


sparse_step.launches = 0  # steps launched on the card (a memset and two kernels each)
