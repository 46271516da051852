"""Fixed-L SUM gather+pool (kernel K1) and its plain PyTorch version.

Replaces the Pallas kernel ``_make_fixedl_kernel`` /
``pallas_embedding_bag_fixedl`` (pim_embedding_lookup_tpu/ops/
pallas_lookup.py:272-387), with the same signature: entry i of the
bag-major ``indices`` reads fused row ``indices[i]``, is kept where
``mask[i]`` is set, and bag b sums entries ``b*L .. b*L+L-1`` in f32.

On the card the kernel is ``csrc/gather_pool.cu``.  Its bound is bytes: per
entry one d-wide row plus a 4-byte id and a 1-byte mask, and per bag one
d-wide f32 output row.  It reads rows straight from the fused storage
(lane-packed [S, 128] storage has the bytes of [rows, d]) and skips masked
entries without reading them.  A group of threads pools each bag and a
warp several bags: :func:`row_load` picks how many bytes of a row a lane
loads at once (16; for int8 rows 8, or 4 for long bags; 0: one element a
thread) and :func:`group_size` the threads a bag, from the storage pointer
and d; :func:`walks_by_group` picks how ids reach the groups from L.  By
group the kernel drops masked entries before it issues row loads, so that
each batch of loads in flight is kept entries (the compacted walk); by
window, where a tile holds bags of at most 32 entries and the card
measured no gain from it, each entry's mask rides through the batches as
a flag.  Both sum a bag's kept entries in entry order.  A caller may pin
the three with ``path=(load, group, by_group)`` (a :class:`KernelPath`, the
counterpart of the Pallas kernels' ``tile_b``/``nbuf``;
``tools/kernel_lab.py`` sweeps them): :func:`kernel_path` refuses a path
the kernel cannot serve, and a pinned path on a CPU tensor, which has no
kernel.

int8 storage (the capacity mode's codes) has its own instances: the codes
are pooled in f32, and with a 1-D f32 ``scale`` of one value a row (the
"row" scale mode) each entry adds code * scale[id]; without one ("table"
mode) the caller folds the table's scale into the pooled output.  A lane
loads 8 codes (two float4 stores of their sums; d/8 threads a bag) where
bags are short, and 4 codes as one 32-bit word (one float4; d/4 threads)
where they are long (:func:`fitted_path` pins either).  The JAX package
gathers int8 dict storage with XLA (its ``_gather_f32``);
``int8_launches`` and ``int8_row_launches`` count these launches.

The plain version runs only for CPU tensors; a CUDA tensor launches the
kernel or raises.  Where the storage requires grad (and grad mode is on),
the wrapper is differentiable w.r.t. the storage: the forward is the same
call, the backward the transpose of the gather, an ``index_add_`` of each
kept entry's bag gradient at its row (XLA's work in the JAX package, not a
Pallas kernel).  Without grad no autograd node is made; int8 storage
cannot require grad, and its scale gets no gradient.

``round_bf16`` gives the hybrid's small set its values: each entry adds
f32(bf16(w[id])), what the JAX package's bf16 one-hot product gives (one
nonzero term an output row), so at L=1 a pooled row is the product's bit
for bit.  f32 storage launches an instance of its own, which rounds each
loaded element to bf16 (nearest, ties to even) before its add
(``bf16_round_launches`` counts it); bf16 storage needs no rounding and
launches the bf16 instance.  Under grad the storage gradient is the
product's: each entry's cotangent rounded to bf16, the sums a row gets
rounded to bf16.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

_STORAGE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}
_MAX_DIM = 1024
_LAUNCH_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [
    ctypes.c_void_p]
# the row loads (bytes a lane loads at once) each storage dtype's kernels
# have besides 0, one element a lane
_LOADS = {torch.float32: (16,), torch.bfloat16: (16,), torch.int8: (4, 8)}
_WARP = 32
_SIGNATURES = {
    "pel_gather_pool_f32": (_LAUNCH_ARGS, ctypes.c_int),
    "pel_gather_pool_f32_bf16r": (_LAUNCH_ARGS, ctypes.c_int),
    "pel_gather_pool_bf16": (_LAUNCH_ARGS, ctypes.c_int),
    # int8: the scale pointer (or NULL) after the storage's
    "pel_gather_pool_i8": ([ctypes.c_void_p] + _LAUNCH_ARGS, ctypes.c_int),
    "pel_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


class KernelPath(NamedTuple):
    """How a pool kernel launch reads rows and ids."""

    load: int  # bytes of a row a lane loads at once; 0: one element (the scalar path)
    group: int  # threads a bag, a power of two in [1, 32]
    by_group: bool  # ids along each bag (True) or in windows shared by the warp


def _check_storage(storage, d, scale=None):
    """Fused storage the kernels read: contiguous [S, 128] lane-packed or
    [N, d], f32, bf16 or int8, with d-wide rows of at most _MAX_DIM lanes;
    and the optional per-row scale of int8 storage, contiguous 1-D f32 of
    one value a d-wide row."""
    if storage.dim() != 2 or not storage.is_contiguous():
        raise ValueError(f"storage must be a contiguous 2-D tensor, got {tuple(storage.shape)}")
    if d < 1 or d > _MAX_DIM:
        raise ValueError(f"d={d} outside [1, {_MAX_DIM}]")
    width = storage.shape[1]
    if not (width == d or (width == 128 and 128 % d == 0)):
        raise ValueError(f"storage width {width} must be d={d}, or 128 with d | 128")
    if storage.dtype not in _STORAGE_DTYPES:
        raise TypeError(f"storage dtype {storage.dtype} not in {list(_STORAGE_DTYPES)}")
    if scale is None:
        return
    if storage.dtype != torch.int8:
        raise TypeError(f"a per-row scale goes with int8 storage, not {storage.dtype}")
    if scale.dtype != torch.float32 or scale.dim() != 1 or not scale.is_contiguous():
        raise TypeError("scale must be a contiguous 1-D f32 tensor")
    if scale.numel() != storage.numel() // d or scale.device != storage.device:
        raise ValueError(f"scale of {scale.numel()} rows on {scale.device} for "
                         f"{storage.numel() // d} rows on {storage.device}")


def _aligned(storage: torch.Tensor, d: int, load: int) -> bool:
    """Whether ``d``-wide rows of ``storage`` take ``load``-byte loads: the
    row bytes and the storage pointer are multiples of ``load``."""
    return d * storage.element_size() % load == 0 and storage.data_ptr() % load == 0


def row_load(storage: torch.Tensor, d: int, entries: int = 1, bags: int = 1) -> int:
    """The bytes of a ``d``-wide row of ``storage`` a pool kernel's lane
    loads at once, for ``entries`` ids in ``bags`` bags (default: single
    hot), where the row bytes and the storage pointer are that aligned:
    16 for f32 and bf16 rows (4 or 8 lanes); for int8 rows 8 (8 codes, two
    float4 stores a lane) where a tile of that group walks by window, and 4
    (4 codes, one float4 store) where its bags are long enough to walk by
    group, since more threads a bag run more of its chain of loads at once
    (H100: at L=1 the 8-byte loads were the fastest int8 path, at L=120 the
    4-byte ones; at L = 2, 3, 4, 8 and 16, d = 16 and 64, this rule's pick
    was within 2.4 % of the faster load, ``PERF_APPENDIX.md``); else 0,
    one element a lane (the scalar path)."""
    if storage.dtype != torch.int8:
        return 16 if _aligned(storage, d, 16) else 0
    if _aligned(storage, d, 8) and not walks_by_group(group_size(storage, d, 8), entries, bags):
        return 8
    return 4 if _aligned(storage, d, 4) else 0


def group_size(storage: torch.Tensor, d: int, load: int) -> int:
    """The threads a bag gets on a row path: one per chunk of the row
    (``load`` bytes, or an element where ``load`` is 0), rounded up to a
    power of two, at most a warp."""
    chunks = d * storage.element_size() // load if load else d
    return min(_WARP, 1 << (chunks - 1).bit_length())


def walks_by_group(group: int, entries: int, bags: int) -> bool:
    """How the pool kernels bring ids to a warp tile's 32 / group bags: in
    windows of 32 entries shared by the warp (False), or each group along
    its own bag (True).  By group where a tile holds more than 32 entries on
    average (``entries`` over ``bags``, padding included), since a shared
    window over long bags leaves most groups idle."""
    return entries * (_WARP // group) > _WARP * bags


def kernel_path(storage: torch.Tensor, d: int, entries: int, bags: int,
                path: tuple | None = None) -> KernelPath:
    """The :class:`KernelPath` of a pool kernel's launch over ``entries``
    ids in ``bags`` bags: what :func:`row_load`, :func:`group_size` and
    :func:`walks_by_group` pick, or ``path`` where the caller pins one
    (``(load, group, by_group)``).  Raises ``ValueError`` for a pinned
    path the kernels cannot serve: one of other than those three fields, a
    group that is not a power of two in [1, 32], a row load the storage
    dtype's kernels do not have (f32 and bf16: 16; int8: 4 and 8) or whose
    bytes the rows or the storage pointer are not aligned to, or any path
    on a tensor that is not on a CUDA device (the plain version has no
    path)."""
    if path is None:
        load = row_load(storage, d, entries, bags)
        group = group_size(storage, d, load)
        return KernelPath(load, group, walks_by_group(group, entries, bags))
    if len(path) != len(KernelPath._fields):
        raise ValueError(f"a kernel path is (load, group, by_group), got {tuple(path)}")
    load, group, by_group = path
    if not 1 <= group <= _WARP or group & (group - 1):
        raise ValueError(f"group {group} is not a power of two in [1, {_WARP}]")
    if load != 0 and load not in _LOADS[storage.dtype]:
        raise ValueError(f"row loads of {load} bytes: the {storage.dtype} kernels load "
                         f"{_LOADS[storage.dtype]} bytes or one element (0)")
    if load and not _aligned(storage, d, load):
        raise ValueError(f"{load}-byte row loads need {load}-byte aligned rows and storage: "
                         f"d={d} of {storage.dtype} at {storage.data_ptr():#x}")
    if storage.device.type != "cuda":
        raise ValueError(f"a kernel path was pinned for a tensor on {storage.device}: "
                         "only the card's kernels have paths")
    return KernelPath(int(load), int(group), bool(by_group))


def fitted_path(storage: torch.Tensor, d: int, entries: int, bags: int,
                load: int) -> KernelPath:
    """The path that loads ``load`` bytes of a row a lane where the rows
    and the storage pointer take it, else the scalar path, with the group
    and walk the kernels pick for that load: a pin for :func:`kernel_path`
    (int8 rows' 8- and 4-byte loads, each at any bag length)."""
    if not _aligned(storage, d, load):
        load = 0
    group = group_size(storage, d, load)
    return KernelPath(load, group, walks_by_group(group, entries, bags))


def _check(storage, d, indices, pooling, batch_size, mask, scale):
    _check_storage(storage, d, scale)
    if indices.dtype != torch.int32 or indices.dim() != 1 or not indices.is_contiguous():
        raise TypeError("indices must be a contiguous 1-D int32 tensor")
    if pooling < 1 or batch_size < 0:
        raise ValueError(f"pooling={pooling}, batch_size={batch_size}")
    if indices.numel() != batch_size * pooling:
        raise ValueError(
            f"len(indices)={indices.numel()} != batch_size*pooling={batch_size * pooling}"
        )
    tensors = [indices]
    if mask is not None:
        if mask.dtype not in (torch.bool, torch.uint8) or mask.dim() != 1:
            raise TypeError("mask must be a 1-D bool or uint8 tensor")
        if mask.numel() != indices.numel() or not mask.is_contiguous():
            raise ValueError("mask must be contiguous and as long as indices")
        tensors.append(mask)
    for t in tensors:
        if t.device != storage.device:
            raise ValueError(f"tensor on {t.device}, storage on {storage.device}")


def _ptr(t):
    """A tensor's device pointer, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def gather_rows(storage: torch.Tensor, d: int, ids: torch.Tensor,
                scale: torch.Tensor | None = None) -> torch.Tensor:
    """Rows ``ids`` (int64) of d-wide storage in f32; int8 codes times
    their rows' ``scale`` where one is given."""
    rows = storage.reshape(-1, d).index_select(0, ids).float()
    if scale is not None:
        rows = rows * scale.index_select(0, ids)[:, None]
    return rows


def embedding_bag_fixedl_reference(
    storage: torch.Tensor, d: int, indices: torch.Tensor, *,
    pooling: int, batch_size: int, mask: torch.Tensor | None = None,
    scale: torch.Tensor | None = None, round_bf16: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of K1: [batch_size, d] f32."""
    ids = indices.long()
    if mask is not None:
        keep = mask.bool()
        ids = torch.where(keep, ids, 0)  # masked entries are not read
    rows = gather_rows(storage, d, ids, scale)
    if round_bf16:
        rows = rows.to(torch.bfloat16).float()
    if mask is not None:
        rows = torch.where(keep[:, None], rows, 0.0)
    return rows.reshape(batch_size, pooling, d).sum(dim=1)


def embedding_bag_fixedl(
    storage: torch.Tensor,  # [S, 128] packed, or [N, d]
    d: int,
    indices: torch.Tensor,  # [B*L] int32 fused row ids, bag-major
    *,
    pooling: int,
    batch_size: int,
    mask: torch.Tensor | None = None,  # [B*L] bool/uint8
    scale: torch.Tensor | None = None,  # [rows] f32, with int8 storage only
    path: tuple | None = None,  # pinned KernelPath (load, group, by_group)
    round_bf16: bool = False,  # each entry adds f32(bf16(w)): f32 or bf16 storage
) -> torch.Tensor:  # [B, d] f32
    """SUM-pooled fixed-L embedding bag over fused storage.  Unmasked ids
    must lie in [0, rows).  ``scale``: int8 storage's per-row scale.
    ``path``: the kernel path to launch (:func:`kernel_path`), CUDA only.
    ``round_bf16``: rows rounded to bf16 as they are added (the module
    docstring)."""
    _check(storage, d, indices, pooling, batch_size, mask, scale)
    if round_bf16 and storage.dtype == torch.int8:
        raise TypeError("round_bf16 rounds float rows: int8 storage has codes")
    if storage.requires_grad and torch.is_grad_enabled():
        return _FixedLBagSum.apply(storage, d, indices, pooling, batch_size, mask, path,
                                   round_bf16)
    return _pool(storage, d, indices, pooling, batch_size, mask, scale, path, round_bf16)


def _pool(storage, d, indices, pooling, batch_size, mask, scale=None, path=None,
          round_bf16=False):
    """Checked K1 body: the plain version for CPU tensors, else one launch
    on ``path`` (:func:`kernel_path`)."""
    if path is not None and path[2] and pooling == 1:
        raise ValueError("a single-hot tile is one window: K1 has no by-group walk at L=1")
    path = kernel_path(storage, d, indices.numel(), batch_size, path)
    if storage.device.type == "cpu":
        return embedding_bag_fixedl_reference(
            storage, d, indices, pooling=pooling, batch_size=batch_size,
            mask=mask, scale=scale, round_bf16=round_bf16,
        )
    if storage.device.type != "cuda":
        raise ValueError(f"no kernel for device {storage.device}")
    out = torch.empty(batch_size, d, dtype=torch.float32, device=storage.device)
    if batch_size == 0:
        return out
    lib = _build.load("gather_pool", _SIGNATURES)
    rounds = round_bf16 and storage.dtype == torch.float32  # bf16 rows need no rounding
    fn = getattr(lib, f"pel_gather_pool_{_STORAGE_DTYPES[storage.dtype]}"
                      + ("_bf16r" if rounds else ""))
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    int8 = storage.dtype == torch.int8
    lead = (storage.data_ptr(),) + ((_ptr(scale),) if int8 else ())
    err = fn(
        *lead, indices.data_ptr(), _ptr(mask), out.data_ptr(), batch_size, pooling, d,
        *path, storage.device.index, stream,
    )
    if err != 0:
        msg = lib.pel_error_string(err).decode()
        raise RuntimeError(f"gather_pool launch failed: {msg} ({err})")
    embedding_bag_fixedl.launches += 1
    embedding_bag_fixedl.int8_launches += int8
    embedding_bag_fixedl.int8_row_launches += scale is not None
    embedding_bag_fixedl.bf16_round_launches += rounds
    return out


embedding_bag_fixedl.launches = 0
embedding_bag_fixedl.int8_launches = 0  # int8 storage, either scale mode
embedding_bag_fixedl.int8_row_launches = 0  # int8 storage with a per-row scale
embedding_bag_fixedl.bf16_round_launches = 0  # f32 storage rounded to bf16 (round_bf16)


def embedding_bag_fixedl_grad(
    g: torch.Tensor,  # [B, d] d(loss)/d(pooled)
    indices: torch.Tensor,  # [B*L] int32 fused row ids, bag-major
    mask: torch.Tensor | None,  # [B*L] bool/uint8
    num_rows: int,
    round_bf16: bool = False,
) -> torch.Tensor:  # [num_rows, d] f32
    """The transpose of K1's gather: ``g[bag(e)] * mask[e]`` added at row
    ``indices[e]`` of a zeroed f32 gradient.  Masked entries add an exact
    zero at row 0, so their ids are never used.  ``round_bf16``: the bf16
    one-hot product's transpose, each entry's cotangent rounded to bf16
    and each row's f32 sum rounded to bf16."""
    b, d = g.shape
    pooling = indices.numel() // max(b, 1)
    g = g.to(torch.bfloat16) if round_bf16 else g
    g_e = g.float()[:, None, :].expand(b, pooling, d).reshape(-1, d)  # [B*L, d]
    ids = indices.long()
    if mask is not None:
        keep = mask.bool()
        g_e = g_e * keep[:, None]
        ids = torch.where(keep, ids, 0)
    dtable = torch.zeros(num_rows, d, dtype=torch.float32, device=g.device)
    dtable.index_add_(0, ids, g_e)
    return dtable.to(torch.bfloat16).float() if round_bf16 else dtable


class _FixedLBagSum(torch.autograd.Function):
    """K1 with its gradient w.r.t. the storage only."""

    @staticmethod
    def forward(ctx, storage, d, indices, pooling, batch_size, mask, path, round_bf16):
        ctx.save_for_backward(indices, mask)
        ctx.shape, ctx.dtype, ctx.round_bf16 = storage.shape, storage.dtype, round_bf16
        return _pool(storage, d, indices, pooling, batch_size, mask, path=path,
                     round_bf16=round_bf16)

    @staticmethod
    def backward(ctx, g):
        indices, mask = ctx.saved_tensors
        rows = ctx.shape.numel() // g.shape[1]
        dtable = embedding_bag_fixedl_grad(g, indices, mask, rows, ctx.round_bf16)
        return (dtable.to(ctx.dtype).view(ctx.shape),) + (None,) * 7
