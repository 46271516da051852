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
warp several bags: :func:`row_path` picks 16-byte vector row loads or one
element a thread, and the group size, from the storage pointer and d;
:func:`walks_by_group` picks how ids reach the groups from L.

The plain version runs only for CPU tensors; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_STORAGE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_DIM = 1024
_LAUNCH_ARGS = [ctypes.c_void_p] * 4 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_VECTOR_BYTES = 16
_WARP = 32
_SIGNATURES = {
    "pel_gather_pool_f32": (_LAUNCH_ARGS, ctypes.c_int),
    "pel_gather_pool_bf16": (_LAUNCH_ARGS, ctypes.c_int),
    "pel_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _check_storage(storage, d):
    """Fused storage the kernels read: contiguous [S, 128] lane-packed or
    [N, d], f32 or bf16, with d-wide rows of at most _MAX_DIM lanes."""
    if storage.dim() != 2 or not storage.is_contiguous():
        raise ValueError(f"storage must be a contiguous 2-D tensor, got {tuple(storage.shape)}")
    if d < 1 or d > _MAX_DIM:
        raise ValueError(f"d={d} outside [1, {_MAX_DIM}]")
    width = storage.shape[1]
    if not (width == d or (width == 128 and 128 % d == 0)):
        raise ValueError(f"storage width {width} must be d={d}, or 128 with d | 128")
    if storage.dtype not in _STORAGE_DTYPES:
        raise TypeError(f"storage dtype {storage.dtype} not in {list(_STORAGE_DTYPES)}")


def row_path(storage: torch.Tensor, d: int) -> tuple[bool, int]:
    """How the pool kernels read ``d``-wide rows of ``storage``: (vector,
    group).  Rows load as 16-byte vectors where the row bytes and the
    storage pointer are 16-byte aligned, else one element at a time; a bag
    is pooled by ``group`` threads, one per chunk of the row (vector or
    element) rounded up to a power of two, at most a warp, so a warp pools
    32 / group bags."""
    row_bytes = d * storage.element_size()
    vector = row_bytes % _VECTOR_BYTES == 0 and storage.data_ptr() % _VECTOR_BYTES == 0
    chunks = row_bytes // _VECTOR_BYTES if vector else d
    return vector, min(_WARP, 1 << (chunks - 1).bit_length())


def walks_by_group(group: int, entries: int, bags: int) -> bool:
    """How the pool kernels bring ids to a warp tile's 32 / group bags: in
    windows of 32 entries shared by the warp (False), or each group along
    its own bag (True).  By group where a tile holds more than 32 entries on
    average (``entries`` over ``bags``, padding included), since a shared
    window over long bags leaves most groups idle."""
    return entries * (_WARP // group) > _WARP * bags


def _check(storage, d, indices, pooling, batch_size, mask):
    _check_storage(storage, d)
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


def embedding_bag_fixedl_reference(
    storage: torch.Tensor, d: int, indices: torch.Tensor, *,
    pooling: int, batch_size: int, mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K1: [batch_size, d] f32."""
    rows_all = storage.reshape(-1, d)
    ids = indices.long()
    if mask is not None:
        keep = mask.bool()
        ids = torch.where(keep, ids, 0)  # masked entries are not read
    rows = rows_all[ids].float()
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
) -> torch.Tensor:  # [B, d] f32
    """SUM-pooled fixed-L embedding bag over fused storage.  Unmasked ids
    must lie in [0, rows)."""
    _check(storage, d, indices, pooling, batch_size, mask)
    if storage.device.type == "cpu":
        return embedding_bag_fixedl_reference(
            storage, d, indices, pooling=pooling, batch_size=batch_size,
            mask=mask,
        )
    if storage.device.type != "cuda":
        raise ValueError(f"no kernel for device {storage.device}")
    out = torch.empty(batch_size, d, dtype=torch.float32, device=storage.device)
    if batch_size == 0:
        return out
    lib = _build.load("gather_pool", _SIGNATURES)
    fn = getattr(lib, f"pel_gather_pool_{_STORAGE_DTYPES[storage.dtype]}")
    stream = torch.cuda.current_stream(storage.device).cuda_stream
    vector, group = row_path(storage, d)
    by_group = walks_by_group(group, indices.numel(), batch_size)
    err = fn(
        storage.data_ptr(), indices.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        batch_size, pooling, d, vector, group, by_group, storage.device.index, stream,
    )
    if err != 0:
        msg = lib.pel_error_string(err).decode()
        raise RuntimeError(f"gather_pool launch failed: {msg} ({err})")
    embedding_bag_fixedl.launches += 1
    return out


embedding_bag_fixedl.launches = 0
