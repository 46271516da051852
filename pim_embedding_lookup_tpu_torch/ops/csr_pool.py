"""CSR SUM gather+pool (kernels K2 and K3), the differentiable CSR bag
(kernel K4, forward and backward), and their plain PyTorch versions.

Replaces the Pallas kernels of pim_embedding_lookup_tpu/ops/pallas_lookup.py:
``pallas_embedding_bag_csr_packed`` (:390, body ``_make_packed_kernel`` :92)
for K2, ``_make_kernel`` (:48) for full-width rows (K3), and
``pallas_embedding_bag_csr`` (:251) with its custom VJP ``_bag_sum`` /
``_bag_sum_bwd`` (:204-245) for K4.  Bag b owns entries
``[offsets[b], offsets[b+1])``; entries at or past ``offsets[B]`` are
padding, never read.  Offsets must satisfy ``0 = off[0] <= ... <= off[B] <=
C``; they are not checked on the card (that would wait for it).

On the card all three are ``csrc/csr_pool.cu``, bound by bytes: one kernel
serves K2, K3 and K4's forward, walking each bag's own offsets with no
atomics.  A group of threads pools each bag (16-byte row loads or one
element a thread, as ``gather_pool.row_path`` picks from the storage
pointer and d), and a warp several consecutive bags whose offsets it loads
together; their ids come in windows shared by the warp, or along each bag
where bags are long (``gather_pool.walks_by_group``, from C / B).  A
second kernel scatters K4's gradient with f32 ``atomicAdd``, one thread
per (bag, lane).  The wrappers take T tables at once (indices [T, C],
offsets [T, B+1]), one launch for all of them.

The plain versions run only for CPU tensors; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .gather_pool import _MAX_DIM, _STORAGE_DTYPES, _check_storage, row_path, walks_by_group
from .ragged import segment_ids_from_offsets

_LAUNCH_ARGS = [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
# the pool kernels also take the row path and the walk, after d: vector,
# group and by_group
_POOL_ARGS = _LAUNCH_ARGS[:8] + [ctypes.c_int] * 3 + _LAUNCH_ARGS[8:]
_SIGNATURES = {
    "pel_csr_pool_f32": (_POOL_ARGS, ctypes.c_int),
    "pel_csr_pool_bf16": (_POOL_ARGS, ctypes.c_int),
    "pel_csr_grad_f32": (_LAUNCH_ARGS, ctypes.c_int),
    "pel_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def _check_csr(indices, offsets, batch_size, device):
    for name, t in (("indices", indices), ("offsets", offsets)):
        if t.dtype != torch.int32 or t.dim() not in (1, 2) or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-D or 2-D int32 tensor")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, expected {device}")
    if indices.dim() != offsets.dim() or indices.shape[:-1] != offsets.shape[:-1]:
        raise ValueError(f"indices {tuple(indices.shape)} and offsets "
                         f"{tuple(offsets.shape)} must be [C], [B+1] or [T, C], [T, B+1]")
    if batch_size < 0 or offsets.shape[-1] != batch_size + 1:
        raise ValueError(f"offsets hold {offsets.shape[-1]} boundaries for "
                         f"batch_size={batch_size}")


def _as_2d(indices, offsets):
    return indices.reshape(-1, indices.shape[-1]), offsets.reshape(-1, offsets.shape[-1])


def _launch(fn_name, src, indices, offsets, out, batch_size, d, *path):
    """One launch of a csr_pool.cu kernel over [T, C] ids and [T, B+1]
    offsets on ``src``'s device and current stream; ``path`` is the pool
    kernels' (vector, group, by_group)."""
    if src.device.type != "cuda":
        raise ValueError(f"no kernel for device {src.device}")
    idx2, off2 = _as_2d(indices, offsets)
    lib = _build.load("csr_pool", _SIGNATURES)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    err = getattr(lib, fn_name)(
        src.data_ptr(), idx2.data_ptr(), off2.data_ptr(), out.data_ptr(),
        idx2.shape[0], batch_size, idx2.shape[1], d, *path, src.device.index, stream,
    )
    if err != 0:
        msg = lib.pel_error_string(err).decode()
        raise RuntimeError(f"{fn_name} launch failed: {msg} ({err})")


def _segments(indices, offsets, batch_size):
    """[T, C] ids -> (fused segment ids t*(B+1) + min(seg, B), valid mask),
    both [T*C]."""
    idx2, off2 = _as_2d(indices, offsets)
    t, c = idx2.shape
    seg = segment_ids_from_offsets(off2, c).long()  # [T, C] in [0, B]
    base = torch.arange(t, device=seg.device)[:, None] * (batch_size + 1)
    return (base + seg).reshape(-1), (seg < batch_size).reshape(-1)


# -- K2 / K3: CSR gather+pool over fused storage --------------------------------


def embedding_bag_csr_packed_reference(
    storage: torch.Tensor, d: int, indices: torch.Tensor, offsets: torch.Tensor,
    *, batch_size: int,
) -> torch.Tensor:
    """Plain PyTorch version of K2/K3: ``index_select`` plus ``index_add_``
    over the segment ids.  [B, d] f32, or [T*B, d] for [T, C] indices."""
    t = 1 if indices.dim() == 1 else indices.shape[0]
    fseg, valid = _segments(indices, offsets, batch_size)
    ids = torch.where(valid, indices.reshape(-1).long(), 0)  # padding not read
    rows = storage.reshape(-1, d).index_select(0, ids).float()
    rows = torch.where(valid[:, None], rows, 0.0)
    out = torch.zeros(t * (batch_size + 1), d, dtype=torch.float32,
                      device=storage.device)
    out.index_add_(0, fseg, rows)
    return out.reshape(t, batch_size + 1, d)[:, :batch_size].reshape(-1, d)


def _pool(storage, d, indices, offsets, batch_size):
    """Checked K2/K3 body: the plain version for CPU tensors, else one
    launch.  Returns (out, whether a kernel was launched)."""
    _check_storage(storage, d)
    _check_csr(indices, offsets, batch_size, storage.device)
    if storage.device.type == "cpu":
        return embedding_bag_csr_packed_reference(
            storage, d, indices, offsets, batch_size=batch_size), False
    t = 1 if indices.dim() == 1 else indices.shape[0]
    out = torch.empty(t * batch_size, d, dtype=torch.float32, device=storage.device)
    if out.numel() == 0:
        return out, False
    vector, group = row_path(storage, d)
    by_group = walks_by_group(group, indices.shape[-1], batch_size)
    _launch(f"pel_csr_pool_{_STORAGE_DTYPES[storage.dtype]}", storage, indices,
            offsets, out, batch_size, d, vector, group, by_group)
    return out, True


def embedding_bag_csr_packed(
    storage: torch.Tensor,  # [S, 128] packed, or [N, d]
    d: int,
    indices: torch.Tensor,  # [C] or [T, C] int32 fused row ids
    offsets: torch.Tensor,  # [B+1] or [T, B+1] int32
    *,
    batch_size: int,
) -> torch.Tensor:  # [B, d] or [T*B, d] f32
    """SUM-pooled CSR embedding bag over fused storage (K2; K3 at d=128).
    Row t*B + b of the result pools bag b of table t.  Valid ids must lie
    in [0, rows)."""
    out, launched = _pool(storage, d, indices, offsets, batch_size)
    embedding_bag_csr_packed.launches += launched
    return out


embedding_bag_csr_packed.launches = 0


# -- K4: the differentiable CSR bag ---------------------------------------------


def embedding_bag_csr_grad_reference(
    g: torch.Tensor, indices: torch.Tensor, offsets: torch.Tensor, num_rows: int,
) -> torch.Tensor:
    """Plain PyTorch version of K4's backward: dtable[idx[e]] += g[seg(e)]
    over the valid entries, by ``index_add_``.  [num_rows, D] f32."""
    b = offsets.shape[-1] - 1
    fseg, valid = _segments(indices, offsets, b)
    t = fseg.numel() // indices.shape[-1]
    g_rows = torch.cat([g.reshape(t, b, -1),
                        g.new_zeros(t, 1, g.shape[-1])], dim=1).reshape(-1, g.shape[-1])
    dtable = torch.zeros(num_rows, g.shape[-1], dtype=torch.float32, device=g.device)
    ids = torch.where(valid, indices.reshape(-1).long(), 0)
    dtable.index_add_(0, ids, g_rows.index_select(0, fseg).float())  # padding adds 0
    return dtable


def embedding_bag_csr_grad(
    g: torch.Tensor,  # [B, D] or [T*B, D] f32
    indices: torch.Tensor,  # [C] or [T, C] int32
    offsets: torch.Tensor,  # [B+1] or [T, B+1] int32
    num_rows: int,
) -> torch.Tensor:  # [num_rows, D] f32
    """K4's backward: the dense table gradient of the SUM bag."""
    _check_csr(indices, offsets, offsets.shape[-1] - 1, g.device)
    t = 1 if indices.dim() == 1 else indices.shape[0]
    b = offsets.shape[-1] - 1
    if g.dtype != torch.float32 or g.dim() != 2 or not g.is_contiguous():
        raise TypeError("g must be a contiguous 2-D f32 tensor")
    if g.shape[0] != t * b or g.shape[1] > _MAX_DIM:
        raise ValueError(f"g {tuple(g.shape)} for {t} tables x {b} bags")
    if g.device.type == "cpu":
        return embedding_bag_csr_grad_reference(g, indices, offsets, num_rows)
    dtable = torch.zeros(num_rows, g.shape[1], dtype=torch.float32, device=g.device)
    if g.numel() == 0:
        return dtable
    _launch("pel_csr_grad_f32", g, indices, offsets, dtable, b, g.shape[1])
    embedding_bag_csr_grad.launches += 1
    return dtable


embedding_bag_csr_grad.launches = 0


class _CSRBagSum(torch.autograd.Function):
    """SUM bag over [N, D] storage with its gradient w.r.t. the table only."""

    @staticmethod
    def forward(ctx, table, indices, offsets, batch_size):
        # the kernel reads f32 or bf16 and adds in f32; other floats go
        # through f32, as the JAX kernel casts its table to f32
        src = table if table.dtype in _STORAGE_DTYPES else table.float()
        out, launched = _pool(src, src.shape[1], indices, offsets, batch_size)
        embedding_bag_csr_sum.launches += launched
        ctx.save_for_backward(indices, offsets)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype
        return out.to(table.dtype)

    @staticmethod
    def backward(ctx, g):
        indices, offsets = ctx.saved_tensors
        dtable = embedding_bag_csr_grad(
            g.float().contiguous(), indices, offsets, ctx.table_shape[0])
        return dtable.to(ctx.table_dtype), None, None, None


def embedding_bag_csr_sum(
    table: torch.Tensor,  # [N, D] float
    indices: torch.Tensor,  # [C] int
    offsets: torch.Tensor,  # [B+1] int
    *,
    batch_size: int,
) -> torch.Tensor:  # [B, D] in the table's dtype
    """Differentiable SUM-pooled CSR embedding bag (K4).  The forward is
    the CSR kernel on [N, D] storage; the backward scatters the output's
    gradient into a dense table gradient.  Ids and offsets get none."""
    if table.dim() != 2 or not table.is_floating_point():
        raise TypeError(f"table must be a 2-D float tensor, got {table.dtype} "
                        f"{tuple(table.shape)}")
    if indices.dim() != 1 or offsets.dim() != 1:
        raise ValueError("indices [C] and offsets [B+1] must be 1-D")
    return _CSRBagSum.apply(
        table.contiguous(), indices.to(torch.int32).contiguous(),
        offsets.to(torch.int32).contiguous(), batch_size)


embedding_bag_csr_sum.launches = 0
