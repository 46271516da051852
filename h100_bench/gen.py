"""Every input of a run, made from ``--seed``.

Table rows come from a counter-based hash, so that any row is a function
of (seed, table, row) alone: the program's storage is filled on the device
in whatever layout it keeps, and the reference makes again only the rows a
batch touches.  Rows follow the dlrm EmbeddingBag init, uniform(-1/sqrt(n),
1/sqrt(n)) for a table of n rows.  MLP weights, dense features, ids and
labels come from ``torch.Generator``s seeded from the same seed, one a
tensor group, so each of them is made again the same on the same device.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B1
# 32-bit multipliers under 2**31: a product with a 32-bit value stays
# inside int64, so CPU and card compute the same bits
_MUL1, _MUL2 = 0x7FEB352D, 0x2C1B3C6D
ROW_CHUNK_ELEMENTS = 1 << 21  # values hashed a call when a storage is filled: its
# int64 temporaries stay near 100 MB, under the program's own footprint


def mix_int(x: int) -> int:
    """The 32-bit finaliser of ``mix`` on a Python int."""
    x &= M32
    x ^= x >> 16
    x = (x * _MUL1) & M32
    x ^= x >> 15
    x = (x * _MUL2) & M32
    return x ^ (x >> 16)


def mix(x: torch.Tensor) -> torch.Tensor:
    """The 32-bit finaliser on an int64 tensor of values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL1) & M32
    x = x ^ (x >> 15)
    x = (x * _MUL2) & M32
    return x ^ (x >> 16)


def key(seed: int, *words: int) -> int:
    """A 32-bit stream key of ``seed`` (any non-negative int) and words."""
    h = mix_int(seed & M32) ^ mix_int((seed >> 32) + 0x5BD1E995)
    for w in words:
        h = mix_int(h ^ mix_int(w + 0x68E31DA4))
    return h


def generator(seed: int, device, *words: int) -> torch.Generator:
    """A torch generator on ``device`` for one stream of the seed."""
    return torch.Generator(device=device).manual_seed(key(seed, *words))


def row_bound(num_rows: int) -> float:
    return 1.0 / math.sqrt(num_rows)


def bf16_exact(cfg: dict, table: int) -> bool:
    """Whether table ``table`` of the configuration holds bf16 values: one
    of at most ``small_set_max_rows`` rows."""
    return cfg["tables"][table] <= cfg["small_set_max_rows"]


def _rows(k1, k2, bound, bf16, rows: torch.Tensor, dim: int) -> torch.Tensor:
    """f32 [N, dim] rows ``rows`` of the tables whose keys, bounds and
    bf16 flags are ``k1``, ``k2``, ``bound`` and ``bf16`` (ints, a float and
    a bool, or [N] tensors)."""
    if isinstance(k2, torch.Tensor):
        k2, bound, bf16 = k2[:, None], bound[:, None], bf16[:, None]
    else:  # the same f32 product as the tensor form
        bound = torch.tensor(bound, dtype=torch.float32, device=rows.device)
        bf16 = torch.tensor(bf16, device=rows.device)
    h = mix(rows.to(torch.int64) ^ k1)
    cols = torch.arange(dim, dtype=torch.int64, device=rows.device) * _GOLDEN
    x = mix(((h[:, None] + cols[None, :]) & M32) ^ k2)
    u = (x >> 8).to(torch.float32) * (1.0 / (1 << 24))  # [0, 1), exact
    v = (2.0 * u - 1.0) * bound
    return torch.where(bf16, v.bfloat16().float(), v)


def table_rows(seed: int, cfg: dict, table: int, rows: torch.Tensor) -> torch.Tensor:
    """Rows ``rows`` (int64 [N], each below 2**32) of table ``table`` (its
    index in the configuration), f32 [N, dim], on ``rows``' device."""
    return _rows(key(seed, 1, table), key(seed, 2, table), row_bound(cfg["tables"][table]),
                 bf16_exact(cfg, table), rows, cfg["dim"])


def fill_fused(storage: torch.Tensor, *, seed: int, cfg: dict, table_ids, row_offsets,
               total_rows: int, shard: int = 0, num_shards: int = 1,
               strided: bool = False) -> None:
    """Fill ``storage`` in place: one process's part of a fused [total_rows,
    dim] storage (any view of its bytes, such as lane-packed [S, 128]).
    Fused row g holds row g - row_offsets[k] of the configuration's table
    ``table_ids[k]`` where it lies inside that table, zeros elsewhere
    (padding).  The part
    is rows [shard * R, (shard + 1) * R) of the fused rows, R = total_rows
    / num_shards, or with ``strided`` the rows j * num_shards + shard."""
    dim = cfg["dim"]
    flat = storage.view(-1, dim)
    local_rows = flat.shape[0]
    if local_rows * num_shards != total_rows:
        raise ValueError(f"{local_rows} local rows x {num_shards} shards != {total_rows}")
    dev = storage.device
    order = sorted(range(len(row_offsets)), key=lambda k: row_offsets[k])
    offs = torch.tensor([row_offsets[k] for k in order], dtype=torch.int64, device=dev)
    tids = [table_ids[k] for k in order]
    counts = torch.tensor([cfg["tables"][t] for t in tids], dtype=torch.int64, device=dev)
    k1 = torch.tensor([key(seed, 1, t) for t in tids], dtype=torch.int64, device=dev)
    k2 = torch.tensor([key(seed, 2, t) for t in tids], dtype=torch.int64, device=dev)
    bound = torch.tensor([row_bound(cfg["tables"][t]) for t in tids], dtype=torch.float32,
                         device=dev)
    bf16 = torch.tensor([bf16_exact(cfg, t) for t in tids], device=dev)
    step = max(1, ROW_CHUNK_ELEMENTS // dim)
    for lo in range(0, local_rows, step):
        j = torch.arange(lo, min(lo + step, local_rows), dtype=torch.int64, device=dev)
        g = j * num_shards + shard if strided else j + shard * local_rows
        pos = (torch.searchsorted(offs, g, right=True) - 1).clamp(min=0)
        r = g - offs[pos]
        inside = (g >= offs[pos]) & (r < counts[pos])
        vals = _rows(k1[pos], k2[pos], bound[pos], bf16[pos], r.clamp(min=0), dim)
        flat[lo:lo + j.numel()].copy_(torch.where(inside[:, None], vals, 0.0))


def mlp_weights(seed: int, sizes, device, which: int) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(W [out, in], b [out]) of each layer, normal(0, sqrt(2 / (in + out)))
    as dlrm draws them; ``which`` 0 for the bottom MLP, 1 for the top."""
    out = []
    for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
        g = generator(seed, device, 3, which, i)
        std = math.sqrt(2.0 / (fi + fo))
        w = torch.randn(fo, fi, generator=g, device=device) * std
        b = torch.randn(fo, generator=g, device=device) * std
        out.append((w, b))
    return out


def lengths(pooling, tables: int) -> list[int]:
    """A traffic's ``pooling`` as one bag length a table: an int for every
    table, or a list of one a table."""
    if isinstance(pooling, int):
        return [pooling] * tables
    if len(pooling) != tables:
        raise ValueError(f"pooling lists {len(pooling)} bag lengths for {tables} tables")
    return list(pooling)


def batch(seed: int, index: int, *, table_rows_: tuple, batch_size: int, pooling,
          dense_dim: int, device, stream: int = 0, wire: str = "dense") -> dict:
    """Batch ``index`` of a stream: dense [B, dense_dim] f32 in [0, 1), the
    B bags of each table, of its bag length L_t (``pooling``: an int or a
    list of one a table), ids uniform over the table's rows, and labels [B]
    f32 in {0, 1}.

    The dense wire gives ``ids`` and ``mask`` [T, B * max L] (bag-major,
    table t's slots past its L_t masked off, their ids 0); the CSR wire
    gives ``ids`` [T, B * max L] and ``offsets`` [T, B+1], bag b of table t
    being ``ids[t, offsets[t, b]:offsets[t, b+1]]`` and the ids past
    ``offsets[t, B]`` padding (0).  Both wires draw the same ids."""
    g = generator(seed, device, 4, stream, index)
    dense = torch.rand(batch_size, dense_dim, generator=g, device=device)
    lens = lengths(pooling, len(table_rows_))
    drawn = [torch.randint(0, rows, (batch_size * n,), generator=g, device=device,
                           dtype=torch.int64)
             for rows, n in zip(table_rows_, lens)]
    labels = torch.randint(0, 2, (batch_size,), generator=g, device=device).float()
    t, width = len(lens), max(lens)
    ids = torch.zeros(t, batch_size, width, dtype=torch.int32, device=device)
    mask = torch.zeros(ids.shape, dtype=torch.bool, device=device)
    if wire == "csr":
        ids = ids.view(t, -1)
        for k, d in enumerate(drawn):
            ids[k, :d.numel()] = d
        offsets = torch.stack([torch.arange(batch_size + 1, device=device) * n for n in lens])
        return {"dense": dense, "ids": ids, "offsets": offsets.to(torch.int32),
                "labels": labels}
    for k, (d, n) in enumerate(zip(drawn, lens)):
        ids[k, :, :n] = d.view(batch_size, n)
        mask[k, :, :n] = True
    return {"dense": dense, "ids": ids.view(t, -1), "mask": mask.view(t, -1), "labels": labels}
