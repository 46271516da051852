"""ctypes binding to the native feeder (``native/feeder.cpp``, built by
``make -C native`` into ``native/libpelfeeder.so``).

The counterpart of ``pim_embedding_lookup_tpu.utils.native``, with the same
C signatures.  The library does host-side data work: query generation,
Criteo parsing and the CSR and length-bucket wire packers.  The port
imports without it: ``gen_query`` then draws with numpy, and the other
entry points return None, as in the JAX package.  ``pack_buckets`` checks
the shapes the C packer trusts (tables of ``indices`` against
``offsets``, one capacity per bucket) before the call, which the JAX
binding does not.

The library is searched for in ``PEL_NATIVE_LIB``, then at
``<repo>/native/libpelfeeder.so``, then by its bare name, and the first
result, found or not, is kept for the process (``_LIB``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None  # None: not searched yet; False: absent; else the library


def _search_paths() -> tuple[str, ...]:
    return (
        os.environ.get("PEL_NATIVE_LIB", ""),
        os.path.join(os.path.dirname(__file__), "..", "..", "native", "libpelfeeder.so"),
        "libpelfeeder.so",
    )


def _i64p():
    return ctypes.POINTER(ctypes.c_int64)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set every symbol's argtypes and restype (the same as the JAX
    package's binding)."""
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), _i64p()
    lib.pel_gen_uniform.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_uint64, ctypes.c_int]
    lib.pel_gen_uniform.restype = None
    lib.pel_gen_zipf.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                                 ctypes.c_uint64, ctypes.c_int]
    lib.pel_gen_zipf.restype = None
    lib.pel_gen_query.argtypes = [i32p, i64p, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int, ctypes.c_double,
                                  ctypes.c_uint64, ctypes.c_int]
    lib.pel_gen_query.restype = None
    lib.pel_parse_criteo.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_float), i32p, i32p]
    lib.pel_parse_criteo.restype = ctypes.c_int64
    lib.pel_pack_csr.argtypes = [i32p, i64p, i32p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                                 i32p, i32p, ctypes.c_int]
    lib.pel_pack_csr.restype = ctypes.c_int
    # pel_pack_buckets is newer than the other symbols: a library built
    # before it keeps the rest, and pack_buckets returns None
    if hasattr(lib, "pel_pack_buckets"):
        lib.pel_pack_buckets.argtypes = [
            i32p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            i32p, ctypes.POINTER(ctypes.c_uint8), i32p, i32p, i32p, i32p, ctypes.c_int,
        ]
        lib.pel_pack_buckets.restype = ctypes.c_int
    return lib


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    for path in _search_paths():
        if not path:
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        _LIB = _declare(lib)
        return _LIB
    _LIB = False
    return False


def available() -> bool:
    return bool(_load())


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _threads(nthreads: int) -> int:
    return nthreads or (os.cpu_count() or 1)


def gen_query(
    rows: np.ndarray,  # [T] int64 table cardinalities
    batch: int,
    pooling: int,
    *,
    distribution: str = "uniform",
    alpha: float = 1.05,
    seed: int = 0,
    nthreads: int = 0,
) -> np.ndarray:  # [T, B, L] int32
    """Multi-table query ids, uniform or zipf over each table's rows: the
    native generator where the library loads, else numpy (another
    stream, the JAX package's fallback)."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    t = len(rows)
    lib = _load()
    if lib:
        out = np.empty((t, batch, pooling), dtype=np.int32)
        lib.pel_gen_query(_i32p(out), rows.ctypes.data_as(_i64p()), t, batch, pooling,
                          1 if distribution == "zipf" else 0, alpha, seed,
                          _threads(nthreads))
        return out
    rng = np.random.default_rng(seed)
    if distribution == "zipf":
        z = rng.zipf(alpha, size=(t, batch, pooling)) - 1
        return np.minimum(z, rows[:, None, None] - 1).astype(np.int32)
    return (rng.random((t, batch, pooling)) * rows[:, None, None]).astype(np.int32)


def parse_criteo_raw(
    path: str, max_rows: int, hash_mod: int = 1 << 20
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Criteo ``train.txt`` -> (labels [N] f32, dense [N, 13] int32, cat
    [N, 26] int32, hex ids modulo ``hash_mod``), or None without the
    library."""
    lib = _load()
    if not lib:
        return None
    labels = np.empty(max_rows, dtype=np.float32)
    dense = np.empty((max_rows, 13), dtype=np.int32)
    cat = np.empty((max_rows, 26), dtype=np.int32)
    n = lib.pel_parse_criteo(path.encode(), max_rows, hash_mod,
                             labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             _i32p(dense), _i32p(cat))
    if n < 0:
        raise FileNotFoundError(path)
    return labels[:n], dense[:n], cat[:n]


def pack_csr(
    values: np.ndarray,  # concatenated bag values, table-major (int32)
    voff: np.ndarray,  # [T+1] int64 per-table offsets into values
    lens: np.ndarray,  # [T, B] int32 bag lengths
    *,
    num_shards: int,
    capacity_per_shard: int,
    pad_index: int = 0,
    nthreads: int = 0,
) -> tuple[np.ndarray, np.ndarray] | None:
    """The data-sharded CSR wire, ``ops.ragged.shard_csr``'s layout:
    (indices [T, Nd*Cd], offsets [T, Nd*(Bd+1)]) int32, or None without the
    library.  Raises ValueError where ``num_shards`` does not divide the
    batch or a shard's window exceeds its capacity."""
    lib = _load()
    if not lib:
        return None
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.int32)
    voff = np.ascontiguousarray(voff, dtype=np.int64)
    t, b = lens.shape
    # the C packer returns -1 for shard-count misuse too: check it here, so
    # that it is not reported as an overflow
    if num_shards <= 0 or b % num_shards:
        raise ValueError(f"pack_csr: batch {b} must divide by num_shards {num_shards} "
                         "(> 0) — the data-sharded wire contract")
    idx = np.empty((t, num_shards * capacity_per_shard), np.int32)
    off = np.empty((t, num_shards * (b // num_shards + 1)), np.int32)
    rc = lib.pel_pack_csr(_i32p(values), voff.ctypes.data_as(_i64p()), _i32p(lens), t, b,
                          num_shards, capacity_per_shard, pad_index, _i32p(idx), _i32p(off),
                          _threads(nthreads))
    if rc != 0:
        raise ValueError(f"pack_csr: a shard window exceeds capacity {capacity_per_shard}")
    return idx, off


def pack_buckets(
    indices: np.ndarray,  # [T, C] int32 flat per-table ids
    offsets: np.ndarray,  # [T, B+1]
    *,
    bucket_ls: tuple[int, ...],
    capacities: tuple[int, ...],
    tail_bags: int,
    tail_entries: int,
    pad_index: int = 0,
    nthreads: int = 0,
):
    """The threaded length-bucket packer, ``ops.ragged.pack_length_buckets``'
    contract: ``(idx_list, mask_list, pos_list, tail_idx, tail_off,
    tail_pos)`` with per-bucket arrays [T, cap_k*L_k] / [cap_k], or None
    where the library (or its ``pel_pack_buckets``) is absent.  Raises
    ValueError on malformed shapes or offsets, and on plan overflow."""
    lib = _load()
    if not lib or not hasattr(lib, "pel_pack_buckets"):
        return None
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if indices.ndim != 2 or offsets.ndim != 2 or indices.shape[0] != offsets.shape[0]:
        raise ValueError(f"pack_buckets: indices {indices.shape} and offsets "
                         f"{offsets.shape} must be [T, C] and [T, B+1] of one T")
    if len(capacities) != len(bucket_ls):
        raise ValueError(f"pack_buckets: {len(capacities)} capacities for "
                         f"{len(bucket_ls)} buckets")
    t, b = offsets.shape[0], offsets.shape[1] - 1
    # malformed offsets would turn a negative length into a huge memcpy
    lens = offsets[:, 1:] - offsets[:, :-1]
    if (lens < 0).any() or (offsets[:, 0] < 0).any() or (offsets[:, -1] > indices.shape[1]).any():
        raise ValueError("pack_buckets: offsets must be non-decreasing, start >= 0, and "
                         "end within indices capacity")
    ls = np.ascontiguousarray(bucket_ls, dtype=np.int64)
    caps = np.ascontiguousarray(capacities, dtype=np.int64)
    nk = len(ls)
    sizes = [int(caps[k] * ls[k]) for k in range(nk)]
    idx_flat = np.empty(t * sum(sizes), np.int32)
    mask_flat = np.empty(t * sum(sizes), np.uint8)
    pos_flat = np.empty(int(caps.sum()), np.int32)
    has_tail = tail_bags > 0
    tail_idx = np.empty((t, max(tail_entries, 1)), np.int32)
    tail_off = np.empty((t, tail_bags + 1), np.int32)
    tail_pos = np.empty(max(tail_bags, 1), np.int32)
    rc = lib.pel_pack_buckets(
        _i32p(indices), offsets.ctypes.data_as(_i64p()), t, b, indices.shape[1],
        ls.ctypes.data_as(_i64p()), nk, caps.ctypes.data_as(_i64p()),
        tail_bags, tail_entries, pad_index,
        _i32p(idx_flat), mask_flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i32p(pos_flat), _i32p(tail_idx), _i32p(tail_off), _i32p(tail_pos),
        _threads(nthreads),
    )
    if rc == -3:
        raise ValueError("pack_buckets: bad plan (bucket_ls must ascend)")
    if rc != 0:
        raise ValueError("bucket plan overflow (native packer) — re-plan with more slack "
                         "or fall back to lookup_csr")
    idx_list, mask_list, pos_list = [], [], []
    o = po = 0
    for k in range(nk):
        w = sizes[k]
        idx_list.append(idx_flat[o * t : o * t + t * w].reshape(t, w))
        mask_list.append(mask_flat[o * t : o * t + t * w].reshape(t, w).astype(bool))
        pos_list.append(pos_flat[po : po + int(caps[k])])
        o += w
        po += int(caps[k])
    return (
        tuple(idx_list), tuple(mask_list), tuple(pos_list),
        tail_idx if has_tail else None,
        tail_off if has_tail else None,
        tail_pos[:tail_bags] if has_tail else None,
    )
