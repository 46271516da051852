#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from source (printing ptxas's registers and
spills), holds the warp-tile pool kernels (K1, and K2 for K3 and K4's
forward) against their plain versions on every code path at toy sizes, then
holds each kernel against its plain PyTorch version at the shapes its path
gives it and times it beside that version, the PyTorch library call that
computes the same function and the card's bound.  Then it serves the
Criteo-Kaggle hybrid DLRM forward at full table rows (5 requests of 8192
samples) over both wires: the dense padded wire (``DLRM.forward``, kernel
K1) and the CSR wire (``lookup_csr`` then ``apply_from_pooled``, kernel
K2).  It checks that each path went through
its kernels and agrees with the same path pooled by the plain version,
runs the length-bucketed CSR dispatch on one request, drives the
full-width CSR lookup (K3) and the differentiable CSR bag (K4, forward and
backward) through their entry points, and holds the port on the card
against the port on the CPU at toy sizes.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result, without
them.  Any failed check raises.  The line before the last is a JSON object
of per-kernel numbers; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from pim_embedding_lookup_tpu_torch import (
    DLRM,
    DLRMConfig,
    EmbeddingCollection,
    ShardingPolicy,
    TableConfig,
    kaggle_config,
    toy_config,
)
from pim_embedding_lookup_tpu_torch import ops
from pim_embedding_lookup_tpu_torch.ops import _build
from pim_embedding_lookup_tpu_torch.ops.csr_pool import (
    embedding_bag_csr_grad,
    embedding_bag_csr_grad_reference,
    embedding_bag_csr_packed,
    embedding_bag_csr_packed_reference,
    embedding_bag_csr_sum,
)
from pim_embedding_lookup_tpu_torch.ops.gather_pool import (
    embedding_bag_fixedl,
    embedding_bag_fixedl_reference,
    row_path,
    walks_by_group,
)
from pim_embedding_lookup_tpu_torch.ops.ragged import (
    pack_length_buckets,
    plan_length_buckets,
)
from pim_embedding_lookup_tpu_torch.parallel import collection as collection_mod
from pim_embedding_lookup_tpu_torch.parallel import lookup_csr_bucketed
from pim_embedding_lookup_tpu_torch.parallel.hybrid import (
    _mxu_csr_lookup,
    _mxu_pooled_lookup,
)

# H100 SXM published peaks (NVIDIA data sheet), at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores

SEED = 0
BATCH = 8192
REQUESTS = 5
ID_SETS = 16  # distinct id sets cycled while timing: > 50 MB of rows, past L2
TIMED_RUNS = 20
CALLS_PER_RUN = 10
# Kernel checks: f32 sums in another order; bf16 storage adds the same bf16
# values in f32 on both sides, so the same tolerance holds.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
DEV = torch.device("cuda")


def _cycles_per_ms() -> float:
    """Clock cycles of the card's sleep kernel per millisecond."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def call_ms(fn, inputs, calls=CALLS_PER_RUN) -> float:
    """Median over TIMED_RUNS of host-clock time per call, each run ``calls``
    calls cycling through ``inputs`` and ending in a synchronize: what a
    caller in a loop sees, host launch cost included."""
    for args in inputs[:3]:
        fn(*args)
    torch.cuda.synchronize()
    runs, k = [], 0
    for _ in range(TIMED_RUNS):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*inputs[k % len(inputs)])
            k += 1
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(runs)


def device_ms(fn, inputs, calls=CALLS_PER_RUN) -> float:
    """Median over TIMED_RUNS of device time per call: CUDA events around
    ``calls`` calls cycling through ``inputs``.  A sleep kernel ahead of each
    run holds the stream for twice the host's enqueue time, so the calls run
    back to back and the host's launch cost stays out of the number."""
    hold = 2 * call_ms(fn, inputs, calls) * calls * _cycles_per_ms()
    runs, k = [], 0
    for _ in range(TIMED_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold))
        start.record()
        for _ in range(calls):
            fn(*inputs[k % len(inputs)])
            k += 1
        end.record()
        end.synchronize()
        runs.append(start.elapsed_time(end) / calls)
    return statistics.median(runs)


class _OpCount(TorchDispatchMode):
    """Counts the ATen operations dispatched inside it (views included)."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def aten_ops(fn) -> int:
    with _OpCount() as count:
        fn()
    return count.ops


def serve(fn, requests):
    """Host-clock ms of each request, each ending in a synchronize; the
    outputs; and the cudaMalloc calls PyTorch's allocator made meanwhile."""
    allocs = torch.cuda.memory_stats().get("num_device_alloc")
    outs, times = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(fn(*req))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    if allocs is not None:
        allocs = torch.cuda.memory_stats()["num_device_alloc"] - allocs
    return outs, times, allocs


def bound(moved_bytes, ops_count):
    """(bound ms, "bytes" | "operations") at the published peaks."""
    bytes_ms = moved_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops_count / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def k1_case(name, storage, d, pooling, id_sets):
    """K1 against its plain version on set 0; kernel, plain and library
    times cycling through all sets; bound from set 0's data."""
    ids, mask = id_sets[0]
    bags = ids.numel() // pooling
    kw = dict(pooling=pooling, batch_size=bags)
    got = embedding_bag_fixedl(storage, d, ids, mask=mask, **kw)
    want = embedding_bag_fixedl_reference(storage, d, ids, mask=mask, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **KERNEL_TOL)

    weight = storage.view(-1, d)
    offsets = torch.arange(0, ids.numel(), pooling, dtype=torch.int32, device=DEV)
    lib_sets = [(i, m.to(storage.dtype)) for i, m in id_sets]
    kernel = lambda i, m: embedding_bag_fixedl(storage, d, i, mask=m, **kw)  # noqa: E731
    kernel_ms = device_ms(kernel, id_sets)
    kernel_call_ms = call_ms(kernel, id_sets)
    plain_ms = device_ms(
        lambda i, m: embedding_bag_fixedl_reference(storage, d, i, mask=m, **kw), id_sets)
    library_ms = device_ms(
        lambda i, w: F.embedding_bag(i, weight, offsets, mode="sum", per_sample_weights=w),
        lib_sets)

    active = int(mask.sum().item())
    bound_ms, bound_by = bound(
        active * d * storage.element_size()  # rows read
        + ids.numel() * 5  # int32 id + 1-byte mask per entry
        + bags * d * 4,  # f32 output
        active * d)  # one add per loaded value
    row = dict(case=name, dtype=str(storage.dtype).replace("torch.", ""),
               bags=bags, pooling=pooling, d=d, active_entries=active,
               max_abs_err=err, kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    print("K1 " + json.dumps(row), flush=True)
    return row


def kaggle_ids(coll, gen, b, pooling, keep):
    """Fused big-set ids [T*B*L] int32 and a mask (all set when keep=1)."""
    local = torch.stack([
        torch.randint(0, n, (b * pooling,), generator=gen, device=DEV, dtype=torch.int32)
        for n in coll.layout.table_rows
    ])
    ids = coll.globalize(local).reshape(-1).contiguous()
    if keep >= 1.0:
        mask = torch.ones(ids.numel(), dtype=torch.bool, device=DEV)
    else:
        mask = torch.rand(ids.numel(), generator=gen, device=DEV) < keep
    return ids, mask


def request(config, gen, b, pooling=1, keep=1.0):
    dense = torch.rand(b, config.dense_dim, generator=gen, device=DEV)
    idx = torch.stack([
        torch.randint(0, t.num_rows, (b * pooling,), generator=gen, device=DEV,
                      dtype=torch.int32)
        for t in config.tables
    ])
    if keep >= 1.0:
        mask = torch.ones(idx.shape, dtype=torch.bool, device=DEV)
    else:
        mask = torch.rand(idx.shape, generator=gen, device=DEV) < keep
    return dense, idx, mask


# -- kernel edge cases ------------------------------------------------------------

EDGE_ROWS = 128  # rows of each toy table: a multiple of every pack 128 / d
EDGE_BAGS = 37  # not a multiple of any warp tile (32 / group bags)
NEVER_READ = 1 << 30  # id of padding and masked entries: a read would fault


def edge_storage(gen, d, dtype, layout):
    """[EDGE_ROWS, d] rows as "packed" [S, 128], "unpacked" [N, d], or
    "unaligned": an [N, d] view one element into its buffer (scalar path)."""
    rows = torch.randn(EDGE_ROWS, d, generator=gen, device=DEV).to(dtype)
    if layout == "packed":
        return rows.reshape(-1, 128)
    if layout == "unaligned":
        buf = torch.empty(EDGE_ROWS * d + 1, dtype=dtype, device=DEV)
        buf[1:] = rows.reshape(-1)
        return buf[1:].view(EDGE_ROWS, d)
    return rows


def edge_csr(gen, tables, max_len, empty):
    """[T, C] ids and [T, B+1] offsets: a fifth of the bags empty (all of
    them if ``empty``), the rest 1..max_len ids, so each table ends at its
    own offsets[B]; padding up to C holds NEVER_READ."""
    lens = torch.randint(1, max_len + 1, (tables, EDGE_BAGS), generator=gen, device=DEV)
    keep = torch.rand(tables, EDGE_BAGS, generator=gen, device=DEV) >= 0.2
    lens = torch.where(keep, lens, 0) * (not empty)
    off = torch.zeros(tables, EDGE_BAGS + 1, dtype=torch.int32, device=DEV)
    off[:, 1:] = lens.cumsum(dim=1)
    cap = int(off[:, -1].max().item()) + 8
    idx = torch.randint(0, EDGE_ROWS, (tables, cap), generator=gen, device=DEV,
                        dtype=torch.int32)
    idx[torch.arange(cap, device=DEV)[None, :] >= off[:, -1:]] = NEVER_READ
    return idx, off


def edge_phase(gen):
    """Both redesigned kernels against their plain versions on every code
    path at toy sizes (f32 and bf16; d in 1, 4, 16, 20, 128, 256; packed,
    unpacked and unaligned storage, so vector and scalar row loads; bags
    longer than the unroll, all-empty bags, T = 1, 2 and 10, and bags long
    enough for the by-group walk; K1 at L = 1, 3, 8, 9 with no mask, a
    random mask and an all-false mask), and repeated launches bitwise equal.
    Padding and masked entries hold ids that fault if read.  Returns the
    number of cases."""
    cases, paths = 0, set()
    for dtype, d in itertools.product((torch.float32, torch.bfloat16),
                                      (1, 4, 16, 20, 128, 256)):
        layouts = ["unpacked", "unaligned"] + (["packed"] if d < 128 and 128 % d == 0 else [])
        for layout in layouts:
            storage = edge_storage(gen, d, dtype, layout)
            vector, group = row_path(storage, d)
            for tables, max_len, empty in ((1, 40, False), (10, 6, False), (3, 3, True),
                                           (2, 100, False)):
                idx, off = edge_csr(gen, tables, max_len, empty)
                got = embedding_bag_csr_packed(storage, d, idx, off, batch_size=EDGE_BAGS)
                again = embedding_bag_csr_packed(storage, d, idx, off, batch_size=EDGE_BAGS)
                want = embedding_bag_csr_packed_reference(
                    storage, d, torch.where(idx == NEVER_READ, 0, idx), off,
                    batch_size=EDGE_BAGS)
                torch.testing.assert_close(got, want, **KERNEL_TOL)
                if not torch.equal(got, again):
                    raise AssertionError(f"K2 not deterministic: {dtype} d={d} {layout}")
                cases += 1
                paths.add(("K2", vector, walks_by_group(group, idx.shape[1], EDGE_BAGS)))
            for pooling, masking in itertools.product((1, 3, 8, 9), ("none", "random", "false")):
                n = EDGE_BAGS * pooling
                ids = torch.randint(0, EDGE_ROWS, (n,), generator=gen, device=DEV,
                                    dtype=torch.int32)
                mask = {"none": None,
                        "random": torch.rand(n, generator=gen, device=DEV) < 0.6,
                        "false": torch.zeros(n, dtype=torch.bool, device=DEV)}[masking]
                read = ids if mask is None else torch.where(mask, ids, NEVER_READ)
                kw = dict(pooling=pooling, batch_size=EDGE_BAGS, mask=mask)
                got = embedding_bag_fixedl(storage, d, read, **kw)
                again = embedding_bag_fixedl(storage, d, read, **kw)
                want = embedding_bag_fixedl_reference(storage, d, ids, **kw)
                torch.testing.assert_close(got, want, **KERNEL_TOL)
                if not torch.equal(got, again):
                    raise AssertionError(f"K1 not deterministic: {dtype} d={d} {layout}")
                cases += 1
                paths.add(("K1", vector, walks_by_group(group, n, EDGE_BAGS)))
    torch.cuda.synchronize()
    if len(paths) != 8:  # K1, K2 x vector, scalar x window, by group
        raise AssertionError(f"edge cases reached only the paths {sorted(paths)}")
    return cases


# -- the CSR wire ---------------------------------------------------------------


def csr_ids(rows, gen, b, pooling):
    """bench.py's ragged CSR mixture for tables of ``rows`` rows: per bag
    10 % empty, 80 % of 1..pooling ids, 10 % of 2*pooling..4*pooling ids.
    Capacity per table is the longest table's total rounded up to 8, and
    entries past offsets[B] are padding (random valid ids, never read).
    Returns local ids [T, C] and offsets [T, B+1], int32, on the card."""
    t = len(rows)
    r = torch.rand(t, b, generator=gen, device=DEV)
    short = torch.randint(1, pooling + 1, (t, b), generator=gen, device=DEV)
    long = torch.randint(2 * pooling, 4 * pooling + 1, (t, b), generator=gen, device=DEV)
    lens = torch.where(r >= 0.9, long, torch.where(r >= 0.1, short, 0))
    cap = -(-int(lens.sum(dim=1).max().item()) // 8) * 8
    off = torch.zeros(t, b + 1, dtype=torch.int32, device=DEV)
    off[:, 1:] = lens.cumsum(dim=1)
    idx = torch.stack([torch.randint(0, n, (cap,), generator=gen, device=DEV,
                                     dtype=torch.int32) for n in rows])
    return idx, off


def csr_request(config, gen, b, pooling=1):
    dense = torch.rand(b, config.dense_dim, generator=gen, device=DEV)
    return (dense, *csr_ids([t.num_rows for t in config.tables], gen, b, pooling))


def serve_csr(model, dense, idx, off):
    """The CSR serving path: pooled lookup over ragged bags, then the dense
    half."""
    pooled = model.collection.lookup_csr(model.emb_params(), idx, off)
    return model.apply_from_pooled(dense, pooled)


def compact(idx, off):
    """All tables' valid entries back to back, and [T*B+1] offsets into
    them: the input of one F.embedding_bag call over every table."""
    t, b = off.shape[0], off.shape[1] - 1
    ends = off[:, -1].tolist()
    flat = torch.cat([idx[i, :ends[i]] for i in range(t)])
    base = torch.tensor([0] + ends[:-1], device=DEV).cumsum(0)
    flat_off = torch.cat([(off[:, :-1] + base[:, None]).reshape(-1),
                          torch.tensor([sum(ends)], device=DEV)])
    return flat.long(), flat_off.long()


def csr_case(tag, name, storage, d, id_sets):
    """K2/K3 against its plain version on set 0 (fused ids [T, C], offsets
    [T, B+1]); kernel, plain and library times cycling through all sets;
    bound from set 0's data: valid entries only, padding is not read."""
    idx, off = id_sets[0]
    t, b = off.shape[0], off.shape[1] - 1
    got = embedding_bag_csr_packed(storage, d, idx, off, batch_size=b)
    want = embedding_bag_csr_packed_reference(storage, d, idx, off, batch_size=b)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **KERNEL_TOL)

    weight = storage.view(-1, d)
    lib_sets = [compact(i, o) for i, o in id_sets]  # before the timed region
    kernel = lambda i, o: embedding_bag_csr_packed(storage, d, i, o, batch_size=b)  # noqa: E731
    kernel_ms = device_ms(kernel, id_sets)
    kernel_call_ms = call_ms(kernel, id_sets)
    plain_ms = device_ms(lambda i, o: embedding_bag_csr_packed_reference(
        storage, d, i, o, batch_size=b), id_sets)
    library_ms = device_ms(lambda i, o: F.embedding_bag(
        i, weight, o, mode="sum", include_last_offset=True), lib_sets)

    active = int(off[:, -1].sum().item())
    bound_ms, bound_by = bound(
        active * (d * storage.element_size() + 4)  # rows and ids read
        + t * (b + 1) * 4  # offsets
        + t * b * d * 4,  # f32 output
        active * d)
    row = dict(case=name, dtype=str(storage.dtype).replace("torch.", ""),
               tables=t, bags=b, capacity=idx.shape[1], d=d, active_entries=active,
               max_abs_err=err, kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by)
    print(f"{tag} " + json.dumps(row), flush=True)
    return row


def k4_phase(gen):
    """K4 through ``ops.embedding_bag(impl="pallas")`` on the largest Kaggle
    table: the path run (forward and backward, launches counted), then each
    half against its plain version, timed beside F.embedding_bag."""
    n, d = max(kaggle_config().tables, key=lambda t: t.num_rows).num_rows, 16
    table = torch.empty(n, d, device=DEV).uniform_(-1, 1, generator=gen)
    w = table.clone().requires_grad_(True)
    sets = [tuple(x[0] for x in csr_ids([n], gen, BATCH, 1)) for _ in range(8 * ID_SETS)]
    grads = [torch.randn(BATCH, d, generator=gen, device=DEV)]
    idx, off = sets[0]
    g = grads[0]

    def facade(tab, i, o):
        return ops.embedding_bag(tab, i, o, batch_size=BATCH, impl="pallas")

    # the path: forward and backward through the facade, counts from 0
    embedding_bag_csr_sum.launches = embedding_bag_csr_grad.launches = 0
    out = facade(w, idx, off)
    out.backward(g)
    torch.cuda.synchronize()
    launches = (embedding_bag_csr_sum.launches, embedding_bag_csr_grad.launches)
    if launches != (1, 1):
        raise AssertionError(f"K4 forward/backward launched {launches} times, not (1, 1)")

    want = embedding_bag_csr_packed_reference(table, d, idx, off, batch_size=BATCH)
    fwd_err = (out.detach() - want).abs().max().item()
    torch.testing.assert_close(out.detach(), want, **KERNEL_TOL)
    want_grad = embedding_bag_csr_grad_reference(g, idx, off, n)
    bwd_err = (w.grad - want_grad).abs().max().item()
    # f32 atomicAdd sums rows shared by several bags in a run-dependent order
    torch.testing.assert_close(w.grad, want_grad, rtol=1e-5, atol=1e-5)
    del out, want, want_grad
    w.grad = None

    # forward: kernel, plain, library
    lib_sets = [compact(i[None], o[None]) for i, o in sets]
    fwd = dict(
        kernel_ms=device_ms(lambda i, o: facade(table, i, o), sets),
        kernel_call_ms=call_ms(lambda i, o: facade(table, i, o), sets),
        plain_ms=device_ms(lambda i, o: embedding_bag_csr_packed_reference(
            table, d, i, o, batch_size=BATCH), sets),
        library_ms=device_ms(lambda i, o: F.embedding_bag(
            i, table, o, mode="sum", include_last_offset=True), lib_sets),
    )
    # backward alone: one graph per id set, each differentiated again and
    # again; the library's graph is F.embedding_bag's, with a dense gradient
    outs = [(facade(w, i, o),) for i, o in sets]
    wl = table.clone().requires_grad_(True)
    lib_outs = [(F.embedding_bag(i, wl, o, mode="sum", include_last_offset=True),)
                for i, o in lib_sets]
    bwd = dict(
        kernel_ms=device_ms(lambda o: torch.autograd.grad(o, w, g, retain_graph=True),
                            outs),
        kernel_call_ms=call_ms(lambda o: torch.autograd.grad(o, w, g, retain_graph=True),
                               outs),
        plain_ms=device_ms(lambda i, o: embedding_bag_csr_grad_reference(g, i, o, n),
                           sets),
        library_ms=device_ms(lambda o: torch.autograd.grad(o, wl, g, retain_graph=True),
                             lib_outs),
    )
    active = int(off[-1].item())
    fwd.update(zip(("bound_ms", "bound_by"), bound(
        active * (d * 4 + 4) + (BATCH + 1) * 4 + BATCH * d * 4, active * d)))
    bwd.update(zip(("bound_ms", "bound_by"), bound(
        BATCH * d * 4 + active * 4 + (BATCH + 1) * 4  # g, ids, offsets read
        + n * d * 4,  # the dense f32 gradient, written once
        active * d)))
    fwd["max_abs_err"], bwd["max_abs_err"] = fwd_err, bwd_err
    for half, row in (("forward", fwd), ("backward", bwd)):
        print(f"K4 {half} " + json.dumps(dict(
            case=f"largest Kaggle table {n} x {d} f32, B={BATCH}, pooling-1 mixture",
            active_entries=active, **row)), flush=True)
    return fwd, bwd, launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. card -------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build: every csrc/*.cu, one nvcc each, all started together --------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: compiled {built or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in _build.logs.items():  # ptxas: registers and spills
        for line in log.splitlines():
            if "Compiling entry function" in line or "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # -- 2b. kernel edge cases: K1 and K2 on every code path, toy sizes ---------
    t0 = time.perf_counter()
    edge_cases = edge_phase(torch.Generator(device=DEV).manual_seed(SEED))
    print(f"kernel edge cases: {edge_cases} cases of K1 and K2 on the vector and "
          "scalar paths, by window and by group, equal to their plain versions "
          "(1e-5 abs + 1e-5 rel), "
          f"repeated launches bitwise equal, in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # -- 3. K1 against its plain version at the dense path's shapes -------------
    config = kaggle_config()
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    t0 = time.perf_counter()
    model = DLRM(config, ShardingPolicy.REPLICATE, hybrid=True, device=DEV,
                 generator=gen)
    torch.cuda.synchronize()
    big = model.collection.big
    print(f"model: full Kaggle rows, big set {sum(big.layout.table_rows)} rows "
          f"in storage {tuple(model.emb_big.shape)} f32 "
          f"({model.emb_big.numel() * 4 / 1e9:.3f} GB), small set "
          f"{tuple(model.emb_small.shape)}, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    main_sets = [kaggle_ids(big, gen, BATCH, 1, 1.0) for _ in range(ID_SETS)]
    main_f32 = k1_case("main path (10 tables x B=8192, L=1, packed)",
                       model.emb_big, 16, 1, main_sets)
    big_bf16 = model.emb_big.to(torch.bfloat16)
    k1_case("main path, bf16 storage", big_bf16, 16, 1, main_sets)
    multi_sets = [kaggle_ids(big, gen, 2048, 8, 0.7) for _ in range(ID_SETS)]
    k1_case("multi-hot (10 tables x B=2048, L=8, mask 0.7)", model.emb_big, 16, 8,
            multi_sets)
    wide = torch.empty(1_000_000, 128, device=DEV).uniform_(-1, 1, generator=gen)
    wide_sets = [
        (torch.randint(0, wide.shape[0], (8192 * 4,), generator=gen, device=DEV,
                       dtype=torch.int32),
         torch.rand(8192 * 4, generator=gen, device=DEV) < 0.7)
        for _ in range(ID_SETS)
    ]
    k1_case("d=128 (1M rows, B=8192, L=4, mask 0.7)", wide, 128, 4, wide_sets)
    del wide, wide_sets, multi_sets, main_sets

    # -- 4. the dense path: hybrid DLRM forward at full Kaggle rows -------------
    requests = [request(config, gen, BATCH) for _ in range(REQUESTS + 1)]
    with torch.no_grad():
        model(*requests[-1])  # warm-up (cuBLAS handles, allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        embedding_bag_fixedl.launches = 0
        logits, times, allocs = serve(model, requests[:REQUESTS])
        k1_launches = embedding_bag_fixedl.launches
        _, again, allocs_again = serve(model, requests[:REQUESTS])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in logits:
        if out.shape != (BATCH,) or not torch.isfinite(out).all():
            raise AssertionError(f"bad logits: shape {tuple(out.shape)}")
    if k1_launches != REQUESTS:
        raise AssertionError(f"K1 launched {k1_launches} times for {REQUESTS} requests")
    with torch.no_grad(), mock.patch.object(
        collection_mod, "embedding_bag_fixedl", embedding_bag_fixedl_reference
    ):
        for req, out in zip(requests, logits):
            torch.testing.assert_close(out, model(*req), rtol=0, atol=1e-4)
    med = statistics.median(times)
    print(f"main path: {REQUESTS} requests of B={BATCH}: ms/request "
          f"{[round(t, 4) for t in times]}, median {med:.4f} ms, "
          f"{BATCH / med * 1e3:.0f} samples/s, K1 launches {k1_launches}, "
          f"peak memory {peak_gb:.3f} GB, cudaMalloc calls {allocs}; logits "
          "finite and equal to the plain-pooled forward (atol 1e-4); the same "
          f"requests again: ms/request {[round(t, 4) for t in again]}, "
          f"cudaMalloc calls {allocs_again}", flush=True)

    # stage times, inputs on the card: device time (CUDA events, launch cost
    # hidden) and host-clock time per call
    dense, idx, mask = requests[0]
    coll, emb = model.collection, model.emb_params()
    sel_s = torch.tensor(coll.small_ids, device=DEV)
    sel_b = torch.tensor(coll.big_ids, device=DEV)
    with torch.no_grad():
        pooled = coll.lookup(emb, idx, mask, batch_size=BATCH)
        fns = {
            "small_set_onehot_bmm": lambda: _mxu_pooled_lookup(
                emb["small"], coll.buckets, idx[sel_s], mask[sel_s],
                batch_size=BATCH),
            "big_set_lookup": lambda: coll.big.lookup(
                emb["big"], idx[sel_b], mask[sel_b], batch_size=BATCH),
            "dense_half": lambda: model.apply_from_pooled(dense, pooled),
            "forward": lambda: model(dense, idx, mask),
        }
        stages = {name: {"device_ms": device_ms(fn, [()], calls=3),
                         "call_ms": call_ms(fn, [()], calls=3)}
                  for name, fn in fns.items()}
        ops_count = {name: aten_ops(fn) for name, fn in fns.items()}
    print("stages (median ms): " + json.dumps(stages), flush=True)
    print("stages (ATen operations per call): " + json.dumps(ops_count), flush=True)
    fwd = stages["forward"]
    print(f"forward: device busy {fwd['device_ms']:.4f} ms of {fwd['call_ms']:.4f} ms "
          f"per call, idle share {1 - fwd['device_ms'] / fwd['call_ms']:.3f}", flush=True)
    del requests, logits, pooled

    # -- 5. K2 against its plain version at the CSR path's shapes ----------------
    big_rows = big.layout.table_rows

    def fused_csr(b, pooling):
        local, off = csr_ids(big_rows, gen, b, pooling)
        return big.globalize(local).contiguous(), off

    csr_sets = [fused_csr(BATCH, 1) for _ in range(ID_SETS)]
    k2_f32 = csr_case("K2", "CSR path (10 tables x B=8192, pooling-1 mixture, packed)",
                      model.emb_big, 16, csr_sets)
    csr_case("K2", "CSR path, bf16 storage", big_bf16, 16, csr_sets)
    del big_bf16
    csr_case("K2", "multi-hot (10 tables x B=2048, pooling-8 mixture)", model.emb_big,
             16, [fused_csr(2048, 8) for _ in range(ID_SETS)])
    del csr_sets

    # -- 6. the CSR path: lookup_csr + apply_from_pooled at full Kaggle rows ----
    requests = [csr_request(config, gen, BATCH) for _ in range(REQUESTS + 1)]
    with torch.no_grad():
        serve_csr(model, *requests[-1])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        embedding_bag_csr_packed.launches = 0
        logits, times, allocs = serve(lambda *r: serve_csr(model, *r),
                                      requests[:REQUESTS])
        k2_launches = embedding_bag_csr_packed.launches
        _, again, allocs_again = serve(lambda *r: serve_csr(model, *r),
                                       requests[:REQUESTS])
    csr_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in logits:
        if out.shape != (BATCH,) or not torch.isfinite(out).all():
            raise AssertionError(f"bad CSR logits: shape {tuple(out.shape)}")
    if k2_launches != REQUESTS:
        raise AssertionError(f"K2 launched {k2_launches} times for {REQUESTS} requests")
    with torch.no_grad(), mock.patch.object(
        collection_mod, "embedding_bag_csr_packed", embedding_bag_csr_packed_reference
    ):
        for req, out in zip(requests, logits):
            torch.testing.assert_close(out, serve_csr(model, *req), rtol=0, atol=1e-4)
    med = statistics.median(times)
    entries = [int(r[2][:, -1].sum().item()) for r in requests[:REQUESTS]]
    print(f"CSR path: {REQUESTS} requests of B={BATCH} (pooling-1 mixture, "
          f"{entries} valid entries over 26 tables): ms/request "
          f"{[round(t, 4) for t in times]}, median {med:.4f} ms, "
          f"{BATCH / med * 1e3:.0f} samples/s, K2 launches {k2_launches}, "
          f"peak memory {csr_peak_gb:.3f} GB, cudaMalloc calls {allocs}; logits "
          "finite and equal to the plain-pooled path (atol 1e-4); the same "
          f"requests again: ms/request {[round(t, 4) for t in again]}, "
          f"cudaMalloc calls {allocs_again}", flush=True)
    # the same requests padded to one capacity (copies of a valid id after
    # offsets[B]), so that every request has the same shapes
    cap = -(-max(r[1].shape[1] for r in requests) // 1024) * 1024
    fixed = [(dn, torch.cat([ix, ix[:, :1].expand(-1, cap - ix.shape[1])], dim=1), of)
             for dn, ix, of in requests[:REQUESTS]]
    with torch.no_grad():
        fixed_logits, fixed_times, _ = serve(lambda *r: serve_csr(model, *r), fixed)
        _, fixed_again, _ = serve(lambda *r: serve_csr(model, *r), fixed)
    for out, want in zip(fixed_logits, logits):
        torch.testing.assert_close(out, want, rtol=0, atol=1e-4)
    print(f"CSR path, the same requests padded to capacity {cap}: ms/request "
          f"{[round(t, 4) for t in fixed_times]}, again "
          f"{[round(t, 4) for t in fixed_again]}; logits equal (atol 1e-4)", flush=True)
    del fixed, fixed_logits

    dense, idx, off = requests[0]
    with torch.no_grad():
        pooled = coll.lookup_csr(emb, idx, off)
        fns = {
            "small_set_onehot_bmm": lambda: _mxu_csr_lookup(
                emb["small"], coll.buckets, idx[sel_s], off[sel_s]),
            "big_set_lookup_csr": lambda: coll.big.lookup_csr(
                emb["big"], idx[sel_b], off[sel_b]),
            "dense_half": lambda: model.apply_from_pooled(dense, pooled),
            "whole": lambda: serve_csr(model, dense, idx, off),
        }
        csr_stages = {name: {"device_ms": device_ms(fn, [()], calls=3),
                             "call_ms": call_ms(fn, [()], calls=3)}
                      for name, fn in fns.items()}
        ops_count = {name: aten_ops(fn) for name, fn in fns.items()}
    print("CSR stages (median ms): " + json.dumps(csr_stages), flush=True)
    print("CSR stages (ATen operations per call): " + json.dumps(ops_count), flush=True)
    whole = csr_stages["whole"]
    print(f"CSR path: device busy {whole['device_ms']:.4f} ms of "
          f"{whole['call_ms']:.4f} ms per call, idle share "
          f"{1 - whole['device_ms'] / whole['call_ms']:.3f}", flush=True)

    # -- 7. length-bucketed CSR on one request, against lookup_csr --------------
    off_np, idx_np = off.cpu().numpy(), idx.cpu().numpy()
    plan = plan_length_buckets(off_np, bucket_ls=(1, 2), slack=1.0)
    packed = pack_length_buckets(idx_np, off_np, plan)
    embedding_bag_fixedl.launches = embedding_bag_csr_packed.launches = 0
    with torch.no_grad():
        got = lookup_csr_bucketed(coll, emb, packed)
    torch.cuda.synchronize()
    launched = (embedding_bag_fixedl.launches, embedding_bag_csr_packed.launches)
    err = (got - pooled).abs().max().item()
    torch.testing.assert_close(got, pooled, rtol=1e-5, atol=1e-5)
    print(f"bucketed CSR: plan buckets {plan.bucket_ls} capacities {plan.capacities} "
          f"tail {plan.tail_bags} bags / {plan.tail_entries} entries; K1, K2 "
          f"launches {launched}; max abs err vs lookup_csr {err:.3g} (tol 1e-5)",
          flush=True)
    del model, coll, emb, big, fns, requests, logits, pooled, got

    # -- 8. K3: the CSR walk over full-width rows, through lookup_csr -----------
    wide_coll = EmbeddingCollection.create(
        [TableConfig(num_rows=1_000_000, dim=128, name="wide")],
        ShardingPolicy.REPLICATE, device=DEV)
    wide = wide_coll.init(gen)
    wide_rows = wide_coll.layout.table_rows
    embedding_bag_csr_packed.launches = 0
    with torch.no_grad():
        for _ in range(REQUESTS):
            pooled = wide_coll.lookup_csr(wide, *csr_ids(wide_rows, gen, BATCH, 4))
            if not torch.isfinite(pooled).all():
                raise AssertionError("non-finite full-width CSR lookup")
    torch.cuda.synchronize()
    k3_launches = embedding_bag_csr_packed.launches
    if k3_launches != REQUESTS:
        raise AssertionError(f"K3 launched {k3_launches} times for {REQUESTS} lookups")
    print(f"full-width CSR lookup: {REQUESTS} lookup_csr calls on 1M x 128 f32, "
          f"B={BATCH}, pooling-4 mixture: K3 launches {k3_launches}", flush=True)
    k3 = csr_case("K3", "d=128 (1M rows, B=8192, pooling-4 mixture)", wide, 128,
                  [csr_ids(wide_rows, gen, BATCH, 4) for _ in range(ID_SETS)])
    del wide, pooled

    # -- 9. K4: the differentiable CSR bag, forward and backward ----------------
    k4_fwd, k4_bwd, k4_launches = k4_phase(gen)

    # -- 10. port on the card against the port on the CPU -----------------------
    mixed = DLRMConfig(
        dense_dim=13, mlp_bot=(64, 16), mlp_top=(32, 1),
        tables=tuple(TableConfig(num_rows=n, dim=16, name=f"t{i}")
                     for i, n in enumerate((3, 24, 583, 1460, 9000, 20000))),
    )
    for name, cfg, hybrid, pooling in (("toy", toy_config(), False, 3),
                                       ("mixed hybrid", mixed, True, 2)):
        cpu = DLRM(cfg, hybrid=hybrid, device="cpu",
                   generator=torch.Generator().manual_seed(SEED))
        gpu = DLRM(cfg, hybrid=hybrid, device=DEV, generator=gen)
        gpu.load_state_dict(cpu.state_dict())
        for wire, req in (("dense", request(cfg, gen, 64, pooling, 0.7)),
                          ("CSR", csr_request(cfg, gen, 64, pooling))):
            forward = gpu if wire == "dense" else (lambda *r, m=gpu: serve_csr(m, *r))
            forward_cpu = cpu if wire == "dense" else (lambda *r: serve_csr(cpu, *r))
            with torch.no_grad():
                on_card = forward(*req)
                on_cpu = forward_cpu(*(t.cpu() for t in req))
            err = (on_card.cpu() - on_cpu).abs().max().item()
            torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-4, atol=1e-4)
            print(f"card vs CPU, {name} DLRM, {wire} wire (B=64, pooling {pooling}): "
                  f"logits max abs err {err:.3g} (tol 1e-4)", flush=True)

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s "
          "(build included)", flush=True)
    src = "pim_embedding_lookup_tpu_torch/csrc/"
    pallas = "pim_embedding_lookup_tpu/ops/pallas_lookup.py:"

    def entry(name, source, replaces, launches, row):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": pallas + replaces, "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    print("kernels: K1, K2, K3, K4 forward, K4 backward", flush=True)
    print(json.dumps({"kernels": [
        entry("K1 embedding_bag_fixedl (fixed-L gather+pool)", "gather_pool.cu",
              "272", k1_launches, main_f32),
        entry("K2 embedding_bag_csr_packed (CSR gather+pool, d=16 packed)",
              "csr_pool.cu", "92", k2_launches, k2_f32),
        entry("K3 embedding_bag_csr_packed (CSR gather+pool, d=128 rows)",
              "csr_pool.cu", "48", k3_launches, k3),
        entry("K4 forward embedding_bag_csr_sum (differentiable CSR bag)",
              "csr_pool.cu", "204", k4_launches[0], k4_fwd),
        entry("K4 backward embedding_bag_csr_grad (CSR bag gradient)",
              "csr_pool.cu", "230", k4_launches[1], k4_bwd),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
