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
against the port on the CPU at toy sizes.  Then the int8 capacity mode
(``int8``): the same model's big set quantized by
``quantize_dlrm_embeddings`` in both scale modes, the int8 instances of K1
and K2 against their plain versions (toy edge cases, then timed at the
main shapes), and 5 requests on each wire in each mode served through the
int8 big set beside the f32 model.  Last it trains the same model at
full table rows, B=8192, fresh ids each step: the sparse step (SGD and
row-wise AdaGrad scattered into the tables) on the dense wire (K1) and the
CSR wire (K2), and the dense-autodiff step (K1 forward, its transpose
backward), each held against the same step pooled by the plain version, with
rows the batch did not touch unchanged; and at toy sizes the sparse SGD step
against the dense-autodiff one, and the train steps on the card against the
port on the CPU.  Then the sharded engine: ``mesh_1`` (an NCCL process group
of one: the same model with its big set under ROW_HASH served, trained by
the sparse step and by the dense-autodiff step, the big set's CSR-wire and
routed gradients, and its int8 big set served broadcast (masked int8 K1
and K2) and routed with a hot cache, each equal to REPLICATE), ``multihost_1`` (the
multi-host entry in a subprocess that has a launcher's environment for a
job of one), ``shards_4`` (the four shards of each policy in one process:
the masked K1, K2 and K4-backward launches against their plain versions,
timed), ``masked`` (the masked walk at a row shard's per-rank shapes of
``cli bench``'s random and bigtable configurations and of Kaggle, 1 in 4
kept and all kept: the chosen walk timed beside its bound, bitwise the sum
of each bag's kept entries in entry order), ``cli`` (the training entry point ``python -m
pim_embedding_lookup_tpu_torch.cli train`` at full Kaggle width in
subprocesses: sparse row-AdaGrad training with reports and a full-state
save, its resume, inference from it, and dense-autodiff ``fit``; in this
process the resume against a straight run, bitwise, ``device_prefetch``
against its host arrays, and ``profiling.trace`` around three CLI steps,
each launching K1), ``tools`` (each of the port's measurement tools,
``pim_embedding_lookup_tpu_torch/tools``, through its ``main`` at full
Kaggle width: sparse training on both wires, serving under load, the phase
split, the int8 capacity bench at a size whose f32 form does not fit on the
card, a trace naming K1's kernel, the kernel lab's probes with every kernel
path it sweeps held against the plain version, and one shard of the
scaling bench), ``bench`` (the lookup bench through ``python -m
pim_embedding_lookup_tpu_torch.cli bench`` in subprocesses at full width:
Criteo Kaggle on every wire, dtype and set of tables, r.sh's random and
bigtable presets, each configuration's first call held in this process
against its plain versions; then ``cli sweep`` over the r.sh grids up to
32 x 13.9M x 64 bf16, 56.9 GB), ``surface`` (200 seeds of the JAX suite's
query-surface fuzz, bf16 added, under REPLICATE, ROW_HASH and the drawn
policy on an NCCL process group of one, both wires, against the CPU and a
numpy oracle; then the full-row int8 DLRM saved by ``utils.checkpoint``
and restored bit for bit in both scale modes) and, with two cards or more,
``multi_gpu`` (which also runs the scaling bench and the bench under
torchrun over all the cards, and the surface battery over NCCL).  The native
feeder library (``native/libpelfeeder.so``) is built beside the kernels
where it is absent, and its bucket packer feeds the bucketed CSR dispatch,
byte-identical to the numpy packer.

    python3 chip_smoke.py
    python3 chip_smoke.py --only tools       # one phase alone (or bench, surface, int8,
                                             # masked, multi_gpu)

Needs one CUDA device, nvcc and a C++ toolchain (``make``); exits non-zero,
printing no result, without them.  Any failed check raises.  The line before the last is a JSON object
of per-kernel numbers; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import gc
import gzip
import io
import itertools
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from pim_embedding_lookup_tpu_torch import (
    DLRM,
    DLRMConfig,
    EmbeddingCollection,
    HybridEmbeddingCollection,
    ShardingPolicy,
    TableConfig,
    kaggle_config,
    random_config,
    toy_config,
)
from pim_embedding_lookup_tpu_torch import (
    bench,
    cli,
    make_optimizer,
    make_train_step,
    mesh_battery,
    multihost_battery,
    ops,
    quantize_dlrm_embeddings,
    surface_battery,
)
from pim_embedding_lookup_tpu_torch.data import SyntheticDLRMBatches, device_prefetch
from pim_embedding_lookup_tpu_torch.models import bce_loss
from pim_embedding_lookup_tpu_torch.models.train import emb_tensors
from pim_embedding_lookup_tpu_torch.models.sparse_train import (
    dense_params,
    make_sparse_train_state,
    make_sparse_train_step,
)
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
    fitted_path,
    kernel_path,
    walks_by_group,
)
from pim_embedding_lookup_tpu_torch.ops.ragged import (
    pack_length_buckets,
    plan_length_buckets,
)
from pim_embedding_lookup_tpu_torch.parallel import collection as collection_mod
from pim_embedding_lookup_tpu_torch.parallel import lookup_csr_bucketed, multihost
from pim_embedding_lookup_tpu_torch.parallel.collection import (
    _csr_finish,
    _csr_local_pool,
    _csr_rowshard_pool,
    _finish_combiner,
    _local_pooled_lookup,
    _owner_local,
    _rowshard_pooled_lookup,
    shard_storage,
)
from pim_embedding_lookup_tpu_torch.parallel.hybrid import (
    _mxu_csr_lookup,
    _mxu_sparse_update,
    _mxu_sparse_update_csr,
    _small_pooled_lookup,
)
from pim_embedding_lookup_tpu_torch.parallel.hotcache import build_hot_cache, hot_ids_from_sample
from pim_embedding_lookup_tpu_torch.parallel.mesh import init_distributed, make_mesh
from pim_embedding_lookup_tpu_torch.parallel.planner import plan
from pim_embedding_lookup_tpu_torch.parallel.sparse_update import (
    sparse_update,
    sparse_update_csr,
)
from pim_embedding_lookup_tpu_torch.tools import (
    capacity_bench,
    kernel_lab,
    phase_bench,
    scaling_bench,
    serving_bench,
    trace_capture,
    train_bench,
)
from pim_embedding_lookup_tpu_torch.tools.common import (
    call_ms,
    device_ms,
    kernel_launches,
    zero_kernel_launches,
)
from pim_embedding_lookup_tpu_torch.utils import checkpoint, native, profiling

# H100 SXM published peaks (NVIDIA data sheet), at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores

SEED = 0
BATCH = 8192
REQUESTS = 5
ID_SETS = 16  # distinct id sets cycled while timing: > 50 MB of rows, past L2
SMALL_SET_BATCH = 65536  # the small set's K1 row: the Kaggle benchmark cells' batch
# Kernel checks: f32 sums in another order; bf16 storage adds the same bf16
# values in f32 on both sides, so the same tolerance holds.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
DEV = torch.device("cuda")
# K1's launches by the hybrid's small set over f32 rows (its bf16-rounding
# instance, a row of its own in the kernel table), gathered over the phases
# that count them apart from the rest of K1's (take_k1)
SMALL_SET_K1 = [0]


def zero_k1() -> None:
    """Sets K1's launch counters to 0, the small set's among them."""
    embedding_bag_fixedl.launches = embedding_bag_fixedl.bf16_round_launches = 0


def take_k1() -> tuple[int, int]:
    """K1's launches since :func:`zero_k1`: (all but the small set's, the
    small set's bf16-rounding ones, which join SMALL_SET_K1)."""
    small = embedding_bag_fixedl.bf16_round_launches
    SMALL_SET_K1[0] += small
    return embedding_bag_fixedl.launches - small, small


class _OpCount(TorchDispatchMode):
    """Counts the ATen operations dispatched inside it (views included)."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def top_kernels(fn, n=6):
    """One call of ``fn`` under torch.profiler: the sum of its kernels'
    device times in ms, and the ``n`` largest as (name, ms, launches)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()  # kernels, not annotated ranges
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]
    return (sum(e.self_device_time_total for e in kernels) / 1e3,
            [(e.key[:72], e.self_device_time_total / 1e3, e.count) for e in top])


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


def distinct_rows(ids, keep) -> int:
    """The distinct rows among the entries of ``ids`` where ``keep`` is
    set: what a pool kernel must read at least once.  ``ids``: [N] fused,
    or [T, C], one table a row (keyed by table, so that local ids of two
    tables stay apart)."""
    if ids.dim() == 2:
        ids = ids.long() + (torch.arange(ids.shape[0], device=ids.device)[:, None] << 32)
    return int(torch.unique(ids[keep]).numel())


def in_turns(fns, id_sets) -> dict:
    """Device ms of each of ``fns`` (name -> function of one id set), timed
    in turns: in order, then in reverse (A B C C B A), so that drift over
    the run falls on every function alike.  Returns name -> [ms, ms]."""
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        times[name].append(device_ms(fns[name], id_sets))
    return times


def path_label(pin) -> str:
    """A kernel path as the lines print it: load bytes (or scalar), G and
    walk."""
    load, group, by_group = pin
    return (f"{f'{load}-byte' if load else 'scalar'} G={group} "
            f"{'by group' if by_group else 'by window'}")


def check_kernel(got, want, slack=None):
    """``got`` against the plain version's ``want`` at KERNEL_TOL, plus a
    per-element ``slack`` where one is given (:func:`order_slack`)."""
    if slack is None:
        torch.testing.assert_close(got, want, **KERNEL_TOL)
        return
    allowed = KERNEL_TOL["atol"] + KERNEL_TOL["rtol"] * want.abs() + slack
    over = (got - want).abs() - allowed
    if over.max().item() > 0:
        raise AssertionError(f"kernel differs from the plain version by "
                             f"{(got - want).abs().max().item():.3g}, past KERNEL_TOL and "
                             f"the summation bound by {over.max().item():.3g}")


def order_slack(pooled_abs, bag_len):
    """What two f32 sums of the same bag's terms in other orders may differ
    by, past KERNEL_TOL (stated for short bags): the standard bound of
    recursive summation, L * 2^-24 * sum|terms| each, twice.
    ``pooled_abs``: the plain version over |codes| with the same scales;
    ``bag_len``: the longest bag."""
    return 2 * bag_len * 2.0 ** -24 * pooled_abs


def checked_paths(run, want, paths, exact, slack=None):
    """Each pinned path of ``paths`` (name -> pin; None: the wrapper's
    choice) run on set 0 against the plain version's ``want``, at
    KERNEL_TOL (plus ``slack``, :func:`check_kernel`) and, where ``exact``
    (a row mask: bags of at most one entry) holds, bitwise.  Returns the
    largest error over the paths."""
    err = 0.0
    for name, pin in paths.items():
        got = run(pin)
        torch.cuda.synchronize()
        check_kernel(got, want, slack)
        if not torch.equal(got[exact], want[exact]):
            raise AssertionError(f"path {name}: bags of one entry differ from the plain version")
        err = max(err, (got - want).abs().max().item())
    return err


def k1_case(name, storage, d, pooling, id_sets, scale=None, f32_weight=None, paths=None,
            extra=None, abs_storage=None, plain_timing=None, round_bf16=False):
    """K1 against its plain version on set 0; kernel, plain and library
    times cycling through all sets; bound from set 0's data (each distinct
    kept row read once, every id and mask byte, the output).  int8
    ``storage`` (with ``scale`` in "row" mode) has no library call
    (``int8_library_probe``): ``f32_weight``'s F.embedding_bag, where
    given, is timed beside it as a reference point.  ``paths`` (name ->
    pinned path; "chosen" -> None, the wrapper's choice): each is held
    against the plain version (bitwise at L=1) and the paths and
    ``extra`` (name -> function of an id set) are timed in turns
    (:func:`in_turns`); the kernel's time is then the mean of the
    choice's two turns.  ``abs_storage`` (|codes| of int8 storage): the
    checks allow :func:`order_slack` past KERNEL_TOL, for long bags.
    ``plain_timing``: ``device_ms``'s calls and runs for the plain version
    and the library call (default 10 and 20; fewer where a call takes
    tens of ms).  ``round_bf16``: the small set's instance, each row
    rounded to bf16, held bitwise against the plain version at L=1; its
    library call pools a bf16 copy of the rows (rounded outside the
    timing)."""
    ids, mask = id_sets[0]
    bags = ids.numel() // pooling
    kw = dict(pooling=pooling, batch_size=bags, scale=scale, round_bf16=round_bf16)
    got = embedding_bag_fixedl(storage, d, ids, mask=mask, **kw)
    want = embedding_bag_fixedl_reference(storage, d, ids, mask=mask, **kw)
    slack = None if abs_storage is None else order_slack(
        embedding_bag_fixedl_reference(abs_storage, d, ids, mask=mask, **kw), pooling)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check_kernel(got, want, slack)
    if round_bf16 and pooling == 1 and not torch.equal(got, want):
        raise AssertionError(f"{name}: single-hot bags differ from the plain version")

    int8 = storage.dtype == torch.int8
    kernel = lambda i, m: embedding_bag_fixedl(storage, d, i, mask=m, **kw)  # noqa: E731
    turns = None
    if paths:
        exact = torch.full((bags,), pooling == 1, device=DEV)
        err = max(err, checked_paths(lambda p: embedding_bag_fixedl(
            storage, d, ids, mask=mask, path=p, **kw), want, paths, exact, slack))
        fns = {n: (lambda i, m, p=p: embedding_bag_fixedl(storage, d, i, mask=m, path=p, **kw))
               for n, p in paths.items()}
        turns = in_turns({**fns, **(extra or {})}, id_sets)
        kernel_ms = statistics.mean(turns["chosen"])
    else:
        kernel_ms = device_ms(kernel, id_sets)
    kernel_call_ms = call_ms(kernel, id_sets)
    plain_ms = device_ms(
        lambda i, m: embedding_bag_fixedl_reference(storage, d, i, mask=m, **kw), id_sets,
        **(plain_timing or {}))
    embedding_bag_ms = None
    weight = f32_weight if int8 else storage
    if weight is not None:
        weight = weight.view(-1, d)
        if round_bf16:
            weight = weight.to(torch.bfloat16)
        offsets = torch.arange(0, ids.numel(), pooling, dtype=torch.int32, device=DEV)
        lib_sets = [(i, m.to(weight.dtype)) for i, m in id_sets]
        embedding_bag_ms = device_ms(
            lambda i, w: F.embedding_bag(i, weight, offsets, mode="sum", per_sample_weights=w),
            lib_sets, **(plain_timing or {}))

    active = int(mask.sum().item())
    rows = distinct_rows(ids, mask)
    bound_ms, bound_by = bound(
        rows * d * storage.element_size()  # each distinct kept row read once
        + rows * 4 * (scale is not None)  # its f32 scale
        + ids.numel() * 5  # int32 id + 1-byte mask per entry
        + bags * d * 4,  # f32 output
        active * d * (1 + (scale is not None)))  # an add (and a multiply) per value
    row = dict(case=name, dtype=str(storage.dtype).replace("torch.", "")
               + (" rounded to bf16" if round_bf16 else ""),
               bags=bags, pooling=pooling, d=d, active_entries=active,
               distinct_rows=rows, max_abs_err=err, kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
               plain_ms=plain_ms, library_ms=None if int8 else embedding_bag_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if int8:
        row.update(scale_mode="row" if scale is not None else "table",
                   f32_embedding_bag_ms=embedding_bag_ms)
    if turns:
        chosen = kernel_path(storage, d, ids.numel(), bags)
        row.update(path=path_label(chosen), paths={
            n: path_label(chosen if p is None else p) for n, p in paths.items()},
            turns_ms=turns)
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
    random mask and an all-false mask; :func:`compaction_cases`), and
    repeated launches bitwise equal.  Padding and masked entries hold ids
    that fault if read.  Returns the number of cases."""
    cases, paths = 0, set()
    for dtype, d in itertools.product((torch.float32, torch.bfloat16),
                                      (1, 4, 16, 20, 128, 256)):
        layouts = ["unpacked", "unaligned"] + (["packed"] if d < 128 and 128 % d == 0 else [])
        for layout in layouts:
            storage = edge_storage(gen, d, dtype, layout)
            row = kernel_path(storage, d, 1, 1)  # the row path; the walk is per case
            vector, group = row.load > 0, row.group
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
            cases += compaction_cases(gen, storage, d)
    torch.cuda.synchronize()
    if len(paths) != 8:  # K1, K2 x vector, scalar x window, by group
        raise AssertionError(f"edge cases reached only the paths {sorted(paths)}")
    return cases


# where compaction can slip: the edges of a 32-id window and of a by-group
# round of G*U entries (G a power of two up to 32, U 2 or 4), as positions in
# a bag; EDGE_LONG entries a bag reach them all
EDGE_KEPT = sorted({0, 31, 32, 33} | {g * u + k for g in (1, 2, 4, 8, 16, 32)
                                       for u in (2, 4) for k in (-1, 0, 1)})
EDGE_LONG = EDGE_KEPT[-1] + 3


def edge_keep(lens):
    """[bags, max(lens)] keep masks of bags of ``lens`` entries, by bag: the
    EDGE_KEPT positions (shifted by 0, 1 or 2, so that tiles meet them at
    every alignment), nothing, all but those positions, the first and the
    last entry only."""
    keep = torch.zeros(len(lens), max(max(lens), 1), dtype=torch.bool)
    for b, n in enumerate(lens):
        kind, shift = b % 4, (b // 4) % 3
        edge = [p + shift for p in EDGE_KEPT if p + shift < n]
        if kind == 0:
            keep[b, edge] = True
        elif kind == 2:
            keep[b, :n] = True
            keep[b, edge] = False
        elif kind == 3 and n:
            keep[b, [0, n - 1]] = True
    return keep.to(DEV)


def compaction_cases(gen, storage, d, scale=None) -> int:
    """K1 and K2 over bags whose kept entries sit at the compaction's edges
    (EDGE_KEPT; bags with nothing kept; an all-false mask), on both walks
    pinned: each bitwise the sum of each bag's kept entries in entry order
    (:func:`entry_order_sum`), within KERNEL_TOL of the plain version, the
    bags with nothing kept exactly zero, repeated launches bitwise equal.
    Masked and padding entries hold NEVER_READ.  Returns the number of
    cases."""
    cases = 0
    lens = [EDGE_LONG] * EDGE_BAGS
    k1_off = (torch.arange(EDGE_BAGS + 1, device=DEV, dtype=torch.int32) * EDGE_LONG)[None]
    for all_false in (False, True):
        keep = edge_keep(lens) & (not all_false)
        n = EDGE_BAGS * EDGE_LONG
        ids = torch.randint(0, EDGE_ROWS, (n,), generator=gen, device=DEV, dtype=torch.int32)
        mask = keep.reshape(-1).contiguous()
        read = torch.where(mask, ids, NEVER_READ)
        kw = dict(pooling=EDGE_LONG, batch_size=EDGE_BAGS, mask=mask, scale=scale)
        compaction_check(f"K1 {storage.dtype} d={d}, all-false mask {all_false}",
                         lambda p: embedding_bag_fixedl(storage, d, read, path=p, **kw),
                         kernel_path(storage, d, n, EDGE_BAGS),
                         embedding_bag_fixedl_reference(storage, d, ids, **kw),
                         entry_order_sum(storage, d, read[None], k1_off, mask[None], scale),
                         ~keep.any(dim=1))
        cases += 1
    # K2: two tables of long bags, empty bags and bags of 1, 33 and 64 entries
    lens = [[[EDGE_LONG, 0, 1, 33, EDGE_LONG, 64][(b + t) % 6] for b in range(EDGE_BAGS)]
             for t in range(2)]
    off = torch.zeros(2, EDGE_BAGS + 1, dtype=torch.int32, device=DEV)
    off[:, 1:] = torch.tensor(lens, device=DEV).cumsum(dim=1)
    cap = int(off[:, -1].max().item()) + 8
    for all_false in (False, True):
        mask = torch.zeros(2, cap, dtype=torch.bool, device=DEV)
        none_kept = []
        for t in range(2):
            keep = edge_keep(lens[t]) & (not all_false)
            for b, n in enumerate(lens[t]):
                start = int(off[t, b].item())
                mask[t, start:start + n] = keep[b, :n]
            none_kept.append(~keep.any(dim=1))
        idx = torch.randint(0, EDGE_ROWS, (2, cap), generator=gen, device=DEV, dtype=torch.int32)
        read = torch.where(mask, idx, NEVER_READ)  # padding past offsets[B] is never kept
        kw = dict(batch_size=EDGE_BAGS, mask=mask, scale=scale)
        compaction_check(f"K2 {storage.dtype} d={d}, all-false mask {all_false}",
                         lambda p: embedding_bag_csr_packed(storage, d, read, off, path=p, **kw),
                         kernel_path(storage, d, cap, EDGE_BAGS),
                         embedding_bag_csr_packed_reference(storage, d, idx, off, **kw),
                         entry_order_sum(storage, d, read, off, mask, scale),
                         torch.cat(none_kept))
        cases += 1
    return cases


def compaction_check(what, run, chosen, want, order, none_kept):
    """One compaction case: ``run(path)`` on the wrapper's path, on each
    walk pinned (``chosen`` by window and by group) and on the wrapper's
    path again, each bitwise ``order`` (the sum in entry order), within
    KERNEL_TOL of the plain ``want``, and zero where a bag kept nothing."""
    runs = [run(None)] + [run(chosen._replace(by_group=bg)) for bg in (False, True)] + [
        run(None)]
    torch.cuda.synchronize()
    torch.testing.assert_close(runs[0], want, **KERNEL_TOL)
    for i, got in enumerate(runs):
        if not torch.equal(got, order):
            raise AssertionError(f"compaction case {what}: run {i} (wrapper's, window, group, "
                                 "wrapper's again) differs bitwise from the sum in entry "
                                 f"order by {(got - order).abs().max().item():.3g}")
    if not torch.equal(runs[0][none_kept], torch.zeros_like(runs[0][none_kept])):
        raise AssertionError(f"compaction case {what}: a bag that kept nothing is not 0")


def entry_order_sum(storage, d, idx, off, mask=None, scale=None):
    """The pool kernels' sum in plain torch: each bag's kept entries added
    in f32 in entry order, code times scale where ``scale`` is given.
    [T*B, d] for [T, C] ids and [T, B+1] offsets (K1's bags: offsets 0, L,
    2L, ...); the kernels' output bitwise.  Masked entries and padding are
    never read."""
    t, c = idx.shape
    starts = (off[:, :-1].long() + torch.arange(t, device=DEV)[:, None] * c).reshape(-1)
    lens = (off[:, 1:] - off[:, :-1]).reshape(-1)
    flat, rows = idx.reshape(-1), storage.reshape(-1, d)
    acc = torch.zeros(starts.numel(), d, device=DEV)
    for k in range(int(lens.max().item()) if lens.numel() else 0):
        live = k < lens
        pos = torch.where(live, starts + k, 0)
        if mask is not None:
            live &= mask.reshape(-1)[pos].bool()
        ids = torch.where(live, flat[pos], 0).long()
        add = rows[ids].float()
        if scale is not None:
            add = add * scale[ids][:, None]
        acc = acc + torch.where(live[:, None], add, 0.0)
    return acc


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


def compact(idx, off, mask=None):
    """All tables' valid entries back to back, and [T*B+1] offsets into
    them: the input of one F.embedding_bag call over every table; with a
    [T, C] mask also its valid entries as f32 per-sample weights."""
    t, b = off.shape[0], off.shape[1] - 1
    ends = off[:, -1].tolist()
    flat = torch.cat([idx[i, :ends[i]] for i in range(t)])
    base = torch.tensor([0] + ends[:-1], device=DEV).cumsum(0)
    flat_off = torch.cat([(off[:, :-1] + base[:, None]).reshape(-1),
                          torch.tensor([sum(ends)], device=DEV)])
    if mask is None:
        return flat.long(), flat_off.long()
    weights = torch.cat([mask[i, :ends[i]] for i in range(t)]).float()
    return flat.long(), flat_off.long(), weights


def csr_case(tag, name, storage, d, id_sets, scale=None, f32_weight=None, paths=None,
             extra=None, abs_storage=None, plain_timing=None):
    """K2/K3 against its plain version on set 0 (fused ids [T, C], offsets
    [T, B+1], and for a row shard its [T, C] ownership mask); kernel, plain
    and library times cycling through all sets; bound from set 0's data:
    the ids of valid entries only (padding is not read), each distinct row
    of a kept entry read once (not the rows of masked entries).  int8 ``storage``, ``paths``, ``extra``, ``abs_storage`` and
    ``plain_timing``: as in k1_case (bitwise on the bags of at most one
    entry)."""
    idx, off, *masked = id_sets[0]
    mask = masked[0] if masked else None
    t, b = off.shape[0], off.shape[1] - 1
    kw = dict(batch_size=b, scale=scale)
    got = embedding_bag_csr_packed(storage, d, idx, off, mask=mask, **kw)
    want = embedding_bag_csr_packed_reference(storage, d, idx, off, mask=mask, **kw)
    slack = None if abs_storage is None else order_slack(
        embedding_bag_csr_packed_reference(abs_storage, d, idx, off, mask=mask, **kw),
        int((off[:, 1:] - off[:, :-1]).max().item()))
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    check_kernel(got, want, slack)

    int8 = storage.dtype == torch.int8
    kernel = lambda i, o, *m: embedding_bag_csr_packed(  # noqa: E731
        storage, d, i, o, mask=m[0] if m else None, **kw)
    turns = None
    if paths:
        exact = ((off[:, 1:] - off[:, :-1]) <= 1).reshape(-1)
        err = max(err, checked_paths(lambda p: embedding_bag_csr_packed(
            storage, d, idx, off, mask=mask, path=p, **kw), want, paths, exact, slack))
        fns = {n: (lambda i, o, *m, p=p: embedding_bag_csr_packed(
                   storage, d, i, o, mask=m[0] if m else None, path=p, **kw))
               for n, p in paths.items()}
        turns = in_turns({**fns, **(extra or {})}, id_sets)
        kernel_ms = statistics.mean(turns["chosen"])
    else:
        kernel_ms = device_ms(kernel, id_sets)
    kernel_call_ms = call_ms(kernel, id_sets)
    plain_ms = device_ms(lambda i, o, *m: embedding_bag_csr_packed_reference(
        storage, d, i, o, mask=m[0] if m else None, **kw), id_sets, **(plain_timing or {}))
    embedding_bag_ms = None
    weight = f32_weight if int8 else storage
    if weight is not None:
        weight = weight.view(-1, d)
        lib_sets = [(i, o, *(w.to(weight.dtype) for w in ws))  # before the timed region
                    for i, o, *ws in (compact(*s) for s in id_sets)]
        embedding_bag_ms = device_ms(lambda i, o, *w: F.embedding_bag(
            i, weight, o, mode="sum", include_last_offset=True,
            per_sample_weights=w[0] if w else None), lib_sets, **(plain_timing or {}))

    valid = torch.arange(idx.shape[1], device=DEV)[None, :] < off[:, -1:]
    active = int(valid.sum().item())
    kept = valid if mask is None else valid & mask
    read = int(kept.sum().item())
    rows = distinct_rows(idx, kept)
    bound_ms, bound_by = bound(
        rows * d * storage.element_size()  # each distinct kept row read once
        + rows * 4 * (scale is not None)  # its f32 scale
        + active * (4 + (mask is not None))  # ids, and mask bytes
        + t * (b + 1) * 4  # offsets
        + t * b * d * 4,  # f32 output
        read * d * (1 + (scale is not None)))
    row = dict(case=name, dtype=str(storage.dtype).replace("torch.", ""),
               tables=t, bags=b, capacity=idx.shape[1], d=d, active_entries=active,
               rows_read=read, distinct_rows=rows, max_abs_err=err, kernel_ms=kernel_ms,
               kernel_call_ms=kernel_call_ms, plain_ms=plain_ms,
               library_ms=None if int8 else embedding_bag_ms,
               bound_ms=bound_ms, bound_by=bound_by)
    if int8:
        row.update(scale_mode="row" if scale is not None else "table",
                   f32_embedding_bag_ms=embedding_bag_ms)
    if turns:
        chosen = kernel_path(storage, d, idx.shape[1], b)
        row.update(path=path_label(chosen), paths={
            n: path_label(chosen if p is None else p) for n, p in paths.items()},
            turns_ms=turns)
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
    rows = distinct_rows(idx[:active], torch.ones(active, dtype=torch.bool, device=DEV))
    fwd.update(zip(("bound_ms", "bound_by"), bound(
        rows * d * 4 + active * 4 + (BATCH + 1) * 4 + BATCH * d * 4, active * d)))
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


def k4_masked_case(name, storage, d, id_sets, gen):
    """K4's backward with a row shard's ownership mask against its plain
    version on set 0 (the shard's owner-local ids [T, C], offsets [T, B+1]
    and mask [T, C]); kernel, plain and library times cycling through all
    sets: the library's is the backward of F.embedding_bag with the mask as
    per-sample weights, a dense gradient too.  Bound from set 0's data: g,
    the offsets, a mask byte a valid entry, the ids of the kept ones, and
    the shard's dense f32 gradient written once."""
    idx, off, mask = id_sets[0]
    t, b = off.shape[0], off.shape[1] - 1
    rows = storage.numel() // d
    g = torch.randn(t * b, d, generator=gen, device=DEV)
    got = embedding_bag_csr_grad(g, idx, off, rows, mask)
    want = embedding_bag_csr_grad_reference(g, idx, off, rows, mask)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    # f32 atomicAdd sums rows shared by several bags in a run-dependent order
    torch.testing.assert_close(got, want, **KERNEL_TOL)
    del got, want

    kernel = lambda i, o, m: embedding_bag_csr_grad(g, i, o, rows, m)  # noqa: E731
    kernel_ms = device_ms(kernel, id_sets)
    kernel_call_ms = call_ms(kernel, id_sets)
    plain_ms = device_ms(lambda i, o, m: embedding_bag_csr_grad_reference(g, i, o, rows, m),
                         id_sets)
    weight = storage.view(-1, d).clone().requires_grad_(True)
    lib_outs = [(F.embedding_bag(i, weight, o, mode="sum", include_last_offset=True,
                                 per_sample_weights=w),)
                for i, o, w in (compact(*s) for s in id_sets)]
    library_ms = device_ms(lambda o: torch.autograd.grad(o, weight, g, retain_graph=True),
                           lib_outs)
    del lib_outs, weight

    valid = torch.arange(idx.shape[1], device=DEV)[None, :] < off[:, -1:]
    active = int(valid.sum().item())
    kept = int((valid & mask).sum().item())
    bound_ms, bound_by = bound(
        t * b * d * 4 + t * (b + 1) * 4  # g and the offsets read
        + active + kept * 4  # a mask byte a valid entry, the kept ids
        + rows * d * 4,  # the dense f32 gradient, written once
        kept * d)
    row = dict(case=name, tables=t, bags=b, capacity=idx.shape[1], d=d, rows=rows,
               active_entries=active, kept_entries=kept, max_abs_err=err,
               kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
    print("K4 backward masked " + json.dumps(row), flush=True)
    return row


# -- int8: the capacity mode --------------------------------------------------

SCALE_MODES = ("table", "row")
# int8 against f32 logits: the bound of tests/test_quantize_serving.py
INT8_LOGIT_ATOL = 0.05
# 8-byte loads or 4-byte words where the rows take them, the scalar path
INT8_EDGE = ((16, "packed"), (16, "unpacked"), (32, "unpacked"), (4, "unpacked"),
             (20, "unpacked"), (64, "packed"), (16, "unaligned"), (4, "unaligned"))
# the capacity bench's width: 4 tables of 5M rows of 64 codes (1.28 GB, far
# past the 50 MB L2), B=8192 at L=1; and cli sweep's int8 points, 32 tables
# x B=64 at L=120, over the same rows
WIDE_TABLES, WIDE_ROWS, WIDE_D = 4, 5_000_000, 64
SWEEP_BAGS, SWEEP_TABLES, SWEEP_L = 64, 32, 120
WIDE_ID_SETS = 32  # 32 x 2 MB of rows at L=1: past L2
# where the wrapper turns from 8-byte to 4-byte int8 row loads: both pinned
# at these pooling factors, at the Kaggle width (10 tables, d=16) and the
# capacity width (4 tables, d=64), B=8192 a table
CROSS_L = (1, 2, 3, 4, 8, 16)
CROSS_SHAPES = ((16, 10), (WIDE_D, WIDE_TABLES))  # (d, tables)
CROSS_ID_SETS = 8  # 8 x 5-42 MB of rows a shape


def int8_paths(storage, d, entries, bags) -> dict:
    """The int8 paths timed in turns, by name: the wrapper's choice (8-byte
    loads for short bags, 4-byte words for long ones), and each of those
    loads pinned.  Each falls back to the scalar path where the storage
    does not take its load."""
    return {"chosen": None, "8-byte": fitted_path(storage, d, entries, bags, 8),
            "4-byte": fitted_path(storage, d, entries, bags, 4)}


def int8_edge_storage(gen, d, layout):
    """[EDGE_ROWS, d] int8 codes with row 0 all zero, as edge_storage lays
    them out, and per-row f32 scales with row 0's 1 (a zero row's scale)."""
    q = torch.randint(-127, 128, (EDGE_ROWS, d), generator=gen, device=DEV, dtype=torch.int8)
    q[0] = 0
    scale = torch.rand(EDGE_ROWS, generator=gen, device=DEV) * 0.02 + 1e-4
    scale[0] = 1.0
    if layout == "packed":
        return q.reshape(-1, 128), scale
    if layout == "unaligned":
        buf = torch.empty(EDGE_ROWS * d + 1, dtype=torch.int8, device=DEV)
        buf[1:] = q.reshape(-1)
        return buf[1:].view(EDGE_ROWS, d), scale
    return q, scale


def int8_edge_phase(gen):
    """int8 K1 and K2 against their plain versions at toy sizes, in both
    scale modes, on the wrapper's path (8-byte loads, or 4-byte words for
    long bags and d = 4, 20: d = 4, 20, 32, 16 and 64 packed and unpacked;
    the scalar path: d = 16 and 4 one byte into their buffers); both id
    walks; K2 unmasked and with a row shard's mask; K1 at L = 1, 3, 9 with
    no mask, a random mask and an all-false one; row 0 all zero with scale
    1; :func:`compaction_cases` in each scale mode.  Padding and masked
    entries hold ids that fault if read (a read of their scales would too).
    Repeated launches bitwise equal, and at L = 1 equal to the plain
    version.  Returns the number of cases."""
    cases, paths = 0, set()
    for (d, layout), mode in itertools.product(INT8_EDGE, SCALE_MODES):
        storage, scale = int8_edge_storage(gen, d, layout)
        scale = scale if mode == "row" else None
        cases += compaction_cases(gen, storage, d, scale)
        for (tables, max_len, empty), masked in itertools.product(
                ((1, 40, False), (10, 6, False), (3, 3, True), (2, 100, False)), (False, True)):
            idx, off = edge_csr(gen, tables, max_len, empty)
            used = kernel_path(storage, d, idx.shape[1], EDGE_BAGS)
            clean = torch.where(idx == NEVER_READ, 0, idx)
            mask = torch.rand(idx.shape, generator=gen, device=DEV) < 0.5 if masked else None
            read = torch.where(mask, idx, NEVER_READ) if masked else idx
            kw = dict(batch_size=EDGE_BAGS, mask=mask, scale=scale)
            got = embedding_bag_csr_packed(storage, d, read, off, **kw)
            again = embedding_bag_csr_packed(storage, d, read, off, **kw)
            want = embedding_bag_csr_packed_reference(storage, d, clean, off, **kw)
            torch.testing.assert_close(got, want, **KERNEL_TOL)
            if not torch.equal(got, again):
                raise AssertionError(f"int8 K2 not deterministic: d={d} {layout} {mode}")
            cases += 1
            paths.add(("K2", used.load > 0, used.by_group))
        for pooling, masking in itertools.product((1, 3, 9), ("none", "random", "false")):
            n = EDGE_BAGS * pooling
            used = kernel_path(storage, d, n, EDGE_BAGS)
            ids = torch.randint(0, EDGE_ROWS, (n,), generator=gen, device=DEV, dtype=torch.int32)
            mask = {"none": None,
                    "random": torch.rand(n, generator=gen, device=DEV) < 0.6,
                    "false": torch.zeros(n, dtype=torch.bool, device=DEV)}[masking]
            read = ids if mask is None else torch.where(mask, ids, NEVER_READ)
            kw = dict(pooling=pooling, batch_size=EDGE_BAGS, mask=mask, scale=scale)
            got = embedding_bag_fixedl(storage, d, read, **kw)
            again = embedding_bag_fixedl(storage, d, read, **kw)
            want = embedding_bag_fixedl_reference(storage, d, ids, **kw)
            torch.testing.assert_close(got, want, **KERNEL_TOL)
            if not torch.equal(got, again) or (pooling == 1 and not torch.equal(got, want)):
                raise AssertionError(f"int8 K1 not deterministic, or not exact at L=1: d={d} "
                                     f"{layout} {mode}")
            cases += 1
            paths.add(("K1", used.load > 0, used.by_group))
    torch.cuda.synchronize()
    if len(paths) != 8:  # K1, K2 x vector, scalar x window, by group
        raise AssertionError(f"int8 edge cases reached only the paths {sorted(paths)}")
    return cases


def int8_library_probe():
    """Whether a PyTorch call on the card pools int8 rows with per-row
    scales.  F.embedding_bag takes no int8 weight; PyTorch's one candidate
    is torch.ops.quantized.embedding_bag_byte_rowwise_offsets (FBGEMM's
    8-bit rowwise rows: uint8 codes, then an f32 scale and bias), called
    here on CUDA tensors.  Returns None where it runs, else its error."""
    w = torch.zeros(4, 16 + 8, dtype=torch.uint8, device=DEV)
    idx = torch.zeros(2, dtype=torch.long, device=DEV)
    off = torch.tensor([0, 1], dtype=torch.long, device=DEV)
    try:
        torch.ops.quantized.embedding_bag_byte_rowwise_offsets(
            w, idx, off, False, 0, False, None, None, False)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 -- the error is the finding
        return f"{type(e).__name__}: {str(e).strip().splitlines()[0][:200]}"
    return None


def rowwise_library_ms(q, d, scale, id_sets, fixed_l):
    """Device ms of the 8-bit rowwise library bag on the same rows (codes +
    128 with the row's scale and a bias of -128 * scale, so each row is
    code * scale, converted before the timing), where int8_library_probe
    finds that it runs.  Its output on set 0 is held against the plain
    version first (1e-5): where they differ it does not compute the same
    function, and the result is None with the difference.  Returns (ms or
    None, what was found)."""
    u8 = (q.view(-1, d).int() + 128).to(torch.uint8)
    fused = torch.cat([u8, scale[:, None].contiguous().view(torch.uint8),
                       (-128.0 * scale)[:, None].contiguous().view(torch.uint8)], dim=1)
    del u8
    op = torch.ops.quantized.embedding_bag_byte_rowwise_offsets
    if fixed_l:
        sets = [(i.long(), torch.arange(0, i.numel(), fixed_l, device=DEV), m.float())
                for i, m in id_sets]
        fn = lambda i, o, w: op(fused, i, o, False, 0, False, w, None, False)  # noqa: E731
        ids, mask = id_sets[0]
        want = embedding_bag_fixedl_reference(q, d, ids, pooling=fixed_l, mask=mask,
                                              batch_size=ids.numel() // fixed_l, scale=scale)
    else:
        sets = [compact(*s) for s in id_sets]
        fn = lambda i, o: op(fused, i, o, False, 0, False, None, None, True)  # noqa: E731
        idx, off = id_sets[0]
        want = embedding_bag_csr_packed_reference(q, d, idx, off, batch_size=off.shape[1] - 1,
                                                  scale=scale)
    try:
        torch.testing.assert_close(fn(*sets[0]), want, **KERNEL_TOL)
    except AssertionError as e:
        return None, "output differs from the plain version's: " + str(e).splitlines()[0]
    return device_ms(fn, sets), "output equal to the plain version's (1e-5)"


def int8_phase(gen, card):
    """The capacity mode at full Kaggle rows (the f32 hybrid DLRM of the
    serving phases, from a seed): ``quantize_dlrm_embeddings`` in both
    scale modes (bytes, time, small set unchanged); int8 K1 on dense-wire
    sets and int8 K2 on CSR-wire sets against their plain versions, timed
    with their bound; then 5 requests on each wire in each mode, served
    through the int8 big set and ``apply_from_pooled`` beside the f32
    model's, with only that mode's int8 set resident on the card (the f32
    big set sits on the host meanwhile): int8 K1 / K2 once a request,
    logits equal to the plain-pooled path (atol 1e-4) and within
    INT8_LOGIT_ATOL of the f32 logits.  Returns the kernel rows and the
    int8 launches of the served requests, keyed by (K, mode)."""
    config = kaggle_config()
    t0 = time.perf_counter()
    model = DLRM(config, ShardingPolicy.REPLICATE, hybrid=True, device=DEV,
                 generator=torch.Generator(device=DEV).manual_seed(SEED + 7))
    torch.cuda.synchronize()
    big = model.collection.big
    f32_bytes = model.emb_big.numel() * 4
    print(f"int8: full-row Kaggle hybrid, big set {tuple(model.emb_big.shape)} f32 "
          f"({f32_bytes / 1e9:.3f} GB), built in {time.perf_counter() - t0:.2f} s", flush=True)
    probe = int8_library_probe()
    print("int8 library: F.embedding_bag takes no int8 weight; "
          "torch.ops.quantized.embedding_bag_byte_rowwise_offsets on CUDA tensors: "
          + ("runs (timed as library_ms)" if probe is None else f"refused ({probe})"),
          flush=True)

    reqs = {"dense": [request(config, gen, BATCH) for _ in range(REQUESTS + 1)],
            "CSR": [csr_request(config, gen, BATCH) for _ in range(REQUESTS + 1)]}
    f32_fns = {"dense": model, "CSR": lambda *r: serve_csr(model, *r)}
    f32_ref, report = {}, {}
    with torch.no_grad():
        for wire, fn in f32_fns.items():
            f32_ref[wire], report[("f32", wire)], _ = _int8_serve_stats(fn, reqs[wire])
    main_sets = [kaggle_ids(big, gen, BATCH, 1, 1.0) for _ in range(ID_SETS)]
    csr_sets = [(big.globalize(i).contiguous(), o)
                for i, o in (csr_ids(big.layout.table_rows, gen, BATCH, 1)
                             for _ in range(ID_SETS))]
    rows, launches, f32_host = {}, {}, None
    for mode in SCALE_MODES:
        if f32_host is not None:
            model.emb_big = f32_host.to(DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        coll, emb = quantize_dlrm_embeddings(model, scale_mode=mode)
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
        p = emb["big"]
        scale = p.get("scale")
        int8_bytes = p["q"].numel() + (0 if scale is None else scale.numel() * 4)
        if emb["small"] is not model.emb_small:
            raise AssertionError("int8: the small set was not kept as it is")
        print(f"int8 {mode} mode: quantize_dlrm_embeddings in {q_s:.3f} s on the card; big "
              f"set {p['q'].numel() / 1e9:.3f} GB of int8 codes"
              + ("" if scale is None else f" + {scale.numel() * 4 / 1e9:.3f} GB of f32 "
                 "row scales") + f" = {int8_bytes / 1e9:.3f} GB against "
              f"{f32_bytes / 1e9:.3f} GB f32; the small set is the f32 model's tensor, "
              "unchanged", flush=True)
        n_main = main_sets[0][0].numel()
        rows[("K1", mode)] = k1_case(
            f"int8 {mode} mode, main path (10 tables x B=8192, L=1, packed)", p["q"], 16, 1,
            main_sets, scale=scale, f32_weight=model.emb_big,
            paths=int8_paths(p["q"], 16, n_main, n_main),
            extra={"f32 K1": lambda i, m: embedding_bag_fixedl(  # the f32 big set's K1
                model.emb_big, 16, i, mask=m, pooling=1, batch_size=n_main)})
        rows[("K2", mode)] = csr_case(
            "K2", f"int8 {mode} mode, CSR path (10 tables x B=8192, pooling-1 mixture, "
            "packed)", p["q"], 16, csr_sets, scale=scale, f32_weight=model.emb_big,
            paths=int8_paths(p["q"], 16, csr_sets[0][0].shape[1], BATCH),
            extra={"f32 K2": lambda i, o: embedding_bag_csr_packed(
                model.emb_big, 16, i, o, batch_size=BATCH)})
        if probe is None:
            sc = scale
            if sc is None:  # the table's scale on each of its rows (REPLICATE order)
                sc = torch.ones(big.layout.total_rows, device=DEV)
                for t, (o, r) in enumerate(zip(big.layout.row_offsets, big.layout.table_rows)):
                    sc[o:o + r] = p["tscale"][t]
            for kk, sets, fixed_l in (("K1", main_sets, 1), ("K2", csr_sets, 0)):
                ms, found = rowwise_library_ms(p["q"], 16, sc, sets, fixed_l)
                rows[(kk, mode)]["library_ms"] = ms
                print(f"int8 {mode} mode {kk}: library_ms (8-bit rowwise bag) {ms}; "
                      f"{found}; {card}", flush=True)
            del sc
        f32_host = model.emb_big.cpu()
        model.emb_big = None  # only this mode's int8 big set stays on the card
        fns = {"dense": lambda d_, i, m: model.apply_from_pooled(
                   d_, coll.lookup(emb, i, m, batch_size=d_.shape[0])),
               "CSR": lambda d_, i, o: model.apply_from_pooled(d_, coll.lookup_csr(emb, i, o))}
        with torch.no_grad():
            for wire, fn in fns.items():
                outs, stats, got = _int8_serve_stats(fn, reqs[wire])
                k = 0 if wire == "dense" else 1
                want = [(0, 0, 0), (0, 0, 0)]
                want[k] = (REQUESTS, REQUESTS, REQUESTS * (mode == "row"))
                if got != want:
                    raise AssertionError(f"int8 {mode} {wire}: K1, K2 (all, int8, row scale) "
                                         f"launched {got}, expected {want}")
                launches[("K1" if k == 0 else "K2", mode)] = REQUESTS
                patched = "embedding_bag_fixedl" if k == 0 else "embedding_bag_csr_packed"
                plain = (embedding_bag_fixedl_reference if k == 0
                         else embedding_bag_csr_packed_reference)
                with mock.patch.object(collection_mod, patched, plain):
                    for req, out in zip(reqs[wire], outs):
                        torch.testing.assert_close(out, fn(*req), rtol=0, atol=1e-4)
                f32_err = max((o - r).abs().max().item() for o, r in zip(outs, f32_ref[wire]))
                if f32_err > INT8_LOGIT_ATOL:
                    raise AssertionError(f"int8 {mode} {wire}: logits {f32_err} from f32")
                stats["max_abs_err_vs_f32"] = f32_err
                report[(mode, wire)] = stats
                print(f"int8 {mode} mode, {wire} wire, {REQUESTS} requests of B={BATCH}: "
                      f"ms/request {stats['ms']}, median {stats['median_ms']:.4f} (f32 "
                      f"{report[('f32', wire)]['median_ms']:.4f}); device ms/request "
                      f"{stats['device_ms']:.4f} (f32 {report[('f32', wire)]['device_ms']:.4f}); "
                      f"idle share {stats['idle_share']:.3f}; ATen operations "
                      f"{stats['aten_ops']}; peak memory {stats['peak_gb']:.3f} GB (f32 "
                      f"{report[('f32', wire)]['peak_gb']:.3f}); int8 "
                      f"{'K1' if k == 0 else 'K2'} once a request; logits finite, equal to "
                      "the plain-pooled path (atol 1e-4), max abs difference from the f32 "
                      f"model's {f32_err:.4g} (bound {INT8_LOGIT_ATOL}); {card}", flush=True)
        del coll, emb, p, scale
    print("int8 serve: summary " + json.dumps({f"{m} {w}": r for (m, w), r in report.items()}),
          flush=True)
    del model, f32_host, main_sets, csr_sets, reqs
    free_card()
    rows.update(int8_wide_rows(gen, card, probe is None))
    return rows, launches


def int8_wide_rows(gen, card, library):
    """int8 K1 and K2 at the capacity bench's width, d = 64, over 4 tables
    of 5M rows (1.28 GB of codes, lane-packed), B=8192 at L=1 (K2 on the
    pooling-1 mixture), and at cli sweep's int8 shape, 32 tables x B=64 at
    L=120 over the same rows (K2 on the same fixed bags as CSR), in both
    scale modes: each path of :func:`int8_paths` against the plain version
    (at L=120 with :func:`order_slack`: 120 products of up to 127 times
    0.02 a bag) and timed in turns, the plain version, the bound and (where
    ``library``) the 8-bit rowwise library bag.  Returns the rows, keyed by
    (K, mode, shape)."""
    t0 = time.perf_counter()
    n, d = WIDE_TABLES * WIDE_ROWS, WIDE_D
    q = torch.randint(-127, 128, (n * d // 128, 128), generator=gen, device=DEV,
                      dtype=torch.int8)
    q_abs = q.abs()
    row_scale = torch.rand(n, generator=gen, device=DEV) * 0.02 + 1e-4
    base = torch.arange(WIDE_TABLES, device=DEV, dtype=torch.int32) * WIDE_ROWS
    k1_sets = [((torch.randint(0, WIDE_ROWS, (WIDE_TABLES, BATCH), generator=gen, device=DEV,
                               dtype=torch.int32) + base[:, None]).reshape(-1),
                torch.ones(WIDE_TABLES * BATCH, dtype=torch.bool, device=DEV))
               for _ in range(WIDE_ID_SETS)]
    k2_sets = [((i + base[:, None]).contiguous(), o) for i, o in (
        csr_ids([WIDE_ROWS] * WIDE_TABLES, gen, BATCH, 1) for _ in range(WIDE_ID_SETS))]
    bags = SWEEP_TABLES * SWEEP_BAGS
    long_ids = [torch.randint(0, n, (bags * SWEEP_L,), generator=gen, device=DEV,
                              dtype=torch.int32) for _ in range(ID_SETS)]
    long_off = (torch.arange(SWEEP_BAGS + 1, device=DEV, dtype=torch.int32)
                * SWEEP_L).expand(SWEEP_TABLES, -1).contiguous()
    l120_k1 = [(i, torch.ones_like(i, dtype=torch.bool)) for i in long_ids]
    l120_k2 = [(i.view(SWEEP_TABLES, -1), long_off) for i in long_ids]
    torch.cuda.synchronize()
    print(f"int8 wide: {WIDE_TABLES} tables x {WIDE_ROWS} rows x {d} codes, "
          f"{q.numel() / 1e9:.3f} GB lane-packed + {row_scale.numel() * 4 / 1e9:.3f} GB of row "
          f"scales, built in {time.perf_counter() - t0:.2f} s", flush=True)
    rows = {}
    for mode in SCALE_MODES:
        scale = row_scale if mode == "row" else None
        scaled = scale is not None
        cases = (
            ("K1", "d=64", lambda: k1_case(
                f"int8 {mode} mode, capacity width ({WIDE_TABLES} tables x B={BATCH}, L=1, "
                "d=64, packed)", q, d, 1, k1_sets, scale=scale,
                paths=int8_paths(q, d, WIDE_TABLES * BATCH, WIDE_TABLES * BATCH)),
             k1_sets, 1),
            ("K2", "d=64", lambda: csr_case(
                "K2", f"int8 {mode} mode, capacity width ({WIDE_TABLES} tables x B={BATCH}, "
                "pooling-1 mixture, d=64, packed)", q, d, k2_sets, scale=scale,
                paths=int8_paths(q, d, k2_sets[0][0].shape[1], BATCH)),
             k2_sets, 0),
            ("K1", "L=120", lambda: k1_case(
                f"int8 {mode} mode, sweep shape ({SWEEP_TABLES} tables x B={SWEEP_BAGS}, "
                f"L={SWEEP_L}, d=64, packed)", q, d, SWEEP_L, l120_k1, scale=scale,
                paths=int8_paths(q, d, bags * SWEEP_L, bags), abs_storage=q_abs),
             l120_k1, SWEEP_L),
            ("K2", "L=120", lambda: csr_case(
                "K2", f"int8 {mode} mode, sweep shape ({SWEEP_TABLES} tables x B={SWEEP_BAGS}, "
                f"bags of {SWEEP_L}, d=64, packed)", q, d, l120_k2, scale=scale,
                paths=int8_paths(q, d, SWEEP_BAGS * SWEEP_L, SWEEP_BAGS),
                abs_storage=q_abs),
             l120_k2, 0),
        )
        for k, shape, case, sets, fixed_l in cases:
            row = case()
            if library:
                ms, found = rowwise_library_ms(
                    q, d, row_scale if scaled else torch.ones(n, device=DEV), sets, fixed_l)
                row["library_ms"] = ms
                print(f"int8 {mode} mode {k} {shape}: library_ms (8-bit rowwise bag) {ms}; "
                      f"{found}; {card}", flush=True)
            rows[(k, mode, shape)] = row
    del k1_sets, k2_sets, long_ids, l120_k1, l120_k2
    int8_crossover(gen, q, q_abs, row_scale, card)
    del q, q_abs, row_scale
    free_card()
    return rows


def int8_crossover(gen, q, q_abs, row_scale, card):
    """The int8 row loads where bags are short but not single: int8 K1
    (fixed L) and K2 (CSR bags of L) at each L of CROSS_L, on each shape
    of CROSS_SHAPES over the first rows of ``q`` (as rows of d codes) and
    in both scale modes, with 8-byte and 4-byte loads pinned (each with the
    group and walk the wrapper gives that load), each held against the
    plain version (with :func:`order_slack`) and timed in turns (8, 4, 4,
    8).  Prints a line a case, with the load the wrapper picks and the
    faster one, and a summary line."""
    t0 = time.perf_counter()
    rows = row_scale.numel()
    summary = {}
    for d, tables in CROSS_SHAPES:
        storage = q.view(-1)[:rows * d].view(-1, 128)
        abs_storage = q_abs.view(-1)[:rows * d].view(-1, 128)
        for pooling in CROSS_L:
            n = BATCH * pooling
            sets = [torch.randint(0, rows, (tables, n), generator=gen, device=DEV,
                                  dtype=torch.int32) for _ in range(CROSS_ID_SETS)]
            off = (torch.arange(BATCH + 1, device=DEV, dtype=torch.int32)
                   * pooling).expand(tables, -1).contiguous()
            kernels = {
                "K1": (lambda i, scale, path: embedding_bag_fixedl(
                    storage, d, i.view(-1), pooling=pooling, batch_size=tables * BATCH,
                    scale=scale, path=path),
                       lambda i, st, scale: embedding_bag_fixedl_reference(
                    st, d, i.view(-1), pooling=pooling, batch_size=tables * BATCH,
                    scale=scale), tables * n, tables * BATCH),
                "K2": (lambda i, scale, path: embedding_bag_csr_packed(
                    storage, d, i, off, batch_size=BATCH, scale=scale, path=path),
                       lambda i, st, scale: embedding_bag_csr_packed_reference(
                    st, d, i, off, batch_size=BATCH, scale=scale), n, BATCH),
            }
            for (k, (run, plain, entries, bags)), mode in itertools.product(
                    kernels.items(), SCALE_MODES):
                scale = row_scale if mode == "row" else None
                pins = {f"{load}-byte": fitted_path(storage, d, entries, bags, load)
                        for load in (8, 4)}
                want = plain(sets[0], storage, scale)
                slack = order_slack(plain(sets[0], abs_storage, scale), pooling)
                for pin in pins.values():
                    check_kernel(run(sets[0], scale, pin), want, slack)
                turns = in_turns({name: (lambda i, p=pin: run(i, scale, p))
                                  for name, pin in pins.items()}, [(i,) for i in sets])
                ms = {name: statistics.mean(t) for name, t in turns.items()}
                picked = kernel_path(storage, d, entries, bags)
                faster = min(ms, key=ms.get)
                line = dict(kernel=k, mode=mode, d=d, tables=tables, bags=BATCH,
                            pooling=pooling, turns_ms=turns,
                            paths={name: path_label(p) for name, p in pins.items()},
                            picked=f"{picked.load}-byte", faster=faster,
                            picked_over_faster=ms[f"{picked.load}-byte"] / ms[faster])
                print("int8 crossover " + json.dumps(line), flush=True)
                summary[f"{k} {mode} d={d} L={pooling}"] = (
                    f"{picked.load}-byte", faster, round(line["picked_over_faster"], 4))
            del sets
    print(f"int8 crossover: summary (picked, faster, picked / faster) {json.dumps(summary)}; "
          f"{time.perf_counter() - t0:.1f} s; {card}", flush=True)


def int8_only(card):
    """``--only int8``: the int8 kernels' edge cases, then the int8 phase
    (the Kaggle shape with the f32 kernels in the same turns, the capacity
    width and the sweep shape)."""
    cases = int8_edge_phase(torch.Generator(device=DEV).manual_seed(SEED + 1))
    print(f"int8 kernel edge cases: {cases} cases, equal to their plain versions", flush=True)
    int8_phase(torch.Generator(device=DEV).manual_seed(SEED), card)


def ptxas_lines(logs) -> list:
    """One line per kernel instance of nvcc's ``-Xptxas=-v`` output in
    ``logs`` (source name -> log): the instance's name, demangled by
    ``c++filt`` where it is found, its registers and its spill stores and
    loads in bytes."""
    found = []  # (source, mangled name, registers, spill stores, spill loads)
    for source, log in logs.items():
        name, spills = None, (0, 0)
        for line in log.splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                name, spills = m.group(1), (0, 0)
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spills = (int(m.group(1)), int(m.group(2)))
            elif (m := re.search(r"Used (\d+) registers", line)) and name:
                found.append((source, name, int(m.group(1)), *spills))
                name = None
    names = [f[1] for f in found]
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, timeout=60).stdout.splitlines()
        if len(out) == len(names):
            names = [re.sub(r"^void (\(anonymous namespace\)::)?", "", n).split("(")[0]
                     for n in out]
    return [f"ptxas {source}: {name}: {regs} registers, spill stores {st} B, spill loads "
            f"{ld} B" for (source, _, regs, st, ld), name in zip(found, names)]


def _int8_serve_stats(fn, reqs):
    """REQUESTS requests (after a warm-up on the spare last one): the
    outputs; host ms per request, device ms per request, idle share, ATen
    operations and peak memory allocated; and the launches of K1 and K2
    (all, int8, int8 with a row scale) over the requests."""
    fn(*reqs[-1])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (embedding_bag_fixedl, embedding_bag_csr_packed)
    for c in counters:
        c.launches = c.int8_launches = c.int8_row_launches = 0
    zero_k1()
    outs, times, _ = serve(fn, reqs[:REQUESTS])
    k1 = take_k1()[0]  # the small set's (f32 rows) apart
    launched = [(c.launches, c.int8_launches, c.int8_row_launches) for c in counters]
    launched[0] = (k1,) + launched[0][1:]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in outs:
        if out.shape != (BATCH,) or not torch.isfinite(out).all():
            raise AssertionError("int8 phase: bad logits")
    dev = device_ms(fn, reqs[:REQUESTS], calls=REQUESTS)
    med = statistics.median(times)
    return outs, dict(ms=[round(t, 4) for t in times], median_ms=med, device_ms=dev,
                      idle_share=1 - dev / med, aten_ops=aten_ops(lambda: fn(*reqs[0])),
                      peak_gb=peak_gb), launched


# -- training ------------------------------------------------------------------

TRAIN_LR = 0.1
TRAIN_STEPS = 5
# A step pooled by the kernel against the same step pooled by the plain
# version: the pooled sums agree, and index_add_ on the card adds rows hit by
# several entries with f32 atomics in a run-dependent order.
STEP_TOL = dict(rtol=1e-5, atol=1e-6)
# The same steps on the card and on the CPU over 3 steps: f32 matmuls and
# scatters in another order, as the forward's card-vs-CPU check.
CARD_CPU_TOL = dict(rtol=1e-4, atol=1e-4)


def train_batches(config, gen, b, wire, steps):
    """``steps`` batches (dense, ids, mask or offsets, labels): ids rotate
    each step by a per-table stride, as tools/train_bench.py rotates them,
    so every step reads rows it has not read before; dense features and
    labels stay.  Dense wire: single-hot, mask all set.  CSR wire: the
    pooling-1 mixture, its padding poisoned with NEVER_READ."""
    rows = torch.tensor([t.num_rows for t in config.tables], device=DEV)
    stride = rows // 7 + 1
    dense = torch.rand(b, config.dense_dim, generator=gen, device=DEV)
    labels = (torch.rand(b, generator=gen, device=DEV) < 0.5).float()
    if wire == "dense":
        _, idx, second = request(config, gen, b)
    else:
        idx, second = csr_ids(rows.tolist(), gen, b, 1)
    pad = torch.arange(idx.shape[1], device=DEV)[None, :] >= (
        second[:, -1:] if wire == "csr" else idx.shape[1])
    out = []
    for _ in range(steps):
        out.append((dense, torch.where(pad, NEVER_READ, idx).to(torch.int32), second, labels))
        idx = (idx + stride[:, None]) % rows[:, None]
    return out


def train_runner(model, kind, wire, optimizer):
    """``run(batch) -> loss`` of one path; the row-AdaGrad accumulator (if
    any) lives in the returned state dict."""
    if kind == "autodiff":
        step = make_train_step(model, make_optimizer(TRAIN_LR, optimizer))
        return lambda batch: step(*batch)[0], {"acc": None}
    opt, acc = make_sparse_train_state(model, optimizer=optimizer, lr=TRAIN_LR)
    step = make_sparse_train_step(model, opt, lr=TRAIN_LR, optimizer=optimizer, wire=wire)
    state = {"acc": acc, "opt": opt}

    def run(batch):
        state["acc"], loss = step(state["acc"], *batch)
        return loss

    return run, state


def touched_rows(coll, batch, wire):
    """Bool masks of the fused rows the batch's valid entries read, for the
    small and the big set."""
    _, idx, second, _ = batch
    valid = (second if wire == "dense" else
             torch.arange(idx.shape[1], device=DEV)[None, :] < second[:, -1:])
    out = {}
    for key, sub, sel in (("small", coll.small, coll.small_ids),
                          ("big", coll.big, coll.big_ids)):
        ids = sub.globalize(idx[list(sel)])[valid[list(sel)]].long()
        mask = torch.zeros(sub.layout.total_rows, dtype=torch.bool, device=DEV)
        mask[ids] = True
        out[key] = mask
    return out


@contextlib.contextmanager
def deterministic():
    """Deterministic CUDA algorithms inside: ``index_add_`` sorts its
    entries instead of adding them with atomics, so two runs of a step add
    in the same order and compare at the one-step tolerance (with atomics
    the small set's rows, each hit by up to B entries a step, differ by more
    from run to run).  Ops with no deterministic form only warn; their
    names are printed once."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).split(" does not have")[0][:80] for w in caught
                  if "deterministic" in str(w.message)})
    if ops:
        print(f"deterministic: no deterministic form, ran as is: {ops}", flush=True)


def sparse_state(model, acc):
    """Clones of what a sparse step changes: both tables, the MLPs and the
    row-AdaGrad accumulator."""
    out = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out.update({f"acc_{k}": v.clone() for k, v in acc.items()})
    return out


def restore(model, acc, saved):
    """Put back a ``sparse_state`` snapshot."""
    with torch.no_grad():
        model.load_state_dict({k: v for k, v in saved.items() if not k.startswith("acc_")})
        for k, v in (acc or {}).items():
            v.copy_(saved[f"acc_{k}"])


def check_against_plain(model, run, state, batch, wire):
    """One step pooled by the kernel against the same step, from the same
    state, pooled by the plain version, both with deterministic algorithms:
    loss, both tables and the accumulator within STEP_TOL.  Rows the batch
    did not touch keep their bits.  Returns the largest abs difference of
    the tables."""
    before = sparse_state(model, state["acc"] or {})
    with deterministic():
        loss_k = run(batch)
    after_k = sparse_state(model, state["acc"] or {})
    touched = touched_rows(model.collection, batch, wire)
    for key, rows in touched.items():
        d = before[f"emb_{key}"].view(-1, 16)
        after = after_k[f"emb_{key}"].view(-1, 16)
        if not torch.equal(after[~rows], d[~rows]):
            raise AssertionError(f"{key} set: rows the batch did not touch changed")
        if torch.equal(after[rows], d[rows]):
            raise AssertionError(f"{key} set: no touched row changed")
    restore(model, state["acc"], before)
    name, plain = (("embedding_bag_fixedl", embedding_bag_fixedl_reference) if wire == "dense"
                   else ("embedding_bag_csr_packed", embedding_bag_csr_packed_reference))
    with mock.patch.object(collection_mod, name, plain), deterministic():
        loss_p = run(batch)
    torch.testing.assert_close(loss_k, loss_p, **STEP_TOL)
    err = 0.0
    for key in ("small", "big"):
        got = getattr(model, f"emb_{key}").detach()
        torch.testing.assert_close(after_k[f"emb_{key}"], got, **STEP_TOL)
        err = max(err, (after_k[f"emb_{key}"] - got).abs().max().item())
        if state["acc"]:
            torch.testing.assert_close(after_k[f"acc_{key}"], state["acc"][key], **STEP_TOL)
    return err


def sparse_stage_fns(model, state, batch, wire, optimizer):
    """The sparse step's stages on one batch: forward lookup, the dense
    tower's forward and backward, the dense optimizer, the small set's and
    the big set's update.  Each call of an update stage steps the tables."""
    coll, emb, acc = model.collection, model.emb_params(), state["acc"]
    dense, idx, second, labels = batch
    sel_s, sel_b = coll._index["small_ids"], coll._index["big_ids"]
    kw = dict(lr=TRAIN_LR, optimizer=optimizer, eps=1e-8)
    if wire == "dense":
        look = lambda: coll.lookup(emb, idx, second, batch_size=dense.shape[0])  # noqa: E731
        small, big = _mxu_sparse_update, sparse_update
    else:
        look = lambda: coll.lookup_csr(emb, idx, second)  # noqa: E731
        small, big = _mxu_sparse_update_csr, sparse_update_csr
    with torch.no_grad():
        pooled = look().requires_grad_(True)
    params = dense_params(model)

    def fwd_bwd():
        loss = bce_loss(model.apply_from_pooled(dense, pooled), labels)
        return torch.autograd.grad(loss, [*params, pooled])

    grads = fwd_bwd()
    for p, g in zip(params, grads):
        p.grad = g
    g_pooled = grads[-1]

    def no_grad(fn):
        def call():
            with torch.no_grad():
                return fn()
        return call

    return {
        "forward_lookup": no_grad(look),
        "dense_fwd_bwd": fwd_bwd,
        "dense_optimizer": state["opt"].step,
        "small_set_update": no_grad(lambda: small(
            coll.buckets, emb["small"], acc["small"], idx[sel_s], second[sel_s],
            g_pooled[:, sel_s], **kw)),
        "big_set_update": no_grad(lambda: big(
            coll.big, emb["big"], acc["big"], idx[sel_b], second[sel_b],
            g_pooled[:, sel_b], **kw)),
    }


def autodiff_stage_fns(model, batch):
    """The dense-autodiff step's stages: the forward (building the graph),
    the backward (the MLPs, the small set's bf16 product, K1's transpose into
    a dense f32 gradient of the big table), and SGD over every tensor."""
    dense, idx, mask, labels = batch
    params = [*model.parameters(), *emb_tensors(model)]
    forward = lambda: bce_loss(model(dense, idx, mask), labels)  # noqa: E731
    loss = forward()
    grads = torch.autograd.grad(loss, params, retain_graph=True)
    opt = make_optimizer(TRAIN_LR, "sgd")(params)
    for p, g in zip(params, grads):
        p.grad = g
    return {
        "forward": forward,
        "backward": lambda: torch.autograd.grad(loss, params, retain_graph=True),
        "optimizer": opt.step,
    }


TRAIN_PATHS = (  # (name, kind, wire, optimizer)
    ("dense-wire sparse row_adagrad", "sparse", "dense", "row_adagrad"),
    ("dense-wire sparse sgd", "sparse", "dense", "sgd"),
    ("CSR-wire sparse row_adagrad", "sparse", "csr", "row_adagrad"),
    ("dense-wire dense-autodiff sgd", "autodiff", "dense", "sgd"),
)


def train_phase(gen):
    """The train paths at full Kaggle rows, B=8192, each from the same
    initial model: 1 warm-up and TRAIN_STEPS timed steps (host clock, each
    step ending in a synchronize), launches counted over the timed steps;
    then device time per step, one step against its plain-pooled twin with
    untouched rows checked, ATen operations and the stage split (whose
    repeated updates leave the model as they will).  Returns the launches
    of K1 and K2 over the timed steps of all paths."""
    config = kaggle_config()
    model = DLRM(config, ShardingPolicy.REPLICATE, hybrid=True, device=DEV, generator=gen)
    acc_mb = (model.collection.small.layout.total_rows
              + model.collection.big.layout.total_rows) * 4 / 1e6
    # on the host, so that the peak memory of the steps is theirs alone
    init = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    launches = {"K1": 0, "K2": 0}
    stage_rows, totals = {}, {}
    for name, kind, wire, optimizer in TRAIN_PATHS:
        with torch.no_grad():  # each path trains from the same initial model
            model.load_state_dict(init)
        batches = train_batches(config, gen, BATCH, wire, 2 * TRAIN_STEPS + 3)
        run, state = train_runner(model, kind, wire, optimizer)
        losses = [run(batches[0]).item()]  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_k1()
        embedding_bag_csr_packed.launches = 0
        times = []
        for batch in batches[1 : 1 + TRAIN_STEPS]:
            t0 = time.perf_counter()
            loss = run(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.item())
        (k1, small), k2 = take_k1(), embedding_bag_csr_packed.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = (TRAIN_STEPS, TRAIN_STEPS, 0) if wire == "dense" else (0, 0, TRAIN_STEPS)
        if (k1, small, k2) != want:
            raise AssertionError(f"{name}: K1, the small set's K1, K2 launched "
                                 f"{(k1, small, k2)} times in {TRAIN_STEPS} steps, not {want}")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: non-finite loss {losses}")
        launches["K1"] += k1
        launches["K2"] += k2
        med = statistics.median(times)
        timed = batches[1 + TRAIN_STEPS : 1 + 2 * TRAIN_STEPS]
        # one step per timed run: a step launches ~500 kernels, and several
        # held behind the sleep kernel fill the card's launch queue, which
        # then makes the host wait and the events time the host
        trained = sparse_state(model, state["acc"] or {})
        dev = device_ms(lambda b_: run(b_), [(b,) for b in timed], calls=1)
        ops_count = aten_ops(lambda: run(batches[-2]))
        # the timing runs ~45 more steps over the same 5 batches at lr 0.1,
        # which can drive a logit past f32's range (loss inf, reproduced by
        # the same step from the same state; which step, if any, moves with
        # the order of the scatters' atomics): the check starts again from
        # the state after the timed steps, whose losses are finite
        restore(model, state["acc"], trained)
        del trained  # out of the next path's peak memory
        err = check_against_plain(model, run, state, batches[-1], wire)
        totals[name] = dict(ms_per_step=med, samples_per_s=BATCH / med * 1e3,
                            device_ms_per_step=dev, idle_share=1 - dev / med,
                            peak_gb=peak_gb, aten_ops=ops_count)
        print(f"train {name}: B={BATCH}, lr {TRAIN_LR}: ms/step "
              f"{[round(t, 4) for t in times]}, median {med:.4f} ms, "
              f"{BATCH / med * 1e3:.0f} samples/s; device {dev:.4f} ms/step, idle "
              f"share {1 - dev / med:.3f}; K1, K2 launches {(k1, k2)} in {TRAIN_STEPS} "
              f"steps; peak memory {peak_gb:.3f} GB; ATen operations per step "
              f"{ops_count}; loss trace (warm-up first) {losses}; one step equal to "
              f"its plain-pooled twin (tables max abs err {err:.3g}, rtol 1e-5, "
              "atol 1e-6), untouched rows bitwise unchanged", flush=True)
        fns = (autodiff_stage_fns(model, batches[0]) if kind == "autodiff"
               else sparse_stage_fns(model, state, batches[0], wire, optimizer))
        fns["whole_step"] = lambda: run(batches[0])
        stage_rows[name] = {k: {"device_ms": device_ms(fn, [()], calls=1),
                                "call_ms": call_ms(fn, [()], calls=1)}
                            for k, fn in fns.items()}
        print(f"train stages, {name} (median ms): " + json.dumps(stage_rows[name]),
              flush=True)
        total, top = top_kernels(lambda: run(batches[0]))
        print(f"train kernels, {name}, one step (torch.profiler): {total:.4f} ms in all; "
              "largest (name, ms, launches): " + json.dumps(top), flush=True)
        del run, state, fns
    print(f"train: full Kaggle rows, big set {model.emb_big.numel() * 4 / 1e9:.3f} GB "
          f"f32, row-AdaGrad accumulator {acc_mb:.1f} MB; summary "
          + json.dumps(totals), flush=True)
    return launches


def toy_train_checks(gen):
    """At toy sizes: a sparse SGD step equals a dense-autodiff SGD step (the
    plain toy collection, multi-hot, masked entries), and 3 steps of each
    train path on the card equal the same steps of the port on the CPU."""
    cfg = toy_config()
    models = [DLRM(cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(1))
              for _ in range(2)]
    dense, idx, mask = request(cfg, gen, 16, pooling=3, keep=0.7)
    batch = (dense, idx, mask, (torch.rand(16, generator=gen, device=DEV) < 0.5).float())
    loss_ref, _ = make_train_step(models[0], make_optimizer(0.1))(*batch)
    opt, acc = make_sparse_train_state(models[1], lr=0.1)
    _, loss = make_sparse_train_step(models[1], opt, lr=0.1)(acc, *batch)
    torch.testing.assert_close(loss, loss_ref, rtol=1e-6, atol=1e-6)
    for (name, x), y in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        torch.testing.assert_close(y, x.detach(), **STEP_TOL, msg=name)
    print("toy: sparse SGD step equal to the dense-autodiff SGD step (loss 1e-6, "
          "params rtol 1e-5 atol 1e-6)", flush=True)

    mixed = DLRMConfig(
        dense_dim=13, mlp_bot=(64, 16), mlp_top=(32, 1),
        tables=tuple(TableConfig(num_rows=n, dim=16, name=f"t{i}")
                     for i, n in enumerate((3, 24, 583, 1460, 9000, 20000))),
    )
    for _, kind, wire, optimizer in TRAIN_PATHS:
        cpu = DLRM(mixed, hybrid=True, device="cpu", generator=torch.Generator().manual_seed(2))
        gpu = DLRM(mixed, hybrid=True, device=DEV, generator=gen)
        gpu.load_state_dict(cpu.state_dict())
        batches = train_batches(mixed, gen, 64, wire, 3)
        run_gpu, _ = train_runner(gpu, kind, wire, optimizer)
        run_cpu, _ = train_runner(cpu, kind, wire, optimizer)
        for batch in batches:
            lg = run_gpu(batch)
            lc = run_cpu(tuple(t.cpu() for t in batch))
            torch.testing.assert_close(lg.cpu(), lc, **CARD_CPU_TOL)
        err = max((a.detach().cpu() - b.detach()).abs().max().item()
                  for a, b in zip(gpu.state_dict().values(), cpu.state_dict().values()))
        for (name, a), b in zip(gpu.state_dict().items(), cpu.state_dict().values()):
            torch.testing.assert_close(a.detach().cpu(), b.detach(), **CARD_CPU_TOL, msg=name)
        print(f"card vs CPU, mixed hybrid DLRM, {wire} wire {kind} {optimizer}, 3 steps "
              f"(B=64): losses and params max abs err {err:.3g} (tol 1e-4)", flush=True)


# -- the sharded engine -------------------------------------------------------------

SHARDS = 4
SHARD_POLICIES = (ShardingPolicy.ROW_HASH, ShardingPolicy.ROW, ShardingPolicy.TABLE_WISE,
                  ShardingPolicy.COLUMN)
# Three steps on a mesh against three steps on one device: the sums of a
# lookup and the atomics of the scatters in another order, compounded.
TRACE_TOL = dict(rtol=1e-4, atol=1e-6)
# A sum of shard partials against the one-device lookup: bags split over
# shards add in another order.
SHARD_SUM_TOL = dict(rtol=1e-5, atol=1e-5)


def mesh_1_phase(gen):
    """The sharded engine through torch.distributed at world size 1: an NCCL
    process group joined over a file store, a (1, 1) mesh.  Runs _mesh_1 in
    it and leaves no process group behind."""
    store = tempfile.mkdtemp(prefix="pel_mesh_1_")
    try:
        init_distributed(0, 1, f"file://{store}/store")
        try:
            return _mesh_1(gen, make_mesh(data=1, model=1))
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _mesh_1(gen, mesh):
    """The full-row Kaggle hybrid DLRM with its big set under ROW_HASH on the
    mesh, built from the same seed as the same model under REPLICATE on one
    device (the same weights: checked).  Serves 5 requests of B=8192 on
    each wire, broadcast (K1 / K2 with the ownership mask, then the
    all-reduce over the model axis) and routed at the default capacity
    factor (buckets, two all_to_all_single calls, no drops); then 3 sparse
    row-AdaGrad steps, broadcast and routed; then autodiff through the
    sharded lookups (``_mesh_1_autodiff``).  Everything equals the
    REPLICATE model's result: logits atol 1e-4, one step rtol 1e-5 / atol
    1e-6, three steps rtol 1e-4.  Returns the masked K1, K2 and K4-backward
    launches of the broadcast paths (served requests, train steps and the
    CSR-wire gradient)."""
    config = kaggle_config()
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen, device=DEV).item())
    t0 = time.perf_counter()
    rep = DLRM(config, ShardingPolicy.REPLICATE, hybrid=True, device=DEV,
               generator=torch.Generator(device=DEV).manual_seed(seed))
    rh = DLRM(config, ShardingPolicy.ROW_HASH, hybrid=True, mesh=mesh,
              generator=torch.Generator(device=DEV).manual_seed(seed))
    if rh.collection.big.layout.policy != ShardingPolicy.ROW_HASH:
        raise AssertionError("the big set is not under ROW_HASH")
    for (name, a), b in zip(rep.state_dict().items(), rh.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: one seed gave other weights on the mesh")
    torch.cuda.synchronize()
    print(f"mesh_1: NCCL process group of 1, mesh (data 1, model 1); full-row Kaggle "
          f"hybrid, big set ROW_HASH {tuple(rh.emb_big.shape)} f32 and REPLICATE "
          f"{tuple(rep.emb_big.shape)} from one seed, equal weights; built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    drops = []

    def routed(wire):
        def fn(dense, idx, second):
            coll, emb = rh.collection, rh.emb_params()
            if wire == "dense":
                pooled, dropped = coll.lookup(emb, idx, second, batch_size=dense.shape[0],
                                              routed=True, return_stats=True)
            else:
                pooled, dropped = coll.lookup_csr(emb, idx, second, routed=True,
                                                  return_stats=True)
            drops.append(dropped)
            return rh.apply_from_pooled(dense, pooled)
        return fn

    reqs = {"dense": [request(config, gen, BATCH) for _ in range(REQUESTS + 1)],
            "CSR": [csr_request(config, gen, BATCH) for _ in range(REQUESTS + 1)]}
    paths = (  # (wire, name, serve)
        ("dense", "REPLICATE", rep),
        ("dense", "ROW_HASH broadcast", rh),
        ("dense", "ROW_HASH routed", routed("dense")),
        ("CSR", "REPLICATE", lambda *r: serve_csr(rep, *r)),
        ("CSR", "ROW_HASH broadcast", lambda *r: serve_csr(rh, *r)),
        ("CSR", "ROW_HASH routed", routed("CSR")),
    )
    want_launches = {  # (K1, K2, masked K2) over REQUESTS requests
        ("dense", "REPLICATE"): (REQUESTS, 0, 0),
        ("dense", "ROW_HASH broadcast"): (REQUESTS, 0, 0),
        ("CSR", "REPLICATE"): (0, REQUESTS, 0),
        ("CSR", "ROW_HASH broadcast"): (0, REQUESTS, REQUESTS),
    }
    ref, serving, masked = {}, {}, {"K1": 0, "K2": 0}
    with torch.no_grad():
        for wire, name, fn in paths:
            fn(*reqs[wire][-1])  # warm-up
            torch.cuda.synchronize()
            zero_k1()
            embedding_bag_csr_packed.launches = embedding_bag_csr_packed.masked_launches = 0
            outs, times, _ = serve(fn, reqs[wire][:REQUESTS])
            k1, small = take_k1()
            launched = (k1, embedding_bag_csr_packed.launches,
                        embedding_bag_csr_packed.masked_launches)
            if (launched != want_launches.get((wire, name), (0, 0, 0))
                    or small != (REQUESTS if wire == "dense" else 0)):
                raise AssertionError(f"mesh_1 {wire} {name}: K1, K2, masked K2 launched "
                                     f"{launched} times and the small set's K1 {small} for "
                                     f"{REQUESTS} requests")
            if name == "ROW_HASH broadcast":
                masked["K1" if wire == "dense" else "K2"] += launched[0] + launched[2]
            for out in outs:
                if out.shape != (BATCH,) or not torch.isfinite(out).all():
                    raise AssertionError(f"mesh_1 {wire} {name}: bad logits")
            if name == "REPLICATE":
                ref[wire] = outs
            err = max((o - r).abs().max().item() for o, r in zip(outs, ref[wire]))
            for o, r in zip(outs, ref[wire]):
                torch.testing.assert_close(o, r, rtol=0, atol=1e-4)
            ops_count = aten_ops(lambda: fn(*reqs[wire][0]))
            serving[f"{wire} {name}"] = dict(ms_per_request=statistics.median(times),
                                             aten_ops=ops_count, max_abs_err=err)
            print(f"mesh_1 serve, {wire} wire, {name}: ms/request "
                  f"{[round(t, 4) for t in times]}, median {statistics.median(times):.4f}; "
                  f"ATen operations {ops_count}; K1, K2, masked K2 launches {launched}; "
                  f"logits max abs err vs REPLICATE {err:.3g} (atol 1e-4)", flush=True)
    dropped = [int(x.item()) for x in drops]
    if any(dropped):
        raise AssertionError(f"mesh_1: routed lookups dropped {dropped}")
    print(f"mesh_1 serve: routed drop counts {dropped} at the default capacity factor "
          f"{rh.collection.big.safe_capacity_factor}; summary " + json.dumps(serving),
          flush=True)

    batches = train_batches(config, gen, BATCH, "dense", 3)
    init = {k: v.detach().clone() for k, v in rep.state_dict().items()}
    ref, training = None, {}
    for name, model, is_routed in (("REPLICATE", rep, False), ("ROW_HASH broadcast", rh, False),
                                   ("ROW_HASH routed", rh, True)):
        def trainer():
            with torch.no_grad():
                model.load_state_dict(init)
            opt, acc = make_sparse_train_state(model, optimizer="row_adagrad", lr=TRAIN_LR)
            return acc, make_sparse_train_step(model, opt, lr=TRAIN_LR,
                                               optimizer="row_adagrad", routed=is_routed)

        # timed, as a trainer runs it
        acc, step = trainer()
        zero_k1()
        times = []
        for batch in batches:
            t0 = time.perf_counter()
            acc, loss = step(acc, *batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        k1, small = take_k1()
        if k1 != (0 if is_routed else len(batches)) or small != len(batches):
            raise AssertionError(f"mesh_1 train {name}: K1 launched {k1} times and the small "
                                 f"set's K1 {small} in {len(batches)} steps")
        if name == "ROW_HASH broadcast":
            masked["K1"] += k1
        ops_count = aten_ops(lambda: step(acc, *batches[0]))

        # checked: the same steps again from the same state, deterministic
        acc, step = trainer()
        losses, snaps = [], []
        with deterministic():
            for batch in batches:
                acc, loss = step(acc, *batch)
                losses.append(loss)
                if len(losses) in (1, len(batches)):
                    snaps.append(sparse_state(model, acc))
        if name == "REPLICATE":
            ref = (losses, snaps)
        errs = []
        for i, (snap, ref_snap, tol) in enumerate(zip(snaps, ref[1], (STEP_TOL, TRACE_TOL))):
            torch.testing.assert_close(losses[2 * i], ref[0][2 * i], **tol)
            for key, val in ref_snap.items():
                err = (snap[key] - val).abs().max().item()
                torch.testing.assert_close(snap[key], val, **tol,
                                           msg=lambda m: f"{name} {key}: {m}")
                errs.append((i, err))
        del snaps
        training[name] = dict(ms_per_step=statistics.median(times), aten_ops=ops_count,
                              losses=[x.item() for x in losses])
        print(f"mesh_1 train, {name}, sparse row_adagrad, B={BATCH}: ms/step "
              f"{[round(t, 4) for t in times]}, median {statistics.median(times):.4f}; ATen "
              f"operations per step {ops_count}; K1 launches {k1} in {len(batches)} steps; "
              f"losses {[x.item() for x in losses]}; vs REPLICATE (deterministic algorithms) "
              f"after 1 step max abs err {max(e for i, e in errs if i == 0):.3g} (rtol 1e-5, "
              f"atol 1e-6), after 3 steps {max(e for i, e in errs if i == 1):.3g} (rtol 1e-4)",
              flush=True)
    print("mesh_1 train: summary " + json.dumps(training), flush=True)
    autodiff = _mesh_1_autodiff(gen, config, rep, rh, init)
    masked["K1"] += autodiff["K1"]
    masked["K4 bwd"] = autodiff["K4 bwd"]
    masked["int8"] = _mesh_1_int8(gen, config, rep, rh, init)
    return masked


def _mesh_1_int8(gen, config, rep, rh, init):
    """The int8 big set under ROW_HASH on the mesh of one, beside REPLICATE
    int8, both quantized by ``quantize_dlrm_embeddings`` from the same
    initial state (the ROW_HASH storage on the card, shard by shard): in
    each scale mode 5 requests on the dense wire broadcast (masked int8 K1)
    and routed with a hot cache built against these params, and 5 on the
    CSR wire broadcast (masked int8 K2), each equal to REPLICATE int8 (atol
    1e-4).  Returns the int8 launches, keyed by (K, mode, "REPLICATE" or
    "masked")."""
    with torch.no_grad():
        rep.load_state_dict(init)
        rh.load_state_dict(init)
    reqs = {"dense": [request(config, gen, BATCH) for _ in range(REQUESTS)],
            "CSR": [csr_request(config, gen, BATCH) for _ in range(REQUESTS)]}
    sel = list(rh.collection.big_ids)
    sample = reqs["dense"][0][1][sel].cpu().numpy()
    launched = {}
    for mode in SCALE_MODES:
        (rep_c, rep_e), (rh_c, rh_e) = (quantize_dlrm_embeddings(m, scale_mode=mode)
                                        for m in (rep, rh))
        ids, rows = build_hot_cache(rh_c.big, rh_e["big"],
                                    hot_ids_from_sample(rh_c.big, sample, 4096))
        paths = (  # (wire, name, pooled)
            ("dense", "REPLICATE", lambda i, m: rep_c.lookup(rep_e, i, m, batch_size=BATCH)),
            ("dense", "ROW_HASH broadcast",
             lambda i, m: rh_c.lookup(rh_e, i, m, batch_size=BATCH)),
            ("dense", "ROW_HASH routed, hot cache", lambda i, m: rh_c.lookup(
                rh_e, i, m, batch_size=BATCH, routed=True, hot_cache=(ids, rows))),
            ("CSR", "REPLICATE", lambda i, o: rep_c.lookup_csr(rep_e, i, o)),
            ("CSR", "ROW_HASH broadcast", lambda i, o: rh_c.lookup_csr(rh_e, i, o)),
        )
        ref = {}
        with torch.no_grad():
            for wire, name, pooled in paths:
                fn = lambda d_, a, b_, p=pooled: rep.apply_from_pooled(d_, p(a, b_))  # noqa: E731
                fn(*reqs[wire][0])  # warm-up
                torch.cuda.synchronize()
                for c in (embedding_bag_fixedl, embedding_bag_csr_packed):
                    c.int8_launches = 0
                embedding_bag_csr_packed.masked_launches = 0
                outs, times, _ = serve(fn, reqs[wire])
                k = "K1" if wire == "dense" else "K2"
                counter = embedding_bag_fixedl if k == "K1" else embedding_bag_csr_packed
                n = counter.int8_launches
                routed = "routed" in name
                if n != (0 if routed else REQUESTS) or (
                        k == "K2" and embedding_bag_csr_packed.masked_launches
                        != (REQUESTS if "ROW_HASH" in name else 0)):
                    raise AssertionError(f"mesh_1 int8 {mode} {wire} {name}: int8 {k} "
                                         f"launched {n} times for {REQUESTS} requests")
                if not routed:
                    launched[(k, mode, "REPLICATE" if name == "REPLICATE" else "masked")] = n
                for out in outs:
                    if out.shape != (BATCH,) or not torch.isfinite(out).all():
                        raise AssertionError(f"mesh_1 int8 {mode} {wire} {name}: bad logits")
                if name == "REPLICATE":
                    ref[wire] = outs
                err = max((o - r).abs().max().item() for o, r in zip(outs, ref[wire]))
                for o, r in zip(outs, ref[wire]):
                    torch.testing.assert_close(o, r, rtol=0, atol=1e-4)
                hits = ""
                if routed:
                    g = rh_c.big.globalize(torch.stack([r[1][sel] for r in reqs[wire]]))
                    hits = (f"; hot cache of {ids.numel()} rows served "
                            f"{int(torch.isin(g, ids).sum().item())} of {g.numel()} entries")
                print(f"mesh_1 int8 {mode} mode, {wire} wire, {name}: ms/request "
                      f"{[round(t, 4) for t in times]}, median {statistics.median(times):.4f}; "
                      f"int8 {k} launches {n}{hits}; logits max abs err vs REPLICATE int8 "
                      f"{err:.3g} (atol 1e-4)", flush=True)
        del rep_c, rep_e, rh_c, rh_e, ids, rows
    return launched


def _mesh_1_autodiff(gen, config, rep, rh, init):
    """Autodiff through the sharded lookups on the mesh of one, each beside
    REPLICATE from the same state: one dense-autodiff SGD step of the whole
    model (K1 masked forward, its transpose, the storage's gradient summed
    over the data axis), timed as the train phase times a step, equal under
    deterministic algorithms at rtol 1e-5 / atol 1e-6; the big set's
    gradient of sum(lookup_csr * w) (K2 masked forward, K4's masked
    backward, launched once) and of sum(lookup_routed * w) on the dense
    wire, equal at 1e-5.  Returns the masked K1 and K4-backward launches."""
    batches = train_batches(config, gen, BATCH, "dense", 4)
    models = (("REPLICATE", rep), ("ROW_HASH broadcast", rh))
    steps, timing, states = {}, {}, {}
    k1 = 0
    for name, model in models:  # timed, as a trainer runs it
        with torch.no_grad():
            model.load_state_dict(init)
        step = steps[name] = make_train_step(model, make_optimizer(TRAIN_LR, "sgd"))
        step(*batches[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_k1()
        times = []
        for batch in batches[1:]:
            t0 = time.perf_counter()
            step(*batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        launched = take_k1()
        if launched != (len(batches) - 1,) * 2:
            raise AssertionError(f"mesh_1 autodiff {name}: K1 and the small set's K1 launched "
                                 f"{launched} times in {len(batches) - 1} steps")
        if name != "REPLICATE":
            k1 += launched[0]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        dev = device_ms(lambda b_: step(*b_), [(b,) for b in batches[1:]], calls=1)
        ops_count = aten_ops(lambda: step(*batches[1]))
        med = statistics.median(times)
        timing[name] = dict(ms_per_step=med, device_ms_per_step=dev, idle_share=1 - dev / med,
                            aten_ops=ops_count, peak_gb=peak_gb)
        for t in emb_tensors(model):
            t.grad = None
    for name, model in models:  # checked: one step from the same state, deterministic
        with torch.no_grad():
            model.load_state_dict(init)
        with deterministic():
            loss, _ = steps[name](*batches[0])
        states[name] = (loss, {k: v.detach().clone() for k, v in model.state_dict().items()})
        for t in emb_tensors(model):
            t.requires_grad_(False)
            t.grad = None
    del steps
    (loss_r, want), (loss_h, got) = states["REPLICATE"], states["ROW_HASH broadcast"]
    torch.testing.assert_close(loss_h, loss_r, **STEP_TOL)
    err = 0.0
    for key, val in want.items():
        torch.testing.assert_close(got[key], val, **STEP_TOL, msg=lambda m: f"{key}: {m}")
        err = max(err, (got[key] - val).abs().max().item())
    del states, want, got
    for name, row in timing.items():
        print(f"mesh_1 train, {name}, dense-autodiff sgd, B={BATCH}: ms/step median "
              f"{row['ms_per_step']:.4f}, device {row['device_ms_per_step']:.4f} ms/step, "
              f"idle share {row['idle_share']:.3f}; ATen operations per step "
              f"{row['aten_ops']}; peak memory {row['peak_gb']:.3f} GB", flush=True)
    print(f"mesh_1 train: the ROW_HASH dense-autodiff step equals REPLICATE's "
          f"(deterministic algorithms; loss and every tensor max abs err {err:.3g}, rtol "
          "1e-5, atol 1e-6); summary " + json.dumps(timing), flush=True)

    # the big set's gradients, REPLICATE beside ROW_HASH
    sel = torch.tensor(rep.collection.big_ids, device=DEV)
    _, cidx, coff = csr_request(config, gen, BATCH)
    _, idx, mask = request(config, gen, BATCH)
    w = torch.randn(BATCH, len(sel), 16, generator=gen, device=DEV)
    grads, launched = {}, {}
    for name, model in (("REPLICATE", rep), ("ROW_HASH", rh)):
        coll = model.collection.big
        for wire in ("CSR", "routed"):
            if wire == "routed" and name == "REPLICATE":
                continue
            table = model.emb_big.detach().clone().requires_grad_(True)
            embedding_bag_csr_grad.launches = embedding_bag_csr_grad.masked_launches = 0
            t0 = time.perf_counter()
            if wire == "CSR":
                out = coll.lookup_csr(table, cidx[sel], coff[sel])
            else:
                out = coll.lookup_routed(table, idx[sel], mask[sel], batch_size=BATCH)
            (out * w).sum().backward()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched[(name, wire)] = (embedding_bag_csr_grad.launches,
                                      embedding_bag_csr_grad.masked_launches)
            grads[(name, wire)] = (table.grad, ms)
            del out, table
    want = {("ROW_HASH", "CSR"): (1, 1), ("REPLICATE", "CSR"): (1, 0),
            ("ROW_HASH", "routed"): (0, 0)}
    if launched != want:
        raise AssertionError(f"mesh_1 gradients: K4 backward (all, masked) launched {launched}")
    table = rep.emb_big.detach().clone().requires_grad_(True)
    (rep.collection.big.lookup(table, idx[sel], mask[sel], batch_size=BATCH) * w).sum().backward()
    ref = {"CSR": grads[("REPLICATE", "CSR")][0], "routed": table.grad}
    for wire in ("CSR", "routed"):
        got, ms = grads[("ROW_HASH", wire)]
        err = (got - ref[wire]).abs().max().item()
        torch.testing.assert_close(got, ref[wire], **KERNEL_TOL)
        what = ("sum(lookup_csr * w): K2 masked forward, K4 masked backward"
                if wire == "CSR" else "sum(lookup_routed * w), dense wire")
        rep_ms = f" (REPLICATE {grads[('REPLICATE', 'CSR')][1]:.4f})" if wire == "CSR" else ""
        print(f"mesh_1 gradient, big set ROW_HASH, {what}, B={BATCH}: "
              f"{tuple(got.shape)} f32 equal to REPLICATE's (max abs err {err:.3g}, tol "
              f"1e-5); forward and backward, host ms {ms:.4f}{rep_ms}; K4 backward "
              f"launches (all, masked) {launched[('ROW_HASH', wire)]}", flush=True)
    del grads, ref, table
    return {"K1": k1, "K4 bwd": launched[("ROW_HASH", "CSR")][1]}


def global_storage(src_layout, src_rows, layout):
    """The tables of ``src_rows`` ([rows, d] in ``src_layout``'s fused
    order, on the card) as the global storage of ``layout``, on the card:
    what ``EmbeddingCollection.fused_host_array`` builds on the host."""
    fused = torch.zeros(layout.total_rows, layout.dim, dtype=src_rows.dtype, device=DEV)
    for a, b, n in zip(src_layout.row_offsets, layout.row_offsets, layout.table_rows):
        fused[b:b + n] = src_rows[a:a + n]
    if layout.policy == ShardingPolicy.ROW_HASH:  # shard s's local row j: fused row j*m + s
        m, rps = layout.num_shards, layout.rows_per_shard
        perm = (torch.arange(rps, device=DEV)[None, :] * m
                + torch.arange(m, device=DEV)[:, None]).reshape(-1)
        fused = fused[perm]
    return fused.view(layout.storage_rows, layout.storage_width)


def shards_4_phase(gen):
    """Four model shards in one process, no collective: the full-row Kaggle
    big set (10 tables, 33,742,688 rows, d=16 f32) cut into the 4 shards of
    ROW_HASH, ROW, TABLE_WISE and COLUMN.  On each shard the launch its
    lookup makes: masked K1 over the dense wire (single-hot, B=8192) and
    masked K2 over the CSR wire (pooling-1 mixture), or K1 / K2 on the
    shard's d/4 slice for COLUMN, held against the plain version (1e-5) and
    timed beside it, the library call and the bound (the distinct rows of
    its kept entries, every id, mask and offset byte, the output).  The shards' partials
    (the per-shard bodies) summed, maxed for MAX, or side by side for
    COLUMN, then finished, equal the REPLICATE lookup.  On ROW_HASH's
    shards also K4's masked backward over the CSR sets, against its plain
    version and timed.  Returns the masked K1, K2 and K4-backward rows of
    ROW_HASH's four shards."""
    config = kaggle_config()
    hyb = HybridEmbeddingCollection.create(config.tables, ShardingPolicy.REPLICATE, device=DEV)
    rep = hyb.big
    tables = [config.tables[i] for i in hyb.big_ids]
    rows = [t.num_rows for t in tables]
    storage = rep.init(gen)
    d = rep.layout.dim
    dense_sets = [torch.stack([torch.randint(0, n, (BATCH,), generator=gen, device=DEV,
                                             dtype=torch.int32) for n in rows])
                  for _ in range(ID_SETS)]
    keep = torch.ones(len(rows), BATCH, dtype=torch.bool, device=DEV)
    csr_sets = [csr_ids(rows, gen, BATCH, 1) for _ in range(ID_SETS)]
    with torch.no_grad():
        want = {(wire, comb): (rep.lookup(storage, dense_sets[0], keep, batch_size=BATCH,
                                          combiner=comb) if wire == "dense"
                               else rep.lookup_csr(storage, *csr_sets[0], combiner=comb))
                for wire in ("dense", "CSR") for comb in ("sum", "max")}
    rows_out = {"K1": [], "K2": [], "K4 bwd": []}
    for policy in SHARD_POLICIES:
        lay = plan(tables, SHARDS, policy, "auto")
        coll = EmbeddingCollection(lay, DEV)
        glob = global_storage(rep.layout, storage.view(-1, d), lay)
        shards = [shard_storage(lay, s, glob).contiguous() for s in range(SHARDS)]
        del glob
        column = policy == ShardingPolicy.COLUMN
        dsub = d // SHARDS if column else d
        strided = policy == ShardingPolicy.ROW_HASH

        def kw(s):
            return dict(shard=s, num_shards=SHARDS, rows_per_shard=lay.rows_per_shard,
                        strided=strided)

        def owned(g, s):
            """(owner-local ids, kept) of fused ids ``g`` on shard s."""
            if column:
                return g, torch.ones_like(g, dtype=torch.bool)
            owner, local = _owner_local(g, lay.rows_per_shard, SHARDS, strided)
            return local, (owner == s) & (local < lay.rows_per_shard)

        # the partials of the per-shard bodies, merged as the collectives merge them
        with torch.no_grad():
            g_dense = coll.globalize(dense_sets[0])
            g_csr = coll.globalize(csr_sets[0][0]).contiguous()
            off = csr_sets[0][1]
            errs = []
            for wire, comb in want:
                parts = []
                for s in range(SHARDS):
                    if wire == "dense":
                        parts.append(_local_pooled_lookup(shards[s], dsub, g_dense, keep, 1, comb)
                                     if column else _rowshard_pooled_lookup(
                                         shards[s], d, g_dense, keep, 1, comb, **kw(s)))
                    else:
                        parts.append(_csr_local_pool(shards[s], dsub, g_csr, off, BATCH, comb)
                                     if column else _csr_rowshard_pool(
                                         shards[s], d, g_csr, off, BATCH, comb, **kw(s)))
                if column:
                    pooled = torch.cat(parts, dim=2)
                else:
                    stacked = torch.stack(parts)
                    pooled = stacked.amax(dim=0) if comb == "max" else stacked.sum(dim=0)
                pooled = (_finish_combiner(comb, 1, pooled, keep) if wire == "dense"
                          else _csr_finish(comb, pooled, off))
                torch.testing.assert_close(pooled, want[(wire, comb)], **SHARD_SUM_TOL)
                errs.append((pooled - want[(wire, comb)]).abs().max().item())
        print(f"shards_4 {policy.value}: {SHARDS} shards of storage "
              f"{tuple(shards[0].shape)}; partials merged equal to the REPLICATE lookup "
              f"(dense sum, dense max, CSR sum, CSR max; max abs err "
              f"{[float(f'{e:.3g}') for e in errs]}, tol 1e-5)", flush=True)

        # each shard's kernel launch at the main path's shapes
        for s in range(SHARDS):
            k1_sets = []
            for ids in dense_sets:
                local, own = owned(coll.globalize(ids), s)
                k1_sets.append((local.reshape(-1).to(torch.int32).contiguous(),
                                (own & keep).reshape(-1).contiguous()))
            k2_sets = []
            for idx, o in csr_sets:
                local, own = owned(coll.globalize(idx), s)
                k2_sets.append((local.to(torch.int32).contiguous(), o)
                               + (() if column else (own.contiguous(),)))
            what = "K1/K2 on its d/4 slice" if column else "ownership mask"
            k1 = k1_case(f"shards_4 {policy.value} shard {s} ({what}; 10 tables x B=8192, L=1)",
                         shards[s], dsub, 1, k1_sets)
            k2 = csr_case("K2", f"shards_4 {policy.value} shard {s} ({what}; 10 tables x "
                          "B=8192, pooling-1 mixture)", shards[s], dsub, k2_sets)
            if policy == ShardingPolicy.ROW_HASH:
                rows_out["K1"].append(k1)
                rows_out["K2"].append(k2)
                rows_out["K4 bwd"].append(k4_masked_case(
                    f"shards_4 row_hash shard {s} (ownership mask; 10 tables x B=8192, "
                    "pooling-1 mixture)", shards[s], dsub, k2_sets, gen))
        del shards
    return rows_out


# -- masked: the masked walk at a row shard's per-rank shapes --------------------

MASKED_ID_SETS = 4  # id sets cycled at the long-bag shapes: each reads >= 130 MB of rows
# the plain version takes 3-50 ms a call at the long-bag shapes: 2 calls a run, 5 runs
MASKED_PLAIN_TIMING = dict(calls=2, runs=5)


def masked_sets(tables, pooling, n_sets, gen):
    """Per-table local ids of ``n_sets`` queries, B=8192: (dense [T, B*L],
    CSR ids [T, C], offsets [T, B+1]); at L=1 the single-hot dense query and
    the pooling-1 CSR mixture (shards_4's), else fixed-L bags on both wires
    (``cli bench``'s CSR wire)."""
    rows = [t.num_rows for t in tables]
    sets = []
    for _ in range(n_sets):
        dense = torch.stack([torch.randint(0, n, (BATCH * pooling,), generator=gen, device=DEV,
                                           dtype=torch.int32) for n in rows])
        if pooling == 1:
            sets.append((dense, *csr_ids(rows, gen, BATCH, 1)))
        else:
            off = (torch.arange(BATCH + 1, device=DEV, dtype=torch.int32) * pooling).expand(
                len(rows), -1).contiguous()
            sets.append((dense, dense, off))
    return sets


def masked_phase(gen, card):
    """The masked walk at the shapes where it matters: K1 and masked K2 on
    shard 0 of a ROW_HASH cut into 4 shards (about 1 entry in 4 kept,
    owner-local ids and the ownership mask from ``_owner_local``, the shard
    storage as ``shards_4`` builds it) and on one card's whole tables under
    an all-set mask (the dense wire's padding mask, which K1 always takes),
    at the per-rank shapes of ``cli bench``'s ``random`` (32 x 500k x 64
    bf16, L=120) and ``bigtable`` (8 x 2M x 128 bf16, L=32; masked K2 at
    d=128 is K3's path), both walked by group, at the Kaggle big set's
    (10 tables, d=16 f32, L=1 and the pooling-1 CSR mixture), and at three
    multi-hot shapes walked by window: the Kaggle big set at L=4 (G=4, U=4)
    and ``bigtable``'s tables in f32 at L=8 and L=32 (G=32, U=8; K1 carries
    the mask as flags there, masked K2 compacts), B=8192.  Each shape
    checks that K1's chosen walk is the one named.  Each row times the
    chosen walk beside its bound, the plain version and F.embedding_bag
    with the mask as per-sample weights, holds it against the plain
    version (KERNEL_TOL) and, with a repeated launch, bitwise against the
    sum of each bag's kept entries in entry order (:func:`entry_order_sum`).
    On each shard the row-shard lookups (``_rowshard_pooled_lookup``,
    ``_csr_rowshard_pool``) launch the same kernels once each, counted,
    with the same bits.  Returns the rows by (shape, kernel, kept)."""
    config = kaggle_config()
    hyb = HybridEmbeddingCollection.create(config.tables, ShardingPolicy.REPLICATE, device=DEV)
    big = [config.tables[i] for i in hyb.big_ids]
    shapes = (  # (name, tables, dtype, L, id sets, K1 walks by group)
        ("random", random_config().tables, torch.bfloat16, 120, MASKED_ID_SETS, True),
        ("bigtable", bench.bigtable_tables(), torch.bfloat16, 32, MASKED_ID_SETS, True),
        ("kaggle", big, torch.float32, 1, ID_SETS, False),
        ("kaggle L=4", big, torch.float32, 4, ID_SETS, False),
        ("bigtable f32 L=8", bench.bigtable_tables(), torch.float32, 8, MASKED_ID_SETS, False),
        ("bigtable f32 L=32", bench.bigtable_tables(), torch.float32, 32, MASKED_ID_SETS, False),
    )
    del hyb
    out = {}
    for shape, tables, dtype, pooling, n_sets, by_group in shapes:
        t0 = time.perf_counter()
        rep = EmbeddingCollection.create(list(tables), ShardingPolicy.REPLICATE, device=DEV)
        storage = rep.init(gen, dtype)
        d = rep.layout.dim
        lay = plan(list(tables), SHARDS, ShardingPolicy.ROW_HASH, "auto")
        coll = EmbeddingCollection(lay, DEV)
        glob = global_storage(rep.layout, storage.view(-1, d), lay)
        shard = shard_storage(lay, 0, glob).contiguous()
        del glob
        rps = lay.rows_per_shard

        def on_shard(local):
            """(owner-local ids, owned) of shard 0, shaped as ``local``."""
            owner, loc = _owner_local(coll.globalize(local), rps, SHARDS, True)
            return loc.to(torch.int32).contiguous(), ((owner == 0) & (loc < rps)).contiguous()

        def one_card(local):
            fused = rep.globalize(local).to(torch.int32).contiguous()
            return fused, torch.ones(fused.shape, dtype=torch.bool, device=DEV)

        sets = masked_sets(tables, pooling, n_sets, gen)
        quick = MASKED_PLAIN_TIMING if pooling > 1 else None
        torch.cuda.synchronize()
        print(f"masked {shape}: {len(tables)} tables x {tables[0].num_rows} rows x d={d} "
              f"{str(dtype).replace('torch.', '')}, B={BATCH}, L={pooling}: one card's storage "
              f"{storage.numel() * storage.element_size() / 1e9:.3f} GB, shard 0 of {SHARDS} "
              f"(ROW_HASH) {shard.numel() * shard.element_size() / 1e9:.3f} GB; {n_sets} id "
              f"sets; built in {time.perf_counter() - t0:.2f} s ({card})", flush=True)
        for kept, stor, cut in (("1 in 4", shard, on_shard), ("all", storage, one_card)):
            k1_sets = [tuple(x.reshape(-1) for x in cut(dense)) for dense, _, _ in sets]
            k2_sets = [(i, off, m) for (i, m), off in ((cut(idx), off) for _, idx, off in sets)]
            where = (f"shard 0 of {SHARDS}, ROW_HASH ownership mask" if stor is shard
                     else "one card, all-set mask")
            ids, mask = k1_sets[0]
            bags = ids.numel() // pooling
            chosen = kernel_path(stor, d, ids.numel(), bags)
            if chosen.by_group != by_group:
                raise AssertionError(f"masked {shape}: K1 walks {path_label(chosen)}, not "
                                     f"{'by group' if by_group else 'by window'}")
            k1 = k1_case(f"masked {shape} K1 ({where}; {len(tables)} tables x B={BATCH}, "
                         f"L={pooling})", stor, d, pooling, k1_sets, plain_timing=quick)
            k1_off = (torch.arange(bags + 1, device=DEV, dtype=torch.int32) * pooling)[None]
            in_entry_order(f"{shape} K1 {kept}", lambda: embedding_bag_fixedl(
                stor, d, ids, pooling=pooling, batch_size=bags, mask=mask),
                entry_order_sum(stor, d, ids[None], k1_off, mask[None]))
            idx, off, kmask = k2_sets[0]
            k2 = csr_case("K2 masked", f"masked {shape} K2 ({where}; {len(tables)} tables x "
                          f"B={BATCH}, {'pooling-1 mixture' if pooling == 1 else f'L={pooling}'})",
                          stor, d, k2_sets, plain_timing=quick)
            in_entry_order(f"{shape} K2 {kept}", lambda: embedding_bag_csr_packed(
                stor, d, idx, off, batch_size=BATCH, mask=kmask),
                entry_order_sum(stor, d, idx, off, kmask))
            k1["path"] = path_label(chosen)
            k2["path"] = path_label(kernel_path(stor, d, idx.shape[1], BATCH))
            out[(shape, "K1", kept)], out[(shape, "K2", kept)] = k1, k2
            if stor is shard:
                via_entry_points(shape, coll, shard, d, pooling, sets[0], k1_sets[0], k2_sets[0])
        for kernel, kept in itertools.product(("K1", "K2"), ("1 in 4", "all")):
            row = out[(shape, kernel, kept)]
            print(f"masked {shape} {kernel}, {kept} kept ({row['path']}): {row['kernel_ms']:.5f} "
                  f"ms, share of bound {row['bound_ms'] / row['kernel_ms']:.3f} (bound "
                  f"{row['bound_ms']:.5f} ms), library {row['library_ms']:.5f} ms, plain "
                  f"{row['plain_ms']:.5f} ms; bitwise the sum in entry order, max abs err vs "
                  f"plain {row['max_abs_err']:.3g} ({card})", flush=True)
        del rep, storage, shard, coll, sets, k1_sets, k2_sets, ids, mask, idx, off, kmask
        gc.collect()
        torch.cuda.empty_cache()
    return out


def masked_only(card):
    """``--only masked``: the kernel edge cases (the compaction cases among
    them, f32, bf16 and int8), then the masked phase."""
    t0 = time.perf_counter()
    cases = edge_phase(torch.Generator(device=DEV).manual_seed(SEED))
    cases += int8_edge_phase(torch.Generator(device=DEV).manual_seed(SEED + 1))
    print(f"kernel edge cases: {cases} cases of K1 and K2 (f32, bf16, int8) equal to their "
          f"plain versions, in {time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    masked_phase(torch.Generator(device=DEV).manual_seed(SEED), card)
    print(f"masked phase: {time.perf_counter() - t0:.1f} s", flush=True)


def in_entry_order(what, run, order):
    """``run()`` twice, each bitwise ``order``, the sum in entry order."""
    got, again = run(), run()
    torch.cuda.synchronize()
    if not (torch.equal(got, order) and torch.equal(again, order)):
        raise AssertionError(f"masked {what}: the kernel differs from the sum in entry order "
                             f"by {(got - order).abs().max().item():.3g}, or from itself by "
                             f"{(got - again).abs().max().item():.3g}")


def via_entry_points(shape, coll, shard, d, pooling, query, k1_set, k2_set):
    """Shard 0's partials through the row-shard lookups of both wires: one
    counted launch of K1 and of masked K2 each, equal bitwise to the direct
    kernel calls on the same owner-local ids and mask."""
    dense, idx, off = query
    t = dense.shape[0]
    kw = dict(shard=0, num_shards=SHARDS, rows_per_shard=coll.layout.rows_per_shard,
              strided=True)
    before = (embedding_bag_fixedl.launches, embedding_bag_csr_packed.masked_launches)
    with torch.no_grad():
        keep = torch.ones(dense.shape, dtype=torch.bool, device=DEV)
        k1 = _rowshard_pooled_lookup(shard, d, coll.globalize(dense), keep, pooling, "sum", **kw)
        k2 = _csr_rowshard_pool(shard, d, coll.globalize(idx).contiguous(), off, BATCH, "sum",
                                **kw)
    launched = (embedding_bag_fixedl.launches - before[0],
                embedding_bag_csr_packed.masked_launches - before[1])
    direct1 = embedding_bag_fixedl(shard, d, k1_set[0], pooling=pooling, batch_size=t * BATCH,
                                   mask=k1_set[1])
    direct2 = embedding_bag_csr_packed(shard, d, k2_set[0], k2_set[1], batch_size=BATCH,
                                       mask=k2_set[2])
    torch.cuda.synchronize()
    if launched != (1, 1):
        raise AssertionError(f"masked {shape}: the row-shard lookups launched (K1, masked K2) "
                             f"{launched} times, not once each")
    for name, via, direct in (("K1", k1, direct1), ("K2", k2, direct2)):
        if not torch.equal(via, direct.reshape(t, BATCH, d).transpose(0, 1)):
            raise AssertionError(f"masked {shape}: the row-shard lookup's {name} differs from "
                                 "the direct call")
    print(f"masked {shape}: shard 0's row-shard lookups (dense wire, CSR wire) launched "
          f"(K1, masked K2) {launched}, bitwise equal to the direct calls", flush=True)


def mean_row(rows):
    """One kernel-table row for the launches of several shards: the mean of
    each time, the largest error."""
    out = {k: statistics.mean(r[k] for r in rows)
           for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    out["bound_by"] = rows[0]["bound_by"]
    return out


def _spawn(cmds, timeout, env=None):
    """Start every command together (``env``: one environment for all, or
    a list of one each); wait for all of them, killing the rest as soon as
    one fails (its peers would wait in a collective).  Raises with the
    failed commands' error output."""
    envs = env if isinstance(env, list) else [env] * len(cmds)
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=e) for c, e in zip(cmds, envs)]
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = [p.communicate() for p in procs]
    failed = [(r, p.returncode, err) for r, (p, (_, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise AssertionError("\n".join(f"process {r} exited {rc}:\n{err[-3000:]}"
                                       for r, rc, err in failed))
    return [out for out, _ in outs]


def run_battery(data, model, device, tmp, battery=mesh_battery, inputs=None):
    """A battery (``mesh_battery`` on its inputs from SEED, or another with
    the same arguments, such as ``surface_battery``, on ``inputs``; a
    battery's checkpoints go to the run's directory) on data*model
    processes (NCCL over the cards, or gloo on the CPU, one thread each);
    each rank's results."""
    world = data * model
    name = battery.__name__.rsplit(".", 1)[-1]
    out = os.path.join(tmp, f"{name}_{device}_{data}x{model}")
    os.makedirs(out)
    path = os.path.join(out, "inputs.npz")
    np.savez(path, **(mesh_battery.make_inputs(SEED, data) if inputs is None else inputs))
    cmd = [sys.executable, "-m", battery.__name__]
    _spawn([cmd + [str(r), str(world), str(data), str(model), os.path.join(out, "store"),
                   path, out, device] for r in range(world)],
           timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(world)]


def mesh_worker(rank, world, store, out):
    """One rank of the multi-card serve: the full-row Kaggle hybrid DLRM,
    big set ROW_HASH over a (1, world) mesh, serving 5 requests of B=8192 on
    the dense wire, routed and broadcast, each held against the REPLICATE
    model built on this card from the same seed (atol 1e-4; no routed
    drops).  Writes its numbers to ``out``/rank<r>.json."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_distributed(rank, world, f"file://{store}")
    try:
        mesh = make_mesh(data=1, model=world)
        config = kaggle_config()
        rh = DLRM(config, ShardingPolicy.ROW_HASH, hybrid=True, mesh=mesh,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
        rep = DLRM(config, ShardingPolicy.REPLICATE, hybrid=True, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        reqs = [request(config, gen, BATCH) for _ in range(REQUESTS + 1)]
        drops = []

        def routed(dense, idx, mask):
            pooled, dropped = rh.collection.lookup(rh.emb_params(), idx, mask,
                                                   batch_size=BATCH, routed=True,
                                                   return_stats=True)
            drops.append(int(dropped.item()))
            return rh.apply_from_pooled(dense, pooled)

        result = {"rank": rank, "device": torch.cuda.get_device_name(dev),
                  "big_shard": list(rh.emb_big.shape)}
        with torch.no_grad():
            want = [rep(*r) for r in reqs[:REQUESTS]]
            for name, fn in (("routed", routed), ("broadcast", rh)):
                fn(*reqs[-1])
                outs, times, _ = serve(fn, reqs[:REQUESTS])
                for o, w in zip(outs, want):
                    torch.testing.assert_close(o, w, rtol=0, atol=1e-4)
                result[name] = dict(
                    ms_per_request=statistics.median(times),
                    max_abs_err=max((o - w).abs().max().item() for o, w in zip(outs, want)))
        if any(drops):
            raise AssertionError(f"routed lookups dropped {drops}")
        result["routed_drops"] = drops
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launcher_env(rank, world, local, port):
    """The environment torchrun gives process ``rank`` of hosts of
    ``local`` processes each."""
    return dict(os.environ, OMP_NUM_THREADS="1", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(rank),
                LOCAL_RANK=str(rank % local), LOCAL_WORLD_SIZE=str(local),
                GROUP_RANK=str(rank // local))


def run_multihost_battery(device, world, tmp):
    """``multihost_battery`` on 2 simulated hosts of world/2 processes
    (NCCL over the cards, or gloo on the CPU); each rank's case results."""
    out = os.path.join(tmp, f"multihost_{device}_{world}")
    os.makedirs(out)
    port = _free_port()
    cmd = [sys.executable, "-m", "pim_embedding_lookup_tpu_torch.multihost_battery", out, device]
    _spawn([cmd] * world, timeout=600,
           env=[launcher_env(r, world, world // 2, port) for r in range(world)])
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def multihost_1_phase():
    """``parallel.multihost`` in a job of one, as torchrun starts it: a
    subprocess (``--multihost-worker``) with the launcher's environment for
    one host of one process."""
    tmp = tempfile.mkdtemp(prefix="pel_multihost_1_")
    try:
        _spawn([[sys.executable, os.path.abspath(__file__), "--multihost-worker", tmp]],
               timeout=600, env=launcher_env(0, 1, 1, _free_port()))
        with open(os.path.join(tmp, "multihost_1.json")) as f:
            result = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("multihost_1: " + json.dumps(result), flush=True)
    return result


def multihost_worker(out):
    """The process of multihost_1: ``initialize()`` twice (one device),
    ``make_pod_mesh()`` -> (1, 1), ``is_primary()``; the full-row Kaggle
    hybrid DLRM with its big set under ROW_HASH serves 5 dense-wire
    requests of B=8192 through ``make_global_queries``, each equal to the
    REPLICATE model from the same seed (atol 1e-4); a toy
    ``device_put_tables`` -> ``unfuse_host`` round trip, exact.  Writes
    ``out``/multihost_1.json."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = multihost.initialize()
    try:
        again = multihost.initialize()
        mesh = multihost.make_pod_mesh()
        if again != dev or (mesh.data, mesh.model) != (1, 1) or not multihost.is_primary():
            raise AssertionError(f"multihost_1: initialize {dev} then {again}, pod mesh "
                                 f"{mesh.shape}, primary {multihost.is_primary()}")
        config = kaggle_config()
        rh = DLRM(config, ShardingPolicy.ROW_HASH, hybrid=True, mesh=mesh,
                  generator=torch.Generator(device=dev).manual_seed(SEED))
        rep = DLRM(config, ShardingPolicy.REPLICATE, hybrid=True, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(SEED))
        gen = torch.Generator(device=dev).manual_seed(SEED + 2)
        reqs = [request(config, gen, BATCH) for _ in range(REQUESTS + 1)]

        def serve_pod(dense, idx, mask):
            return rh(dense, *multihost.make_global_queries(mesh, idx, mask))

        with torch.no_grad():
            want = [rep(*r) for r in reqs[:REQUESTS]]
            serve_pod(*reqs[-1])  # warm-up
            zero_k1()
            outs, times, _ = serve(serve_pod, reqs[:REQUESTS])
        k1, small = take_k1()
        if (k1, small) != (REQUESTS, REQUESTS):
            raise AssertionError(f"multihost_1: K1 launched {k1} times and the small set's "
                                 f"K1 {small} for {REQUESTS} requests")
        for o, w in zip(outs, want):
            if o.shape != (BATCH,) or not torch.isfinite(o).all():
                raise AssertionError("multihost_1: bad logits")
            torch.testing.assert_close(o, w, rtol=0, atol=1e-4)
        rng = np.random.default_rng(SEED)
        toy = [TableConfig(num_rows=n, dim=16, name=f"t{i}")
               for i, n in enumerate((100, 1000, 37))]
        coll = EmbeddingCollection.create(toy, ShardingPolicy.ROW_HASH, packed="auto", mesh=mesh)
        host = [rng.standard_normal((t.num_rows, 16)).astype(np.float32) for t in toy]
        back = coll.unfuse_host(multihost.device_put_tables(coll, host))
        if not all(np.array_equal(a, b) for a, b in zip(host, back)):
            raise AssertionError("multihost_1: device_put_tables -> unfuse_host is not exact")
        result = dict(device=str(dev), mesh=mesh.shape, primary=multihost.is_primary(),
                      ms_per_request=times, median_ms=statistics.median(times),
                      k1_masked_launches=k1,
                      max_abs_err=max((o - w).abs().max().item() for o, w in zip(outs, want)),
                      round_trip_exact=True)
        with open(os.path.join(out, "multihost_1.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()
    return 0


def compare_battery(got, want, label):
    """Every rank's NCCL results against the same rank of the gloo run: drop
    counts, hot ids, refusals and other integers exactly, values at the CPU
    tests' tolerances (a result that passes through bf16 within 2**-6 of
    its largest value)."""
    cases = 0
    for r, ranked in enumerate(got):
        if set(ranked) != set(want[r]):
            raise AssertionError(f"{label} rank {r}: other results "
                                 f"{sorted(set(ranked) ^ set(want[r]))}")
        for key, val in want[r].items():
            case, name = key.split("/", 1)
            if name == "error":
                raise AssertionError(f"{label} {case}: {bytes(val).decode()[-2000:]}")
            if (name.endswith(("dropped", "error_text")) or name == "hot_ids"
                    or val.dtype.kind != "f"):
                np.testing.assert_array_equal(ranked[key], val, err_msg=f"{label} {key}")
            elif (case, name) in mesh_battery.BF16_RESULTS:
                np.testing.assert_allclose(ranked[key], val, rtol=0,
                                           atol=2.0 ** -6 * np.abs(val).max(),
                                           err_msg=f"{label} {key}")
            else:
                tol = TRACE_TOL if case in mesh_battery.TRACE_CASES else STEP_TOL
                np.testing.assert_allclose(ranked[key], val, **tol, err_msg=f"{label} {key}")
        cases = len({k.split("/", 1)[0] for k in ranked})
    return cases


REPO = os.path.dirname(os.path.abspath(__file__))
NATIVE_SO = os.path.join(REPO, "native", "libpelfeeder.so")


def start_native_build():
    """``make -C native`` where the feeder library is absent (its output
    path is git-ignored), started beside the kernels' build; None where it
    is there already."""
    if os.path.exists(NATIVE_SO):
        return None
    return subprocess.Popen(["make", "-C", os.path.join(REPO, "native")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_native_build(proc):
    if proc is not None:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"make -C native failed:\n{out[-3000:]}")
    if not native.available():  # no quiet numpy run on the card
        raise RuntimeError(f"the native feeder did not load from {NATIVE_SO}")


def same_pack(a, b) -> None:
    """Two BucketedCSR packs hold the same bytes."""
    if a.identity != b.identity or a.plan != b.plan:
        raise AssertionError("packs differ in identity or plan")
    pairs = list(zip(a.idx + a.mask + a.pos, b.idx + b.mask + b.pos))
    pairs += [(a.tail_idx, b.tail_idx), (a.tail_off, b.tail_off), (a.tail_pos, b.tail_pos)]
    for x, y in pairs:
        if (x is None) != (y is None) or (x is not None and (
                x.dtype != y.dtype or x.shape != y.shape or x.tobytes() != y.tobytes())):
            raise AssertionError("the native and numpy packs differ")


def native_phase(coll, emb, idx, off, pooled):
    """The native length-bucket packer on one full-row Kaggle CSR request:
    byte-identical to the numpy packer, each timed on the host; the
    bucketed dispatch over the native pack (K1 per bucket, K2 on the tail)
    against ``lookup_csr``.  Returns (K1, K2) launches."""
    off_np, idx_np = off.cpu().numpy(), idx.cpu().numpy()
    plan = plan_length_buckets(off_np, bucket_ls=(1, 2), slack=1.0)
    packs, pack_ms = {}, {}
    for impl in ("numpy", "native"):
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            packs[impl] = pack_length_buckets(idx_np, off_np, plan, impl=impl)
            times.append((time.perf_counter() - t0) * 1e3)
        pack_ms[impl] = statistics.median(times)
    same_pack(packs["native"], packs["numpy"])
    zero_k1()
    embedding_bag_csr_packed.launches = 0
    with torch.no_grad():
        got = lookup_csr_bucketed(coll, emb, packs["native"])
    torch.cuda.synchronize()
    launched = (take_k1()[0], embedding_bag_csr_packed.launches)
    if launched[0] < 1 or (plan.tail_bags and launched[1] < 1):
        raise AssertionError(f"bucketed dispatch launched K1, K2 {launched}")
    err = (got - pooled).abs().max().item()
    torch.testing.assert_close(got, pooled, rtol=1e-5, atol=1e-5)
    print(f"native: feeder library {NATIVE_SO}; bucket pack of the full-row request (plan "
          f"buckets {plan.bucket_ls} capacities {plan.capacities} tail {plan.tail_bags} bags "
          f"/ {plan.tail_entries} entries): native and numpy packs byte-identical, host ms "
          f"(median of 5) native {pack_ms['native']:.3f}, numpy {pack_ms['numpy']:.3f}; "
          f"bucketed dispatch on the native pack: K1, K2 launches {launched}, max abs err "
          f"vs lookup_csr {err:.3g} (tol 1e-5)", flush=True)
    return launched


CLI = [sys.executable, "-m", "pim_embedding_lookup_tpu_torch.cli", "train", "--data-set=kaggle",
       "--data-generation=random", "--hybrid", f"--mini-batch-size={BATCH}", "--device=cuda"]
CLI_REPORT = re.compile(r"step (\d+): loss=(\S+) acc=(\S+) auc=(\S+)")
CLI_PHASE = re.compile(r"^(\w+): ([\d.]+) us \(n=(\d+)\)$", re.M)
CLI_EVAL = re.compile(r"accuracy=(\S+) auc=(\S+)")


def run_cli(*args, expect=()):
    """One run of the CLI's train at full Kaggle width in a subprocess:
    its stdout and wall seconds; fails unless it exits 0 and prints every
    string of ``expect``."""
    t0 = time.perf_counter()
    r = subprocess.run(CLI + list(args), capture_output=True, text=True, timeout=900, cwd=REPO)
    secs = time.perf_counter() - t0
    missing = [s for s in expect if s not in r.stdout]
    if r.returncode != 0 or missing:
        raise AssertionError(f"cli {' '.join(args)}: rc {r.returncode}, missing {missing}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return r.stdout, secs


def cli_reports(out, steps):
    reports = [(int(s), float(loss), float(acc), float(auc))
               for s, loss, acc, auc in CLI_REPORT.findall(out)]
    if [r[0] for r in reports] != list(steps) or not all(
            math.isfinite(x) for r in reports for x in r[1:3]):
        raise AssertionError(f"cli reports {reports}, expected finite losses at steps {steps}")
    return reports


def cli_phases(out):
    return {name: (float(us) / 1e3, int(n)) for name, us, n in CLI_PHASE.findall(out)}


def cli_phase():
    """``cli``: the port's entry point at full Kaggle width, B=8192, on the
    card.  In subprocesses: (a) 8 sparse row-AdaGrad steps with reports at
    steps 4 and 8 and a full-state save, (b) its resume, (c) inference from
    it, (d) 3 dense-autodiff steps through ``fit``.  In this process: 8
    steps straight against 4, save, restore into a fresh model, 4 more
    (bitwise, deterministic algorithms), ``device_prefetch`` over 16 batches
    against their host arrays, and ``profiling.trace`` around 3 CLI steps,
    whose K1 launches it returns."""
    tmp = tempfile.mkdtemp(prefix="pel_cli_")
    full = os.path.join(tmp, "full")
    try:
        out_a, secs_a = run_cli("--optimizer=adagrad", "--num-batches=8", "--test-freq=4",
                                "--print-time", f"--save-model={full}",
                                expect=["saved full train state", "train_step:"])
        rep_a = cli_reports(out_a, (4, 8))
        ckpt_bytes = sum(os.path.getsize(os.path.join(full, f)) for f in os.listdir(full))
        out_b, secs_b = run_cli("--optimizer=adagrad", "--num-batches=4", "--test-freq=4",
                                f"--load-model={full}",
                                expect=[f"resumed full train state from {full} at step 8"])
        rep_b = cli_reports(out_b, (12,))
        out_c, secs_c = run_cli("--inference-only", "--num-batches=4", "--print-time",
                                f"--load-model={full}",
                                expect=["loaded model (params of full state)", "inference:"])
        acc_c, auc_c = (float(v) for v in CLI_EVAL.search(out_c).groups())
        out_d, secs_d = run_cli("--embedding-update=dense", "--num-batches=3", "--test-freq=3")
        rep_d = cli_reports(out_d, (3,))
        phases = {**cli_phases(out_a), **cli_phases(out_c)}
        print(f"cli: (a) 8 sparse row-AdaGrad steps {secs_a:.1f} s wall, reports {rep_a}, "
              f"train_step {phases['train_step'][0]:.4f} ms mean (n={phases['train_step'][1]}), "
              f"full-state checkpoint {ckpt_bytes} bytes; (b) resumed at step 8, {secs_b:.1f} s, "
              f"reports {rep_b}; (c) inference {secs_c:.1f} s, accuracy {acc_c} auc {auc_c}, "
              f"inference {phases['inference'][0]:.4f} ms mean (n={phases['inference'][1]}); "
              f"(d) dense-autodiff fit {secs_d:.1f} s, reports {rep_d}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    config = kaggle_config()
    host = list(SyntheticDLRMBatches(config, BATCH, 1, 16, seed=SEED))
    seen = 0
    for got, want in zip(device_prefetch(iter(host), device=DEV), host, strict=True):
        for g, w in zip(got, want, strict=True):
            if g.device.type != DEV.type or not torch.equal(g, torch.from_numpy(w).to(DEV)):
                raise AssertionError(f"prefetched batch {seen} differs from its host arrays")
        seen += 1
    print(f"cli prefetch: device_prefetch over {seen} Kaggle batches of B={BATCH}: every "
          "tensor on the card equal to its host array", flush=True)

    batches = [tuple(torch.from_numpy(x).to(DEV) for x in b) for b in host[:8]]
    tmp = tempfile.mkdtemp(prefix="pel_ckpt_")
    try:
        with deterministic():
            straight = resume_run(config, batches)
            snap = [t.clone() for t in straight]
            del straight
            resumed, save_s, restore_s, nbytes = resume_run(config, batches, tmp, save_at=4)
        for a, b in zip(snap, resumed, strict=True):
            if not torch.equal(a, b):
                raise AssertionError("resumed training differs from the straight run")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"cli resume: 8 sparse row-AdaGrad steps straight equal, bitwise, 4 steps + "
          f"checkpoint.save ({save_s:.3f} s, {nbytes} bytes) + restore into a fresh model "
          f"({restore_s:.3f} s) + 4 steps", flush=True)
    del snap, resumed, batches

    # the same CLI in this process, where the card is warm: 3 steps traced
    # (K1 counted), then 1 step, so that the 2 steps' difference in kernel
    # time is the device time of a CLI step
    tmp = tempfile.mkdtemp(prefix="pel_trace_")
    args = CLI[3:] + ["--optimizer=adagrad", "--print-time"]
    try:
        out = io.StringIO()
        zero_k1()
        t0 = time.perf_counter()
        with profiling.trace(tmp) as prof, contextlib.redirect_stdout(out):
            cli.main(args + ["--num-batches=3"])
        secs = time.perf_counter() - t0
        k1, small = take_k1()
        with open(os.path.join(tmp, "trace.json")) as f:
            names_k1 = "fixedl_pool_kernel" in f.read()
        trace_bytes = os.path.getsize(os.path.join(tmp, "trace.json"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if (k1, small) != (3, 3) or not names_k1:
        raise AssertionError(f"traced CLI: K1 launches {k1} and the small set's {small} for "
                             f"3 steps, trace names fixedl_pool_kernel: {names_k1}")
    step3 = cli_phases(out.getvalue())["train_step"]
    one = io.StringIO()
    with contextlib.redirect_stdout(one):
        device_1, _ = top_kernels(lambda: cli.main(args + ["--num-batches=1"]))
    device_3 = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation) / 1e3
    print(f"cli trace: profiling.trace around cli.main (3 steps, warm card) in {secs:.2f} s: "
          f"K1 launches {k1}, one a step; the Chrome trace ({trace_bytes} bytes) names "
          f"fixedl_pool_kernel; train_step {step3[0]:.4f} ms mean (n={step3[1]}); device time "
          f"of the run {device_3:.4f} ms, of a 1-step run {device_1:.4f} ms: "
          f"{(device_3 - device_1) / 2:.4f} device ms a CLI step", flush=True)
    return k1


def resume_run(config, batches, tmp=None, save_at=None):
    """Sparse row-AdaGrad steps over ``batches`` on the CLI's model; with
    ``save_at``, the full state is saved after that step and restored into
    a fresh model, optimizer and accumulator.  Returns the tables, MLPs and
    accumulator (and the save and restore seconds and bytes)."""
    def fresh(seed):
        model = DLRM(config, ShardingPolicy.AUTO, hybrid=True, device=DEV,
                     generator=torch.Generator(device=DEV).manual_seed(seed))
        opt, acc = make_sparse_train_state(model, optimizer="row_adagrad", lr=TRAIN_LR)
        step = make_sparse_train_step(model, opt, lr=TRAIN_LR, optimizer="row_adagrad")
        return model, opt, acc, step

    def full(model, opt, acc, stepno):
        params = checkpoint.model_params(model)
        return {"emb": params["emb"], "acc": acc,
                "dense": {k: params[k] for k in ("bot", "top")},
                "opt_state": opt.state_dict(), "step": stepno}

    model, opt, acc, step = fresh(SEED)
    meta = {"collection": checkpoint.collection_meta(model.collection), "state": "full"}
    for i, batch in enumerate(batches):
        acc, _ = step(acc, *batch)
        if i + 1 == save_at:
            path = os.path.join(tmp, "full")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save(path, full(model, opt, acc, i + 1), meta=meta)
            save_s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
            del model, opt, acc, step
            model, opt, acc, step = fresh(SEED + 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = checkpoint.restore(path, full(model, opt, acc, 0), expect_meta=meta)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            acc = st["acc"]
            opt.load_state_dict(st["opt_state"])
            if st["step"] != save_at:
                raise AssertionError(f"restored step {st['step']} != {save_at}")
    tensors = [*model.buffers(), *model.parameters(), *(a for a in acc.values() if a is not None)]
    if save_at is None:
        return tensors
    return tensors, save_s, restore_s, nbytes


# -- tools: the port's measurement entry points at full Kaggle width -------------

TOOLS_LAB_PROBES = "take,pallas,pallaschain,onehot,scatter,drophot,hotcost"


def add_counts(total: dict, counts: dict, sign: int = 1) -> None:
    """Adds launches by kernel-table row (``kernel_launches``) into ``total``."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + sign * v


def tools_phase():
    """Each measurement tool (``pim_embedding_lookup_tpu_torch/tools``) on
    the card through its ``main``, as a user runs it (no ``--device``: the
    card), at the full Criteo-Kaggle width: sparse training on both wires;
    serving at 100 qps, and at 1000 qps in microbatches of 8 with 2 in
    flight; the phase split; the int8 capacity bench at 4 x 100M rows x 64
    (102.4 GB in f32) in both scale modes, its f32 form checked not to fit
    on the card and its three lookups held against their plain versions on
    ids that read storage past element 2^31; a trace, which must name K1's kernel; the kernel lab's
    probes at the main shapes and K3's, each checked by the lab against its
    plain version on every path it sweeps; one shard of the data-axis
    scaling bench.  Each tool prints its own JSON line; a failing tool, or a
    check here, raises.  Returns the kernel launches of the phase by
    kernel-table row, counted from 0 before each tool."""
    total_gb = torch.cuda.get_device_properties(DEV).total_memory / 1e9
    kaggle = ["--config", "kaggle"]
    runs = [
        ("train_bench dense", train_bench, kaggle + ["--batch", "8192", "--hybrid",
                                                     "--iters", "20", "--wire", "dense"]),
        ("train_bench csr", train_bench, kaggle + ["--batch", "8192", "--hybrid",
                                                   "--iters", "20", "--wire", "csr"]),
        ("serving_bench 100 qps", serving_bench,
         kaggle + ["--hybrid", "--qps", "100", "--duration", "5"]),
        ("serving_bench 1000 qps microbatch 8", serving_bench,
         kaggle + ["--hybrid", "--qps", "1000", "--microbatch", "8", "--inflight", "2",
                   "--duration", "5"]),
        ("phase_bench", phase_bench, kaggle + ["--batch", "8192"]),
        *((f"capacity_bench {mode}", capacity_bench,
           ["--tables", "4", "--rows", "100000000", "--dim", "64", "--scale-mode", mode])
          for mode in SCALE_MODES),
        ("trace_capture", trace_capture, kaggle + ["--batch", "1024", "--iters", "3"]),
        ("kernel_lab", kernel_lab, ["--only", TOOLS_LAB_PROBES]),
        ("kernel_lab d=128 (K3)", kernel_lab,
         ["--rows", "1000000", "--dim", "128", "--tables", "1", "--pooling", "4",
          "--only", "pallas,pallaschain"]),
        ("scaling_bench data", scaling_bench, ["--axis", "data"]),
    ]
    launches = {}
    tmp = tempfile.mkdtemp(prefix="pel_tools_")
    try:
        for name, tool, argv in runs:
            gc.collect()
            torch.cuda.empty_cache()
            if tool is trace_capture:
                argv = argv + ["--out", os.path.join(tmp, "trace")]
            t0 = time.perf_counter()
            zero_kernel_launches()
            result = tool.main(argv)
            torch.cuda.synchronize()
            counts = kernel_launches(full_width="d=128" in name)  # K2 at d=128 is K3
            add_counts(launches, counts)
            check_tool(name, tool, result, total_gb)
            print(f"tools {name}: {time.perf_counter() - t0:.1f} s, launches "
                  + json.dumps({k: v for k, v in counts.items() if v}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def check_tool(name, tool, result, total_gb):
    """What a tool's result must show on the card."""
    if tool in (train_bench, serving_bench, phase_bench, capacity_bench, scaling_bench):
        if result.get("device_name") != torch.cuda.get_device_name(DEV):
            raise AssertionError(f"{name} ran on {result.get('device_name')}")
    if tool is train_bench:
        if not math.isfinite(result["loss_mean"]) or result["device_us_per_step"] is None:
            raise AssertionError(f"{name}: {result}")
    elif tool is serving_bench:
        if not result["requests"] or not (result["p50_ms"] <= result["p95_ms"]
                                          <= result["p99_ms"]):
            raise AssertionError(f"{name}: {result}")
        if result["microbatch"] > 1 and result["dispatches"] >= result["requests"]:
            raise AssertionError(f"{name}: the microbatches did not aggregate")
    elif tool is capacity_bench:
        if result["tables_gb_f32_equiv"] <= total_gb:
            raise AssertionError(f"{name}: the f32 tables ({result['tables_gb_f32_equiv']} "
                                 f"GB) fit on the card ({total_gb:.1f} GB)")
        # the bench held its three lookups against their plain versions
        # (rtol 1e-5, atol 1e-5 of the largest value) on its first ids
        if result["device_storage_elements_read"] <= 2 ** 31:
            raise AssertionError(f"{name}: the checked ids read no storage element past "
                                 f"2^31 ({result['device_storage_elements_read']})")
        print(f"tools {name}: fixed-L, CSR and MEAN equal to the plain version, max abs "
              f"err {json.dumps(result['device_plain_max_abs_err'])}, storage elements read "
              f"up to {result['device_storage_elements_read']} (past 2^31)", flush=True)
    elif tool is trace_capture:
        with gzip.open(result["trace"], "rt") as f:
            if "fixedl_pool_kernel" not in f.read():
                raise AssertionError(f"{name}: the trace names no fixedl_pool_kernel")
        if result["rows"] != 3:
            raise AssertionError(f"{name}: {result['rows']} intervals for 3 lookups")
    elif tool is kernel_lab:
        paths = [k for k in result if "path=" in k and not k.endswith("path=auto")]
        unchecked = [k for k in paths if result[k]["max_abs_err"] is None]
        if not paths or unchecked:
            raise AssertionError(f"{name}: swept paths {paths}, unchecked {unchecked}")
        print(f"tools {name}: {len(paths)} pinned kernel paths, each equal to the plain "
              "version (1e-5 abs + 1e-5 rel)", flush=True)
    elif tool is scaling_bench:
        if result["scaling_efficiency"] != {"1": 1.0}:
            raise AssertionError(f"{name}: {result}")


# -- bench: the lookup bench and the CLI's bench and sweep at full width ---------

BENCH_CLI = [sys.executable, "-m", "pim_embedding_lookup_tpu_torch.cli", "bench"]
BENCH_CASES = [  # (name, argv): Criteo Kaggle at B=8192 (bf16 by default), r.sh's presets
    ("default", []),  # the only one with the CPU baseline
    ("float32", ["--dtype", "float32"]),
    ("csr ragged", ["--wire", "csr", "--csr-ragged"]),
    ("csr-bucketed ragged", ["--wire", "csr-bucketed", "--csr-ragged"]),
    ("int8 table", ["--dtype", "int8", "--int8-scale", "table"]),
    ("int8 row", ["--dtype", "int8", "--int8-scale", "row"]),
    ("int8 row csr-bucketed ragged", ["--dtype", "int8", "--int8-scale", "row",
                                      "--wire", "csr-bucketed", "--csr-ragged"]),
    ("int8 no-hybrid", ["--dtype", "int8", "--no-hybrid"]),
    ("no-hybrid", ["--no-hybrid"]),
    ("tables-filter small", ["--tables-filter", "small"]),
    ("tables-filter big", ["--tables-filter", "big"]),
    ("random", ["--config", "random"]),
    ("bigtable dense", ["--config", "bigtable"]),
    ("bigtable csr", ["--config", "bigtable", "--wire", "csr"]),
]
BENCH_LOG = ("layout:", "ragged CSR:", "bucket plan:", "tables-filter", "cpu torch:",
             "us/iter")
SWEEP_RUNS = [["--grid", g] for g in cli.SWEEP_GRIDS] + [
    ["--grid", "table-size", "--quantized-above-gb", "20"]]
SWEEP_TOP = dict(tables=32, rows=13_900_000, dim=64, batch=64, pooling=120)  # 56.9 GB bf16


def plain_check(lk, tol=KERNEL_TOL) -> tuple[float, dict]:
    """``lk``'s first call on the card against the same call with the pool
    kernels replaced by their plain versions; raises on a mismatch.
    Returns (max abs err, the first call's kernel launches by row).  Every
    configuration of the bench is held at the kernel rows' tolerance: the
    kernels and their plain versions add the same entries of each bag (one
    at Kaggle's pooling 1, where they agree exactly), and the small set's
    product runs the same code on both sides."""
    full_width = lk.tables[0].dim % 128 == 0
    before = kernel_launches(full_width)
    with torch.no_grad():
        got = lk.fn(lk.idx)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in kernel_launches(full_width).items()
                    if v > before[k]}
        with mock.patch.object(collection_mod, "embedding_bag_fixedl",
                               embedding_bag_fixedl_reference), \
             mock.patch.object(collection_mod, "embedding_bag_csr_packed",
                               embedding_bag_csr_packed_reference):
            want = lk.fn(lk.idx)
    shape = (lk.batch, len(lk.tables), lk.tables[0].dim)
    if tuple(got.shape) != shape or not torch.isfinite(got).all():
        raise AssertionError(f"bench lookup: shape {tuple(got.shape)} for {shape}, or "
                             "non-finite values")
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, **tol)
    return err, launched


def free_card():
    gc.collect()
    torch.cuda.empty_cache()


def checked_sweep(argv) -> tuple[list, dict]:
    """``cli.cmd_sweep(argv)`` with each point's first call, on the tables
    and ids the sweep built, held against its plain versions
    (:func:`plain_check`) before the sweep times it, a line a point; the
    table-size grid's top point in bf16 (32 x 13.9M x 64, 56.9 GB) must
    read storage past element 2^31.  Returns the records and the kernel
    launches of the sweep's timed loops by row (the checks' left out)."""
    build, checks = bench.build_lookup, {}

    def build_checked(tables, batch, pooling, **kw):
        lk = build(tables, batch, pooling, **kw)
        err, launched = plain_check(lk)
        add_counts(checks, launched)
        dtype = "int8" if lk.quantized else lk.dtype
        coll = getattr(lk.coll, "big", None) or lk.coll  # the gathered set
        end = (int(coll.globalize(lk.idx).max()) + 1) * tables[0].dim  # elements read
        top = SWEEP_TOP == dict(tables=len(tables), rows=tables[0].num_rows,
                                dim=tables[0].dim, batch=batch, pooling=pooling)
        if not launched or (top and dtype == "bfloat16" and end <= 2 ** 31):
            raise AssertionError(f"sweep point {len(tables)} x {tables[0].num_rows} {dtype}: "
                                 f"launches {launched}, storage elements read up to {end}")
        print(f"sweep {' '.join(argv)} point {len(tables)} x {tables[0].num_rows} x "
              f"{tables[0].dim} {dtype}, B={batch}, L={pooling}: first call equal to the "
              f"plain versions, max abs err {err:.3g} (tol {KERNEL_TOL}), launches "
              f"{json.dumps(launched)}, storage elements read up to {end}"
              f"{' (past 2^31)' if end > 2 ** 31 else ''}", flush=True)
        return lk

    zero_kernel_launches()
    with mock.patch.object(bench, "build_lookup", build_checked):
        records = cli.cmd_sweep(argv)
    torch.cuda.synchronize()
    counts = kernel_launches()
    add_counts(counts, checks, -1)
    return records, counts


def bench_phase():
    """The lookup bench as users run it, ``python -m
    pim_embedding_lookup_tpu_torch.cli bench`` in a subprocess on the card,
    at full width: the Criteo-Kaggle config (B=8192) in bf16 with the CPU
    baseline, in f32, on the ragged CSR and bucketed CSR wires, in int8
    (hybrid in both scale modes, the bucketed wire in "row" mode, and the
    plain int8 collection), without the hybrid, each side of the hybrid's
    threshold alone, and r.sh's random (32 x 500k x 64, L=120) and
    bigtable (8 x 2M x 128, L=32, dense and CSR) presets.  Each prints its
    JSON line and a ``bench <case>:`` line of its seconds and kernel
    launches; in this process each configuration's first call from
    ``bench.build_lookup`` is held against the same call on the kernels'
    plain versions.  Then ``cli sweep`` on every r.sh grid at the default
    budget and the table-size grid with its top points in int8, each point
    a JSON record and its first call held against its plain versions
    (:func:`checked_sweep`); the table-size grid's top point (32 x 13.9M x
    64 bf16, 56.9 GB) must run, on ids that read storage past element 2^31.
    Returns the launches of the subprocess runs and the sweeps by
    kernel-table row."""
    launches = {}
    free_card()
    for i, (name, argv) in enumerate(BENCH_CASES):
        argv = argv + ([] if i == 0 else ["--no-baseline"])
        t0 = time.perf_counter()
        run = subprocess.run(BENCH_CLI + argv, capture_output=True, text=True, timeout=600,
                             cwd=REPO)
        secs = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"cli bench {argv} exited {run.returncode}:\n"
                                 f"{run.stderr[-3000:]}")
        for line in run.stderr.splitlines():
            if any(key in line for key in BENCH_LOG):
                print(f"bench {name} | {line.strip()}", flush=True)
        line = run.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        result = json.loads(line)
        counts = result["device_kernel_launches"]
        add_counts(launches, counts)
        if (counts["K2 masked"] or result["device_name"] != torch.cuda.get_device_name(DEV)
                or result["device_us_per_iter"] is None or not result["value"] > 0
                or (i == 0) == (result["vs_baseline"] is None)):
            raise AssertionError(f"bench {name}: {result}")
        print(f"bench {name}: {secs:.1f} s, launches "
              + json.dumps({k: v for k, v in counts.items() if v}), flush=True)
        lk = bench.lookup_for(bench.parse_args(argv), device=DEV)
        err, launched = plain_check(lk)
        if not launched and name != "tables-filter small":  # the small set has no kernel
            raise AssertionError(f"bench {name}: the first call launched no kernel")
        print(f"bench {name} first call: equal to the plain versions, max abs err {err:.3g} "
              f"(tol {KERNEL_TOL}), kernel launches {json.dumps(launched)}", flush=True)
        del lk
        free_card()

    for argv in SWEEP_RUNS:
        free_card()
        t0 = time.perf_counter()
        records, counts = checked_sweep(argv)
        add_counts(launches, counts)
        ran = [r for r in records if "skipped" not in r]
        bad = [r for r in ran if not r["lookups_per_s"] > 0 or r["device_mean_us"] is None]
        if argv == ["--grid", "table-size"]:  # the 56.9 GB point runs in bf16
            bad += [r for r in records if r["rows"] == SWEEP_TOP["rows"]
                    and r.get("dtype") != "bfloat16"]
        if bad:
            raise AssertionError(f"sweep {argv}: {bad}")
        skipped = [f"{r['tables']}x{r['rows']} ({r['tables_gb']} GB)"
                   for r in records if "skipped" in r]
        print(f"sweep {' '.join(argv)}: {time.perf_counter() - t0:.1f} s, {len(ran)} points "
              f"run ({sum(r['dtype'] == 'int8' for r in ran)} in int8), skipped "
              f"{skipped or 'none'}, launches "
              + json.dumps({k: v for k, v in counts.items() if v}), flush=True)
    free_card()
    return launches


SURFACE_SEEDS = 200
SURFACE_ORACLE_TOL = {"int8": 2e-3}  # the JAX suite's; 1e-4 for float storage


def csr_oracle(host_tables, idx, off, combiner):
    """The pooled bags of a CSR query [T, C], [T, B+1] by numpy, empty bags
    0 (the JAX suite's oracle, tests/test_surface_matrix.py:30-42, on CSR)."""
    t, b = off.shape[0], off.shape[1] - 1
    out = np.zeros((b, t, host_tables[0].shape[1]), np.float32)
    for ti in range(t):
        for bi in range(b):
            rows = host_tables[ti][idx[ti, off[ti, bi]:off[ti, bi + 1]]]
            if len(rows):
                out[bi, ti] = {"sum": rows.sum(0), "mean": rows.mean(0),
                               "max": rows.max(0)}[combiner]
    return out


def stored_values(host_tables, spec):
    """The values a case's storage holds, as f32 numpy: int8 codes times
    their scale (the JAX suite's ``quant_roundtrip``), bf16-rounded rows,
    or the tables as drawn."""
    if spec["storage"] == "bf16":
        return [torch.from_numpy(t).to(torch.bfloat16).float().numpy() for t in host_tables]
    if spec["storage"] != "int8":
        return host_tables
    out = []
    for t in host_tables:
        if spec["scale_mode"] == "table":
            am = np.abs(t).max()
            scale = np.full(t.shape[0], am / 127.0 if am > 0 else 1.0, np.float32)
        else:
            am = np.abs(t).max(axis=1)
            scale = np.where(am > 0, am / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(t / scale[:, None]), -127, 127).astype(np.int8)
        out.append(q.astype(np.float32) * scale[:, None])
    return out


def surface_phase():
    """The query surface on the card, on an NCCL process group of one over a
    file store ((1, 1) mesh), as ``mesh_1`` joins one: the fuzz
    (:func:`surface_fuzz`), then the int8 checkpoint round trip at full
    Kaggle width (:func:`surface_checkpoint`).  Returns the launches of
    both by kernel-table row, K1's launches under the ownership mask in
    their own row ("K1 masked")."""
    store = tempfile.mkdtemp(prefix="pel_surface_")
    try:
        init_distributed(0, 1, f"file://{store}/store")
        try:
            mesh = make_mesh(data=1, model=1)
            t0 = time.perf_counter()
            launches = surface_fuzz(mesh)
            print(f"surface fuzz: {time.perf_counter() - t0:.1f} s", flush=True)
            t0 = time.perf_counter()
            add_counts(launches, surface_checkpoint(mesh, store))
            print(f"surface checkpoint: {time.perf_counter() - t0:.1f} s", flush=True)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return launches


def surface_fuzz(mesh):
    """Seeds 0-199 of the query-surface fuzz (``surface_battery.draw_fuzz``:
    the JAX suite's draw, with bf16 as a third storage kind), each case's
    tables, dim, packing, storage, scale mode and combiner placed three
    ways: REPLICATE on one card, ROW_HASH on the mesh, and the drawn
    policy on the mesh (routed where it is rowish and the draw routes).
    Each placement runs ``lookup_csr`` and, through ``csr_to_dense``, the
    dense-wire lookup; each result equals REPLICATE on the CPU (the plain
    versions) within 1e-5 abs + 1e-5 rel, the numpy oracle within the JAX
    suite's tolerance (1e-4; int8 2e-3), and a second run bit for bit;
    routed calls drop nothing.  Deterministic algorithms (``index_add_``
    sorts: the routed pools add in a fixed order).  Prints the cases and
    the worst error against the CPU per kernel instance, and the seeds the
    planner refused (COLUMN with packed=True, with its message)."""
    cases, worst, refused, total = {}, {}, {}, {}
    with deterministic(), torch.no_grad():
        for seed in range(SURFACE_SEEDS):
            spec, arrays = surface_battery.draw_fuzz(seed, mesh.data, bf16=True)
            host = [arrays[f"table{i}"] for i in range(len(spec["rows"]))]
            oracle_tol = SURFACE_ORACLE_TOL.get(spec["storage"], 1e-4)
            placements = [("replicate", None), ("row_hash", mesh)]
            if spec["policy"] not in ("replicate", "row_hash"):
                placements.append((spec["policy"], mesh))
            cpu_coll, cpu_params = surface_battery.build(spec, host, "replicate", device="cpu")
            cpu_q = [torch.from_numpy(arrays[k]) for k in ("idx", "off")]
            dev_q = [q.to(DEV) for q in cpu_q]
            oracle = csr_oracle(stored_values(host, spec), arrays["idx"], arrays["off"],
                                spec["combiner"])
            for wire in ("csr", "dense"):
                want, _ = surface_battery.lookup(cpu_coll, cpu_params, spec, *cpu_q,
                                                 wire=wire, routed=False)
                np.testing.assert_allclose(want.numpy(), oracle, rtol=oracle_tol,
                                           atol=oracle_tol, err_msg=f"seed {seed} CPU {wire}")
                for policy, on in placements:
                    try:
                        coll, params = surface_battery.build(spec, host, policy, mesh=on,
                                                             device=DEV)
                    except ValueError as e:
                        if not (policy == "column" and spec["packed"]):
                            raise
                        refused[seed] = f"{type(e).__name__}: {e}"
                        continue
                    rowish = on is not None and policy in surface_battery.ROWISH
                    routed = spec["routed"] and rowish
                    tag = f"seed {seed} {policy} {wire} {spec}"
                    zero_kernel_launches()
                    got, dropped = surface_battery.lookup(coll, params, spec, *dev_q,
                                                          wire=wire, routed=routed)
                    torch.cuda.synchronize()
                    counts = kernel_launches()
                    again, _ = surface_battery.lookup(coll, params, spec, *dev_q, wire=wire,
                                                      routed=routed)
                    if not torch.equal(got, again):
                        raise AssertionError(f"{tag}: a second run differs")
                    if routed and int(dropped.item()):
                        raise AssertionError(f"{tag}: routed lookup dropped {dropped.item()}")
                    got = got.cpu()
                    torch.testing.assert_close(got, want, **KERNEL_TOL, msg=tag)
                    np.testing.assert_allclose(got.numpy(), oracle, rtol=oracle_tol,
                                               atol=oracle_tol, err_msg=tag)
                    err = (got - want).abs().max().item() if got.numel() else 0.0
                    masked = rowish and not routed
                    for row, n in counts.items():
                        if not n:
                            continue
                        inst = (f"{row} masked" if masked and row not in ("K2 masked",
                                                                        "K1 small set")
                                else row)
                        cases[inst] = cases.get(inst, 0) + 1
                        worst[inst] = max(worst.get(inst, 0.0), err)
                        key = "K1 masked" if masked and row == "K1" else row
                        total[key] = total.get(key, 0) + n
    if refused and any(not v.startswith("ValueError: packed storage unsupported")
                       for v in refused.values()):
        raise AssertionError(f"surface: unexpected refusals {refused}")
    for inst in ("K1", "K2", "K1 masked", "K2 masked", "K1 int8 table", "K1 int8 row",
                 "K2 int8 table", "K2 int8 row"):
        if not cases.get(inst):
            raise AssertionError(f"surface: no case launched {inst}: {cases}")
    print(f"surface: {SURFACE_SEEDS} seeds of the query-surface fuzz, REPLICATE, ROW_HASH "
          "and the drawn policy on an NCCL mesh of one, lookup_csr and the dense wire, "
          "each equal to REPLICATE on the CPU (1e-5 abs + 1e-5 rel) and the numpy oracle "
          "(1e-4; int8 2e-3), repeated runs bitwise equal, routed drops 0; cases per "
          f"kernel instance {json.dumps(dict(sorted(cases.items())))}; worst abs error "
          "against the CPU per instance "
          f"{json.dumps({k: float(f'{v:.3g}') for k, v in sorted(worst.items())})}; "
          f"seeds refused by the planner {sorted(refused)} "
          f"({set(refused.values()) or 'none'})", flush=True)
    return total


def surface_checkpoint(mesh, tmp):
    """int8 params through ``utils.checkpoint`` at full width: the
    full-row Kaggle hybrid DLRM (REPLICATE, from a seed) quantized by
    ``quantize_dlrm_embeddings`` in each scale mode serves one B=8192
    request; its params (int8 big set, f32 small set and MLPs) are saved,
    restored into a model built from another seed and quantized the same
    way, and the same request served again: the logits bit for bit.  Then
    a ROW_HASH model's checkpoint on the mesh of one, restored into a
    REPLICATE template, is refused ("layout mismatch").  Prints each
    checkpoint's bytes, save and restore seconds and the request's device
    ms before and after; returns the served requests' launches."""
    config = kaggle_config()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    model = DLRM(config, ShardingPolicy.REPLICATE, hybrid=True, device=DEV, generator=gen)
    fresh = DLRM(config, ShardingPolicy.REPLICATE, hybrid=True, device=DEV,
                 generator=torch.Generator(device=DEV).manual_seed(SEED + 12))
    dense, idx, mask = request(config, gen, BATCH)

    def serve_int8(m, coll, emb):
        return m.apply_from_pooled(dense, coll.lookup(emb, idx, mask, batch_size=BATCH))

    launches = {}
    for mode in SCALE_MODES:
        path = os.path.join(tmp, f"int8_{mode}")
        with torch.no_grad():
            coll, emb = quantize_dlrm_embeddings(model, scale_mode=mode)
            fcoll, femb = quantize_dlrm_embeddings(fresh, scale_mode=mode)
            zero_kernel_launches()
            before = serve_int8(model, coll, emb)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save(path, {**checkpoint.model_params(model), "emb": emb},
                            meta=checkpoint.collection_meta(coll))
            save_s = time.perf_counter() - t0
            template = {**checkpoint.model_params(fresh), "emb": femb}
            t0 = time.perf_counter()
            restored = checkpoint.restore(path, template,
                                          expect_meta=checkpoint.collection_meta(fcoll))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            after = serve_int8(fresh, fcoll, restored["emb"])
            torch.cuda.synchronize()
            add_counts(launches, kernel_launches())
            if not torch.equal(before, after) or not torch.isfinite(before).all():
                raise AssertionError(f"surface checkpoint {mode}: logits differ after the "
                                     f"round trip by {(before - after).abs().max().item()}")
            ms = [device_ms(lambda m=m, c=c, e=e: serve_int8(m, c, e), [()], calls=3)
                  for m, c, e in ((model, coll, emb), (fresh, fcoll, restored["emb"]))]
        size = sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        big = emb["big"]
        print(f"surface checkpoint {mode}: full-row Kaggle int8 DLRM (big set "
              f"{tuple(big['q'].shape)} int8 codes"
              + (f" + {big['scale'].numel() * 4 / 1e9:.3f} GB row scales" if "scale" in big
                 else "") + f"), checkpoint {size} bytes in {sorted(os.listdir(path))}, "
              f"save {save_s:.3f} s, restore {restore_s:.3f} s; B={BATCH} request device ms "
              f"{ms[0]:.4f} before, {ms[1]:.4f} after the round trip; logits bit-equal",
              flush=True)
        shutil.rmtree(path)
        del coll, emb, fcoll, femb, template, restored
    del model, fresh
    rh = DLRM(config, ShardingPolicy.ROW_HASH, hybrid=True, mesh=mesh,
              generator=torch.Generator(device=DEV).manual_seed(SEED + 13))
    rep = DLRM(config, ShardingPolicy.REPLICATE, hybrid=True, device=DEV,
               generator=torch.Generator(device=DEV).manual_seed(SEED + 13))
    path = os.path.join(tmp, "int8_row_hash")
    with torch.no_grad():
        coll, emb = quantize_dlrm_embeddings(rh, scale_mode="table")
        checkpoint.save(path, {**checkpoint.model_params(rh), "emb": emb},
                        meta=checkpoint.collection_meta(coll), mesh=mesh)
        rcoll, remb = quantize_dlrm_embeddings(rep, scale_mode="table")
        try:
            checkpoint.restore(path, {**checkpoint.model_params(rep), "emb": remb},
                               expect_meta=checkpoint.collection_meta(rcoll))
        except ValueError as e:
            if "layout mismatch" not in str(e):
                raise
            print(f"surface checkpoint: the ROW_HASH model's checkpoint (mesh of one, "
                  f"{sorted(os.listdir(path))}) restored into a REPLICATE template: "
                  f"refused, {str(e)[:160]}...", flush=True)
        else:
            raise AssertionError("surface checkpoint: a ROW_HASH checkpoint restored into "
                                 "a REPLICATE template")
    shutil.rmtree(path)
    return launches


def surface_multi_gpu(w, tmp):
    """``surface_battery`` (the query-surface fuzz, bf16 routed and
    broadcast, int8 checkpoints with one file per model shard) over NCCL on
    ``w`` cards, (data 2, model 2) on 4, else (1, w), against the same
    battery over gloo on the CPU, rank by rank."""
    data, model = (2, 2) if w == 4 else (1, w)
    t0 = time.perf_counter()
    inputs = surface_battery.make_inputs(data)
    got, want = (run_battery(data, model, kind, tmp, surface_battery, inputs)
                 for kind in ("cuda", "cpu"))
    cases = compare_battery(got, want, f"multi_gpu surface {data}x{model}")
    refused = sorted(k.split("/")[0] for k, v in want[0].items()
                     if k.startswith("fuzz-") and k.endswith("/error_text"))
    print(f"multi_gpu: surface battery, mesh (data {data}, model {model}) over NCCL on "
          f"{w} cards: {cases} cases equal to the gloo run on the CPU rank by rank (rtol 1e-5 "
          f"atol 1e-6; drop counts, refusals and checkpoint checks exact; refused {refused}) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)


def multi_gpu_phase():
    """Across min(4, count) cards (only where the machine shows more than
    one): the toy battery of the sharded engine over NCCL equal to the same
    battery over gloo on the CPU (which the CPU tests hold against the JAX
    package), on a (1, W) mesh and, with 4 cards, a (2, 2) one; the
    multihost battery on 2 simulated hosts over NCCL and over gloo, every
    case passing on every rank of both; then the full-row ROW_HASH routed
    serve over the W cards; then ``tools/scaling_bench.py`` on the data and
    the routed axis over all the cards, one process a card under torchrun's
    environment, and the lookup bench under torchrun over all the cards
    (ROW_HASH on a (1, N) mesh)."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"multi_gpu: skipped: the machine shows {n} CUDA device "
              "(torch.cuda.device_count()); the phase needs 2 or more", flush=True)
        return
    w = min(4, n)
    tmp = tempfile.mkdtemp(prefix="pel_multi_gpu_")
    try:
        for data, model in [(1, w)] + ([(2, 2)] if w == 4 else []):
            t0 = time.perf_counter()
            got = run_battery(data, model, "cuda", tmp)
            want = run_battery(data, model, "cpu", tmp)
            cases = compare_battery(got, want, f"multi_gpu {data}x{model}")
            print(f"multi_gpu: toy battery, mesh (data {data}, model {model}) over NCCL on "
                  f"{data * model} cards: {cases} cases equal to the gloo run on the CPU "
                  f"(rtol 1e-5 atol 1e-6; 3-step traces rtol 1e-4; drop counts exact) in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        surface_multi_gpu(w, tmp)
        t0 = time.perf_counter()
        hw = 2 * (w // 2)  # 2 hosts of hw / 2 processes
        hosts = {kind: run_multihost_battery(kind, hw, tmp) for kind in ("cuda", "cpu")}
        for kind, ranks in hosts.items():
            for r, results in enumerate(ranks):
                failed = {k: v for k, v in results.items() if v != "ok"}
                if failed or set(results) != set(multihost_battery.CASES):
                    raise AssertionError(f"multihost battery, {kind}, rank {r}: {failed}")
        print(f"multi_gpu: multihost battery, 2 simulated hosts of {hw // 2} processes, "
              f"NCCL over {hw} cards and gloo on the CPU: all {len(multihost_battery.CASES)} "
              f"cases passed on every rank of both, against the same numpy oracle, in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out = os.path.join(tmp, "serve")
        os.makedirs(out)
        t0 = time.perf_counter()
        _spawn([[sys.executable, os.path.abspath(__file__), "--mesh-worker", str(r), str(w),
                 os.path.join(out, "store"), out] for r in range(w)], timeout=900)
        for r in range(w):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                print(f"multi_gpu serve, full-row Kaggle hybrid, big set ROW_HASH over {w} "
                      f"cards, B={BATCH}: " + f.read(), flush=True)
        print(f"multi_gpu serve: {time.perf_counter() - t0:.1f} s", flush=True)
        for axis in ("data", "routed"):  # the scaling bench under torchrun's environment
            t0 = time.perf_counter()
            port = _free_port()
            outs = _spawn([[sys.executable, "-m",
                            "pim_embedding_lookup_tpu_torch.tools.scaling_bench",
                            "--axis", axis]] * n, timeout=600,
                          env=[launcher_env(r, n, n, port) for r in range(n)])
            rep = json.loads(outs[0].strip().splitlines()[-1])
            counts = [str(c) for c in (1, 2, 4, 8, 16, 32) if c <= n]
            if list(rep["lookups_per_s"]) != counts or any(rep["routed_drops"].values()):
                raise AssertionError(f"scaling_bench --axis {axis}: {rep}")
            print(f"multi_gpu scaling_bench --axis {axis} over {n} cards (NCCL, "
                  f"{time.perf_counter() - t0:.1f} s): " + json.dumps(rep), flush=True)
        # the lookup bench under torchrun: bf16 on the dense wire (masked K1),
        # int8 "row" on the bucketed CSR wire (masked int8 K1 and K2)
        for argv, row in (([], "K1"), (["--dtype", "int8", "--int8-scale", "row", "--wire",
                                        "csr-bucketed", "--csr-ragged"], "K2 int8 row")):
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(n), "-m", "pim_embedding_lookup_tpu_torch.cli",
                 "bench", "--no-baseline", *argv],
                capture_output=True, text=True, timeout=900, cwd=REPO)
            if run.returncode != 0:
                raise AssertionError(f"torchrun cli bench {argv} exited {run.returncode}:\n"
                                     f"{run.stderr[-3000:]}")
            rep = json.loads(run.stdout.strip().splitlines()[-1])
            counts = rep["device_kernel_launches"]
            if (rep["device_mesh"] != [1, n] or not rep["value"] > 0 or not counts[row] > 0
                    or min(counts.values()) < 0):
                raise AssertionError(f"torchrun cli bench {argv}: {rep}")
            print(f"multi_gpu cli bench {' '.join(argv)} under torchrun over {n} cards "
                  f"(ROW_HASH, NCCL, {time.perf_counter() - t0:.1f} s): " + json.dumps(rep),
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--mesh-worker"]:  # one rank of multi_gpu's serve
        rank, world = map(int, argv[1:3])
        return mesh_worker(rank, world, *argv[3:5])
    if argv[:1] == ["--multihost-worker"]:  # the process of multihost_1
        return multihost_worker(argv[1])
    only = argv[1] if len(argv) == 2 and argv[0] == "--only" else None
    if argv and only not in ("multi_gpu", "tools", "bench", "surface", "int8", "masked"):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
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
    native_build = start_native_build()  # the feeder library beside the kernels
    built = _build.build()
    finish_native_build(native_build)
    print(f"build: compiled {built or 'nothing (cached)'}"
          f"{' and native/libpelfeeder.so' if native_build else ''} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in ptxas_lines(_build.logs):  # every kernel instance's registers and spills
        print(line, flush=True)

    if only is not None:  # one phase alone (multi_gpu: e.g. on a 4-chip call)
        {"multi_gpu": multi_gpu_phase, "tools": tools_phase, "bench": bench_phase,
         "surface": surface_phase, "int8": lambda: int8_only(card),
         "masked": lambda: masked_only(card)}[only]()
        print(f"chip_smoke: {only} phase passed in {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return 0

    # -- 2b. kernel edge cases: K1 and K2 on every code path, toy sizes ---------
    t0 = time.perf_counter()
    edge_cases = edge_phase(torch.Generator(device=DEV).manual_seed(SEED))
    print(f"kernel edge cases: {edge_cases} cases of K1 and K2 on the vector and "
          "scalar paths, by window and by group, equal to their plain versions "
          "(1e-5 abs + 1e-5 rel), "
          f"repeated launches bitwise equal, in {time.perf_counter() - t0:.2f} s",
          flush=True)
    t0 = time.perf_counter()
    int8_cases = int8_edge_phase(torch.Generator(device=DEV).manual_seed(SEED + 1))
    print(f"int8 kernel edge cases: {int8_cases} cases of int8 K1 and K2 in both scale "
          "modes on the vector and scalar paths, by window and by group, masked or not, "
          "equal to their plain versions (1e-5 abs + 1e-5 rel), repeated launches bitwise "
          f"equal, in {time.perf_counter() - t0:.2f} s", flush=True)

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
    small = model.collection.small  # the benchmark's Kaggle cells' small-set shape
    small_sets = [kaggle_ids(small, gen, SMALL_SET_BATCH, 1, 1.0) for _ in range(ID_SETS)]
    small_f32 = k1_case(f"small set ({len(small.layout.table_rows)} tables x "
                        f"B={SMALL_SET_BATCH}, L=1, f32 rows rounded to bf16)",
                        model.emb_small, 16, 1, small_sets, round_bf16=True)
    del small_sets
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
        zero_k1()
        logits, times, allocs = serve(model, requests[:REQUESTS])
        k1_launches, small_launches = take_k1()
        _, again, allocs_again = serve(model, requests[:REQUESTS])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in logits:
        if out.shape != (BATCH,) or not torch.isfinite(out).all():
            raise AssertionError(f"bad logits: shape {tuple(out.shape)}")
    if (k1_launches, small_launches) != (REQUESTS, REQUESTS):
        raise AssertionError(f"K1 launched {k1_launches} times and the small set's K1 "
                             f"{small_launches} for {REQUESTS} requests")
    with torch.no_grad(), mock.patch.object(
        collection_mod, "embedding_bag_fixedl", embedding_bag_fixedl_reference
    ):
        for req, out in zip(requests, logits):
            torch.testing.assert_close(out, model(*req), rtol=0, atol=1e-4)
    med = statistics.median(times)
    print(f"main path: {REQUESTS} requests of B={BATCH}: ms/request "
          f"{[round(t, 4) for t in times]}, median {med:.4f} ms, "
          f"{BATCH / med * 1e3:.0f} samples/s, K1 launches {k1_launches} and the small "
          f"set's {small_launches}, "
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
            "small_set_k1": lambda: _small_pooled_lookup(
                coll.small, emb["small"], idx[sel_s], mask[sel_s], batch_size=BATCH),
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

    # -- 7. length-bucketed CSR on one request, against lookup_csr, packed by
    # the native packer (byte-identical to the numpy one) ----------------------
    native_launches = native_phase(coll, emb, idx, off, pooled)
    del model, coll, emb, big, fns, requests, logits, pooled

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

    # -- 10b. int8: the capacity mode's serving path at full Kaggle rows -------
    t0 = time.perf_counter()
    int8_rows, int8_launches = int8_phase(gen, card)
    print(f"int8 phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 11. training at full Kaggle rows, then the toy checks ------------------
    t0 = time.perf_counter()
    train_launches = train_phase(gen)
    toy_train_checks(gen)
    print(f"train phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 12. mesh_1: the sharded engine through NCCL at world size 1 ------------
    t0 = time.perf_counter()
    masked_launches = mesh_1_phase(gen)
    print(f"mesh_1 phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 12b. multihost_1: parallel.multihost in a job of one ---------------------
    t0 = time.perf_counter()
    multihost_1 = multihost_1_phase()
    print(f"multihost_1 phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 13. shards_4: four shards of the full-row big set in one process -------
    t0 = time.perf_counter()
    shard_rows = shards_4_phase(gen)
    print(f"shards_4 phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 13a. masked: the masked walk at the per-rank shapes ----------------------
    t0 = time.perf_counter()
    masked_phase(gen, card)
    print(f"masked phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 13b. cli: the training entry point at full Kaggle width ----------------
    t0 = time.perf_counter()
    cli_k1 = cli_phase()
    print(f"cli phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 13c. tools: the measurement entry points at full Kaggle width ----------
    t0 = time.perf_counter()
    tools = tools_phase()
    print(f"tools phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 13d. bench: the lookup bench and the CLI's bench and sweep ---------------
    t0 = time.perf_counter()
    benched = bench_phase()
    print(f"bench phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 13e. surface: the query-surface fuzz and the full-width int8 checkpoint
    t0 = time.perf_counter()
    surfaced = surface_phase()
    print(f"surface phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 14. multi_gpu: the sharded engine over several cards, where there are --
    t0 = time.perf_counter()
    multi_gpu_phase()
    print(f"multi_gpu phase: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s "
          "(build included)", flush=True)
    src = "pim_embedding_lookup_tpu_torch/csrc/"
    pallas = "pim_embedding_lookup_tpu/ops/pallas_lookup.py:"

    def entry(name, source, replaces, launches, row, replaced=None):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaced or pallas + replaces, "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    int8_mesh = masked_launches["int8"]
    print("kernels: K1, K2, K3, K4 forward, K4 backward; the small set's K1 (bf16-rounded, "
          "f32 rows) in a row of its own, its launches over every phase that counts them; "
          "K1 and K2 launches over "
          "the served requests, the timed train steps, the bucketed dispatch on the native "
          f"pack {list(native_launches)} and (K1) the traced CLI's {cli_k1} steps; "
          "masked K1, K2 and K4 backward: "
          "the mean of ROW_HASH's 4 shard launches (shards_4), launches over mesh_1's "
          "broadcast requests, train steps (sparse and dense-autodiff) and CSR-wire "
          "gradient; multihost_1's masked K1 launches "
          f"{multihost_1['k1_masked_launches']} are its subprocess's; int8 K1 and K2 in "
          "each scale mode: the int8 phase's times, launches over its served requests and "
          "mesh_1's REPLICATE int8 requests; masked int8 launches over mesh_1's ROW_HASH "
          "broadcast requests: " + json.dumps({f"{k} {m}": n for (k, m, kind), n in
                                                int8_mesh.items() if kind == "masked"})
          + "; every row adds the tools phase's launches (its per-tool lines; K3: the "
          "kernel lab at d=128; K4: the lab's pallas and scatter probes; masked K4 "
          "backward: the lab's drophot probe; int8: the capacity bench) and the bench "
          "phase's (its `bench <case>:` and `sweep` lines: the cli bench subprocesses and "
          "the sweeps; K3: bigtable on the CSR wire; not its plain checks) and the surface "
          "phase's (the fuzz's first run of each lookup, K1 under ROW_HASH's ownership mask "
          "in masked K1's row, masked int8 launches in the int8 rows; the int8 checkpoint's "
          "served requests): " + json.dumps(surfaced),
          flush=True)
    phases = dict(tools)  # the tools, bench and surface phases' launches by kernel-table row
    add_counts(phases, benched)
    add_counts(phases, surfaced)
    print(json.dumps({"kernels": [
        entry("K1 embedding_bag_fixedl (fixed-L gather+pool)", "gather_pool.cu", "272",
              k1_launches + train_launches["K1"] + native_launches[0] + cli_k1
              + phases["K1"], main_f32),
        entry("K1 small set embedding_bag_fixedl(round_bf16=True) (the hybrid's small set, "
              "f32 rows rounded to bf16)", "gather_pool.cu", "", SMALL_SET_K1[0]
              + phases.get("K1 small set", 0), small_f32,
              replaced="pim_embedding_lookup_tpu/parallel/hybrid.py:496 _bucket_entry_rows "
                       "(the bf16 one-hot einsum, not a Pallas kernel)"),
        entry("K2 embedding_bag_csr_packed (CSR gather+pool, d=16 packed)", "csr_pool.cu",
              "92", k2_launches + train_launches["K2"] + native_launches[1] + phases["K2"],
              k2_f32),
        entry("K3 embedding_bag_csr_packed (CSR gather+pool, d=128 rows)",
              "csr_pool.cu", "48", k3_launches + phases["K3"], k3),
        entry("K4 forward embedding_bag_csr_sum (differentiable CSR bag)",
              "csr_pool.cu", "204", k4_launches[0] + phases["K4 fwd"], k4_fwd),
        entry("K4 backward embedding_bag_csr_grad (CSR bag gradient)",
              "csr_pool.cu", "230", k4_launches[1] + phases["K4 bwd"], k4_bwd),
        entry("K1 masked embedding_bag_fixedl (row shard, ownership mask)",
              "gather_pool.cu", "272", masked_launches["K1"] + phases.get("K1 masked", 0),
              mean_row(shard_rows["K1"])),
        entry("K2 masked embedding_bag_csr_packed (row shard, ownership mask)",
              "csr_pool.cu", "92", masked_launches["K2"] + phases["K2 masked"],
              mean_row(shard_rows["K2"])),
        entry("K4 backward masked embedding_bag_csr_grad (row shard, ownership mask)",
              "csr_pool.cu", "230", masked_launches["K4 bwd"] + phases["K4 bwd masked"],
              mean_row(shard_rows["K4 bwd"])),
        *(entry(f"{k} int8 {mode} scale mode {fn} (int8 codes"
                + (", per-row f32 scales)" if mode == "row" else "; table scale folded after)"),
                source, line,
                int8_launches[(k, mode)] + int8_mesh[(k, mode, "REPLICATE")]
                + phases[f"{k} int8 {mode}"],
                int8_rows[(k, mode)])
          for k, fn, source, line in (
              ("K1", "embedding_bag_fixedl", "gather_pool.cu", "272"),
              ("K2", "embedding_bag_csr_packed", "csr_pool.cu", "92"))
          for mode in SCALE_MODES),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
