#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from source, holds each against its plain
PyTorch version at the main path's shapes and times it beside that version,
the PyTorch library call that computes the same function and the card's
bound.  Then it serves the Criteo-Kaggle hybrid DLRM forward at full table
rows (5 requests of 8192 samples), checks that the forward went through the
kernels and agrees with the same forward pooled by the plain version, and
holds the port on the card against the port on the CPU at toy sizes.

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero, printing no result, without
them.  Any failed check raises.  The line before the last is a JSON object
of per-kernel numbers; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
    ShardingPolicy,
    TableConfig,
    kaggle_config,
    toy_config,
)
from pim_embedding_lookup_tpu_torch.ops import _build
from pim_embedding_lookup_tpu_torch.ops.gather_pool import (
    embedding_bag_fixedl,
    embedding_bag_fixedl_reference,
)
from pim_embedding_lookup_tpu_torch.parallel import collection as collection_mod
from pim_embedding_lookup_tpu_torch.parallel.hybrid import _mxu_pooled_lookup

# H100 SXM published peaks (NVIDIA data sheet), at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores

SEED = 0
BATCH = 8192
REQUESTS = 5
ID_SETS = 16  # distinct id sets cycled while timing: > 50 MB of rows, past L2
TIMED_RUNS = 20
CALLS_PER_RUN = 10
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
    # f32: sums in another order; bf16 storage: both sides add the same
    # bf16 values in f32, so the same tolerance holds relative to the sum
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

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
    moved = (active * d * storage.element_size()  # rows read
             + ids.numel() * 5  # int32 id + 1-byte mask per entry
             + bags * d * 4)  # f32 output
    ops = active * d  # one add per loaded value
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    row = dict(case=name, dtype=str(storage.dtype).replace("torch.", ""),
               bags=bags, pooling=pooling, d=d, active_entries=active,
               max_abs_err=err, kernel_ms=kernel_ms, kernel_call_ms=kernel_call_ms,
               plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. card -------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: compiled {built or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # -- 3. K1 against its plain version at the main path's shapes ------------
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
    del big_bf16
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

    # -- 4. the main path: hybrid DLRM forward at full Kaggle rows ------------
    requests = [request(config, gen, BATCH) for _ in range(REQUESTS + 1)]
    with torch.no_grad():
        model(*requests[-1])  # warm-up (cuBLAS handles, allocator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        embedding_bag_fixedl.launches = 0
        logits, times = [], []
        for req in requests[:REQUESTS]:
            t0 = time.perf_counter()
            out = model(*req)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            logits.append(out)
        launches = embedding_bag_fixedl.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in logits:
        if out.shape != (BATCH,) or not torch.isfinite(out).all():
            raise AssertionError(f"bad logits: shape {tuple(out.shape)}")
    if launches != REQUESTS:
        raise AssertionError(f"K1 launched {launches} times for {REQUESTS} requests")
    with torch.no_grad(), mock.patch.object(
        collection_mod, "embedding_bag_fixedl", embedding_bag_fixedl_reference
    ):
        for req, out in zip(requests, logits):
            torch.testing.assert_close(out, model(*req), rtol=0, atol=1e-4)
    med = statistics.median(times)
    print(f"main path: {REQUESTS} requests of B={BATCH}: ms/request "
          f"{[round(t, 4) for t in times]}, median {med:.4f} ms, "
          f"{BATCH / med * 1e3:.0f} samples/s, K1 launches {launches}, "
          f"peak memory {peak_gb:.3f} GB; logits finite and equal to the "
          "plain-pooled forward (atol 1e-4)", flush=True)

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
        ops = {name: aten_ops(fn) for name, fn in fns.items()}
    print("stages (median ms): " + json.dumps(stages), flush=True)
    print("stages (ATen operations per call): " + json.dumps(ops), flush=True)
    fwd = stages["forward"]
    print(f"forward: device busy {fwd['device_ms']:.4f} ms of {fwd['call_ms']:.4f} ms "
          f"per call, idle share {1 - fwd['device_ms'] / fwd['call_ms']:.3f}", flush=True)
    del model, requests, logits, pooled

    # -- 5. port on the card against the port on the CPU ----------------------
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
        req = request(cfg, gen, 64, pooling, 0.7)
        with torch.no_grad():
            on_card = gpu(*req)
            on_cpu = cpu(*(t.cpu() for t in req))
        err = (on_card.cpu() - on_cpu).abs().max().item()
        torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-4, atol=1e-4)
        print(f"card vs CPU, {name} DLRM (B=64, L={pooling}): logits max abs "
              f"err {err:.3g} (tol 1e-4)", flush=True)

    print("kernels: K1", flush=True)
    print(json.dumps({"kernels": [{
        "name": "K1 embedding_bag_fixedl (fixed-L gather+pool)",
        "route": "cuda",
        "source": "pim_embedding_lookup_tpu_torch/csrc/gather_pool.cu",
        "replaces": "pim_embedding_lookup_tpu/ops/pallas_lookup.py:272",
        "launches": launches,
        "max_abs_err": main_f32["max_abs_err"],
        "ms": main_f32["kernel_ms"],
        "plain_ms": main_f32["plain_ms"],
        "bound_ms": main_f32["bound_ms"],
        "bound_by": main_f32["bound_by"],
        "library_ms": main_f32["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
