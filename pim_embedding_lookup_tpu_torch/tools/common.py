"""What the measurement tools share: the config switch, seeded ids, the
rotating device loop and its two clocks, and joining a job.

Timing, on the card: a loop of N calls of one step, each step's output
consumed into an accumulator on the device (``acc += out.sum()``) so that
no call can be skipped, and its ids rotated on the device by ``(idx +
stride) % rows`` (stride ``rows // 7 + 1``), so that no two calls read the
same rows.  Two clocks read the loop: the host clock to a synchronize
(host µs per call: what a caller in a loop sees, launch cost included) and
CUDA events around the calls held behind a sleep kernel, so that they run
back to back and the host's launch cost stays out (device µs per call).
On the CPU only the host clock runs.  ``chip_smoke.py`` times its kernels
with the same two functions, :func:`call_ms` and :func:`device_ms`.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..config import (
    ShardingPolicy,
    kaggle_config,
    mlperf_dcnv2_config,
    random_config,
    toy_config,
)
from ..device import resolve_device
from ..ops.csr_pool import embedding_bag_csr_grad, embedding_bag_csr_packed, embedding_bag_csr_sum
from ..ops.gather_pool import embedding_bag_fixedl

CONFIGS = {"kaggle": kaggle_config, "random": random_config, "toy": toy_config,
           "dcnv2": mlperf_dcnv2_config}
REPO = Path(__file__).resolve().parents[2]  # the checkout holding the package


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N or cpu; without a card and "
                         "without --device=cpu the tool fails")


def device_info(dev: torch.device) -> dict:
    """The device a result was measured on, for its JSON line."""
    if dev.type == "cuda":
        return {"device_name": torch.cuda.get_device_name(dev),
                "device_count": torch.cuda.device_count()}
    return {"device_name": "cpu", "device_count": 1}


def zero_kernel_launches() -> None:
    """Sets every launch counter of the pool kernels' wrappers to 0."""
    for fn in (embedding_bag_fixedl, embedding_bag_csr_packed):
        fn.launches = fn.int8_launches = fn.int8_row_launches = 0
    embedding_bag_fixedl.bf16_round_launches = 0
    embedding_bag_csr_packed.masked_launches = embedding_bag_csr_packed.masked_int8_launches = 0
    embedding_bag_csr_sum.launches = 0
    embedding_bag_csr_grad.launches = embedding_bag_csr_grad.masked_launches = 0


def kernel_launches(full_width: bool = False) -> dict:
    """The pool kernels' launches, by row of the kernel table (PERF.md):
    K1 and K2 on float storage, K1's bf16-rounding instance (the hybrid's
    small set over f32 rows), K2 without an ownership mask (K3's row with
    ``full_width``: the caller's K2 launches were at d % 128 == 0), their
    int8 instances in each scale mode, masked K2 on float storage, K4's
    forward, its backward and its masked backward.  Each launch counts in
    one row; K1's masked launches count in K1's.  The wrappers count a
    launch only where they launch their kernel on the card."""
    k1, k2, grad = embedding_bag_fixedl, embedding_bag_csr_packed, embedding_bag_csr_grad
    masked = k2.masked_launches - k2.masked_int8_launches
    return {
        "K1": k1.launches - k1.int8_launches - k1.bf16_round_launches,
        "K1 small set": k1.bf16_round_launches,
        "K1 int8 table": k1.int8_launches - k1.int8_row_launches,
        "K1 int8 row": k1.int8_row_launches,
        "K3" if full_width else "K2": k2.launches - k2.int8_launches - masked,
        "K2 int8 table": k2.int8_launches - k2.int8_row_launches,
        "K2 int8 row": k2.int8_row_launches,
        "K2 masked": masked,
        "K4 fwd": embedding_bag_csr_sum.launches,
        "K4 bwd": grad.launches - grad.masked_launches,
        "K4 bwd masked": grad.masked_launches,
    }


def uniform_ids(rng: np.random.Generator, tables, n: int) -> np.ndarray:
    """[T, n] int32 uniform local ids, drawn table by table as the JAX
    tools draw them."""
    return np.stack([rng.integers(0, tb.num_rows, size=n) for tb in tables]).astype(np.int32)


def rotation(tables, device) -> tuple[torch.Tensor, torch.Tensor]:
    """([T, 1] rows, [T, 1] stride) int32 on ``device`` for :func:`rotate`."""
    rows = [tb.num_rows for tb in tables]
    return (torch.tensor(rows, dtype=torch.int32, device=device)[:, None],
            torch.tensor([max(1, n // 7 + 1) for n in rows], dtype=torch.int32,
                         device=device)[:, None])


def rotate(idx, rows, stride):
    """Each table's ids moved by its stride, modulo its rows: a bijection,
    so the ids' duplicate structure stays the same.  ``idx`` is a [T, *]
    tensor or a tuple of them (the bucketed CSR wire's id arrays), each
    rotated alike."""
    if isinstance(idx, tuple):
        return tuple((a + stride) % rows for a in idx)
    return (idx + stride) % rows


class RotatingLoop:
    """One call runs ``body(idx)``, adds the sum of its output to ``acc``
    and rotates ``idx`` (a tensor or a tuple of them, :func:`rotate`);
    ``acc`` and ``idx`` stay on the device."""

    def __init__(self, body, idx, rows, stride):
        self.body, self.idx, self.rows, self.stride = body, idx, rows, stride
        self.acc = torch.zeros((), dtype=torch.float32, device=rows.device)

    def __call__(self):
        out = self.body(self.idx)
        self.acc += out.float().sum()
        self.idx = rotate(self.idx, self.rows, self.stride)
        return out


def sync(device=None) -> None:
    """Wait for ``device`` (default: the current card); nothing on the CPU."""
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _cycles_per_ms() -> float:
    """Clock cycles of the card's sleep kernel per millisecond."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def call_ms(fn, inputs, calls=10, runs=20, device=None) -> float:
    """Median over ``runs`` of host-clock time per call, each run ``calls``
    calls cycling through ``inputs`` and ending in a synchronize of
    ``device`` (default: the current card): what a caller in a loop sees,
    host launch cost included.  The first three inputs warm up first."""
    for args in inputs[:3]:
        fn(*args)
    sync(device)
    times, k = [], 0
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*inputs[k % len(inputs)])
            k += 1
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    return statistics.median(times)


def device_ms(fn, inputs, calls=10, runs=20, hold_runs=None) -> float:
    """Median over ``runs`` of device time per call on the current card:
    CUDA events around ``calls`` calls cycling through ``inputs``.  A sleep
    kernel ahead of each run holds the stream for twice the host's enqueue
    time (the median of ``hold_runs`` host-clock runs, default ``runs``),
    so the calls run back to back and the host's launch cost stays out of
    the number.  Keep ``calls`` times the kernels a call launches under the
    launch queue's ~1000 entries: past it the host waits, the sleep ends
    early and the gaps count."""
    hold_runs = runs if hold_runs is None else hold_runs
    hold = 2 * call_ms(fn, inputs, calls, runs=hold_runs) * calls * _cycles_per_ms()
    times, k = [], 0
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold))
        start.record()
        for _ in range(calls):
            fn(*inputs[k % len(inputs)])
            k += 1
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def loop_us(step, iters: int, device: torch.device, *, warmup: int = 2,
            device_calls: int | None = None, device_runs: int = 1,
            hold_runs: int | None = None,
            events: bool = True) -> tuple[float, float | None]:
    """(host µs, device µs or None) per call of ``step``: ``warmup`` calls,
    then one host-clock loop of ``iters`` calls, then on the card (unless
    ``events`` is False) the median of ``device_runs`` event-timed runs of
    ``device_calls`` calls (default ``iters``) behind the sleep kernel,
    sized from ``hold_runs`` host runs (:func:`device_ms`)."""
    for _ in range(warmup):
        step()
    host = call_ms(step, [()], calls=iters, runs=1, device=device) * 1e3
    if device.type != "cuda" or not events:
        return host, None
    calls = iters if device_calls is None else device_calls
    return host, device_ms(step, [()], calls=calls, runs=device_runs,
                           hold_runs=hold_runs) * 1e3


# -- jobs ---------------------------------------------------------------------------


def join(device, *, group_of_one: bool = False) -> tuple[torch.device, bool]:
    """This process's device, joining the job where there is one: under a
    launcher's environment (``WORLD_SIZE``, as torchrun sets it) every
    process joins it; otherwise, where ``group_of_one``, a process group
    of one.  A group already joined (by a caller) is kept.  Returns
    (device, whether this call joined a group, to be left by
    :func:`leave`)."""
    from ..cli import _free_port
    from ..parallel import multihost

    dev = resolve_device(device)
    if dist.is_initialized():
        return multihost.initialize(), False
    if "WORLD_SIZE" in os.environ:
        return multihost.initialize(device=None if device is None else dev), True
    if group_of_one:
        return multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=dev), True
    return dev, False


def leave(joined: bool) -> None:
    if joined and dist.is_initialized():
        dist.destroy_process_group()


def tool_mesh(device, routed: bool):
    """(device, mesh or None, policy, joined), as the JAX tools place their
    tables: every process of the job on the model axis under ROW_HASH, or
    one process under REPLICATE with no mesh; ``routed`` on one process
    runs ROW_HASH on a mesh of one, as the port's CLI does."""
    from ..parallel.mesh import make_mesh

    dev, joined = join(device, group_of_one=routed)
    if not dist.is_initialized() or (dist.get_world_size() == 1 and not routed):
        return dev, None, ShardingPolicy.REPLICATE, joined
    mesh = make_mesh(data=1, model=dist.get_world_size(), device=dev)
    return dev, mesh, ShardingPolicy.ROW_HASH, joined


def primary() -> bool:
    """Whether this process prints a tool's result (rank 0, or no job)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def without_flag(argv: list[str], flag: str) -> list[str]:
    """``argv`` less ``flag`` and its value (``--flag V`` or ``--flag=V``)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == flag:
            skip = True
        elif not a.startswith(flag + "="):
            out.append(a)
    return out


def launch_local(module: str, argv: list[str], n: int, *, timeout: float = 900) -> str:
    """Run ``python -m module argv`` as ``n`` CPU processes of one job, each
    with the environment torchrun gives a process on one host (gloo over
    localhost); returns rank 0's standard output.  Raises, with every
    failed rank's error output, where a rank fails or the job outlives
    ``timeout`` seconds."""
    from ..cli import _free_port

    port = _free_port()
    procs, logs = [], []
    for rank in range(n):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(n), GROUP_RANK="0", OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        logs.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", module, *argv, "--device", "cpu"], env=env, cwd=REPO,
            stdout=out, stderr=err, text=True))
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
        if any(p.poll() not in (None, 0) for p in procs):
            time.sleep(5)  # the others may wait in a collective for the failed rank
            break
        time.sleep(0.1)
    texts = []
    for p, (out, err) in zip(procs, logs):
        if p.poll() is None:
            p.kill()
        p.wait()
        texts.append(tuple(f.seek(0) or f.read() for f in (out, err)))
        out.close()
        err.close()
    failed = [f"rank {r} (exit {p.returncode}):\n{err[-3000:]}"
              for r, (p, (_, err)) in enumerate(zip(procs, texts)) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"{module} on {n} CPU processes failed:\n" + "\n".join(failed))
    sys.stderr.write(texts[0][1])  # rank 0's progress lines
    return texts[0][0]
