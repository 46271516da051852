"""A cell over a mesh: one process a card.

``run.py`` hands a cell whose configuration's ``mesh`` holds d x m > 1
cards to :func:`launch`, which starts ``run.py`` again once a rank, with
``--rank r``: rank r drives ``cuda:r`` (under ``--device cpu``, the CPU
through gloo) and joins the port's process group (``systems/_mesh.py``).
Only rank 0's result line and ``check`` lines are printed, after every
rank has ended with code 0; the other ranks' standard error is passed on
with a ``[rank r]`` prefix.  A rank that exits with another code, or that
has not joined within ``JOIN_S`` seconds, or a run past ``RUN_S``, ends
every rank, and the launcher exits with another code than 0.

Inside a rank, :class:`Ranks` is its place in the mesh and the harness's
own collectives over it.  Each runs outside the measured window: rank 0's
call count broadcast before it, a barrier at its start, and after it the
window's end, the peaks and the check's numbers reduced to rank 0.
"""

from __future__ import annotations

import ctypes
import math
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch
import torch.distributed as dist

RUN = Path(__file__).resolve().parent / "run.py"
JOINED = "mesh: joined as rank"  # a rank's line on standard error once it joined
JOIN_S = 300.0  # seconds from the launcher's start until every rank has joined
RUN_S = 1500.0  # seconds for the whole run, a first build of the kernels included


# -- the launcher ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent():
    """In a rank, before it runs: SIGKILL when the launcher dies."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def launch(argv: list[str], world: int, started: float) -> int:
    """Runs ``run.py argv`` as ``world`` ranks and waits for all of them;
    returns 0 where every rank ended with 0, else another code.
    ``started`` is the launcher's start, from which rank 0 counts set-up."""
    base = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    procs = [subprocess.Popen([sys.executable, str(RUN), *argv, "--rank", str(r),
                               "--started", repr(started)],
                              env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              preexec_fn=_die_with_parent)
             for r in range(world)]
    held_out, held_err, joined = [], [], set()
    lock = threading.Lock()

    def pump(r, stream, err):
        for line in stream:
            with lock:
                if err and line.startswith(JOINED):
                    joined.add(r)
                if r == 0 and (not err or line.startswith("check ")):
                    (held_err if err else held_out).append(line)
                else:
                    sys.stderr.write(line if r == 0 else f"[rank {r}] {line}")
                    sys.stderr.flush()

    pumps = [threading.Thread(target=pump, args=(r, s, s is p.stderr), daemon=True)
             for r, p in enumerate(procs) for s in (p.stdout, p.stderr)]
    for t in pumps:
        t.start()
    previous = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        code = _watch(procs, joined, lock, started)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for t in pumps:
            t.join(timeout=10)
        signal.signal(signal.SIGTERM, previous)
    sys.stderr.writelines(held_err)
    sys.stderr.flush()
    if code == 0:
        sys.stdout.writelines(held_out)
        sys.stdout.flush()
    return code


def _watch(procs, joined, lock, started) -> int:
    """Waits until every rank has ended with 0 (returns 0), one has ended
    with another code (returns it, 1 for a signal), or a deadline passed
    (returns 1)."""
    while True:
        codes = [p.poll() for p in procs]
        failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            r, c = failed[0]
            _say(f"launcher: rank {r} exited with code {c}: ending the other ranks")
            return c if c > 0 else 1
        if all(c == 0 for c in codes):
            return 0
        waited = time.time() - started
        with lock:
            late = sorted(set(range(len(procs))) - joined)
        if late and waited > JOIN_S:
            _say(f"launcher: rank(s) {late} did not join the mesh within {JOIN_S:.0f} s: "
                 "ending every rank")
            return 1
        if waited > RUN_S:
            _say(f"launcher: the run passed {RUN_S:.0f} s: ending every rank")
            return 1
        time.sleep(0.05)


def _say(text: str):
    sys.stderr.write(f"{text}\n")
    sys.stderr.flush()


# -- inside a rank -----------------------------------------------------------------


class Ranks:
    """Rank ``rank``'s place in the configuration's (data, model) mesh: data
    row ``rank // model``, model column ``rank % model``; ``mesh`` is the
    port's ``PortMesh``, which the system is built on."""

    def __init__(self, rank: int, cfg: dict, device: torch.device):
        from h100_bench.systems._mesh import join

        self.rank, self.device = rank, device
        self.data, self.model = cfg["mesh"]["data"], cfg["mesh"]["model"]
        self.data_index = rank // self.model
        self.mesh = join(device, self.data, self.model)
        _say(f"{JOINED} {rank} of {self.data} x {self.model}")

    @property
    def lead(self) -> bool:
        return self.rank == 0

    # -- the batch over the data axis ---------------------------------------

    def data_slice(self, b: dict) -> dict:
        """This data row's part of the global batch ``b``: samples
        [i B/d, (i+1) B/d) of data row i, on the batch's wire (the dense
        wire's bag-major ids and mask; the CSR wire's window, its offsets
        from 0 and its ids padded with 0 to the widest table's)."""
        bsz = b["dense"].shape[0]
        if bsz % self.data:
            raise ValueError(f"batch {bsz} does not divide over the data axis of {self.data}")
        bd = bsz // self.data
        lo, hi = self.data_index * bd, (self.data_index + 1) * bd
        out = {"dense": b["dense"][lo:hi].clone(), "labels": b["labels"][lo:hi].clone()}
        if "offsets" not in b:
            w = b["ids"].shape[1] // bsz
            out.update(ids=b["ids"][:, lo * w:hi * w].clone(),
                       mask=b["mask"][:, lo * w:hi * w].clone())
            return out
        off = b["offsets"][:, lo:hi + 1]
        starts, stops = off[:, 0].tolist(), off[:, -1].tolist()
        ids = b["ids"].new_zeros(b["ids"].shape[0], max(e - s for s, e in zip(starts, stops)))
        for k, (s, e) in enumerate(zip(starts, stops)):
            ids[k, :e - s] = b["ids"][k, s:e]
        out.update(ids=ids, offsets=(off - off[:, :1]).contiguous())
        return out

    # -- the harness's collectives --------------------------------------------

    def _reduce(self, values, op, group=None) -> list[float]:
        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=op, group=group)
        return t.tolist()

    def counts(self, fn, items, seconds: float, trace_seconds: float) -> tuple[int, int]:
        """Every rank calls ``fn`` on each of ``items`` (a warm-up pass), and
        rank 0 times it: the window's call count, so that it lasts about
        ``seconds``, and the traced segment's, about ``trace_seconds``,
        broadcast from rank 0."""
        _sync(self.device)
        t0 = time.perf_counter()
        for b in items:
            fn(b)
        _sync(self.device)
        per_call = (time.perf_counter() - t0) / len(items)
        n = torch.tensor([max(1, round(seconds / per_call)),
                          max(1, round(trace_seconds / per_call))], device=self.device)
        dist.broadcast(n, src=0)
        return tuple(n.tolist())

    def barrier(self):
        """Returns once every rank has reached it."""
        self._reduce([0.0], dist.ReduceOp.SUM)

    def window(self, own_s: float) -> float:
        """The window over every rank, from rank 0's start after the
        barrier to the last rank's last completion, given this rank's own
        window, which ended just now."""
        end = time.monotonic()
        start = end - own_s if self.lead else -math.inf
        last, first = self._reduce([end, start], dist.ReduceOp.MAX)
        return last - first

    def model_sum(self, values: list[float]) -> list[float]:
        """Each of ``values`` summed over this rank's model-axis peers."""
        return self._reduce(values, dist.ReduceOp.SUM, self.mesh.group("model"))

    def gather(self, run, bad_modules: int) -> int:
        """Folds every rank's ``run`` into rank 0's: each check the largest
        over ranks (a NaN counting as +inf), ``failed`` summed, the peak the
        fullest card's.  Returns the ranks' count of forbidden modules.
        Raises where the ranks made different numbers of calls."""
        _say(f"mesh: rank {self.rank} peak {run.peak_bytes} bytes")
        names = list(run.checks)  # in one order on every rank: the entry's
        own = [run.checks[n] if not math.isnan(run.checks[n]) else math.inf for n in names]
        high = self._reduce([*own, run.peak_bytes, run.attempted, -run.attempted],
                            dist.ReduceOp.MAX)
        failed, bad = self._reduce([run.failed, bad_modules], dist.ReduceOp.SUM)
        if high[-2] != -high[-1]:
            raise RuntimeError(f"the ranks made from {-high[-1]:.0f} to {high[-2]:.0f} calls")
        run.checks = dict(zip(names, high))
        run.peak_bytes, run.failed = int(high[-3]), int(failed)
        if self.lead:
            _say(f"mesh {self.data} x {self.model}: {run.attempted} calls on every rank")
        return int(bad)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)

