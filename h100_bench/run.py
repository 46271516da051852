"""The benchmark of ``pim_embedding_lookup_tpu_torch`` on NVIDIA H100s.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json``: builds the port's model of the cell's
configuration (``systems/<interaction>.py``) with weights made from the
seed, warms up every shape the cell's traffic uses, drives the cell's entry (``score`` or ``train``) for
``--seconds``, then checks what the timed path produced
against the plain reference.  With ``--trace 0`` the result holds the
cell's end-to-end metrics; with ``--trace 1`` a traced segment follows the
window, and the result holds the per-layer metrics.  The last line of
standard output is the result; the last lines of standard error, and the
result's last key, hold each number the check compared beside its limit.

A cell whose configuration's ``mesh`` holds d x m > 1 cards runs as d x m
processes, one a card (``ranks.py``): this process launches them, each is
``run.py`` again with ``--rank``, and rank 0 prints the result.  Set-up runs
from this process's start to rank 0's first timed call.  A 1 x 1 cell runs
here, in this process alone.

Not for the benchmark's own runs: ``--control tf32`` puts the reference,
computed with TF32 on, in the program's place; ``--fault`` plants a fault
in the timed path (``faults.py``); ``--device cpu`` runs without a card,
for the tests (a mesh over gloo).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on the ``time.time`` clock."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


START = _process_start()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "pim_embedding_lookup_tpu"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="h100_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    ap.add_argument("--fault", choices=("answer", "half", "state"), default=None)
    ap.add_argument("--device", default="cuda")
    # a rank of a cell over a mesh, and the launcher's start (ranks.py)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--started", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


class _Absent:
    """The program's place when the control stands in it."""

    def free(self):
        pass


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    args = parse_args(argv)
    from h100_bench.manifest import Manifest, mesh_size

    man = Manifest(ROOT)
    cell = man.cell(args.workload)
    cfg, traffic, limits = man.config(cell), man.traffic(cell), man.limits(cell)
    if args.seed < 0:
        raise SystemExit("--seed must be a non-negative integer")
    if mesh_size(cfg) > 1 and args.rank is None:
        from h100_bench.ranks import launch

        return launch(sys.argv[1:] if argv is None else list(argv), mesh_size(cfg), START)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); found {found}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", args.rank or 0)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    from h100_bench import entries

    ranks, on_mesh = None, {}
    if args.rank is not None:
        from h100_bench.ranks import Ranks

        ranks = Ranks(args.rank, cfg, device)
        on_mesh = {"mesh": ranks.mesh}
    system = (_Absent() if args.control
              else man.system(cfg).PortSystem(cfg, args.seed, device, **on_mesh))
    kw = dict(trace=bool(args.trace), control=args.control is not None, fault=args.fault)
    if ranks is not None:
        kw["ranks"] = ranks
    steps = entries.ENTRIES[traffic["entry"]](system, man.dense(cfg), cfg, traffic, args.seed,
                                             args.seconds, device, **kw)
    next(steps)
    setup_s = time.time() - (START if ranks is None else args.started)
    next(steps)
    run = next(steps)
    elsewhere = 0  # forbidden modules the other ranks loaded
    if ranks is not None:
        own = forbidden_modules()
        elsewhere = ranks.gather(run, len(own)) - len(own)
        if not ranks.lead:
            if own:
                print(f"rank {args.rank} loaded modules the benchmark must not load: "
                      f"{', '.join(own)}", file=sys.stderr)
                return 3
            return 0
    run.context["platform"] = "gpu" if device.type == "cuda" else device.type

    metrics = {}
    if args.trace:
        for m in man.per_layer(cell):
            value = man.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # an end-to-end metric reads the quantity its name begins with, up
        # to a first '.': score_samples_per_s.longbag is a score rate
        values = dict(run.e2e, setup_s=setup_s, peak_mem_gb=run.peak_bytes / 1e9)
        for m in man.end_to_end(cell):
            quantity = m["name"].split(".", 1)[0]
            if quantity in values:
                metrics[m["name"]] = {"value": values[quantity], "unit": m["unit"]}
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in run.checks.items()}
    correct = run.failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": run.context["platform"],
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": run.peak_bytes,
           "power_limit_w": _power_limit() if device.type == "cuda" else None}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if args.trace and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s(), run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    for key in ("timeline", "worst_leaf", "leaves_left_out"):
        if run.context.get(key):
            result[key] = run.context[key]
    result["checks"] = checks

    bad = forbidden_modules()
    if bad or elsewhere:
        print(f"loaded modules the benchmark must not load: {', '.join(bad)}"
              f"{f' (and {elsewhere} on other ranks)' if elsewhere else ''}", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _power_limit():
    """The card's power limit in W, as ``nvidia-smi`` reads it."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


if __name__ == "__main__":
    sys.exit(main())
