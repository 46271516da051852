"""Build times: the seconds ``nvcc`` takes for each kernel source, with the
flags the port builds with (``ops/_build.py``'s ``NVCC_FLAGS``).

Every ``*.cu`` of each ``--csrc`` directory (default: the port's own
``csrc/``) is compiled alone, one at a time, into a temporary directory
that is removed afterwards; the directories take turns (in order, then in
reverse), so that two trees, e.g. a parent commit's ``csrc/`` and this
one's, are compared on the same machine.  One JSON line a directory and
source on stdout: its seconds in each turn and the kernel instances ptxas
compiled.  Needs ``nvcc`` (as the kernels' build does), not a card:

    python -m pim_embedding_lookup_tpu_torch.tools.build_times \\
        [--csrc DIR ...]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

from ..ops import _build


def instances(log: str) -> int:
    """Kernel instances in ``nvcc -Xptxas=-v``'s output: one "Compiling
    entry function" line each."""
    return log.count("Compiling entry function")


def compile_source(nvcc: str, source: Path, out: Path) -> tuple[float, int]:
    """(seconds, kernel instances) of one ``nvcc`` run on ``source``;
    raises if it fails."""
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-o", str(out), str(source)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    return seconds, instances(proc.stdout + proc.stderr)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", action="append", type=Path,
                    help="a directory of kernel sources (repeat to compare trees); "
                         "default: the port's csrc/")
    args = ap.parse_args(argv)
    dirs = args.csrc or [_build.CSRC]
    nvcc = _build._nvcc()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for turn, directory in enumerate([*dirs, *reversed(dirs)]):
            for source in sorted(directory.glob("*.cu")):
                seconds, count = compile_source(nvcc, source,
                                                Path(tmp) / f"{turn}-{source.stem}.so")
                row = results.setdefault((str(directory), source.name), dict(
                    csrc=str(directory), source=source.name, instances=count, seconds=[]))
                row["seconds"].append(seconds)
    for row in results.values():
        print(json.dumps(row), flush=True)
    return results


if __name__ == "__main__":
    main()
