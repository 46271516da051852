"""The cross network's share of the card's f32 peak in the traced batches:
its operations a call (``dense/dcn.py`` ``cross_flops_per_sample``, twice
the multiply-adds of every V_l and W_l, times the cell's batch) over the
device seconds a call of the port's ``pel.cross`` span, over 67 TFLOP/s
(f32 outside the tensor cores: TF32 is off).  The configuration and the
batch are the DCNv2 cell's, read through ``Manifest``."""

from pathlib import Path

from h100_bench import readers
from h100_bench.manifest import Manifest
from h100_bench.yardstick import PEAKS

UNIT = "%"
CELL = "dcnv2-score-b65536"


def read(run):
    ms = readers.span_device_ms(run, "pel.cross")
    if ms is None:
        return None
    man = Manifest(Path(__file__).resolve().parents[2])
    cell = man.cell(CELL)
    cfg = man.config(cell)
    flops = man.dense(cfg).cross_flops_per_sample(cfg) * man.traffic(cell)["batch_size"]
    return flops / (ms * 1e-3) / PEAKS["f32_flops"] * 100.0
