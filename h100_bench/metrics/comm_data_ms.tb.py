"""Device ms a train step of the activities launched inside the port's
``pel.comm.data`` spans (``parallel/mesh.py``): the data axis's
collectives, the dense gradients' and the loss's all-reduces and the
sparse update's gathers of ids, mask and cotangents, NCCL's wait for the
peer included; summed over the traced segment and divided by its count of
``pel.train_step``."""

from h100_bench import comm

UNIT = "ms"


def read(run):
    return comm.device_ms_a_step(run, "pel.comm.data")
