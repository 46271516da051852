"""Device ms a train step of the activities launched inside the port's
``pel.comm.model`` spans (``parallel/mesh.py``): the model axis's
collectives, the big set's psum of its pooled rows, NCCL's wait for the
peer included; summed over the traced segment and divided by its count of
``pel.train_step``."""

from h100_bench import comm

UNIT = "ms"


def read(run):
    return comm.device_ms_a_step(run, "pel.comm.model")
