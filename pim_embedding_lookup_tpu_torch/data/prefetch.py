"""Host-to-device input prefetch.

The counterpart of ``pim_embedding_lookup_tpu.data.prefetch``: a
background thread stages upcoming batches on the device while the current
step computes, and the consumer iterates batches already resident there.
A batch is a numpy array or tensor, or a tuple, list or dict of them
(nested); it comes out with the same structure, every leaf a tensor on the
device.

On a CUDA device the thread copies each leaf into pinned host memory, then
to the device with a ``non_blocking`` copy on a side stream, and records an
event after the batch's copies.  The consumer's stream waits on that event
before the batch is handed out, and each yielded tensor is marked as used
by the consumer's stream (``record_stream``), so that the caching
allocator does not give its memory to a later copy while the step still
reads it.  On the CPU each leaf becomes a tensor copy of its host array.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..device import resolve_device

_SENTINEL = object()


def _host_tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) \
        else torch.as_tensor(x)


def device_prefetch(
    batches: Iterable[Any],
    *,
    buffer_size: int = 2,
    device=None,
) -> Iterator[Any]:
    """Wrap a host batch iterator; yields batches on ``device`` (CUDA
    unless named), at most ``buffer_size`` of them staged ahead.  An
    exception the iterator raises is raised in the consumer, after the
    batches before it."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(device=dev) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    err: list[BaseException] = []

    def stage(batch):
        if not cuda:  # a copy, as a device's would be
            return tree_map(lambda x: _host_tensor(x).clone(), batch), None
        with torch.cuda.stream(copy_stream):
            out = tree_map(lambda x: _host_tensor(x).pin_memory().to(dev, non_blocking=True),
                           batch)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return out, ready

    def worker():
        try:
            if cuda:
                torch.cuda.set_device(dev)
            for b in batches:
                q.put(stage(b))
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            t.join()
            if err:
                raise err[0]
            return
        batch, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            for x in tree_leaves(batch):
                x.record_stream(consumer)
        yield batch
