"""Failure detection: NaN/Inf guards and a checkpoint-restart loop.

The counterpart of ``pim_embedding_lookup_tpu.utils.guards``.  A state is
a tensor, numpy array or number, or a dict, list or tuple of them
(nested); a leaf's path is written as ``jax.tree_util.keystr`` writes it,
``['key'][0]``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch
from torch.utils._pytree import tree_map


class NonFiniteError(RuntimeError):
    def __init__(self, where: str):
        super().__init__(f"non-finite value detected in {where}")
        self.where = where


def _leaves_with_path(value: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(value, dict):  # in sorted key order, as JAX flattens a dict
        for k in sorted(value):
            yield from _leaves_with_path(value[k], f"{path}[{k!r}]")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from _leaves_with_path(v, f"{path}[{i}]")
    elif value is not None:
        yield path, value


def _finite(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.isfinite(arr).all())


def check_finite(value: Any, where: str = "value") -> None:
    """Raise NonFiniteError naming the first leaf that holds NaN or Inf
    (a host-side check: it waits for the device)."""
    for path, leaf in _leaves_with_path(value):
        if not _finite(leaf):
            raise NonFiniteError(f"{where}{path}")


def finite_or_skip_update(new: Any, old: Any, loss: torch.Tensor) -> Any:
    """``new`` where ``loss`` is finite, else ``old``, leaf by leaf, without
    waiting for the device: a step that produced a non-finite loss is
    skipped."""
    ok = torch.isfinite(torch.as_tensor(loss))
    return tree_map(lambda n, o: torch.where(ok.to(n.device), n, o), new, old)


def train_with_restart(
    run_steps: Callable[[Any, int], tuple[Any, float]],
    save: Callable[[Any, int], None],
    restore: Callable[[int], Any],
    state: Any,
    *,
    total_steps: int,
    checkpoint_every: int,
    max_restarts: int = 3,
) -> Any:
    """Checkpoint/restart loop: run ``run_steps(state, n)`` in
    ``checkpoint_every`` chunks, saving after each; on NonFiniteError roll
    back to the last save, at most ``max_restarts`` times.

    ``run_steps`` returns (state, last_loss) and may itself raise
    NonFiniteError (e.g. through check_finite on the loss)."""
    done = 0
    restarts = 0
    save(state, 0)
    last_ckpt = 0
    while done < total_steps:
        n = min(checkpoint_every, total_steps - done)
        try:
            state, loss = run_steps(state, n)
            check_finite(loss, "loss")
            done += n
            save(state, done)
            last_ckpt = done
        except NonFiniteError:
            restarts += 1
            if restarts > max_restarts:
                raise
            state = restore(last_ckpt)
            done = last_ckpt
    return state
