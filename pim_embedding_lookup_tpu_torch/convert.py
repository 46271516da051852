"""Load the JAX package's DLRM parameters, and its sparse train step's
accumulator, into the port."""

from __future__ import annotations

import numpy as np
import torch

from .models.dlrm import DLRM
from .models.sparse_train import _init_acc


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.from_numpy(np.array(src, dtype=np.float32))  # a writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src)


@torch.no_grad()
def params_from_jax(params_np: dict, model: DLRM) -> DLRM:
    """Copy a JAX DLRM parameter tree, as numpy arrays, into ``model``.

    The tree is ``{"emb": fused | {"small": [R_s, D], "big": [S, W]},
    "bot"/"top": [{"w": [in, out], "b": [out]}, ...]}``.  Fused storage
    keeps its shape (the layouts match); each ``w`` is transposed into
    ``nn.Linear``'s [out, in].  Returns ``model``."""
    emb = params_np["emb"]
    if model.hybrid:
        for key in ("small", "big"):
            dst = getattr(model, f"emb_{key}")
            if (emb[key] is None) != (dst is None):
                raise ValueError(f"emb[{key!r}] present on one side only")
            if dst is not None:
                _copy(dst, emb[key])
    else:
        _copy(model.emb, emb)
    for name in ("bot", "top"):
        layers = getattr(model, name)
        if len(layers) != len(params_np[name]):
            raise ValueError(f"{name}: {len(params_np[name])} layers for {len(layers)}")
        for lin, p in zip(layers, params_np[name]):
            _copy(lin.weight, np.asarray(p["w"]).T)
            _copy(lin.bias, p["b"])
    return model


@torch.no_grad()
def train_state_from_jax(acc_np, model: DLRM):
    """The JAX sparse step's row-AdaGrad accumulator (``{"small", "big"}``
    for a hybrid model, else one [total_rows] array; numpy) as the port's
    accumulator on the model's device.  With ``params_from_jax`` it lets a
    state trained by JAX steps go on training in the port."""
    acc = _init_acc(model.collection)
    if isinstance(acc, dict):
        for key, dst in acc.items():
            if (acc_np[key] is None) != (dst is None):
                raise ValueError(f"acc[{key!r}] present on one side only")
            if dst is not None:
                _copy(dst, acc_np[key])
    else:
        _copy(acc, acc_np)
    return acc
