"""Load the JAX package's DLRM parameters, its sparse train step's
accumulator, and its int8 collection's params, into the port.

A JAX array is global: on a mesh each process takes its own shard of it
(``storage_shard``, ``accumulator_shard``), so that a JAX state and the
port on any mesh compute the same thing."""

from __future__ import annotations

import numpy as np
import torch

from .models.dlrm import DLRM
from .models.sparse_train import _init_acc
from .parallel.collection import EmbeddingCollection
from .parallel.quantized_collection import QuantizedEmbeddingCollection


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.from_numpy(np.array(src, dtype=np.float32))  # a writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(src.shape)} != {tuple(dst.shape)}")
    dst.copy_(src)


def storage_shard(coll: EmbeddingCollection, storage) -> np.ndarray:
    """This process's shard of a JAX global fused storage array (numpy,
    [storage_rows, storage_width])."""
    return coll.shard_host_array(np.asarray(storage, dtype=np.float32))


def accumulator_shard(coll: EmbeddingCollection, acc) -> np.ndarray:
    """This process's shard of a JAX global [total_rows] row-AdaGrad
    accumulator (numpy)."""
    return coll.shard_host_accumulator(np.asarray(acc, dtype=np.float32))


def _subsets(model: DLRM):
    """(key, collection, storage buffer) of each embedding set."""
    if model.hybrid:
        return [(key, getattr(model.collection, key), getattr(model, f"emb_{key}"))
                for key in ("small", "big")]
    return [(None, model.collection, model.emb)]


@torch.no_grad()
def params_from_jax(params_np: dict, model: DLRM) -> DLRM:
    """Copy a JAX DLRM parameter tree, as numpy arrays, into ``model``.

    The tree is ``{"emb": fused | {"small": [R_s, D], "big": [S, W]},
    "bot"/"top": [{"w": [in, out], "b": [out]}, ...]}``.  Fused storage
    keeps its layout (the layouts match), cut to this process's shard on a
    mesh; each ``w`` is transposed into ``nn.Linear``'s [out, in].  Returns
    ``model``."""
    emb = params_np["emb"]
    for key, coll, dst in _subsets(model):
        src = emb if key is None else emb[key]
        if (src is None) != (dst is None):
            raise ValueError(f"emb[{key!r}] present on one side only")
        if dst is not None:
            _copy(dst, storage_shard(coll, src))
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
    accumulator on the model's device (this process's shard on a mesh).
    With ``params_from_jax`` it lets a state trained by JAX steps go on
    training in the port."""
    acc = _init_acc(model.collection)
    for key, coll, _ in _subsets(model):
        src, dst = (acc_np, acc) if key is None else (acc_np[key], acc[key])
        if (src is None) != (dst is None):
            raise ValueError(f"acc[{key!r}] present on one side only")
        if dst is not None:
            _copy(dst, accumulator_shard(coll, src))
    return acc


def quantized_params_from_jax(coll: QuantizedEmbeddingCollection, params_np: dict) -> dict:
    """A JAX int8 params tree as numpy arrays (``{"q", "tscale"}`` or
    ``{"q", "scale"}``, global and in storage order) -> this process's
    params on ``coll``'s device: ``q`` cut like the storage, ``scale`` (1-D
    per fused row, strided under ROW_HASH) like the row-AdaGrad
    accumulator, ``tscale`` whole."""
    return coll.shard_params({k: np.asarray(v) for k, v in params_np.items()})
