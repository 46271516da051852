"""Load the JAX package's DLRM parameters into the port's module."""

from __future__ import annotations

import numpy as np
import torch

from .models.dlrm import DLRM


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
