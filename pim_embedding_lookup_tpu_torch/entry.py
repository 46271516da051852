"""Entry point: the flagship DLRM forward and an example batch."""

from __future__ import annotations

import numpy as np
import torch

from .config import KAGGLE_TABLE_ROWS, DLRMConfig, ShardingPolicy, TableConfig
from .device import resolve_device
from .models.dlrm import DLRM


def entry(device=None):
    """The 26-table Criteo-Kaggle DLRM (rows capped at 100k) on the hybrid
    collection, with a batch of B=128 single-hot bags.

    Returns ``(model, (dense, indices, mask))``; ``model(*args)`` gives [B]
    logits.  Runs on CUDA unless ``device`` names another device."""
    device = resolve_device(device)
    dim = 16
    tables = tuple(
        TableConfig(num_rows=min(n, 100_000), dim=dim, name=f"cat_{i}")
        for i, n in enumerate(KAGGLE_TABLE_ROWS)
    )
    config = DLRMConfig(
        dense_dim=13,
        mlp_bot=(512, 256, 64, dim),
        mlp_top=(512, 256, 1),
        tables=tables,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    model = DLRM(config, ShardingPolicy.REPLICATE, hybrid=True, device=device,
                 generator=gen)

    b, l = 128, 1
    rng = np.random.default_rng(0)
    dense = torch.from_numpy(rng.random((b, 13), dtype=np.float32))
    idx = torch.from_numpy(
        np.stack([rng.integers(0, t.num_rows, size=b * l) for t in tables])
        .astype(np.int32)
    )
    mask = torch.ones(len(tables), b * l, dtype=torch.bool)
    return model, (dense.to(device), idx.to(device), mask.to(device))
