"""The dot family's dense half: bottom MLP, the pairwise dot interaction
of the dense vector and the T pooled vectors, top MLP to one logit (dlrm's
``--arch-interaction-op=dot`` without self-interaction), in plain PyTorch
with weights from ``gen``."""

from __future__ import annotations

import torch

from h100_bench import gen, yardstick
from h100_bench.reference import mlp

CONFIG_KEYS = {"mlp_bot": list, "mlp_top": list}


def interact(bot: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """[B, D] and [B, T, D] -> [B, D + npairs]: the dense vector, then the
    dots of each pair of the 1+T features below the diagonal, row by row."""
    z = torch.cat([bot[:, None, :], pooled], dim=1)
    nf = z.shape[1]
    li, lj = torch.tril_indices(nf, nf, -1, device=z.device)
    dots = (z[:, li, :] * z[:, lj, :]).sum(-1)
    return torch.cat([bot, dots], dim=1)


def top_in(cfg: dict) -> int:
    nf = len(cfg["tables"]) + 1
    return cfg["dim"] + nf * (nf - 1) // 2


class DenseHalf:
    """The bottom and top MLPs from the seed, as tensors of their own."""

    def __init__(self, cfg: dict, seed: int, device):
        self.bot = gen.mlp_weights(seed, [cfg["dense_dim"], *cfg["mlp_bot"]], device, 0)
        self.top = gen.mlp_weights(seed, [top_in(cfg), *cfg["mlp_top"]], device, 1)

    def leaves(self) -> dict:
        out = {}
        for side in ("bot", "top"):
            for i, (w, b) in enumerate(getattr(self, side)):
                out[f"{side}.{i}.weight"], out[f"{side}.{i}.bias"] = w, b
        return out

    def logits(self, dense: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        z = interact(mlp(self.bot, dense, last_linear=False), pooled)
        return mlp(self.top, z, last_linear=True)[:, 0]


def flops_per_sample(cfg: dict, lengths) -> int:
    """Model operations of one sample's forward: the MLPs' and the
    interaction's multiply-adds twice, and the pooling's adds over bags of
    ``lengths`` (one a table)."""
    nf = len(cfg["tables"]) + 1
    mac = (yardstick.macs([cfg["dense_dim"], *cfg["mlp_bot"]]) + nf * (nf - 1) // 2 * cfg["dim"]
           + yardstick.macs([top_in(cfg), *cfg["mlp_top"]]))
    return 2 * mac + yardstick.pooling_adds(cfg, lengths)
