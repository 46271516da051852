"""A toy family for the harness's tests (``dense/toycat.py`` in a toy
checkout): the bottom MLP's output and each pooled vector times
``concat_scale``, concatenated, then the top MLP to one logit."""

from __future__ import annotations

import torch

from h100_bench import gen, yardstick
from h100_bench.reference import mlp

CONFIG_KEYS = {"mlp_bot": list, "mlp_top": list, "concat_scale": (int, float)}


def top_in(cfg: dict) -> int:
    return cfg["dim"] * (len(cfg["tables"]) + 1)


class DenseHalf:
    def __init__(self, cfg: dict, seed: int, device):
        self.scale = float(cfg["concat_scale"])
        self.bot = gen.mlp_weights(seed, [cfg["dense_dim"], *cfg["mlp_bot"]], device, 0)
        self.top = gen.mlp_weights(seed, [top_in(cfg), *cfg["mlp_top"]], device, 1)

    def leaves(self) -> dict:
        out = {}
        for side in ("bot", "top"):
            for i, (w, b) in enumerate(getattr(self, side)):
                out[f"{side}.{i}.weight"], out[f"{side}.{i}.bias"] = w, b
        return out

    def logits(self, dense: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        z = torch.cat([mlp(self.bot, dense, last_linear=False),
                       self.scale * pooled.flatten(1)], dim=1)
        return mlp(self.top, z, last_linear=True)[:, 0]


def flops_per_sample(cfg: dict, lengths) -> int:
    mac = (yardstick.macs([cfg["dense_dim"], *cfg["mlp_bot"]])
           + yardstick.macs([top_in(cfg), *cfg["mlp_top"]]))
    return 2 * mac + len(cfg["tables"]) * cfg["dim"] + yardstick.pooling_adds(cfg, lengths)
