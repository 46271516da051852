"""The dcn family's dense half, MLPerf DLRM-DCNv2 (torchrec's ``DLRM_DCN``):
bottom MLP, x0 the dense vector and the T pooled vectors concatenated,
a low-rank cross network over x0, top MLP to one logit, in plain PyTorch
with weights from ``gen``.

Cross layer l (torchrec's ``LowRankCrossNet``) maps x_l to

    x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l

with V_l [rank, width] and W_l [width, rank], width = (1 + T) * dim.  Every
kernel is drawn normal(0, sqrt(2 / (in + out))), which is torchrec's
``xavier_normal_`` for V_l and W_l; b_l is W_l's drawn bias (torchrec
starts it at zero), and V_l's drawn bias is unused."""

from __future__ import annotations

import torch

from h100_bench import gen, yardstick
from h100_bench.reference import mlp

CONFIG_KEYS = {"mlp_bot": list, "mlp_top": list, "dcn_num_layers": int,
               "dcn_low_rank_dim": int}
# gen.mlp_weights' ``which`` of layer l's V_l is CROSS_WHICH + 2 l, of its
# W_l the next; 0 and 1 are the bottom and top MLPs
CROSS_WHICH = 2


def width(cfg: dict) -> int:
    """The width of x0: the dense vector and the T pooled vectors."""
    return (len(cfg["tables"]) + 1) * cfg["dim"]


class DenseHalf:
    """The MLPs and the cross layers from the seed, as tensors of their own."""

    def __init__(self, cfg: dict, seed: int, device):
        w, r = width(cfg), cfg["dcn_low_rank_dim"]
        self.bot = gen.mlp_weights(seed, [cfg["dense_dim"], *cfg["mlp_bot"]], device, 0)
        self.top = gen.mlp_weights(seed, [w, *cfg["mlp_top"]], device, 1)
        self.cross = []  # (V_l, W_l, b_l)
        for layer in range(cfg["dcn_num_layers"]):
            (v, _), = gen.mlp_weights(seed, [w, r], device, CROSS_WHICH + 2 * layer)
            (wk, b), = gen.mlp_weights(seed, [r, w], device, CROSS_WHICH + 2 * layer + 1)
            self.cross.append((v, wk, b))

    def leaves(self) -> dict:
        out = {}
        for side in ("bot", "top"):
            for i, (w, b) in enumerate(getattr(self, side)):
                out[f"{side}.{i}.weight"], out[f"{side}.{i}.bias"] = w, b
        for i, (v, w, b) in enumerate(self.cross):
            out[f"cross.{i}.V.weight"] = v
            out[f"cross.{i}.W.weight"], out[f"cross.{i}.W.bias"] = w, b
        return out

    def cross_net(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for v, w, b in self.cross:
            x = x0 * ((x @ v.t()) @ w.t() + b) + x
        return x

    def logits(self, dense: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
        bot = mlp(self.bot, dense, last_linear=False)
        x0 = torch.cat([bot[:, None, :], pooled], dim=1).flatten(1)
        return mlp(self.top, self.cross_net(x0), last_linear=True)[:, 0]


def cross_flops_per_sample(cfg: dict) -> int:
    """Operations of one sample through the cross network: twice the
    multiply-adds of every V_l and W_l (the bias, product and residual
    adds, 3 x width a layer, left out)."""
    return 2 * cfg["dcn_num_layers"] * 2 * width(cfg) * cfg["dcn_low_rank_dim"]


def flops_per_sample(cfg: dict, lengths) -> int:
    """Model operations of one sample's forward: the MLPs' multiply-adds
    twice, the cross network's, and the pooling's adds over bags of
    ``lengths`` (one a table)."""
    mac = (yardstick.macs([cfg["dense_dim"], *cfg["mlp_bot"]])
           + yardstick.macs([width(cfg), *cfg["mlp_top"]]))
    return 2 * mac + cross_flops_per_sample(cfg) + yardstick.pooling_adds(cfg, lengths)
