"""The toy family on the port (``systems/toycat.py`` in a toy checkout):
the port's hybrid collection under a dense half of this file's own, trained
by the port's sparse update on the batch's wire."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

import pim_embedding_lookup_tpu_torch as port
from h100_bench import gen
from h100_bench.systems._collection import CollectionSystem, table_configs
from pim_embedding_lookup_tpu_torch.parallel.hybrid import (
    init_accumulator_hybrid,
    sparse_update_hybrid,
    sparse_update_hybrid_csr,
)


def _linears(seed, sizes, device, which) -> nn.ModuleList:
    out = nn.ModuleList()
    for w, b in gen.mlp_weights(seed, sizes, device, which):
        lin = nn.Linear(w.shape[1], w.shape[0], device=device)
        with torch.no_grad():
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        out.append(lin)
    return out


def _mlp(layers, x, *, last_linear):
    for i, lin in enumerate(layers):
        x = lin(x)
        if not (last_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


class PortSystem(CollectionSystem):
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        super().__init__(cfg)
        self.coll = port.HybridEmbeddingCollection.create(
            table_configs(cfg), port.ShardingPolicy(cfg["sharding"]), device=device)
        self.emb = self.coll.init(torch.Generator(device=device).manual_seed(0))
        self.fill(seed)
        self.scale = float(cfg["concat_scale"])
        self.bot = _linears(seed, [cfg["dense_dim"], *cfg["mlp_bot"]], device, 0)
        top_in = cfg["dim"] * (len(cfg["tables"]) + 1)
        self.top = _linears(seed, [top_in, *cfg["mlp_top"]], device, 1)

    def storage(self) -> dict:
        return self.emb

    def _logits(self, dense, pooled):
        z = torch.cat([_mlp(self.bot, dense, last_linear=False),
                       self.scale * pooled.flatten(1)], dim=1)
        return _mlp(self.top, z, last_linear=True)[:, 0]

    @torch.no_grad()
    def predict(self, b: dict) -> torch.Tensor:
        return torch.sigmoid(self._logits(b["dense"], self.lookup(b)))

    def make_train(self, traffic: dict) -> None:
        self.traffic = traffic
        self.opt = torch.optim.SGD([*self.bot.parameters(), *self.top.parameters()],
                                   lr=traffic["lr"])
        self.acc = init_accumulator_hybrid(self.coll)

    def train_step(self, b: dict) -> torch.Tensor:
        t = self.traffic
        with torch.no_grad():
            pooled = self.lookup(b)
        pooled.requires_grad_(True)
        self.opt.zero_grad(set_to_none=True)
        loss = F.binary_cross_entropy_with_logits(self._logits(b["dense"], pooled), b["labels"])
        loss.backward()
        self.opt.step()
        kw = dict(lr=t["lr"], optimizer=t["optimizer"], eps=t["eps"])
        with torch.no_grad():
            if "offsets" in b:
                _, self.acc = sparse_update_hybrid_csr(self.coll, self.emb, self.acc, b["ids"],
                                                       b["offsets"], pooled.grad, **kw)
            else:
                _, self.acc = sparse_update_hybrid(self.coll, self.emb, self.acc, b["ids"],
                                                   b["mask"], pooled.grad, **kw)
        return loss.detach()

    def dense_leaves(self) -> dict:
        out = {}
        for side in ("bot", "top"):
            for i, lin in enumerate(getattr(self, side)):
                out[f"{side}.{i}.weight"], out[f"{side}.{i}.bias"] = lin.weight, lin.bias
        return out

    def free(self) -> None:
        self.coll = self.emb = self.acc = self.bot = self.top = self.opt = None
