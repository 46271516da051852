"""The dot family on the port: ``pim_embedding_lookup_tpu_torch``'s DLRM
(``models/dlrm.py``, ``interact_dot``) over its hybrid collection, built
from a configuration file, with the benchmark's weights written over its
own.  Scores through ``DLRM.forward`` on the dense wire, and through the
collection's ``lookup_csr`` and ``DLRM.apply_from_pooled`` on the CSR wire;
trains through ``make_sparse_train_step`` on the batch's wire.  Given a
``mesh`` (the port's ``PortMesh``), the model is built on it: this process
holds its shard of the big set and is fed its data row's part of a batch."""

from __future__ import annotations

import torch

import pim_embedding_lookup_tpu_torch as port
from h100_bench import gen
from h100_bench.systems._collection import CollectionSystem, table_configs
from pim_embedding_lookup_tpu_torch.models.sparse_train import (
    make_sparse_train_state,
    make_sparse_train_step,
)


class PortSystem(CollectionSystem):
    def __init__(self, cfg: dict, seed: int, device: torch.device, mesh=None):
        super().__init__(cfg)
        dlrm_cfg = port.DLRMConfig(dense_dim=cfg["dense_dim"], mlp_bot=tuple(cfg["mlp_bot"]),
                                   mlp_top=tuple(cfg["mlp_top"]),
                                   tables=tuple(table_configs(cfg)))
        # the port draws its own init here; every tensor of it is then
        # overwritten with the benchmark's weights
        self.model = port.DLRM(dlrm_cfg, port.ShardingPolicy(cfg["sharding"]), hybrid=True,
                               device=device, mesh=mesh,
                               generator=torch.Generator(device=device).manual_seed(0))
        self.coll = self.model.collection
        self.fill(seed)
        with torch.no_grad():
            for side, which, sizes in ((self.model.bot, 0, [cfg["dense_dim"], *cfg["mlp_bot"]]),
                                       (self.model.top, 1, None)):
                sizes = sizes or [side[0].in_features, *cfg["mlp_top"]]
                for lin, (w, b) in zip(side, gen.mlp_weights(seed, sizes, device, which)):
                    lin.weight.copy_(w)
                    lin.bias.copy_(b)
        self._train = None

    def storage(self) -> dict:
        return self.model.emb_params()

    # -- the timed calls ------------------------------------------------------

    @torch.no_grad()
    def predict(self, b: dict) -> torch.Tensor:
        """Click probabilities [B]: ``DLRM.forward`` then the sigmoid, or on
        the CSR wire ``lookup_csr`` and ``apply_from_pooled``."""
        if "offsets" in b:
            return torch.sigmoid(self.model.apply_from_pooled(b["dense"], self.lookup(b)))
        return torch.sigmoid(self.model(b["dense"], b["ids"], b["mask"]))

    def make_train(self, traffic: dict) -> None:
        opt = traffic["optimizer"]
        dense_opt, self.acc = make_sparse_train_state(self.model, optimizer=opt,
                                                      lr=traffic["lr"])
        self._train = make_sparse_train_step(self.model, dense_opt, lr=traffic["lr"],
                                             optimizer=opt, eps=traffic["eps"],
                                             wire=traffic["wire"])

    def train_step(self, b: dict) -> torch.Tensor:
        """One sparse step in place; returns the loss (on the device)."""
        second = b["offsets"] if "offsets" in b else b["mask"]
        self.acc, loss = self._train(self.acc, b["dense"], b["ids"], second, b["labels"])
        return loss

    # -- what the check reads -------------------------------------------------

    def dense_leaves(self) -> dict:
        out = {}
        for side in ("bot", "top"):
            for i, lin in enumerate(getattr(self.model, side)):
                out[f"{side}.{i}.weight"], out[f"{side}.{i}.bias"] = lin.weight, lin.bias
        return out

    def free(self) -> None:
        self.model = self.coll = self._train = self.acc = None
