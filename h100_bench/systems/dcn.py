"""The dcn family on the port: ``pim_embedding_lookup_tpu_torch``'s DLRM
with its low-rank cross interaction (``DLRMConfig(interaction="dcn")``,
``models/dlrm.py`` ``LowRankCrossNet``) over its hybrid collection, built
from a configuration file, with the benchmark's rows and weights written
over its own.  Scores and trains as the dot family's system does: through
``DLRM.forward`` on the dense wire (``lookup_csr`` and
``apply_from_pooled`` on the CSR wire) and ``make_sparse_train_step``."""

from __future__ import annotations

import torch

import pim_embedding_lookup_tpu_torch as port
from h100_bench.dense.dcn import DenseHalf
from h100_bench.systems._collection import CollectionSystem, table_configs
from h100_bench.systems.dot import PortSystem as DotSystem


class PortSystem(DotSystem):
    def __init__(self, cfg: dict, seed: int, device: torch.device, mesh=None):
        CollectionSystem.__init__(self, cfg)
        dlrm_cfg = port.DLRMConfig(dense_dim=cfg["dense_dim"], mlp_bot=tuple(cfg["mlp_bot"]),
                                   mlp_top=tuple(cfg["mlp_top"]),
                                   tables=tuple(table_configs(cfg)), interaction="dcn",
                                   dcn_num_layers=cfg["dcn_num_layers"],
                                   dcn_low_rank_dim=cfg["dcn_low_rank_dim"])
        # the port draws its own init here; every tensor of it is then
        # overwritten with the benchmark's rows and weights
        self.model = port.DLRM(dlrm_cfg, port.ShardingPolicy(cfg["sharding"]), hybrid=True,
                               device=device, mesh=mesh,
                               generator=torch.Generator(device=device).manual_seed(0))
        self.coll = self.model.collection
        self.fill(seed)
        mine = self.dense_leaves()
        seeded = DenseHalf(cfg, seed, device).leaves()
        if {n: p.shape for n, p in mine.items()} != {n: w.shape for n, w in seeded.items()}:
            raise ValueError("the program's dense tower is not the reference's: "
                             f"{sorted(mine)} against {sorted(seeded)}")
        with torch.no_grad():
            for name, p in mine.items():
                p.copy_(seeded[name])
        self._train = None

    def dense_leaves(self) -> dict:
        """Every parameter of the dense tower by name: ``bot.{i}.*``,
        ``top.{i}.*``, ``cross.{l}.V.weight``, ``cross.{l}.W.weight`` and
        ``cross.{l}.W.bias``."""
        return dict(self.model.named_parameters())
