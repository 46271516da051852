"""The system under test: the port's DLRM, built from a configuration file,
with the benchmark's weights loaded into its collection's fused layout.

This is the one module of the benchmark that imports the program.  Besides
the calls the workloads time, it reads back what the check needs: the
program's rows of a table at given ids and its row-AdaGrad accumulator,
through the same layout.
"""

from __future__ import annotations

import torch

import pim_embedding_lookup_tpu_torch as port
from pim_embedding_lookup_tpu_torch.models.sparse_train import (
    make_sparse_train_state,
    make_sparse_train_step,
)

from . import gen, tracing


class _SpannedLookup:
    """The collection, with each ``lookup`` inside a ``lookup`` span."""

    def __init__(self, inner):
        self._inner = inner

    def lookup(self, *args, **kwargs):
        with tracing.span("lookup"):
            return self._inner.lookup(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class PortSystem:
    def __init__(self, cfg: dict, seed: int, device: torch.device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.seed, self.device = cfg, seed, device
        tables = [port.TableConfig(num_rows=n, dim=cfg["dim"], name=f"t{i}", dtype=cfg["dtype"])
                  for i, n in enumerate(cfg["tables"])]
        dlrm_cfg = port.DLRMConfig(dense_dim=cfg["dense_dim"], mlp_bot=tuple(cfg["mlp_bot"]),
                                   mlp_top=tuple(cfg["mlp_top"]), tables=tuple(tables))
        # the port draws its own init here; every tensor of it is then
        # overwritten with the benchmark's weights
        self.model = port.DLRM(dlrm_cfg, port.ShardingPolicy(cfg["sharding"]), hybrid=True,
                               device=device,
                               generator=torch.Generator(device=device).manual_seed(0))
        coll = self.coll = self.model.collection
        small = tuple(i for i, n in enumerate(cfg["tables"]) if n <= cfg["small_set_max_rows"])
        if tuple(sorted(coll.small_ids)) != small:
            raise ValueError(f"the program's small set {coll.small_ids} is not the "
                             f"configuration's {small}")
        with torch.no_grad():
            for part, name in ((coll.small, "emb_small"), (coll.big, "emb_big")):
                if part is None:
                    continue
                lay = part.layout
                ids = coll.small_ids if name == "emb_small" else coll.big_ids
                if tuple(lay.table_rows) != tuple(cfg["tables"][t] for t in ids):
                    raise ValueError(f"the program's {name} tables hold {lay.table_rows} rows")
                gen.fill_fused(getattr(self.model, name), seed=seed, cfg=cfg,
                               table_ids=ids, row_offsets=lay.row_offsets,
                               total_rows=lay.total_rows,
                               shard=part.shard, num_shards=lay.num_shards,
                               strided=lay.policy == port.ShardingPolicy.ROW_HASH)
            for side, which, sizes in ((self.model.bot, 0, [cfg["dense_dim"], *cfg["mlp_bot"]]),
                                       (self.model.top, 1, None)):
                sizes = sizes or [side[0].in_features, *cfg["mlp_top"]]
                for lin, (w, b) in zip(side, gen.mlp_weights(seed, sizes, device, which)):
                    lin.weight.copy_(w)
                    lin.bias.copy_(b)
        self._train = None

    # -- the timed calls ------------------------------------------------------

    def spanned(self) -> None:
        """Put the harness's spans around the model's two halves."""
        model = self.model
        model.collection = _SpannedLookup(self.coll)
        inner = model.apply_from_pooled

        def apply_from_pooled(dense, pooled):
            with tracing.span("dense_half"):
                return inner(dense, pooled)

        model.apply_from_pooled = apply_from_pooled

    @torch.no_grad()
    def predict(self, b: dict) -> torch.Tensor:
        """``DLRM.forward``, then the sigmoid: click probabilities [B]."""
        return torch.sigmoid(self.model(b["dense"], b["ids"], b["mask"]))

    def make_train(self, traffic: dict) -> None:
        opt = traffic["optimizer"]
        dense_opt, self.acc = make_sparse_train_state(self.model, optimizer=opt,
                                                      lr=traffic["lr"])
        self._train = make_sparse_train_step(self.model, dense_opt, lr=traffic["lr"],
                                             optimizer=opt, eps=traffic["eps"])

    def train_step(self, b: dict) -> torch.Tensor:
        """One sparse step in place; returns the loss (on the device)."""
        self.acc, loss = self._train(self.acc, b["dense"], b["ids"], b["mask"], b["labels"])
        return loss

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a train step updates in place."""
        m = self.model
        out = [t for t in (m.emb_small, m.emb_big) if t is not None]
        out += [p.data for p in self.dense_leaves().values()]
        return out + [a for a in self.acc.values() if a is not None]

    # -- what the check reads -------------------------------------------------

    def dense_leaves(self) -> dict:
        out = {}
        for side in ("bot", "top"):
            for i, lin in enumerate(getattr(self.model, side)):
                out[f"{side}.{i}.weight"], out[f"{side}.{i}.bias"] = lin.weight, lin.bias
        return out

    def _where(self, table: int):
        coll = self.coll
        if table in coll.small_ids:
            return "small", coll.small, coll.small_ids.index(table)
        return "big", coll.big, coll.big_ids.index(table)

    def rows(self, table: int, ids: torch.Tensor) -> torch.Tensor:
        """The program's current rows of ``table`` at ``ids``, f32 [N, D]."""
        name, part, k = self._where(table)
        storage = getattr(self.model, f"emb_{name}").view(-1, self.cfg["dim"])
        return storage[part.layout.row_offsets[k] + ids.long()].float()

    def accumulator(self, table: int, ids: torch.Tensor) -> torch.Tensor:
        name, part, k = self._where(table)
        return self.acc[name][part.layout.row_offsets[k] + ids.long()]

    def free(self) -> None:
        self.model = self.coll = self._train = self.acc = None
