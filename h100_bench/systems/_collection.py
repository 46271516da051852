"""What every family's system shares: the port's hybrid embedding
collection, its storage filled with the benchmark's rows, and what the
check reads back through its fused layout (a table's rows at given ids, its
row-AdaGrad accumulator).  A family's ``systems/<interaction>.py`` builds
its model around the collection and subclasses ``CollectionSystem``."""

from __future__ import annotations

import torch

import pim_embedding_lookup_tpu_torch as port
from h100_bench import gen


def table_configs(cfg: dict) -> list:
    return [port.TableConfig(num_rows=n, dim=cfg["dim"], name=f"t{i}", dtype=cfg["dtype"])
            for i, n in enumerate(cfg["tables"])]


class CollectionSystem:
    """A system whose tables are ``self.coll``, a hybrid collection, stored
    in ``self.storage()`` ({"small": ..., "big": ...}).  Subclasses give
    ``storage``, ``dense_leaves``, ``predict``, ``make_train`` and
    ``train_step``, and set ``self.acc`` in ``make_train``."""

    coll = None
    acc = None

    def __init__(self, cfg: dict):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg

    def fill(self, seed: int) -> None:
        """Writes the benchmark's rows over the program's storage."""
        cfg, coll = self.cfg, self.coll
        small = tuple(i for i, n in enumerate(cfg["tables"]) if n <= cfg["small_set_max_rows"])
        if tuple(sorted(coll.small_ids)) != small:
            raise ValueError(f"the program's small set {coll.small_ids} is not the "
                             f"configuration's {small}")
        storage = self.storage()
        with torch.no_grad():
            for name, part, ids in (("small", coll.small, coll.small_ids),
                                    ("big", coll.big, coll.big_ids)):
                if part is None:
                    continue
                lay = part.layout
                if tuple(lay.table_rows) != tuple(cfg["tables"][t] for t in ids):
                    raise ValueError(f"the program's {name} tables hold {lay.table_rows} rows")
                gen.fill_fused(storage[name], seed=seed, cfg=cfg, table_ids=ids,
                               row_offsets=lay.row_offsets, total_rows=lay.total_rows,
                               shard=part.shard, num_shards=lay.num_shards,
                               strided=lay.policy == port.ShardingPolicy.ROW_HASH)

    def lookup(self, b: dict) -> torch.Tensor:
        """[B, T, D] pooled over batch ``b``'s wire: the dense one's ids and
        mask, or the CSR one's ids and offsets."""
        emb = self.storage()
        if "offsets" in b:
            return self.coll.lookup_csr(emb, b["ids"], b["offsets"])
        return self.coll.lookup(emb, b["ids"], b["mask"], batch_size=b["dense"].shape[0])

    def state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a train step updates in place."""
        out = [t for t in self.storage().values() if t is not None]
        out += [p.data for p in self.dense_leaves().values()]
        return out + [a for a in self.acc.values() if a is not None]

    def _where(self, table: int):
        coll = self.coll
        if table in coll.small_ids:
            return "small", coll.small, coll.small_ids.index(table)
        return "big", coll.big, coll.big_ids.index(table)

    def rows(self, table: int, ids: torch.Tensor) -> torch.Tensor:
        """The program's current rows of ``table`` at ``ids``, f32 [N, D]."""
        name, part, k = self._where(table)
        storage = self.storage()[name].view(-1, self.cfg["dim"])
        return storage[part.layout.row_offsets[k] + ids.long()].float()

    def accumulator(self, table: int, ids: torch.Tensor) -> torch.Tensor:
        name, part, k = self._where(table)
        return self.acc[name][part.layout.row_offsets[k] + ids.long()]
