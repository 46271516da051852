"""What every family's system shares: the port's hybrid embedding
collection, its storage filled with the benchmark's rows, and what the
check reads back through its fused layout (a table's rows at given ids, its
row-AdaGrad accumulator).  A family's ``systems/<interaction>.py`` builds
its model around the collection and subclasses ``CollectionSystem``.

On a mesh (the port's ``PortMesh``) a process holds the small set whole
and its shard of the big set, placed by the configuration's ``sharding``:
under row, the fused rows [s R, (s+1) R) of model shard s; under row_hash,
the fused rows g with g % m == s.  It fills and reads back those rows
alone."""

from __future__ import annotations

import torch

import pim_embedding_lookup_tpu_torch as port
from h100_bench import gen


ROW_POLICIES = (port.ShardingPolicy.ROW, port.ShardingPolicy.ROW_HASH)


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
                rows = lay.policy in ROW_POLICIES  # else every process holds every row
                gen.fill_fused(storage[name], seed=seed, cfg=cfg, table_ids=ids,
                               row_offsets=lay.row_offsets, total_rows=lay.total_rows,
                               shard=part.shard if rows else 0,
                               num_shards=lay.num_shards if rows else 1,
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

    def _placed(self, table: int, ids: torch.Tensor):
        """(set name, the row of each of ``table``'s ``ids`` in its holder's
        storage, whether this process holds it: bool [N], or None where every
        process holds every row)."""
        name, part, k = self._where(table)
        lay = part.layout
        g = lay.row_offsets[k] + ids.long()
        if lay.policy == port.ShardingPolicy.ROW_HASH:
            return name, g // lay.num_shards, g % lay.num_shards == part.shard
        if lay.policy == port.ShardingPolicy.ROW:
            return name, g % lay.rows_per_shard, g // lay.rows_per_shard == part.shard
        return name, g, None

    def _local(self, table: int, ids: torch.Tensor):
        """(set name, this process's storage rows of ``table``'s ``ids``);
        refuses an id that another model shard holds."""
        name, local, mine = self._placed(table, ids)
        if mine is not None and not bool(mine.all()):
            raise ValueError(f"table {table}: ids held by another model shard")
        return name, local

    def holds(self, table: int, ids: torch.Tensor) -> torch.Tensor:
        """Which of ``table``'s ``ids`` this process holds, bool [N]."""
        _, _, mine = self._placed(table, ids)
        return torch.ones_like(ids, dtype=torch.bool) if mine is None else mine

    def split(self, table: int) -> bool:
        """Whether the model axis splits ``table``'s rows over its processes."""
        _, part, _ = self._where(table)
        return part.layout.policy in ROW_POLICIES and part.layout.num_shards > 1

    def rows(self, table: int, ids: torch.Tensor) -> torch.Tensor:
        """The program's current rows of ``table`` at ``ids``, f32 [N, D]:
        ids this process holds."""
        name, local = self._local(table, ids)
        return self.storage()[name].view(-1, self.cfg["dim"])[local].float()

    def accumulator(self, table: int, ids: torch.Tensor) -> torch.Tensor:
        """The row-AdaGrad accumulator of ``table`` at ``ids``, f32 [N]: ids
        this process holds."""
        name, local = self._local(table, ids)
        return self.acc[name][local]
